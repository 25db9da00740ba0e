"""ASVSRModel: the shipped SAVSR trainer and evaluator.

Counterpart of ``savsr_tpu/models/asvsr_model.py::ASVSRModel``: feed_data
records the batch's scale tuple and optimize_parameters runs the step at it
(eager PyTorch needs no per-scale program); ``test`` runs at the eval scale
of the options (the dataset's, set by the validation). The recurrent
trainer (ASVSRRecurrentModel) is not ported yet.
"""

from __future__ import annotations

from ..utils.registry import MODEL_REGISTRY
from .video_base_model import VideoBaseModel


@MODEL_REGISTRY.register()
class ASVSRModel(VideoBaseModel):
    """Windowed arbitrary-scale VSR trainer (model_type of the shipped
    train and test configs)."""

    def test(self):
        # the eval scale comes from the dataset or test config
        # (reference asvsr_model.py:31-61)
        if self.opt.get("scale") is not None:
            s = self.opt["scale"]
            self.scale = tuple(s) if isinstance(s, (tuple, list)) else (s, s)
        super().test()
