"""ASVSRModel: the shipped SAVSR trainer.

Counterpart of ``savsr_tpu/models/asvsr_model.py::ASVSRModel``: feed_data
records the batch's scale tuple and optimize_parameters runs the step at it
(eager PyTorch needs no per-scale program). The recurrent trainer
(ASVSRRecurrentModel) is not ported yet.
"""

from __future__ import annotations

from ..utils.registry import MODEL_REGISTRY
from .video_base_model import VideoBaseModel


@MODEL_REGISTRY.register()
class ASVSRModel(VideoBaseModel):
    """Windowed arbitrary-scale VSR trainer (model_type of the shipped
    train configs)."""
