"""VideoBaseModel: the windowed-VSR model family's base.

Counterpart of ``savsr_tpu/models/video_base_model.py``. Its job there is the
per-folder, per-frame validation; the eval pipeline is not ported yet, so the
validation entry points raise.
"""

from __future__ import annotations

from ..utils.registry import MODEL_REGISTRY
from .sr_model import SRModel


@MODEL_REGISTRY.register()
class VideoBaseModel(SRModel):
    """Base video SR model."""

    def validation(self, dataloader, current_iter, tb_logger, save_img=False):
        raise NotImplementedError("val: validation (the eval pipeline) is not ported yet")

    dist_validation = nondist_validation = validation
