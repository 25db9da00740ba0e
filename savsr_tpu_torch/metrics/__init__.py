"""Image quality metrics of the eval pipeline, resolved by name from the
``val: metrics`` block (the port's counterpart of ``savsr_tpu/metrics``)."""

from copy import deepcopy

from ..utils.registry import METRIC_REGISTRY
from .psnr_ssim import calculate_psnr, calculate_psnr_pt, calculate_ssim, calculate_ssim_pt

__all__ = ["calculate_psnr", "calculate_ssim", "calculate_psnr_pt", "calculate_ssim_pt",
           "calculate_metric"]


@METRIC_REGISTRY.register()
def calculate_niqe(*args, **kwargs):
    """NIQE needs the pristine-image statistics of BasicSR's release assets,
    which are not in the repository (ROADMAP.md A.6)."""
    raise NotImplementedError("metrics: type: calculate_niqe (NIQE) is not ported yet "
                              "(ROADMAP.md A.6)")


def calculate_metric(data: dict, opt: dict):
    """Instantiate and run a metric from an options dict (key ``type``)."""
    opt = deepcopy(opt)
    metric_type = opt.pop("type")
    return METRIC_REGISTRY.get(metric_type)(**data, **opt)
