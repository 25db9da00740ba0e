from copy import deepcopy

from ..utils.logger import get_root_logger
from ..utils.registry import LOSS_REGISTRY
from .basic_loss import CharbonnierLoss, L1Loss, MSELoss

__all__ = ["L1Loss", "MSELoss", "CharbonnierLoss", "build_loss"]

# losses of the JAX package that the port does not have yet
NOT_PORTED = ("PerceptualLoss", "WeightedTVLoss", "GANLoss", "MultiScaleGANLoss")


def build_loss(opt):
    """Instantiate a loss from an options dict (key ``type``)."""
    opt = deepcopy(opt)
    loss_type = opt.pop("type")
    if loss_type in NOT_PORTED:
        raise NotImplementedError(f"loss type {loss_type} is not ported yet")
    loss = LOSS_REGISTRY.get(loss_type)(**opt)
    get_root_logger().info(f"Loss [{loss.__class__.__name__}] is created.")
    return loss
