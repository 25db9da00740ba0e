from copy import deepcopy

from ..utils.logger import get_root_logger
from ..utils.registry import MODEL_REGISTRY

# import model modules so their @register decorators run
from . import asvsr_model  # noqa: F401
from . import sr_model  # noqa: F401
from . import video_base_model  # noqa: F401

__all__ = ["build_model"]

# model types of the JAX package that the port does not have yet
NOT_PORTED = ("VideoRecurrentModel", "ASVideoRecurrentModel", "ASVSRRecurrentModel")


def build_model(opt):
    """Instantiate a model wrapper by its YAML ``model_type``."""
    opt = deepcopy(opt)
    if opt["model_type"] in NOT_PORTED:
        raise NotImplementedError(
            f"model_type: {opt['model_type']} (the recurrent model family) is not ported yet")
    model = MODEL_REGISTRY.get(opt["model_type"])(opt)
    get_root_logger().info(f"Model [{model.__class__.__name__}] is created.")
    return model
