"""Network factory: YAML ``network_g: type`` -> module."""

from copy import deepcopy

from ..utils.logger import get_root_logger

# settings of the JAX package's engines that name one math here: the CHW
# Pallas engine or XLA for the eval convs (``conv_engine``) and the paired
# alignment pass (``pair_align``); the port has one engine for each.
# ``conv_precision`` (native | split) and ``matmul_precision`` (float32 |
# default) are the network's own settings: with f32 weights they select the
# strict, fast or split serving tier (``SAVSR.serving_tier``).
JAX_ENGINE_KEYS = ("conv_engine", "pair_align")


def build_network(opt: dict):
    """Instantiate a network from its options dict (key ``type``). The port
    has SAVSR; the JAX package's other architectures are not ported yet.
    The JAX engine settings are accepted and logged; ``conv_precision:
    split`` builds the split serving tier and ``matmul_precision: default``
    with f32 weights the fast one (eval forwards only)."""
    opt = deepcopy(opt)
    net_type = opt.pop("type")
    if net_type != "SAVSR":
        raise NotImplementedError(f"network_g: type: {net_type} is not ported yet")
    engines = {k: opt.pop(k) for k in JAX_ENGINE_KEYS if k in opt}
    if engines:
        get_root_logger().info(f"network_g: {engines} select engines of the JAX package; the "
                               "port runs its one engine (the CUDA kernels of ops/).")
    from .savsr_arch import SAVSR

    return SAVSR(**opt)
