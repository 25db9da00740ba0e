"""Network factory: YAML ``network_g: type`` -> module."""

from copy import deepcopy


def build_network(opt: dict):
    """Instantiate a network from its options dict (key ``type``). The port
    has SAVSR; the JAX package's other architectures are not ported yet."""
    opt = deepcopy(opt)
    net_type = opt.pop("type")
    if net_type != "SAVSR":
        raise NotImplementedError(f"network_g: type: {net_type} is not ported yet")
    from .savsr_arch import SAVSR

    return SAVSR(**opt)
