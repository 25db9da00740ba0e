"""Checkpoint conversion for the port: JAX parameter dicts and torch ``.pth``
files -> a torch-layout ``state_dict``, with strict key accounting, and back
(``params_to_jax``), so ``net_g_<iter>.npz`` files written by either package
load in the other.

``params_from_jax`` is the port's copy of the inverse layout transpose of
``savsr_tpu/utils/convert.py::invert_state_dict``, ``params_to_jax`` of
``::convert_state_dict``:

  HWIO conv weight   [kh, kw, I, O]      -> [O, I, kh, kw]
  [in, out] linear                        -> [out, in]
  OSConv bank        [K, k, k, I, O]     -> [K, O, I, k, k]
  STAU experts       [n, o, i]           -> [n, o, i, 1, 1]
  BN num_batches_tracked                  -> int64
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn


def params_from_jax(np_params: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """JAX param dict (numpy values) -> torch-layout state_dict."""
    out: Dict[str, torch.Tensor] = {}
    for key, v in np_params.items():
        v = np.asarray(v)
        if key.endswith("weight_compress") or key.endswith("weight_expand"):
            v = v[..., None, None]
        elif v.ndim == 5:
            v = v.transpose(0, 4, 3, 1, 2)
        elif v.ndim == 4:
            v = v.transpose(3, 2, 0, 1)
        elif v.ndim == 2:
            v = v.transpose(1, 0)
        if key.endswith("num_batches_tracked"):
            v = v.astype(np.int64)
        out[key] = torch.from_numpy(np.array(v, order="C"))
    return out


def params_to_jax(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Torch-layout state_dict -> JAX param dict (numpy values): the inverse
    of ``params_from_jax`` (OIHW -> HWIO, [out, in] -> [in, out], the OSConv
    bank [K, O, I, k, k] -> [K, k, k, I, O], the STAU experts back to
    [n, o, i], num_batches_tracked as int32)."""
    out: Dict[str, np.ndarray] = {}
    for key, t in state.items():
        v = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        if key.endswith("weight_compress") or key.endswith("weight_expand"):
            v = v[..., 0, 0]
        elif v.ndim == 5:
            v = v.transpose(0, 3, 4, 2, 1)
        elif v.ndim == 4:
            v = v.transpose(2, 3, 1, 0)
        elif v.ndim == 2:
            v = v.transpose(1, 0)
        if key.endswith("num_batches_tracked"):
            v = v.astype(np.int32)
        out[key] = np.array(v, order="C")  # keeps 0-d entries 0-d
    return out


def load_checkpoint(path: str, param_key: str = "params") -> Dict[str, torch.Tensor]:
    """A checkpoint as a torch-layout state_dict.

    ``.npz``: a JAX checkpoint (``<param_key>/name`` or ``params/name``
    entries as written by the JAX package's training, or a bare converted
    param dict), carried over with ``params_from_jax``.
    ``.pth``: a reference torch checkpoint ({'params': ..., 'params_ema': ...}
    or a bare state_dict); ``module.`` prefixes are dropped.
    """
    if path.endswith(".npz"):
        with np.load(path) as data:
            keys = data.files
            for prefix in (f"{param_key}/", "params/"):
                if any(k.startswith(prefix) for k in keys):
                    raw = {k[len(prefix):]: data[k] for k in keys if k.startswith(prefix)}
                    break
            else:
                raw = {k: data[k] for k in keys}
        return params_from_jax(raw)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if param_key in ckpt:
        ckpt = ckpt[param_key]
    elif "params" in ckpt:
        ckpt = ckpt["params"]
    return {k.replace("module.", ""): v for k, v in ckpt.items()}


def key_problems(model: nn.Module, state: Mapping[str, torch.Tensor]) -> list[str]:
    """Exact key and shape accounting of ``state`` against ``model``
    (empty list = clean)."""
    expect = model.state_dict()
    problems = [f"missing from checkpoint: {k} {tuple(expect[k].shape)}"
                for k in sorted(set(expect) - set(state))]
    problems += [f"unexpected in checkpoint: {k} {tuple(state[k].shape)}"
                 for k in sorted(set(state) - set(expect))]
    problems += [f"shape mismatch {k}: model {tuple(expect[k].shape)} vs checkpoint "
                 f"{tuple(state[k].shape)}"
                 for k in sorted(set(expect) & set(state))
                 if tuple(expect[k].shape) != tuple(state[k].shape)]
    return problems


def load_into(model: nn.Module, state: Mapping[str, torch.Tensor]) -> None:
    """Strict load: raise KeyError listing the key/shape problems, if any."""
    problems = key_problems(model, state)
    if problems:
        shown = "; ".join(problems[:5]) + (" ..." if len(problems) > 5 else "")
        raise KeyError(f"checkpoint does not match the network ({len(problems)} "
                       f"problems): {shown}")
    model.load_state_dict(state, strict=True)
