"""Bicubic resampling with exact reference semantics, as dense matmuls
(the port's own copy of the host side of ``savsr_tpu/data/resize.py``).

The reference pipeline degrades GT frames on the fly with one of two bicubic
implementations (lbasicsr/data/data_util.py:371-420):

  - ``torch`` mode (the shipped default): torchvision
    ``Resize(BICUBIC, antialias=True)``, i.e. PyTorch's separable
    antialiased resampler (identical to PIL's convolution-based resize).
  - ``core`` mode: a MATLAB ``imresize('bicubic')``-exact resizer
    (lbasicsr/data/core.py) with antialias widening and symmetric padding.

Both are separable 1-D convolutions with position-dependent taps, so each
axis is realised once (cached) as a dense ``[out_size, in_size]`` weight
matrix and applied as a matmul: on the host (``resize_np``), or on NCHW
device tensors (``resize_pt``, the device metrics' post-process).

Algorithms are implemented from their public definitions (PIL/PyTorch
antialiased resampling; MATLAB imresize) — no code is taken from the
reference.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple, Union

import numpy as np

Scale = Union[float, Tuple[float, float]]


def _cubic_kernel(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    """Keys cubic convolution kernel (a=-0.5), support [-2, 2]."""
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    w = np.where(
        ax <= 1.0,
        (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0,
        np.where(ax < 2.0, a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a, 0.0),
    )
    return w


def _torch_aa_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Antialiased bicubic weight matrix matching PyTorch/PIL.

    Per output pixel i (scale = in/out):
        center  = scale * (i + 0.5)
        support = 2*scale if scale > 1 else 2      (bicubic radius 2)
        taps j in [floor(center - support + 0.5), ...) clipped to [0, in)
        w_j = cubic((j + 0.5 - center) / max(scale, 1)),  normalized to sum 1
    """
    scale = in_size / out_size
    support = 2.0 * scale if scale > 1.0 else 2.0
    invscale = 1.0 / scale if scale > 1.0 else 1.0
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        center = scale * (i + 0.5)
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        j = np.arange(xmin, xmax, dtype=np.float64)
        w = _cubic_kernel((j + 0.5 - center) * invscale)
        s = w.sum()
        if s != 0:
            w = w / s
        mat[i, xmin:xmax] = w
    return mat


def _torch_nonaa_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Non-antialiased bicubic matrix matching ``F.interpolate(mode='bicubic',
    antialias=False, align_corners=False)``: 4 taps around
    src = (i+0.5)*scale - 0.5 with a=-0.75 (torch/OpenCV convention),
    border replicated (not renormalized)."""
    scale = in_size / out_size
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        src = (i + 0.5) * scale - 0.5
        fl = math.floor(src)
        j = np.arange(fl - 1, fl + 3, dtype=np.int64)
        w = _cubic_kernel(j.astype(np.float64) - src, a=-0.75)
        jc = np.clip(j, 0, in_size - 1)
        for idx, wv in zip(jc, w):
            mat[i, idx] += wv
    return mat


def _matlab_matrix(in_size: int, out_size: int, scale: float) -> np.ndarray:
    """MATLAB imresize bicubic weight matrix (antialias when downscaling).

    Per output pixel i (1-based MATLAB math, 0-based here):
        u = (i+1)/scale + 0.5*(1 - 1/scale)        # in 1-based input coords
        kernel_width = 4/scale if scale < 1 else 4
        left = floor(u - kernel_width/2)
        taps j = left + (0..P-1),  P = ceil(kernel_width) + 2
        w_j = scale*cubic(scale*(u - j)) if scale < 1 else cubic(u - j)
        normalize; indices reflected symmetrically into range.
    """
    antialias = scale < 1.0
    kernel_width = 4.0 / scale if antialias else 4.0
    P = int(math.ceil(kernel_width)) + 2
    mat = np.zeros((out_size, in_size), dtype=np.float64)

    i = np.arange(1, out_size + 1, dtype=np.float64)
    u = i / scale + 0.5 * (1.0 - 1.0 / scale)
    left = np.floor(u - kernel_width / 2.0)
    indices = left[:, None] + np.arange(P, dtype=np.float64)[None, :]  # 1-based
    if antialias:
        weights = scale * _cubic_kernel(scale * (u[:, None] - indices))
    else:
        weights = _cubic_kernel(u[:, None] - indices)
    weights = weights / weights.sum(axis=1, keepdims=True)

    # symmetric boundary: aux = [1..n, n..1], index = aux[mod(idx-1, 2n)]
    idx0 = (indices - 1).astype(np.int64)  # 0-based, may be out of range
    aux = np.concatenate(
        [np.arange(in_size), np.arange(in_size - 1, -1, -1)]
    )
    idx_mapped = aux[np.mod(idx0, 2 * in_size)]
    for r in range(out_size):
        for c in range(P):
            mat[r, idx_mapped[r, c]] += weights[r, c]
    return mat


@functools.lru_cache(maxsize=512)
def bicubic_weight_matrix(
    in_size: int,
    out_size: int,
    mode: str = "torch",
    antialias: bool = True,
    scale: Optional[float] = None,
    dtype=np.float32,
) -> np.ndarray:
    """Dense [out_size, in_size] resampling matrix (cached).

    Args:
        mode: 'torch' (PyTorch/PIL convention) or 'core' (MATLAB convention).
        antialias: only meaningful for 'torch' mode.
        scale: out/in ratio for 'core' mode; defaults to out_size/in_size.
    """
    if mode == "torch":
        m = _torch_aa_matrix(in_size, out_size) if antialias else _torch_nonaa_matrix(in_size, out_size)
    elif mode in ("core", "matlab"):
        s = scale if scale is not None else out_size / in_size
        m = _matlab_matrix(in_size, out_size, s)
    else:
        raise ValueError(f"Unknown resize mode: {mode}")
    return m.astype(dtype)


def resize_np(
    img: np.ndarray,
    size: Tuple[int, int],
    mode: str = "torch",
    antialias: bool = True,
    scale: Optional[Tuple[float, float]] = None,
) -> np.ndarray:
    """Resize the trailing-spatial image(s) on host.

    Accepts ``[..., H, W, C]`` (channel-last). float32 images go through
    the host resampler (csrc/resample.cpp: float accumulation, the JAX
    package's arithmetic, ~1e-6 off float64); other dtypes, and float32
    where the resampler cannot be built, are computed in float64 and cast
    back to the input dtype.
    """
    h, w = img.shape[-3], img.shape[-2]
    H, W = size
    mh = bicubic_weight_matrix(
        h, H, mode, antialias, None if scale is None else scale[0], np.float64
    )
    mw = bicubic_weight_matrix(
        w, W, mode, antialias, None if scale is None else scale[1], np.float64
    )
    if img.dtype == np.float32:
        from ..csrc.build import resample_native

        flat = img.reshape((-1,) + img.shape[-3:])
        out = resample_native(flat, mh.astype(np.float32), mw.astype(np.float32))
        if out is not None:
            return out.reshape(img.shape[:-3] + out.shape[1:])
    out = np.einsum("Hh,...hwc->...Hwc", mh, img.astype(np.float64), optimize=True)
    out = np.einsum("Ww,...hwc->...hWc", mw, out, optimize=True)
    return out.astype(img.dtype)


def resize_pt(x, size: Tuple[int, int], mode: str = "torch", antialias: bool = True):
    """Resize [..., C, H, W] tensors on their device: the two weight
    matrices of ``resize_np`` as true-f32 matmuls (the JAX package's
    ``resize_jax`` at precision 'highest')."""
    import torch

    from ..archs.arch_util import float32_precision

    h, w = x.shape[-2], x.shape[-1]
    mh, mw = (torch.from_numpy(bicubic_weight_matrix(n, m, mode, antialias)).to(x)
              for n, m in ((h, size[0]), (w, size[1])))
    with float32_precision():
        return torch.einsum("Hh,...hw,Ww->...HW", mh, x, mw)
