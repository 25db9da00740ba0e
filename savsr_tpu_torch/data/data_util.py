"""Frame-window indexing, image-sequence reading, and the degradations of
the training and test datasets (arbitrary-scale bicubic, and the DUF
protocol's Gaussian blur + subsampling): the port's counterpart of
``savsr_tpu/data/data_util.py``. Image stacks are channel-last numpy,
[T, H, W, C]."""

from __future__ import annotations

import os
from os import path as osp
from typing import List

import numpy as np

from ..utils.img_util import imread
from .resize import resize_np
from .transforms import as_mod_crop, mod_crop


def generate_frame_indices(crt_idx: int, max_frame_num: int, num_frames: int,
                           padding: str = "reflection") -> List[int]:
    """Indices of a temporal window centred at ``crt_idx``, padded at clip
    borders: 'replicate' | 'reflection' | 'reflection_circle' | 'circle'
    (reference data_util.py:63-112)."""
    if num_frames % 2 != 1:
        raise ValueError("num_frames should be an odd number.")
    if padding not in ("replicate", "reflection", "reflection_circle", "circle"):
        raise ValueError(f"Wrong padding mode: {padding}.")
    max_frame_num = max_frame_num - 1
    num_pad = num_frames // 2
    indices = []
    for i in range(crt_idx - num_pad, crt_idx + num_pad + 1):
        if i < 0:
            if padding == "replicate":
                pad_idx = 0
            elif padding == "reflection":
                pad_idx = -i
            elif padding == "reflection_circle":
                pad_idx = crt_idx + num_pad - i
            else:
                pad_idx = num_frames + i
        elif i > max_frame_num:
            if padding == "replicate":
                pad_idx = max_frame_num
            elif padding == "reflection":
                pad_idx = max_frame_num * 2 - i
            elif padding == "reflection_circle":
                pad_idx = (crt_idx - num_pad) - (i - max_frame_num)
            else:
                pad_idx = i - num_frames
        else:
            pad_idx = i
        indices.append(pad_idx)
    return indices


def read_img_seq(paths: List[str], require_mod_crop: bool = False, scale=1,
                 require_as_mod_crop: bool = False, return_imgname: bool = False):
    """Read frames into a [T, H, W, C] float32 RGB stack in [0, 1], each
    frame mod-cropped to the integer ``scale`` (``require_mod_crop``) or
    to the arbitrary ``scale`` (``require_as_mod_crop``) first; with
    ``return_imgname`` also the frames' names without extension."""
    imgs = [imread(p, float32=True) for p in paths]
    if require_mod_crop:
        imgs = [mod_crop(img, int(scale)) for img in imgs]
    if require_as_mod_crop:
        imgs = [as_mod_crop(img, scale) for img in imgs]
    stack = np.stack([img[..., ::-1] for img in imgs], axis=0).astype(np.float32)
    if return_imgname:
        return stack, [osp.splitext(osp.basename(p))[0] for p in paths]
    return stack


def paths_from_folder(folder: str, suffix=(".png", ".jpg", ".jpeg", ".bmp")) -> List[str]:
    return sorted(os.path.join(folder, p) for p in os.listdir(folder)
                  if p.lower().endswith(suffix)
                  and os.path.isfile(os.path.join(folder, p)))


def generate_gaussian_kernel(kernel_size: int = 13, sigma: float = 1.6) -> np.ndarray:
    """2-D Gaussian kernel via separable 1-D weights (sums to 1)."""
    ax = np.arange(kernel_size) - (kernel_size - 1) / 2.0
    g = np.exp(-(ax**2) / (2.0 * sigma**2))
    g = g / g.sum()
    return np.outer(g, g)


def duf_downsample(x: np.ndarray, kernel_size: int = 13, scale: int = 4) -> np.ndarray:
    """BD degradation: Gaussian blur (sigma 0.4*scale) + stride-``scale``
    subsampling of [T, H, W, C] or [B, T, H, W, C], the DUF protocol
    (reference data_util.py:338-368)."""
    if scale not in (2, 3, 4):
        raise ValueError(f"Only scale (2, 3, 4) supported, got {scale}.")
    squeeze = x.ndim == 4
    if squeeze:
        x = x[None]
    b, t, h, w, c = x.shape
    pad = kernel_size // 2 + scale * 2
    flat = x.reshape(b * t, h, w, c)
    flat = np.pad(flat, ((0, 0), (pad, pad), (pad, pad), (0, 0)), mode="reflect")
    kernel = generate_gaussian_kernel(kernel_size, 0.4 * scale)
    kh = kernel.shape[0]
    # valid conv with stride ``scale`` as a strided patch sum
    h_out = (flat.shape[1] - kh) // scale + 1
    w_out = (flat.shape[2] - kh) // scale + 1
    out = np.zeros((b * t, h_out, w_out, c), dtype=flat.dtype)
    for i in range(kh):
        for j in range(kh):
            out += kernel[i, j] * flat[:, i:i + h_out * scale:scale, j:j + w_out * scale:scale, :]
    out = out[:, 2:-2, 2:-2, :]
    out = out.reshape(b, t, out.shape[1], out.shape[2], c)
    return out[0] if squeeze else out


def arbitrary_scale_downsample(x: np.ndarray, scale, mode: str = "torch",
                               degradation: str = "BI") -> np.ndarray:
    """Degrade [T, H, W, C] or [B, T, H, W, C] by an arbitrary, possibly
    asymmetric scale (reference data_util.py:371-420): ``degradation``
    'BI' is the antialiased bicubic downsample to (round(h/sh),
    round(w/sw)), Python rounding, ``mode`` 'torch' (the shipped default)
    or 'core' (MATLAB); 'BD' is ``duf_downsample`` at int(sh)."""
    scale_h, scale_w = scale if isinstance(scale, tuple) else (scale, scale)
    if degradation == "BI":
        h, w = x.shape[-3], x.shape[-2]
        return resize_np(x, (round(h / scale_h), round(w / scale_w)), mode=mode, antialias=True)
    if degradation == "BD":
        return duf_downsample(x, kernel_size=13, scale=int(scale_h))
    raise ValueError(f"Unknown degradation {degradation}")
