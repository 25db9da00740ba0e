"""Frame-window indexing and image-sequence reading for serving, and the
arbitrary-scale bicubic degradation of the training loader."""

from __future__ import annotations

import os
from typing import List

import numpy as np

from ..utils.img_util import imread
from .resize import resize_np


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


def read_img_seq(paths: List[str]) -> np.ndarray:
    """Read frames into a [T, H, W, C] float32 RGB stack in [0, 1]."""
    imgs = [imread(p, float32=True) for p in paths]
    return np.stack([img[..., ::-1] for img in imgs], axis=0).astype(np.float32)


def paths_from_folder(folder: str, suffix=(".png", ".jpg", ".jpeg", ".bmp")) -> List[str]:
    return sorted(os.path.join(folder, p) for p in os.listdir(folder)
                  if p.lower().endswith(suffix)
                  and os.path.isfile(os.path.join(folder, p)))


def arbitrary_scale_downsample(x: np.ndarray, scale, mode: str = "torch") -> np.ndarray:
    """asBI degradation (reference data_util.py:371-420): bicubic downsample
    of [T, H, W, C] or [B, T, H, W, C] by an arbitrary, possibly asymmetric
    scale; output size (round(h/sh), round(w/sw)), Python rounding.
    ``mode``: 'torch' (antialiased, the shipped default) or 'core' (MATLAB)."""
    scale_h, scale_w = scale if isinstance(scale, tuple) else (scale, scale)
    h, w = x.shape[-3], x.shape[-2]
    return resize_np(x, (round(h / scale_h), round(w / scale_w)), mode=mode, antialias=True)
