"""Colour space conversions (MATLAB-compatible BT.601 YCbCr).

The port's own copy of ``savsr_tpu/utils/color_util.py`` (numerically the
reference's lbasicsr/utils/color_util.py), so that Y-channel PSNR/SSIM
match it exactly: numpy conversions for the host metrics, and the Y
transform on tensors (``rgb2ycbcr_pt``) for the device metrics.
"""

from __future__ import annotations

import numpy as np
import torch


def _convert_input_type_range(img: np.ndarray) -> np.ndarray:
    """Normalize to float32 in [0, 1] (accepts uint8 [0,255] or float [0,1])."""
    img_type = img.dtype
    img = img.astype(np.float32)
    if img_type == np.uint8:
        img /= 255.0
    elif img_type not in (np.float32, np.float64):
        raise TypeError(f"Image type must be uint8/float32/float64, got {img_type}")
    return img


def _convert_output_type_range(img: np.ndarray, dst_type) -> np.ndarray:
    """Restore [0,255] uint8 (rounded) or float of the input's range."""
    if dst_type not in (np.uint8, np.float32, np.float64):
        raise TypeError(f"dst_type must be uint8/float32/float64, got {dst_type}")
    if dst_type == np.uint8:
        img = img.round()
    else:
        img /= 255.0
    return img.astype(dst_type)


# BT.601 full-swing matrices (MATLAB rgb2ycbcr convention)
_RGB2YCBCR = np.array(
    [[65.481, -37.797, 112.0], [128.553, -74.203, -93.786], [24.966, 112.0, -18.214]]
)
_Y_FROM_RGB = np.array([65.481, 128.553, 24.966])


def rgb2ycbcr(img: np.ndarray, y_only: bool = False) -> np.ndarray:
    img_type = img.dtype
    img = _convert_input_type_range(img)
    if y_only:
        out = np.dot(img, _Y_FROM_RGB) + 16.0
    else:
        out = np.matmul(img, _RGB2YCBCR) + [16, 128, 128]
    return _convert_output_type_range(out, img_type)


def bgr2ycbcr(img: np.ndarray, y_only: bool = False) -> np.ndarray:
    img_type = img.dtype
    img = _convert_input_type_range(img)
    if y_only:
        out = np.dot(img, _Y_FROM_RGB[::-1]) + 16.0
    else:
        out = np.matmul(img, _RGB2YCBCR[::-1]) + [16, 128, 128]
    return _convert_output_type_range(out, img_type)


def ycbcr2rgb(img: np.ndarray) -> np.ndarray:
    img_type = img.dtype
    img = _convert_input_type_range(img) * 255
    inv = np.linalg.inv(_RGB2YCBCR) * 255
    out = np.matmul(img, inv) - np.matmul(np.array([16, 128, 128]), inv)
    return _convert_output_type_range(out, img_type)


def ycbcr2bgr(img: np.ndarray) -> np.ndarray:
    return ycbcr2rgb(img)[..., ::-1].copy()


def rgb2ycbcr_pt(img: torch.Tensor, y_only: bool = True) -> torch.Tensor:
    """[N, 3, H, W] RGB float in [0, 1] -> Y [N, 1, H, W] (``y_only``) or
    YCbCr [N, 3, H, W], Y in [16/255, 235/255]: the device metrics'
    transform (the JAX package's ``rgb2ycbcr_jnp`` on NCHW tensors). Three
    multiply-adds per output channel, no matmul (so no TF32 on the card)."""
    mat = _Y_FROM_RGB[:, None] if y_only else _RGB2YCBCR
    off = (16.0,) if y_only else (16.0, 128.0, 128.0)
    out = [img[:, 0] * float(mat[0, j]) + img[:, 1] * float(mat[1, j])
           + img[:, 2] * float(mat[2, j]) + off[j] for j in range(len(off))]
    return torch.stack(out, dim=1) / 255.0
