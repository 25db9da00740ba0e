"""PSNR / SSIM, MATLAB-faithful (Y-channel option, 11x11 Gaussian SSIM in
valid mode): the port's own copy of ``savsr_tpu/metrics/psnr_ssim.py``
(numerically lbasicsr/metrics/psnr_ssim.py).

The host (numpy) versions are the canonical evaluation path; the ``*_pt``
versions run the same math on device tensors for in-loop validation
(``val: metrics_device: true``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..archs.arch_util import float32_precision
from ..utils.color_util import rgb2ycbcr_pt
from ..utils.registry import METRIC_REGISTRY
from .metric_util import reorder_image, to_y_channel


def _gaussian_kernel_1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(ax**2) / (2.0 * sigma**2))
    return g / g.sum()


def _crop_and_y(img, img2, crop_border, input_order, test_y_channel):
    if img.shape != img2.shape:
        raise ValueError(f"Image shapes are different: {img.shape}, {img2.shape}.")
    img = reorder_image(np.asarray(img), input_order=input_order)
    img2 = reorder_image(np.asarray(img2), input_order=input_order)
    if crop_border != 0:
        img = img[crop_border:-crop_border, crop_border:-crop_border, ...]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border, ...]
    if test_y_channel:
        img = to_y_channel(img)
        img2 = to_y_channel(img2)
    return img.astype(np.float64), img2.astype(np.float64)


@METRIC_REGISTRY.register()
def calculate_psnr(img, img2, crop_border, input_order="HWC", test_y_channel=False,
                   **kwargs) -> float:
    """PSNR on [0,255] images (BGR HWC by convention, as ``array2img``
    writes them)."""
    img, img2 = _crop_and_y(img, img2, crop_border, input_order, test_y_channel)
    mse = np.mean((img - img2) ** 2)
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(255.0 * 255.0 / mse)


def _valid_gaussian_filter(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable valid-mode 2-D Gaussian filtering of an HW image."""
    size = k.shape[0]
    h, w = img.shape
    out = np.zeros((h, w - size + 1), dtype=np.float64)
    for j in range(size):
        out += k[j] * img[:, j: j + w - size + 1]
    out2 = np.zeros((h - size + 1, out.shape[1]), dtype=np.float64)
    for i in range(size):
        out2 += k[i] * out[i: i + h - size + 1, :]
    return out2


def _ssim_single(img: np.ndarray, img2: np.ndarray) -> float:
    """Single-channel SSIM, 11x11 Gaussian sigma 1.5, valid mode, [0,255]."""
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    k = _gaussian_kernel_1d(11, 1.5)

    mu1 = _valid_gaussian_filter(img, k)
    mu2 = _valid_gaussian_filter(img2, k)
    mu1_sq = mu1**2
    mu2_sq = mu2**2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = _valid_gaussian_filter(img**2, k) - mu1_sq
    sigma2_sq = _valid_gaussian_filter(img2**2, k) - mu2_sq
    sigma12 = _valid_gaussian_filter(img * img2, k) - mu1_mu2

    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return float(ssim_map.mean())


@METRIC_REGISTRY.register()
def calculate_ssim(img, img2, crop_border, input_order="HWC", test_y_channel=False,
                   **kwargs) -> float:
    """SSIM on [0,255] images; channels averaged."""
    img, img2 = _crop_and_y(img, img2, crop_border, input_order, test_y_channel)
    ssims = [_ssim_single(img[..., i], img2[..., i]) for i in range(img.shape[2])]
    return float(np.mean(ssims))


# ---------------------------------------------------------------------------
# device versions (float tensors in [0, 1], NCHW RGB; one value per sample)
# ---------------------------------------------------------------------------


def _crop_and_y_pt(img, img2, crop_border, test_y_channel):
    if crop_border != 0:
        img = img[:, :, crop_border:-crop_border, crop_border:-crop_border]
        img2 = img2[:, :, crop_border:-crop_border, crop_border:-crop_border]
    if test_y_channel:
        img, img2 = rgb2ycbcr_pt(img), rgb2ycbcr_pt(img2)
    return img, img2


def calculate_psnr_pt(img: torch.Tensor, img2: torch.Tensor, crop_border: int = 0,
                      test_y_channel: bool = False) -> torch.Tensor:
    """PSNR of NCHW RGB [0,1] tensors, per sample. Works on the float values
    (no uint8 rounding), so it is not the canonical host path's number."""
    img, img2 = _crop_and_y_pt(img, img2, crop_border, test_y_channel)
    mse = torch.mean((img - img2) ** 2, dim=(1, 2, 3))
    return 10.0 * torch.log10(1.0 / (mse + 1e-8))


def calculate_ssim_pt(img: torch.Tensor, img2: torch.Tensor, crop_border: int = 0,
                      test_y_channel: bool = False) -> torch.Tensor:
    """SSIM of NCHW RGB [0,1] tensors, per sample (valid-mode 11x11
    Gaussian, depthwise, in true f32)."""
    img, img2 = _crop_and_y_pt(img, img2, crop_border, test_y_channel)
    img, img2 = img * 255.0, img2 * 255.0
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    k = torch.tensor(_gaussian_kernel_1d(11, 1.5), dtype=img.dtype, device=img.device)
    c = img.shape[1]
    window = (k[:, None] * k[None, :]).expand(c, 1, 11, 11).contiguous()

    def filt(x):
        return F.conv2d(x, window, groups=c)

    with float32_precision():
        mu1, mu2 = filt(img), filt(img2)
        mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
        sigma1_sq = filt(img * img) - mu1_sq
        sigma2_sq = filt(img2 * img2) - mu2_sq
        sigma12 = filt(img * img2) - mu1_mu2
    cs_map = (2 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    ssim_map = ((2 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)) * cs_map
    return ssim_map.mean(dim=(1, 2, 3))
