"""The port's eval metrics and colour conversions (savsr_tpu_torch.metrics,
savsr_tpu_torch.utils.color_util, array2img) against the JAX package's on
seeded images: the host forms within 1e-12, the device forms within 1e-4
dB PSNR and 1e-5 SSIM, and the reference goldens at the bounds the JAX
package's tests hold (tests/test_metrics.py)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from savsr_tpu.metrics import calculate_psnr as jax_psnr
from savsr_tpu.metrics import calculate_ssim as jax_ssim
from savsr_tpu.metrics.psnr_ssim import calculate_psnr_jnp, calculate_ssim_jnp
from savsr_tpu.utils import color_util as jax_color
from savsr_tpu.utils.img_util import array2img as jax_array2img
from savsr_tpu.utils.img_util import crop_border as jax_crop_border
from savsr_tpu_torch.metrics import (calculate_metric, calculate_psnr, calculate_psnr_pt,
                                     calculate_ssim, calculate_ssim_pt)
from savsr_tpu_torch.utils import color_util
from savsr_tpu_torch.utils.img_util import array2img, crop_border

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "metrics.npz")


def _pair(seed=7, hw=(40, 52)):
    """Two [0, 255] BGR HWC images, uint8-valued, the second a noisy copy."""
    rng = np.random.default_rng(seed)
    img = (rng.random(hw + (3,)) * 255).round()
    img2 = np.clip(img + rng.normal(0, 8, img.shape), 0, 255).round()
    return img, img2


@pytest.mark.parametrize("layout", ["HWC", "CHW"])
@pytest.mark.parametrize("crop", [0, 4])
@pytest.mark.parametrize("y", [False, True])
def test_host_metrics_match_jax(layout, crop, y):
    img, img2 = _pair()
    if layout == "CHW":
        img, img2 = img.transpose(2, 0, 1), img2.transpose(2, 0, 1)
    kw = dict(crop_border=crop, input_order=layout, test_y_channel=y)
    assert abs(calculate_psnr(img, img2, **kw) - jax_psnr(img, img2, **kw)) <= 1e-12
    assert abs(calculate_ssim(img, img2, **kw) - jax_ssim(img, img2, **kw)) <= 1e-12
    # the registry path the validation takes
    for name, fn in (("calculate_psnr", jax_psnr), ("calculate_ssim", jax_ssim)):
        got = calculate_metric({"img": img, "img2": img2}, dict(type=name, **kw))
        assert abs(got - fn(img, img2, **kw)) <= 1e-12


def test_host_metrics_meet_the_reference_goldens():
    data = np.load(GOLDEN)
    img, img2 = data["img"], data["img2"]
    assert abs(calculate_psnr(img, img2, crop_border=0) - data["psnr"]) < 1e-8
    assert abs(calculate_psnr(img, img2, crop_border=0, test_y_channel=True)
               - data["psnr_y"]) < 1e-6
    assert abs(calculate_ssim(img, img2, crop_border=0) - data["ssim"]) < 1e-7
    assert abs(calculate_ssim(img, img2, crop_border=0, test_y_channel=True)
               - data["ssim_y"]) < 1e-7
    assert abs(calculate_psnr(img, img2, crop_border=4) - data["psnr_cb4"]) < 1e-8
    assert calculate_psnr(img, img, crop_border=0) == float("inf")


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_colour_conversions_match_jax(dtype):
    rng = np.random.default_rng(3)
    img = rng.random((9, 11, 3))
    img = (img * 255).round().astype(np.uint8) if dtype == np.uint8 else img.astype(dtype)
    for name in ("rgb2ycbcr", "bgr2ycbcr"):
        for y_only in (False, True):
            got = getattr(color_util, name)(img, y_only=y_only)
            want = getattr(jax_color, name)(img, y_only=y_only)
            assert got.dtype == want.dtype
            assert np.abs(got.astype(np.float64) - want.astype(np.float64)).max() <= 1e-12
    for name in ("ycbcr2rgb", "ycbcr2bgr"):
        got, want = getattr(color_util, name)(img), getattr(jax_color, name)(img)
        assert got.dtype == want.dtype
        assert np.abs(got.astype(np.float64) - want.astype(np.float64)).max() <= 1e-12


def test_array2img_and_crop_border_match_jax():
    rng = np.random.default_rng(5)
    for shape in ((1, 10, 12, 3), (10, 12, 3), (10, 12, 1), (10, 12)):
        a = (rng.random(shape) * 1.4 - 0.2).astype(np.float32)  # clamped both ways
        for kw in ({}, dict(rgb2bgr=False), dict(out_type=np.float32)):
            got, want = array2img(a, **kw), jax_array2img(a, **kw)
            assert got.dtype == want.dtype and np.array_equal(got, want), (shape, kw)
    imgs = [rng.random((10, 12, 3)) for _ in range(2)]
    for cb in (0, 2):
        assert all(np.array_equal(g, w) for g, w in zip(crop_border(imgs, cb),
                                                        jax_crop_border(imgs, cb)))


@pytest.mark.parametrize("crop", [0, 4])
@pytest.mark.parametrize("y", [False, True])
def test_device_metrics_match_jnp(crop, y):
    """The torch forms (NCHW RGB in [0, 1], per sample) against the JAX
    package's ``_jnp`` forms (NHWC) on a batch of two."""
    rng = np.random.default_rng(11)
    a = rng.random((2, 40, 52, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.03, a.shape), 0, 1).astype(np.float32)
    ta, tb = (torch.from_numpy(v).permute(0, 3, 1, 2) for v in (a, b))
    psnr = calculate_psnr_pt(ta, tb, crop, y).numpy()
    ssim = calculate_ssim_pt(ta, tb, crop, y).numpy()
    assert psnr.shape == ssim.shape == (2,)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    assert np.abs(psnr - np.asarray(calculate_psnr_jnp(ja, jb, crop, y))).max() <= 1e-4
    assert np.abs(ssim - np.asarray(calculate_ssim_jnp(ja, jb, crop, y))).max() <= 1e-5
    yc = color_util.rgb2ycbcr_pt(ta).permute(0, 2, 3, 1).numpy()[..., 0]
    assert np.abs(yc - np.asarray(jax_color.rgb2ycbcr_jnp(ja))).max() <= 1e-6


def test_niqe_is_refused_by_name():
    img, img2 = _pair()
    with pytest.raises(NotImplementedError, match="calculate_niqe"):
        calculate_metric({"img": img}, dict(type="calculate_niqe", crop_border=0))
