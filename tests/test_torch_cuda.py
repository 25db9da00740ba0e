"""The port's CUDA kernels against their plain versions on the card, at
small and ragged shapes the serving run does not reach (partial tiles,
C = 16 and 32, two samples), and the small-config forward on the card
against the torch golden. Needs a CUDA card, and skips without one. On a
machine with a card:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: the repo's conftest imports JAX, which the port's
machines need not have). Tolerances as in chip_smoke.py: f32 1e-4 x
max|plain| (summation order), bf16 2e-2 x max|plain| (one bf16 rounding).
"""

import os

import numpy as np
import pytest
import torch

from savsr_tpu_torch import ops
from savsr_tpu_torch.archs.arch_util import float32_precision
from savsr_tpu_torch.archs.savsr_arch import (SAVSR, STAUpsample, _stau_head, get_hw,
                                              stau_sampler_planes, tail_operands)
from savsr_tpu_torch.ops.conv import conv_fused, conv_fused_plain
from savsr_tpu_torch.ops.sta import sta_conv_fused, sta_conv_fused_plain
from savsr_tpu_torch.ops.stau import stau_upsample_fused, stau_upsample_fused_plain
from savsr_tpu_torch.ops.tail import tail_fused, tail_fused_plain

pytestmark = pytest.mark.cuda

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]
SMALL_CFG = dict(num_in_ch=3, num_feat=16, num_frame=7, slid_win=3, fusion_win=5,
                 interval=0, w1_num_block=2, w2_num_block=1, n_resgroups=1, n_resblocks=2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with float32_precision(True):  # the plain versions run true f32
        yield torch.device("cuda")


def _rand(rng, shape, dtype, dev, std=1.0):
    return torch.from_numpy((std * rng.standard_normal(shape)).astype(np.float32)).to(dev, dtype)


@torch.no_grad()
def _agree(kernel_fn, plain_fn, dtype, name):
    before = ops.launches[name]
    got = kernel_fn().float()
    torch.cuda.synchronize()
    assert ops.launches[name] == before + 1
    want = plain_fn().float()
    assert got.shape == want.shape
    assert torch.isfinite(got).all()
    err = float((got - want).abs().max())
    assert err <= TOL[dtype] * float(want.abs().max()), err


# (kernel size, input parts' channels, Cout, per-sample weights, full epilogue, h, w)
CONV = [
    (3, [5, 11], 16, False, True, 13, 37),
    (3, [3], 64, True, False, 8, 32),
    (3, [64, 64], 128, False, True, 17, 65),
    (1, [16], 24, True, True, 9, 33),
    (1, [16, 16, 16], 16, False, False, 3, 5),
]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CONV, ids=[f"k{c[0]}-{sum(c[1])}to{c[2]}" for c in CONV])
def test_conv_kernel_matches_plain(dev, case, dtype):
    k, chans, cout, per_sample, full, h, w = case
    rng = np.random.default_rng(sum(chans) + cout)
    b = 2
    cin = sum(chans)
    parts = [_rand(rng, (b, c, h, w), dtype, dev) for c in chans]
    weight = _rand(rng, ((b,) if per_sample else ()) + (cout, cin, k, k), dtype, dev,
                   (cin * k * k) ** -0.5)
    bias = _rand(rng, (cout,), dtype, dev, 0.1)
    extra = {}
    if full:
        extra = dict(pre_add=_rand(rng, (b, cout, h, w), dtype, dev),
                     out_scale=torch.from_numpy(rng.uniform(0.5, 1.5, (b, cout))
                                                .astype(np.float32)).to(dev),
                     lrelu=(0.6, 0.4), residual=_rand(rng, (b, cout, h, w), dtype, dev))
    name = "conv3x3" if k == 3 else "conv1x1"
    _agree(lambda: conv_fused(parts, weight, bias, **extra),
           lambda: conv_fused_plain(parts, weight, bias, extra.get("pre_add"),
                                    extra.get("out_scale"), extra.get("lrelu"),
                                    extra.get("residual")), dtype, name)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("c,h,w", [(16, 5, 7), (32, 9, 18), (64, 6, 33)])
def test_sta_kernel_matches_plain(dev, c, h, w, dtype):
    rng = np.random.default_rng(c + h)
    x, st = _rand(rng, (2, c, h, w), dtype, dev), _rand(rng, (2, c, h, w), dtype, dev)
    wk = _rand(rng, (25 * c, c, 1, 1), dtype, dev, c ** -0.5)
    bk = _rand(rng, (25 * c,), dtype, dev, 0.1)
    _agree(lambda: sta_conv_fused(x, st, wk, bk), lambda: sta_conv_fused_plain(x, st, wk, bk),
           dtype, "sta")


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("scale", [(2.5, 1.7), (4.0, 4.0)])
def test_stau_kernel_matches_plain(dev, scale, dtype):
    """The reference STAU weights at C=32 (tests/goldens/stau_state.npz),
    with the sampler planes of their own coordinate head."""
    m = STAUpsample(32)
    m.load_state_dict({k: torch.from_numpy(v) for k, v in
                       np.load(os.path.join(GOLDEN_DIR, "stau_state.npz")).items()})
    m.to(dev)
    rng = np.random.default_rng(7)
    h, w = 10, 12
    x, sta = _rand(rng, (2, 32, h, w), dtype, dev), _rand(rng, (2, 32, h, w), dtype, dev)
    with torch.no_grad():
        pix = stau_sampler_planes(_stau_head(m, h, w, scale, dtype, dev), scale, h, w)
    assert tuple(pix.shape[1:]) == get_hw(h, w, scale)
    args = (x, sta, pix, m.weight_compress.to(dtype), m.weight_expand.to(dtype),
            m.fusion.weight.to(dtype), m.fusion.bias)
    _agree(lambda: stau_upsample_fused(*args), lambda: stau_upsample_fused_plain(*args),
           dtype, "stau")


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("c,h0,w0,scale", [(16, 9, 13, (2.5, 1.7)), (64, 11, 14, (1.5, 3.5))])
def test_tail_kernel_matches_plain(dev, c, h0, w0, scale, dtype):
    rng = np.random.default_rng(c + h0)
    H, W = get_hw(h0, w0, scale)
    sr = _rand(rng, (2, c, H, W), dtype, dev)
    xc = torch.from_numpy(rng.random((2, 3, h0, w0)).astype(np.float32)).to(dev, dtype)
    o = tail_operands(h0, w0, H, W, dev)
    args = (sr, xc, o["tail_j0"], o["tail_wy"], o["tail_c0"], o["tail_cw"],
            _rand(rng, (3, c, 3, 3), dtype, dev, 0.1), _rand(rng, (3,), dtype, dev, 0.1))
    _agree(lambda: tail_fused(*args), lambda: tail_fused_plain(*args), dtype, "tail")


@pytest.mark.parametrize("scale", [(2.0, 2.0), (1.5, 3.5)])
def test_small_forward_on_the_card_matches_torch_golden(dev, scale):
    io = np.load(os.path.join(GOLDEN_DIR, "savsr_small_forward.npz"))
    model = SAVSR(**SMALL_CFG).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           np.load(os.path.join(GOLDEN_DIR, "savsr_small_state.npz")).items()})
    model.to(dev)
    ops.reset_counts()
    y = model(torch.from_numpy(io["x"]).to(dev), scale).cpu().numpy()
    assert all(v > 0 for v in ops.launches.values()), ops.launches
    assert not any(ops.plain_cuda_calls.values()), ops.plain_cuda_calls
    assert np.abs(y - io[f"y_{scale[0]}_{scale[1]}"]).max() <= 1e-5


# (B, Cin, H, W, Cout, k, padding): partial tiles in every direction, Cin and
# Cout off the 32/64 tiles, every padding of k = 3, and k = 1
OSCONV_SHAPES = [(2, 48, 13, 10, 32, 3, 1), (1, 16, 10, 12, 8, 3, 0), (3, 40, 9, 37, 72, 3, 2),
                 (2, 24, 7, 33, 16, 1, 0), (8, 192, 60, 60, 64, 3, 1)]


def _osconv_inputs(shape, dtype, dev):
    b, cin, h, w, cout, k, pad = shape
    rng = np.random.default_rng(sum(shape))
    x = _rand(rng, (b, cin, h, w), dtype, dev)
    agg = _rand(rng, (b, k, k, cin, cout), dtype, dev, std=(cin * k * k) ** -0.5)
    g = _rand(rng, (b, cout, h + 2 * pad - k + 1, w + 2 * pad - k + 1), dtype, dev)
    return x, agg, g, k, pad


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", OSCONV_SHAPES, ids=str)
def test_osconv_agg_kernel_ragged(dev, shape, dtype):
    from savsr_tpu_torch.ops.osconv import osconv_agg, osconv_agg_plain

    x, agg, _, _, pad = _osconv_inputs(shape, dtype, dev)
    _agree(lambda: osconv_agg(x, agg, pad), lambda: osconv_agg_plain(x, agg, pad), dtype,
           "osconv_agg")


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", OSCONV_SHAPES, ids=str)
def test_osconv_dagg_kernel_ragged(dev, shape, dtype):
    """The weight gradient is f32 for both input types, so one tolerance:
    1e-4 x max|plain| (the kernel sums the pixels chunk by chunk, the plain
    version in einsum's order); it is the same from run to run."""
    from savsr_tpu_torch.ops.osconv import osconv_dagg, osconv_dagg_plain

    x, _, g, k, pad = _osconv_inputs(shape, dtype, dev)
    got = osconv_dagg(x, g, k, k, pad)
    again = osconv_dagg(x, g, k, k, pad)
    torch.cuda.synchronize()
    want = osconv_dagg_plain(x, g, k, k, pad)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, again)
    err = float((got - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), err


@pytest.mark.parametrize("shape", OSCONV_SHAPES[:3], ids=str)
def test_osconv_agg_train_gradients_on_card(dev, shape):
    """The Function's dx and dagg (kernels) against autograd through the
    plain version, f32: 1e-4 x the gradient's max (summation order)."""
    from savsr_tpu_torch.ops.osconv import osconv_agg_plain, osconv_agg_train

    x, agg, g, _, pad = _osconv_inputs(shape, torch.float32, dev)
    grads = []
    for fn in (osconv_agg_train, osconv_agg_plain):
        xr, ar = x.clone().requires_grad_(), agg.clone().requires_grad_()
        (fn(xr, ar, pad) * g).sum().backward()
        grads.append((xr.grad, ar.grad))
    for got, want in zip(*grads):
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
