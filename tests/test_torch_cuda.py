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
from savsr_tpu_torch.ops.stau import (stau_upsample_fused, stau_upsample_fused_plain,
                                      stau_window_plan)
from savsr_tpu_torch.ops.tail import tail_fused, tail_fused_plain

pytestmark = pytest.mark.cuda

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]
SERVING_KERNELS = ("conv3x3", "conv1x1", "sta", "stau", "tail")
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
    return got


# (kernel size, input parts' channels, Cout, per-sample weights, full epilogue,
#  h, w, parts as frame views of one [B, T, C, h, w] tensor). The bf16 kernel
# works in 64-channel x 4-row x 64-column tiles and 16-channel steps, each
# part from its own TMA map: Cin off the 16-channel step across parts (3;
# 5+11; 3+3; 24+40), W below, at and above 64 and off a multiple of 8 (the
# pitch-padded copy: 37, 65, 33, 5, 130, 45), H off the 4-row tile, Cout 16,
# 24, 64 and 128, and parts whose batch stride is not C*h*w.
CONV = [
    (3, [5, 11], 16, False, True, 13, 37, False),
    (3, [3], 64, True, False, 8, 32, False),
    (3, [64, 64], 128, False, True, 17, 65, False),
    (1, [16], 24, True, True, 9, 33, False),
    (1, [16, 16, 16], 16, False, False, 3, 5, False),
    (3, [3, 3], 64, False, True, 6, 64, True),
    (3, [3, 3, 3], 64, True, True, 9, 45, True),
    (3, [64], 64, False, False, 7, 200, False),
    (3, [24, 40], 24, True, True, 5, 130, False),
    (1, [3, 64], 128, False, True, 11, 72, False),
]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CONV, ids=[f"k{c[0]}-{sum(c[1])}to{c[2]}" for c in CONV])
def test_conv_kernel_matches_plain(dev, case, dtype):
    """Kernel against plain version, and a second launch on the same inputs
    bit for bit (no atomics, a fixed summation order)."""
    k, chans, cout, per_sample, full, h, w, frames = case
    rng = np.random.default_rng(sum(chans) + cout)
    b = 2
    cin = sum(chans)
    if frames:
        clip = _rand(rng, (b, len(chans), chans[0], h, w), dtype, dev)
        parts = [clip[:, i] for i in range(len(chans))]
    else:
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
    got = _agree(lambda: conv_fused(parts, weight, bias, **extra),
                 lambda: conv_fused_plain(parts, weight, bias, extra.get("pre_add"),
                                          extra.get("out_scale"), extra.get("lrelu"),
                                          extra.get("residual")), dtype, name)
    with torch.no_grad():
        again = conv_fused(parts, weight, bias, **extra).float()
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("c,h,w", [(16, 5, 7), (32, 9, 18), (64, 6, 33)])
def test_sta_kernel_matches_plain(dev, c, h, w, dtype):
    rng = np.random.default_rng(c + h)
    x, st = _rand(rng, (2, c, h, w), dtype, dev), _rand(rng, (2, c, h, w), dtype, dev)
    wk = _rand(rng, (25 * c, c, 1, 1), dtype, dev, c ** -0.5)
    bk = _rand(rng, (25 * c,), dtype, dev, 0.1)
    _agree(lambda: sta_conv_fused(x, st, wk, bk), lambda: sta_conv_fused_plain(x, st, wk, bk),
           dtype, "sta")


# the bf16 STA kernel (tensor cores: 8x8-pixel tiles, all 25 taps' weights in
# shared memory, the K product on wgmma): C 16, 32 and 64, h and w off the
# tile (5x7, 9x18, 6x33, 37x61), batch 1 and 8 (b, c, (h, w))
STA_BF16 = [(b, c, hw) for c in (16, 32, 64)
            for b, hw in ((1, (5, 7)), (8, (9, 18)), (1, (6, 33)), (8, (37, 61)))]


@pytest.mark.parametrize("case", STA_BF16, ids=[f"b{c[0]}-c{c[1]}-{c[2][0]}x{c[2][1]}"
                                                for c in STA_BF16])
def test_sta_bf16_kernel_matches_plain(dev, case):
    """Inputs of std 4 and weights of std 2/sqrt(C), so that K spans many
    bf16 binades and its rounding point matters; each replicate-padded
    border (two rows or columns at each of the four edges) on its own, and a
    second launch bit for bit. The launch went through the tensor-core
    route (its packed weights are on the weight)."""
    b, c, (h, w) = case
    rng = np.random.default_rng(c + h + w)
    x, st = (_rand(rng, (b, c, h, w), torch.bfloat16, dev, 4.0) for _ in range(2))
    wk = _rand(rng, (25 * c, c, 1, 1), torch.bfloat16, dev, 2 * c ** -0.5)
    bk = _rand(rng, (25 * c,), torch.bfloat16, dev, 0.5)
    got = _agree(lambda: sta_conv_fused(x, st, wk, bk), lambda: sta_conv_fused_plain(x, st, wk, bk),
                 torch.bfloat16, "sta")
    assert hasattr(wk, "_savsr_sta_packed")
    with torch.no_grad():
        want = sta_conv_fused_plain(x, st, wk, bk).float()
        again = sta_conv_fused(x, st, wk, bk).float()
    assert torch.equal(got, again)
    tol = TOL[torch.bfloat16] * float(want.abs().max())
    for edge in (np.s_[..., :2, :], np.s_[..., -2:, :], np.s_[..., :, :2], np.s_[..., :, -2:]):
        assert float((got[edge] - want[edge]).abs().max()) <= tol


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


# the bf16 STAU kernel (tensor cores, tiles of 8 HR rows x 64 HR columns,
# staged LR windows): C 32 and 64, the three serving scales, LR widths off
# and on a multiple of 8 (the landing copy's plain loads and its cp.async),
# every H and W off the tile, batch 1 and 8 (b, c, (h, w), scale)
STAU_BF16 = [(b, c, hw, scale) for b, c, hw in ((1, 32, (13, 23)), (8, 64, (12, 40)),
                                                 (8, 32, (9, 16)), (1, 64, (17, 21)))
             for scale in ((4.0, 4.0), (1.5, 3.5), (3.05, 3.05))]


def _stau_bf16_case(dev, b, c, hw, scale, seed, large=False):
    m = STAUpsample(c)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32) * 0.3))
    m.to(dev)
    h, w = hw
    with torch.no_grad():
        pix = stau_sampler_planes(_stau_head(m, h, w, scale, torch.float32, dev), scale, h, w)
    if large:  # offsets of up to +-3 LR rows/columns x 8 on the upper left tiles
        off = torch.from_numpy(rng.uniform(-24, 24, (4, 16, 64)).astype(np.float32)).to(dev)
        pix[:4, :16, :64] += off
    plan = stau_window_plan(pix, h, w)
    x, sta = _rand(rng, (b, c, h, w), torch.bfloat16, dev), _rand(rng, (b, c, h, w),
                                                                   torch.bfloat16, dev)
    args = (x, sta, pix, m.weight_compress.to(torch.bfloat16),
            m.weight_expand.to(torch.bfloat16), m.fusion.weight.to(torch.bfloat16), m.fusion.bias)
    _agree(lambda: stau_upsample_fused(*args, plan=plan),
           lambda: stau_upsample_fused_plain(*args), torch.bfloat16, "stau")
    return plan


@pytest.mark.parametrize("case", STAU_BF16, ids=[f"b{c[0]}-c{c[1]}-{c[2][0]}x{c[2][1]}-x{c[3][0]}"
                                                 for c in STAU_BF16])
def test_stau_bf16_kernel_matches_plain(dev, case):
    plan = _stau_bf16_case(dev, *case, seed=sum(case[2]) + case[1])
    assert bool((plan[:, 4] > 0).all())  # every tile staged


@pytest.mark.parametrize("b,c", [(1, 64), (8, 32)])
def test_stau_bf16_kernel_direct_tiles(dev, b, c):
    """Large offsets: the plan marks tiles for the gather from device
    memory, and those tiles agree as well."""
    plan = _stau_bf16_case(dev, b, c, (20, 40), (4.0, 4.0), seed=c, large=True)
    assert 0 < int((plan[:, 4] == 0).sum()) < plan.shape[0]


# the bf16 tail kernel (tensor cores, 128-px strips walked down runs of rows):
# (b, c, H, W, h0, w0): W under, over and off the strip, on and off a
# multiple of 8 (16-byte loads or plain ones), H short of a run and long
# enough for several, C 16, 32 and 64, batch 1 and 8
TAIL_BF16 = [(8, 64, 37, 300, 10, 75), (1, 32, 45, 256, 15, 64), (1, 64, 16, 136, 4, 34),
             (2, 16, 5, 33, 3, 11), (8, 64, 90, 128, 30, 32), (1, 48, 23, 200, 8, 50)]


@pytest.mark.parametrize("case", TAIL_BF16, ids=[f"b{c[0]}-c{c[1]}-{c[2]}x{c[3]}"
                                                 for c in TAIL_BF16])
def test_tail_bf16_kernel_matches_plain(dev, case):
    b, c, H, W, h0, w0 = case
    rng = np.random.default_rng(c + H)
    sr = _rand(rng, (b, c, H, W), torch.bfloat16, dev)
    xc = torch.from_numpy(rng.random((b, 3, h0, w0)).astype(np.float32)).to(dev, torch.bfloat16)
    o = tail_operands(h0, w0, H, W, dev)
    args = (sr, xc, o["tail_j0"], o["tail_wy"], o["tail_c0"], o["tail_cw"],
            _rand(rng, (3, c, 3, 3), torch.bfloat16, dev, 0.1),
            _rand(rng, (3,), torch.bfloat16, dev, 0.1))
    _agree(lambda: tail_fused(*args), lambda: tail_fused_plain(*args), torch.bfloat16, "tail")


@pytest.mark.parametrize("scale", [(2.0, 2.0), (1.5, 3.5)])
def test_small_forward_on_the_card_matches_torch_golden(dev, scale):
    io = np.load(os.path.join(GOLDEN_DIR, "savsr_small_forward.npz"))
    model = SAVSR(**SMALL_CFG).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           np.load(os.path.join(GOLDEN_DIR, "savsr_small_state.npz")).items()})
    model.to(dev)
    ops.reset_counts()
    y = model(torch.from_numpy(io["x"]).to(dev), scale).cpu().numpy()
    # every serving kernel ran (the OSConv kernels are the training path's)
    assert all(ops.launches[k] > 0 for k in SERVING_KERNELS), ops.launches
    assert not any(ops.plain_cuda_calls.values()), ops.plain_cuda_calls
    assert np.abs(y - io[f"y_{scale[0]}_{scale[1]}"]).max() <= 1e-5


# (B, Cin, H, W, Cout, k, padding): partial tiles in every direction, Cin and
# Cout off the 32/64 tiles, every padding of k = 3, and k = 1. In bf16 the
# cases at padding k//2 run the tensor-core kernels (the bf16 conv's 64-Cout
# x 4-row x 64-px tiles for agg; 64-Cin x 64-Cout blocks walking 64-px row
# boxes for dagg); the last five aim at their ragged edges: Cin off 64 (100,
# 40, 72), W 60 and 130 (pitch-padded copies; 130 also crosses column tiles,
# so the halo boxes are used), W 24 (a multiple of 8, read in place), H 13,
# 6 and 37 (off the 4-row tile; 37 cuts into row chunks of 10, 10, 10 and
# 7), Cout 64 and 72, and the training shape 320 -> 64; then the third
# training shape, 64 -> 64. In f32 the weight gradient's CUDA-core kernel
# walks 64-column segments (130: three) and one-wave row chunks
OSCONV_SHAPES = [(2, 48, 13, 10, 32, 3, 1), (1, 16, 10, 12, 8, 3, 0), (3, 40, 9, 37, 72, 3, 2),
                 (2, 24, 7, 33, 16, 1, 0), (8, 192, 60, 60, 64, 3, 1),
                 (2, 100, 13, 60, 64, 3, 1), (2, 72, 9, 24, 72, 3, 1), (1, 40, 6, 130, 64, 3, 1),
                 (3, 40, 5, 130, 72, 1, 0), (8, 320, 60, 60, 64, 3, 1), (8, 64, 37, 24, 64, 3, 1),
                 (8, 64, 60, 60, 64, 3, 1)]


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
def test_osconv_agg_dx_kernel_ragged(dev, shape, dtype):
    """The backward's dx call on agg as it lies (bf16 at padding k//2: the
    flip and channel swap folded into the tensor-core repack) against the
    plain version on the flipped, swapped weight."""
    from savsr_tpu_torch.ops.osconv import osconv_agg_dx, osconv_agg_plain

    _, agg, g, k, pad = _osconv_inputs(shape, dtype, dev)
    flipped = agg.flip(1, 2).transpose(3, 4)
    _agree(lambda: osconv_agg_dx(g, agg, pad), lambda: osconv_agg_plain(g, flipped, k - 1 - pad),
           dtype, "osconv_agg")


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


@pytest.mark.parametrize("shape", [OSCONV_SHAPES[i] for i in (0, 4, 5, 7, 9)], ids=str)
def test_osconv_agg_train_gradients_on_card_bf16(dev, shape):
    """bf16 at padding 1, the training path: the Function's dx (the folded
    flip-and-swap repack on the tensor cores) and dagg (the tensor-core
    weight gradient, cast to bf16) against autograd through the plain
    version: 2e-2 x the gradient's max (each side rounds once to bf16)."""
    from savsr_tpu_torch.ops.osconv import osconv_agg_plain, osconv_agg_train

    x, agg, g, _, pad = _osconv_inputs(shape, torch.bfloat16, dev)
    grads = []
    for fn in (osconv_agg_train, osconv_agg_plain):
        xr, ar = x.clone().requires_grad_(), agg.clone().requires_grad_()
        (fn(xr, ar, pad).float() * g.float()).sum().backward()
        grads.append((xr.grad, ar.grad))
    for got, want in zip(*grads):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        err = float((got.float() - want.float()).abs().max())
        assert err <= TOL[torch.bfloat16] * float(want.float().abs().max()), err
