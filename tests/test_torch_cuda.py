"""The port's CUDA kernels against their plain versions on the card, at
small and ragged shapes the serving run does not reach (partial tiles,
C = 16 and 32, two samples), and the small-config forward on the card
against the torch golden. Needs a CUDA card, and skips without one. On a
machine with a card:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: the repo's conftest imports JAX, which the port's
machines need not have). Tolerances as in chip_smoke.py: f32 1e-4 x
max|plain| (summation order), bf16 2e-2 x max|plain| (one bf16 rounding);
the fast tier's kernels f32's where they round only their inputs (the
convs, STA), and where they round values inside (STAU, the tail) max abs one
bf16 ulp of the output's scale, 2^-8, and mean abs 1e-5 of it (a rounding
point misplaced for every value passes the first and fails the second:
scripts/fast_fault_check.py).
"""

import os

import numpy as np
import pytest
import torch

from savsr_tpu_torch import ops
from savsr_tpu_torch.archs.arch_util import float32_precision
from savsr_tpu_torch.archs.savsr_arch import (SAVSR, STAUpsample, _stau_head, get_hw,
                                              stau_sampler_planes, tail_operands)
from savsr_tpu_torch.ops.conv import (Pair, conv_fused, conv_fused_fast, conv_fused_fast_plain,
                                      conv_fused_plain, conv_fused_split,
                                      conv_fused_split_plain, pair_merge, pair_split)
from savsr_tpu_torch.ops.sta import (sta_conv_fused, sta_conv_fused_fast,
                                     sta_conv_fused_fast_plain, sta_conv_fused_plain)
from savsr_tpu_torch.ops.stau import (plan_geometry, stau_upsample_fused,
                                      stau_upsample_fused_fast, stau_upsample_fused_fast_plain,
                                      stau_upsample_fused_plain, stau_window_plan)
from savsr_tpu_torch.ops.tail import (tail_fused, tail_fused_fast, tail_fused_fast_plain,
                                      tail_fused_plain)

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
def _agree(kernel_fn, plain_fn, dtype, name, tol=None, mean_tol=None):
    """``tol`` (relative to max|plain|) overrides TOL[dtype] for the max abs
    error; ``mean_tol`` (relative too) also bounds the mean abs error."""
    before = ops.launches[name]
    got = kernel_fn().float()
    torch.cuda.synchronize()
    assert ops.launches[name] == before + 1
    want = plain_fn().float()
    assert got.shape == want.shape
    assert torch.isfinite(got).all()
    diff, scale = (got - want).abs(), float(want.abs().max())
    err = float(diff.max())
    assert err <= (TOL[dtype] if tol is None else tol) * scale, err
    if mean_tol is not None:
        assert float(diff.mean()) <= mean_tol * scale, float(diff.mean())
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


def _conv_f32_case(dev, k, chans, cout, per_sample, epi, b, h, w, seed, frames=False):
    """Inputs of one f32 conv; ``epi``: the epilogue terms to switch on."""
    rng = np.random.default_rng(seed)
    cin = sum(chans)
    if frames:
        clip = _rand(rng, (b, len(chans), chans[0], h, w), torch.float32, dev)
        parts = [clip[:, i] for i in range(len(chans))]
    else:
        parts = [_rand(rng, (b, c, h, w), torch.float32, dev) for c in chans]
    weight = _rand(rng, ((b,) if per_sample else ()) + (cout, cin, k, k), torch.float32, dev,
                   (cin * k * k) ** -0.5)
    terms = dict(
        bias=_rand(rng, (cout,), torch.float32, dev, 0.1),
        pre_add=_rand(rng, (b, cout, h, w), torch.float32, dev),
        out_scale=torch.from_numpy(rng.uniform(0.5, 1.5, (b, cout)).astype(np.float32)).to(dev),
        shared_scale=torch.from_numpy(rng.uniform(0.5, 1.5, cout).astype(np.float32)).to(dev),
        lrelu=(0.6, 0.4), residual=_rand(rng, (b, cout, h, w), torch.float32, dev))
    if "shared_scale" in epi:
        terms["out_scale"] = terms["shared_scale"]
    kw = {t: terms[t] for t in ("bias", "pre_add", "out_scale", "lrelu", "residual")
          if t in epi or (t == "out_scale" and "shared_scale" in epi)}
    return parts, weight, kw


ALL_TERMS = ("bias", "pre_add", "out_scale", "lrelu", "residual")
# the f32 kernel (csrc/conv.cu conv_f32_kernel: 64-channel x 4-row x 64-column
# tiles, 8- or 16-channel stages, 4-byte copies off 16-byte alignment): (k,
# parts' channels, Cout, per-sample weights, epilogue terms, b, h, w). Widths
# 1, 7, 33, 61 and 321 (off a multiple of 4: the 4-byte path) and 64 (the
# 16-byte path of the 1x1), heights 1, 5 and 181, Cin 3, 6 and 67, 1 to 8
# parts, Cout 64, 128 and 96, batch 1 and 8; small outputs split the Cin
# reduction (the second pass runs the epilogue)
CONV_F32 = [
    (3, [64], 64, False, ALL_TERMS, 1, 1, 1),
    (3, [3], 64, False, ("bias", "lrelu"), 8, 5, 7),
    (3, [6], 96, True, ALL_TERMS, 1, 181, 33),
    (3, [67], 128, False, ALL_TERMS, 1, 5, 61),
    (3, [64, 3], 64, True, (), 8, 5, 321),
    (3, [8] * 8, 64, False, ALL_TERMS, 1, 5, 33),
    (3, [64, 64], 96, True, ("lrelu", "residual"), 8, 12, 64),
    (1, [67], 96, False, ALL_TERMS, 8, 5, 61),
    (1, [3, 6], 64, True, ALL_TERMS, 1, 181, 7),
    (1, [16] * 8, 128, True, ("bias", "lrelu"), 1, 1, 321),
    (1, [64] * 3, 64, False, ("bias", "lrelu"), 8, 9, 64),
    (1, [3], 64, False, ALL_TERMS, 8, 5, 1),
]


@pytest.mark.parametrize("case", CONV_F32, ids=[
    f"k{c[0]}-{'+'.join(map(str, c[1]))}to{c[2]}-b{c[5]}-{c[6]}x{c[7]}" for c in CONV_F32])
def test_conv_f32_kernel_matches_plain(dev, case):
    """The f32 kernel against the plain version at f32's tolerance, and a
    second launch bit for bit (split partials added in chunk order)."""
    k, chans, cout, per_sample, epi, b, h, w = case
    parts, weight, kw = _conv_f32_case(dev, k, chans, cout, per_sample, epi, b, h, w,
                                       sum(chans) + cout + h + w)
    got = _agree(lambda: conv_fused(parts, weight, **kw),
                 lambda: conv_fused_plain(parts, weight, kw.get("bias"), kw.get("pre_add"),
                                          kw.get("out_scale"), kw.get("lrelu"),
                                          kw.get("residual")),
                 torch.float32, "conv3x3" if k == 3 else "conv1x1")
    with torch.no_grad():
        assert torch.equal(got, conv_fused(parts, weight, **kw))


@pytest.mark.parametrize("k", [3, 1])
@pytest.mark.parametrize("term", ALL_TERMS + ("shared_scale",))
@pytest.mark.parametrize("b,h,w", [(8, 20, 70), (1, 5, 33)], ids=["whole", "split"])
def test_conv_f32_epilogue_terms(dev, k, term, b, h, w):
    """Each epilogue term on its own, in the kernel's own epilogue (8 x 20x70:
    one chunk) and in the split's second pass (1 x 5x33)."""
    parts, weight, kw = _conv_f32_case(dev, k, [40, 24], 64, False, (term,), b, h, w, 7)
    _agree(lambda: conv_fused(parts, weight, **kw),
           lambda: conv_fused_plain(parts, weight, kw.get("bias"), kw.get("pre_add"),
                                    kw.get("out_scale"), kw.get("lrelu"), kw.get("residual")),
           torch.float32, "conv3x3" if k == 3 else "conv1x1")


def test_conv_f32_frames_view_parts(dev):
    """Parts that are frame views of one clip (batch stride T*C*h*w)."""
    parts, weight, kw = _conv_f32_case(dev, 3, [64] * 3, 64, True, ("lrelu",), 2, 9, 45, 3,
                                       frames=True)
    _agree(lambda: conv_fused(parts, weight, **kw),
           lambda: conv_fused_plain(parts, weight, None, None, None, kw["lrelu"]),
           torch.float32, "conv3x3")


# the split conv (B, h, w, k, input parts' channels, Cout, per-sample weight,
# residual: pair / f32 / none, output: pair / f32, raw f32 inputs, pre_add and
# out_scale): the serving path's split convs at its shape (8 x 180x320:
# conv_c and conv_sup on the raw frames, conv0 and conv2 with their pair
# residuals, the WindowUnit_l1 OSConv's per-sample weight, the WindowUnit_l2
# merge over 5 pairs, conv1, conv_last's f32 output), then batch 1 at the
# eval sweep's widths (650, 715, 671: pitch-padded TMA copies; odd widths
# take the epilogue's scalar path) and every epilogue term at once
SPLIT = [
    (8, 180, 320, 3, [3], 64, False, None, "pair", True, False),
    (8, 180, 320, 3, [6], 64, False, None, "pair", True, False),
    (8, 180, 320, 3, [64], 64, False, "pair", "pair", False, False),
    (8, 180, 320, 3, [64, 64], 64, False, "pair", "pair", False, False),
    (8, 180, 320, 3, [64] * 3, 64, True, None, "pair", False, False),
    (8, 180, 320, 3, [64] * 5, 128, False, None, "pair", False, False),
    (8, 180, 320, 1, [64] * 3, 64, False, None, "pair", False, False),
    (8, 180, 320, 3, [64], 64, False, "pair", "f32", False, False),
    (1, 36, 650, 3, [64, 64], 64, False, "pair", "pair", False, False),
    (1, 20, 715, 3, [64] * 5, 64, True, None, "pair", False, False),
    (1, 20, 671, 1, [64] * 3, 64, False, "pair", "f32", False, False),
    (2, 13, 37, 3, [24, 40], 72, True, "f32", "pair", False, True),
    (2, 9, 33, 1, [16], 24, False, "f32", "f32", True, True),
]


@pytest.mark.parametrize("case", SPLIT, ids=[
    f"k{c[3]}-{'+'.join(map(str, c[4]))}to{c[5]}-b{c[0]}-{c[1]}x{c[2]}-{c[8]}" for c in SPLIT])
def test_split_conv_kernel_matches_plain(dev, case):
    """The split conv against ``conv_fused_split_plain`` on the merged values
    at f32's tolerance (both sum exact products of bf16 values in f32, in
    other orders), and a second launch bit for bit."""
    b, h, w, k, chans, cout, per_sample, res, out, raw, pre_scale = case
    rng = np.random.default_rng(sum(chans) + cout + h + w)
    f32 = torch.float32
    parts = [_rand(rng, (b, c, h, w), f32, dev) for c in chans]
    if not raw:
        parts = [pair_split(p) for p in parts]
    cin = sum(chans)
    weight = _rand(rng, ((b,) if per_sample else ()) + (cout, cin, k, k), f32, dev,
                   (cin * k * k) ** -0.5)
    kw = dict(bias=None if per_sample else _rand(rng, (cout,), f32, dev, 0.1),
              lrelu=(0.6, 0.4), out=out)
    if res is not None:
        r = _rand(rng, (b, cout, h, w), f32, dev)
        kw["residual"] = pair_split(r) if res == "pair" else r
    if pre_scale:
        kw.update(pre_add=_rand(rng, (b, cout, h, w), f32, dev),
                  out_scale=torch.from_numpy(rng.uniform(0.5, 1.5, (b, cout))
                                             .astype(np.float32)).to(dev))

    def merged(y):
        assert isinstance(y, Pair) == (out == "pair")
        return pair_merge(y) if out == "pair" else y

    name = "conv3x3_split" if k == 3 else "conv1x1_split"
    got = _agree(lambda: merged(conv_fused_split(parts, weight, **kw)),
                 lambda: merged(conv_fused_split_plain(parts, weight, **kw)), f32, name)
    with torch.no_grad():
        assert torch.equal(got, merged(conv_fused_split(parts, weight, **kw)))


def test_small_split_forward_on_the_card(dev):
    """The small config's split forward on the card: every conv through the
    split kernels (none through the native ones), STA, STAU and the tail on
    their f32 kernels, no plain version on the card; < 2e-3 from the strict
    forward on the card (the tier's gate, tests/test_torch_split.py)."""
    io = np.load(os.path.join(GOLDEN_DIR, "savsr_small_forward.npz"))
    state = {k: torch.from_numpy(v) for k, v in
             np.load(os.path.join(GOLDEN_DIR, "savsr_small_state.npz")).items()}
    x = torch.from_numpy(io["x"]).to(dev)
    outs = {}
    for prec in ("native", "split"):
        model = SAVSR(**SMALL_CFG, conv_precision=prec).eval()
        model.load_state_dict(state)
        model.to(dev)
        ops.reset_counts()
        outs[prec] = model(x, (1.5, 3.5))
    assert all(ops.launches[k] > 0 for k in ("conv3x3_split", "conv1x1_split", "sta", "stau",
                                             "tail")), ops.launches
    assert ops.launches["conv3x3"] == ops.launches["conv1x1"] == 0, ops.launches
    assert not any(ops.plain_cuda_calls.values()), ops.plain_cuda_calls
    assert float((outs["split"] - outs["native"]).abs().max()) < 2e-3


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


# the f32 STA kernel (CUDA cores: persistent 8 x 32-pixel tiles, C padded to
# 16, 32 or 64): C 16, 32 and 64, h and w off the tile (5x7, 9x37, 17x33,
# 12x70), batch 1 and 8 (b, c, (h, w))
STA_F32 = [(b, c, hw) for c in (16, 32, 64)
           for b, hw in ((1, (5, 7)), (8, (9, 37)), (1, (17, 33)), (8, (12, 70)))]


def _sta_f32_check(dev, dtype, b, c, h, w):
    """Kernel against plain version with inputs of std 4 and weights of std
    2/sqrt(C) (K spans many binades), each replicate-padded border (two rows
    or columns at each edge) on its own, a second launch bit for bit, and
    the f32 packing on the weight."""
    rng = np.random.default_rng(c + h + w)
    x, st = (_rand(rng, (b, c, h, w), dtype, dev, 4.0) for _ in range(2))
    wk = _rand(rng, (25 * c, c, 1, 1), dtype, dev, 2 * c ** -0.5)
    bk = _rand(rng, (25 * c,), dtype, dev, 0.5)
    got = _agree(lambda: sta_conv_fused(x, st, wk, bk), lambda: sta_conv_fused_plain(x, st, wk, bk),
                 dtype, "sta")
    assert hasattr(wk, "_savsr_packed")
    with torch.no_grad():
        want = sta_conv_fused_plain(x, st, wk, bk).float()
        again = sta_conv_fused(x, st, wk, bk).float()
    assert torch.equal(got, again)
    tol = TOL[dtype] * float(want.abs().max())
    for edge in (np.s_[..., :2, :], np.s_[..., -2:, :], np.s_[..., :, :2], np.s_[..., :, -2:]):
        assert float((got[edge] - want[edge]).abs().max()) <= tol


@pytest.mark.parametrize("case", STA_F32, ids=[f"b{c[0]}-c{c[1]}-{c[2][0]}x{c[2][1]}"
                                               for c in STA_F32])
def test_sta_f32_kernel_matches_plain(dev, case):
    b, c, (h, w) = case
    _sta_f32_check(dev, torch.float32, b, c, h, w)


@pytest.mark.parametrize("c", [24, 48])
def test_sta_bf16_other_channels_kernel_matches_plain(dev, c):
    """bf16 at a C the tensor cores do not take: the CUDA-core kernel on
    inputs widened to f32, K rounded to bf16, the output rounded once."""
    _sta_f32_check(dev, torch.bfloat16, 8, c, 9, 37)


# the f32 STAU kernel (CUDA cores, tiles of 2 HR rows x 64 HR columns, staged
# LR windows as channel rows): C 16, 32 and 64, the three serving scales, LR
# widths off a multiple of 4 (4-byte copies), a multiple of 4 but not 8, and
# a multiple of 8 (16-byte copies), every H and W off the tile, batch 1 and
# 8 (b, c, (h, w), scale)
STAU_F32 = [(b, c, hw, scale) for b, c, hw in ((1, 16, (13, 23)), (8, 64, (12, 40)),
                                                (8, 32, (9, 20)), (1, 64, (17, 21)))
            for scale in ((4.0, 4.0), (1.5, 3.5), (3.05, 3.05))]


def _stau_f32_case(dev, b, c, hw, scale, seed, large=False):
    """Seeded weights (std 0.3), the sampler planes of their coordinate head
    (plus offsets of up to +-24 LR px on the upper left HR block with
    ``large``), the f32 plan; kernel against plain version, and a second
    launch bit for bit. Returns the plan."""
    m = STAUpsample(c)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32) * 0.3))
    m.to(dev)
    h, w = hw
    with torch.no_grad():
        pix = stau_sampler_planes(_stau_head(m, h, w, scale, torch.float32, dev), scale, h, w)
    if large:
        off = torch.from_numpy(rng.uniform(-24, 24, (4, 16, 64)).astype(np.float32)).to(dev)
        pix[:4, :16, :64] += off
    plan = stau_window_plan(pix, h, w, *plan_geometry(torch.float32))
    x, sta = _rand(rng, (b, c, h, w), torch.float32, dev), _rand(rng, (b, c, h, w),
                                                                  torch.float32, dev)
    args = (x, sta, pix, m.weight_compress, m.weight_expand, m.fusion.weight, m.fusion.bias)
    got = _agree(lambda: stau_upsample_fused(*args, plan=plan),
                 lambda: stau_upsample_fused_plain(*args), torch.float32, "stau")
    with torch.no_grad():
        assert torch.equal(got, stau_upsample_fused(*args, plan=plan).float())
    return plan


@pytest.mark.parametrize("case", STAU_F32, ids=[f"b{c[0]}-c{c[1]}-{c[2][0]}x{c[2][1]}-x{c[3][0]}"
                                                for c in STAU_F32])
def test_stau_f32_kernel_matches_plain(dev, case):
    plan = _stau_f32_case(dev, *case, seed=sum(case[2]) + case[1])
    assert bool((plan[:, 4] > 0).all())  # every tile staged


@pytest.mark.parametrize("b,c", [(1, 64), (8, 32)])
def test_stau_f32_kernel_direct_tiles(dev, b, c):
    """Large offsets: the f32 plan marks tiles for the gather from device
    memory, and those tiles agree as well."""
    plan = _stau_f32_case(dev, b, c, (20, 40), (4.0, 4.0), seed=c, large=True)
    assert 0 < int((plan[:, 4] == 0).sum()) < plan.shape[0]


def test_stau_f32_kernel_other_widths(dev):
    """C = 24 (padded to 32), 12 outputs, 3 experts, and no plan given (the
    wrapper plans)."""
    m = STAUpsample(24, num_experts=3)
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32) * 0.3))
    m.to(dev)
    h, w, scale = 11, 19, (2.5, 1.7)
    with torch.no_grad():
        pix = stau_sampler_planes(_stau_head(m, h, w, scale, torch.float32, dev), scale, h, w)
    x, sta = (_rand(rng, (2, 24, h, w), torch.float32, dev) for _ in range(2))
    args = (x, sta, pix, m.weight_compress, m.weight_expand,
            _rand(rng, (12, 48, 1, 1), torch.float32, dev, 0.3),
            _rand(rng, (12,), torch.float32, dev, 0.3))
    _agree(lambda: stau_upsample_fused(*args), lambda: stau_upsample_fused_plain(*args),
           torch.float32, "stau")


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


def _tail_args(dev, b, c, H, W, h0, w0, dtype, seed):
    rng = np.random.default_rng(seed)
    sr = _rand(rng, (b, c, H, W), dtype, dev)
    xc = torch.from_numpy(rng.random((b, 3, h0, w0)).astype(np.float32)).to(dev, dtype)
    o = tail_operands(h0, w0, H, W, dev)
    return (sr, xc, o["tail_j0"], o["tail_wy"], o["tail_c0"], o["tail_cw"],
            _rand(rng, (3, c, 3, 3), dtype, dev, c ** -0.5 / 3),
            _rand(rng, (3,), dtype, dev, 0.1))


# the f32 tail kernel (CUDA cores, 32 x 256 tiles, a channel a stage): the
# bf16 kernel's shapes in f32 (W under, over and off the 256-px tile, on and
# off a multiple of 4 (16-byte or 4-byte staging), H short of a tile and
# over several, batch 1 and 8), and a width off a multiple of 4 over two
# tiles
TAIL_F32 = TAIL_BF16 + [(2, 64, 40, 530, 10, 133)]


@pytest.mark.parametrize("case", TAIL_F32, ids=[f"b{c[0]}-c{c[1]}-{c[2]}x{c[3]}"
                                                for c in TAIL_F32])
def test_tail_f32_kernel_matches_plain(dev, case):
    args = _tail_args(dev, *case, torch.float32, seed=case[1] + case[2])
    _agree(lambda: tail_fused(*args), lambda: tail_fused_plain(*args), torch.float32, "tail")


@pytest.mark.parametrize("c", [3, 24, 64, 96])
def test_tail_f32_kernel_channels(dev, c):
    """Any C: the weights stream with the channels (96 is over the cap of
    the kernel this one replaced)."""
    args = _tail_args(dev, 2, c, 37, 300, 10, 75, torch.float32, seed=c)
    _agree(lambda: tail_fused(*args), lambda: tail_fused_plain(*args), torch.float32, "tail")


@pytest.mark.parametrize("border", ["top", "bottom", "left", "right"])
def test_tail_f32_kernel_each_border(dev, border):
    """sr nonzero only on one border row or column (and the skip zero), so
    the output is that border's conv with the zero padding alone: 70 x 520
    spans three row tiles and three column tiles."""
    args = list(_tail_args(dev, 2, 16, 70, 520, 18, 130, torch.float32, seed=5))
    sr = torch.zeros_like(args[0])
    idx = {"top": (Ellipsis, 0, slice(None)), "bottom": (Ellipsis, -1, slice(None)),
           "left": (Ellipsis, slice(None), 0), "right": (Ellipsis, slice(None), -1)}[border]
    sr[idx] = args[0][idx]
    args[0], args[1] = sr, torch.zeros_like(args[1])
    got = _agree(lambda: tail_fused(*args), lambda: tail_fused_plain(*args), torch.float32, "tail")
    assert float(got.abs().max()) > 0.1


@pytest.mark.parametrize("scale", [(4.0, 4.0), (1.5, 3.5), (3.05, 3.05)])
def test_tail_f32_kernel_parity_outputs(dev, scale):
    """The strict parity forward's tails: 45x80 -> 180x320, 68x280, 137x244;
    a second launch gives the same bits."""
    H, W = get_hw(45, 80, scale)
    args = _tail_args(dev, 1, 64, H, W, 45, 80, torch.float32, seed=H)
    got = _agree(lambda: tail_fused(*args), lambda: tail_fused_plain(*args), torch.float32, "tail")
    assert torch.equal(got, tail_fused(*args))


@pytest.mark.parametrize("c", [24, 80])
def test_tail_bf16_other_channels(dev, c):
    """bf16 at C the tensor-core kernel does not take: widened to f32 for the
    CUDA-core kernel, with the bf16 tier's rounding points."""
    args = _tail_args(dev, 2, c, 37, 300, 10, 75, torch.bfloat16, seed=c)
    got = _agree(lambda: tail_fused(*args), lambda: tail_fused_plain(*args), torch.bfloat16,
                 "tail")
    assert tail_fused(*args).dtype == torch.bfloat16 and got.shape == (2, 3, 37, 300)


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


def test_forward_on_the_card_takes_a_channel_last_view(dev):
    """A window handed over as a permuted view of channel-last frames (as
    the eval datasets give them) gives the contiguous window's output: the
    kernels read contiguous channel planes, so the forward copies first."""
    io = np.load(os.path.join(GOLDEN_DIR, "savsr_small_forward.npz"))
    model = SAVSR(**SMALL_CFG).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           np.load(os.path.join(GOLDEN_DIR, "savsr_small_state.npz")).items()})
    model.to(dev)
    x = torch.from_numpy(io["x"]).to(dev)
    view = x.permute(0, 1, 3, 4, 2).contiguous().permute(0, 1, 4, 2, 3)
    assert not view.is_contiguous()
    assert torch.equal(model(view, (2.0, 2.0)), model(x, (2.0, 2.0)))


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


# the f32 OSConv on the f32 conv kernel (B, Cin, H, W, Cout, k, padding): the
# training shape 192 -> 64 at 8 x 60x60 (a split Cin reduction), k = 3 at
# padding 0 (16-byte copies: W 60), 1 and 2, k = 1, and ragged sizes
OSCONV_F32 = [(8, 192, 60, 60, 64, 3, 1), (2, 40, 60, 60, 64, 3, 0), (3, 40, 9, 37, 72, 3, 2),
              (2, 24, 7, 33, 16, 1, 0), (1, 67, 60, 60, 96, 1, 0), (2, 100, 13, 61, 64, 3, 1)]


@pytest.mark.parametrize("dx", [False, True], ids=["fwd", "dx"])
@pytest.mark.parametrize("shape", OSCONV_F32, ids=str)
def test_osconv_agg_f32_kernel(dev, shape, dx):
    """Forward and the dx call (agg read flipped and channel-swapped through
    strides) against the plain version, and a second launch bit for bit."""
    from savsr_tpu_torch.ops.osconv import osconv_agg, osconv_agg_dx, osconv_agg_plain

    x, agg, g, k, pad = _osconv_inputs(shape, torch.float32, dev)
    if dx:
        flipped = agg.flip(1, 2).transpose(3, 4)
        fn, plain = (lambda: osconv_agg_dx(g, agg, pad),
                     lambda: osconv_agg_plain(g, flipped, k - 1 - pad))
    else:
        fn, plain = lambda: osconv_agg(x, agg, pad), lambda: osconv_agg_plain(x, agg, pad)
    got = _agree(fn, plain, torch.float32, "osconv_agg")
    with torch.no_grad():
        assert torch.equal(got, fn())


def test_osconv_agg_f32_training_shape_splits(dev):
    """At the training shape the wrapper splits the Cin reduction (one wave
    of two blocks a SM)."""
    from savsr_tpu_torch.ops import sm_count
    from savsr_tpu_torch.ops.conv import f32_chunks

    assert f32_chunks(8, [192], 64, 60, 60, 3, sm_count(dev))[0] > 1


# ---------------------------------------------------------------------------
# the fast tier's kernels (f32 at default precision: one bf16 pass)
# ---------------------------------------------------------------------------

def _split_agree(dev, k, chans, cout, per_sample, epi, b, h, w, seed, res="pair", out="pair"):
    """The split conv against ``conv_fused_split_plain`` on the merged values
    at f32's tolerance, and a second launch bit for bit: pair inputs, the
    epilogue terms ``epi`` (as ``_conv_f32_case`` makes them), the residual
    a pair (``res`` "pair") or f32, the output a pair or f32 (``out``)."""
    parts, weight, kw = _conv_f32_case(dev, k, chans, cout, per_sample, epi, b, h, w, seed)
    pairs = [pair_split(p) for p in parts]
    if "residual" in kw and res == "pair":
        kw["residual"] = pair_split(kw["residual"])

    def merged(y):
        assert isinstance(y, Pair) == (out == "pair")
        return pair_merge(y) if out == "pair" else y

    name = "conv3x3_split" if k == 3 else "conv1x1_split"
    got = _agree(lambda: merged(conv_fused_split(pairs, weight, out=out, **kw)),
                 lambda: merged(conv_fused_split_plain(pairs, weight, out=out, **kw)),
                 torch.float32, name)
    with torch.no_grad():
        assert torch.equal(got, merged(conv_fused_split(pairs, weight, out=out, **kw)))


# the split 3x3 on the pair kernel (csrc/conv.cu conv_split_kernel<3>): widths
# read in place (64, 320: one and five column tiles) and through a
# pitch-padded copy of each plane (68, 90, 655: even, the 8-byte epilogue; 7:
# odd, the scalar one), the eval sweep's 655 and 90 among them
SPLIT_WIDTHS = [64, 68, 320, 655, 90, 7]


@pytest.mark.parametrize("w", SPLIT_WIDTHS)
def test_split_pair_kernel_widths(dev, w):
    _split_agree(dev, 3, [64], 64, False, ("bias", "lrelu", "residual"), 2, 6, w, w + 3)


@pytest.mark.parametrize("cout,per_sample", [(64, True), (128, False)])
def test_split_pair_kernel_five_pairs(dev, cout, per_sample):
    """Five pairs (the WindowUnit_l2 merge and OSConv), with a per-sample
    weight (the OSConv's) and at Cout 128 (the merge)."""
    _split_agree(dev, 3, [64] * 5, cout, per_sample, ("bias", "lrelu"), 2, 8, 72, cout + 5)


@pytest.mark.parametrize("cout", [96, 128])
@pytest.mark.parametrize("res,out", [("pair", "pair"), ("f32", "f32")])
def test_split_pair_kernel_cout_past_one_tile(dev, cout, res, out):
    _split_agree(dev, 3, [64, 3], cout, False, ALL_TERMS, 2, 9, 130, cout + 9, res, out)


@pytest.mark.parametrize("term", ALL_TERMS + ("shared_scale",))
@pytest.mark.parametrize("res,out", [("pair", "pair"), ("f32", "f32")])
def test_split_pair_kernel_epilogue_terms(dev, term, res, out):
    """Each epilogue term on its own (at an even and an odd width), with a
    pair or an f32 residual and output."""
    for w in (70, 33):
        _split_agree(dev, 3, [40, 24], 64, False, (term,), 2, 5, w, 7 + w, res, out)


def test_split_forward_runs_the_pair_kernel_for_every_conv(dev):
    """The small config's split forward: every split conv launch is
    conv_split_kernel<K> (torch.profiler's kernel names), none the bf16
    kernel (conv_wgmma_kernel, which walked each pair as the segments hi,
    lo, hi before)."""
    from torch.profiler import ProfilerActivity, profile

    io = np.load(os.path.join(GOLDEN_DIR, "savsr_small_forward.npz"))
    state = {k: torch.from_numpy(v) for k, v in
             np.load(os.path.join(GOLDEN_DIR, "savsr_small_state.npz")).items()}
    x = torch.from_numpy(io["x"]).to(dev)
    model = SAVSR(**SMALL_CFG, conv_precision="split").eval()
    model.load_state_dict(state)
    model.to(dev)
    model(x, (1.5, 3.5))
    torch.cuda.synchronize()
    ops.reset_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        model(x, (1.5, 3.5))
        torch.cuda.synchronize()
    counts = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for name in ("conv_split_kernel<3>", "conv_split_kernel<1>", "conv_wgmma_kernel"):
            if name in e.key:
                counts[name] = counts.get(name, 0) + e.count
    assert ops.launches["conv3x3_split"] > 0 and ops.launches["conv1x1_split"] > 0, ops.launches
    assert counts.get("conv_split_kernel<3>") == ops.launches["conv3x3_split"], counts
    assert counts.get("conv_split_kernel<1>") == ops.launches["conv1x1_split"], counts
    assert "conv_wgmma_kernel" not in counts, counts


FAST_INNER_TOL, FAST_INNER_MEAN_TOL = 2.0 ** -8, 1e-5


@pytest.mark.parametrize("case", CONV, ids=[f"k{c[0]}-{sum(c[1])}to{c[2]}" for c in CONV])
def test_fast_conv_kernel_matches_plain(dev, case):
    """The fast conv (the split kernel, one K segment a part, on the parts
    rounded to bf16) against its plain version at the bf16 conv's ragged
    shapes, f32 tolerance, and a second launch bit for bit."""
    k, chans, cout, per_sample, full, h, w, frames = case
    rng = np.random.default_rng(sum(chans) + cout + 1)
    b, f32 = 2, torch.float32
    cin = sum(chans)
    if frames:
        clip = _rand(rng, (b, len(chans), chans[0], h, w), f32, dev)
        parts = [clip[:, i] for i in range(len(chans))]
    else:
        parts = [_rand(rng, (b, c, h, w), f32, dev) for c in chans]
    weight = _rand(rng, ((b,) if per_sample else ()) + (cout, cin, k, k), f32, dev,
                   (cin * k * k) ** -0.5)
    kw = dict(bias=_rand(rng, (cout,), f32, dev, 0.1))
    if full:
        kw.update(pre_add=_rand(rng, (b, cout, h, w), f32, dev),
                  out_scale=torch.from_numpy(rng.uniform(0.5, 1.5, (b, cout))
                                             .astype(np.float32)).to(dev),
                  lrelu=(0.6, 0.4), residual=_rand(rng, (b, cout, h, w), f32, dev))
    name = "conv3x3_fast" if k == 3 else "conv1x1_fast"
    got = _agree(lambda: conv_fused_fast(parts, weight, **kw),
                 lambda: conv_fused_fast_plain(parts, weight, **kw), f32, name)
    with torch.no_grad():
        assert torch.equal(got, conv_fused_fast(parts, weight, **kw))


def _fast_conv_agree(dev, k, chans, cout, per_sample, epi, b, h, w, seed, frames=False):
    """The fast kernel (csrc/conv.cu conv_fast_kernel) against its plain
    version at f32's tolerance, and a second launch bit for bit."""
    parts, weight, kw = _conv_f32_case(dev, k, chans, cout, per_sample, epi, b, h, w, seed,
                                       frames=frames)
    name = "conv3x3_fast" if k == 3 else "conv1x1_fast"
    got = _agree(lambda: conv_fused_fast(parts, weight, **kw),
                 lambda: conv_fused_fast_plain(parts, weight, **kw), torch.float32, name)
    with torch.no_grad():
        assert torch.equal(got, conv_fused_fast(parts, weight, **kw))


# widths read in place by the f32 TMA maps (W % 4 == 0: 64, 68, 320, 132)
# and through a pitch-padded copy (66: even, the 8-byte epilogue; 65 and 7:
# odd, the scalar one), one to five column tiles
FAST_WIDTHS = [64, 68, 320, 132, 66, 65, 7]


@pytest.mark.parametrize("k", [3, 1])
@pytest.mark.parametrize("w", FAST_WIDTHS)
def test_fast_conv_widths(dev, k, w):
    _fast_conv_agree(dev, k, [64], 64, False, ("bias", "lrelu", "residual"), 2, 6, w, w + k)


@pytest.mark.parametrize("k,w", [(3, 320), (3, 45), (1, 64)])
def test_fast_conv_frames_view_parts(dev, k, w):
    """Parts that are frame views of one clip (batch stride T*C*h*w), as the
    window's raw frames reach conv_sup."""
    _fast_conv_agree(dev, k, [3, 3], 64, False, ("bias", "lrelu"), 2, 9, w, w + 1,
                     frames=True)


@pytest.mark.parametrize("cout,w", [(64, 96), (128, 72)])
def test_fast_conv_five_parts(dev, cout, w):
    """Five 64-channel parts (the WindowUnit_l2 merge and OSConv)."""
    _fast_conv_agree(dev, 3, [64] * 5, cout, False, ("bias",), 2, 8, w, cout + w)


@pytest.mark.parametrize("k,chans", [(3, [64] * 3), (3, [64]), (1, [64, 64])])
def test_fast_conv_per_sample_weight(dev, k, chans):
    _fast_conv_agree(dev, k, chans, 64, True, ("lrelu",), 3, 7, 70, sum(chans) + k)


@pytest.mark.parametrize("k", [3, 1])
@pytest.mark.parametrize("term", ALL_TERMS + ("shared_scale",))
def test_fast_conv_epilogue_terms(dev, k, term):
    """Each epilogue term on its own (at an even and an odd width)."""
    for w in (70, 33):
        _fast_conv_agree(dev, k, [40, 24], 64, False, (term,), 2, 5, w, 7 + w)


@pytest.mark.parametrize("k", [3, 1])
@pytest.mark.parametrize("w", [130, 67])
def test_fast_conv_rounds_ties_to_nearest_even(dev, k, w):
    """Inputs on bf16 rounding ties (the low 16 bits 0x8000, with the kept
    bit odd and even), next to them (0x7fff, 0x8001) and exact, through a
    weight whose every output channel is one tap of one input channel times
    1: each output is one rounded input, shifted by its tap, with no sum to
    reorder, so the kernel's in-kernel rounding must equal .to(bfloat16) in
    the plain version bit for bit (halo columns and borders included)."""
    rng = np.random.default_rng(w + k)
    b, c, h = 2, 16, 6
    hi = rng.integers(0x3c00, 0x4200, (b, c, h, w)) | (rng.integers(0, 2, (b, c, h, w)) << 15)
    lo = rng.choice(np.array([0x8000, 0x8000, 0x7fff, 0x8001, 0, 0x1234]), (b, c, h, w))
    x = torch.from_numpy(((hi << 16) | lo).astype(np.uint32).view(np.float32)).to(dev)
    kk = k * k
    weight = torch.zeros(kk * c, c, k, k)
    for t in range(kk):
        for ci in range(c):
            weight[t * c + ci, ci, t // k, t % k] = 1.0
    weight = weight.to(dev)
    got = conv_fused_fast([x], weight)
    want = conv_fused_fast_plain([x], weight)
    assert torch.equal(got, want)
    center = (kk // 2) * c
    assert torch.equal(got[:, center:center + c], x.to(torch.bfloat16).float())
    assert not torch.equal(got[:, center:center + c], x)  # the ties did round


@pytest.mark.parametrize("c,h,w", [(16, 5, 7), (32, 9, 18), (64, 6, 33)])
def test_fast_sta_kernel_matches_plain(dev, c, h, w):
    rng = np.random.default_rng(c + h + 1)
    f32 = torch.float32
    x, st = _rand(rng, (2, c, h, w), f32, dev), _rand(rng, (2, c, h, w), f32, dev)
    wk = _rand(rng, (25 * c, c, 1, 1), f32, dev, c ** -0.5)
    bk = _rand(rng, (25 * c,), f32, dev, 0.1)
    _agree(lambda: sta_conv_fused_fast(x, st, wk, bk),
           lambda: sta_conv_fused_fast_plain(x, st, wk, bk), f32, "sta_fast")


class _EntrySpy:
    """A kernel library whose ``savsr_*`` entry points record their calls
    (and, with ``fail``, return that CUDA error instead of launching)."""

    def __init__(self, lib, fail=None):
        self.lib, self.fail, self.called = lib, fail, []

    def __getattr__(self, name):
        fn = getattr(self.lib, name)
        if not name.startswith("savsr_") or name == "savsr_error_string":
            return fn

        def call(*args):
            self.called.append(name)
            return self.fail if self.fail is not None else fn(*args)
        return call


@pytest.mark.parametrize("c,route", [(16, "savsr_sta_fast"), (32, "savsr_sta_fast"),
                                     (64, "savsr_sta_fast"), (8, "savsr_sta_f32"),
                                     (24, "savsr_sta_f32"), (40, "savsr_sta_f32")])
def test_fast_sta_routes_by_channels(dev, c, route, monkeypatch):
    """C 16/32/64 run the tensor-core sta_fast_kernel, other C the CUDA-core
    sta_f32_kernel; both hold to the plain version."""
    from savsr_tpu_torch.ops import sta as sta_ops

    spy = _EntrySpy(sta_ops._lib())
    monkeypatch.setattr(sta_ops, "_lib", lambda: spy)
    rng = np.random.default_rng(c + 7)
    f32 = torch.float32
    x, st = _rand(rng, (2, c, 7, 11), f32, dev), _rand(rng, (2, c, 7, 11), f32, dev)
    wk, bk = _rand(rng, (25 * c, c, 1, 1), f32, dev, c ** -0.5), _rand(rng, (25 * c,), f32, dev, 0.1)
    _agree(lambda: sta_conv_fused_fast(x, st, wk, bk),
           lambda: sta_conv_fused_fast_plain(x, st, wk, bk), f32, "sta_fast")
    assert spy.called == [route]


@pytest.mark.parametrize("c", [16, 64])
def test_fast_sta_failed_launch_raises(dev, c, monkeypatch):
    """A launch the entry point refuses raises; nothing falls back."""
    from savsr_tpu_torch.ops import sta as sta_ops

    monkeypatch.setattr(sta_ops, "_lib", lambda spy=_EntrySpy(sta_ops._lib(), fail=1): spy)
    x = torch.zeros((1, c, 4, 4), device=dev)
    with pytest.raises(RuntimeError, match="sta_conv_fused_fast: CUDA error 1"):
        sta_conv_fused_fast(x, x, torch.zeros((25 * c, c, 1, 1), device=dev),
                            torch.zeros((25 * c,), device=dev))


@pytest.mark.parametrize("b,c,h,w", [(3, 16, 1, 1), (1, 16, 13, 17), (2, 32, 17, 23),
                                     (3, 32, 8, 16), (1, 64, 12, 50), (2, 64, 45, 80)])
def test_fast_sta_tensor_core_kernel_edges(dev, b, c, h, w):
    """sta_fast_kernel at the eval sweep's odd shapes: tiles of 8 x 16
    pixels cut by the bottom and right edges (a right half wholly outside),
    an image smaller than one tile, several samples."""
    rng = np.random.default_rng(b + c + h + w)
    f32 = torch.float32
    x, st = _rand(rng, (b, c, h, w), f32, dev, 2.0), _rand(rng, (b, c, h, w), f32, dev, 2.0)
    wk, bk = _rand(rng, (25 * c, c, 1, 1), f32, dev, c ** -0.5), _rand(rng, (25 * c,), f32, dev, 0.1)
    _agree(lambda: sta_conv_fused_fast(x, st, wk, bk),
           lambda: sta_conv_fused_fast_plain(x, st, wk, bk), f32, "sta_fast")


def _stau_fast_case(dev, b, c, hw, scale, seed, large=False):
    m = STAUpsample(c)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32) * 0.3))
    m.to(dev)
    h, w = hw
    with torch.no_grad():
        pix = stau_sampler_planes(_stau_head(m, h, w, scale, torch.float32, dev), scale, h, w)
    if large:
        off = torch.from_numpy(rng.uniform(-24, 24, (4, 16, 64)).astype(np.float32)).to(dev)
        pix[:4, :16, :64] += off
    plan = stau_window_plan(pix, h, w, *plan_geometry(torch.float32, fast=True))
    x, sta = (_rand(rng, (b, c, h, w), torch.float32, dev) for _ in range(2))
    args = (x, sta, pix, m.weight_compress, m.weight_expand, m.fusion.weight, m.fusion.bias)
    got = _agree(lambda: stau_upsample_fused_fast(*args, plan=plan),
                 lambda: stau_upsample_fused_fast_plain(*args), torch.float32, "stau_fast",
                 tol=FAST_INNER_TOL, mean_tol=FAST_INNER_MEAN_TOL)
    with torch.no_grad():
        assert torch.equal(got, stau_upsample_fused_fast(*args, plan=plan))
    return plan


@pytest.mark.parametrize("case", STAU_BF16, ids=[f"b{c[0]}-c{c[1]}-{c[2][0]}x{c[2][1]}-x{c[3][0]}"
                                                 for c in STAU_BF16])
def test_fast_stau_kernel_matches_plain(dev, case):
    """The fast STAU (the bf16 kernel's fast mode: f32 f0 in the residual,
    kept from its one sampling; f32 output) at the bf16 kernel's shapes."""
    plan = _stau_fast_case(dev, *case, seed=sum(case[2]) + case[1] + 1)
    assert bool((plan[:, 4] > 0).all())


def test_fast_stau_kernel_takes_a_bf16_plan(dev):
    """A plan made at the bf16 kernel's capacity (600 slots; the same shape
    as the fast plan): the fast kernel gathers its tiles over its own 536
    from device memory, and holds to the plain version."""
    from savsr_tpu_torch.ops.stau import FAST_STAGE_CAP, STAGE_CAP

    h, w, s, c = 40, 100, 1.75, 64
    gy, gx = np.meshgrid((np.arange(round(h * s)) + 0.5) / s - 0.5,
                         (np.arange(round(w * s)) + 0.5) / s - 0.5, indexing="ij")
    rng = np.random.default_rng(4)
    pix = torch.from_numpy(np.concatenate([np.stack([gy, gx, gy, gx]), rng.random((4,) + gy.shape)])
                           .astype(np.float32)).to(dev)
    plan = stau_window_plan(pix, h, w, *plan_geometry(torch.bfloat16))
    sizes = plan[:, 4] * plan[:, 5] + plan[:, 6] * plan[:, 7]
    assert bool(((sizes > FAST_STAGE_CAP) & (sizes <= STAGE_CAP)).any())
    m = STAUpsample(c).to(dev)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(_rand(rng, p.shape, torch.float32, dev, 0.3))
    x, sta = (_rand(rng, (2, c, h, w), torch.float32, dev) for _ in range(2))
    args = (x, sta, pix, m.weight_compress, m.weight_expand, m.fusion.weight, m.fusion.bias)
    _agree(lambda: stau_upsample_fused_fast(*args, plan=plan),
           lambda: stau_upsample_fused_fast_plain(*args), torch.float32, "stau_fast",
           tol=FAST_INNER_TOL, mean_tol=FAST_INNER_MEAN_TOL)


@pytest.mark.parametrize("b,c", [(1, 64), (8, 32)])
def test_fast_stau_kernel_direct_tiles(dev, b, c):
    plan = _stau_fast_case(dev, b, c, (20, 40), (4.0, 4.0), seed=c + 1, large=True)
    assert 0 < int((plan[:, 4] == 0).sum()) < plan.shape[0]


@pytest.mark.parametrize("case", TAIL_F32, ids=[f"b{c[0]}-c{c[1]}-{c[2]}x{c[3]}"
                                                for c in TAIL_F32])
def test_fast_tail_kernel_matches_plain(dev, case):
    args = _tail_args(dev, *case, torch.float32, seed=case[1] + case[2] + 1)
    got = _agree(lambda: tail_fused_fast(*args), lambda: tail_fused_fast_plain(*args),
                 torch.float32, "tail_fast", tol=FAST_INNER_TOL, mean_tol=FAST_INNER_MEAN_TOL)
    assert got.dtype == torch.float32


def test_small_fast_forward_on_the_card(dev):
    """The small config's fast forward on the card runs the five fast kernels
    and nothing else, no plain version on the card, and lands within the
    tier's floor of the CPU's fast forward (plain versions): max 2e-3,
    mean 3e-4 (tests/test_torch_fast.py measures the floor, a reversed sum
    order, at 5.3e-4 / 1.1e-4)."""
    io = np.load(os.path.join(GOLDEN_DIR, "savsr_small_forward.npz"))
    state = {k: torch.from_numpy(v) for k, v in
             np.load(os.path.join(GOLDEN_DIR, "savsr_small_state.npz")).items()}
    x = torch.from_numpy(io["x"])
    model = SAVSR(**SMALL_CFG, matmul_precision="default").eval()
    model.load_state_dict(state)
    cpu = model(x, (1.5, 3.5))
    model.to(dev)
    ops.reset_counts()
    y = model(x.to(dev), (1.5, 3.5)).cpu()
    fast = ("conv3x3_fast", "conv1x1_fast", "sta_fast", "stau_fast", "tail_fast")
    assert all(ops.launches[k] > 0 for k in fast), ops.launches
    assert not any(v for k, v in ops.launches.items() if k not in fast), ops.launches
    assert not any(ops.plain_cuda_calls.values()), ops.plain_cuda_calls
    err = (y - cpu).abs()
    assert float(err.max()) <= 2e-3 and float(err.mean()) <= 3e-4, (err.max(), err.mean())
