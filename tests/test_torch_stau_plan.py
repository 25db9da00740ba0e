"""The layout steps of the STAU and tail kernels (savsr_tpu_torch/ops/
stau.py, ops/tail.py), replayed on the CPU: the STAU window plans
(``stau_window_plan`` at the bf16 and the f32 kernel's tile and capacity),
the bf16 kernel's staged gather from the planned boxes with channels
innermost and the f32 kernel's from channel rows, the packed mma B
fragments of the bf16 kernels (``pack_stau_weights``, ``pack_tail_weights``)
and the f32 kernel's packed weights (``pack_stau_weights_f32``).

The kernels run only on the card (chip_smoke.py, tests/test_torch_cuda.py);
here their data movement is replayed in PyTorch and held to the plain
versions: the staged gather to ``bilinear_gather`` exactly (the same f32
arithmetic on the same values), the products on the unpacked fragments to
the plain versions within 1e-5 (f32, summation order).
"""

import hashlib
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from savsr_tpu_torch.archs.savsr_arch import SAVSR, STAUpsample, get_hw, tail_operands
from savsr_tpu_torch.ops.stau import (F32_PLAN_COLS, F32_PLAN_ROWS, F32_STAGE_CAP,
                                      FAST_STAGE_CAP, PLAN_COLS, PLAN_ROWS, STAGE_CAP,
                                      bilinear_gather, f32_channels,
                                      pack_stau_weights, pack_stau_weights_f32, plan_geometry,
                                      stau_upsample_fused_plain, stau_window_plan)
from savsr_tpu_torch.ops.tail import pack_tail_weights, tail_fused_plain
from savsr_tpu_torch.utils.convert import load_into

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
SMALL_CFG = dict(num_in_ch=3, num_feat=16, num_frame=7, slid_win=3, fusion_win=5,
                 interval=0, w1_num_block=2, w2_num_block=1, n_resgroups=1, n_resblocks=2)
SCALES = [(4.0, 4.0), (1.5, 3.5), (3.05, 3.05)]
LR = (21, 37)  # H, W at every scale off the 8 x 64 tile


@pytest.fixture(scope="module")
def small_model():
    m = SAVSR(**SMALL_CFG)
    load_into(m, {k: torch.from_numpy(v) for k, v in
                  np.load(os.path.join(GOLDEN_DIR, "savsr_small_state.npz")).items()})
    return m.eval()


def stage_pos(c: int, ch: int) -> int:
    """csrc/stau.cu stage_pos: where channel c sits in a staged pixel."""
    cb, kb, r = ch // 16, c // 16, c % 16
    return 4 * cb * ((r % 8) // 2) + 4 * kb + 2 * (r // 8) + r % 2


def staged_gather(x, fy, fx, plan, sampler):
    """The kernel's gather for one sampler (0: f, 1: s): per tile, the
    planned box of ``x`` staged as [rows * cols, C] slots with channel c at
    stage_pos(c) (zeros past the image's right edge, as the landing copy
    fills them); lane q of a quad reads positions [4 C/16 q, 4 C/16 (q + 1)),
    i.e. channels 16 kb + 2q, +1, +8, +9. Tiles without boxes read ``x``
    itself. Every in-image tap of a staged tile must lie in its box."""
    b, c, h, w = x.shape
    H, W = fy.shape
    ncs = -(-W // PLAN_COLS)
    perm = torch.tensor([stage_pos(k, c) for k in range(c)])
    lane_ch = torch.tensor([16 * kb + 2 * q + d for q in range(4) for kb in range(c // 16)
                            for d in (0, 1, 8, 9)])
    assert sorted(perm.tolist()) == list(range(c))
    assert torch.equal(perm[lane_ch], torch.arange(c))  # lanes read contiguous runs
    out = torch.zeros(b, c, H, W)
    for t, p in enumerate(plan.tolist()):
        Y0, X0 = (t // ncs) * PLAN_ROWS, (t % ncs) * PLAN_COLS
        ys, xs = slice(Y0, min(Y0 + PLAN_ROWS, H)), slice(X0, min(X0 + PLAN_COLS, W))
        ty, tx = fy[ys, xs], fx[ys, xs]
        y0, x0, nr, nc = p[2 * sampler], p[2 * sampler + 1], p[4 + 2 * sampler], p[5 + 2 * sampler]
        if nr == 0:
            out[:, :, ys, xs] = bilinear_gather(x, ty, tx)
            continue
        box = F.pad(x.float(), (0, x0 + nc - w if x0 + nc > w else 0))[:, :, y0:y0 + nr,
                                                                        x0:x0 + nc]
        slots = torch.zeros(b, nr * nc, c)
        slots[:, :, perm] = box.reshape(b, c, nr * nc).transpose(1, 2)
        yf, xf = torch.floor(ty), torch.floor(tx)
        acc = torch.zeros(b, c, *ty.shape)
        for dy, wy in ((0, 1.0 - (ty - yf)), (1, ty - yf)):
            for dx, wx in ((0, 1.0 - (tx - xf)), (1, tx - xf)):
                yy, xx = yf + dy, xf + dx
                ok = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
                ry, rx = (yy - y0)[ok], (xx - x0)[ok]
                assert bool(((ry >= 0) & (ry < nr) & (rx >= 0) & (rx < nc)).all()), t
                idx = torch.where(ok, (yy - y0) * nc + (xx - x0), 0).long().reshape(-1)
                v = slots[:, idx][:, :, perm].transpose(1, 2).reshape(acc.shape)
                acc = acc + (wy * wx * ok) * v
        out[:, :, ys, xs] = acc
    return out


@pytest.mark.parametrize("scale", SCALES, ids=str)
def test_window_plan_covers_every_tap_and_staged_gather_is_exact(small_model, scale):
    """On the small config's statics, every tap of both samplers lies in its
    tile's box, every box fits the staging, and the staged gather equals
    bilinear_gather bit for bit."""
    h, w = LR
    st = small_model.stau_statics(LR, scale, dtype=torch.bfloat16)
    pix, plan = st["pix"], st["stau_plan"]
    H, W = get_hw(h, w, scale)
    assert tuple(plan.shape) == (-(-H // PLAN_ROWS) * -(-W // PLAN_COLS), 8)
    assert plan.dtype == torch.int32
    sizes = plan[:, 4] * plan[:, 5] + plan[:, 6] * plan[:, 7]
    assert bool((sizes > 0).all() & (sizes <= STAGE_CAP).all())
    assert bool((plan[:, 1] % 8 == 0).all() & (plan[:, 3] % 8 == 0).all())
    assert bool((plan[:, 5] % 8 == 0).all() & (plan[:, 7] % 8 == 0).all())
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 16, h, w)).astype(np.float32))
    for s in (0, 1):
        got = staged_gather(x, pix[2 * s], pix[2 * s + 1], plan, s)
        assert torch.equal(got, bilinear_gather(x, pix[2 * s], pix[2 * s + 1]))


def test_large_offsets_mark_tiles_for_the_direct_gather():
    """Seeded offsets of up to +-24 LR px in one block of HR pixels (rows
    0-63, columns 64-127) blow those tiles' boxes past the staging capacity:
    they get zero sizes (gathered from device memory), the rest still cover
    their taps, and the replay still equals bilinear_gather."""
    h, w, H, W = 30, 40, 120, 160
    rng = np.random.default_rng(5)
    gy, gx = np.meshgrid((np.arange(H) + 0.5) / 4 - 0.5, (np.arange(W) + 0.5) / 4 - 0.5,
                         indexing="ij")
    off = np.zeros((4, H, W))
    off[:, :64, 64:128] = rng.uniform(-24, 24, (4, 64, 64))
    pix = np.concatenate([np.stack([gy, gx, gy, gx]) + off, rng.random((4, H, W))])
    pix = torch.from_numpy(pix.astype(np.float32))
    plan = stau_window_plan(pix, h, w)
    direct = plan[:, 4] == 0
    assert 0 < int(direct.sum()) < plan.shape[0]
    assert bool((plan[direct, 4:] == 0).all())
    x = torch.from_numpy(rng.standard_normal((1, 32, h, w)).astype(np.float32))
    for s in (0, 1):
        got = staged_gather(x, pix[2 * s], pix[2 * s + 1], plan, s)
        assert torch.equal(got, bilinear_gather(x, pix[2 * s], pix[2 * s + 1]))


def _fragments(packed: torch.Tensor, kblocks: int, ntiles: int) -> torch.Tensor:
    """Unpack [kblocks][ntiles][32 lanes][4] B fragments into B[K, N]: lane
    4g + q, element j holds B[16 kb + 2q + j % 2 + 8 (j // 2)][8 nt + g]."""
    blk = packed.reshape(kblocks, ntiles, 8, 4, 2, 2)  # kb, nt, g, q, j//2, j%2
    return blk.permute(0, 4, 3, 5, 1, 2).reshape(16 * kblocks, 8 * ntiles)


@pytest.mark.parametrize("c", [16, 32, 64])
def test_stau_weight_packing_replays_the_plain_products(c):
    """The three products computed from the unpacked weights (compress
    with experts padded to 4 x 8 columns and expand as mma B fragments, the
    fusion as wgmma core matrices; the routing between) against
    stau_upsample_fused_plain in f32: <= 1e-5."""
    m = STAUpsample(c)
    rng = np.random.default_rng(c)
    for p in m.parameters():
        p.data = torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32) * 0.2)
        p.requires_grad_(False)
    wc, we, wf = m.weight_compress, m.weight_expand, m.fusion.weight
    packed = pack_stau_weights(wc, we, wf)
    assert pack_stau_weights(wc, we, wf) is packed  # cached
    cb = c // 16
    bc, rest = packed[:cb * 4 * 128], packed[cb * 4 * 128:]
    be, bf = rest[:2 * (c // 8) * 128], rest[2 * (c // 8) * 128:]
    Bc, Be = _fragments(bc, cb, 4), _fragments(be, 2, c // 8)
    # fusion: K-major core matrices [kb][n8][k half][n][k] -> B[K, N]
    Bf = bf.reshape(2 * cb, c // 8, 2, 8, 8).permute(0, 2, 4, 1, 3).reshape(2 * c, c)
    n, e_n = wc.shape[0], c // 8
    want_c = torch.zeros(c, 32)
    want_e = torch.zeros(32, c)
    for e in range(n):
        want_c[:, 8 * e:8 * e + e_n] = wc[e, :, :, 0, 0].t()
        want_e[8 * e:8 * e + e_n] = we[e, :, :, 0, 0].t()
    assert torch.equal(Bc, want_c) and torch.equal(Be, want_e)
    assert torch.equal(Bf, wf[:, :, 0, 0].t())
    # the kernel's chain on these matrices, pixels as rows
    h, w, H, W = 5, 6, 11, 13
    x = torch.from_numpy(rng.standard_normal((1, c, h, w)).astype(np.float32))
    sta = torch.from_numpy(rng.standard_normal((1, c, h, w)).astype(np.float32))
    pix = torch.from_numpy(np.concatenate([rng.uniform(-1, h, (1, H, W)),
                                           rng.uniform(-1, w, (1, H, W)),
                                           rng.uniform(-1, h, (1, H, W)),
                                           rng.uniform(-1, w, (1, H, W)),
                                           rng.random((n, H, W))]).astype(np.float32))
    f0 = bilinear_gather(x, pix[0], pix[1])[0].reshape(c, -1).t()
    sa = bilinear_gather(sta, pix[2], pix[3])[0].reshape(c, -1).t()
    r = pix[4:].reshape(n, -1).t()
    z = (f0 @ Bc).reshape(-1, 4, 8)[:, :n]
    fc = (r[:, :, None] * z).sum(1)
    stk = torch.zeros(f0.shape[0], 4, 8)
    stk[:, :n] = r[:, :, None] * fc[:, None]
    fea = stk.reshape(-1, 32) @ Be + f0
    y = torch.cat([sa, fea], 1) @ Bf + m.fusion.bias
    want = stau_upsample_fused_plain(x, sta, pix, wc, we, wf, m.fusion.bias)
    assert float((y.t().reshape(1, c, H, W) - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("c", [16, 64])
def test_tail_weight_packing_replays_the_plain_conv(c):
    """The kernel's products from the unpacked B fragments: per tap row dy,
    each (zero-padded) row of sr times B_dy[C, 16] (column 3 dx + k, k < 3;
    the rest zero) into P, then out[k, y, x] = sum over dx of
    P[y, x + dx][3 dx + k] + bias + skip, against tail_fused_plain in f32:
    <= 1e-5."""
    rng = np.random.default_rng(c)
    weight = torch.from_numpy(rng.standard_normal((3, c, 3, 3)).astype(np.float32) * 0.1)
    bias = torch.from_numpy(rng.standard_normal(3).astype(np.float32) * 0.1)
    packed = pack_tail_weights(weight)
    assert pack_tail_weights(weight) is packed
    rows = packed.reshape(3, -1)
    h0, w0, H, W = 6, 7, 13, 17
    sr = torch.from_numpy(rng.standard_normal((2, c, H, W)).astype(np.float32))
    xc = torch.from_numpy(rng.random((2, 3, h0, w0)).astype(np.float32))
    pad = F.pad(sr, (1, 1, 1, 1))  # staged pixel s is x = s - 1
    P = torch.zeros(2, H, W + 2, 16)
    for dy in range(3):
        bd = _fragments(rows[dy], c // 16, 2)  # [C, 16]
        for dx in range(3):
            assert torch.equal(bd[:, 3 * dx:3 * dx + 3], weight[:, :, dy, dx].t())
        assert not bd[:, 9:].any()
        P += pad[:, :, dy:dy + H].permute(0, 2, 3, 1) @ bd
    conv = sum(P[:, :, dx:dx + W, 3 * dx:3 * dx + 3] for dx in range(3))
    o = tail_operands(h0, w0, H, W, "cpu")
    args = (o["tail_j0"], o["tail_wy"], o["tail_c0"], o["tail_cw"])
    skip = tail_fused_plain(torch.zeros_like(sr), xc, *args, torch.zeros_like(weight),
                            torch.zeros(3))
    got = conv.permute(0, 3, 1, 2) + bias.view(1, 3, 1, 1) + skip
    want = tail_fused_plain(sr, xc, *args, weight, bias)
    assert float((got - want).abs().max()) <= 1e-5


def _seeded_pix():
    """Sampler planes on a 30x44 -> 117x171 grid with small seeded offsets,
    offsets of up to +-20 LR px on one block of HR pixels and one non-finite
    coordinate."""
    h, w, H, W = 30, 44, 117, 171
    rng = np.random.default_rng(11)
    gy, gx = np.meshgrid((np.arange(H) + 0.5) * h / H - 0.5, (np.arange(W) + 0.5) * w / W - 0.5,
                         indexing="ij")
    off = rng.uniform(-0.6, 0.6, (4, H, W))
    off[:, :40, 60:130] += rng.uniform(-20, 20, (4, 40, 70))
    pix = np.concatenate([np.stack([gy, gx, gy, gx]) + off, rng.random((4, H, W))])
    pix = pix.astype(np.float32)
    pix[1, 100, 5] = np.nan
    return torch.from_numpy(pix), h, w


def _kernel_plan(plan, cap):
    """csrc/stau.cu load_plan: a tile whose boxes exceed the kernel's
    ``cap`` slots (a plan made for a larger capacity) gathers from device
    memory."""
    out = plan.clone()
    sizes = plan[:, 4] * plan[:, 5] + plan[:, 6] * plan[:, 7]
    out[sizes > cap, 4:] = 0
    return out


def test_fast_window_plan_is_the_bf16_tile_at_the_fast_capacity():
    """The fast tier's plan: the bf16 kernel's tile and alignment at the
    fast mode's capacity, i.e. the bf16 plan with its tiles over that
    capacity gathered from device memory; the fast kernel reads a bf16 plan
    as its own, and the bf16 kernel reads a fast plan unchanged."""
    h, w, s = 40, 100, 1.75  # boxes of 480-576 slots: some tiles between the capacities
    gy, gx = np.meshgrid((np.arange(round(h * s)) + 0.5) / s - 0.5,
                         (np.arange(round(w * s)) + 0.5) / s - 0.5, indexing="ij")
    pix = torch.from_numpy(np.concatenate([np.stack([gy, gx, gy, gx]),
                                           np.ones((4,) + gy.shape)]).astype(np.float32))
    assert plan_geometry(torch.float32, fast=True) == (PLAN_ROWS, PLAN_COLS, FAST_STAGE_CAP, 8)
    bf16 = stau_window_plan(pix, h, w)
    fast = stau_window_plan(pix, h, w, *plan_geometry(torch.float32, fast=True))
    assert int((fast[:, 4] == 0).sum()) > int((bf16[:, 4] == 0).sum())
    assert torch.equal(fast, _kernel_plan(bf16, FAST_STAGE_CAP))
    assert torch.equal(_kernel_plan(fast, FAST_STAGE_CAP), fast)
    assert torch.equal(_kernel_plan(fast, STAGE_CAP), fast)


@pytest.mark.parametrize("scale", SCALES, ids=str)
def test_fast_statics_plan_fits_the_fast_staging(scale):
    """A fast model's statics plan at the fast capacity, and the staged
    gather on it equals bilinear_gather bit for bit."""
    m = SAVSR(**SMALL_CFG, matmul_precision="default")
    load_into(m, {k: torch.from_numpy(v) for k, v in
                  np.load(os.path.join(GOLDEN_DIR, "savsr_small_state.npz")).items()})
    h, w = LR
    st = m.eval().stau_statics(LR, scale, dtype=torch.float32)
    pix, plan = st["pix"], st["stau_plan"]
    assert torch.equal(plan, stau_window_plan(pix, h, w, *plan_geometry(torch.float32, fast=True)))
    sizes = plan[:, 4] * plan[:, 5] + plan[:, 6] * plan[:, 7]
    assert bool((sizes <= FAST_STAGE_CAP).all())
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 16, h, w)).astype(np.float32))
    for s in (0, 1):
        assert torch.equal(staged_gather(x, pix[2 * s], pix[2 * s + 1], plan, s),
                           bilinear_gather(x, pix[2 * s], pix[2 * s + 1]))


def test_bf16_window_plan_is_unchanged():
    """The bf16 plan (the default geometry) is bit for bit the plan of the
    kernel's first release on seeded coordinates (its digest), with the
    oversize and non-finite tiles marked direct."""
    pix, h, w = _seeded_pix()
    plan = stau_window_plan(pix, h, w)
    assert plan_geometry(torch.bfloat16) == (PLAN_ROWS, PLAN_COLS, STAGE_CAP, 8)
    assert torch.equal(plan, stau_window_plan(pix, h, w, PLAN_ROWS, PLAN_COLS, STAGE_CAP, 8))
    assert int((plan[:, 4] == 0).sum()) == 16
    assert hashlib.sha256(plan.numpy().tobytes()).hexdigest() == (
        "3870509b16c13c3d162b7e4fe9ef5cd01631d3213f4f086a7dcf097a4dadfbac")


def staged_gather_rows(x, fy, fx, plan, sampler, rows, cols, cap):
    """The f32 kernel's gather for one sampler: per tile, both planned boxes
    staged with channel quads innermost, channel c of box pixel pos (the f
    box from slot 0, the s box after it; columns past the image zero) at
    [c // 4][slot][c % 4] of a [C/4][cap][4] buffer; every tap as (weight,
    slot), weight 0 at the box's first slot for taps off the image, summed
    in tap order. Tiles without boxes read ``x`` itself. Every in-image tap
    of a staged tile must lie in its box."""
    b, c, h, w = x.shape
    H, W = fy.shape
    ncs = -(-W // cols)
    out = torch.zeros(b, c, H, W)
    for t, p in enumerate(plan.tolist()):
        Y0, X0 = (t // ncs) * rows, (t % ncs) * cols
        ys, xs = slice(Y0, min(Y0 + rows, H)), slice(X0, min(X0 + cols, W))
        ty, tx = fy[ys, xs], fx[ys, xs]
        if p[4] == 0:
            out[:, :, ys, xs] = bilinear_gather(x, ty, tx)
            continue
        stage = torch.full((b, c // 4, cap, 4), float("nan"))
        base = 0
        for s_ in (0, 1):
            y0, x0, nr, nc = p[2 * s_], p[2 * s_ + 1], p[4 + 2 * s_], p[5 + 2 * s_]
            box = F.pad(x.float(), (0, max(x0 + nc - w, 0)))[:, :, y0:y0 + nr, x0:x0 + nc]
            quads = box.reshape(b, c // 4, 4, nr * nc).transpose(2, 3)
            stage[:, :, base:base + nr * nc] = quads
            if s_ == sampler:
                y0s, x0s, ncs_, bases = y0, x0, nc, base
            base += nr * nc
        assert base <= cap
        yf, xf = torch.floor(ty), torch.floor(tx)
        acc = torch.zeros(b, c, *ty.shape)
        for dy, wy in ((0, 1.0 - (ty - yf)), (1, ty - yf)):
            for dx, wx in ((0, 1.0 - (tx - xf)), (1, tx - xf)):
                yy, xx = yf + dy, xf + dx
                ok = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
                ry, rx = (yy - y0s)[ok], (xx - x0s)[ok]
                assert bool(((ry >= 0) & (rx >= 0) & (rx < ncs_)).all()), t
                slot = torch.where(ok, bases + (yy - y0s) * ncs_ + (xx - x0s), bases).long()
                assert bool((slot < base).all())
                v = stage[:, :, slot.reshape(-1)].permute(0, 1, 3, 2).reshape(acc.shape)
                acc = acc + torch.where(ok, wy * wx, 0.0) * v
        out[:, :, ys, xs] = acc
    return out


@pytest.mark.parametrize("scale", SCALES, ids=str)
def test_f32_window_plan_covers_every_tap_and_staged_gather_is_exact(small_model, scale):
    """The f32 statics carry the f32 kernel's plan (2 x 64 HR tiles, 320
    slots, exact boxes, no column alignment): on the small config every tile
    is staged within the capacity, every box is the exact span of its taps,
    and the kernel's gather from its staged boxes equals bilinear_gather bit
    for bit."""
    h, w = LR
    st = small_model.stau_statics(LR, scale, dtype=torch.float32)
    pix, plan = st["pix"], st["stau_plan"]
    H, W = get_hw(h, w, scale)
    assert plan_geometry(torch.float32) == (F32_PLAN_ROWS, F32_PLAN_COLS, F32_STAGE_CAP, 1)
    assert tuple(plan.shape) == (-(-H // F32_PLAN_ROWS) * -(-W // F32_PLAN_COLS), 8)
    assert torch.equal(plan, stau_window_plan(pix, h, w, *plan_geometry(torch.float32)))
    sizes = plan[:, 4] * plan[:, 5] + plan[:, 6] * plan[:, 7]
    assert bool((sizes > 0).all() & (sizes <= F32_STAGE_CAP).all())
    aligned = stau_window_plan(pix, h, w, F32_PLAN_ROWS, F32_PLAN_COLS, F32_STAGE_CAP)
    assert bool((plan[:, 5] <= aligned[:, 5]).all() & (plan[:, 7] <= aligned[:, 7]).all())
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 16, h, w)).astype(np.float32))
    for s in (0, 1):
        got = staged_gather_rows(x, pix[2 * s], pix[2 * s + 1], plan, s, F32_PLAN_ROWS,
                                 F32_PLAN_COLS, F32_STAGE_CAP)
        assert torch.equal(got, bilinear_gather(x, pix[2 * s], pix[2 * s + 1]))


def test_f32_window_plan_sends_oversize_and_nonfinite_tiles_direct():
    """At the f32 geometry, the tiles whose boxes exceed 320 slots and the
    tile with a non-finite coordinate get zero sizes, no other tile does,
    and the replay on that plan (staged and direct tiles; the coordinates
    made finite, as bilinear_gather needs) equals bilinear_gather."""
    pix, h, w = _seeded_pix()
    rows, cols, cap, align = plan_geometry(torch.float32)
    plan = stau_window_plan(pix, h, w, rows, cols, cap, align)
    unbounded = stau_window_plan(torch.nan_to_num(pix), h, w, rows, cols, 10 ** 9, align)
    sizes = unbounded[:, 4] * unbounded[:, 5] + unbounded[:, 6] * unbounded[:, 7]
    direct = plan[:, 4] == 0
    bad = torch.zeros_like(direct)
    bad[(100 // rows) * -(-pix.shape[2] // cols) + 5 // cols] = True
    assert torch.equal(direct, (sizes > cap) | bad)
    assert 1 < int(direct.sum()) < plan.shape[0]
    assert bool((plan[direct, 4:] == 0).all())
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 8, h, w)).astype(np.float32))
    pix = torch.nan_to_num(pix)
    for s in (0, 1):
        got = staged_gather_rows(x, pix[2 * s], pix[2 * s + 1], plan, s, rows, cols, cap)
        assert torch.equal(got, bilinear_gather(x, pix[2 * s], pix[2 * s + 1]))


@pytest.mark.parametrize("c,cout,n", [(8, 8, 4), (24, 12, 3), (64, 64, 4)])
def test_stau_f32_weight_packing_replays_the_plain_products(c, cout, n):
    """The f32 kernel's chain on its packed weights (C padded to 16, 32 or
    64, 4 experts, 64 outputs; compress [CP][E][4], then the fusion rows
    [2CP + 4E][64]: sa, f0 and the expand folded in), pixels as columns,
    with the routing between, against stau_upsample_fused_plain in f32:
    <= 1e-5; padded slots are zero and the folded rows are Wfus_fea We."""
    rng = np.random.default_rng(c + n)
    f = lambda *shape: torch.from_numpy(  # noqa: E731
        (0.2 * rng.standard_normal(shape)).astype(np.float32))
    wc, we, wf, bias = f(n, c // 8, c, 1, 1), f(n, c, c // 8, 1, 1), f(cout, 2 * c, 1, 1), f(cout)
    packed = pack_stau_weights_f32(wc, we, wf)
    assert pack_stau_weights_f32(wc, we, wf) is packed  # cached
    cp = f32_channels(c)
    e = cp // 8
    Wc = packed[:cp * e * 4].reshape(cp, e, 4)
    Wf = packed[cp * e * 4:].reshape(2 * cp + 4 * e, 64)
    assert not Wf[:, cout:].any() and not Wf[c:cp].any() and not Wf[cp + c:2 * cp].any()
    assert not Wc[c:].any() and not Wc[:, c // 8:].any() and not Wc[..., n:].any()
    fold = Wf[2 * cp:].reshape(4, e, 64)
    want_fold = torch.einsum("oc,nce->neo", wf[:, c:, 0, 0].double(), we[..., 0, 0].double())
    assert torch.equal(fold[:n, :c // 8, :cout], want_fold.float())
    assert not fold[n:].any() and not fold[:, c // 8:].any()
    h, w, H, W = 5, 6, 11, 13
    x, sta = f(1, c, h, w) * 5, f(1, c, h, w) * 5
    pix = torch.from_numpy(np.concatenate([rng.uniform(-1, h, (1, H, W)),
                                           rng.uniform(-1, w, (1, H, W)),
                                           rng.uniform(-1, h, (1, H, W)),
                                           rng.uniform(-1, w, (1, H, W)),
                                           rng.random((n, H, W))]).astype(np.float32))
    act = torch.zeros(2 * cp + 4 * e, H * W)  # sa rows, f0 rows, stk rows
    act[:c] = bilinear_gather(sta, pix[2], pix[3])[0].reshape(c, -1)
    act[cp:cp + c] = bilinear_gather(x, pix[0], pix[1])[0].reshape(c, -1)
    r = torch.zeros(4, H * W)
    r[:n] = pix[4:].reshape(n, -1)
    z = torch.einsum("koe,kp->eop", Wc, act[cp:2 * cp])               # [4][E][px]
    fc = (r[:, None] * z).sum(0)
    act[2 * cp:] = (r[:, None] * fc[None]).reshape(4 * e, -1)         # stk, rows e E + o
    y = Wf.t()[:cout] @ act + bias[:, None]
    want = stau_upsample_fused_plain(x, sta, pix, wc, we, wf, bias)
    assert float((y.reshape(1, cout, H, W) - want).abs().max()) <= 1e-5
