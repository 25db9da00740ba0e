"""The layout steps of the bf16 STAU and tail kernels (savsr_tpu_torch/ops/
stau.py, ops/tail.py), replayed on the CPU: the STAU window plan
(``stau_window_plan``), the staged gather from the planned boxes with
channels innermost, and the packed mma B fragments of both kernels
(``pack_stau_weights``, ``pack_tail_weights``).

The kernels run only on the card (chip_smoke.py, tests/test_torch_cuda.py);
here their data movement is replayed in PyTorch and held to the plain
versions: the staged gather to ``bilinear_gather`` exactly (the same f32
arithmetic on the same values), the products on the unpacked fragments to
the plain versions within 1e-5 (f32, summation order).
"""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from savsr_tpu_torch.archs.savsr_arch import SAVSR, STAUpsample, get_hw, tail_operands
from savsr_tpu_torch.ops.stau import (PLAN_COLS, PLAN_ROWS, STAGE_CAP, bilinear_gather,
                                      pack_stau_weights, stau_upsample_fused_plain,
                                      stau_window_plan)
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
    st = small_model.stau_statics(LR, scale)
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
