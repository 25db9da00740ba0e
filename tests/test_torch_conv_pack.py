"""The layout steps of the bf16 tensor-core conv (savsr_tpu_torch/ops/conv.py):
the weight repack into the kernel's A-operand stages (``pack_index`` /
``pack_weight``) and the pitch-padded copy of a part TMA cannot address
(``tma_part``); and those of the f32 CUDA-core conv: its weight repack
(``pack_weight_f32``), its stages and its split of the Cin reduction
(``f32_stages``, ``f32_chunks``); and those of the fast conv: the f32 part
maps (``tma_part`` at a 4-element pitch) and the kernel's tiling, replayed with its rounding of
each f32 box to bf16 and the one-pixel shifts it builds from the box and
its halo columns (``_replay_fast``); and those of the split conv's pair
kernel: its weight packing (``pack_weight_pair``: per chunk of a pair the
Whi then the Wlo taps) and its tiling, replayed chunk by chunk from the
bf16 hi and lo planes in its K order, hi x Whi, hi x Wlo, lo x Whi
(``_replay_split``), against ``conv_fused_split_plain`` and, for one case,
the JAX package's pair-carry ``conv3x3_chw`` in interpret mode.

The kernel itself runs only on the card (chip_smoke.py, tests/test_torch_cuda.py).
Here its decomposition is replayed in PyTorch on the CPU from the packed
weight: per 16-channel step of each part (channels past the part's end
zero, as TMA fills them) and per tap, a [64 x 16] weight block times the
shifted input, summed in f32, then the epilogue. That replay is held to
``conv_fused_plain`` and, for one case, to the JAX package's Pallas
``conv3x3_chw`` in interpret mode: max abs <= 1e-5 (f32, summation order).
The f32 kernel's decomposition is replayed likewise (``_replay_f32``: stage
by stage, the weight read through the strides the wrapper passes, chunk
partials added in chunk order, then the epilogue).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from savsr_tpu.archs import chw_engine as jchw
from savsr_tpu.ops.pallas.chw_conv import chw_to_nhwc, conv3x3_chw, nhwc_to_chw, pack_w3
from savsr_tpu_torch.ops.conv import (CI_STEP, CO_TILE, F32_BLOCKS_PER_SM, F32_STAGE_CH,
                                      F32_TILE, Pair, conv_fused_fast_plain, conv_fused_plain,
                                      conv_fused_split_plain, f32_chunks, f32_stages,
                                      pack_index, pack_weight, pack_weight_f32,
                                      pack_weight_fast, pack_weight_pair, pair_merge,
                                      pair_pack_index, pair_split, split_weight, tma_part)


def _unpack(packed: torch.Tensor, cout: int, chans, k: int) -> torch.Tensor:
    """Inverse of pack_weight: scatter the packed elements back to their
    [(B,) Cout, Cin, k, k] places."""
    idx = pack_index(cout, tuple(chans), k)
    n = cout * sum(chans) * k * k
    flat = packed.reshape(-1, idx.numel())
    out = flat.new_zeros(flat.shape[0], n + 1).index_copy_(1, idx, flat)
    return out[:, :n].reshape((-1, cout, sum(chans), k, k))


def _replay(parts, weight, bias=None, pre_add=None, out_scale=None, lrelu=None,
            residual=None) -> torch.Tensor:
    """The bf16 kernel's arithmetic, stage by stage, from the packed weight."""
    b, _, h, w = parts[0].shape
    k = weight.shape[-1]
    halo, kk = k // 2, k * k
    chans = [p.shape[1] for p in parts]
    cout = weight.shape[-4]
    nct = -(-cout // CO_TILE)
    packed = pack_weight(weight, chans)
    packed = packed.reshape(-1, packed.shape[-1])
    # [tile][chunk][tap][co/8][ci/8][co%8][ci%8] -> [chunk][tap][co][ci]
    blocks = packed.view(packed.shape[0], nct, -1, kk, 8, 2, 8, 8).permute(
        0, 2, 3, 1, 4, 6, 5, 7).reshape(packed.shape[0], -1, kk, nct * CO_TILE, CI_STEP)
    y = torch.zeros(b, nct * CO_TILE, h, w)
    chunk = 0
    for p in parts:
        buf, pitch = tma_part(p)
        assert pitch % 8 == 0 and torch.equal(buf[..., :w], p)
        for c0 in range(0, p.shape[1], CI_STEP):
            xs = torch.zeros(b, CI_STEP, h + 2 * halo, w + 2 * halo)
            n = min(CI_STEP, p.shape[1] - c0)
            xs[:, :n, halo:halo + h, halo:halo + w] = buf[:, c0:c0 + n, :, :w]
            for tap in range(kk):
                dy, dx = divmod(tap, k)
                a = blocks[:, chunk, tap].expand(b, -1, -1)
                y += torch.einsum("bok,bkhw->bohw", a, xs[:, :, dy:dy + h, dx:dx + w])
            chunk += 1
    y = y[:, :cout]
    if bias is not None:
        y = y + bias.view(1, -1, 1, 1)
    if pre_add is not None:
        y = y + pre_add
    if out_scale is not None:
        y = y * out_scale.reshape(-1, cout, 1, 1)
    if lrelu is not None:
        y = lrelu[0] * y + lrelu[1] * y.abs()
    if residual is not None:
        y = y + residual
    return y


def _t(rng, shape, std=1.0):
    return torch.from_numpy((std * rng.standard_normal(shape)).astype(np.float32))


# (kernel size, parts' channels, Cout, per-sample weights): Cin off the
# 16-channel step within and across parts, Cout below, at and above 64
PACK_CASES = [(3, [5, 11], 16, True), (3, [3, 3], 64, False), (3, [64, 24], 128, False),
              (1, [16, 3], 24, True), (1, [40], 72, False)]


@pytest.mark.parametrize("case", PACK_CASES, ids=str)
def test_pack_weight_round_trip(case):
    """Every weight element lands once in the packed layout (the unpack
    restores it exactly) and every other packed element is zero."""
    k, chans, cout, per_sample = case
    rng = np.random.default_rng(sum(chans) + cout)
    weight = _t(rng, ((2,) if per_sample else ()) + (cout, sum(chans), k, k))
    packed = pack_weight(weight, chans)
    nchunk = sum(-(-c // CI_STEP) for c in chans)
    assert packed.shape[-1] == -(-cout // CO_TILE) * nchunk * k * k * CO_TILE * CI_STEP
    assert torch.equal(_unpack(packed, cout, chans, k), weight.reshape(-1, *weight.shape[-4:]))
    assert int((packed != 0).sum()) == weight.numel()


@pytest.mark.parametrize("case", PACK_CASES, ids=str)
def test_replayed_kernel_matches_plain(case):
    k, chans, cout, per_sample = case
    rng = np.random.default_rng(sum(chans) + 2 * cout)
    b, h, w = 2, 7, 13
    parts = [_t(rng, (b, c, h, w)) for c in chans]
    weight = _t(rng, ((b,) if per_sample else ()) + (cout, sum(chans), k, k),
                (sum(chans) * k * k) ** -0.5)
    epi = dict(bias=_t(rng, (cout,), 0.1), pre_add=_t(rng, (b, cout, h, w)),
               out_scale=torch.from_numpy(rng.uniform(0.5, 1.5, (b, cout)).astype(np.float32)),
               lrelu=(0.6, 0.4), residual=_t(rng, (b, cout, h, w)))
    want = conv_fused_plain(parts, weight, **epi)
    assert float((_replay(parts, weight, **epi) - want).abs().max()) <= 1e-5


def test_replayed_kernel_matches_pallas():
    """Per-sample 3x3 weights over two parts (3 + 13 channels: both off the
    16-channel step) with the full epilogue, against conv3x3_chw."""
    rng = np.random.default_rng(20)
    b, h, w, cin, cout = 2, 9, 12, 16, 8
    x = rng.standard_normal((b, h, w, cin), dtype=np.float32)
    wt = 0.1 * rng.standard_normal((b, 3, 3, cin, cout), dtype=np.float32)
    bias = rng.standard_normal((cout,), dtype=np.float32)
    scale = rng.uniform(0.5, 1.5, (b, cout)).astype(np.float32)
    pre = rng.standard_normal((b, h, w, cout), dtype=np.float32)
    res = rng.standard_normal((b, h, w, cout), dtype=np.float32)
    y_jax = conv3x3_chw(
        nhwc_to_chw(jnp.asarray(x)), jnp.stack([pack_w3(jnp.asarray(wt[i])) for i in range(b)]),
        jnp.asarray(bias).reshape(-1, 1), jnp.asarray(scale)[:, :, None],
        nhwc_to_chw(jnp.asarray(pre)), nhwc_to_chw(jnp.asarray(res)),
        h=h, w=w, lrelu=(0.6, 0.4),
    )
    y_jax = np.asarray(chw_to_nhwc(y_jax, h, w)).transpose(0, 3, 1, 2)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))  # noqa: E731
    y = _replay([xt[:, :3], xt[:, 3:]], torch.from_numpy(wt.transpose(0, 4, 3, 1, 2).copy()),
                torch.from_numpy(bias), nchw(pre), torch.from_numpy(scale), (0.6, 0.4), nchw(res))
    assert np.abs(y.numpy() - y_jax).max() <= 1e-5


@pytest.mark.parametrize("shape,view,copied", [
    ((2, 3, 5, 37), None, True),         # width off a multiple of 8
    ((2, 3, 5, 320), None, False),       # the serving width: read in place
    ((2, 7, 3, 6, 320), 2, False),       # a frame view: its own batch stride
    ((2, 7, 3, 6, 45), 4, True),         # a frame view of a ragged width
])
def test_tma_part_pitch(shape, view, copied):
    rng = np.random.default_rng(len(shape))
    x = _t(rng, shape)
    p = x[:, view] if view is not None else x
    buf, pitch = tma_part(p)
    w = p.shape[-1]
    assert pitch == w + (-w % 8) and buf.shape[-1] == pitch
    assert buf.stride(-2) == pitch and buf.stride(1) == p.shape[2] * pitch
    assert buf.stride(0) % 8 == 0 and buf.data_ptr() % 16 == 0
    assert (buf.data_ptr() != p.data_ptr()) == copied
    assert torch.equal(buf[..., :w], p) and not buf[..., w:].any()
    odd = torch.zeros(p.numel() + 1)[1:].view(p.shape).copy_(p)  # a base 4 bytes off
    buf, _ = tma_part(odd)
    assert buf.data_ptr() % 16 == 0 and torch.equal(buf[..., :w], p)


def test_pack_weight_cache_follows_the_weight():
    """A shared weight's packed copy is reused until the weight is written in
    place or its storage is swapped; a per-sample weight is packed afresh."""
    rng = np.random.default_rng(3)
    w = torch.nn.Parameter(_t(rng, (24, 19, 3, 3)), requires_grad=False)
    first = pack_weight(w, [3, 16])
    assert pack_weight(w, [3, 16]) is first
    assert pack_weight(w, [16, 3]) is not first  # another part plan
    with torch.no_grad():
        w.mul_(2)
    again = pack_weight(w, [16, 3])
    assert torch.equal(_unpack(again, 24, [16, 3], 3)[0], w)
    w.data = _t(rng, (24, 19, 3, 3))
    assert torch.equal(_unpack(pack_weight(w, [16, 3]), 24, [16, 3], 3)[0], w)
    per_sample = _t(rng, (2, 24, 19, 3, 3))
    assert pack_weight(per_sample, [19]) is not pack_weight(per_sample, [19])


def _replay_f32(parts, wt, strides, cout, k, pad, plan, bias=None, pre_add=None,
                out_scale=None, lrelu=None, residual=None) -> torch.Tensor:
    """The f32 kernel's arithmetic (csrc/conv.cu conv_f32_kernel): per chunk
    of ``plan`` = (chunks, stages per chunk), per stage of ``f32_stages``
    (channels past a part's end zero) and tap, the weight element (b, tap,
    ci, co) read at b * w_b + off + tap * s_tap + ci * s_ci + co * s_co of
    the flat ``wt``, times the shifted zero-padded input; the chunks'
    partials added in chunk order, then the epilogue."""
    b, _, h, w = parts[0].shape
    ho, wo = h + 2 * pad - k + 1, w + 2 * pad - k + 1
    flat = wt.reshape(-1)
    w_b, off, s_tap, s_ci, s_co = strides
    chans = [p.shape[1] for p in parts]
    cbase = np.cumsum([0] + chans)
    step = F32_STAGE_CH[k]
    stages = f32_stages(chans, k)
    nchunks, per = plan
    assert (nchunks - 1) * per < len(stages) <= nchunks * per
    co = torch.arange(cout).view(1, 1, -1)
    partials = []
    for c in range(nchunks):
        acc = torch.zeros(b, cout, ho, wo)
        for p, c0 in stages[c * per:(c + 1) * per]:
            xs = torch.zeros(b, step, h, w)
            n = min(step, chans[p] - c0)
            xs[:, :n] = parts[p][:, c0:c0 + n]
            xs = F.pad(xs, (pad,) * 4)
            ci = torch.arange(n).view(1, -1, 1) + int(cbase[p]) + c0
            for tap in range(k * k):
                dy, dx = divmod(tap, k)
                idx = (torch.arange(b).view(-1, 1, 1) * w_b + off + tap * s_tap + ci * s_ci
                       + co * s_co)
                wtap = torch.zeros(b, step, cout)
                wtap[:, :n] = flat[idx]
                acc += torch.einsum("bihw,bio->bohw", xs[:, :, dy:dy + ho, dx:dx + wo], wtap)
        partials.append(acc)
    y = partials[0]
    for part in partials[1:]:
        y = y + part
    if bias is not None:
        y = y + bias.view(1, -1, 1, 1)
    if pre_add is not None:
        y = y + pre_add
    if out_scale is not None:
        y = y * out_scale.reshape(-1, cout, 1, 1)
    if lrelu is not None:
        y = lrelu[0] * y + lrelu[1] * y.abs()
    if residual is not None:
        y = y + residual
    return y


@pytest.mark.parametrize("per_sample", [False, True], ids=["shared", "per-sample"])
@pytest.mark.parametrize("k", [3, 1])
def test_pack_weight_f32_layout(k, per_sample):
    """[(B,) Cout, Cin, k, k] -> [(B,) k*k, Cin, Cout], contiguous; a shared
    weight's packed copy is reused until the weight is written in place."""
    rng = np.random.default_rng(k)
    weight = _t(rng, ((3,) if per_sample else ()) + (24, 10, k, k))
    packed = pack_weight_f32(weight)
    assert packed.is_contiguous()
    want = weight.flatten(-2).movedim(-1, -3).transpose(-1, -2).clone()
    assert torch.equal(packed, want)
    if not per_sample:
        assert pack_weight_f32(weight) is packed
        weight.mul_(2)
        assert torch.equal(pack_weight_f32(weight), 2 * want)


# (k, parts' channels, Cout, per-sample weights, b, h, w, plan): stages that
# end a part short of the channel step, Cout off the 64-channel tile, and the
# Cin reduction whole, split as the wrapper plans it for a small card, and
# split into as many chunks as stages
F32_CASES = [(3, [5, 11], 16, True, 2, 6, 9, None), (3, [3, 3], 64, False, 1, 5, 7, (2, 1)),
             (3, [64, 24], 72, False, 2, 4, 5, "plan"), (1, [16, 3], 24, True, 2, 5, 6, (1, 3)),
             (1, [40], 72, False, 1, 3, 4, (3, 1)), (3, [8] * 8, 8, True, 1, 3, 3, (4, 2))]


@pytest.mark.parametrize("case", F32_CASES, ids=str)
def test_replayed_f32_kernel_matches_plain(case):
    """The f32 kernel's decomposition on the repacked weight, with every
    epilogue term, against ``conv_fused_plain`` (the einsum on the packed
    layout is the kernel's product)."""
    k, chans, cout, per_sample, b, h, w, plan = case
    rng = np.random.default_rng(sum(chans) + cout + h)
    parts = [_t(rng, (b, c, h, w)) for c in chans]
    cin = sum(chans)
    weight = _t(rng, ((b,) if per_sample else ()) + (cout, cin, k, k), (cin * k * k) ** -0.5)
    epi = dict(bias=_t(rng, (cout,), 0.1), pre_add=_t(rng, (b, cout, h, w)),
               out_scale=torch.from_numpy(rng.uniform(0.5, 1.5, (b, cout)).astype(np.float32)),
               lrelu=(0.6, 0.4), residual=_t(rng, (b, cout, h, w)))
    nst = len(f32_stages(chans, k))
    if plan is None:
        plan = (1, nst)
    elif plan == "plan":
        plan = f32_chunks(b, chans, cout, h, w, k, sms=4)
        assert plan[0] > 1
    strides = (k * k * cin * cout if per_sample else 0, 0, cin * cout, cout, 1)
    got = _replay_f32(parts, pack_weight_f32(weight), strides, cout, k, k // 2, plan, **epi)
    want = conv_fused_plain(parts, weight, **epi)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_f32_stages_cover_every_channel_once():
    """Each part's channels fall in its own stages, each stage of at most
    the step, in order, and every chunk of a plan takes whole stages."""
    for k in (3, 1):
        for chans in ([3], [64], [64, 3], [5, 11, 16], [64] * 5, [67, 6]):
            stages = f32_stages(chans, k)
            seen = [(p, c0 + j) for p, c0 in stages for j in range(F32_STAGE_CH[k])
                    if c0 + j < chans[p]]
            assert seen == [(p, c) for p, n in enumerate(chans) for c in range(n)]
            for sms in (1, 4, 132):
                n, per = f32_chunks(8, chans, 64, 60, 60, k, sms)
                covered = [t for c in range(n) for t in range(c * per, min((c + 1) * per,
                                                                          len(stages)))]
                assert covered == list(range(len(stages)))
                assert n == 1 or per >= 2


# every f32 conv of the serving path at its shape (8 windows of 180x320),
# which must not split; and the OSConv's training shapes (8 x 60x60), which
# must: (k, parts' channels, Cout)
SERVING_F32 = [(3, [3], 64), (3, [3, 3], 64), (3, [64], 64), (3, [64, 64], 64), (3, [64] * 3, 64),
               (3, [64] * 5, 64), (3, [64] * 5, 128), (1, [64] * 3, 64), (1, [64, 64], 64)]


@pytest.mark.parametrize("case", SERVING_F32, ids=str)
def test_f32_chunks_no_split_at_the_serving_shape(case):
    k, chans, cout = case
    assert f32_chunks(8, chans, cout, 180, 320, k, 132) == (1, len(f32_stages(chans, k)))


@pytest.mark.parametrize("cin", [192, 320, 64])
def test_f32_chunks_fill_one_wave_at_the_training_shape(cin):
    """The OSConv forward at 8 x 60x60 (120 output tiles): the split puts a
    block on every one of 132 SMs and all of them in one wave of two blocks
    a SM."""
    n, _ = f32_chunks(8, [cin], 64, 60, 60, 3, 132)
    co, rows, cols = F32_TILE
    blocks = 8 * -(-64 // co) * -(-60 // rows) * -(-60 // cols) * n
    assert n > 1 and 132 <= blocks <= F32_BLOCKS_PER_SM * 132


@pytest.mark.parametrize("shape,view,copied", [
    ((2, 3, 5, 64), None, False),        # W % 4 == 0: read in place
    ((2, 3, 5, 68), None, False),        # a multiple of 4, not of 8: in place in f32
    ((2, 3, 5, 66), None, True),         # off a multiple of 4: pitch 68
    ((2, 3, 5, 65), None, True),         # odd: pitch 68
    ((2, 7, 3, 6, 320), 2, False),       # a frame view: its own batch stride
    ((2, 7, 3, 6, 45), 4, True),         # a frame view of a ragged width
])
def test_fast_part_pitch(shape, view, copied):
    """The fast kernel's f32 maps: a part is read in place where TMA can
    address its rows (16-byte pitch, base and batch stride, contiguous
    channel planes), else through a pitch-padded f32 copy (pitch a multiple
    of 4, the pad columns zero and never read)."""
    rng = np.random.default_rng(len(shape) + shape[-1])
    x = _t(rng, shape)
    p = x[:, view] if view is not None else x
    buf, pitch = tma_part(p, 4)
    h, w = p.shape[-2:]
    assert pitch == w + (-w % 4) and buf.shape[-1] == pitch and buf.dtype == torch.float32
    assert buf.stride(-1) == 1 and buf.stride(-2) == pitch and buf.stride(1) == h * pitch
    assert buf.stride(0) % 4 == 0 and buf.data_ptr() % 16 == 0
    assert (buf.data_ptr() != p.data_ptr()) == copied
    assert torch.equal(buf[..., :w], p) and not buf[..., w:].any()
    odd = torch.zeros(p.numel() + 1)[1:].view(p.shape).copy_(p)  # a base 4 bytes off
    for q in (odd, p.contiguous(memory_format=torch.channels_last)):
        buf, pitch = tma_part(q, 4)
        assert buf.data_ptr() != q.data_ptr() and buf.data_ptr() % 16 == 0
        assert buf.stride(-2) == pitch and torch.equal(buf[..., :w], p)


def _replay_fast(parts, weight, bias=None, pre_add=None, out_scale=None, lrelu=None,
                 residual=None) -> torch.Tensor:
    """The fast kernel's arithmetic (csrc/conv.cu conv_fast_kernel), tile by
    tile: per 64-column x 4-row tile and 16-channel chunk of each part, the
    f32 box of the slab (rows y0 - k//2 .. , zero outside the image as TMA
    fills it) and its halo columns x0 - 1 and x0 + 64 (zero at the borders),
    rounded to bf16; the dx = 0 and dx = 2 buffers the box shifted one pixel
    right and left with the halo column at the end; per tap, the packed
    bf16 weight block times the buffer's rows dy.., summed in f32 in chunk
    and tap order, then the epilogue."""
    b, _, h, w = parts[0].shape
    k = weight.shape[-1]
    halo, kk, slab = k // 2, k * k, 4 + 2 * (k // 2)
    chans = [p.shape[1] for p in parts]
    cout = weight.shape[-4]
    nct = -(-cout // CO_TILE)
    packed = pack_weight_fast(weight, chans).float()
    packed = packed.reshape(-1, packed.shape[-1])
    blocks = packed.view(packed.shape[0], nct, -1, kk, 8, 2, 8, 8).permute(
        0, 2, 3, 1, 4, 6, 5, 7).reshape(packed.shape[0], -1, kk, nct * CO_TILE, CI_STEP)
    hp, wp = -(-h // 4) * 4, -(-w // 64) * 64
    y = torch.zeros(b, nct * CO_TILE, hp, wp)
    chunk = 0
    for p in parts:
        buf, pitch = tma_part(p, 4)
        # the image as TMA sees it: the true width, zero around it
        img = torch.zeros(b, p.shape[1] + CI_STEP, hp + 2 * halo, wp + 2)
        img[:, :p.shape[1], halo:halo + h, 1:1 + w] = buf[..., :w]
        for c0 in range(0, p.shape[1], CI_STEP):
            for y0 in range(0, h, 4):
                for x0 in range(0, w, 64):
                    box = img[:, c0:c0 + CI_STEP, y0:y0 + slab, x0:x0 + 66]  # halos at 0, 65
                    r = box.to(torch.bfloat16).float()
                    bufs = {0: r[..., 0:64], 1: r[..., 1:65], 2: r[..., 2:66]}
                    for tap in range(kk):
                        dy, dx = divmod(tap, k)
                        a = blocks[:, chunk, tap].expand(b, -1, -1)
                        src = bufs[dx if k == 3 else 1][:, :, dy:dy + 4]
                        y[:, :, y0:y0 + 4, x0:x0 + 64] += torch.einsum("bok,bkhw->bohw", a, src)
            chunk += 1
    y = y[:, :cout, :h, :w]
    if bias is not None:
        y = y + bias.view(1, -1, 1, 1)
    if pre_add is not None:
        y = y + pre_add
    if out_scale is not None:
        y = y * out_scale.reshape(-1, cout, 1, 1)
    if lrelu is not None:
        y = lrelu[0] * y + lrelu[1] * y.abs()
    if residual is not None:
        y = y + residual
    return y


# (kernel size, parts' channels, Cout, per-sample weights, h, w, parts as
# frame views): one to three column tiles, widths on and off a multiple of
# 4, Cin off the 16-channel step, Cout past one 64-channel tile
FAST_REPLAY = [(3, [64], 64, False, 9, 130, False), (3, [3, 3], 64, False, 6, 66, True),
               (1, [16, 3], 24, True, 5, 65, False), (3, [5, 11], 72, True, 7, 7, False),
               (1, [64] * 3, 128, False, 4, 68, False)]


@pytest.mark.parametrize("case", FAST_REPLAY, ids=str)
def test_replayed_fast_kernel_matches_plain(case):
    """The replayed tiling against ``conv_fused_fast_plain`` (bf16 inputs
    and weight, f32 sums in another order): max abs <= 1e-5 of the output's
    scale, with every epilogue term."""
    k, chans, cout, per_sample, h, w, frames = case
    rng = np.random.default_rng(sum(chans) + cout + w)
    b = 2
    if frames:
        clip = _t(rng, (b, len(chans), chans[0], h, w))
        parts = [clip[:, i] for i in range(len(chans))]
    else:
        parts = [_t(rng, (b, c, h, w)) for c in chans]
    weight = _t(rng, ((b,) if per_sample else ()) + (cout, sum(chans), k, k),
                (sum(chans) * k * k) ** -0.5)
    epi = dict(bias=_t(rng, (cout,), 0.1), pre_add=_t(rng, (b, cout, h, w)),
               out_scale=torch.from_numpy(rng.uniform(0.5, 1.5, (b, cout)).astype(np.float32)),
               lrelu=(0.6, 0.4), residual=_t(rng, (b, cout, h, w)))
    want = conv_fused_fast_plain(parts, weight, **epi)
    got = _replay_fast(parts, weight, **epi)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.fixture
def one_thread():
    """One intra-op thread for the replays' small tensors: beside the
    suite's other workers more threads only contend for the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _unpack_pair(packed: torch.Tensor, cout: int, chans, k: int):
    """Inverse of pack_weight_pair: (Whi, Wlo), each [B or 1, Cout, Cin, k, k]."""
    idx = pair_pack_index(cout, tuple(chans), k)
    n = cout * sum(chans) * k * k
    flat = packed.reshape(-1, idx.numel())
    out = flat.new_zeros(flat.shape[0], 2 * n + 1).index_copy_(1, idx, flat)
    return (out[:, :n].reshape(-1, cout, sum(chans), k, k),
            out[:, n:2 * n].reshape(-1, cout, sum(chans), k, k))


@pytest.mark.parametrize("case", PACK_CASES, ids=str)
def test_pack_weight_pair_round_trip(case, one_thread):
    """Whi = bf16(W) and Wlo = bf16(W - Whi) land once each in the pair
    layout, as split_weight's [Whi, Whi, Wlo] blocks hold them, with every
    padding slot zero; two thirds of the segment packing's elements."""
    k, chans, cout, per_sample = case
    rng = np.random.default_rng(sum(chans) + 3 * cout)
    weight = _t(rng, ((2,) if per_sample else ()) + (cout, sum(chans), k, k))
    packed = pack_weight_pair(weight, chans)
    assert packed.dtype == torch.bfloat16
    nchunk = sum(-(-c // CI_STEP) for c in chans)
    assert packed.shape[-1] == -(-cout // CO_TILE) * nchunk * 2 * k * k * CO_TILE * CI_STEP
    hi, lo = _unpack_pair(packed, cout, chans, k)
    w = weight.reshape(-1, *weight.shape[-4:])
    assert torch.equal(hi, w.to(torch.bfloat16))
    assert torch.equal(lo, (w - w.to(torch.bfloat16).float()).to(torch.bfloat16))
    blocks = split_weight(weight, chans).reshape(-1, cout, 3 * sum(chans), k, k)
    off = 0
    for c in chans:
        assert torch.equal(blocks[:, :, 3 * off:3 * off + c], hi[:, :, off:off + c])
        assert torch.equal(blocks[:, :, 3 * off + 2 * c:3 * (off + c)], lo[:, :, off:off + c])
        off += c
    pad = pair_pack_index(cout, tuple(chans), k) == 2 * w[0].numel()
    assert not packed.reshape(-1, pad.numel())[:, pad].any()
    assert 3 * packed.shape[-1] == 2 * pack_weight(split_weight(weight, chans),
                                                   [c for c in chans for _ in range(3)]).shape[-1]


def _replay_split(pairs, weight, bias=None, pre_add=None, out_scale=None, lrelu=None,
                  residual=None, out="pair"):
    """The pair kernel's arithmetic (csrc/conv.cu conv_split_kernel), tile by
    tile: per 64-column x 4-row tile and 16-channel chunk of each pair, the
    hi and lo boxes of the slab (rows y0 - k//2 .., zero outside the image
    and past the pair's channels, as TMA fills them) with their halo columns
    x0 - 1 and x0 + 64; each plane's dx = 0 and dx = 2 buffers the box
    shifted one pixel right and left with the halo column at the end; per
    chunk the packed Whi taps times hi's buffers, the Wlo taps times hi's,
    the Whi taps times lo's, summed in f32 in that order; then the f32
    epilogue (a pair residual as hi + lo) and the result as a pair or f32."""
    b, _, h, w = pairs[0].hi.shape
    k = weight.shape[-1]
    halo, kk, slab = k // 2, k * k, 4 + 2 * (k // 2)
    chans = [p.hi.shape[1] for p in pairs]
    cout = weight.shape[-4]
    nct = -(-cout // CO_TILE)
    packed = pack_weight_pair(weight, chans).float()
    packed = packed.reshape(-1, packed.shape[-1])
    # [tile][chunk][Whi, Wlo][tap][co/8][ci/8][co%8][ci%8] -> [chunk][Whi, Wlo][tap][co][ci]
    blocks = packed.view(packed.shape[0], nct, -1, 2, kk, 8, 2, 8, 8).permute(
        0, 2, 3, 4, 1, 5, 7, 6, 8).reshape(packed.shape[0], -1, 2, kk, nct * CO_TILE, CI_STEP)
    hp, wp = -(-h // 4) * 4, -(-w // 64) * 64
    y = torch.zeros(b, nct * CO_TILE, hp, wp)
    chunk = 0
    for p in pairs:
        imgs = []
        for t in (p.hi, p.lo):
            buf, pitch = tma_part(t)
            assert pitch % 8 == 0 and torch.equal(buf[..., :w], t)
            # the plane as TMA sees it: the true width, zero around it
            img = torch.zeros(b, t.shape[1] + CI_STEP, hp + 2 * halo, wp + 2)
            img[:, :t.shape[1], halo:halo + h, 1:1 + w] = buf[..., :w].float()
            imgs.append(img)
        for c0 in range(0, p.hi.shape[1], CI_STEP):
            for y0 in range(0, h, 4):
                for x0 in range(0, w, 64):
                    bufs = []
                    for img in imgs:  # halos at columns 0 and 65 of the box
                        box = img[:, c0:c0 + CI_STEP, y0:y0 + slab, x0:x0 + 66]
                        bufs.append({0: box[..., 0:64], 1: box[..., 1:65], 2: box[..., 2:66]})
                    for wsel, plane in ((0, 0), (1, 0), (0, 1)):  # hi Whi, hi Wlo, lo Whi
                        for tap in range(kk):
                            dy, dx = divmod(tap, k)
                            a = blocks[:, chunk, wsel, tap].expand(b, -1, -1)
                            src = bufs[plane][dx if k == 3 else 1][:, :, dy:dy + 4]
                            y[:, :, y0:y0 + 4, x0:x0 + 64] += torch.einsum("bok,bkhw->bohw",
                                                                           a, src)
            chunk += 1
    y = y[:, :cout, :h, :w]
    if bias is not None:
        y = y + bias.view(1, -1, 1, 1)
    if pre_add is not None:
        y = y + pre_add
    if out_scale is not None:
        y = y * out_scale.reshape(-1, cout, 1, 1)
    if lrelu is not None:
        y = lrelu[0] * y + lrelu[1] * y.abs()
    if residual is not None:
        y = y + (pair_merge(residual) if isinstance(residual, Pair) else residual)
    return pair_split(y) if out == "pair" else y


# (kernel size, pairs' channels, Cout, per-sample weights, h, w, residual,
# output): one, three and five pairs, Cin off the 16-channel step, Cout past
# one 64-channel tile, widths on and off a multiple of 8 (a pitch-padded
# copy of each plane) over one to three column tiles, pair and f32
# residuals and outputs
SPLIT_REPLAY = [(3, [16], 64, False, 6, 66, "pair", "pair"),
                (3, [5, 11, 8], 24, True, 5, 13, "f32", "f32"),
                (3, [8] * 5, 72, False, 7, 130, None, "pair"),
                (3, [64], 16, True, 9, 64, "pair", "f32"),
                (1, [16, 3], 24, True, 5, 65, "pair", "pair"),
                (1, [8] * 5, 80, False, 4, 72, "f32", "f32")]


@pytest.mark.parametrize("case", SPLIT_REPLAY, ids=str)
def test_replayed_split_kernel_matches_plain(case, one_thread):
    """The replayed pair kernel against ``conv_fused_split_plain`` (the same
    exact products of bf16 values, f32 sums in another order), merged
    values within 1e-5 of the output's scale, with every epilogue term."""
    k, chans, cout, per_sample, h, w, res, out = case
    rng = np.random.default_rng(sum(chans) + cout + w + k)
    b = 2
    pairs = [pair_split(_t(rng, (b, c, h, w))) for c in chans]
    cin = sum(chans)
    weight = _t(rng, ((b,) if per_sample else ()) + (cout, cin, k, k), (cin * k * k) ** -0.5)
    r = _t(rng, (b, cout, h, w))
    epi = dict(bias=_t(rng, (cout,), 0.1), pre_add=_t(rng, (b, cout, h, w)),
               out_scale=torch.from_numpy(rng.uniform(0.5, 1.5, (b, cout)).astype(np.float32)),
               lrelu=(0.6, 0.4), residual={"pair": pair_split(r), "f32": r, None: None}[res],
               out=out)
    got, want = _replay_split(pairs, weight, **epi), conv_fused_split_plain(pairs, weight, **epi)
    assert isinstance(got, Pair) == isinstance(want, Pair) == (out == "pair")
    if out == "pair":
        got, want = pair_merge(got), pair_merge(want)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_replayed_split_kernel_matches_pallas_pair_carry(one_thread):
    """Per-sample weights over one pair of 16 channels with every epilogue
    term, a pair residual and a pair output, against the JAX package's
    ``conv3x3_chw(in_pair=True, res_pair=True, out_pair=True)`` in interpret
    mode (its [Xhi, Xlo, Xhi] x [Whi, Whi, Wlo] im2col): merged values
    within 1e-5 of the output's scale."""
    rng = np.random.default_rng(15)
    b, h, w, cin, cout = 2, 9, 12, 16, 16
    x = rng.standard_normal((b, h, w, cin), dtype=np.float32)
    wt = (0.2 * rng.standard_normal((b, 3, 3, cin, cout))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, (b, cout)).astype(np.float32)
    pre = rng.standard_normal((b, h, w, cout), dtype=np.float32)
    res = rng.standard_normal((b, h, w, cout), dtype=np.float32)
    with pltpu.force_tpu_interpret_mode():
        y = conv3x3_chw(jchw.pair_split(nhwc_to_chw(jnp.asarray(x)), cin),
                        jchw._pack_split_w3(jnp.asarray(wt), b),
                        jnp.asarray(bias).reshape(-1, 1), jnp.asarray(scale)[:, :, None],
                        nhwc_to_chw(jnp.asarray(pre)),
                        jchw.pair_split(nhwc_to_chw(jnp.asarray(res)), cout), h=h, w=w,
                        lrelu=(0.6, 0.4), in_pair=True, out_pair=True, res_pair=True, pc=cin)
    want = np.asarray(chw_to_nhwc(jchw.pair_merge(y, cout), h, w)).transpose(0, 3, 1, 2)
    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))  # noqa: E731
    got = _replay_split([pair_split(nchw(x))],
                        torch.from_numpy(np.ascontiguousarray(wt.transpose(0, 4, 3, 1, 2))),
                        torch.from_numpy(bias), nchw(pre), torch.from_numpy(scale), (0.6, 0.4),
                        pair_split(nchw(res)))
    got = pair_merge(got).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
