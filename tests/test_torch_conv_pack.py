"""The layout steps of the bf16 tensor-core conv (savsr_tpu_torch/ops/conv.py):
the weight repack into the kernel's A-operand stages (``pack_index`` /
``pack_weight``) and the pitch-padded copy of a part TMA cannot address
(``tma_part``).

The kernel itself runs only on the card (chip_smoke.py, tests/test_torch_cuda.py).
Here its decomposition is replayed in PyTorch on the CPU from the packed
weight: per 16-channel step of each part (channels past the part's end
zero, as TMA fills them) and per tap, a [64 x 16] weight block times the
shifted input, summed in f32, then the epilogue. That replay is held to
``conv_fused_plain`` and, for one case, to the JAX package's Pallas
``conv3x3_chw`` in interpret mode: max abs <= 1e-5 (f32, summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from savsr_tpu.ops.pallas.chw_conv import chw_to_nhwc, conv3x3_chw, nhwc_to_chw, pack_w3
from savsr_tpu_torch.ops.conv import (CI_STEP, CO_TILE, conv_fused_plain, pack_index,
                                      pack_weight, tma_part)


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
