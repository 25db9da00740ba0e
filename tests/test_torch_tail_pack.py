"""The f32 tail kernel's host-side layout and its order of arithmetic,
replayed on the CPU (csrc/tail.cu ``tail_f32_kernel``, ops/tail.py).

The kernel reads a channel's 27 weights from ``pack_tail_weights_f32``'s
packing ([C][28], slot 9 dy + 3 dx + k, then the bias) and computes, per
HR pixel and output k: the taps summed from zero in channel, then (dy, dx)
order, plus the bias, plus the skip (the centre frame's rows mixed by wy,
then its columns by cw; in the bf16 tier the mixed rows and the column
weights rounded to bf16). ``_replay`` does the same from the packed
weights, so a packing fault or a change of order or rounding point shows
here without a card.

Tolerances: f32, the replay against the plain version and against the
Pallas kernel in interpret mode, 1e-5 (the plain kernels' bound in
tests/test_torch_kernels.py: sums of the same products in another order).
bf16 (the widened route, C off the tensor-core kernel's channel counts):
two bf16 steps of the output's largest magnitude (2 x 2^-8 x max): each
side rounds its output once from f32 sums taken in another order, and a
row-mixed centre-frame value next to a rounding boundary may land one bf16
step apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from savsr_tpu.archs.arch_util import Ctx
from savsr_tpu.archs.savsr_arch import tail_fused_apply as jax_tail_fused_apply
from savsr_tpu_torch.archs.savsr_arch import get_hw, tail_operands
from savsr_tpu_torch.ops.tail import (F32_SLOTS, MMA_CHANNELS, pack_tail_weights_f32, tail_fused,
                                      tail_fused_plain)

ONE_STEP = 2.0 ** -8  # one bf16 step, relative to the largest output


def _operands(c, b=2, h0=5, w0=7, scale=(2.5, 1.7), seed=0):
    rng = np.random.default_rng(seed + c)
    H, W = get_hw(h0, w0, scale)
    sr = torch.from_numpy(rng.standard_normal((b, c, H, W)).astype(np.float32))
    xc = torch.from_numpy(rng.random((b, 3, h0, w0)).astype(np.float32))
    weight = torch.from_numpy((c ** -0.5 * rng.standard_normal((3, c, 3, 3))).astype(np.float32))
    bias = torch.from_numpy((0.1 * rng.standard_normal(3)).astype(np.float32))
    return sr, xc, tail_operands(h0, w0, H, W, "cpu"), weight, bias


@pytest.mark.parametrize("c", [3, 24, 64, 96])
def test_f32_pack_places_every_weight_once_and_inverts(c):
    # distinct nonzero values, so each one's slot is known
    weight = torch.arange(1, 27 * c + 1, dtype=torch.float32).reshape(3, c, 3, 3)
    bias = -torch.arange(1, 4, dtype=torch.float32)
    packed = pack_tail_weights_f32(weight, bias)
    assert packed.shape == (F32_SLOTS * c + 4,)
    assert torch.equal(torch.sort(packed[packed != 0]).values,
                       torch.sort(torch.cat([weight.reshape(-1), bias])).values)
    rows = packed[:F32_SLOTS * c].reshape(c, F32_SLOTS)
    for dy in range(3):
        for dx in range(3):
            assert torch.equal(rows[:, 9 * dy + 3 * dx:9 * dy + 3 * dx + 3],
                               weight[:, :, dy, dx].t())
    assert not rows[:, 27].any()
    assert torch.equal(packed[F32_SLOTS * c:], torch.cat([bias, torch.zeros(1)]))
    back = rows[:, :27].reshape(c, 3, 3, 3).permute(3, 0, 1, 2)
    assert torch.equal(back, weight)


def test_f32_pack_cache_follows_weight_and_bias():
    sr, xc, o, weight, bias = _operands(8)
    first = pack_tail_weights_f32(weight, bias)
    assert pack_tail_weights_f32(weight, bias) is first
    bias.add_(1.0)
    second = pack_tail_weights_f32(weight, bias)
    assert second is not first and torch.equal(second[-4:-1], bias)
    weight.mul_(2.0)
    assert torch.equal(pack_tail_weights_f32(weight, bias)[:27], 2 * first[:27])


def _replay(sr, xc, o, packed, round_bf16=False):
    """The kernel's arithmetic from the packed weights, in its order."""
    b, c, H, W = sr.shape
    rows = packed[:F32_SLOTS * c].reshape(c, F32_SLOTS)
    bias = packed[F32_SLOTS * c:F32_SLOTS * c + 3].view(1, 3, 1, 1)
    j0 = o["tail_j0"].long()
    wy = o["tail_wy"].view(1, 1, -1, 1)
    lr = wy * xc[:, :, j0, :] + (1.0 - wy) * xc[:, :, j0 + 1, :]
    cw = o["tail_cw"]
    if round_bf16:
        lr, cw = lr.bfloat16().float(), cw.bfloat16().float()
    c0 = o["tail_c0"].long()
    acc = torch.zeros(b, 3, H, W)
    pad = F.pad(sr, (1, 1, 1, 1))
    for ci in range(c):
        for dy in range(3):
            for dx in range(3):
                w = rows[ci, 9 * dy + 3 * dx:9 * dy + 3 * dx + 3].view(1, 3, 1, 1)
                acc = acc + w * pad[:, ci:ci + 1, dy:dy + H, dx:dx + W]
    return (acc + bias) + (cw[0] * lr[..., c0] + cw[1] * lr[..., c0 + 1])


def _jax_tail(sr, xc, weight, bias, dtype=jnp.float32):
    """The JAX package's tail (its Pallas kernel, interpret mode on the CPU)
    on the port's NCHW operands; NCHW f32 out."""
    b, c, H, W = sr.shape
    h0, w0 = xc.shape[2:]
    wp = -(-W // 128) * 128
    rows = np.zeros((b, H, c, wp), np.float32)
    rows[..., :W] = sr.float().numpy().transpose(0, 2, 1, 3)
    params = {"tail.weight": jnp.asarray(weight.float().numpy().transpose(2, 3, 1, 0)),
              "tail.bias": jnp.asarray(bias.float().numpy())}
    y = jax_tail_fused_apply(Ctx(params), jnp.asarray(rows, dtype),
                             jnp.asarray(xc.float().numpy().transpose(0, 2, 3, 1), dtype),
                             h0, w0, H, W)
    return torch.from_numpy(np.asarray(y.astype(jnp.float32)).transpose(0, 3, 1, 2).copy())


@pytest.mark.parametrize("c", [3, 24])
def test_f32_replay_matches_plain_and_pallas(c):
    sr, xc, o, weight, bias = _operands(c)
    got = _replay(sr, xc, o, pack_tail_weights_f32(weight, bias))
    args = (o["tail_j0"], o["tail_wy"], o["tail_c0"], o["tail_cw"], weight, bias)
    assert float((got - tail_fused_plain(sr, xc, *args)).abs().max()) <= 1e-5
    assert float((got - _jax_tail(sr, xc, weight, bias)).abs().max()) <= 1e-5


def test_bf16_other_channels_replay_and_pallas():
    """bf16 at C = 24 (not a tensor-core channel count): the widened route's
    replay and the port's bf16 tail (its plain version here) against the
    JAX tail in bf16, within two bf16 steps of the largest output."""
    c = 24
    assert c not in MMA_CHANNELS
    sr, xc, o, weight, bias = _operands(c, seed=1)
    sr, xc, weight, bias = (t.bfloat16() for t in (sr, xc, weight, bias))
    args = (o["tail_j0"], o["tail_wy"], o["tail_c0"], o["tail_cw"], weight, bias)
    port = tail_fused(sr, xc, *args)
    assert port.dtype == torch.bfloat16
    want = _jax_tail(sr, xc, weight, bias, jnp.bfloat16)
    tol = 2 * ONE_STEP * float(want.abs().max())
    replay = _replay(sr.float(), xc.float(), o, pack_tail_weights_f32(weight, bias),
                     round_bf16=True).bfloat16().float()
    assert float((replay - want).abs().max()) <= tol
    assert float((port.float() - want).abs().max()) <= tol
    assert float((replay - port.float()).abs().max()) <= tol
