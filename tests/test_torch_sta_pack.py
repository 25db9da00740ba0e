"""The bf16 tensor-core STA kernel's host-side layout and its order of
arithmetic, replayed on the CPU (csrc/sta.cu ``sta_mma_kernel``, ops/sta.py).

The kernel reads its weights from ``sta_pack_index``'s packing and computes,
per tap t: K_t = bf16-input product summed in f32 + bias (f32), the
abs-form LeakyReLU in f32, one rounding to bf16, then K_t * x at the tap's
replicate-clamped pixel added to an f32 sum; one sum over taps 0..12 and
one over taps 13..24 (its two warpgroups), each in tap order, are added and
the result rounded to bf16 once. ``_replay`` does the same from the packed
weights, so a packing fault or a change of rounding point shows here
without a card.

Tolerances: the replay against the plain version (and the Pallas kernel)
within one bf16 step of the output's largest magnitude (2^-8 x max): both
round K to bf16 from f32 sums taken in another order, so a K value next to
a rounding boundary may land one bf16 step apart, and each rounds its
output once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from savsr_tpu.archs.arch_util import Ctx
from savsr_tpu.archs.savsr_arch import _stau_sta_rows
from savsr_tpu_torch.ops.sta import (MMA_CHANNELS, TAPS, WG_TAPS, pack_sta_weights,
                                     sta_conv_fused_plain, sta_pack_index)

ONE_STEP = 2.0 ** -8  # one bf16 step, relative to the largest output


@pytest.mark.parametrize("c", MMA_CHANNELS)
def test_pack_index_inverts(c):
    """Every weight lands in exactly one packed slot, and scattering the
    packed weights back gives the weight bit for bit."""
    idx = sta_pack_index(c)
    assert idx.shape == (TAPS * c * c,)
    assert torch.equal(torch.sort(idx).values, torch.arange(TAPS * c * c))
    rng = np.random.default_rng(c)
    w = torch.from_numpy(rng.standard_normal((TAPS * c, c, 1, 1)).astype(np.float32))
    back = torch.empty(TAPS * c * c)
    back[idx] = w.reshape(-1)[idx]
    assert torch.equal(back.reshape(w.shape), w)


def test_pack_cache_follows_weight_and_bias():
    """The packed pair is reused while weight and bias are unchanged, and
    made again after either is written in place."""
    c = 16
    w = torch.randn(TAPS * c, c, 1, 1)
    b = torch.randn(TAPS * c)
    first = pack_sta_weights(w, b)
    assert pack_sta_weights(w, b)[0] is first[0]
    b.add_(1.0)
    packed, bias_t = pack_sta_weights(w, b)
    assert packed is not first[0]
    assert torch.equal(bias_t, b.reshape(c, TAPS).t())


def _replay(x, st, packed, bias_t, c):
    """The kernel's arithmetic in its order, its weights read from the
    packed layout [tap][k-block][n8][k half][8 n][8 k]."""
    b, _, h, w = x.shape
    p = packed.float().reshape(TAPS, c // 16, c // 8, 2, 8, 8)
    # -> [tap][output channel (n8, n)][input channel (k-block, k half, k)]
    wt = p.permute(0, 2, 4, 1, 3, 5).reshape(TAPS, c, c)
    xp = F.pad(x.float(), (2, 2, 2, 2), mode="replicate")
    stf = st.float()
    sums = [torch.zeros((b, c, h, w)), torch.zeros((b, c, h, w))]
    for t in range(TAPS):
        dy, dx = divmod(t, 5)
        k = torch.einsum("oi,bihw->bohw", wt[t], stf) + bias_t[t][None, :, None, None]
        k = (0.55 * k + 0.45 * k.abs()).to(torch.bfloat16).float()
        sums[t >= WG_TAPS] = sums[t >= WG_TAPS] + k * xp[:, :, dy:dy + h, dx:dx + w]
    return (sums[0] + sums[1]).to(torch.bfloat16)


def _inputs(c, b, h, w, seed, scale=1.0):
    """bf16 x, st, weight [25C, C, 1, 1] and bias, seeded with numpy; the
    weights are large enough that K spans many bf16 binades."""
    rng = np.random.default_rng(seed)
    f = lambda shape, s: torch.from_numpy(  # noqa: E731
        (s * rng.standard_normal(shape)).astype(np.float32)).to(torch.bfloat16)
    return (f((b, c, h, w), scale), f((b, c, h, w), scale),
            f((TAPS * c, c, 1, 1), 2 * c ** -0.5), f((TAPS * c,), 0.5))


@pytest.mark.parametrize("c", MMA_CHANNELS)
@pytest.mark.parametrize("b,h,w", [(2, 5, 7), (1, 9, 18)])
def test_replay_matches_plain(c, b, h, w):
    x, st, wk, bk = _inputs(c, b, h, w, seed=c + h, scale=4.0)
    packed, bias_t = pack_sta_weights(wk, bk)
    got = _replay(x, st, packed, bias_t, c).float()
    want = sta_conv_fused_plain(x, st, wk, bk).float()
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= ONE_STEP * float(want.abs().max())


def test_replay_matches_pallas():
    """The replay against the JAX package's fused STA kernel in interpret
    mode (the Pallas kernel run as tests/test_torch_kernels.py runs it), both
    on the same bf16 inputs."""
    c, b, h, w = 16, 2, 9, 13
    x, st, wk, bk = _inputs(c, b, h, w, seed=12)
    packed, bias_t = pack_sta_weights(wk, bk)
    got = _replay(x, st, packed, bias_t, c).float().numpy()

    def nhwc(t):
        return jnp.asarray(t.float().numpy().transpose(0, 2, 3, 1), jnp.bfloat16)

    params = {"kernel_conv.0.weight": jnp.asarray(wk.float().numpy()[:, :, 0, 0].T[None, None],
                                                  jnp.bfloat16),
              "kernel_conv.0.bias": jnp.asarray(bk.float().numpy(), jnp.bfloat16)}
    with jax.default_matmul_precision("float32"):
        rows = _stau_sta_rows(Ctx(params), "", nhwc(x), nhwc(st), 5, 128)
    want = np.asarray(rows.astype(jnp.float32))[..., :w].transpose(0, 2, 1, 3)  # [B, C, h, w]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= ONE_STEP * np.abs(want).max()
