"""The STA kernels' host-side layouts and their order of arithmetic,
replayed on the CPU (csrc/sta.cu ``sta_mma_kernel`` and ``sta_f32_kernel``,
ops/sta.py). The f32 kernel's packing (``sta_f32_pack_index``) is replayed
by ``_replay_f32`` at the end of this file.

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
from savsr_tpu_torch.ops.sta import (MMA_CHANNELS, TAPS, WG_TAPS, f32_channels,
                                     pack_sta_weights, pack_sta_weights_f32,
                                     sta_conv_fused_fast_plain, sta_conv_fused_plain,
                                     sta_f32_pack_index, sta_pack_index)

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


# the f32 kernel (CUDA cores): C padded to 16, 32 or 64; each column of the
# packed weights and bias is the channel the kernel's thread group reads
F32_CHANNELS = [4, 16, 24, 40, 64]


@pytest.mark.parametrize("c", F32_CHANNELS)
def test_f32_pack_index_places_every_weight_once(c):
    """Every weight and bias element lands in exactly one packed slot, at
    [tap][ci][column] with column 8 cg + i holding channel cg + 8i; every
    other slot (rows or columns past C) is the zero."""
    cp = f32_channels(c)
    w_idx, b_idx = sta_f32_pack_index(c)
    assert w_idx.shape == (TAPS * cp * cp,) and b_idx.shape == (TAPS * cp,)
    real = w_idx[w_idx < TAPS * c * c]
    assert torch.equal(torch.sort(real).values, torch.arange(TAPS * c * c))
    assert int((w_idx == TAPS * c * c).sum()) == TAPS * (cp * cp - c * c)
    assert torch.equal(torch.sort(b_idx[b_idx < TAPS * c]).values, torch.arange(TAPS * c))
    t, ci, col = 3, min(2, c - 1), 9 % cp  # column 9: channel cg + 8 i
    ch = col // (cp // 8) + 8 * (col % (cp // 8))
    if ch < c:
        assert int(w_idx[(t * cp + ci) * cp + col]) == (ch * TAPS + t) * c + ci
        assert int(b_idx[t * cp + col]) == ch * TAPS + t


def _replay_f32(x, st, packed, bias_p, c, round_k=False):
    """The f32 kernel's arithmetic from its packed weights: per tap t, K =
    W_t^T st + bias in f32 for the padded channel columns, the abs-form
    LeakyReLU (rounded to bf16 with ``round_k``), times x at the tap's
    replicate-clamped pixel, summed over taps in order; columns mapped back
    to channels."""
    b, _, h, w = x.shape
    cp = f32_channels(c)
    wt = packed.reshape(TAPS, cp, cp)          # [tap][ci][column]
    bt = bias_p.reshape(TAPS, cp)
    col = torch.arange(cp)
    ch = col // (cp // 8) + 8 * (col % (cp // 8))
    stp = F.pad(st.float(), (0, 0, 0, 0, 0, cp - c))
    xp = F.pad(F.pad(x.float(), (2, 2, 2, 2), mode="replicate"), (0, 0, 0, 0, 0, cp - c))
    out = torch.zeros((b, cp, h, w))
    for t in range(TAPS):
        dy, dx = divmod(t, 5)
        k = torch.einsum("ij,bihw->bjhw", wt[t], stp) + bt[t][None, :, None, None]
        k = 0.55 * k + 0.45 * k.abs()
        if round_k:
            k = k.to(torch.bfloat16).float()
        out = out + k * xp[:, ch, dy:dy + h, dx:dx + w]
    back = torch.empty_like(out)
    back[:, ch] = out
    return back[:, :c]


@pytest.mark.parametrize("c", F32_CHANNELS)
def test_f32_pack_replays_plain(c):
    """The replay from the packed weights against sta_conv_fused_plain in
    f32: within 1e-5 of the output's largest magnitude (sums in another
    order)."""
    rng = np.random.default_rng(c)
    f = lambda shape, s: torch.from_numpy(  # noqa: E731
        (s * rng.standard_normal(shape)).astype(np.float32))
    x, st = f((2, c, 7, 9), 2.0), f((2, c, 7, 9), 2.0)
    wk, bk = f((TAPS * c, c, 1, 1), c ** -0.5), f((TAPS * c,), 0.3)
    packed, bias_p = pack_sta_weights_f32(wk, bk)
    got = _replay_f32(x, st, packed, bias_p, c)
    want = sta_conv_fused_plain(x, st, wk, bk)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_f32_pack_with_rounded_k_replays_plain_bf16():
    """bf16 at a C the tensor cores do not take (24): the kernel runs on the
    widened inputs with K rounded to bf16 and the output rounded once; the
    replay against the plain bf16 version within one bf16 step."""
    x, st, wk, bk = _inputs(24, 2, 9, 11, seed=5, scale=4.0)
    packed, bias_p = pack_sta_weights_f32(wk, bk)
    got = _replay_f32(x, st, packed, bias_p, 24, round_k=True).to(torch.bfloat16).float()
    want = sta_conv_fused_plain(x, st, wk, bk).float()
    assert float((got - want).abs().max()) <= ONE_STEP * float(want.abs().max())


def test_f32_pack_cache_is_apart_from_the_bf16_packing():
    """The f32 packing is cached on the weight beside, not in place of, the
    bf16 one, reused while weight and bias are unchanged, and made again
    after an in-place write."""
    c = 16
    w = torch.randn(TAPS * c, c, 1, 1)
    b = torch.randn(TAPS * c)
    bf16_pack = pack_sta_weights(w, b)
    first = pack_sta_weights_f32(w, b)
    assert pack_sta_weights_f32(w, b)[0] is first[0]
    assert pack_sta_weights(w, b)[0] is bf16_pack[0]
    assert first[0].dtype == torch.float32 and first[0].shape == (TAPS * c * c,)
    w.mul_(2.0)
    again = pack_sta_weights_f32(w, b)
    assert again[0] is not first[0]
    assert torch.equal(again[0], 2.0 * first[0])


# the fast tier's tensor-core kernel (csrc/sta.cu sta_fast_kernel): the same
# packed bf16 weights, packed from an f32 weight's bf16 values


def _replay_fast(x, st, packed, bias_t, c):
    """``sta_fast_kernel``'s arithmetic in its order: per tap the K product
    of st rounded to bf16 with the packed weights, f32 sums, + bias, the
    abs-form LeakyReLU in f32 (K not rounded), K * x (f32) at the tap's
    replicate-clamped pixel added to one f32 sum in tap order."""
    b, _, h, w = x.shape
    p = packed.float().reshape(TAPS, c // 16, c // 8, 2, 8, 8)
    wt = p.permute(0, 2, 4, 1, 3, 5).reshape(TAPS, c, c)
    xp = F.pad(x, (2, 2, 2, 2), mode="replicate")
    stb = st.to(torch.bfloat16).float()
    out = torch.zeros((b, c, h, w))
    for t in range(TAPS):
        dy, dx = divmod(t, 5)
        k = torch.einsum("oi,bihw->bohw", wt[t], stb) + bias_t[t][None, :, None, None]
        out = out + (0.55 * k + 0.45 * k.abs()) * xp[:, :, dy:dy + h, dx:dx + w]
    return out


@pytest.mark.parametrize("c", MMA_CHANNELS)
def test_fast_pack_is_the_bf16_values_packing(c):
    """An f32 weight packs to its bf16 values' packing, bit for bit."""
    x, st, wk, bk = _inputs(c, 1, 2, 2, seed=c)
    wf = wk.float() + torch.from_numpy(  # f32 values off the bf16 grid
        np.random.default_rng(c).uniform(-1e-3, 1e-3, wk.shape).astype(np.float32))
    packed, bias_t = pack_sta_weights(wf, bk.float())
    assert packed.dtype == torch.bfloat16
    assert torch.equal(packed, pack_sta_weights(wf.to(torch.bfloat16), bk)[0])


@pytest.mark.parametrize("c", MMA_CHANNELS)
@pytest.mark.parametrize("b,h,w", [(2, 5, 7), (1, 9, 18)])
def test_fast_replay_matches_fast_plain(c, b, h, w):
    """The replay from the packed weights against the fast plain version
    (sum orders differ: f32's 1e-5 of the output's scale)."""
    rng = np.random.default_rng(3 * c + h)
    f = lambda shape, s: torch.from_numpy((s * rng.standard_normal(shape)).astype(np.float32))  # noqa: E731
    x, st = f((b, c, h, w), 4.0), f((b, c, h, w), 4.0)
    wk, bk = f((TAPS * c, c, 1, 1), 2 * c ** -0.5), f((TAPS * c,), 0.5)
    packed, bias_t = pack_sta_weights(wk, bk)
    got = _replay_fast(x, st, packed, bias_t, c)
    want = sta_conv_fused_fast_plain(x, st, wk, bk)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
