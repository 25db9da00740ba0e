"""The layout steps of the tensor-core OSConv path (savsr_tpu_torch/ops/osconv.py,
bf16 at padding k//2): the weight gather from the JAX layout [B, k, k, Cin,
Cout] into the bf16 conv kernel's A operand (``pack_agg``, with the dx call's
tap flip and channel swap folded into the index), and the weight gradient's
shift of g instead of x; and the CUDA-core weight gradient's (f32, any
padding) launch plan and row walk.

The kernels run only on the card (chip_smoke.py, tests/test_torch_cuda.py).
Here their decompositions are replayed in PyTorch on the CPU, in f32 (the
point is the algorithm):

- agg: per 16-channel step (channels past Cin zero, as TMA fills them) and
  per tap, a [64 x 16] block of the packed weight times the shifted input;
- dagg: per chunk of rows (the wrapper's launch plan), per column tile and
  x row, x times the g row ``h - dy + P`` read one pixel right, in place and
  one pixel left (the three dx taps of one wgmma), with the halo pixels from
  the neighbouring column tiles and TMA's zero fill outside the image; chunk
  partials added in chunk order;
- the CUDA-core dagg: per part (chunk of x rows from ``dagg_chunks``, times
  segment of ``DAGG_SEG`` columns), per x row and dy, x times g row ``y +
  pad - dy`` read at column ``c + pad - dx`` (zero off the image); part
  partials added in part order.

Each replay is held to the plain version (f32, max abs <= 1e-5, or 1e-5 of
the max for dagg: summation order) and, for one tiny case, to the JAX
package's Pallas kernel in interpret mode (1e-5 / 1e-4 of the max, as
tests/test_torch_osconv.py holds the plain versions).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from savsr_tpu.ops.pallas.osconv_kernel import osconv_pallas_agg, osconv_pallas_dagg
from savsr_tpu_torch.ops.conv import CI_STEP, CO_TILE, pack_weight, tma_part
from savsr_tpu_torch.ops.osconv import (DAGG_SEG, dagg_chunks, dagg_tc_chunks, osconv_agg_dx,
                                        osconv_agg_plain, osconv_agg_train, osconv_dagg_plain,
                                        pack_agg, tensor_cores)

HALO_PX = 8  # the weight-gradient kernel's halo box (TG_HALO_PX in csrc/osconv.cu)


def _t(rng, shape, std=1.0):
    return torch.from_numpy((std * rng.standard_normal(shape)).astype(np.float32))


def _conv_weight(agg: torch.Tensor, transpose: bool) -> torch.Tensor:
    """The [B, Cout, Cin, k, k] weight of the conv that the call runs: agg
    itself, or (dx) agg with its taps flipped and channel axes swapped."""
    if transpose:
        agg = agg.flip(1, 2).transpose(3, 4)
    return agg.permute(0, 4, 3, 1, 2).contiguous()


def _replay_agg(x: torch.Tensor, packed: torch.Tensor, cout: int, k: int) -> torch.Tensor:
    """The tensor-core agg path's arithmetic, stage by stage, from the packed
    weight (one part, per-sample weights, no epilogue)."""
    b, cin, h, w = x.shape
    kk, halo = k * k, k // 2
    nct = -(-cout // CO_TILE)
    # [tile][chunk][tap][co/8][ci/8][co%8][ci%8] -> [chunk][tap][co][ci]
    blocks = packed.view(b, nct, -1, kk, 8, 2, 8, 8).permute(0, 2, 3, 1, 4, 6, 5, 7).reshape(
        b, -1, kk, nct * CO_TILE, CI_STEP)
    buf, pitch = tma_part(x)
    assert pitch % 8 == 0 and torch.equal(buf[..., :w], x)
    y = torch.zeros(b, nct * CO_TILE, h, w)
    for chunk, c0 in enumerate(range(0, cin, CI_STEP)):
        xs = torch.zeros(b, CI_STEP, h + 2 * halo, w + 2 * halo)
        n = min(CI_STEP, cin - c0)
        xs[:, :n, halo:halo + h, halo:halo + w] = buf[:, c0:c0 + n, :, :w]
        for tap in range(kk):
            dy, dx = divmod(tap, k)
            y += torch.einsum("bok,bkhw->bohw", blocks[:, chunk, tap], xs[:, :, dy:dy + h, dx:dx + w])
    return y[:, :cout]


def _box(t: torch.Tensor, r: int, x0: int, width: int) -> torch.Tensor:
    """A TMA row box [B, C, width] of t [B, C, H, W] at row r, columns x0..:
    zero outside the image."""
    b, c, h, w = t.shape
    out = torch.zeros(b, c, width)
    lo, hi = max(x0, 0), min(x0 + width, w)
    if 0 <= r < h and lo < hi:
        out[:, :, lo - x0:hi - x0] = t[:, :, r, lo:hi]
    return out


def _replay_dagg(x: torch.Tensor, g: torch.Tensor, k: int, sms: int, px: int = 64):
    """The tensor-core weight gradient's arithmetic with g shifted instead of
    x: its launch plan, column tiles of ``px`` pixels, halo boxes, and chunk
    partials added in chunk order."""
    b, cin, h, w = x.shape
    cout, p = g.shape[1], k // 2
    nchunks, rows = dagg_tc_chunks(b, cin, cout, h, sms)
    xb, gb = (tma_part(t)[0][..., :w] for t in (x, g))
    partials = []
    for c in range(nchunks):
        acc = torch.zeros(b, k, k, cin, cout)
        for x0 in range(0, w, px):
            for row in range(c * rows, min(h, (c + 1) * rows)):
                xa = _box(xb, row, x0, px)
                for dy in range(k):
                    gr = row - dy + p
                    center = _box(gb, gr, x0, px)
                    left = (_box(gb, gr, x0 - HALO_PX, HALO_PX)[..., -1:] if x0 > 0
                            else torch.zeros(b, cout, 1))
                    right = (_box(gb, gr, x0 + px, HALO_PX)[..., :1] if x0 + px < w
                             else torch.zeros(b, cout, 1))
                    # dx = 0 reads w + 1, dx = 1 w, dx = 2 w - 1
                    shifted = ([torch.cat([center[..., 1:], right], -1), center,
                                torch.cat([left, center[..., :-1]], -1)] if k == 3 else [center])
                    for dx in range(k):
                        acc[:, dy, dx] += torch.einsum("bip,bop->bio", xa, shifted[dx])
        partials.append(acc)
    total = partials[0]
    for part in partials[1:]:
        total = total + part
    return total.reshape(b, k * k, cin, cout)


# (B, H, W, Cin, Cout, k): Cin and Cout off the 16-channel step and the
# 64-channel tile, W off a multiple of 8 (the pitch-padded copy), Cout 72
# (two output tiles), a 1x1 kernel, and 64 -> 64, whose packing has no zero
# slot either way (the training shapes' case: a gather without the pad)
AGG_CASES = [(2, 9, 13, 20, 8, 3), (1, 7, 16, 5, 72, 3), (2, 5, 11, 16, 24, 1),
             (1, 5, 9, 64, 64, 3)]


@pytest.mark.parametrize("transpose", [False, True], ids=["fwd", "dx"])
@pytest.mark.parametrize("case", AGG_CASES, ids=str)
def test_pack_agg_equals_the_conv_weights_pack(case, transpose):
    """The strided gather from agg as it lies gives exactly the bf16 conv's
    packing of the explicitly permuted (and, for dx, flipped and swapped)
    weight: every element lands once, every other slot is zero."""
    b, _, _, cin, cout, k = case
    rng = np.random.default_rng(cin + cout)
    agg = _t(rng, (b, k, k, cin, cout))
    conv_w = _conv_weight(agg, transpose)
    want = pack_weight(conv_w, [conv_w.shape[2]])
    got = pack_agg(agg, transpose)
    assert torch.equal(got, want)
    assert int((got != 0).sum()) == agg.numel()


@pytest.mark.parametrize("transpose", [False, True], ids=["fwd", "dx"])
@pytest.mark.parametrize("case", AGG_CASES, ids=str)
def test_replayed_agg_matches_plain(case, transpose):
    """Forward: the replay on x; dx: on the cotangent with the folded
    weight, against the plain version on the flipped, swapped weight."""
    b, h, w, cin, cout, k = case
    rng = np.random.default_rng(h * w + cin)
    agg = _t(rng, (b, k, k, cin, cout), (cin * k * k) ** -0.5)
    x = _t(rng, (b, cout if transpose else cin, h, w))
    conv_cout = cin if transpose else cout
    want = osconv_agg_plain(x, agg.flip(1, 2).transpose(3, 4) if transpose else agg, k // 2)
    got = _replay_agg(x, pack_agg(agg, transpose), conv_cout, k)
    assert float((got - want).abs().max()) <= 1e-5


def test_replayed_agg_matches_pallas():
    """Forward and dx against osconv_pallas_agg in interpret mode (the dx on
    the flipped, swapped weight, as the JAX custom_vjp runs it)."""
    rng = np.random.default_rng(7)
    b, h, w, cin, cout = 2, 9, 13, 12, 8
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    g = rng.standard_normal((b, h, w, cout)).astype(np.float32)
    agg = (0.1 * rng.standard_normal((b, 3, 3, cin, cout))).astype(np.float32)
    agg_t = np.ascontiguousarray(agg[:, ::-1, ::-1].transpose(0, 1, 2, 4, 3))
    with pltpu.force_tpu_interpret_mode():
        y_ref = np.asarray(osconv_pallas_agg(jnp.asarray(x), jnp.asarray(agg), 1))
        dx_ref = np.asarray(osconv_pallas_agg(jnp.asarray(g), jnp.asarray(agg_t), 1))
    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))  # noqa: E731
    aggt = torch.from_numpy(agg)
    y = _replay_agg(nchw(x), pack_agg(aggt), cout, 3).numpy().transpose(0, 2, 3, 1)
    dx = _replay_agg(nchw(g), pack_agg(aggt, True), cin, 3).numpy().transpose(0, 2, 3, 1)
    assert np.abs(y - y_ref).max() <= 1e-5
    assert np.abs(dx - dx_ref).max() <= 1e-5


# (B, H, W, Cin, Cout, k, SMs, column tile): the launch plan's chunking
# (H 9 and 17: one chunk, two chunks of 9 and 8 rows), W off a multiple of
# 8, column tiles of 4 pixels so the halo boxes and the zero fill at both
# image borders are exercised, Cout 72, and a 1x1 kernel
DAGG_CASES = [(2, 9, 13, 20, 8, 3, 132, 64), (2, 17, 13, 20, 8, 3, 132, 4),
              (1, 17, 16, 5, 72, 3, 4, 4), (2, 5, 11, 16, 24, 1, 4, 64)]


@pytest.mark.parametrize("case", DAGG_CASES, ids=str)
def test_replayed_dagg_matches_plain(case):
    b, h, w, cin, cout, k, sms, px = case
    rng = np.random.default_rng(h + w + cin + sms)
    x = _t(rng, (b, cin, h, w))
    g = _t(rng, (b, cout, h, w))
    want = osconv_dagg_plain(x, g, k, k, k // 2)
    got = _replay_dagg(x, g, k, sms, px)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_replayed_dagg_matches_pallas():
    """The g-shift form against osconv_pallas_dagg (interpret mode), with
    halo column tiles: padding 1 at every border."""
    rng = np.random.default_rng(8)
    b, h, w, cin, cout = 2, 9, 13, 12, 8
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    g = rng.standard_normal((b, h, w, cout)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(osconv_pallas_dagg(jnp.asarray(x), jnp.asarray(g), 3, 3, 1))
    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))  # noqa: E731
    got = _replay_dagg(nchw(x), nchw(g), 3, sms=4, px=4).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def _replay_cuda_core_dagg(x: torch.Tensor, g: torch.Tensor, k: int, pad: int,
                           sms: int) -> torch.Tensor:
    """The CUDA-core weight gradient's walk: per part (row chunk x column
    segment) the x rows of the chunk, each against the g rows y + pad - dy,
    at g columns c + pad - dx (zero off the image); parts added in order."""
    b, cin, h, w = x.shape
    cout, ho, wo = g.shape[1:]
    nchunks, rows = dagg_chunks(b, cin, cout, h, w, sms)
    out = None
    for chunk in range(nchunks):
        for c0 in range(0, w, DAGG_SEG):
            cols = torch.arange(c0, min(w, c0 + DAGG_SEG))
            part = torch.zeros(b, k * k, cin, cout)
            for y in range(chunk * rows, min(h, (chunk + 1) * rows)):
                for dy in range(k):
                    gr = y + pad - dy
                    if not 0 <= gr < ho:
                        continue
                    for dx in range(k):
                        gc = cols + pad - dx
                        ok = (gc >= 0) & (gc < wo)
                        gv = torch.zeros(b, cout, len(cols))
                        gv[..., ok] = g[:, :, gr, gc[ok]]
                        part[:, dy * k + dx] += torch.einsum("bic,boc->bio", x[:, :, y, cols], gv)
            out = part if out is None else out + part
    return out


# (B, Cin, H, W, Cout, k, padding, SMs): one and several row chunks (SMs 132
# and 4), W over one column segment (130: segments of 64, 64, 2), every
# padding of k = 3 (Ho = H - 2, H, H + 2) and k = 1
CUDA_CORE_DAGG = [(2, 20, 9, 13, 8, 3, 1, 132), (1, 6, 7, 130, 72, 3, 0, 4),
                  (2, 5, 6, 70, 9, 3, 2, 4), (2, 16, 5, 11, 24, 1, 0, 4)]


@pytest.mark.parametrize("case", CUDA_CORE_DAGG, ids=str)
def test_replayed_cuda_core_dagg_matches_plain(case):
    b, cin, h, w, cout, k, pad, sms = case
    rng = np.random.default_rng(h + w + cin)
    x = _t(rng, (b, cin, h, w))
    g = _t(rng, (b, cout, h + 2 * pad - k + 1, w + 2 * pad - k + 1))
    want = osconv_dagg_plain(x, g, k, k, pad)
    got = _replay_cuda_core_dagg(x, g, k, pad, sms)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("b,cin,cout,h,sms,plan", [
    (8, 192, 64, 60, 132, (5, 12)), (8, 320, 64, 60, 132, (3, 20)), (8, 64, 64, 60, 132, (7, 9)),
    (1, 16, 8, 10, 132, (1, 10)), (8, 320, 72, 7, 132, (1, 7)), (2, 48, 32, 40, 4, (2, 20))])
def test_dagg_tc_chunks_cover_the_rows(b, cin, cout, h, sms, plan):
    """The tensor-core weight-gradient plan: chunks of at least 8 rows (or
    one chunk) that cover every row, none empty, and no more blocks than
    SMs unless one chunk is already too many."""
    n, rows = dagg_tc_chunks(b, cin, cout, h, sms)
    assert (n, rows) == plan
    assert n * rows >= h and (n - 1) * rows < h
    assert n == 1 or rows >= 8
    blocks = b * -(-cin // 64) * -(-cout // 64)
    assert n == 1 or blocks * n <= sms


def test_kernel_choice_is_by_dtype_and_padding():
    assert tensor_cores(torch.bfloat16, 3, 1) and tensor_cores(torch.bfloat16, 1, 0)
    assert not tensor_cores(torch.bfloat16, 3, 0) and not tensor_cores(torch.bfloat16, 3, 2)
    assert not tensor_cores(torch.float32, 3, 1) and not tensor_cores(torch.float32, 1, 0)


def test_agg_dx_wrapper_is_the_backward_dx():
    """osconv_agg_dx (the dx call a profile or a benchmark times on its own)
    equals the Function's dx, and refuses a cotangent whose channels are not
    agg's output channels."""
    rng = np.random.default_rng(9)
    x, agg, g = _t(rng, (2, 6, 7, 9)), _t(rng, (2, 3, 3, 6, 5), 0.1), _t(rng, (2, 5, 7, 9))
    xr = x.clone().requires_grad_()
    (osconv_agg_train(xr, agg, 1) * g).sum().backward()
    assert float((osconv_agg_dx(g, agg, 1) - xr.grad).abs().max()) <= 1e-6
    with pytest.raises(ValueError, match="output channels"):
        osconv_agg_dx(x, agg, 1)
