"""Per-sample-weight convolution and its weight gradient (kernels 6 and 7):
the OSConv engine of the training path.

Replaces ``savsr_tpu/ops/pallas/osconv_kernel.py::osconv_pallas_agg`` (the
forward, and dx of the backward), ``::osconv_pallas_dagg`` (the per-sample
weight gradient) and the ``jax.custom_vjp`` ``::osconv_agg_train`` around
them. Stride 1, square kernels of size 1 or 3, zero padding 0..k-1:

    y[b, o, h, w]      = sum_{dy,dx,i} xpad[b, i, h+dy, w+dx] * agg[b, dy, dx, i, o]
    dagg[b, p, i, o]   = sum_{h,w}     xpad[b, i, h+dy, w+dx] * g[b, o, h, w],  p = dy*k + dx

with f32 accumulation; ``y`` comes back in x's dtype, ``dagg`` always in f32.

Layouts: activations are NCHW (``x`` [B, Cin, H, W]; ``y`` and ``g``
[B, Cout, Ho, Wo]) like the rest of the port; the per-sample weight keeps
the JAX package's layout ``agg`` [B, kh, kw, Cin, Cout] and ``dagg`` is
[B, kh*kw, Cin, Cout]. The TPU kernels' 128-lane channel padding, 8-aligned
canvas, stacked shifted copies of x and row-slab DMA ring have no
counterpart.

Which kernel runs is chosen by dtype and padding alone (``tensor_cores``):

- bf16 at padding k//2 (the training path: k = 3, padding 1, and the dx
  call at k-1-1 = 1): the tensor cores. ``osconv_agg`` runs the bf16 conv's
  ``conv_wgmma_kernel`` (csrc/conv.cu, the implicit GEMM that takes a
  per-sample weight) on the weight gathered from the JAX layout into its A
  operand (``pack_agg``; the dx call's tap flip and channel swap are folded
  into the same gather, so no flipped copy is made); ``osconv_dagg`` runs
  ``osconv_dagg_wgmma_kernel`` (csrc/osconv.cu). Both read x and g through
  TMA, so a width that is not a multiple of 8 is copied once into a
  pitch-padded buffer (``ops.conv.tma_part``); the training Function keeps
  that copy of x for the backward.
- f32 at any padding (the train-parity tier: true f32, no TF32), and bf16
  at any other padding: the CUDA cores. ``osconv_agg`` runs the f32 conv's
  ``conv_f32_kernel`` (csrc/conv.cu, through ``ops.conv.run_conv_f32``),
  which reads agg as it lies and the dx call's flipped, channel-swapped
  weight from agg through strides (no copy); ``osconv_dagg`` runs
  ``osconv_dagg_kernel`` (csrc/osconv.cu). Both take f32 only: bf16 inputs
  are widened to f32 first (the same products and sums as widening on
  load), and the forward's output is rounded back to bf16.

On CPU tensors every wrapper runs its plain version; on CUDA tensors it
launches its kernel or raises. Each launch counts once in
``ops.launches`` and runs inside a ``torch.profiler.record_function`` range
of the kernel's name, so a profile attributes the repack and pitch copies
to the wrapper too.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from . import (check_rc, count_plain, dtype_code, launches, ptr, require, sm_count,
               stream_ptr)
from .conv import pack_index, run_conv, run_conv_f32, tma_part

# the CUDA-core weight gradient's channel tile (Cin and Cout per block) and
# column segment (DG_CH, DG_SEG in csrc/osconv.cu); it runs one block per SM
DAGG_TILE, DAGG_SEG = 64, 64
# the tensor-core weight gradient's channel tile (Cin and Cout per block,
# TG_CH in csrc/osconv.cu); it runs one block per SM. A chunk of rows walks
# 2 more g rows than x rows and writes a whole f32 partial, so chunks keep at
# least DAGG_TC_MIN_ROWS rows (scripts/osconv_timing.py --plans times this
# plan against two others at the training shapes)
DAGG_TC_TILE, DAGG_TC_MIN_ROWS = 64, 8


def _check(x: torch.Tensor, other: torch.Tensor, k: int, padding: int, what: str) -> None:
    """Checks common to both wrappers (``other`` is agg or g)."""
    dtype_code(x)
    require(x.dim() == 4, f"{what}: x must be [B, Cin, H, W], got {tuple(x.shape)}")
    require(other.dtype == x.dtype and other.device == x.device,
            f"{what}: operands differ in dtype or device ({x.dtype} {x.device} vs "
            f"{other.dtype} {other.device})")
    require(other.shape[0] == x.shape[0],
            f"{what}: batch mismatch, x has {x.shape[0]} samples, the other operand "
            f"{other.shape[0]}")
    require(k in (1, 3), f"{what}: kernel size {k} (1 or 3)")
    require(0 <= padding <= k - 1, f"{what}: padding {padding} outside 0..{k - 1}")
    require(x.is_contiguous() and other.is_contiguous(), f"{what}: operands must be contiguous")


def _check_agg(x: torch.Tensor, agg: torch.Tensor, padding: int) -> None:
    require(agg.dim() == 5 and agg.shape[1] == agg.shape[2],
            f"osconv_agg: agg must be [B, k, k, Cin, Cout], got {tuple(agg.shape)}")
    _check(x, agg, agg.shape[1], padding, "osconv_agg")
    require(agg.shape[3] == x.shape[1],
            f"osconv_agg: agg has {agg.shape[3]} input channels, x {x.shape[1]}")


def _check_dagg(x: torch.Tensor, g: torch.Tensor, kh: int, kw: int, padding: int) -> None:
    require(kh == kw, f"osconv_dagg: kernel {kh}x{kw} is not square")
    require(g.dim() == 4, f"osconv_dagg: g must be [B, Cout, Ho, Wo], got {tuple(g.shape)}")
    _check(x, g, kh, padding, "osconv_dagg")
    ho, wo = x.shape[2] + 2 * padding - kh + 1, x.shape[3] + 2 * padding - kw + 1
    require(tuple(g.shape[2:]) == (ho, wo),
            f"osconv_dagg: g is {tuple(g.shape[2:])}, the conv output is {(ho, wo)}")


def _taps(x: torch.Tensor, k: int, padding: int):
    """(tap index, shifted f32 slice [B, Cin, Ho, Wo]) for the k*k taps."""
    xp = F.pad(x.float(), (padding,) * 4) if padding else x.float()
    ho, wo = xp.shape[2] - k + 1, xp.shape[3] - k + 1
    for dy in range(k):
        for dx in range(k):
            yield dy * k + dx, xp[:, :, dy:dy + ho, dx:dx + wo]


def osconv_agg_plain(x: torch.Tensor, agg: torch.Tensor, padding: int = 1) -> torch.Tensor:
    """Plain PyTorch version of kernel 6: the tap-decomposed sum of
    ``savsr_tpu/ops/osconv.py::osconv_apply_taps``, accumulated in f32."""
    count_plain("osconv_agg", x)
    b, k, _, cin, cout = agg.shape
    w = agg.float().reshape(b, k * k, cin, cout)
    y = None
    for p, xs in _taps(x, k, padding):
        yt = torch.einsum("bihw,bio->bohw", xs, w[:, p])
        y = yt if y is None else y + yt
    return y.to(x.dtype)


def osconv_dagg_plain(x: torch.Tensor, g: torch.Tensor, kh: int, kw: int,
                      padding: int = 1) -> torch.Tensor:
    """Plain PyTorch version of kernel 7 (the transpose of the tap sum):
    [B, kh*kw, Cin, Cout] in f32."""
    count_plain("osconv_dagg", x)
    gf = g.float()
    return torch.stack([torch.einsum("bihw,bohw->bio", xs, gf)
                        for _, xs in _taps(x, kh, padding)], dim=1)


@functools.lru_cache(maxsize=None)
def _lib():
    from ..csrc.build import load

    lib = load("osconv")
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.savsr_osconv_dagg.restype = i
    lib.savsr_osconv_dagg.argtypes = [i, p, p, p, p,       # ksize, x, g, out, scratch
                                      i, i,                # nchunks, rows_per_chunk
                                      i, i, i, i, i, i, p]  # B, Cin, H, W, Cout, pad, stream
    ll = ctypes.c_longlong
    lib.savsr_osconv_dagg_wgmma.restype = i
    lib.savsr_osconv_dagg_wgmma.argtypes = [i, p, ll, ll,   # ksize, x, batch stride, pitch
                                            p, ll, ll,      # g, batch stride, pitch
                                            p, p, i, i,     # out, scratch, nchunks, rows
                                            i, i, i, i, i, p]  # B, Cin, H, W, Cout, stream
    return lib


def dagg_chunks(b: int, cin: int, cout: int, h: int, w: int, sms: int):
    """(number of pixel-row chunks, rows per chunk) of the CUDA-core
    weight-gradient launch, over the rows of x: one block per SM, so the rows
    of each (sample, channel tiles, column segment) are split into as many
    chunks as keep every block in the first wave (or one chunk)."""
    base = b * -(-cin // DAGG_TILE) * -(-cout // DAGG_TILE) * -(-w // DAGG_SEG)
    want = max(1, min(h, sms // base))
    rows = -(-h // want)
    return -(-h // rows), rows


def dagg_tc_chunks(b: int, cin: int, cout: int, h: int, sms: int):
    """(number of pixel-row chunks, rows per chunk) of the tensor-core
    weight-gradient launch: one block per SM, so the rows of each (sample,
    channel tile) are split into as many chunks as keep every block in the
    first wave, of at least DAGG_TC_MIN_ROWS rows (or one chunk)."""
    base = b * -(-cin // DAGG_TC_TILE) * -(-cout // DAGG_TC_TILE)
    want = max(1, min(h // DAGG_TC_MIN_ROWS, sms // base))
    rows = -(-h // want)
    return -(-h // rows), rows


def tensor_cores(dtype: torch.dtype, k: int, padding: int) -> bool:
    """Whether a CUDA launch at this dtype, kernel size and padding runs on
    the tensor cores (bf16 at padding k//2) or on the CUDA-core kernels."""
    return dtype == torch.bfloat16 and padding == k // 2


@functools.lru_cache(maxsize=None)
def _agg_index(cin: int, cout: int, k: int, transpose: bool, device: str):
    """``pack_index`` of the conv that the call runs, read from agg's flat
    [tap][Cin][Cout] (for ``transpose``, the dx call's [k, k, Cout, Cin]
    weight with its taps flipped), on ``device``; and whether it has zero
    slots (channels off the 16-channel step or Cout off the 64-channel tile)."""
    if transpose:
        conv_cout, conv_cin, strides = cin, cout, (cout, 1, cin * cout)
    else:
        conv_cout, conv_cin, strides = cout, cin, (1, cout, cin * cout)
    idx = pack_index(conv_cout, (conv_cin,), k, strides, transpose)
    return idx.to(device), bool((idx == cin * cout * k * k).any())


def pack_agg(agg: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """``agg`` [B, k, k, Cin, Cout] in the bf16 conv kernel's per-sample
    A-operand layout (``ops.conv.pack_index``): [B, L], one gather. With
    ``transpose``, the weight of the dx call, agg with its taps flipped and
    its channel axes swapped, read from agg as it lies."""
    b, k, _, cin, cout = agg.shape
    idx, zero_slots = _agg_index(cin, cout, k, transpose, str(agg.device))
    flat = agg.detach().reshape(b, -1)
    if zero_slots:  # the index's zero slot is one element past the weight
        flat = F.pad(flat, (0, 1))
    return flat.index_select(1, idx)


def f32_agg_strides(shape, transpose: bool = False):
    """Where the f32 conv kernel (``ops.conv.run_conv_f32``) reads weight
    element (b, tap, ci, co) of the conv from agg [B, k, k, Cin, Cout] of
    ``shape``: (per sample, offset, tap, ci, co) strides. As it lies; for
    the dx call (``transpose``) tap k*k-1-tap with ci and co swapped."""
    _, k, _, ci, co = shape
    kk = k * k
    if transpose:
        return kk * ci * co, (kk - 1) * ci * co, -ci * co, 1, co
    return kk * ci * co, 0, ci * co, co, 1


def _agg(x: torch.Tensor, agg: torch.Tensor, padding: int, transpose: bool = False):
    """Kernel 6 on CUDA tensors (checked by the caller). ``transpose``: the
    dx call, with agg's taps flipped and channel axes swapped. Returns the
    output and (buffer, row pitch) of x as the kernel read it: on the tensor
    cores ``tma_part(x)``, which the training Function keeps for the weight
    gradient; on the CUDA cores x itself."""
    b, _, h, w = x.shape
    k = agg.shape[1]
    cout = agg.shape[3] if transpose else agg.shape[4]
    out = torch.empty((b, cout, h + 2 * padding - k + 1, w + 2 * padding - k + 1),
                      dtype=x.dtype, device=x.device)
    xb, pitch = x, w
    with record_function("osconv_agg"):
        if tensor_cores(x.dtype, k, padding):
            xb, pitch = tma_part(x)
            wt = pack_agg(agg, transpose)
            run_conv(k, [xb], [pitch], wt, wt.shape[1], out, "osconv_agg")
        else:
            o32 = out if out.dtype == torch.float32 else torch.empty_like(out, dtype=torch.float32)
            strides = f32_agg_strides(agg.shape, transpose)
            run_conv_f32(k, [x.float()], padding, agg.float(), strides, o32, "osconv_agg")
            if o32 is not out:
                out.copy_(o32)
    return out, (xb, pitch)


def _dagg(x: torch.Tensor, g: torch.Tensor, k: int, padding: int, x_tma=None,
          g_tma=None) -> torch.Tensor:
    """Kernel 7 on CUDA tensors (checked by the caller); ``x_tma`` /
    ``g_tma``: x / g as an earlier kernel 6 launch read them (``_agg``), if
    the caller holds them (used on the tensor cores only)."""
    b, cin, h, w = x.shape
    cout = g.shape[1]
    out = torch.empty((b, k * k, cin, cout), dtype=torch.float32, device=x.device)
    with record_function("osconv_dagg"):
        lib = _lib()
        tc = tensor_cores(x.dtype, k, padding)
        sms = sm_count(x.device)
        nchunks, rows = dagg_tc_chunks(b, cin, cout, h, sms) if tc else dagg_chunks(
            b, cin, cout, h, w, sms)
        nparts = nchunks if tc else nchunks * -(-w // DAGG_SEG)
        scratch = (torch.empty((nparts,) + tuple(out.shape), dtype=torch.float32,
                               device=x.device) if nparts > 1 else None)
        if tc:
            xb, xpitch = x_tma if x_tma is not None else tma_part(x)
            gb, gpitch = g_tma if g_tma is not None else tma_part(g)
            rc = lib.savsr_osconv_dagg_wgmma(k, ptr(xb), xb.stride(0), xpitch, ptr(gb),
                                             gb.stride(0), gpitch, ptr(out), ptr(scratch),
                                             nchunks, rows, b, cin, h, w, cout, stream_ptr(x))
        else:
            xf, gf = x.float(), g.float()
            rc = lib.savsr_osconv_dagg(k, ptr(xf), ptr(gf), ptr(out), ptr(scratch), nchunks,
                                       rows, b, cin, h, w, cout, padding, stream_ptr(x))
        check_rc(lib, rc, "osconv_dagg")
    launches["osconv_dagg"] += 1
    return out


def osconv_agg(x: torch.Tensor, agg: torch.Tensor, padding: int = 1) -> torch.Tensor:
    """Kernel 6: conv of ``x[b]`` [Cin, H, W] with its own weight ``agg[b]``
    [k, k, Cin, Cout] -> [B, Cout, Ho, Wo] in x's dtype. bf16 at padding k//2
    runs on the tensor cores, everything else on the CUDA-core kernel."""
    _check_agg(x, agg, padding)
    if not x.is_cuda:
        return osconv_agg_plain(x, agg, padding)
    return _agg(x, agg, padding)[0]


def osconv_dagg(x: torch.Tensor, g: torch.Tensor, kh: int, kw: int,
                padding: int = 1) -> torch.Tensor:
    """Kernel 7: per-sample weight gradient [B, kh*kw, Cin, Cout], f32. bf16
    at padding k//2 runs on the tensor cores, everything else on the
    CUDA-core kernel."""
    _check_dagg(x, g, kh, kw, padding)
    if not x.is_cuda:
        return osconv_dagg_plain(x, g, kh, kw, padding)
    return _dagg(x, g, kh, padding)


def osconv_agg_dx(g: torch.Tensor, agg: torch.Tensor, padding: int = 1) -> torch.Tensor:
    """Kernel 6 as the backward's dx call: ``g`` [B, Cout, Ho, Wo] through
    ``agg`` [B, k, k, Cin, Cout] with its taps flipped and its channel axes
    swapped, at padding k-1-``padding`` (``padding`` is the forward's) ->
    [B, Cin, H, W]. The flip and swap are never copied: on the tensor cores
    they are folded into the weight's repack, the CUDA-core kernel reads agg
    through strides."""
    require(agg.dim() == 5 and agg.shape[1] == agg.shape[2],
            f"osconv_agg_dx: agg must be [B, k, k, Cin, Cout], got {tuple(agg.shape)}")
    k = agg.shape[1]
    _check(g, agg, k, padding, "osconv_agg_dx")
    require(agg.shape[4] == g.shape[1],
            f"osconv_agg_dx: agg has {agg.shape[4]} output channels, g {g.shape[1]}")
    if not g.is_cuda:
        return osconv_agg_plain(g, agg.flip(1, 2).transpose(3, 4), k - 1 - padding)
    return _agg(g, agg, k - 1 - padding, transpose=True)[0]


class _OSConvAggTrain(torch.autograd.Function):
    """Forward through kernel 6; backward: dx through kernel 6 on the
    cotangent (taps flipped, channel axes swapped, padding k-1-p), dagg
    through kernel 7, cast to agg's dtype. On the tensor-core path the saved
    x is its pitch-padded TMA copy (the same tensor when none was needed),
    so the backward's dagg does not copy it again."""

    @staticmethod
    def forward(ctx, x, agg, padding):
        x, agg = x.contiguous(), agg.contiguous()
        _check_agg(x, agg, padding)
        ctx.padding, ctx.width = padding, x.shape[-1]
        if not x.is_cuda:
            ctx.save_for_backward(x, agg)
            return osconv_agg_plain(x, agg, padding)
        y, (xs, ctx.pitch) = _agg(x, agg, padding)
        ctx.save_for_backward(xs, agg)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        xs, agg = ctx.saved_tensors
        k, p = agg.shape[1], ctx.padding
        g = g.contiguous()
        dx = dagg = None
        if not g.is_cuda:
            if ctx.needs_input_grad[0]:
                dx = osconv_agg_plain(g, agg.flip(1, 2).transpose(3, 4), k - 1 - p)
            if ctx.needs_input_grad[1]:
                dagg = osconv_dagg_plain(xs, g, k, k, p).to(agg.dtype).reshape(agg.shape)
            return dx, dagg, None
        g_tma = None
        if ctx.needs_input_grad[0]:
            dx, g_tma = _agg(g, agg, k - 1 - p, transpose=True)
        if ctx.needs_input_grad[1]:
            dagg = _dagg(xs[..., :ctx.width], g, k, p, (xs, ctx.pitch), g_tma)
            dagg = dagg.to(agg.dtype).reshape(agg.shape)
        return dx, dagg, None


def osconv_agg_train(x: torch.Tensor, agg: torch.Tensor, padding: int = 1) -> torch.Tensor:
    """Trainable per-sample-weight conv: kernels in both directions."""
    return _OSConvAggTrain.apply(x, agg, padding)
