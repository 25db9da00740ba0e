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
counterpart: the CUDA kernels (csrc/osconv.cu) bounds-check their halos.

On CPU tensors every wrapper runs its plain version; on CUDA tensors it
launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import check_rc, count_plain, dtype_code, launches, ptr, require, stream_ptr

# pixel rows per shared-memory stage of the weight-gradient kernel (DR in
# csrc/osconv.cu): a chunk of rows is a multiple of it
DAGG_ROWS = 2
# channel tiles of the weight-gradient kernel (DI, DO in csrc/osconv.cu)
DAGG_CIN_TILE, DAGG_COUT_TILE = 32, 64
# blocks wanted in flight (two per SM of a 132-SM card) before the pixel rows
# stop being split further, and the most chunks the rows are split into
DAGG_TARGET_BLOCKS, DAGG_MAX_CHUNKS = 264, 8


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
    lib.savsr_osconv_agg.restype = i
    lib.savsr_osconv_agg.argtypes = [i, i, p, p, p,        # ksize, dtype, x, agg, out
                                     i, i, i, i, i, i, p]  # B, Cin, H, W, Cout, pad, stream
    lib.savsr_osconv_dagg.restype = i
    lib.savsr_osconv_dagg.argtypes = [i, i, p, p, p, p,    # ksize, dtype, x, g, out, scratch
                                      i, i,                # nchunks, rows_per_chunk
                                      i, i, i, i, i, i, p]  # B, Cin, H, W, Cout, pad, stream
    return lib


def dagg_chunks(b: int, cin: int, cout: int, ho: int):
    """(number of pixel-row chunks, rows per chunk) of the weight-gradient
    launch: the rows are split until about two blocks per SM are in flight."""
    base = b * -(-cin // DAGG_CIN_TILE) * -(-cout // DAGG_COUT_TILE)
    row_tiles = -(-ho // DAGG_ROWS)
    want = min(DAGG_MAX_CHUNKS, -(-DAGG_TARGET_BLOCKS // base), row_tiles)
    rows = -(-row_tiles // want) * DAGG_ROWS
    return -(-ho // rows), rows


def osconv_agg(x: torch.Tensor, agg: torch.Tensor, padding: int = 1) -> torch.Tensor:
    """Kernel 6: conv of ``x[b]`` [Cin, H, W] with its own weight ``agg[b]``
    [k, k, Cin, Cout] -> [B, Cout, Ho, Wo] in x's dtype."""
    _check_agg(x, agg, padding)
    if not x.is_cuda:
        return osconv_agg_plain(x, agg, padding)
    b, cin, h, w = x.shape
    k, cout = agg.shape[1], agg.shape[4]
    out = torch.empty((b, cout, h + 2 * padding - k + 1, w + 2 * padding - k + 1),
                      dtype=x.dtype, device=x.device)
    lib = _lib()
    rc = lib.savsr_osconv_agg(k, dtype_code(x), ptr(x), ptr(agg), ptr(out), b, cin, h, w, cout,
                              padding, stream_ptr(x))
    check_rc(lib, rc, "osconv_agg")
    launches["osconv_agg"] += 1
    return out


def osconv_dagg(x: torch.Tensor, g: torch.Tensor, kh: int, kw: int,
                padding: int = 1) -> torch.Tensor:
    """Kernel 7: per-sample weight gradient [B, kh*kw, Cin, Cout], f32."""
    _check_dagg(x, g, kh, kw, padding)
    if not x.is_cuda:
        return osconv_dagg_plain(x, g, kh, kw, padding)
    b, cin, h, w = x.shape
    cout, ho = g.shape[1], g.shape[2]
    out = torch.empty((b, kh * kw, cin, cout), dtype=torch.float32, device=x.device)
    nchunks, rows = dagg_chunks(b, cin, cout, ho)
    scratch = (torch.empty((nchunks,) + tuple(out.shape), dtype=torch.float32, device=x.device)
               if nchunks > 1 else None)
    lib = _lib()
    rc = lib.savsr_osconv_dagg(kh, dtype_code(x), ptr(x), ptr(g), ptr(out), ptr(scratch),
                               nchunks, rows, b, cin, h, w, cout, padding, stream_ptr(x))
    check_rc(lib, rc, "osconv_dagg")
    launches["osconv_dagg"] += 1
    return out


class _OSConvAggTrain(torch.autograd.Function):
    """Forward through kernel 6; backward: dx through kernel 6 on the
    cotangent (taps flipped, channel axes swapped, padding k-1-p), dagg
    through kernel 7, cast to agg's dtype."""

    @staticmethod
    def forward(ctx, x, agg, padding):
        x, agg = x.contiguous(), agg.contiguous()
        ctx.save_for_backward(x, agg)
        ctx.padding = padding
        return osconv_agg(x, agg, padding)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, agg = ctx.saved_tensors
        k = agg.shape[1]
        g = g.contiguous()
        dx = dagg = None
        if ctx.needs_input_grad[0]:
            agg_t = agg.flip(1, 2).transpose(3, 4).contiguous()
            dx = osconv_agg(g, agg_t, k - 1 - ctx.padding)
        if ctx.needs_input_grad[1]:
            dagg = osconv_dagg(x, g, k, k, ctx.padding).to(agg.dtype).reshape(agg.shape)
        return dx, dagg, None


def osconv_agg_train(x: torch.Tensor, agg: torch.Tensor, padding: int = 1) -> torch.Tensor:
    """Trainable per-sample-weight conv: kernels in both directions."""
    return _OSConvAggTrain.apply(x, agg, padding)
