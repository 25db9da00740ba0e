"""Fused 3x3 / 1x1 convolution with epilogue (kernels 1 and 2).

Replaces ``savsr_tpu/ops/pallas/chw_conv.py::conv3x3_chw`` (with its
Cin-chunking wrapper ``conv3x3_chw_parts``) and ``::conv1x1_chw``: a
zero-padded KxK convolution (K in {1, 3}) over the channel concatenation of
``parts``, with f32 accumulation and the fused epilogue

    y = conv + bias;  y += pre_add;  y *= out_scale;
    y = a*y + b*|y|   (abs-form LeakyReLU; 0.2 slope = (0.6, 0.4), ReLU = (0.5, 0.5));
    y += residual

Layout is NCHW. The TPU kernel's flat-padded CHW layout, pad-ring mask and
Cin chunking (forced by 16 MB of VMEM) have no counterpart here: the CUDA
kernels (csrc/conv.cu) run the whole Cin in one launch, reading the channel
parts through separate pointers (f32) or TMA tensor maps (bf16), so no
concat is ever copied. ``weight`` is [Cout, Cin, K, K] (shared) or [B, Cout,
Cin, K, K] (per sample: the attention-folded OSConv weight).

The bf16 kernel is a tensor-core implicit GEMM. Its wrapper owns two layout
steps: ``pack_weight`` reorders the weight into the kernel's A-operand
stages (``pack_index``), and ``tma_part`` gives each part a row pitch that
TMA can address (a multiple of 8 elements, 16-byte aligned base and batch
stride), copying the part into a pitch-padded buffer where it has none.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import check_rc, count_plain, dtype_code, launches, ptr, require, stream_ptr

MAX_PARTS = 8
# the bf16 kernel's tiles: output channels per tile (wgmma M) and input
# channels per pipeline stage (wgmma K); a stage's weights are one
# [64 co][16 ci] block per tap
CO_TILE, CI_STEP = 64, 16


def _kernel_name(weight: torch.Tensor) -> str:
    return "conv3x3" if weight.shape[-1] == 3 else "conv1x1"


def conv_fused_plain(parts: Sequence[torch.Tensor], weight: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     pre_add: Optional[torch.Tensor] = None,
                     out_scale: Optional[torch.Tensor] = None,
                     lrelu: Optional[Tuple[float, float]] = None,
                     residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: the same function, computed in f32."""
    count_plain(_kernel_name(weight), parts[0])
    x = torch.cat(list(parts), 1) if len(parts) > 1 else parts[0]
    dtype = x.dtype
    xf, wf = x.float(), weight.float()
    k = wf.shape[-1]
    if wf.dim() == 5:  # per-sample weights as one grouped conv
        b, cout, cin = wf.shape[:3]
        y = F.conv2d(xf.reshape(1, b * cin, *xf.shape[2:]),
                     wf.reshape(b * cout, cin, k, k), padding=k // 2, groups=b)
        y = y.reshape(b, cout, *xf.shape[2:])
    else:
        y = F.conv2d(xf, wf, padding=k // 2)
    if bias is not None:
        y = y + bias.float().view(1, -1, 1, 1)
    if pre_add is not None:
        y = y + pre_add.float()
    if out_scale is not None:
        y = y * out_scale.float().reshape(-1, y.shape[1], 1, 1)
    if lrelu is not None:
        y = lrelu[0] * y + lrelu[1] * y.abs()
    if residual is not None:
        y = y + residual.float()
    return y.to(dtype)


@functools.lru_cache(maxsize=None)
def pack_index(cout: int, chans: Tuple[int, ...], k: int,
               strides: Optional[Tuple[int, int, int]] = None,
               flip: bool = False) -> torch.Tensor:
    """Where each element of the packed bf16 weight comes from: an int64
    index into the flat weight of ``cout * cin * k * k`` elements, with one
    more slot (that count, a zero) for the padding.

    Packed order: [co tile][chunk][tap][co // 8 % 8][ci // 8 % 2][co % 8][ci % 8]
    with co = 64 * tile + ..., ci = 16 channels of one part from ``c0`` (a
    chunk; each part starts a new one), tap = dy * k + dx. Each (tile,
    chunk, tap) is the 2 KB K-major core-matrix block of the wgmma A
    operand; channels past a part's end and outputs past Cout are zero.

    ``strides`` (co, ci, tap) are the source weight's element strides, by
    default those of [Cout, Cin, k, k]; ``flip`` reads tap k*k-1-tap (the
    kernel turned by 180 degrees)."""
    cin, kk = sum(chans), k * k
    s_co, s_ci, s_tap = strides or (cin * kk, kk, 1)
    nct = -(-cout // CO_TILE)
    ci_of_chunk, off = [], 0
    for c in chans:
        for c0 in range(0, c, CI_STEP):
            ci_of_chunk.append([off + c0 + j if c0 + j < c else -1 for j in range(CI_STEP)])
        off += c
    ci = torch.tensor(ci_of_chunk, dtype=torch.int64).view(1, -1, 1, 1, 2, 1, 8)
    co = torch.arange(nct * CO_TILE, dtype=torch.int64).view(nct, 1, 1, 8, 1, 8, 1)
    tap = torch.arange(kk, dtype=torch.int64).view(1, 1, kk, 1, 1, 1, 1)
    src = co * s_co + ci * s_ci + (kk - 1 - tap if flip else tap) * s_tap
    valid = (co < cout) & (ci >= 0)
    return torch.where(valid, src, torch.full_like(src, cout * cin * kk)).reshape(-1)


@functools.lru_cache(maxsize=None)
def _pack_index_on(cout: int, chans: Tuple[int, ...], k: int, device: str) -> torch.Tensor:
    return pack_index(cout, chans, k).to(device)


def pack_weight(weight: torch.Tensor, chans: Sequence[int]) -> torch.Tensor:
    """The bf16 kernel's weight layout (``pack_index``): [L] for a shared
    [Cout, Cin, k, k] weight, [B, L] for per-sample [B, Cout, Cin, k, k].

    A shared weight (a parameter) keeps its packed copy as an attribute,
    ``_savsr_packed``, reused while its storage, version counter (an
    in-place write moves it) and parts stay the same; per-sample weights
    are built anew every forward and are packed at every call."""
    shared = weight.dim() == 4
    key = (weight.data_ptr(), weight._version, tuple(chans))
    if shared:
        hit = getattr(weight, "_savsr_packed", None)
        if hit is not None and hit[0] == key:
            return hit[1]
    cout, k = weight.shape[-4], weight.shape[-1]
    flat = weight.detach().reshape(-1, weight.numel() if shared else weight[0].numel())
    idx = _pack_index_on(cout, tuple(chans), k, str(weight.device))
    packed = F.pad(flat, (0, 1)).index_select(1, idx)
    if shared:
        packed = packed[0]
        weight._savsr_packed = (key, packed)
    return packed


def tma_part(p: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """A part TMA can read, and its row pitch in elements. TMA needs 16-byte
    aligned rows, channel planes and samples: a part whose width is not a
    multiple of 8, or whose base or batch stride is off, is copied into a
    buffer with the pitch rounded up to 8 (the kernel still reads only the
    true width: the map's extent is W)."""
    w = p.shape[-1]
    if w % 8 == 0 and p.stride(0) % 8 == 0 and p.data_ptr() % 16 == 0:
        return p, w
    pitch = w + (-w % 8)
    buf = p.new_zeros(p.shape[:-1] + (pitch,))
    buf[..., :w] = p
    return buf, pitch


@functools.lru_cache(maxsize=None)
def _lib():
    from ..csrc.build import load

    lib = load("conv")
    lib.savsr_conv_fused.restype = ctypes.c_int
    lib.savsr_conv_fused.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,                # K, dtype, nparts
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong),                       # parts, ch, bstride, pitch
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, H, W, Cout
        ctypes.c_void_p, ctypes.c_longlong,                      # weight, w_bstride
        ctypes.c_void_p, ctypes.c_void_p,                        # bias, pre_add
        ctypes.c_void_p, ctypes.c_longlong,                      # out_scale, s_bstride
        ctypes.c_int, ctypes.c_float, ctypes.c_float,            # lrelu, a, b
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,       # residual, out, stream
    ]
    return lib


def _launch(parts: List[torch.Tensor], weight, bias, pre_add, out_scale,
            lrelu, residual) -> torch.Tensor:
    x0 = parts[0]
    b, _, h, w = x0.shape
    dt = x0.dtype
    k = weight.shape[-1]
    require(k in (1, 3) and weight.shape[-2] == k, f"kernel size {tuple(weight.shape)}")
    require(1 <= len(parts) <= MAX_PARTS, f"{len(parts)} parts (max {MAX_PARTS})")
    for p in parts:
        require(p.is_cuda and p.dtype == dt and p.dim() == 4
                and p.shape[0] == b and tuple(p.shape[2:]) == (h, w),
                "parts must be CUDA tensors of one dtype and size")
        require(p.stride(3) == 1 and p.stride(2) == w and p.stride(1) == h * w,
                "each part needs contiguous channel planes")
    cin = sum(p.shape[1] for p in parts)
    per_sample = weight.dim() == 5
    cout = weight.shape[-4]
    require(weight.dtype == dt and weight.is_contiguous()
            and weight.shape[-3] == cin
            and (not per_sample or weight.shape[0] == b),
            f"weight {tuple(weight.shape)} {weight.dtype} vs input {b}x{cin} {dt}")
    for name, t in (("pre_add", pre_add), ("residual", residual)):
        require(t is None or (t.dtype == dt and t.is_contiguous()
                              and tuple(t.shape) == (b, cout, h, w)),
                f"{name} must be a contiguous {dt} [{b},{cout},{h},{w}] tensor")
    require(bias is None or (bias.dtype == dt and bias.numel() == cout
                             and bias.is_contiguous()), "bias")
    s_bstride = 0
    if out_scale is not None:
        require(out_scale.dtype == torch.float32 and out_scale.is_contiguous()
                and out_scale.numel() in (cout, b * cout), "out_scale")
        s_bstride = cout if out_scale.numel() == b * cout else 0

    out = torch.empty((b, cout, h, w), dtype=dt, device=x0.device)
    chans = [p.shape[1] for p in parts]
    if dt == torch.bfloat16:
        parts, pitch = zip(*(tma_part(p) for p in parts))
        wt = pack_weight(weight, chans)
        w_bstride = wt.shape[1] if per_sample else 0
    else:
        pitch = [w] * len(parts)
        wt, w_bstride = weight, cout * cin * k * k if per_sample else 0
    run_conv(k, parts, pitch, wt, w_bstride, out, _kernel_name(weight), bias, pre_add,
             out_scale, s_bstride, lrelu, residual)
    return out


def run_conv(k: int, parts, pitch, wt: torch.Tensor, w_bstride: int, out: torch.Tensor,
             counter: str, bias=None, pre_add=None, out_scale=None, s_bstride: int = 0,
             lrelu=None, residual=None) -> None:
    """One launch of ``savsr_conv_fused`` (checked by the caller): conv_k of
    the channel parts, each read at its row pitch (``tma_part`` for bf16),
    with the weight as the kernel takes it (``pack_weight`` for bf16;
    ``w_bstride`` elements per sample, 0 for a shared weight) into ``out``
    [B, Cout, H, W]; counted once as ``counter``."""
    b, cout, h, w = out.shape
    n = len(parts)
    part_ptrs = (ctypes.c_void_p * n)(*[p.data_ptr() for p in parts])
    part_ch = (ctypes.c_int * n)(*[p.shape[1] for p in parts])
    part_bs = (ctypes.c_longlong * n)(*[p.stride(0) for p in parts])
    part_pitch = (ctypes.c_longlong * n)(*pitch)
    la, lb = lrelu if lrelu is not None else (1.0, 0.0)
    lib = _lib()
    rc = lib.savsr_conv_fused(k, dtype_code(out), n, part_ptrs, part_ch, part_bs, part_pitch,
                              b, h, w, cout, ptr(wt), w_bstride, ptr(bias), ptr(pre_add),
                              ptr(out_scale), s_bstride, int(lrelu is not None), la, lb,
                              ptr(residual), ptr(out), stream_ptr(out))
    check_rc(lib, rc, counter)
    launches[counter] += 1


def conv_fused(parts, weight: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               pre_add: Optional[torch.Tensor] = None,
               out_scale: Optional[torch.Tensor] = None,
               lrelu: Optional[Tuple[float, float]] = None,
               residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """conv_K(concat(parts, dim=1)) with the fused epilogue; ``parts`` is a
    tensor or a list of [B, Ci, H, W] tensors. CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise)."""
    parts = list(parts) if isinstance(parts, (list, tuple)) else [parts]
    if not parts[0].is_cuda:
        return conv_fused_plain(parts, weight, bias, pre_add, out_scale, lrelu, residual)
    return _launch(parts, weight, bias, pre_add, out_scale, lrelu, residual)
