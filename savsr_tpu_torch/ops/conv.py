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

The f32 kernel runs on the CUDA cores (true f32, the strict tier's
contract). Its wrapper repacks the weight into [(B,) K*K, Cin, Cout]
(``pack_weight_f32``) and plans a split of the Cin reduction where the
output has too few tiles to fill the card (``f32_chunks``; the partials
are added in chunk order by a second kernel). ``run_conv_f32`` is also the
f32 OSConv's launch (ops/osconv.py): any padding 0..K-1 and a weight read
through strides.

The bf16 kernel is a tensor-core implicit GEMM. Its wrapper owns two layout
steps: ``pack_weight`` reorders the weight into the kernel's A-operand
stages (``pack_index``), and ``tma_part`` gives each part a row pitch that
TMA can address (a multiple of 8 elements, 16-byte aligned base and batch
stride), copying the part into a pitch-padded buffer where it has none.

The split conv (``conv_fused_split``, the split serving tier) is the pair-carry
mode of the TPU kernels (``in_pair``, ``out_pair``, ``res_pair``): features
travel as a ``Pair`` of bf16 planes, hi = bf16(y) and lo = bf16(y - hi), and
each conv contracts [Xhi; Xlo; Xhi] against [Whi, Whi, Wlo] on a tensor-core
kernel of its own (f32 accumulators; a pipeline stage holds one 16-channel
chunk of one pair, both planes read once, hi x Whi, hi x Wlo and lo x Whi),
with an f32 epilogue that writes a ``Pair`` or f32. The TPU interleaves hi
and lo channels in ``pc``-wide chunks of one tensor (a VMEM artefact); here
a pair is two tensors and a concat a list of pairs. Its weight, Whi and Wlo
per chunk, is split and packed per call of a per-sample weight, once for a
shared one (``pack_weight_pair``).

The fast conv (``conv_fused_fast``, the fast serving tier: f32 weights and
carries at ``matmul_precision: default``) is the TPU kernels' f32 mode at
DEFAULT precision, one bf16 pass: the inputs and the weight rounded to bf16,
exact products summed in f32, the epilogue and the output in f32. Its kernel
reads the f32 parts through TMA and rounds them to bf16 in shared memory
(in place where W % 4 == 0, else a pitch-padded f32 copy, ``tma_part``);
the weight is rounded by its packing (``pack_weight_fast``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import check_rc, count_plain, dtype_code, launches, ptr, require, sm_count, stream_ptr

MAX_PARTS = 8
# the bf16 kernel's tiles: output channels per tile (wgmma M) and input
# channels per pipeline stage (wgmma K); a stage's weights are one
# [64 co][16 ci] block per tap
CO_TILE, CI_STEP = 64, 16
# the f32 kernel (csrc/conv.cu F_CO, F_ROWS, F_COLS, FCfg::CI): output tiles
# of 64 channels x 4 rows x 64 columns, input channels staged 8 (3x3) or 16
# (1x1) at a time, each part from its own first channel; two blocks run on
# each SM. A split of the Cin reduction keeps at least F32_MIN_STAGES stages
# a chunk and makes at most F32_MAX_CHUNKS chunks.
F32_TILE = (64, 4, 64)
F32_STAGE_CH = {3: 8, 1: 16}
F32_BLOCKS_PER_SM = 2
F32_MIN_STAGES, F32_MAX_CHUNKS = 2, 8


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
    return _conv_plain(parts, weight, bias, pre_add, out_scale, lrelu, residual)


def _conv_plain(parts, weight, bias, pre_add, out_scale, lrelu, residual) -> torch.Tensor:
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


def packed_once(weight: torch.Tensor, plan, pack, bias: Optional[torch.Tensor] = None):
    """``pack()``; for a shared weight (a parameter) kept as its attribute
    ``_savsr_packed`` and reused while its storage, version counter (an
    in-place write moves it) and ``plan`` stay the same, and those of
    ``bias`` where the packing holds it too. Per-sample weights are built
    anew every forward and are packed at every call."""
    if weight.dim() != 4:
        return pack()
    key = (weight.data_ptr(), weight._version, plan)
    if bias is not None:
        key += (bias.data_ptr(), bias._version)
    hit = getattr(weight, "_savsr_packed", None)
    if hit is None or hit[0] != key:
        hit = weight._savsr_packed = (key, pack())
    return hit[1]


def pack_weight(weight: torch.Tensor, chans: Sequence[int]) -> torch.Tensor:
    """The bf16 kernel's weight layout (``pack_index``): [L] for a shared
    [Cout, Cin, k, k] weight, [B, L] for per-sample [B, Cout, Cin, k, k];
    a shared weight's is packed once (``packed_once``)."""
    def pack():
        shared = weight.dim() == 4
        cout, k = weight.shape[-4], weight.shape[-1]
        flat = weight.detach().reshape(-1, weight.numel() if shared else weight[0].numel())
        idx = _pack_index_on(cout, tuple(chans), k, str(weight.device))
        packed = F.pad(flat, (0, 1)).index_select(1, idx)
        return packed[0] if shared else packed

    return packed_once(weight, tuple(chans), pack)


def pack_weight_f32(weight: torch.Tensor) -> torch.Tensor:
    """The f32 kernel's weight layout: [K*K, Cin, Cout] for a shared [Cout,
    Cin, K, K] weight, [B, K*K, Cin, Cout] per sample, contiguous in Cout (the
    OSConv's agg layout); a shared weight's is packed once
    (``packed_once``)."""
    def pack():
        w = weight.detach().flatten(-2)  # [(B,) Cout, Cin, K*K]
        return (w.permute(2, 1, 0) if weight.dim() == 4 else w.permute(0, 3, 2, 1)).contiguous()

    return packed_once(weight, "f32", pack)


def f32_stages(chans: Sequence[int], k: int) -> List[Tuple[int, int]]:
    """The f32 kernel's stages, in order: (part, first channel) of each
    group of ``F32_STAGE_CH[k]`` channels; each part starts a new one."""
    step = F32_STAGE_CH[k]
    return [(p, c0) for p, c in enumerate(chans) for c0 in range(0, c, step)]


def f32_chunks(b: int, chans: Sequence[int], cout: int, ho: int, wo: int, k: int,
               sms: int) -> Tuple[int, int]:
    """(chunks, stages per chunk) of the f32 kernel's Cin reduction. Blocks
    are (sample, channel tile, row tile, column tile, chunk), two resident
    on each SM. A launch takes about (waves of block slots) / chunks of an
    unsplit block's time; the split with the fewest (the fewest chunks on a
    tie) is taken where it saves at least an eighth of the unsplit launch's
    time, which pays for its partials and second pass. So a launch whose
    tiles fill the slots is not split."""
    co, rows, cols = F32_TILE
    nst = len(f32_stages(chans, k))
    base = b * -(-cout // co) * -(-ho // rows) * -(-wo // cols)
    slots = F32_BLOCKS_PER_SM * sms
    one = -(-base // slots)
    best, best_waves = 1, one
    for n in range(2, min(F32_MAX_CHUNKS, nst // F32_MIN_STAGES) + 1):
        waves = -(-base * n // slots)
        if waves * best < best_waves * n:  # waves / n < best_waves / best
            best, best_waves = n, waves
    if 8 * best_waves > 7 * one * best:  # saves less than an eighth
        return 1, nst
    per = -(-nst // best)
    return -(-nst // per), per


def tma_part(p: torch.Tensor, align: int = 8) -> Tuple[torch.Tensor, int]:
    """A part TMA can read, and its row pitch in elements. TMA needs 16-byte
    aligned rows, channel planes and samples (``align`` elements: 8 in bf16,
    4 in f32): a part whose width is not a multiple of ``align``, whose base
    or batch stride is off, or whose channel planes are not contiguous, is
    copied into a buffer with the pitch rounded up to ``align`` (the kernel
    still reads only the true width: the map's extent is W)."""
    h, w = p.shape[-2:]
    if (w % align == 0 and p.stride(0) % align == 0 and p.data_ptr() % 16 == 0
            and p.stride(-1) == 1 and p.stride(-2) == w and p.stride(-3) == h * w):
        return p, w
    pitch = w + (-w % align)
    buf = p.new_zeros(p.shape[:-1] + (pitch,))
    buf[..., :w] = p
    return buf, pitch


class Pair:
    """A feature of the split tier: two bf16 tensors of one shape, ``hi`` =
    bf16(y) and ``lo`` = bf16(y - hi), whose f32 sum stands for y (the TPU
    engine's pair carry, ``savsr_tpu/archs/chw_engine.py`` pair_split)."""

    __slots__ = ("hi", "lo")

    def __init__(self, hi: torch.Tensor, lo: torch.Tensor):
        self.hi, self.lo = hi, lo


def pair_split(x: torch.Tensor) -> Pair:
    """f32 -> its pair: hi = bf16(x), lo = bf16(x - hi)."""
    hi = x.to(torch.bfloat16)
    return Pair(hi, (x - hi.float()).to(torch.bfloat16))


def pair_merge(p: Pair) -> torch.Tensor:
    """A pair's value in f32: hi + lo."""
    return p.hi.float() + p.lo.float()


def split_weight(weight: torch.Tensor, chans: Sequence[int]) -> torch.Tensor:
    """f32 [(B,) Cout, Cin, k, k] -> bf16 [(B,) Cout, 3 Cin, k, k]: for each
    input part (``chans`` channels) the blocks [Whi, Whi, Wlo], Whi =
    bf16(W), Wlo = bf16(W - Whi), against the part's [Xhi; Xlo; Xhi]
    (``savsr_tpu/archs/chw_engine.py`` _split_w)."""
    w = weight.detach().float()
    hi = w.to(torch.bfloat16)
    lo = (w - hi.float()).to(torch.bfloat16)
    blocks, off = [], 0
    for c in chans:
        sl = slice(off, off + c)
        blocks += [hi[..., sl, :, :], hi[..., sl, :, :], lo[..., sl, :, :]]
        off += c
    return torch.cat(blocks, dim=-3)


@functools.lru_cache(maxsize=None)
def pair_pack_index(cout: int, chans: Tuple[int, ...], k: int) -> torch.Tensor:
    """Where each element of the pair kernel's packed weight comes from: an
    int64 index into [Whi flat | Wlo flat] (each ``n`` = cout * cin * k * k
    elements of [Cout, Cin, k, k]), with ``2n`` (a zero) for the padding.

    Packed order: [co tile][chunk][Whi, Wlo][tap][co // 8 % 8][ci // 8 % 2]
    [co % 8][ci % 8]: ``pack_index``'s blocks, each chunk's Whi taps then
    its Wlo taps, so one bulk copy brings a chunk's weights."""
    n = cout * sum(chans) * k * k
    blocks = pack_index(cout, chans, k).view(-(-cout // CO_TILE), -1, 1,
                                             k * k * CO_TILE * CI_STEP)
    pad = blocks == n
    hi = torch.where(pad, torch.full_like(blocks, 2 * n), blocks)
    lo = torch.where(pad, torch.full_like(blocks, 2 * n), blocks + n)
    return torch.cat([hi, lo], 2).reshape(-1)


@functools.lru_cache(maxsize=None)
def _pair_index_on(cout: int, chans: Tuple[int, ...], k: int, device: str) -> torch.Tensor:
    return pair_pack_index(cout, chans, k).to(device)


def pack_weight_pair(weight: torch.Tensor, chans: Sequence[int]) -> torch.Tensor:
    """The pair kernel's weight (``pair_pack_index``): bf16 Whi = bf16(W)
    and Wlo = bf16(W - Whi) of an f32 [Cout, Cin, k, k] weight ([L]) or a
    per-sample [B, Cout, Cin, k, k] one ([B, L]); ``chans`` the pairs'
    channels. A shared weight's is packed once (``packed_once``)."""
    def pack():
        shared = weight.dim() == 4
        cout, k = weight.shape[-4], weight.shape[-1]
        w = weight.detach().float()
        hi = w.to(torch.bfloat16)
        lo = (w - hi.float()).to(torch.bfloat16)
        per = w.numel() if shared else w[0].numel()
        flat = torch.cat([hi.reshape(-1, per), lo.reshape(-1, per)], 1)
        idx = _pair_index_on(cout, tuple(chans), k, str(weight.device))
        packed = F.pad(flat, (0, 1)).index_select(1, idx)
        return packed[0] if shared else packed

    return packed_once(weight, ("pair",) + tuple(chans), pack)


def _split_inputs(parts) -> List[Pair]:
    parts = parts if isinstance(parts, (list, tuple)) else [parts]
    return [p if isinstance(p, Pair) else pair_split(p) for p in parts]


def conv_fused_split_plain(parts, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                           pre_add: Optional[torch.Tensor] = None,
                           out_scale: Optional[torch.Tensor] = None,
                           lrelu: Optional[Tuple[float, float]] = None,
                           residual=None, out: str = "pair"):
    """Plain PyTorch version of the split conv: the f32 conv of [Xhi; Xlo;
    Xhi] (per part) by [Whi, Whi, Wlo], both bf16-valued, with TF32 off, so
    every product is exact and only the f32 sums' order differs from the
    kernel's; then the epilogue in f32 and the pair split of the result."""
    from ..archs.arch_util import float32_precision

    pairs = _split_inputs(parts)
    count_plain(_kernel_name(weight) + "_split", pairs[0].hi)
    xs = [t.float() for p in pairs for t in (p.hi, p.lo, p.hi)]
    w = split_weight(weight, [p.hi.shape[1] for p in pairs]).float()
    res = pair_merge(residual) if isinstance(residual, Pair) else residual
    with float32_precision(True):
        y = _conv_plain(xs, w, None if bias is None else bias.float(), pre_add, out_scale,
                        lrelu, res)
    return pair_split(y) if out == "pair" else y


@functools.lru_cache(maxsize=None)
def _lib():
    from ..csrc.build import load

    lib = load("conv")
    i, ll, f, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p
    lib.savsr_conv_fused.restype = i
    lib.savsr_conv_fused.argtypes = [
        i, i,                                                    # K, nparts
        ctypes.POINTER(p), ctypes.POINTER(i), ctypes.POINTER(ll),
        ctypes.POINTER(ll),                                      # parts, ch, bstride, pitch
        i, i, i, i,                                              # B, H, W, Cout
        p, ll,                                                   # weight, w_bstride
        p, p, p, ll,                                 # bias, pre_add, out_scale, s_bstride
        i, f, f,                                                 # lrelu, a, b
        p, p, p,                                                 # residual, out, stream
    ]
    lib.savsr_conv_f32.restype = i
    lib.savsr_conv_f32.argtypes = [
        i, i, ctypes.POINTER(p), ctypes.POINTER(i), ctypes.POINTER(ll),  # K, nparts, parts
        i, i, i, i, i,                                           # B, H, W, pad, Cout
        p, ll, ll, ll, ll, ll,                                   # weight, w_b, off, tap, ci, co
        p, p, p, ll,                                 # bias, pre_add, out_scale, s_bstride
        i, f, f,                                                 # lrelu, a, b
        p, p, p, i, i, p,                            # residual, out, partial, nchunks, per, stream
    ]
    lib.savsr_conv_fast.restype = i
    lib.savsr_conv_fast.argtypes = lib.savsr_conv_fused.argtypes
    lib.savsr_conv_pair.restype = i
    lib.savsr_conv_pair.argtypes = list(lib.savsr_conv_fused.argtypes[:-3]) + [
        p, p, p, p, p,                               # residual hi / f32, lo, out hi / f32, lo, stream
    ]
    return lib


def _part_arrays(parts):
    n = len(parts)
    return (n, (ctypes.c_void_p * n)(*[p.data_ptr() for p in parts]),
            (ctypes.c_int * n)(*[p.shape[1] for p in parts]),
            (ctypes.c_longlong * n)(*[p.stride(0) for p in parts]))


def _launch(parts: List[torch.Tensor], weight, bias, pre_add, out_scale,
            lrelu, residual) -> torch.Tensor:
    x0 = parts[0]
    b, _, h, w = x0.shape
    dt = x0.dtype
    dtype_code(x0)  # f32 or bf16
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
    name = _kernel_name(weight)
    if dt == torch.float32:
        wt = pack_weight_f32(weight)
        kk = k * k
        strides = (kk * cin * cout if per_sample else 0, 0, cin * cout, cout, 1)
        run_conv_f32(k, parts, k // 2, wt, strides, out, name, bias, pre_add, out_scale,
                     s_bstride, lrelu, residual)
        return out
    parts, pitch = zip(*(tma_part(p) for p in parts))
    wt = pack_weight(weight, [p.shape[1] for p in parts])
    run_conv(k, parts, pitch, wt, wt.shape[1] if per_sample else 0, out, name, bias, pre_add,
             out_scale, s_bstride, lrelu, residual)
    return out


def run_conv(k: int, parts, pitch, wt: torch.Tensor, w_bstride: int, out: torch.Tensor,
             counter: str, bias=None, pre_add=None, out_scale=None, s_bstride: int = 0,
             lrelu=None, residual=None, entry: str = "savsr_conv_fused") -> None:
    """One launch of the bf16 kernel, ``savsr_conv_fused`` (or, ``entry``
    ``savsr_conv_fast``, the fast kernel on f32 parts; checked by the
    caller): conv_k of the channel parts, each read at its row pitch
    (``tma_part``), with the weight as ``pack_weight`` lays it out
    (``w_bstride`` elements per sample, 0 for a shared weight) into ``out``
    [B, Cout, H, W]; counted once as ``counter``."""
    b, cout, h, w = out.shape
    n, part_ptrs, part_ch, part_bs = _part_arrays(parts)
    part_pitch = (ctypes.c_longlong * n)(*pitch)
    la, lb = lrelu if lrelu is not None else (1.0, 0.0)
    lib = _lib()
    rc = getattr(lib, entry)(k, n, part_ptrs, part_ch, part_bs, part_pitch,
                             b, h, w, cout, ptr(wt), w_bstride, ptr(bias), ptr(pre_add),
                             ptr(out_scale), s_bstride, int(lrelu is not None), la, lb,
                             ptr(residual), ptr(out), stream_ptr(out))
    check_rc(lib, rc, counter)
    launches[counter] += 1


def run_conv_f32(k: int, parts, padding: int, wt: torch.Tensor, w_strides, out: torch.Tensor,
                 counter: str, bias=None, pre_add=None, out_scale=None, s_bstride: int = 0,
                 lrelu=None, residual=None) -> None:
    """One launch of the f32 kernel, ``savsr_conv_f32`` (checked by the
    caller): conv_k at ``padding`` of the f32 channel parts (contiguous
    channel planes) into ``out`` [B, Cout, Ho, Wo], the weight element (b,
    tap, ci, co) read at ``b * w_b + off + tap * s_tap + ci * s_ci + co *
    s_co`` for ``w_strides`` = (w_b, off, s_tap, s_ci, s_co); the Cin
    reduction split as ``f32_chunks`` plans it; counted once as
    ``counter``."""
    b, cout, ho, wo = out.shape
    h, w = parts[0].shape[2:]
    nchunks, per = f32_chunks(b, [p.shape[1] for p in parts], cout, ho, wo, k,
                              sm_count(out.device))
    partial = (torch.empty((nchunks,) + tuple(out.shape), dtype=torch.float32,
                           device=out.device) if nchunks > 1 else None)
    n, part_ptrs, part_ch, part_bs = _part_arrays(parts)
    la, lb = lrelu if lrelu is not None else (1.0, 0.0)
    lib = _lib()
    rc = lib.savsr_conv_f32(k, n, part_ptrs, part_ch, part_bs, b, h, w, padding, cout, ptr(wt),
                            *w_strides, ptr(bias), ptr(pre_add), ptr(out_scale), s_bstride,
                            int(lrelu is not None), la, lb, ptr(residual), ptr(out),
                            ptr(partial), nchunks, per, stream_ptr(out))
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


# the split kernel's pairs (csrc/conv.cu PAIR_MAX) and the fast kernel's
# parts (FAST_MAPS)
SPLIT_MAX_PAIRS = 5
FAST_MAX_PARTS = 10


def _f32_epilogue(dev, shape, bias, pre_add, out_scale, residual):
    """Check the split kernel's epilogue operands for an output of ``shape``
    on ``dev``: f32 bias, pre_add and out_scale, and a residual in f32 or as
    a ``Pair``. Returns out_scale's batch stride and the residual's planes
    (hi, lo) or (f32, None)."""
    b, cout = shape[:2]

    def f32_operand(name, t):
        require(t is None or (t.device == dev and t.dtype == torch.float32 and t.is_contiguous()
                              and tuple(t.shape) == shape and t.data_ptr() % 8 == 0),
                f"{name} must be a contiguous 8-byte aligned f32 {list(shape)} tensor on {dev}")

    f32_operand("pre_add", pre_add)
    if isinstance(residual, Pair):
        for t in (residual.hi, residual.lo):
            require(t.device == dev and t.dtype == torch.bfloat16 and t.is_contiguous()
                    and tuple(t.shape) == shape and t.data_ptr() % 4 == 0,
                    f"a pair residual is two contiguous bf16 tensors on {dev}")
        res, res_lo = residual.hi, residual.lo
    else:
        f32_operand("residual", residual)
        res, res_lo = residual, None
    require(bias is None or (bias.device == dev and bias.dtype == torch.float32
                             and bias.numel() == cout and bias.is_contiguous()),
            f"bias must be f32 on {dev}")
    s_bstride = 0
    if out_scale is not None:
        require(out_scale.device == dev and out_scale.dtype == torch.float32
                and out_scale.is_contiguous() and out_scale.numel() in (cout, b * cout),
                "out_scale")
        s_bstride = cout if out_scale.numel() == b * cout else 0
    return s_bstride, res, res_lo


def _launch_split(k: int, pairs: Sequence[Pair], weight: torch.Tensor, bias, pre_add,
                  out_scale, lrelu, residual, out: str):
    """One launch of the split kernel, ``savsr_conv_pair``: the pairs' hi and
    lo planes as TMA maps (``tma_part``), a stage one 16-channel chunk of one
    pair, against ``pack_weight_pair``; returns a ``Pair`` or (``out`` "f32")
    an f32 tensor; counted once as conv3x3_split / conv1x1_split."""
    hi0 = pairs[0].hi
    b, _, h, w = hi0.shape
    require(k in (1, 3) and weight.shape[-2:] == (k, k), f"kernel size {tuple(weight.shape)}")
    require(1 <= len(pairs) <= SPLIT_MAX_PAIRS, f"{len(pairs)} pairs (max {SPLIT_MAX_PAIRS})")
    require(out in ("pair", "f32"), f"out {out!r}")
    for p in pairs:
        for t in (p.hi, p.lo):
            require(t.device == hi0.device and t.dtype == torch.bfloat16 and t.dim() == 4
                    and t.shape[0] == b and tuple(t.shape[2:]) == (h, w)
                    and t.shape[1] == p.hi.shape[1],
                    "pairs must be CUDA bf16 tensors of one size")
            require(t.stride(3) == 1 and t.stride(2) == w and t.stride(1) == h * w,
                    "each plane needs contiguous channel planes")
    chans = [p.hi.shape[1] for p in pairs]
    cout = weight.shape[-4]
    per_sample = weight.dim() == 5
    dev = hi0.device
    require(weight.device == dev and weight.dtype == torch.float32
            and weight.shape[-3] == sum(chans) and (not per_sample or weight.shape[0] == b),
            f"weight {tuple(weight.shape)} {weight.dtype} vs f32 input {b}x{sum(chans)}")
    shape = (b, cout, h, w)
    s_bstride, res, res_lo = _f32_epilogue(dev, shape, bias, pre_add, out_scale, residual)

    maps = [tma_part(t) for p in pairs for t in (p.hi, p.lo)]
    if out == "pair":
        dst = Pair(hi0.new_empty(shape), hi0.new_empty(shape))
        o, o_lo = dst.hi, dst.lo
    else:
        dst = o = torch.empty(shape, dtype=torch.float32, device=hi0.device)
        o_lo = None
    n = len(maps)
    wt = pack_weight_pair(weight, chans)
    la, lb = lrelu if lrelu is not None else (1.0, 0.0)
    counter = _kernel_name(weight) + "_split"
    lib = _lib()
    rc = lib.savsr_conv_pair(
        k, len(pairs), (ctypes.c_void_p * n)(*[t.data_ptr() for t, _ in maps]),
        (ctypes.c_int * n)(*[t.shape[1] for t, _ in maps]),
        (ctypes.c_longlong * n)(*[t.stride(0) for t, _ in maps]),
        (ctypes.c_longlong * n)(*[pitch for _, pitch in maps]), b, h, w, cout, ptr(wt),
        wt.shape[1] if per_sample else 0, ptr(bias), ptr(pre_add), ptr(out_scale), s_bstride,
        int(lrelu is not None), la, lb, ptr(res), ptr(res_lo), ptr(o), ptr(o_lo),
        stream_ptr(o))
    check_rc(lib, rc, counter)
    launches[counter] += 1
    return dst


def conv_fused_split(parts, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     pre_add: Optional[torch.Tensor] = None,
                     out_scale: Optional[torch.Tensor] = None,
                     lrelu: Optional[Tuple[float, float]] = None,
                     residual=None, out: str = "pair"):
    """The split conv of concat(parts): ``parts`` is a ``Pair``, an f32
    tensor or a list of them (f32 parts, the window's raw frames, are split
    first); ``weight`` f32 [Cout, Cin, K, K] or per sample [B, Cout, Cin, K,
    K]; ``bias``, ``pre_add`` f32; ``residual`` a ``Pair`` or f32. Returns
    a ``Pair`` (``out`` "pair") or the f32 result (``out`` "f32"). CPU
    tensors take the plain version; CUDA tensors launch the kernel (or
    raise)."""
    pairs = _split_inputs(parts)
    if not pairs[0].hi.is_cuda:
        return conv_fused_split_plain(pairs, weight, bias, pre_add, out_scale, lrelu, residual,
                                      out)
    return _launch_split(weight.shape[-1], pairs, weight.contiguous(), bias, pre_add,
                          out_scale, lrelu, residual, out)


# ---------------------------------------------------------------------------
# the fast tier's conv
# ---------------------------------------------------------------------------


def conv_fused_fast_plain(parts, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                          pre_add: Optional[torch.Tensor] = None,
                          out_scale: Optional[torch.Tensor] = None,
                          lrelu: Optional[Tuple[float, float]] = None,
                          residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the fast conv: the f32 conv of bf16(parts) by
    bf16(weight), with TF32 off, so every product is exact and only the f32
    sums' order differs from the kernel's; then the epilogue in f32 and an
    f32 result."""
    from ..archs.arch_util import float32_precision

    parts = list(parts) if isinstance(parts, (list, tuple)) else [parts]
    count_plain(_kernel_name(weight) + "_fast", parts[0])
    xs = [p.to(torch.bfloat16).float() for p in parts]
    with float32_precision(True):
        return _conv_plain(xs, weight.to(torch.bfloat16).float(), bias, pre_add, out_scale,
                           lrelu, residual)


def pack_weight_fast(weight: torch.Tensor, chans: Sequence[int]) -> torch.Tensor:
    """The fast conv's weight: bf16(weight) in the bf16 kernel's layout
    (``pack_index``, one block of channels a part); a shared weight's is
    packed once (``packed_once``)."""
    return packed_once(weight, ("fast",) + tuple(chans),
                       lambda: pack_weight(weight.detach().to(torch.bfloat16), chans))


def _launch_fast(k: int, parts: Sequence[torch.Tensor], weight: torch.Tensor, bias, pre_add,
                 out_scale, lrelu, residual) -> torch.Tensor:
    """One launch of the fast kernel, ``savsr_conv_fast``: the f32 parts as
    TMA maps, rounded to bf16 in the kernel, against ``pack_weight_fast``;
    f32 epilogue operands and f32 output; counted once as conv3x3_fast /
    conv1x1_fast. A part is read in place where its rows are 16-byte
    aligned (W % 4 == 0: every serving and parity width), else through a
    pitch-padded f32 copy (``tma_part``)."""
    x0 = parts[0]
    b, _, h, w = x0.shape
    dev = x0.device
    require(k in (1, 3) and weight.shape[-2:] == (k, k), f"kernel size {tuple(weight.shape)}")
    require(1 <= len(parts) <= FAST_MAX_PARTS, f"{len(parts)} parts (max {FAST_MAX_PARTS})")
    for p in parts:
        require(p.device == dev and p.dtype == torch.float32 and p.dim() == 4
                and p.shape[0] == b and tuple(p.shape[2:]) == (h, w),
                "fast parts must be f32 CUDA tensors of one size")
    chans = [p.shape[1] for p in parts]
    cout = weight.shape[-4]
    per_sample = weight.dim() == 5
    require(weight.device == dev and weight.dtype == torch.float32
            and weight.shape[-3] == sum(chans) and (not per_sample or weight.shape[0] == b),
            f"weight {tuple(weight.shape)} {weight.dtype} vs f32 input {b}x{sum(chans)}")
    require(not isinstance(residual, Pair), "the fast conv's residual is an f32 tensor")
    shape = (b, cout, h, w)
    s_bstride, res, _ = _f32_epilogue(dev, shape, bias, pre_add, out_scale, residual)

    bufs, pitch = zip(*(tma_part(p, 4) for p in parts))  # 16 bytes: 4 f32
    wt = pack_weight_fast(weight, chans)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    run_conv(k, bufs, pitch, wt, wt.shape[1] if per_sample else 0, out,
             _kernel_name(weight) + "_fast", bias, pre_add, out_scale, s_bstride, lrelu, res,
             entry="savsr_conv_fast")
    return out


def conv_fused_fast(parts, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                    pre_add: Optional[torch.Tensor] = None,
                    out_scale: Optional[torch.Tensor] = None,
                    lrelu: Optional[Tuple[float, float]] = None,
                    residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The fast conv of concat(parts): ``parts`` an f32 [B, Ci, H, W] tensor
    or a list of them; ``weight`` f32 [Cout, Cin, K, K] or per sample [B,
    Cout, Cin, K, K]; the epilogue operands f32. Returns f32. CPU tensors
    take the plain version; CUDA tensors launch the kernel (or raise)."""
    parts = list(parts) if isinstance(parts, (list, tuple)) else [parts]
    if not parts[0].is_cuda:
        return conv_fused_fast_plain(parts, weight, bias, pre_add, out_scale, lrelu, residual)
    return _launch_fast(weight.shape[-1], parts, weight.contiguous(), bias, pre_add, out_scale,
                        lrelu, residual)
