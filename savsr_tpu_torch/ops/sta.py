"""Fused STA filtering: kernel_conv (1x1) + LeakyReLU(0.1) + 25-tap sta_conv
(kernel 3).

Replaces ``savsr_tpu/ops/pallas/sta_kernel.py::sta_conv_fused`` (reference
semantics lbasicsr/archs/savsr_arch.py:297-313): per-pixel 5x5 kernels are
predicted from the alignment feature ``st`` by a 1x1 conv C -> 25C, then
each pixel of the trunk feature ``x`` is filtered by its own kernel over a
replicate-padded neighbourhood. The CUDA kernels (csrc/sta.cu) keep the
25C-channel kernel tensor on chip. NCHW; the TPU kernel's row layout and
column-validity mask are layout artefacts with no counterpart here.

Which kernel runs on a CUDA tensor is chosen by dtype and channel count:

- bf16 with C in 16, 32, 64 (the flagship and the small configs): the
  tensor cores, ``sta_mma_kernel`` (the K product as one wgmma GEMM per tap,
  pixels as M, output channels as N, f32 accumulators; the filter on the
  CUDA cores in f32; the block's two warpgroups sum taps 0..12 and 13..24
  and add the two sums). Its weights are repacked once into the wgmma B
  layout (``sta_pack_index``) and the bias into f32 tap-major order, both
  kept on the weight tensor (``pack_sta_weights``) while the weight's and
  the bias's storages and version counters stay the same.
- f32 (the strict tier, true f32), and bf16 at any other C: the CUDA-core
  ``sta_f32_kernel`` (persistent 8 x 32-pixel tiles, the K product of each
  tap as a register-tiled shared-memory GEMM, the taps' weights streamed
  into a double buffer). Its weights are repacked once into [tap][input
  channel][column] order with C padded to 16, 32 or 64 (``sta_f32_pack_index``:
  column 8 cg + i holds channel cg + 8i, the channels of thread group cg),
  the bias alike, both kept on the weight (``pack_sta_weights_f32``, apart
  from the bf16 packing). bf16 at other C is widened to f32 here, runs
  with K rounded to bf16 in the kernel (the TPU kernel's rounding point),
  and its f32 output is rounded once to bf16.

The fast tier (``sta_conv_fused_fast``; f32 weights and carries at
``matmul_precision: default``) is the TPU kernel's f32 mode at DEFAULT
precision: the K product takes st and the weight rounded to bf16 (exact
products, f32 sums), and K itself, the 25-tap filter of the f32 trunk and
the output stay f32. At C 16/32/64 it runs ``sta_fast_kernel``: the bf16
kernel's per-tap wgmma K product on st rounded to bf16 as it is loaded and
the weight packed from its bf16 values (``pack_sta_weights``), the taps'
weights streamed through a ring, K and the filter in f32. At other C it
runs ``sta_f32_kernel`` without its K rounding on st rounded to bf16 (one
pass before the launch) and the weight packed from its bf16 values;
rounding commutes with the packing, so both are exact.

A failed build or launch raises; nothing falls back to another kernel.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import (check_rc, count_plain, dtype_code, f32_channels, launches, ptr, require,
               sm_count, stream_ptr)
from .conv import packed_once

KSIZE = 5
TAPS = KSIZE * KSIZE
# the channel counts the tensor-core kernel takes, and the taps its first
# warpgroup sums (WG_TAPS in csrc/sta.cu; the second sums the rest)
MMA_CHANNELS, WG_TAPS = (16, 32, 64), 13

def sta_conv_fused_plain(x: torch.Tensor, st: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version. x, st: [B, C, h, w]; weight: kernel_conv.0
    weight [25C, C, 1, 1] (output channel c*25 + t); bias: [25C]."""
    count_plain("sta", x)
    return _sta_plain(x, st, weight, bias)


def sta_conv_fused_fast_plain(x: torch.Tensor, st: torch.Tensor, weight: torch.Tensor,
                              bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the fast STA: the plain version on bf16(st)
    and bf16(weight) with f32 x, in f32 with TF32 off (every product of the
    K product exact, K unrounded)."""
    from ..archs.arch_util import float32_precision

    count_plain("sta_fast", x)
    with float32_precision(True):
        return _sta_plain(x, st.to(torch.bfloat16).float(), weight.to(torch.bfloat16).float(),
                          bias)


def _sta_plain(x, st, weight, bias) -> torch.Tensor:
    b, c, h, w = x.shape
    kk = KSIZE * KSIZE
    k = F.conv2d(st.float(), weight.float().reshape(c * kk, c, 1, 1), bias.float())
    k = (0.55 * k + 0.45 * k.abs()).to(x.dtype).float().reshape(b, c, kk, h, w)
    pad = KSIZE // 2
    xp = F.pad(x.float(), (pad, pad, pad, pad), mode="replicate")
    out = torch.zeros((b, c, h, w), dtype=torch.float32, device=x.device)
    for t in range(kk):
        dy, dx = divmod(t, KSIZE)
        out = out + k[:, :, t] * xp[:, :, dy:dy + h, dx:dx + w]
    return out.to(x.dtype)


def sta_pack_index(c: int) -> torch.Tensor:
    """Where each element of the tensor-core kernel's packed weights comes
    from: an int64 index into the flat kernel_conv weight [25C, C] (row
    c*25 + t, column ci). Packed order [tap][k-block C/16][n8 C/8][k half
    2][8 n][8 k]: per tap the wgmma B operand B[k = ci][n = output channel]
    in K-major 8x8 core matrices (16-byte rows of 8 input channels)."""
    t, kb, n8, kh, nr, kr = np.meshgrid(
        np.arange(TAPS), np.arange(c // 16), np.arange(c // 8), np.arange(2), np.arange(8),
        np.arange(8), indexing="ij")
    row = (8 * n8 + nr) * TAPS + t
    return torch.from_numpy((row * c + 16 * kb + 8 * kh + kr).reshape(-1).astype(np.int64))


def pack_sta_weights(weight: torch.Tensor, bias: torch.Tensor):
    """(packed bf16 weights, f32 tap-major bias [25, C]) of the tensor-core
    kernels (an f32 weight, the fast tier's, packed from its bf16 values),
    kept on ``weight`` as ``_savsr_sta_packed`` while the weight's and the
    bias's storages and version counters stay the same."""
    key = (weight.data_ptr(), weight._version, bias.data_ptr(), bias._version)
    hit = getattr(weight, "_savsr_sta_packed", None)
    if hit is not None and hit[0] == key:
        return hit[1]
    c = weight.shape[1]
    packed = weight.detach().to(torch.bfloat16).reshape(-1)[sta_pack_index(c).to(weight.device)]
    bias_t = bias.detach().float().reshape(c, TAPS).t().contiguous()
    weight._savsr_sta_packed = (key, (packed, bias_t))
    return packed, bias_t


@functools.lru_cache(maxsize=None)
def sta_f32_pack_index(c: int):
    """Where each element of the CUDA-core kernel's packed weights and bias
    comes from: int64 indices into the flat kernel_conv weight [25C, C] (row
    c*25 + t, column ci) and into the bias [25C], the value one past the end
    standing for a zero. Packed order: weights [tap][ci < CP][column < CP],
    bias [tap][column]; column 8 cg + i (cg < 8, i < CP/8) holds output
    channel cg + 8i, and rows or columns past C are zero."""
    cp = f32_channels(c)
    t, ci, col = np.meshgrid(np.arange(TAPS), np.arange(cp), np.arange(cp), indexing="ij")
    ch = col // (cp // 8) + 8 * (col % (cp // 8))
    w_idx = np.where((ci < c) & (ch < c), (ch * TAPS + t) * c + ci, TAPS * c * c)
    t, col = np.meshgrid(np.arange(TAPS), np.arange(cp), indexing="ij")
    ch = col // (cp // 8) + 8 * (col % (cp // 8))
    b_idx = np.where(ch < c, ch * TAPS + t, TAPS * c)
    return (torch.from_numpy(w_idx.reshape(-1).astype(np.int64)),
            torch.from_numpy(b_idx.reshape(-1).astype(np.int64)))


def pack_sta_weights_f32(weight: torch.Tensor, bias: torch.Tensor, fast: bool = False):
    """(packed weights, packed bias) of the CUDA-core kernel, both f32
    (``sta_f32_pack_index``; ``fast``: the weight's bf16 values), packed
    once for a shared weight and bias (``ops/conv.py packed_once``)."""
    def pack():
        w_idx, b_idx = sta_f32_pack_index(weight.shape[1])
        wt = weight.detach().to(torch.bfloat16) if fast else weight.detach()
        return tuple(F.pad(t.detach().reshape(-1).float(), (0, 1))[idx.to(t.device)]
                     for t, idx in ((wt, w_idx), (bias, b_idx)))

    return packed_once(weight, "sta_fast" if fast else "sta_f32", pack, bias)


@functools.lru_cache(maxsize=None)
def _lib():
    from ..csrc.build import load

    lib = load("sta")
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.savsr_sta_f32.restype = i
    lib.savsr_sta_f32.argtypes = [p, p, p, p, p,          # x, st, wpack, bias_p, out
                                  i, i, i, i, i, i, p]    # B, C, H, W, round_k, sms, stream
    lib.savsr_sta_mma.restype = i
    lib.savsr_sta_mma.argtypes = [p, p, p, p, p,          # x, st, wpack, bias_t, out
                                  i, i, i, i, i, p]       # B, C, H, W, sms, stream
    lib.savsr_sta_fast.restype = i
    lib.savsr_sta_fast.argtypes = lib.savsr_sta_mma.argtypes
    return lib


def _check(what: str, x, st, weight, bias, dt) -> None:
    """The wrappers' operand checks: contiguous CUDA tensors of dtype ``dt``,
    x and st [B, C, h, w], the kernel_conv weight [25C, C, 1, 1] and bias
    [25C]."""
    b, c, h, w = x.shape
    for name, t, shape in (("x", x, (b, c, h, w)), ("st", st, (b, c, h, w)),
                           ("weight", weight, (c * TAPS, c, 1, 1)),
                           ("bias", bias, (c * TAPS,))):
        require(t.is_cuda and t.dtype == dt and t.is_contiguous()
                and tuple(t.shape) == shape,
                f"{what}: {name} must be a contiguous {dt} {shape} CUDA tensor")


def sta_conv_fused(x: torch.Tensor, st: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """lrelu_0.1(kernel_conv(st)) applied as per-pixel 5x5 filters to x.
    CPU tensors take the plain version; CUDA tensors launch a kernel: bf16
    at C 16/32/64 the tensor-core kernel, f32 (and bf16 at other C, widened)
    the CUDA-core one."""
    if not x.is_cuda:
        return sta_conv_fused_plain(x, st, weight, bias)
    b, c, h, w = x.shape
    dt = x.dtype
    _check("sta", x, st, weight, bias, dt)
    out = torch.empty_like(x)
    lib = _lib()
    if dt == torch.bfloat16 and c in MMA_CHANNELS:
        packed, bias_t = pack_sta_weights(weight, bias)
        rc = lib.savsr_sta_mma(ptr(x), ptr(st), ptr(packed), ptr(bias_t), ptr(out), b, c, h, w,
                               sm_count(x.device), stream_ptr(x))
    else:
        dtype_code(x)
        require(c <= 64, f"sta: the CUDA-core kernel takes C <= 64, got {c}")
        packed, bias_p = pack_sta_weights_f32(weight, bias)
        xf, stf = x.float(), st.float()
        out_f = out if dt == torch.float32 else torch.empty_like(xf)
        rc = lib.savsr_sta_f32(ptr(xf), ptr(stf), ptr(packed), ptr(bias_p), ptr(out_f), b, c, h, w,
                               int(dt != torch.float32), sm_count(x.device), stream_ptr(x))
    check_rc(lib, rc, "sta_conv_fused")
    launches["sta"] += 1
    if dt != torch.float32 and c not in MMA_CHANNELS:
        out.copy_(out_f)  # the widened route's one rounding of the output to bf16
    return out


def sta_conv_fused_fast(x: torch.Tensor, st: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor) -> torch.Tensor:
    """The fast STA, all f32 (see the module docstring). CPU tensors take the
    plain version; CUDA tensors launch ``sta_fast_kernel`` at C 16/32/64 and
    ``sta_f32_kernel`` (C <= 64) without its K rounding, on st rounded to
    bf16, at other C."""
    if not x.is_cuda:
        return sta_conv_fused_fast_plain(x, st, weight, bias)
    b, c, h, w = x.shape
    _check("sta fast", x, st, weight, bias, torch.float32)
    out = torch.empty_like(x)
    lib = _lib()
    if c in MMA_CHANNELS:
        packed, bias_t = pack_sta_weights(weight, bias)
        rc = lib.savsr_sta_fast(ptr(x), ptr(st), ptr(packed), ptr(bias_t), ptr(out), b, c, h, w,
                                sm_count(x.device), stream_ptr(x))
    else:
        require(c <= 64, f"sta fast: the CUDA-core kernel takes C <= 64, got {c}")
        packed, bias_p = pack_sta_weights_f32(weight, bias, fast=True)
        st_r = st.to(torch.bfloat16).float()  # st as the K product takes it
        rc = lib.savsr_sta_f32(ptr(x), ptr(st_r), ptr(packed), ptr(bias_p), ptr(out), b, c, h, w,
                               0, sm_count(x.device), stream_ptr(x))
    check_rc(lib, rc, "sta_conv_fused_fast")
    launches["sta_fast"] += 1
    return out
