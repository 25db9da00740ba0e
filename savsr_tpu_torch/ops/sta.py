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
  ``sta_kernel``.

A failed build or launch raises; nothing falls back to another kernel.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import (check_rc, count_plain, dtype_code, launches, ptr, require, sm_count,
               stream_ptr)

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
    """(packed weights, f32 tap-major bias [25, C]) of the tensor-core kernel,
    kept on ``weight`` as ``_savsr_sta_packed`` while the weight's and the
    bias's storages and version counters stay the same."""
    key = (weight.data_ptr(), weight._version, bias.data_ptr(), bias._version)
    hit = getattr(weight, "_savsr_sta_packed", None)
    if hit is not None and hit[0] == key:
        return hit[1]
    c = weight.shape[1]
    packed = weight.detach().reshape(-1)[sta_pack_index(c).to(weight.device)]
    bias_t = bias.detach().float().reshape(c, TAPS).t().contiguous()
    weight._savsr_sta_packed = (key, (packed, bias_t))
    return packed, bias_t


@functools.lru_cache(maxsize=None)
def _lib():
    from ..csrc.build import load

    lib = load("sta")
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.savsr_sta_fused.restype = i
    lib.savsr_sta_fused.argtypes = [i, p, p, p, p, p, i, i, i, i, p]
    lib.savsr_sta_mma.restype = i
    lib.savsr_sta_mma.argtypes = [p, p, p, p, p,          # x, st, wpack, bias_t, out
                                  i, i, i, i, i, p]       # B, C, H, W, sms, stream
    return lib


def sta_conv_fused(x: torch.Tensor, st: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """lrelu_0.1(kernel_conv(st)) applied as per-pixel 5x5 filters to x.
    CPU tensors take the plain version; CUDA tensors launch a kernel: bf16
    at C 16/32/64 the tensor-core kernel, otherwise the CUDA-core one."""
    if not x.is_cuda:
        return sta_conv_fused_plain(x, st, weight, bias)
    b, c, h, w = x.shape
    dt = x.dtype
    for name, t, shape in (("x", x, (b, c, h, w)), ("st", st, (b, c, h, w)),
                           ("weight", weight, (c * TAPS, c, 1, 1)),
                           ("bias", bias, (c * TAPS,))):
        require(t.is_cuda and t.dtype == dt and t.is_contiguous()
                and tuple(t.shape) == shape,
                f"sta: {name} must be a contiguous {dt} {shape} CUDA tensor")
    out = torch.empty_like(x)
    lib = _lib()
    if dt == torch.bfloat16 and c in MMA_CHANNELS:
        packed, bias_t = pack_sta_weights(weight, bias)
        rc = lib.savsr_sta_mma(ptr(x), ptr(st), ptr(packed), ptr(bias_t), ptr(out), b, c, h, w,
                               sm_count(x.device), stream_ptr(x))
    else:
        rc = lib.savsr_sta_fused(dtype_code(x), ptr(x), ptr(st), ptr(weight), ptr(bias),
                                 ptr(out), b, c, h, w, stream_ptr(x))
    check_rc(lib, rc, "sta_conv_fused")
    launches["sta"] += 1
    return out
