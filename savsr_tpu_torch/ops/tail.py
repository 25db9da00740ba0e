"""Fused tail: 3x3 conv (C -> 3) + bilinear centre-frame skip (kernel 5).

Replaces ``savsr_tpu/ops/pallas/tail_kernel.py::tail_fused`` (reference
semantics lbasicsr/archs/savsr_arch.py:739-741): the STAU output goes
through ``conv_tail`` (zero padding) and the bilinearly upsampled
(align_corners=False) centre frame is added. The resize is separable with
<=2 nonzeros per row and per column: rows mix ``wy*xc[j0] + (1-wy)*xc[j0+1]``
(j0 clipped to h0-2, as ``_tail_row_mix``), columns ``cw[0]*lr[c0] +
cw[1]*lr[c0+1]`` (c0 clipped to w0-2). The CUDA kernels (csrc/tail.cu) do
both in one pass over the HR image. Which one runs on a CUDA tensor is
chosen by dtype and channel count:

- bf16 with C in 16, 32, 48, 64 (``MMA_CHANNELS``): the tensor cores,
  ``tail_mma_kernel``, with the weight packed as mma B fragments
  (``pack_tail_weights``, cached on the weight).
- f32 (the strict tier, true f32), and bf16 at any other C: the CUDA-core
  ``tail_f32_kernel`` (4 x 8-pixel register tiles, sr streamed by TMA a
  channel at a time with that channel's weights; a width off a multiple of
  8 is copied to a pitch-padded buffer first, ``ops/conv.py tma_part``).
  Its weights and bias are packed once into [C][28] f32 (slot 9 dy + 3 dx
  + k) followed by the bias, kept on the weight (``pack_tail_weights_f32``). bf16 at other C is widened to f32 here and
  runs with the bf16 tier's rounding points in the kernel (the row-mixed
  centre frame and the column weights rounded to bf16); its f32 output is
  rounded once to bf16.

The fast tier (``tail_fused_fast``; f32 weights and carries at
``matmul_precision: default``) is the TPU kernel's f32 mode at DEFAULT
precision: the conv takes sr and the weight rounded to bf16, the ``up``
product the row-mixed centre frame and the column weights rounded to bf16
(exact products, f32 sums), and the bias, the row mix itself and the output
stay f32. It runs ``tail_f32_kernel`` with its rounding points on (sr
rounded as it is loaded) and the weight packed from its bf16 values, with
an f32 output.

A failed build or launch raises; nothing falls back to another kernel.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import check_rc, count_plain, dtype_code, launches, ptr, require, sm_count, stream_ptr
from .conv import packed_once, tma_part

# the channel counts the tensor-core kernel takes in bf16
MMA_CHANNELS = (16, 32, 48, 64)
# f32 slots of a channel's packed weights: 27 taps x outputs and a zero
F32_SLOTS = 28


def tail_fused_plain(sr, xc, rows_j0, rows_wy, cols_c0, cols_w, weight, bias):
    """Plain PyTorch version. sr: [B, C, H, W]; xc: [B, 3, h0, w0];
    rows_j0/rows_wy: [H]; cols_c0: [W]; cols_w: [2, W]; weight: [3, C, 3, 3]."""
    count_plain("tail", sr)
    return _tail_plain(sr, xc, rows_j0, rows_wy, cols_c0, cols_w, weight, bias, sr.dtype,
                       sr.dtype)


def tail_fused_fast_plain(sr, xc, rows_j0, rows_wy, cols_c0, cols_w, weight, bias):
    """Plain PyTorch version of the fast tail: the conv of bf16(sr) by
    bf16(weight) and the skip with its bf16 rounding points, in f32 with
    TF32 off (every product of bf16 values exact); f32 out."""
    from ..archs.arch_util import float32_precision

    count_plain("tail_fast", sr)
    with float32_precision(True):
        return _tail_plain(sr.to(torch.bfloat16).float(), xc, rows_j0, rows_wy, cols_c0, cols_w,
                           weight.to(torch.bfloat16).float(), bias, torch.bfloat16,
                           torch.float32)


def _tail_plain(sr, xc, rows_j0, rows_wy, cols_c0, cols_w, weight, bias, dt, out_dt):
    """The tail with the TPU kernel's skip rounding points at ``dt`` (the row
    mix and the column weights), returned as ``out_dt``."""
    y = F.conv2d(sr.float(), weight.float(), bias.float(), padding=1)
    xf = xc.float()
    j0 = rows_j0.long()
    wy = rows_wy.view(1, 1, -1, 1)
    lr = (wy * xf[:, :, j0, :] + (1.0 - wy) * xf[:, :, j0 + 1, :]).to(dt).float()
    c0 = cols_c0.long()
    cw = cols_w.to(dt).float()
    up = cw[0] * lr[..., c0] + cw[1] * lr[..., c0 + 1]
    return (y + up).to(out_dt)


@functools.lru_cache(maxsize=None)
def tail_pack_index(c: int) -> torch.Tensor:
    """Where each element of the packed bf16 tail weight comes from: an
    int64 index into ``cat(weight.flatten(), [0])`` (weight [3, C, 3, 3];
    the last slot, a zero, pads). The kernel multiplies each row of sr by
    B_dy[C, 16], column n = 3 dx + k (k < 3 an output; n >= 9 zero), and
    shifts the products by dx afterwards. Packed order: [dy][C/16][2 n-tiles]
    [lane][4], lane l = 4g + q holding B_dy[c][8 nt + g] for c = 16 kb + 2q,
    +1, +8, +9 (the mma.sync m16n8k16 B fragment)."""
    lane = np.arange(32)
    g, q = lane[:, None] // 4, lane[:, None] % 4
    j = np.arange(4)[None, :]
    kk = 2 * q + j % 2 + 8 * (j // 2)
    n = np.broadcast_to(g, kk.shape)
    blocks = []
    for dy in range(3):
        for kb in range(c // 16):
            for nt in range(2):
                dx, k = (8 * nt + n) // 3, (8 * nt + n) % 3
                blocks.append(np.where(8 * nt + n < 9,
                                       ((k * c + 16 * kb + kk) * 3 + dy) * 3 + dx, 27 * c))
    return torch.from_numpy(np.stack(blocks).reshape(-1).astype(np.int64))


def pack_tail_weights(weight: torch.Tensor) -> torch.Tensor:
    """The bf16 kernel's B fragments (``tail_pack_index``), kept on the
    weight as ``_savsr_tail_packed`` while its storage and version counter
    stay the same."""
    key = (weight.data_ptr(), weight._version)
    hit = getattr(weight, "_savsr_tail_packed", None)
    if hit is not None and hit[0] == key:
        return hit[1]
    flat = torch.cat([weight.detach().reshape(-1), weight.new_zeros(1)])
    packed = flat[tail_pack_index(weight.shape[1]).to(flat.device)]
    weight._savsr_tail_packed = (key, packed)
    return packed


def pack_tail_weights_f32(weight: torch.Tensor, bias: torch.Tensor,
                          fast: bool = False) -> torch.Tensor:
    """The CUDA-core kernel's weights and bias, f32: [C][F32_SLOTS], slot
    9 dy + 3 dx + k holding weight[k, c, dy, dx] (``fast``: its bf16 value)
    and slot 27 zero, then bias[0..2] and a zero; packed once for a shared
    weight and bias (``ops/conv.py packed_once``)."""
    def pack():
        c = weight.shape[1]
        wt = weight.detach().to(torch.bfloat16) if fast else weight.detach()
        rows = F.pad(wt.float().permute(1, 2, 3, 0).reshape(c, 27), (0, 1))
        return F.pad(torch.cat([rows.reshape(-1), bias.detach().float().reshape(-1)]), (0, 1))

    return packed_once(weight, "tail_fast" if fast else "tail_f32", pack, bias)


@functools.lru_cache(maxsize=None)
def _lib():
    from ..csrc.build import load

    lib = load("tail")
    for fn in (lib.savsr_tail_f32, lib.savsr_tail_mma):
        fn.restype = ctypes.c_int
    lib.savsr_tail_f32.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 7
                                   + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.savsr_tail_mma.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 8
                                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    return lib


def _check(what: str, sr, xc, rows_j0, rows_wy, cols_c0, cols_w, weight, bias, dt) -> None:
    """The wrappers' operand checks: contiguous CUDA tensors, sr [B, C, H,
    W], xc [B, 3, h0, w0], weight [3, C, 3, 3] and bias [3] of dtype ``dt``,
    the resize rows and columns int32 / f32."""
    b, c, H, W = sr.shape
    h0, w0 = xc.shape[2:]
    for name, t, shape, tdt in (
        ("sr", sr, (b, c, H, W), dt), ("xc", xc, (b, 3, h0, w0), dt),
        ("weight", weight, (3, c, 3, 3), dt), ("bias", bias, (3,), dt),
        ("rows_j0", rows_j0, (H,), torch.int32), ("rows_wy", rows_wy, (H,), torch.float32),
        ("cols_c0", cols_c0, (W,), torch.int32), ("cols_w", cols_w, (2, W), torch.float32),
    ):
        require(t.is_cuda and t.dtype == tdt and t.is_contiguous() and tuple(t.shape) == shape,
                f"{what}: {name} must be a contiguous {tdt} {shape} CUDA tensor")


def tail_fused(sr, xc, rows_j0, rows_wy, cols_c0, cols_w, weight, bias) -> torch.Tensor:
    """Tail conv + bilinear skip -> [B, 3, H, W]. CPU tensors take the plain
    version; CUDA tensors launch a kernel: bf16 at C in 16, 32, 48, 64 the
    tensor-core kernel, f32 (and bf16 at other C, widened) the CUDA-core
    one."""
    if not sr.is_cuda:
        return tail_fused_plain(sr, xc, rows_j0, rows_wy, cols_c0, cols_w, weight, bias)
    b, c, H, W = sr.shape
    h0, w0 = xc.shape[2:]
    dt = sr.dtype
    dtype_code(sr)
    _check("tail", sr, xc, rows_j0, rows_wy, cols_c0, cols_w, weight, bias, dt)
    out = torch.empty((b, 3, H, W), dtype=dt, device=sr.device)
    lib = _lib()
    tensor_cores = dt == torch.bfloat16 and c in MMA_CHANNELS
    if tensor_cores:
        srk, pitch = tma_part(sr)  # TMA reads rows at a 16-byte pitch
        rc = lib.savsr_tail_mma(ptr(srk), pitch, ptr(xc), ptr(pack_tail_weights(weight)),
                                ptr(bias), ptr(rows_j0), ptr(rows_wy), ptr(cols_c0), ptr(cols_w),
                                ptr(out), b, c, H, W, h0, w0, stream_ptr(sr))
    else:
        srk, pitch = tma_part(sr.float())  # TMA reads rows at a padded pitch
        xcf = xc.float()  # kept alive across the launch
        out_f = out if dt == torch.float32 else torch.empty(out.shape, device=sr.device)
        rc = lib.savsr_tail_f32(ptr(srk), pitch, ptr(xcf), ptr(pack_tail_weights_f32(weight, bias)),
                                ptr(rows_j0), ptr(rows_wy), ptr(cols_c0), ptr(cols_w), ptr(out_f),
                                b, c, H, W, h0, w0, int(dt != torch.float32),
                                sm_count(sr.device), stream_ptr(sr))
    check_rc(lib, rc, "tail_fused")
    launches["tail"] += 1
    if not tensor_cores and dt != torch.float32:
        out.copy_(out_f)  # the widened route's one rounding of the output to bf16
    return out


def tail_fused_fast(sr, xc, rows_j0, rows_wy, cols_c0, cols_w, weight, bias) -> torch.Tensor:
    """The fast tail, all f32 (see the module docstring) -> f32 [B, 3, H, W].
    CPU tensors take the plain version; CUDA tensors launch
    ``tail_f32_kernel`` with its bf16 rounding points."""
    if not sr.is_cuda:
        return tail_fused_fast_plain(sr, xc, rows_j0, rows_wy, cols_c0, cols_w, weight, bias)
    b, c, H, W = sr.shape
    h0, w0 = xc.shape[2:]
    _check("tail fast", sr, xc, rows_j0, rows_wy, cols_c0, cols_w, weight, bias, torch.float32)
    srk, pitch = tma_part(sr)  # TMA reads rows at a padded pitch
    out = torch.empty((b, 3, H, W), dtype=torch.float32, device=sr.device)
    lib = _lib()
    wpk = pack_tail_weights_f32(weight, bias, fast=True)
    rc = lib.savsr_tail_f32(ptr(srk), pitch, ptr(xc), ptr(wpk), ptr(rows_j0), ptr(rows_wy),
                            ptr(cols_c0), ptr(cols_w), ptr(out), b, c, H, W, h0, w0, 1,
                            sm_count(sr.device), stream_ptr(sr))
    check_rc(lib, rc, "tail_fused_fast")
    launches["tail_fast"] += 1
    return out
