"""Fused STAU upsampler: both grid-samples + expert mixing + fusion (kernel 4).

Replaces ``savsr_tpu/ops/pallas/stau_kernel.py::stau_upsample_fused``
(reference semantics lbasicsr/archs/savsr_arch.py:262-376). Per HR pixel:
bilinear samples (zeros padding, align_corners=True, coordinates already in
LR pixel units) of the trunk feature ``x`` at (fy_f, fx_f) -> f0 and of the
STA feature at (fy_s, fx_s) -> sa; expert mixing
``fea = f0 + sum_n r_n We_n (sum_m r_m Wc_m f0)``; then the 1x1 fusion
``Wfus [sa; fea] + bias``. Rounding points follow the TPU kernel (the hat
x-weights, f0, sa, r_n*fc and fea are rounded to the I/O dtype; the
y-weights stay f32). The TPU kernel's hat-matrix sampling over precomputed
LR row bands (j0/g0) becomes a 4-tap gather in the CUDA kernels
(csrc/stau.cu).

The fast tier (``stau_upsample_fused_fast``; f32 weights and carries at
``matmul_precision: default``) is the TPU kernel's f32 mode at DEFAULT
precision: every product takes bf16 operands (the inputs, the hat
x-weights, f0 into the compress, r_n*fc, sa and fea into the fusion, the
weights) with f32 sums, while f0 stays f32 in the residual and the output
is f32. It runs the bf16 kernel in its fast mode (``stau_mma_kernel<CB,
true>``, which keeps the f32 f0 of its one sampling in shared memory for
the residual) on the inputs rounded to bf16 and on the bf16 kernel's tile
at a smaller staging capacity (``plan_geometry(torch.float32,
fast=True)``).

Both kernels have two layout steps in Python, replayed on the CPU by the
tests: ``stau_window_plan``, the LR box each tile reads (the sampling
positions depend only on the static coordinate embedding, so
``SAVSR.stau_statics`` plans once per shape, scale and dtype), at each
kernel's tile, staging capacity and column alignment (``plan_geometry``:
bf16 8 HR rows x 64 HR columns, 600 slots of both boxes (the fast mode
536), boxes on 8-column boundaries; f32 2 x 64, 320 slots per channel,
exact boxes);
and the packed weights, cached on the fusion weight: ``pack_stau_weights``,
the bf16 kernel's mma B fragments, and ``pack_stau_weights_f32``, the f32
kernel's row order with C padded to 16, 32 or 64 and the expand folded into
the fusion (f32 only: no rounding point lies between them).

``pix`` is [4 + n, H, W] f32: planes fy_f, fx_f, fy_s, fx_s, r_0..r_{n-1}
(savsr_arch.stau_sampler_planes). Weights keep the torch layouts:
``wc`` [n, C/8, C, 1, 1], ``we`` [n, C, C/8, 1, 1], ``wfus`` [Cout, 2C, 1, 1].
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import (check_rc, count_plain, dtype_code, f32_channels, launches, ptr, require,
               stream_ptr)


def bilinear_gather(x: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor,
                    col_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Sample [B, C, h, w] at unnormalized coords [H, W] with zeros outside
    the image (grid_sample bilinear, align_corners=True), the x-weights
    rounded to ``col_dtype`` (the TPU kernel's hat matrix). Returns f32."""
    b, c, h, w = x.shape
    flat = x.float().reshape(b, c, h * w)
    y0, x0 = torch.floor(fy), torch.floor(fx)
    wy1, wx1 = fy - y0, fx - x0
    out = torch.zeros((b, c) + tuple(fy.shape), dtype=torch.float32, device=x.device)
    for dy, wy in ((0, 1.0 - wy1), (1, wy1)):
        for dx, wx in ((0, 1.0 - wx1), (1, wx1)):
            wx = wx.to(col_dtype).float()
            yy, xx = y0 + dy, x0 + dx
            ok = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
            idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long().reshape(-1)
            v = flat[:, :, idx].reshape(out.shape)
            out = out + (wy * wx * ok) * v
    return out


def stau_upsample_fused_plain(x, sta, pix, wc, we, wfus, bias) -> torch.Tensor:
    """Plain PyTorch version (see module docstring)."""
    count_plain("stau", x)
    return _stau_plain(x, sta, pix, wc, we, wfus, bias, fast=False)


def stau_upsample_fused_fast_plain(x, sta, pix, wc, we, wfus, bias) -> torch.Tensor:
    """Plain PyTorch version of the fast STAU (f32 in and out; see the module
    docstring), in f32 with TF32 off: every product of bf16 values exact."""
    from ..archs.arch_util import float32_precision

    count_plain("stau_fast", x)
    with float32_precision(True):
        return _stau_plain(x, sta, pix, wc, we, wfus, bias, fast=True)


def _stau_plain(x, sta, pix, wc, we, wfus, bias, fast: bool) -> torch.Tensor:
    """The STAU with the TPU kernel's rounding points at the I/O dtype (bf16
    for ``fast``, whose inputs and weights are rounded too and whose f0
    stays f32 in the residual); returns the I/O dtype (f32 for ``fast``)."""
    dt = torch.bfloat16 if fast else x.dtype
    n = wc.shape[0]

    def rnd(t):  # a rounding point (no-op in f32)
        return t.to(dt).float()

    xs, stas = (rnd(x), rnd(sta)) if fast else (x, sta)
    f0 = bilinear_gather(xs, pix[0], pix[1], dt)
    f0r = rnd(f0)
    sa = rnd(bilinear_gather(stas, pix[2], pix[3], dt))
    r = pix[4:4 + n]                                          # [n, H, W]
    z = torch.einsum("noc,bchw->bnohw", rnd(wc)[..., 0, 0], f0r)
    fc = (r[None, :, None] * z).sum(1)                        # [B, C/8, H, W]
    stk = rnd(r[None, :, None] * fc[:, None])                 # [B, n, C/8, H, W]
    fea = rnd(torch.einsum("nco,bnohw->bchw", rnd(we)[..., 0, 0], stk) + (f0 if fast else f0r))
    out = torch.einsum("ok,bkhw->bohw", rnd(wfus)[:, :, 0, 0], torch.cat([sa, fea], 1))
    return (out + bias.float().view(1, -1, 1, 1)).to(torch.float32 if fast else dt)


# the bf16 kernel's tile (HR rows x HR columns) and staging capacity (LR
# pixel slots of both samplers' boxes together), as in csrc/stau.cu; its
# fast mode's capacity (FAST_STAGE_CAP there: the f32 f0 it keeps takes
# some of the staging)
PLAN_ROWS, PLAN_COLS, STAGE_CAP = 8, 64, 600
FAST_STAGE_CAP = 536
# the f32 kernel's (FS_ROWS, FS_COLS, FS_CAP in csrc/stau.cu; slots per
# channel); its 4-byte copies need no column alignment
F32_PLAN_ROWS, F32_PLAN_COLS, F32_STAGE_CAP = 2, 64, 320
# its padded expert count (each expert's C/8 compress outputs pad to 8)
NE_PAD = 4


def plan_geometry(dtype: torch.dtype, fast: bool = False) -> tuple:
    """(tile rows, tile columns, staging capacity, column alignment) of the
    kernel that runs ``dtype``: the f32 kernel's for float32 (the strict and
    split tiers), the bf16 kernel's otherwise, and for the fast tier
    (``fast``: f32 on the bf16 kernel's fast mode) the bf16 kernel's tile at
    the fast mode's capacity. The kernel also checks each tile's boxes
    against its capacity (a bigger one gathers from device memory), so the
    bf16 and fast plans, of one shape, are safe in either kernel."""
    if dtype == torch.float32 and not fast:
        return F32_PLAN_ROWS, F32_PLAN_COLS, F32_STAGE_CAP, 1
    return PLAN_ROWS, PLAN_COLS, FAST_STAGE_CAP if fast else STAGE_CAP, 8


def stau_window_plan(pix: torch.Tensor, h: int, w: int, rows: int = PLAN_ROWS,
                     cols: int = PLAN_COLS, cap: int = STAGE_CAP, align: int = 8) -> torch.Tensor:
    """The LR windows of a kernel's tiles of ``rows`` HR rows x ``cols`` HR
    columns (the bf16 kernel's by default): int32 [ceil(H/rows) *
    ceil(W/cols), 8], per tile (row group major) the box of each sampler
    (f: planes 0-1 of ``pix``, s: planes 2-3) as (y_f, x_f, y_s, x_s, rows_f,
    cols_f, rows_s, cols_s). A box spans every in-image row and column that
    the tile's bilinear taps (floor and floor + 1, clipped to the image)
    touch; its first column sits on an ``align``-pixel boundary and its
    width is a multiple of ``align`` (8: the bf16 kernel's 16-byte copies).
    Tiles whose two boxes exceed ``cap`` slots, or whose coordinates are not
    finite, get zero sizes: the kernel gathers them from device memory."""
    H, W = pix.shape[1:]
    nrg, ncs = -(-H // rows), -(-W // cols)
    pad = (0, ncs * cols - W, 0, nrg * rows - H)

    def per_tile(t, fill, reduce):
        t = F.pad(t, pad, value=fill).view(nrg, rows, ncs, cols)
        return reduce(reduce(t, 3), 1)

    bad = torch.zeros((nrg, ncs), dtype=torch.bool, device=pix.device)
    fields = []
    for fy, fx in ((pix[0], pix[1]), (pix[2], pix[3])):
        ext = []
        for f, n in ((fy, h), (fx, w)):
            bad |= per_tile((~torch.isfinite(f)).float(), 0.0, torch.amax) > 0
            f0 = torch.floor(torch.nan_to_num(f))
            ext.append((per_tile(f0.clamp(0, n - 1), float(n), torch.amin),
                        per_tile((f0 + 1).clamp(0, n - 1), -1.0, torch.amax)))
        (ylo, yhi), (xlo, xhi) = ext
        x0 = torch.div(xlo, align, rounding_mode="floor") * align
        fields.append((ylo, x0, yhi - ylo + 1, torch.ceil((xhi + 1 - x0) / align) * align))
    (yf, xf, nrf, ncf), (ys, xs, nrs, ncs_) = fields
    plan = torch.stack([yf, xf, ys, xs, nrf, ncf, nrs, ncs_], -1).to(torch.int32)
    direct = bad | (nrf * ncf + nrs * ncs_ > cap)
    plan[..., 4:] = plan[..., 4:].masked_fill(direct[..., None], 0)
    return plan.reshape(-1, 8).contiguous()


@functools.lru_cache(maxsize=None)
def stau_pack_index(n: int, c: int, cout: int) -> torch.Tensor:
    """Where each element of the packed bf16 weights comes from: an int64
    index into ``cat(wc.flatten(), we.flatten(), wfus.flatten(), [0])``
    (the last slot, a zero, pads).

    Packed order: compress and expand as mma.sync m16n8k16 B fragments, 128
    elements per (k-block of 16, n-tile of 8) of B[K, N], compress [C/16][4],
    expand [2][C/8]; inside a block, lane l = 4g + q holds B[k][g] for k =
    2q, 2q + 1, 2q + 8, 2q + 9. Compress: K = channel k, N = 8e + o (expert
    e < 4, output o < 8), wc[e, o, k]; expand: K = 8e + o, N = channel c,
    we[e, c, o]; experts past ``n`` and outputs past C/8 are zero. Then the
    fusion as the wgmma B operand, K-major 8x8 core matrices:
    [2C/16][Cout/8][2][8][8] = wfus[8 n8 + n, 16 kb + 8 kh + k] (K =
    channel of [sa; fea], N = output)."""
    e_n = c // 8
    lane = np.arange(32)
    g, q = lane[:, None] // 4, lane[:, None] % 4
    j = np.arange(4)[None, :]
    kk = 2 * q + j % 2 + 8 * (j // 2)  # [32 lanes, 4]: the lane's k
    gg = np.broadcast_to(g, kk.shape)  # its n
    n_wc = n * e_n * c
    zero = n_wc + c * n * e_n + cout * 2 * c
    blocks = []
    for kb in range(c // 16):  # compress
        for e in range(NE_PAD):
            ok = (e < n) & (gg < e_n)
            blocks.append(np.where(ok, (e * e_n + gg) * c + 16 * kb + kk, zero))
    for kb in range(2):  # expand
        for nt in range(c // 8):
            e, o = (16 * kb + kk) // 8, kk % 8
            ok = (e < n) & (o < e_n)
            blocks.append(np.where(ok, n_wc + (e * c + 8 * nt + gg) * e_n + o, zero))
    idx = np.concatenate([b.reshape(-1) for b in blocks])
    # fusion: [2C/16 k-blocks][Cout/8][2 k halves][8 n][8 k] (K-major core
    # matrices of the wgmma B operand)
    kb, n8, kh, nr, kr = np.meshgrid(np.arange(2 * c // 16), np.arange(cout // 8), np.arange(2),
                                     np.arange(8), np.arange(8), indexing="ij")
    fus = n_wc + c * n * e_n + (8 * n8 + nr) * 2 * c + 16 * kb + 8 * kh + kr
    return torch.from_numpy(np.concatenate([idx, fus.reshape(-1)]).astype(np.int64))


def pack_stau_weights(wc: torch.Tensor, we: torch.Tensor, wfus: torch.Tensor,
                      fast: bool = False) -> torch.Tensor:
    """The bf16 kernel's B fragments (``stau_pack_index``; ``fast``: of the
    f32 weights' bf16 values), kept on ``wfus`` as ``_savsr_stau_packed``
    (``_savsr_stau_packed_fast``) while the three weights' storages and
    version counters stay the same."""
    attr = "_savsr_stau_packed_fast" if fast else "_savsr_stau_packed"
    key = tuple((t.data_ptr(), t._version) for t in (wc, we, wfus))
    hit = getattr(wfus, attr, None)
    if hit is not None and hit[0] == key:
        return hit[1]
    n, c, cout = wc.shape[0], wc.shape[2], wfus.shape[0]
    ts = [t.detach().to(torch.bfloat16) if fast else t.detach() for t in (wc, we, wfus)]
    flat = torch.cat([t.reshape(-1) for t in ts] + [ts[0].new_zeros(1)])
    packed = flat[stau_pack_index(n, c, cout).to(flat.device)]
    setattr(wfus, attr, (key, packed))
    return packed


@functools.lru_cache(maxsize=None)
def stau_f32_pack_index(n: int, c: int, cout: int) -> torch.Tensor:
    """Where the gathered part of the packed f32 weights comes from: an int64
    index into ``cat(wc.flatten(), wfus.flatten(), [0])`` (the last slot, a
    zero, pads). With CP = ``f32_channels(c)`` and E = CP/8: compress
    [CP k][E o][4 e] = wc[e, o, k]; then the fusion's first 2 CP rows of 64
    outputs, [2 CP k][64 o] = wfus[o, k] for k < CP (the sa rows) and
    wfus[o, C + k - CP] after (the f0 rows). Experts past ``n``, compress
    outputs past C/8, channels past C and outputs past ``cout`` are zero."""
    cp, e_n = f32_channels(c), c // 8
    ep = cp // 8
    n_wc = n * e_n * c
    zero = n_wc + cout * 2 * c
    k, o, e = np.meshgrid(np.arange(cp), np.arange(ep), np.arange(NE_PAD), indexing="ij")
    wc_idx = np.where((k < c) & (o < e_n) & (e < n), (e * e_n + o) * c + k, zero)
    k, o = np.meshgrid(np.arange(2 * cp), np.arange(64), indexing="ij")
    ch, col = np.where(k < cp, k, k - cp), np.where(k < cp, k, c + k - cp)
    wf_idx = np.where((ch < c) & (o < cout), n_wc + o * 2 * c + col, zero)
    idx = np.concatenate([wc_idx.reshape(-1), wf_idx.reshape(-1)])
    return torch.from_numpy(idx.astype(np.int64))


def pack_stau_weights_f32(wc: torch.Tensor, we: torch.Tensor, wfus: torch.Tensor) -> torch.Tensor:
    """The f32 kernel's packed weights, kept on ``wfus`` as
    ``_savsr_stau_packed_f32`` while the three weights' storages and version
    counters stay the same: ``stau_f32_pack_index``'s compress block and
    fusion rows, then the expand folded into the fusion, [4 E (row e E + o)]
    [64 outputs] = sum_c wfus[out, C + c] we[e, c, o] (in float64, rounded
    once to f32; zero past ``n`` experts, C/8 outputs and Cout). The kernel
    computes Wfus_sa sa + Wfus_fea f0 + (Wfus_fea We) stk, which is
    Wfus [sa; f0 + We stk] in f32, where the fea rounding point of the TPU
    kernel is a no-op."""
    key = tuple((t.data_ptr(), t._version) for t in (wc, we, wfus))
    hit = getattr(wfus, "_savsr_stau_packed_f32", None)
    if hit is not None and hit[0] == key:
        return hit[1]
    n, c, cout = wc.shape[0], wc.shape[2], wfus.shape[0]
    ep = f32_channels(c) // 8
    flat = torch.cat([t.detach().reshape(-1).float() for t in (wc, wfus)]
                     + [wc.new_zeros(1, dtype=torch.float32)])
    fold = torch.zeros((NE_PAD, ep, 64), dtype=torch.float64, device=wc.device)
    fold[:n, :c // 8, :cout] = torch.einsum("oc,nce->neo", wfus.detach()[:, c:, 0, 0].double(),
                                            we.detach()[..., 0, 0].double())
    packed = torch.cat([flat[stau_f32_pack_index(n, c, cout).to(flat.device)],
                        fold.float().reshape(-1)])
    wfus._savsr_stau_packed_f32 = (key, packed)
    return packed


@functools.lru_cache(maxsize=None)
def _lib():
    from ..csrc.build import load

    lib = load("stau")
    lib.savsr_stau_f32.restype = ctypes.c_int
    lib.savsr_stau_f32.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    for fn in (lib.savsr_stau_mma, lib.savsr_stau_fast):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    return lib


def _check(what: str, x, sta, pix, wc, we, wfus, dt):
    """The wrappers' operand checks: x, sta [B, C, h, w], the weights in the
    torch layouts, all of dtype ``dt`` on the card, and pix contiguous f32
    [4 + n, H, W]. Returns (B, C, h, w, experts, Cout)."""
    b, c, h, w = x.shape
    n, cout = wc.shape[0], wfus.shape[0]
    for name, t, shape in (("x", x, (b, c, h, w)), ("sta", sta, (b, c, h, w)),
                           ("wc", wc, (n, c // 8, c, 1, 1)),
                           ("we", we, (n, c, c // 8, 1, 1)),
                           ("wfus", wfus, (cout, 2 * c, 1, 1))):
        require(t.is_cuda and t.dtype == dt and tuple(t.shape) == shape,
                f"{what}: {name} must be a {dt} {shape} CUDA tensor")
    require(pix.dtype == torch.float32 and pix.is_contiguous()
            and pix.shape[0] >= 4 + n, f"{what}: pix must be contiguous f32 [4+n, H, W]")
    return b, c, h, w, n, cout


def _plan(what: str, plan, pix, h: int, w: int, geometry) -> torch.Tensor:
    """``plan``, or the window plan of ``pix`` at the kernel's ``geometry``
    (``plan_geometry``) when it is None; checked against that geometry."""
    rows, cols, cap, align = geometry
    H, W = pix.shape[1:]
    nst = -(-H // rows) * -(-W // cols)
    if plan is None:
        plan = stau_window_plan(pix, h, w, rows, cols, cap, align)
    require(plan.is_cuda and plan.dtype == torch.int32 and plan.is_contiguous()
            and tuple(plan.shape) == (nst, 8), f"{what}: plan must be int32 [{nst}, 8]")
    return plan


def stau_upsample_fused(x: torch.Tensor, sta: torch.Tensor, pix: torch.Tensor,
                        wc: torch.Tensor, we: torch.Tensor, wfus: torch.Tensor,
                        bias: torch.Tensor, plan: torch.Tensor = None) -> torch.Tensor:
    """x, sta: [B, C, h, w] -> [B, Cout, H, W] (H, W from ``pix``). CPU
    tensors take the plain version; CUDA tensors launch a kernel on ``plan``
    (``stau_window_plan`` of ``pix`` at the dtype's ``plan_geometry``, made
    here when not given): f32 the CUDA-core kernel (C % 8 == 0, C <= 64,
    Cout % 4 == 0, Cout <= 64, at most 4 experts), bf16 the tensor-core
    kernel (C in 16, 32, 64, Cout = C, at most 4 experts)."""
    if not x.is_cuda:
        return stau_upsample_fused_plain(x, sta, pix, wc, we, wfus, bias)
    dt = x.dtype
    dtype_code(x)
    b, c, h, w, n, cout = _check("stau", x, sta, pix, wc, we, wfus, dt)
    H, W = pix.shape[1:]
    plan = _plan("stau", plan, pix, h, w, plan_geometry(dt))
    bias_f = bias.float().contiguous()
    xk, sk = x.contiguous(), sta.contiguous()
    out = torch.empty((b, cout, H, W), dtype=dt, device=x.device)
    lib = _lib()
    if dt == torch.float32:
        require(c % 8 == 0 and c <= 64 and cout % 4 == 0 and cout <= 64 and n <= NE_PAD,
                f"stau: f32 takes C % 8 == 0 up to 64, Cout % 4 == 0 up to 64 and at most "
                f"{NE_PAD} experts, got C={c}, Cout={cout}, {n} experts")
        wpk = pack_stau_weights_f32(wc, we, wfus)
        rc = lib.savsr_stau_f32(ptr(xk), ptr(sk), ptr(pix), ptr(plan), ptr(wpk), ptr(bias_f),
                                ptr(out), b, c, n, cout, h, w, H, W, int(W % 4 == 0),
                                stream_ptr(x))
    else:
        require(c in (16, 32, 64) and cout == c and n <= NE_PAD,
                f"stau: bf16 takes C in 16, 32, 64, Cout = C and at most {NE_PAD} experts, "
                f"got C={c}, Cout={cout}, {n} experts")
        wpk = pack_stau_weights(wc, we, wfus)
        vec_in = w % 8 == 0 and xk.data_ptr() % 16 == 0 and sk.data_ptr() % 16 == 0
        rc = lib.savsr_stau_mma(ptr(xk), ptr(sk), ptr(pix), ptr(plan), ptr(wpk), ptr(bias_f),
                                ptr(out), b, c, n, h, w, H, W, int(vec_in), int(W % 8 == 0),
                                stream_ptr(x))
    check_rc(lib, rc, "stau_upsample_fused")
    launches["stau"] += 1
    return out


def stau_upsample_fused_fast(x: torch.Tensor, sta: torch.Tensor, pix: torch.Tensor,
                             wc: torch.Tensor, we: torch.Tensor, wfus: torch.Tensor,
                             bias: torch.Tensor, plan: torch.Tensor = None) -> torch.Tensor:
    """The fast STAU: f32 x, sta [B, C, h, w] and f32 weights -> f32 [B, C,
    H, W]. CPU tensors take the plain version; CUDA tensors launch the bf16
    kernel's fast mode (C in 16, 32, 64, Cout = C, at most 4 experts) on x
    and sta rounded to bf16, on ``plan`` (``stau_window_plan`` at
    ``plan_geometry(torch.float32, fast=True)``, made here when not
    given)."""
    if not x.is_cuda:
        return stau_upsample_fused_fast_plain(x, sta, pix, wc, we, wfus, bias)
    b, c, h, w, n, cout = _check("stau fast", x, sta, pix, wc, we, wfus, torch.float32)
    H, W = pix.shape[1:]
    require(c in (16, 32, 64) and cout == c and n <= NE_PAD,
            f"stau fast: C in 16, 32, 64, Cout = C and at most {NE_PAD} experts, "
            f"got C={c}, Cout={cout}, {n} experts")
    plan = _plan("stau fast", plan, pix, h, w, plan_geometry(torch.float32, fast=True))
    # the rounding pass: the inputs as the products take them
    xk = x.to(torch.bfloat16, memory_format=torch.contiguous_format)
    sk = sta.to(torch.bfloat16, memory_format=torch.contiguous_format)
    bias_f = bias.float().contiguous()
    out = torch.empty((b, cout, H, W), dtype=torch.float32, device=x.device)
    wpk = pack_stau_weights(wc, we, wfus, fast=True)
    lib = _lib()
    rc = lib.savsr_stau_fast(ptr(xk), ptr(sk), ptr(pix), ptr(plan), ptr(wpk), ptr(bias_f),
                             ptr(out), b, c, n, h, w, H, W, int(w % 8 == 0), 0, stream_ptr(x))
    check_rc(lib, rc, "stau_upsample_fused_fast")
    launches["stau_fast"] += 1
    return out
