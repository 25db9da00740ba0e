"""Fused STAU upsampler: both grid-samples + expert mixing + fusion (kernel 4).

Replaces ``savsr_tpu/ops/pallas/stau_kernel.py::stau_upsample_fused``
(reference semantics lbasicsr/archs/savsr_arch.py:262-376). Per HR pixel:
bilinear samples (zeros padding, align_corners=True, coordinates already in
LR pixel units) of the trunk feature ``x`` at (fy_f, fx_f) -> f0 and of the
STA feature at (fy_s, fx_s) -> sa; expert mixing
``fea = f0 + sum_n r_n We_n (sum_m r_m Wc_m f0)``; then the 1x1 fusion
``Wfus [sa; fea] + bias``. Rounding points follow the TPU kernel (f0, sa,
r_n*fc and fea are rounded to the I/O dtype). The TPU kernel's hat-matrix
sampling over precomputed LR row bands (j0/g0) becomes a 4-tap gather in
the CUDA kernels (csrc/stau.cu).

The bf16 kernel (tensor cores) has two layout steps in Python, both
replayed on the CPU by the tests: ``stau_window_plan``, the LR box each
tile of 8 HR rows x 64 HR columns reads (the sampling positions depend only
on the static coordinate embedding, so ``SAVSR.stau_statics`` plans once
per shape and scale), and ``pack_stau_weights``, the three weights as the
kernel's mma B fragments (cached on the fusion weight). f32 runs the
CUDA-core kernel on the weights as they are.

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

from . import check_rc, count_plain, dtype_code, launches, ptr, require, stream_ptr


def bilinear_gather(x: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor) -> torch.Tensor:
    """Sample [B, C, h, w] at unnormalized coords [H, W] with zeros outside
    the image (grid_sample bilinear, align_corners=True). Returns f32."""
    b, c, h, w = x.shape
    flat = x.float().reshape(b, c, h * w)
    y0, x0 = torch.floor(fy), torch.floor(fx)
    wy1, wx1 = fy - y0, fx - x0
    out = torch.zeros((b, c) + tuple(fy.shape), dtype=torch.float32, device=x.device)
    for dy, wy in ((0, 1.0 - wy1), (1, wy1)):
        for dx, wx in ((0, 1.0 - wx1), (1, wx1)):
            yy, xx = y0 + dy, x0 + dx
            ok = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
            idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long().reshape(-1)
            v = flat[:, :, idx].reshape(out.shape)
            out = out + (wy * wx * ok) * v
    return out


def stau_upsample_fused_plain(x, sta, pix, wc, we, wfus, bias) -> torch.Tensor:
    """Plain PyTorch version (see module docstring)."""
    count_plain("stau", x)
    dt = x.dtype
    n = wc.shape[0]

    def rnd(t):  # the TPU kernel's rounding points (no-op in f32)
        return t.to(dt).float()

    f0 = rnd(bilinear_gather(x, pix[0], pix[1]))
    sa = rnd(bilinear_gather(sta, pix[2], pix[3]))
    r = pix[4:4 + n]                                          # [n, H, W]
    z = torch.einsum("noc,bchw->bnohw", wc.float()[..., 0, 0], f0)
    fc = (r[None, :, None] * z).sum(1)                        # [B, C/8, H, W]
    stk = rnd(r[None, :, None] * fc[:, None])                 # [B, n, C/8, H, W]
    fea = rnd(torch.einsum("nco,bnohw->bchw", we.float()[..., 0, 0], stk) + f0)
    out = torch.einsum("ok,bkhw->bohw", wfus.float()[:, :, 0, 0], torch.cat([sa, fea], 1))
    return (out + bias.float().view(1, -1, 1, 1)).to(dt)


# the bf16 kernel's tile (HR rows x HR columns) and staging capacity (LR
# pixel slots of both samplers' boxes together), as in csrc/stau.cu
PLAN_ROWS, PLAN_COLS, STAGE_CAP = 8, 64, 600
# its padded expert count (each expert's C/8 compress outputs pad to 8)
NE_PAD = 4


def stau_window_plan(pix: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The LR windows of the bf16 kernel's tiles: int32 [ceil(H/8) *
    ceil(W/64), 8], per tile (row group major) the box of each sampler
    (f: planes 0-1 of ``pix``, s: planes 2-3) as (y_f, x_f, y_s, x_s, rows_f,
    cols_f, rows_s, cols_s). A box spans every in-image row and column that
    the tile's bilinear taps (floor and floor + 1, clipped to the image)
    touch; its first column sits on an 8-pixel boundary and its width is a
    multiple of 8 (16-byte copies). Tiles whose two boxes exceed
    ``STAGE_CAP`` slots, or whose coordinates are not finite, get zero
    sizes: the kernel gathers them from device memory."""
    H, W = pix.shape[1:]
    nrg, ncs = -(-H // PLAN_ROWS), -(-W // PLAN_COLS)
    pad = (0, ncs * PLAN_COLS - W, 0, nrg * PLAN_ROWS - H)

    def per_tile(t, fill, reduce):
        t = F.pad(t, pad, value=fill).view(nrg, PLAN_ROWS, ncs, PLAN_COLS)
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
        x0 = torch.div(xlo, 8, rounding_mode="floor") * 8
        fields.append((ylo, x0, yhi - ylo + 1, torch.ceil((xhi + 1 - x0) / 8) * 8))
    (yf, xf, nrf, ncf), (ys, xs, nrs, ncs_) = fields
    plan = torch.stack([yf, xf, ys, xs, nrf, ncf, nrs, ncs_], -1).to(torch.int32)
    direct = bad | (nrf * ncf + nrs * ncs_ > STAGE_CAP)
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


def pack_stau_weights(wc: torch.Tensor, we: torch.Tensor, wfus: torch.Tensor) -> torch.Tensor:
    """The bf16 kernel's B fragments (``stau_pack_index``), kept on ``wfus``
    as ``_savsr_stau_packed`` while the three weights' storages and version
    counters stay the same."""
    key = tuple((t.data_ptr(), t._version) for t in (wc, we, wfus))
    hit = getattr(wfus, "_savsr_stau_packed", None)
    if hit is not None and hit[0] == key:
        return hit[1]
    n, c, cout = wc.shape[0], wc.shape[2], wfus.shape[0]
    flat = torch.cat([t.detach().reshape(-1) for t in (wc, we, wfus)] + [wc.new_zeros(1)])
    packed = flat[stau_pack_index(n, c, cout).to(flat.device)]
    wfus._savsr_stau_packed = (key, packed)
    return packed


@functools.lru_cache(maxsize=None)
def _lib():
    from ..csrc.build import load

    lib = load("stau")
    lib.savsr_stau_fused.restype = ctypes.c_int
    lib.savsr_stau_fused.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.savsr_stau_mma.restype = ctypes.c_int
    lib.savsr_stau_mma.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    return lib


def stau_upsample_fused(x: torch.Tensor, sta: torch.Tensor, pix: torch.Tensor,
                        wc: torch.Tensor, we: torch.Tensor, wfus: torch.Tensor,
                        bias: torch.Tensor, plan: torch.Tensor = None) -> torch.Tensor:
    """x, sta: [B, C, h, w] -> [B, Cout, H, W] (H, W from ``pix``). CPU
    tensors take the plain version; CUDA tensors launch a kernel: f32 the
    CUDA-core kernel, bf16 the tensor-core kernel (C in 16, 32, 64, Cout =
    C, at most 4 experts) on ``plan`` (``stau_window_plan`` of ``pix``, made
    here when not given)."""
    if not x.is_cuda:
        return stau_upsample_fused_plain(x, sta, pix, wc, we, wfus, bias)
    b, c, h, w = x.shape
    n = wc.shape[0]
    _, H, W = pix.shape
    cout = wfus.shape[0]
    dt = x.dtype
    dtype_code(x)
    for name, t, shape in (("x", x, (b, c, h, w)), ("sta", sta, (b, c, h, w)),
                           ("wc", wc, (n, c // 8, c, 1, 1)),
                           ("we", we, (n, c, c // 8, 1, 1)),
                           ("wfus", wfus, (cout, 2 * c, 1, 1))):
        require(t.is_cuda and t.dtype == dt and tuple(t.shape) == shape,
                f"stau: {name} must be a {dt} {shape} CUDA tensor")
    require(pix.dtype == torch.float32 and pix.is_contiguous()
            and pix.shape[0] >= 4 + n, "stau: pix must be contiguous f32 [4+n, H, W]")
    bias_f = bias.float().contiguous()
    xk, sk = x.contiguous(), sta.contiguous()
    out = torch.empty((b, cout, H, W), dtype=dt, device=x.device)
    lib = _lib()
    if dt == torch.float32:
        # kernel layouts: wc rows n*C/8 + o; we [C, n*C/8]; wfus [Cout, 2C]
        wc_k = wc.reshape(n * (c // 8), c).contiguous()
        we_k = we[..., 0, 0].permute(1, 0, 2).reshape(c, n * (c // 8)).contiguous()
        wf_k = wfus.reshape(cout, 2 * c).contiguous()
        rc = lib.savsr_stau_fused(ptr(xk), ptr(sk), ptr(pix), ptr(wc_k), ptr(we_k), ptr(wf_k),
                                  ptr(bias_f), ptr(out), b, c, n, cout, h, w, H, W,
                                  stream_ptr(x))
    else:
        require(c in (16, 32, 64) and cout == c and n <= NE_PAD,
                f"stau: bf16 takes C in 16, 32, 64, Cout = C and at most {NE_PAD} experts, "
                f"got C={c}, Cout={cout}, {n} experts")
        nst = -(-H // PLAN_ROWS) * -(-W // PLAN_COLS)
        if plan is None:
            plan = stau_window_plan(pix, h, w)
        require(plan.is_cuda and plan.dtype == torch.int32 and plan.is_contiguous()
                and tuple(plan.shape) == (nst, 8), f"stau: plan must be int32 [{nst}, 8]")
        wpk = pack_stau_weights(wc, we, wfus)
        vec_in = w % 8 == 0 and xk.data_ptr() % 16 == 0 and sk.data_ptr() % 16 == 0
        rc = lib.savsr_stau_mma(ptr(xk), ptr(sk), ptr(pix), ptr(plan), ptr(wpk), ptr(bias_f),
                                ptr(out), b, c, n, h, w, H, W, int(vec_in), int(W % 8 == 0),
                                stream_ptr(x))
    check_rc(lib, rc, "stau_upsample_fused")
    launches["stau"] += 1
    return out
