"""Building blocks on NCHW tensors.

The port's counterpart of ``savsr_tpu/archs/arch_util.py`` for SAVSR: conv2d,
batch_norm (running statistics in eval; batch statistics and chained
running-stat updates in training, through ``TrainCtx``; with a process
group in it, the statistics of the world's global batch), leaky_relu, sigmoid,
pools, replicate padding, the dense-matrix bilinear resize, grid sampling and
the unfused spatio-temporal filter. Parameters live in ``nn.Module``s whose
names mirror the reference state_dict; these functions take the tensors.
"""

from __future__ import annotations

import contextlib
import functools
import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def conv2d(x: torch.Tensor, conv: nn.Conv2d, padding: int = 0, fast: bool = False) -> torch.Tensor:
    """NCHW convolution with the module's weight/bias cast to x's dtype
    (``fast``: one bf16 pass, ``dot_operand`` / ``dot_cotangent``; with
    gradients on, the bias joins after the product, as in the JAX package)."""
    weight = conv.weight.to(x.dtype)
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    if fast and torch.is_grad_enabled():
        y = dot_cotangent(F.conv2d(dot_operand(x, fast), dot_operand(weight, fast),
                                   padding=padding), fast)
        return y if bias is None else y + bias[:, None, None]
    return F.conv2d(dot_operand(x, fast), dot_operand(weight, fast), bias, padding=padding)


def linear(x: torch.Tensor, lin: nn.Linear, fast: bool = False) -> torch.Tensor:
    y = dot_operand(x, fast) @ dot_operand(lin.weight.to(x.dtype), fast).t()
    return dot_cotangent(y, fast) + lin.bias.to(x.dtype)


def fc1x1(x: torch.Tensor, conv: nn.Conv2d, fast: bool = False) -> torch.Tensor:
    """A 1x1 conv applied to a [B, C] vector (a matmul with its weight core)."""
    y = dot_operand(x, fast) @ dot_operand(conv.weight[:, :, 0, 0].to(x.dtype), fast).t()
    y = dot_cotangent(y, fast)
    if conv.bias is not None:
        y = y + conv.bias.to(y.dtype)
    return y


def dot_einsum(equation: str, a: torch.Tensor, b: torch.Tensor, fast: bool) -> torch.Tensor:
    """A two-operand einsum as a product of the tier (see ``dot_operand``)."""
    return dot_cotangent(torch.einsum(equation, dot_operand(a, fast), dot_operand(b, fast)), fast)


class _RoundOperand(torch.autograd.Function):
    """f32 -> its nearest bf16 value kept in f32; the gradient passes
    unrounded (straight through)."""

    @staticmethod
    def forward(ctx, t):
        return t.to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundCotangent(torch.autograd.Function):
    """The identity, whose backward rounds the cotangent to bf16 (kept in
    f32): on a product's output, both transposed products take it rounded."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).float()


def dot_operand(t: torch.Tensor, fast: bool) -> torch.Tensor:
    """An operand of a matmul or convolution. At f32 and matmul_precision
    default (``fast``), which a TPU runs as one bf16 pass (bf16 operands,
    exact products, f32 sums), an f32 tensor rounded to bf16 and kept in
    f32, so that the f32 op with TF32 off is that pass exactly; the gradient
    passes straight through, as the TPU rounds the operands of the
    transposed products and not the carries (``dot_cotangent``). Else ``t``
    itself."""
    if fast and t.dtype == torch.float32:
        return _RoundOperand.apply(t) if t.requires_grad else t.to(torch.bfloat16).float()
    return t


def dot_cotangent(y: torch.Tensor, fast: bool) -> torch.Tensor:
    """A product's f32 output at ``fast``: its cotangent is rounded to bf16
    where it enters the product's two transposed products (the TPU's
    backward at default precision). The value is ``y``."""
    if fast and y.dtype == torch.float32 and y.requires_grad:
        return _RoundCotangent.apply(y)
    return y


@dataclass
class TrainCtx:
    """Forward-pass context of the training engine: the train flag, the
    BatchNorm running-stat updates of this forward, keyed by module, and the
    products' precision. A BN applied more than once per step (the alignment
    loop) chains: it reads the previous update of this forward before it
    writes its own."""

    train: bool = False
    stats: Dict[nn.Module, Dict[str, torch.Tensor]] = field(default_factory=dict)
    # every product in one bf16 pass (f32 at matmul_precision default)
    fast: bool = False
    # the process group whose ranks' rows make up the global batch: the
    # BatchNorm statistics are taken over all of them (None: this batch)
    group: Optional[object] = None
    # spatially sharded (a parallel.spatial.BandGroup, its rows the padded
    # frame's bands): every feature is this rank's band of rows
    band: Optional[object] = None
    # sharded: the halo extensions made in this segment of the forward
    # (train_engine._halo), id of a feature -> (the feature, its
    # extension); each checkpointed segment, and each recomputation of one,
    # starts an empty one
    halo: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = field(default_factory=dict)


class _WorldSum(torch.autograd.Function):
    """A sum over the ranks of ``group``, differentiable: the gradient
    with respect to each rank's part is the sum of the ranks' output
    gradients (the global loss is the sum of theirs)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone(memory_format=torch.contiguous_format)
        torch.distributed.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        return _WorldSum.apply(g, ctx.group), None


def _global_mean(t: torch.Tensor, dims, n: int, group) -> torch.Tensor:
    """The mean over ``dims`` of the world's global batch, of which ``t``
    is this rank's part: the f32 sums of the ranks' parts, summed over the
    ranks, over the global count ``n``."""
    return _WorldSum.apply(t.sum(dim=dims, dtype=torch.float32), group) / n


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d, ctx: Optional[TrainCtx] = None,
               eps: float = 1e-5, momentum: float = 0.1, group=None,
               count: Optional[int] = None) -> torch.Tensor:
    """BatchNorm over every dim but 1, in the JAX package's form
    (x - mean) * rsqrt(var + eps) * gamma + beta, all in x's dtype.

    Eval (no ctx, or ctx.train False): the running statistics. Training:
    the batch statistics normalise (biased variance); the running-stat
    update (unbiased variance, momentum 0.1, num_batches_tracked + 1) is
    recorded in ``ctx.stats`` and never written into the module here. With
    ``group`` (the caller's choice: ``ctx.group`` for a batch spread over
    the world), x is this rank's part of a batch spread over the group's
    ranks: the mean, then the variance, are taken over their rows
    (differentiably, so each rank's backward carries the other ranks'
    dependence on its rows), and ``n`` is the global count, as the JAX
    package's mean over a batch sharded across devices is: ``count``, else
    this rank's count times the group's size (equal parts)."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    dt = x.dtype
    if ctx is not None and ctx.train:
        dims = [d for d in range(x.dim()) if d != 1]
        n = x.numel() // x.shape[1]
        if group is None:
            mean = x.mean(dim=dims)
            var = ((x - mean.view(shape)) ** 2).mean(dim=dims)
        else:
            n = count if count is not None else n * torch.distributed.get_world_size(group)
            mean = _global_mean(x, dims, n, group).to(dt)
            d = x - mean.view(shape)
            var = _global_mean(d * d, dims, n, group).to(dt)
        prev = ctx.stats.get(bn, {})
        rm = prev.get("running_mean", bn.running_mean)
        rv = prev.get("running_var", bn.running_var)
        nbt = prev.get("num_batches_tracked", bn.num_batches_tracked)
        with torch.no_grad():
            ctx.stats[bn] = {
                "running_mean": (1 - momentum) * rm + momentum * mean,
                "running_var": (1 - momentum) * rv + momentum * (var * (n / max(n - 1, 1))),
                "num_batches_tracked": nbt + 1,
            }
    else:
        mean, var = bn.running_mean.to(dt), bn.running_var
    inv = torch.rsqrt(var.to(dt) + eps)
    return ((x - mean.view(shape)) * inv.view(shape)
            * bn.weight.to(dt).view(shape) + bn.bias.to(dt).view(shape))


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """Abs form a*x + b*|x| (identical values to the compare/select form)."""
    a = 0.5 * (1.0 + negative_slope)
    b = 0.5 * (1.0 - negative_slope)
    return a * x + b * x.abs()


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def adaptive_avg_pool_11(x: torch.Tensor) -> torch.Tensor:
    """Global average pool NCHW -> [B, C]."""
    return x.mean(dim=(2, 3))


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pooling, stride 2."""
    return F.avg_pool2d(x, 2)


def replicate_pad_hw(x: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(x, (pad, pad, pad, pad), mode="replicate")


def _bilinear_matrix(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """[out, in] bilinear interpolation matrix, torch conventions, edge clamp
    (float64; callers cast)."""
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    if align_corners and out_size > 1:
        scale = (in_size - 1) / (out_size - 1)
    else:
        scale = in_size / out_size
    for i in range(out_size):
        src = i * scale if align_corners else (i + 0.5) * scale - 0.5
        src = min(max(src, 0.0), in_size - 1)
        lo = int(math.floor(src))
        hi = min(lo + 1, in_size - 1)
        f = src - lo
        mat[i, lo] += 1.0 - f
        mat[i, hi] += f
    return mat


@functools.lru_cache(maxsize=64)
def _resize_matrix(in_size: int, out_size: int, align_corners: bool, dtype,
                   device) -> torch.Tensor:
    """_bilinear_matrix as a device tensor, built once per shape (a fresh
    host-to-device copy per forward would sync the stream)."""
    return torch.as_tensor(_bilinear_matrix(in_size, out_size, align_corners),
                           dtype=dtype, device=device)


def interpolate_bilinear(x: torch.Tensor, size: Tuple[int, int],
                         align_corners: bool = False, rows=None, src=None) -> torch.Tensor:
    """NCHW bilinear resize matching ``F.interpolate(mode='bilinear')``, as
    two dense-matrix products (the JAX package's formulation); ``rows``
    (y0, y1): only those rows of the output; ``src`` (r0, h): x holds rows
    [r0, r0 + its height) of an ``h``-row input (all the rows those output
    rows read)."""
    h, w = x.shape[2:]
    r0, h = (0, h) if src is None else src
    mh = _resize_matrix(h, size[0], align_corners, x.dtype, x.device)
    if rows is not None:
        mh = mh[rows[0]:rows[1]]
    if src is not None:
        mh = mh[:, r0:r0 + x.shape[2]]
    mw = _resize_matrix(w, size[1], align_corners, x.dtype, x.device)
    y = torch.einsum("Hh,bchw->bcHw", mh, x)
    return torch.einsum("Ww,bchw->bchW", mw, y)


def grid_sample_bilinear(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """``F.grid_sample(mode='bilinear', padding_mode='zeros',
    align_corners=True)`` on NCHW ``x`` with ``grid`` [B, H, W, 2] (gx, gy)
    in [-1, 1]: the function of the JAX package's four-gather
    ``grid_sample_bilinear``, differentiable in both arguments."""
    return F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros", align_corners=True)


def sta_conv(feat: torch.Tensor, kernel: torch.Tensor, st_ksize: int = 5,
             rows=(0, 0)) -> torch.Tensor:
    """Per-pixel spatio-temporal filtering, unfused (the training engine's
    form): ``feat`` [B, C, h, w] filtered by the per-pixel k*k kernels packed
    channel-major (c*k*k + dy*k + dx) in ``kernel`` [B, C*k*k, h, w], over
    the replicate-padded feature, as k*k shifted multiply-accumulates.
    ``rows`` (above, below): rows of ``feat`` beyond the kernel's on each
    side (a band's neighbours' rows, (k-1)/2 or none); a side without them
    is replicate-padded."""
    b, c, h, w = kernel.shape[0], feat.shape[1], kernel.shape[2], kernel.shape[3]
    p = (st_ksize - 1) // 2
    fp = F.pad(feat, (p, p, p - rows[0], p - rows[1]), mode="replicate")
    k5 = kernel.reshape(b, c, st_ksize * st_ksize, h, w)
    out = feat.new_zeros((b, c, h, w))
    for dy in range(st_ksize):
        for dx in range(st_ksize):
            out = out + fp[:, :, dy:dy + h, dx:dx + w] * k5[:, :, dy * st_ksize + dx]
    return out


def upsample_bilinear_2x(x: torch.Tensor) -> torch.Tensor:
    """nn.Upsample(scale_factor=2, mode='bilinear', align_corners=False)."""
    return interpolate_bilinear(x, (x.shape[2] * 2, x.shape[3] * 2), align_corners=False)


@contextlib.contextmanager
def float32_precision(enabled: bool = True):
    """Run matmuls and cuDNN convolutions in true f32 (TF32 off) — the strict
    tier's counterpart of JAX's default_matmul_precision('float32')."""
    if not enabled:
        yield
        return
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def resolve_device(device: Optional[str | torch.device] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Asking for CUDA without a usable card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
