"""The training engine: the differentiable SAVSR forward.

The port's counterpart of the ``train_engines`` branches of
``savsr_tpu/archs/savsr_arch.py::_savsr_apply_inner`` and of the modules
they call (``osconv_apply_module`` in its concat form with
``osconv_impl: pallas_train``, ``osadapt_apply``, ``residual_block_apply``,
``window_l1_apply``, ``window_l2_apply``, ``rcab_apply``,
``residual_group_apply``, the unfused ``stau_apply`` with its coordinate
head differentiated, the tail conv and the bilinear skip), on the module
tree of archs/savsr_arch.py.

Every OSConv runs ``ops.osconv.osconv_agg_train``: the CUDA kernels forward
and backward on the card, their plain versions on the CPU. The fold of the
four attentions into the per-sample weight is plain PyTorch that autograd
differentiates. The ordinary convolutions are ``F.conv2d`` (XLA convs in the
JAX package, outside any Pallas kernel); the serving kernels have no
backward and are not on this path.

Precision. At f32 and ``matmul_precision: default`` (``ctx.fast``) the JAX
package runs every product that does not pin a precision as a TPU runs
default precision: one bf16 pass, operands rounded to bf16, exact products,
f32 sums, and the two transposed products of its backward the same way,
with the cotangent rounded (JAX's transpose rules pass the precision on).
Here each such product takes its operands through ``arch_util.dot_operand``
(rounded, the gradient straight through) and its output through
``arch_util.dot_cotangent`` (the cotangent rounded where it enters both
transposes), with TF32 off; the bias joins after the product and its
gradient, like the carries, stays f32. The products, JAX package
(``savsr_tpu/archs/``, ``savsr_tpu/ops/``) | port (``savsr_tpu_torch/archs/``,
"here": this file):

- convs, ``arch_util.py:178`` (``conv2d``) and ``savsr_arch.py:777``
  (``_conv2d_parts``: conv1, conv2, merge) | ``arch_util.py:25`` ``conv2d``,
  here at :128-133, 142-147, 151-158, 164-165, 176, 279, 291; the OSAdapt
  mask head ``savsr_arch.py:275-280`` |
  ``savsr_arch.py:232-237``; the STAU coordinate head
  ``savsr_arch.py:684-688`` | ``savsr_arch.py:305-310``; kernel_conv, fusion
  and tail ``savsr_arch.py:705, 745, 1504`` | here :204, :217, :297;
- ScaleAttention's 1x1 heads and the RCAB attention, ``_fc1x1``
  ``savsr_arch.py:76`` (called at :110-126, :893-894) | ``arch_util.py:43``
  ``fc1x1`` (``savsr_arch.py:199-208``, here :167-168);
- the scale-routing linears, ``arch_util.py:194`` (called at
  ``savsr_arch.py:168-169``) | ``arch_util.py:38`` ``linear``
  (``savsr_arch.py:222-223``);
- the OSConv kernel-bank fold, ``savsr_arch.py:218`` | here :110
  (``arch_util.dot_einsum``);
- the STAU compress/expand einsums, ``savsr_arch.py:738-741`` | here
  :212-215.

Products that pin their precision stay true f32: the two OSConv Pallas
kernels, which pin HIGHEST for f32 (``ops/pallas/osconv_kernel.py:115-120,
285-286``) | ``ops/osconv.py osconv_agg_train`` in its f32 mode (here
:118); the bilinear resizes at ``precision="highest"``
(``arch_util.py:303-304``: OSAdapt's 2x upsample and the skip at
``savsr_arch.py:1505``) | ``arch_util.interpolate_bilinear`` (f32 with TF32
off; here :298). No other product lies on the path: the grid samples
(``arch_util.py:367``) gather, sta_conv (``savsr_arch.py:400``) and the
BatchNorms are elementwise.

BatchNorm running-stat updates are collected in a ``TrainCtx`` and returned;
nothing here writes into the module. ``remat_train`` / ``remat_stau`` wrap
the same segments as the JAX package's ``_ckpt_call`` in
``torch.utils.checkpoint``: a segment receives the updates so far, so chained
updates survive its recomputation.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..ops.osconv import osconv_agg_train
from .arch_util import (
    TrainCtx,
    adaptive_avg_pool_11,
    conv2d,
    dot_einsum,
    fc1x1,
    grid_sample_bilinear,
    interpolate_bilinear,
    leaky_relu,
    sigmoid,
    sta_conv,
)
from .savsr_arch import (
    _stau_base_grid,
    _stau_coordinate_input,
    _stau_head,
    frame_sample_indices,
    get_hw,
    osadapt_mask,
    osconv_attention,
    pad_spatial,
)


def osconv_apply(ctx: TrainCtx, m, parts: List[torch.Tensor], scale, padding: int = 1):
    """OSConv2d forward on the concat of ``parts``: attentions from the GAP
    vector, folded with the kernel bank into the per-sample weight
    agg[b] = (sum_K ka W_K) * sa * ca[i] * fa[o] in the JAX layout
    [B, k, k, Cin, Cout], then the per-sample conv kernel."""
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    ca, fa, sa, ka = osconv_attention(m, adaptive_avg_pool_11(x), scale, ctx, ctx.fast)
    w = m.weight.to(x.dtype)  # [K, O, I, k, k]
    if ka is not None:
        agg = dot_einsum("bK,Koikl->bklio", ka, w, ctx.fast)
    else:
        agg = w[0].permute(2, 3, 1, 0).expand(x.shape[0], -1, -1, -1, -1)
    if sa is not None:
        agg = agg * sa[:, :, :, None, None]
    agg = agg * ca[:, None, None, :, None]
    if fa is not None:
        agg = agg * fa[:, None, None, None, :]
    return osconv_agg_train(x, agg, padding)


def osadapt_apply(ctx: TrainCtx, m, x: torch.Tensor, scale) -> torch.Tensor:
    mask = osadapt_mask(m, x, ctx, ctx.fast)
    return x + osconv_apply(ctx, m.adapt, [x], scale) * mask


def residual_block_apply(ctx: TrainCtx, blk, feats: List[torch.Tensor], scale):
    n, fast = len(feats), ctx.fast
    x1 = [leaky_relu(conv2d(feats[i], blk.conv0[i], 1, fast)) for i in range(n)]
    if blk.use_osconv:
        base = leaky_relu(osconv_apply(ctx, blk.osconv, x1, scale))
    else:
        base = leaky_relu(conv2d(torch.cat(x1, dim=1), blk.conv1, 0, fast))
    return [feats[i] + leaky_relu(conv2d(torch.cat([base, x1[i]], dim=1), blk.conv2[i], 1,
                                         fast))
            for i in range(n)]


def window_l1_apply(ctx: TrainCtx, unit, x: torch.Tensor, h_past: torch.Tensor, scale):
    """x: [B, T=3, C_in, h, w] sliding window; h_past: [B, C, h, w]."""
    t = x.shape[1]
    x_sup = torch.cat([x[:, i] for i in range(t) if i != t // 2], dim=1)
    h_sup = leaky_relu(conv2d(x_sup, unit.conv_sup, 1, ctx.fast))
    h_c = leaky_relu(conv2d(x[:, t // 2], unit.conv_c, 1, ctx.fast))
    feats = [h_c, h_sup, h_past]
    for blk in unit.blocks:
        feats = residual_block_apply(ctx, blk, feats, scale)
    return conv2d(torch.cat(feats, dim=1), unit.merge, 1, ctx.fast)


def window_l2_apply(ctx: TrainCtx, unit, feats: List[torch.Tensor], scale):
    h_feat = [leaky_relu(conv2d(feats[i], unit.conv_h[i], 1, ctx.fast))
              for i in range(unit.win_size)]
    out = h_feat if len(h_feat) == 1 else []
    for i in range(unit.win_size - unit.slid_win + 1):
        sw = h_feat[i:i + unit.slid_win]
        for blk in unit.blocks:
            sw = residual_block_apply(ctx, blk, sw, scale)
        out.append(conv2d(torch.cat(sw, dim=1), unit.merge, 1, ctx.fast))
    return out


def rcab_apply(rcab, x: torch.Tensor, fast: bool = False) -> torch.Tensor:
    body = rcab.rcab
    y = torch.relu(conv2d(x, body[0], 1, fast))
    y = conv2d(y, body[2], 1, fast)
    att = body[3].attention
    a = torch.relu(fc1x1(adaptive_avg_pool_11(y), att[1], fast))
    a = sigmoid(fc1x1(a, att[3], fast))
    return y * a[:, :, None, None] + x


def residual_group_apply(rg, x: torch.Tensor, fast: bool = False) -> torch.Tensor:
    y = x
    for rcab in rg.residual_group:
        y = rcab_apply(rcab, y, fast)
    return conv2d(y, rg.conv, 1, fast) + x


@functools.lru_cache(maxsize=256)
def _stau_static(kind: str, h: int, w: int, scale, dtype, device) -> torch.Tensor:
    """The STAU's static arrays (base grid, coordinate input) as device
    tensors, built once per (LR shape, scale): a fresh host-to-device copy
    every step would stall the stream."""
    make = _stau_base_grid if kind == "grid" else _stau_coordinate_input
    return torch.as_tensor(make(h, w, scale), dtype=dtype, device=device)


def _stau_grid_sample(x: torch.Tensor, offset: torch.Tensor, scale) -> torch.Tensor:
    """Sample ``x`` [B, C, h, w] at the HR->LR projection grid plus the
    predicted ``offset`` [1, 2, H, W] (x, y), zeros padding,
    align_corners=True; the grid is built in x's dtype."""
    b, _, h, w = x.shape
    base = _stau_static("grid", h, w, scale, x.dtype, x.device)
    off = torch.stack([offset[0, 0] * (2.0 / (w - 1)), offset[0, 1] * (2.0 / (h - 1))], dim=-1)
    grid = (base + off)[None].expand(b, -1, -1, -1)
    return grid_sample_bilinear(x, grid)


def stau_apply(m, x: torch.Tensor, scale, st_feat: torch.Tensor,
               fast: bool = False) -> torch.Tensor:
    """The unfused STAU upsampler [B, C, h, w] -> [B, C, H, W], with its
    coordinate head computed inline (training differentiates through it)."""
    _, _, h, w = x.shape
    kernel_warp = leaky_relu(conv2d(st_feat, m.kernel_conv[0], 0, fast), 0.1)
    sta_feat = sta_conv(x, kernel_warp)
    head = _stau_head(m, h, w, scale, x.dtype, x.device,
                      inp=_stau_static("coord", h, w, scale, x.dtype, x.device), fast=fast)
    fea0 = _stau_grid_sample(x, head["offset"], scale)
    wc = m.weight_compress.to(x.dtype)[:, :, :, 0, 0]  # [n, C/8, C]
    we = m.weight_expand.to(x.dtype)[:, :, :, 0, 0]    # [n, C, C/8]
    r = head["routing"][0]                             # [n, H, W]
    zc = dot_einsum("bchw,noc->bnohw", fea0, wc, fast)
    fc = dot_einsum("bnohw,nhw->bohw", zc, r, fast)
    ze = dot_einsum("bohw,nco->bnchw", fc, we, fast)
    fea = dot_einsum("bnchw,nhw->bchw", ze, r, fast) + fea0
    sta_up = _stau_grid_sample(sta_feat, head["st_offset"], scale)
    return conv2d(torch.cat([sta_up, fea], dim=1), m.fusion, 0, fast)


def _ckpt_call(ctx: TrainCtx, fn, *args, remat: bool):
    """Run ``fn(ctx', *args)`` as a checkpointed segment in training. The
    segment sees the updates recorded so far (chained updates survive) and
    hands its own back; on recomputation it rebuilds them from its inputs
    and touches nothing outside."""
    if not (ctx.train and remat):
        return fn(ctx, *args)

    def wrapped(stats, *a):
        inner = TrainCtx(train=True, stats={k: dict(v) for k, v in stats.items()},
                         fast=ctx.fast)
        return fn(inner, *a), inner.stats

    out, stats = checkpoint(wrapped, ctx.stats, *args, use_reentrant=False)
    ctx.stats.update(stats)
    return out


def savsr_train_forward(model, x: torch.Tensor, scale, train: bool = True,
                        fast: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """SAVSR forward of the training engine: x [B, T, C, h, w] in [0, 1] ->
    (sr [B, C, H, W], BatchNorm running-stat updates keyed like the
    state_dict). With ``train`` False the BatchNorms use their running
    statistics and the updates are empty. ``fast``: every product of the
    module docstring's list in one bf16 pass (f32 at matmul_precision
    default; the caller turns TF32 off)."""
    cfg = model.cfg
    ctx = TrainCtx(train=train, fast=fast)
    b, t, _, h_in, w_in = x.shape
    H, W = get_hw(h_in, w_in, scale)
    x_center = x[:, cfg.center]
    x = pad_spatial(x)
    hp, wp = x.shape[3:]
    fwd_idx, bwd_idx = frame_sample_indices(t, cfg.interval)
    x_forward = x[:, fwd_idx] if cfg.interval else x
    x_backward = x[:, bwd_idx] if cfg.interval else x

    n_iter = cfg.iter_win - cfg.slid_win + 1
    half = cfg.slid_win // 2
    ht_f2p = x.new_zeros((b, cfg.num_feat, hp, wp))
    ht_p2f = torch.zeros_like(ht_f2p)
    f2p: List[torch.Tensor] = [None] * n_iter
    p2f: List[torch.Tensor] = []
    # sequential bidirectional propagation; weights are shared across the
    # n_iter steps and the BatchNorm updates chain through ctx
    for idx in range(n_iter):
        cur = cfg.iter_win - 1 - half - idx
        ht_f2p = _ckpt_call(ctx, lambda c, a, hh: window_l1_apply(c, model.f2p_win, a, hh, scale),
                            x_backward[:, cur - half:cur + half + 1], ht_f2p,
                            remat=cfg.remat_train)
        f2p[n_iter - 1 - idx] = ht_f2p
        cur = idx + half
        ht_p2f = _ckpt_call(ctx, lambda c, a, hh: window_l1_apply(c, model.p2f_win, a, hh, scale),
                            x_forward[:, cur - half:cur + half + 1], ht_p2f,
                            remat=cfg.remat_train)
        p2f.append(ht_p2f)
    h_feat = [torch.cat([f2p[i], p2f[i]], dim=1) for i in range(n_iter)]
    for unit in model.h_win:
        h_feat = window_l2_apply(ctx, unit, h_feat, scale)
    h = leaky_relu(conv2d(h_feat[0], model.h_win_conv_h, 1, fast))
    align_feat = share = h

    gamma = model.gamma.to(x.dtype)

    def group(c, hh, rg, ad):
        return osadapt_apply(c, ad, residual_group_apply(rg, hh, c.fast), scale)

    for rg, ad in zip(model.RG, model.adapt):
        h = _ckpt_call(ctx, lambda c, hh, rg=rg, ad=ad: group(c, hh, rg, ad), h,
                       remat=cfg.remat_train)
        h = h + gamma * share
    h = conv2d(h, model.conv_last, 1, fast) + share

    # arbitrary-scale upsampling on the un-padded region
    sr = _ckpt_call(ctx, lambda c, hh, aa: stau_apply(model.upsample, hh, scale, aa, c.fast),
                    h[:, :, :h_in, :w_in], align_feat[:, :, :h_in, :w_in],
                    remat=cfg.remat_train or cfg.remat_stau)
    sr = conv2d(sr, model.tail, 1, fast)
    sr = sr + interpolate_bilinear(x_center, (H, W), align_corners=False)
    return sr, stats_by_name(model, ctx)


def stats_by_name(model: nn.Module, ctx: TrainCtx) -> Dict[str, torch.Tensor]:
    """ctx.stats re-keyed like the state_dict ("<module>.running_mean", ...)."""
    names = {m: name for name, m in model.named_modules() if m in ctx.stats}
    return {f"{names[m]}.{k}": v for m, upd in ctx.stats.items() for k, v in upd.items()}
