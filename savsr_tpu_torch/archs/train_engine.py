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
  here at :150-151 (``conv3``, every 3x3 of a feature), :231, :244-245;
  the OSAdapt mask head ``savsr_arch.py:275-280`` | ``savsr_arch.py:240-245``
  (sharded: ``conv3``); the STAU coordinate head
  ``savsr_arch.py:684-688`` | ``savsr_arch.py:313-318``; kernel_conv, fusion
  and tail ``savsr_arch.py:705, 745, 1504`` | here :323, :351, :458;
- ScaleAttention's 1x1 heads and the RCAB attention, ``_fc1x1``
  ``savsr_arch.py:76`` (called at :110-126, :893-894) | ``arch_util.py:43``
  ``fc1x1`` (``savsr_arch.py:207-216``, here :269-270);
- the scale-routing linears, ``arch_util.py:194`` (called at
  ``savsr_arch.py:168-169``) | ``arch_util.py:38`` ``linear``
  (``savsr_arch.py:230-231``);
- the OSConv kernel-bank fold, ``savsr_arch.py:218`` | here :178
  (``arch_util.dot_einsum``);
- the STAU compress/expand einsums, ``savsr_arch.py:738-741`` | here
  :346-349.

Products that pin their precision stay true f32: the two OSConv Pallas
kernels, which pin HIGHEST for f32 (``ops/pallas/osconv_kernel.py:115-120,
285-286``) | ``ops/osconv.py osconv_agg_train`` in its f32 mode (here
:187-188); the bilinear resizes at ``precision="highest"``
(``arch_util.py:303-304``: OSAdapt's 2x upsample and the skip at
``savsr_arch.py:1505``) | ``arch_util.interpolate_bilinear`` (f32, TF32
off; here :464, the sharded mask head's :218). No other product lies on
the path: the grid samples (``arch_util.py:367``) gather, sta_conv
(``savsr_arch.py:400``) and the BatchNorms are elementwise.

Spatially sharded (``band``, a ``parallel.spatial.BandGroup``: the
JAX package's ``spatial`` mesh axis in training, where XLA differentiates
the halo exchanges it inserts): every rank of a band group holds the whole
LR window, and every feature is its band of rows of the padded frame. A
3x3 conv reads its parts extended by one row of the neighbours' on each
side (``spatial.extend_rows_train``: zero rows at the frame's edges; one
exchange for the parts not extended yet, the extension kept in the
context's halo cache for the segment, so a feature that several convs of
a segment read is exchanged once), at no padding in height (the OSConv kernel at padding 1, its
output cut to the band); a GAP sums each row, puts the bands' row sums
together (``band_row_sums_train``) and adds them in row order; the OSAdapt
mask head exchanges a halo row at each of its layers (``_band_mask``), its
BatchNorms' statistics over the world's rows (the global count given); STA reads ``STA_REACH``
rows beyond the band, replicated only at the frame's edges; every band
computes the whole STAU coordinate head, and the sampler reads its band's
LR window in zeros of the frame's height (``fetch_window_train``),
producing the band's HR rows and one beyond on each side for the tail's
3x3. What every band computes alike (the heads, the attentions, the
ScaleAttention BatchNorm, whose statistics run over the band's data group)
each band differentiates only for its own share of the loss: the backward
of each exchange is its transpose, and the parameters' gradients are
summed over the bands by the trainer (``parallel.reduce_gradients``).

BatchNorm running-stat updates are collected in a ``TrainCtx`` and returned;
nothing here writes into the module. ``remat_train`` / ``remat_stau`` wrap
the same segments as the JAX package's ``_ckpt_call`` in
``torch.utils.checkpoint``: a segment receives the updates so far, so chained
updates survive its recomputation.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..ops.osconv import osconv_agg_train
from ..parallel import spatial
from .arch_util import (
    TrainCtx,
    adaptive_avg_pool_11,
    avg_pool2,
    batch_norm,
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
    band_input,
    _stau_coordinate_input,
    _stau_head,
    frame_sample_indices,
    get_hw,
    osadapt_mask,
    osconv_attention,
    pad_spatial,
)


def _cat(parts: List[torch.Tensor]) -> torch.Tensor:
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def _halo(ctx: TrainCtx, parts: List[torch.Tensor]) -> List[torch.Tensor]:
    """Sharded: each of ``parts`` with its neighbours' row on each side
    (zero rows at the frame's edges). The parts not extended yet in this
    segment go in one exchange, and ``ctx.halo`` keeps each extension (with
    its feature, so that the id stays its own), so that a feature that
    several convs of a segment read is exchanged once."""
    todo = {id(p): p for p in parts if id(p) not in ctx.halo}
    if todo:
        exts, _ = spatial.extend_rows_train(list(todo.values()), ctx.band, spatial.HALO)
        ctx.halo.update({k: (p, e) for (k, p), e in zip(todo.items(), exts)})
    return [ctx.halo[id(p)][1] for p in parts]


def conv3(ctx: TrainCtx, parts: List[torch.Tensor], conv) -> torch.Tensor:
    """A 3x3 conv (zero padding 1) of the concat of ``parts``; sharded, of
    their extensions (``_halo``) at no padding in height."""
    if ctx.band is None:
        return conv2d(_cat(parts), conv, 1, ctx.fast)
    return conv2d(_cat(_halo(ctx, parts)), conv, (0, 1), ctx.fast)


def gap(ctx: TrainCtx, parts: List[torch.Tensor]) -> torch.Tensor:
    """Global average pool of the concat of ``parts`` -> [B, C]. Sharded:
    each row's f32 sum, the bands' rows put together into the frame's
    (``band_row_sums_train``), added in row order, times the f32
    reciprocal of the frame's h*w (the eval's form, archs/chw_engine.py
    ``_gap``). One process keeps ``adaptive_avg_pool_11``: its sum order
    is the one tests/test_torch_dist.py's batch was chosen far from a ReLU
    kink for (ROADMAP C)."""
    if ctx.band is None:
        return adaptive_avg_pool_11(_cat(parts))
    rows = torch.cat([p.sum(dim=3, dtype=torch.float32) for p in parts], dim=1)
    full = spatial.band_row_sums_train(rows, ctx.band)
    inv_hw = float(torch.tensor(1.0 / (full.shape[2] * parts[0].shape[3]), dtype=torch.float32))
    return (full.sum(dim=2) * inv_hw).to(parts[0].dtype)


def osconv_apply(ctx: TrainCtx, m, parts: List[torch.Tensor], scale):
    """OSConv2d forward on the concat of ``parts``: attentions from the GAP
    vector, folded with the kernel bank into the per-sample weight
    agg[b] = (sum_K ka W_K) * sa * ca[i] * fa[o] in the JAX layout
    [B, k, k, Cin, Cout], then the per-sample conv kernel at padding 1
    (sharded: on the parts' extensions, the output cut to the band)."""
    x = _cat(parts)
    ca, fa, sa, ka = osconv_attention(m, gap(ctx, parts), scale, ctx, ctx.fast)
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
    if ctx.band is None:
        return osconv_agg_train(x, agg, 1)
    y = osconv_agg_train(_cat(_halo(ctx, parts)), agg, 1)
    return y[:, :, spatial.HALO:y.shape[2] - spatial.HALO]


def osadapt_apply(ctx: TrainCtx, m, x: torch.Tensor, scale) -> torch.Tensor:
    if ctx.band is None:
        mask = osadapt_mask(m, x, ctx, ctx.fast)
    else:
        mask = _band_mask(ctx, m, x)
    return x + osconv_apply(ctx, m.adapt, [x], scale) * mask


def _band_mask(ctx: TrainCtx, m, x: torch.Tensor) -> torch.Tensor:
    """The OSAdapt mask head (``savsr_arch.osadapt_mask``) on a band, layer
    by layer: each 3x3 conv on its input's halo extension, the BatchNorms
    over the world's rows, the pooling on the band's row pairs, the
    bilinear x2 on the half-resolution band and a row beyond on each side
    (none beyond the frame's edges, where the resize clamps as on the
    whole frame). Every activation is its owner's alone and computed once
    (the eval's head runs on ``MASK_REACH`` extra rows instead, which in
    training would leave each band a part of its neighbours' rows'
    gradients)."""
    band, s = ctx.band, m.mask
    count = x.shape[0] * band.data * band.rows[-1][1] * x.shape[3]
    y = torch.relu(batch_norm(conv3(ctx, [x], s[0]), s[1], ctx, group=ctx.group, count=count))
    y = avg_pool2(y)
    y = torch.relu(batch_norm(conv3(ctx, [y], s[4]), s[5], ctx, group=ctx.group,
                              count=count // 4))
    y = torch.relu(batch_norm(conv3(ctx, [y], s[7]), s[8], ctx, group=ctx.group,
                              count=count // 4))
    (ext,), top = spatial.extend_rows_train([y], band, 1, zeros=False)
    a, b = band.rows[band.index]
    y = interpolate_bilinear(ext, (band.rows[-1][1], 2 * y.shape[3]), rows=(a, b),
                             src=(a // 2 - top, band.rows[-1][1] // 2))
    return sigmoid(batch_norm(conv3(ctx, [y], s[11]), s[12], ctx, group=ctx.group,
                              count=count))


def residual_block_apply(ctx: TrainCtx, blk, feats: List[torch.Tensor], scale):
    n = len(feats)
    if ctx.band is not None:
        _halo(ctx, feats)
    x1 = [leaky_relu(conv3(ctx, [feats[i]], blk.conv0[i])) for i in range(n)]
    if blk.use_osconv:
        base = leaky_relu(osconv_apply(ctx, blk.osconv, x1, scale))
    else:
        base = leaky_relu(conv2d(torch.cat(x1, dim=1), blk.conv1, 0, ctx.fast))
    if ctx.band is not None:
        _halo(ctx, [base] + x1)
    return [feats[i] + leaky_relu(conv3(ctx, [base, x1[i]], blk.conv2[i])) for i in range(n)]


def window_l1_apply(ctx: TrainCtx, unit, x: torch.Tensor, h_past: torch.Tensor, scale):
    """x: [B, T=3, C_in, h, w] sliding window (sharded: the band's rows
    with a halo row of the frames on each side, zeros beyond the frame);
    h_past: [B, C, h, w]."""
    t = x.shape[1]
    pad = 1 if ctx.band is None else (0, 1)
    x_sup = torch.cat([x[:, i] for i in range(t) if i != t // 2], dim=1)
    h_sup = leaky_relu(conv2d(x_sup, unit.conv_sup, pad, ctx.fast))
    h_c = leaky_relu(conv2d(x[:, t // 2], unit.conv_c, pad, ctx.fast))
    feats = [h_c, h_sup, h_past]
    for blk in unit.blocks:
        feats = residual_block_apply(ctx, blk, feats, scale)
    return conv3(ctx, feats, unit.merge)


def window_l2_apply(ctx: TrainCtx, unit, feats: List[List[torch.Tensor]], scale):
    """feats: the windows' hidden states, each a list of channel parts."""
    h_feat = [leaky_relu(conv3(ctx, feats[i], unit.conv_h[i])) for i in range(unit.win_size)]
    out = [[h] for h in h_feat] if len(h_feat) == 1 else []
    for i in range(unit.win_size - unit.slid_win + 1):
        sw = h_feat[i:i + unit.slid_win]
        for blk in unit.blocks:
            sw = residual_block_apply(ctx, blk, sw, scale)
        out.append([conv3(ctx, sw, unit.merge)])
    return out


def rcab_apply(ctx: TrainCtx, rcab, x: torch.Tensor) -> torch.Tensor:
    body = rcab.rcab
    y = torch.relu(conv3(ctx, [x], body[0]))
    y = conv3(ctx, [y], body[2])
    att = body[3].attention
    a = torch.relu(fc1x1(gap(ctx, [y]), att[1], ctx.fast))
    a = sigmoid(fc1x1(a, att[3], ctx.fast))
    return y * a[:, :, None, None] + x


def residual_group_apply(ctx: TrainCtx, rg, x: torch.Tensor) -> torch.Tensor:
    y = x
    for rcab in rg.residual_group:
        y = rcab_apply(ctx, rcab, y)
    return conv3(ctx, [y], rg.conv) + x


@functools.lru_cache(maxsize=256)
def _stau_static(kind: str, h: int, w: int, scale, dtype, device) -> torch.Tensor:
    """The STAU's static arrays (base grid, coordinate input) as device
    tensors, built once per (LR shape, scale): a fresh host-to-device copy
    every step would stall the stream."""
    make = _stau_base_grid if kind == "grid" else _stau_coordinate_input
    return torch.as_tensor(make(h, w, scale), dtype=dtype, device=device)


def _stau_grid(x: torch.Tensor, offset: torch.Tensor, scale, rows=None) -> torch.Tensor:
    """The sampling grid [B, H, W, 2] (x, y) of the HR->LR projection plus
    the predicted ``offset`` [1, 2, H, W] for ``x`` [B, C, h, w], built in
    x's dtype; ``rows`` (y0, y1): only those HR rows."""
    b, _, h, w = x.shape
    base = _stau_static("grid", h, w, scale, x.dtype, x.device)
    if rows is not None:
        base, offset = base[rows[0]:rows[1]], offset[:, :, rows[0]:rows[1]]
    off = torch.stack([offset[0, 0] * (2.0 / (w - 1)), offset[0, 1] * (2.0 / (h - 1))], dim=-1)
    return (base + off)[None].expand(b, -1, -1, -1)


def _stau_grid_sample(x: torch.Tensor, offset: torch.Tensor, scale, rows=None) -> torch.Tensor:
    """Sample ``x`` [B, C, h, w] at ``_stau_grid``, zeros padding,
    align_corners=True."""
    return grid_sample_bilinear(x, _stau_grid(x, offset, scale, rows))


def stau_apply(ctx: TrainCtx, m, x: torch.Tensor, scale, st_feat: torch.Tensor,
               h: Optional[int] = None) -> torch.Tensor:
    """The unfused STAU upsampler [B, C, h, w] -> [B, C, H, W], with its
    coordinate head computed inline (training differentiates through it).
    Sharded (``ctx.band``): x and st_feat are the band's rows of the
    cropped frame of ``h`` rows, and the result the band's HR rows with one
    row beyond on each side (``spatial.sampler_rows``). STA reads the ``STA_REACH``
    rows beyond the band, replicate-padded only at the frame's edges; every
    band computes the whole coordinate head, and from its (detached)
    offsets every band's LR window, the rows its taps reach, widened by a
    row; the sampler reads the band's window of x and STA in zeros of the
    frame's height, so its taps find the frame's values or its zeros."""
    fast, band = ctx.fast, ctx.band
    w = x.shape[3]
    h = x.shape[2] if band is None else h
    kernel_warp = leaky_relu(conv2d(st_feat, m.kernel_conv[0], 0, fast), 0.1)
    if band is None:
        sta_feat = sta_conv(x, kernel_warp)
    else:
        (xe,), top = spatial.extend_rows_train([x], band, spatial.STA_REACH, zeros=False)
        sta_feat = sta_conv(xe, kernel_warp, rows=(top, xe.shape[2] - top - x.shape[2]))
    head = _stau_head(m, h, w, scale, x.dtype, x.device,
                      inp=_stau_static("coord", h, w, scale, x.dtype, x.device), fast=fast)
    rows = None
    if band is not None:
        H = head["offset"].shape[2]
        ext = spatial.sampler_rows(spatial.hr_band_rows(band.rows, h, H), H)
        rows = ext[band.index]
        windows = stau_windows(head, scale, h, w, ext, x.dtype)
        win = spatial.fetch_window_train(torch.cat([x, sta_feat], 1), band,
                                         spatial.crop_rows(band.rows, h), windows, h)
        x, sta_feat = win[:, :x.shape[1]], win[:, x.shape[1]:]
    fea0 = _stau_grid_sample(x, head["offset"], scale, rows)
    wc = m.weight_compress.to(x.dtype)[:, :, :, 0, 0]  # [n, C/8, C]
    we = m.weight_expand.to(x.dtype)[:, :, :, 0, 0]    # [n, C, C/8]
    r = head["routing"][0]                             # [n, H, W]
    if rows is not None:
        r = r[:, rows[0]:rows[1]]
    zc = dot_einsum("bchw,noc->bnohw", fea0, wc, fast)
    fc = dot_einsum("bnohw,nhw->bohw", zc, r, fast)
    ze = dot_einsum("bohw,nco->bnchw", fc, we, fast)
    fea = dot_einsum("bnchw,nhw->bchw", ze, r, fast) + fea0
    sta_up = _stau_grid_sample(sta_feat, head["st_offset"], scale, rows)
    return conv2d(torch.cat([sta_up, fea], dim=1), m.fusion, 0, fast)


def stau_windows(head: Dict[str, torch.Tensor], scale, h: int, w: int, hr_rows, dtype):
    """The LR rows [L0, L1) of an ``h`` x ``w`` frame that the STAU's two
    samplers reach from each range of ``hr_rows``, from the head's
    offsets (detached; the grids built in ``dtype``, as the sampler's),
    widened by a row on each side for the sampler's own rounding of the
    coordinates (one device-to-host read)."""
    frame = torch.empty((1, 1, h, w), dtype=dtype, device=head["offset"].device)
    fy = torch.stack([(_stau_grid(frame, head[k].detach(), scale)[0, :, :, 1].float() + 1.0)
                      * (0.5 * (h - 1)) for k in ("offset", "st_offset")])
    return spatial.window_reach(fy, hr_rows, h, margin=1)


def _ckpt_call(ctx: TrainCtx, fn, *args, remat: bool):
    """Run ``fn(ctx', *args)`` as a checkpointed segment in training. The
    segment sees the updates recorded so far (chained updates survive) and
    hands its own back; on recomputation it rebuilds them from its inputs
    and touches nothing outside. Every segment, checkpointed or not, starts
    an empty halo cache (``ctx.halo``), which ends with it: sharded, the
    recomputation issues all of the segment's exchanges again, inside the
    backward, at the same point on every band."""
    if not (ctx.train and remat):
        return fn(dataclasses.replace(ctx, halo={}), *args)

    def wrapped(stats, *a):
        inner = dataclasses.replace(ctx, stats={k: dict(v) for k, v in stats.items()}, halo={})
        return fn(inner, *a), inner.stats

    out, stats = checkpoint(wrapped, ctx.stats, *args, use_reentrant=False)
    ctx.stats.update(stats)
    return out


def savsr_train_forward(model, x: torch.Tensor, scale, train: bool = True,
                        fast: bool = False, group=None,
                        band=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """SAVSR forward of the training engine: x [B, T, C, h, w] in [0, 1] ->
    (sr [B, C, H, W], BatchNorm running-stat updates keyed like the
    state_dict). With ``train`` False the BatchNorms use their running
    statistics and the updates are empty. ``fast``: every product of the
    module docstring's list in one bf16 pass (f32 at matmul_precision
    default; the caller turns TF32 off). ``group``: x is this rank's part
    of a global batch spread over the group's ranks, over which the
    BatchNorm statistics are taken. ``band`` (a
    ``parallel.spatial.BandGroup``): x is the whole window on every band of
    the group, and sr this band's rows ``spatial.hr_band_rows(...)[index]``
    of the output (module docstring)."""
    cfg = model.cfg
    b, t, _, h_in, w_in = x.shape
    H, W = get_hw(h_in, w_in, scale)
    x_center = x[:, cfg.center]
    x = pad_spatial(x)
    hp, wp = x.shape[3:]
    rows = hp  # the features' height: the band's rows when sharded
    if band is not None:
        band = dataclasses.replace(band, rows=tuple(spatial.band_rows(hp, band.count)))
        a, b_ = band.rows[band.index]
        x, rows = band_input(x, a, b_), b_ - a
    ctx = TrainCtx(train=train, fast=fast, group=group, band=band)
    fwd_idx, bwd_idx = frame_sample_indices(t, cfg.interval)
    x_forward = x[:, fwd_idx] if cfg.interval else x
    x_backward = x[:, bwd_idx] if cfg.interval else x

    n_iter = cfg.iter_win - cfg.slid_win + 1
    half = cfg.slid_win // 2
    ht_f2p = x.new_zeros((b, cfg.num_feat, rows, wp))
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
    h_feat = [[f2p[i], p2f[i]] for i in range(n_iter)]
    for unit in model.h_win:
        h_feat = window_l2_apply(ctx, unit, h_feat, scale)
    h = leaky_relu(conv3(ctx, h_feat[0], model.h_win_conv_h))
    align_feat = share = h

    gamma = model.gamma.to(x.dtype)

    def trunk_group(c, hh, rg, ad):
        return osadapt_apply(c, ad, residual_group_apply(c, rg, hh), scale)

    for rg, ad in zip(model.RG, model.adapt):
        h = _ckpt_call(ctx, lambda c, hh, rg=rg, ad=ad: trunk_group(c, hh, rg, ad), h,
                       remat=cfg.remat_train)
        h = h + gamma * share
    h = conv3(ctx, [h], model.conv_last) + share

    # arbitrary-scale upsampling on the un-padded region
    crop = h_in if band is None else min(band.rows[band.index][1], h_in) - band.rows[band.index][0]
    sr = _ckpt_call(ctx, lambda c, hh, aa: stau_apply(c, model.upsample, hh, scale, aa, h_in),
                    h[:, :, :crop, :w_in], align_feat[:, :, :crop, :w_in],
                    remat=cfg.remat_train or cfg.remat_stau)
    sr = conv2d(sr, model.tail, 1, fast)
    out_rows = None
    if band is not None:  # the tail's extra rows cut
        out_rows = spatial.hr_band_rows(band.rows, h_in, H)[band.index]
        e0 = spatial.sampler_rows([out_rows], H)[0][0]
        sr = sr[:, :, out_rows[0] - e0:out_rows[1] - e0]
    sr = sr + interpolate_bilinear(x_center, (H, W), align_corners=False, rows=out_rows)
    return sr, stats_by_name(model, ctx)


def stats_by_name(model: nn.Module, ctx: TrainCtx) -> Dict[str, torch.Tensor]:
    """ctx.stats re-keyed like the state_dict ("<module>.running_mean", ...)."""
    names = {m: name for name, m in model.named_modules() if m in ctx.stats}
    return {f"{names[m]}.{k}": v for m, upd in ctx.stats.items() for k, v in upd.items()}
