"""The serving engine's composition: alignment scan units, WindowUnit_l2 and
the trunk on the fused conv kernel (ops/conv.py).

The port's counterpart of ``savsr_tpu/archs/chw_engine.py`` (eval only).
Every 3x3/1x1 conv goes through ``conv_fused`` with its bias / LeakyReLU /
residual epilogue fused, and the OSConv2d attentions (ca/fa/sa/ka) are
folded into a per-sample f32 aggregated weight that is cast once, so
activations go straight through ``y = W'x``. Channel concats are passed as
lists of parts and never copied. Layout is plain NCHW: the TPU engine's
flat-padded CHW layout, its pad mask and its Cin chunking are TPU artefacts.

The split tier (``SAVSRConfig.conv_precision = "split"``) carries features
between convs as ``Pair``s of bf16 planes (ops/conv.py) and runs each conv
as the 3-pass hi/lo contraction of ``conv_fused_split``. Which tier a unit
runs follows from what it is given: a window's hidden state that is a
``Pair`` splits the raw f32 frames and every conv after them. The non-conv
consumers rebuild the f32 value (``pair_merge``): the RCAB attention and
the trunk's ``+ gamma * share`` re-split their f32 result, the OSConv GAP
sums hi and lo apart, the OSAdapt mask head and the trunk's last conv
return f32. The TPU's pair-chunk width (``model_pc``) interleaves hi and lo
channels in one tensor for its VMEM slabs; a ``Pair`` keeps two tensors, so
it has no counterpart here.

The fast tier (f32 weights and carries at ``matmul_precision: default``,
the counterpart of the JAX engine's ambient DEFAULT matmul precision) is
named by the ``fast`` argument, which SAVSR's forward passes down: every
conv takes the fast conv (``conv_fused_fast``: bf16 operands, f32 sums, f32
epilogue and output), the OSConv weight aggregation rounds ka and the bank
to bf16 (its f32 result is rounded again where the conv takes it), and the
heads round their operands (``arch_util.dot_operand``).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..ops.conv import Pair, conv_fused, conv_fused_fast, conv_fused_split, pair_merge, pair_split
from .arch_util import dot_operand, fc1x1, sigmoid

# leaky_relu(0.2) in the kernel's abs form a*x + b*|x|
LRELU = (0.6, 0.4)
RELU = (0.5, 0.5)


def conv3(conv, x, lrelu=LRELU, residual=None, pre_add: Optional[torch.Tensor] = None,
          out: str = "pair", fast: bool = False):
    """Named-parameter conv (3x3 or 1x1, from the weight) on a tensor or a
    list of channel parts standing for their concat. Parts that are
    ``Pair``s take the split conv, whose result is a ``Pair`` or, with
    ``out="f32"``, f32; ``fast`` the fast conv."""
    parts = x if isinstance(x, list) else [x]
    if isinstance(parts[0], Pair):
        return conv_fused_split(parts, conv.weight, conv.bias, pre_add=pre_add, lrelu=lrelu,
                                residual=residual, out=out)
    if fast:
        return conv_fused_fast(x, conv.weight, conv.bias, pre_add=pre_add, lrelu=lrelu,
                               residual=residual)
    return conv_fused(x, conv.weight, conv.bias, pre_add=pre_add, lrelu=lrelu,
                      residual=residual)


conv1 = conv3  # the 1x1 convs take the same wrapper (kernel chosen by weight)


def _sum_s(p) -> torch.Tensor:
    """Spatial f32 sums [B, C]; of a pair, the hi and lo sums added (the TPU
    engine's _pair_sum_s)."""
    if isinstance(p, Pair):
        return _sum_s(p.hi) + _sum_s(p.lo)
    return p.sum(dim=(2, 3), dtype=torch.float32)


def _gap(parts: List, h: int, w: int) -> torch.Tensor:
    """Per-channel means over the (padded) frame: f32 sums times the f32
    reciprocal of h*w, as the TPU engine computes them."""
    inv_hw = float(torch.tensor(1.0 / (h * w), dtype=torch.float32))
    return torch.cat([_sum_s(p) * inv_hw for p in parts], dim=1)


def _value_dtype(x) -> torch.dtype:
    """The dtype a feature's value has: f32 for a pair."""
    return torch.float32 if isinstance(x, Pair) else x.dtype


def osconv_agg(m, parts: List[torch.Tensor], scale, h: int, w: int,
               fast: bool = False) -> torch.Tensor:
    """Per-sample aggregated OSConv weight [B, O, I, 3, 3] (f32) with all four
    attentions folded: W'[b] = (sum_K ka W_K) * sa * ca[i] * fa[o] (``fast``:
    the heads' and the sum's operands rounded to bf16)."""
    from .savsr_arch import osconv_attention

    gap = _gap(parts, h, w).to(_value_dtype(parts[0]))
    ca, fa, sa, ka = osconv_attention(m, gap, scale, fast=fast)
    agg = torch.einsum("bK,Koikl->boikl", dot_operand(ka.float(), fast),
                       dot_operand(m.weight.float(), fast))
    if sa is not None:
        agg = agg * sa.float()[:, None, None, :, :]
    agg = agg * ca.float()[:, None, :, None, None]
    if fa is not None:
        agg = agg * fa.float()[:, :, None, None, None]
    return agg


def osconv_chw(m, parts: List, scale, h: int, w: int, lrelu=None, fast: bool = False):
    """OSConv2d: the folded per-sample weight, cast once (split: kept in f32
    and split per sample by the split conv; fast: kept in f32 and rounded to
    bf16 by the fast conv)."""
    agg = osconv_agg(m, parts, scale, h, w, fast)
    if isinstance(parts[0], Pair):
        return conv_fused_split(parts, agg, None, lrelu=lrelu)
    if fast:
        return conv_fused_fast(parts, agg, None, lrelu=lrelu)
    return conv_fused(parts, agg.to(parts[0].dtype).contiguous(), None, lrelu=lrelu)


def residual_block_chw(blk, feats: List, scale, h: int, w: int,
                       fast: bool = False) -> List[torch.Tensor]:
    """ResidualBlock (reference savsr_arch.py:379-415)."""
    n = len(feats)
    x1 = [conv3(blk.conv0[i], feats[i], fast=fast) for i in range(n)]
    if blk.use_osconv:
        base = osconv_chw(blk.osconv, x1, scale, h, w, lrelu=LRELU, fast=fast)
    else:
        base = conv1(blk.conv1, x1, fast=fast)
    return [conv3(blk.conv2[i], [base, x1[i]], residual=feats[i], fast=fast) for i in range(n)]


def window_l1_apply_chw(unit, x: torch.Tensor, h_past, scale, h: int, w: int,
                        fast: bool = False):
    """WindowUnit_l1 (reference savsr_arch.py:418-464). x: [B, T=3, C_in, h, w]
    window (frame views, no copies); h_past: [B, C, h, w], or a ``Pair`` in
    the split tier, which then splits the f32 frames (the supporting frames
    as one concat, as the TPU engine's _split_x does)."""
    t = x.shape[1]
    sup = [x[:, i] for i in range(t) if i != t // 2]
    x_c = x[:, t // 2]
    if isinstance(h_past, Pair):
        x_c, sup = pair_split(x_c), pair_split(torch.cat(sup, 1))
    feats = [conv3(unit.conv_c, x_c, fast=fast), conv3(unit.conv_sup, sup, fast=fast), h_past]
    for blk in unit.blocks:
        feats = residual_block_chw(blk, feats, scale, h, w, fast)
    return conv3(unit.merge, feats, lrelu=None, fast=fast)


def window_l2_apply_chw(unit, feats: List, scale, h: int, w: int, fast: bool = False) -> List:
    """WindowUnit_l2 (reference savsr_arch.py:467-501). feats: the hidden
    states of the two directions, each a [B, 2C, h, w] tensor or a list of
    channel parts (split: of ``Pair``s)."""
    h_feat = [conv3(unit.conv_h[i], feats[i], fast=fast) for i in range(unit.win_size)]
    out = h_feat if len(h_feat) == 1 else []
    for i in range(unit.win_size - unit.slid_win + 1):
        sw = h_feat[i:i + unit.slid_win]
        for blk in unit.blocks:
            sw = residual_block_chw(blk, sw, scale, h, w, fast)
        out.append(conv3(unit.merge, sw, lrelu=None, fast=fast))
    return out


def rcab_chw(rcab, x, h: int, w: int, fast: bool = False):
    """Residual channel-attention block (reference rcan RCAB). Split: the
    channel scale and the residual add run on the pairs' f32 values, and the
    sum is split again."""
    body = rcab.rcab
    y = conv3(body[0], x, lrelu=RELU, fast=fast)
    y = conv3(body[2], y, lrelu=None, fast=fast)
    att = body[3].attention
    a = _gap([y], h, w).to(_value_dtype(y))
    a = torch.clamp_min(fc1x1(a, att[1], fast), 0)
    a = sigmoid(fc1x1(a, att[3], fast))
    if isinstance(y, Pair):
        return pair_split(pair_merge(y) * a[:, :, None, None] + pair_merge(x))
    return y * a[:, :, None, None] + x


def residual_group_chw(rg, x, h: int, w: int, fast: bool = False):
    y = x
    for rcab in rg.residual_group:
        y = rcab_chw(rcab, y, h, w, fast)
    return conv3(rg.conv, y, lrelu=None, residual=x, fast=fast)


def osadapt_chw(m, x, scale, h: int, w: int, fast: bool = False) -> torch.Tensor:
    """OSAdapt: the small mask head in plain PyTorch, the 64-channel adapt
    OSConv on the fused conv kernel. Split: the mask head and the sum run on
    the f32 values, and the result stays f32 (the trunk splits it after its
    own add)."""
    from .savsr_arch import osadapt_mask

    pair = isinstance(x, Pair)
    xf = pair_merge(x) if pair else x
    mask = osadapt_mask(m, xf, fast=fast)
    adapted = osconv_chw(m.adapt, [x], scale, h, w, fast=fast)
    return xf + (pair_merge(adapted) if pair else adapted) * mask


def trunk_apply_chw(model, h_feat, scale, h: int, w: int, fast: bool = False):
    """h_win_conv_h + RCAN trunk with OSAdapt residual adapters (reference
    savsr_arch.py:692-706). Returns (trunk feature, align feature), f32 in
    the split tier."""
    x = conv3(model.h_win_conv_h, h_feat, fast=fast)
    share = x
    pair = isinstance(share, Pair)
    share_f = pair_merge(share) if pair else share
    gamma = model.gamma.to(_value_dtype(share))
    for rg, ad in zip(model.RG, model.adapt):
        g = residual_group_chw(rg, x, h, w, fast)
        g = osadapt_chw(ad, g, scale, h, w, fast)
        x = g + gamma * share_f
        if pair:
            x = pair_split(x)
    x = conv3(model.conv_last, x, lrelu=None, residual=share, out="f32", fast=fast)
    return x, share_f
