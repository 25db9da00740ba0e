"""SAVSR: arbitrary-scale video super-resolution network, NCHW.

The port's counterpart of ``savsr_tpu/archs/savsr_arch.py``: ``nn.Module``s
whose ``state_dict`` keys and shapes equal the reference's
(lbasicsr/archs/savsr_arch.py), so reference checkpoints load with
``load_state_dict(strict=True)``, plus two forwards on that one module tree:

- serving (``forward(x, scale)``): the eval forward of the CHW serving
  engine (``_savsr_apply_inner`` with ``conv_engine="chw"``): the alignment
  scan, WindowUnit_l2 and the trunk (archs/chw_engine.py) on the fused conv
  kernel, then the STA, STAU and tail kernels, at the tier that the
  weights' dtype and ``matmul_precision`` / ``conv_precision`` name
  (``SAVSR.serving_tier``): bf16; strict (f32, ``float32``); fast (f32 at
  ``default``: every product in one bf16 pass, the fast kernels, the heads'
  operands rounded to bf16); split (f32 with ``conv_precision: split``: the
  convs up to the trunk's end run the split conv on pair carries and STA,
  STAU and the tail their f32 kernels);
- training (``forward(x, scale, train=True)``): the differentiable forward
  of archs/train_engine.py, whose OSConv engine is the pair of kernels of
  ops/osconv.py; it returns ``(sr, stats_updates)``.

The small heads that the JAX package leaves to XLA (ScaleAttention MLPs,
the OSAdapt mask head, the STAU coordinate head) run as plain PyTorch ops.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..ops.conv import Pair
from ..ops.sta import sta_conv_fused, sta_conv_fused_fast
from ..ops.stau import (plan_geometry, stau_upsample_fused, stau_upsample_fused_fast,
                        stau_window_plan)
from ..ops.tail import tail_fused, tail_fused_fast
from .arch_util import (
    _bilinear_matrix,
    avg_pool2,
    batch_norm,
    conv2d,
    fc1x1,
    float32_precision,
    linear,
    sigmoid,
    upsample_bilinear_2x,
)

Scale = Tuple[float, float]


def get_hw(h: int, w: int, scale: Scale) -> Tuple[int, int]:
    """Output size round(h*sh), round(w*sw) — Python's banker's rounding,
    as the reference's get_HW_round."""
    return round(h * scale[0]), round(w * scale[1])


def normalize_scale(scale) -> Scale:
    if isinstance(scale, (tuple, list)):
        return (float(scale[0]), float(scale[1]))
    return (float(scale), float(scale))


def _conv(cin: int, cout: int, k: int, bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, padding=k // 2, bias=bias)


# ---------------------------------------------------------------------------
# modules (parameter containers with the reference's names)
# ---------------------------------------------------------------------------


class ScaleAttention(nn.Module):
    def __init__(self, in_planes: int, out_planes: int, kernel_size: int, groups: int = 1,
                 reduction: float = 0.0625, kernel_num: int = 4, min_channel: int = 16):
        super().__init__()
        att = max(int(in_planes * reduction), min_channel)
        self.kernel_size = kernel_size
        self.fc = _conv(in_planes, att, 1, bias=False)
        self.bn = nn.BatchNorm2d(att)
        self.channel_fc = _conv(att, in_planes, 1)
        self.filter_fc = (None if in_planes == groups and in_planes == out_planes
                          else _conv(att, out_planes, 1))
        self.spatial_fc = None if kernel_size == 1 else _conv(att, kernel_size ** 2, 1)
        self.kernel_fc = None if kernel_num == 1 else _conv(att, kernel_num, 1)


class OSConv2d(nn.Module):
    def __init__(self, in_planes: int, out_planes: int, kernel_size: int, kernel_num: int = 8):
        super().__init__()
        self.attention = ScaleAttention(in_planes, out_planes, kernel_size,
                                        kernel_num=kernel_num)
        self.weight = nn.Parameter(
            torch.zeros(kernel_num, out_planes, in_planes, kernel_size, kernel_size))
        self.scale_routing = nn.Sequential(
            nn.Linear(in_planes + 2, 2 * in_planes), nn.ReLU(),
            nn.Linear(2 * in_planes, in_planes))


class OSAdapt(nn.Module):
    def __init__(self, channels: int, ratio: int = 4):
        super().__init__()
        c2 = channels // ratio
        self.mask = nn.Sequential(
            _conv(channels, c2, 3), nn.BatchNorm2d(c2), nn.ReLU(), nn.AvgPool2d(2),
            _conv(c2, c2, 3), nn.BatchNorm2d(c2), nn.ReLU(),
            _conv(c2, c2, 3), nn.BatchNorm2d(c2), nn.ReLU(),
            nn.Upsample(scale_factor=2, mode="bilinear", align_corners=False),
            _conv(c2, 1, 3), nn.BatchNorm2d(1), nn.Sigmoid())
        self.adapt = OSConv2d(channels, channels, 3)


class STAUpsample(nn.Module):
    def __init__(self, channels: int, num_experts: int = 4, st_ksize: int = 5):
        super().__init__()
        self.kernel_conv = nn.Sequential(_conv(channels, channels * st_ksize ** 2, 1),
                                         nn.LeakyReLU(0.1))
        self.weight_compress = nn.Parameter(
            torch.zeros(num_experts, channels // 8, channels, 1, 1))
        self.weight_expand = nn.Parameter(
            torch.zeros(num_experts, channels, channels // 8, 1, 1))
        self.body = nn.Sequential(_conv(4, 64, 1), nn.ReLU(), _conv(64, 64, 1), nn.ReLU())
        self.routing = nn.Sequential(_conv(64, num_experts, 1), nn.Sigmoid())
        self.offset = _conv(64, 2, 1)
        self.st_offset = _conv(64, 2, 1)
        self.fusion = _conv(2 * channels, channels, 1)


class ResidualBlock(nn.Module):
    def __init__(self, num_feat: int, num_frame: int, use_osconv: bool):
        super().__init__()
        self.use_osconv = use_osconv
        self.conv0 = nn.ModuleList(_conv(num_feat, num_feat, 3) for _ in range(num_frame))
        if use_osconv:
            self.osconv = OSConv2d(num_feat * num_frame, num_feat, 3)
        else:
            self.conv1 = _conv(num_feat * num_frame, num_feat, 1)
        self.conv2 = nn.ModuleList(_conv(2 * num_feat, num_feat, 3) for _ in range(num_frame))


class WindowUnitL1(nn.Module):
    def __init__(self, num_in_ch: int, num_feat: int, win_size: int = 3, num_block: int = 4):
        super().__init__()
        self.conv_c = _conv(num_in_ch, num_feat, 3)
        self.conv_sup = _conv(num_in_ch * (win_size - 1), num_feat, 3)
        self.blocks = nn.ModuleList(ResidualBlock(num_feat, 3, i >= 1) for i in range(num_block))
        self.merge = _conv(3 * num_feat, num_feat, 3)


class WindowUnitL2(nn.Module):
    def __init__(self, num_feat: int, win_size: int = 5, slid_win: int = 5, num_block: int = 2):
        super().__init__()
        self.win_size, self.slid_win = win_size, slid_win
        self.conv_h = nn.ModuleList(_conv(2 * num_feat, num_feat, 3) for _ in range(win_size))
        self.blocks = nn.ModuleList(ResidualBlock(num_feat, slid_win, True)
                                    for _ in range(num_block))
        self.merge = _conv(slid_win * num_feat, 2 * num_feat, 3)


class ChannelAttention(nn.Module):
    def __init__(self, num_feat: int, squeeze_factor: int = 16):
        super().__init__()
        self.attention = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), _conv(num_feat, num_feat // squeeze_factor, 1), nn.ReLU(),
            _conv(num_feat // squeeze_factor, num_feat, 1), nn.Sigmoid())


class RCAB(nn.Module):
    def __init__(self, num_feat: int, squeeze_factor: int = 16):
        super().__init__()
        self.rcab = nn.Sequential(_conv(num_feat, num_feat, 3), nn.ReLU(),
                                  _conv(num_feat, num_feat, 3),
                                  ChannelAttention(num_feat, squeeze_factor))


class ResidualGroup(nn.Module):
    def __init__(self, num_feat: int, num_block: int):
        super().__init__()
        self.residual_group = nn.Sequential(*(RCAB(num_feat) for _ in range(num_block)))
        self.conv = _conv(num_feat, num_feat, 3)


# ---------------------------------------------------------------------------
# heads (plain PyTorch, as the JAX package leaves them to XLA)
# ---------------------------------------------------------------------------


def scale_attention_apply(att: ScaleAttention, v: torch.Tensor, temperature: float = 1.0,
                          ctx=None, fast: bool = False):
    """[B, in_planes] -> (ca [B,Cin], fa [B,Cout] | None, sa [B,k,k] | None,
    ka [B,K] | None). ``ctx`` (arch_util.TrainCtx) switches the BatchNorm to
    batch statistics in training; ``fast`` rounds the products' operands to
    bf16 (the fast tier, ``arch_util.dot_operand``), as ``fast`` does in
    every head below."""
    v = torch.relu(batch_norm(fc1x1(v, att.fc, fast), att.bn, ctx))
    ca = sigmoid(fc1x1(v, att.channel_fc, fast) / temperature)
    fa = (None if att.filter_fc is None
          else sigmoid(fc1x1(v, att.filter_fc, fast) / temperature))
    sa = None
    if att.spatial_fc is not None:
        k = att.kernel_size
        sa = sigmoid(fc1x1(v, att.spatial_fc, fast) / temperature).reshape(-1, k, k)
    ka = (None if att.kernel_fc is None
          else torch.softmax(fc1x1(v, att.kernel_fc, fast) / temperature, dim=1))
    return ca, fa, sa, ka


def osconv_attention(m: OSConv2d, gap: torch.Tensor, scale: Scale, ctx=None,
                     fast: bool = False):
    """Scale-routed attention heads from a [B, Cin] GAP vector (reference
    savsr_arch.py:139-150)."""
    b, dtype = gap.shape[0], gap.dtype
    # filled on the device (a host tensor here would sync the stream)
    scale_info = torch.empty((b, 2), dtype=dtype, device=gap.device)
    scale_info[:, 0] = 1.0 / scale[0]
    scale_info[:, 1] = 1.0 / scale[1]
    r = torch.cat([scale_info, gap], dim=1)
    r = torch.relu(linear(r, m.scale_routing[0], fast))
    r = torch.relu(linear(r, m.scale_routing[2], fast))
    return scale_attention_apply(m.attention, r, ctx=ctx, fast=fast)


def osadapt_mask(m: OSAdapt, x: torch.Tensor, ctx=None, fast: bool = False) -> torch.Tensor:
    """The downsample/upsample mask head of OSAdapt (reference
    savsr_arch.py:190-205) -> [B, 1, H, W]. The bilinear resize stays f32
    in the fast tier, as the JAX package pins it to highest precision."""
    s = m.mask
    y = torch.relu(batch_norm(conv2d(x, s[0], 1, fast), s[1], ctx))
    y = avg_pool2(y)
    y = torch.relu(batch_norm(conv2d(y, s[4], 1, fast), s[5], ctx))
    y = torch.relu(batch_norm(conv2d(y, s[7], 1, fast), s[8], ctx))
    y = upsample_bilinear_2x(y)
    return sigmoid(batch_norm(conv2d(y, s[11], 1, fast), s[12], ctx))


# ---------------------------------------------------------------------------
# STAU glue
# ---------------------------------------------------------------------------


def _stau_coordinate_input(h: int, w: int, scale: Scale) -> np.ndarray:
    """Static HR coordinate embedding input [1, 4, H, W]: channels
    (1/sw, 1/sh, R(y), R(x)) — reference savsr_arch.py:326-340."""
    H, W = get_hw(h, w, scale)
    coor_h = np.arange(H, dtype=np.float32)
    coor_h = ((coor_h + 0.5) / np.float32(scale[0])) - np.floor(
        (coor_h + 0.5) / np.float32(scale[0]) + 1e-3) - 0.5
    coor_w = np.arange(W, dtype=np.float32)
    coor_w = ((coor_w + 0.5) / np.float32(scale[1])) - np.floor(
        (coor_w + 0.5) / np.float32(scale[1]) + 1e-3) - 0.5
    inp = np.empty((1, 4, H, W), dtype=np.float32)
    inp[:, 0] = 1.0 / scale[1]
    inp[:, 1] = 1.0 / scale[0]
    inp[:, 2] = coor_h[:, None]
    inp[:, 3] = coor_w[None, :]
    return inp


def _stau_base_grid(h: int, w: int, scale: Scale) -> np.ndarray:
    """Static HR->LR projection grid [H, W, 2] (x, y) normalized to [-1, 1]
    (reference grid_sample, savsr_arch.py:262-282; float64 meshgrid, then f32)."""
    H, W = get_hw(h, w, scale)
    gx, gy = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    gx = (gx + 0.5) / scale[1] - 0.5
    gy = (gy + 0.5) / scale[0] - 0.5
    gx = gx * 2.0 / (w - 1) - 1.0
    gy = gy * 2.0 / (h - 1) - 1.0
    return np.stack([gx, gy], axis=-1).astype(np.float32)


def _stau_pixel_coords(offset: torch.Tensor, scale: Scale, h: int, w: int):
    """Unnormalized f32 sampling coords (fy, fx) [H, W]: the normalized grid
    plus offsets, unnormalized as grid_sample(align_corners=True) does."""
    base = torch.as_tensor(_stau_base_grid(h, w, scale), device=offset.device)
    off = offset[0].float()
    gx = base[..., 0] + off[0] * (2.0 / (w - 1))
    gy = base[..., 1] + off[1] * (2.0 / (h - 1))
    fx = (gx + 1.0) * 0.5 * (w - 1)
    fy = (gy + 1.0) * 0.5 * (h - 1)
    return fy, fx


def stau_sampler_planes(head: Dict[str, torch.Tensor], scale: Scale, h: int,
                        w: int) -> torch.Tensor:
    """The fused sampler's per-HR-pixel planes [4 + n, H, W] f32: fy_f, fx_f
    (trunk feature), fy_s, fx_s (STA feature), routing r_0..r_{n-1}."""
    fy_f, fx_f = _stau_pixel_coords(head["offset"], scale, h, w)
    fy_s, fx_s = _stau_pixel_coords(head["st_offset"], scale, h, w)
    rt = head["routing"][0].float()
    return torch.cat([torch.stack([fy_f, fx_f, fy_s, fx_s]), rt], dim=0).contiguous()


def _stau_head(m: STAUpsample, h: int, w: int, scale: Scale, dtype, device, inp=None,
               fast: bool = False):
    """STAU coordinate head: static HR coordinate embedding -> offsets and
    expert routing (reference savsr_arch.py:326-364). Depends only on
    (params, h, w, scale), never on video content. ``inp``: the coordinate
    input already on the device (the training engine caches it)."""
    if inp is None:
        inp = torch.as_tensor(_stau_coordinate_input(h, w, scale), dtype=dtype, device=device)
    emb = torch.relu(conv2d(inp, m.body[0], fast=fast))
    emb = torch.relu(conv2d(emb, m.body[2], fast=fast))
    return {
        "offset": conv2d(emb, m.offset, fast=fast),
        "st_offset": conv2d(emb, m.st_offset, fast=fast),
        "routing": sigmoid(conv2d(emb, m.routing[0], fast=fast)),
    }


@functools.lru_cache(maxsize=32)
def _tail_row_mix(h0: int, H: int):
    """Skip-resize row info: start row (clipped to h0-2) and its weight, from
    the <=2 nonzeros of the bilinear row matrix."""
    mh = _bilinear_matrix(h0, H, align_corners=False)
    j0 = np.zeros((H,), np.int32)
    wy = np.zeros((H,), np.float32)
    for i in range(H):
        nz = np.nonzero(mh[i])[0]
        j0[i] = min(int(nz[0]), h0 - 2)
        wy[i] = mh[i, j0[i]]
    return j0, wy


@functools.lru_cache(maxsize=32)
def _tail_col_mix(w0: int, W: int):
    """Skip-resize column info: start column (clipped to w0-2) and the f32
    weights of columns c0 and c0+1 (the TPU kernel's hatc entries)."""
    mw = _bilinear_matrix(w0, W, align_corners=False)
    c0 = np.zeros((W,), np.int32)
    cw = np.zeros((2, W), np.float32)
    for i in range(W):
        nz = np.nonzero(mw[i])[0]
        c0[i] = min(int(nz[0]), w0 - 2)
        cw[0, i] = mw[i, c0[i]]
        cw[1, i] = mw[i, c0[i] + 1]
    return c0, cw


def tail_operands(h0: int, w0: int, H: int, W: int, device) -> Dict[str, torch.Tensor]:
    j0, wy = _tail_row_mix(h0, H)
    c0, cw = _tail_col_mix(w0, W)
    return {k: torch.as_tensor(v, device=device)
            for k, v in (("tail_j0", j0), ("tail_wy", wy), ("tail_c0", c0), ("tail_cw", cw))}


def stau_apply(m: STAUpsample, x: torch.Tensor, scale: Scale, st_feat: torch.Tensor,
               statics: Optional[Dict[str, torch.Tensor]] = None,
               fast: bool = False) -> torch.Tensor:
    """STA filtering + fused STAU sampler on [B, C, h, w] -> [B, C, H, W].
    ``statics`` (SAVSR.stau_statics) hoists the coordinate head; ``fast``
    the fast tier's head and kernels."""
    b, c, h, w = x.shape
    x, st_feat = x.contiguous(), st_feat.contiguous()
    if statics is None:
        head = _stau_head(m, h, w, scale, x.dtype, x.device, fast=fast)
        pix = stau_sampler_planes(head, scale, h, w)
    else:
        pix = statics["pix"]
    kc = m.kernel_conv[0]
    sta = (sta_conv_fused_fast if fast else sta_conv_fused)(x, st_feat, kc.weight, kc.bias)
    return (stau_upsample_fused_fast if fast else stau_upsample_fused)(
        x, sta, pix, m.weight_compress, m.weight_expand, m.fusion.weight, m.fusion.bias,
        plan=None if statics is None else statics["stau_plan"])


def tail_fused_apply(tail: nn.Conv2d, sr: torch.Tensor, x_center: torch.Tensor,
                     statics: Optional[Dict[str, torch.Tensor]] = None,
                     fast: bool = False) -> torch.Tensor:
    """Tail conv + bilinear centre-frame skip: [B, C, H, W] -> [B, 3, H, W]
    (``fast``: the fast kernel)."""
    H, W = sr.shape[2:]
    h0, w0 = x_center.shape[2:]
    ops = statics if statics is not None else tail_operands(h0, w0, H, W, sr.device)
    return (tail_fused_fast if fast else tail_fused)(
        sr, x_center.contiguous(), ops["tail_j0"], ops["tail_wy"], ops["tail_c0"],
        ops["tail_cw"], tail.weight, tail.bias)


# ---------------------------------------------------------------------------
# top level
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SAVSRConfig:
    num_in_ch: int = 3
    num_feat: int = 64
    num_frame: int = 7
    slid_win: int = 3
    fusion_win: int = 5
    interval: int = 0
    w1_num_block: int = 4
    w2_num_block: int = 2
    n_resgroups: int = 4
    n_resblocks: int = 8
    center_frame_idx: Optional[int] = None
    # the serving tier with f32 weights (SAVSR.serving_tier; bf16 weights run
    # the bf16 tier whatever it says): "float32" — true f32, TF32 off, the
    # strict tier; "default" — every product in one bf16 pass with f32 sums,
    # as a TPU runs f32 at default precision: the fast tier (the fast
    # kernels, the heads' operands rounded to bf16). The training engine at
    # f32 and "default" runs the same pass in the forward and the backward
    # (archs/train_engine.py), with TF32 off
    matmul_precision: str = "float32"
    # the serving forward's convs (eval only; training ignores it):
    # "native" — at the weights' dtype; "split" — the split tier: f32
    # weights, features carried between convs as bf16 hi/lo pairs, each conv
    # a 3-pass bf16 contraction with f32 sums (ops/conv.py conv_fused_split),
    # ~2^-16 relative error a conv; needs matmul_precision "float32" (the
    # heads and STA, STAU and the tail stay strict)
    conv_precision: str = "native"
    # training-forward options (archs/train_engine.py). The port has one
    # OSConv training engine, the kernels of ops/osconv.py, so every value
    # of osconv_impl the JAX package accepts selects it (they are one math).
    osconv_impl: str = "einsum"
    # "auto": the training engine iff train=True; "train"/"eval" force one
    engines: str = "auto"
    # torch.utils.checkpoint around each alignment window, each trunk group
    # and the upsampler (remat_train), or around the upsampler only
    # (remat_stau); remat_policy is accepted ("full" | "dots") and both
    # recompute the whole segment
    remat_train: bool = True
    remat_policy: str = "full"
    remat_stau: bool = False
    # "unroll" | "scan": accepted; eager PyTorch runs the same Python loop
    train_loop: str = "unroll"

    @property
    def center(self) -> int:
        return self.num_frame // 2 if self.center_frame_idx is None else self.center_frame_idx

    @property
    def iter_win(self) -> int:
        if self.interval == 0:
            return self.num_frame
        if self.center % 2 == 0:
            return self.center + 1
        return self.center + 2


def frame_sample_indices(num_frame: int, interval: int) -> Tuple[List[int], List[int]]:
    """Static forward/backward frame index lists (savsr_arch.py:638-659)."""
    index = list(range(num_frame))
    if interval == 0:
        return index, index
    center = num_frame // 2
    if center % 2 == 0:
        forward_idx = index[1::(interval + 1)]
        forward_idx.insert(center // 2, center)
        backward_idx = index[::(interval + 1)]
    else:
        forward_idx = index[::(interval + 1)]
        forward_idx.insert(center // 2 + 1, center)
        backward_idx = index[1::(interval + 1)]
        if len(forward_idx) != len(backward_idx):
            backward_idx.append(forward_idx[-1])
            backward_idx.insert(0, forward_idx[0])
    return forward_idx, backward_idx


def pad_spatial(x: torch.Tensor, multiple: int = 2) -> torch.Tensor:
    """Reflect-pad [B, T, C, H, W] so H, W are multiples of ``multiple``
    (OSAdapt's pool/upsample requires it; savsr_arch.py:670-690)."""
    b, t, c, h, w = x.shape
    pad_h = (multiple - h % multiple) % multiple
    pad_w = (multiple - w % multiple) % multiple
    if pad_h == 0 and pad_w == 0:
        return x
    y = torch.nn.functional.pad(x.reshape(b * t, c, h, w), (0, pad_w, 0, pad_h),
                                mode="reflect")
    return y.reshape(b, t, c, h + pad_h, w + pad_w)


def init_weights(model: nn.Module, seed: int = 0) -> None:
    """Seeded initialisation with the reference's distributions (the JAX
    package's ``savsr_init``; the two frameworks draw different numbers from
    one seed): convs and linears kaiming-uniform(a=sqrt 5) with uniform
    biases, the ScaleAttention convs kaiming-normal(fan_out) with zero
    biases, each OSConv bank kernel kaiming-normal(fan_out), the STAU experts
    kaiming-uniform(a=sqrt 5), BatchNorm and gamma at their defaults."""
    import math

    gen = torch.Generator().manual_seed(int(seed))
    init = nn.init
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                init.kaiming_uniform_(m.weight, a=math.sqrt(5), generator=gen)
                if m.bias is not None:
                    bound = 1.0 / math.sqrt(m.weight[0].numel())
                    init.uniform_(m.bias, -bound, bound, generator=gen)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        for m in model.modules():
            if isinstance(m, ScaleAttention):
                for conv in (m.fc, m.channel_fc, m.filter_fc, m.spatial_fc, m.kernel_fc):
                    if conv is not None:
                        init.kaiming_normal_(conv.weight, mode="fan_out", nonlinearity="relu",
                                             generator=gen)
                        if conv.bias is not None:
                            conv.bias.zero_()
            elif isinstance(m, OSConv2d):
                for i in range(m.weight.shape[0]):
                    init.kaiming_normal_(m.weight[i], mode="fan_out", nonlinearity="relu",
                                         generator=gen)
            elif isinstance(m, STAUpsample):
                for bank in (m.weight_compress, m.weight_expand):
                    for i in range(bank.shape[0]):
                        init.kaiming_uniform_(bank[i], a=math.sqrt(5), generator=gen)
        if hasattr(model, "gamma"):
            model.gamma.fill_(1.0)


OSCONV_IMPLS = ("einsum", "grouped", "batchgroup", "taps", "kpatch3", "pallas", "pallas_train")
MATMUL_PRECISIONS = ("float32", "default")


class SAVSR(nn.Module):
    """SAVSR network. ``forward(x [B, T, C, h, w], scale)`` returns
    [B, C, round(h*sh), round(w*sw)]; with ``train=True`` it returns that
    and the BatchNorm running-stat updates of the step."""

    def __init__(self, **kwargs):
        super().__init__()
        kwargs.pop("downsample_scale", None)
        cfg = self.cfg = SAVSRConfig(**{k: v for k, v in kwargs.items()
                                        if v is not None or k == "center_frame_idx"})
        if cfg.osconv_impl not in OSCONV_IMPLS:
            raise ValueError(f"unknown osconv impl {cfg.osconv_impl}")
        if cfg.conv_precision not in ("native", "split"):
            raise ValueError(f"conv_precision {cfg.conv_precision!r} not in ('native', 'split')")
        if cfg.matmul_precision not in MATMUL_PRECISIONS:
            raise ValueError(f"matmul_precision {cfg.matmul_precision!r} not in "
                             f"{MATMUL_PRECISIONS}")
        nf = cfg.num_feat
        self.f2p_win = WindowUnitL1(cfg.num_in_ch, nf, cfg.slid_win, cfg.w1_num_block)
        self.p2f_win = WindowUnitL1(cfg.num_in_ch, nf, cfg.slid_win, cfg.w1_num_block)
        n_l2 = (cfg.iter_win - cfg.fusion_win + 1) // 2
        self.h_win = nn.ModuleList(
            WindowUnitL2(nf, win_size=(cfg.iter_win - cfg.slid_win + 1) - 2 * i,
                         slid_win=cfg.fusion_win, num_block=cfg.w2_num_block)
            for i in range(n_l2))
        self.h_win_conv_h = _conv(2 * nf, nf, 3)
        self.RG = nn.ModuleList(ResidualGroup(nf, cfg.n_resblocks)
                                for _ in range(cfg.n_resgroups))
        self.adapt = nn.ModuleList(OSAdapt(nf) for _ in range(cfg.n_resgroups))
        self.gamma = nn.Parameter(torch.ones(1))
        self.conv_last = _conv(nf, nf, 3)
        self.upsample = STAUpsample(nf)
        self.tail = _conv(nf, cfg.num_in_ch, 3)

    def serving_tier(self, dtype: Optional[torch.dtype] = None) -> str:
        """The serving forward's tier at feature dtype ``dtype`` (default: the
        weights'): "bf16" for bf16; for f32 "strict" (matmul_precision
        float32), "fast" (default) or "split" (conv_precision split, which
        needs float32)."""
        dtype = self.gamma.dtype if dtype is None else dtype
        cfg = self.cfg
        if dtype != torch.float32:
            return "bf16"
        fast = cfg.matmul_precision == "default"
        if cfg.conv_precision == "split":
            if fast:
                raise NotImplementedError(
                    "network_g: conv_precision: split with matmul_precision: default (the "
                    "split convs with default-precision heads and STA, STAU and tail) is not "
                    "ported yet; use matmul_precision: float32")
            return "split"
        return "fast" if fast else "strict"

    def _precision(self, tier: str):
        """The tier's context: TF32 off for fast (its products are the f32
        ops of bf16-rounded operands) and at matmul_precision float32."""
        return float32_precision(tier == "fast" or self.cfg.matmul_precision == "float32")

    @torch.no_grad()
    def stau_statics(self, lq_hw, scale, dtype=torch.float32, device=None):
        """Frame-invariant operands for (LR shape, scale): the STAU
        coordinate-head outputs, the sampler planes, the window plan of the
        STAU kernel that the tier of ``dtype`` runs (``serving_tier``; the
        fast tier's: the bf16 kernel's tile at its fast mode's capacity) and
        the tail's resize rows/columns.
        ``dtype`` must be the forward's feature dtype for the result to equal
        the inline path exactly (and for the plan to fit its kernel)."""
        h, w = int(lq_hw[0]), int(lq_hw[1])
        scale = normalize_scale(scale)
        device = self.gamma.device if device is None else device
        H, W = get_hw(h, w, scale)
        tier = self.serving_tier(dtype)
        with self._precision(tier):
            st = _stau_head(self.upsample, h, w, scale, dtype, device, fast=tier == "fast")
            st["pix"] = stau_sampler_planes(st, scale, h, w)
            st["stau_plan"] = stau_window_plan(st["pix"], h, w,
                                               *plan_geometry(dtype, fast=tier == "fast"))
        st.update(tail_operands(h, w, H, W, device))
        return st

    def forward(self, x: torch.Tensor, scale, stau_statics=None, train: bool = False):
        """Serving forward (no gradients, the kernels of the serving path),
        or with ``train=True`` (or ``cfg.engines == "train"``) the training
        engine: differentiable, BatchNorm on batch statistics when ``train``.
        Training returns ``(sr, stats_updates)``, the updates keyed like the
        state_dict ("adapt.0.mask.1.running_mean", ...)."""
        scale = normalize_scale(scale)
        train_engines = train if self.cfg.engines == "auto" else self.cfg.engines == "train"
        if train and not train_engines:
            raise ValueError("train=True needs the training engine (engines: auto | train)")
        if train_engines:
            from .train_engine import savsr_train_forward

            # f32 at default: every product one bf16 pass, forward and backward
            fast = self.cfg.matmul_precision == "default" and x.dtype == torch.float32
            with float32_precision(fast or self.cfg.matmul_precision == "float32"):
                sr, updates = savsr_train_forward(self, x, scale, train, fast)
            return (sr, updates) if train else sr
        tier = self.serving_tier()
        with self._precision(tier), torch.no_grad():
            return self._forward(x, scale, stau_statics, tier)

    def _forward(self, x, scale: Scale, statics, tier: str) -> torch.Tensor:
        from .chw_engine import trunk_apply_chw, window_l1_apply_chw, window_l2_apply_chw

        cfg = self.cfg
        split, fast = tier == "split", tier == "fast"
        if cfg.conv_precision == "split" and (self.gamma.dtype != torch.float32
                                              or x.dtype != torch.float32):
            raise ValueError(f"conv_precision: split needs f32 weights and input, got "
                             f"{self.gamma.dtype} weights and {x.dtype} input")
        if fast and x.dtype != torch.float32:
            raise ValueError(f"the fast tier (f32 weights, matmul_precision: default) needs "
                             f"f32 input, got {x.dtype}")
        x = x.contiguous()  # the kernels read contiguous channel planes
        b, t, _, h_in, w_in = x.shape
        x_center = x[:, cfg.center]
        x = pad_spatial(x)
        hp, wp = x.shape[3:]
        fwd_idx, bwd_idx = frame_sample_indices(t, cfg.interval)
        x_forward = x[:, fwd_idx] if cfg.interval else x
        x_backward = x[:, bwd_idx] if cfg.interval else x

        n_iter = cfg.iter_win - cfg.slid_win + 1
        half = cfg.slid_win // 2
        if split:  # hidden states start as zero pairs
            zero = x.new_zeros((b, cfg.num_feat, hp, wp), dtype=torch.bfloat16)
            hf = hpf = Pair(zero, zero)
        else:
            hf = x.new_zeros((b, cfg.num_feat, hp, wp))
            hpf = x.new_zeros((b, cfg.num_feat, hp, wp))
        hf_seq, hp_seq = [], []
        # sequential bidirectional propagation (reference savsr_arch.py:708-719)
        for idx in range(n_iter):
            it_b = x_backward[:, cfg.iter_win - 1 - 2 * half - idx: cfg.iter_win - idx]
            it_f = x_forward[:, idx: idx + cfg.slid_win]
            hf = window_l1_apply_chw(self.f2p_win, it_b, hf, scale, hp, wp, fast)
            hpf = window_l1_apply_chw(self.p2f_win, it_f, hpf, scale, hp, wp, fast)
            hf_seq.append(hf)
            hp_seq.append(hpf)
        # f2p outputs were produced from the future end backwards; each hidden
        # pair stays two channel parts (no concat copy)
        h_feat = [[hf_seq[n_iter - 1 - i], hp_seq[i]] for i in range(n_iter)]
        for unit in self.h_win:
            h_feat = window_l2_apply_chw(unit, h_feat, scale, hp, wp, fast)
        h_feat, align_feat = trunk_apply_chw(self, h_feat[0], scale, hp, wp, fast)

        # arbitrary-scale upsampling on the un-padded region
        sr = stau_apply(self.upsample, h_feat[:, :, :h_in, :w_in], scale,
                        align_feat[:, :, :h_in, :w_in], statics, fast)
        return tail_fused_apply(self.tail, sr, x_center, statics, fast)
