#!/usr/bin/env python3
"""Which serving kernels compute a band's rows to the bit as they compute
the whole frame's: each kernel of each tier (and the OSAdapt mask head's
library convs and the GAP's row sums) on a seeded frame, then on each
band's rows with the rows beyond them that the spatial path gives it
(savsr_tpu_torch/parallel/spatial.py: a conv's halo row, STA's 2 rows, the
STAU window, the tail's extra HR row), the band's output rows held against
the whole frame's. No ranks: one process on one device.

    python3 scripts/torch_band_invariance.py [--hw 540 960] [--bands 4]
        [--scale 4 4] [--device cuda]

Prints, per kernel and tier, the max abs difference over all bands (0:
bit-equal). Where a sharded forward differs from one process (PERF.md PR
18), the kernels that print a difference here are where its sums follow
the frame's height.
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from savsr_tpu_torch.archs.arch_util import upsample_bilinear_2x  # noqa: E402
from savsr_tpu_torch.inference import build_serving_model  # noqa: E402
from savsr_tpu_torch.ops.conv import (conv_fused, conv_fused_fast, conv_fused_split,  # noqa: E402
                                      pair_merge, pair_split)
from savsr_tpu_torch.ops.sta import sta_conv_fused, sta_conv_fused_fast  # noqa: E402
from savsr_tpu_torch.ops.stau import stau_upsample_fused, stau_upsample_fused_fast  # noqa: E402
from savsr_tpu_torch.ops.tail import tail_fused, tail_fused_fast  # noqa: E402
from savsr_tpu_torch.parallel import spatial  # noqa: E402
from savsr_tpu_torch.parallel.spatial import BandGroup  # noqa: E402
from savsr_tpu_torch.utils.convert import load_into  # noqa: E402

TIERS = ("strict", "bf16", "split", "fast")


def rows_of(t, lo, hi):
    """Rows [lo, hi) of t (dim 2), zeros for rows outside it (the convs'
    padding)."""
    a, b = max(lo, 0), min(hi, t.shape[2])
    return F.pad(t[:, :, a:b], (0, 0, a - lo, hi - b))


def conv_of(tier, weight, bias, parts: int):
    """The tier's conv of ``parts`` equal channel parts of its input by
    ``weight`` (shared or per sample; ReLU epilogue), f32 out."""
    def run(t):
        xs = list(t.chunk(parts, dim=1))
        if tier == "split":
            return pair_merge(conv_fused_split([pair_split(p) for p in xs], weight, bias,
                                               lrelu=(0.5, 0.5)))
        if tier == "fast":
            return conv_fused_fast(xs, weight, bias, lrelu=(0.5, 0.5))
        w = weight.to(t.dtype).contiguous() if weight.dim() == 5 else weight
        return conv_fused(xs, w, bias, lrelu=(0.5, 0.5)).float()
    return run


def diff(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--hw", type=int, nargs=2, default=[540, 960])
    ap.add_argument("--bands", type=int, default=4)
    ap.add_argument("--scale", type=float, nargs=2, default=[4.0, 4.0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true", help="the small config (rehearsal)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    print(cs.card_name(), flush=True)
    if device.type == "cuda":
        cs.build.build_all()  # every kernel library at once
    net = cs.SMALL_CFG if args.small else cs.flagship_net_kwargs()
    sd = dict(np.load(os.path.join(cs.GOLDENS, "savsr_small_state.npz" if args.small
                                   else "savsr_state_dict.npz")))
    h, w = args.hw
    hp, scale = h + h % 2, tuple(args.scale)
    lr = spatial.band_rows(hp, args.bands)
    rng = np.random.default_rng(4)
    for tier in TIERS:
        dt = torch.bfloat16 if tier == "bf16" else torch.float32
        model = build_serving_model(tier, net)
        load_into(model, {k: torch.from_numpy(v) for k, v in sd.items()})
        model.to(device=device, dtype=dt)
        c = model.cfg.num_feat

        def feat(hh, ww, ch=c):
            return torch.from_numpy(rng.standard_normal((1, ch, hh, ww), np.float32)).to(
                device, dt)

        out = {}
        with model._precision(tier), torch.no_grad():
            x = feat(hp, w)
            blk = model.f2p_win.blocks
            agg = torch.from_numpy(rng.standard_normal((1,) + blk[1].osconv.weight.shape[1:],
                                                       np.float32) * 0.02).to(device)
            for name, (wt, bias, parts) in {
                    "conv3x3": (model.RG[0].residual_group[0].rcab[0].weight,
                                model.RG[0].residual_group[0].rcab[0].bias, 1),
                    "conv3x3 3 parts (merge)": (model.f2p_win.merge.weight,
                                                model.f2p_win.merge.bias, 3),
                    "conv1x1 3 parts": (blk[0].conv1.weight, blk[0].conv1.bias, 3),
                    "osconv per-sample 3 parts": (agg, None, 3)}.items():
                run = conv_of(tier, wt, bias, parts)
                xi = x if parts == 1 else feat(hp, w, wt.shape[-3])
                whole = run(xi)
                out[name] = max(diff(run(rows_of(xi, a - 1, b + 1))[:, :, 1:-1],
                                     whole[:, :, a:b]) for a, b in lr)
            mask = model.adapt[0].mask
            c2 = mask[0].out_channels
            for i, name in ((0, "mask conv 64->16"), (4, "mask conv 16->16 (half)"),
                            (11, "mask conv 16->1")):
                xi = x if i == 0 else feat(hp // 2, w // 2, c2) if i == 4 else feat(hp, w, c2)
                wt = mask[i].weight.to(dt)
                whole = F.conv2d(xi, wt, padding=1)
                bands = [(a // 2, b // 2) for a, b in lr] if i == 4 else lr
                out[name] = max(diff(F.conv2d(rows_of(xi, a - 1, b + 1), wt,
                                              padding=1)[:, :, 1:-1], whole[:, :, a:b])
                                for a, b in bands)
            # the mask head's bilinear x2 (a dense matrix product) on a band
            # and the 4 half rows beyond it, as the head runs it
            xi = feat(hp // 2, w // 2, c2)
            whole = upsample_bilinear_2x(xi)
            d = 0.0
            for a, b in lr:
                lo, hi = max(a // 2 - 4, 0), min(b // 2 + 4, hp // 2)
                y = upsample_bilinear_2x(xi[:, :, lo:hi])
                d = max(d, diff(y[:, :, a - 2 * lo:b - 2 * lo], whole[:, :, a:b]))
            out["mask upsample x2"] = d
            whole = x.sum(dim=3, dtype=torch.float32)
            out["row sums"] = max(diff(rows_of(x, a - 1, b + 1)[:, :, 1:-1].sum(
                dim=3, dtype=torch.float32), whole[:, :, a:b]) for a, b in lr)

            xs, st = feat(h, w), feat(h, w)
            kc = model.upsample.kernel_conv[0]
            sta_fn = sta_conv_fused_fast if tier == "fast" else sta_conv_fused
            sta = sta_fn(xs, st, kc.weight, kc.bias)
            d = 0.0
            for a, b in spatial.crop_rows(lr, h):  # the band and 2 rows, none off the frame
                lo, hi = max(a - 2, 0), min(b + 2, h)
                y = sta_fn(xs[:, :, lo:hi].contiguous(), st[:, :, lo:hi].contiguous(), kc.weight,
                           kc.bias)
                d = max(d, diff(y[:, :, a - lo:b - lo], sta[:, :, a:b]))
            out["sta"] = d

            statics = model.stau_statics((h, w), scale, dtype=dt, device=device)
            up = model.upsample
            stau_fn = stau_upsample_fused_fast if tier == "fast" else stau_upsample_fused
            whole = stau_fn(xs, sta, statics["pix"], up.weight_compress, up.weight_expand,
                            up.fusion.weight, up.fusion.bias, plan=statics["stau_plan"])
            tail_fn = tail_fused_fast if tier == "fast" else tail_fused

            def tail_args(o):
                return (o["tail_j0"], o["tail_wy"], o["tail_c0"], o["tail_cw"],
                        model.tail.weight, model.tail.bias)

            xc = torch.from_numpy(rng.random((1, 3, h, w), np.float32)).to(device, dt)
            tail_whole = tail_fn(whole.contiguous(), xc, *tail_args(statics))
            d_stau = d_tail = 0.0
            for index in range(args.bands):
                bs = model.stau_statics((h, w), scale, dtype=dt, device=device,
                                        band=BandGroup(index, args.bands,
                                                       tuple(range(args.bands))))["band"]
                (e0, e1), (l0, l1) = bs["hr_ext"], bs["windows"][index]
                y = stau_fn(xs[:, :, l0:l1].contiguous(), sta[:, :, l0:l1].contiguous(),
                            bs["pix"], up.weight_compress, up.weight_expand, up.fusion.weight,
                            up.fusion.bias, plan=bs["stau_plan"])
                d_stau = max(d_stau, diff(y, whole[:, :, e0:e1]))
                y0, y1 = bs["hr"][index]
                t = tail_fn(whole[:, :, e0:e1].contiguous(), xc, *tail_args(bs))
                d_tail = max(d_tail, diff(t[:, :, y0 - e0:y1 - e0], tail_whole[:, :, y0:y1]))
            out["stau"], out["tail"] = d_stau, d_tail
        print(f"[band-invariance] {tier} {h}x{w} x{scale[0]}x{scale[1]}, {args.bands} bands "
              f"{lr}: max abs band - whole " + "; ".join(f"{k} {v:.3e}" for k, v in out.items()),
              flush=True)
        del model
    return 0


if __name__ == "__main__":
    sys.exit(main())
