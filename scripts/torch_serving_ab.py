#!/usr/bin/env python3
"""The bf16 conv (rows 1-2), STA, STAU and tail kernels of the PyTorch port
(savsr_tpu_torch) and the serving forward's device time, for one or more
checkouts of the repo, on one CUDA card; with ``--tier`` also another tier's
kernels and forward: ``strict`` (or ``--strict``) the f32 conv kernels and
the strict tier's forward, ``split`` the split convs and the split forward,
``fast`` the fast convs and the fast forward.

    python3 scripts/torch_serving_ab.py [--tier strict split fast] [--out FILE] ROOT [ROOT ...]

Each ROOT is a checkout of the repo (this one, or a ``git archive`` of
another commit unpacked into a directory; it needs ``savsr_tpu_torch/`` and
``chip_smoke.py``). They run one after another, each in a process of its own
that imports that checkout's package and builds its kernels, so an A/B in
one call reads ``A B B A``. The flagship weights come from this checkout's
``tests/goldens/savsr_state_dict.npz`` for every ROOT.

Per checkout:

- the checkout's own ``chip_smoke.conv_case`` of rows 1-2's headline cases
  (3x3 64->64, 1x1 3x64->64), ``chip_smoke.sta_case``, ``chip_smoke.stau_case`` and
  ``chip_smoke.tail_case`` in bf16 at the serving shape (8 windows of 180x320 LR, x4, C = 64): the
  kernel against its plain version, ``ms`` from back-to-back calls between
  CUDA events (the method of every kernel row of chip_smoke.py), the plain
  version's and the library call's times, and the bound;
- the serving profile, as ``chip_smoke.phase_profile`` takes it: one bf16
  forward of 8 windows unprofiled (median of 3) and under torch.profiler,
  its device busy time and the device time of the bf16 conv, STA, STAU and
  tail kernels;
- with ``--strict``: the f32 ``sta_case``, ``stau_case`` and ``tail_case``
  rows (the strict tier's CUDA-core STA, STAU and tail kernels, STAU on the
  f32 statics' sampler planes; the tail's library call with TF32 off),
  every ``chip_smoke.CONV_CASES`` row in f32 (the
  checkout's own ``chip_smoke.conv_case``: kernel against plain version,
  back-to-back ms, ``F.conv2d`` with TF32 off, bound), and the same profile
  of one strict-tier (f32) forward of 8 windows, with the device time of
  the f32 conv kernels (``conv_f32_kernel`` and its reduce pass, or an older
  checkout's ``conv_fused_kernel``) and of the STA, STAU and tail kernels;
- with ``--tier split`` / ``fast``: every ``chip_smoke.SPLIT_CASES`` /
  ``FAST_CASES`` row (the checkout's own ``split_conv_case`` /
  ``fast_conv_case``) and the profile of one forward of 8 windows at that
  tier, with the device time of its conv kernels and of PyTorch's copy
  kernels; ``fast`` also the fast STA and STAU rows (``fast_sta_case``,
  ``fast_stau_case``) and the fast forward's deviation PSNR against the
  strict forward on the parity cell (the 45x80 golden input at x4,
  x(1.5, 3.5), x3.05), as ``chip_smoke.fast_parity`` takes it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(HERE, "tests", "goldens", "savsr_state_dict.npz")


def profile(cs, model, device, dtype) -> dict:
    """One serving forward of cs.WINDOWS windows in ``dtype``: unprofiled
    ms, device busy ms, and device ms by kernel (STA, STAU, tail, the f32
    conv)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile as prof_

    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.random((cs.WINDOWS, 7, 3) + cs.LR_HW, dtype=np.float32)).to(
        device, dtype)
    statics = model.stau_statics(cs.LR_HW, cs.SCALE, dtype=dtype, device=device)
    fwd_ms = cs.timed_ms(lambda: model(x, cs.SCALE, stau_statics=statics), device, reps=3, iters=1)
    with prof_(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model(x, cs.SCALE, stau_statics=statics)
        torch.cuda.synchronize()
    rows = cs.device_rows(prof)
    kernels = {cs.short_name(name): ms for name, ms, _ in rows
               if cs.short_name(name).startswith(("sta", "tail", "conv_f32", "conv_fused",
                                                  "conv_wgmma", "conv_fast", "conv_split"))}
    f32 = [(ms, n) for name, ms, n in rows
           if cs.short_name(name).startswith(("conv_f32", "conv_fused"))]
    tc = [(ms, n) for name, ms, n in rows
          if cs.short_name(name).startswith(("conv_wgmma", "conv_fast", "conv_split"))]
    copies = [(ms, n) for name, ms, n in rows if "copy" in name.lower()]
    return {"forward_ms": fwd_ms, "device_ms": sum(r[1] for r in rows), "kernels": kernels,
            "f32_conv_ms": sum(ms for ms, _ in f32), "f32_conv_launches": sum(n for _, n in f32),
            "tc_conv_ms": sum(ms for ms, _ in tc), "tc_conv_launches": sum(n for _, n in tc),
            "copy_ms": sum(ms for ms, _ in copies), "copy_launches": sum(n for _, n in copies)}


HEADLINES = ("conv0 64->64 lrelu", "conv1 3x64->64 lrelu")
PARITY_SCALES = (("y", (4.0, 4.0)), ("y_1.5_3.5", (1.5, 3.5)), ("y_3.05_3.05", (3.05, 3.05)))


def fast_db(cs, build_serving_model, load_into, sd, device) -> dict:
    """The fast forward's deviation PSNR against the strict forward on the
    parity cell, per scale."""
    import numpy as np
    import torch

    g = np.load(os.path.join(HERE, "tests", "goldens", "savsr_realsize_forward.npz"))
    x = torch.from_numpy(g["x"]).to(device)
    outs = {}
    for tier in ("fast", "strict"):
        model = build_serving_model(tier)
        load_into(model, sd)
        model.to(device)
        for key, scale in PARITY_SCALES:
            statics = model.stau_statics(x.shape[-2:], scale, dtype=torch.float32, device=device)
            outs[tier, key] = model(x, scale, stau_statics=statics).float().cpu().numpy()
        del model
        torch.cuda.empty_cache()
    return {key: cs.deviation_psnr(outs["fast", key], outs["strict", key])
            for key, _ in PARITY_SCALES}


def child(root: str, out_path: str, tiers) -> None:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from savsr_tpu_torch.archs.savsr_arch import SAVSR
    from savsr_tpu_torch.csrc import build
    from savsr_tpu_torch.inference import build_serving_model, flagship_net_kwargs
    from savsr_tpu_torch.utils.convert import load_into

    if not os.path.abspath(cs.__file__).startswith(root + os.sep):
        raise AssertionError(f"imported {cs.__file__}, not the checkout at {root}")

    def log(msg):
        print(f"[{os.path.basename(root)}] {msg}", flush=True)

    build.build_all()
    device = torch.device("cuda")
    sd = {k: torch.from_numpy(v) for k, v in np.load(WEIGHTS).items()}
    model = SAVSR(**flagship_net_kwargs()).eval()
    load_into(model, sd)
    model.to(device)
    rng = np.random.default_rng(0)
    strict = "strict" in tiers
    with cs.float32_precision(True):
        statics = model.stau_statics(cs.LR_HW, cs.SCALE, dtype=torch.float32, device=device)
        rows = [cs.conv_case(rng, *case, torch.bfloat16, device) for case in cs.CONV_CASES
                if case[0] in HEADLINES]
        rows += [cs.sta_case(rng, model, torch.bfloat16, device),
                 cs.stau_case(rng, model, statics, torch.bfloat16, device),
                 cs.tail_case(rng, model, torch.bfloat16, device)]
        if "split" in tiers:
            rows += [cs.split_conv_case(rng, *case, device) for case in cs.SPLIT_CASES]
        if "fast" in tiers:
            rows += [cs.fast_conv_case(rng, *case, device) for case in cs.FAST_CASES]
            rows += [cs.fast_sta_case(rng, model, device),
                     cs.fast_stau_case(rng, model, statics["pix"], device)]
        if strict:
            rows += [cs.sta_case(rng, model, torch.float32, device),
                     cs.stau_case(rng, model, statics, torch.float32, device),
                     cs.tail_case(rng, model, torch.float32, device)]
            rows += [cs.conv_case(rng, *case, torch.float32, device) for case in cs.CONV_CASES]
    del model
    profiles = {}
    for tier in ("bf16",) + tuple(t for t in ("strict", "split", "fast") if t in tiers):
        dtype = torch.bfloat16 if tier == "bf16" else torch.float32
        model = build_serving_model(tier)  # as chip_smoke.phase_profile builds it
        load_into(model, sd)
        model.to(device=device, dtype=dtype)
        prof = profiles[tier] = profile(cs, model, device, dtype)
        del model
        torch.cuda.empty_cache()
        log(f"serving forward {tier}, {cs.WINDOWS} windows {cs.LR_HW[0]}x{cs.LR_HW[1]} x4: "
            f"{prof['forward_ms']:.2f} ms unprofiled, device busy {prof['device_ms']:.2f} ms "
            f"(f32 conv {prof['f32_conv_ms']:.2f} ms in {prof['f32_conv_launches']} launches; "
            f"tensor-core conv {prof['tc_conv_ms']:.2f} ms in {prof['tc_conv_launches']}; "
            f"copies {prof['copy_ms']:.2f} ms in {prof['copy_launches']}); "
            + "; ".join(f"{k} {v:.4f} ms" for k, v in prof["kernels"].items()))
    parity = fast_db(cs, build_serving_model, load_into, sd, device) if "fast" in tiers else None
    if parity:
        log("fast vs strict deviation PSNR on the parity cell: "
            + "; ".join(f"{k} {v:.4f} dB" for k, v in parity.items()))
    with open(out_path, "w") as f:
        json.dump({"root": root, "cases": rows, "profile": profiles["bf16"],
                   "strict_profile": profiles.get("strict"), "profiles": profiles,
                   "fast_db_vs_strict": parity}, f)
    if not all(r["ok"] for r in rows):
        raise AssertionError(f"{root}: a kernel disagrees with its plain version")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("roots", nargs="+", help="checkouts of the repo, run in this order")
    ap.add_argument("--strict", action="store_true",
                    help="also the f32 conv rows and the strict tier's forward (--tier strict)")
    ap.add_argument("--tier", nargs="+", default=[], choices=("strict", "split", "fast"),
                    help="also these tiers' conv rows and forwards")
    ap.add_argument("--out", default=None, help="write every checkout's results here as JSON")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    tiers = sorted(set(args.tier) | ({"strict"} if args.strict else set()))
    if args.child:
        child(os.path.abspath(args.roots[0]), args.child, tiers)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, root in enumerate(args.roots):
            path = os.path.join(tmp, f"{i}.json")
            root = os.path.abspath(root)
            subprocess.run([sys.executable, os.path.abspath(__file__), root, "--child", path]
                           + (["--tier", *tiers] if tiers else []), check=True, cwd=root)
            with open(path) as f:
                results.append(json.load(f))
    for r in results:
        for tier, prof in r["profiles"].items():
            rows = [c for c in r["cases"] if c["dtype"] == tier and c["name"].startswith("conv")]
            print(f"[ab] {r['root']}: {tier} forward device busy {prof['device_ms']:.2f} ms "
                  f"(tensor-core conv {prof['tc_conv_ms']:.2f} ms, copies {prof['copy_ms']:.2f} "
                  f"ms in {prof['copy_launches']}); conv rows ms (library): "
                  + "; ".join(f"{c['case']} {c['ms']:.4f} ({c['library_ms']:.4f})" for c in rows),
                  flush=True)
        by = {c["name"]: c for c in r["cases"] if c["dtype"] == "bf16"}
        print(f"[ab] {r['root']}: sta {by['sta']['ms']:.4f} ms (bound {by['sta']['bound_ms']:.4f}), "
              f"stau {by['stau']['ms']:.4f} ms, tail {by['tail']['ms']:.4f} ms "
              f"(library {by['tail']['library_ms']:.4f}), device busy "
              f"{r['profile']['device_ms']:.2f} ms per forward", flush=True)
        if r.get("fast_db_vs_strict"):
            fast = {c["name"]: c for c in r["cases"] if c["dtype"] == "fast"}
            print(f"[ab] {r['root']}: fast sta {fast['sta_fast']['ms']:.4f} ms, fast stau "
                  f"{fast['stau_fast']['ms']:.4f} ms; fast vs strict dB "
                  + ", ".join(f"{k} {v:.4f}" for k, v in r["fast_db_vs_strict"].items()),
                  flush=True)
        if r["strict_profile"]:
            f32 = [c for c in r["cases"] if c["dtype"] == "f32" and c["name"].startswith("conv")]
            sp = r["strict_profile"]
            print(f"[ab] {r['root']}: strict forward device busy {sp['device_ms']:.2f} ms "
                  f"(f32 conv {sp['f32_conv_ms']:.2f} ms; "
                  + "; ".join(f"{k} {v:.4f} ms" for k, v in sp["kernels"].items()
                              if not k.startswith("conv"))
                  + "); f32 sta / stau / tail rows ms (bound): "
                  + "; ".join(f"{c['name']} {c['ms']:.4f} ({c['bound_ms']:.4f})"
                              for c in r["cases"] if c["dtype"] == "f32"
                              and c["name"] in ("sta", "stau", "tail"))
                  + "; f32 conv rows ms (F.conv2d): "
                  + "; ".join(f"{c['case']} {c['ms']:.4f} ({c['library_ms']:.4f})" for c in f32),
                  flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "runs": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
