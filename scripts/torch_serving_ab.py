#!/usr/bin/env python3
"""The bf16 STA, STAU and tail kernels of the PyTorch port (savsr_tpu_torch)
and the serving forward's device time, for one or more checkouts of the repo,
on one CUDA card.

    python3 scripts/torch_serving_ab.py [--out FILE] ROOT [ROOT ...]

Each ROOT is a checkout of the repo (this one, or a ``git archive`` of
another commit unpacked into a directory; it needs ``savsr_tpu_torch/`` and
``chip_smoke.py``). They run one after another, each in a process of its own
that imports that checkout's package and builds its kernels, so an A/B in
one call reads ``A B B A``. The flagship weights come from this checkout's
``tests/goldens/savsr_state_dict.npz`` for every ROOT.

Per checkout:

- the checkout's own ``chip_smoke.sta_case``, ``chip_smoke.stau_case`` and
  ``chip_smoke.tail_case`` in bf16 at the serving shape (8 windows of 180x320 LR, x4, C = 64): the
  kernel against its plain version, ``ms`` from back-to-back calls between
  CUDA events (the method of every kernel row of chip_smoke.py), the plain
  version's and the library call's times, and the bound;
- the serving profile, as ``chip_smoke.phase_profile`` takes it: one bf16
  forward of 8 windows unprofiled (median of 3) and under torch.profiler,
  its device busy time and the device time of the STA, STAU and tail
  kernels.
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


def profile(cs, model, device) -> dict:
    """One bf16 serving forward of cs.WINDOWS windows: unprofiled ms, device
    busy ms, and device ms by kernel."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile as prof_

    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.random((cs.WINDOWS, 7, 3) + cs.LR_HW, dtype=np.float32)).to(
        device, torch.bfloat16)
    statics = model.stau_statics(cs.LR_HW, cs.SCALE, dtype=torch.bfloat16, device=device)
    fwd_ms = cs.timed_ms(lambda: model(x, cs.SCALE, stau_statics=statics), device, reps=3, iters=1)
    with prof_(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model(x, cs.SCALE, stau_statics=statics)
        torch.cuda.synchronize()
    rows = cs.device_rows(prof)
    return {"forward_ms": fwd_ms, "device_ms": sum(r[1] for r in rows),
            "kernels": {name: ms for name, ms, _ in rows
                        if cs.short_name(name).startswith(("sta", "tail"))}}


def child(root: str, out_path: str) -> None:
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
    with cs.float32_precision(True):
        statics = model.stau_statics(cs.LR_HW, cs.SCALE, dtype=torch.float32, device=device)
        rows = [cs.sta_case(rng, model, torch.bfloat16, device),
                cs.stau_case(rng, model, statics, torch.bfloat16, device),
                cs.tail_case(rng, model, torch.bfloat16, device)]
    del model
    model = build_serving_model("bf16")  # as chip_smoke.phase_profile builds it
    load_into(model, sd)
    model.to(device=device, dtype=torch.bfloat16)
    prof = profile(cs, model, device)
    log(f"serving forward bf16, {cs.WINDOWS} windows {cs.LR_HW[0]}x{cs.LR_HW[1]} x4: "
        f"{prof['forward_ms']:.2f} ms unprofiled, device busy {prof['device_ms']:.2f} ms; "
        + "; ".join(f"{cs.short_name(k)} {v:.4f} ms" for k, v in prof["kernels"].items()))
    with open(out_path, "w") as f:
        json.dump({"root": root, "cases": rows, "profile": prof}, f)
    if not all(r["ok"] for r in rows):
        raise AssertionError(f"{root}: a kernel disagrees with its plain version")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("roots", nargs="+", help="checkouts of the repo, run in this order")
    ap.add_argument("--out", default=None, help="write every checkout's results here as JSON")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(os.path.abspath(args.roots[0]), args.child)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, root in enumerate(args.roots):
            path = os.path.join(tmp, f"{i}.json")
            root = os.path.abspath(root)
            subprocess.run([sys.executable, os.path.abspath(__file__), root, "--child", path],
                           check=True, cwd=root)
            with open(path) as f:
                results.append(json.load(f))
    for r in results:
        by = {c["name"]: c for c in r["cases"]}
        print(f"[ab] {r['root']}: sta {by['sta']['ms']:.4f} ms (bound {by['sta']['bound_ms']:.4f}), "
              f"stau {by['stau']['ms']:.4f} ms, tail {by['tail']['ms']:.4f} ms "
              f"(library {by['tail']['library_ms']:.4f}), device busy "
              f"{r['profile']['device_ms']:.2f} ms per forward", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "runs": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
