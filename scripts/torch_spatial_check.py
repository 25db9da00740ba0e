#!/usr/bin/env python3
"""Phases 1 and 13 of chip_smoke.py alone, on one NVIDIA GPU: the kernels'
build, then spatial sharding of the eval forward (two ranks over gloo on
cuda:0 under torch.distributed.run, mesh {spatial: 2}: the flagship's
forward of one seeded 180x320 window at x4, x(1.5,3.5) and x3.05 in each
tier against one process, and the eval of the shipped Vid4 config's first
three datasets against a one-process run of the same datasets, here in
place of phase 9's).

    python3 scripts/torch_spatial_check.py

A quicker check than the whole smoke run after a change to the spatial
path (parallel/spatial.py, the engine's band mode, the band statics);
exits non-zero on any failure.
"""

import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from savsr_tpu_torch.test import test_pipeline  # noqa: E402
from savsr_tpu_torch.utils.options import yaml_load  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_spatial_check: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    print(cs.card_name(), flush=True)
    t0 = time.perf_counter()
    cs.phase_build()
    sd = dict(np.load(os.path.join(cs.GOLDENS, "savsr_state_dict.npz")))
    names = [ds["name"] for ds in yaml_load(cs.EVAL_YML)["datasets"].values()][
        :cs.DIST_EVAL_COUNT]
    with tempfile.TemporaryDirectory() as tmp:
        pth = os.path.join(tmp, "savsr.pth")
        torch.save({"params": {k: torch.from_numpy(v) for k, v in sd.items()}}, pth)
        one = test_pipeline(tmp, ["-opt", cs.eval_config(tmp, pth, names=names), "--device",
                                  "cuda"])
    torch.cuda.empty_cache()
    cs.phase_spatial(sd, device, one)
    print(f"torch_spatial_check: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
