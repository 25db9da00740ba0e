#!/usr/bin/env python3
"""Phases 1, 6 and 12 of chip_smoke.py alone, on one NVIDIA GPU: the
kernels' build, the training parity (the small config's strict f32 and
default steps), and the distribution phase (two ranks over gloo on cuda:0:
the flagship's step against one process, the training CLI under
torch.distributed.run with a resume and one rank over NCCL, and the eval of
the shipped Vid4 config's first three datasets against a one-process run of
the same datasets, here in place of phase 9's).

    python3 scripts/torch_dist_check.py

A quicker check than the whole smoke run after a change to the
distributed path (parallel/, utils/dist_util.py, the trainer, the sampler,
the eval's strided loop); exits non-zero on any failure.
"""

import os
import subprocess
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
        print("torch_dist_check: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    cs.phase_build()
    cs.phase_train_parity(device)
    sd = dict(np.load(os.path.join(cs.GOLDENS, "savsr_state_dict.npz")))
    names = [ds["name"] for ds in yaml_load(cs.EVAL_YML)["datasets"].values()]
    names = names[:cs.DIST_EVAL_COUNT]
    with tempfile.TemporaryDirectory() as tmp:
        pth = os.path.join(tmp, "savsr.pth")
        torch.save({"params": {k: torch.from_numpy(v) for k, v in sd.items()}}, pth)
        one = test_pipeline(tmp, ["-opt", cs.eval_config(tmp, pth, names=names),
                                  "--device", "cuda"])
    for name, fn in (("eval", lambda: cs.dist_eval(sd, device, one)),
                     ("parity", lambda: cs.dist_parity(sd, device)),
                     ("cli", lambda: cs.dist_cli(device))):
        t0 = time.perf_counter()
        fn()
        print(f"[dist-check] {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
