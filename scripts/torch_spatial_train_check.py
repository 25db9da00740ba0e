#!/usr/bin/env python3
"""Phases 1 and 14 of chip_smoke.py alone, on one NVIDIA GPU: the kernels'
build, then spatially sharded training (two ranks over gloo on cuda:0
under torch.distributed.run, mesh {spatial: 2}: the flagship's strict f32
step at accum 1 and 2 on four seeded 60x60 septuplets at x4 against the
one-process step; the training CLI on the shipped bf16 recipe for 2
iterations, resumed to 4).

    python3 scripts/torch_spatial_train_check.py [--seeds N ...] [--parity-only]

``--seeds``: take the parity step (a) on the batch of each seed in turn
(default: phase 14's, ``SPATIAL_TRAIN_SEED``); ``--parity-only``: leave out
the CLI (b). A quicker check than the whole smoke run after a change to
the spatially sharded training path (parallel/spatial.py's differentiable
exchanges, the training engine's band path, the band's loss share); exits
non-zero on any failure.
"""

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seeds", type=int, nargs="+", default=[cs.SPATIAL_TRAIN_SEED])
    ap.add_argument("--parity-only", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_spatial_train_check: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    print(cs.card_name(), flush=True)
    t0 = time.perf_counter()
    cs.phase_build()
    sd = dict(np.load(os.path.join(cs.GOLDENS, "savsr_state_dict.npz")))
    for seed in args.seeds:
        cs.spatial_train_parity(sd, device, seed=seed)
        torch.cuda.empty_cache()
    if not args.parity_only:
        cs.spatial_train_cli(device)
    print(f"torch_spatial_train_check: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
