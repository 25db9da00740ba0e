#!/usr/bin/env python3
"""Whether a training batch sits near a ReLU kink that phase 14's bound
would see: chip_smoke's ``kink_check`` (the flagship's strict f32
gradient, golden weights, one process, on the whole batch and on each
half, against the same step with its input moved by a relative 1e-6,
three draws) on the parity batch of each seed (four seeded 60x60
septuplets at x4, ``dist_batch``). A gradient that jumps under such a move
has a ReLU input at 0 behind it, where two sum orders (one process, two
data ranks, two bands) may land on either side; the jump is held against
the parity bound (2e-3 of the gradient's max + 1e-7).

    python3 scripts/gradient_kink_probe.py [--device cuda] [--seeds 12 13]

Prints, per seed, each part's largest move over its bound and where, and
the gradient's run-to-run spread on the device (the whole batch twice);
the last line names the seeds whose every jump is within its bound (phase
14's premise), from which its ``SPATIAL_TRAIN_SEED`` is taken. ~15
gradients a seed: ~20 s on the card (the flagship is too large for a
shared CPU).
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from savsr_tpu_torch.archs.savsr_arch import SAVSR  # noqa: E402
from savsr_tpu_torch.inference import flagship_net_kwargs  # noqa: E402
from savsr_tpu_torch.utils.convert import load_into  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", type=int, nargs="+", default=[cs.SPATIAL_TRAIN_SEED])
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    sd = dict(np.load(os.path.join(cs.GOLDENS, "savsr_state_dict.npz")))
    model = SAVSR(**dict(flagship_net_kwargs(), remat_train=False))
    load_into(model, {k: torch.from_numpy(v) for k, v in sd.items()})
    model.to(device)
    far = []
    for seed in args.seeds:
        batch = cs.dist_batch(cs.DIST_ROWS, cs.DIST_HW, seed)
        worst = cs.kink_check(model, batch, device)
        one = cs.strict_gradients(model, batch["lq"], batch["gt"], device)
        again = cs.strict_gradients(model, batch["lq"], batch["gt"], device)
        spread = max(float(np.abs(again[k] - v).max()) for k, v in one.items())
        parts = {k: (f"{v[0]:.4g}", v[1], f"{v[2]:.3e}", f"{v[3]:.3e}") for k, v in worst.items()}
        print(f"seed {seed}: largest move by part (over its bound, gradient, move, its max) "
              f"{parts}; run-to-run spread {spread:.3e}", flush=True)
        if all(v[0] <= 1.0 for v in worst.values()):
            far.append(seed)
    print(f"every jump within its bound: seeds {far} of {args.seeds}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
