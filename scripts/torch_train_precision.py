#!/usr/bin/env python3
"""How far one training step's gradients move with the products' precision
and the card's settings: the small config (``chip_smoke.SMALL_CFG``, the
golden weights and batch of ``tests/goldens/savsr_small_grads.npz``), one
Charbonnier loss and backward, at ``matmul_precision`` float32 and default,
on the CPU and on one CUDA card, the card also with cuDNN's TF32 off for the
backward (``SAVSR.forward`` turns it off around the forward only) and with
cuDNN off. Prints, for each pair of runs, the whole gradient's relative L2
distance and the output's max abs difference, then the gradients that the
card moves most at default against the CPU's.

    python3 scripts/torch_train_precision.py
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    import chip_smoke as cs
    from savsr_tpu_torch.archs.savsr_arch import SAVSR
    from savsr_tpu_torch.csrc import build
    from savsr_tpu_torch.utils.convert import load_into

    if not torch.cuda.is_available():
        print("torch_train_precision: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    build.build_all()
    golden = np.load(os.path.join(REPO, "tests", "goldens", "savsr_small_grads.npz"))
    state = {k: torch.from_numpy(v) for k, v in
             np.load(os.path.join(REPO, "tests", "goldens", "savsr_small_state.npz")).items()}

    def step(dev, precision, tf32=True, cudnn=True):
        old = (torch.backends.cudnn.enabled, torch.backends.cudnn.allow_tf32)
        torch.backends.cudnn.enabled, torch.backends.cudnn.allow_tf32 = cudnn, tf32
        try:
            model = SAVSR(**cs.SMALL_CFG, matmul_precision=precision, remat_train=False)
            load_into(model, state)
            model.to(dev).train()
            sr, _ = model(torch.from_numpy(golden["lq"]).to(dev), (2.0, 2.0), train=True)
            loss = torch.sqrt((sr - torch.from_numpy(golden["gt"]).to(dev)) ** 2 + 1e-12).mean()
            loss.backward()
        finally:
            torch.backends.cudnn.enabled, torch.backends.cudnn.allow_tf32 = old
        return (float(loss.detach()), sr.detach().cpu().numpy(),
                {k: p.grad.detach().cpu().numpy() for k, p in model.named_parameters()})

    def l2(a, b):
        num = sum(float(((a[k] - v).astype(np.float64) ** 2).sum()) for k, v in b.items())
        return (num / sum(float((v.astype(np.float64) ** 2).sum()) for v in b.values())) ** 0.5

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    runs = {"cpu default": step(cpu, "default"), "cpu float32": step(cpu, "float32"),
            "card default": step(cuda, "default"), "card float32": step(cuda, "float32"),
            "card default, TF32 off": step(cuda, "default", tf32=False),
            "card float32, TF32 off": step(cuda, "float32", tf32=False),
            "card default, cuDNN off": step(cuda, "default", cudnn=False)}
    for a, (loss, sr, grads) in runs.items():
        print(f"[precision] {a}: loss {loss:.8f}; " + "; ".join(
            f"vs {b} {l2(grads, g):.3e} L2, out {np.abs(sr - y).max():.1e}"
            for b, (_, y, g) in runs.items() if b != a), flush=True)
    ref, card = runs["cpu default"][2], runs["card default"][2]
    f32 = runs["cpu float32"][2]
    rows = sorted(((np.abs(card[k] - v).max() / (np.abs(v).max() + 1e-30),
                    np.abs(f32[k] - v).max() / (np.abs(v).max() + 1e-30), k)
                   for k, v in ref.items()), reverse=True)
    for card_rel, f32_rel, k in rows[:12]:
        print(f"[precision] {k}: card vs CPU at default {card_rel:.2e} of its max; CPU float32 "
              f"vs default {f32_rel:.2e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
