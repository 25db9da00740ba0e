#!/usr/bin/env python3
"""Whether the card checks of the fast STAU and the fast tail reject a
kernel whose rounding point is misplaced for every value, on one CUDA card.

    python3 scripts/fast_fault_check.py [--out FILE]

The two fast kernels that round values inside (csrc/stau.cu
``stau_mma_kernel<CB, true>``, csrc/tail.cu ``tail_f32_kernel<true>``) are
held against their plain versions with a max abs bound of one bf16 ulp of
the output's scale and a mean abs bound of 1e-5 of it (``chip_smoke.py``
FAST_INNER_TOL / FAST_INNER_MEAN_TOL, ``tests/test_torch_cuda.py -k fast``).
This script builds each kernel again with one fault planted, as a text edit
of a copy of its source in a temporary directory (built as
``scripts/torch_kernel_variants.py`` builds its variants):

- tail: sr left unrounded as it is loaded (the conv's f32 operand, where
  the TPU kernel's one bf16 pass rounds it);
- STAU: f0 rounded to bf16 in the residual fea = f0 + STK We^T (the TPU
  kernel keeps it f32 there and rounds it only where it meets the compress).

For the package's kernels and for each fault it runs chip_smoke.py's phase
11 case of that kernel (8 windows of 180x320 LR, x4, C = 64, the flagship
weights) and the card tests of that kernel (every shape of
``test_fast_stau_*`` / ``test_fast_tail_*``), and prints per run the max
and mean abs error against the plain version, whether the max bound alone
would pass it, and whether the checks pass. It exits 0 when the package's
kernels pass every check and each fault fails chip_smoke.py's case and
every card test.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

FAULTS = {
    "tail": {"sr left unrounded as loaded": [
        ("    if constexpr (ROUND) {\n      a = make_float4(",
         "    if constexpr (false) {\n      a = make_float4(")]},
    "stau": {"f0 rounded to bf16 in the residual": [
        ("              pack_bf16x2(e[j][2 * hf] + f[2 * j], e[j][2 * hf + 1] + f[2 * j + 1]);",
         "              pack_bf16x2(e[j][2 * hf] +\n"
         "                              __bfloat162float(__float2bfloat16_rn(f[2 * j])),\n"
         "                          e[j][2 * hf + 1] +\n"
         "                              __bfloat162float(__float2bfloat16_rn(f[2 * j + 1])));")]},
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=None, help="also write the results here as JSON")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import chip_smoke as cs
    import test_torch_cuda as tc
    from torch_kernel_variants import build_variants
    from savsr_tpu_torch.archs.savsr_arch import SAVSR
    from savsr_tpu_torch.csrc import build
    from savsr_tpu_torch.inference import flagship_net_kwargs
    from savsr_tpu_torch.ops import stau, tail
    from savsr_tpu_torch.utils.convert import load_into

    if not torch.cuda.is_available():
        print("fast_fault_check: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    device = torch.device("cuda")
    model = SAVSR(**flagship_net_kwargs()).eval()
    load_into(model, {k: torch.from_numpy(v) for k, v in
                      np.load(os.path.join(cs.GOLDENS, "savsr_state_dict.npz")).items()})
    model.to(device)
    with cs.float32_precision(True):
        pix = model.stau_statics(cs.LR_HW, cs.SCALE, dtype=torch.float32, device=device)["pix"]
    smoke_case = {
        "stau": lambda: cs.fast_stau_case(np.random.default_rng(11), model, pix, device),
        "tail": lambda: cs.fast_tail_case(np.random.default_rng(11), model, device),
    }
    card_tests = {
        "stau": [(f"test_fast_stau_kernel_matches_plain[{c}]",
                  lambda c=c: tc.test_fast_stau_kernel_matches_plain(device, c))
                 for c in tc.STAU_BF16]
        + [(f"test_fast_stau_kernel_direct_tiles[b{b}-c{c}]",
            lambda b=b, c=c: tc.test_fast_stau_kernel_direct_tiles(device, b, c))
           for b, c in ((1, 64), (8, 32))],
        "tail": [(f"test_fast_tail_kernel_matches_plain[{c}]",
                  lambda c=c: tc.test_fast_tail_kernel_matches_plain(device, c))
                 for c in tc.TAIL_F32],
    }
    modules = {"stau": stau, "tail": tail}
    results, ok = [], True
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(tmp, build, FAULTS)
        for kern, mod in modules.items():
            real = mod._lib()
            runs = [("package kernel", None)] + [(f, libs[(kern, f)]) for f in FAULTS[kern]]
            for name, path in runs:
                saved = mod._lib
                if path is not None:
                    lib = ctypes.CDLL(path)
                    for sym in dir(real):
                        if sym.startswith("savsr_"):
                            getattr(lib, sym).argtypes = getattr(real, sym).argtypes
                            getattr(lib, sym).restype = getattr(real, sym).restype
                    mod._lib = lambda lib=lib: lib
                try:
                    with cs.float32_precision(True):  # the plain versions run true f32
                        with torch.no_grad():
                            row = smoke_case[kern]()
                        failed_tests = []
                        for test, fn in card_tests[kern]:
                            try:
                                fn()
                            except AssertionError as e:
                                failed_tests.append(f"{test}: {str(e).splitlines()[0][:80]}")
                finally:
                    mod._lib = saved
                max_only = row["max_abs_err"] <= cs.FAST_INNER_TOL * row["max_abs_plain"]
                planted = path is not None
                want = not planted
                good = (row["ok"] == want and
                        (not failed_tests if want else len(failed_tests) == len(card_tests[kern])))
                ok = ok and good
                print(f"[fault] {kern} {name:36s} max abs {row['max_abs_err']:.3e} "
                      f"(bound {cs.FAST_INNER_TOL * row['max_abs_plain']:.3e}: "
                      f"{'passes' if max_only else 'fails'}) mean abs {row['mean_abs_err']:.3e} "
                      f"(bound {cs.FAST_INNER_MEAN_TOL * row['max_abs_plain']:.3e}); chip_smoke "
                      f"case {'passes' if row['ok'] else 'fails'}; card tests failed "
                      f"{len(failed_tests)} of {len(card_tests[kern])} -> "
                      f"{'as expected' if good else 'NOT AS EXPECTED'}", flush=True)
                for t in failed_tests:
                    print(f"[fault]     {t}", flush=True)
                results.append({"kernel": kern, "run": name, "planted": planted,
                                "max_abs_err": row["max_abs_err"],
                                "mean_abs_err": row["mean_abs_err"],
                                "max_abs_plain": row["max_abs_plain"],
                                "max_bound_alone_passes": max_only, "smoke_ok": row["ok"],
                                "card_tests": len(card_tests[kern]),
                                "card_tests_failed": failed_tests, "as_expected": good})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "runs": results}, f, indent=1)
    print(f"[fault] {'ok' if ok else 'FAILED'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
