#!/usr/bin/env python3
"""Where the time of the port's bf16 STAU and tail kernels goes: each kernel
built again with one part switched off, timed at the serving shape on one
CUDA card.

    python3 scripts/torch_kernel_variants.py [--out FILE]

A variant is a text edit of a copy of ``savsr_tpu_torch/csrc/<kernel>.cu``
in a temporary directory (the edit must match the source, or the script
stops), built with the package's nvcc flags and called through the
package's wrapper at 8 windows of 180x320 LR, x4, C = 64 (STAU with the
flagship weights' window plan), back-to-back between CUDA events as
``chip_smoke.py`` times every kernel. The variants compute wrong results:
their error against the plain version is printed only to show which part
was switched off. The time a variant saves is an upper bound on what that
part costs, since the parts overlap.
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

# mma.sync replaced by one cheap dependent operation on its inputs
NO_MMA = ('#include "hopper.cuh"\n',
          '#include "hopper.cuh"\n#define mma_m16n8k16_bf16(d, a, b0, b1) '
          '(d[0] += __uint_as_float((a[0] ^ b0 ^ b1) & 0x3f800000u))\n')
VARIANTS = {
    "stau": {
        "full": [],
        "no bilinear taps": [("    if (!ok[t]) continue;", "    if (true) continue;")],
        "no staging copies": [("    if (p.nrf == 0) return;\n    const long long off",
                               "    if (true) return;\n    const long long off")],
        "no mma.sync": [NO_MMA],
        "no pix loads": [
            ("    fy[i] = live[i] ? pix[2 * HW + pbase + px[i]] : 0.f;\n"
             "    fx[i] = live[i] ? pix[3 * HW + pbase + px[i]] : 0.f;",
             "    fy[i] = Y * 0.25f;\n    fx[i] = px[i] * 0.25f;"),
            ("    fy[i] = live[i] ? pix[pbase + px[i]] : 0.f;\n"
             "    fx[i] = live[i] ? pix[HW + pbase + px[i]] : 0.f;",
             "    fy[i] = Y * 0.25f;\n    fx[i] = px[i] * 0.25f;"),
            ("        r[e] = live[hf] && e < NE ? pix[(4 + e) * HW + pbase + px[hf]] : 0.f;",
             "        r[e] = 0.25f;")],
        "no output stores": [
            ("        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);",
             "        if (src[0] == __float2bfloat16_rn(12345.f))\n"
             "          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);")],
    },
    "tail": {
        "full": [],
        "no mma.sync": [NO_MMA],
        "no skip loads": [("      skip_load(sk, xcb, h0, w0);\n      skip_rows(sk, y + 4, H, rj0, rwy);",
                           "")],
        "no output stores": [
            ("        out[((long long)b * 3 + k) * HW + (long long)(y + r) * W + x] =",
             "        if (v == 12345.f) out[((long long)b * 3 + k) * HW + (long long)(y + r) * W + x] =")],
    },
}


def build_variants(tmp: str) -> dict:
    """Compile every variant at once; {(kernel, variant): library path}."""
    from savsr_tpu_torch.csrc import build

    procs = {}
    for kern, variants in VARIANTS.items():
        src = open(os.path.join(build.CSRC_DIR, f"{kern}.cu")).read()
        for i, (name, edits) in enumerate(variants.items()):
            text = src
            for old, new in edits:
                if old not in text:
                    raise AssertionError(f"{kern} / {name}: the edit no longer matches the source")
                text = text.replace(old, new)
            path = os.path.join(tmp, f"{kern}_{i}.cu")
            with open(path, "w") as f:
                f.write(text)
            lib = path[:-3] + ".so"
            procs[(kern, name)] = (lib, subprocess.Popen(
                [build.nvcc_path(), *build.NVCC_FLAGS, "-I", build.CSRC_DIR, "-o", lib, path],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log[-3000:]}")
        libs[key] = lib
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=None, help="also write the times here as JSON")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import chip_smoke as cs
    from savsr_tpu_torch.archs.savsr_arch import SAVSR
    from savsr_tpu_torch.inference import flagship_net_kwargs
    from savsr_tpu_torch.ops import stau, tail
    from savsr_tpu_torch.utils.convert import load_into

    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    device = torch.device("cuda")
    rng = np.random.default_rng(0)
    b, c, (h, w) = cs.WINDOWS, 64, cs.LR_HW
    H, W = cs.get_hw(h, w, cs.SCALE)
    model = SAVSR(**flagship_net_kwargs()).eval()
    load_into(model, {k: torch.from_numpy(v) for k, v in
                      np.load(os.path.join(cs.GOLDENS, "savsr_state_dict.npz")).items()})
    model.to(device)
    with cs.float32_precision(True):
        st = model.stau_statics(cs.LR_HW, cs.SCALE, device=device)
    up, bf = model.upsample, torch.bfloat16
    calls = {
        "stau": (stau, "stau_upsample_fused", (
            cs._rand(rng, (b, c, h, w), bf, device), cs._rand(rng, (b, c, h, w), bf, device),
            st["pix"], up.weight_compress.to(bf), up.weight_expand.to(bf), up.fusion.weight.to(bf),
            up.fusion.bias), {"plan": st["stau_plan"]}),
        "tail": (tail, "tail_fused", (
            cs._rand(rng, (b, c, H, W), bf, device),
            torch.from_numpy(rng.random((b, 3, h, w)).astype(np.float32)).to(device, bf),
            *(cs.tail_operands(h, w, H, W, device)[k]
              for k in ("tail_j0", "tail_wy", "tail_c0", "tail_cw")),
            cs._rand(rng, (3, c, 3, 3), bf, device, 0.1), cs._rand(rng, (3,), bf, device, 0.1)),
            {}),
    }
    results = []
    with tempfile.TemporaryDirectory() as tmp, torch.no_grad():
        libs = build_variants(tmp)
        for kern, (mod, fn_name, fn_args, kw) in calls.items():
            real = mod._lib()
            fn = getattr(mod, fn_name)
            want = getattr(mod, fn_name + "_plain")(*fn_args).float()
            for name in VARIANTS[kern]:
                lib = ctypes.CDLL(libs[(kern, name)])
                for sym in ("savsr_error_string", f"savsr_{kern}_fused", f"savsr_{kern}_mma"):
                    getattr(lib, sym).argtypes = getattr(real, sym).argtypes
                    getattr(lib, sym).restype = getattr(real, sym).restype
                mod._lib = lambda lib=lib: lib
                err = float((fn(*fn_args, **kw).float() - want).abs().max())
                ms = cs.timed_ms(lambda: fn(*fn_args, **kw), device)
                print(f"[variants] {kern} {name:20s} ms {ms:.4f} (max abs err {err:.3e})",
                      flush=True)
                results.append({"kernel": kern, "variant": name, "ms": ms, "max_abs_err": err})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "variants": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
