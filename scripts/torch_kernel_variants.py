#!/usr/bin/env python3
"""Where the time of the port's hand-written kernels goes: each kernel built
again with one part switched off, timed at its main-path shape on one CUDA
card.

    python3 scripts/torch_kernel_variants.py [--kernels K [K ...]] [--out FILE]

A variant is a text edit of a copy of ``savsr_tpu_torch/csrc/<source>.cu``
in a temporary directory (the edit must match the source, or the script
stops), built with the package's nvcc flags and called through the
package's wrapper, back-to-back between CUDA events as ``chip_smoke.py``
times every kernel; a variant may instead (or also) set a module attribute
of the wrapper for its call (a launch plan, a tile width). Shapes: STAU and
the tail at 8 windows of 180x320 LR, x4, C = 64 (STAU with the flagship
weights' window plan), bf16; STA at 8 windows of 180x320, C = 64, bf16; the
f32 OSConv weight gradient at 8 x 60x60, 192 -> 64, k = 3, padding 1. The
edited variants compute wrong results: their error against the plain
version is printed only to show which part was switched off. The time a
variant saves is an upper bound on what that part costs, since the parts
overlap.
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
    "sta": {
        "full": [],
        "no wgmma": [("    wgmma_m64nNk16_bf16_rs<C>(acc, a[kb], make_desc(w_tap + kb * C * 32, 128, 256, "
                      "kInterleave),\n                              kb > 0);",
                      "    acc[0] += __uint_as_float(a[kb][0] & 0x3f800000u);")],
        "no x loads in the epilogue": [
            ("      const uint32_t xv = hx[j * HALO * StaCfg<C>::PW + 4 * i];",
             "      const uint32_t xv = 0x3f803f80u;")],
        "no operand loads": [("    sta_fetch<C>(x, st, tl, H, W, sn, hn);",
                              "    if (tile < 0) sta_fetch<C>(x, st, tl, H, W, sn, hn);")],
        "no L2 prefetch of the next tile": [("    if (tile + gridDim.x < ntiles)\n      sta_prefetch",
                                             "    if (tile < 0)\n      sta_prefetch")],
    },
    "osconv_dagg": {
        "full": [],
        "no staging copies": [
            ("      hopper::cp_async4(xd + ci * DG_XP + c,",
             "      if (c < 0) hopper::cp_async4(xd + ci * DG_XP + c,"),
            ("      hopper::cp_async4(gd + o * DG_GP + c,",
             "      if (c < 0) hopper::cp_async4(gd + o * DG_GP + c,")],
        "FMAs of 1 of 3 dx taps": [
            ("                acc[k][m][d] = fmaf(xk, gk, acc[k][m][d]);",
             "                if (d == 0) acc[k][m][d] = fmaf(xk, gk, acc[k][m][d]);")],
        "no reduce": [("  dagg_reduce_kernel<<<blocks < 1024 ? blocks : 1024, THREADS, 0, stream>>>"
                       "(scratch, out, n,\n"
                       "                                                                            "
                       "nparts);\n", "")],
        "1 chunk of 60 rows": {"dagg_chunks": lambda *a: (1, 60)},
        "3 chunks of 20 rows": {"dagg_chunks": lambda *a: (3, 20)},
        "6 chunks of 10 rows": {"dagg_chunks": lambda *a: (6, 10)},
        "10 chunks of 6 rows": {"dagg_chunks": lambda *a: (10, 6)},
    },
}


def _edits(variant):
    return [] if isinstance(variant, dict) else variant


def build_variants(tmp: str, build, variants: dict) -> dict:
    """Compile every variant with edits at once (one nvcc each; a variant
    without edits uses the package's own library); {(kernel, variant):
    library path}."""
    procs = {}
    for kern, vs in variants.items():
        source = "osconv" if kern == "osconv_dagg" else kern
        src = open(os.path.join(build.CSRC_DIR, f"{source}.cu")).read()
        for i, (name, variant) in enumerate(vs.items()):
            edits = _edits(variant)
            if not edits:
                continue
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
    ap.add_argument("--kernels", nargs="+", default=["stau", "tail", "sta", "osconv_dagg"],
                    help="the kernels to vary")
    ap.add_argument("--out", default=None, help="also write the times here as JSON")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import chip_smoke as cs
    from savsr_tpu_torch.archs.savsr_arch import SAVSR
    from savsr_tpu_torch.csrc import build
    from savsr_tpu_torch.inference import flagship_net_kwargs
    from savsr_tpu_torch.ops import osconv, sta, stau, tail
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
    kc = up.kernel_conv[0]
    tb, th, tw = cs.TRAIN_B, *cs.TRAIN_HW
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
        "sta": (sta, "sta_conv_fused", (
            cs._rand(rng, (b, c, h, w), bf, device), cs._rand(rng, (b, c, h, w), bf, device),
            kc.weight.to(bf), kc.bias.to(bf)), {}),
        "osconv_dagg": (osconv, "osconv_dagg", (
            cs._rand(rng, (tb, 192, th, tw), torch.float32, device),
            cs._rand(rng, (tb, 64, th, tw), torch.float32, device), 3, 3, 1), {}),
    }
    variants = {k: VARIANTS[k] for k in args.kernels}
    results = []
    with tempfile.TemporaryDirectory() as tmp, torch.no_grad(), cs.float32_precision(True):
        libs = build_variants(tmp, build, variants)
        for kern, vs in variants.items():
            mod, fn_name, fn_args, kw = calls[kern]
            real = mod._lib()
            fn = getattr(mod, fn_name)
            want = getattr(mod, fn_name + "_plain")(*fn_args).float()
            for name, variant in vs.items():
                patch = variant if isinstance(variant, dict) else {}
                if (kern, name) in libs:
                    lib = ctypes.CDLL(libs[(kern, name)])
                    for sym in dir(real):
                        if sym.startswith("savsr_"):
                            getattr(lib, sym).argtypes = getattr(real, sym).argtypes
                            getattr(lib, sym).restype = getattr(real, sym).restype
                    patch = {**patch, "_lib": lambda lib=lib: lib}
                saved = {k: getattr(mod, k) for k in patch}
                for k, v in patch.items():
                    setattr(mod, k, v)
                try:
                    err = float((fn(*fn_args, **kw).float() - want).abs().max())
                    ms = cs.timed_ms(lambda: fn(*fn_args, **kw), device)
                finally:
                    for k, v in saved.items():
                        setattr(mod, k, v)
                print(f"[variants] {kern} {name:28s} ms {ms:.4f} (max abs err {err:.3e})",
                      flush=True)
                results.append({"kernel": kern, "variant": name, "ms": ms, "max_abs_err": err})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "variants": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
