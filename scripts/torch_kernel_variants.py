#!/usr/bin/env python3
"""Where the time of the port's hand-written kernels goes: each kernel built
again with one part switched off, timed at its main-path shape on one CUDA
card.

    python3 scripts/torch_kernel_variants.py [--kernels K [K ...]] [--sass DIR] [--out FILE]

A variant is a text edit of a copy of ``savsr_tpu_torch/csrc/<source>.cu``
in a temporary directory (the edit must match the source, or the script
stops), built with the package's nvcc flags and called through the
package's wrapper, back-to-back between CUDA events as ``chip_smoke.py``
times every kernel; a variant may instead (or also) set a module attribute
of the wrapper for its call (a launch plan, a tile width). Shapes: STAU and
the tail at 8 windows of 180x320 LR, x4, C = 64 (STAU with the flagship
weights' window plan), bf16, STAU in f32 (``stau_f32``: the CUDA-core
kernel on the f32 plan) and the tail in f32 (``tail_f32``: the CUDA-core
``tail_f32_kernel``); STA at 8 windows of 180x320, C = 64, bf16, and in
f32 (``sta_f32``: the CUDA-core kernel); the
f32 OSConv weight gradient at 8 x 60x60, 192 -> 64, k = 3, padding 1; the
f32 conv (csrc/conv.cu conv_f32_kernel) at 8 windows of 180x320, 3x3 64 ->
64 and 1x1 3x64 -> 64; the fast tier's conv (csrc/conv.cu
conv_fast_kernel, which rounds its f32 parts itself) at 8 windows of
180x320, 3x3 64 -> 64 with an f32 residual (``conv_fast``) and 1x1 3x64 ->
64 (``conv_fast_1x1``); the split tier's conv (csrc/conv.cu, pair inputs
of bf16 hi and lo planes) at 8 windows of 180x320, 3x3 64 -> 64 with a
pair residual (``conv_split``) and 1x1 3x64 -> 64 (``conv_split_1x1``).
The fast tier's STA (``sta_fast``: csrc/sta.cu sta_fast_kernel) and STAU
(``stau_fast``: csrc/stau.cu, its fast kernel on the fast plan, and the
wrapper's rounding passes where it has them) at 8 windows of 180x320, C =
64, f32. ``--sass DIR`` also prints each variant's ptxas
lines and SASS counts and writes the full variant's SASS into DIR. The
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
import re
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# mma.sync replaced by one cheap dependent operation on its inputs
NO_MMA = ('#include "hopper.cuh"\n',
          '#include "hopper.cuh"\n#define mma_m16n8k16_bf16(d, a, b0, b1) '
          '(d[0] += __uint_as_float((a[0] ^ b0 ^ b1) & 0x3f800000u))\n')
CONV_F32_COMMON = {
    "full": [],
    "no staging copies": [("  const int cn = min(C::CI, s.c - s.c0);  // channels of the stage that exist",
                           "  if (a.Cout > 0) return;\n"
                           "  const int cn = min(C::CI, s.c - s.c0);  // channels of the stage that exist")],
    # constant operands: the FMAs become adds of a constant, on the same pipe
    "no shared loads in the FMAs": [
        ("          const float4 p = *reinterpret_cast<const float4*>(row);",
         "          const float4 p = make_float4(ir, 0.5f, 0.25f, 0.125f);"),
        ("          const float4 p = *reinterpret_cast<const float4*>(row + 1);\n"
         "          v[ir][0] = row[0],",
         "          const float4 p = make_float4(ir, 0.5f, 0.25f, 0.125f);\n"
         "          v[ir][0] = 0.375f,"),
        ("          v[ir][5] = row[5];", "          v[ir][5] = 0.625f;"),
        ("        const float4 lo = *reinterpret_cast<const float4*>(w + tap * F_WP);\n"
         "        const float4 hi = *reinterpret_cast<const float4*>(w + tap * F_WP + 4);",
         "        const float4 lo = make_float4(1.f, tap, u, 2.f), hi = make_float4(u, 3.f, 5.f, 7.f);")],
    "no barrier": [("    __syncthreads();  // ... everyone's; and every warp is done with stage t - 1's buffer\n",
                    "")],
}
# the fast conv (csrc/conv.cu conv_fast_kernel), a part switched off at a time
FAST_RINGS = ("  static constexpr int BF_STAGES = KS == 3 ? 2 : 4;\n"
              "  static constexpr int F32_STAGES = KS == 3 ? 2 : 4;")


def _rings(bf3, f3, bf1, f1):
    return (FAST_RINGS, f"  static constexpr int BF_STAGES = KS == 3 ? {bf3} : {bf1};\n"
                        f"  static constexpr int F32_STAGES = KS == 3 ? {f3} : {f1};")


CONV_FAST_COMMON = {
    "full": [],
    # the f32 chunks still land, the converters write nothing
    "no rounding": [("  for (int pi = cw; pi < C::LINES / 2; pi += FX_CONVERTERS) {",
                     "  for (int pi = cw; pi < 0; pi += FX_CONVERTERS) {")],
    "no f32 input loads": [
        ("        const uint32_t bytes = C::HALO_OFF + (int(left) + int(right)) * C::HALO_SIDE;",
         "        const uint32_t bytes = 0;"),
        ("            tma_load_4d(st, &parts.center[p], &f_full[fs], tl.x0, c0, y, tl.b);\n"
         "            if (left)",
         "            if (bytes) tma_load_4d(st, &parts.center[p], &f_full[fs], tl.x0, c0, y, tl.b);\n"
         "            if (bytes && left)"),
        ("            if (right)\n              tma_load_4d(st + C::HALO_OFF + C::HALO_SIDE",
         "            if (bytes && right)\n              tma_load_4d(st + C::HALO_OFF + C::HALO_SIDE")],
    "no output stores": [("        if (ok) *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);",
                          "        if (ok && v[0] == 12345.f) *reinterpret_cast<float2*>(o) = "
                          "make_float2(v[0], v[1]);")],
    "no epilogue": [("    if (W & 1) {\n      if (lrelu)\n        fast_epilogue<false, true, RES>",
                     "    if (acc[0] != 12345.f) {\n    } else if (W & 1) {\n      if (lrelu)\n"
                     "        fast_epilogue<false, true, RES>")],
}
CONV_FAST_3X3 = {
    **CONV_FAST_COMMON,
    "no residual loads": [("    if constexpr (RES) {  // in flight under the tile's MMAs",
                           "    if constexpr (false) {")],
    "f32 ring 3": [_rings(2, 3, 4, 4)],
    "f32 ring 4": [_rings(2, 4, 4, 4)],
}
CONV_FAST_1X1 = {**CONV_FAST_COMMON, "f32 ring 2": [_rings(2, 2, 4, 2)],
                 "f32 ring 8": [_rings(2, 2, 4, 8)], "bf16 ring 2": [_rings(2, 2, 2, 4)]}

# the split conv (csrc/conv.cu conv_split_kernel<K>: a stage one chunk of one
# pair, ping-pong consumer warpgroups), a part switched off at a time
SPLIT_EPILOGUE = "    split_epilogue<RES, PAIR_OUT, VEC>(acc, e, tl, warp, lane, H, W, Cout);\n"
CONV_SPLIT_COMMON = {
    "full": [],
    "no epilogue": [(SPLIT_EPILOGUE, "    if (acc[0] == 12345.f)\n  " + SPLIT_EPILOGUE)],
    "no residual loads": [("      if (RES) {  // the loads, all in flight at once",
                           "      if (false) {  // the loads, all in flight at once")],
    "no output stores": [("        if (!ok) continue;\n        float v[2]",
                          "        if (!ok || acc[0] != 12345.f) continue;\n        float v[2]")],
}
CONV_SPLIT_3X3 = {
    **CONV_SPLIT_COMMON,
    "no shift build": [("          const int line = q * C::PLANE + l * 128;",
                        "          if (tl.b >= 0) continue;\n"
                        "          const int line = q * C::PLANE + l * 128;")],
    "no weight copy": [
        ("            2 * C::BUF + C::W_BYTES + 2 *", "            2 * C::BUF + 2 *"),
        ("            bulk_load(st + C::W_OFF, wsrc + (long long)chunk * C::W_BYTES, C::W_BYTES,\n"
         "                      &tma_full[stage]);\n", "")],
    "hi x Whi only (9 of 27 MMAs)": [("      for (int m = 0; m < 3; ++m) {\n"
                                      "        const uint32_t a0 = m == 1",
                                      "      for (int m = 0; m < 1; ++m) {\n"
                                      "        const uint32_t a0 = m == 1")],
}


VARIANTS = {
    "conv_f32": {**CONV_F32_COMMON, "FMAs and weights of 3 of 9 taps": [
        ("      for (int tap = 0; tap < KS * KS; ++tap) {",
         "      for (int tap = 0; tap < KS; ++tap) {")]},
    "conv_f32_1x1": CONV_F32_COMMON,
    "stau": {
        "full": [],
        "no bilinear taps": [("    if (!tp.ok[t]) continue;", "    if (true) continue;")],
        "no staging copies": [("    if (p.nrf == 0) return;\n    const long long off = (t % B) * chw;\n"
                               "    stage_issue<CB>",
                               "    if (true) return;\n    const long long off = (t % B) * chw;\n"
                               "    stage_issue<CB>")],
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
    "tail_f32": {
        "full": [],
        # the loads stay (their values feed an empty asm), the products go
        "no FFMAs": [("            acc[o][j][k] = fmaf(w[9 * dy + 3 * dx + k], v[j >> 2][(j & 3) + dx], acc[o][j][k]);",
                      '            asm volatile("" ::"f"(w[9 * dy + 3 * dx + k]), "f"(v[j >> 2][(j & 3) + dx]));')],
        "no shared loads in the FMAs": [
            ("    const float4 v = wq[i];", "    const float4 v = make_float4(lane, i, 0.25f, 0.125f);"),
            ("    float4 a = *reinterpret_cast<const float4*>(ra + r * TF_BW);\n"
             "    float4 q = *reinterpret_cast<const float4*>(rb + r * TF_BW);\n"
             "    float e = re[r * TF_BW];",
             "    float4 a = make_float4(lane, r, 2.f, 3.f), q = make_float4(r, lane, 4.f, 5.f);\n"
             "    float e = 6.f;")],
        "no shuffles": [("    const float al = __shfl_sync(~0u, a.w, up);\n"
                         "    const float ar = __shfl_sync(~0u, lane == 0 ? q.x : a.x, down);\n"
                         "    const float bl = __shfl_sync(~0u, lane == 31 ? a.w : q.w, up);\n"
                         "    const float br = __shfl_sync(~0u, q.x, down);",
                         "    const float al = a.w, ar = q.x, bl = q.w, br = a.x;")],
        "no sr boxes (weights only)": [
            ("    mbar_arrive_expect_tx(&full[slot], TF_TX);\n"
             "    tma_load_4d(st, &map, &full[slot], px0 - 4, py0 - 1, ic, pb);\n"
             "    tma_load_4d(st + TF_B_OFF, &map, &full[slot], px0 + TF_TW / 2 - 4, py0 - 1, ic, pb);",
             "    mbar_arrive_expect_tx(&full[slot], TF_WSLOTS * 4);")],
        "one channel plane (sr from L2)": [
            ("    tma_load_4d(st, &map, &full[slot], px0 - 4, py0 - 1, ic, pb);\n"
             "    tma_load_4d(st + TF_B_OFF, &map, &full[slot], px0 + TF_TW / 2 - 4, py0 - 1, ic, pb);",
             "    tma_load_4d(st, &map, &full[slot], px0 - 4, py0 - 1, 0, pb);\n"
             "    tma_load_4d(st + TF_B_OFF, &map, &full[slot], px0 + TF_TW / 2 - 4, py0 - 1, 0, pb);")],
        "no skip": [("        v[j] = (acc[o][j][k] + bk) + (cw0[j] * l0 + cw1[j] * l1);",
                     "        v[j] = acc[o][j][k] + bk;")],
        "no epilogue": [("    if (active)\n      tf_epilogue<ROUND>(", "    if (active && acc[0][0][0] == 12345.f)\n      tf_epilogue<ROUND>(")],
        "ring of 2": [("constexpr int TF_STAGES = 3;", "constexpr int TF_STAGES = 2;")],
        "ring of 4": [("constexpr int TF_STAGES = 3;", "constexpr int TF_STAGES = 4;")],
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
    "stau_fast": {
        "full": [],
        "no kept-f0 loads": [("        const float4 k4 = f0_keep[(hf * CB + kb) * 32 + lane];",
                              "        const float4 k4 = make_float4(0.5f, 0.25f, 0.125f, 1.f);")],
        "no f32 output stores": [
            ("        if (Y < H && x < W) outf[co * HW + pbase + x] = out[4 * nt + j] + bias[co];",
             "        if (Y < H && x < W && out[4 * nt + j] == 12345.f)\n"
             "          outf[co * HW + pbase + x] = out[4 * nt + j] + bias[co];")],
        "no bilinear taps": [("    if (!tp.ok[t]) continue;", "    if (true) continue;")],
        "no staging copies": [("    if (p.nrf == 0) return;\n    const long long off = (t % B) * chw;\n"
                               "    stage_issue<CB>",
                               "    if (true) return;\n    const long long off = (t % B) * chw;\n"
                               "    stage_issue<CB>")],
        "no mma.sync": [NO_MMA],
    },
    "stau_f32": {
        "full": [],
        "no staging copies": [("    for (int c = 0; c < C; c += 4, g += 4 * hw, d += 4 * FS_CAP) "
                               "cp_async4_zfill(d, g, ok);",
                               "    for (int c = 0; c < C && h < 0; c += 4, g += 4 * hw, d += 4 * FS_CAP) "
                               "cp_async4_zfill(d, g, ok);")],
        "no bilinear tap loads": [
            ("          const float4 v0 = *reinterpret_cast<const float4*>(s0 + c * FS_CAP);\n"
             "          const float4 v1 = *reinterpret_cast<const float4*>(s1 + c * FS_CAP);\n"
             "          const float4 v2 = *reinterpret_cast<const float4*>(s2 + c * FS_CAP);\n"
             "          const float4 v3 = *reinterpret_cast<const float4*>(s3 + c * FS_CAP);",
             "          const float4 v0 = make_float4(wt[0], c, 1.f, 2.f), v1 = v0, v2 = v0, v3 = v0;")],
        "no expert products": [("      if (lt < E * 16) {", "      if (lt < 0) {"),
                               ("      gemm_rows<K>(acc,", "      gemm_rows<1>(acc,")],
        "no fusion product": [("      gemm_rows<CP>(acc, fsm + Cfg::WF_OFF + 8 * og",
                               "      gemm_rows<1>(acc, fsm + Cfg::WF_OFF + 8 * og"),
                              ("      gemm_rows<CP>(acc, fsm + Cfg::WF_OFF + CP * FS_OMAX",
                               "      gemm_rows<1>(acc, fsm + Cfg::WF_OFF + CP * FS_OMAX")],
        "no output stores": [("      if (f.vec_out && f.X + 4 <= f.W) {",
                              "      if (v[0] != 12345.f) continue;\n"
                              "      if (f.vec_out && f.X + 4 <= f.W) {")],
    },
    "sta_f32": {
        "full": [],
        "no weight streaming": [("    cp_async16(dst + 4 * e, src + 4 * e);",
                                 "    if (e < 0) cp_async16(dst + 4 * e, src + 4 * e);")],
        "no tile staging": [("    sta_f32_stage<CP>(s_st, s_x, x, st, b, y0, x0, C, H, W);",
                             "    if (tile < 0) sta_f32_stage<CP>(s_st, s_x, x, st, b, y0, x0, C, H, W);")],
        "no K product": [("      for (int ci = 0; ci < CP; ++ci) {", "      for (int ci = 0; ci < 1; ++ci) {")],
        "no x loads in the epilogue": [
            ("          o[i][j] = fmaf(v, xb[8 * i * F_CS + (j >> 2) * 4 * F_HC + 8 * (j & 3)], o[i][j]);",
             "          o[i][j] = fmaf(v, 0.5f, o[i][j]);")],
        "no L2 prefetch of the next tile": [("    if (tile + gridDim.x < ntiles) {\n      const int nt",
                                             "    if (tile < 0) {\n      const int nt")],
        "3 of 25 taps": [("    for (int t = 0; t < TAPS; ++t, ++step) {",
                          "    for (int t = 0; t < 3; ++t, ++step) {")],
    },
    "sta_fast": {
        "full": [],
        "no wgmma": [("    wgmma_m64nNk16_bf16_rs<C>(acc, a[kb], make_desc(w_tap + kb * C * 32, 128, 256, "
                      "kInterleave),\n                              kb > 0);",
                      "    acc[0] += __uint_as_float(a[kb][0] & 0x3f800000u);")],
        "no epilogue": [("      sta_fast_epilogue<C>(o, acc, xt + (t / KS) * FT_HC + t % KS, bq + t * C);",
                         "      if (acc[0] == 12345.f)\n"
                         "        sta_fast_epilogue<C>(o, acc, xt + (t / KS) * FT_HC + t % KS, bq + t * C);")],
        "no x loads in the epilogue": [
            ("            fmaf(v, xt[(8 * i + c) * FT_XS + j * FT_HC], out[4 * i + 2 * j + c]);",
             "            fmaf(v, 0.5f, out[4 * i + 2 * j + c]);")],
        "no st loads": [("    sta_fast_a<C>(a, st, tl, H, W, col0, warp, g, q);",
                         "    if (tile < 0) sta_fast_a<C>(a, st, tl, H, W, col0, warp, g, q);")],
        "no x staging": [("      sta_fast_stage_x<C>(s_x + ((it + 1) & 1) * Cfg::X_FLOATS, x, nt, H, W);",
                          "      if (tile < 0) sta_fast_stage_x<C>(s_x + ((it + 1) & 1) * Cfg::X_FLOATS, x, nt, H, W);")],
        "no output stores": [("        for (int c = 0; c < 2; ++c) ob[(long long)(8 * i + c) * HW] = o[4 * i + 2 * j + c];",
                              "        for (int c = 0; c < 2; ++c)\n"
                              "          if (o[4 * i + 2 * j + c] == 12345.f) ob[(long long)(8 * i + c) * HW] = 0.f;")],
    },
    "conv_fast": CONV_FAST_3X3,
    "conv_fast_1x1": CONV_FAST_1X1,
    "conv_split": CONV_SPLIT_3X3,
    "conv_split_1x1": CONV_SPLIT_COMMON,
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


SOURCE = {"osconv_dagg": "osconv", "conv_f32": "conv", "conv_f32_1x1": "conv", "conv_fast": "conv",
          "conv_fast_1x1": "conv", "conv_split": "conv", "conv_split_1x1": "conv",
          "stau_f32": "stau", "stau_fast": "stau",
          "sta_f32": "sta", "sta_fast": "sta", "tail_f32": "tail"}


def _edits(variant):
    return [] if isinstance(variant, dict) else variant


# the kernels whose ptxas lines and SASS ``--sass`` reports (default: the
# source's name)
SASS_FUNCS = {"conv_fast": ("conv_fast_kernel",), "conv_fast_1x1": ("conv_fast_kernel",),
              "sta_fast": ("sta_fast_kernel",), "stau_fast": ("stau_mma_kernelILi4ELb1E",),
              "conv_split": ("conv_split_kernelILi3E",), "conv_split_1x1": ("conv_split_kernelILi1E",)}
# SASS opcodes counted per kernel: tensor-core products, the warpgroup
# waits ptxas places (one per product group unless it serialises the
# wgmmas), local-memory traffic (spills), and global loads and stores
SASS_OPS = ("HGMMA", "WARPGROUP.DEPBAR", "WARPGROUP.ARRIVE", "LDL", "STL", "LDG", "STG",
            "UTMALDG", "UTMASTG", "UBLKCP", "LDS", "STS", "SHFL", "F2FP")


def demangle(names):
    tool = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    if not os.path.isfile(tool):
        tool = shutil.which("c++filt")
    if not tool:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True).stdout
    return out.splitlines() if out.count("\n") >= len(names) - 1 else list(names)


def ptxas_report(log: str, funcs) -> list:
    """ptxas's lines for the kernels named by ``funcs`` (registers, spills,
    stack) and every line on wgmma (C7514 / C7518: serialised wgmmas)."""
    keep, cur = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = line.split("'")[1]
            continue
        if "Function properties for" in line:
            cur = line.split()[-1]
            continue
        if "wgmma" in line or "C751" in line:
            keep.append(line.strip())
        elif cur and any(f in cur for f in funcs) and ("registers" in line or "spill" in line):
            keep.append(f"{demangle([cur])[0][:90]}: {line.strip()}")
    return keep


def sass_report(lib: str, funcs, dump: str = None) -> list:
    """Per kernel named by ``funcs``: its SASS instruction count and the
    counts of SASS_OPS; the SASS itself written to ``dump`` (a file) too."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.isfile(tool):
        return ["no cuobjdump"]
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    sections = re.split(r"\n\s*Function : ", sass)[1:]
    rows, texts = [], []
    for sec in sections:
        name = sec.split("\n", 1)[0].strip()
        if not any(f in name for f in funcs):
            continue
        ins = [l for l in sec.splitlines() if re.match(r"\s*/\*[0-9a-f]{4,}\*/", l)]
        counts = {op: sum(1 for l in ins if re.search(rf"\b{re.escape(op)}\b", l))
                  for op in SASS_OPS}
        pretty = demangle([name])[0]
        rows.append(f"{pretty[:90]}: {len(ins)} instructions; "
                    + ", ".join(f"{k} {v}" for k, v in counts.items()))
        texts.append(f"Function : {pretty}\n{sec}")
    if dump:
        with open(dump, "w") as f:
            f.write("\n".join(texts))
    return rows


def build_variants(tmp: str, build, variants: dict, logs: dict = None) -> dict:
    """Compile every variant with edits at once (one nvcc each; a variant
    without edits uses the package's own library); {(kernel, variant):
    library path}; ``logs`` gets each build's compiler output."""
    procs = {}
    for kern, vs in variants.items():
        source = SOURCE.get(kern, kern)
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
        if logs is not None:
            logs[key] = log
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--kernels", nargs="+", default=["stau", "tail", "sta", "osconv_dagg"],
                    help="the kernels to vary")
    ap.add_argument("--out", default=None, help="also write the times here as JSON")
    ap.add_argument("--sass", default=None, metavar="DIR",
                    help="print each variant's ptxas lines (registers, spills, serialised "
                         "wgmmas) and SASS counts, and write its SASS into DIR")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import chip_smoke as cs
    from savsr_tpu_torch.archs.savsr_arch import SAVSR
    from savsr_tpu_torch.csrc import build
    from savsr_tpu_torch.inference import flagship_net_kwargs
    from savsr_tpu_torch.ops import conv, osconv, sta, stau, tail
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
                      np.load(os.path.join(REPO, "tests", "goldens", "savsr_state_dict.npz")).items()})
    model.to(device)
    with cs.float32_precision(True):
        st = model.stau_statics(cs.LR_HW, cs.SCALE, device=device)  # the f32 plan
    up, bf, f32 = model.upsample, torch.bfloat16, torch.float32
    kc = up.kernel_conv[0]
    tb, th, tw = cs.TRAIN_B, *cs.TRAIN_HW
    calls = {
        "stau": (stau, "stau_upsample_fused", (
            cs._rand(rng, (b, c, h, w), bf, device), cs._rand(rng, (b, c, h, w), bf, device),
            st["pix"], up.weight_compress.to(bf), up.weight_expand.to(bf), up.fusion.weight.to(bf),
            up.fusion.bias), {"plan": stau.stau_window_plan(st["pix"], h, w)}),
        "stau_f32": (stau, "stau_upsample_fused", (
            cs._rand(rng, (b, c, h, w), f32, device), cs._rand(rng, (b, c, h, w), f32, device),
            st["pix"], up.weight_compress, up.weight_expand, up.fusion.weight, up.fusion.bias),
            {"plan": st["stau_plan"]}),
        "sta_f32": (sta, "sta_conv_fused", (
            cs._rand(rng, (b, c, h, w), f32, device), cs._rand(rng, (b, c, h, w), f32, device),
            kc.weight, kc.bias), {}),
        "sta_fast": (sta, "sta_conv_fused_fast", (
            cs._rand(rng, (b, c, h, w), f32, device), cs._rand(rng, (b, c, h, w), f32, device),
            kc.weight, kc.bias), {}),
        "stau_fast": (stau, "stau_upsample_fused_fast", (
            cs._rand(rng, (b, c, h, w), f32, device), cs._rand(rng, (b, c, h, w), f32, device),
            st["pix"], up.weight_compress, up.weight_expand, up.fusion.weight, up.fusion.bias),
            {"plan": stau.stau_window_plan(st["pix"], h, w, *stau.plan_geometry(f32, fast=True))}),
        "tail": (tail, "tail_fused", (
            cs._rand(rng, (b, c, H, W), bf, device),
            torch.from_numpy(rng.random((b, 3, h, w)).astype(np.float32)).to(device, bf),
            *(cs.tail_operands(h, w, H, W, device)[k]
              for k in ("tail_j0", "tail_wy", "tail_c0", "tail_cw")),
            cs._rand(rng, (3, c, 3, 3), bf, device, 0.1), cs._rand(rng, (3,), bf, device, 0.1)),
            {}),
        "tail_f32": (tail, "tail_fused", (
            cs._rand(rng, (b, c, H, W), f32, device),
            torch.from_numpy(rng.random((b, 3, h, w)).astype(np.float32)).to(device),
            *(cs.tail_operands(h, w, H, W, device)[k]
              for k in ("tail_j0", "tail_wy", "tail_c0", "tail_cw")),
            model.tail.weight, model.tail.bias), {}),
        "sta": (sta, "sta_conv_fused", (
            cs._rand(rng, (b, c, h, w), bf, device), cs._rand(rng, (b, c, h, w), bf, device),
            kc.weight.to(bf), kc.bias.to(bf)), {}),
        "conv_f32": (conv, "conv_fused", (
            [cs._rand(rng, (b, c, h, w), torch.float32, device)],
            cs._rand(rng, (c, c, 3, 3), torch.float32, device, (9 * c) ** -0.5),
            cs._rand(rng, (c,), torch.float32, device, 0.1)), {}),
        "conv_f32_1x1": (conv, "conv_fused", (
            [cs._rand(rng, (b, c, h, w), torch.float32, device) for _ in range(3)],
            cs._rand(rng, (c, 3 * c, 1, 1), torch.float32, device, (3 * c) ** -0.5),
            cs._rand(rng, (c,), torch.float32, device, 0.1)), {}),
        "conv_fast": (conv, "conv_fused_fast", (
            [cs._rand(rng, (b, c, h, w), torch.float32, device)],
            cs._rand(rng, (c, c, 3, 3), torch.float32, device, (9 * c) ** -0.5),
            cs._rand(rng, (c,), torch.float32, device, 0.1)),
            {"lrelu": (0.6, 0.4), "residual": cs._rand(rng, (b, c, h, w), torch.float32, device)}),
        "conv_fast_1x1": (conv, "conv_fused_fast", (
            [cs._rand(rng, (b, c, h, w), torch.float32, device) for _ in range(3)],
            cs._rand(rng, (c, 3 * c, 1, 1), torch.float32, device, (3 * c) ** -0.5),
            cs._rand(rng, (c,), torch.float32, device, 0.1)), {"lrelu": (0.6, 0.4)}),
        "conv_split": (conv, "conv_fused_split", (
            [conv.pair_split(cs._rand(rng, (b, c, h, w), f32, device))],
            cs._rand(rng, (c, c, 3, 3), f32, device, (9 * c) ** -0.5),
            cs._rand(rng, (c,), f32, device, 0.1)),
            {"lrelu": (0.6, 0.4),
             "residual": conv.pair_split(cs._rand(rng, (b, c, h, w), f32, device))}),
        "conv_split_1x1": (conv, "conv_fused_split", (
            [conv.pair_split(cs._rand(rng, (b, c, h, w), f32, device)) for _ in range(3)],
            cs._rand(rng, (c, 3 * c, 1, 1), f32, device, (3 * c) ** -0.5),
            cs._rand(rng, (c,), f32, device, 0.1)), {"lrelu": (0.6, 0.4)}),
        "osconv_dagg": (osconv, "osconv_dagg", (
            cs._rand(rng, (tb, 192, th, tw), torch.float32, device),
            cs._rand(rng, (tb, 64, th, tw), torch.float32, device), 3, 3, 1), {}),
    }
    variants = {k: VARIANTS[k] for k in args.kernels}

    def value(y):  # the split conv's pair output by its f32 value
        return conv.pair_merge(y) if isinstance(y, conv.Pair) else y.float()

    results = []
    with tempfile.TemporaryDirectory() as tmp, torch.no_grad(), cs.float32_precision(True):
        logs = {}
        libs = build_variants(tmp, build, variants, logs)
        build.build_all()
        if args.sass:
            os.makedirs(args.sass, exist_ok=True)
            for kern, vs in variants.items():
                source = SOURCE.get(kern, kern)
                funcs = SASS_FUNCS.get(kern, (source,))
                for i, name in enumerate(vs):
                    if (kern, name) in libs:
                        lib, log = libs[(kern, name)], logs[(kern, name)]
                    elif i == 0 or name == "full":
                        lib = build.library_path(source)
                        with open(lib + ".log") as f:
                            log = f.read()
                    else:
                        continue
                    dump = os.path.join(args.sass, f"{kern}.sass") if name == "full" else None
                    for line in ptxas_report(log, funcs) + sass_report(lib, funcs, dump):
                        print(f"[sass] {kern} {name}: {line}", flush=True)
        for kern, vs in variants.items():
            mod, fn_name, fn_args, kw = calls[kern]
            real = mod._lib()
            fn = getattr(mod, fn_name)
            want = value(getattr(mod, fn_name + "_plain")(
                *fn_args, **{k: v for k, v in kw.items() if k != "plan"}))
            first = fn_args[0][0] if isinstance(fn_args[0], list) else fn_args[0]
            first = first.hi if isinstance(first, conv.Pair) else first
            print(f"[variants] {kern} reference: one read of its {tuple(first.shape)} "
                  f"{str(first.dtype)[6:]} input (torch.Tensor.sum) ms "
                  f"{cs.timed_ms(lambda: first.sum(), device):.4f}", flush=True)
            if kern == "stau_fast":  # its wrapper's rounding passes, inside every variant's time
                rnd = lambda: [t.to(torch.bfloat16, memory_format=torch.contiguous_format)  # noqa: E731
                               for t in fn_args[:2]]
                print(f"[variants] {kern} the wrapper's rounding passes of x and sta ms "
                      f"{cs.timed_ms(rnd, device):.4f}", flush=True)
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
                    err = float((value(fn(*fn_args, **kw)) - want).abs().max())
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
