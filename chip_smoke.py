#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (savsr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Phases (each prints its lines; any failure exits non-zero):

1. build    nvcc compiles the port's CUDA sources (savsr_tpu_torch/csrc/*.cu,
            one process per source, all at once) for sm_90a; prints ptxas's
            registers and spills and the tensor-core instructions in the
            SASS of the libraries with bf16 tensor-core kernels: HGMMA
            (wgmma) in conv, osconv and sta (the bf16 conv, which also runs
            the bf16 OSConv forward and dx, the bf16 OSConv weight gradient
            and the bf16 STA K product), HMMA (mma.sync) in stau and tail;
            neither count may be 0 where the kernels use it.
2. kernels  each kernel wrapper against its plain PyTorch version on the
            card, f32 and bf16: max abs error, median time, the plain
            version's time, the time of one library call computing the same
            function (where there is one), the card's bound for the work,
            and the achieved TFLOP/s and share of the bound, all from
            back-to-back calls (STA's bound holds its K product to the bf16
            tensor-core rate and its 25-tap filter, which has no matrix
            form, to the f32 CUDA-core rate). The serving kernels at the
            serving path's shapes (8 windows of 180x320 per launch, x4,
            flagship widths); the
            bf16 STAU kernel on the window plan of the serving statics (the
            plan's count of tiles gathered from device memory is printed for
            each serving scale); the two OSConv kernels at the training
            path's (8 samples of 60x60, Cin
            192/320/64 -> 64, forward, dx and weight gradient), whose host
            launch cost exceeds their device time, so they (and their library
            calls) are also timed as replays of a CUDA graph of the calls,
            with each call's device time by kernel; and the autograd Function's
            dx/dagg against autograd through the plain version (f32 at
            192 -> 64; bf16 at 192, 320 and 64 -> 64).
3. parity   flagship weights (tests/goldens/savsr_state_dict.npz, loaded
            with load_state_dict(strict=True)) on the strict tier against the
            reference torch outputs (tests/goldens/savsr_realsize_forward.npz)
            at x4, x(1.5,3.5) and x3.05: deviation PSNR must exceed 100 dB,
            every kernel must launch, no plain version may run on the card.
4. serving  savsr_tpu_torch.inference.main on a seeded 8-frame 180x320 clip
            at -s 4 --tier bf16 --windows 8 (720p out), run twice; the second
            run is the main-path run whose kernel launches are counted and
            whose chunk gives the steady rate. The bf16 output of the first
            window is held against the strict tier (deviation PSNR >= 50 dB).
5. profile  device time by kernel over one bf16 serving forward of 8
            windows (torch.profiler), against its unprofiled time, and the
            bf16 conv's weight repack (the gather kernels).
6. train-parity  the small config in strict f32 on the card: one loss +
            backward on the golden batch against the torch oracle's
            gradients (tests/goldens/savsr_small_grads.npz: loss within
            1e-5, every gradient within 2e-3 of its own max), through the
            OSConv kernels, no plain version on the card.
7. training savsr_tpu_torch.train.train_pipeline on 32 seeded 256x448
            septuplets with the flagship recipe (num_feat 64, B=16 = 2x8
            micro-batches of 60x60 LR crops, bf16, Charbonnier, Adam +
            CosineAnnealingRestartLR, EMA 0.999), 6 iterations: losses
            finite, checkpoint written and reloaded, the OSConv kernels'
            launches per step as the architecture gives them, ms/step and
            samples/s over the steps after the first two, peak memory. This
            is the training main-path run for the two OSConv kernels.
8. train-profile  device time by kernel over one more training step of that
            model, against its unprofiled time, and the OSConv wrappers'
            share (their record_function ranges).

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": <name>, "count": <n>}};
the line before it holds the per-kernel results as one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from savsr_tpu_torch import ops
from savsr_tpu_torch.archs.arch_util import float32_precision
from savsr_tpu_torch.archs.savsr_arch import SAVSR, get_hw, tail_operands
from savsr_tpu_torch.csrc import build
from savsr_tpu_torch.data.data_util import generate_frame_indices
from savsr_tpu_torch.inference import (build_serving_model, flagship_net_kwargs,
                                       load_params, main as serve_main)
from savsr_tpu_torch.ops.conv import conv_fused, conv_fused_plain
from savsr_tpu_torch.ops.osconv import (osconv_agg, osconv_agg_dx, osconv_agg_plain,
                                        osconv_agg_train, osconv_dagg, osconv_dagg_plain)
from savsr_tpu_torch.ops.sta import sta_conv_fused, sta_conv_fused_plain
from savsr_tpu_torch.ops.stau import (STAGE_CAP, stau_upsample_fused,
                                      stau_upsample_fused_plain)
from savsr_tpu_torch.ops.tail import tail_fused, tail_fused_plain
from savsr_tpu_torch.utils.convert import load_into

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDENS = os.path.join(REPO, "tests", "goldens")
LR_HW = (180, 320)  # the serving path's LR frame; x4 gives 720x1280
SCALE = (4.0, 4.0)
# windows per forward in the serving run (--windows): the kernels see this
# batch on the main path, so phase 2 checks and times them at it
WINDOWS = 8

# H100 SXM published peaks (NVIDIA data sheet, dense): the f32 kernels must
# stay true f32 (no TF32), so f32 work is held to the CUDA-core f32 rate;
# bf16 inputs to the bf16 tensor-core rate.
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
# f32: the kernel and the plain version sum the same products in another
# order (error ~1e-6 relative), 1e-4 leaves room for sums over 2880 terms;
# bf16: both round each output once to bf16 (2^-8 relative) from f32 sums,
# so outputs may land one bf16 step apart.
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SOURCES = {
    "conv3x3": ("savsr_tpu_torch/csrc/conv.cu", "savsr_tpu/ops/pallas/chw_conv.py:386"),
    "conv1x1": ("savsr_tpu_torch/csrc/conv.cu", "savsr_tpu/ops/pallas/chw_conv.py:531"),
    # bf16 (the timed headline) runs the tensor-core sta_mma_kernel; f32 the
    # CUDA-core sta_kernel
    "sta": ("savsr_tpu_torch/csrc/sta.cu", "savsr_tpu/ops/pallas/sta_kernel.py:84"),
    # bf16 (the timed headline) runs the tensor-core kernels stau_mma_kernel
    # and tail_mma_kernel; f32 the CUDA-core stau_kernel and tail_kernel
    "stau": ("savsr_tpu_torch/csrc/stau.cu", "savsr_tpu/ops/pallas/stau_kernel.py:183"),
    "tail": ("savsr_tpu_torch/csrc/tail.cu", "savsr_tpu/ops/pallas/tail_kernel.py:89"),
    # bf16 (the training path, the timed headline) runs the bf16 conv's
    # kernel; f32 runs osconv.cu's CUDA-core kernel
    "osconv_agg": ("savsr_tpu_torch/csrc/conv.cu",
                   "savsr_tpu/ops/pallas/osconv_kernel.py:139"),
    "osconv_dagg": ("savsr_tpu_torch/csrc/osconv.cu",
                    "savsr_tpu/ops/pallas/osconv_kernel.py:303"),
}
SERVING_KERNELS = ("conv3x3", "conv1x1", "sta", "stau", "tail")
TRAINING_KERNELS = ("osconv_agg", "osconv_dagg")
# the training path's shapes: a micro-batch of 8 samples of 60x60 LR crops
TRAIN_B, TRAIN_HW = 8, (60, 60)
DT_NAME = {torch.float32: "f32", torch.bfloat16: "bf16"}


def log(msg: str) -> None:
    print(msg, flush=True)


def timed_ms(fn, device, reps: int = 5, iters: int = 10) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back calls,
    after two warm-up calls (CUDA events on the card)."""
    fn()
    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / iters)
    return float(np.median(times))


def graph_ms(fn, reps: int = 5, iters: int = 20) -> float:
    """Device time per call of ``fn``: median over ``reps`` replays of one
    CUDA graph of ``iters`` back-to-back calls, so every kernel and copy the
    call makes is timed without the host's launch overhead (which, at the
    training path's 60x60 shapes, is longer than the work it launches)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return float(np.median(times))


def per_call_breakdown(fn, calls: int = 5) -> list:
    """(kernel, device ms per call) of the kernels and copies one call of
    ``fn`` runs, from torch.profiler over ``calls`` calls, largest first."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [(name, ms / calls) for name, ms, _ in device_rows(prof)]


def short_name(kernel: str) -> str:
    """A kernel's name without its namespace, return type and arguments."""
    name = kernel
    for prefix in ("void ", "(anonymous namespace)::", "at::native::"):
        name = name.replace(prefix, "")
    return name.split("(")[0].strip()[:48]


def bound_ms(flops: float, nbytes: float, dtype, ops_ms=None) -> tuple:
    """(the least time for the work, "operations" or "bytes"); ``ops_ms``
    overrides the operations' time where they run at more than one rate."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3 if ops_ms is None else ops_ms
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def check(name: str, label: str, kernel_fn, plain_fn, library_fn, flops: float,
          io_bytes: int, dtype, device, tol=None, graph: bool = False, ops_ms=None) -> dict:
    """Run the kernel and its plain version on the same inputs, compare in
    f32, time both (and the library call), and return the result row.
    ``tol`` (relative to max|plain|) overrides TOL[dtype]. ``ms`` and
    ``library_ms`` are back-to-back calls between CUDA events; ``graph``
    adds ``graph_ms`` and ``library_graph_ms``, replays of a CUDA graph of
    the calls (device time, repack and copies included, no host launch
    cost), and ``breakdown``, the device time of each kernel of a call."""
    tol = TOL[dtype] if tol is None else tol
    with torch.no_grad():
        want = plain_fn().float()
        got = kernel_fn().float()
        if device.type == "cuda":
            torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        ok = bool(torch.isfinite(got).all()) and err <= tol * scale
        ms = timed_ms(kernel_fn, device)
        plain_ms = timed_ms(plain_fn, device, reps=3, iters=3)
        lib_ms = None if library_fn is None else timed_ms(library_fn, device)
        graphed = {}
        if graph and device.type == "cuda":
            graphed = {"graph_ms": graph_ms(kernel_fn),
                       "library_graph_ms": None if library_fn is None else graph_ms(library_fn),
                       "breakdown": per_call_breakdown(kernel_fn)}
    b_ms, b_by = bound_ms(flops, io_bytes, dtype, ops_ms)
    tflops = flops / ms * 1e-9
    row = {"name": name, "case": label, "dtype": DT_NAME[dtype], "max_abs_err": err,
           "max_abs_plain": scale, "ok": ok, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
           "tflops": tflops, "bound_share": b_ms / ms, **graphed}
    lib = "null" if lib_ms is None else f"{lib_ms:.4f}"
    log(f"[kernels] {name:11s} {label:44s} {DT_NAME[dtype]:4s} err {err:.3e} "
        f"(tol {tol * scale:.3e}) ms {ms:.4f} plain {plain_ms:.4f} lib {lib} "
        f"bound {b_ms:.4f} ({b_by}) {tflops:.1f} TFLOP/s = {100 * b_ms / ms:.1f}% of bound "
        f"{'ok' if ok else 'FAIL'}")
    if graphed:
        g_ms, g_lib = graphed["graph_ms"], graphed["library_graph_ms"]
        log(f"[kernels]     graph replay: ms {g_ms:.4f} "
            f"({100 * b_ms / g_ms:.1f}% of bound) lib "
            f"{'null' if g_lib is None else format(g_lib, '.4f')}; device ms per call: "
            + "; ".join(f"{short_name(k)} {t:.4f}" for k, t in graphed["breakdown"]))
    return row


def _rand(rng, shape, dtype, device, std=1.0):
    return torch.from_numpy((std * rng.standard_normal(shape)).astype(np.float32)).to(
        device=device, dtype=dtype)


# (label, kernel size, input parts' channels, Cout, per-sample weights,
#  epilogue: pre_add, out_scale, lrelu, residual) — every Cin/Cout pair of
#  the serving path: conv_c (3), conv_sup (3+3), conv0/rcab/adapt (64),
#  conv2/conv_h/h_win_conv_h (64+64), the WindowUnit_l1 OSConv and merge
#  (3x64), the WindowUnit_l2 OSConv and merge (5x64 -> 64 / 128), conv1 (3x64)
CONV_CASES = [
    ("conv_c 3->64 lrelu", 3, [3], 64, False, (False, False, True, False)),
    ("conv_sup 3+3->64 lrelu", 3, [3, 3], 64, False, (False, False, True, False)),
    ("conv0 64->64 lrelu", 3, [64], 64, False, (False, False, True, False)),
    ("conv2 64+64->64 lrelu+res", 3, [64, 64], 64, False, (False, False, True, True)),
    ("osconv 3x64->64 per-sample lrelu", 3, [64] * 3, 64, True, (False, False, True, False)),
    ("osconv 5x64->64 per-sample lrelu", 3, [64] * 5, 64, True, (False, False, True, False)),
    ("merge_l2 5x64->128", 3, [64] * 5, 128, False, (False, False, False, False)),
    ("all-epilogue 64->64 per-sample relu", 3, [64], 64, True, (True, True, "relu", True)),
    ("conv1 3x64->64 lrelu", 1, [64] * 3, 64, False, (False, False, True, False)),
    ("all-epilogue 1x1 64+64->64 per-sample", 1, [64, 64], 64, True, (True, True, True, True)),
]
HEADLINE = {"conv3x3": "conv0 64->64 lrelu", "conv1x1": "conv1 3x64->64 lrelu",
            "osconv_agg": "fwd 192->64 (WindowUnit_l1)", "osconv_dagg": "192->64 (WindowUnit_l1)"}
# (label, Cin, Cout, as dx): the OSConvs of the training forward (3x64 -> 64
# in WindowUnit_l1, 5x64 -> 64 in WindowUnit_l2, 64 -> 64 in OSAdapt), k = 3,
# padding 1, and their dx calls (osconv_agg_dx): the same kernel on the
# cotangent with flipped taps and swapped channel axes at padding 3-1-1 = 1
OSCONV_CASES = [
    ("fwd 192->64 (WindowUnit_l1)", 192, 64, False),
    ("fwd 320->64 (WindowUnit_l2)", 320, 64, False),
    ("fwd 64->64 (OSAdapt)", 64, 64, False),
    ("dx 64->192 (WindowUnit_l1)", 192, 64, True),
    ("dx 64->320 (WindowUnit_l2)", 320, 64, True),
    ("dx 64->64 (OSAdapt)", 64, 64, True),
]
DAGG_CASES = [("192->64 (WindowUnit_l1)", 192, 64), ("320->64 (WindowUnit_l2)", 320, 64),
              ("64->64 (OSAdapt)", 64, 64)]


def conv_case(rng, label, k, chans, cout, per_sample, epi, dtype, device, b=WINDOWS):
    h, w = LR_HW
    cin = sum(chans)
    parts = [_rand(rng, (b, c, h, w), dtype, device) for c in chans]
    wshape = ((b,) if per_sample else ()) + (cout, cin, k, k)
    weight = _rand(rng, wshape, dtype, device, std=(cin * k * k) ** -0.5)
    use_pre, use_scale, act, use_res = epi
    # the folded OSConv weight has no bias; every other conv has one
    bias = None if label.startswith("osconv") else _rand(rng, (cout,), dtype, device, 0.1)
    pre = _rand(rng, (b, cout, h, w), dtype, device) if use_pre else None
    out_scale = (torch.from_numpy(rng.uniform(0.5, 1.5, (b, cout)).astype(np.float32))
                 .to(device) if use_scale else None)
    lrelu = {True: (0.6, 0.4), "relu": (0.5, 0.5), False: None}[act]
    res = _rand(rng, (b, cout, h, w), dtype, device) if use_res else None
    x_cat = torch.cat(parts, 1)

    def kernel():
        return conv_fused(parts, weight, bias, pre_add=pre, out_scale=out_scale,
                          lrelu=lrelu, residual=res)

    def plain():
        return conv_fused_plain(parts, weight, bias, pre, out_scale, lrelu, res)

    def library():
        if per_sample:
            return F.conv2d(x_cat.reshape(1, b * cin, h, w), weight.reshape(b * cout, cin, k, k),
                            None if bias is None else bias.repeat(b), padding=k // 2, groups=b)
        return F.conv2d(x_cat, weight, bias, padding=k // 2)

    name = "conv3x3" if k == 3 else "conv1x1"
    flops = 2.0 * k * k * cin * cout * h * w * b
    io = nbytes(*parts, weight, bias, pre, out_scale, res) + b * cout * h * w * x_cat.element_size()
    return check(name, label, kernel, plain, library, flops, io, dtype, device)


def osconv_agg_case(rng, label, cin, cout, as_dx, dtype, device, b=TRAIN_B):
    """Kernel 6 at a training shape, per call of the wrapper (weight repack
    and pitch copies included): forward, or the backward's dx call
    (osconv_agg_dx on agg as it lies; the plain version and the library
    call take the flipped, channel-swapped copy)."""
    h, w = TRAIN_HW
    agg = _rand(rng, (b, 3, 3, cin, cout), dtype, device, std=(cin * 9) ** -0.5)
    if as_dx:  # the cotangent through the flipped, channel-swapped weight
        x = _rand(rng, (b, cout, h, w), dtype, device)
        w_conv = agg.flip(1, 2).transpose(3, 4).contiguous()
        kernel = lambda: osconv_agg_dx(x, agg, 1)  # noqa: E731
    else:
        x = _rand(rng, (b, cin, h, w), dtype, device)
        w_conv = agg
        kernel = lambda: osconv_agg(x, agg, 1)  # noqa: E731
    ci, co = w_conv.shape[3], w_conv.shape[4]
    w_oihw = w_conv.permute(0, 4, 3, 1, 2).reshape(b * co, ci, 3, 3).contiguous()

    def library():
        return F.conv2d(x.reshape(1, b * ci, h, w), w_oihw, padding=1, groups=b)

    flops = 2.0 * 9 * ci * co * h * w * b
    io = nbytes(x, agg) + b * co * h * w * x.element_size()
    return check("osconv_agg", label, kernel, lambda: osconv_agg_plain(x, w_conv, 1), library,
                 flops, io, dtype, device, graph=True)


def osconv_dagg_case(rng, label, cin, cout, dtype, device, b=TRAIN_B):
    """Kernel 7 at a training shape. Its output is f32 for both input types
    and both it and the plain version widen the inputs to f32 before they
    multiply, so they differ only in the order of the f32 sum over the 3600
    pixels: 1e-4 of max|plain| for f32 and bf16 inputs alike. The kernel's
    sum order is fixed (chunk partials added in chunk order), so a second
    launch must give the same bits."""
    h, w = TRAIN_HW
    x = _rand(rng, (b, cin, h, w), dtype, device)
    g = _rand(rng, (b, cout, h, w), dtype, device)

    def library():
        return torch.nn.grad.conv2d_weight(x.reshape(1, b * cin, h, w), (b * cout, cin, 3, 3),
                                           g.reshape(1, b * cout, h, w), padding=1, groups=b)

    if not torch.equal(osconv_dagg(x, g, 3, 3, 1), osconv_dagg(x, g, 3, 3, 1)):
        raise AssertionError(f"osconv_dagg {label}: two launches disagree")
    flops = 2.0 * 9 * cin * cout * h * w * b
    io = nbytes(x, g) + b * 9 * cin * cout * 4
    return check("osconv_dagg", label, lambda: osconv_dagg(x, g, 3, 3, 1),
                 lambda: osconv_dagg_plain(x, g, 3, 3, 1), library, flops, io, dtype, device,
                 tol=1e-4, graph=True)


def osconv_function_check(rng, device, dtype=torch.float32, cin=192, b=TRAIN_B) -> None:
    """The autograd Function's dx and dagg (kernels) against autograd through
    the plain version at cin -> 64: f32 within 1e-4 of each gradient's max
    (f32 sums in another order); bf16 (the tensor-core path: the dx call's
    folded flip-and-swap repack, the weight gradient cast to bf16) within
    TOL[bf16] of it (each side rounds once to bf16)."""
    h, w = TRAIN_HW
    tol = 1e-4 if dtype == torch.float32 else TOL[dtype]
    x = _rand(rng, (b, cin, h, w), dtype, device)
    agg = _rand(rng, (b, 3, 3, cin, 64), dtype, device, std=(cin * 9) ** -0.5)
    cot = _rand(rng, (b, 64, h, w), dtype, device)
    grads = []
    for fn in (osconv_agg_train, osconv_agg_plain):
        xr, ar = x.clone().requires_grad_(), agg.clone().requires_grad_()
        (fn(xr, ar, 1).float() * cot.float()).sum().backward()
        grads.append((xr.grad, ar.grad))
    for name, got, want in zip(("dx", "dagg"), *grads):
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        ok = got.dtype == dtype and err <= tol * scale
        log(f"[kernels] osconv_agg_train {DT_NAME[dtype]} {cin}->64 {name} vs autograd of the "
            f"plain version: err {err:.3e} (tol {tol * scale:.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"osconv_agg_train {DT_NAME[dtype]} {cin}->64 {name} disagrees "
                                 f"with autograd: {err} ({got.dtype})")


def sta_case(rng, model, dtype, device, b=WINDOWS):
    h, w = LR_HW
    c = model.cfg.num_feat
    kc = model.upsample.kernel_conv[0]
    x = _rand(rng, (b, c, h, w), dtype, device)
    st = _rand(rng, (b, c, h, w), dtype, device)
    wk, bk = kc.weight.to(dtype), kc.bias.to(dtype)
    # the K product (2*25*C*C FLOPs a pixel) fits the tensor cores in bf16;
    # the 25-tap filter (2*25*C) is a per-pixel, per-channel multiply-add
    # with no matrix form, so it runs at the f32 CUDA-core rate in both
    # types. In bf16 the tensor cores run beside the FP32 pipe, so the
    # slower of the two sets the bound; in f32 one pipe does both
    k_flops, filter_flops = 2.0 * 25 * c * c * h * w * b, 2.0 * 25 * c * h * w * b
    t_k, t_filter = k_flops / PEAK_FLOPS[dtype], filter_flops / PEAK_FLOPS[torch.float32]
    ops_ms = (max(t_k, t_filter) if dtype == torch.bfloat16 else t_k + t_filter) * 1e3
    io = nbytes(x, st, wk, bk) + x.numel() * x.element_size()  # the output is x-sized
    return check("sta", f"C={c} {h}x{w}", lambda: sta_conv_fused(x, st, wk, bk),
                 lambda: sta_conv_fused_plain(x, st, wk, bk), None, k_flops + filter_flops, io,
                 dtype, device, ops_ms=ops_ms)


def stau_case(rng, model, statics, dtype, device, b=WINDOWS):
    h, w = LR_HW
    up = model.upsample
    c = model.cfg.num_feat
    pix = statics["pix"]
    n = up.weight_compress.shape[0]
    H, W = pix.shape[1:]
    x = _rand(rng, (b, c, h, w), dtype, device)
    sta = _rand(rng, (b, c, h, w), dtype, device)
    wts = [t.to(dtype) for t in (up.weight_compress, up.weight_expand, up.fusion.weight)]
    bias = up.fusion.bias
    args = (x, sta, pix, *wts, bias)
    plan = statics["stau_plan"]  # the serving path's: planned once per shape and scale
    cout = wts[2].shape[0]
    # 2 bilinear gathers (4 taps, C channels), compress + expand (n*C/8 x C
    # each), routing mixes, and the 2C -> Cout fusion, per HR pixel
    flops = (16.0 * c + 4.0 * n * (c // 8) * c + 4.0 * n * (c // 8) + 4.0 * c * cout) * H * W * b
    io = nbytes(x, sta, pix, *wts, bias) + b * cout * H * W * x.element_size()
    return check("stau", f"C={c} {h}x{w} -> {H}x{W}", lambda: stau_upsample_fused(*args, plan=plan),
                 lambda: stau_upsample_fused_plain(*args), None, flops, io, dtype, device)


def tail_case(rng, model, dtype, device, b=WINDOWS):
    h, w = LR_HW
    H, W = get_hw(h, w, SCALE)
    c = model.cfg.num_feat
    sr = _rand(rng, (b, c, H, W), dtype, device)
    xc = torch.from_numpy(rng.random((b, 3, h, w)).astype(np.float32)).to(device, dtype)
    o = tail_operands(h, w, H, W, device)
    wt, bt = model.tail.weight.to(dtype), model.tail.bias.to(dtype)
    args = (sr, xc, o["tail_j0"], o["tail_wy"], o["tail_c0"], o["tail_cw"], wt, bt)

    def library():
        return F.conv2d(sr, wt, bt, padding=1) + F.interpolate(
            xc, size=(H, W), mode="bilinear", align_corners=False)

    flops = (2.0 * 27 * c + 3 * 6.0) * H * W * b
    io = nbytes(sr, xc, wt, bt, *(o[k] for k in o)) + b * 3 * H * W * sr.element_size()
    return check("tail", f"C={c} {H}x{W}", lambda: tail_fused(*args),
                 lambda: tail_fused_plain(*args), library, flops, io, dtype, device)


def phase_kernels(model, device) -> list:
    """Every kernel against its plain version at its path's shapes."""
    rng = np.random.default_rng(0)
    rows = []
    with float32_precision(True):
        for scale in ((4.0, 4.0), (1.5, 3.5), (3.05, 3.05)):
            plan = model.stau_statics(LR_HW, scale, device=device)["stau_plan"]
            sizes = plan[:, 4] * plan[:, 5] + plan[:, 6] * plan[:, 7]
            log(f"[kernels] stau window plan x{scale[0]}x{scale[1]} {LR_HW[0]}x{LR_HW[1]}: "
                f"{plan.shape[0]} tiles, {int((plan[:, 4] == 0).sum())} gathered from device "
                f"memory, staged box slots max {int(sizes.max())} mean "
                f"{float(sizes.float().mean()):.1f} of {STAGE_CAP}")
        statics = model.stau_statics(LR_HW, SCALE, dtype=torch.float32, device=device)
        for dtype in (torch.float32, torch.bfloat16):
            for case in CONV_CASES:
                rows.append(conv_case(rng, *case, dtype, device))
            rows.append(sta_case(rng, model, dtype, device))
            rows.append(stau_case(rng, model, statics, dtype, device))
            rows.append(tail_case(rng, model, dtype, device))
            for case in OSCONV_CASES:
                rows.append(osconv_agg_case(rng, *case, dtype, device))
            for case in DAGG_CASES:
                rows.append(osconv_dagg_case(rng, *case, dtype, device))
        osconv_function_check(rng, device)
        for _, cin, _ in DAGG_CASES:
            osconv_function_check(rng, device, torch.bfloat16, cin)
    failed = [f"{r['name']} {r['case']} {r['dtype']}" for r in rows if not r["ok"]]
    if failed:
        raise AssertionError(f"kernels disagree with their plain versions: {failed}")
    return rows


def deviation_psnr(y: np.ndarray, ref: np.ndarray) -> float:
    mse = float(((y.astype(np.float64) - ref.astype(np.float64)) ** 2).mean())
    return float("inf") if mse == 0 else float(10 * np.log10(1.0 / mse))


def require_kernels_ran(phase: str, kernels=SERVING_KERNELS) -> dict:
    """The launch counts since the last reset: every kernel of ``kernels``
    (the path's own) must have launched and no plain version may have run on
    the card."""
    launches, plain = dict(ops.launches), dict(ops.plain_cuda_calls)
    if any(launches[k] == 0 for k in kernels) or any(plain.values()):
        raise AssertionError(f"{phase}: kernel launches {launches}, plain versions on the "
                             f"card {plain}")
    return launches


def phase_parity(model, device) -> None:
    """Strict tier, flagship weights, against the torch reference outputs."""
    g = np.load(os.path.join(GOLDENS, "savsr_realsize_forward.npz"))
    x = torch.from_numpy(g["x"]).to(device)
    ops.reset_counts()
    for key, scale in (("y", (4.0, 4.0)), ("y_1.5_3.5", (1.5, 3.5)),
                       ("y_3.05_3.05", (3.05, 3.05))):
        statics = model.stau_statics(x.shape[-2:], scale, dtype=x.dtype)
        y = model(x, scale, stau_statics=statics).cpu().numpy()
        if device.type == "cuda":
            torch.cuda.synchronize()
        ref = g[key]
        if y.shape != ref.shape or not np.isfinite(y).all():
            raise AssertionError(f"parity {key}: shape {y.shape} vs {ref.shape} or non-finite")
        psnr = deviation_psnr(y, ref)
        log(f"[parity] strict x{scale[0]}x{scale[1]} {tuple(x.shape)} -> {y.shape}: "
            f"deviation PSNR {psnr:.2f} dB, max abs {np.abs(y - ref).max():.3e}")
        if not psnr > 100:
            raise AssertionError(f"parity {key}: deviation PSNR {psnr:.2f} dB <= 100")
    launches = require_kernels_ran("parity")
    log(f"[parity] kernel launches over the three forwards: {launches}")


def write_clip(root: str, n: int, hw) -> str:
    import cv2

    rng = np.random.default_rng(1)
    d = os.path.join(root, "clip")
    os.makedirs(d)
    base = (rng.random((hw[0] // 4, hw[1] // 4, 3)) * 255).astype(np.float32)
    base = cv2.resize(base, (hw[1], hw[0]), interpolation=cv2.INTER_CUBIC)
    for i in range(n):
        noise = rng.normal(0, 4, base.shape)
        img = np.clip(np.roll(base, 2 * i, axis=1) + noise, 0, 255).astype(np.uint8)
        cv2.imwrite(os.path.join(d, f"{i:08d}.png"), img)
    return d


def phase_serving(sd, device, n_frames: int = 8, hw=LR_HW, windows: int = WINDOWS) -> dict:
    """The port's CLI on a seeded clip, bf16 tier; returns the main-path
    run's kernel launches and rates."""
    import cv2

    from savsr_tpu_torch.data.data_util import paths_from_folder, read_img_seq

    with tempfile.TemporaryDirectory() as tmp:
        clip = write_clip(tmp, n_frames, hw)
        pth = os.path.join(tmp, "savsr.pth")
        torch.save({"params": {k: torch.from_numpy(v) for k, v in sd.items()}}, pth)
        argv = ["-i", clip, "-s", str(SCALE[0]), "-w", pth, "--tier", "bf16",
                "--windows", str(windows), "--device", str(device)]
        warm = []
        t0 = time.perf_counter()
        serve_main(argv + ["-o", os.path.join(tmp, "warm")], stats=warm)
        warm_s = time.perf_counter() - t0
        # the main-path run: counts zeroed just before, read just after
        stats = []
        ops.reset_counts()
        t0 = time.perf_counter()
        serve_main(argv + ["-o", os.path.join(tmp, "out")], stats=stats)
        wall = time.perf_counter() - t0
        launches = require_kernels_ran("serving")
        H, W = get_hw(hw[0], hw[1], SCALE)
        outs = paths_from_folder(os.path.join(tmp, "out"))
        frames = [cv2.imread(p) for p in outs]
        if len(frames) != n_frames or any(f is None or f.shape != (H, W, 3) for f in frames):
            raise AssertionError(f"serving wrote {len(frames)} frames of "
                                 f"{[None if f is None else f.shape for f in frames[:2]]}")
        n_chunk, chunk_s = stats[0]
        log(f"[serving] {n_frames} frames {hw[0]}x{hw[1]} -> {H}x{W} bf16, windows {windows}: "
            f"first run {warm_s:.3f} s (first chunk {warm[0][1] * 1e3:.1f} ms); "
            f"main-path run {wall:.3f} s wall incl. IO")
        log(f"[serving] steady chunk: {n_chunk} frames in {chunk_s * 1e3:.1f} ms = "
            f"{chunk_s * 1e3 / n_chunk:.2f} ms/frame, {n_chunk / chunk_s:.3f} fps "
            f"(dispatch to frames on the host)")
        log(f"[serving] kernel launches in the main-path run: {launches} "
            f"({ {k: v / n_frames for k, v in launches.items()} } per frame)")

        # bf16 against the strict tier on the first window
        lr = read_img_seq(paths_from_folder(clip))
        idx = generate_frame_indices(0, n_frames, 7, padding="reflection")
        win = torch.from_numpy(lr[idx].transpose(0, 3, 1, 2).copy())[None].to(device)
        outs_f = {}
        for tier in ("strict", "bf16"):
            m = load_params(build_serving_model(tier), pth, tier, device=device)
            dt = torch.bfloat16 if tier == "bf16" else torch.float32
            outs_f[tier] = m(win.to(dt), SCALE).float().cpu().numpy()
            del m
        psnr = deviation_psnr(outs_f["bf16"], outs_f["strict"])
        strict8 = np.round(np.clip(outs_f["strict"][0], 0, 1) * 255).astype(np.int16)
        lsb = int(np.abs(frames[0].astype(np.int16) - strict8[::-1].transpose(1, 2, 0)).max())
        log(f"[serving] bf16 vs strict on window 0: deviation PSNR {psnr:.2f} dB; "
            f"written frame 0 vs rounded strict: max {lsb} LSB")
        if not psnr >= 50:
            raise AssertionError(f"bf16 vs strict deviation PSNR {psnr:.2f} dB < 50")
    return {"launches": launches, "ms_per_frame": chunk_s * 1e3 / n_chunk,
            "fps": n_chunk / chunk_s, "bf16_vs_strict_db": psnr}


def device_rows(prof) -> list:
    """(kernel, device ms, count) of a profile's device-side events, largest
    first: kernels and copies only (the host ops that launched them carry the
    same device time, and a record_function range's device-side span covers
    its kernels, so either would count it twice)."""
    return sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation and e.self_device_time_total > 0),
                  key=lambda r: -r[1])


def phase_profile(sd, device, windows: int = WINDOWS) -> None:
    """Device time by kernel over one bf16 serving forward of ``windows``
    windows (torch.profiler), against the forward's unprofiled time."""
    from torch.profiler import ProfilerActivity, profile

    model = build_serving_model("bf16")
    load_into(model, {k: torch.from_numpy(v) for k, v in sd.items()})
    model.to(device=device, dtype=torch.bfloat16)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.random((windows, 7, 3) + LR_HW, dtype=np.float32)).to(
        device, torch.bfloat16)
    statics = model.stau_statics(LR_HW, SCALE, dtype=torch.bfloat16, device=device)
    fwd_ms = timed_ms(lambda: model(x, SCALE, stau_statics=statics), device, reps=3, iters=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model(x, SCALE, stau_statics=statics)
        if device.type == "cuda":
            torch.cuda.synchronize()
    rows = device_rows(prof)
    total = sum(r[1] for r in rows)
    log(f"[profile] bf16 forward of {windows} windows {LR_HW[0]}x{LR_HW[1]} x{SCALE[0]}: "
        f"{fwd_ms:.2f} ms unprofiled; device busy {total:.2f} ms "
        f"({100 * total / fwd_ms:.1f}% of the forward)")
    for name, ms, count in rows[:12]:
        log(f"[profile] {ms:9.3f} ms {100 * ms / total:5.1f}% x{count:<5d} {name[:90]}")
    port = [r for r in rows if any(f"{k}_kernel" in r[0] for k in (
        "conv_fused", "conv_wgmma", "sta", "stau", "stau_mma", "tail", "tail_mma"))]
    port_ms = sum(r[1] for r in port)
    log(f"[profile] the port's kernels {port_ms:.2f} ms in {sum(r[2] for r in port)} launches; "
        f"everything else {total - port_ms:.2f} ms in {sum(r[2] for r in rows) - sum(r[2] for r in port)} "
        f"device events")
    # the bf16 conv's weight repack (ops/conv.py pack_weight: a zero pad and
    # an index_select, whose CUDA kernel is PyTorch's gather, for each
    # per-sample OSConv weight; shared weights keep their packed copy)
    repack = [r for r in rows if "scatter_gather" in r[0]]
    log(f"[profile] gather kernels (the bf16 conv weight repack): "
        f"{sum(r[1] for r in repack):.2f} ms in {sum(r[2] for r in repack)} launches")


SMALL_CFG = dict(num_in_ch=3, num_feat=16, num_frame=7, slid_win=3, fusion_win=5, interval=0,
                 w1_num_block=2, w2_num_block=1, n_resgroups=1, n_resblocks=2)


def phase_train_parity(device) -> None:
    """Small config, strict f32 (TF32 off) on the card: one Charbonnier loss
    + backward on the golden batch against the torch oracle's gradients, at
    the bounds tests/test_grad_parity.py holds the JAX package to (loss 1e-5;
    every gradient within 2e-3 of its own max)."""
    golden = np.load(os.path.join(GOLDENS, "savsr_small_grads.npz"))
    model = SAVSR(**SMALL_CFG, remat_train=False)
    load_into(model, {k: torch.from_numpy(v)
                      for k, v in np.load(os.path.join(GOLDENS, "savsr_small_state.npz")).items()})
    model.to(device).train()
    lq, gt = torch.from_numpy(golden["lq"]).to(device), torch.from_numpy(golden["gt"]).to(device)
    ops.reset_counts()
    sr, _ = model(lq, (2.0, 2.0), train=True)
    loss = torch.sqrt((sr - gt) ** 2 + 1e-12).mean()
    loss.backward()
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = require_kernels_ran("train-parity", TRAINING_KERNELS)
    # per gradient: |d| <= 2e-3 * max|ref| + 1e-7. The absolute term is for
    # the near-dead gradients (the routing biases in front of a
    # batch-statistics BatchNorm, max|ref| < 1e-6, where the golden itself is
    # f32 cancellation noise of sums of O(1e-2) terms); it is 1e-4 of the
    # smallest live gradient's 2e-3 band and changes nothing for the rest.
    worst_rel, worst_abs, failed = (0.0, None), (0.0, None), []
    for k, p in model.named_parameters():
        ref = golden["g/" + k]
        err, ref_max = float(np.abs(p.grad.cpu().numpy() - ref).max()), float(np.abs(ref).max())
        if ref_max >= 1e-5:
            worst_rel = max(worst_rel, (err / ref_max, k))
        else:
            worst_abs = max(worst_abs, (err, k))
        if not err <= 2e-3 * ref_max + 1e-7:
            failed.append((k, err, ref_max))
    d_loss = abs(float(loss.detach()) - float(golden["loss"]))
    log(f"[train-parity] small config f32: loss {float(loss.detach()):.8f} vs golden "
        f"{float(golden['loss']):.8f} (|d| {d_loss:.2e}, bound 1e-5); worst gradient "
        f"{worst_rel[0]:.3e} of its max at {worst_rel[1]} (bound 2e-3); near-dead gradients "
        f"(max < 1e-5): worst |d| {worst_abs[0]:.2e} at {worst_abs[1]} (bound 1e-7); launches "
        f"osconv_agg {launches['osconv_agg']}, osconv_dagg {launches['osconv_dagg']}")
    if not d_loss < 1e-5 or failed:
        raise AssertionError(f"train-parity: loss off by {d_loss}, gradients off: {failed[:5]}")


TRAIN_ITERS = 6
TRAIN_YML = """
name: smoke_SAVSR_Vimeo90K_asBI
model_type: ASVSRModel
num_gpu: 1
manual_seed: 114514
datasets:
  train:
    name: Vimeo90K
    type: ASVimeo90KDataset
    dataroot_gt: {root}/sequences
    dataroot_lq: {root}/sequences
    meta_info_file: {root}/meta.txt
    io_backend:
      type: disk
    num_frame: 7
    lq_size: 60
    downsample_mode: torch
    init_int_scale: true
    single_scale_ft: false
    CL_train_set: [240, 3, 5]
    gt_size: 256
    interval_list: [1]
    random_reverse: true
    use_hflip: true
    use_rot: true
    flip_sequence: false
    num_worker_per_gpu: 4
    batch_size_per_gpu: 16
    # 32 septuplets stand in for the 64,612 of Vimeo90K: enlarged so that the
    # 6 iterations stay inside one epoch, as they do on the real set (the
    # loader restarts its workers at every epoch boundary)
    dataset_enlarge_ratio: 4
    prefetch_mode: device
network_g:
  type: SAVSR
  num_in_ch: 3
  num_feat: 64
  num_frame: 7
  slid_win: 3
  fusion_win: 5
  interval: 0
  w1_num_block: 4
  w2_num_block: 2
  n_resgroups: 4
  n_resblocks: 8
  center_frame_idx: ~
  osconv_impl: pallas_train
  remat_train: false
path:
  pretrain_network_g: ~
  strict_load_g: true
  resume_state: ~
train:
  ema_decay: 0.999
  bf16: true
  accum_steps: 2
  aot_cache: true
  optim_g:
    type: Adam
    lr: !!float 2e-4
    weight_decay: 0
    betas: [0.9, 0.999]
  scheduler:
    type: CosineAnnealingRestartLR
    periods: [300000, 300000, 300000, 300000]
    restart_weights: [1, 0.5, 0.5, 0.5]
    eta_min: !!float 1e-7
  total_iter: {iters}
  warmup_iter: -1
  pixel_opt:
    type: CharbonnierLoss
    loss_weight: 1.0
    reduction: mean
logger:
  print_freq: 1
  save_checkpoint_freq: {iters}
  use_tb_logger: false
  wandb:
    project: ~
    resume_id: ~
"""


def write_septuplets(root: str, n: int, hw=(256, 448)) -> None:
    """``n`` seeded Vimeo-style septuplets (smooth texture + noise, shifted
    from frame to frame) and their meta file."""
    import cv2

    rng = np.random.default_rng(3)
    lines = []
    for i in range(n):
        key = f"{1 + i // 1000:05d}/{1 + i % 1000:04d}"
        d = os.path.join(root, "sequences", key)
        os.makedirs(d)
        base = (rng.random((hw[0] // 8, hw[1] // 8, 3)) * 255).astype(np.float32)
        base = cv2.resize(base, (hw[1], hw[0]), interpolation=cv2.INTER_CUBIC)
        for t in range(1, 8):
            img = np.roll(base, 2 * t, axis=1) + rng.normal(0, 3, base.shape)
            cv2.imwrite(os.path.join(d, f"im{t}.png"), np.clip(img, 0, 255).astype(np.uint8))
        lines.append(f"{key} 7 ({hw[0]},{hw[1]},3)\n")
    with open(os.path.join(root, "meta.txt"), "w") as f:
        f.writelines(lines)


def expected_osconv_launches(cfg, accum: int) -> dict:
    """OSConv kernel launches of one optimizer step, from the architecture:
    per micro-batch forward, every WindowUnit_l1 block but the first has one
    OSConv (two chains x n_iter windows), every WindowUnit_l2 block has one
    per sliding window, every residual group one OSAdapt; the backward
    launches kernel 6 once more (dx) and kernel 7 once for each."""
    n_iter = cfg.iter_win - cfg.slid_win + 1
    fwd = 2 * n_iter * (cfg.w1_num_block - 1)
    for i in range((cfg.iter_win - cfg.fusion_win + 1) // 2):
        win_size = n_iter - 2 * i
        fwd += (win_size - cfg.fusion_win + 1) * cfg.w2_num_block
    fwd += cfg.n_resgroups
    return {"osconv_agg": 2 * fwd * accum, "osconv_dagg": fwd * accum}


def phase_training(device, n_seq: int = 32, iters: int = TRAIN_ITERS, yml: str = TRAIN_YML) -> dict:
    """The port's trainer through its entry point on seeded septuplets: the
    training main-path run (kernel counts zeroed just before, read just
    after), then a profile of one more step of the trained model."""
    from savsr_tpu_torch.train import train_pipeline
    from savsr_tpu_torch.utils.convert import load_checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_septuplets(tmp, n_seq)
        cfg_path = os.path.join(tmp, "train_smoke.yml")
        with open(cfg_path, "w") as f:
            f.write(yml.format(root=tmp, iters=iters))
        data_s = time.perf_counter() - t0
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        stats = []
        ops.reset_counts()
        model = train_pipeline(tmp, ["-opt", cfg_path, "--device", str(device)], stats=stats)
        if device.type == "cuda":
            torch.cuda.synchronize()
            launches = require_kernels_ran("training", TRAINING_KERNELS)
        else:
            launches = dict(ops.launches)
        peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0

        accum = int(model.opt["train"].get("accum_steps", 1))
        expect = {k: v * iters for k, v in expected_osconv_launches(model.net_g.cfg, accum).items()}
        if device.type == "cuda" and any(launches[k] != v for k, v in expect.items()):
            raise AssertionError(f"training: OSConv launches {launches}, expected {expect}")
        losses = [log_vars["l_pix"] for _, _, log_vars in stats]
        if len(stats) != iters or not all(np.isfinite(losses)):
            raise AssertionError(f"training: {len(stats)} steps, losses {losses}")
        exp = os.path.join(tmp, "experiments", "smoke_SAVSR_Vimeo90K_asBI")
        ckpt = os.path.join(exp, "models", f"net_g_{iters}.npz")
        state_path = os.path.join(exp, "training_states", f"{iters}.state")
        fresh = SAVSR(**{k: v for k, v in model.opt["network_g"].items() if k != "type"})
        for key in ("params", "params_ema"):
            load_into(fresh, load_checkpoint(ckpt, key))
        state = torch.load(state_path, map_location="cpu", weights_only=True)
        if state["iter"] != iters:
            raise AssertionError(f"training: {state_path} holds iter {state['iter']}")
        live = model.net_g.state_dict()
        if not all(torch.equal(v, live[k].cpu()) for k, v in load_checkpoint(ckpt).items()):
            raise AssertionError("training: the reloaded checkpoint differs from the live network")

    batch = model.lq.shape[0]
    steady = [s for i, s, _ in stats if i > 2]
    ms_step = 1e3 * float(np.mean(steady))
    log(f"[training] wrote {n_seq} septuplets in {data_s:.1f} s; {iters} steps of B={batch} "
        f"(= {accum} x {batch // accum}) {tuple(model.lq.shape[-2:])} LR crops at x{model.scale}, "
        f"bf16 {model.opt['train'].get('bf16')}: losses {[round(v, 5) for v in losses]}")
    log(f"[training] step seconds (host clock, each step ends in the loss fetch): "
        f"{[round(s, 4) for _, s, _ in stats]}")
    log(f"[training] steady (steps 3-{iters}): {ms_step:.2f} ms/step, "
        f"{batch / (ms_step / 1e3):.3f} samples/s; peak memory "
        f"{peak / 2 ** 30:.3f} GiB; checkpoint net_g_{iters}.npz + {iters}.state reloaded")
    log(f"[training] OSConv kernel launches over the {iters} steps: {launches} "
        f"(per step: {({k: launches[k] // iters for k in TRAINING_KERNELS})}, as the "
        f"architecture gives them)")
    phase_train_profile(model, device)
    return {"launches": launches, "ms_per_step": ms_step, "samples_per_s": batch / (ms_step / 1e3),
            "peak_bytes": peak, "losses": losses}


def phase_train_profile(model, device) -> None:
    """Device time by kernel over one more training step on the last batch
    (torch.profiler), against the step's unprofiled time."""
    from torch.profiler import ProfilerActivity, profile

    def step():
        model.optimize_parameters(0)
        if device.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    step()
    step_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
    rows = device_rows(prof)
    total = sum(r[1] for r in rows)
    log(f"[train-profile] one step of B={model.lq.shape[0]} at x{model.scale}: {step_ms:.2f} ms "
        f"unprofiled; device busy {total:.2f} ms ({100 * total / step_ms:.1f}% of the step) in "
        f"{sum(r[2] for r in rows)} device events")
    for name, ms, count in rows[:14]:
        log(f"[train-profile] {ms:9.3f} ms {100 * ms / max(total, 1e-9):5.1f}% x{count:<5d} "
            f"{name[:90]}")
    osconv_share(prof, rows, total)


def osconv_share(prof, rows, total: float) -> None:
    """The OSConv wrappers' device time in a training-step profile. The
    kernels of csrc/ (launched through ctypes) are found by name — the
    training step runs no other bf16 conv, its plain convs go to cuDNN — and
    the PyTorch kernels each wrapper adds (the weight repack, the pitch
    copies) by the wrapper's record_function range; a kernel the profiler
    links to a range is not counted twice."""
    def is_port(name):
        return any(n in name for n in ("osconv_", "dagg_reduce", "conv_wgmma_kernel"))

    def kernels(ev):
        yield from ((k.name, k.duration) for k in ev.kernels)
        for child in ev.cpu_children:
            yield from kernels(child)

    calls = {k: 0 for k in TRAINING_KERNELS}
    in_ranges = []
    for ev in prof.events():
        if ev.name in calls and ev.device_type == torch.autograd.DeviceType.CPU:
            calls[ev.name] += 1
            in_ranges += list(kernels(ev))
    added_ms = sum(us for name, us in in_ranges if not is_port(name)) / 1e3
    port = [r for r in rows if is_port(r[0])]
    port_ms = sum(r[1] for r in port)
    share = port_ms + added_ms
    log(f"[train-profile] the OSConv wrappers {share:.2f} ms ({100 * share / max(total, 1e-9):.1f}% "
        f"of device time) in {calls} calls: their kernels {port_ms:.2f} ms in "
        f"{sum(r[2] for r in port)} launches ("
        + "; ".join(f"{name[:48]} {ms:.2f} ms x{count}" for name, ms, count in port)
        + f"), the repack and pitch copies inside their ranges {added_ms:.2f} ms in "
        f"{sum(1 for name, _ in in_ranges if not is_port(name))} launches")


def tensor_core_count(lib_path: str):
    """(HMMA, HGMMA) instructions in a library's SASS — mma.sync and wgmma
    — or None without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.isfile(tool):
        return None
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout.splitlines()
    return (sum(1 for line in sass if "HMMA" in line), sum(1 for line in sass if "HGMMA" in line))


# the tensor-core instruction each library's bf16 kernels must contain
TENSOR_CORE_OPS = {"conv": "HGMMA", "osconv": "HGMMA", "sta": "HGMMA", "stau": "HMMA",
                   "tail": "HMMA"}


def phase_build() -> None:
    t0 = time.perf_counter()
    build.build_all()
    log(f"[build] nvcc {' '.join(build.NVCC_FLAGS)}: {time.perf_counter() - t0:.1f} s "
        f"for {', '.join(f'{n}.cu' for n in build.SOURCES)}")
    for name in build.SOURCES:
        log_path = build.library_path(name) + ".log"
        if os.path.isfile(log_path):
            with open(log_path) as f:
                for line in f:
                    if "registers" in line or "spill" in line or "Compiling entry" in line:
                        log(f"[build] {name}: {line.strip()}")
    for name, op in TENSOR_CORE_OPS.items():
        n = tensor_core_count(build.library_path(name))
        if n is None:
            log(f"[build] tensor-core instructions in {name}'s SASS: not counted (no cuobjdump)")
            continue
        log(f"[build] tensor-core instructions in {name}'s SASS: HMMA {n[0]}, HGMMA {n[1]}")
        if n[op == "HGMMA"] == 0:
            raise AssertionError(f"the tensor-core kernels of {name}.cu have no {op} instruction")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=None, help="also write the results as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} "
        f"(nvidia-smi: {smi}), torch {torch.__version__}, CUDA {torch.version.cuda}")

    phase_build()

    sd = dict(np.load(os.path.join(GOLDENS, "savsr_state_dict.npz")))
    model = SAVSR(**flagship_net_kwargs()).eval()
    load_into(model, {k: torch.from_numpy(v) for k, v in sd.items()})
    model.to(device)

    rows = phase_kernels(model, device)
    phase_parity(model, device)
    del model
    torch.cuda.empty_cache()
    serving = phase_serving(sd, device)
    phase_profile(sd, device)
    torch.cuda.empty_cache()
    phase_train_parity(device)
    training = phase_training(device)

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        head = next(r for r in rows if r["name"] == name and r["dtype"] == "bf16"
                    and r["case"] == HEADLINE.get(name, r["case"]))
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": (training if name in TRAINING_KERNELS
                                     else serving)["launches"][name],
                        "max_abs_err": head["max_abs_err"], "ms": head["ms"],
                        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
                        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
                        **{k: head[k] for k in ("graph_ms", "library_graph_ms") if k in head}})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "cases": rows, "serving": serving, "training": training,
                       "kernels": kernels},
                      f, indent=1)
    log(smi)  # the card's name and power limit, as nvidia-smi gives them
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
