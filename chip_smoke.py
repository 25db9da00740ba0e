#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (savsr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Phases (each prints its lines; any failure exits non-zero):

1. build    nvcc compiles the port's CUDA sources (savsr_tpu_torch/csrc/*.cu,
            one process per source, all at once) for sm_90a; prints ptxas's
            registers, spills and any serialised-wgmma line (C7514 /
            C7518), and the tensor-core instructions in the
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
            STAU kernels on the window plans of the serving statics, each at
            its kernel's tile and capacity (each plan's count of tiles
            gathered from device memory is printed for each serving scale);
            the two OSConv kernels at the training
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
            bf16 conv's weight repack (the gather kernels); then the same
            for one strict-tier (f32) forward of 8 windows, with the f32
            conv kernel's share of its device time and its launches.
6. train-parity  the small config in strict f32 on the card: one loss +
            backward on the golden batch, the backward under the forward's
            precision (TF32 off), against the torch oracle's gradients
            (tests/goldens/savsr_small_grads.npz: loss within 1e-5, every
            gradient within 2e-3 of its own max) and the whole gradient
            within 2e-6 relative L2 of the CPU's float32 step, through the
            OSConv kernels, no plain version on the card; then the same at
            matmul_precision default against the CPU's default step.
7. training savsr_tpu_torch.train.train_pipeline on 32 seeded 256x448
            septuplets with the flagship recipe (num_feat 64, B=16 = 2x8
            micro-batches of 60x60 LR crops, bf16, Charbonnier, Adam +
            CosineAnnealingRestartLR, EMA 0.999) and its val_x4 / val:
            blocks (on a seeded 4-frame 576x720 clip), 6 iterations and the
            final validation: losses finite, checkpoint written and
            reloaded, the OSConv kernels' launches per step as the
            architecture gives them, the validation's psnr_y and ssim_y
            finite and the serving kernels launched by it, ms/step and
            samples/s over the steps after the first two (validation
            excluded), peak memory. This is the training main-path run for
            the two OSConv kernels.
8. train-profile  device time by kernel over one more training step of that
            model, against its unprofiled time, and the OSConv wrappers'
            share (their record_function ranges).
9. eval     savsr_tpu_torch.test.test_pipeline on the shipped
            options/test/SAVSR/test_SAVSR_Vid4_asBI.yml (dataroots, weights
            and results root changed only): all 48 datasets (x1.1-x4.0, the
            asymmetric ones, x6-x12) on a seeded 4-frame 576x720 clip with
            the flagship weights, strict f32, batch 1, PNGs written. First
            the f32 kernels against their plain versions at the sweep's
            shapes (x4, x1.1, x(1.5,3.5), x(1.6,3.05), x8, x12: LR and HR
            widths off a multiple of 4 and 8, STAU boxes over the staging
            capacity); then the main-path run of the strict tier's kernels
            (counts zeroed just before, read just after): every serving
            kernel launched, no plain version on the card, finite psnr_y and
            ssim_y for every dataset, per-dataset metrics, seconds per frame
            by part, launches per frame; then frame 0 of x4.0, x1.1 and
            x(1.5,3.5) as saved must equal array2img of a direct forward.

10. split   the split serving tier (conv_precision: split: pair-carried
            bf16 hi/lo convs on the tensor cores, csrc/conv.cu
            conv_split_kernel<K>, a stage one chunk of one pair; STA, STAU
            and the tail on their f32
            kernels): the split conv against its plain version at 8 x
            180x320 (64->64 3x3 with a pair residual, the 3-pair merge, the
            1x1 conv1, the WindowUnit_l1 OSConv's per-sample weight; f32's
            tolerance on the merged values; the library time is F.conv2d in
            bf16 over the stacked [hi, lo, hi] input, the nearest single
            call); the flagship split forward on the 45x80 golden input at
            x4, x(1.5,3.5), x3.05 against the strict forward on the card
            (max abs < 2e-3 and 30x below the bf16 tier's) with its
            deviation PSNR against the reference outputs; the CLI at --tier
            split on the serving clip (the split main-path run: counts
            zeroed just before, read just after; every split and f32 serving
            kernel launched, no native conv); one profiled split forward of
            8 windows (device busy, the split conv's share, every split conv
            on conv_split_kernel<K> and none on conv_wgmma_kernel, the
            device time outside the port's kernels by kernel); and the shipped
            Vid4 config with conv_precision: split on its x4, x1.1 and
            x(1.5,3.5) datasets (psnr_y and ssim_y against the strict sweep
            of phase 9).
11. fast    the fast serving tier (f32 weights and carries at
            matmul_precision: default: every product one bf16 pass, f32
            sums; the convs on conv_fast_kernel<K, RES>, which rounds its f32
            parts itself, STA and the tail on their CUDA-core kernels with the
            tier's rounding points, STAU on stau_mma_kernel<CB, true>): each
            fast kernel against its plain version at 8 x 180x320, C = 64
            (the 3x3 64->64 with an f32 residual, the 3-part merge, the 1x1
            3x64->64, the per-sample OSConv, STA, STAU and the tail; f32's
            tolerance for the convs and STA; for STAU and the tail, whose
            values are rounded inside the kernel where another f32 sum order
            may round one the other way, max abs one bf16 ulp of the output's
            scale and mean abs 1e-5 of it, which a rounding point misplaced
            for every value exceeds;
            the library time of the convs is F.conv2d in bf16 on the rounded
            input, the nearest single call, printed beside the rounding of
            the parts plus that call); the flagship fast forward on
            the 45x80 golden input at x4, x(1.5,3.5), x3.05 against the
            strict forward on the card (deviation PSNR at least the bf16
            tier's, max abs at least 10x the split tier's of phase 10) with
            its deviation PSNR against the reference outputs; the CLI at
            --tier fast on the serving clip (the fast main-path run: counts
            zeroed just before, read just after; every fast kernel launched
            as often as the bf16 run launches its own, no other kernel and
            no plain version); one profiled fast forward of 8 windows
            (device busy, the fast conv's share, PyTorch's copy kernels by
            what they copy: the conv parts, STA's st, STAU's inputs, the
            tail's pitch copy, the rest); and
            the shipped Vid4 config with matmul_precision: default on its
            x4, x1.1 and x(1.5,3.5) datasets (psnr_y and ssim_y against the
            strict sweep of phase 9).
12. dist    distribution, one process per GPU (savsr_tpu_torch/parallel,
            --launcher pytorch). The card machine has one card and NCCL
            takes no two ranks on one device, so two ranks share cuda:0
            over gloo. (a) the flagship (golden weights) in strict f32,
            two ranks under torch.distributed.run, each on its share of a
            global batch of 4 seeded 60x60 septuplets at x4, at accum 1 and
            2, against the one-process step on the whole batch on the card:
            loss within 1e-5, BatchNorm statistics within 1e-6, every
            gradient within 2e-3 of its own max + 1e-7 (phase 6's bounds),
            the ranks' gradients identical, each rank's OSConv launches (its
            counts zeroed just before its step, read just after) as the
            architecture gives them; (b) the training CLI, python -m
            torch.distributed.run --nproc_per_node 2 -m savsr_tpu_torch.train
            --launcher pytorch --device cuda:0, phase 7's copy of the
            shipped recipe over gloo: 4 iterations, a checkpoint every 2 and
            the final validation (exactly one file a save and one log,
            rank 0's), then --auto_resume to 6 (both ranks load the last
            checkpoint), then one rank over NCCL through the same command;
            step times (two ranks sharing one card: not a scaling figure)
            and losses printed; (c) the eval pipeline on two ranks over gloo
            on the shipped Vid4 config's first three datasets, strict, each
            rank's serving kernels launched, the metrics equal to phase 9's
            to the printed digit.
13. spatial spatial sharding of the eval forward (mesh: {spatial: 2},
            savsr_tpu_torch/parallel/spatial.py: each frame split by height
            over the ranks, halo rows exchanged around every conv, the
            OSAdapt mask head, STA, STAU and the tail), two ranks over gloo
            on cuda:0 under torch.distributed.run: (a) one seeded 180x320
            window of the flagship (golden weights) at x4, x(1.5,3.5) and
            x3.05 in each tier, band 0 gathering the output, against the
            one-process forward on the card: strict within 1e-5 max abs, the
            other tiers equal to the bit (the tier's own distance from
            strict printed beside); each rank's launches of the tier's kernels (counts zeroed
            just before each forward, read just after) all nonzero, no plain
            version on the card; each rank's band rows, the rows it
            exchanged (count and bytes) per forward, and its device busy
            time beside one process's; (b) the eval pipeline on the shipped
            Vid4 config's first three datasets with mesh {spatial: 2},
            strict: psnr_y and ssim_y within 1e-4 of phase 9's, band 0
            scoring every frame.
14. spatial-train  spatially sharded training (mesh: {spatial: 2} with a
            train: block: a differentiable halo exchange around every conv,
            the GAPs' and BatchNorms' sums over the bands, each band's share
            of the loss, the gradients summed over the bands), two ranks over
            gloo on cuda:0 under torch.distributed.run: (a) the flagship
            (golden weights) in strict f32 on phase 12's four seeded 60x60
            septuplets at x4 (bands of 30 LR and 120 HR rows), at accum 1
            and 2, against the one-process step on the card (phase 12's):
            loss within 1e-5, BatchNorm statistics within 1e-6, every
            gradient within 2e-3 of its own max + 1e-7, both ranks'
            gradients identical; each rank's launches of rows 6-7 by kernel
            (counts zeroed just before the step, read just after), no plain
            version; the exchanges and bytes sent a rank-step; a rank-step's
            time beside one process's; (b) the training CLI with mesh
            {spatial: 2} on phase 7's copy of the shipped bf16 recipe: 2
            iterations, one checkpoint and the final (sharded) validation,
            written by rank 0 alone, then --auto_resume to 4.

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": <name>, "count": <n>}};
the line before it holds the per-kernel results as one JSON object.
"""

from __future__ import annotations

import argparse
import contextlib
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
from savsr_tpu_torch.ops.conv import (Pair, conv_fused, conv_fused_fast, conv_fused_fast_plain,
                                      conv_fused_plain, conv_fused_split,
                                      conv_fused_split_plain, pair_merge, pair_split,
                                      split_weight)
from savsr_tpu_torch.ops.osconv import (osconv_agg, osconv_agg_dx, osconv_agg_plain,
                                        osconv_agg_train, osconv_dagg, osconv_dagg_plain)
from savsr_tpu_torch.ops.sta import (sta_conv_fused, sta_conv_fused_fast,
                                     sta_conv_fused_fast_plain, sta_conv_fused_plain)
from savsr_tpu_torch.ops.stau import (plan_geometry, stau_upsample_fused,
                                      stau_upsample_fused_fast, stau_upsample_fused_fast_plain,
                                      stau_upsample_fused_plain, stau_window_plan)
from savsr_tpu_torch.ops.tail import (tail_fused, tail_fused_fast, tail_fused_fast_plain,
                                      tail_fused_plain)
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
    # CUDA-core sta_f32_kernel
    "sta": ("savsr_tpu_torch/csrc/sta.cu", "savsr_tpu/ops/pallas/sta_kernel.py:84"),
    # bf16 (the timed headline) runs the tensor-core kernels stau_mma_kernel
    # and tail_mma_kernel; f32 the CUDA-core stau_f32_kernel and
    # tail_f32_kernel
    "stau": ("savsr_tpu_torch/csrc/stau.cu", "savsr_tpu/ops/pallas/stau_kernel.py:183"),
    "tail": ("savsr_tpu_torch/csrc/tail.cu", "savsr_tpu/ops/pallas/tail_kernel.py:89"),
    # bf16 (the training path, the timed headline) runs the bf16 conv's
    # kernel; f32 the f32 conv's (conv.cu conv_f32_kernel)
    "osconv_agg": ("savsr_tpu_torch/csrc/conv.cu",
                   "savsr_tpu/ops/pallas/osconv_kernel.py:139"),
    "osconv_dagg": ("savsr_tpu_torch/csrc/osconv.cu",
                    "savsr_tpu/ops/pallas/osconv_kernel.py:303"),
    # the split tier's convs: the pair-carry mode of kernels 1 and 2
    "conv3x3_split": ("savsr_tpu_torch/csrc/conv.cu", "savsr_tpu/ops/pallas/chw_conv.py:386"),
    "conv1x1_split": ("savsr_tpu_torch/csrc/conv.cu", "savsr_tpu/ops/pallas/chw_conv.py:531"),
    # the fast tier's kernels: the default-precision mode of kernels 1-5
    "conv3x3_fast": ("savsr_tpu_torch/csrc/conv.cu", "savsr_tpu/ops/pallas/chw_conv.py:386"),
    "conv1x1_fast": ("savsr_tpu_torch/csrc/conv.cu", "savsr_tpu/ops/pallas/chw_conv.py:531"),
    "sta_fast": ("savsr_tpu_torch/csrc/sta.cu", "savsr_tpu/ops/pallas/sta_kernel.py:84"),
    "stau_fast": ("savsr_tpu_torch/csrc/stau.cu", "savsr_tpu/ops/pallas/stau_kernel.py:183"),
    "tail_fast": ("savsr_tpu_torch/csrc/tail.cu", "savsr_tpu/ops/pallas/tail_kernel.py:89"),
}
SERVING_KERNELS = ("conv3x3", "conv1x1", "sta", "stau", "tail")
SPLIT_KERNELS = ("conv3x3_split", "conv1x1_split")
# the split tier's path: its convs, and STA, STAU and the tail in f32
SPLIT_SERVING_KERNELS = SPLIT_KERNELS + ("sta", "stau", "tail")
# the fast tier's path: its five kernels and nothing else
FAST_KERNELS = ("conv3x3_fast", "conv1x1_fast", "sta_fast", "stau_fast", "tail_fast")
TIER_KERNELS = {"bf16": SERVING_KERNELS, "split": SPLIT_SERVING_KERNELS, "fast": FAST_KERNELS}
# the CUDA kernels behind each row of the JSON kernels line, by dtype (the
# flagship widths: C = 64, 4 experts; W % 4 == 0)
CUDA_KERNELS = {
    ("conv3x3", "bf16"): "conv_wgmma_kernel<3>",
    ("conv3x3", "f32"): "conv_f32_kernel<3, 1>",
    ("conv1x1", "bf16"): "conv_wgmma_kernel<1>",
    ("conv1x1", "f32"): "conv_f32_kernel<1, 0>",
    ("conv3x3_split", "split"): "conv_split_kernel<3>",
    ("conv1x1_split", "split"): "conv_split_kernel<1>",
    ("sta", "bf16"): "sta_mma_kernel<64>", ("sta", "f32"): "sta_f32_kernel<64, false>",
    ("stau", "bf16"): "stau_mma_kernel<4, false>", ("stau", "f32"): "stau_f32_kernel<64>",
    ("tail", "bf16"): "tail_mma_kernel<4>", ("tail", "f32"): "tail_f32_kernel<false>",
    ("osconv_agg", "bf16"): "conv_wgmma_kernel<3>",
    ("osconv_agg", "f32"): "conv_f32_kernel<3, 1> + conv_f32_reduce_kernel",
    ("osconv_dagg", "bf16"): "osconv_dagg_wgmma_kernel<3> + dagg_reduce_kernel",
    ("osconv_dagg", "f32"): "osconv_dagg_kernel + dagg_reduce_kernel",
    ("conv3x3_fast", "fast"): "conv_fast_kernel<3, true>",
    ("conv1x1_fast", "fast"): "conv_fast_kernel<1, false>",
    ("sta_fast", "fast"): "sta_fast_kernel<64>",
    ("stau_fast", "fast"): "stau_mma_kernel<4, true>",
    ("tail_fast", "fast"): "tail_f32_kernel<true>",
}
TRAINING_KERNELS = ("osconv_agg", "osconv_dagg")
# phase 6's whole-gradient bound at matmul_precision default (train_parity_default)
DEFAULT_GRAD_L2 = 2e-2
# phase 6's whole-gradient bound in strict f32, the card against the CPU's
# step: 2.8e-7 was measured with the backward's TF32 off, 6.0e-5 with it on
STRICT_GRAD_L2 = 2e-6
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
          io_bytes: int, dtype, device, tol=None, graph: bool = False, ops_ms=None,
          value=None, dt_name=None, mean_tol=None) -> dict:
    """Run the kernel and its plain version on the same inputs, compare in
    f32, time both (and the library call), and return the result row.
    ``tol`` (relative to max|plain|) overrides TOL[dtype]; ``mean_tol``
    (relative to max|plain|) also bounds the mean abs error; ``value`` maps an
    output to the f32 tensor compared (default ``.float()``); ``dt_name``
    names the row's type (default that of ``dtype``, whose peak rate holds
    the operations). ``ms`` and
    ``library_ms`` are back-to-back calls between CUDA events; ``graph``
    adds ``graph_ms`` and ``library_graph_ms``, replays of a CUDA graph of
    the calls (device time, repack and copies included, no host launch
    cost), and ``breakdown``, the device time of each kernel of a call."""
    tol = TOL[dtype] if tol is None else tol
    value = value or (lambda y: y.float())
    dt_name = dt_name or DT_NAME[dtype]
    with torch.no_grad():
        want = value(plain_fn())
        got = value(kernel_fn())
        if device.type == "cuda":
            torch.cuda.synchronize()
        diff = (got - want).abs()
        err, mean_err = float(diff.max()), float(diff.mean())
        scale = float(want.abs().max())
        ok = bool(torch.isfinite(got).all()) and err <= tol * scale
        if mean_tol is not None:
            ok = ok and mean_err <= mean_tol * scale
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
    row = {"name": name, "case": label, "dtype": dt_name, "max_abs_err": err,
           "mean_abs_err": mean_err, "max_abs_plain": scale, "ok": ok, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
           "tflops": tflops, "bound_share": b_ms / ms, **graphed}
    lib = "null" if lib_ms is None else f"{lib_ms:.4f}"
    mean = "" if mean_tol is None else f", mean {mean_err:.3e} (tol {mean_tol * scale:.3e})"
    log(f"[kernels] {name:11s} {label:44s} {dt_name:4s} err {err:.3e} "
        f"(tol {tol * scale:.3e}{mean}) ms {ms:.4f} plain {plain_ms:.4f} lib {lib} "
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
            "conv3x3_split": "conv0 64->64 lrelu+pair res", "conv1x1_split": "conv1 3x64->64 lrelu",
            "conv3x3_fast": "conv0 64->64 lrelu+res", "conv1x1_fast": "conv1 3x64->64 lrelu",
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


def conv_case(rng, label, k, chans, cout, per_sample, epi, dtype, device, b=WINDOWS,
              hw=LR_HW):
    h, w = hw
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


# (label, kernel size, input pairs' channels, Cout, per-sample weight, lrelu,
#  pair residual): the split tier's convs of phase 10
SPLIT_CASES = [
    ("conv0 64->64 lrelu+pair res", 3, [64], 64, False, True, True),
    ("merge_l1 3x64->64", 3, [64] * 3, 64, False, False, False),
    ("conv1 3x64->64 lrelu", 1, [64] * 3, 64, False, True, False),
    ("osconv 3x64->64 per-sample lrelu", 3, [64] * 3, 64, True, True, False),
]


def split_conv_case(rng, label, k, chans, cout, per_sample, act, res, device, b=WINDOWS,
                    hw=LR_HW):
    """Kernels 1-2 in their pair-carry mode (the split conv): pair inputs, an
    f32 weight, a pair output, compared on the merged values at f32's
    tolerance. Bound: 3x the bf16 conv's operations at the bf16 tensor-core
    rate against the pairs' bytes (the f32 weight once); library: F.conv2d
    in bf16 over the stacked [hi, lo, hi] input and the [Whi, Whi, Wlo]
    weight, the nearest single call (it computes the same sum)."""
    h, w = hw
    cin = sum(chans)
    f32 = torch.float32
    parts = [pair_split(_rand(rng, (b, c, h, w), f32, device)) for c in chans]
    weight = _rand(rng, ((b,) if per_sample else ()) + (cout, cin, k, k), f32, device,
                   std=(cin * k * k) ** -0.5)
    bias = None if per_sample else _rand(rng, (cout,), f32, device, 0.1)
    residual = pair_split(_rand(rng, (b, cout, h, w), f32, device)) if res else None
    lrelu = (0.6, 0.4) if act else None
    x_stack = torch.cat([t for p in parts for t in (p.hi, p.lo, p.hi)], 1)
    w_stack = split_weight(weight, chans)
    b_stack = None if bias is None else bias.to(torch.bfloat16)

    def library():
        if per_sample:
            return F.conv2d(x_stack.reshape(1, b * 3 * cin, h, w),
                            w_stack.reshape(b * cout, 3 * cin, k, k), padding=k // 2, groups=b)
        return F.conv2d(x_stack, w_stack, b_stack, padding=k // 2)

    name = "conv3x3_split" if k == 3 else "conv1x1_split"
    flops = 3 * 2.0 * k * k * cin * cout * h * w * b
    pair_bytes = sum(nbytes(p.hi, p.lo) for p in parts)
    io = (pair_bytes + nbytes(weight, bias) + (0 if residual is None else nbytes(residual.hi,
                                                                               residual.lo))
          + b * cout * h * w * 4)
    return check(name, label,
                 lambda: conv_fused_split(parts, weight, bias, lrelu=lrelu, residual=residual),
                 lambda: conv_fused_split_plain(parts, weight, bias, lrelu=lrelu,
                                                residual=residual),
                 library, flops, io, torch.bfloat16, device, tol=TOL[f32],
                 value=lambda y: pair_merge(y) if isinstance(y, Pair) else y.float(),
                 dt_name="split")


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


def sta_case(rng, model, dtype, device, b=WINDOWS, hw=LR_HW):
    h, w = hw
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


def stau_case(rng, model, statics, dtype, device, b=WINDOWS, hw=LR_HW):
    h, w = hw
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
    # the serving path's plan (planned once per shape and scale), at the tile
    # and capacity of the kernel that runs ``dtype``
    plan = stau_window_plan(pix, h, w, *plan_geometry(dtype))
    cout = wts[2].shape[0]
    # 2 bilinear gathers (4 taps, C channels), compress + expand (n*C/8 x C
    # each), routing mixes, and the 2C -> Cout fusion, per HR pixel
    flops = (16.0 * c + 4.0 * n * (c // 8) * c + 4.0 * n * (c // 8) + 4.0 * c * cout) * H * W * b
    io = nbytes(x, sta, pix, *wts, bias) + b * cout * H * W * x.element_size()
    return check("stau", f"C={c} {h}x{w} -> {H}x{W}", lambda: stau_upsample_fused(*args, plan=plan),
                 lambda: stau_upsample_fused_plain(*args), None, flops, io, dtype, device)


def tail_case(rng, model, dtype, device, b=WINDOWS, hw=LR_HW, scale=SCALE):
    h, w = hw
    H, W = get_hw(h, w, scale)
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


def log_stau_plan(phase: str, pix, hw, scale, dtype, fast: bool = False) -> None:
    """The STAU window plan of ``dtype``'s kernel (``fast``: the fast tier's)
    at (``hw``, ``scale``): its tiles, those gathered from device memory
    (boxes over the capacity) and the staged boxes' sizes."""
    tile_r, tile_c, cap, align = plan_geometry(dtype, fast=fast)
    plan = stau_window_plan(pix, *hw, tile_r, tile_c, cap, align)
    sizes = plan[:, 4] * plan[:, 5] + plan[:, 6] * plan[:, 7]
    log(f"[{phase}] stau {'fast' if fast else DT_NAME[dtype]} window plan x{scale[0]}x{scale[1]} "
        f"{hw[0]}x{hw[1]} ({tile_r}x{tile_c} HR tiles): {plan.shape[0]} tiles, "
        f"{int((plan[:, 4] == 0).sum())} gathered from device memory, staged box "
        f"slots max {int(sizes.max())} mean {float(sizes.float().mean()):.1f} of {cap}")


def phase_kernels(model, device) -> list:
    """Every kernel against its plain version at its path's shapes."""
    rng = np.random.default_rng(0)
    rows = []
    with float32_precision(True):
        for scale in ((4.0, 4.0), (1.5, 3.5), (3.05, 3.05)):
            pix = model.stau_statics(LR_HW, scale, device=device)["pix"]
            for dtype in (torch.bfloat16, torch.float32):
                log_stau_plan("kernels", pix, LR_HW, scale, dtype)
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


def phase_parity(model, device) -> dict:
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
    return launches


def write_clip(root: str, n: int, hw, name: str = "clip") -> str:
    """``n`` seeded frames (smooth texture + noise, shifted from frame to
    frame) at ``hw`` as root/name/0000000i.png."""
    import cv2

    rng = np.random.default_rng(1)
    d = os.path.join(root, name)
    os.makedirs(d)
    base = (rng.random((hw[0] // 4, hw[1] // 4, 3)) * 255).astype(np.float32)
    base = cv2.resize(base, (hw[1], hw[0]), interpolation=cv2.INTER_CUBIC)
    for i in range(n):
        noise = rng.normal(0, 4, base.shape)
        img = np.clip(np.roll(base, 2 * i, axis=1) + noise, 0, 255).astype(np.uint8)
        cv2.imwrite(os.path.join(d, f"{i:08d}.png"), img)
    return d


# the kernels a tier's path must not launch: the split tier runs every conv
# on the split kernels, the fast tier nothing but its five kernels
TIER_FORBIDDEN = {"bf16": (), "split": ("conv3x3", "conv1x1"),
                  "fast": SERVING_KERNELS + SPLIT_KERNELS}


def require_none_of(phase: str, launches: dict, tier: str) -> None:
    """No kernel of ``TIER_FORBIDDEN[tier]`` launched."""
    other = {k: launches[k] for k in TIER_FORBIDDEN[tier] if launches[k]}
    if other:
        raise AssertionError(f"{phase}: other tiers' kernels launched in the {tier} tier: "
                             f"{other} ({launches})")


def phase_serving(sd, device, n_frames: int = 8, hw=LR_HW, windows: int = WINDOWS,
                  tier: str = "bf16") -> dict:
    """The port's CLI on a seeded clip at ``tier`` (bf16, split or fast);
    returns the main-path run's kernel launches and rates (bf16: and the
    bf16 tier's deviation from the strict tier on the first window)."""
    import cv2

    from savsr_tpu_torch.data.data_util import paths_from_folder, read_img_seq

    with tempfile.TemporaryDirectory() as tmp:
        clip = write_clip(tmp, n_frames, hw)
        pth = os.path.join(tmp, "savsr.pth")
        torch.save({"params": {k: torch.from_numpy(v) for k, v in sd.items()}}, pth)
        argv = ["-i", clip, "-s", str(SCALE[0]), "-w", pth, "--tier", tier,
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
        phase = "serving" if tier == "bf16" else f"{tier}-serving"
        launches = require_kernels_ran(phase, TIER_KERNELS[tier])
        require_none_of(phase, launches, tier)
        H, W = get_hw(hw[0], hw[1], SCALE)
        outs = paths_from_folder(os.path.join(tmp, "out"))
        frames = [cv2.imread(p) for p in outs]
        if len(frames) != n_frames or any(f is None or f.shape != (H, W, 3) for f in frames):
            raise AssertionError(f"serving wrote {len(frames)} frames of "
                                 f"{[None if f is None else f.shape for f in frames[:2]]}")
        n_chunk, chunk_s = stats[0]
        log(f"[{phase}] {n_frames} frames {hw[0]}x{hw[1]} -> {H}x{W} {tier}, windows {windows}: "
            f"first run {warm_s:.3f} s (first chunk {warm[0][1] * 1e3:.1f} ms); "
            f"main-path run {wall:.3f} s wall incl. IO")
        log(f"[{phase}] steady chunk: {n_chunk} frames in {chunk_s * 1e3:.1f} ms = "
            f"{chunk_s * 1e3 / n_chunk:.2f} ms/frame, {n_chunk / chunk_s:.3f} fps "
            f"(dispatch to frames on the host)")
        log(f"[{phase}] kernel launches in the main-path run: {launches} "
            f"({ {k: v / n_frames for k, v in launches.items()} } per frame)")
        result = {"launches": launches, "ms_per_frame": chunk_s * 1e3 / n_chunk,
                  "fps": n_chunk / chunk_s}
        if tier != "bf16":
            return result

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
    return dict(result, bf16_vs_strict_db=psnr)


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


@contextlib.contextmanager
def copy_ranges():
    """Profiler ranges around what makes PyTorch copies in a fast forward:
    the fast conv's part maps (ops/conv.py tma_part: pitch-padded copies of
    widths off a multiple of 4), STA's wrapper (its rounding pass of st),
    STAU's wrapper (its inputs rounded to bf16) and the tail's pitch copy
    (ops/tail.py tma_part)."""
    from savsr_tpu_torch.archs import savsr_arch
    from savsr_tpu_torch.ops import conv as conv_ops, tail as tail_ops

    targets = [(conv_ops, "tma_part", "conv parts"),
               (savsr_arch, "sta_conv_fused_fast", "STA st"),
               (savsr_arch, "stau_upsample_fused_fast", "STAU inputs"),
               (tail_ops, "tma_part", "tail pitch")]
    saved = []
    for mod, name, label in targets:
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _label=f"copies: {label}", **kw):
            with torch.profiler.record_function(_label):
                return _fn(*a, **kw)

        saved.append((mod, name, fn))
        setattr(mod, name, wrapped)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def copies_by_source(prof) -> dict:
    """{what is copied: (device ms, launches)} of a profile's PyTorch copy
    kernels: each is credited to the innermost ``copy_ranges`` range around
    the op that launched it, else to "other" (the architecture's own casts,
    concats and contiguous copies)."""
    out = {}
    for e in prof.events():
        ks = [k for k in e.kernels if "copy" in k.name.lower()]
        if not ks:
            continue
        label, p = "other", e.cpu_parent
        while p is not None:
            if p.name.startswith("copies: "):
                label = p.name[len("copies: "):]
                break
            p = p.cpu_parent
        ms, n = out.get(label, (0.0, 0))
        out[label] = (ms + sum(k.duration for k in ks) / 1e3, n + len(ks))
    return out


def phase_profile(sd, device, windows: int = WINDOWS, tier: str = "bf16") -> dict:
    """Device time by kernel over one serving forward of ``windows`` windows
    at ``tier`` (torch.profiler), against the forward's unprofiled time; for
    the strict tier also the f32 conv kernel's share and launches, for the
    split tier the split conv kernel's."""
    from torch.profiler import ProfilerActivity, profile

    dt = torch.bfloat16 if tier == "bf16" else torch.float32
    model = build_serving_model(tier)
    load_into(model, {k: torch.from_numpy(v) for k, v in sd.items()})
    model.to(device=device, dtype=dt)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.random((windows, 7, 3) + LR_HW, dtype=np.float32)).to(device, dt)
    statics = model.stau_statics(LR_HW, SCALE, dtype=dt, device=device)
    fwd_ms = timed_ms(lambda: model(x, SCALE, stau_statics=statics), device, reps=3, iters=1)
    ops.reset_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
            (copy_ranges() if tier == "fast" else contextlib.nullcontext()):
        model(x, SCALE, stau_statics=statics)
        if device.type == "cuda":
            torch.cuda.synchronize()
    launches = dict(ops.launches)
    rows = device_rows(prof)
    total = sum(r[1] for r in rows)
    log(f"[profile] {tier} forward of {windows} windows {LR_HW[0]}x{LR_HW[1]} x{SCALE[0]}: "
        f"{fwd_ms:.2f} ms unprofiled; device busy {total:.2f} ms "
        f"({100 * total / fwd_ms:.1f}% of the forward)")
    for name, ms, count in rows[:12]:
        log(f"[profile] {ms:9.3f} ms {100 * ms / max(total, 1e-9):5.1f}% x{count:<5d} {name[:90]}")
    port = [r for r in rows if any(f"{k}_kernel" in r[0] for k in (
        "conv_f32", "conv_f32_reduce", "conv_wgmma", "conv_fast", "conv_split", "sta_f32", "sta_mma",
        "sta_fast", "stau_f32", "stau_mma", "stau_fast", "tail_f32", "tail_mma"))]
    result = {"tier": tier, "launches": launches}
    port_ms = sum(r[1] for r in port)
    log(f"[profile] the port's kernels {port_ms:.2f} ms in {sum(r[2] for r in port)} launches; "
        f"everything else {total - port_ms:.2f} ms in {sum(r[2] for r in rows) - sum(r[2] for r in port)} "
        f"device events")
    result.update(forward_ms=fwd_ms, device_ms=total, port_ms=port_ms)
    if tier == "fast":
        fc = [r for r in rows if "conv_fast" in r[0]]
        fc_ms = sum(r[1] for r in fc)
        log(f"[profile] fast: the fast conv kernels {fc_ms:.2f} ms = "
            f"{100 * fc_ms / max(total, 1e-9):.1f}% of device busy {total:.2f} ms, in "
            f"{sum(r[2] for r in fc)} device launches (wrapper calls conv3x3_fast "
            f"{launches['conv3x3_fast']}, conv1x1_fast {launches['conv1x1_fast']}): "
            + "; ".join(f"{short_name(n)} {ms:.2f} ms x{c}" for n, ms, c in fc))
        # PyTorch's copy kernels, by what they copy: the fast conv's parts
        # (pitch copies only: the kernel rounds its f32 parts itself), STA's
        # st and STAU's inputs (their rounding passes), the tail's pitch copy,
        # and the architecture's own
        copies = copies_by_source(prof)
        cast_ms = sum(ms for ms, _ in copies.values())
        log(f"[profile] fast: copy kernels {cast_ms:.2f} ms in "
            f"{sum(n for _, n in copies.values())} launches: "
            + "; ".join(f"{k} {ms:.2f} ms x{n}" for k, (ms, n) in sorted(copies.items())))
        result.update(fast_conv_ms=fc_ms, copy_ms=cast_ms,
                      copies={k: {"ms": ms, "launches": n} for k, (ms, n) in copies.items()})
        # every fast STA and STAU launch on the fast tier's own kernels
        want = {CUDA_KERNELS[k, "fast"]: launches[k] for k in ("sta_fast", "stau_fast")}
        got = {}
        for name, _, count in rows:
            if short_name(name).startswith(("sta_", "stau_")):
                got[short_name(name)] = got.get(short_name(name), 0) + count
        log(f"[profile] fast: STA and STAU kernels {got} (wrapper calls {want})")
        if device.type == "cuda" and got != want:
            raise AssertionError(f"fast profile: STA and STAU launches {got}, want {want}")
        return result
    if tier == "strict":
        f32 = [r for r in rows if "conv_f32" in r[0]]
        f32_ms = sum(r[1] for r in f32)
        log(f"[profile] strict: the f32 conv kernels {f32_ms:.2f} ms = "
            f"{100 * f32_ms / max(total, 1e-9):.1f}% of device busy {total:.2f} ms, in "
            f"{sum(r[2] for r in f32)} device launches (wrapper calls conv3x3 "
            f"{launches['conv3x3']}, conv1x1 {launches['conv1x1']}): "
            + "; ".join(f"{short_name(n)} {ms:.2f} ms x{c}" for n, ms, c in f32))
        result["f32_conv_ms"] = f32_ms
        return result
    if tier == "split":
        sp = [r for r in rows if "conv_wgmma" in r[0] or "conv_split" in r[0]]
        sp_ms = sum(r[1] for r in sp)
        log(f"[profile] split: the split conv kernels {sp_ms:.2f} ms = "
            f"{100 * sp_ms / max(total, 1e-9):.1f}% of device busy {total:.2f} ms, in "
            f"{sum(r[2] for r in sp)} device launches (wrapper calls conv3x3_split "
            f"{launches['conv3x3_split']}, conv1x1_split {launches['conv1x1_split']}): "
            + "; ".join(f"{short_name(n)} {ms:.2f} ms x{c}" for n, ms, c in sp))
        # every split conv runs the pair kernel (conv_split_kernel<K>), none
        # the bf16 kernel (conv_wgmma_kernel); the profiler's counts run a
        # few short of the wrapper calls over a whole forward (391 + 9 of 402
        # + 10 here, as for the fast convs), so kernels are held, not counts
        if device.type == "cuda" and ({short_name(n) for n, _, _ in sp}
                                      != {"conv_split_kernel<3>", "conv_split_kernel<1>"}):
            raise AssertionError(f"split profile: conv3x3_split {launches['conv3x3_split']}, "
                                 f"conv1x1_split {launches['conv1x1_split']} calls; kernels {sp}")
        # the device time outside the port's kernels, by kernel: the pairs'
        # elementwise passes (adds, splits, casts) and copies
        other = {}
        for name, ms, count in rows:
            if (name, ms, count) not in port:
                prev = other.get(short_name(name), (0.0, 0))
                other[short_name(name)] = (prev[0] + ms, prev[1] + count)
        other = sorted(other.items(), key=lambda kv: -kv[1][0])
        log(f"[profile] split: outside the port's kernels {sum(v[0] for _, v in other):.2f} ms "
            f"in {sum(v[1] for _, v in other)} launches, by kernel: "
            + "; ".join(f"{k} {ms:.2f} ms x{n}" for k, (ms, n) in other[:12]))
        result.update(split_conv_ms=sp_ms,
                      other_kernels={k: {"ms": ms, "launches": n} for k, (ms, n) in other})
    # the bf16 conv's weight repack (ops/conv.py pack_weight: a zero pad and
    # an index_select, whose CUDA kernel is PyTorch's gather, for each
    # per-sample OSConv weight, split into hi and lo first in the split tier;
    # shared weights keep their packed copy)
    repack = [r for r in rows if "scatter_gather" in r[0]]
    log(f"[profile] gather kernels (the {tier} conv weight repack): "
        f"{sum(r[1] for r in repack):.2f} ms in {sum(r[2] for r in repack)} launches")
    return result


SMALL_CFG = dict(num_in_ch=3, num_feat=16, num_frame=7, slid_win=3, fusion_win=5, interval=0,
                 w1_num_block=2, w2_num_block=1, n_resgroups=1, n_resblocks=2)


def small_step(dev, precision):
    """One Charbonnier loss + backward of the small config on the golden
    batch at ``matmul_precision`` ``precision``, the backward under the
    forward's precision (as the trainer's step runs it): (loss, gradients)."""
    golden = np.load(os.path.join(GOLDENS, "savsr_small_grads.npz"))
    model = SAVSR(**SMALL_CFG, matmul_precision=precision, remat_train=False)
    load_into(model, {k: torch.from_numpy(v)
                      for k, v in np.load(os.path.join(GOLDENS, "savsr_small_state.npz")).items()})
    model.to(dev).train()
    lq, gt = torch.from_numpy(golden["lq"]).to(dev), torch.from_numpy(golden["gt"]).to(dev)
    sr, _ = model(lq, (2.0, 2.0), train=True)
    loss = torch.sqrt((sr - gt) ** 2 + 1e-12).mean()
    with model.train_precision(torch.float32):
        loss.backward()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return float(loss.detach()), {k: p.grad.detach().cpu().numpy()
                                  for k, p in model.named_parameters()}


def rel_l2(a: dict, b: dict) -> float:
    """The relative L2 distance of gradient dict ``a`` from ``b``."""
    num = sum(float(((a[k] - v).astype(np.float64) ** 2).sum()) for k, v in b.items())
    return (num / sum(float((v.astype(np.float64) ** 2).sum()) for v in b.values())) ** 0.5


def phase_train_parity(device) -> dict:
    """Small config, strict f32 (TF32 off in the forward and the backward)
    on the card: one Charbonnier loss + backward on the golden batch against
    the torch oracle's gradients, at the bounds tests/test_grad_parity.py
    holds the JAX package to (loss 1e-5; every gradient within 2e-3 of its
    own max), and the whole gradient within STRICT_GRAD_L2 relative L2 of the
    CPU's float32 step."""
    golden = np.load(os.path.join(GOLDENS, "savsr_small_grads.npz"))
    ops.reset_counts()
    loss, grads = small_step(device, "float32")
    launches = require_kernels_ran("train-parity", TRAINING_KERNELS)
    # per gradient: |d| <= 2e-3 * max|ref| + 1e-7. The absolute term is for
    # the near-dead gradients (the routing biases in front of a
    # batch-statistics BatchNorm, max|ref| < 1e-6, where the golden itself is
    # f32 cancellation noise of sums of O(1e-2) terms); it is 1e-4 of the
    # smallest live gradient's 2e-3 band and changes nothing for the rest.
    worst_rel, worst_abs, failed = (0.0, None), (0.0, None), []
    for k, g in grads.items():
        ref = golden["g/" + k]
        err, ref_max = float(np.abs(g - ref).max()), float(np.abs(ref).max())
        if ref_max >= 1e-5:
            worst_rel = max(worst_rel, (err / ref_max, k))
        else:
            worst_abs = max(worst_abs, (err, k))
        if not err <= 2e-3 * ref_max + 1e-7:
            failed.append((k, err, ref_max))
    d_loss = abs(loss - float(golden["loss"]))
    cpu_f32 = small_step(torch.device("cpu"), "float32")
    l2_cpu = rel_l2(grads, cpu_f32[1])
    log(f"[train-parity] small config f32: loss {loss:.8f} vs golden "
        f"{float(golden['loss']):.8f} (|d| {d_loss:.2e}, bound 1e-5); worst gradient "
        f"{worst_rel[0]:.3e} of its max at {worst_rel[1]} (bound 2e-3); near-dead gradients "
        f"(max < 1e-5): worst |d| {worst_abs[0]:.2e} at {worst_abs[1]} (bound 1e-7); launches "
        f"osconv_agg {launches['osconv_agg']}, osconv_dagg {launches['osconv_dagg']}")
    log(f"[train-parity] small config f32, card vs the CPU's float32 step (TF32 off in the "
        f"backward too): whole gradient {l2_cpu:.3e} relative L2 (bound {STRICT_GRAD_L2}), loss "
        f"|d| {abs(loss - cpu_f32[0]):.2e}")
    if not d_loss < 1e-5 or failed or not l2_cpu <= STRICT_GRAD_L2:
        raise AssertionError(f"train-parity: loss off by {d_loss}, gradients off: {failed[:5]}, "
                             f"{l2_cpu} relative L2 from the CPU's float32 step")
    train_parity_default(device, cpu_f32)
    return launches


def train_parity_default(device, cpu_f32=None) -> dict:
    """Phase 6's default-precision case: the small config with f32 weights at
    matmul_precision default (every product one bf16 pass, the transposed
    products of the backward too: archs/train_engine.py) on the card against
    the port's own CPU run of the same step (which tests/
    test_torch_train_default.py holds to the JAX package). A sum taken in
    another order rounds some product's operand or cotangent to the other
    bf16 neighbour, which moves everything upstream, so the gradients are
    held by the measured figures, logged beside the run-to-run spread of
    the card (its atomics) and the distance to the CPU's float32 step: loss
    within 1e-5 (phase 6's bound) and at least 10x nearer the CPU's default
    step than its float32 step (the card runs the default math: on the
    golden batch 4.5e-7 against 1.3e-5); the whole gradient within
    DEFAULT_GRAD_L2 relative L2 (measured 6.3e-3; the card's own run with
    cuDNN off moves it by 6.9e-3, and the CPU's float32 step sits 9.7e-3
    from its default one, so gradients cannot tell the two apart); each
    gradient within 0.25 of its max + 2e-3 of the largest (phase 6's 2e-3
    of each max is counted, not held). ``cpu_f32``: the CPU's float32 step,
    if phase 6 has it already."""
    cpu = torch.device("cpu")
    cpu_loss, ref = small_step(cpu, "default")
    f32_loss, ref_f32 = cpu_f32 or small_step(cpu, "float32")
    ops.reset_counts()
    loss, grads = small_step(device, "default")
    launches = require_kernels_ran("train-parity-default", TRAINING_KERNELS)
    _, again = small_step(device, "default")
    l2 = rel_l2
    top = max(float(np.abs(v).max()) for v in ref.values())
    worst, failed, narrow = (0.0, None), [], 0
    for k, v in ref.items():
        err, ref_max = float(np.abs(grads[k] - v).max()), float(np.abs(v).max())
        if ref_max > 1e-5 and err / ref_max >= worst[0]:
            worst = (err / ref_max, k)
        narrow += not err <= 2e-3 * ref_max + 1e-7
        if not err <= 0.25 * ref_max + 2e-3 * top:
            failed.append((k, err, ref_max))
    d_loss, d_loss_f32 = abs(loss - cpu_loss), abs(loss - f32_loss)
    res = {"loss_diff": d_loss, "loss_diff_vs_cpu_float32": d_loss_f32, "worst_rel": worst[0],
           "rel_l2": l2(grads, ref),
           "rel_l2_card_rerun": l2(again, grads), "rel_l2_vs_cpu_float32": l2(grads, ref_f32),
           "rel_l2_cpu_float32_vs_default": l2(ref_f32, ref)}
    log(f"[train-parity] small config f32 at matmul_precision default, card vs CPU: loss "
        f"{loss:.8f} vs {cpu_loss:.8f} (|d| {d_loss:.2e}, bound 1e-5; the CPU's float32 step "
        f"{f32_loss:.8f}, |d| {d_loss_f32:.2e}, at least 10x); whole gradient "
        f"{res['rel_l2']:.3e} relative L2 (bound {DEFAULT_GRAD_L2}; the card against itself "
        f"{res['rel_l2_card_rerun']:.3e}, against the CPU's float32 step "
        f"{res['rel_l2_vs_cpu_float32']:.3e}, CPU float32 against CPU default "
        f"{res['rel_l2_cpu_float32_vs_default']:.3e}); worst gradient {worst[0]:.3e} of its max "
        f"at {worst[1]} ({narrow} of {len(ref)} outside phase 6's 2e-3); launches osconv_agg "
        f"{launches['osconv_agg']}, osconv_dagg {launches['osconv_dagg']}")
    if (not d_loss < 1e-5 or not 10 * d_loss <= d_loss_f32 or failed
            or not res["rel_l2"] <= DEFAULT_GRAD_L2):
        raise AssertionError(f"train-parity default: {res}, gradients off: {failed[:5]}")
    return res


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
  val_x4:
    name: Vid4_x4
    type: ASVideoTestDataset
    dataroot_gt: {root}/Vid4/GT
    dataroot_lq: {root}/Vid4/GT
    io_backend:
      type: disk

    cache_data: false
    num_frame: 7
    padding: reflection
    use_arbitrary_scale_downsampling: true
    downsampling_scale: !!python/tuple [4, 4]
    downsampling_mode: torch
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
val:
  val_freq: !!float 5e3
  save_img: false

  metrics:
    psnr_y:
      type: calculate_psnr
      crop_border: 0
      test_y_channel: true
    ssim_y:
      type: calculate_ssim
      crop_border: 0
      test_y_channel: true
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
        write_clip(os.path.join(tmp, "Vid4", "GT"), EVAL_FRAMES, EVAL_HW, name="calendar")
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
            # the final validation runs the serving kernels (its eval
            # forward folds each OSConv into the conv kernel's per-sample
            # weight, archs/chw_engine.py osconv_chw, so it adds no OSConv
            # launch: the exact check below counts the training steps' own)
            launches = require_kernels_ran("training", TRAINING_KERNELS + SERVING_KERNELS)
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
        val = getattr(model, "last_metric_results", None)
        if val is None or not all(np.isfinite(val[m]) for m in ("psnr_y", "ssim_y")):
            raise AssertionError(f"training: the final validation gave {val}")
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
    log(f"[training] OSConv kernel launches over the {iters} steps: "
        f"{ {k: launches[k] for k in TRAINING_KERNELS} } "
        f"(per step: {({k: launches[k] // iters for k in TRAINING_KERNELS})}, as the "
        f"architecture gives them)")
    log(f"[training] the final validation ({model.opt['datasets']['val_x4']['name']}, "
        f"{EVAL_FRAMES} frames {EVAL_HW[0]}x{EVAL_HW[1]}, f32 on the EMA weights): "
        f"psnr_y {val['psnr_y']:.4f} dB, ssim_y {val['ssim_y']:.6f}; serving kernel launches "
        f"{ {k: launches[k] for k in SERVING_KERNELS} }")
    phase_train_profile(model, device)
    return {"launches": launches, "ms_per_step": ms_step, "samples_per_s": batch / (ms_step / 1e3),
            "peak_bytes": peak, "losses": losses, "validation": val}


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


EVAL_YML = os.path.join(REPO, "options", "test", "SAVSR", "test_SAVSR_Vid4_asBI.yml")
# the frame size of Vid4's calendar clip; 4 frames stand in for its 41
EVAL_HW, EVAL_FRAMES = (576, 720), 4
EVAL_DATASETS = 48  # the shipped config's dataset blocks
# the datasets whose frame 0 is held against a direct forward, and whose
# per-frame times are printed
EVAL_TIMED = ("Vid4_x4.0", "Vid4_x1.1", "Vid4_x1.5_x3.5")
# the datasets at whose shapes the f32 kernels are held against their plain
# versions first: the largest LR frame (x1.1: widths 650 and 715, neither a
# multiple of 8 or 4), an HR width of 671 (x3.05), the extrapolated scales
# whose STAU boxes overflow the staging capacity (x8, x12), and x4
EVAL_SHAPES = ("Vid4_x4.0", "Vid4_x1.1", "Vid4_x1.5_x3.5", "Vid4_x1.6_x3.05", "Vid4_x8",
               "Vid4_x12")
EVAL_CONV_CASES = ("conv_c 3->64 lrelu", "conv2 64+64->64 lrelu+res",
                   "osconv 5x64->64 per-sample lrelu", "conv1 3x64->64 lrelu")


def eval_config(tmp: str, pth: str, names=None, network=None) -> str:
    """The shipped Vid4 test config with its dataroots pointed at a seeded
    clip under ``tmp``, its weights at ``pth`` and its results under
    ``tmp``; with ``names`` only those datasets, with ``network`` these
    network_g settings added; nothing else changed. Returns the written
    config's path."""
    import yaml

    from savsr_tpu_torch.utils.options import yaml_load

    opt = yaml_load(EVAL_YML)
    if names is not None:
        opt["datasets"] = {k: ds for k, ds in opt["datasets"].items() if ds["name"] in names}
    opt["network_g"].update(network or {})
    gt_root = os.path.join(tmp, "Vid4", "GT")
    write_clip(gt_root, EVAL_FRAMES, EVAL_HW, name="calendar")
    for ds in opt["datasets"].values():
        ds["dataroot_gt"] = ds["dataroot_lq"] = gt_root
    opt["path"]["pretrain_network_g"] = pth
    opt["path"]["results_root"] = os.path.join(tmp, "results")
    path = os.path.join(tmp, "test_vid4.yml")
    with open(path, "w") as f:
        yaml.dump(opt, f)  # tuples as !!python/tuple, as the shipped file writes them
    return path


def first_window(opt: dict, name: str):
    """(the eval dataset ``name``'s first item, its scale) by the port's
    dataset, as the pipeline reads it."""
    from savsr_tpu_torch.data import build_dataset

    block = next(b for b in opt["datasets"].values() if b["name"] == name)
    return build_dataset(dict(block, phase="test"))[0], tuple(block["downsampling_scale"])


def profile_forward(model, lq, scale, statics, device, label: str) -> dict:
    """One eval forward (batch 1) under torch.profiler: device busy against
    its unprofiled time (back-to-back forwards between CUDA events), and
    the largest kernels."""
    from torch.profiler import ProfilerActivity, profile

    fwd_ms = timed_ms(lambda: model(lq, scale, stau_statics=statics), device, reps=3, iters=3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model(lq, scale, stau_statics=statics)
        if device.type == "cuda":
            torch.cuda.synchronize()
    rows = device_rows(prof)
    busy = sum(r[1] for r in rows)
    log(f"[eval-profile] {label} forward {tuple(lq.shape[-2:])} x{scale[0]}x{scale[1]}, batch 1: "
        f"{fwd_ms:.2f} ms unprofiled, device busy {busy:.2f} ms ({100 * busy / fwd_ms:.1f}%) in "
        f"{sum(r[2] for r in rows)} device events: "
        + "; ".join(f"{short_name(k)} {ms:.2f} ms x{c}" for k, ms, c in rows[:5]))
    return {"forward_ms": fwd_ms, "device_busy_ms": busy}


def phase_eval(sd, device) -> dict:
    """The eval pipeline (savsr_tpu_torch.test.test_pipeline) on the shipped
    Vid4 config, all 48 datasets, strict f32, batch 1: first the f32 kernels
    against their plain versions at the sweep's shapes, then the main-path
    run (counts zeroed just before, read just after), then frame 0 of three
    datasets against a direct forward of the same window."""
    import cv2

    from savsr_tpu_torch.test import test_pipeline
    from savsr_tpu_torch.utils.img_util import array2img
    from savsr_tpu_torch.utils.options import yaml_load
    from savsr_tpu_torch.data.resize import resize_np

    model = SAVSR(**flagship_net_kwargs()).eval()
    load_into(model, {k: torch.from_numpy(v) for k, v in sd.items()})
    model.to(device)
    rng = np.random.default_rng(9)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        pth = os.path.join(tmp, "savsr.pth")
        torch.save({"params": {k: torch.from_numpy(v) for k, v in sd.items()}}, pth)
        cfg = eval_config(tmp, pth)
        opt = yaml_load(cfg)
        t0 = time.perf_counter()
        with float32_precision(True):
            for name in EVAL_SHAPES:
                item, scale = first_window(opt, name)
                hw = item["lq"].shape[1:3]
                statics = model.stau_statics(hw, scale, dtype=torch.float32, device=device)
                log_stau_plan("eval", statics["pix"], hw, scale, torch.float32)
                for case in CONV_CASES:
                    if case[0] in EVAL_CONV_CASES:
                        rows.append(conv_case(rng, f"{case[0]} {name}", *case[1:], torch.float32,
                                              device, b=1, hw=hw))
                rows.append(sta_case(rng, model, torch.float32, device, b=1, hw=hw))
                rows.append(stau_case(rng, model, statics, torch.float32, device, b=1, hw=hw))
                rows.append(tail_case(rng, model, torch.float32, device, b=1, hw=hw, scale=scale))
        failed = [f"{r['name']} {r['case']}" for r in rows if not r["ok"]]
        if failed:
            raise AssertionError(f"eval: f32 kernels disagree with their plain versions at the "
                                 f"sweep's shapes: {failed}")
        check_s = time.perf_counter() - t0

        stats = []
        ops.reset_counts()
        t0 = time.perf_counter()
        results = test_pipeline(tmp, ["-opt", cfg, "--device", str(device)], stats=stats)
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = require_kernels_ran("eval")
        names = [ds["name"] for ds in opt["datasets"].values()]
        bad = [n for n in names if n not in results
               or not all(np.isfinite(results[n][m]) for m in ("psnr_y", "ssim_y"))]
        if len(names) != EVAL_DATASETS or bad or len(stats) != EVAL_DATASETS * EVAL_FRAMES:
            raise AssertionError(f"eval: {len(names)} datasets, {len(stats)} frames, missing or "
                                 f"non-finite: {bad}")
        for n in names:
            log(f"[eval] {n:18s} psnr_y {results[n]['psnr_y']:.4f} dB  "
                f"ssim_y {results[n]['ssim_y']:.6f}")
        frames = len(stats)
        totals = {k: sum(st[k] for st in stats) for k in ("load_s", "statics_s", "forward_s",
                                                          "post_s")}
        log(f"[eval] {len(names)} datasets x {EVAL_FRAMES} frames {EVAL_HW[0]}x{EVAL_HW[1]} (GT), strict "
            f"f32, batch 1: {wall:.2f} s ({check_s:.2f} s of kernel checks before it); per "
            f"frame: " + ", ".join(f"{k} {v / frames:.4f}" for k, v in totals.items())
            + " s (load: the item's frames read and degraded on the host; forward: up to the "
            "output on the host; post: metrics on the host and the PNG write)")
        timed = {}
        for n in EVAL_TIMED:
            mine = [st for st in stats if st["dataset"] == n]
            rest = [st["forward_s"] for st in mine[1:]]
            timed[n] = {"statics_s": mine[0]["statics_s"], "first_forward_s": mine[0]["forward_s"],
                        "forward_s": float(np.mean(rest)),
                        "frame_s": float(np.mean([st["load_s"] + st["forward_s"] + st["post_s"]
                                                  for st in mine[1:]]))}
            log(f"[eval] {n}: frames 2-{len(mine)}: forward {timed[n]['forward_s']:.4f} s/frame "
                f"(to the output on the host), whole frame {timed[n]['frame_s']:.4f} s; frame 1: "
                f"statics {mine[0]['statics_s']:.4f} s apart, forward "
                f"{mine[0]['forward_s']:.4f} s")
        log(f"[eval] kernel launches in the main-path run: {launches} "
            f"({ {k: round(v / frames, 2) for k, v in launches.items()} } per frame)")

        # frame 0 of three datasets: the saved PNG against array2img of a
        # direct forward of the same window (+ the BI post-process where the
        # shapes differ)
        vis = os.path.join(tmp, "results", opt["name"], "visualization")
        for n in EVAL_TIMED:
            item, scale = first_window(opt, n)
            lq = torch.from_numpy(item["lq"]).permute(0, 3, 1, 2).contiguous()[None].to(device)
            statics = model.stau_statics(lq.shape[-2:], scale, dtype=torch.float32, device=device)
            sr = model(lq, scale, stau_statics=statics).permute(0, 2, 3, 1).cpu().numpy()
            gt_hw = item["gt"].shape[:2]
            if sr.shape[1:3] != gt_hw:
                sr = resize_np(sr, gt_hw, mode="torch", antialias=True)
            want = array2img(sr[0])
            saved = cv2.imread(os.path.join(vis, n, "calendar",
                                            f"00000000_{opt['name']}.png"), cv2.IMREAD_UNCHANGED)
            same = saved is not None and saved.shape == want.shape and np.array_equal(saved, want)
            log(f"[eval] {n} frame 0: LR {tuple(lq.shape[-2:])} -> {sr.shape[1:3]}, saved PNG "
                f"{'equals' if same else 'DIFFERS FROM'} array2img of a direct forward")
            if not same:
                raise AssertionError(f"eval: {n} frame 0 differs from a direct forward")
            timed[n].update(profile_forward(model, lq, scale, statics, device, n))
    return {"launches": launches, "seconds": wall, "frames": frames, "per_frame": totals,
            "timed": timed, "results": results, "rows": rows}


# the shipped Vid4 config's datasets that phase 10 evaluates on the split tier
SPLIT_EVAL = ("Vid4_x4.0", "Vid4_x1.1", "Vid4_x1.5_x3.5")


def split_parity(sd, device) -> dict:
    """The flagship split forward on the 45x80 golden input at three scales
    against the strict forward on the card (max abs < 2e-3 and 30x below the
    bf16 tier's, the JAX package's gate for its split tier,
    tests/test_split_conv.py), with the deviation PSNR of each against the
    reference torch outputs."""
    g = np.load(os.path.join(GOLDENS, "savsr_realsize_forward.npz"))
    x = torch.from_numpy(g["x"]).to(device)
    scales = (("y", (4.0, 4.0)), ("y_1.5_3.5", (1.5, 3.5)), ("y_3.05_3.05", (3.05, 3.05)))
    outs = {}
    for tier in ("split", "strict", "bf16"):
        dt = torch.bfloat16 if tier == "bf16" else torch.float32
        model = build_serving_model(tier)
        load_into(model, {k: torch.from_numpy(v) for k, v in sd.items()})
        model.to(device=device, dtype=dt)
        ops.reset_counts()
        for key, scale in scales:
            statics = model.stau_statics(x.shape[-2:], scale, dtype=dt, device=device)
            outs[tier, key] = model(x.to(dt), scale, stau_statics=statics).float().cpu().numpy()
        if tier == "split":
            launches = require_kernels_ran("split-parity", SPLIT_SERVING_KERNELS)
            require_none_of("split-parity", launches, tier)
        del model
    result = {}
    for key, scale in scales:
        split, strict, bf16 = (outs[t, key] for t in ("split", "strict", "bf16"))
        if split.shape != g[key].shape or not np.isfinite(split).all():
            raise AssertionError(f"split parity {key}: shape {split.shape} or non-finite")
        err = float(np.abs(split - strict).max())
        err_bf16 = float(np.abs(bf16 - strict).max())
        row = {"max_abs_vs_strict": err, "bf16_max_abs_vs_strict": err_bf16,
               "db_vs_reference": deviation_psnr(split, g[key]),
               "db_vs_strict": deviation_psnr(split, strict),
               "strict_db_vs_reference": deviation_psnr(strict, g[key])}
        log(f"[split] parity x{scale[0]}x{scale[1]} {tuple(x.shape)}: split vs strict max abs "
            f"{err:.3e} (bf16 {err_bf16:.3e}, {err_bf16 / max(err, 1e-30):.1f}x), deviation PSNR "
            f"vs strict {row['db_vs_strict']:.2f} dB; vs the reference outputs: split "
            f"{row['db_vs_reference']:.2f} dB, strict {row['strict_db_vs_reference']:.2f} dB")
        if not (err < 2e-3 and err * 30 < err_bf16):
            raise AssertionError(f"split parity {key}: {err} vs strict (bf16 {err_bf16})")
        result[key] = row
    return result


# the network_g settings that select a tier in an eval config
TIER_NETWORK = {"split": {"conv_precision": "split"}, "fast": {"matmul_precision": "default"}}


def tier_eval(sd, device, strict_results: dict, tier: str = "split") -> dict:
    """The shipped Vid4 config with ``tier``'s network_g setting on three of
    its datasets (the tier's eval path: counts zeroed just before, read just
    after), against the strict sweep's metrics of phase 9."""
    from savsr_tpu_torch.test import test_pipeline

    with tempfile.TemporaryDirectory() as tmp:
        pth = os.path.join(tmp, "savsr.pth")
        torch.save({"params": {k: torch.from_numpy(v) for k, v in sd.items()}}, pth)
        cfg = eval_config(tmp, pth, SPLIT_EVAL, TIER_NETWORK[tier])
        stats = []
        ops.reset_counts()
        t0 = time.perf_counter()
        results = test_pipeline(tmp, ["-opt", cfg, "--device", str(device)], stats=stats)
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = require_kernels_ran(f"{tier}-eval", TIER_KERNELS[tier])
        require_none_of(f"{tier}-eval", launches, tier)
    if sorted(results) != sorted(SPLIT_EVAL) or not all(
            np.isfinite(results[n][m]) for n in SPLIT_EVAL for m in ("psnr_y", "ssim_y")):
        raise AssertionError(f"{tier} eval: {results}")
    for n in SPLIT_EVAL:
        d_psnr = results[n]["psnr_y"] - strict_results[n]["psnr_y"]
        d_ssim = results[n]["ssim_y"] - strict_results[n]["ssim_y"]
        log(f"[{tier}] eval {n:16s} psnr_y {results[n]['psnr_y']:.4f} dB ({d_psnr:+.4f} vs "
            f"strict) ssim_y {results[n]['ssim_y']:.6f} ({d_ssim:+.6f})")
    frames = len(stats)
    fwd = {n: float(np.mean([st["forward_s"] for st in stats if st["dataset"] == n][1:]))
           for n in SPLIT_EVAL}
    log(f"[{tier}] eval {len(SPLIT_EVAL)} datasets x {EVAL_FRAMES} frames, batch 1: {wall:.2f} s; "
        f"forward to the output on the host, frames 2-{EVAL_FRAMES}: "
        + ", ".join(f"{n} {v:.4f} s" for n, v in fwd.items())
        + f"; kernel launches {launches} ({ {k: round(v / frames, 2) for k, v in launches.items()} }"
        " per frame)")
    return {"results": results, "launches": launches, "seconds": wall, "forward_s": fwd}


def phase_split(sd, device, strict_results: dict) -> dict:
    """Phase 10: the split serving tier (see the module docstring)."""
    rng = np.random.default_rng(10)
    with float32_precision(True):  # the plain versions run true f32
        rows = [split_conv_case(rng, *case, device) for case in SPLIT_CASES]
    failed = [r["case"] for r in rows if not r["ok"]]
    if failed:
        raise AssertionError(f"split conv disagrees with its plain version: {failed}")
    parity = split_parity(sd, device)
    torch.cuda.empty_cache()
    serving = phase_serving(sd, device, tier="split")
    profile = phase_profile(sd, device, tier="split")
    torch.cuda.empty_cache()
    evaluation = tier_eval(sd, device, strict_results, "split")
    return {"rows": rows, "parity": parity, "serving": serving, "profile": profile,
            "eval": evaluation}


# (label, kernel size, input parts' channels, Cout, per-sample weight, lrelu,
#  f32 residual): the fast tier's convs of phase 11
FAST_CASES = [
    ("conv0 64->64 lrelu+res", 3, [64], 64, False, True, True),
    ("merge_l1 3x64->64", 3, [64] * 3, 64, False, False, False),
    ("conv1 3x64->64 lrelu", 1, [64] * 3, 64, False, True, False),
    ("osconv 3x64->64 per-sample lrelu", 3, [64] * 3, 64, True, True, False),
]
# the tolerance of the fast kernels that round values inside: STAU (f0, sa,
# r*fc, fea) and the tail (the row-mixed centre frame), where the kernel's f32
# sums in another order may round one value the other way: one bf16 ulp of
# the output's scale at most, and rarely, so the mean abs error stays under
# 1e-5 of the output's scale. A rounding point misplaced for all values
# (the tail's sr left unrounded, STAU's f0 rounded in the residual) stays
# under the max bound but moves the mean to ~2e-4 of the scale, 20x over
# (scripts/fast_fault_check.py plants both)
FAST_INNER_TOL = 2.0 ** -8
FAST_INNER_MEAN_TOL = 1e-5


def fast_conv_case(rng, label, k, chans, cout, per_sample, act, res, device, b=WINDOWS,
                   hw=LR_HW):
    """Kernels 1-2 in their default-precision mode (the fast conv): f32
    parts, weight, residual and output, the products of their bf16 values.
    Bound: the bf16 conv's operations at the bf16 tensor-core rate against
    the f32 bytes (parts, weight, residual in; output out). Library: F.conv2d
    in bf16 on the inputs rounded to bf16, the nearest single call; and
    ``library_round_ms``, the rounding of the f32 parts to bf16 and that
    call, the yardstick for a conv that takes f32 inputs."""
    h, w = hw
    cin = sum(chans)
    f32 = torch.float32
    parts = [_rand(rng, (b, c, h, w), f32, device) for c in chans]
    weight = _rand(rng, ((b,) if per_sample else ()) + (cout, cin, k, k), f32, device,
                   std=(cin * k * k) ** -0.5)
    bias = None if per_sample else _rand(rng, (cout,), f32, device, 0.1)
    residual = _rand(rng, (b, cout, h, w), f32, device) if res else None
    lrelu = (0.6, 0.4) if act else None
    x_b = torch.cat(parts, 1).to(torch.bfloat16)
    w_b = weight.to(torch.bfloat16)
    b_b = None if bias is None else bias.to(torch.bfloat16)

    def library():
        if per_sample:
            return F.conv2d(x_b.reshape(1, b * cin, h, w), w_b.reshape(b * cout, cin, k, k),
                            padding=k // 2, groups=b)
        return F.conv2d(x_b, w_b, b_b, padding=k // 2)

    def library_round():
        xs = [p.to(torch.bfloat16) for p in parts]
        x = torch.cat(xs, 1) if len(xs) > 1 else xs[0]
        if per_sample:
            return F.conv2d(x.reshape(1, b * cin, h, w), w_b.reshape(b * cout, cin, k, k),
                            padding=k // 2, groups=b)
        return F.conv2d(x, w_b, b_b, padding=k // 2)

    name = "conv3x3_fast" if k == 3 else "conv1x1_fast"
    flops = 2.0 * k * k * cin * cout * h * w * b
    io = nbytes(*parts, weight, bias, residual) + b * cout * h * w * 4
    row = check(name, label,
                lambda: conv_fused_fast(parts, weight, bias, lrelu=lrelu, residual=residual),
                lambda: conv_fused_fast_plain(parts, weight, bias, lrelu=lrelu,
                                              residual=residual),
                library, flops, io, torch.bfloat16, device, tol=TOL[f32], dt_name="fast")
    row["library_round_ms"] = timed_ms(library_round, device)
    log(f"[kernels]     the parts rounded to bf16 + the library call: "
        f"{row['library_round_ms']:.4f} ms")
    return row


def fast_sta_case(rng, model, device, b=WINDOWS, hw=LR_HW):
    """Kernel 3 in its default-precision mode: the K product of bf16 values
    (its bound at the bf16 tensor-core rate beside the 25-tap filter's f32
    CUDA-core rate, the slower of the two, as the bf16 row's; the kernel
    runs both on the CUDA cores), f32 in and out."""
    h, w = hw
    c = model.cfg.num_feat
    kc = model.upsample.kernel_conv[0]
    x = _rand(rng, (b, c, h, w), torch.float32, device)
    st = _rand(rng, (b, c, h, w), torch.float32, device)
    wk, bk = kc.weight.float(), kc.bias.float()
    k_flops, filter_flops = 2.0 * 25 * c * c * h * w * b, 2.0 * 25 * c * h * w * b
    ops_ms = max(k_flops / PEAK_FLOPS[torch.bfloat16],
                 filter_flops / PEAK_FLOPS[torch.float32]) * 1e3
    io = nbytes(x, st, wk, bk) + x.numel() * 4
    return check("sta_fast", f"C={c} {h}x{w}", lambda: sta_conv_fused_fast(x, st, wk, bk),
                 lambda: sta_conv_fused_fast_plain(x, st, wk, bk), None,
                 k_flops + filter_flops, io, torch.bfloat16, device, tol=TOL[torch.float32],
                 ops_ms=ops_ms, dt_name="fast")


def fast_stau_case(rng, model, pix, device, b=WINDOWS, hw=LR_HW):
    """Kernel 4 in its default-precision mode on the bf16 kernel's plan of the
    serving statics: f32 in and out, the products at the bf16 tensor-core
    rate."""
    h, w = hw
    up = model.upsample
    c = model.cfg.num_feat
    n = up.weight_compress.shape[0]
    H, W = pix.shape[1:]
    x = _rand(rng, (b, c, h, w), torch.float32, device)
    sta = _rand(rng, (b, c, h, w), torch.float32, device)
    wts = [t.float() for t in (up.weight_compress, up.weight_expand, up.fusion.weight)]
    args = (x, sta, pix, *wts, up.fusion.bias)
    plan = stau_window_plan(pix, h, w, *plan_geometry(torch.float32, fast=True))
    cout = wts[2].shape[0]
    flops = (16.0 * c + 4.0 * n * (c // 8) * c + 4.0 * n * (c // 8) + 4.0 * c * cout) * H * W * b
    io = nbytes(x, sta, pix, *wts, up.fusion.bias) + b * cout * H * W * 4
    return check("stau_fast", f"C={c} {h}x{w} -> {H}x{W}",
                 lambda: stau_upsample_fused_fast(*args, plan=plan),
                 lambda: stau_upsample_fused_fast_plain(*args), None, flops, io,
                 torch.bfloat16, device, tol=FAST_INNER_TOL, dt_name="fast",
                 mean_tol=FAST_INNER_MEAN_TOL)


def fast_tail_case(rng, model, device, b=WINDOWS, hw=LR_HW, scale=SCALE):
    """Kernel 5 in its default-precision mode: f32 in and out, the conv's
    and the skip's products of bf16 values. Library: F.conv2d and
    F.interpolate in bf16 on the inputs rounded to bf16."""
    h, w = hw
    H, W = get_hw(h, w, scale)
    c = model.cfg.num_feat
    sr = _rand(rng, (b, c, H, W), torch.float32, device)
    xc = torch.from_numpy(rng.random((b, 3, h, w)).astype(np.float32)).to(device)
    o = tail_operands(h, w, H, W, device)
    wt, bt = model.tail.weight.float(), model.tail.bias.float()
    args = (sr, xc, o["tail_j0"], o["tail_wy"], o["tail_c0"], o["tail_cw"], wt, bt)
    sr_b, xc_b, wt_b, bt_b = (t.to(torch.bfloat16) for t in (sr, xc, wt, bt))

    def library():
        return F.conv2d(sr_b, wt_b, bt_b, padding=1) + F.interpolate(
            xc_b, size=(H, W), mode="bilinear", align_corners=False)

    flops = (2.0 * 27 * c + 3 * 6.0) * H * W * b
    io = nbytes(sr, xc, wt, bt, *(o[k] for k in o)) + b * 3 * H * W * 4
    return check("tail_fast", f"C={c} {H}x{W}", lambda: tail_fused_fast(*args),
                 lambda: tail_fused_fast_plain(*args), library, flops, io, torch.bfloat16,
                 device, tol=FAST_INNER_TOL, dt_name="fast", mean_tol=FAST_INNER_MEAN_TOL)


def fast_parity(sd, device, split_parity_rows: dict) -> dict:
    """The flagship fast forward on the 45x80 golden input at three scales
    against the strict forward on the card: its deviation PSNR against
    strict at least the bf16 tier's, and its max abs against strict at
    least 10x the split tier's (phase 10), with its deviation PSNR against
    the reference torch outputs."""
    g = np.load(os.path.join(GOLDENS, "savsr_realsize_forward.npz"))
    x = torch.from_numpy(g["x"]).to(device)
    scales = (("y", (4.0, 4.0)), ("y_1.5_3.5", (1.5, 3.5)), ("y_3.05_3.05", (3.05, 3.05)))
    outs = {}
    for tier in ("fast", "strict", "bf16"):
        dt = torch.bfloat16 if tier == "bf16" else torch.float32
        model = build_serving_model(tier)
        load_into(model, {k: torch.from_numpy(v) for k, v in sd.items()})
        model.to(device=device, dtype=dt)
        ops.reset_counts()
        for key, scale in scales:
            statics = model.stau_statics(x.shape[-2:], scale, dtype=dt, device=device)
            outs[tier, key] = model(x.to(dt), scale, stau_statics=statics).float().cpu().numpy()
        if tier == "fast":
            launches = require_kernels_ran("fast-parity", FAST_KERNELS)
            require_none_of("fast-parity", launches, tier)
        del model
    result = {}
    for key, scale in scales:
        fast, strict, bf16 = (outs[t, key] for t in ("fast", "strict", "bf16"))
        if fast.shape != g[key].shape or not np.isfinite(fast).all():
            raise AssertionError(f"fast parity {key}: shape {fast.shape} or non-finite")
        err = float(np.abs(fast - strict).max())
        err_split = split_parity_rows[key]["max_abs_vs_strict"]
        row = {"max_abs_vs_strict": err, "split_max_abs_vs_strict": err_split,
               "bf16_max_abs_vs_strict": float(np.abs(bf16 - strict).max()),
               "db_vs_strict": deviation_psnr(fast, strict),
               "bf16_db_vs_strict": deviation_psnr(bf16, strict),
               "db_vs_reference": deviation_psnr(fast, g[key]),
               "strict_db_vs_reference": deviation_psnr(strict, g[key])}
        log(f"[fast] parity x{scale[0]}x{scale[1]} {tuple(x.shape)}: fast vs strict max abs "
            f"{err:.3e} ({err / max(err_split, 1e-30):.1f}x the split tier's {err_split:.3e}; bf16 "
            f"{row['bf16_max_abs_vs_strict']:.3e}), deviation PSNR vs strict "
            f"{row['db_vs_strict']:.2f} dB (bf16 {row['bf16_db_vs_strict']:.2f} dB); vs the "
            f"reference outputs: fast {row['db_vs_reference']:.2f} dB, strict "
            f"{row['strict_db_vs_reference']:.2f} dB")
        if not (row["db_vs_strict"] >= row["bf16_db_vs_strict"] and err >= 10 * err_split):
            raise AssertionError(f"fast parity {key}: {row}")
        result[key] = row
    return result


def phase_fast(sd, device, strict_results: dict, split_parity_rows: dict,
               bf16_launches: dict) -> dict:
    """Phase 11: the fast serving tier (see the module docstring)."""
    rng = np.random.default_rng(11)
    model = SAVSR(**flagship_net_kwargs()).eval()
    load_into(model, {k: torch.from_numpy(v) for k, v in sd.items()})
    model.to(device)
    with float32_precision(True):  # the plain versions run f32 with TF32 off
        pix = model.stau_statics(LR_HW, SCALE, dtype=torch.float32, device=device)["pix"]
        log_stau_plan("fast", pix, LR_HW, SCALE, torch.float32, fast=True)
        rows = [fast_conv_case(rng, *case, device) for case in FAST_CASES]
        rows += [fast_sta_case(rng, model, device), fast_stau_case(rng, model, pix, device),
                 fast_tail_case(rng, model, device)]
    del model
    failed = [r["case"] for r in rows if not r["ok"]]
    if failed:
        raise AssertionError(f"fast kernels disagree with their plain versions: {failed}")
    parity = fast_parity(sd, device, split_parity_rows)
    torch.cuda.empty_cache()
    serving = phase_serving(sd, device, tier="fast")
    want = {f"{k}_fast": bf16_launches[k] for k in SERVING_KERNELS}
    got = {k: serving["launches"][k] for k in want}
    if got != want:
        raise AssertionError(f"fast-serving: launches {got}, the bf16 run's {want}")
    profile = phase_profile(sd, device, tier="fast")
    torch.cuda.empty_cache()
    evaluation = tier_eval(sd, device, strict_results, "fast")
    return {"rows": rows, "parity": parity, "serving": serving, "profile": profile,
            "eval": evaluation}


# ---------------------------------------------------------------------------
# phase 12: distribution (one process per GPU, savsr_tpu_torch/parallel)
# ---------------------------------------------------------------------------

DIST_WORLD = 2
# the parity step's global batch: 2 seeded septuplets of 60x60 LR a rank, x4
DIST_ROWS, DIST_HW = 2 * DIST_WORLD, (60, 60)
# the CLI runs' iterations (a checkpoint every 2), and the resumed run's end
DIST_ITERS, DIST_RESUME_ITERS = 4, 6
# the eval run: the shipped Vid4 config's first three datasets
DIST_EVAL_COUNT = 3

# one rank of the parity step (run under torch.distributed.run): the step at
# accum 1 and 2 on the rank's share of the global batch, through the
# trainer's entry points, its kernel launch counts zeroed just before the
# step and read just after
DIST_STEP_WORKER = r'''
import json, os, sys, time
import numpy as np
import torch
from savsr_tpu_torch import ops
from savsr_tpu_torch.models import build_model
from savsr_tpu_torch.parallel import shard_or_replicate_batch
from savsr_tpu_torch.utils.dist_util import destroy_dist
from savsr_tpu_torch.utils.options import parse_options

work, device = sys.argv[1], sys.argv[2]
rank = os.environ["RANK"]
batch = dict(np.load(os.path.join(work, "batch.npz")))
out, info = {}, {}
for accum in (1, 2):
    opt, _ = parse_options(work, True, ["-opt", os.path.join(work, f"step{accum}.yml"),
                                        "--launcher", "pytorch", "--device", device])
    model = build_model(opt)
    share = shard_or_replicate_batch(dict(batch), model.mesh, accum)
    model.feed_data(dict(share, scale=(4.0, 4.0)))
    sync = torch.cuda.synchronize if model.device.type == "cuda" else (lambda: None)
    bands = model.mesh.bands
    before = dict(bands.stats) if bands is not None else {}
    sync()
    ops.reset_counts()
    t0 = time.perf_counter()
    model.optimize_parameters(1)
    sync()
    info[accum] = {"ms": 1e3 * (time.perf_counter() - t0), "launches": dict(ops.launches),
                   "plain_cuda": dict(ops.plain_cuda_calls), "world": opt["world_size"],
                   "rows": int(model.lq.shape[0]),
                   **{k: bands.stats[k] - v for k, v in before.items()}}
    out[f"{accum}/loss"] = np.float64(model.log_dict["l_pix"])
    out.update({f"{accum}/g/{k}": p.grad.cpu().numpy() for k, p in model.net_g.named_parameters()})
    out.update({f"{accum}/b/{k}": b.cpu().numpy() for k, b in model.net_g.named_buffers()})
    del model
np.savez(os.path.join(work, f"rank{rank}.npz"), **out)
with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
    json.dump(info, f)
destroy_dist()
'''

# one rank of the eval run: the eval pipeline with --launcher pytorch, the
# launch counts zeroed just before it and read just after
DIST_EVAL_WORKER = r'''
import json, os, sys
import torch
from savsr_tpu_torch import ops
from savsr_tpu_torch.test import test_pipeline
from savsr_tpu_torch.utils.dist_util import destroy_dist

work, cfg, device = sys.argv[1], sys.argv[2], sys.argv[3]
stats = []
ops.reset_counts()
results = test_pipeline(work, ["-opt", cfg, "--launcher", "pytorch", "--device", device], stats)
if device.startswith("cuda"):
    torch.cuda.synchronize()
with open(os.path.join(work, f"eval_rank{os.environ['RANK']}.json"), "w") as f:
    json.dump({"results": results, "launches": dict(ops.launches), "frames": len(stats),
               "plain_cuda": dict(ops.plain_cuda_calls)}, f)
destroy_dist()
'''


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def torchrun(nproc: int, args: list, cwd: str, log_dir=None, timeout: int = 600) -> str:
    """``python -m torch.distributed.run --nproc_per_node nproc <args>`` in
    ``cwd`` (each rank's output teed into ``log_dir``); its output. Raises
    if it fails; kills its whole process group if it outlives ``timeout``."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(nproc),
           "--master_port", str(free_port())]
    if log_dir is not None:
        cmd += ["--log-dir", log_dir, "--tee", "3"]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(cmd + args, cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        raise AssertionError(f"dist: {' '.join(cmd + args)} ran past {timeout} s")
    if proc.returncode != 0:
        raise AssertionError(f"dist: {' '.join(cmd + args)} exited {proc.returncode}:\n"
                             f"{out[-6000:]}")
    return out


def rank_logs(log_dir: str) -> dict:
    """{rank: its teed stdout} from a torch.distributed.run --log-dir."""
    found = {}
    for d, _, files in os.walk(log_dir):
        if "stdout.log" in files:
            with open(os.path.join(d, "stdout.log")) as f:
                found[int(os.path.basename(d))] = f.read()
    return found


def dist_yml(name: str, accum: int, pth: str, net: dict) -> str:
    """The parity step's config: the flagship network from ``pth``, strict
    f32, the shipped recipe's optimizer and loss, gloo."""
    network = "".join(f"  {k}: {v}\n" for k, v in net.items())
    return f"""
name: {name}
model_type: ASVSRModel
num_gpu: auto
manual_seed: 0
network_g:
  type: SAVSR
{network}  remat_train: false
path:
  pretrain_network_g: {pth}
  strict_load_g: true
  resume_state: ~
train:
  ema_decay: 0.999
  accum_steps: {accum}
  optim_g:
    type: Adam
    lr: !!float 2e-4
    weight_decay: 0
    betas: [0.9, 0.999]
  scheduler:
    type: CosineAnnealingRestartLR
    periods: [300000]
    restart_weights: [1]
    eta_min: !!float 1e-7
  total_iter: 1
  warmup_iter: -1
  pixel_opt:
    type: CharbonnierLoss
    loss_weight: 1.0
    reduction: mean
dist_params:
  backend: gloo
"""


def dist_batch(rows: int, hw, seed: int = 12) -> dict:
    """A global batch from ``seed``: ``rows`` septuplets of smooth texture +
    noise shifted from frame to frame, LR ``hw`` and GT x4."""
    import cv2

    rng = np.random.default_rng(seed)
    h, w = hw
    lq = np.empty((rows, 7, h, w, 3), np.float32)
    gt = np.empty((rows, 4 * h, 4 * w, 3), np.float32)
    for r in range(rows):
        base = cv2.resize(rng.random((h // 2, w // 2, 3)).astype(np.float32), (4 * w, 4 * h),
                          interpolation=cv2.INTER_CUBIC)
        gt[r] = np.clip(base + rng.normal(0, 0.02, base.shape), 0, 1)
        for t in range(7):
            lq[r, t] = cv2.resize(np.roll(gt[r], 2 * (t - 3), axis=1), (w, h),
                                  interpolation=cv2.INTER_AREA)
    return {"lq": lq, "gt": gt}


def one_process_step(tmp: str, accum: int, batch: dict, device) -> tuple:
    """The one-process step of ``step{accum}.yml`` in ``tmp`` on the whole
    ``batch`` at x4: (loss, gradients, BatchNorm buffers, host ms, the
    network's config)."""
    from savsr_tpu_torch.models import build_model
    from savsr_tpu_torch.utils.options import parse_options

    opt, _ = parse_options(tmp, True, ["-opt", os.path.join(tmp, f"step{accum}.yml"),
                                       "--device", str(device)])
    model = build_model(opt)
    model.feed_data(dict(batch, scale=(4.0, 4.0)))
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.optimize_parameters(1)
    if device.type == "cuda":
        torch.cuda.synchronize()
    one_ms = 1e3 * (time.perf_counter() - t0)
    return (float(model.log_dict["l_pix"]),
            {k: p.grad.cpu().numpy() for k, p in model.net_g.named_parameters()},
            {k: b.cpu().numpy() for k, b in model.net_g.named_buffers()}, one_ms,
            model.net_g.cfg)


def step_distance(out: dict, accum: int, ref, ref_b) -> tuple:
    """A saved step's (``out``: "<accum>/g/<name>" gradients, "<accum>/b/"
    buffers) distance from a one-process step's gradients ``ref`` and
    buffers ``ref_b``: (its gradients, BatchNorm max |d|, (worst gradient's
    error over its max, name), the gradients outside 2e-3 of their max +
    1e-7 (phase 6's bound))."""
    grads = {k: out[f"{accum}/g/{k}"] for k in ref}
    d_bn = max(float(np.abs(out[f"{accum}/b/{k}"].astype(np.float64) - v).max())
               for k, v in ref_b.items())
    worst, failed = (0.0, ""), []
    for k, v in ref.items():
        err, ref_max = float(np.abs(grads[k] - v).max()), float(np.abs(v).max())
        if ref_max > 1e-5:
            worst = max(worst, (err / ref_max, k))
        if not err <= 2e-3 * ref_max + 1e-7:
            failed.append((k, err, ref_max))
    return grads, d_bn, worst, failed


def dist_parity(sd, device, net=None, rows: int = DIST_ROWS, hw=DIST_HW) -> dict:
    """(a) Two ranks on ``device`` over gloo take the flagship's strict-f32
    step at accum 1 and 2 on their shares of one global batch; each is held
    against the one-process step on the whole batch on the same device:
    loss within 1e-5, BatchNorm running statistics within 1e-6, every
    gradient within 2e-3 of its own max + 1e-7 (phase 6's bounds); both
    ranks hold the same gradients; each rank's step launched the OSConv
    kernels as the architecture gives them."""
    net = net or flagship_net_kwargs()
    dev = "cuda:0" if device.type == "cuda" else "cpu"
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        pth = os.path.join(tmp, "weights.pth")
        torch.save({"params": {k: torch.from_numpy(v) for k, v in sd.items()}}, pth)
        batch = dist_batch(rows, hw)
        np.savez(os.path.join(tmp, "batch.npz"), **batch)
        for accum in (1, 2):
            with open(os.path.join(tmp, f"step{accum}.yml"), "w") as f:
                f.write(dist_yml(f"dist_parity_{accum}", accum, pth, net))
        with open(os.path.join(tmp, "worker.py"), "w") as f:
            f.write(DIST_STEP_WORKER)
        t0 = time.perf_counter()
        torchrun(DIST_WORLD, [os.path.join(tmp, "worker.py"), tmp, dev], tmp)
        ranks_s = time.perf_counter() - t0
        outs = [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(DIST_WORLD)]
        infos = []
        for r in range(DIST_WORLD):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                infos.append(json.load(f))
        for k in outs[0]:
            if not np.array_equal(outs[0][k], outs[1][k]):
                raise AssertionError(f"dist parity: the ranks hold different {k}")
        for accum in (1, 2):
            ref_loss, ref, ref_b, one_ms, cfg = one_process_step(tmp, accum, batch, device)
            out, info = outs[0], infos[0][str(accum)]
            d_loss = abs(float(out[f"{accum}/loss"]) - ref_loss)
            grads, d_bn, worst, failed = step_distance(out, accum, ref, ref_b)
            expect = expected_osconv_launches(cfg, accum)
            counts = [infos[r][str(accum)]["launches"] for r in range(DIST_WORLD)]
            res[accum] = {"loss": ref_loss, "loss_diff": d_loss, "bn_diff": d_bn,
                          "worst_rel": worst[0], "rel_l2": rel_l2(grads, ref),
                          "rank_ms": [infos[r][str(accum)]["ms"] for r in range(DIST_WORLD)],
                          "one_ms": one_ms}
            log(f"[dist] parity accum {accum}: global batch {rows} x {hw[0]}x{hw[1]} at x4 "
                f"({info['rows']} rows a rank, world {info['world']}, gloo on {dev}), strict "
                f"f32, num_feat {net['num_feat']}: loss {float(out[f'{accum}/loss']):.8f} vs one process "
                f"{ref_loss:.8f} (|d| {d_loss:.2e}, bound 1e-5); BatchNorm statistics |d| "
                f"{d_bn:.2e} (bound 1e-6); worst gradient {worst[0]:.3e} of its max at "
                f"{worst[1]} (bound 2e-3 + 1e-7); whole gradient {res[accum]['rel_l2']:.3e} "
                f"relative L2; step ms rank 0 / 1 {res[accum]['rank_ms'][0]:.1f} / "
                f"{res[accum]['rank_ms'][1]:.1f} (two ranks sharing one card), one process "
                f"{one_ms:.1f}; OSConv launches a rank "
                f"{[{k: c[k] for k in TRAINING_KERNELS} for c in counts]}")
            bad_counts = (device.type == "cuda" and any(
                any(c[k] != v for k, v in expect.items()) for c in counts)) or any(
                any(infos[r][str(accum)]["plain_cuda"].values()) for r in range(DIST_WORLD))
            if not d_loss < 1e-5 or not d_bn <= 1e-6 or failed or bad_counts:
                raise AssertionError(f"dist parity accum {accum}: loss {d_loss}, BatchNorm "
                                     f"{d_bn}, gradients off {failed[:5]}, launches {counts} "
                                     f"(expected {expect})")
    log(f"[dist] parity: two ranks' run {ranks_s:.1f} s (start-up included)")
    return res


def train_log_lines(exp: str) -> list:
    """The training log files of an experiment directory, in time order."""
    return sorted(os.path.join(exp, f) for f in os.listdir(exp)
                  if f.startswith("train_") and f.endswith(".log"))


def iter_records(log_path: str) -> list:
    """(iter, its seconds, l_pix) of each iteration line of a training log
    (print_freq 1). The log gives the running mean of the iteration times
    since the run started; iteration k's own is k x mean_k - (k-1) x
    mean_(k-1)."""
    import re

    pat = re.compile(r"iter:\s*([\d,]+).*time \(data\): ([\d.]+) .*l_pix: ([-\d.e+]+)")
    with open(log_path) as f:
        rows = [(int(m.group(1).replace(",", "")), float(m.group(2)), float(m.group(3)))
                for m in map(pat.search, f) if m]
    return [(it, round(k * mean - (k - 1) * (rows[k - 2][1] if k > 1 else 0.0), 3), loss)
            for k, (it, mean, loss) in enumerate(rows, 1)]


def dist_cli(device, n_seq: int = 32, yml: str = TRAIN_YML) -> dict:
    """(b) The training CLI under torch.distributed.run: the shipped recipe
    (phase 7's copy, seeded septuplets) on two ranks over gloo on one card
    for DIST_ITERS iterations, a checkpoint every 2, and the final
    validation: exactly one checkpoint file per save and one log, written
    by rank 0; then both ranks resume from the last checkpoint
    (--auto_resume) to DIST_RESUME_ITERS; then one rank over NCCL."""
    from savsr_tpu_torch.utils.options import yaml_load

    dev = "cuda:0" if device.type == "cuda" else "cpu"
    yml = (yml.replace("save_checkpoint_freq: {iters}", "save_checkpoint_freq: 2")
           .replace("name: smoke_SAVSR_Vimeo90K_asBI", "name: {name}")
           + "dist_params:\n  backend: {backend}\n  port: 29500\n")
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        write_septuplets(tmp, n_seq)
        write_clip(os.path.join(tmp, "Vid4", "GT"), EVAL_FRAMES, EVAL_HW, name="calendar")
        for name, backend, iters in (("dist_gloo", "gloo", DIST_ITERS),
                                     ("dist_nccl", "nccl", 2)):
            with open(os.path.join(tmp, f"{name}.yml"), "w") as f:
                f.write(yml.format(root=tmp, iters=iters, name=name, backend=backend))
        train = ["-m", "savsr_tpu_torch.train", "-opt", os.path.join(tmp, "dist_gloo.yml"),
                 "--launcher", "pytorch", "--device", dev]
        exp = os.path.join(tmp, "experiments", "dist_gloo")
        t0 = time.perf_counter()
        torchrun(DIST_WORLD, train, tmp, log_dir=os.path.join(tmp, "logs1"))
        res["gloo_s"] = time.perf_counter() - t0
        models, states = sorted(os.listdir(os.path.join(exp, "models"))), sorted(
            os.listdir(os.path.join(exp, "training_states")))
        logs = train_log_lines(exp)
        want = ([f"net_g_{i}.npz" for i in range(2, DIST_ITERS + 1, 2)] + ["net_g_latest.npz"],
                [f"{i}.state" for i in range(2, DIST_ITERS + 1, 2)])
        if (models, states) != want or len(logs) != 1:
            raise AssertionError(f"dist cli: models {models}, states {states} (want {want}), "
                                 f"logs {logs}")
        recs = iter_records(logs[0])
        with open(logs[0]) as f:
            val = [ln for ln in f if "# psnr_y" in ln]
        if [r[0] for r in recs] != list(range(1, DIST_ITERS + 1)) or not val or not all(
                np.isfinite(r[2]) for r in recs):
            raise AssertionError(f"dist cli: iterations {recs}, validation {val}")
        res["gloo"] = recs
        train_opt = yaml_load(os.path.join(tmp, "dist_gloo.yml"))
        b = train_opt["datasets"]["train"]["batch_size_per_gpu"]
        log(f"[dist] cli, 2 ranks over gloo on {dev} (sharing one card; not a scaling figure), "
            f"the shipped recipe (B={b} a rank = {train_opt['train']['accum_steps']} micro-"
            f"batches, global {DIST_WORLD * b}, bf16 {train_opt['train']['bf16']}), {DIST_ITERS} "
            f"iterations in {res['gloo_s']:.1f} s (start-up and the final validation included): "
            f"per iteration (time s, l_pix averaged over the ranks) "
            f"{[(r[0], r[1], round(r[2], 5)) for r in recs]}; rank 0 wrote {models} + {states} "
            f"and one log; final validation: {val[-1].strip()[:60]}")

        # both ranks resume from the last save
        t0 = time.perf_counter()
        torchrun(DIST_WORLD, train + ["--auto_resume", "--force_yml",
                                      f"train:total_iter={DIST_RESUME_ITERS}"],
                 tmp, log_dir=os.path.join(tmp, "logs2"))
        res["resume_s"] = time.perf_counter() - t0
        outs = rank_logs(os.path.join(tmp, "logs2"))
        ckpt = f"net_g_{DIST_ITERS}.npz"
        resumed = {r: ckpt in out and "Set pretrain_network_g" in out for r, out in outs.items()}
        logs = train_log_lines(exp)
        recs = iter_records(logs[-1])
        if (sorted(resumed) != list(range(DIST_WORLD)) or not all(resumed.values())
                or [r[0] for r in recs] != list(range(DIST_ITERS + 1, DIST_RESUME_ITERS + 1))
                or not os.path.isfile(os.path.join(exp, "models",
                                                   f"net_g_{DIST_RESUME_ITERS}.npz"))):
            raise AssertionError(f"dist cli resume: ranks resumed {resumed}, iterations {recs}")
        log(f"[dist] cli resume (--auto_resume, total_iter {DIST_RESUME_ITERS}): both ranks "
            f"loaded {ckpt} ({resumed}); iterations {[(r[0], r[1], round(r[2], 5)) for r in recs]}"
            f" in {res['resume_s']:.1f} s")

        # one rank over NCCL, through the same command (device cuda:<LOCAL_RANK>)
        if device.type == "cuda":
            t0 = time.perf_counter()
            torchrun(1, ["-m", "savsr_tpu_torch.train", "-opt",
                         os.path.join(tmp, "dist_nccl.yml"), "--launcher", "pytorch"], tmp)
            res["nccl_s"] = time.perf_counter() - t0
            exp = os.path.join(tmp, "experiments", "dist_nccl")
            recs = iter_records(train_log_lines(exp)[0])
            if ([r[0] for r in recs] != [1, 2]
                    or not os.path.isfile(os.path.join(exp, "models", "net_g_2.npz"))):
                raise AssertionError(f"dist cli nccl: iterations {recs}")
            res["nccl"] = recs
            log(f"[dist] cli, 1 rank over NCCL: iterations "
                f"{[(r[0], r[1], round(r[2], 5)) for r in recs]} in {res['nccl_s']:.1f} s")
    return res


def dist_eval(sd, device, eval_results: dict, net=None) -> dict:
    """(c) The eval pipeline on two ranks over gloo (items strided over the
    ranks, metric rows summed): the shipped Vid4 config's first three
    datasets at the strict tier, each rank's kernels launched, and the
    metrics equal to phase 9's one-process values to the printed digit."""
    from savsr_tpu_torch.utils.options import yaml_load

    dev = "cuda:0" if device.type == "cuda" else "cpu"
    names = [ds["name"] for ds in yaml_load(EVAL_YML)["datasets"].values()][:DIST_EVAL_COUNT]
    with tempfile.TemporaryDirectory() as tmp:
        pth = os.path.join(tmp, "savsr.pth")
        torch.save({"params": {k: torch.from_numpy(v) for k, v in sd.items()}}, pth)
        cfg = eval_config(tmp, pth, names=names, network=net)
        with open(cfg, "a") as f:
            f.write("dist_params:\n  backend: gloo\n")
        with open(os.path.join(tmp, "worker.py"), "w") as f:
            f.write(DIST_EVAL_WORKER)
        t0 = time.perf_counter()
        torchrun(DIST_WORLD, [os.path.join(tmp, "worker.py"), tmp, cfg, dev], tmp)
        wall = time.perf_counter() - t0
        infos = []
        for r in range(DIST_WORLD):
            with open(os.path.join(tmp, f"eval_rank{r}.json")) as f:
                infos.append(json.load(f))
    printed = {n: (f"{eval_results[n]['psnr_y']:.4f}", f"{eval_results[n]['ssim_y']:.6f}")
               for n in names}
    got = [{n: (f"{i['results'][n]['psnr_y']:.4f}", f"{i['results'][n]['ssim_y']:.6f}")
            for n in names} for i in infos]
    exact = all(i["results"][n] == eval_results[n] for i in infos for n in names)
    frames = [i["frames"] for i in infos]
    kernels_ok = device.type != "cuda" or all(
        all(i["launches"][k] > 0 for k in SERVING_KERNELS) and not any(i["plain_cuda"].values())
        for i in infos)
    log(f"[dist] eval, 2 ranks over gloo on {dev}: {names} at the strict tier in {wall:.1f} s "
        f"(start-up included), frames a rank {frames}; psnr_y / ssim_y {got[0]} (phase 9: "
        f"{printed}; {'bit-equal' if exact else 'equal to the printed digit'}); launches a rank "
        f"{[{k: i['launches'][k] for k in SERVING_KERNELS} for i in infos]}")
    if any(g != printed for g in got) or sum(frames) != len(names) * EVAL_FRAMES or not kernels_ok:
        raise AssertionError(f"dist eval: {got} vs {printed}, frames {frames}, launches "
                             f"{[i['launches'] for i in infos]}")
    return {"seconds": wall, "frames": frames, "bit_equal": exact,
            "launches": [i["launches"] for i in infos]}


def phase_dist(sd, device, eval_results: dict) -> dict:
    """Phase 12: distribution, one process per GPU (the card machine has one
    card, and NCCL takes no two ranks on one device, so the two-rank runs
    share it over gloo)."""
    t0 = time.perf_counter()
    res = {"parity": dist_parity(sd, device)}
    torch.cuda.empty_cache()
    res["cli"] = dist_cli(device)
    res["eval"] = dist_eval(sd, device, eval_results)
    res["seconds"] = time.perf_counter() - t0
    log(f"[dist] phase 12: {res['seconds']:.1f} s")
    return res


# ---------------------------------------------------------------------------
# phase 13: spatial sharding of the eval forward (savsr_tpu_torch/parallel/spatial.py)
# ---------------------------------------------------------------------------

SPATIAL_WORLD = 2
SPATIAL_SCALES = ((4.0, 4.0), (1.5, 3.5), (3.05, 3.05))
SPATIAL_TIERS = ("strict", "bf16", "split", "fast")
SPATIAL_KERNELS = {"strict": SERVING_KERNELS, **TIER_KERNELS}
# max abs against one process: strict the JAX package's bound for a sharded
# frame (tests/test_spatial_sharding.py; the f32 conv splits its Cin sum by
# the output's tile count, f32_chunks, so a band's rows round apart); the
# other tiers equal to the bit, as in tests/test_torch_spatial.py (their
# kernels sum each pixel in one order at any height)
SPATIAL_TOL = {"strict": 1e-5, "bf16": 0.0, "split": 0.0, "fast": 0.0}

# one rank of the spatial run (under torch.distributed.run, mesh {spatial:
# 2}): the eval pipeline on the config's datasets, then each tier's forward
# of one window at each scale on this rank's band, gathered on band 0; the
# launch counts zeroed just before each forward and read just after, the
# rows exchanged, and one profiled forward a tier at the first scale
SPATIAL_WORKER = r'''
import json, os, sys, time
import numpy as np
import torch
import chip_smoke as cs
from savsr_tpu_torch import ops
from savsr_tpu_torch.inference import build_serving_model
from savsr_tpu_torch.parallel import get_mesh_from_opt
from savsr_tpu_torch.parallel.spatial import gather_rows
from savsr_tpu_torch.test import test_pipeline
from savsr_tpu_torch.utils.convert import load_into
from savsr_tpu_torch.utils.dist_util import destroy_dist

work, cfg, device = sys.argv[1], sys.argv[2], torch.device(sys.argv[3])
net, scales, tiers, spatial = (json.loads(a) for a in sys.argv[4:8])
rank = int(os.environ["RANK"])
cuda = device.type == "cuda"
sync = torch.cuda.synchronize if cuda else (lambda: None)
stats = []
ops.reset_counts()
t0 = time.perf_counter()
results = test_pipeline(work, ["-opt", cfg, "--launcher", "pytorch", "--device", str(device)],
                        stats)
sync()
info = {"eval": {"results": results, "launches": dict(ops.launches), "frames": len(stats),
                 "plain_cuda": dict(ops.plain_cuda_calls), "seconds": time.perf_counter() - t0},
        "forward": {}}
mesh = get_mesh_from_opt({"dist": True, "mesh": {"spatial": spatial}})
bands = mesh.bands
info["band"] = mesh.band
sd = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(work, "weights.npz")).items()}
x = torch.from_numpy(np.load(os.path.join(work, "x.npy"))).to(device)
out = {}
for tier in tiers:
    dt = torch.bfloat16 if tier == "bf16" else torch.float32
    model = build_serving_model(tier, net)
    load_into(model, sd)
    model.to(device=device, dtype=dt)
    for i, scale in enumerate(map(tuple, scales)):
        statics = model.stau_statics(x.shape[-2:], scale, dtype=dt, device=device, band=bands)
        sync()
        before = dict(bands.stats)
        ops.reset_counts()
        t1 = time.perf_counter()
        y = model(x.to(dt), scale, stau_statics=statics, band=bands)
        sync()
        rec = {"launches": dict(ops.launches), "plain_cuda": dict(ops.plain_cuda_calls),
               "host_ms": 1e3 * (time.perf_counter() - t1),
               "exchanges": bands.stats["exchanges"] - before["exchanges"],
               "bytes": bands.stats["bytes"] - before["bytes"],
               "geometry": {k: statics["band"][k] for k in ("lr", "hr", "windows", "hr_ext")}}
        if i == 0 and cuda:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                model(x.to(dt), scale, stau_statics=statics, band=bands)
                sync()
            rows = cs.device_rows(prof)
            rec["device_busy_ms"] = sum(r[1] for r in rows)
            # gloo's staging of the exchanged rows through the host
            rec["memcpy_ms"] = sum(r[1] for r in rows if "memcpy" in r[0].lower())
        info["forward"][f"{tier} {scale[0]}x{scale[1]}"] = rec
        y = gather_rows(y, bands, statics["band"]["hr"])
        if y is not None:
            out[f"{tier} {scale[0]}x{scale[1]}"] = y.float().cpu().numpy()
    del model
np.savez(os.path.join(work, f"spatial_rank{rank}.npz"), **out)
with open(os.path.join(work, f"spatial_rank{rank}.json"), "w") as f:
    json.dump(info, f)
destroy_dist()
'''


def spatial_window(hw) -> np.ndarray:
    """One seeded 7-frame window [1, 7, 3, h, w] (write_clip's frames)."""
    import cv2

    with tempfile.TemporaryDirectory() as tmp:
        d = write_clip(tmp, 7, hw)
        frames = [cv2.imread(os.path.join(d, f))[..., ::-1] for f in sorted(os.listdir(d))]
    return (np.stack(frames).transpose(0, 3, 1, 2)[None] / 255.0).astype(np.float32)


def phase_spatial(sd, device, eval_results: dict, net=None, hw=LR_HW,
                  scales=SPATIAL_SCALES, tiers=SPATIAL_TIERS) -> dict:
    """Phase 13: spatial sharding of the eval forward, two ranks over gloo
    on one card under torch.distributed.run (mesh {spatial: 2}): (a) one
    seeded window of ``hw`` at each scale in each tier, each rank on its
    band and band 0 gathering, against the one-process forward on the same
    device within SPATIAL_TOL max abs (strict 1e-5, the other tiers
    bit-equal), the tier's own distance from strict printed beside; every
    kernel of the tier launched by each rank, no plain version on the card;
    (b) the eval pipeline on the shipped Vid4 config's first three datasets
    at the strict tier: psnr_y and ssim_y within 1e-4 of phase 9's, band 0
    scoring every frame and band 1 none."""
    from torch.profiler import ProfilerActivity, profile

    from savsr_tpu_torch.utils.options import yaml_load

    net = net or flagship_net_kwargs()
    dev = "cuda:0" if device.type == "cuda" else "cpu"
    smi = card_name()
    t0 = time.perf_counter()
    x = spatial_window(hw)
    xt = torch.from_numpy(x).to(device)
    one, busy_one = {}, {}
    for tier in tiers:  # the one-process forwards
        dt = torch.bfloat16 if tier == "bf16" else torch.float32
        model = build_serving_model(tier, net)
        load_into(model, {k: torch.from_numpy(v) for k, v in sd.items()})
        model.to(device=device, dtype=dt)
        for i, scale in enumerate(scales):
            statics = model.stau_statics(hw, scale, dtype=dt, device=device)
            one[f"{tier} {scale[0]}x{scale[1]}"] = model(
                xt.to(dt), scale, stau_statics=statics).float().cpu().numpy()
            if i == 0 and device.type == "cuda":
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    model(xt.to(dt), scale, stau_statics=statics)
                    torch.cuda.synchronize()
                busy_one[tier] = sum(r[1] for r in device_rows(prof))
        del model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    names = [ds["name"] for ds in yaml_load(EVAL_YML)["datasets"].values()][:DIST_EVAL_COUNT]
    with tempfile.TemporaryDirectory() as tmp:
        pth = os.path.join(tmp, "savsr.pth")
        torch.save({"params": {k: torch.from_numpy(v) for k, v in sd.items()}}, pth)
        np.savez(os.path.join(tmp, "weights.npz"), **sd)
        np.save(os.path.join(tmp, "x.npy"), x)
        cfg = eval_config(tmp, pth, names=names, network=net)
        with open(cfg, "a") as f:
            f.write(f"mesh:\n  spatial: {SPATIAL_WORLD}\ndist_params:\n  backend: gloo\n")
        with open(os.path.join(tmp, "worker.py"), "w") as f:
            f.write(SPATIAL_WORKER)
        t1 = time.perf_counter()
        torchrun(SPATIAL_WORLD, [os.path.join(tmp, "worker.py"), tmp, cfg, dev, json.dumps(net),
                                 json.dumps(scales), json.dumps(list(tiers)),
                                 str(SPATIAL_WORLD)], tmp)
        ranks_s = time.perf_counter() - t1
        outs, infos = [], []
        for r in range(SPATIAL_WORLD):
            outs.append(dict(np.load(os.path.join(tmp, f"spatial_rank{r}.npz"))))
            with open(os.path.join(tmp, f"spatial_rank{r}.json")) as f:
                infos.append(json.load(f))

    # (a) the forwards
    res, failed = {"forward": {}}, []
    for tier in tiers:
        for scale in scales:
            key = f"{tier} {scale[0]}x{scale[1]}"
            strict_key = f"strict {scale[0]}x{scale[1]}"
            err = float(np.abs(outs[0][key] - one[key]).max())
            to_strict = (float(np.abs(one[key] - one[strict_key]).max())
                         if strict_key in one and tier != "strict" else None)
            bound = SPATIAL_TOL[tier]
            recs = [i["forward"][key] for i in infos]
            ran = all(all(rec["launches"][k] > 0 for k in SPATIAL_KERNELS[tier])
                      and not any(rec["plain_cuda"].values()) for rec in recs) \
                or device.type != "cuda"
            geo = recs[0]["geometry"]
            log(f"[spatial] {key} {hw[0]}x{hw[1]}, {SPATIAL_WORLD} ranks: max abs "
                f"{err:.3e} from one process"
                f"{' (bit-equal)' if err == 0 else ''}, bound {bound:.3e}"
                + ("" if to_strict is None else f" (the tier's distance from strict "
                                                 f"{to_strict:.3e})")
                + f"; per rank: LR band rows {geo['lr']}, HR rows {geo['hr']}, STAU LR windows "
                f"{geo['windows']}; exchanges / bytes sent "
                f"{[(rec['exchanges'], rec['bytes']) for rec in recs]}; launches "
                f"{[{k: rec['launches'][k] for k in SPATIAL_KERNELS[tier]} for rec in recs]}; "
                f"host ms {[round(rec['host_ms'], 1) for rec in recs]}")
            res["forward"][key] = {"max_abs": err, "bound": bound, "to_strict": to_strict,
                                   "exchanges": [rec["exchanges"] for rec in recs],
                                   "bytes": [rec["bytes"] for rec in recs],
                                   "launches": [rec["launches"] for rec in recs]}
            if not err <= bound or not ran or len(outs[1]):
                failed.append((key, err, bound, ran))
        if device.type == "cuda":
            key = f"{tier} {scales[0][0]}x{scales[0][1]}"
            busy = [i["forward"][key]["device_busy_ms"] for i in infos]
            copies = [i["forward"][key]["memcpy_ms"] for i in infos]
            res["forward"][key].update(device_busy_ms=busy, memcpy_ms=copies,
                                       one_process_busy_ms=busy_one[tier])
            log(f"[spatial] {key}: device busy a rank {[round(b, 2) for b in busy]} ms (of it "
                f"host-device copies, gloo's staging of the exchanges, "
                f"{[round(c, 2) for c in copies]} ms), one process {busy_one[tier]:.2f} ms "
                f"({smi}; two ranks share the card: not a scaling figure)")

    # (b) the eval
    got = [{n: (i["eval"]["results"][n]["psnr_y"], i["eval"]["results"][n]["ssim_y"])
            for n in names} for i in infos]
    want = {n: (eval_results[n]["psnr_y"], eval_results[n]["ssim_y"]) for n in names}
    d_eval = max(abs(g[n][k] - want[n][k]) for g in got for n in names for k in (0, 1))
    frames = [i["eval"]["frames"] for i in infos]
    eval_ran = device.type != "cuda" or all(
        all(i["eval"]["launches"][k] > 0 for k in SERVING_KERNELS)
        and not any(i["eval"]["plain_cuda"].values()) for i in infos)
    log(f"[spatial] eval, {SPATIAL_WORLD} ranks over gloo on {dev} (mesh spatial "
        f"{SPATIAL_WORLD}): {names} strict, psnr_y / ssim_y "
        f"{ {n: (round(v[0], 4), round(v[1], 6)) for n, v in got[0].items()} } (phase 9: "
        f"{ {n: (round(v[0], 4), round(v[1], 6)) for n, v in want.items()} }; max |d| "
        f"{d_eval:.2e}{', bit-equal' if d_eval == 0 else ''}); frames scored a rank {frames}; "
        f"launches a rank {[{k: i['eval']['launches'][k] for k in SERVING_KERNELS} for i in infos]}"
        f"; {[round(i['eval']['seconds'], 1) for i in infos]} s a rank")
    res["eval"] = {"max_diff": d_eval, "frames": frames,
                   "launches": [i["eval"]["launches"] for i in infos]}
    if not d_eval <= 1e-4 or frames != [len(names) * EVAL_FRAMES, 0] or not eval_ran:
        failed.append(("eval", d_eval, frames, eval_ran))
    res["seconds"] = time.perf_counter() - t0
    log(f"[spatial] phase 13: {res['seconds']:.1f} s (the two ranks' run {ranks_s:.1f} s with "
        "start-up)")
    if failed:
        raise AssertionError(f"spatial: {failed}")
    return res


# ---------------------------------------------------------------------------
# phase 14: spatially sharded training (mesh {spatial: 2} with a train: block)
# ---------------------------------------------------------------------------

# the CLI run's iterations (one checkpoint) and the resumed run's end; its
# validation clip (a quarter of phase 9's frame: the sharded eval is phase
# 13's, and the phase keeps within ~120 s)
SPATIAL_TRAIN_ITERS, SPATIAL_TRAIN_RESUME = 2, 4
SPATIAL_TRAIN_VAL_HW = (288, 360)
# the parity step's batch seed (phase 12's batch, seed 12, has a ReLU kink
# in adapt.0's mask head that crosses the bound): one where a relative 1e-6
# move of the input moves no gradient by more than its bound, in the whole
# batch and in either micro-batch (kink_check, run by the phase); of seeds
# 13-20 (scripts/gradient_kink_probe.py) 13 keeps the largest jump lowest
SPATIAL_TRAIN_SEED = 13


def strict_gradients(model, lq: np.ndarray, gt: np.ndarray, device) -> dict:
    """One process's strict f32 gradient of the mean Charbonnier loss of
    ``model`` at x4 on channel-last ``lq`` [B, T, h, w, C], ``gt``."""
    model.zero_grad(set_to_none=True)
    x = torch.from_numpy(lq).permute(0, 1, 4, 2, 3).contiguous().to(device)
    y = torch.from_numpy(gt).permute(0, 3, 1, 2).to(device)
    out, _ = model(x, (4.0, 4.0), train=True)
    with float32_precision():
        torch.sqrt((out - y) ** 2 + 1e-12).mean().backward()
    return {k: p.grad.cpu().numpy() for k, p in model.named_parameters()}


def kink_check(model, batch: dict, device, draws: int = 3) -> dict:
    """Whether ``batch`` sits near a ReLU kink that the parity bound would
    see: for the whole batch and each half (accum 2's micro-batches), the
    largest move of any gradient when the input moves by a relative 1e-6
    (``draws`` draws), over that gradient's parity bound (2e-3 of its max +
    1e-7): {part: (move over bound, gradient, move, its max)}. A ReLU input
    within rounding distance of 0 flips under such a move, as it may under
    another sum order (one process, two bands); the phase needs every jump
    within the bound, so that no flip crosses it on its own (none of nine
    seeds probed kept every jump within half of it: the mask heads' ReLUs
    on batch statistics of 2-4 samples). (The CPU tests' premise, 1e-4 of the max, is
    1e-9-5e-9 for a mask-head gradient, whose max is 1e-5-5e-5: below the
    card's own run-to-run spread of the gradient, 7.5e-9-1.5e-8.)"""
    n, worst = batch["lq"].shape[0], {}
    for part, rows in (("whole", slice(0, n)), ("micro 0", slice(0, n // 2)),
                       ("micro 1", slice(n // 2, n))):
        lq, gt = batch["lq"][rows], batch["gt"][rows]
        ref = strict_gradients(model, lq, gt, device)
        noise = np.random.default_rng(5)
        worst[part] = (0.0, "", 0.0, 0.0)
        for _ in range(draws):
            moved = strict_gradients(model, (lq * (1 + 1e-6 * noise.standard_normal(lq.shape)))
                                     .astype(np.float32), gt, device)
            for k, v in ref.items():
                d, top = float(np.abs(moved[k] - v).max()), float(np.abs(v).max())
                worst[part] = max(worst[part], (d / (2e-3 * top + 1e-7), k, d, top))
    return worst


def spatial_train_parity(sd, device, net=None, rows: int = DIST_ROWS, hw=DIST_HW,
                         seed: int = SPATIAL_TRAIN_SEED) -> dict:
    """(a) Two ranks on ``device`` over gloo, mesh {spatial: 2}, take the
    flagship's strict-f32 step at accum 1 and 2, each on its band of rows of
    every sample of a global batch like phase 12's, from ``seed`` (bands of
    30 LR and 120 HR rows at 60x60, x4), whose ReLU kinks must each jump
    by less than the bound (``kink_check``: the premise of the bounds,
    checked here); each is
    held against the one-process step on the whole batch on the same
    device at phase 12's bounds: loss within 1e-5, BatchNorm statistics within 1e-6,
    every gradient within 2e-3 of its own max + 1e-7; both ranks hold the
    same gradients; each rank's step launched rows 6-7 on their CUDA kernels
    as the architecture gives them (counts zeroed just before the step, read
    just after), no plain version. Prints each rank's exchanges and bytes
    sent a step and its step time beside one process's."""
    net = net or flagship_net_kwargs()
    dev = "cuda:0" if device.type == "cuda" else "cpu"
    smi = card_name()
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        pth = os.path.join(tmp, "weights.pth")
        torch.save({"params": {k: torch.from_numpy(v) for k, v in sd.items()}}, pth)
        batch = dist_batch(rows, hw, seed)
        np.savez(os.path.join(tmp, "batch.npz"), **batch)
        for accum in (1, 2):
            with open(os.path.join(tmp, f"step{accum}.yml"), "w") as f:
                f.write(dist_yml(f"spatial_train_{accum}", accum, pth, net)
                        + f"mesh:\n  spatial: {SPATIAL_WORLD}\n")
        with open(os.path.join(tmp, "worker.py"), "w") as f:
            f.write(DIST_STEP_WORKER)
        t0 = time.perf_counter()
        torchrun(SPATIAL_WORLD, [os.path.join(tmp, "worker.py"), tmp, dev], tmp)
        ranks_s = time.perf_counter() - t0
        outs = [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(SPATIAL_WORLD)]
        infos = []
        for r in range(SPATIAL_WORLD):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                infos.append(json.load(f))
        same = all(np.array_equal(outs[0][k], outs[1][k]) for k in outs[0])
        for accum in (1, 2):
            # the same configs without the mesh: the one-process step
            with open(os.path.join(tmp, f"step{accum}.yml"), "w") as f:
                f.write(dist_yml(f"spatial_train_one_{accum}", accum, pth, net))
            ref_loss, ref, ref_b, one_ms, cfg = one_process_step(tmp, accum, batch, device)
            out = outs[0]
            recs = [infos[r][str(accum)] for r in range(SPATIAL_WORLD)]
            loss = float(out[f"{accum}/loss"])
            d_loss = abs(loss - ref_loss)
            grads, d_bn, worst, failed = step_distance(out, accum, ref, ref_b)
            expect = expected_osconv_launches(cfg, accum)
            counts = [{f"{k} ({CUDA_KERNELS[k, 'f32']})": rec["launches"][k]
                       for k in TRAINING_KERNELS} for rec in recs]
            res[accum] = {"loss": loss, "loss_diff": d_loss, "bn_diff": d_bn,
                          "worst_rel": worst[0], "worst_at": worst[1],
                          "rel_l2": rel_l2(grads, ref), "ranks_equal": same,
                          "rank_ms": [rec["ms"] for rec in recs], "one_ms": one_ms,
                          "exchanges": [rec["exchanges"] for rec in recs],
                          "bytes": [rec["bytes"] for rec in recs], "launches": counts}
            log(f"[spatial-train] parity accum {accum}: {recs[0]['rows']} samples of "
                f"{hw[0]}x{hw[1]} (batch seed {seed}) at x4 on {SPATIAL_WORLD} bands (world "
                f"{recs[0]['world']}, mesh spatial {SPATIAL_WORLD}, gloo on {dev}), strict f32, "
                f"num_feat {net['num_feat']}: loss {loss:.8f} vs one process {ref_loss:.8f} (|d| "
                f"{d_loss:.2e}, bound 1e-5); BatchNorm statistics |d| {d_bn:.2e} (bound 1e-6); "
                f"worst gradient {worst[0]:.3e} of its max at {worst[1]} (bound 2e-3 + 1e-7); "
                f"whole gradient {res[accum]['rel_l2']:.3e} relative L2; ranks' gradients and "
                f"statistics {'identical' if same else 'DIFFERENT'}; rows 6-7 launches a rank "
                f"{counts}; exchanges / bytes sent a rank-step "
                f"{list(zip(res[accum]['exchanges'], res[accum]['bytes']))}; step ms rank 0 / 1 "
                f"{recs[0]['ms']:.1f} / {recs[1]['ms']:.1f} (two ranks sharing one card: not a "
                f"scaling figure), one process {one_ms:.1f} ({smi})")
            bad_counts = (device.type == "cuda" and any(
                any(rec["launches"][k] != v for k, v in expect.items()) for rec in recs)) or any(
                any(rec["plain_cuda"].values()) for rec in recs)
            if not d_loss < 1e-5 or not d_bn <= 1e-6 or failed or bad_counts or not same:
                raise AssertionError(f"spatial-train parity accum {accum}: loss {d_loss}, "
                                     f"BatchNorm {d_bn}, gradients off {failed[:5]}, ranks equal "
                                     f"{same}, launches {[r['launches'] for r in recs]} "
                                     f"(expected {expect})")
    log(f"[spatial-train] parity: two ranks' run {ranks_s:.1f} s (start-up included)")
    t0 = time.perf_counter()
    model = SAVSR(**dict(net, remat_train=False))
    load_into(model, {k: torch.from_numpy(v) for k, v in sd.items()})
    worst = kink_check(model.to(device), batch, device)
    res["kink"] = worst
    log(f"[spatial-train] premise: batch seed {seed}, the largest gradient move under a "
        f"relative 1e-6 input move (3 draws) over its bound (2e-3 of its max + 1e-7; at "
        f"most 1), "
        f"by part (over bound, gradient, move, its max): "
        f"{({k: (round(v[0], 4), v[1], f'{v[2]:.3e}', f'{v[3]:.3e}') for k, v in worst.items()})} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not all(v[0] <= 1.0 for v in worst.values()):
        raise AssertionError(f"spatial-train: batch seed {seed} sits near a ReLU kink: {worst}")
    return res


def spatial_train_cli(device, n_seq: int = 32, yml: str = TRAIN_YML) -> dict:
    """(b) The training CLI under torch.distributed.run with mesh {spatial:
    2}: the shipped recipe (phase 7's copy, seeded septuplets; 60-row LR
    crops, bands of 30) on two ranks over gloo on one card for
    SPATIAL_TRAIN_ITERS iterations with one checkpoint and the final
    validation (the sharded eval, on a SPATIAL_TRAIN_VAL_HW clip), written
    by rank 0 alone; then both ranks resume from it (--auto_resume) to
    SPATIAL_TRAIN_RESUME."""
    from savsr_tpu_torch.utils.options import yaml_load

    dev = "cuda:0" if device.type == "cuda" else "cpu"
    yml = (yml.replace("name: smoke_SAVSR_Vimeo90K_asBI", "name: spatial_train")
           + f"mesh:\n  spatial: {SPATIAL_WORLD}\ndist_params:\n  backend: gloo\n")
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        write_septuplets(tmp, n_seq)
        write_clip(os.path.join(tmp, "Vid4", "GT"), EVAL_FRAMES, SPATIAL_TRAIN_VAL_HW,
                   name="calendar")
        cfg = os.path.join(tmp, "spatial_train.yml")
        with open(cfg, "w") as f:
            f.write(yml.format(root=tmp, iters=SPATIAL_TRAIN_ITERS))
        train = ["-m", "savsr_tpu_torch.train", "-opt", cfg, "--launcher", "pytorch",
                 "--device", dev]
        exp = os.path.join(tmp, "experiments", "spatial_train")
        t0 = time.perf_counter()
        torchrun(SPATIAL_WORLD, train, tmp, log_dir=os.path.join(tmp, "logs1"))
        res["seconds"] = time.perf_counter() - t0
        models, states = sorted(os.listdir(os.path.join(exp, "models"))), sorted(
            os.listdir(os.path.join(exp, "training_states")))
        logs = train_log_lines(exp)
        want = ([f"net_g_{SPATIAL_TRAIN_ITERS}.npz", "net_g_latest.npz"],
                [f"{SPATIAL_TRAIN_ITERS}.state"])
        if (models, states) != want or len(logs) != 1:
            raise AssertionError(f"spatial-train cli: models {models}, states {states} (want "
                                 f"{want}), logs {logs}")
        recs = iter_records(logs[0])
        with open(logs[0]) as f:
            val = [ln for ln in f if "# psnr_y" in ln]
        if [r[0] for r in recs] != list(range(1, SPATIAL_TRAIN_ITERS + 1)) or not val or not all(
                np.isfinite(r[2]) for r in recs):
            raise AssertionError(f"spatial-train cli: iterations {recs}, validation {val}")
        res["iterations"] = recs
        train_opt = yaml_load(cfg)
        b = train_opt["datasets"]["train"]["batch_size_per_gpu"]
        lq = train_opt["datasets"]["train"]["lq_size"]
        log(f"[spatial-train] cli, {SPATIAL_WORLD} ranks over gloo on {dev} with mesh spatial "
            f"{SPATIAL_WORLD} (sharing one card; not a scaling figure), the shipped recipe (B={b} "
            f"a data group = {train_opt['train']['accum_steps']} micro-batches, each sample's "
            f"{lq}-row LR crop in bands of {lq // SPATIAL_WORLD}, bf16 "
            f"{train_opt['train']['bf16']}), "
            f"{SPATIAL_TRAIN_ITERS} iterations in {res['seconds']:.1f} s (start-up and the "
            f"final validation included): per iteration (time s, l_pix) "
            f"{[(r[0], r[1], round(r[2], 5)) for r in recs]}; rank 0 wrote {models} + {states} "
            f"and one log; final validation: {val[-1].strip()[:60]}")

        t0 = time.perf_counter()
        torchrun(SPATIAL_WORLD, train + ["--auto_resume", "--force_yml",
                                         f"train:total_iter={SPATIAL_TRAIN_RESUME}"],
                 tmp, log_dir=os.path.join(tmp, "logs2"))
        res["resume_seconds"] = time.perf_counter() - t0
        outs = rank_logs(os.path.join(tmp, "logs2"))
        ckpt = f"net_g_{SPATIAL_TRAIN_ITERS}.npz"
        resumed = {r: ckpt in out and "Set pretrain_network_g" in out for r, out in outs.items()}
        recs = iter_records(train_log_lines(exp)[-1])
        models = sorted(os.listdir(os.path.join(exp, "models")))
        if (sorted(resumed) != list(range(SPATIAL_WORLD)) or not all(resumed.values())
                or [r[0] for r in recs] != list(range(SPATIAL_TRAIN_ITERS + 1,
                                                      SPATIAL_TRAIN_RESUME + 1))
                or not all(np.isfinite(r[2]) for r in recs)
                or f"net_g_{SPATIAL_TRAIN_RESUME}.npz" not in models):
            raise AssertionError(f"spatial-train cli resume: ranks resumed {resumed}, "
                                 f"iterations {recs}, models {models}")
        res["resumed"] = recs
        log(f"[spatial-train] cli resume (--auto_resume, total_iter {SPATIAL_TRAIN_RESUME}): "
            f"both ranks loaded {ckpt} ({resumed}); iterations "
            f"{[(r[0], r[1], round(r[2], 5)) for r in recs]} in {res['resume_seconds']:.1f} s; "
            f"rank 0 wrote {models}")
    return res


def phase_spatial_train(sd, device) -> dict:
    """Phase 14: spatially sharded training, two ranks over gloo on one card
    (mesh {spatial: 2}): (a) the flagship's strict step against one
    process's, (b) the training CLI and its resume."""
    t0 = time.perf_counter()
    res = {"parity": spatial_train_parity(sd, device)}
    if device.type == "cuda":
        torch.cuda.empty_cache()
    res["cli"] = spatial_train_cli(device)
    res["seconds"] = time.perf_counter() - t0
    log(f"[spatial-train] phase 14: {res['seconds']:.1f} s")
    return res


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them, each
    distinct line once (the CPU's rehearsal: "cpu")."""
    if not torch.cuda.is_available():
        return "cpu"
    lines = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return "; ".join(dict.fromkeys(line.strip() for line in lines))


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
                    # C7514 / C7518: ptxas serialised a kernel's wgmmas
                    if ("registers" in line or "spill" in line or "Compiling entry" in line
                            or "wgmma" in line or "C751" in line):
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
    smi = card_name()
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} "
        f"(nvidia-smi: {smi}), torch {torch.__version__}, CUDA {torch.version.cuda}")

    phase_build()

    sd = dict(np.load(os.path.join(GOLDENS, "savsr_state_dict.npz")))
    model = SAVSR(**flagship_net_kwargs()).eval()
    load_into(model, {k: torch.from_numpy(v) for k, v in sd.items()})
    model.to(device)

    rows = phase_kernels(model, device)
    parity = phase_parity(model, device)
    del model
    torch.cuda.empty_cache()
    serving = phase_serving(sd, device)
    phase_profile(sd, device)
    torch.cuda.empty_cache()
    strict = phase_profile(sd, device, tier="strict")
    torch.cuda.empty_cache()
    train_parity = phase_train_parity(device)
    training = phase_training(device)
    torch.cuda.empty_cache()
    evaluation = phase_eval(sd, device)
    torch.cuda.empty_cache()
    split = phase_split(sd, device, evaluation["results"])
    torch.cuda.empty_cache()
    fast = phase_fast(sd, device, evaluation["results"], split["parity"], serving["launches"])
    torch.cuda.empty_cache()
    dist = phase_dist(sd, device, evaluation["results"])
    torch.cuda.empty_cache()
    spatial = phase_spatial(sd, device, evaluation["results"])
    torch.cuda.empty_cache()
    spatial_train = phase_spatial_train(sd, device)
    rows = rows + split["rows"] + fast["rows"]

    def entry(name, dtype, source, replaces, launches):
        head = next(r for r in rows if r["name"] == name and r["dtype"] == dtype
                    and r["case"] == HEADLINE.get(name, r["case"]))
        return {"name": name, "dtype": dtype, "kernel": CUDA_KERNELS[name, dtype],
                "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": head["max_abs_err"], "ms": head["ms"],
                "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
                "bound_by": head["bound_by"], "library_ms": head["library_ms"],
                **{k: head[k] for k in ("graph_ms", "library_graph_ms") if k in head}}

    # the bf16 rows: launches on the main paths (serving, training); the f32
    # rows (the strict tier's kernels: csrc/conv.cu conv_f32_kernel, which
    # also runs every f32 OSConv, sta_f32_kernel, stau_f32_kernel,
    # tail_f32_kernel): launches on the eval pipeline's main-path run (the
    # strict tier's path) and, for the f32 OSConv, the f32 train-parity step
    kernels = [entry(name, "bf16", source, replaces,
                     (training if name in TRAINING_KERNELS else serving)["launches"][name])
               for name, (source, replaces) in SOURCES.items()
               if name not in SPLIT_KERNELS + FAST_KERNELS]
    kernels += [entry(name, "f32", SOURCES[name][0] if name in ("sta", "stau", "tail")
                      else "savsr_tpu_torch/csrc/conv.cu", SOURCES[name][1],
                      train_parity[name] if name in TRAINING_KERNELS
                      else evaluation["launches"][name])
                for name in ("conv3x3", "conv1x1", "sta", "stau", "tail", "osconv_agg")]
    # the split rows: launches on the split tier's serving main-path run
    kernels += [entry(name, "split", *SOURCES[name], split["serving"]["launches"][name])
                for name in SPLIT_KERNELS]
    # the fast rows: launches on the fast tier's serving main-path run
    kernels += [entry(name, "fast", *SOURCES[name], fast["serving"]["launches"][name])
                for name in FAST_KERNELS]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "cases": rows, "serving": serving, "strict": strict,
                       "training": training, "eval": evaluation,
                       "split": {k: v for k, v in split.items() if k != "rows"},
                       "fast": {k: v for k, v in fast.items() if k != "rows"},
                       "dist": dist, "spatial": spatial, "spatial_train": spatial_train,
                       "kernels": kernels}, f, indent=1)
    log(smi)  # the card's name and power limit, as nvidia-smi gives them
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
