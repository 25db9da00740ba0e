#!/usr/bin/env python3
"""Per-call times of the PyTorch port's bf16 OSConv wrappers
(``savsr_tpu_torch.ops.osconv``) at the training path's shapes, for one or
more checkouts of the repo, on one CUDA card.

    python3 scripts/torch_osconv_ab.py [--dtype bf16|f32] [--plans] [--train] [--out FILE]
        ROOT [ROOT ...]

Each ROOT is a checkout of the repo (this one, or a ``git archive`` of
another commit unpacked into a directory). They run one after another, each
in a process of its own that imports that checkout's package and builds its
kernels, so an A/B in one call reads ``A B B A``.

Per checkout and case (8 samples of 60x60, k = 3, padding 1, in ``--dtype``
(bf16, the training path's, or f32, the train-parity tier's, with TF32 off
for the library calls too): the forward and the dx call of ``osconv_agg`` at
192/320/64 <-> 64, and ``osconv_dagg`` at 192/320/64 -> 64):

- ``ms``: back-to-back calls of the wrapper between CUDA events (median of
  5 means of 10 calls), as ``chip_smoke.py`` times every kernel;
- ``graph_ms``: device time per call, from replays of one CUDA graph of 20
  calls (the repack and pitch copies included, no host launch cost);
- ``library_ms`` / ``library_graph_ms``: the same for one PyTorch call that
  computes the same function (``F.conv2d`` grouped by sample,
  ``torch.nn.grad.conv2d_weight``);
- ``rel_err``: max |wrapper - plain version| over max |plain version|,
  held to chip_smoke's tolerances (2e-2 for bf16 outputs, 1e-4 for f32
  outputs and for the weight gradient, which is f32 for both types).

The dx call is timed as the training Function's backward makes it: through
``osconv_agg_dx`` where the checkout has it, else as a flipped,
channel-swapped copy of agg and ``osconv_agg`` on it.

``--plans`` also times the tensor-core weight gradient at three row-chunk
plans (chunks of at least 4, 8 and 12 rows; the package uses
``DAGG_TC_MIN_ROWS``) on checkouts that have it. ``--train`` also runs the
checkout's own ``chip_smoke.phase_training`` (6 steps of the flagship recipe,
then one profiled step), whose ``[train-profile]`` lines give the step's
device time.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

B, H, W, COUT = 8, 60, 60, 64
CINS = (192, 320, 64)


def timed_ms(fn, reps: int = 5, iters: int = 10) -> float:
    import numpy as np
    import torch

    fn()
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def graph_ms(fn, reps: int = 5, iters: int = 20) -> float:
    import numpy as np
    import torch

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


def cases(oc, cin: int, rng, dtype):
    """(label, wrapper call, plain version, library call, tolerance) at cin."""
    import torch
    import torch.nn.functional as F

    def rand(shape, std=1.0):
        return torch.from_numpy((std * rng.standard_normal(shape)).astype("float32")).to(
            "cuda", dtype)

    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4

    x, g = rand((B, cin, H, W)), rand((B, COUT, H, W))
    agg = rand((B, 3, 3, cin, COUT), (cin * 9) ** -0.5)
    agg_t = agg.flip(1, 2).transpose(3, 4).contiguous()
    w_fwd = agg.permute(0, 4, 3, 1, 2).reshape(B * COUT, cin, 3, 3).contiguous()
    w_dx = agg_t.permute(0, 4, 3, 1, 2).reshape(B * cin, COUT, 3, 3).contiguous()
    if hasattr(oc, "osconv_agg_dx"):
        dx = lambda: oc.osconv_agg_dx(g, agg, 1)  # noqa: E731
    else:
        dx = lambda: oc.osconv_agg(g, agg.flip(1, 2).transpose(3, 4).contiguous(), 1)  # noqa: E731
    return [
        (f"osconv_agg fwd {cin}->64", lambda: oc.osconv_agg(x, agg, 1),
         lambda: oc.osconv_agg_plain(x, agg, 1),
         lambda: F.conv2d(x.reshape(1, B * cin, H, W), w_fwd, padding=1, groups=B), tol),
        (f"osconv_agg dx 64->{cin}", dx, lambda: oc.osconv_agg_plain(g, agg_t, 1),
         lambda: F.conv2d(g.reshape(1, B * COUT, H, W), w_dx, padding=1, groups=B), tol),
        (f"osconv_dagg {cin}->64", lambda: oc.osconv_dagg(x, g, 3, 3, 1),
         lambda: oc.osconv_dagg_plain(x, g, 3, 3, 1),
         lambda: torch.nn.grad.conv2d_weight(x.reshape(1, B * cin, H, W), (B * COUT, cin, 3, 3),
                                             g.reshape(1, B * COUT, H, W), padding=1, groups=B),
         1e-4),
    ], (x, g)


def plan_rows(oc, cin: int, x, g, log) -> list:
    """The tensor-core weight gradient at chunks of at least 4, 8 and 12
    rows, launched through the checkout's C entry with each plan."""
    import torch

    from savsr_tpu_torch.ops import check_rc, ptr, stream_ptr
    from savsr_tpu_torch.ops.conv import tma_part

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    base = B * -(-cin // oc.DAGG_TC_TILE) * -(-COUT // oc.DAGG_TC_TILE)

    def plan(min_rows):  # ops/osconv.py dagg_tc_chunks at another minimum
        want = max(1, min(H // min_rows, sms // base))
        rows = -(-H // want)
        return -(-H // rows), rows

    if plan(oc.DAGG_TC_MIN_ROWS) != oc.dagg_tc_chunks(B, cin, COUT, H, sms):
        raise AssertionError("the plan formula here differs from dagg_tc_chunks")
    (xb, xp), (gb, gp) = tma_part(x), tma_part(g)
    want = oc.osconv_dagg(x, g, 3, 3, 1)
    out = []
    for min_rows in (4, oc.DAGG_TC_MIN_ROWS, 12):
        nchunks, rows = plan(min_rows)

        def launch():
            y = torch.empty((B, 9, cin, COUT), dtype=torch.float32, device="cuda")
            scratch = (torch.empty((nchunks,) + tuple(y.shape), dtype=torch.float32,
                                   device="cuda") if nchunks > 1 else None)
            rc = oc._lib().savsr_osconv_dagg_wgmma(
                3, ptr(xb), xb.stride(0), xp, ptr(gb), gb.stride(0), gp, ptr(y), ptr(scratch),
                nchunks, rows, B, cin, H, W, COUT, stream_ptr(x))
            check_rc(oc._lib(), rc, "osconv_dagg")
            return y

        err = float((launch() - want).abs().max() / want.abs().max())
        ms = graph_ms(launch)
        log(f"[plans] osconv_dagg {cin}->64 bf16, chunks of >= {min_rows} rows: {nchunks} "
            f"chunks of {rows} rows, graph {ms:.4f} ms, rel err vs the wrapper {err:.2e}")
        if not err <= 1e-4:
            raise AssertionError(f"plan >= {min_rows} rows disagrees with the wrapper: {err}")
        out.append({"cin": cin, "min_rows": min_rows, "nchunks": nchunks, "rows": rows,
                    "graph_ms": ms, "used": min_rows == oc.DAGG_TC_MIN_ROWS})
    return out


def child(root: str, out_path: str, dtype_name: str, plans: bool, train: bool) -> None:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from savsr_tpu_torch.archs.arch_util import float32_precision
    from savsr_tpu_torch.csrc import build
    from savsr_tpu_torch.ops import osconv as oc

    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype_name]

    if not os.path.abspath(oc.__file__).startswith(root + os.sep):
        raise AssertionError(f"imported {oc.__file__}, not the checkout at {root}")

    def log(msg):
        print(f"[{os.path.basename(root)}] {msg}", flush=True)

    build.build_all()
    rng = np.random.default_rng(0)
    rows, plan_out = [], []
    with torch.no_grad(), float32_precision(True):
        for cin in CINS:
            case_list, (x, g) = cases(oc, cin, rng, dtype)
            for label, fn, plain, library, tol in case_list:
                want = plain().float()
                err = float((fn().float() - want).abs().max() / want.abs().max())
                row = {"case": label, "rel_err": err, "ok": err <= tol,
                       "ms": timed_ms(fn), "graph_ms": graph_ms(fn),
                       "library_ms": timed_ms(library), "library_graph_ms": graph_ms(library)}
                row["dtype"] = dtype_name
                log(f"{label:24s} {dtype_name} rel err {err:.2e} (tol {tol:g}) ms {row['ms']:.4f} "
                    f"graph {row['graph_ms']:.4f}; library ms {row['library_ms']:.4f} "
                    f"graph {row['library_graph_ms']:.4f} {'ok' if row['ok'] else 'FAIL'}")
                rows.append(row)
            if plans and dtype == torch.bfloat16 and hasattr(oc, "dagg_tc_chunks") \
                    and cin in (192, 64):
                plan_out += plan_rows(oc, cin, x, g, log)
    if train:
        import chip_smoke

        chip_smoke.phase_training(torch.device("cuda"))
    with open(out_path, "w") as f:
        json.dump({"root": root, "cases": rows, "plans": plan_out}, f)
    if not all(r["ok"] for r in rows):
        raise AssertionError(f"{root}: a wrapper disagrees with its plain version")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("roots", nargs="+", help="checkouts of the repo, run in this order")
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16",
                    help="the wrappers' input type (default bf16, the training path's)")
    ap.add_argument("--plans", action="store_true",
                    help="also time the tensor-core dagg row-chunk plans (bf16)")
    ap.add_argument("--train", action="store_true",
                    help="also run each checkout's chip_smoke.phase_training")
    ap.add_argument("--out", default=None, help="write every checkout's results here as JSON")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(os.path.abspath(args.roots[0]), args.child, args.dtype, args.plans, args.train)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, root in enumerate(args.roots):
            path = os.path.join(tmp, f"{i}.json")
            root = os.path.abspath(root)
            cmd = [sys.executable, os.path.abspath(__file__), root, "--child", path,
                   "--dtype", args.dtype]
            cmd += ["--plans"] * args.plans + ["--train"] * args.train
            subprocess.run(cmd, check=True, cwd=root)
            with open(path) as f:
                results.append(json.load(f))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "dtype": args.dtype, "runs": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
