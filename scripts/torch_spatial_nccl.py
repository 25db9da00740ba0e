#!/usr/bin/env python3
"""Spatial sharding of the eval forward over NCCL, one rank a card, on every
card of one host (``mesh: {spatial: N}``, savsr_tpu_torch/parallel/spatial.py).

    python3 scripts/torch_spatial_nccl.py [--hw 180 320] [--scale 4 4]
        [--tiers strict bf16 split fast] [--reps 5] [--out FILE]

First the one-process forward of one seeded window of the flagship (golden
weights) on cuda:0 in each tier, then the same under torch.distributed.run
on N = torch.cuda.device_count() ranks over NCCL (rank r on cuda:r), band 0
gathering the output. Each tier's sharded output is held against the
one-process one (strict within 1e-5 max abs, the other tiers equal to the
bit, as chip_smoke.py phase 13 holds them over gloo), and each forward is
timed by the host clock around synchronised calls (median of --reps, after
one warm-up), on every rank and for the one process: N cards on one frame
beside one card on it. Exits non-zero on any failure; prints one JSON line
of the results last. ``--backend gloo --device cpu --small`` rehearses it on
the CPU (the small config, N = --ranks processes).
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from savsr_tpu_torch.inference import build_serving_model  # noqa: E402
from savsr_tpu_torch.utils.convert import load_into  # noqa: E402

TOL = cs.SPATIAL_TOL

# one rank: the tiers' sharded forwards on this rank's card, timed; band 0
# writes the gathered outputs
WORKER = r'''
import json, os, sys, time
import numpy as np
import torch
import torch.distributed as dist
from savsr_tpu_torch.inference import build_serving_model
from savsr_tpu_torch.parallel import get_mesh_from_opt
from savsr_tpu_torch.parallel.spatial import gather_rows
from savsr_tpu_torch.utils.convert import load_into

work, backend, device_type = sys.argv[1], sys.argv[2], sys.argv[3]
net, scale, tiers, reps = (json.loads(a) for a in sys.argv[4:8])
scale = tuple(scale)
local = int(os.environ["LOCAL_RANK"])
device = torch.device(f"cuda:{local}" if device_type == "cuda" else "cpu")
if device.type == "cuda":
    torch.cuda.set_device(device)
dist.init_process_group(backend)
world = dist.get_world_size()
mesh = get_mesh_from_opt({"dist": True, "mesh": {"spatial": world}})
bands = mesh.bands
sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
sd = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(work, "weights.npz")).items()}
x = torch.from_numpy(np.load(os.path.join(work, "x.npy"))).to(device)
out, info = {}, {"band": mesh.band, "device": str(device), "tiers": {}}
for tier in tiers:
    dt = torch.bfloat16 if tier == "bf16" else torch.float32
    model = build_serving_model(tier, net)
    load_into(model, sd)
    model.to(device=device, dtype=dt)
    statics = model.stau_statics(x.shape[-2:], scale, dtype=dt, device=device, band=bands)
    y = gather_rows(model(x.to(dt), scale, stau_statics=statics, band=bands), bands,
                    statics["band"]["hr"])
    if y is not None:
        out[tier] = y.float().cpu().numpy()
    times = []
    for _ in range(reps):
        before = dict(bands.stats)
        sync()
        t0 = time.perf_counter()
        model(x.to(dt), scale, stau_statics=statics, band=bands)
        sync()
        times.append(1e3 * (time.perf_counter() - t0))
    info["tiers"][tier] = {"ms": times, "rows": statics["band"]["lr"][mesh.band],
                           "exchanges": bands.stats["exchanges"] - before["exchanges"],
                           "bytes": bands.stats["bytes"] - before["bytes"]}
    del model
np.savez(os.path.join(work, f"rank{mesh.rank}.npz"), **out)
with open(os.path.join(work, f"rank{mesh.rank}.json"), "w") as f:
    json.dump(info, f)
dist.destroy_process_group()
'''


def one_process(sd, net, x, scale, tiers, reps, device):
    """Each tier's one-process output and its forward's host-clock times."""
    out, times = {}, {}
    xt = torch.from_numpy(x).to(device)
    for tier in tiers:
        dt = torch.bfloat16 if tier == "bf16" else torch.float32
        model = build_serving_model(tier, net)
        load_into(model, {k: torch.from_numpy(v) for k, v in sd.items()})
        model.to(device=device, dtype=dt)
        statics = model.stau_statics(x.shape[-2:], scale, dtype=dt, device=device)
        out[tier] = model(xt.to(dt), scale, stau_statics=statics).float().cpu().numpy()
        times[tier] = []
        for _ in range(reps):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            model(xt.to(dt), scale, stau_statics=statics)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            times[tier].append(1e3 * (time.perf_counter() - t0))
        del model
    return out, times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--hw", type=int, nargs=2, default=list(cs.LR_HW))
    ap.add_argument("--scale", type=float, nargs=2, default=list(cs.SCALE))
    ap.add_argument("--tiers", nargs="+", default=list(cs.SPATIAL_TIERS))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--backend", default="nccl")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=None, help="default: the card count")
    ap.add_argument("--small", action="store_true", help="the small config (rehearsal)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("torch_spatial_nccl: no CUDA device", file=sys.stderr)
        return 2
    ranks = args.ranks or torch.cuda.device_count()
    card = cs.card_name()
    print(card, flush=True)
    if args.small:
        net = cs.SMALL_CFG
        sd = dict(np.load(os.path.join(cs.GOLDENS, "savsr_small_state.npz")))
    else:
        net = cs.flagship_net_kwargs()
        sd = dict(np.load(os.path.join(cs.GOLDENS, "savsr_state_dict.npz")))
    hw, scale = tuple(args.hw), tuple(args.scale)
    x = cs.spatial_window(hw)
    one, one_ms = one_process(sd, net, x, scale, args.tiers, args.reps, device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(os.path.join(tmp, "weights.npz"), **sd)
        np.save(os.path.join(tmp, "x.npy"), x)
        with open(os.path.join(tmp, "worker.py"), "w") as f:
            f.write(WORKER)
        t0 = time.perf_counter()
        cs.torchrun(ranks, [os.path.join(tmp, "worker.py"), tmp, args.backend, device.type,
                            json.dumps(net), json.dumps(scale), json.dumps(args.tiers),
                            str(args.reps)], tmp, timeout=900)
        wall = time.perf_counter() - t0
        infos = []
        for r in range(ranks):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                infos.append(json.load(f))
        got = dict(np.load(os.path.join(tmp, "rank0.npz")))
    res, failed = {"card": card, "ranks": ranks, "backend": args.backend, "hw": hw,
                   "scale": scale, "tiers": {}}, []
    for tier in args.tiers:
        err = float(np.abs(got[tier] - one[tier]).max())
        rank_ms = [float(np.median(i["tiers"][tier]["ms"])) for i in infos]
        med_one = float(np.median(one_ms[tier]))
        res["tiers"][tier] = {"max_abs": err, "one_process_ms": one_ms[tier],
                              "rank_ms": [i["tiers"][tier]["ms"] for i in infos],
                              "rows": [i["tiers"][tier]["rows"] for i in infos],
                              "exchanges": [i["tiers"][tier]["exchanges"] for i in infos],
                              "bytes": [i["tiers"][tier]["bytes"] for i in infos]}
        print(f"[spatial-nccl] {tier} {hw[0]}x{hw[1]} x{scale[0]}x{scale[1]}, {ranks} ranks over "
              f"{args.backend} ({card}): max abs {err:.3e} from one process (bound {TOL[tier]:.0e})"
              f"; forward ms, median of {args.reps} (host clock, synchronised): ranks "
              f"{[round(m, 2) for m in rank_ms]}, one process {med_one:.2f} "
              f"({med_one / max(rank_ms):.2f}x); band rows {res['tiers'][tier]['rows']}; "
              f"exchanges / bytes sent a rank "
              f"{list(zip(res['tiers'][tier]['exchanges'], res['tiers'][tier]['bytes']))}",
              flush=True)
        if not err <= TOL[tier]:
            failed.append((tier, err))
    print(f"[spatial-nccl] the ranks' run {wall:.1f} s with start-up", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps({"ok": not failed, "failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
