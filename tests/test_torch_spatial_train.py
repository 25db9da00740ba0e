"""Spatially sharded training of the port (``mesh: {data: D, spatial: S}``
with a ``train:`` block, ``savsr_tpu_torch/parallel/spatial.py`` and the
band path of ``archs/train_engine.py``) on the CPU, at the small config
with the kernels' plain versions.

Two launches under ``torch.distributed.run`` over gloo, ``{spatial: 2}``
on 2 ranks and ``{data: 2, spatial: 2}`` on 4, and the port's one-process
run, all started at once; the JAX package's step compiles meanwhile. The LR
frame is 17x12 (padded to 18: bands of 8 and 10 rows, the last owning the
reflected row) at x(1.5, 2.5), Charbonnier loss, strict f32, accum 1 and 2
(the global batch's rows 0-3, and rows 0-7 as two micro-batches of 4).

A sharded step must be the JAX package's step on the global batch: the
same loss, BatchNorm statistics and gradients. It is held against the JAX
package's replicated step (``SAVSR.apply(train=True,
osconv_impl="pallas_train")``, its Pallas kernels in the interpret mode the
package picks off a TPU, as tests/test_torch_dist.py runs it) and against
the port's one-process step: loss and every BatchNorm statistic within
1e-6, the whole gradient within 2e-6 relative L2 (tests/test_torch_dist.py's
bounds), and every gradient within 1e-4 of its own max plus 1e-6 of the
largest gradient (0.06 here), inside the JAX package's own bound for a
sharded step (tests/test_spatial_sharding.py: every gradient within 1e-4).

Measured (batch seed 14): from one process, loss <= 3.0e-8, BatchNorm
<= 3.0e-8, the whole gradient 8.6e-8 - 1.5e-7 relative L2; from the JAX
package, loss <= 1.0e-7, BatchNorm <= 1.2e-7, the whole gradient 2.2e-7
(accum 1) and 1.46e-6 (accum 2: the one-process port's own distance,
1.45e-6). Per gradient the worst sits at 0.20 of its bound:
p2f_win.blocks.1.osconv.scale_routing.0.bias, whose gradient (max < 4e-5)
is what cancels in front of a batch-statistics BatchNorm; it sits 6.6x
outside tests/test_torch_dist.py's per-gradient bound (1e-5 of its max,
floor 2e-9), which the data-parallel step meets, hence the bound above. In
float64 (a plain per-sample conv for the OSConv and float64 sums) the
sharded step equals one process's to 1.6e-16 relative L2, loss 0: the
distances are f32 sum orders.

Every rank of a world holds identical gradients and statistics. Remat
(``remat_train: true``, whose recomputation re-issues the segments'
exchanges inside the backward) equals the same mesh's step without it to
the bit. The other modes on ``{spatial: 2}`` against the port's
one-process step in the same mode, the loss within a tenth of the mode's
distance from the strict step (measured 3.0e-8 of 1.1e-5 at default, of
1.4e-4 in bf16) and the whole gradient: f32 at ``matmul_precision:
default`` within a tenth of the mode's distance from strict (2.4e-4 of
8.0e-3 relative L2); the bf16 step through ``functional_call`` within the
one-process bf16 step's own spread under another conv sum order (2.8e-3;
with oneDNN's convs one process moves 6.4e-3, and the mode sits 1.0e-2
from strict, so a tenth of that is below the bf16 step's floor).

oneDNN is off on both sides, as in tests/test_torch_spatial.py: with it
on, CPU ``F.conv2d`` blocks its sums by the frame's height, so a band's
conv rounds apart from the whole frame's; off, the distances above come
from the sharding's own sum orders (the GAPs' and BatchNorms' sums over the
bands, the weight gradients' sums split by band) and nothing else.

The data: the network's gradient has kinks (a ReLU whose input sits within
rounding distance of 0 flips with the sum order, and moves a gradient by
up to ~1e-2 of its max); the batch's seed is one where three relative 1e-6
moves of the input move no gradient by more than 1e-4 of its max, and the
one-process run checks it (seed 5 had a kink; so had seed 9's second
micro-batch, which one draw missed and the sharded step found, hence three
draws). On ``{data: 2,
spatial: 2}`` the ranks of a data group draw the same items, crops, flips
and scales through the trainer's loader and the two groups draw apart;
with four loader threads a rank (whose order of the per-item draws varies)
both bands of a group train on band 0's batch to the bit
(``share_group_batch``); the trainer's CLI trains two iterations on that
mesh and only rank 0 writes.
The geometry: the HR rows of each band's loss count every ``gt`` row once,
the STAU window from a training head's offsets holds every tap, and a thin
band raises from the trainer's path.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(REPO, "tests", "goldens")
SMALL_CFG = dict(num_in_ch=3, num_feat=16, num_frame=7, slid_win=3, fusion_win=5,
                 interval=0, w1_num_block=2, w2_num_block=1, n_resgroups=1, n_resblocks=2)
LR_HW, SCALE = (17, 12), (1.5, 2.5)
HR_HW = (26, 30)
MESHES = {"s2": {"spatial": 2}, "d2s2": {"data": 2, "spatial": 2}}
WORLDS = {"s2": 2, "d2s2": 4}
# the global batch's rows of the accum-1 and accum-2 steps
ROWS = {1: 4, 2: 8}
# the steps each run takes: (name, accum, config)
STEPS = {
    # bf161_dnn: the bf16 step again with oneDNN's convs (another sum order)
    "one": [("strict1", 1, "strict"), ("strict2", 2, "strict"), ("default1", 1, "default"),
            ("bf161", 1, "bf16"), ("bf161_dnn", 1, "bf16")],
    "s2": [("strict1", 1, "strict"), ("strict2", 2, "strict"), ("remat1", 1, "remat"),
           ("default1", 1, "default"), ("bf161", 1, "bf16")],
    "d2s2": [("strict1", 1, "strict"), ("strict2", 2, "strict")],
}
MODES = {"strict": {}, "remat": {"remat_train": "true"},
         "default": {"matmul_precision": "default"}, "bf16": {}}

WORKER = r'''
import json, os, sys
import numpy as np
import torch

torch.set_num_threads(1)
torch.backends.mkldnn.enabled = False
work, tag = sys.argv[1], sys.argv[2]
steps, rows = json.loads(sys.argv[3]), json.loads(sys.argv[4])
scale = tuple(json.loads(sys.argv[5]))
dist = "RANK" in os.environ
launch = ["--launcher", "pytorch"] if dist else []
name = f"{tag}_rank{os.environ['RANK']}" if dist else tag

from savsr_tpu_torch.models import build_model
from savsr_tpu_torch.parallel import shard_or_replicate_batch
from savsr_tpu_torch.utils.dist_util import destroy_dist
from savsr_tpu_torch.utils.logger import get_root_logger
from savsr_tpu_torch.utils.options import parse_options

batch = dict(np.load(os.path.join(work, "batch.npz")))
out, info = {}, {"stats": {}}
for step, accum, cfg in steps:
    mesh = "" if tag == "one" else f"_{tag}"
    opt, _ = parse_options(work, True, ["-opt", os.path.join(work, f"{cfg}{accum}{mesh}.yml"),
                                        "--device", "cpu"] + launch)
    model = build_model(opt)
    n = rows[str(accum)]
    share = shard_or_replicate_batch({"lq": batch["lq"][:n], "gt": batch["gt"][:n]},
                                     model.mesh, accum)
    model.feed_data(dict(share, scale=scale))
    bands = model.mesh.bands
    before = dict(bands.stats) if bands is not None else {}
    torch.backends.mkldnn.enabled = step.endswith("_dnn")
    model.optimize_parameters(1)
    torch.backends.mkldnn.enabled = False
    if bands is not None:
        info["stats"][step] = {k: bands.stats[k] - before[k] for k in before}
        info["axes"], info["band"] = model.mesh.shape, model.mesh.band
        info["data_index"] = model.mesh.data_index
    out[f"{step}/loss"] = np.float64(model.log_dict["l_pix"])
    out.update({f"{step}/g/{k}": p.grad.numpy() for k, p in model.net_g.named_parameters()})
    out.update({f"{step}/b/{k}": b.numpy() for k, b in model.net_g.named_buffers()})
if tag == "one":
    # the data's conditioning: each micro-batch's step, and again with its
    # input * (1 + 1e-6 noise), three draws
    noise = np.random.default_rng(5)
    for key in ("c0", "p0a", "p0b", "p0c", "c1", "p1a", "p1b", "p1c"):
        m = int(key[1])
        lq = batch["lq"][4 * m:4 * (m + 1)]
        if key[0] == "p":
            lq = (lq * (1 + 1e-6 * noise.standard_normal(lq.shape))).astype(np.float32)
        opt, _ = parse_options(work, True, ["-opt", os.path.join(work, "strict1.yml"),
                                            "--device", "cpu"])
        model = build_model(opt)
        model.feed_data({"lq": lq, "gt": batch["gt"][4 * m:4 * (m + 1)], "scale": scale})
        model.optimize_parameters(1)
        out.update({f"{key}/g/{k}": p.grad.numpy() for k, p in model.net_g.named_parameters()})
if tag == "d2s2":
    # the trainer's loader on the mesh: two batches' items, crops and scales
    from savsr_tpu_torch.train import create_train_val_dataloader
    opt, _ = parse_options(work, True, ["-opt", os.path.join(work, "cli.yml"), "--device", "cpu",
                                        "--launcher", "pytorch"])
    loader = create_train_val_dataloader(opt, get_root_logger())[0]
    loader.set_epoch(0)
    it = iter(loader)
    for i in range(2):
        b = next(it)
        out[f"data/{i}/gt"], out[f"data/{i}/lq"] = b["gt"], b["lq"]
        info[f"data/{i}"] = {"keys": list(b["key"]), "scale": list(b["scale"])}
    # four loader threads a rank: the step trains each band on band 0's batch
    opt, _ = parse_options(work, True, ["-opt", os.path.join(work, "cli4.yml"), "--device",
                                        "cpu", "--launcher", "pytorch"])
    loader = create_train_val_dataloader(opt, get_root_logger())[0]
    loader.set_epoch(0)
    it = iter(loader)
    for i in range(3):
        model.feed_data(next(it))
        model.share_group_batch()
        out[f"shared/{i}/lq"], out[f"shared/{i}/gt"] = model.lq.numpy(), model.gt.numpy()
        info[f"shared/{i}"] = list(model.scale)
    # the CLI on the mesh: two iterations, one checkpoint
    from savsr_tpu_torch.train import train_pipeline
    model = train_pipeline(work, ["-opt", os.path.join(work, "cli.yml"), "--device", "cpu",
                                  "--launcher", "pytorch"])
    info["cli_loss"] = float(model.log_dict["l_pix"])
if tag in ("one", "s2"):
    # the strict accum-1 step in float64, the model called directly: the
    # OSConv as a plain per-sample conv (its wrappers take f32 and bf16)
    # and the band GAP's and BatchNorms' sums in float64, so that what is
    # left of a distance is the sharding's math
    import torch.nn.functional as F
    import savsr_tpu_torch.archs.arch_util as au
    import savsr_tpu_torch.archs.train_engine as te
    from savsr_tpu_torch.archs.savsr_arch import SAVSR
    from savsr_tpu_torch.parallel import all_reduce_sum, get_mesh_from_opt, reduce_gradients
    from savsr_tpu_torch.parallel.spatial import band_row_sums_train, frame_hr_rows

    te.osconv_agg_train = lambda x, agg, padding=1: torch.cat(
        [F.conv2d(x[i:i + 1], agg[i].permute(3, 2, 0, 1), padding=padding)
         for i in range(x.shape[0])])
    au._global_mean = lambda t, dims, n, group: au._WorldSum.apply(
        t.sum(dim=dims), group) / n

    def gap(ctx, parts):
        if ctx.band is None:
            return au.adaptive_avg_pool_11(te._cat(parts))
        full = band_row_sums_train(torch.cat([p.sum(dim=3) for p in parts], 1), ctx.band)
        return full.sum(dim=2) / (full.shape[2] * parts[0].shape[3])

    te.gap = gap
    suffix = "" if tag == "one" else f"_{tag}"
    opt, _ = parse_options(work, True, ["-opt", os.path.join(work, f"strict1{suffix}.yml"),
                                        "--device", "cpu"] + launch)
    grid = get_mesh_from_opt(opt)
    net = SAVSR(**{k: v for k, v in opt["network_g"].items() if k != "type"})
    net.load_state_dict(torch.load(os.path.join(work, "small.pth"))["params"])
    net.double()
    lq = torch.from_numpy(batch["lq"][:4]).double().permute(0, 1, 4, 2, 3)
    gt = torch.from_numpy(batch["gt"][:4]).double().permute(0, 3, 1, 2)
    y, _ = net(lq, scale, train=True, bn_group=grid.group, band=grid.bands)
    loss = torch.sqrt((y - gt) ** 2 + 1e-12).mean() if grid.bands is None else None
    if grid.bands is not None:
        y0, y1 = frame_hr_rows(lq.shape[-2], gt.shape[-2], 2)[grid.band]
        loss = (torch.sqrt((y - gt[:, :, y0:y1]) ** 2 + 1e-12).mean()
                * ((y1 - y0) / gt.shape[-2]))
    loss.backward()
    reduce_gradients(net.parameters(), grid)
    out["f64/loss"] = all_reduce_sum(loss.detach().clone(), grid).numpy()
    out.update({f"f64/g/{k}": p.grad.numpy() for k, p in net.named_parameters()})
np.savez(os.path.join(work, f"{name}.npz"), **out)
with open(os.path.join(work, f"{name}.json"), "w") as f:
    json.dump(info, f)
if dist:
    destroy_dist()
'''


def _state():
    return dict(np.load(os.path.join(GOLDEN_DIR, "savsr_small_state.npz")))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _mesh_block(tag) -> str:
    if tag is None:
        return ""
    return "mesh:\n" + "".join(f"  {k}: {v}\n" for k, v in MESHES[tag].items())


def _net_yml(mode: str) -> str:
    net = dict(SMALL_CFG, **{"remat_train": "false", **MODES[mode]})
    return "network_g:\n  type: SAVSR\n" + "".join(f"  {k}: {v}\n" for k, v in net.items())


def _train_yml(work, mode: str, accum: int, tag=None) -> str:
    return f"""
name: spatial_step_{mode}{accum}_{tag}
model_type: ASVSRModel
num_gpu: auto
manual_seed: 0
{_mesh_block(tag)}{_net_yml(mode)}
path:
  pretrain_network_g: {work}/small.pth
  strict_load_g: true
  resume_state: ~
  experiments_root: {work}/experiments
train:
  ema_decay: 0.999
  bf16: {"true" if mode == "bf16" else "false"}
  accum_steps: {accum}
  optim_g:
    type: Adam
    lr: !!float 1e-4
    weight_decay: 0
    betas: [0.9, 0.999]
  scheduler:
    type: CosineAnnealingRestartLR
    periods: [100]
    restart_weights: [1]
    eta_min: !!float 1e-7
  total_iter: 1
  warmup_iter: -1
  pixel_opt:
    type: CharbonnierLoss
    loss_weight: 1.0
    reduction: mean
"""


def _cli_yml(work) -> str:
    """The trainer's config on {data: 2, spatial: 2}: seeded septuplets,
    16-row LR crops (two bands of 8), batch 2 a data group, 2 iterations."""
    return f"""
name: spatial_cli
model_type: ASVSRModel
num_gpu: auto
manual_seed: 3
{_mesh_block("d2s2")}datasets:
  train:
    name: tiny
    type: ASVimeo90KDataset
    dataroot_gt: {work}/sequences
    dataroot_lq: {work}/sequences
    meta_info_file: {work}/meta.txt
    io_backend:
      type: disk
    num_frame: 7
    lq_size: 16
    max_scale: 4
    downsample_mode: torch
    random_reverse: true
    use_hflip: true
    use_rot: true
    num_worker_per_gpu: 0
    batch_size_per_gpu: 2
    dataset_enlarge_ratio: 2
{_net_yml("strict")}
path:
  pretrain_network_g: {work}/small.pth
  strict_load_g: true
  resume_state: ~
  experiments_root: {work}/experiments
train:
  ema_decay: 0.999
  optim_g:
    type: Adam
    lr: !!float 1e-4
    weight_decay: 0
    betas: [0.9, 0.999]
  scheduler:
    type: CosineAnnealingRestartLR
    periods: [100]
    restart_weights: [1]
    eta_min: !!float 1e-7
  total_iter: 2
  warmup_iter: -1
  pixel_opt:
    type: CharbonnierLoss
    loss_weight: 1.0
    reduction: mean
logger:
  print_freq: 1
  save_checkpoint_freq: 2
  use_tb_logger: false
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The global batch, the small config's golden weights as a checkpoint,
    the step configs of each mesh and mode, and 8 seeded septuplets of
    68x68 for the trainer's loader."""
    import cv2

    work = tmp_path_factory.mktemp("spatial_train")
    torch.save({"params": {k: torch.from_numpy(v) for k, v in _state().items()}},
               work / "small.pth")
    rng = np.random.default_rng(14)
    batch = {"lq": rng.random((ROWS[2], 7) + LR_HW + (3,), dtype=np.float32),
             "gt": rng.random((ROWS[2],) + HR_HW + (3,), dtype=np.float32)}
    np.savez(work / "batch.npz", **batch)
    for tag in [None] + list(MESHES):
        for _, accum, mode in STEPS[tag or "one"]:
            suffix = "" if tag is None else f"_{tag}"
            (work / f"{mode}{accum}{suffix}.yml").write_text(_train_yml(work, mode, accum, tag))
    (work / "cli.yml").write_text(_cli_yml(work))
    (work / "cli4.yml").write_text(_cli_yml(work).replace("num_worker_per_gpu: 0",
                                                          "num_worker_per_gpu: 4"))
    keys = [f"00001/{i:04d}" for i in range(1, 9)]
    for k, key in enumerate(keys):
        d = work / "sequences" / key
        d.mkdir(parents=True)
        img = (rng.random((68, 68, 3)) * 255).astype(np.uint8)
        for i in range(1, 8):
            cv2.imwrite(str(d / f"im{i}.png"), np.roll(img, i, axis=0))
    (work / "meta.txt").write_text("".join(f"{k} 7 (68,68,3)\n" for k in keys))
    return work, batch


@pytest.fixture(scope="module")
def launches(world):
    """Both launches and the one-process run, started at once; the test
    process computes the JAX package's step meanwhile."""
    work, _ = world
    (work / "worker.py").write_text(WORKER)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    args = [json.dumps({str(k): v for k, v in ROWS.items()}), json.dumps(SCALE)]
    procs = {"one": subprocess.Popen(
        [sys.executable, str(work / "worker.py"), str(work), "one", json.dumps(STEPS["one"])]
        + args, env=env, cwd=str(work), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)}
    for tag in MESHES:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
               str(WORLDS[tag]), "--master_addr", "127.0.0.1", "--master_port",
               str(_free_port()), str(work / "worker.py"), str(work), tag,
               json.dumps(STEPS[tag])] + args
        procs[tag] = subprocess.Popen(cmd, env=env, cwd=str(work), stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    return procs


@pytest.fixture(scope="module")
def jax_steps(world, launches):
    """The JAX package's replicated step on each global batch: loss,
    gradients and BatchNorm statistics after the step, micro-batches
    chained as its scan does (one compile for both). The accum-1 step is
    the accum-2 step's first micro-step."""
    import jax
    import jax.numpy as jnp

    from savsr_tpu.archs.savsr_arch import SAVSR as JaxSAVSR
    from savsr_tpu.models.base_model import split_params
    from savsr_tpu.utils.convert import convert_state_dict

    _, batch = world
    params = {k: jnp.asarray(v) for k, v in convert_state_dict(_state()).items()}
    trainable, stats = split_params(params)
    jm = JaxSAVSR(**SMALL_CFG, osconv_impl="pallas_train", remat_train=False)

    def loss_fn(tr, st, lq, gt):
        out, ups = jm.apply({**tr, **st}, lq, SCALE, train=True)
        return jnp.sqrt((out - gt) ** 2 + 1e-12).mean(), ups

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    micro, st = [], stats
    for m in range(2):
        rows = slice(m * ROWS[1], (m + 1) * ROWS[1])
        (loss, ups), g = step(trainable, st, jnp.asarray(batch["lq"][rows]),
                              jnp.asarray(batch["gt"][rows]))
        st = {**st, **ups}
        micro.append((float(loss), {k: np.asarray(v) for k, v in g.items()},
                      {k: np.asarray(v) for k, v in st.items()}))
    (l0, g0, s0), (l1, g1, s1) = micro
    return {1: (l0, g0, s0), 2: ((l0 + l1) / 2, {k: (g0[k] + g1[k]) / 2 for k in g0}, s1)}


@pytest.fixture(scope="module")
def runs(world, launches, jax_steps):
    """{tag: [(npz, json) for each rank]} once every run has ended."""
    work, _ = world
    for tag, p in launches.items():
        try:
            out, _ = p.communicate(timeout=300)
        finally:
            if p.returncode != 0:  # a timeout or a failed run: stop them all
                for q in launches.values():
                    q.kill()
        assert p.returncode == 0, out[-4000:]
    got = {"one": [(dict(np.load(work / "one.npz")), json.loads((work / "one.json").read_text()))]}
    for tag in MESHES:
        got[tag] = [(dict(np.load(work / f"{tag}_rank{r}.npz")),
                     json.loads((work / f"{tag}_rank{r}.json").read_text()))
                    for r in range(WORLDS[tag])]
    return got


def _rel_l2(a, b) -> float:
    num = sum(float(((a[k] - v).astype(np.float64) ** 2).sum()) for k, v in b.items())
    return (num / sum(float((v.astype(np.float64) ** 2).sum()) for v in b.values())) ** 0.5


def _step(out, step):
    return (float(out[f"{step}/loss"]),
            {k[len(f"{step}/g/"):]: v for k, v in out.items() if k.startswith(f"{step}/g/")},
            {k[len(f"{step}/b/"):]: v for k, v in out.items() if k.startswith(f"{step}/b/")})


def _held(loss, grads, buffers, ref_loss, ref_grads, ref_buffers, label):
    """Loss and every BatchNorm statistic within 1e-6, the whole gradient
    within 2e-6 relative L2, every gradient within 1e-4 of its own max plus
    1e-6 of the largest gradient; prints the distances, the worst gradient's
    against its bound."""
    assert set(grads) == set(ref_grads) and set(buffers) == set(ref_buffers)
    d_bn = max(float(np.abs(buffers[k].astype(np.float64) - v).max())
               for k, v in ref_buffers.items())
    largest = max(float(np.abs(v).max()) for v in ref_grads.values())

    def bound(v):
        return 1e-4 * float(np.abs(v).max()) + 1e-6 * largest

    worst = max((float(np.abs(grads[k] - v).max()) / bound(v), k) for k, v in ref_grads.items())
    print(f"{label}: loss |d| {abs(loss - ref_loss):.2e}, BatchNorm |d| {d_bn:.2e}, "
          f"relative L2 {_rel_l2(grads, ref_grads):.2e}, worst gradient {worst[0]:.3f} of its "
          f"bound at {worst[1]} (largest gradient {largest:.3e})")
    assert abs(loss - ref_loss) <= 1e-6
    assert d_bn <= 1e-6
    assert _rel_l2(grads, ref_grads) <= 2e-6
    for k, v in ref_grads.items():
        assert np.abs(grads[k] - v).max() <= bound(v), k


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("tag", list(MESHES))
def test_sharded_step_matches_jax_global_batch(runs, jax_steps, tag, accum):
    """The sharded strict step against the JAX package's replicated step
    on the global batch (the module docstring's bounds)."""
    from savsr_tpu_torch.utils.convert import params_to_jax

    loss, grads, buffers = _step(runs[tag][0][0], f"strict{accum}")
    j_loss, j_grads, j_stats = jax_steps[accum]
    ours_b = params_to_jax({k: torch.from_numpy(v) for k, v in buffers.items()})
    ours_g = params_to_jax({k: torch.from_numpy(v) for k, v in grads.items()})
    _held(loss, ours_g, ours_b, j_loss, j_grads, j_stats, f"{tag} accum {accum} vs JAX")


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("tag", list(MESHES))
def test_sharded_step_matches_one_process_port(runs, tag, accum):
    """The sharded strict step against the port's one-process step on the
    same global batch (the same bounds)."""
    step = f"strict{accum}"
    _held(*_step(runs[tag][0][0], step), *_step(runs["one"][0][0], step),
          f"{tag} accum {accum} vs one process")


@pytest.mark.parametrize("tag", list(MESHES))
def test_every_rank_holds_the_same_step(runs, tag):
    """Every rank of the world holds identical gradients, statistics and
    logged loss after every step; each rank sits at its mesh place and
    exchanged rows in every step."""
    ranks = runs[tag]
    out0 = ranks[0][0]
    for r, (out, info) in enumerate(ranks):
        assert info["axes"] == {"data": MESHES[tag].get("data", 1), "spatial": 2}
        assert (info["band"], info["data_index"]) == (r % 2, r // 2)
        assert all(s["exchanges"] > 0 and s["bytes"] > 0 for s in info["stats"].values())
        for k, v in out0.items():
            if not k.startswith(("data/", "shared/")):
                assert np.array_equal(out[k], v), (r, k)


def test_float64_sharded_step_is_exact(runs):
    """In float64 (a plain per-sample conv for the OSConv, the band GAP's
    and BatchNorms' sums in float64) the {spatial: 2} step equals one
    process's to rounding: the loss within 1e-14, the whole gradient
    within 1e-12 relative L2 (measured 0 and 1.5e-16), so the f32
    distances above are sum orders and nothing in the sharding's math."""
    one, sharded = runs["one"][0][0], runs["s2"][0][0]
    loss, grads, _ = _step(sharded, "f64")
    ref_loss, ref_grads, _ = _step(one, "f64")
    d = _rel_l2(grads, ref_grads)
    print(f"float64: loss |d| {abs(loss - ref_loss):.2e}, relative L2 {d:.2e}")
    assert grads[next(iter(grads))].dtype == np.float64
    assert abs(loss - ref_loss) <= 1e-14 and d <= 1e-12


def test_remat_equals_no_remat_to_the_bit(runs):
    """``remat_train: true`` on {spatial: 2} at accum 1 (its recomputation
    issues the segments' exchanges again inside the backward) gives the
    step without remat to the bit."""
    out = runs["s2"][0][0]
    loss, grads, buffers = _step(out, "strict1")
    r_loss, r_grads, r_buffers = _step(out, "remat1")
    assert r_loss == loss
    for k, v in grads.items():
        assert np.array_equal(r_grads[k], v), k
    for k, v in buffers.items():
        assert np.array_equal(r_buffers[k], v), k
    stats = runs["s2"][0][1]["stats"]
    assert stats["remat1"]["exchanges"] > stats["strict1"]["exchanges"]


@pytest.mark.parametrize("mode", ["default", "bf16"])
def test_other_modes_match_one_process(runs, mode):
    """f32 at matmul_precision default, and the bf16 step, on {spatial: 2}
    against the port's one-process step in the same mode: the loss within
    a tenth of the mode's own distance from the strict step; the whole
    gradient (relative L2) within a tenth of the mode's distance from the
    strict step at default; in bf16 within the one-process bf16 step's own
    spread, its distance from itself with oneDNN's convs (another sum
    order): every bf16 weight gradient is rounded once a band, and that
    floor (measured 6.4e-3) lies above a tenth of the mode's distance from
    strict (1.0e-2), so no sharding of the bf16 step meets the tenth."""
    step = f"{mode}1"
    one = runs["one"][0][0]
    loss, grads, _ = _step(runs["s2"][0][0], step)
    ref_loss, ref_grads, _ = _step(one, step)
    s_loss, s_grads, _ = _step(one, "strict1")
    d, own = _rel_l2(grads, ref_grads), _rel_l2(ref_grads, s_grads)
    spread = _rel_l2(_step(one, "bf161_dnn")[1], ref_grads) if mode == "bf16" else None
    print(f"{mode}: sharded vs one process {d:.3e} relative L2, loss |d| "
          f"{abs(loss - ref_loss):.2e}; the mode vs strict {own:.3e}, loss |d| "
          f"{abs(ref_loss - s_loss):.2e}" + ("" if spread is None else
                                            f"; one process with oneDNN {spread:.3e}"))
    assert own > 0 and d <= (0.1 * own if spread is None else spread)
    assert abs(loss - ref_loss) <= 0.1 * abs(ref_loss - s_loss)


def test_the_data_is_far_from_a_kink(runs):
    """The premise of the bounds: each micro-batch's one-process gradients
    move by at most 1e-4 of their max (floor 1e-9) when its input moves by
    a relative 1e-6, so the sharded sum order cannot flip a ReLU."""
    out = runs["one"][0][0]

    def grads(key):
        return {k[len(key) + 3:]: v for k, v in out.items() if k.startswith(f"{key}/g/")}

    for m in range(2):
        ref = grads(f"c{m}")
        for draw in "abc":
            moved = grads(f"p{m}{draw}")
            assert ref and set(ref) == set(moved)
            for k, v in ref.items():
                assert np.abs(moved[k] - v).max() <= max(1e-4 * np.abs(v).max(), 1e-9), (m, k)


def test_data_groups_draw_apart_and_bands_alike(runs):
    """Through the trainer's loader on {data: 2, spatial: 2}: the two bands
    of a data group draw the same items, crops, flips and scale; the two
    groups draw different items and share the scale."""
    ranks = runs["d2s2"]
    for i in range(2):
        for g in range(2):
            (a, ia), (b, ib) = ranks[2 * g], ranks[2 * g + 1]
            assert ia[f"data/{i}"] == ib[f"data/{i}"]
            assert np.array_equal(a[f"data/{i}/gt"], b[f"data/{i}/gt"])
            assert np.array_equal(a[f"data/{i}/lq"], b[f"data/{i}/lq"])
        g0, g1 = ranks[0][1][f"data/{i}"], ranks[2][1][f"data/{i}"]
        assert g0["scale"] == g1["scale"]
        assert g0["keys"] != g1["keys"]
        assert not np.array_equal(ranks[0][0][f"data/{i}/gt"], ranks[2][0][f"data/{i}/gt"])


def test_bands_train_on_one_batch_with_loader_threads(runs):
    """With four loader threads a rank (``num_worker_per_gpu: 4``, as the
    shipped recipe runs), whose order of the datasets' per-item draws
    varies from rank to rank, the step's batch (``share_group_batch``) on
    {data: 2, spatial: 2} is band 0's on both bands of a data group, to the
    bit (lq, gt and scale), and the two groups' batches differ."""
    ranks = runs["d2s2"]
    for i in range(3):
        for g in range(2):
            (a, ia), (b, ib) = ranks[2 * g], ranks[2 * g + 1]
            assert ia[f"shared/{i}"] == ib[f"shared/{i}"]
            assert np.array_equal(a[f"shared/{i}/lq"], b[f"shared/{i}/lq"])
            assert np.array_equal(a[f"shared/{i}/gt"], b[f"shared/{i}/gt"])
        assert not np.array_equal(ranks[0][0][f"shared/{i}/gt"], ranks[2][0][f"shared/{i}/gt"])


def test_cli_trains_on_a_spatial_mesh(world, runs):
    """``train_pipeline`` (the CLI's body, ``--launcher pytorch``) on
    {data: 2, spatial: 2}: two iterations, a finite loss on every rank, one
    checkpoint written by rank 0 only."""
    work, _ = world
    losses = [info["cli_loss"] for _, info in runs["d2s2"]]
    assert all(np.isfinite(losses)) and len(set(losses)) == 1
    exp = work / "experiments" / "spatial_cli"
    assert sorted(os.listdir(exp / "models")) == ["net_g_2.npz", "net_g_latest.npz"]
    assert sorted(os.listdir(exp / "training_states")) == ["2.state"]


@pytest.mark.parametrize("h,scale", [(17, (4.0, 4.0)), (17, (1.5, 2.5)), (33, (3.05, 3.05)),
                                     (60, (4.0, 4.0))])
@pytest.mark.parametrize("count", [2, 3])
def test_loss_rows_count_every_gt_row_once(h, scale, count):
    """The HR rows that each band's loss scores (``frame_hr_rows``) tile
    the output in order, and with ``reduction: mean`` the bands' shares of
    the frame's rows add up to 1. A band's STAU produces its rows with one
    more on each side (clipped), for the tail (``sampler_rows``)."""
    from savsr_tpu_torch.archs.savsr_arch import get_hw
    from savsr_tpu_torch.parallel import spatial

    if (h + h % 2) // count < spatial.MASK_REACH:
        with pytest.raises(ValueError, match="thinner than the widest halo"):
            spatial.frame_hr_rows(h, get_hw(h, h, scale)[0], count)
        return
    H = get_hw(h, h, scale)[0]
    rows = spatial.frame_hr_rows(h, H, count)
    assert rows[0][0] == 0 and rows[-1][1] == H
    assert all(b == c for (_, b), (c, _) in zip(rows, rows[1:]))
    assert all(b > a for a, b in rows)
    assert abs(sum((b - a) / H for a, b in rows) - 1.0) < 1e-12
    ext = spatial.sampler_rows(rows, H)
    assert ext == [(max(a - 1, 0), min(b + 1, H)) for a, b in rows]


@pytest.mark.parametrize("scale", [(1.5, 2.5), (4.0, 4.0), (3.05, 3.05)])
def test_stau_window_from_a_training_head(scale):
    """The window of LR rows computed from a training head's offsets
    (``stau_windows``, on trained-looking offsets: the golden head's,
    doubled and with noise added) holds every tap that the sampler
    (``F.grid_sample`` on the grid the engine builds) takes inside the
    frame from each band's HR rows, one row beyond them included."""
    import torch.nn.functional as F

    from savsr_tpu_torch.archs.savsr_arch import SAVSR, _stau_head
    from savsr_tpu_torch.archs.train_engine import _stau_grid, stau_windows
    from savsr_tpu_torch.parallel import spatial

    model = SAVSR(**SMALL_CFG)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in _state().items()})
    h, w = 33, 20
    with torch.no_grad():
        head = _stau_head(model.upsample, h, w, scale, torch.float32, torch.device("cpu"))
        g = torch.Generator().manual_seed(1)
        for k in ("offset", "st_offset"):
            head[k] = 2 * head[k] + torch.randn(head[k].shape, generator=g)
    H = head["offset"].shape[2]
    ext = spatial.sampler_rows(spatial.frame_hr_rows(h, H, 2), H)
    windows = stau_windows(head, scale, h, w, ext, torch.float32)
    frame = torch.empty((1, 1, h, w))
    for k in ("offset", "st_offset"):
        grid = _stau_grid(frame, head[k], scale)
        for (e0, e1), (l0, l1) in zip(ext, windows):
            # ones on the frame's rows outside the window: any tap there
            # with a nonzero weight shows
            outside = torch.ones(1, 1, h, w)
            outside[:, :, l0:l1] = 0
            taken = F.grid_sample(outside, grid[:, e0:e1], mode="bilinear",
                                  padding_mode="zeros", align_corners=True)
            assert float(taken.abs().max()) == 0.0, (k, e0, e1, l0, l1)
        assert 0 <= l0 < l1 <= h


def test_thin_band_raises_from_the_trainer():
    """The training forward on two bands of a 14-row frame (6 and 8 rows,
    thinner than the mask head's reach) raises ValueError naming the cause
    before it exchanges anything."""
    from savsr_tpu_torch.archs.savsr_arch import SAVSR
    from savsr_tpu_torch.parallel import BandGroup

    model = SAVSR(**SMALL_CFG)
    x = torch.rand(1, 7, 3, 14, 12)
    with pytest.raises(ValueError, match="thinner than the widest halo"):
        model(x, (2.0, 2.0), train=True, band=BandGroup(0, 2, (0, 1)))
