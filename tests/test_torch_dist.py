"""The port's distributed training and eval (``--launcher pytorch``: one
process per GPU, ``savsr_tpu_torch/parallel``) on the CPU, two gloo ranks
at the small config in strict f32.

A world of W ranks must compute the JAX package's step on the global batch
(the ranks' rows in the one-process global order): the loss is the mean
over it, the BatchNorm statistics are its statistics, and with accum_steps
micro-batch m is global rows [m*B/a, (m+1)*B/a). The two-rank step is held
against the JAX package's one-process step on that batch
(``SAVSR.apply(train=True, osconv_impl="pallas_train")``, its Pallas
kernels in the interpret mode the package picks off a TPU) and against the
port's one-process step: loss and BatchNorm updates within 1e-6 (the bounds
of tests/test_torch_train_forward.py), the whole gradient within 2e-6
relative L2, and every gradient within 1e-5 of its own max, floor 2e-9.

The bounds, measured (seed 5): the whole gradient sits 6.3e-7-7.7e-7 from
either reference. Per gradient, 1e-6 of the max is below the f32 noise of
the same sums taken in another order: tail.bias, a sum over every output
pixel, moves 9.4e-7 of its max between the one-process and two-rank port,
and the one-process port sits 1.04e-5 of a routing bias's max from the JAX
package, so 1e-5 it is (two ranks: at most 0.63 of it). The floor is for
the gradients at the level of cancellation noise (the routing biases in
front of a batch-statistics BatchNorm, and the smallest ones, where 1e-5 of
the max is a few ulps of it): measured up to 1.25e-9.

The data: the network's gradient has kinks (a ReLU whose input sits within
rounding distance of 0 flips with the sum order, and moves a gradient by
up to ~1e-2 of its max); at such a point no two sum orders agree to these
bounds, whichever package computes them. The batch's seed is one where a
1e-6 relative change of the input moves no gradient by more than ~2e-5 of
its max (seeds 0-4 and 17 had kinks; on seed 17 the one-process port sat
3e-3 from the JAX package), and the one-process run checks that it holds.

The sampler's shares reassemble the one-process order, the ranks crop apart
and share a step's scale, a two-rank eval equals a one-rank eval to the
bit, only rank 0 writes checkpoints and logs, and what is not ported raises.
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
WORLD = 2
# the global batch of 8 rows: the accum-1 step takes rows 0-3, the accum-2
# step all 8 (micro-batches 0-3 and 4-7), so the JAX package computes two
# micro-steps of 4 rows (one compile) for both, and every rank holds 2 rows
# of every micro-batch
ROWS = {1: 4, 2: 8}

WORKER = r'''
import json, os, sys
import numpy as np
import torch

torch.set_num_threads(1)
work = sys.argv[1]
# a rank of the world under torchrun's environment, or the one-process run
tag = f"rank{os.environ['RANK']}" if "RANK" in os.environ else "one"
launch = ["--launcher", "pytorch"] if tag != "one" else []
writes = {"npz": 0, "state": 0}
_savez, _save = np.savez, torch.save


def savez(*a, **k):
    writes["npz"] += 1
    return _savez(*a, **k)


def save(*a, **k):
    writes["state"] += 1
    return _save(*a, **k)


np.savez, torch.save = savez, save

from savsr_tpu_torch.models import build_model
from savsr_tpu_torch.parallel import shard_or_replicate_batch
from savsr_tpu_torch.test import test_pipeline
from savsr_tpu_torch.utils.dist_util import destroy_dist
from savsr_tpu_torch.utils.logger import get_root_logger
from savsr_tpu_torch.utils.options import parse_options

# the eval first: its pipeline sets up the logger (rank 0's with the log file)
results = test_pipeline(work, ["-opt", os.path.join(work, f"eval_{tag}.yml"), "--device", "cpu"]
                        + launch)
batch = dict(np.load(os.path.join(work, "batch.npz")))
out = {}
for accum, rows in ((1, 4), (2, 8)):
    opt, _ = parse_options(work, True, ["-opt", os.path.join(work, f"train{accum}.yml"),
                                        "--device", "cpu"] + launch)
    model = build_model(opt)
    share = shard_or_replicate_batch({"lq": batch["lq"][:rows], "gt": batch["gt"][:rows]},
                                     model.mesh, accum)
    model.feed_data(dict(share, scale=(2.0, 2.0)))
    model.optimize_parameters(1)
    out[f"{accum}/loss"] = np.float64(model.log_dict["l_pix"])
    out.update({f"{accum}/g/{k}": p.grad.numpy() for k, p in model.net_g.named_parameters()})
    out.update({f"{accum}/b/{k}": b.numpy() for k, b in model.net_g.named_buffers()})
    if accum == 1 and tag != "one":
        model.save(0, 1)
if tag == "one":
    # the data's conditioning: each micro-batch's step, and again with its
    # input * (1 + 1e-6 noise)
    noise = np.random.default_rng(5)
    for key in ("c0", "p0", "c1", "p1"):
        m = int(key[1])
        lq = batch["lq"][4 * m:4 * (m + 1)]
        if key[0] == "p":
            lq = (lq * (1 + 1e-6 * noise.standard_normal(lq.shape))).astype(np.float32)
        opt, _ = parse_options(work, True, ["-opt", os.path.join(work, "train1.yml"),
                                            "--device", "cpu"])
        model = build_model(opt)
        model.feed_data({"lq": lq, "gt": batch["gt"][4 * m:4 * (m + 1)], "scale": (2.0, 2.0)})
        model.optimize_parameters(1)
        out.update({f"{key}/g/{k}": p.grad.numpy() for k, p in model.net_g.named_parameters()})
_savez(os.path.join(work, f"{tag}.npz"), **out)
with open(os.path.join(work, f"{tag}.json"), "w") as f:
    json.dump({"world": opt["world_size"], "results": results, "writes": writes,
               "log_level": get_root_logger().level}, f)
destroy_dist()
'''


def _state():
    return dict(np.load(os.path.join(GOLDEN_DIR, "savsr_small_state.npz")))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _net_yml() -> str:
    return "network_g:\n  type: SAVSR\n" + "".join(f"  {k}: {v}\n" for k, v in SMALL_CFG.items())


def _train_yml(work, accum: int) -> str:
    return f"""
name: dist_step_{accum}
model_type: ASVSRModel
num_gpu: auto
manual_seed: 0
{_net_yml()}
path:
  pretrain_network_g: {work}/small.pth
  strict_load_g: true
  resume_state: ~
  experiments_root: {work}/experiments
train:
  ema_decay: 0.999
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


def _eval_yml(work, name: str) -> str:
    return f"""
name: {name}
model_type: ASVSRModel
num_gpu: 1
manual_seed: 0
datasets:
  test_01:
    name: Vid4_x2
    type: ASVideoTestDataset
    dataroot_gt: {work}/GT
    dataroot_lq: {work}/GT
    io_backend:
      type: disk
    cache_data: false
    num_frame: 7
    padding: reflection
    use_arbitrary_scale_downsampling: true
    downsampling_scale: !!python/tuple [2.0, 2.0]
    downsampling_mode: torch
{_net_yml()}
path:
  pretrain_network_g: {work}/small.pth
  strict_load_g: true
  resume_state: ~
  results_root: {work}/results
val:
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
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The steps' global batches, the small config's golden weights as a
    checkpoint, the configs, and two 4-frame eval clips of 28x36."""
    import cv2

    work = tmp_path_factory.mktemp("dist")
    torch.save({"params": {k: torch.from_numpy(v) for k, v in _state().items()}},
               work / "small.pth")
    rng = np.random.default_rng(5)
    batch = {"lq": rng.random((ROWS[2], 7, 12, 12, 3), dtype=np.float32),
             "gt": rng.random((ROWS[2], 24, 24, 3), dtype=np.float32)}
    np.savez(work / "batch.npz", **batch)
    for accum in ROWS:
        (work / f"train{accum}.yml").write_text(_train_yml(work, accum))
        (work / "experiments" / f"dist_step_{accum}" / "models").mkdir(parents=True)
        (work / "experiments" / f"dist_step_{accum}" / "training_states").mkdir()
    for tag in ("rank0", "rank1"):
        (work / f"eval_{tag}.yml").write_text(_eval_yml(work, "dist_eval"))
    (work / "eval_one.yml").write_text(_eval_yml(work, "one_eval"))
    for clip in ("calendar", "city"):
        d = work / "GT" / clip
        d.mkdir(parents=True)
        img = (rng.random((28, 36, 3)) * 255).astype(np.uint8)
        for i in range(4):
            cv2.imwrite(str(d / f"{i:08d}.png"), np.roll(img, 2 * i, axis=1))
    return work, batch


@pytest.fixture(scope="module")
def runs(world):
    """Three processes through the port's own entry points: two gloo ranks
    under torchrun's environment and the one-process run, each taking the
    step at accum 1 and 2 (each rank on its share of the global batch, the
    one-process run on all of it), the ranks a checkpoint save, and the eval
    pipeline. Started first; the JAX package's steps run meanwhile."""
    work, _ = world
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    world_env = dict(env, WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(_free_port()))
    (work / "worker.py").write_text(WORKER)
    envs = {f"rank{r}": dict(world_env, RANK=str(r), LOCAL_RANK=str(r)) for r in range(WORLD)}
    envs["one"] = env
    return work, {tag: subprocess.Popen([sys.executable, str(work / "worker.py"), str(work)],
                                        env=e, cwd=str(work), stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
                  for tag, e in envs.items()}


@pytest.fixture(scope="module")
def results(runs, jax_steps):
    """{tag: (the worker's npz, its json)} once every worker has ended."""
    work, procs = runs
    for p in procs.values():
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            raise
        assert p.returncode == 0, out[-4000:]
    return {tag: (dict(np.load(work / f"{tag}.npz")), json.loads((work / f"{tag}.json").read_text()))
            for tag in procs}


@pytest.fixture(scope="module")
def jax_steps(world, runs):
    """The JAX package's step on each global batch: loss, gradients and
    BatchNorm statistics after the step, micro-batches chained as its
    scan does (gradients and losses averaged, statistics carried). The
    accum-1 step is the accum-2 step's first micro-step."""
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
        out, ups = jm.apply({**tr, **st}, lq, (2.0, 2.0), train=True)
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


def _rel_l2(a, b) -> float:
    num = sum(float(((a[k] - v).astype(np.float64) ** 2).sum()) for k, v in b.items())
    return (num / sum(float((v.astype(np.float64) ** 2).sum()) for v in b.values())) ** 0.5


def _step(out, accum):
    return (float(out[f"{accum}/loss"]),
            {k[len(f"{accum}/g/"):]: v for k, v in out.items() if k.startswith(f"{accum}/g/")},
            {k[len(f"{accum}/b/"):]: v for k, v in out.items() if k.startswith(f"{accum}/b/")})


@pytest.mark.parametrize("accum", [1, 2])
def test_two_rank_step_matches_jax_global_batch(results, jax_steps, accum):
    """Loss <= 1e-6, every BatchNorm running statistic after the step <=
    1e-6, the whole gradient <= 2e-6 relative L2 and every gradient <= 1e-5
    of its own max (floor 2e-9) of the JAX package's step on the global
    batch; both ranks hold the same gradients and statistics."""
    from savsr_tpu_torch.utils.convert import params_to_jax

    (out0, info0), (out1, info1) = results["rank0"], results["rank1"]
    assert info0["world"] == info1["world"] == WORLD and results["one"][1]["world"] == 1
    for k in out0:
        assert np.array_equal(out0[k], out1[k]), k
    loss, grads, buffers = _step(out0, accum)
    j_loss, j_grads, j_stats = jax_steps[accum]
    assert abs(loss - j_loss) <= 1e-6
    ours = params_to_jax({k: torch.from_numpy(v) for k, v in buffers.items()})
    assert set(ours) == set(j_stats)
    for k, v in j_stats.items():
        assert np.abs(ours[k].astype(np.float64) - v).max() <= 1e-6, k
    ours = params_to_jax({k: torch.from_numpy(v) for k, v in grads.items()})
    assert set(ours) == set(j_grads)
    assert _rel_l2(ours, j_grads) <= 2e-6
    for k, v in j_grads.items():
        assert np.abs(ours[k] - v).max() <= max(1e-5 * np.abs(v).max(), 2e-9), k


def test_the_data_is_far_from_a_kink(results):
    """The premise of the bounds above: each micro-batch's one-process
    gradients move by at most 1e-4 of their max (floor 1e-9) when its input
    moves by a relative 1e-6 (measured ~2e-5), so the distributed sum order
    cannot flip a ReLU."""
    out = results["one"][0]

    def grads(key):
        return {k[len(key) + 3:]: v for k, v in out.items() if k.startswith(f"{key}/g/")}

    for m in range(2):
        ref, moved = grads(f"c{m}"), grads(f"p{m}")
        assert ref and set(ref) == set(moved)
        for k, v in ref.items():
            assert np.abs(moved[k] - v).max() <= max(1e-4 * np.abs(v).max(), 1e-9), (m, k)


@pytest.mark.parametrize("accum", [1, 2])
def test_two_rank_step_matches_one_process_port(results, accum):
    """The two-rank step against the port's one-process step on the same
    global batch: loss and BatchNorm statistics <= 1e-6, the whole gradient
    <= 2e-6 relative L2, every gradient <= 1e-5 of its own max (floor
    2e-9)."""
    loss, grads, buffers = _step(results["rank0"][0], accum)
    ref_loss, ref_grads, ref_buffers = _step(results["one"][0], accum)
    assert abs(loss - ref_loss) <= 1e-6
    for k, v in ref_buffers.items():
        assert np.abs(buffers[k].astype(np.float64) - v).max() <= 1e-6, k
    assert _rel_l2(grads, ref_grads) <= 2e-6
    for k, v in ref_grads.items():
        assert np.abs(grads[k] - v).max() <= max(1e-5 * np.abs(v).max(), 2e-9), k


def test_two_rank_eval_equals_one_rank_and_rank0_writes(world, results):
    """A two-rank eval (items strided over the ranks, metric rows summed)
    equals the one-process eval to the bit; only rank 0 wrote the
    checkpoint (one .npz and one .state a save) and the eval log, and rank
    1 logs errors only."""
    work, _ = world
    infos = {tag: info for tag, (_, info) in results.items()}
    one = infos["one"]["results"]
    assert set(one["Vid4_x2"]) == {"psnr_y", "ssim_y"}
    assert infos["rank0"]["results"] == infos["rank1"]["results"] == one
    assert infos["rank0"]["writes"] == {"npz": 1, "state": 1}
    assert infos["rank1"]["writes"] == {"npz": 0, "state": 0}
    exp = work / "experiments" / "dist_step_1"
    assert sorted(os.listdir(exp / "models")) == ["net_g_1.npz"]
    assert sorted(os.listdir(exp / "training_states")) == ["1.state"]
    logs = [f for f in os.listdir(work / "results" / "dist_eval") if f.endswith(".log")]
    assert len(logs) == 1
    assert infos["rank0"]["log_level"] == 20 and infos["rank1"]["log_level"] == 40


@pytest.mark.parametrize("accum", [1, 2])
def test_sampler_shares_reassemble_the_global_order(accum):
    """Pure index check: with batch_size_per_gpu b, the two ranks' shares
    of each step, micro-batch by micro-batch and rank by rank, are the
    one-process order's global batch of 2b, and a rank's m-th chunk is its
    share of micro-batch m."""
    from savsr_tpu_torch.data.loader import EnlargedSampler

    b, n, ratio = 4, 21, 2
    one = list(EnlargedSampler(n, 1, 0, ratio, batch_size=WORLD * b, accum_steps=accum))
    shares = [list(EnlargedSampler(n, WORLD, r, ratio, batch_size=b, accum_steps=accum))
              for r in range(WORLD)]
    steps = len(shares[0]) // b
    assert steps == n * ratio // (WORLD * b) and all(len(s) == steps * b for s in shares)
    micro = b // accum
    for k in range(steps):
        rebuilt = [i for m in range(accum) for s in shares
                   for i in s[k * b + m * micro:k * b + (m + 1) * micro]]
        assert rebuilt == one[k * WORLD * b:(k + 1) * WORLD * b]


def test_ranks_crop_apart_and_share_the_scale(tmp_path):
    """The arbitrary-scale training set on two ranks, every sequence the
    same frames: their first batches differ in their crops (each rank its
    own stream of per-item draws) and share their scale, and rank 0 draws
    the scale sequence of a one-process loader."""
    import cv2

    from savsr_tpu_torch.data import EnlargedSampler, build_dataloader, build_dataset

    # every sequence the same frames: batches differ only by their draws
    img = (np.random.default_rng(0).random((52, 52, 3)) * 255).astype(np.uint8)
    keys = [f"00001/{i:04d}" for i in range(1, 5)]
    for key in keys:
        d = tmp_path / "sequences" / key
        d.mkdir(parents=True)
        for i in range(1, 8):
            cv2.imwrite(str(d / f"im{i}.png"), np.roll(img, i, axis=0))
    (tmp_path / "meta.txt").write_text("".join(f"{k} 7 (52,52,3)\n" for k in keys))
    opt = dict(name="tiny", type="ASVimeo90KDataset", phase="train",
               dataroot_gt=str(tmp_path / "sequences"), dataroot_lq=str(tmp_path / "sequences"),
               meta_info_file=str(tmp_path / "meta.txt"), io_backend=dict(type="disk"),
               num_frame=7, lq_size=12, max_scale=4, downsample_mode="torch",
               random_reverse=True, use_hflip=True, use_rot=True, num_worker_per_gpu=0,
               batch_size_per_gpu=1)

    def batches(world, rank, steps=3):
        ds = build_dataset(opt, seed=5, rank=rank)
        loader = build_dataloader(ds, opt, seed=5, sampler=EnlargedSampler(
            len(ds), world, rank, 2, batch_size=1))
        it = iter(loader)
        return [next(it) for _ in range(steps)]

    r0, r1, one = batches(WORLD, 0), batches(WORLD, 1), batches(1, 0)
    assert [b["scale"] for b in r0] == [b["scale"] for b in r1] == [b["scale"] for b in one]
    assert len({b["scale"] for b in r0}) > 1
    assert r0[0]["gt"].shape == r1[0]["gt"].shape
    assert not np.array_equal(r0[0]["gt"], r1[0]["gt"])


def test_spatial_mesh_axes_and_what_raises(tmp_path, monkeypatch):
    """``mesh: {data: 1, spatial: 2}`` on a world of 2 builds a mesh of
    those axes (rank 1: data index 0, band 1 of a band group of ranks 0 and
    1); a trainer on that mesh builds, its mesh holding the band group
    and the data group;
    ``--launcher pytorch`` outside torchrun raises naming its environment
    (it never runs as a world of one); ``num_gpu: 2`` without a launcher
    names the torchrun command; a mesh other than the world size raises."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from savsr_tpu_torch.models import build_model
    from savsr_tpu_torch.parallel import get_mesh_from_opt
    from savsr_tpu_torch.utils.options import parse_options

    torch.save({"params": {k: torch.from_numpy(v) for k, v in _state().items()}},
               tmp_path / "small.pth")
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(_train_yml(tmp_path, 1) + "mesh:\n  data: 1\n  spatial: 2\n")
    # rank 1 of a world of 2 (a process group that communicates nothing)
    dist.init_process_group("fake", rank=1, world_size=2, store=FakeStore())
    try:
        mesh = get_mesh_from_opt({"dist": True, "mesh": {"data": 1, "spatial": 2}})
        assert mesh.shape == {"data": 1, "spatial": 2} and mesh.size == 1
        assert (mesh.rank, mesh.data_index, mesh.band) == (1, 0, 1)
        assert (mesh.bands.index, mesh.bands.count, mesh.bands.ranks) == (1, 2, (0, 1))
        filled = get_mesh_from_opt({"dist": True, "mesh": {"data": 1, "spatial": -1}})
        assert filled.shape == mesh.shape
        opt, _ = parse_options(str(tmp_path), True, ["-opt", str(cfg), "--launcher", "pytorch",
                                                     "--device", "cpu"])
        model = build_model(opt)
        assert model.is_train and model.mesh.shape == {"data": 1, "spatial": 2}
        assert model.mesh.bands.group is not None and model.mesh.data_group is not None
        assert (model.mesh.bands.index, model.mesh.bands.data) == (1, 1)
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="world size"):
        get_mesh_from_opt({"mesh": {"data": 2}})
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    cfg.write_text(_train_yml(tmp_path, 1))
    with pytest.raises(RuntimeError, match="RANK.*torch.distributed.run"):
        parse_options(str(tmp_path), True, ["-opt", str(cfg), "--launcher", "pytorch",
                                            "--device", "cpu"])
    cfg.write_text(_train_yml(tmp_path, 1).replace("num_gpu: auto", "num_gpu: 2"))
    with pytest.raises(ValueError, match="torch.distributed.run"):
        parse_options(str(tmp_path), True, ["-opt", str(cfg), "--device", "cpu"])
