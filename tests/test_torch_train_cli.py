"""The port's training CLI (python -m savsr_tpu_torch.train) driven through a
YAML config as a user would, on the CPU: the tiny YAML of
tests/test_cli_pipelines.py (tiny net, 52x52 synthetic septuplets), resume,
the options the port refuses, and the dataset + collate against the JAX
package's on the same files with the same injected crop and scale.
"""

import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tiny_world(tmp_path_factory):
    """Vimeo-style training septuplets: two 52x52 sequences and a meta file."""
    import cv2

    root = tmp_path_factory.mktemp("world")
    rng = np.random.default_rng(0)
    keys = ["00001/0001", "00001/0002"]
    for key in keys:
        d = root / "vimeo" / "sequences" / key
        d.mkdir(parents=True)
        img = (rng.random((52, 52, 3)) * 255).astype(np.uint8)
        for i in range(1, 8):
            cv2.imwrite(str(d / f"im{i}.png"), np.roll(img, i, axis=0))
    (root / "meta.txt").write_text("".join(f"{k} 7 (52,52,3)\n" for k in keys))
    return root


def _yml(tiny_world, tmp_path, total_iter=2, extra_train="", extra_top="", net_extra=""):
    return f"""
name: train_tiny_cli
model_type: ASVSRModel
num_gpu: 1
manual_seed: 7

datasets:
  train:
    name: Vimeo90K_tiny
    type: ASVimeo90KDataset
    dataroot_gt: {tiny_world}/vimeo/sequences
    dataroot_lq: {tiny_world}/vimeo/sequences
    meta_info_file: {tiny_world}/meta.txt
    io_backend:
      type: disk
    num_frame: 7
    lq_size: 12
    max_scale: 4
    downsample_mode: torch
    init_int_scale: false
    single_scale_ft: true
    random_reverse: false
    use_hflip: true
    use_rot: true
    num_worker_per_gpu: 0
    batch_size_per_gpu: 1
    dataset_enlarge_ratio: 1

network_g:
  type: SAVSR
  num_in_ch: 3
  num_feat: 16
  num_frame: 7
  slid_win: 3
  fusion_win: 5
  interval: 0
  w1_num_block: 2
  w2_num_block: 1
  n_resgroups: 1
  n_resblocks: 2
  center_frame_idx: ~
{net_extra}
path:
  pretrain_network_g: ~
  strict_load_g: true
  resume_state: ~
  experiments_root: {tmp_path}/experiments

scale: !!python/tuple [2, 2]
{extra_top}
train:
  ema_decay: 0.999
{extra_train}
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
  total_iter: {total_iter}
  warmup_iter: -1
  pixel_opt:
    type: CharbonnierLoss
    loss_weight: 1.0
    reduction: mean

logger:
  print_freq: 1
  save_checkpoint_freq: 2
  use_tb_logger: false
  wandb:
    project: ~
    resume_id: ~
"""


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-m", "savsr_tpu_torch.train", *args], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=600)


def test_train_cli_two_iterations_then_auto_resume(tiny_world, tmp_path):
    cfg = tmp_path / "train_cfg.yml"
    cfg.write_text(_yml(tiny_world, tmp_path))
    r = _run(["-opt", str(cfg), "--device", "cpu"], tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    exp = tmp_path / "experiments" / "train_tiny_cli"
    assert (exp / "models" / "net_g_2.npz").is_file()
    assert (exp / "models" / "net_g_latest.npz").is_file()
    assert (exp / "training_states" / "2.state").is_file()
    copied = exp / "train_cfg.yml"
    assert copied.is_file() and copied.read_text().startswith("# GENERATE TIME")
    assert "l_pix" in r.stderr and "iter:       2" in r.stderr
    assert "one OSConv training engine" in r.stderr

    # the checkpoint has the JAX package's key scheme and layout
    with np.load(exp / "models" / "net_g_2.npz") as ck:
        assert any(k.startswith("params/") for k in ck.files)
        assert any(k.startswith("params_ema/") for k in ck.files)
        assert ck["params/f2p_win.conv_c.weight"].shape == (3, 3, 3, 16)  # HWIO
        assert np.isfinite(ck["params/tail.weight"]).all()

    # --auto_resume picks up 2.state and continues to total_iter=4
    cfg4 = tmp_path / "train_cfg4.yml"
    cfg4.write_text(_yml(tiny_world, tmp_path, total_iter=4))
    r = _run(["-opt", str(cfg4), "--auto_resume", "--device", "cpu"], tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Resuming training from epoch" in r.stderr
    assert (exp / "models" / "net_g_4.npz").is_file()
    assert (exp / "training_states" / "4.state").is_file()
    state = torch.load(exp / "training_states" / "4.state", weights_only=True)
    assert state["iter"] == 4
    assert state["optimizers"][0]["state"][0]["step"] == 4  # Adam continued from step 2


UNPORTED = [
    # validation runs; its bucketed eval is not ported
    ("val", dict(extra_top="val:\n  val_freq: 2\n  save_img: false\n  bucket_eval: true\n")),
    ("bucket_train", dict(extra_train="  bucket_train: true")),
    ("degrade_on_device", dict(extra_train="  degrade_on_device: true")),
    ("perceptual_opt", dict(extra_train="  perceptual_opt:\n    type: PerceptualLoss")),
]


@pytest.mark.parametrize("key,kw", UNPORTED, ids=[u[0] for u in UNPORTED])
def test_unported_options_raise_by_name(tiny_world, tmp_path, key, kw):
    """What the port leaves for later raises NotImplementedError naming the
    option; nothing is silently skipped."""
    from savsr_tpu_torch.train import train_pipeline

    cfg = tmp_path / "cfg.yml"
    cfg.write_text(_yml(tiny_world, tmp_path, **kw))
    with pytest.raises(NotImplementedError, match=key):
        train_pipeline(str(tmp_path), ["-opt", str(cfg), "--device", "cpu"])


@pytest.mark.parametrize("impl", ["einsum", "grouped", "batchgroup", "taps", "kpatch3",
                                  "pallas", "pallas_train"])
def test_every_osconv_impl_is_accepted(impl):
    """The YAML key osconv_impl takes every value the JAX package accepts
    (one math, one engine here); an unknown one raises."""
    from savsr_tpu_torch.archs import build_network

    net = build_network(dict(type="SAVSR", num_feat=16, w1_num_block=1, w2_num_block=1,
                             n_resgroups=1, n_resblocks=1, osconv_impl=impl,
                             train_loop="scan"))
    assert net.cfg.osconv_impl == impl
    with pytest.raises(ValueError, match="osconv impl"):
        build_network(dict(type="SAVSR", num_feat=16, osconv_impl="nope"))


def test_train_without_a_card_raises(tiny_world, tmp_path):
    from savsr_tpu_torch.train import train_pipeline

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(_yml(tiny_world, tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        train_pipeline(str(tmp_path), ["-opt", str(cfg)])


def test_dataset_and_collate_match_jax_package(tiny_world):
    """Same files, same seed of the crop/flip/scale draws (the JAX package
    draws from the global ``random``, the port from its own generator seeded
    alike): samples are identical, the collated GT is identical and the
    collated LR equals the JAX package's ``arbitrary_scale_downsample`` of
    it to 1e-6 (its f32 resampler against the port's f64 matmuls)."""
    from savsr_tpu.data.data_util import arbitrary_scale_downsample as jax_downsample
    from savsr_tpu.data.vimeo90k_dataset import ASVimeo90KDataset as JDataset
    from savsr_tpu_torch.data import build_dataloader, build_dataset

    opt = dict(name="tiny", type="ASVimeo90KDataset", phase="train",
               dataroot_gt=f"{tiny_world}/vimeo/sequences",
               dataroot_lq=f"{tiny_world}/vimeo/sequences",
               meta_info_file=f"{tiny_world}/meta.txt", io_backend=dict(type="disk"),
               num_frame=7, lq_size=12, max_scale=4, downsample_mode="torch",
               init_int_scale=False, single_scale_ft=False, random_reverse=True,
               use_hflip=True, use_rot=True, num_worker_per_gpu=0, batch_size_per_gpu=2,
               scale_h_list=[1.5, 2.0, 3.5], scale_w_list=[2.5, 2.0, 1.5])
    port = build_dataset(opt, seed=11)
    jds = JDataset(dict(opt))
    random.seed(11)
    want = jds.as_collate_fn([jds[0], jds[1]])
    got = port.as_collate_fn([port[0], port[1]])
    assert got["scale"] == want["scale"] and got["key"] == want["key"]
    for k in ("gt", "lq"):
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype == np.float32, k
    assert np.array_equal(got["gt"], want["gt"])
    sh, sw = got["scale"]
    assert got["gt"].shape == (2, round(12 * sh), round(12 * sw), 3)
    assert got["lq"].shape == (2, 7, 12, 12, 3)
    assert np.abs(got["lq"] - want["lq"]).max() <= 1e-6

    # the loader: batches of the right shapes, the scale injected by the
    # collate, reproducible from the seed
    loader = build_dataloader(build_dataset(opt, seed=3), opt, seed=3)
    again = build_dataloader(build_dataset(opt, seed=3), opt, seed=3)
    b1, b2 = next(iter(loader)), next(iter(again))
    assert b1["scale"] == b2["scale"] and np.array_equal(b1["lq"], b2["lq"])
    full = jax_downsample(np.ascontiguousarray(b1["gt"][:, None]), b1["scale"], "torch")
    assert full.shape[2:4] == (12, 12)


def test_paired_dataset_matches_jax_package(tiny_world, tmp_path):
    """The fixed-scale paired Vimeo90KDataset against the JAX package's on
    the same files with the same seed of the crop/flip draws: identical."""
    import cv2

    from savsr_tpu.data.vimeo90k_dataset import Vimeo90KDataset as JDataset
    from savsr_tpu_torch.data import build_dataset

    rng = np.random.default_rng(1)
    for key in ("00001/0001", "00001/0002"):
        d = tmp_path / "lq" / key
        d.mkdir(parents=True)
        for i in range(1, 8):
            cv2.imwrite(str(d / f"im{i}.png"), (rng.random((13, 13, 3)) * 255).astype(np.uint8))
    opt = dict(name="paired", type="Vimeo90KDataset", phase="train", scale=4, gt_size=32,
               dataroot_gt=f"{tiny_world}/vimeo/sequences", dataroot_lq=str(tmp_path / "lq"),
               meta_info_file=f"{tiny_world}/meta.txt", io_backend=dict(type="disk"),
               num_frame=7, random_reverse=True, use_hflip=True, use_rot=True)
    port, jds = build_dataset(opt, seed=5), JDataset(dict(opt))
    random.seed(5)
    for i in (0, 1, 0):
        got, want = port[i], jds[i]
        assert got["key"] == want["key"]
        assert got["lq"].shape == (7, 8, 8, 3) and got["gt"].shape == (32, 32, 3)
        assert np.array_equal(got["lq"], want["lq"]) and np.array_equal(got["gt"], want["gt"])


def test_process_workers_draw_apart_and_reproducibly(tiny_world):
    """worker_mode: process (spawned decode processes, each with its own copy
    of the dataset): batches have the thread mode's shapes, two runs from one
    seed give the same batches, and the processes' draws are reseeded per
    (seed, epoch, process), so the second epoch differs from the first."""
    from savsr_tpu_torch.data import build_dataloader, build_dataset

    opt = dict(name="tiny", type="ASVimeo90KDataset", phase="train",
               dataroot_gt=f"{tiny_world}/vimeo/sequences",
               dataroot_lq=f"{tiny_world}/vimeo/sequences",
               meta_info_file=f"{tiny_world}/meta.txt", io_backend=dict(type="disk"),
               num_frame=7, lq_size=12, max_scale=4, downsample_mode="torch",
               random_reverse=False, use_hflip=True, use_rot=True, num_worker_per_gpu=1,
               batch_size_per_gpu=2, worker_mode="process")

    def epochs():
        loader = build_dataloader(build_dataset(opt, seed=9), opt, seed=9)
        out = []
        for epoch in (0, 1):
            loader.set_epoch(epoch)
            out.append(list(loader))
        return out

    first, again = epochs(), epochs()
    assert len(first[0]) == 1 and first[0][0]["lq"].shape == (2, 7, 12, 12, 3)
    for a, b in zip(first, again):
        assert a[0]["scale"] == b[0]["scale"] and np.array_equal(a[0]["lq"], b[0]["lq"])
    assert (first[0][0]["scale"] != first[1][0]["scale"]
            or not np.array_equal(first[0][0]["gt"], first[1][0]["gt"]))
