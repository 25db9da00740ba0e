"""The port's eval pipeline (python -m savsr_tpu_torch.test) against the JAX
package's (savsr_tpu.test) on the CPU: the same tiny clips, the same JAX
checkpoint of the tiny network (the JAX side on its default XLA engine), at
x2 and x(1.5, 3.5). Per-dataset psnr_y within 0.01 dB and ssim_y within
1e-4, the same saved files, frame 0's float SR within 1e-5, the x8
self-ensemble within 1e-5; the options the port refuses raise by name."""

import os
import sys

import numpy as np
import pytest
import torch

TINY = dict(num_feat=16, w1_num_block=2, w2_num_block=1, n_resgroups=1, n_resblocks=2)
SCALES = {"Vid4_x2": (2.0, 2.0), "Vid4_x1.5_x3.5": (1.5, 3.5)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's small CPU tensors: beside the
    suite's other workers more threads only contend for the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Two 4-frame clips of 36x44 (GT) and their 9x11 LR frames, and a
    checkpoint of the tiny network in the JAX package's layout (.npz,
    params/ keys; seeded weights written as the port's trainer writes them,
    which both packages load)."""
    import cv2

    from savsr_tpu_torch.archs.savsr_arch import SAVSR, init_weights
    from savsr_tpu_torch.utils.convert import params_to_jax

    root = tmp_path_factory.mktemp("eval_world")
    rng = np.random.default_rng(0)
    for clip in ("calendar", "city"):
        d = root / "GT" / clip
        d.mkdir(parents=True)
        (root / "LR" / clip).mkdir(parents=True)
        img = (rng.random((36, 44, 3)) * 255).astype(np.uint8)
        for i in range(4):
            frame = np.roll(img, 2 * i, axis=1)
            cv2.imwrite(str(d / f"{i:08d}.png"), frame)
            cv2.imwrite(str(root / "LR" / clip / f"{i:08d}.png"),
                        cv2.resize(frame, (11, 9), interpolation=cv2.INTER_AREA))
    net = SAVSR(**TINY)
    init_weights(net, 3)
    np.savez(root / "net_g.npz",
             **{f"params/{k}": v for k, v in params_to_jax(net.state_dict()).items()})
    return root


def _yml(root, name="test_tiny_eval", net_extra="", val_extra="", scales=SCALES):
    blocks = "".join(f"""
  test_{i:02d}:
    name: {ds}
    type: ASVideoTestDataset
    dataroot_gt: {root}/GT
    dataroot_lq: {root}/GT
    io_backend:
      type: disk
    cache_data: false
    num_frame: 7
    padding: reflection
    use_arbitrary_scale_downsampling: true
    downsampling_scale: !!python/tuple [{s[0]}, {s[1]}]
    downsampling_mode: torch
""" for i, (ds, s) in enumerate(scales.items(), 1))
    net = "".join(f"  {k}: {v}\n" for k, v in TINY.items())
    return f"""
name: {name}
model_type: ASVSRModel
num_gpu: 1
manual_seed: 0
datasets:{blocks}
network_g:
  type: SAVSR
  num_in_ch: 3
  num_frame: 7
  slid_win: 3
  fusion_win: 5
  interval: 0
  center_frame_idx: ~
{net}{net_extra}
path:
  pretrain_network_g: {root}/net_g.npz
  strict_load_g: true
  resume_state: ~
val:
  save_img: true
  suffix: ~
{val_extra}
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


def _saved(results_root):
    return sorted(os.path.relpath(os.path.join(d, f), results_root)
                  for d, _, files in os.walk(results_root) for f in files if f.endswith(".png"))


@pytest.fixture(scope="module")
def runs(world, tmp_path_factory):
    """Both pipelines once on the same config: (results, saved files)."""
    from savsr_tpu.test import test_pipeline as jax_test_pipeline
    from savsr_tpu_torch.test import test_pipeline

    out = {}
    cfg = world / "eval.yml"
    cfg.write_text(_yml(world))
    for side in ("jax", "port"):
        root = tmp_path_factory.mktemp(side)
        if side == "jax":
            argv, sys.argv = sys.argv, ["test.py", "-opt", str(cfg)]
            try:
                results = jax_test_pipeline(str(root))
            finally:
                sys.argv = argv
        else:
            results = test_pipeline(str(root), ["-opt", str(cfg), "--device", "cpu"])
        out[side] = (results, _saved(root / "results" / "test_tiny_eval"))
    return out


def test_pipeline_metrics_and_files_match_jax(runs):
    (jax_res, jax_files), (res, files) = runs["jax"], runs["port"]
    assert sorted(res) == sorted(jax_res) == sorted(SCALES)
    for ds in SCALES:
        assert abs(res[ds]["psnr_y"] - jax_res[ds]["psnr_y"]) < 0.01, ds
        assert abs(res[ds]["ssim_y"] - jax_res[ds]["ssim_y"]) < 1e-4, ds
        assert np.isfinite(res[ds]["psnr_y"]) and 0 < res[ds]["ssim_y"] < 1
    assert files == jax_files and len(files) == 2 * 2 * 4  # datasets x clips x frames
    assert files[0] == os.path.join("visualization", "Vid4_x1.5_x3.5", "calendar",
                                    "00000000_test_tiny_eval.png")


@pytest.fixture(scope="module")
def models(world, tmp_path_factory):
    """The JAX package's model and the port's, built from one config as
    their test pipelines build them."""
    from savsr_tpu.models import build_model as jax_build_model
    from savsr_tpu.utils.options import parse_options as jax_parse_options
    from savsr_tpu_torch.models import build_model
    from savsr_tpu_torch.utils.options import parse_options

    root = tmp_path_factory.mktemp("models")
    cfg = root / "m.yml"
    cfg.write_text(_yml(world))
    jopt, _ = jax_parse_options(str(root), is_train=False, args_list=["-opt", str(cfg)])
    popt, _ = parse_options(str(root), is_train=False,
                            args_list=["-opt", str(cfg), "--device", "cpu"])
    return jax_build_model(jopt), build_model(popt)


@pytest.mark.parametrize("ds", list(SCALES))
def test_frame0_float_sr_matches_jax(world, models, ds):
    from savsr_tpu_torch.data import build_dataset
    from savsr_tpu_torch.utils.options import yaml_load

    jmodel, model = models
    block = next(b for b in yaml_load(_yml(world))["datasets"].values() if b["name"] == ds)
    item = dict(build_dataset(dict(block, phase="test"))[0])
    item["lq"], item["gt"] = item["lq"][None], item["gt"][None]
    for m in (jmodel, model):
        m.opt["scale"] = SCALES[ds]
        m.feed_data(dict(item))
        m.test()
    want = np.asarray(jmodel.output)
    got = model.output.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1,) + item["gt"].shape[1:]
    assert np.abs(got - want).max() <= 1e-5


def test_selfensemble_and_bi_postprocess_match_jax(models):
    """x8 self-ensemble on one square 12x12 window at x2: the transposed
    variants run at the swapped scale. Then the visuals against a GT of
    another size (26x22): the output is resized to it (antialiased
    bicubic, the BI post-process) as the JAX package resizes it."""
    jmodel, model = models
    rng = np.random.default_rng(4)
    data = {"lq": rng.random((1, 7, 12, 12, 3), dtype=np.float32),
            "gt": rng.random((1, 26, 22, 3), dtype=np.float32)}
    for m in (jmodel, model):
        m.opt["scale"] = None
        m.feed_data(dict(data))
        m.scale = (2.0, 2.0)
        m.test_selfensemble()
    want = np.asarray(jmodel.output)
    got = model.output.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1, 24, 24, 3)
    assert np.abs(got - want).max() <= 1e-5
    got_v, want_v = model.get_current_visuals(), jmodel.get_current_visuals()
    assert got_v["result"].shape == want_v["result"].shape == (1, 26, 22, 3)
    assert np.abs(got_v["result"] - want_v["result"]).max() <= 1e-5
    assert np.array_equal(got_v["gt"], want_v["gt"]) and np.array_equal(got_v["lq"], data["lq"])


def test_device_metrics_match_host_metrics(world, models):
    """``val: metrics_device: true`` computes PSNR/SSIM on the device
    tensors (float values, for monitoring): within the bounds the JAX
    package holds its device forms to against the host metrics
    (tests/test_metrics.py: 0.05 dB, 1e-3), on frame 0 at x(1.5, 3.5)."""
    from savsr_tpu_torch.data import build_dataset
    from savsr_tpu_torch.metrics import calculate_metric
    from savsr_tpu_torch.utils.img_util import array2img
    from savsr_tpu_torch.utils.options import yaml_load

    _, model = models
    block = next(b for b in yaml_load(_yml(world))["datasets"].values()
                 if b["name"] == "Vid4_x1.5_x3.5")
    item = dict(build_dataset(dict(block, phase="test"))[0])
    item["lq"], item["gt"] = item["lq"][None], item["gt"][None]
    model.opt["scale"] = block["downsampling_scale"]
    model.feed_data(item)
    model.test()
    dev = model._device_metrics()
    visuals = model.get_current_visuals()
    data = {"img": array2img(visuals["result"][0]), "img2": array2img(visuals["gt"][0])}
    host = [calculate_metric(data, m) for m in model.opt["val"]["metrics"].values()]
    assert abs(dev[0] - host[0]) < 0.05 and abs(dev[1] - host[1]) < 1e-3, (dev, host)


def test_image_model_validation_averages_over_frames(world, tmp_path, monkeypatch):
    """model_type SRModel validates over the loader (the mean over every
    frame) where the video model takes the mean of per-folder means: equal
    when the folders have one length. A paired LR folder at x4; the forward
    is stood in for by a bilinear upsample of the centre frame (this checks
    the bookkeeping; the forward is checked above)."""
    import torch.nn.functional as F

    from savsr_tpu_torch.data import build_dataloader, build_dataset
    from savsr_tpu_torch.models import build_model
    from savsr_tpu_torch.models.sr_model import SRModel
    from savsr_tpu_torch.utils.options import parse_options

    def upsample(self):
        self.output = F.interpolate(self.lq[:, 3], scale_factor=4, mode="bilinear")

    monkeypatch.setattr(SRModel, "test", upsample)
    block = f"""
  test_01:
    name: Vid4_BI
    type: VideoTestDataset
    dataroot_gt: {world}/GT
    dataroot_lq: {world}/LR
    io_backend:
      type: disk
    cache_data: true
    num_frame: 7
    padding: reflection
scale: 4"""
    res = {}
    for model_type in ("SRModel", "ASVSRModel"):
        cfg = tmp_path / f"{model_type}.yml"
        cfg.write_text(_yml(world, name=model_type, scales={}).replace(
            "model_type: ASVSRModel", f"model_type: {model_type}").replace(
            "datasets:", "datasets:" + block, 1))
        opt, _ = parse_options(str(tmp_path), is_train=False,
                               args_list=["-opt", str(cfg), "--device", "cpu"])
        ds_opt = opt["datasets"]["test_01"]
        model = build_model(opt)
        model.validation(build_dataloader(build_dataset(ds_opt), ds_opt), "t", None)
        res[model_type] = getattr(model, "last_metric_results", model.metric_results)
    for m in ("psnr_y", "ssim_y"):
        got, want = res["SRModel"][m], res["ASVSRModel"][m]
        assert np.isfinite(want) and abs(got - want) <= 1e-9 * abs(want), m


def test_conv_engine_chw_is_accepted_and_changes_nothing(world):
    """The shipped configs' ``conv_engine: chw`` (and ``pair_align``, the
    native ``conv_precision``) name engines of the JAX package: the port
    builds the same network with or without them."""
    from savsr_tpu_torch.archs import build_network
    from savsr_tpu_torch.utils.options import yaml_load

    net_opt = yaml_load(_yml(world))["network_g"]
    plain = build_network(net_opt)
    chw = build_network(dict(net_opt, conv_engine="chw", pair_align=False,
                             conv_precision="native"))
    assert chw.cfg == plain.cfg
    assert {k: v.shape for k, v in chw.state_dict().items()} == {
        k: v.shape for k, v in plain.state_dict().items()}


def test_split_tier_eval_matches_direct_split_forward(world, tmp_path, monkeypatch):
    """``network_g: conv_precision: split`` runs the pipeline on the split
    tier: every frame's psnr_y and ssim_y equal those of a direct split
    forward of its window (the same post-process and metrics), at
    x(1.5, 3.5)."""
    from savsr_tpu_torch import test as test_mod
    from savsr_tpu_torch.archs.savsr_arch import SAVSR
    from savsr_tpu_torch.data import build_dataset
    from savsr_tpu_torch.data.resize import resize_np
    from savsr_tpu_torch.metrics import calculate_metric
    from savsr_tpu_torch.utils.convert import load_checkpoint, load_into
    from savsr_tpu_torch.utils.img_util import array2img
    from savsr_tpu_torch.utils.options import yaml_load

    built, real_build = [], test_mod.build_model
    monkeypatch.setattr(test_mod, "build_model", lambda opt: built.append(real_build(opt))
                        or built[-1])
    scales = {"Vid4_x1.5_x3.5": SCALES["Vid4_x1.5_x3.5"]}
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(_yml(world, net_extra="  conv_precision: split\n", scales=scales))
    results = test_mod.test_pipeline(str(tmp_path), ["-opt", str(cfg), "--device", "cpu"])
    (model,) = built
    assert model.net_g.cfg.conv_precision == "split"
    assert np.isfinite(results["Vid4_x1.5_x3.5"]["psnr_y"])

    opt = yaml_load(cfg.read_text())
    net = SAVSR(**{k: v for k, v in opt["network_g"].items() if k != "type"}).eval()
    load_into(net, load_checkpoint(str(world / "net_g.npz"), "params"))
    dataset = build_dataset(dict(opt["datasets"]["test_01"], phase="test"))
    metrics = opt["val"]["metrics"].values()
    for i in range(len(dataset)):
        item = dataset[i]
        lq = torch.from_numpy(item["lq"]).permute(0, 3, 1, 2)[None]
        sr = net(lq, scales["Vid4_x1.5_x3.5"]).permute(0, 2, 3, 1).numpy()
        if sr.shape[1:3] != item["gt"].shape[:2]:  # the BI post-process
            sr = resize_np(sr, item["gt"].shape[:2], mode="torch", antialias=True)
        data = {"img": array2img(sr[0]), "img2": array2img(item["gt"])}
        want = [calculate_metric(data, m) for m in metrics]
        got = model.metric_results[item["folder"]][int(item["idx"].split("/")[0])]
        assert list(got) == want, (i, list(got), want)


UNPORTED = [
    ("bucket_eval", dict(val_extra="  bucket_eval: true\n")),
    ("bucket_auto", dict(val_extra="  bucket_auto: true\n")),
]


@pytest.mark.parametrize("key,kw", UNPORTED, ids=[u[0] for u in UNPORTED])
def test_unported_eval_options_raise_by_name(world, tmp_path, key, kw):
    from savsr_tpu_torch.test import test_pipeline

    cfg = tmp_path / "cfg.yml"
    cfg.write_text(_yml(world, **kw))
    with pytest.raises(NotImplementedError, match=key):
        test_pipeline(str(tmp_path), ["-opt", str(cfg), "--device", "cpu"])


def test_eval_without_a_card_raises(world, tmp_path):
    from savsr_tpu_torch.test import test_pipeline

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(_yml(world))
    with pytest.raises(RuntimeError, match="CUDA"):
        test_pipeline(str(tmp_path), ["-opt", str(cfg)])
