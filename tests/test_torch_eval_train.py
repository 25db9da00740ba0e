"""Validation inside the port's training (python -m savsr_tpu_torch.train
with ``val_*`` datasets and a ``val:`` block), on the CPU: the validation
at an iteration equals the eval pipeline run on the checkpoint saved at
that iteration (EMA weights), also after further steps (a stale STAU
statics cache or EMA copy would break it), and the step after a
validation trains at its own batch's scale."""

import numpy as np
import pytest

TINY_NET = """
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
"""
VAL_BLOCK = """
  val_x2:
    name: Vid4_x2
    type: ASVideoTestDataset
    dataroot_gt: {root}/GT
    dataroot_lq: {root}/GT
    io_backend:
      type: disk
    cache_data: false
    num_frame: 7
    padding: reflection
    use_arbitrary_scale_downsampling: true
    downsampling_scale: !!python/tuple [2, 2]
    downsampling_mode: torch
"""
METRICS = """
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
    """Two Vimeo-style 52x52 septuplets and one 4-frame 24x28 eval clip."""
    import cv2

    root = tmp_path_factory.mktemp("eval_train")
    rng = np.random.default_rng(0)
    keys = ["00001/0001", "00001/0002"]
    for key in keys:
        d = root / "vimeo" / key
        d.mkdir(parents=True)
        img = (rng.random((52, 52, 3)) * 255).astype(np.uint8)
        for i in range(1, 8):
            cv2.imwrite(str(d / f"im{i}.png"), np.roll(img, i, axis=0))
    (root / "meta.txt").write_text("".join(f"{k} 7 (52,52,3)\n" for k in keys))
    d = root / "GT" / "clip"
    d.mkdir(parents=True)
    img = (rng.random((24, 28, 3)) * 255).astype(np.uint8)
    for i in range(4):
        cv2.imwrite(str(d / f"{i:08d}.png"), np.roll(img, i, axis=1))
    return root


def _train_yml(root):
    return f"""
name: train_tiny_val
model_type: ASVSRModel
num_gpu: 1
manual_seed: 7
datasets:
  train:
    name: Vimeo90K_tiny
    type: ASVimeo90KDataset
    dataroot_gt: {root}/vimeo
    dataroot_lq: {root}/vimeo
    meta_info_file: {root}/meta.txt
    io_backend:
      type: disk
    num_frame: 7
    lq_size: 12
    max_scale: 4
    downsample_mode: torch
    init_int_scale: false
    single_scale_ft: false
    scale_h_list: [1.5, 3.5]
    scale_w_list: [2.5, 3.0]
    random_reverse: false
    use_hflip: true
    use_rot: true
    num_worker_per_gpu: 0
    batch_size_per_gpu: 1
    dataset_enlarge_ratio: 2
{VAL_BLOCK.format(root=root)}{TINY_NET}
path:
  pretrain_network_g: ~
  strict_load_g: true
  resume_state: ~
  experiments_root: {root}/experiments
train:
  ema_decay: 0.9
  optim_g:
    type: Adam
    lr: !!float 1e-3
    weight_decay: 0
    betas: [0.9, 0.999]
  scheduler:
    type: CosineAnnealingRestartLR
    periods: [100]
    restart_weights: [1]
    eta_min: !!float 1e-7
  total_iter: 3
  warmup_iter: -1
  pixel_opt:
    type: CharbonnierLoss
    loss_weight: 1.0
    reduction: mean
val:
  val_freq: 2
  save_img: false
{METRICS}
logger:
  print_freq: 1
  save_checkpoint_freq: 2
  use_tb_logger: false
  wandb:
    project: ~
    resume_id: ~
"""


def _test_yml(root, ckpt):
    block = VAL_BLOCK.format(root=root).replace("val_x2:", "test_01:")
    return f"""
name: eval_{ckpt}
model_type: ASVSRModel
num_gpu: 1
manual_seed: 0
datasets:{block}{TINY_NET}
path:
  pretrain_network_g: {root}/experiments/train_tiny_val/models/net_g_{ckpt}.npz
  param_key_g: params_ema
  strict_load_g: true
  resume_state: ~
val:
  save_img: false
{METRICS}"""


def test_validation_equals_the_eval_of_the_saved_checkpoint(world, monkeypatch):
    from savsr_tpu_torch.models.sr_model import SRModel
    from savsr_tpu_torch.models.video_base_model import VideoBaseModel
    from savsr_tpu_torch.test import test_pipeline
    from savsr_tpu_torch.train import train_pipeline

    validations, steps = [], []
    log_metrics = VideoBaseModel._log_validation_metric_values
    feed_data = SRModel.feed_data
    optimize = SRModel.optimize_parameters

    def record_validation(self, current_iter, dataset_name, tb_logger):
        log_metrics(self, current_iter, dataset_name, tb_logger)
        validations.append((current_iter, dict(self.last_metric_results)))

    def record_feed(self, data):
        feed_data(self, data)
        self._batch_scale = data.get("scale")

    def record_step(self, current_iter):
        steps.append((current_iter, self._batch_scale, tuple(self.scale),
                      self.opt.get("scale")))
        optimize(self, current_iter)

    monkeypatch.setattr(VideoBaseModel, "_log_validation_metric_values", record_validation)
    monkeypatch.setattr(SRModel, "feed_data", record_feed)
    monkeypatch.setattr(SRModel, "optimize_parameters", record_step)
    cfg = world / "train.yml"
    cfg.write_text(_train_yml(world))
    model = train_pipeline(str(world), ["-opt", str(cfg), "--device", "cpu"])

    # one validation at iteration 2 (val_freq), one after the final save
    # (logged at the loop's counter, total_iter + 1, as the JAX package does)
    assert [it for it, _ in validations] == [2, 4]
    assert model.last_metric_results == validations[-1][1]
    for it, metrics in validations:
        assert np.isfinite(metrics["psnr_y"]) and 0 < metrics["ssim_y"] < 1
    assert validations[0][1] != validations[1][1]  # the weights moved in step 3

    # the step after the validation at its own batch's scale; the eval scale
    # does not stay in the options
    assert [s[0] for s in steps] == [1, 2, 3]
    for _, batch_scale, scale, opt_scale in steps:
        assert scale == tuple(float(v) for v in batch_scale) and opt_scale is None
    assert steps[2][2] != (2.0, 2.0)

    # the eval pipeline on the checkpoints' EMA weights gives the same numbers
    for (it, metrics), ckpt in zip(validations, ("2", "latest")):
        cfg = world / f"eval_{ckpt}.yml"
        cfg.write_text(_test_yml(world, ckpt))
        res = test_pipeline(str(world), ["-opt", str(cfg), "--device", "cpu"])
        assert res["Vid4_x2"] == metrics, (it, ckpt)
