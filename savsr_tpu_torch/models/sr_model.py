"""SRModel: generic single-output super-resolution trainer and evaluator.

The port's counterpart of ``savsr_tpu/models/sr_model.py`` (itself
lbasicsr/models/sr_model.py): one training step is forward -> pixel loss
-> backward -> optimizer step -> EMA, eagerly on one device; the eval
forward is the serving forward (the kernels of ops/) in f32 on the EMA
weights where there are any, with the STAU statics computed once per (LR
shape, scale, weights).

``train: bf16`` is a whole cast, not autocast, as in the JAX package: every
f32 parameter and buffer and ``lq`` are cast to bf16 inside the graph
(``torch.func.functional_call`` on the cast copies, so the gradients arrive
on the f32 masters), the entire forward runs in bf16 (BatchNorm statistics,
sigmoids and the STAU head included), the output goes to f32 before the loss;
masters, optimizer moments and EMA stay f32, and the BatchNorm running-stat
updates are cast back to f32. f32 steps run in true f32 (TF32 off) through
the network's ``matmul_precision``.

The eval forward takes f32 ``lq`` and the f32 weights whatever the
training dtype, as the JAX package's does, at the tier the network's
settings name (``SAVSR.serving_tier``: strict at ``matmul_precision:
float32``, fast at ``default``, split with ``conv_precision: split``). Not ported yet (each raises
NotImplementedError): ``train: bucket_train``, ``train: degrade_on_device``,
perceptual/GAN losses, ``val: bucket_eval`` / ``bucket_auto``.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from itertools import chain
from os import path as osp
from typing import Dict

import numpy as np
import torch

from ..archs import build_network
from ..archs.savsr_arch import init_weights, normalize_scale
from ..data.resize import resize_np
from ..losses import build_loss
from ..metrics import calculate_metric
from ..utils.img_util import array2img, imwrite
from ..utils.logger import get_root_logger
from ..utils.registry import MODEL_REGISTRY
from .base_model import BaseModel


@MODEL_REGISTRY.register()
class SRModel(BaseModel):
    def __init__(self, opt: dict):
        super().__init__(opt)
        self.net_g = build_network(opt["network_g"])
        init_weights(self.net_g, opt.get("manual_seed") or 0)

        load_path = self.opt["path"].get("pretrain_network_g")
        if load_path is not None:
            strict = self.opt["path"].get("strict_load_g", True)
            loaded = self.load_network(load_path, self.opt["path"].get("param_key_g", "params"))
            self.check_loaded_keys(self.net_g.state_dict(), loaded, strict)
            self.net_g.load_state_dict(loaded, strict=strict)
        self.net_g.to(self.device)
        self.params_ema = None
        self.scale = self.opt.get("scale", (4, 4))
        # advanced by every change of the weights after the load (optimizer
        # step and EMA update, both in place): the eval network copy of the
        # EMA weights and the STAU statics are rebuilt when it moves
        self.weights_version = 0
        self._ema_net = None  # (weights_version, network holding params_ema)
        self._stau_statics = None  # (key, statics)
        self._statics_s = 0.0  # host seconds spent computing statics (for eval_stats)
        # optional list: dist_validation appends per-item timings to it
        self.eval_stats = None
        self.check_val_options()

        if self.is_train:
            self.init_training_settings()

    def check_val_options(self) -> None:
        """Raise for the ``val:`` options of the JAX package's eval forward
        that the port does not run, naming the option."""
        val_opt = self.opt.get("val") or {}
        for key in ("bucket_eval", "bucket_auto"):
            if val_opt.get(key):
                raise NotImplementedError(f"val: {key} (bucketed eval) is not ported yet")
        if val_opt.get("aot_cache"):
            get_root_logger().info("val: aot_cache is a no-op here: eager PyTorch compiles no "
                                   "eval program.")

    # ------------------------------------------------------------------ #
    # training setup
    # ------------------------------------------------------------------ #

    def init_training_settings(self) -> None:
        train_opt = self.opt["train"]
        logger = get_root_logger()
        for key in ("bucket_train", "degrade_on_device"):
            if train_opt.get(key, False):
                raise NotImplementedError(f"train: {key} is not ported yet")
        for key in ("perceptual_opt", "gan_opt"):
            if train_opt.get(key):
                raise NotImplementedError(f"train: {key} (perceptual/GAN losses) is not ported yet")
        if train_opt.get("aot_cache", False):
            logger.info("train: aot_cache is a no-op here: eager PyTorch compiles no training "
                        "program.")
        logger.info(f"osconv_impl: {self.net_g.cfg.osconv_impl}: the port has one OSConv "
                    "training engine: on CUDA every value runs the CUDA kernels of "
                    "ops/osconv.py (forward, dx, weight gradient), on the CPU their plain "
                    "versions.")
        self.net_g.train()
        self.ema_decay = train_opt.get("ema_decay", 0)
        if self.ema_decay > 0:
            logger.info(f"Use Exponential Moving Average with decay: {self.ema_decay}")
            load_path = self.opt["path"].get("pretrain_network_g")
            ema = None
            if load_path is not None:
                try:
                    ema = self.load_network(load_path, "params_ema")
                    self.check_loaded_keys(self.net_g.state_dict(), ema, True)
                except KeyError:
                    ema = None
            if ema is None:
                ema = self.net_g.state_dict()
            self.params_ema = {k: v.detach().clone().to(self.device) for k, v in ema.items()}

        self.cri_pix = build_loss(train_opt["pixel_opt"]) if train_opt.get("pixel_opt") else None
        if self.cri_pix is None:
            raise ValueError("The pixel loss is None.")
        self.setup_optimizers()
        self.setup_schedulers()

    def setup_optimizers(self) -> None:
        optim_opt = dict(self.opt["train"]["optim_g"])
        optim_type = optim_opt.pop("type")
        self.base_lr = optim_opt.get("lr", 1e-4)
        self.optimizer_g = self.get_optimizer(optim_type, list(self.net_g.parameters()),
                                              **optim_opt)
        self.optimizers = [self.optimizer_g]

    # ------------------------------------------------------------------ #
    # data / step
    # ------------------------------------------------------------------ #

    def prepare_batch(self, data: Dict) -> Dict:
        """Host -> device upload, separated from feed_data so a
        DevicePrefetcher can run it one batch ahead. The loader's batches are
        channel-last numpy (lq [B, T, H, W, C], gt [B, H, W, C]); they go
        through pinned memory with non-blocking copies and come out NCHW."""
        out = dict(data)
        for key in ("lq", "gt"):
            if key not in data:
                continue
            t = torch.from_numpy(np.ascontiguousarray(data[key], dtype=np.float32))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[key] = t.movedim(-1, -3).contiguous()
        return out

    def feed_data(self, data: Dict) -> None:
        batch = data if isinstance(data.get("lq"), torch.Tensor) else self.prepare_batch(data)
        self.lq = batch["lq"]
        self.gt = batch.get("gt")
        if data.get("scale") is not None:
            s = data["scale"]
            self.scale = ((float(s[0]), float(s[1])) if isinstance(s, (tuple, list))
                          else (float(s), float(s)))

    def _loss(self, lq: torch.Tensor, gt: torch.Tensor, scale):
        """Forward + pixel loss of one (micro-)batch: (total, losses,
        BatchNorm running-stat updates)."""
        net = self.net_g
        if self.opt["train"].get("bf16", False):
            cast = {k: (v.to(torch.bfloat16) if v.dtype == torch.float32 else v)
                    for k, v in chain(net.named_parameters(), net.named_buffers())}
            output, updates = torch.func.functional_call(
                net, cast, (lq.to(torch.bfloat16), scale), {"train": True})
        else:
            output, updates = net(lq, scale, train=True)
        l_pix = self.cri_pix(output.float(), gt)
        return l_pix, {"l_pix": l_pix.detach(), "l_total": l_pix.detach()}, updates

    @torch.no_grad()
    def _apply_stats(self, updates: Dict[str, torch.Tensor]) -> None:
        """Write the step's running-stat updates into the network's buffers,
        cast back to the buffers' (master) dtypes."""
        buffers = dict(self.net_g.named_buffers())
        for k, v in updates.items():
            buffers[k].copy_(v)

    def optimize_parameters(self, current_iter: int) -> None:
        """One optimizer step. With ``train: accum_steps`` > 1 the batch is
        cut into micro-batches: the gradient is the mean of theirs, BatchNorm
        normalises per micro-batch and its running stats chain across them
        like consecutive forwards."""
        accum = int(self.opt["train"].get("accum_steps", 1))
        if self.lq.shape[0] % accum != 0:
            raise ValueError(
                f"train: accum_steps={accum} requires the batch dimension "
                f"({self.lq.shape[0]}) to be divisible by it — adjust "
                f"batch_size_per_gpu or accum_steps.")
        scale = (tuple(self.scale) if isinstance(self.scale, (tuple, list))
                 else (self.scale, self.scale))
        self.optimizer_g.zero_grad(set_to_none=True)
        losses = None
        for lq, gt in zip(self.lq.chunk(accum), self.gt.chunk(accum)):
            total, losses_m, updates = self._loss(lq, gt, scale)
            (total / accum).backward()
            self._apply_stats(updates)
            losses = losses_m if losses is None else {k: losses[k] + v
                                                       for k, v in losses_m.items()}
        if accum > 1:
            losses = {k: v / accum for k, v in losses.items()}
        self.optimizer_g.step()
        if self.ema_decay > 0:
            self.ema_update(self.params_ema, self.net_g.state_dict(), self.ema_decay)
        self.weights_version += 1
        self.defer_loss_fetch(losses)

    # ------------------------------------------------------------------ #
    # inference / eval
    # ------------------------------------------------------------------ #

    def _eval_net(self):
        """The network the eval forward runs: ``net_g``, or with EMA a second
        network that holds ``params_ema``, loaded again only after the
        weights changed."""
        if self.params_ema is None:
            return self.net_g
        if self._ema_net is None or self._ema_net[0] != self.weights_version:
            net = self._ema_net[1] if self._ema_net is not None else (
                build_network(self.opt["network_g"]).to(self.device).eval())
            net.load_state_dict(self.params_ema)
            self._ema_net = (self.weights_version, net)
        return self._ema_net[1]

    def _stau_statics_cached(self, net, lq_hw, scale, dtype):
        """One-entry cache of the frame-invariant STAU and tail operands
        (``SAVSR.stau_statics``): eval walks a clip's frames at one (shape,
        scale), so each computes them once. Keyed on the network, its
        weights' version, the shape, the scale and the dtype."""
        key = (id(net), self.weights_version, lq_hw, scale, dtype)
        if self._stau_statics is None or self._stau_statics[0] != key:
            self._stau_statics = None  # free the old operands first
            t0 = self._eval_clock()
            statics = net.stau_statics(lq_hw, scale, dtype=dtype, device=self.device)
            self._statics_s += self._eval_clock() - t0
            self._stau_statics = (key, statics)
        return self._stau_statics[1]

    def _eval_clock(self) -> float:
        """Host clock for ``eval_stats``, after the device's queue drains
        (no sync when nobody records)."""
        if self.eval_stats is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _forward_eval(self, net, lq: torch.Tensor, scale) -> torch.Tensor:
        scale = normalize_scale(scale)
        lq = lq.float()
        statics = self._stau_statics_cached(net, (int(lq.shape[-2]), int(lq.shape[-1])), scale,
                                            lq.dtype)
        return net(lq, scale, stau_statics=statics)

    def test(self) -> None:
        self.output = self._forward_eval(self._eval_net(), self.lq, self.scale)

    def test_selfensemble(self) -> None:
        """x8 geometric self-ensemble (reference sr_model.py:141-187): the
        forward on every flip/transpose of the window, each output mapped
        back, averaged. A transpose swaps the scale's axes."""
        net = self._eval_net()
        sh, sw = normalize_scale(self.scale)
        outputs = []
        for transposed in (False, True):
            for tf in ("identity", "h", "v", "hv"):
                x = self.lq
                if "h" in tf:
                    x = x.flip(-1)
                if "v" in tf:
                    x = x.flip(-2)
                if transposed:
                    x = x.transpose(-2, -1)
                out = self._forward_eval(net, x.contiguous(), (sw, sh) if transposed else (sh, sw))
                if transposed:
                    out = out.transpose(-2, -1)
                if "v" in tf:
                    out = out.flip(-2)
                if "h" in tf:
                    out = out.flip(-1)
                outputs.append(out)
        self.output = torch.stack(outputs).mean(dim=0)

    def get_current_visuals(self) -> "OrderedDict":
        """lq / result / gt as channel-last host numpy (the JAX package's
        layout); the arbitrary-scale BI post-process: where output and gt
        shapes differ, the output is resized (bicubic, antialiased) to the gt
        size (reference sr_model.py:291-304)."""
        out = self.output.float().permute(0, 2, 3, 1).cpu().numpy()
        gt = None if self.gt is None else self.gt.float().permute(0, 2, 3, 1).cpu().numpy()
        if gt is not None and out.shape != gt.shape:
            out = resize_np(out, (gt.shape[-3], gt.shape[-2]), mode="torch", antialias=True)
        d = OrderedDict()
        d["lq"] = self.lq.movedim(-3, -1).cpu().numpy()
        d["result"] = out
        if gt is not None:
            d["gt"] = gt
        return d

    # ------------------------------------------------------------------ #
    # validation
    # ------------------------------------------------------------------ #

    def validation(self, dataloader, current_iter, tb_logger, save_img=False):
        self.nondist_validation(dataloader, current_iter, tb_logger, save_img)

    def dist_validation(self, dataloader, current_iter, tb_logger, save_img=False):
        self.nondist_validation(dataloader, current_iter, tb_logger, save_img)

    def nondist_validation(self, dataloader, current_iter, tb_logger, save_img):
        """Image-model validation over the loader: the mean of each metric
        over the images."""
        dataset_name = dataloader.dataset.opt["name"]
        with_metrics = self.opt["val"].get("metrics") is not None
        if with_metrics:
            self.metric_results = {m: 0 for m in self.opt["val"]["metrics"].keys()}
            self._initialize_best_metric_results(dataset_name)
        cnt = 0
        for val_data in dataloader:
            img_name = osp.splitext(osp.basename(val_data["lq_path"][0]))[0]
            self.feed_data(val_data)
            self.test()
            visuals = self.get_current_visuals()
            sr_img = array2img(visuals["result"][0])
            metric_data = {"img": sr_img}
            if "gt" in visuals:
                metric_data["img2"] = array2img(visuals["gt"][0])
            if save_img:
                if self.opt["is_train"]:
                    save_path = osp.join(self.opt["path"]["visualization"], img_name,
                                         f"{img_name}_{current_iter}.png")
                else:
                    suffix = self.opt["val"].get("suffix") or self.opt["name"]
                    save_path = osp.join(self.opt["path"]["visualization"], dataset_name,
                                         f"{img_name}_{suffix}.png")
                imwrite(sr_img, save_path)
            if with_metrics:
                for name, opt_ in self.opt["val"]["metrics"].items():
                    self.metric_results[name] += calculate_metric(metric_data, opt_)
            cnt += 1
        if with_metrics:
            for metric in self.metric_results.keys():
                self.metric_results[metric] /= cnt
                self._update_best_metric_result(dataset_name, metric,
                                                self.metric_results[metric], current_iter)
            self._log_validation_metric_values(current_iter, dataset_name, tb_logger)

    def _log_validation_metric_values(self, current_iter, dataset_name, tb_logger):
        log_str = f"Validation {dataset_name}\n"
        for metric, value in self.metric_results.items():
            log_str += f"\t # {metric}: {value:.4f}"
            if hasattr(self, "best_metric_results"):
                rec = self.best_metric_results[dataset_name][metric]
                log_str += f"\tBest: {rec['val']:.4f} @ {rec['iter']} iter"
            log_str += "\n"
        get_root_logger().info(log_str)
        if tb_logger:
            for metric, value in self.metric_results.items():
                tb_logger.add_scalar(f"metrics/{dataset_name}/{metric}", value, current_iter)

    # ------------------------------------------------------------------ #
    # save
    # ------------------------------------------------------------------ #

    def save(self, epoch: int, current_iter: int) -> None:
        nets = {"params": self.net_g.state_dict()}
        if self.params_ema is not None:
            nets["params_ema"] = self.params_ema
        self.save_network(nets, self.opt["path"]["models"], "net_g", current_iter)
        self.save_training_state(self.opt["path"]["training_states"], epoch, current_iter)
