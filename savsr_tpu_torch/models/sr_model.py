"""SRModel: generic single-output super-resolution trainer.

The port's counterpart of the training half of ``savsr_tpu/models/sr_model.py``
(itself lbasicsr/models/sr_model.py): one step is forward -> pixel loss ->
backward -> optimizer step -> EMA, eagerly on one device.

``train: bf16`` is a whole cast, not autocast, as in the JAX package: every
f32 parameter and buffer and ``lq`` are cast to bf16 inside the graph
(``torch.func.functional_call`` on the cast copies, so the gradients arrive
on the f32 masters), the entire forward runs in bf16 (BatchNorm statistics,
sigmoids and the STAU head included), the output goes to f32 before the loss;
masters, optimizer moments and EMA stay f32, and the BatchNorm running-stat
updates are cast back to f32. f32 steps run in true f32 (TF32 off) through
the network's ``matmul_precision``.

Not ported yet (each raises NotImplementedError): ``train: bucket_train``,
``train: degrade_on_device``, perceptual/GAN losses, validation.
"""

from __future__ import annotations

from itertools import chain
from typing import Dict

import numpy as np
import torch

from ..archs import build_network
from ..archs.savsr_arch import init_weights
from ..losses import build_loss
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

        if self.is_train:
            self.init_training_settings()

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
        self.defer_loss_fetch(losses)

    # ------------------------------------------------------------------ #
    # save
    # ------------------------------------------------------------------ #

    def save(self, epoch: int, current_iter: int) -> None:
        nets = {"params": self.net_g.state_dict()}
        if self.params_ema is not None:
            nets["params_ema"] = self.params_ema
        self.save_network(nets, self.opt["path"]["models"], "net_g", current_iter)
        self.save_training_state(self.opt["path"]["training_states"], epoch, current_iter)
