"""BaseModel: device, optimizers, schedules, EMA, checkpointing.

The port's counterpart of ``savsr_tpu/models/base_model.py`` (itself the
counterpart of lbasicsr/models/base_model.py). The network is an
``nn.Module`` on one device, the optimizers are ``torch.optim`` objects and
the EMA is a second state_dict. Checkpoint artifacts keep the JAX package's
shape: ``net_g_<iter>.npz`` holds ``params/`` and ``params_ema/`` entries in
the JAX layout (utils/convert.py::params_to_jax), so either package loads the
other's file; ``<iter>.state`` holds {epoch, iter, optimizers} with the
``torch.optim`` state_dicts and is this package's own.

In a world of several ranks (``opt['dist']``, one process per GPU,
``parallel.get_mesh_from_opt``) every rank holds the whole network, equal
on all of them (broadcast from rank 0 at set-up and resume), and only rank
0 writes checkpoints; the trainer waits for the write at a barrier.
"""

from __future__ import annotations

import time
from os import path as osp
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..archs.arch_util import resolve_device
from ..parallel import get_mesh_from_opt, replicate
from ..utils.convert import load_checkpoint, params_to_jax
from ..utils.dist_util import master_only
from ..utils.logger import get_root_logger
from .lr_scheduler import build_schedule

STAT_SUFFIXES = ("running_mean", "running_var", "num_batches_tracked")
# the scheduled learning rate does not apply to these two: their lr is an
# initial step size (Rprop) or a decay constant (ASGD)
SELF_SCALED = ("ASGD", "Rprop")


def is_trainable_key(key: str) -> bool:
    return not key.endswith(STAT_SUFFIXES)


class BaseModel:
    """Base train state machine."""

    def __init__(self, opt: dict):
        self.opt = opt
        self.is_train = opt["is_train"]
        self.mesh = get_mesh_from_opt(opt)
        self.device = resolve_device(opt.get("device"))
        self.schedulers: List[Callable] = []
        self.optimizers: list = []
        self.log_dict = {}

    # log_dict is lazy: optimize_parameters leaves the step's loss scalars on
    # the device and the host fetch (a stream sync) happens only when
    # something reads log_dict (the message logger at print_freq). Steps
    # between reads queue back to back with no host sync.
    @property
    def log_dict(self) -> Dict[str, float]:
        if self._log_cache is None:
            dev = self._losses_dev
            self._log_cache = self.reduce_loss_dict(dev) if dev is not None else {}
        return self._log_cache

    @log_dict.setter
    def log_dict(self, value) -> None:
        self._log_cache = value
        self._losses_dev = None

    def defer_loss_fetch(self, losses) -> None:
        """Record the step's device-side loss dict without fetching it."""
        self._log_cache = None
        self._losses_dev = losses

    @staticmethod
    def reduce_loss_dict(loss_dict: Dict) -> Dict[str, float]:
        """Loss values as floats, in one device-to-host copy (the step has
        already averaged them over the world)."""
        keys = list(loss_dict)
        vals = torch.stack([loss_dict[k].detach().float() for k in keys]).tolist()
        return dict(zip(keys, vals))

    # ------------------------------------------------------------------ #
    # optimizer / scheduler factory
    # ------------------------------------------------------------------ #

    def get_optimizer(self, optim_type: str, params, **kwargs) -> torch.optim.Optimizer:
        """``torch.optim`` optimizer of one of the 7 reference types
        (lbasicsr/models/base_model.py:107-124). The scheduled learning rate
        is written into ``param_group['lr']`` every iteration
        (update_learning_rate), except for ASGD and Rprop, which keep the
        configured lr as their decay constant / initial step size."""
        kwargs = {k: (tuple(v) if isinstance(v, list) else v) for k, v in kwargs.items()}
        kwargs["weight_decay"] = kwargs.get("weight_decay") or 0
        kwargs["lr"] = kwargs.get("lr") or 1e-2
        self._opt_self_scaled = optim_type in SELF_SCALED
        if optim_type == "Rprop":
            kwargs.pop("weight_decay")
        if optim_type not in ("Adam", "AdamW", "Adamax", "SGD", "ASGD", "RMSprop", "Rprop"):
            raise NotImplementedError(f"optimizer {optim_type} is not supported yet.")
        return getattr(torch.optim, optim_type)(params, **kwargs)

    def setup_schedulers(self) -> None:
        """Attach host-side step->lr schedules (reference base_model.py:126)."""
        train_opt = self.opt["train"]
        self.schedulers = [build_schedule(train_opt, train_opt["optim_g"].get("lr", 1e-4))]

    def get_current_learning_rate(self, current_iter: int) -> List[float]:
        return [sched(current_iter) for sched in self.schedulers]

    def update_learning_rate(self, current_iter: int, warmup_iter: int = -1) -> None:
        """LR for this iteration, with linear warmup (reference
        base_model.py:185-206), written into the optimizers' param groups."""
        lrs = self.get_current_learning_rate(current_iter)
        if current_iter < warmup_iter:
            init_lrs = [self.opt["train"]["optim_g"].get("lr", 1e-4)]
            lrs = [v / warmup_iter * current_iter for v in init_lrs]
        self._current_lrs = lrs
        if getattr(self, "_opt_self_scaled", False):
            return
        for optimizer, lr in zip(self.optimizers, lrs):
            for group in optimizer.param_groups:
                group["lr"] = lr

    # ------------------------------------------------------------------ #
    # validation bookkeeping
    # ------------------------------------------------------------------ #

    def _initialize_best_metric_results(self, dataset_name: str) -> None:
        """A best-value record per metric of ``val: metrics`` for the
        dataset (kept across validations): -inf / inf by ``better``."""
        if not hasattr(self, "best_metric_results"):
            self.best_metric_results: Dict[str, Dict] = {}
        if dataset_name in self.best_metric_results:
            return
        record = {}
        for metric, content in self.opt["val"]["metrics"].items():
            better = content.get("better", "higher")
            init_val = float("-inf") if better == "higher" else float("inf")
            record[metric] = dict(better=better, val=init_val, iter=-1)
        self.best_metric_results[dataset_name] = record

    def _update_best_metric_result(self, dataset_name: str, metric: str, val: float,
                                   current_iter) -> None:
        rec = self.best_metric_results[dataset_name][metric]
        if (rec["better"] == "higher" and val >= rec["val"]) or (
                rec["better"] == "lower" and val <= rec["val"]):
            rec["val"] = val
            rec["iter"] = current_iter

    # ------------------------------------------------------------------ #
    # EMA
    # ------------------------------------------------------------------ #

    @staticmethod
    @torch.no_grad()
    def ema_update(ema: Dict[str, torch.Tensor], state: Dict[str, torch.Tensor],
                   decay: float) -> None:
        """In place: ema = decay*ema + (1-decay)*param on trainable keys; BN
        statistics follow the live network (reference base_model.py:75-82)."""
        train_keys = [k for k in ema if is_trainable_key(k)]
        ema_t = [ema[k] for k in train_keys]
        torch._foreach_mul_(ema_t, decay)
        torch._foreach_add_(ema_t, [state[k] for k in train_keys], alpha=1 - decay)
        for k in ema:
            if not is_trainable_key(k):
                ema[k].copy_(state[k])

    # ------------------------------------------------------------------ #
    # checkpoint IO
    # ------------------------------------------------------------------ #

    @master_only
    def save_network(self, params_dict: Dict[str, Dict[str, torch.Tensor]], save_root: str,
                     net_label: str, current_iter: int) -> None:
        """Save {'params': ..., 'params_ema': ...} state_dicts as one npz in
        the JAX package's layout and key scheme (``<key>/<name>``); rank 0
        only."""
        if current_iter == -1:
            current_iter = "latest"
        save_path = osp.join(save_root, f"{net_label}_{current_iter}.npz")
        flat = {f"{pk}/{k}": v for pk, state in params_dict.items()
                for k, v in params_to_jax(state).items()}
        for attempt in range(3):
            try:
                np.savez(save_path, **flat)
                break
            except Exception as e:
                get_root_logger().warning(f"Save ckpt error: {e}, retry {attempt + 1}")
                time.sleep(1)
        else:
            raise IOError(f"Cannot save {save_path}.")

    def load_network(self, load_path: str,
                     param_key: Optional[str] = "params") -> Dict[str, torch.Tensor]:
        """A ``.npz`` (JAX layout, either package's) or torch ``.pth``
        checkpoint as a torch-layout state_dict."""
        get_root_logger().info(f"Loading model from {load_path} (key: {param_key}).")
        return load_checkpoint(load_path, param_key)

    def check_loaded_keys(self, current: Dict, loaded: Dict, strict: bool = True) -> None:
        crt, ld = set(current.keys()), set(loaded.keys())
        if crt != ld:
            logger = get_root_logger()
            logger.warning("Current net - loaded net:")
            for v in sorted(crt - ld):
                logger.warning(f"  {v}")
            logger.warning("Loaded net - current net:")
            for v in sorted(ld - crt):
                logger.warning(f"  {v}")
            if strict:
                raise KeyError("State dict key mismatch (strict load).")

    @master_only
    def save_training_state(self, state_root: str, epoch: int, current_iter: int,
                            extra: Optional[Dict] = None) -> None:
        """{epoch, iter, optimizers} (reference base_model.py:321-354), written
        with ``torch.save``, rank 0 only. Not interchangeable with the JAX
        package's pickled optax state."""
        if current_iter == -1:
            return
        state = {"epoch": epoch, "iter": current_iter,
                 "optimizers": [o.state_dict() for o in self.optimizers]}
        if extra:
            state.update(extra)
        path = osp.join(state_root, f"{current_iter}.state")
        for attempt in range(3):
            try:
                torch.save(state, path)
                break
            except Exception as e:
                get_root_logger().warning(f"Save state error: {e}, retry {attempt + 1}")
                time.sleep(1)
        else:
            raise IOError(f"Cannot save {path}.")

    def resume_training(self, resume_state: dict) -> None:
        states = resume_state["optimizers"]
        if len(states) != len(self.optimizers):
            raise ValueError(f"the training state holds {len(states)} optimizers, the model "
                             f"{len(self.optimizers)}")
        for optimizer, state in zip(self.optimizers, states):
            optimizer.load_state_dict(state)
            replicate(optimizer, self.mesh, self.device)
