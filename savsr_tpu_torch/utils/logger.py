"""Logging: the root logger, the training message logger and timers (the
port's counterpart of ``savsr_tpu/utils/logger.py``). In a world of several
ranks only rank 0 logs, writes the log file and the TensorBoard events; the
others log errors only."""

from __future__ import annotations

import datetime
import logging
import time
from typing import Optional

from .dist_util import is_master, master_only


def get_root_logger(logger_name: str = "savsr_tpu_torch", log_level: int = logging.INFO,
                    log_file: Optional[str] = None) -> logging.Logger:
    """A logger with one stream handler (and, on rank 0, an optional file
    handler), configured on first use; on the other ranks at level ERROR."""
    logger = logging.getLogger(logger_name)
    if getattr(logger, "_savsr_configured", False):
        return logger
    fmt = logging.Formatter("%(asctime)s %(levelname)s: %(message)s")
    handler = logging.StreamHandler()
    handler.setFormatter(fmt)
    logger.addHandler(handler)
    if not is_master():
        log_level = logging.ERROR
    elif log_file is not None:
        file_handler = logging.FileHandler(log_file, "w")
        file_handler.setFormatter(fmt)
        logger.addHandler(file_handler)
    logger.setLevel(log_level)
    logger.propagate = False
    logger._savsr_configured = True
    return logger


class AvgTimer:
    """Windowed average timer for iter/data time (reference logger.py:10-42)."""

    def __init__(self, window: int = 200):
        self.window = window
        self.current_time = 0.0
        self.total_time = 0.0
        self.count = 0
        self.avg_time = 0.0
        self.start()

    def start(self) -> None:
        self.start_time = self.tic = time.time()

    def record(self) -> None:
        self.count += 1
        self.toc = time.time()
        self.current_time = self.toc - self.tic
        self.total_time += self.current_time
        self.avg_time = self.total_time / self.count
        if self.count > self.window:
            self.count = 0
            self.total_time = 0
        self.tic = time.time()

    def get_current_time(self) -> float:
        return self.current_time

    def get_avg_time(self) -> float:
        return self.avg_time


class MessageLogger:
    """Format and emit periodic training log lines + TensorBoard scalars."""

    def __init__(self, opt: dict, start_iter: int = 1, tb_logger=None):
        self.exp_name = opt["name"]
        self.interval = opt["logger"]["print_freq"]
        self.start_iter = start_iter
        self.max_iters = opt["train"]["total_iter"]
        self.tb_logger = tb_logger
        self.start_time = time.time()
        self.logger = get_root_logger()

    def reset_start_time(self) -> None:
        self.start_time = time.time()

    @master_only
    def __call__(self, log_vars: dict) -> None:
        epoch = log_vars.pop("epoch")
        current_iter = log_vars.pop("iter")
        lrs = log_vars.pop("lrs")
        message = f"[{self.exp_name[:31]}..][epoch:{epoch:3d}, iter:{current_iter:8,d}, lr:("
        message += "".join(f"{v:.3e}," for v in lrs) + ")] "
        if "time" in log_vars:
            iter_time = log_vars.pop("time")
            data_time = log_vars.pop("data_time")
            total_time = time.time() - self.start_time
            time_sec_avg = total_time / (current_iter - self.start_iter + 1)
            eta_sec = time_sec_avg * (self.max_iters - current_iter - 1)
            message += f"[eta: {datetime.timedelta(seconds=int(eta_sec))}, "
            message += f"time (data): {iter_time:.3f} ({data_time:.3f})] "
        for k, v in log_vars.items():
            message += f"{k}: {v:.4e} "
            if self.tb_logger is not None:
                tag = k if k.startswith("l_") else f"other/{k}"
                if k.startswith("m_"):
                    tag = f"metrics/{k[2:]}"
                self.tb_logger.add_scalar(tag, v, current_iter)
        self.logger.info(message)


@master_only
def init_tb_logger(log_dir: str):
    """A TensorBoard SummaryWriter if tensorboard is importable, else None
    (scalars then stay in the text log)."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        get_root_logger().warning(
            "tensorboard unavailable; scalar logging falls back to text logs.")
        return None
    return SummaryWriter(log_dir=log_dir)


def get_env_info() -> str:
    import torch

    from .. import __version__

    cuda = torch.cuda.is_available()
    return ("\nVersion Information: "
            f"\n\tsavsr_tpu_torch: {__version__}"
            f"\n\tPyTorch: {torch.__version__}"
            f"\n\tCUDA: {torch.version.cuda}"
            f"\n\tDevices: {[torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())] if cuda else ['cpu']}")
