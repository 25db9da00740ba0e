"""Learning-rate schedules as pure step->lr functions, evaluated on the host
(the port's own copy of ``savsr_tpu/models/lr_scheduler.py``).

Semantics mirror lbasicsr/models/lr_scheduler.py: MultiStepRestartLR and
CosineAnnealingRestartLR (the shipped SAVSR schedule: 4x300k cosine restarts
with weights [1, .5, .5, .5], eta_min 1e-7).
"""

from __future__ import annotations

import math
from bisect import bisect_right
from typing import Callable, Sequence

import numpy as np


def multi_step_restart_lr(
    base_lr: float,
    milestones: Sequence[int],
    gamma: float = 0.1,
    restarts: Sequence[int] = (0,),
    restart_weights: Sequence[int] = (1,),
) -> Callable:
    """Step decay with optional restarts; returns f(step)->lr."""
    assert len(restarts) == len(restart_weights)
    milestones = sorted(milestones)
    restarts = list(restarts)

    def schedule(step):
        step = int(step)
        if step in restarts:
            return base_lr * restart_weights[restarts.index(step)]
        n = bisect_right(milestones, step)
        return base_lr * (gamma**n)

    return schedule


def cosine_annealing_restart_lr(
    base_lr: float,
    periods: Sequence[int],
    restart_weights: Sequence[float] = (1,),
    eta_min: float = 0.0,
) -> Callable:
    """Cosine annealing with restarts; returns f(step)->lr.

    lr(t) = eta_min + w_i * 0.5*(base_lr - eta_min) *
            (1 + cos(pi * (t - start_i) / period_i))
    """
    assert len(periods) == len(restart_weights)
    cum = np.cumsum([0] + list(periods))

    def schedule(step):
        step = int(step)
        idx = int(np.searchsorted(cum[1:], step, side="right"))
        idx = min(idx, len(periods) - 1)
        start = cum[idx]
        w = restart_weights[idx]
        period = periods[idx]
        return eta_min + w * 0.5 * (base_lr - eta_min) * (
            1 + math.cos(math.pi * ((step - start) / period))
        )

    return schedule


def constant_lr(base_lr: float) -> Callable:
    return lambda step: base_lr


def build_schedule(train_opt: dict, base_lr: float) -> Callable:
    """Build a schedule from the YAML ``train.scheduler`` block."""
    sched = dict(train_opt["scheduler"])
    stype = sched.pop("type")
    if stype == "CosineAnnealingRestartLR":
        return cosine_annealing_restart_lr(base_lr, **sched)
    if stype in ("MultiStepLR", "MultiStepRestartLR"):
        return multi_step_restart_lr(base_lr, **sched)
    if stype in ("none", "constant"):
        return constant_lr(base_lr)
    raise NotImplementedError(f"Scheduler {stype} is not implemented.")
