"""Loss reduction helpers (role of lbasicsr/losses/loss_util.py)."""

from __future__ import annotations

import functools

import torch


def reduce_loss(loss: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    if reduction == "none":
        return loss
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    raise ValueError(f"invalid reduction {reduction}")


def weight_reduce_loss(loss, weight=None, reduction="mean"):
    """Apply elementwise weights, then reduce; 'mean' with weights averages
    over all elements, as the reference does."""
    if weight is not None:
        loss = loss * weight
    return reduce_loss(loss, reduction)


def weighted_loss(loss_func):
    """Decorator adding (weight, reduction) handling to an elementwise loss."""

    @functools.wraps(loss_func)
    def wrapper(pred, target, weight=None, reduction="mean", **kwargs):
        return weight_reduce_loss(loss_func(pred, target, **kwargs), weight, reduction)

    return wrapper
