"""Pixel-space losses (reference: lbasicsr/losses/basic_loss.py), the port's
counterpart of ``savsr_tpu/losses/basic_loss.py:19-66``: plain callables on
tensors, instantiated by name through LOSS_REGISTRY from YAML."""

from __future__ import annotations

import torch

from ..utils.registry import LOSS_REGISTRY
from .loss_util import weighted_loss

_reduction_modes = ["none", "mean", "sum"]


@weighted_loss
def l1_loss(pred, target):
    return (pred - target).abs()


@weighted_loss
def mse_loss(pred, target):
    return (pred - target) ** 2


@weighted_loss
def charbonnier_loss(pred, target, eps=1e-12):
    return torch.sqrt((pred - target) ** 2 + eps)


class _WeightedLoss:
    def __init__(self, loss_weight: float = 1.0, reduction: str = "mean"):
        if reduction not in _reduction_modes:
            raise ValueError(f"Unsupported reduction mode: {reduction}")
        self.loss_weight = loss_weight
        self.reduction = reduction


@LOSS_REGISTRY.register()
class L1Loss(_WeightedLoss):
    def __call__(self, pred, target, weight=None, **kwargs):
        return self.loss_weight * l1_loss(pred, target, weight, reduction=self.reduction)


@LOSS_REGISTRY.register()
class MSELoss(_WeightedLoss):
    def __call__(self, pred, target, weight=None, **kwargs):
        return self.loss_weight * mse_loss(pred, target, weight, reduction=self.reduction)


@LOSS_REGISTRY.register()
class CharbonnierLoss(_WeightedLoss):
    """Charbonnier (robust L1): sqrt((x-y)^2 + eps). The shipped SAVSR
    training loss (train_SAVSR_Vimeo90K_asBI.yml, eps=1e-12)."""

    def __init__(self, loss_weight: float = 1.0, reduction: str = "mean", eps: float = 1e-12):
        super().__init__(loss_weight, reduction)
        self.eps = eps

    def __call__(self, pred, target, weight=None, **kwargs):
        return self.loss_weight * charbonnier_loss(
            pred, target, weight, reduction=self.reduction, eps=self.eps)
