"""L1 and smooth-L1 regression losses (mmdet smooth_l1_loss.py).

Counterpart of pointtinybenchmark_tpu/models/losses/smooth_l1_loss.py::
L1Loss and SmoothL1Loss.
"""
from __future__ import annotations

from typing import Optional

import torch

from .utils import weight_reduce_loss

__all__ = ["L1Loss", "SmoothL1Loss"]


class SmoothL1Loss:

    def __init__(self, beta: float = 1.0, reduction: str = "mean",
                 loss_weight: float = 1.0):
        self.beta = beta
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred: torch.Tensor, target: torch.Tensor,
                 weight: Optional[torch.Tensor] = None,
                 avg_factor=None) -> torch.Tensor:
        diff = (pred - target).abs()
        loss = torch.where(diff < self.beta, 0.5 * diff * diff / self.beta,
                           diff - 0.5 * self.beta)
        loss = weight_reduce_loss(loss, weight, self.reduction, avg_factor)
        return self.loss_weight * loss


class L1Loss:

    def __init__(self, reduction: str = "mean", loss_weight: float = 1.0):
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred: torch.Tensor, target: torch.Tensor,
                 weight: Optional[torch.Tensor] = None,
                 avg_factor=None) -> torch.Tensor:
        loss = weight_reduce_loss((pred - target).abs(), weight,
                                  self.reduction, avg_factor)
        return self.loss_weight * loss
