"""L1, smooth-L1 and balanced-L1 regression losses (mmdet
smooth_l1_loss.py, balanced_l1_loss.py).

Counterpart of pointtinybenchmark_tpu/models/losses/smooth_l1_loss.py::
L1Loss, SmoothL1Loss and BalancedL1Loss (Libra R-CNN), each in the JAX
function's form.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .utils import weight_reduce_loss

__all__ = ["L1Loss", "SmoothL1Loss", "BalancedL1Loss"]


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


class BalancedL1Loss:
    """a / b (b|x| + 1) log1p(b|x| / beta) - a|x| below beta, else
    g|x| + g / b - a beta, with b = e^(g / a) - 1; weighted, summed, and
    divided by max(avg_factor, 1) where one is given (JAX's form, which
    takes no `reduction`). Its gradient is JAX's, also at x = 0."""

    def __init__(self, alpha: float = 0.5, gamma: float = 1.5,
                 beta: float = 1.0, loss_weight: float = 1.0):
        self.alpha = alpha
        self.gamma = gamma
        self.beta = beta
        self.loss_weight = loss_weight

    def __call__(self, pred: torch.Tensor, target: torch.Tensor,
                 weight: Optional[torch.Tensor] = None,
                 avg_factor=None) -> torch.Tensor:
        a, g, beta = self.alpha, self.gamma, self.beta
        b = math.e ** (g / a) - 1
        x = pred - target
        # |x| with jnp.abs's gradient, +1 at 0 (torch's abs gives 0 there)
        diff = torch.where(x >= 0, x, -x)
        loss = torch.where(
            diff < beta,
            a / b * (b * diff + 1) * torch.log1p(b * diff / beta) - a * diff,
            g * diff + g / b - a * beta)
        if weight is not None:
            loss = loss * weight
        loss = loss.sum()
        if avg_factor is not None:
            loss = loss / torch.clamp(torch.as_tensor(
                avg_factor, dtype=loss.dtype, device=loss.device), min=1.0)
        return self.loss_weight * loss
