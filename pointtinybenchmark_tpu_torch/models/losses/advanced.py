"""Varifocal loss (mmdet models/losses/varifocal_loss.py).

Counterpart of pointtinybenchmark_tpu/models/losses/advanced.py::
_bce_with_logits and ::VarifocalLoss, plain jnp there too: the target is
the IoU-aware classification score (0 on negatives); a positive (target
> 0) weighs its binary cross-entropy by the target (`iou_weighted`) or 1,
a negative by alpha |sigmoid(x) - t| ** gamma; the sum over
max(avg_factor, 1). The operations keep JAX's order, and the binary
cross-entropy and |.| are cross_entropy_loss.py's, with JAX's derivatives
at 0. The file's GHMC, GHMR and distillation losses are not ported
(ROADMAP.md queue 3, M8).
"""
from __future__ import annotations

from typing import Optional

import torch

from .cross_entropy_loss import binary_cross_entropy_with_logits, jax_abs

__all__ = ["VarifocalLoss"]


class VarifocalLoss:

    def __init__(self, use_sigmoid: bool = True, alpha: float = 0.75,
                 gamma: float = 2.0, iou_weighted: bool = True,
                 loss_weight: float = 1.0):
        if not use_sigmoid:
            raise NotImplementedError("only the sigmoid varifocal loss is "
                                      "ported (as in the JAX package)")
        self.alpha = alpha
        self.gamma = gamma
        self.iou_weighted = iou_weighted
        self.loss_weight = loss_weight

    def __call__(self, pred: torch.Tensor, target: torch.Tensor,
                 weight: Optional[torch.Tensor] = None,
                 avg_factor=None) -> torch.Tensor:
        """pred (N, C) logits, target (N, C) scores in [0, 1]; `weight`
        broadcasts against them."""
        p = torch.sigmoid(pred)
        pos = (target > 0.0).to(pred.dtype)
        neg_w = self.alpha * jax_abs(p - target) ** self.gamma * (1 - pos)
        focal_w = (target * pos if self.iou_weighted else pos) + neg_w
        loss = binary_cross_entropy_with_logits(pred, target) * focal_w
        if weight is not None:
            loss = loss * weight
        loss = loss.sum()
        if avg_factor is not None:
            loss = loss / torch.clamp(torch.as_tensor(
                avg_factor, dtype=loss.dtype, device=loss.device), min=1.0)
        return self.loss_weight * loss
