"""Sigmoid focal loss (mmdet focal_loss.py), plain PyTorch.

Counterpart of pointtinybenchmark_tpu/models/losses/focal_loss.py
(`sigmoid_focal_loss`, `FocalLoss`), which is plain jnp too: no kernel.
The operations keep JAX's order: the focal weight (alpha t + (1 - alpha)
(1 - t)) pt ** gamma, the stable binary cross-entropy with logits
max(x, 0) - x t + log1p(exp(-|x|)), their product. The target is an
integer label, where label C (background) is the all-zero one-hot row over
the C foreground logits.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .cross_entropy_loss import binary_cross_entropy_with_logits
from .utils import weight_reduce_loss

__all__ = ["sigmoid_focal_loss", "FocalLoss"]


def sigmoid_focal_loss(pred: torch.Tensor, target_onehot: torch.Tensor,
                       gamma: float = 2.0, alpha: float = 0.25
                       ) -> torch.Tensor:
    """Elementwise focal loss on logits; pred and target (..., C)."""
    p = torch.sigmoid(pred)
    t = target_onehot.to(pred.dtype)
    pt = (1 - p) * t + p * (1 - t)
    focal_weight = (alpha * t + (1 - alpha) * (1 - t)) * pt ** gamma
    return binary_cross_entropy_with_logits(pred, t) * focal_weight


class FocalLoss:

    def __init__(self, use_sigmoid: bool = True, gamma: float = 2.0,
                 alpha: float = 0.25, reduction: str = "mean",
                 loss_weight: float = 1.0):
        if not use_sigmoid:
            raise NotImplementedError("only the sigmoid focal loss is ported")
        self.gamma = gamma
        self.alpha = alpha
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred: torch.Tensor, target: torch.Tensor,
                 weight: Optional[torch.Tensor] = None,
                 avg_factor=None) -> torch.Tensor:
        """pred (N, C) logits; target (N,) labels in [0, C], C the
        background; a 1-d weight weighs each row."""
        # label C (background) gives the all-zero row
        onehot = F.one_hot(target.long(), pred.shape[-1] + 1)[..., :-1]
        loss = sigmoid_focal_loss(pred, onehot, self.gamma, self.alpha)
        if weight is not None and weight.dim() == 1:
            weight = weight[:, None]
        loss = weight_reduce_loss(loss, weight, self.reduction, avg_factor)
        return self.loss_weight * loss
