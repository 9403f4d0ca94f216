"""Cross-entropy loss, softmax and sigmoid (mmdet cross_entropy_loss.py).

Counterpart of pointtinybenchmark_tpu/models/losses/cross_entropy_loss.py::
CrossEntropyLoss. Softmax: -log_softmax at the label (clipped into range).
Sigmoid: binary cross-entropy with logits, max(x, 0) - x t + log1p(exp(-|x|)),
against the one-hot of the label, where label C (background) is the
all-zero row, summed over the classes. At the kink x = 0 the gradient is
JAX's: max is `torch.maximum`, which splits a tie in half as jnp.maximum
does, and |x| is `jax_abs`, whose derivative at 0 is 1 as jnp.abs's
(torch's clamp would give 1 and its abs 0 there). Class weights, the mask
form and soft targets are not ported.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .utils import weight_reduce_loss

__all__ = ["CrossEntropyLoss", "softmax_cross_entropy",
           "binary_cross_entropy_with_logits", "jax_abs"]


def softmax_cross_entropy(pred: torch.Tensor,
                          label: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(pred, dim=-1)
    safe = label.long().clamp(0, pred.shape[-1] - 1)
    return -logp.gather(-1, safe[..., None])[..., 0]


def jax_abs(x: torch.Tensor) -> torch.Tensor:
    """|x| whose derivative at 0 is 1, as jnp.abs's."""
    return torch.where(x >= 0, x, -x)


def binary_cross_entropy_with_logits(pred: torch.Tensor,
                                     target: torch.Tensor) -> torch.Tensor:
    return (torch.maximum(pred, pred.new_zeros(())) - pred * target
            + torch.log1p(torch.exp(-jax_abs(pred))))


class CrossEntropyLoss:

    def __init__(self, use_sigmoid: bool = False, reduction: str = "mean",
                 loss_weight: float = 1.0):
        self.use_sigmoid = use_sigmoid
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred: torch.Tensor, label: torch.Tensor,
                 weight: Optional[torch.Tensor] = None,
                 avg_factor=None) -> torch.Tensor:
        """pred (N, C) logits (C + 1 with the softmax's background), label
        (N,) in [0, C]."""
        if self.use_sigmoid:
            # label C (background) gives the all-zero row
            onehot = F.one_hot(label.long(), pred.shape[-1] + 1)[..., :-1]
            loss = binary_cross_entropy_with_logits(
                pred, onehot.to(pred.dtype)).sum(-1)
        else:
            loss = softmax_cross_entropy(pred, label)
        loss = weight_reduce_loss(loss, weight, self.reduction, avg_factor)
        return self.loss_weight * loss
