"""Varifocal, gradient-harmonized and Seesaw losses (mmdet
models/losses/varifocal_loss.py, ghm_loss.py, seesaw_loss.py).

Counterpart of pointtinybenchmark_tpu/models/losses/advanced.py::
_bce_with_logits, ::VarifocalLoss, ::GHMC, ::GHMR and ::SeesawLoss, plain
jnp there too. VarifocalLoss: the target is
the IoU-aware classification score (0 on negatives); a positive (target
> 0) weighs its binary cross-entropy by the target (`iou_weighted`) or 1,
a negative by alpha |sigmoid(x) - t| ** gamma; the sum over
max(avg_factor, 1). The operations keep JAX's order, and the binary
cross-entropy and |.| are cross_entropy_loss.py's, with JAX's derivatives
at 0.

GHMC and GHMR weigh each valid element by tot / (count of its gradient
norm's bin) / (bins with any element), the histogram of the current batch
(JAX's form: mmdet's momentum statistics across steps are not kept; the
`momentum` key is taken and unused); GHMC on the binary cross-entropy of
(N, C) logits against (N, C) binary targets, GHMR on the authentic smooth
L1 sqrt(d^2 + mu^2) - mu. Both take `label_weight` as their third
argument, JAX's signature: the anchor head's call with `weight=` raises
TypeError in both packages, so the GHM RetinaNet does not train.

SeesawLoss takes (N, C) foreground logits and (N,) labels (label C gives
the all-zero row), class counts from the current batch's labels (plus
`class_counts`, or 1): mitigation min(1, N_j / N_i) ** p and compensation
max(1, s_j / max(s_i, eps)) ** q scale the other classes' exponentials.
Given the RoI head's C + 1 columns it raises JAX's TypeError (JAX
broadcasts (N, C + 1) against (N, C) and fails), so the LVIS Seesaw
config does not train in either package.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .cross_entropy_loss import binary_cross_entropy_with_logits, jax_abs

__all__ = ["GHMC", "GHMR", "SeesawLoss", "VarifocalLoss"]


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


def _ghm_weights(g: torch.Tensor, label_weight: torch.Tensor,
                 bins: int) -> tuple:
    """Each element's GHM weight from its gradient norm g (no gradient)
    and validity, and tot = max(valid elements, 1)."""
    valid = (label_weight > 0).to(g.dtype)
    tot = valid.sum().clamp(min=1.0)
    bin_idx = (g * bins).to(torch.int32).clamp(0, bins - 1).long()
    counts = torch.zeros(bins, dtype=g.dtype, device=g.device).index_add_(
        0, bin_idx.reshape(-1), valid.expand_as(g).reshape(-1))
    n_valid_bins = (counts > 0).sum().to(g.dtype).clamp(min=1.0)
    w = torch.where(counts > 0, tot / counts.clamp(min=1.0), 0.0)
    return w[bin_idx] * valid / n_valid_bins, tot


class GHMC:
    """Gradient-harmonized binary cross-entropy: pred (N, C) logits,
    target (N, C) binary, label_weight (N, C) validity."""

    def __init__(self, bins: int = 10, momentum: float = 0.0,
                 use_sigmoid: bool = True, loss_weight: float = 1.0):
        if not use_sigmoid:
            raise NotImplementedError("only the sigmoid GHMC is ported (as "
                                      "in the JAX package)")
        self.bins = bins
        self.momentum = momentum
        self.loss_weight = loss_weight

    def __call__(self, pred: torch.Tensor, target: torch.Tensor,
                 label_weight: torch.Tensor) -> torch.Tensor:
        target = target.to(pred.dtype)
        g = jax_abs(torch.sigmoid(pred) - target).detach()
        weights, tot = _ghm_weights(g, label_weight, self.bins)
        loss = (binary_cross_entropy_with_logits(pred, target)
                * weights).sum() / tot
        return self.loss_weight * loss


class GHMR:
    """Gradient-harmonized authentic smooth L1: pred and target (..., 4),
    label_weight broadcasting against them."""

    def __init__(self, mu: float = 0.02, bins: int = 10,
                 momentum: float = 0.0, loss_weight: float = 1.0):
        self.mu = mu
        self.bins = bins
        self.momentum = momentum
        self.loss_weight = loss_weight

    def __call__(self, pred: torch.Tensor, target: torch.Tensor,
                 label_weight: torch.Tensor, avg_factor=None) -> torch.Tensor:
        mu = self.mu
        diff = pred - target
        loss = torch.sqrt(diff * diff + mu * mu) - mu
        g = jax_abs(diff / torch.sqrt(mu * mu + diff * diff)).detach()
        weights, tot = _ghm_weights(g, label_weight, self.bins)
        return self.loss_weight * (loss * weights).sum() / tot


class SeesawLoss:
    """Seesaw loss for long-tailed classification: pred (N, C) logits over
    the foreground classes, target (N,) int."""

    def __init__(self, p: float = 0.8, q: float = 2.0,
                 num_classes: int = 1203, eps: float = 1e-2,
                 loss_weight: float = 1.0,
                 class_counts: Optional[Sequence[float]] = None,
                 use_sigmoid: bool = False):
        if use_sigmoid:
            raise NotImplementedError("only the softmax Seesaw loss is "
                                      "ported (as in the JAX package)")
        self.p = p
        self.q = q
        self.num_classes = num_classes
        self.eps = eps
        self.loss_weight = loss_weight
        self.class_counts = class_counts

    def __call__(self, pred: torch.Tensor, target: torch.Tensor,
                 weight: Optional[torch.Tensor] = None,
                 avg_factor=None) -> torch.Tensor:
        c = self.num_classes
        if pred.shape[-1] != c:
            # where JAX's `scores * onehot` fails on the RoI head's C + 1
            raise TypeError(f"mul got incompatible shapes for broadcasting: "
                            f"{tuple(pred.shape)}, {(pred.shape[0], c)}.")
        onehot = (target.long()[:, None] == torch.arange(
            c, device=pred.device)).to(pred.dtype)
        counts = onehot.sum(0) + (
            torch.as_tensor(self.class_counts, dtype=pred.dtype,
                            device=pred.device)
            if self.class_counts is not None else 1.0)
        ratio = counts[None, :] / counts[:, None].clamp(min=1.0)
        mitigation = torch.minimum(ratio, ratio.new_ones(())) ** self.p
        scores = torch.softmax(pred, -1)
        s_gt = (scores * onehot).sum(-1, keepdim=True)
        comp = torch.maximum(scores / torch.maximum(
            s_gt, s_gt.new_tensor(self.eps)), scores.new_ones(())) ** self.q
        sw = (onehot @ mitigation) * comp
        sw = torch.where(onehot > 0, 1.0, sw)
        adj = pred + torch.log(torch.maximum(sw, sw.new_tensor(1e-8)))
        ll = (adj * onehot).sum(-1) - torch.logsumexp(adj, -1)
        loss = -ll
        if weight is not None:
            loss = loss * weight
        loss = loss.sum()
        if avg_factor is not None:
            loss = loss / torch.clamp(torch.as_tensor(
                avg_factor, dtype=loss.dtype, device=loss.device), min=1.0)
        return self.loss_weight * loss
