"""Multi-instance-learning bag loss of CPR (the fork's MILLoss).

Counterpart of pointtinybenchmark_tpu/models/losses/mil_loss.py::MILLoss:
a bag's probability is the sum over its points of the class probability
times the instance attention, a softmax over the bag's valid points; it
is scored with the generalized focal term
-(p - q)^2 [q log(p + eps) + (1 - q) log(1 - p + eps)] and averaged over
the bags with at least one valid point. The masked softmax sets padded
points to float32's lowest value, then to 0 after the softmax, and divides
by max(sum, 1e-12): a bag with no valid point has a zero probability, a
zero loss and a zero gradient, never NaN. The binary instance branch
(`binary_ins`) and the cross-entropy `loss_type`, which no config sets,
are not ported and raise.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .utils import accuracy

__all__ = ["MILLoss", "masked_softmax"]


def masked_softmax(x: torch.Tensor, mask: torch.Tensor,
                   dim: int) -> torch.Tensor:
    neg = torch.finfo(x.dtype).min
    x = torch.where(mask, x, neg)
    y = torch.softmax(x, dim=dim)
    y = torch.where(mask, y, 0.0)
    denom = y.sum(dim=dim, keepdim=True)
    return y / denom.clamp(min=1e-12)


class MILLoss:

    def __init__(self, binary_ins: bool = False, loss_weight: float = 1.0,
                 eps: float = 1e-6, loss_type: str = "gfocal_loss"):
        if binary_ins or loss_type != "gfocal_loss":
            raise NotImplementedError(
                f"MILLoss binary_ins={binary_ins}, loss_type={loss_type!r} "
                f"(False and 'gfocal_loss' are ported)")
        self.loss_weight = loss_weight
        self.eps = eps

    def gfocal_loss(self, p: torch.Tensor, q: torch.Tensor,
                    w=1.0) -> torch.Tensor:
        l1 = (p - q) ** 2
        l2 = q * torch.log(p + self.eps) + (1 - q) * torch.log(
            1 - p + self.eps)
        return -(l1 * l2 * w).sum(-1)

    def __call__(self, bag_cls_prob: torch.Tensor, bag_ins_outs: torch.Tensor,
                 labels: torch.Tensor, valid: torch.Tensor,
                 weight: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """bag_cls_prob (B, N, C) per point; bag_ins_outs (B, N, C) raw
        attention scores; labels (B,) the bags' classes; valid (B, N, 1) or
        (B, N, C) mask or weights. Returns (loss, accuracy, number of
        non-empty bags)."""
        c = bag_cls_prob.shape[-1]
        vmask = (valid != 0).expand(bag_ins_outs.shape)
        prob_ins = masked_softmax(bag_ins_outs, vmask, dim=1)
        prob = (bag_cls_prob * prob_ins).sum(dim=1)           # (B, C)
        label_weights = (valid.sum(dim=1) > 0).to(torch.float32)
        bag_ok = label_weights.sum(-1) > 0
        acc = accuracy(prob, labels, mask=bag_ok)
        onehot = (labels.long()[:, None] == torch.arange(
            c, device=labels.device)).to(torch.float32)
        num_sample = bag_ok.to(torch.float32).sum().clamp(min=1.0)
        loss = self.gfocal_loss(prob, onehot, label_weights)
        if weight is not None:
            loss = loss * weight
        loss = loss.sum() / num_sample * self.loss_weight
        return loss, acc, num_sample
