"""IoU-family regression losses (mmdet models/losses/iou_loss.py).

Counterpart of pointtinybenchmark_tpu/models/losses/iou_loss.py::IoULoss
and GIoULoss: IoULoss takes -log of the IoU clipped to `eps` (mmdet's
default linear=False), GIoULoss 1 - GIoU; a weight of the prediction's
rank is averaged over its last axis first.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...ops.iou import bbox_overlaps_aligned
from .utils import weight_reduce_loss

__all__ = ["IoULoss", "GIoULoss"]


def _weighted(loss: torch.Tensor, pred: torch.Tensor,
              weight: Optional[torch.Tensor], reduction: str,
              avg_factor) -> torch.Tensor:
    if weight is not None and weight.dim() == pred.dim():
        weight = weight.mean(-1)
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


class IoULoss:

    def __init__(self, linear: bool = False, eps: float = 1e-6,
                 reduction: str = "mean", loss_weight: float = 1.0):
        self.linear = linear
        self.eps = eps
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred: torch.Tensor, target: torch.Tensor,
                 weight: Optional[torch.Tensor] = None,
                 avg_factor=None) -> torch.Tensor:
        ious = bbox_overlaps_aligned(pred, target, eps=self.eps).clamp(
            min=self.eps)
        loss = 1 - ious if self.linear else -torch.log(ious)
        return self.loss_weight * _weighted(loss, pred, weight,
                                            self.reduction, avg_factor)


class GIoULoss:

    def __init__(self, eps: float = 1e-7, reduction: str = "mean",
                 loss_weight: float = 1.0):
        self.eps = eps
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred: torch.Tensor, target: torch.Tensor,
                 weight: Optional[torch.Tensor] = None,
                 avg_factor=None) -> torch.Tensor:
        loss = 1 - bbox_overlaps_aligned(pred, target, mode="giou",
                                         eps=self.eps)
        return self.loss_weight * _weighted(loss, pred, weight,
                                            self.reduction, avg_factor)
