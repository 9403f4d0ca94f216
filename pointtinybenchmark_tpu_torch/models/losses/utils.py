"""Loss weighting and reduction (mmdet models/losses/utils.py).

Counterpart of pointtinybenchmark_tpu/models/losses/utils.py::
weight_reduce_loss: an elementwise weight, then the mean, sum or nothing;
with `avg_factor` the mean is the sum over max(avg_factor, 1e-12); and
`accuracy`, top-1 in percent over the rows a mask keeps.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["reduce_loss", "weight_reduce_loss", "accuracy"]


def reduce_loss(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "none":
        return loss
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    raise ValueError(f"reduction {reduction!r}")


def weight_reduce_loss(loss: torch.Tensor,
                       weight: Optional[torch.Tensor] = None,
                       reduction: str = "mean",
                       avg_factor: Optional[Union[float, torch.Tensor]] = None
                       ) -> torch.Tensor:
    if weight is not None:
        loss = loss * weight
    if avg_factor is None:
        return reduce_loss(loss, reduction)
    if reduction == "mean":
        return loss.sum() / torch.clamp(torch.as_tensor(
            avg_factor, dtype=loss.dtype, device=loss.device), min=1e-12)
    if reduction == "none":
        return loss
    raise ValueError("avg_factor can not be used with reduction='sum'")


def accuracy(pred: torch.Tensor, target: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Top-1 accuracy in percent: pred (N, C) scores, target (N,) labels;
    with `mask` (N,) over the rows it keeps (0 when it keeps none)."""
    correct = (pred.argmax(-1) == target).to(torch.float32)
    if mask is not None:
        m = mask.to(torch.float32)
        return (correct * m).sum() / m.sum().clamp(min=1.0) * 100.0
    return correct.mean() * 100.0
