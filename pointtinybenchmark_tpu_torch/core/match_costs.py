"""Match costs of the point matcher (HungarianAssignerV2), batched.

Counterpart of pointtinybenchmark_tpu/core/match_costs.py: `FocalLossCost`,
the fork's `DisCostV2` (p-norm distance between predicted and gt points,
optionally normalised by the image's width and height) and `ZeroCost`, in
the JAX package's operation order. Each takes a leading batch axis: costs
are (B, N, G), predictions x gts; invalid gt columns are masked by the
assigner, not here. The box costs (BBoxL1Cost, IoUCost) are not ported.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["FocalLossCost", "DisCostV2", "ZeroCost", "build_match_cost",
           "MATCH_COSTS"]


class FocalLossCost:

    def __init__(self, weight: float = 1.0, alpha: float = 0.25,
                 gamma: float = 2.0, eps: float = 1e-12):
        self.weight = weight
        self.alpha = alpha
        self.gamma = gamma
        self.eps = eps

    def __call__(self, cls_pred: torch.Tensor,
                 gt_labels: torch.Tensor) -> torch.Tensor:
        """cls_pred (B, N, C) logits, gt_labels (B, G) -> (B, N, G)."""
        p = torch.sigmoid(cls_pred)
        neg_cost = (-torch.log1p(-(p - self.eps)) * (1 - self.alpha)
                    * p ** self.gamma)
        pos_cost = (-torch.log(p + self.eps) * self.alpha
                    * (1 - p) ** self.gamma)
        b, n, c = cls_pred.shape
        gl = gt_labels.long().clamp(0, c - 1)[:, None, :].expand(
            b, n, gt_labels.shape[1])
        cost = pos_cost.gather(2, gl) - neg_cost.gather(2, gl)
        return cost * self.weight


class DisCostV2:

    def __init__(self, weight: float = 1.0, norm_with_img_wh: bool = True,
                 p: int = 1):
        self.weight = weight
        self.norm_with_img_wh = norm_with_img_wh
        self.p = p

    def __call__(self, bbox_pred: torch.Tensor, gt_bboxes: torch.Tensor,
                 img_shape: Optional[torch.Tensor] = None) -> torch.Tensor:
        """bbox_pred (B, N, 2k) and gt_bboxes (B, G, 2k) points; img_shape
        (B, 2+) [h, w] when normalising -> (B, N, G)."""
        pred, gt = bbox_pred, gt_bboxes
        if self.norm_with_img_wh:
            k = bbox_pred.shape[-1] // 2
            wh = img_shape[:, [1, 0]].to(bbox_pred.dtype)
            factor = wh.repeat(1, k)[:, None, :]
            pred = pred / factor
            gt = gt / factor
        diff = (pred[:, :, None, :] - gt[:, None, :, :]).abs()
        if self.p == 1:
            cost = diff.sum(-1)
        elif self.p == 2:
            cost = torch.sqrt((diff * diff).sum(-1) + 1e-12)
        else:
            cost = (diff ** self.p).sum(-1) ** (1.0 / self.p)
        return cost * self.weight


class ZeroCost:

    def __init__(self, weight: float = 0.0):
        self.weight = weight

    def __call__(self, *args, **kwargs) -> float:
        return 0.0


MATCH_COSTS = {"FocalLossCost": FocalLossCost, "DisCostV2": DisCostV2,
               "ZeroCost": ZeroCost}


def build_match_cost(cfg: dict):
    args = dict(cfg)
    kind = args.pop("type")
    if kind not in MATCH_COSTS:
        raise KeyError(f"match cost {kind} is not ported: "
                       f"{sorted(MATCH_COSTS)}")
    return MATCH_COSTS[kind](**args)
