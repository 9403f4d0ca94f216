"""MaxIoUAssigner (mmdet max_iou_assigner.py) and the point matcher
HungarianAssignerV2 with its top-k auction, batched, static shapes.

Counterpart of pointtinybenchmark_tpu/core/assigners.py::MaxIoUAssigner,
`_auction_round`, `topk_auction_match` and HungarianAssignerV2.
The JAX assigner runs one image under vmap; this one takes a batch of
images at once: boxes (N, 4) shared by every image (anchors) or (B, N, 4)
per image (proposals), gts padded to (B, G, 4) with a validity mask.
Padded gt columns count as overlap 0, so a box that meets no real gt is a
negative (the reference's num_gt == 0 case). Low-quality matches give each
gt the boxes that reach its best overlap; a box that is such a match for
several gts takes the largest gt index, as the reference's in-order loop
leaves it. Boxes whose IoF with a valid ignore region exceeds
`ignore_iof_thr`, and boxes marked not valid, are ignored. Only the
ported configs' form is taken: a single negative threshold, and
low-quality matches to every box that reaches a gt's best overlap
(gt_max_assign_all).

Encoding (mmdet): -1 ignore, 0 negative, j >= 1 matched to gt j - 1.

The auction (`topk_auction_match`) is the JAX package's reverse auction,
operation for operation, so that it picks the same predictions: scipy's
assignment breaks the ties of a top-k > 1 matching otherwise. The images
of a batch run as one (B, G, N) problem, each with its own value range and
eps. An image whose valid gts are all assigned makes no bid, so its
iterations change nothing; the loop therefore reads the convergence back
to the host only every AUCTION_CHECK_EVERY iterations and stops at the
first check after every image has converged, or at max_iters exactly.
`auction_stats` counts the iterations run and those host reads.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.iou import bbox_overlaps
from .match_costs import build_match_cost

__all__ = ["MaxIoUAssigner", "HungarianAssignerV2", "topk_auction_match",
           "auction_stats"]

NEG = -1e9                 # benefit of a taken or invalid pair
BIG = 1e8                  # cost of an invalid gt column
AUCTION_CHECK_EVERY = 8    # iterations between host reads of convergence
auction_stats: Dict[str, int] = {"rounds": 0, "iterations": 0, "syncs": 0}


class MaxIoUAssigner:

    def __init__(self, pos_iou_thr: float, neg_iou_thr: float,
                 min_pos_iou: float = 0.0, gt_max_assign_all: bool = True,
                 ignore_iof_thr: float = -1.0,
                 match_low_quality: bool = True):
        if not gt_max_assign_all or not isinstance(neg_iou_thr,
                                                   (int, float)):
            raise NotImplementedError(
                "gt_max_assign_all=False and a (lo, hi) neg_iou_thr are not "
                "ported")
        self.pos_iou_thr = pos_iou_thr
        self.neg_iou_thr = neg_iou_thr
        self.min_pos_iou = min_pos_iou
        self.ignore_iof_thr = ignore_iof_thr
        self.match_low_quality = match_low_quality

    def assign(self, bboxes: torch.Tensor, gt_bboxes: torch.Tensor,
               gt_valid: torch.Tensor,
               gt_labels: Optional[torch.Tensor] = None,
               gt_bboxes_ignore: Optional[torch.Tensor] = None,
               gt_ignore_valid: Optional[torch.Tensor] = None,
               bbox_valid: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """bboxes (N, 4) or (B, N, 4); gt_bboxes (B, G, 4), gt_valid (B, G)
        bool, gt_labels (B, G); ignore regions (B, GI, 4) with (B, GI)
        validity; bbox_valid (N,) or (B, N) bool. Returns the assignment
        (B, N) int64, each box's max overlap (B, N) and its label (B, N)
        int64 (-1 where not positive)."""
        b = gt_bboxes.shape[0]
        if bboxes.dim() == 2:
            bboxes = bboxes.expand(b, -1, -1)
        n = bboxes.shape[1]
        overlaps = bbox_overlaps(bboxes, gt_bboxes)            # (B, N, G)
        overlaps = torch.where(gt_valid[:, None, :], overlaps, 0.0)
        max_overlaps = overlaps.amax(-1)
        argmax = overlaps.argmax(-1)     # the first maximum, as jnp.argmax
        assigned = torch.full((b, n), -1, dtype=torch.int64,
                              device=bboxes.device)
        neg = (max_overlaps >= 0) & (max_overlaps < self.neg_iou_thr)
        assigned = torch.where(neg, 0, assigned)
        assigned = torch.where(max_overlaps >= self.pos_iou_thr, argmax + 1,
                               assigned)

        if self.match_low_quality:
            gt_max = overlaps.amax(1, keepdim=True)             # (B, 1, G)
            cand = ((overlaps == gt_max) & (gt_max >= self.min_pos_iou)
                    & gt_valid[:, None, :] & (overlaps > 0))
            g = overlaps.shape[-1]
            gt_idx1 = torch.arange(1, g + 1, device=bboxes.device)
            lq = torch.where(cand, gt_idx1, 0).amax(-1)         # 0 if none
            assigned = torch.where(lq > 0, lq, assigned)

        if gt_bboxes_ignore is not None and self.ignore_iof_thr > 0:
            iof = bbox_overlaps(bboxes, gt_bboxes_ignore, mode="iof")
            if gt_ignore_valid is not None:
                iof = torch.where(gt_ignore_valid[:, None, :], iof, -1.0)
            ignore = iof.amax(-1) > self.ignore_iof_thr
            assigned = torch.where(ignore, -1, assigned)

        if bbox_valid is not None:
            assigned = torch.where(bbox_valid, assigned, -1)

        if gt_labels is not None:
            safe = (assigned - 1).clamp(0, gt_bboxes.shape[1] - 1)
            labels = torch.where(assigned > 0,
                                 gt_labels.long().gather(1, safe), -1)
        else:
            labels = torch.full_like(assigned, -1)
        return assigned, max_overlaps, labels


def _auction_round(benefit: torch.Tensor, eps: float,
                   max_iters: int) -> torch.Tensor:
    """One one-to-one assignment of every valid gt to a distinct pred, per
    image (JAX `_auction_round`). benefit (B, G, N) float32, NEG where a
    pair is not allowed. Returns owner (B, N) int32, gt index + 1 (0 =
    unowned)."""
    b, g, n = benefit.shape
    dev = benefit.device
    f32 = torch.float32
    inf = torch.tensor(float("inf"), dtype=f32, device=dev)
    valid = benefit > NEG
    row_valid = valid.any(2)                                   # (B, G)
    vmax = torch.where(valid, benefit, -inf).amax((1, 2))
    vmin = torch.where(valid, benefit, inf).amin((1, 2))
    value_range = vmax - vmin
    value_range = torch.where(torch.isfinite(value_range), value_range, 0.0)
    eps_eff = torch.maximum(
        value_range * torch.tensor(np.float32(5e-3 / max(g, 1)), device=dev),
        torch.tensor(np.float32(eps), device=dev))[:, None]    # (B, 1)
    gt_index = torch.arange(g, device=dev).expand(b, g)
    price = torch.zeros((b, n), dtype=f32, device=dev)
    owner = torch.zeros((b, n), dtype=torch.int32, device=dev)
    assigned = torch.zeros((b, g), dtype=torch.bool, device=dev)
    it = 0
    while it < max_iters:
        if it % AUCTION_CHECK_EVERY == 0:
            auction_stats["syncs"] += 1
            if not bool((~assigned & row_valid).any()):
                break
        value = benefit - price[:, None, :]                    # (B, G, N)
        best_idx = value.argmax(2)                   # the first max
        best_val = value.gather(2, best_idx[..., None])[..., 0]
        # the max over all but the argmax: the second of the two largest
        second_val = (value.topk(2, dim=2).values[..., 1] if n > 1
                      else torch.full_like(best_val, -float("inf")))
        bid = best_val - second_val + eps_eff
        bidding = ~assigned & (best_val > NEG)
        bid_amount = torch.where(bidding, bid, -inf)           # (B, G)
        # each pred takes its highest bid, ties to the lowest gt index
        win_bid = torch.full((b, n), -float("inf"), dtype=f32, device=dev)
        win_bid.scatter_reduce_(1, best_idx, bid_amount, "amax")
        top = bid_amount == win_bid.gather(1, best_idx)
        win_gt = torch.full((b, n), g, dtype=torch.int64, device=dev)
        win_gt.scatter_reduce_(1, best_idx, torch.where(top, gt_index, g),
                               "amin")
        has_bid = win_bid > -inf
        owner = torch.where(has_bid, (win_gt + 1).to(torch.int32), owner)
        price = torch.where(has_bid, price + win_bid, price)
        counts = torch.zeros((b, g + 1), dtype=torch.int32, device=dev)
        counts.scatter_add_(1, owner.long(), torch.ones_like(owner))
        assigned = counts[:, 1:] > 0
        it += 1
    auction_stats["iterations"] += it
    # greedy completion (only after the iteration cap): each valid gt left
    # unmatched, in gt order, takes its best still-free valid pred
    auction_stats["syncs"] += 1
    pending = (~assigned & row_valid).nonzero().tolist()
    for bi, gi in pending:
        free = (owner[bi] == 0) & valid[bi, gi]
        if bool(free.any()):
            best = torch.where(free, benefit[bi, gi], -inf).argmax()
            owner[bi, best] = gi + 1
    return owner


def topk_auction_match(cost: torch.Tensor, gt_valid: torch.Tensor,
                       topk_k: int, eps: float = 1e-4,
                       max_iters: int = 20000) -> torch.Tensor:
    """Batched top-k assignment (JAX `topk_auction_match`): `topk_k`
    rounds, each matching every valid gt to one more distinct prediction.
    cost (B, N, G), gt_valid (B, G) bool. Returns assigned (B, N) int32, 0
    background, j + 1 matched to gt j."""
    b, n, g = cost.shape
    gv = gt_valid[:, :, None]
    benefit0 = torch.where(gv, -cost.float().transpose(1, 2), NEG)
    assigned = torch.zeros((b, n), dtype=torch.int32, device=cost.device)
    taken = torch.zeros((b, n), dtype=torch.bool, device=cost.device)
    for _ in range(topk_k):
        benefit = torch.where(taken[:, None, :], NEG, benefit0)
        benefit = torch.where(gv, benefit, NEG)
        owner = _auction_round(benefit, eps, max_iters)
        auction_stats["rounds"] += 1
        newly = (owner > 0) & ~taken
        assigned = torch.where(newly, owner, assigned)
        taken = taken | newly
    return assigned


class HungarianAssignerV2:
    """The fork's one-to-many point matcher (JAX HungarianAssignerV2): the
    cost is the sum of the classification costs and the point costs, and
    an invalid gt column costs BIG. `topk_k` rounds of the auction."""

    def __init__(self, cls_costs: Union[dict, Sequence[dict], None] = None,
                 reg_costs: Union[dict, Sequence[dict], None] = None,
                 topk_k: int = 1):
        if cls_costs is None or reg_costs is None:
            raise NotImplementedError(
                "the default costs (ClassificationCost, BBoxL1Cost, "
                "IoUCost) are not ported: give cls_costs and reg_costs")
        cls_costs = (cls_costs if isinstance(cls_costs, (list, tuple))
                     else [cls_costs])
        reg_costs = (reg_costs if isinstance(reg_costs, (list, tuple))
                     else [reg_costs])
        self.cls_costs = [build_match_cost(c) for c in cls_costs]
        self.reg_costs = [build_match_cost(c) for c in reg_costs]
        self.topk_k = topk_k

    def cost_matrix(self, bbox_pred: torch.Tensor, cls_pred: torch.Tensor,
                    gt_bboxes: torch.Tensor, gt_labels: torch.Tensor,
                    img_shape: torch.Tensor,
                    gt_valid: torch.Tensor) -> torch.Tensor:
        """bbox_pred (B, N, 2k), cls_pred (B, N, C), gt_bboxes (B, G, 2k),
        gt_labels and gt_valid (B, G), img_shape (B, 2) -> (B, N, G)."""
        cost = (sum(c(cls_pred, gt_labels) for c in self.cls_costs)
                + sum(c(bbox_pred, gt_bboxes, img_shape)
                      for c in self.reg_costs))
        return torch.where(gt_valid[:, None, :], cost, BIG)
