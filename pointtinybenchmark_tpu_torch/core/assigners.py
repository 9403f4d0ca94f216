"""MaxIoUAssigner (mmdet max_iou_assigner.py), batched, static shapes.

Counterpart of pointtinybenchmark_tpu/core/assigners.py::MaxIoUAssigner.
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
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.iou import bbox_overlaps

__all__ = ["MaxIoUAssigner"]


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
