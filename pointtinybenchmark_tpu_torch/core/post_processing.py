"""Static-shape multiclass NMS, batched over images or tiles.

Counterpart of pointtinybenchmark_tpu/core/post_processing.py (mmdet
bbox_nms.py::multiclass_nms): per-class score threshold, optional score
factors, a static cap on the candidates handed to NMS, class-aware NMS and
a max_per_img cap, with fixed-size outputs and a validity mask. The JAX
function handles one image under vmap; this one takes the batch axis and
runs one NMS launch for all of it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.nms import batched_nms

__all__ = ["multiclass_nms", "DetResult"]


class DetResult(NamedTuple):
    bboxes: torch.Tensor   # (B, max_per_img, 5): x1, y1, x2, y2, score
    labels: torch.Tensor   # (B, max_per_img) int32, -1 where not valid
    valid: torch.Tensor    # (B, max_per_img) bool


def multiclass_nms(multi_bboxes: torch.Tensor,
                   multi_scores: torch.Tensor,
                   score_thr: float,
                   iou_threshold: float,
                   max_per_img: int,
                   valid_mask: Optional[torch.Tensor] = None,
                   pre_nms_limit: int = 20000,
                   score_factors: Optional[torch.Tensor] = None) -> DetResult:
    """
    Args:
        multi_bboxes: (B, N, 4) class-agnostic or (B, N, C*4).
        multi_scores: (B, N, C+1); the last column is background (dropped).
        score_thr: drop candidates at or below this score.
        iou_threshold: NMS IoU threshold.
        max_per_img: static output size.
        valid_mask: (B, N) bool for padded rows.
        pre_nms_limit: cap on the N*C flattened candidates handed to NMS:
            the top `pre_nms_limit` by score, ties to the lower index (as
            lax.top_k), invalid ones last.
        score_factors: (B, N) multiplier (centerness, objectness) applied
            after the score threshold, as mmdet's bbox_nms.py does; the
            output score is the product.
    """
    b, n = multi_scores.shape[:2]
    num_classes = multi_scores.shape[2] - 1
    scores = multi_scores[..., :num_classes]
    if multi_bboxes.shape[-1] == 4:
        boxes = multi_bboxes[:, :, None, :].expand(b, n, num_classes, 4)
    else:
        boxes = multi_bboxes.reshape(b, n, num_classes, 4)

    flat_scores = scores.reshape(b, -1)
    flat_boxes = boxes.reshape(b, -1, 4)
    flat_labels = torch.arange(num_classes, dtype=torch.int32,
                               device=scores.device).repeat(n).expand(b, -1)
    ok = flat_scores > score_thr
    if valid_mask is not None:
        ok = ok & valid_mask.repeat_interleave(num_classes, dim=1)
    if score_factors is not None:
        flat_scores = flat_scores * score_factors.repeat_interleave(
            num_classes, dim=1)
    flat_scores = torch.where(ok, flat_scores, -1.0)

    k = pre_nms_limit
    if k < flat_scores.shape[1]:
        # a stable descending sort, then the first k: lax.top_k's order
        # (torch.topk leaves the order of ties unspecified)
        flat_scores, idx = torch.sort(flat_scores, dim=1, descending=True,
                                      stable=True)
        flat_scores, idx = flat_scores[:, :k], idx[:, :k]
        flat_boxes = flat_boxes.gather(1, idx[..., None].expand(-1, -1, 4))
        flat_labels = flat_labels.gather(1, idx)
        ok = ok.gather(1, idx)

    keep_idx, _ = batched_nms(flat_boxes, flat_scores, flat_labels,
                              iou_threshold, max_per_img, valid_mask=ok)
    out_valid = keep_idx >= 0
    safe = keep_idx.clamp(min=0).long()
    out_boxes = flat_boxes.gather(1, safe[..., None].expand(-1, -1, 4))
    out_scores = torch.where(out_valid, flat_scores.gather(1, safe), 0.0)
    out_labels = torch.where(out_valid, flat_labels.gather(1, safe), -1)
    dets = torch.cat([out_boxes, out_scores[..., None]], dim=-1)
    dets = torch.where(out_valid[..., None], dets, 0.0)
    return DetResult(dets, out_labels, out_valid)
