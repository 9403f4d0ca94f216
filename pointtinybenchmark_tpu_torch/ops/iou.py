"""Pairwise box overlaps (IoU, IoF), the port's own copy.

Counterpart of pointtinybenchmark_tpu/ops/iou.py::bbox_overlaps (mmdet
iou2d_calculator.py), in the same operation order: boxes are [x1, y1, x2,
y2] with no +1, the union (or, for "iof", the first box's area) is floored
at 1e-6, and the overlap is divided by it. ops/nms.py keeps its own
division form, which is tuned for keep-set equality; this one serves the
assigners. `bbox_overlaps_aligned` is the elementwise form of
pointtinybenchmark_tpu/ops/iou.py::bbox_overlaps_aligned (IoU and GIoU of
box pairs, the IoU losses' form): the union is floored at `eps` before
the division, and for GIoU the enclosing area is floored at `eps` too.
"""
from __future__ import annotations

import torch

__all__ = ["bbox_overlaps", "bbox_overlaps_aligned"]


def bbox_overlaps(bboxes1: torch.Tensor, bboxes2: torch.Tensor,
                  mode: str = "iou") -> torch.Tensor:
    """(..., M, 4) and (..., N, 4) -> (..., M, N) overlaps. `mode` is "iou"
    or "iof" (intersection over the area of bboxes1)."""
    if mode not in ("iou", "iof"):
        raise ValueError(f"mode {mode!r}: only 'iou' and 'iof' are ported")
    area1 = ((bboxes1[..., 2] - bboxes1[..., 0])
             * (bboxes1[..., 3] - bboxes1[..., 1]))
    area2 = ((bboxes2[..., 2] - bboxes2[..., 0])
             * (bboxes2[..., 3] - bboxes2[..., 1]))
    lt = torch.maximum(bboxes1[..., :, None, :2], bboxes2[..., None, :, :2])
    rb = torch.minimum(bboxes1[..., :, None, 2:], bboxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    overlap = wh[..., 0] * wh[..., 1]
    if mode == "iof":
        union = area1[..., :, None]
    else:
        union = area1[..., :, None] + area2[..., None, :] - overlap
    return overlap / union.clamp(min=1e-6)


def bbox_overlaps_aligned(bboxes1: torch.Tensor, bboxes2: torch.Tensor,
                          mode: str = "iou", eps: float = 1e-6
                          ) -> torch.Tensor:
    """Overlaps of aligned box pairs: (..., 4) and (..., 4) of one shape ->
    (...). `mode` is "iou" or "giou"."""
    if mode not in ("iou", "giou"):
        raise ValueError(f"mode {mode!r}: only 'iou' and 'giou' are ported")
    area1 = ((bboxes1[..., 2] - bboxes1[..., 0])
             * (bboxes1[..., 3] - bboxes1[..., 1]))
    area2 = ((bboxes2[..., 2] - bboxes2[..., 0])
             * (bboxes2[..., 3] - bboxes2[..., 1]))
    lt = torch.maximum(bboxes1[..., :2], bboxes2[..., :2])
    rb = torch.minimum(bboxes1[..., 2:], bboxes2[..., 2:])
    wh = (rb - lt).clamp(min=0)
    overlap = wh[..., 0] * wh[..., 1]
    union = (area1 + area2 - overlap).clamp(min=eps)
    ious = overlap / union
    if mode == "iou":
        return ious
    enclosed_lt = torch.minimum(bboxes1[..., :2], bboxes2[..., :2])
    enclosed_rb = torch.maximum(bboxes1[..., 2:], bboxes2[..., 2:])
    enclose_wh = (enclosed_rb - enclosed_lt).clamp(min=0)
    enclose_area = (enclose_wh[..., 0] * enclose_wh[..., 1]).clamp(min=eps)
    return ious - (enclose_area - union) / enclose_area
