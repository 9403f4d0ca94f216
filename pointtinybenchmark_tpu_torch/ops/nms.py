"""Exact greedy NMS, batched, on the IoU-bitmask kernel pair.

Counterpart of pointtinybenchmark_tpu/ops/nms.py. The JAX package routes
between a pick-loop, a Jacobi fixpoint and two blocked variants to suit XLA
on a TPU; all of them compute the sequential greedy keep set over boxes
sorted by descending score, ties to the lower index. Here one path serves
every size: a stable sort, the suppression bitmask (`nms_cuda.iou_bitmask`,
the port of the Pallas `iou_suppression_matrix`) and the greedy walk over it
(`nms_cuda.greedy_reduce`). One call covers a whole batch: the per-tile NMS
of all tiles, or the global merge of all frames.

Boxes are (N, 4) or (B, N, 4); every output gains or drops the batch axis
with them. Results are `(keep_idx, num_kept)`: keep_idx holds indices into
the input in pick order, padded with -1 to `max_out`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import nms_cuda

__all__ = ["nms", "batched_nms", "NEG_INF"]

NEG_INF = -1e30


def _masked_scores(scores: torch.Tensor, valid_mask: Optional[torch.Tensor],
                   score_threshold: float) -> torch.Tensor:
    scores = scores.float()
    if valid_mask is not None:
        scores = torch.where(valid_mask, scores, NEG_INF)
    return torch.where(scores > score_threshold, scores, NEG_INF)


def _sort(boxes: torch.Tensor, scores: torch.Tensor):
    """boxes (B, N, 4), masked scores (B, N) -> sorted boxes (B, N, 4) f32,
    ok (B, N) bool, order (B, N) int64, n_valid (B,) int32. The masked
    scores hold no NaN and ok is `score > NEG_INF` of the sort key, so the
    ok rows are the first n_valid of the descending order."""
    # stable: equal scores keep index order, as jnp.argsort / lax.top_k do
    sorted_scores, order = torch.sort(scores, dim=-1, descending=True,
                                      stable=True)
    sorted_boxes = torch.gather(boxes.float(), 1,
                                order[..., None].expand(-1, -1, 4))
    ok = sorted_scores > NEG_INF
    return (sorted_boxes.contiguous(), ok, order,
            ok.sum(1, dtype=torch.int32))


def _greedy(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
            max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """boxes (B, N, 4), masked scores (B, N) -> keep (B, max_out), (B,)."""
    sorted_boxes, ok, order, n_valid = _sort(boxes, scores)
    mask = nms_cuda.iou_bitmask(sorted_boxes, iou_threshold, n_valid)
    return nms_cuda.greedy_reduce(mask, ok, order.to(torch.int32), max_out,
                                  n_valid)


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        max_out: int, valid_mask: Optional[torch.Tensor] = None,
        score_threshold: float = float("-inf")
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS. Rows where `valid_mask` is False, or whose score is at
    or below `score_threshold`, are neither kept nor suppress."""
    single = boxes.dim() == 2
    if single:
        boxes, scores = boxes[None], scores[None]
        valid_mask = None if valid_mask is None else valid_mask[None]
    keep, num = _greedy(boxes, _masked_scores(scores, valid_mask,
                                              score_threshold),
                        iou_threshold, max_out)
    return (keep[0], num[0]) if single else (keep, num)


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor, idxs: torch.Tensor,
                iou_threshold: float, max_out: int,
                valid_mask: Optional[torch.Tensor] = None,
                score_threshold: float = float("-inf")
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-aware NMS by the coordinate-offset trick (mmcv batched_nms):
    boxes of different `idxs` never suppress each other. Serves both JAX
    entry points, `batched_nms` and `batched_nms_large`. The offset is the
    largest finite coordinate of each batch item plus one, taken over all
    rows, padded ones included, as in the JAX package."""
    return nms(_offset_boxes(boxes, idxs), scores, iou_threshold, max_out,
               valid_mask, score_threshold)


def _offset_boxes(boxes: torch.Tensor, idxs: torch.Tensor) -> torch.Tensor:
    finite = torch.where(torch.isfinite(boxes), boxes, 0.0)
    max_coord = finite.amax(dim=(-2, -1), keepdim=True) + 1.0
    return boxes + idxs.to(boxes.dtype)[..., None] * max_coord
