"""DeltaXYWH box coding (mmdet delta_xywh_bbox_coder.py: bbox2delta,
delta2bbox) and the point-distance decode of the anchor-free heads
(distance2bbox).

Counterpart of pointtinybenchmark_tpu/core/bbox.py::bbox2delta, delta2bbox,
distance2bbox and `delta_coder_fns`, in the same operation order.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

__all__ = ["bbox2delta", "delta2bbox", "delta_coder_fns", "distance2bbox"]


def bbox2delta(proposals: torch.Tensor, gt: torch.Tensor,
               means: Sequence[float] = (0., 0., 0., 0.),
               stds: Sequence[float] = (1., 1., 1., 1.)) -> torch.Tensor:
    """(dx, dy, dw, dh) that take (..., 4) xyxy proposals to the gt boxes,
    normalised by `means` and `stds`; widths and heights are floored at
    1e-6."""
    px = (proposals[..., 0] + proposals[..., 2]) * 0.5
    py = (proposals[..., 1] + proposals[..., 3]) * 0.5
    pw = proposals[..., 2] - proposals[..., 0]
    ph = proposals[..., 3] - proposals[..., 1]
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    pw = pw.clamp(min=1e-6)
    ph = ph.clamp(min=1e-6)
    dx = (gx - px) / pw
    dy = (gy - py) / ph
    dw = torch.log(gw.clamp(min=1e-6) / pw)
    dh = torch.log(gh.clamp(min=1e-6) / ph)
    deltas = torch.stack([dx, dy, dw, dh], dim=-1)
    return (deltas - deltas.new_tensor(means)) / deltas.new_tensor(stds)


def delta2bbox(rois: torch.Tensor, deltas: torch.Tensor,
               means: Sequence[float] = (0., 0., 0., 0.),
               stds: Sequence[float] = (1., 1., 1., 1.),
               max_shape: Optional[Tuple[int, int]] = None,
               wh_ratio_clip: float = 16 / 1000) -> torch.Tensor:
    """Apply (dx, dy, dw, dh) deltas to (..., 4) xyxy rois; dw and dh are
    clamped to |log(wh_ratio_clip)|."""
    means = deltas.new_tensor(means)
    stds = deltas.new_tensor(stds)
    d = deltas * stds + means
    dx, dy, dw, dh = d.unbind(-1)
    max_ratio = abs(math.log(wh_ratio_clip))
    dw = dw.clamp(-max_ratio, max_ratio)
    dh = dh.clamp(-max_ratio, max_ratio)
    px = (rois[..., 0] + rois[..., 2]) * 0.5
    py = (rois[..., 1] + rois[..., 3]) * 0.5
    pw = rois[..., 2] - rois[..., 0]
    ph = rois[..., 3] - rois[..., 1]
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    gx = px + pw * dx
    gy = py + ph * dy
    x1 = gx - gw * 0.5
    y1 = gy - gh * 0.5
    x2 = gx + gw * 0.5
    y2 = gy + gh * 0.5
    if max_shape is not None:
        x1 = x1.clamp(0, max_shape[1])
        y1 = y1.clamp(0, max_shape[0])
        x2 = x2.clamp(0, max_shape[1])
        y2 = y2.clamp(0, max_shape[0])
    return torch.stack([x1, y1, x2, y2], dim=-1)


def distance2bbox(points: torch.Tensor, distance: torch.Tensor,
                  max_shape: Optional[Tuple[int, int]] = None
                  ) -> torch.Tensor:
    """(..., 2) points and (..., 4) (left, top, right, bottom) distances ->
    (..., 4) xyxy boxes, clipped to `max_shape` (h, w) if given."""
    x1 = points[..., 0] - distance[..., 0]
    y1 = points[..., 1] - distance[..., 1]
    x2 = points[..., 0] + distance[..., 2]
    y2 = points[..., 1] + distance[..., 3]
    if max_shape is not None:
        x1 = x1.clamp(0, max_shape[1])
        y1 = y1.clamp(0, max_shape[0])
        x2 = x2.clamp(0, max_shape[1])
        y2 = y2.clamp(0, max_shape[0])
    return torch.stack([x1, y1, x2, y2], dim=-1)


def delta_coder_fns(coder_cfg: Optional[dict]):
    """(encode, decode) for a bbox_coder config. Only DeltaXYWHBBoxCoder is
    ported; the MMDet V1.x legacy coder raises."""
    kind = (coder_cfg or {}).get("type", "DeltaXYWHBBoxCoder")
    if kind != "DeltaXYWHBBoxCoder":
        raise NotImplementedError(f"bbox coder {kind} is not ported")
    return bbox2delta, delta2bbox

