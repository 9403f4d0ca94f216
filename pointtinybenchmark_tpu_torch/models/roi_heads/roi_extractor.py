"""Multi-level RoI feature extraction (mmdet SingleRoIExtractor).

Counterpart of pointtinybenchmark_tpu/models/roi_heads/roi_extractor.py
(`map_roi_levels`, `single_roi_extract`): each roi is assigned to an FPN
level by floor(log2(sqrt(area) / finest_scale + 1e-6)), clamped to the
level range, and RoIAligned from that level in one call
(ops/roi_align.py::roi_align_multilevel: the CUDA kernel on the card). The
JAX package's `use_pallas` switch has no counterpart: a CUDA tensor always
goes to the kernel.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ...ops.roi_align import roi_align_multilevel

__all__ = ["map_roi_levels", "single_roi_extract"]


def map_roi_levels(rois: torch.Tensor, num_levels: int,
                   finest_scale: float = 56.0) -> torch.Tensor:
    """rois (R, 5) -> (R,) int64 level index."""
    w = rois[:, 3] - rois[:, 1]
    h = rois[:, 4] - rois[:, 2]
    scale = torch.sqrt((w * h).clamp(min=0))
    lvl = torch.floor(torch.log2(scale / finest_scale + 1e-6))
    return lvl.clamp(0, num_levels - 1).long()


def single_roi_extract(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                       featmap_strides: Sequence[int], output_size: int = 7,
                       sampling_ratio: int = 2, finest_scale: float = 56.0,
                       aligned: bool = True) -> torch.Tensor:
    """feats: per-level (B, C, H, W); rois (R, 5) -> (R, C, S, S)."""
    lvls = map_roi_levels(rois, len(featmap_strides), finest_scale)
    return roi_align_multilevel(tuple(feats), rois, lvls,
                                tuple(featmap_strides), output_size,
                                sampling_ratio, aligned)
