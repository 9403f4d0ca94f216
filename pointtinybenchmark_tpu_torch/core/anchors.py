"""Multi-level anchor grids (mmdet v2 AnchorGenerator semantics) and point
grids (mmdet PointGenerator).

Counterpart of pointtinybenchmark_tpu/core/anchors.py::AnchorGenerator and
::PointGenerator, in numpy on the host. Anchors: base anchors centred at
(0, 0) (`center_offset=0`), w/h from base_size * scale * sqrt-ratio,
octave scales `octave_base_scale * 2 ** (i / scales_per_octave)`, and
per-level grids in (H, W, A) order. The tiny-object "Adap" recipe sets
octave_base_scale=2. `LegacyAnchorGenerator` (::LegacyAnchorGenerator,
mmdet V1.x) centres the base anchors at center_offset * (base_size - 1),
takes the corners with the w - 1 convention and rounds them to integers.
Points: (x, y, stride) at the cells' corners.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["AnchorGenerator", "LegacyAnchorGenerator", "PointGenerator"]


class AnchorGenerator:

    def __init__(self,
                 strides: Sequence[int],
                 ratios: Sequence[float],
                 scales: Optional[Sequence[float]] = None,
                 base_sizes: Optional[Sequence[int]] = None,
                 scale_major: bool = True,
                 octave_base_scale: Optional[float] = None,
                 scales_per_octave: Optional[int] = None,
                 center_offset: float = 0.0):
        self.strides = [(s, s) if isinstance(s, int) else tuple(s)
                        for s in strides]
        self.base_sizes = (list(base_sizes) if base_sizes is not None
                           else [min(s) for s in self.strides])
        if scales is not None:
            self.scales = np.asarray(scales, np.float32)
        elif octave_base_scale is not None and scales_per_octave is not None:
            octave = 2 ** (np.arange(scales_per_octave) / scales_per_octave)
            self.scales = (octave * octave_base_scale).astype(np.float32)
        else:
            raise ValueError("give scales, or octave_base_scale and "
                             "scales_per_octave")
        self.ratios = np.asarray(ratios, np.float32)
        self.scale_major = scale_major
        self.center_offset = center_offset
        self.base_anchors = [self._single_level_base_anchors(bs, stride)
                             for bs, stride in zip(self.base_sizes,
                                                   self.strides)]

    @property
    def num_levels(self) -> int:
        return len(self.strides)

    @property
    def num_base_anchors(self) -> List[int]:
        return [a.shape[0] for a in self.base_anchors]

    def _anchor_sizes(self, base_size: float):
        """The base anchors' widths and heights, ratio- or scale-major."""
        h_ratios = np.sqrt(self.ratios)
        w_ratios = 1.0 / h_ratios
        if self.scale_major:
            ws = (base_size * w_ratios[:, None] * self.scales[None, :])
            hs = (base_size * h_ratios[:, None] * self.scales[None, :])
        else:
            ws = (base_size * self.scales[:, None] * w_ratios[None, :])
            hs = (base_size * self.scales[:, None] * h_ratios[None, :])
        return ws.reshape(-1), hs.reshape(-1)

    def _single_level_base_anchors(self, base_size: float, stride) -> np.ndarray:
        ws, hs = self._anchor_sizes(float(base_size))
        x_c = self.center_offset * stride[0]
        y_c = self.center_offset * stride[1]
        return np.stack([x_c - 0.5 * ws, y_c - 0.5 * hs,
                         x_c + 0.5 * ws, y_c + 0.5 * hs],
                        axis=-1).astype(np.float32)

    def single_level_grid_anchors(self, featmap_size: Tuple[int, int],
                                  level: int) -> np.ndarray:
        """(H*W*A, 4) anchors for one level, row-major over the grid."""
        h, w = featmap_size
        sx, sy = self.strides[level]
        xx, yy = np.meshgrid(np.arange(w, dtype=np.float32) * sx,
                             np.arange(h, dtype=np.float32) * sy)
        shifts = np.stack([xx.ravel(), yy.ravel(), xx.ravel(), yy.ravel()],
                          axis=-1)
        return (self.base_anchors[level][None] + shifts[:, None]).reshape(-1, 4)

    def grid_anchors(self, featmap_sizes: Sequence[Tuple[int, int]]
                     ) -> List[np.ndarray]:
        if len(featmap_sizes) != self.num_levels:
            raise ValueError(f"{len(featmap_sizes)} feature maps for "
                             f"{self.num_levels} anchor levels")
        return [self.single_level_grid_anchors(fs, i)
                for i, fs in enumerate(featmap_sizes)]

    def valid_flags(self, featmap_sizes, pad_shape) -> List[np.ndarray]:
        """Anchors whose grid cell lies inside the (unpadded) image."""
        flags = []
        for i, (h, w) in enumerate(featmap_sizes):
            sx, sy = self.strides[i]
            valid_w = min(int(np.ceil(pad_shape[1] / sx)), w)
            valid_h = min(int(np.ceil(pad_shape[0] / sy)), h)
            vx = np.arange(w) < valid_w
            vy = np.arange(h) < valid_h
            flags.append(np.repeat((vy[:, None] & vx[None, :]).ravel(),
                                   self.num_base_anchors[i]))
        return flags


class LegacyAnchorGenerator(AnchorGenerator):
    """MMDet V1.x anchors (mmdet anchor_generator.py:474)."""

    def _single_level_base_anchors(self, base_size: float, stride) -> np.ndarray:
        ws, hs = self._anchor_sizes(float(base_size))
        x_c = y_c = self.center_offset * (float(base_size) - 1)
        base = np.stack([x_c - 0.5 * (ws - 1), y_c - 0.5 * (hs - 1),
                         x_c + 0.5 * (ws - 1), y_c + 0.5 * (hs - 1)],
                        axis=-1)
        return np.round(base).astype(np.float32)


ANCHOR_GENERATORS = {"AnchorGenerator": AnchorGenerator,
                     "LegacyAnchorGenerator": LegacyAnchorGenerator}


class PointGenerator:
    """Grid points (x, y, stride) at cell corners, x = ix * stride, as
    mmdet's point_generator.py."""

    def grid_points(self, featmap_size: Tuple[int, int],
                    stride: int) -> np.ndarray:
        """(H*W, 3) float32 rows of (x, y, stride), row-major."""
        h, w = featmap_size
        xx, yy = np.meshgrid(np.arange(0., w, dtype=np.float32) * stride,
                             np.arange(0., h, dtype=np.float32) * stride)
        ss = np.full_like(xx.ravel(), float(stride))
        return np.stack([xx.ravel(), yy.ravel(), ss], axis=-1)

    def valid_flags(self, featmap_size: Tuple[int, int],
                    valid_size: Tuple[int, int]) -> np.ndarray:
        """(H*W,) bool: the points of the first valid_size cells."""
        h, w = featmap_size
        vh, vw = valid_size
        vx = np.arange(w) < vw
        vy = np.arange(h) < vh
        return (vy[:, None] & vx[None, :]).ravel()
