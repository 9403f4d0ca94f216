"""The runtime tile grid of the TinyPerson protocol.

Counterpart of pointtinybenchmark_tpu/data/tiling.py::tile_grid (reference
rtest_time_aug.py CroppedTilesFlipAug): tiles of exactly (tile_w, tile_h),
stepped by tile - overlap, with the last row and column clamped to end at
the image border.
"""
from __future__ import annotations

from typing import List, Tuple

__all__ = ["tile_grid"]


def _starts(size: int, tile: int, step: int) -> List[int]:
    starts, x = [], 0
    while x + tile < size:
        starts.append(x)
        x += step
    starts.append(max(size - tile, 0))
    return starts


def tile_grid(img_w: int, img_h: int, tile_w: int, tile_h: int,
              overlap_w: int = 0, overlap_h: int = 0
              ) -> List[Tuple[int, int, int, int]]:
    """All (l, u, r, b) tile rects covering the image, row-major, without
    duplicates (small images can collapse onto one rect)."""
    xs = _starts(img_w, tile_w, max(tile_w - overlap_w, 1))
    ys = _starts(img_h, tile_h, max(tile_h - overlap_h, 1))
    rects = [(x, y, min(x + tile_w, img_w), min(y + tile_h, img_h))
             for y in ys for x in xs]
    return list(dict.fromkeys(rects))
