"""Image tiling of the TinyPerson protocol: the tile grid, the offline
corner dataset and the test-time tilers.

Counterpart of pointtinybenchmark_tpu/data/tiling.py:
- `tile_grid`: tiles of exactly (tile_w, tile_h), stepped by tile -
  overlap, with the last row and column clamped to end at the image border;
- `generate_corner_dataset` / `generate_corner_json_file_if_not_exist`:
  the offline split of a COCO json into overlapping tiles, each tile image
  carrying its `corner` = (l, u, r, b) crop rect and its annotations
  clipped into it (marked `ignore` when less than keep_ratio_th of the box
  is kept);
- `CroppedTilesFlipAug` (mmdet rtest_time_aug.py of the fork): one view per
  tile x scale x flip, with the tile's `tile_offset` in its metas; each
  view starts from a deep copy of the results dict, as the JAX package's
  does; `MultiScaleFlipAug` and `NoAug` beside it.
"""
from __future__ import annotations

import copy
import json
import os
import os.path as osp
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.registry import PIPELINES
from .transforms import Compose

__all__ = ["tile_grid", "generate_corner_dataset",
           "generate_corner_json_file_if_not_exist", "CroppedTilesFlipAug",
           "MultiScaleFlipAug", "NoAug"]


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


def generate_corner_dataset(ann_file: str,
                            corner_kwargs: dict) -> dict:
    """Split a COCO json into a corner (tiled) json.

    corner_kwargs: sub_img_w, sub_img_h, overlap_w, overlap_h (default 0),
    keep_ratio_th (min kept area fraction for a clipped ann, default 0.3).
    """
    with open(ann_file) as f:
        ds = json.load(f)
    tw = int(corner_kwargs.get("sub_img_w", 640))
    th = int(corner_kwargs.get("sub_img_h", 512))
    ow = int(corner_kwargs.get("overlap_w", 0))
    oh = int(corner_kwargs.get("overlap_h", 0))
    keep_th = float(corner_kwargs.get("keep_ratio_th", 0.3))

    anns_by_img: Dict[int, list] = {}
    for a in ds.get("annotations", []):
        anns_by_img.setdefault(a["image_id"], []).append(a)

    new_images, new_anns = [], []
    next_img_id, next_ann_id = 1, 1
    for img in ds.get("images", []):
        w, h = img["width"], img["height"]
        for (l, u, r, b) in tile_grid(w, h, tw, th, ow, oh):
            tile_img = dict(img)
            tile_img["id"] = next_img_id
            tile_img["width"] = r - l
            tile_img["height"] = b - u
            tile_img["corner"] = [l, u, r, b]
            tile_img["ori_id"] = img["id"]
            new_images.append(tile_img)
            for a in anns_by_img.get(img["id"], []):
                x, y, bw, bh = a["bbox"]
                nx1 = max(x - l, 0)
                ny1 = max(y - u, 0)
                nx2 = min(x + bw - l, r - l)
                ny2 = min(y + bh - u, b - u)
                if nx2 <= nx1 or ny2 <= ny1:
                    continue
                kept = (nx2 - nx1) * (ny2 - ny1) / max(bw * bh, 1e-6)
                na = copy.deepcopy(a)
                na["id"] = next_ann_id
                na["image_id"] = next_img_id
                na["bbox"] = [nx1, ny1, nx2 - nx1, ny2 - ny1]
                na["area"] = (nx2 - nx1) * (ny2 - ny1)
                na["ori_ann_id"] = a["id"]
                if kept < keep_th:
                    na["ignore"] = 1  # mostly-cut objects become ignore
                if "point" in a:
                    na["point"] = [a["point"][0] - l, a["point"][1] - u]
                new_anns.append(na)
                next_ann_id += 1
            next_img_id += 1
    return dict(images=new_images, annotations=new_anns,
                categories=ds.get("categories", []),
                info=ds.get("info", {}), licenses=ds.get("licenses", []))


def generate_corner_json_file_if_not_exist(ann_file: str,
                                           data_root: Optional[str],
                                           corner_kwargs: dict) -> str:
    """Write the corner json beside the original, once, and return its path
    (mmdet cocofmt.py:23-43 of the fork)."""
    tw = corner_kwargs.get("sub_img_w", 640)
    th = corner_kwargs.get("sub_img_h", 512)
    base, ext = osp.splitext(ann_file)
    out_file = f"{base}_corner_sw{tw}_sh{th}{ext}"
    if not osp.isfile(out_file):
        ds = generate_corner_dataset(ann_file, corner_kwargs)
        os.makedirs(osp.dirname(osp.abspath(out_file)), exist_ok=True)
        with open(out_file, "w") as f:
            json.dump(ds, f)
    return out_file


@PIPELINES.register_module()
class CroppedTilesFlipAug:
    """The test-time tiler: one view per (tile x scale x flip), with
    tile_offset recorded in its metas."""

    def __init__(self, transforms: Sequence[dict],
                 tile_shape: Tuple[int, int],   # (w, h) like the reference
                 tile_overlap: Tuple[int, int] = (0, 0),
                 scale_factor=(1.0,), flip: bool = False,
                 flip_direction: str = "horizontal"):
        self.transforms = Compose(transforms)
        self.tile_shape = tile_shape
        self.tile_overlap = tile_overlap
        self.scale_factor = (list(scale_factor)
                             if isinstance(scale_factor, (list, tuple))
                             else [scale_factor])
        self.flip = flip
        self.flip_direction = flip_direction

    def __call__(self, results: dict) -> dict:
        img = results["img"]
        h, w = img.shape[:2]
        tw, thh = self.tile_shape
        rects = tile_grid(w, h, tw, thh, *self.tile_overlap)
        views = []
        flips = [False, True] if self.flip else [False]
        for (l, u, r, b) in rects:
            for sf in self.scale_factor:
                for fl in flips:
                    v = copy.deepcopy(
                        {k: results[k] for k in results if k != "img"})
                    v["img"] = img[u:b, l:r].copy()
                    v["img_shape"] = v["img"].shape
                    v["ori_shape"] = results.get("ori_shape", img.shape)
                    v["tile_offset"] = np.asarray([l, u], np.float32)
                    v["scale"] = None
                    v["_resize_ratio"] = float(sf)
                    v["flip"] = fl
                    v["flip_direction"] = self.flip_direction
                    v["bbox_fields"] = []
                    out = self.transforms(v)
                    if out is not None:
                        views.append(out)
        return {"views": views}


@PIPELINES.register_module()
class MultiScaleFlipAug:
    """mmdet's multi-scale / flip test-time wrapper: one view per
    (scale x flip)."""

    def __init__(self, transforms: Sequence[dict], img_scale=None,
                 scale_factor=None, flip: bool = False,
                 flip_direction="horizontal"):
        self.transforms = Compose(transforms)
        scales = img_scale if img_scale is not None else scale_factor
        if not isinstance(scales, list):
            scales = [scales]
        self.scales = scales
        self.use_ratio = img_scale is None
        self.flip = flip
        self.flip_direction = (flip_direction if isinstance(flip_direction,
                                                            list)
                               else [flip_direction])

    def __call__(self, results: dict) -> dict:
        views = []
        flip_args = [(False, "horizontal")]
        if self.flip:
            flip_args += [(True, d) for d in self.flip_direction]
        for scale in self.scales:
            for fl, d in flip_args:
                v = copy.deepcopy(results)
                if self.use_ratio:
                    v["scale"] = None
                    v["_resize_ratio"] = float(scale)
                else:
                    v["scale"] = tuple(scale)
                v["flip"] = fl
                v["flip_direction"] = d
                out = self.transforms(v)
                if out is not None:
                    views.append(out)
        return {"views": views}


@PIPELINES.register_module()
class NoAug:
    """A single view, untiled (rtest_time_aug.py:80-95 of the fork)."""

    def __init__(self, transforms: Sequence[dict], **kwargs):
        self.transforms = Compose(transforms)

    def __call__(self, results: dict) -> dict:
        results["scale"] = None
        results.setdefault("_resize_ratio", 1.0)
        results["flip"] = False
        results["flip_direction"] = "horizontal"
        out = self.transforms(results)
        return {"views": [out]}
