"""Tile-result merging: per-tile detections -> full-image detections + NMS.

The port's own copy of pointtinybenchmark_tpu/evaluation/merge.py, host
numpy, not a K1 launch (huicv evaluation.evaluate_tiny.merge_det_result;
behavior pinned by call site TOV_mmdetection/mmdet/datasets/cocofmt.py:310-317
and docs/tov/evaluation_of_tiny_object.md:106-120): shift each corner-tile
detection by its tile's (l, u) offset, regroup by original image id, run
class-wise NMS (merge_nms_th, default 0.5), evaluate against the full-image
gt json.
"""
from __future__ import annotations

from collections import defaultdict
from typing import List, Optional, Tuple

import numpy as np

from ..data.coco import COCO

__all__ = ["merge_det_result", "nms_numpy"]


def nms_numpy(boxes: np.ndarray, scores: np.ndarray, thr: float) -> List[int]:
    """Greedy NMS on host (xyxy)."""
    order = np.argsort(-scores, kind="mergesort")
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = (x2 - x1) * (y2 - y1)
    keep = []
    suppressed = np.zeros(len(boxes), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1)
        yy1 = np.maximum(y1[i], y1)
        xx2 = np.minimum(x2[i], x2)
        yy2 = np.minimum(y2[i], y2)
        inter = np.clip(xx2 - xx1, 0, None) * np.clip(yy2 - yy1, 0, None)
        iou = inter / np.maximum(areas[i] + areas - inter, 1e-10)
        suppressed |= iou > thr
        suppressed[i] = True
    return keep


def merge_det_result(det_json: List[dict], corner_coco: COCO,
                     merge_gt_file: Optional[str],
                     nms_th: float = 0.5) -> Tuple[List[dict], COCO]:
    """Returns (merged det json, full-image gt COCO)."""
    # tile image id -> (offset, original image id)
    offset, ori_id = {}, {}
    for img_id, img in corner_coco.imgs.items():
        c = img.get("corner", [0, 0, img["width"], img["height"]])
        offset[img_id] = (float(c[0]), float(c[1]))
        ori_id[img_id] = img.get("ori_id", img_id)

    by_img_cat = defaultdict(list)
    for d in det_json:
        l, u = offset.get(d["image_id"], (0.0, 0.0))
        nd = dict(d)
        bb = d["bbox"]
        nd["bbox"] = [bb[0] + l, bb[1] + u, bb[2], bb[3]]
        if "point" in d:
            nd["point"] = [d["point"][0] + l, d["point"][1] + u]
        nd["image_id"] = ori_id.get(d["image_id"], d["image_id"])
        by_img_cat[nd["image_id"], nd["category_id"]].append(nd)

    merged = []
    for (img_id, cat_id), dets in by_img_cat.items():
        boxes = np.asarray([[d["bbox"][0], d["bbox"][1],
                             d["bbox"][0] + d["bbox"][2],
                             d["bbox"][1] + d["bbox"][3]] for d in dets])
        scores = np.asarray([d["score"] for d in dets])
        for i in nms_numpy(boxes, scores, nms_th):
            merged.append(dets[i])

    gt_coco = COCO(merge_gt_file) if merge_gt_file else corner_coco
    return merged, gt_coco
