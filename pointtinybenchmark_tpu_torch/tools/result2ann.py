"""Turn CPR's refined points (detections keyed by ann_id) back into a COCO
training annotation json for stage 2 (P2P training).

    python -m pointtinybenchmark_tpu_torch.tools.result2ann
        --ori_ann ANN.json --det_file REFINED.json --save_ann OUT.json
        [--wh 16]

The port's own copy of the repo's tools/result2ann.py
(TOV_mmdetection/exp/tools/result2ann.py:52-92): each refined detection
replaces its original annotation's bbox, with `--wh` > 0 a box of that
width and height around the refined box's centre, and its point where the
detection has one. `--det_file` is what the port's test CLI writes with
`--out` for a CPR config (one row per annotated point, with `ann_id`).
"""
from __future__ import annotations

import argparse
import json
from typing import List, Optional, Sequence, Tuple, Union

__all__ = ["turn_bbox_wh", "result_to_annotation", "main"]


def xywh2centerwh(xywh: Sequence[float]) -> List[float]:
    x1, y1, w, h = xywh
    return [x1 + w / 2, y1 + h / 2, w, h]


def centerwh2xywh(cwh: Sequence[float]) -> List[float]:
    xc, yc, w, h = cwh
    return [xc - w / 2, yc - h / 2, w, h]


def turn_bbox_wh(bbox: Sequence[float], new_wh: Sequence[float]
                 ) -> List[float]:
    """Keep the centre, replace w and h when both new ones are > 0."""
    bbox = list(bbox)
    if new_wh[0] > 0 and new_wh[1] > 0:
        xc, yc, _, _ = xywh2centerwh(bbox)
        bbox = centerwh2xywh([xc, yc, new_wh[0], new_wh[1]])
    return bbox


def result_to_annotation(ori_ann_file: str,
                         det_results: Union[str, List[dict]],
                         new_wh: Tuple[float, float] = (-1, -1)
                         ) -> Tuple[dict, int]:
    """The annotation json of `ori_ann_file` with each annotation that a
    detection names by `ann_id` updated (bbox, area, point), and the
    number updated. A detection must be of its annotation's image."""
    with open(ori_ann_file) as f:
        dataset = json.load(f)
    if isinstance(det_results, str):
        with open(det_results) as f:
            det_results = json.load(f)
    by_ann_id = {d["ann_id"]: d for d in det_results if "ann_id" in d}
    n_updated = 0
    for ann in dataset.get("annotations", []):
        det = by_ann_id.get(ann["id"])
        if det is None:
            continue
        assert det.get("image_id") == ann["image_id"], (det, ann)
        ann["bbox"] = turn_bbox_wh(det["bbox"], new_wh)
        ann["area"] = ann["bbox"][2] * ann["bbox"][3]
        if "point" in det:
            ann["point"] = list(det["point"])
        n_updated += 1
    return dataset, n_updated


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="CPR results -> annotations")
    p.add_argument("--ori_ann", required=True)
    p.add_argument("--det_file", required=True)
    p.add_argument("--save_ann", required=True)
    p.add_argument("--wh", default=-1, type=float)
    args = p.parse_args(argv)
    dataset, n = result_to_annotation(args.ori_ann, args.det_file,
                                      (args.wh, args.wh))
    with open(args.save_ann, "w") as f:
        json.dump(dataset, f)
    print(f"updated {n} annotations -> {args.save_ann}")
    return n


if __name__ == "__main__":
    main()
