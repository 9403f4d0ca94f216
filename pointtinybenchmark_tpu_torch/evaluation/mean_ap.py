"""VOC-style mAP (mmdet core/evaluation/mean_ap.py:12-400).

The port's own copy of pointtinybenchmark_tpu/evaluation/mean_ap.py, host
numpy: `eval_map` / `tpfp_default` / `average_precision`, greedy
per-image score-ordered matching against max-IoU gts with ignore-region
and area-range handling, then the precision-envelope 'area' integral (or
VOC07 '11points'). No multiprocessing (the evaluation is offline).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["average_precision", "tpfp_default", "eval_map"]


def _bbox_overlaps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if a.shape[0] == 0 or b.shape[0] == 0:
        return np.zeros((a.shape[0], b.shape[0]))
    ix1 = np.maximum(a[:, None, 0], b[None, :, 0])
    iy1 = np.maximum(a[:, None, 1], b[None, :, 1])
    ix2 = np.minimum(a[:, None, 2], b[None, :, 2])
    iy2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter,
                              np.finfo(np.float32).eps)


def average_precision(recalls: np.ndarray, precisions: np.ndarray,
                      mode: str = "area"):
    """reference mean_ap.py:12-57: precision-envelope area integral or the
    VOC07 11-point average."""
    no_scale = recalls.ndim == 1
    if no_scale:
        recalls = recalls[None, :]
        precisions = precisions[None, :]
    num_scales = recalls.shape[0]
    ap = np.zeros(num_scales, np.float32)
    if mode == "area":
        zeros = np.zeros((num_scales, 1), recalls.dtype)
        ones = np.ones((num_scales, 1), recalls.dtype)
        mrec = np.hstack((zeros, recalls, ones))
        mpre = np.hstack((zeros, precisions, zeros))
        for i in range(mpre.shape[1] - 1, 0, -1):
            mpre[:, i - 1] = np.maximum(mpre[:, i - 1], mpre[:, i])
        for i in range(num_scales):
            ind = np.where(mrec[i, 1:] != mrec[i, :-1])[0]
            ap[i] = np.sum((mrec[i, ind + 1] - mrec[i, ind])
                           * mpre[i, ind + 1])
    elif mode == "11points":
        for i in range(num_scales):
            for thr in np.arange(0, 1 + 1e-3, 0.1):
                precs = precisions[i, recalls[i, :] >= thr]
                ap[i] += precs.max() if precs.size > 0 else 0
        ap /= 11
    else:
        raise ValueError(f"unsupported mode {mode}")
    return ap[0] if no_scale else ap


def tpfp_default(det_bboxes: np.ndarray, gt_bboxes: np.ndarray,
                 gt_bboxes_ignore: Optional[np.ndarray] = None,
                 iou_thr: float = 0.5,
                 area_ranges=None) -> Tuple[np.ndarray, np.ndarray]:
    """reference mean_ap.py:153-238 exactly (incl. the detail that a det
    whose max-IoU gt is ignored contributes neither tp nor fp)."""
    gt_bboxes_ignore = (np.empty((0, 4), np.float32)
                        if gt_bboxes_ignore is None else gt_bboxes_ignore)
    gt_ignore_inds = np.concatenate(
        (np.zeros(gt_bboxes.shape[0], bool),
         np.ones(gt_bboxes_ignore.shape[0], bool)))
    gt_bboxes = np.vstack((gt_bboxes, gt_bboxes_ignore))

    num_dets = det_bboxes.shape[0]
    num_gts = gt_bboxes.shape[0]
    if area_ranges is None:
        area_ranges = [(None, None)]
    num_scales = len(area_ranges)
    tp = np.zeros((num_scales, num_dets), np.float32)
    fp = np.zeros((num_scales, num_dets), np.float32)

    if num_gts == 0:
        if area_ranges == [(None, None)]:
            fp[...] = 1
        else:
            det_areas = ((det_bboxes[:, 2] - det_bboxes[:, 0])
                         * (det_bboxes[:, 3] - det_bboxes[:, 1]))
            for i, (mn, mx) in enumerate(area_ranges):
                fp[i, (det_areas >= mn) & (det_areas < mx)] = 1
        return tp, fp

    ious = _bbox_overlaps(det_bboxes[:, :4], gt_bboxes)
    ious_max = ious.max(axis=1) if num_dets else np.zeros(0)
    ious_argmax = ious.argmax(axis=1) if num_dets else np.zeros(0, int)
    sort_inds = np.argsort(-det_bboxes[:, -1])
    for k, (mn, mx) in enumerate(area_ranges):
        gt_covered = np.zeros(num_gts, bool)
        if mn is None:
            gt_area_ignore = np.zeros_like(gt_ignore_inds, dtype=bool)
        else:
            gt_areas = ((gt_bboxes[:, 2] - gt_bboxes[:, 0])
                        * (gt_bboxes[:, 3] - gt_bboxes[:, 1]))
            gt_area_ignore = (gt_areas < mn) | (gt_areas >= mx)
        for i in sort_inds:
            if ious_max[i] >= iou_thr:
                m = ious_argmax[i]
                if not (gt_ignore_inds[m] or gt_area_ignore[m]):
                    if not gt_covered[m]:
                        gt_covered[m] = True
                        tp[k, i] = 1
                    else:
                        fp[k, i] = 1
            elif mn is None:
                fp[k, i] = 1
            else:
                b = det_bboxes[i, :4]
                area = (b[2] - b[0]) * (b[3] - b[1])
                if mn <= area < mx:
                    fp[k, i] = 1
    return tp, fp


def eval_map(det_results: List[List[np.ndarray]],
             annotations: List[dict],
             scale_ranges: Optional[Sequence[Tuple[float, float]]] = None,
             iou_thr: float = 0.5,
             dataset: Optional[str] = None):
    """reference mean_ap.py:267-400 (single-process).

    det_results[img][cls] = (n, 5) xyxy+score; annotations[img] has
    bboxes/labels (+bboxes_ignore/labels_ignore). Returns
    (mean_ap, [per-class dict]).
    """
    assert len(det_results) == len(annotations)
    num_imgs = len(det_results)
    num_scales = len(scale_ranges) if scale_ranges is not None else 1
    num_classes = len(det_results[0])
    area_ranges = ([(rg[0] ** 2, rg[1] ** 2) for rg in scale_ranges]
                   if scale_ranges is not None else None)

    eval_results = []
    for c in range(num_classes):
        cls_dets = [img_res[c] for img_res in det_results]
        cls_gts, cls_gts_ignore = [], []
        for ann in annotations:
            sel = ann["labels"] == c
            cls_gts.append(ann["bboxes"][sel, :])
            if ann.get("labels_ignore") is not None:
                isel = ann["labels_ignore"] == c
                cls_gts_ignore.append(ann["bboxes_ignore"][isel, :])
            else:
                cls_gts_ignore.append(np.empty((0, 4), np.float32))
        tpfp = [tpfp_default(cls_dets[i], cls_gts[i], cls_gts_ignore[i],
                             iou_thr, area_ranges)
                for i in range(num_imgs)]
        tp, fp = tuple(zip(*tpfp))
        num_gts = np.zeros(num_scales, int)
        for bbox in cls_gts:
            if area_ranges is None:
                num_gts[0] += bbox.shape[0]
            else:
                gt_areas = ((bbox[:, 2] - bbox[:, 0])
                            * (bbox[:, 3] - bbox[:, 1]))
                for k, (mn, mx) in enumerate(area_ranges):
                    num_gts[k] += np.sum((gt_areas >= mn) & (gt_areas < mx))
        all_dets = np.vstack(cls_dets)
        num_dets = all_dets.shape[0]
        sort_inds = np.argsort(-all_dets[:, -1])
        tp = np.hstack(tp)[:, sort_inds]
        fp = np.hstack(fp)[:, sort_inds]
        tp = np.cumsum(tp, axis=1)
        fp = np.cumsum(fp, axis=1)
        eps = np.finfo(np.float32).eps
        recalls = tp / np.maximum(num_gts[:, None], eps)
        precisions = tp / np.maximum(tp + fp, eps)
        if scale_ranges is None:
            recalls = recalls[0, :]
            precisions = precisions[0, :]
            num_gts = num_gts.item()
        mode = "area" if dataset != "voc07" else "11points"
        ap = average_precision(recalls, precisions, mode)
        eval_results.append(dict(num_gts=num_gts, num_dets=num_dets,
                                 recall=recalls, precision=precisions,
                                 ap=ap))
    if scale_ranges is not None:
        all_ap = np.vstack([r["ap"] for r in eval_results])
        all_num_gts = np.vstack([r["num_gts"] for r in eval_results])
        mean_ap = []
        for i in range(num_scales):
            if np.any(all_num_gts[:, i] > 0):
                mean_ap.append(all_ap[all_num_gts[:, i] > 0, i].mean())
            else:
                mean_ap.append(0.0)
    else:
        aps = [r["ap"] for r in eval_results if r["num_gts"] > 0]
        mean_ap = np.array(aps).mean().item() if aps else 0.0
    return mean_ap, eval_results
