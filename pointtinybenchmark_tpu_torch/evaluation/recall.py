"""Proposal recall (AR) in pure numpy.

The port's own copy of pointtinybenchmark_tpu/evaluation/recall.py
(mmdet core/evaluation/recall.py::eval_recalls), the
`proposal_fast` metric of CocoDataset.evaluate
(reference mmdet/datasets/coco.py:316-335, 432-441): per-image greedy
one-to-one gt<->proposal matching on IoU, recall curves over
(proposal_nums x iou_thrs).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

__all__ = ["eval_recalls"]


def _bbox_ious(g: np.ndarray, p: np.ndarray) -> np.ndarray:
    """IoU (num_gts, num_proposals) on xyxy boxes."""
    if len(g) == 0 or len(p) == 0:
        return np.zeros((len(g), len(p)))
    ix1 = np.maximum(g[:, None, 0], p[None, :, 0])
    iy1 = np.maximum(g[:, None, 1], p[None, :, 1])
    ix2 = np.minimum(g[:, None, 2], p[None, :, 2])
    iy2 = np.minimum(g[:, None, 3], p[None, :, 3])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    ga = ((g[:, 2] - g[:, 0]) * (g[:, 3] - g[:, 1]))[:, None]
    pa = ((p[:, 2] - p[:, 0]) * (p[:, 3] - p[:, 1]))[None, :]
    return inter / np.maximum(ga + pa - inter, 1e-10)


def _greedy_gt_ious(ious: np.ndarray) -> np.ndarray:
    """mmdet _recalls inner loop: repeatedly match the globally best
    (gt, proposal) pair, removing both."""
    ious = ious.copy()
    gt_ious = np.zeros(ious.shape[0])
    if ious.size == 0:
        return gt_ious
    for j in range(ious.shape[0]):
        gt_max = ious.argmax(axis=1)
        max_ious = ious[np.arange(ious.shape[0]), gt_max]
        gi = max_ious.argmax()
        gt_ious[j] = max_ious[gi]
        ious[gi, :] = -1
        ious[:, gt_max[gi]] = -1
    return gt_ious


def eval_recalls(gts: List[np.ndarray], proposals: List[np.ndarray],
                 proposal_nums: Sequence[int],
                 iou_thrs: Sequence[float]) -> np.ndarray:
    """Recall matrix (len(proposal_nums), len(iou_thrs)).

    gts[i]: (G_i, 4) xyxy; proposals[i]: (P_i, 4) or (P_i, 5) with score —
    5-column proposals are sorted by score descending before the top-k cut.
    """
    proposal_nums = np.asarray(proposal_nums, int)
    iou_thrs = np.asarray(iou_thrs, float)
    total_gt = int(sum(len(g) for g in gts))
    all_ious = []
    for g, p in zip(gts, proposals):
        p = np.asarray(p, float)
        if p.ndim == 2 and p.shape[1] == 5:
            p = p[np.argsort(-p[:, 4])][:, :4]
        all_ious.append(_bbox_ious(np.asarray(g, float).reshape(-1, 4), p))
    matched = np.zeros((len(proposal_nums), max(total_gt, 1)))
    for k, num in enumerate(proposal_nums):
        acc = []
        for ious in all_ious:
            acc.append(_greedy_gt_ious(ious[:, :num]))
        if acc:
            cat = np.concatenate(acc) if total_gt else np.zeros(1)
            matched[k, :len(cat)] = cat
    recalls = np.zeros((len(proposal_nums), len(iou_thrs)))
    for i, thr in enumerate(iou_thrs):
        recalls[:, i] = ((matched >= thr).sum(axis=1) / float(total_gt)
                         if total_gt else 0.0)
    return recalls
