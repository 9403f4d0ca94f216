"""Point-localization AP (LocationEvaluator), host numpy.

The port's own copy of pointtinybenchmark_tpu/evaluation/location_eval.py:
predicted points are matched to gt points greedily by score under a
distance threshold normalised by the gt's size (matchThs 0.5, 1.0, 2.0),
and AP is accumulated COCO-style over recThrs and maxDets; a gt without a
point is its box's centre. `gt_coco` is any object with `get_cat_ids()`,
`get_img_ids()` and `img_ann_map` (image id -> annotation dicts with
`bbox` [x, y, w, h], `category_id` and optionally `point`, `ignore`,
`iscrowd`, `uncertain`); detections are dicts with `image_id`,
`category_id`, `score` and `point` [x, y] (or `bbox`).
"""
from __future__ import annotations

from collections import OrderedDict, defaultdict
from typing import Dict, List, Optional

import numpy as np

__all__ = ["LocationEvaluator"]


class LocationEvaluator:
    def __init__(self,
                 matcher_kwargs: Optional[dict] = None,
                 location_param: Optional[dict] = None,
                 add_center_from_bbox_if_no_point: bool = True,
                 class_wise: bool = False):
        matcher_kwargs = dict(matcher_kwargs or {})
        location_param = dict(location_param or {})
        self.multi_match_not_false_alarm = bool(
            matcher_kwargs.get("multi_match_not_false_alarm", False))
        self.match_ths = list(location_param.get("matchThs", [0.5, 1.0, 2.0]))
        rec = location_param.get(
            "recThrs", np.linspace(.0, 1.00, 101))
        if isinstance(rec, str):
            from ..utils.safe_eval import safe_eval_expr
            rec = safe_eval_expr(rec)
        self.rec_thrs = np.asarray(rec)
        self.max_dets = list(location_param.get("maxDets", [100]))
        self.add_center = add_center_from_bbox_if_no_point
        self.class_wise = class_wise

    @staticmethod
    def _gt_point(ann: dict):
        if "point" in ann:
            return ann["point"]
        x, y, w, h = ann["bbox"]
        return [x + w / 2, y + h / 2]

    @staticmethod
    def _det_point(det: dict):
        if "point" in det:
            return det["point"]
        x, y, w, h = det["bbox"]
        return [x + w / 2, y + h / 2]

    def __call__(self, det_json: List[dict], gt_coco) -> Dict[str, float]:
        cat_ids = sorted(gt_coco.get_cat_ids()) or [1]
        img_ids = sorted(gt_coco.get_img_ids())
        dts = defaultdict(list)
        for d in det_json:
            dts[d["image_id"], d["category_id"]].append(d)

        T = len(self.match_ths)
        K = len(cat_ids)
        M = len(self.max_dets)
        R = len(self.rec_thrs)
        precision = -np.ones((T, R, K, M))
        recall = -np.ones((T, K, M))

        for k, cat_id in enumerate(cat_ids):
            per_img = []
            for img_id in img_ids:
                gts = [g for g in gt_coco.img_ann_map[img_id]
                       if g.get("category_id") == cat_id]
                gt_ig = np.asarray([
                    bool(g.get("ignore", 0) or g.get("iscrowd", 0)
                         or g.get("uncertain", 0)) for g in gts])
                if not self.add_center:
                    keep = np.asarray(["point" in g for g in gts], bool)
                    gts = [g for g, kp in zip(gts, keep) if kp]
                    gt_ig = gt_ig[keep] if len(gt_ig) else gt_ig
                dt = sorted(dts[img_id, cat_id], key=lambda d: -d["score"])
                per_img.append((gts, gt_ig, dt))

            for m, max_det in enumerate(self.max_dets):
                for t, th in enumerate(self.match_ths):
                    all_scores, all_tp, all_ig = [], [], []
                    npig = 0
                    for gts, gt_ig, dt in per_img:
                        dt = dt[:max_det]
                        npig += int((~gt_ig).sum()) if len(gt_ig) else 0
                        if not dt:
                            continue
                        dpts = np.asarray([self._det_point(d) for d in dt])
                        if gts:
                            gpts = np.asarray([self._gt_point(g) for g in gts])
                            sizes = np.asarray([
                                max(np.sqrt(max(g["bbox"][2] * g["bbox"][3],
                                                1e-6)), 1e-6) for g in gts])
                            dist = np.linalg.norm(
                                dpts[:, None, :] - gpts[None, :, :], axis=-1)
                            dist = dist / sizes[None, :]
                        else:
                            dist = np.zeros((len(dt), 0))
                        matched = np.zeros(len(gts), bool)
                        for di in range(len(dt)):
                            tp, ig = 0, 0
                            if dist.shape[1]:
                                order = np.argsort(dist[di])
                                chosen = -1
                                for gi in order:
                                    if dist[di, gi] > th:
                                        break
                                    if not matched[gi]:
                                        chosen = gi
                                        break
                                    if self.multi_match_not_false_alarm or gt_ig[gi]:
                                        chosen = gi  # absorbed, not FA
                                        break
                                if chosen >= 0:
                                    if gt_ig[chosen]:
                                        ig = 1
                                    elif not matched[chosen]:
                                        matched[chosen] = True
                                        tp = 1
                                    else:  # multi-match absorb
                                        ig = 1
                            all_scores.append(dt[di]["score"])
                            all_tp.append(tp)
                            all_ig.append(ig)
                    if npig == 0:
                        continue
                    if not all_scores:
                        recall[t, k, m] = 0
                        precision[t, :, k, m] = 0
                        continue
                    scores = np.asarray(all_scores)
                    order = np.argsort(-scores, kind="mergesort")
                    tp = np.asarray(all_tp)[order]
                    ig = np.asarray(all_ig)[order]
                    keep = ~ig.astype(bool)
                    tp = tp[keep]
                    fp = 1 - tp
                    tp_c = np.cumsum(tp).astype(float)
                    fp_c = np.cumsum(fp).astype(float)
                    rc = tp_c / npig
                    pr = tp_c / np.maximum(tp_c + fp_c, np.finfo(float).eps)
                    recall[t, k, m] = rc[-1] if len(rc) else 0
                    prl = pr.tolist()
                    for i in range(len(prl) - 1, 0, -1):
                        if prl[i] > prl[i - 1]:
                            prl[i - 1] = prl[i]
                    inds = np.searchsorted(rc, self.rec_thrs, side="left")
                    q = np.zeros(R)
                    for ri, pi in enumerate(inds):
                        if pi < len(prl):
                            q[ri] = prl[pi]
                    precision[t, :, k, m] = q

        stats = OrderedDict()
        md = self.max_dets[-1]
        mi = len(self.max_dets) - 1
        valid = precision[:, :, :, mi]
        stats["AP"] = float(np.mean(valid[valid > -1])) if (valid > -1).any() else -1.0
        for t, th in enumerate(self.match_ths):
            v = precision[t, :, :, mi]
            stats[f"AP_d{th}"] = float(np.mean(v[v > -1])) if (v > -1).any() else -1.0
        for t, th in enumerate(self.match_ths):
            v = recall[t, :, mi]
            stats[f"AR_d{th}@{md}"] = float(np.mean(v[v > -1])) if (v > -1).any() else -1.0
        return stats
