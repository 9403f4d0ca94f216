"""LVIS evaluation (federated, frequency-binned AP) in numpy.

The port's own copy of pointtinybenchmark_tpu/evaluation/lvis_eval.py::
LVISExpandEval (the lvis-api's LVISEval as mmdet datasets/lvis.py uses it),
built on the port's `COCOExpandEval` at maxDets 300:
- the federated drop (`_prepare`): a detection of class c on image i
  counts only where c has a gt on i or is in the image's
  `neg_category_ids`; every other detection is dropped;
- the not-exhaustive ignore (`_finish_eval_img`, reached from the native
  and from the Python matching): on an image that lists c in
  `not_exhaustive_category_ids`, the detections of c that matched nothing
  are ignored, not false positives;
- `summarize`: mAP, AP50, AP75, APs / APm / APl, APr / APc / APf (the mean
  AP over the classes whose `frequency` is r, c or f; -1 where a bin has
  none) and AR@300.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np

from .cocoeval import COCOExpandEval

__all__ = ["LVISExpandEval"]


class LVISExpandEval(COCOExpandEval):

    def __init__(self, cocoGt, cocoDt, iouType: str = "bbox",
                 max_dets: int = 300, **kwargs):
        cocofmt_param = dict(kwargs.pop("cocofmt_param", {}) or {})
        cocofmt_param.setdefault("maxDets", [max_dets])
        super().__init__(cocoGt, cocoDt, iouType,
                         cocofmt_param=cocofmt_param, **kwargs)

    def _prepare(self):
        super()._prepare()
        imgs = {i: self.cocoGt.load_imgs([i])[0] for i in self.params.imgIds}
        img_pl = {i: set() for i in self.params.imgIds}
        for (img_id, cat_id), gts in self._gts.items():
            if gts:
                img_pl[img_id].add(cat_id)
        self._img_nel = {i: set(imgs[i].get("neg_category_ids", []))
                         for i in self.params.imgIds}
        self._img_ne = {i: set(imgs[i].get("not_exhaustive_category_ids",
                                           []))
                        for i in self.params.imgIds}
        for img_id, cat_id in list(self._dts.keys()):
            if (cat_id not in img_pl[img_id]
                    and cat_id not in self._img_nel[img_id]):
                del self._dts[img_id, cat_id]

    def _finish_eval_img(self, img_id, cat_id, a_rng, max_det, dt, gt,
                         dtm, gtm, gt_ig, dt_ig):
        out = super()._finish_eval_img(img_id, cat_id, a_rng, max_det, dt,
                                       gt, dtm, gtm, gt_ig, dt_ig)
        if out is not None and cat_id in self._img_ne.get(img_id, ()):
            out["dtIgnore"] = np.logical_or(out["dtIgnore"],
                                            out["dtMatches"] == 0)
        return out

    def summarize(self):
        p = self.params
        max_det = p.maxDets[-1]
        stats: "OrderedDict[str, float]" = OrderedDict()
        stats["mAP"] = self._summarize(1, None, "all", max_det)
        stats["AP50"] = self._summarize(1, 0.5, "all", max_det)
        stats["AP75"] = self._summarize(1, 0.75, "all", max_det)
        for lbl in p.areaRngLbl[1:]:
            stats[f"AP{lbl[0]}"] = self._summarize(1, None, lbl, max_det)
        freq = {c["id"]: c.get("frequency", "f")
                for c in self.cocoGt.load_cats(p.catIds)}
        precision = self.eval["precision"]               # (T, R, K, A, M)
        for band, key in (("r", "APr"), ("c", "APc"), ("f", "APf")):
            ks = [k for k, cid in enumerate(p.catIds) if freq[cid] == band]
            if not ks:
                stats[key] = -1.0
                continue
            s = precision[:, :, ks, 0, -1]
            stats[key] = float(np.mean(s[s > -1])) if (s > -1).any() else -1.0
        stats["AR@%d" % max_det] = self._summarize(0, None, "all", max_det)
        self.stats_dict = stats
        self.stats = np.asarray(list(stats.values()))
        return stats
