"""COCO detection evaluation in numpy, with the TinyPerson extensions.

The port's own copy of pointtinybenchmark_tpu/evaluation/cocoeval.py
(pycocotools COCOeval for bbox and segm, and huicv's COCOExpandEval):
* ignore_uncertain: anns tagged `uncertain` are always ignored;
* use_ignore_attr: anns tagged `ignore` act like crowd regions;
* use_iod_for_ignore: dets match ignore regions by IoD (intersection over
  the *detection* area) instead of IoU;
* iod_th_of_iou_f: a string lambda mapping the IoU threshold to the IoD
  threshold used against ignore regions (utils/safe_eval.py);
* evaluate_standard='tiny': size ranges all / tiny [2, 20] / tiny1 /
  tiny2 / tiny3 / small (area = size^2), iouThrs [0.25, 0.5, 0.75],
  maxDets [200] (the TinyPerson configs set maxDets [1000] through
  proposal_nums).

Each cell's greedy matching runs in the native loop
(`evaluation/native.py`, built with g++ at first use; a failed build
raises) or, with `native=False`, in the Python loops below, which are the
reference: both give the same stats. So does segm's mask IoU.
"""
from __future__ import annotations

from collections import OrderedDict, defaultdict
from typing import List, Optional

import numpy as np

__all__ = ["COCOExpandEval"]


def _bbox_iou_matrix(d: np.ndarray, g: np.ndarray,
                     iod_cols: np.ndarray) -> np.ndarray:
    """IoU of dets (D,4 xywh) vs gts (G,4 xywh); columns flagged in iod_cols
    use intersection-over-det-area (pycocotools crowd semantics / huicv IoD)."""
    if len(d) == 0 or len(g) == 0:
        return np.zeros((len(d), len(g)))
    dx1, dy1 = d[:, 0], d[:, 1]
    dx2, dy2 = d[:, 0] + d[:, 2], d[:, 1] + d[:, 3]
    gx1, gy1 = g[:, 0], g[:, 1]
    gx2, gy2 = g[:, 0] + g[:, 2], g[:, 1] + g[:, 3]
    ix1 = np.maximum(dx1[:, None], gx1[None, :])
    iy1 = np.maximum(dy1[:, None], gy1[None, :])
    ix2 = np.minimum(dx2[:, None], gx2[None, :])
    iy2 = np.minimum(dy2[:, None], gy2[None, :])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    darea = (d[:, 2] * d[:, 3])[:, None]
    garea = (g[:, 2] * g[:, 3])[None, :]
    union = np.where(iod_cols[None, :], darea,
                     darea + garea - inter)
    return inter / np.maximum(union, 1e-10)


class Params:
    def __init__(self, evaluate_standard: str = "coco"):
        self.imgIds: List[int] = []
        self.catIds: List[int] = []
        self.useCats = 1
        self.evaluate_standard = evaluate_standard
        if evaluate_standard == "tiny":
            self.iouThrs = np.array([0.25, 0.5, 0.75])
            self.maxDets = [200]
            self.areaRng = [[1 ** 2, 1e5 ** 2], [1 ** 2, 20 ** 2],
                            [1 ** 2, 8 ** 2], [8 ** 2, 12 ** 2],
                            [12 ** 2, 20 ** 2], [20 ** 2, 32 ** 2]]
            self.areaRngLbl = ["all", "tiny", "tiny1", "tiny2", "tiny3",
                               "small"]
        else:  # coco standard
            self.iouThrs = np.linspace(.5, 0.95,
                                       int(np.round((0.95 - .5) / .05)) + 1)
            self.maxDets = [100, 300, 1000]
            self.areaRng = [[0 ** 2, 1e5 ** 2], [0 ** 2, 32 ** 2],
                            [32 ** 2, 96 ** 2], [96 ** 2, 1e5 ** 2]]
            self.areaRngLbl = ["all", "small", "medium", "large"]
        self.recThrs = np.linspace(.0, 1.00,
                                   int(np.round((1.00 - .0) / .01)) + 1)


class COCOExpandEval:
    def __init__(self, cocoGt, cocoDt, iouType: str = "bbox",
                 ignore_uncertain: bool = False,
                 use_ignore_attr: bool = False,
                 use_iod_for_ignore: bool = False,
                 iod_th_of_iou_f: str = "lambda iou: iou",
                 cocofmt_param: Optional[dict] = None,
                 native: bool = True):
        # bbox: IoU on boxes; segm: IoU on RLE masks (pycocotools parity,
        # reference mmdet/datasets/coco.py:373-460 dispatch)
        assert iouType in ("bbox", "segm"), iouType
        self.iouType = iouType
        self.cocoGt = cocoGt
        self.cocoDt = cocoDt
        self.ignore_uncertain = ignore_uncertain
        self.use_ignore_attr = use_ignore_attr
        self.use_iod_for_ignore = use_iod_for_ignore
        self.native = native
        from ..utils.safe_eval import safe_eval_lambda
        self.iod_th_of_iou_f = safe_eval_lambda(iod_th_of_iou_f)
        cocofmt_param = dict(cocofmt_param or {})
        std = cocofmt_param.pop("evaluate_standard", "coco")
        self.params = Params(std)
        for k, v in cocofmt_param.items():
            setattr(self.params, k, np.asarray(v) if k in
                    ("iouThrs", "recThrs") else v)
        self.params.imgIds = sorted(cocoGt.get_img_ids())
        self.params.catIds = sorted(cocoGt.get_cat_ids())
        self.evalImgs: dict = {}
        self.eval: dict = {}
        self.stats = None
        self.stats_dict: "OrderedDict[str, float]" = OrderedDict()

    # ------------------------------------------------------------ prepare
    def _prepare(self):
        p = self.params
        gts = self.cocoGt.load_anns(
            self.cocoGt.get_ann_ids(img_ids=p.imgIds, cat_ids=p.catIds))
        dts = self.cocoDt.load_anns(
            self.cocoDt.get_ann_ids(img_ids=p.imgIds, cat_ids=p.catIds))
        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        for gt in gts:
            gt = dict(gt)
            ignore = gt.get("ignore", 0) or gt.get("iscrowd", 0)
            if self.ignore_uncertain and gt.get("uncertain", False):
                ignore = 1
            gt["_ignore_attr"] = int(bool(ignore))
            # crowd-like for matching: iscrowd, or ignore attr when
            # use_ignore_attr is on
            gt["_crowd_like"] = int(bool(gt.get("iscrowd", 0) or (
                self.use_ignore_attr and ignore)))
            cat = gt["category_id"] if p.useCats else -1
            self._gts[gt["image_id"], cat].append(gt)
        for dt in dts:
            cat = dt["category_id"] if p.useCats else -1
            self._dts[dt["image_id"], cat].append(dict(dt))

    def _cat_keys(self):
        """Effective category keys: real cats, or the class-agnostic -1
        bucket when useCats=0 (proposal metric, pycocotools parity)."""
        return self.params.catIds if self.params.useCats else [-1]

    # ------------------------------------------------------------ evaluate
    def evaluate(self):
        self._prepare()
        p = self.params
        cats = self._cat_keys()
        self.ious = {
            (img_id, cat_id): self._compute_iou(img_id, cat_id)
            for img_id in p.imgIds for cat_id in cats
        }
        max_det = p.maxDets[-1]
        self.evalImgs = {
            (img_id, cat_id, a): self._evaluate_img(img_id, cat_id,
                                                    p.areaRng[a], max_det)
            for img_id in p.imgIds for cat_id in cats
            for a in range(len(p.areaRng))
        }

    def _compute_iou(self, img_id, cat_id):
        gt = self._gts[img_id, cat_id]
        dt = self._dts[img_id, cat_id]
        if len(gt) == 0 or len(dt) == 0:
            return np.zeros((len(dt), len(gt)))
        dt = sorted(dt, key=lambda d: -d["score"])[:self.params.maxDets[-1]]
        iod_cols = np.asarray(
            [bool(x["_crowd_like"]) and self.use_iod_for_ignore for x in gt])
        # plain iscrowd always uses IoD (pycocotools semantics)
        crowd_cols = np.asarray([bool(x.get("iscrowd", 0)) for x in gt])
        if self.iouType == "segm":
            from .mask_utils import ann_to_rle, mask_iou
            info = self.cocoGt.load_imgs([img_id])[0]
            h, w = info["height"], info["width"]
            g_rle = [ann_to_rle(x["segmentation"], h, w) for x in gt]
            d_rle = [ann_to_rle(x["segmentation"], h, w) for x in dt]
            return mask_iou(d_rle, g_rle, iod_cols | crowd_cols,
                            native=self.native)
        d = np.asarray([x["bbox"] for x in dt], float)
        g = np.asarray([x["bbox"] for x in gt], float)
        return _bbox_iou_matrix(d, g, iod_cols | crowd_cols)

    def _evaluate_img(self, img_id, cat_id, a_rng, max_det):
        gt = self._gts[img_id, cat_id]
        dt = self._dts[img_id, cat_id]
        if len(gt) == 0 and len(dt) == 0:
            return None
        gt = [dict(g) for g in gt]
        for g in gt:
            area = g.get("area", g["bbox"][2] * g["bbox"][3])
            g["_ignore"] = int(g["_ignore_attr"]
                               or area < a_rng[0] or area > a_rng[1])
        # sort gts: non-ignored first (stable)
        gtind = np.argsort([g["_ignore"] for g in gt], kind="mergesort")
        gt = [gt[i] for i in gtind]
        dt = sorted(dt, key=lambda d: -d["score"])[:max_det]
        ious_full = self.ious[img_id, cat_id]
        ious = ious_full[:, gtind] if len(ious_full) else ious_full

        T = len(self.params.iouThrs)
        G = len(gt)
        D = len(dt)
        gtm = np.zeros((T, G))
        dtm = np.zeros((T, D))
        gt_ig = np.asarray([g["_ignore"] for g in gt])
        dt_ig = np.zeros((T, D))
        crowd_like = np.asarray(
            [bool(g["_crowd_like"] or g.get("iscrowd", 0)) for g in gt])

        if self.native and D and G:
            from .native import greedy_match_native
            thrs = np.asarray(self.params.iouThrs, float)
            iod_thrs = np.asarray([self.iod_th_of_iou_f(t) for t in thrs])
            dtm_idx, gtm_idx, dig = greedy_match_native(
                np.ascontiguousarray(ious), gt_ig.astype(np.uint8),
                crowd_like.astype(np.uint8), thrs, iod_thrs,
                self.use_iod_for_ignore)
            gt_ids = np.asarray([g["id"] for g in gt], np.int64)
            dt_ids = np.asarray([d["id"] for d in dt], np.int64)
            dtm = np.where(dtm_idx > 0,
                           gt_ids[np.clip(dtm_idx - 1, 0, G - 1)], 0)
            gtm = np.where(gtm_idx > 0,
                           dt_ids[np.clip(gtm_idx - 1, 0, max(D - 1, 0))], 0)
            dt_ig = dig.astype(float)
            return self._finish_eval_img(img_id, cat_id, a_rng, max_det,
                                         dt, gt, dtm, gtm, gt_ig, dt_ig)

        for tind, t in enumerate(self.params.iouThrs):
            iod_t = float(self.iod_th_of_iou_f(t))
            for dind in range(D):
                # Pass 1: best-IoU match among non-ignored gts at threshold t
                # (two-pass formulation of the pycocotools loop: dets prefer
                # real gts, falling back to ignore regions).
                best = min(t, 1 - 1e-10)
                m = -1
                for gind in range(G):
                    if gt_ig[gind]:
                        break  # sorted: ignored gts come last
                    if gtm[tind, gind] > 0:
                        continue
                    if ious[dind, gind] < best:
                        continue
                    best = ious[dind, gind]
                    m = gind
                if m == -1:
                    # Pass 2: ignore regions; IoD threshold when enabled
                    best2 = -1.0
                    for gind in range(G):
                        if not gt_ig[gind]:
                            continue
                        if gtm[tind, gind] > 0 and not crowd_like[gind]:
                            continue
                        thr = iod_t if (self.use_iod_for_ignore
                                        and crowd_like[gind]) else t
                        iou_dg = ious[dind, gind]
                        if iou_dg < max(min(thr, 1 - 1e-10), 1e-10):
                            continue
                        if iou_dg <= best2:
                            continue
                        best2 = iou_dg
                        m = gind
                if m == -1:
                    continue
                dt_ig[tind, dind] = gt_ig[m]
                dtm[tind, dind] = gt[m]["id"]
                gtm[tind, m] = dt[dind]["id"]
        return self._finish_eval_img(img_id, cat_id, a_rng, max_det, dt, gt,
                                     dtm, gtm, gt_ig, dt_ig)

    def _finish_eval_img(self, img_id, cat_id, a_rng, max_det, dt, gt,
                         dtm, gtm, gt_ig, dt_ig):
        T = dtm.shape[0]
        # dets outside the area range that matched nothing are ignored
        # (area = mask area for segm results, loadRes computes it)
        def _darea(d):
            return d.get("area", d["bbox"][2] * d["bbox"][3]
                         if "bbox" in d else 0.0)
        a = np.asarray([_darea(d) < a_rng[0] or _darea(d) > a_rng[1]
                        for d in dt])
        if len(dt):
            dt_ig = np.logical_or(dt_ig, np.logical_and(
                dtm == 0, np.tile(a, (T, 1))))
        return {
            "image_id": img_id, "category_id": cat_id, "aRng": a_rng,
            "maxDet": max_det,
            "dtIds": [d["id"] for d in dt],
            "gtIds": [g["id"] for g in gt],
            "dtMatches": dtm, "gtMatches": gtm,
            "dtScores": [d["score"] for d in dt],
            "gtIgnore": gt_ig, "dtIgnore": dt_ig,
        }

    # ------------------------------------------------------------ accumulate
    def accumulate(self):
        p = self.params
        T = len(p.iouThrs)
        R = len(p.recThrs)
        K = len(self._cat_keys())
        A = len(p.areaRng)
        M = len(p.maxDets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        scores = -np.ones((T, R, K, A, M))
        for k, cat_id in enumerate(self._cat_keys()):
            for a in range(A):
                E = [self.evalImgs.get((img_id, cat_id, a))
                     for img_id in p.imgIds]
                E = [e for e in E if e is not None]
                if not E:
                    continue
                for m, max_det in enumerate(p.maxDets):
                    dtm, dt_ig, ds = _merge_sorted(E, max_det)
                    npig = int(sum((e["gtIgnore"] == 0).sum() for e in E))
                    if npig == 0:
                        continue
                    tps = np.logical_and(dtm, np.logical_not(dt_ig))
                    fps = np.logical_and(np.logical_not(dtm),
                                         np.logical_not(dt_ig))
                    tp_sum = np.cumsum(tps, axis=1).astype(float)
                    fp_sum = np.cumsum(fps, axis=1).astype(float)
                    for t in range(T):
                        tp = tp_sum[t]
                        fp = fp_sum[t]
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / np.maximum(tp + fp, np.finfo(float).eps)
                        recall[t, k, a, m] = rc[-1] if nd else 0
                        q = np.zeros(R)
                        ss = np.zeros(R)
                        # make precision monotonically decreasing
                        pr = pr.tolist()
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds_r = np.searchsorted(rc, p.recThrs, side="left")
                        for ri, pi in enumerate(inds_r):
                            if pi < nd:
                                q[ri] = pr[pi]
                                ss[ri] = ds[pi]
                        precision[t, :, k, a, m] = q
                        scores[t, :, k, a, m] = ss
        self.eval = dict(precision=precision, recall=recall, scores=scores,
                         params=p)

    # ------------------------------------------------------------ summarize
    def _summarize(self, ap=1, iouThr=None, areaLbl="all", maxDet=100):
        p = self.params
        aind = [i for i, l in enumerate(p.areaRngLbl) if l == areaLbl]
        mind = [i for i, m in enumerate(p.maxDets) if m == maxDet]
        if ap == 1:
            s = self.eval["precision"]
            if iouThr is not None:
                t = np.where(np.isclose(p.iouThrs, iouThr))[0]
                s = s[t]
            s = s[:, :, :, aind, mind]
        else:
            s = self.eval["recall"]
            if iouThr is not None:
                t = np.where(np.isclose(p.iouThrs, iouThr))[0]
                s = s[t]
            s = s[:, :, aind, mind]
        if len(s[s > -1]) == 0:
            return -1.0
        return float(np.mean(s[s > -1]))

    def summarize(self):
        p = self.params
        stats = OrderedDict()
        max_det = p.maxDets[-1]
        stats[f"mAP_{p.areaRngLbl[0]}"] = self._summarize(1, None, "all", max_det)
        for t in p.iouThrs:
            for lbl in p.areaRngLbl:
                key = f"AP{int(round(t * 100))}_{lbl}"
                stats[key] = self._summarize(1, float(t), lbl, max_det)
        for lbl in p.areaRngLbl:
            stats[f"AR_{lbl}"] = self._summarize(0, None, lbl, max_det)
        self.stats_dict = stats
        self.stats = np.asarray(list(stats.values()))
        return stats

    def classwise_summary(self, cat_names=None) -> "OrderedDict[str, float]":
        """Per-class AP at the primary IoU (reference cocofmt.py:434-445
        AsciiTable)."""
        p = self.params
        precision = self.eval["precision"]  # (T, R, K, A, M)
        out = OrderedDict()
        for k, cat_id in enumerate(p.catIds):
            s = precision[:, :, k, 0, -1]
            ap = float(np.mean(s[s > -1])) if (s > -1).any() else -1.0
            name = (cat_names[k] if cat_names is not None
                    and k < len(cat_names) else str(cat_id))
            out[name] = ap
        return out


def _merge_sorted(E, max_det):
    """Concatenate per-image det matches capped at max_det, sorted by score
    across images (pycocotools accumulate parity)."""
    dt_scores = np.concatenate(
        [np.asarray(e["dtScores"][:max_det]) for e in E])
    inds = np.argsort(-dt_scores, kind="mergesort")
    dtm = np.concatenate([e["dtMatches"][:, :max_det] for e in E],
                         axis=1)[:, inds]
    dt_ig = np.concatenate([e["dtIgnore"][:, :max_det] for e in E],
                           axis=1)[:, inds]
    return dtm, dt_ig, dt_scores[inds]
