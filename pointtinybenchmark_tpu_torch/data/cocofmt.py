"""CocoFmtDataset: the COCO-format dataset of the TinyPerson workflow.

The port's own copy of pointtinybenchmark_tpu/data/cocofmt.py::
CocoFmtDataset (mmdet datasets/cocofmt.py of the fork, with the
CocoDataset / CustomDataset machinery it inherits), host numpy:
- class discovery when classes=None; `min_gt_size` and empty-gt image
  filtering; the aspect-ratio group `flag`;
- `ignore` annotations dropped from training (train_ignore_as_bg); `true_bbox`
  and the annotation ids per kept box;
- the corner (tile) dataset made on the fly (`corner_kwargs`,
  data/tiling.py) and the point workflow's pseudo boxes (`noise_kwargs`,
  data/noise.py); precomputed proposals (`proposal_file`);
- a numpy RandomState per sample, seeded by (seed, epoch, index), which
  the pipeline's random transforms draw from;
- `format_results` / `format_segm_results` (COCO result json) and
  `evaluate` for bbox, segm and proposal (COCOExpandEval, with the tiny
  standard), proposal_fast (evaluation/recall.py::eval_recalls) or the
  location metric (evaluation/location_eval.py), after the offline tile
  merge where `merge_after_infer_kwargs` asks for it
  (evaluation/merge.py: a corner set's detections shifted into their
  original image and merged by a host NMS).

Its subclasses (::LVISDataset, ::CityscapesDataset, ::DeepFashionDataset):
- `LVISDataset`: file names from `coco_url` (its last two parts; a
  `COCO_..._<id>.jpg` name keeps its last part) and the LVIS evaluation
  (evaluation/lvis_eval.py: the federated drop, the not-exhaustive ignore,
  APr / APc / APf at maxDets 300);
- `CityscapesDataset`: the 8 Cityscapes classes, the COCO metrics; the
  cityscapesscripts protocol (`metric="cityscapes"`) needs that package
  and raises JAX's ImportError without it;
- `DeepFashionDataset`: the 15 DeepFashion classes, the COCO metrics.
"""
from __future__ import annotations

import os.path as osp
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..utils.logging import get_root_logger
from ..utils.registry import DATASETS
from .coco import COCO
from .transforms import Compose

__all__ = ["CocoFmtDataset", "CityscapesDataset", "DeepFashionDataset",
           "LVISDataset"]


@DATASETS.register_module()
class CocoFmtDataset:
    CLASSES: Optional[Sequence[str]] = None

    def __init__(self,
                 ann_file: str,
                 pipeline: Sequence[dict],
                 classes: Optional[Sequence[str]] = None,
                 data_root: Optional[str] = None,
                 img_prefix: str = "",
                 test_mode: bool = False,
                 filter_empty_gt: bool = True,
                 min_gt_size: Optional[float] = None,
                 train_ignore_as_bg: bool = True,
                 corner_kwargs: Optional[dict] = None,
                 noise_kwargs: Optional[dict] = None,
                 merge_after_infer_kwargs: Optional[dict] = None,
                 proposal_file: Optional[str] = None,
                 seed: int = 0):
        if data_root is not None:
            if not osp.isabs(ann_file):
                ann_file = osp.join(data_root, ann_file)
            if img_prefix and not osp.isabs(img_prefix):
                img_prefix = osp.join(data_root, img_prefix)
            if proposal_file and not osp.isabs(proposal_file):
                proposal_file = osp.join(data_root, proposal_file)
        if corner_kwargs is not None:
            from .tiling import generate_corner_json_file_if_not_exist
            ann_file = generate_corner_json_file_if_not_exist(
                ann_file, data_root, dict(corner_kwargs))
        if noise_kwargs is not None:
            from .noise import generate_pseudo_bbox_for_noise_data
            ann_file = generate_pseudo_bbox_for_noise_data(
                ann_file, data_root, dict(noise_kwargs))

        self.ann_file = ann_file
        self.img_prefix = img_prefix
        self.test_mode = test_mode
        self.filter_empty_gt = filter_empty_gt
        self.min_gt_size = min_gt_size
        self.train_ignore_as_bg = train_ignore_as_bg
        self.merge_after_infer_kwargs = merge_after_infer_kwargs
        self.seed = seed

        self.classes = list(classes) if classes is not None else None
        self.data_infos = self.load_annotations(ann_file)

        if not test_mode:
            valid_inds = self._filter_imgs()
            self.data_infos = [self.data_infos[i] for i in valid_inds]
            self._set_group_flag()
        else:
            self.flag = np.zeros(len(self.data_infos), np.uint8)

        self.proposals = (self.load_proposals(proposal_file)
                          if proposal_file else None)
        self.pipeline = Compose(pipeline)
        self._epoch = 0

    def load_proposals(self, proposal_file: str) -> List[np.ndarray]:
        """Precomputed per-image proposals (mmdet custom.py:115,
        mmcv.load of a pickle list of (n, 4|5) arrays aligned with
        data_infos; .json alternative maps image_id -> list of boxes)."""
        if proposal_file.endswith(".json"):
            import json
            with open(proposal_file) as f:
                by_img = json.load(f)
            raw = [by_img.get(str(info["id"]), [])
                   for info in self.data_infos]
        else:
            import pickle
            with open(proposal_file, "rb") as f:
                raw = pickle.load(f)
            assert len(raw) == len(self.data_infos), (
                f"proposal count {len(raw)} != image count "
                f"{len(self.data_infos)}")
        return [np.asarray(p, np.float32).reshape(-1, 5)
                if len(p) and np.asarray(p).shape[-1] == 5
                else np.asarray(p, np.float32).reshape(-1, 4)
                for p in raw]

    # ------------------------------------------------------------- loading
    def load_annotations(self, ann_file: str) -> List[dict]:
        self.coco = COCO(ann_file)
        if self.classes is None:
            self.classes = [c["name"] for c in
                            self.coco.dataset.get("categories", [])]
        type(self).CLASSES = self.classes
        self.cat_ids = self.coco.get_cat_ids(cat_names=self.classes)
        self.cat2label = {cid: i for i, cid in enumerate(self.cat_ids)}
        self.img_ids = self.coco.get_img_ids()
        infos = []
        for i in self.img_ids:
            info = self.coco.load_imgs([i])[0]
            if "file_name" not in info:  # LVIS-style: derive from coco_url
                info["file_name"] = "/".join(
                    info.get("coco_url", "").split("/")[-2:])
            info["filename"] = info["file_name"]
            infos.append(info)
        return infos

    def _filter_imgs(self, min_size: int = 32) -> List[int]:
        valid_inds, valid_img_ids = [], []
        ids_with_ann = {a["image_id"] for a in
                        self.coco.dataset.get("annotations", [])}
        for i, info in enumerate(self.data_infos):
            img_id = info["id"]
            if self.filter_empty_gt and img_id not in ids_with_ann:
                continue
            if min(info["width"], info["height"]) < min_size:
                continue
            if self.min_gt_size:
                ok = False
                for ann in self.coco.img_ann_map[img_id]:
                    if ann.get("ignore", False):
                        continue
                    if (ann["bbox"][3] > self.min_gt_size
                            and ann["bbox"][2] > self.min_gt_size):
                        ok = True
                        break
                if not ok:
                    continue
            valid_inds.append(i)
            valid_img_ids.append(img_id)
        self.img_ids = valid_img_ids
        get_root_logger().info("valid image count: %d", len(valid_inds))
        return valid_inds

    def _set_group_flag(self):
        """The aspect-ratio group flag of the GroupSampler: 1 where w > h."""
        self.flag = np.zeros(len(self.data_infos), np.uint8)
        for i, info in enumerate(self.data_infos):
            if info["width"] / info["height"] > 1:
                self.flag[i] = 1

    def get_ann_info(self, idx: int) -> dict:
        img_info = self.data_infos[idx]
        ann_info = self.coco.img_ann_map[img_info["id"]]
        return self._parse_ann_info(img_info, ann_info)

    def _parse_ann_info(self, img_info: dict, ann_info: List[dict]) -> dict:
        gt_bboxes, gt_labels, gt_bboxes_ignore = [], [], []
        true_bboxes, anns_id, gt_masks = [], [], []
        for ann in ann_info:
            if self.train_ignore_as_bg and ann.get("ignore", False):
                continue
            x1, y1, w, h = ann["bbox"]
            inter_w = max(0, min(x1 + w, img_info["width"]) - max(x1, 0))
            inter_h = max(0, min(y1 + h, img_info["height"]) - max(y1, 0))
            if inter_w * inter_h == 0:
                continue
            if ann.get("area", w * h) <= 0 or w < 1 or h < 1:
                continue
            if ann["category_id"] not in self.cat_ids:
                continue
            bbox = [x1, y1, x1 + w, y1 + h]
            if ann.get("iscrowd", False):
                gt_bboxes_ignore.append(bbox)
            else:
                gt_bboxes.append(bbox)
                gt_labels.append(self.cat2label[ann["category_id"]])
                if "true_bbox" in ann:
                    tx, ty, tw, th = ann["true_bbox"]
                    true_bboxes.append([tx, ty, tx + tw, ty + th])
                anns_id.append(ann["id"])
                gt_masks.append(ann.get("segmentation"))

        out = dict(
            bboxes=np.asarray(gt_bboxes, np.float32).reshape(-1, 4),
            labels=np.asarray(gt_labels, np.int64),
            anns_id=np.asarray(anns_id, np.int64),
            bboxes_ignore=np.asarray(gt_bboxes_ignore,
                                     np.float32).reshape(-1, 4),
            masks=gt_masks,
        )
        if true_bboxes:
            out["true_bboxes"] = np.asarray(true_bboxes, np.float32)
        return out

    # ------------------------------------------------------------- access
    def __len__(self) -> int:
        return len(self.data_infos)

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __getitem__(self, idx: int) -> Optional[dict]:
        if self.test_mode:
            return self.prepare_test_img(idx)
        return self.prepare_train_img(idx)

    def _base_results(self, idx: int) -> dict:
        results = dict(
            img_info=self.data_infos[idx],
            img_prefix=self.img_prefix,
            bbox_fields=[],
            _rng=np.random.RandomState(
                (self.seed * 1_000_003 + self._epoch * 10_007 + idx)
                % (2 ** 31)),
        )
        if self.proposals is not None:
            results["proposals"] = self.proposals[idx]
        return results

    def prepare_train_img(self, idx: int) -> Optional[dict]:
        results = self._base_results(idx)
        results["ann_info"] = self.get_ann_info(idx)
        return self.pipeline(results)

    def prepare_test_img(self, idx: int) -> Optional[dict]:
        results = self._base_results(idx)
        # val pipelines may Collect gt_* (the CPR eval path needs them)
        results["ann_info"] = self.get_ann_info(idx)
        return self.pipeline(results)

    # ---------------------------------------------------------- evaluation
    def format_results(self, results: List[dict]) -> List[dict]:
        """results: per-image list of dicts with 'bboxes' (n,5 xyxy+score),
        'labels' (n,), optional 'anns_id'. Returns COCO det json list."""
        json_results = []
        for idx, res in enumerate(results):
            img_id = self.img_ids[idx]
            bboxes = np.asarray(res["bboxes"])
            labels = np.asarray(res["labels"])
            for i in range(len(bboxes)):
                x1, y1, x2, y2, score = bboxes[i][:5]
                det = dict(
                    image_id=int(img_id),
                    bbox=[float(x1), float(y1), float(x2 - x1), float(y2 - y1)],
                    score=float(score),
                    category_id=int(self.cat_ids[int(labels[i])]),
                )
                if "anns_id" in res:
                    det["ann_id"] = int(res["anns_id"][i])
                if "points" in res:
                    det["point"] = [float(v) for v in res["points"][i][:2]]
                json_results.append(det)
        return json_results

    def format_segm_results(self, results: List[dict]) -> List[dict]:
        """Segm json (mmdet coco.py:237-273 _segm2json): per-image
        results must carry 'masks' (list of RLE dicts aligned with
        'bboxes'), optionally 'mask_scores' (MaskScoring head)."""
        json_results = []
        for idx, res in enumerate(results):
            img_id = self.img_ids[idx]
            bboxes = np.asarray(res["bboxes"])
            labels = np.asarray(res["labels"])
            masks = res.get("masks", [])
            mask_scores = res.get("mask_scores")
            for i in range(min(len(bboxes), len(masks))):
                score = (float(mask_scores[i]) if mask_scores is not None
                         else float(bboxes[i][4]))
                rle = dict(masks[i])
                if isinstance(rle.get("counts"), bytes):
                    rle["counts"] = rle["counts"].decode()
                # no 'bbox' key: mask-extent bbox/area are derived by
                # loadRes for accurate s/m/l mask AP (mmdet
                # coco.py:449-460)
                json_results.append(dict(
                    image_id=int(img_id), score=score,
                    category_id=int(self.cat_ids[int(labels[i])]),
                    segmentation=rle))
        return json_results

    def evaluate(self,
                 results: List[dict],
                 metric: str = "bbox",
                 logger=None,
                 iou_thrs=None,
                 proposal_nums=(100, 300, 1000),
                 classwise: bool = False,
                 use_location_metric: bool = False,
                 location_kwargs: Optional[dict] = None,
                 cocofmt_kwargs: Optional[dict] = None,
                 save_result_file: Optional[str] = None,
                 native: bool = True,
                 **kwargs) -> Dict[str, float]:
        """Evaluate detections (mmdet cocofmt.py:227-464 of the fork):
        the metrics in order, as COCOExpandEval.summarize gives them.
        `native` picks COCOExpandEval's native matching or its Python
        reference loops."""
        import json

        det_json = self.format_results(results)
        gt_coco = self.coco

        # the offline corner set's tile merge (cocofmt.py:310-317 of the fork)
        if self.merge_after_infer_kwargs:
            from ..evaluation.merge import merge_det_result
            mk = self.merge_after_infer_kwargs
            det_json, gt_coco = merge_det_result(
                det_json, self.coco, mk.get("merge_gt_file"),
                nms_th=mk.get("merge_nms_th", 0.5))

        if save_result_file:
            with open(save_result_file, "w") as f:
                json.dump(det_json, f)
            get_root_logger().info("saved result to %s", save_result_file)

        if use_location_metric:
            from ..evaluation.location_eval import LocationEvaluator
            lk = dict(location_kwargs or {})
            ev = LocationEvaluator(**lk)
            return ev(det_json, gt_coco)

        from ..evaluation.cocoeval import COCOExpandEval
        metrics = metric if isinstance(metric, (list, tuple)) else [metric]
        allowed = ("bbox", "segm", "proposal", "proposal_fast")
        for m in metrics:
            assert m in allowed, f"metric {m} is not supported"
        pn = (list(proposal_nums) if isinstance(proposal_nums, (list, tuple))
              else [proposal_nums]) if proposal_nums is not None else None

        def build_param(extra_ck=None):
            ck = dict(cocofmt_kwargs or {})
            if extra_ck:
                ck.update(extra_ck)
            cocofmt_param = dict(ck.pop("cocofmt_param", {}))
            if iou_thrs is not None:
                cocofmt_param.setdefault("iouThrs", list(iou_thrs))
            if pn is not None:
                cocofmt_param.setdefault("maxDets", pn)
            return ck, cocofmt_param

        out: "OrderedDict[str, float]" = OrderedDict()
        prefix_keys = len(metrics) > 1

        def emit(m, stats):
            for k, v in stats.items():
                out[f"{m}_{k}" if prefix_keys else k] = v

        for m in metrics:
            if m == "proposal_fast":
                # mmdet coco.py:432-441 fast_eval_recall
                from ..evaluation.recall import eval_recalls
                gts = []
                for img_id in self.img_ids:
                    anns = gt_coco.load_anns(
                        gt_coco.get_ann_ids(img_ids=[img_id]))
                    boxes = [[a["bbox"][0], a["bbox"][1],
                              a["bbox"][0] + a["bbox"][2],
                              a["bbox"][1] + a["bbox"][3]] for a in anns
                             if not (a.get("ignore") or a.get("iscrowd"))]
                    gts.append(np.asarray(boxes, np.float32).reshape(-1, 4))
                props = [np.asarray(r["bboxes"], np.float32).reshape(-1, 5)
                         for r in results]
                thrs = (np.asarray(iou_thrs) if iou_thrs is not None
                        else np.arange(0.5, 0.96, 0.05))
                nums = pn or [100, 300, 1000]
                ar = eval_recalls(gts, props, nums, thrs).mean(axis=1)
                for i, num in enumerate(nums):
                    out[f"AR@{num}"] = float(ar[i])
                continue

            if m == "segm":
                segm_json = self.format_segm_results(results)
                if not segm_json:
                    get_root_logger().warning(
                        "segm metric requested but results carry no masks")
                    continue
                ck, cocofmt_param = build_param()
                ev = COCOExpandEval(gt_coco, gt_coco.loadRes(segm_json),
                                    "segm", cocofmt_param=cocofmt_param,
                                    native=native, **ck)
                ev.evaluate()
                ev.accumulate()
                emit(m, ev.summarize())
                continue

            ck, cocofmt_param = build_param()
            ev = COCOExpandEval(gt_coco, gt_coco.loadRes(det_json), "bbox",
                                cocofmt_param=cocofmt_param, native=native,
                                **ck)
            if m == "proposal":
                # class-agnostic AR (mmdet coco.py:494-507: useCats=0)
                ev.params.useCats = 0
                ev.evaluate()
                ev.accumulate()
                ev.summarize()
                for md in ev.params.maxDets:
                    out[f"AR@{md}"] = ev._summarize(0, None, "all", md)
                for lbl in ev.params.areaRngLbl[1:]:
                    out[f"AR_{lbl}@{ev.params.maxDets[-1]}"] = \
                        ev._summarize(0, None, lbl, ev.params.maxDets[-1])
                continue
            ev.evaluate()
            ev.accumulate()
            stats = ev.summarize()
            if classwise:
                names = [c.get("name", str(cid)) for cid, c in
                         sorted(gt_coco.cats.items())]
                for n, ap in ev.classwise_summary(names).items():
                    stats[f"classwise_{n}"] = ap
            emit(m, stats)
        return out


@DATASETS.register_module()
class LVISDataset(CocoFmtDataset):
    """LVIS v1 (mmdet datasets/lvis.py)."""

    def load_annotations(self, ann_file: str) -> List[dict]:
        infos = super().load_annotations(ann_file)
        for info in infos:
            if not info.get("file_name"):
                url = info.get("coco_url", "")
                info["file_name"] = "/".join(url.split("/")[-2:])
                info["filename"] = info["file_name"]
            elif info["file_name"].startswith("COCO_"):
                info["file_name"] = info["file_name"].split("_")[-1]
                info["filename"] = info["file_name"]
        return infos

    def evaluate(self, results: List[dict], metric="bbox", logger=None,
                 iou_thrs=None, proposal_nums=300, classwise: bool = False,
                 save_result_file: Optional[str] = None, native: bool = True,
                 **kwargs) -> Dict[str, float]:
        """The LVIS metrics of each of `metric` (bbox, segm or proposal),
        prefixed by the metric's name when there are several, at maxDets
        the last of `proposal_nums`. `native` picks the native matching or
        the Python reference loops."""
        import json

        from ..evaluation.lvis_eval import LVISExpandEval

        metrics = metric if isinstance(metric, (list, tuple)) else [metric]
        out: "OrderedDict[str, float]" = OrderedDict()
        prefix = len(metrics) > 1
        max_det = (proposal_nums[-1] if isinstance(proposal_nums,
                                                   (list, tuple))
                   else int(proposal_nums))
        for m in metrics:
            res_json = (self.format_segm_results(results) if m == "segm"
                        else self.format_results(results))
            if save_result_file and m == metrics[0]:
                with open(save_result_file, "w") as f:
                    json.dump(res_json, f)
            cocofmt_param = {}
            if iou_thrs is not None:
                cocofmt_param["iouThrs"] = list(iou_thrs)
            ev = LVISExpandEval(self.coco, self.coco.loadRes(res_json),
                                "segm" if m == "segm" else "bbox",
                                max_dets=max_det,
                                cocofmt_param=cocofmt_param, native=native)
            if m == "proposal":
                ev.params.useCats = 0
            ev.evaluate()
            ev.accumulate()
            for k, v in ev.summarize().items():
                out[f"{m}_{k}" if prefix else k] = v
        return out


@DATASETS.register_module()
class CityscapesDataset(CocoFmtDataset):
    """Cityscapes instances in COCO format (mmdet datasets/cityscapes.py):
    the COCO metrics; `metric="cityscapes"` needs cityscapesscripts."""
    CLASSES = ("person", "rider", "car", "truck", "bus", "train",
               "motorcycle", "bicycle")

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("classes", list(self.CLASSES))
        super().__init__(*args, **kwargs)

    def evaluate(self, results: List[dict], metric="bbox",
                 **kwargs) -> Dict[str, float]:
        metrics = metric if isinstance(metric, (list, tuple)) else [metric]
        if "cityscapes" in metrics:
            try:
                import cityscapesscripts  # noqa: F401
            except ImportError as e:
                raise ImportError(
                    "metric='cityscapes' needs the cityscapesscripts "
                    "package (pip install cityscapesscripts); use "
                    "metric='bbox'/'segm' for the native COCO-protocol "
                    "evaluation instead") from e
            metrics = [m for m in metrics if m != "cityscapes"]
        if not metrics:
            return OrderedDict()
        return super().evaluate(results, metric=list(metrics), **kwargs)


@DATASETS.register_module()
class DeepFashionDataset(CocoFmtDataset):
    """DeepFashion In-shop in COCO format (mmdet datasets/deepfashion.py)."""
    CLASSES = ("top", "skirt", "leggings", "dress", "outer", "pants", "bag",
               "neckwear", "headwear", "eyeglass", "belt", "footwear",
               "hair", "skin", "face")

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("classes", list(self.CLASSES))
        super().__init__(*args, **kwargs)
