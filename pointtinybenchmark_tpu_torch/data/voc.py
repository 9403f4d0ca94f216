"""PASCAL VOC (XML) dataset.

The port's own copy of pointtinybenchmark_tpu/data/voc.py (mmdet
datasets/voc.py + xml_style.py): XML annotation
parsing, `difficult` (and boxes under `min_size`) as ignore regions, the
aspect `flag`, and `evaluate`: mAP by evaluation/mean_ap.py::eval_map
(11 points for a VOC2007 ann_file, else the area), or recall by
evaluation/recall.py::eval_recalls.

`ann_file` is one image-id list. A list of them (mmdet's form for VOC
07+12, configs/_base_/datasets/voc0712.py) raises: the JAX package opens
it as one file and fails with a TypeError, so there is no JAX dataset to
match; a ConcatDataset of one VOCDataset per split is the form both
packages load.
"""
from __future__ import annotations

import os.path as osp
import xml.etree.ElementTree as ET
from typing import List, Optional, Sequence

import numpy as np

from ..utils.registry import DATASETS
from .transforms import Compose

__all__ = ["VOCDataset", "WIDERFaceDataset"]

VOC_CLASSES = ("aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
               "car", "cat", "chair", "cow", "diningtable", "dog", "horse",
               "motorbike", "person", "pottedplant", "sheep", "sofa",
               "train", "tvmonitor")


@DATASETS.register_module()
class VOCDataset:
    CLASSES = VOC_CLASSES

    def __init__(self, ann_file: str, pipeline: Sequence[dict],
                 img_prefix: str = "", img_subdir: str = "JPEGImages",
                 ann_subdir: str = "Annotations",
                 classes: Optional[Sequence[str]] = None,
                 test_mode: bool = False, min_size: Optional[float] = None,
                 seed: int = 0):
        self.img_prefix = img_prefix
        self.img_subdir = img_subdir
        self.ann_subdir = ann_subdir
        self.classes = list(classes) if classes else list(self.CLASSES)
        self.cat2label = {c: i for i, c in enumerate(self.classes)}
        self.test_mode = test_mode
        self.min_size = min_size
        self.seed = seed
        self._epoch = 0
        if not isinstance(ann_file, str):
            raise TypeError(
                f"VOCDataset takes one ann_file, not {type(ann_file).__name__}"
                f" {ann_file!r}: the JAX package cannot load a list either "
                f"(data/voc.py opens it as one file); give a ConcatDataset "
                f"of one VOCDataset per split")
        self.ann_file = ann_file
        with open(ann_file) as f:
            self.img_ids = [line.strip() for line in f if line.strip()]
        self.data_infos = self._load_infos()
        self.flag = np.zeros(len(self.data_infos), np.uint8)
        for i, info in enumerate(self.data_infos):
            if info["width"] / max(info["height"], 1) > 1:
                self.flag[i] = 1
        self.pipeline = Compose(pipeline)

    def _load_infos(self) -> List[dict]:
        infos = []
        for img_id in self.img_ids:
            xml_path = osp.join(self.img_prefix, self.ann_subdir,
                                f"{img_id}.xml")
            width = height = 0
            if osp.exists(xml_path):
                root = ET.parse(xml_path).getroot()
                size = root.find("size")
                if size is not None:
                    width = int(size.find("width").text)
                    height = int(size.find("height").text)
            infos.append(dict(
                id=img_id, filename=osp.join(self.img_subdir,
                                             f"{img_id}.jpg"),
                file_name=osp.join(self.img_subdir, f"{img_id}.jpg"),
                width=width, height=height))
        return infos

    def __len__(self):
        return len(self.data_infos)

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def get_ann_info(self, idx: int) -> dict:
        img_id = self.data_infos[idx]["id"]
        xml_path = osp.join(self.img_prefix, self.ann_subdir,
                            f"{img_id}.xml")
        bboxes, labels, bboxes_ignore = [], [], []
        if osp.exists(xml_path):
            root = ET.parse(xml_path).getroot()
            for obj in root.findall("object"):
                name = obj.find("name").text
                if name not in self.cat2label:
                    continue
                difficult = int(obj.find("difficult").text
                                if obj.find("difficult") is not None else 0)
                bb = obj.find("bndbox")
                box = [float(bb.find(k).text) - (1 if k.startswith(("xmi",
                                                                    "ymi"))
                                                 else 0)
                       for k in ("xmin", "ymin", "xmax", "ymax")]
                w, h = box[2] - box[0], box[3] - box[1]
                ignore = difficult or (self.min_size and
                                       (w < self.min_size
                                        or h < self.min_size))
                if ignore:
                    bboxes_ignore.append(box)
                else:
                    bboxes.append(box)
                    labels.append(self.cat2label[name])
        return dict(
            bboxes=np.asarray(bboxes, np.float32).reshape(-1, 4),
            labels=np.asarray(labels, np.int64),
            anns_id=np.arange(len(bboxes), dtype=np.int64),
            bboxes_ignore=np.asarray(bboxes_ignore,
                                     np.float32).reshape(-1, 4))

    def __getitem__(self, idx: int):
        results = dict(
            img_info=self.data_infos[idx],
            ann_info=self.get_ann_info(idx),
            img_prefix=self.img_prefix,
            bbox_fields=[],
            _rng=np.random.RandomState(
                (self.seed * 1_000_003 + self._epoch * 10_007 + idx)
                % (2 ** 31)),
        )
        return self.pipeline(results)

    def evaluate(self, results, metric="mAP", iou_thr=0.5,
                 scale_ranges=None, proposal_nums=(100, 300, 1000),
                 **kwargs):
        """VOC-protocol evaluation (reference datasets/voc.py:36-86 +
        core/evaluation/mean_ap.py): true VOC-style eval_map — 11-point
        interpolation for VOC2007 ann paths, precision-envelope area
        otherwise — with difficult boxes as ignore regions. metric can
        also be 'recall' (eval_recalls semantics)."""
        from ..evaluation.mean_ap import eval_map

        annotations = [self.get_ann_info(i) for i in range(len(self))]
        num_classes = len(self.classes)
        det_results = []
        for res in results:
            bboxes = np.asarray(res["bboxes"], np.float32).reshape(-1, 5)
            labels = np.asarray(res["labels"]).reshape(-1)
            det_results.append([bboxes[labels == c] for c in
                                range(num_classes)])
        anns = []
        for ann in annotations:
            item = dict(bboxes=ann["bboxes"], labels=ann["labels"])
            if len(ann.get("bboxes_ignore", [])):
                item["bboxes_ignore"] = ann["bboxes_ignore"]
                item["labels_ignore"] = ann.get(
                    "labels_ignore",
                    np.zeros(len(ann["bboxes_ignore"]), np.int64))
            else:
                item["labels_ignore"] = None
            anns.append(item)

        if metric == "recall":
            from ..evaluation.recall import eval_recalls
            gt_list = [a["bboxes"] for a in anns]
            all_det = [np.vstack([d for d in img]) for img in det_results]
            recalls = eval_recalls(gt_list, all_det, list(proposal_nums),
                                   iou_thrs=[iou_thr])
            return {f"recall@{n}": float(recalls[i, 0])
                    for i, n in enumerate(proposal_nums)}

        ds_name = "voc07" if "VOC2007" in str(self.ann_file) else None
        mean_ap, per_cls = eval_map(det_results, anns,
                                    scale_ranges=scale_ranges,
                                    iou_thr=iou_thr, dataset=ds_name)
        out = {"mAP": float(mean_ap)}
        for c, r in enumerate(per_cls):
            out[f"AP_{self.classes[c]}"] = float(np.mean(r["ap"]))
        return out


@DATASETS.register_module()
class WIDERFaceDataset(VOCDataset):
    """WIDER Face in PASCAL-VOC XML layout (reference
    mmdet/datasets/wider_face.py — single 'face' class; image paths keep
    the WIDER event-folder prefix)."""
    CLASSES = ("face",)
