"""A COCO-format annotation API in numpy (no pycocotools).

The port's own copy of pointtinybenchmark_tpu/data/coco.py: the subset of
pycocotools.coco.COCO that the datasets and the evaluation use (getAnnIds,
getCatIds, getImgIds, loadAnns, loadCats, loadImgs, imgToAnns, the
anns / cats / imgs dicts, and loadRes, which gives segmentation results
their mask area and mask-extent box).
"""
from __future__ import annotations

import copy
import json
from collections import defaultdict
from typing import Any, Dict, List, Optional, Union

__all__ = ["COCO"]


def _as_list(x) -> list:
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


class COCO:
    def __init__(self, annotation_file: Optional[Union[str, dict]] = None):
        self.dataset: Dict[str, Any] = {}
        self.anns: Dict[int, dict] = {}
        self.cats: Dict[int, dict] = {}
        self.imgs: Dict[int, dict] = {}
        self.img_ann_map = defaultdict(list)   # imgToAnns
        self.cat_img_map = defaultdict(list)   # catToImgs
        if annotation_file is not None:
            if isinstance(annotation_file, dict):
                self.dataset = annotation_file
            else:
                with open(annotation_file, "r") as f:
                    self.dataset = json.load(f)
            assert isinstance(self.dataset, dict)
            self.create_index()

    def create_index(self):
        anns, cats, imgs = {}, {}, {}
        img_ann_map = defaultdict(list)
        cat_img_map = defaultdict(list)
        for ann in self.dataset.get("annotations", []):
            img_ann_map[ann["image_id"]].append(ann)
            anns[ann["id"]] = ann
        for img in self.dataset.get("images", []):
            imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            cats[cat["id"]] = cat
        for ann in self.dataset.get("annotations", []):
            if "category_id" in ann:
                cat_img_map[ann["category_id"]].append(ann["image_id"])
        self.anns = anns
        self.imgs = imgs
        self.cats = cats
        self.img_ann_map = img_ann_map
        self.cat_img_map = cat_img_map

    # pycocotools-compatible camelCase + mmdet snake_case aliases ----------
    def get_ann_ids(self, img_ids=None, cat_ids=None, area_rng=None,
                    iscrowd=None) -> List[int]:
        img_ids = _as_list(img_ids)
        cat_ids = _as_list(cat_ids)
        if img_ids:
            anns = []
            for i in img_ids:
                anns.extend(self.img_ann_map[i])
        else:
            anns = list(self.dataset.get("annotations", []))
        if cat_ids:
            cs = set(cat_ids)
            anns = [a for a in anns if a.get("category_id") in cs]
        if area_rng:
            anns = [a for a in anns
                    if area_rng[0] < a.get("area", 0) < area_rng[1]]
        if iscrowd is not None:
            anns = [a for a in anns if a.get("iscrowd", 0) == iscrowd]
        return [a["id"] for a in anns]

    def get_cat_ids(self, cat_names=None, sup_names=None, cat_ids=None) -> List[int]:
        cat_names = _as_list(cat_names)
        sup_names = _as_list(sup_names)
        cat_ids = _as_list(cat_ids)
        cats = list(self.dataset.get("categories", []))
        if cat_names:
            cats = [c for c in cats if c["name"] in cat_names]
        if sup_names:
            cats = [c for c in cats if c.get("supercategory") in sup_names]
        if cat_ids:
            cs = set(cat_ids)
            cats = [c for c in cats if c["id"] in cs]
        return [c["id"] for c in cats]

    def get_img_ids(self, img_ids=None, cat_ids=None) -> List[int]:
        img_ids = _as_list(img_ids)
        cat_ids = _as_list(cat_ids)
        if not img_ids and not cat_ids:
            return list(self.imgs.keys())
        ids = set(img_ids) if img_ids else None
        for i, cat_id in enumerate(cat_ids):
            imgs_with_cat = set(self.cat_img_map[cat_id])
            ids = imgs_with_cat if ids is None else (
                ids & imgs_with_cat if img_ids or i > 0 else imgs_with_cat)
        return list(ids) if ids is not None else list(self.imgs.keys())

    def load_anns(self, ids) -> List[dict]:
        return [self.anns[i] for i in _as_list(ids)]

    def load_cats(self, ids) -> List[dict]:
        return [self.cats[i] for i in _as_list(ids)]

    def load_imgs(self, ids) -> List[dict]:
        return [self.imgs[i] for i in _as_list(ids)]

    # camelCase aliases (pycocotools API)
    getAnnIds = get_ann_ids
    getCatIds = get_cat_ids
    getImgIds = get_img_ids
    loadAnns = load_anns
    loadCats = load_cats
    loadImgs = load_imgs

    @property
    def imgToAnns(self):
        return self.img_ann_map

    def loadRes(self, results: Union[str, List[dict]]) -> "COCO":
        """Create a result COCO from a detection list (pycocotools parity:
        each det dict has image_id, category_id, bbox [x,y,w,h], score)."""
        res = COCO()
        res.dataset = {"images": [img for img in self.dataset.get("images", [])],
                       "categories": copy.deepcopy(self.dataset.get("categories", []))}
        if isinstance(results, str):
            with open(results) as f:
                results = json.load(f)
        anns = copy.deepcopy(results)
        for i, ann in enumerate(anns):
            if "segmentation" in ann:
                # pycocotools: segm results get mask area + mask-extent bbox
                from ..evaluation.mask_utils import (ann_to_rle, rle_area,
                                                     rle_to_bbox)
                seg = ann["segmentation"]
                if isinstance(seg, dict):
                    rle = ann_to_rle(seg, *seg["size"])
                else:
                    info = self.imgs[ann["image_id"]]
                    rle = ann_to_rle(seg, info["height"], info["width"])
                ann.setdefault("area", float(rle_area(rle)))
                ann.setdefault("bbox", rle_to_bbox(rle))
            bb = ann.get("bbox")
            if bb is not None and "area" not in ann:
                ann["area"] = bb[2] * bb[3]
            ann.setdefault("iscrowd", 0)
            ann["id"] = i + 1
        res.dataset["annotations"] = anns
        res.create_index()
        return res
