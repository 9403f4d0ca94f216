"""Host-side pipeline transforms of the dataset path (numpy; PIL decodes).

The port's own copy of the subset of pointtinybenchmark_tpu/data/
transforms.py that the TinyPerson and COCO base pipelines use (mmdet
datasets/pipelines): `Compose`; `LoadImageFromFile`, with the fork's
corner crop on load (a pre-tiled dataset's image carries its tile's
`corner` rect) and the process-wide RAM cache; `LoadAnnotations` (with the
fork's `gt_true_bboxes` and `gt_anns_id`); `LoadProposals`; `Resize` in
the fork's `scale_factor` mode (native resolution at [1.0]) and in the
`img_scale` mode; `RandomFlip`, drawing from the sample's `_rng`;
`Normalize`, `Pad`, `DefaultFormatBundle`, `ImageToTensor` and `Collect`;
`Albu` (data/albu_native.py, its transform list checked when it is built)
and `InstaBoost` (data/instaboost_native.py), both drawing from the
sample's `_rng` as JAX's do.

Transforms are dict-in, dict-out. Images flow as float32 RGB HWC numpy
(mmcv loads BGR and converts in Normalize(to_rgb=True); loading RGB and
treating to_rgb as a no-op gives the same numbers). PIL is imported where
an image is decoded, resized or rasterized, not with the module.
"""
from __future__ import annotations

import os.path as osp
from typing import Optional, Sequence, Tuple

import numpy as np

from ..utils.registry import PIPELINES

__all__ = ["Compose", "LoadImageFromFile", "LoadAnnotations",
           "LoadProposals", "Resize", "RandomFlip", "Normalize", "Pad",
           "Collect", "DefaultFormatBundle", "ImageToTensor", "Albu",
           "InstaBoost"]


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = []
        for t in transforms:
            if isinstance(t, dict):
                self.transforms.append(PIPELINES.build(dict(t)))
            elif callable(t):
                self.transforms.append(t)
            else:
                raise TypeError(f"transform must be dict or callable: {t}")

    def __call__(self, results: Optional[dict]) -> Optional[dict]:
        for t in self.transforms:
            results = t(results)
            if results is None:
                return None
        return results

    def __repr__(self):
        return f"Compose({self.transforms})"


@PIPELINES.register_module()
class LoadImageFromFile:
    """Image decode, with the fork's corner crop on load (mmdet
    loading.py:63-68 of the fork).

    `cache=True` keeps the decoded (and corner-cropped) uint8 tile in a
    process-wide RAM cache, so that PIL leaves the hot loop after the first
    epoch. `cache_max_bytes` caps the cache (insertion stops when full; no
    eviction: epoch access is cyclic, so LRU would thrash)."""

    _CACHE: dict = {}
    _CACHE_BYTES = [0]

    def __init__(self, to_float32: bool = True, color_type: str = "color",
                 cache: bool = False,
                 cache_max_bytes: int = 2 * 1024**3):
        self.to_float32 = to_float32
        self.cache = cache
        self.cache_max_bytes = int(cache_max_bytes)

    def _decode(self, filename: str, info: dict) -> np.ndarray:
        from PIL import Image
        img = np.asarray(Image.open(filename).convert("RGB"))
        # fork corner-crop: pre-tiled (corner) datasets carry a crop rect
        if "corner" in info:
            l, u, r, b = [int(v) for v in info["corner"]]
            img = img[u:b, l:r]
        return img

    def __call__(self, results: dict) -> dict:
        info = results["img_info"]
        if results.get("img_prefix"):
            filename = osp.join(results["img_prefix"], info["file_name"])
        else:
            filename = info["file_name"]
        if self.cache:
            key = (filename, tuple(info.get("corner", ())))
            img = self._CACHE.get(key)
            if img is None:
                img = self._decode(filename, info)
                if self._CACHE_BYTES[0] + img.nbytes <= self.cache_max_bytes:
                    self._CACHE[key] = img
                    self._CACHE_BYTES[0] += img.nbytes
        else:
            img = self._decode(filename, info)
        if self.to_float32:
            img = img.astype(np.float32)
        elif self.cache:
            img = img.copy()   # downstream transforms mutate in place
        results["filename"] = filename
        results["ori_filename"] = info["file_name"]
        results["img"] = img
        results["img_shape"] = img.shape
        results["ori_shape"] = img.shape
        results["img_fields"] = ["img"]
        return results


@PIPELINES.register_module()
class LoadAnnotations:
    def __init__(self, with_bbox: bool = True, with_label: bool = True,
                 with_mask: bool = False, with_seg: bool = False):
        self.with_bbox = with_bbox
        self.with_label = with_label
        self.with_mask = with_mask

    @staticmethod
    def _rasterize(segs, h: int, w: int) -> np.ndarray:
        """COCO polygon lists -> (G, H, W) uint8 bitmaps (PIL rasterizer)."""
        from PIL import Image, ImageDraw
        masks = np.zeros((len(segs), h, w), np.uint8)
        for i, seg in enumerate(segs):
            if not seg:
                continue
            img = Image.new("L", (w, h), 0)
            draw = ImageDraw.Draw(img)
            polys = seg if isinstance(seg, (list, tuple)) and seg and \
                isinstance(seg[0], (list, tuple)) else [seg]
            for poly in polys:
                if poly is None or len(poly) < 6:
                    continue
                draw.polygon([float(v) for v in poly], fill=1)
            masks[i] = np.asarray(img, np.uint8)
        return masks

    def __call__(self, results: dict) -> dict:
        ann = results["ann_info"]
        if self.with_bbox:
            results["gt_bboxes"] = ann["bboxes"].copy()
            results["gt_bboxes_ignore"] = ann.get(
                "bboxes_ignore", np.zeros((0, 4), np.float32)).copy()
            # extend, not replace: LoadProposals may already have
            # registered "proposals" (reference appends per-loader too)
            results["bbox_fields"] = (
                [k for k in results.get("bbox_fields", [])
                 if k not in ("gt_bboxes", "gt_bboxes_ignore")]
                + ["gt_bboxes", "gt_bboxes_ignore"])
            # fork extras for the point pipeline
            if "true_bboxes" in ann:
                results["gt_true_bboxes"] = ann["true_bboxes"].copy()
                results["bbox_fields"].append("gt_true_bboxes")
            if "anns_id" in ann:
                results["gt_anns_id"] = ann["anns_id"].copy()
        if self.with_label:
            results["gt_labels"] = ann["labels"].copy()
        if self.with_mask and "masks" in ann:
            h, w = results["img"].shape[:2]
            results["gt_masks"] = self._rasterize(ann["masks"], h, w)
            results["mask_fields"] = ["gt_masks"]
        return results


@PIPELINES.register_module()
class LoadProposals:
    """Precomputed-proposal loader (reference pipelines/loading.py:403):
    strips scores to (n, 4), truncates to num_max_proposals, and registers
    `proposals` as a bbox field so Resize/Flip map them with the image."""

    def __init__(self, num_max_proposals: Optional[int] = None):
        self.num_max_proposals = num_max_proposals

    def __call__(self, results: dict) -> dict:
        proposals = np.asarray(results["proposals"], np.float32)
        if proposals.ndim != 2 or proposals.shape[-1] not in (4, 5):
            raise AssertionError(
                "proposals should have shapes (n, 4) or (n, 5), "
                f"but found {proposals.shape}")
        proposals = proposals[:, :4]
        if self.num_max_proposals is not None:
            proposals = proposals[:self.num_max_proposals]
        if len(proposals) == 0:
            proposals = np.zeros((0, 4), np.float32)
        results["proposals"] = proposals
        results.setdefault("bbox_fields", []).append("proposals")
        return results


def _imrescale_size(old_size: Tuple[int, int], scale, keep_ratio=True):
    """mmcv rescale_size parity: scale is (max_long, max_short) or float."""
    w, h = old_size
    if isinstance(scale, (float, int)) and not isinstance(scale, bool):
        scale_factor = float(scale)
    else:
        max_long_edge = max(scale)
        max_short_edge = min(scale)
        scale_factor = min(max_long_edge / max(h, w),
                           max_short_edge / min(h, w))
    new_w = int(w * scale_factor + 0.5)
    new_h = int(h * scale_factor + 0.5)
    return new_w, new_h


@PIPELINES.register_module()
class Resize:
    """mmdet Resize with the fork's scale_factor mode.

    Modes:
    - img_scale=(w, h) [+keep_ratio]: standard mmdet resize.
    - img_scale=None, ratio_range or scale_factor list: multiply native
      resolution (fork transforms.py:74,99-103; scale_factor=[1.0] keeps
      native resolution — the TinyPerson recipe).
    """

    def __init__(self, img_scale=None, multiscale_mode: str = "range",
                 ratio_range=None, keep_ratio: bool = True,
                 scale_factor=None, override: bool = False,
                 bbox_clip_border: bool = True):
        self.img_scale = img_scale
        self.multiscale_mode = multiscale_mode
        self.ratio_range = ratio_range
        self.keep_ratio = keep_ratio
        self.scale_factor = scale_factor
        self.bbox_clip_border = bbox_clip_border

    def _pick_scale(self, results) -> None:
        rng: np.random.RandomState = results.get(
            "_rng", np.random.RandomState())
        if self.scale_factor is not None:
            sf = self.scale_factor
            f = sf[rng.randint(len(sf))] if isinstance(sf, (list, tuple)) else sf
            results["scale"] = None
            results["_resize_ratio"] = float(f)
        elif self.ratio_range is not None:
            lo, hi = self.ratio_range
            results["scale"] = None
            results["_resize_ratio"] = float(rng.uniform(lo, hi))
        elif isinstance(self.img_scale, list):
            idx = rng.randint(len(self.img_scale))
            results["scale"] = tuple(self.img_scale[idx])
        else:
            results["scale"] = tuple(self.img_scale) if self.img_scale else None

    def __call__(self, results: dict) -> dict:
        if "scale" not in results and "_resize_ratio" not in results:
            self._pick_scale(results)
        img = results["img"]
        h, w = img.shape[:2]
        if results.get("scale") is not None:
            if self.keep_ratio:
                new_w, new_h = _imrescale_size((w, h), results["scale"])
            else:
                new_w, new_h = results["scale"]
        else:
            ratio = results.get("_resize_ratio", 1.0)
            new_w, new_h = int(w * ratio + 0.5), int(h * ratio + 0.5)

        if (new_w, new_h) != (w, h):
            from PIL import Image
            pil = Image.fromarray(img.astype(np.uint8)) if img.dtype != np.uint8 \
                else Image.fromarray(img)
            img = np.asarray(pil.resize((new_w, new_h), Image.BILINEAR),
                             dtype=np.float32)
        else:
            img = img.astype(np.float32)
        w_scale = new_w / w
        h_scale = new_h / h
        results["img"] = img
        results["img_shape"] = img.shape
        results["pad_shape"] = img.shape
        results["scale_factor"] = np.asarray(
            [w_scale, h_scale, w_scale, h_scale], np.float32)
        results["keep_ratio"] = self.keep_ratio

        for key in results.get("bbox_fields", []):
            bboxes = results[key] * results["scale_factor"]
            if self.bbox_clip_border:
                bboxes[:, 0::2] = np.clip(bboxes[:, 0::2], 0, new_w)
                bboxes[:, 1::2] = np.clip(bboxes[:, 1::2], 0, new_h)
            results[key] = bboxes
        for key in results.get("mask_fields", []):
            m = results[key]
            if m.shape[1:] != (new_h, new_w) and len(m):
                from PIL import Image
                out = np.zeros((len(m), new_h, new_w), m.dtype)
                for i in range(len(m)):
                    out[i] = np.asarray(Image.fromarray(m[i] * 255).resize(
                        (new_w, new_h), Image.NEAREST)) // 255
                results[key] = out
        return results


@PIPELINES.register_module()
class RandomFlip:
    def __init__(self, flip_ratio: Optional[float] = None,
                 direction: str = "horizontal"):
        self.flip_ratio = flip_ratio
        self.direction = direction

    def __call__(self, results: dict) -> dict:
        rng: np.random.RandomState = results.get(
            "_rng", np.random.RandomState())
        if "flip" not in results:
            flip = (self.flip_ratio is not None
                    and rng.rand() < self.flip_ratio)
            results["flip"] = flip
            results["flip_direction"] = self.direction
        if results["flip"]:
            img = results["img"]
            h, w = img.shape[:2]
            if results["flip_direction"] == "horizontal":
                results["img"] = img[:, ::-1].copy()
                for key in results.get("bbox_fields", []):
                    b = results[key].copy()
                    b[:, 0] = w - results[key][:, 2]
                    b[:, 2] = w - results[key][:, 0]
                    results[key] = b
                for key in results.get("mask_fields", []):
                    results[key] = results[key][:, :, ::-1].copy()
            else:
                results["img"] = img[::-1].copy()
                for key in results.get("bbox_fields", []):
                    b = results[key].copy()
                    b[:, 1] = h - results[key][:, 3]
                    b[:, 3] = h - results[key][:, 1]
                    results[key] = b
                for key in results.get("mask_fields", []):
                    results[key] = results[key][:, ::-1, :].copy()
        return results


@PIPELINES.register_module()
class Normalize:
    def __init__(self, mean, std, to_rgb: bool = True):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self._inv_std = (1.0 / self.std).astype(np.float32)
        # images are loaded RGB already; to_rgb kept for config parity

    def __call__(self, results: dict) -> dict:
        # in place: one allocation (astype) and two passes instead of
        # three allocating passes
        img = results["img"]
        if (img.dtype != np.float32 or img.base is not None
                or not img.flags.writeable):
            # copy when not an owned writable f32 buffer (tile crops are
            # views into the parent image — in-place would corrupt overlaps)
            img = img.astype(np.float32)
        np.subtract(img, self.mean, out=img)
        np.multiply(img, self._inv_std, out=img)
        results["img"] = img
        results["img_norm_cfg"] = dict(mean=self.mean, std=self.std)
        return results


@PIPELINES.register_module()
class Pad:
    def __init__(self, size: Optional[Tuple[int, int]] = None,
                 size_divisor: Optional[int] = None, pad_val: float = 0.0):
        self.size = size            # (h, w)
        self.size_divisor = size_divisor
        self.pad_val = pad_val
        assert size is not None or size_divisor is not None

    def __call__(self, results: dict) -> dict:
        img = results["img"]
        h, w = img.shape[:2]
        if self.size is not None:
            th, tw = self.size
        else:
            d = self.size_divisor
            th = int(np.ceil(h / d)) * d
            tw = int(np.ceil(w / d)) * d
        pad_h, pad_w = th - h, tw - w
        assert pad_h >= 0 and pad_w >= 0, \
            f"image ({h},{w}) larger than pad size ({th},{tw})"
        if pad_h or pad_w:
            img = np.pad(img, ((0, pad_h), (0, pad_w), (0, 0)),
                         constant_values=self.pad_val)
            for key in results.get("mask_fields", []):
                results[key] = np.pad(
                    results[key], ((0, 0), (0, pad_h), (0, pad_w)))
        results["img"] = img
        results["pad_shape"] = img.shape
        results["pad_fixed_size"] = self.size
        results["pad_size_divisor"] = self.size_divisor
        return results


@PIPELINES.register_module()
class DefaultFormatBundle:
    """No-op marker kept for config parity (tensors are built by the
    collator)."""

    def __call__(self, results: dict) -> dict:
        return results


@PIPELINES.register_module()
class ImageToTensor:
    def __init__(self, keys: Sequence[str] = ("img",)):
        self.keys = keys

    def __call__(self, results: dict) -> dict:
        return results


@PIPELINES.register_module()
class Collect:
    DEFAULT_META = ("filename", "ori_filename", "ori_shape", "img_shape",
                    "pad_shape", "scale_factor", "flip", "flip_direction",
                    "img_norm_cfg", "tile_offset")

    def __init__(self, keys: Sequence[str],
                 meta_keys: Sequence[str] = DEFAULT_META):
        self.keys = keys
        self.meta_keys = meta_keys

    def __call__(self, results: dict) -> dict:
        data = {}
        img_meta = {k: results[k] for k in self.meta_keys if k in results}
        data["img_metas"] = img_meta
        for k in self.keys:
            if k in results:
                data[k] = results[k]
        return data


@PIPELINES.register_module()
class Albu:
    """The albumentations bridge (mmdet transforms.py:1297) on the port's
    own transforms (data/albu_native.py); a type they lack raises
    ValueError when the transform is built. After the transforms the boxes
    are clipped to the image and, with `bbox_params.filter_lost_elements`,
    those whose visible area is at most `min_visibility` of their area
    before are dropped with their labels and masks."""

    def __init__(self, transforms, bbox_params=None, keymap=None,
                 update_pad_shape=False, skip_img_without_anno=False):
        from .albu_native import NATIVE_ALBU_OPS

        self.transforms = [dict(t) for t in transforms]
        for t in self.transforms:
            types = [t["type"]] if t["type"] != "OneOf" else \
                [c["type"] for c in t["transforms"]]
            for tt in types:
                if tt not in NATIVE_ALBU_OPS and tt not in (
                        "HorizontalFlip", "VerticalFlip", "OneOf"):
                    raise ValueError(
                        f"Albu transform {tt!r} has no native "
                        f"implementation (supported: "
                        f"{sorted(NATIVE_ALBU_OPS)})")
        bp = dict(bbox_params or {})
        self.min_visibility = float(bp.get("min_visibility", 0.0))
        self.filter_lost = bool(bp.get("filter_lost_elements", False))
        self.update_pad_shape = update_pad_shape
        self.skip_img_without_anno = skip_img_without_anno

    def __call__(self, results: dict) -> dict:
        from .albu_native import apply_albu_transform

        rng = results.get("_rng") or np.random
        img = results["img"]
        float_input = np.issubdtype(np.asarray(img).dtype, np.floating)
        img = np.clip(np.asarray(img), 0, 255).astype(np.uint8)
        boxes = results.get("gt_bboxes")
        masks = results.get("gt_masks")
        orig_areas = None
        if boxes is not None and len(boxes):
            orig_areas = ((boxes[:, 2] - boxes[:, 0])
                          * (boxes[:, 3] - boxes[:, 1]))
        for t in self.transforms:
            img, boxes, masks = apply_albu_transform(t, img, boxes, masks,
                                                     rng)
        h, w = img.shape[:2]
        results["img"] = img.astype(np.float32) if float_input else img
        if boxes is not None and len(boxes):
            clipped = boxes.copy()
            clipped[:, 0::2] = np.clip(clipped[:, 0::2], 0, w)
            clipped[:, 1::2] = np.clip(clipped[:, 1::2], 0, h)
            if self.filter_lost:
                area = ((clipped[:, 2] - clipped[:, 0])
                        * (clipped[:, 3] - clipped[:, 1]))
                keep = area / np.maximum(orig_areas, 1e-6) \
                    > self.min_visibility
                clipped = clipped[keep]
                if "gt_labels" in results:
                    results["gt_labels"] = results["gt_labels"][keep]
                if masks is not None and len(masks):
                    masks = masks[keep]
            results["gt_bboxes"] = clipped
        if masks is not None:
            results["gt_masks"] = masks
        if self.update_pad_shape:
            results["pad_shape"] = img.shape
        return results


@PIPELINES.register_module()
class InstaBoost:
    """InstaBoost (mmdet datasets/pipelines/instaboost.py's config keys)
    on the port's own data/instaboost_native.py. It needs `gt_masks`
    (LoadAnnotations with_mask=True before it); with probability
    1 - aug_ratio, or without boxes, the sample passes unchanged.
    `hflag` is taken and unused, as in JAX."""

    def __init__(self, action_candidate=("normal", "horizontal", "skip"),
                 action_prob=(1, 0, 0), scale=(0.8, 1.2), dx=15, dy=15,
                 theta=(-1, 1), color_prob=0.5, hflag=False,
                 aug_ratio=0.5):
        self.action_candidate = tuple(action_candidate)
        self.action_prob = tuple(action_prob)
        self.scale = tuple(scale)
        self.dx = float(dx)
        self.dy = float(dy)
        self.theta = tuple(theta)
        self.color_prob = float(color_prob)
        self.aug_ratio = float(aug_ratio)

    def __call__(self, results: dict) -> dict:
        from .instaboost_native import instaboost_sample

        masks = results.get("gt_masks")
        boxes = results.get("gt_bboxes")
        if masks is None or boxes is None or len(boxes) == 0:
            return results
        rng: np.random.RandomState = results.get(
            "_rng", np.random.RandomState())
        if rng.rand() > self.aug_ratio:
            return results
        labels = results.get("gt_labels", np.zeros(len(boxes), np.int64))
        img, boxes, masks, labels = instaboost_sample(
            results["img"], boxes, masks, labels, rng,
            self.action_candidate, self.action_prob, self.scale,
            self.dx, self.dy, self.theta, self.color_prob)
        results["img"] = img
        results["gt_bboxes"] = boxes
        results["gt_masks"] = masks
        results["gt_labels"] = labels
        return results
