"""The albumentations transforms of the reference configs, in PIL and numpy.

The port's own copy of pointtinybenchmark_tpu/data/albu_native.py (what
mmdet's `Albu` bridge runs, datasets/pipelines/transforms.py:1297, for the
transform set of configs/albu_example/mask_rcnn_r50_fpn_albu_1x_coco.py):
ShiftScaleRotate (boxes and masks warped with the image),
RandomBrightnessContrast, RGBShift, HueSaturationValue, JpegCompression /
ImageCompression, ChannelShuffle, Blur, MedianBlur, OneOf and the two
flips, each drawing from the sample's numpy RandomState in JAX's order, so
that a seed gives the same arrays in both packages. Another type raises.
"""
from __future__ import annotations

import io
import math
from typing import Dict, List, Optional

import numpy as np
from PIL import Image, ImageFilter

__all__ = ["NATIVE_ALBU_OPS", "apply_albu_transform"]


def _rand(rng, limit):
    """uniform in [-limit, limit] or [limit[0], limit[1]]."""
    if isinstance(limit, (list, tuple)):
        lo, hi = limit
    else:
        lo, hi = -limit, limit
    return rng.uniform(lo, hi)


def _to_uint8(img):
    return np.clip(img, 0, 255).astype(np.uint8)


# ------------------------------------------------------------- pixel-level
def _brightness_contrast(img, rng, brightness_limit=0.2, contrast_limit=0.2,
                         brightness_by_max=True, **_):
    alpha = 1.0 + _rand(rng, contrast_limit)
    beta = _rand(rng, brightness_limit)
    out = img.astype(np.float32) * alpha
    out += beta * (255.0 if brightness_by_max else out.mean())
    return _to_uint8(out)


def _rgb_shift(img, rng, r_shift_limit=20, g_shift_limit=20,
               b_shift_limit=20, **_):
    shifts = np.array([_rand(rng, r_shift_limit), _rand(rng, g_shift_limit),
                       _rand(rng, b_shift_limit)], np.float32)
    return _to_uint8(img.astype(np.float32) + shifts)


def _hsv(img, rng, hue_shift_limit=20, sat_shift_limit=30,
         val_shift_limit=20, **_):
    pil = Image.fromarray(_to_uint8(img)).convert("HSV")
    h, s, v = [np.asarray(c, np.float32) for c in pil.split()]
    h = np.mod(h + _rand(rng, hue_shift_limit), 256)
    s = np.clip(s + _rand(rng, sat_shift_limit), 0, 255)
    v = np.clip(v + _rand(rng, val_shift_limit), 0, 255)
    out = Image.merge("HSV", [Image.fromarray(c.astype(np.uint8))
                              for c in (h, s, v)])
    return np.asarray(out.convert("RGB"))


def _jpeg(img, rng, quality_lower=85, quality_upper=95, **_):
    q = int(rng.randint(quality_lower, quality_upper + 1))
    buf = io.BytesIO()
    Image.fromarray(_to_uint8(img)).save(buf, format="JPEG", quality=q)
    buf.seek(0)
    return np.asarray(Image.open(buf).convert("RGB"))


def _channel_shuffle(img, rng, **_):
    perm = rng.permutation(img.shape[-1])
    return img[..., perm]


def _blur(img, rng, blur_limit=7, **_):
    hi = blur_limit if not isinstance(blur_limit, (list, tuple)) \
        else blur_limit[1]
    k = int(rng.randint(3, max(hi, 3) + 1)) | 1  # odd
    out = Image.fromarray(_to_uint8(img)).filter(ImageFilter.BoxBlur(k // 2))
    return np.asarray(out)


def _median_blur(img, rng, blur_limit=7, **_):
    hi = blur_limit if not isinstance(blur_limit, (list, tuple)) \
        else blur_limit[1]
    k = int(rng.randint(3, max(hi, 3) + 1)) | 1
    out = Image.fromarray(_to_uint8(img)).filter(ImageFilter.MedianFilter(k))
    return np.asarray(out)


# ---------------------------------------------------------- geometry-level
def _affine_matrix(h, w, dx, dy, scale, angle_deg):
    """Output->input PIL affine coefficients about the image center."""
    cx, cy = w / 2.0, h / 2.0
    a = math.radians(angle_deg)
    cos, sin = math.cos(a) / scale, math.sin(a) / scale
    # inverse of (translate(dx,dy) . rotate_scale about center)
    tx = cx - cos * (cx + dx) - sin * (cy + dy)
    ty = cy + sin * (cx + dx) - cos * (cy + dy)
    return (cos, sin, tx, -sin, cos, ty)


def _shift_scale_rotate(img, rng, bboxes=None, masks=None,
                        shift_limit=0.0625, scale_limit=0.1,
                        rotate_limit=45, interpolation=1, **_):
    h, w = img.shape[:2]
    dx = _rand(rng, shift_limit) * w
    dy = _rand(rng, shift_limit) * h
    scale = 1.0 + _rand(rng, scale_limit)
    angle = _rand(rng, rotate_limit)
    coeffs = _affine_matrix(h, w, dx, dy, scale, angle)
    resample = Image.BILINEAR if interpolation else Image.NEAREST
    out = np.asarray(Image.fromarray(_to_uint8(img)).transform(
        (w, h), Image.AFFINE, coeffs, resample=resample))
    new_boxes = None
    if bboxes is not None and len(bboxes):
        # forward transform = inverse of `coeffs`
        a = math.radians(angle)
        cos_f, sin_f = math.cos(a) * scale, math.sin(a) * scale
        cx, cy = w / 2.0, h / 2.0
        corners = np.stack([
            bboxes[:, [0, 1]], bboxes[:, [2, 1]],
            bboxes[:, [0, 3]], bboxes[:, [2, 3]]], axis=1)  # (N, 4, 2)
        rel = corners - np.array([cx, cy])
        rot = np.stack([
            cos_f * rel[..., 0] - sin_f * rel[..., 1],
            sin_f * rel[..., 0] + cos_f * rel[..., 1]], axis=-1)
        moved = rot + np.array([cx + dx, cy + dy])
        new_boxes = np.concatenate(
            [moved.min(axis=1), moved.max(axis=1)], axis=1).astype(
                bboxes.dtype)
    new_masks = None
    if masks is not None and len(masks):
        new_masks = np.stack([np.asarray(
            Image.fromarray(m).transform((w, h), Image.AFFINE, coeffs,
                                         resample=Image.NEAREST))
            for m in masks])
    return out, new_boxes, new_masks


NATIVE_ALBU_OPS: Dict[str, object] = {
    "RandomBrightnessContrast": _brightness_contrast,
    "RGBShift": _rgb_shift,
    "HueSaturationValue": _hsv,
    "JpegCompression": _jpeg,
    "ImageCompression": _jpeg,
    "ChannelShuffle": _channel_shuffle,
    "Blur": _blur,
    "MedianBlur": _median_blur,
    "ShiftScaleRotate": _shift_scale_rotate,
}


def apply_albu_transform(t: dict, img, bboxes, masks, rng):
    """Apply one albumentations-style transform dict; returns
    (img, bboxes, masks). Honors `p`; OneOf recurses."""
    t = dict(t)
    ttype = t.pop("type")
    p = t.pop("p", 0.5)
    if ttype == "OneOf":
        if rng.rand() >= p:
            return img, bboxes, masks
        children: List[dict] = t["transforms"]
        weights = np.asarray([c.get("p", 1.0) for c in children], float)
        weights = weights / weights.sum()
        child = dict(children[rng.choice(len(children), p=weights)])
        child["p"] = 1.0  # OneOf already rolled the dice
        return apply_albu_transform(child, img, bboxes, masks, rng)
    if ttype in ("HorizontalFlip", "VerticalFlip"):
        if rng.rand() >= p:
            return img, bboxes, masks
        axis = 1 if ttype == "HorizontalFlip" else 0
        size = img.shape[1] if axis == 1 else img.shape[0]
        img = np.flip(img, axis=axis).copy()
        if bboxes is not None and len(bboxes):
            bboxes = bboxes.copy()
            lo, hi = (0, 2) if axis == 1 else (1, 3)
            lo_v = size - bboxes[:, hi]
            hi_v = size - bboxes[:, lo]
            bboxes[:, lo], bboxes[:, hi] = lo_v, hi_v
        if masks is not None and len(masks):
            masks = np.flip(masks, axis=axis + 1).copy()
        return img, bboxes, masks
    fn = NATIVE_ALBU_OPS.get(ttype)
    if fn is None:
        raise ValueError(
            f"Albu transform {ttype!r} has no native implementation "
            f"(supported: {sorted(NATIVE_ALBU_OPS)} + OneOf/flips). "
            "Install the external `albumentations` package and swap the "
            "bridge, or use the built-in PhotoMetricDistortion/AutoAugment "
            "transforms.")
    if rng.rand() >= p:
        return img, bboxes, masks
    if ttype == "ShiftScaleRotate":
        img, new_boxes, new_masks = fn(img, rng, bboxes=bboxes, masks=masks,
                                       **t)
        return (img, new_boxes if new_boxes is not None else bboxes,
                new_masks if new_masks is not None else masks)
    return fn(img, rng, **t), bboxes, masks
