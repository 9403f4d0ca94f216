"""InstaBoost: mask-guided crop, jitter and paste of each instance.

The port's own copy of pointtinybenchmark_tpu/data/instaboost_native.py
(what mmdet's InstaBoost transform, datasets/pipelines/instaboost.py, gets
from the `instaboostfast` package, in its "normal" random mode): each
instance is cut out along its mask, its hole filled with the median colour
of the pixels ringing it, and pasted back after a random scale, rotation
and shift (horizontal only for the "horizontal" action), with an optional
colour gain; boxes are recomputed from the moved masks and instances that
left the image dropped. The draws come from the sample's numpy RandomState
in JAX's order, so a seed gives the same arrays in both packages. Not
reproduced, as in JAX: the package's appearance-consistency heatmap ("map"
mode) and soft alpha matting.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
from PIL import Image

__all__ = ["instaboost_sample"]


def _boundary_fill_color(img: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Median color of the pixels ringing the mask (the local background)."""
    shifted = np.zeros_like(mask)
    shifted[1:, :] |= mask[:-1, :]
    shifted[:-1, :] |= mask[1:, :]
    shifted[:, 1:] |= mask[:, :-1]
    shifted[:, :-1] |= mask[:, 1:]
    ring = shifted & ~mask
    if not ring.any():
        return np.asarray(np.median(img.reshape(-1, img.shape[-1]), axis=0))
    return np.asarray(np.median(img[ring], axis=0))


def _transform_instance(crop: np.ndarray, m: np.ndarray, scale: float,
                        theta: float) -> Tuple[np.ndarray, np.ndarray]:
    """Scale + rotate an instance crop and its mask (PIL, bilinear/nearest)."""
    h, w = m.shape
    nw = max(1, int(round(w * scale)))
    nh = max(1, int(round(h * scale)))
    im = Image.fromarray(crop.astype(np.uint8)).resize((nw, nh),
                                                       Image.BILINEAR)
    mm = Image.fromarray((m * 255).astype(np.uint8)).resize((nw, nh),
                                                            Image.NEAREST)
    if abs(theta) > 1e-3:
        im = im.rotate(theta, resample=Image.BILINEAR, expand=True)
        mm = mm.rotate(theta, resample=Image.NEAREST, expand=True)
    return np.asarray(im), (np.asarray(mm) > 127).astype(np.uint8)


def instaboost_sample(img: np.ndarray, boxes: np.ndarray, masks: np.ndarray,
                      labels: np.ndarray, rng: np.random.RandomState,
                      action_candidate: Sequence[str] = ("normal",
                                                        "horizontal", "skip"),
                      action_prob: Sequence[float] = (1.0, 0.0, 0.0),
                      scale: Tuple[float, float] = (0.8, 1.2),
                      dx: float = 15, dy: float = 15,
                      theta: Tuple[float, float] = (-1.0, 1.0),
                      color_prob: float = 0.5):
    """Jitter every instance of one sample in place.

    Args:
        img: (H, W, 3) uint8/float image.
        boxes: (N, 4) xyxy.
        masks: (N, H, W) uint8 bitmaps.
        labels: (N,) — returned filtered in step with boxes/masks.
    Returns:
        (img, boxes, masks, labels) with instances jittered; instances whose
        mask left the image are dropped (reference filters empty anns too).
    """
    h, w = img.shape[:2]
    float_input = np.issubdtype(img.dtype, np.floating)
    out = np.clip(img, 0, 255).astype(np.uint8).copy()
    probs = np.asarray(action_prob, np.float64)
    probs = probs / max(probs.sum(), 1e-12)

    new_masks = []
    keep = []
    for i in range(len(masks)):
        m = masks[i].astype(bool)
        action = action_candidate[int(rng.choice(len(probs), p=probs))]
        if action == "skip" or not m.any():
            new_masks.append(masks[i])
            keep.append(True)
            continue
        ys, xs = np.nonzero(m)
        y1, y2 = ys.min(), ys.max() + 1
        x1, x2 = xs.min(), xs.max() + 1
        crop = out[y1:y2, x1:x2].copy()
        mc = m[y1:y2, x1:x2]
        # cut: fill the hole with the local background color
        out[m] = _boundary_fill_color(out, m).astype(np.uint8)
        s = float(rng.uniform(*scale))
        th = float(rng.uniform(*theta))
        tdx = float(rng.uniform(-dx, dx))
        tdy = 0.0 if action == "horizontal" else float(rng.uniform(-dy, dy))
        tcrop, tm = _transform_instance(np.where(mc[..., None], crop, 0),
                                        mc, s, th)
        if rng.rand() < color_prob:
            gain = rng.uniform(0.8, 1.2, size=(1, 1, 3))
            tcrop = np.clip(tcrop.astype(np.float32) * gain, 0,
                            255).astype(np.uint8)
        # paste at the jittered location (center-preserving)
        cy = (y1 + y2) / 2 + tdy
        cx = (x1 + x2) / 2 + tdx
        nh, nw = tm.shape
        py1 = int(round(cy - nh / 2))
        px1 = int(round(cx - nw / 2))
        # clip paste window to the image
        sy1, sx1 = max(0, -py1), max(0, -px1)
        dy1, dx1 = max(0, py1), max(0, px1)
        ph = min(nh - sy1, h - dy1)
        pw = min(nw - sx1, w - dx1)
        nm = np.zeros((h, w), np.uint8)
        if ph > 0 and pw > 0:
            sub = tm[sy1:sy1 + ph, sx1:sx1 + pw].astype(bool)
            region = out[dy1:dy1 + ph, dx1:dx1 + pw]
            region[sub] = tcrop[sy1:sy1 + ph, sx1:sx1 + pw][sub]
            nm[dy1:dy1 + ph, dx1:dx1 + pw] = sub
        new_masks.append(nm)
        keep.append(bool(nm.any()))

    new_masks = np.stack(new_masks) if new_masks else masks
    keep = np.asarray(keep, bool)
    # recompute boxes from the (possibly moved) masks
    new_boxes = boxes.copy().astype(np.float32)
    for i in range(len(new_masks)):
        if not keep[i]:
            continue
        ys, xs = np.nonzero(new_masks[i])
        if len(ys) == 0:
            keep[i] = False
            continue
        new_boxes[i] = (xs.min(), ys.min(), xs.max() + 1, ys.max() + 1)
    out_img = out.astype(np.float32) if float_input else out
    return (out_img, new_boxes[keep], new_masks[keep], labels[keep])
