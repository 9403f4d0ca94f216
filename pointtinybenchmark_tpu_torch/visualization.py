"""Detection visualization (PIL-based; no cv2/matplotlib dependency).

The port's own copy of pointtinybenchmark_tpu/visualization.py
(mmdet core/visualization/image.py imshow_det_bboxes): draw
boxes + class/score labels, optional save to file.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
from PIL import Image, ImageDraw

__all__ = ["imshow_det_bboxes", "imshow_gt_det_bboxes"]

_PALETTE = [(255, 56, 56), (56, 168, 255), (72, 249, 10), (255, 157, 151),
            (255, 112, 31), (255, 178, 29), (207, 210, 49), (26, 147, 52),
            (0, 212, 187), (44, 153, 168), (0, 194, 255), (52, 69, 147),
            (100, 115, 255), (0, 24, 236), (132, 56, 255), (82, 0, 133)]


def imshow_det_bboxes(img: np.ndarray, bboxes: np.ndarray,
                      labels: np.ndarray,
                      class_names: Optional[Sequence[str]] = None,
                      score_thr: float = 0.0,
                      thickness: int = 1,
                      out_file: Optional[str] = None) -> np.ndarray:
    """img: (H, W, 3) uint8/float RGB; bboxes (n, 4|5); labels (n,)."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    pil = Image.fromarray(arr).convert("RGB")
    draw = ImageDraw.Draw(pil)
    bboxes = np.asarray(bboxes)
    labels = np.asarray(labels)
    for i in range(len(bboxes)):
        bb = bboxes[i]
        score = float(bb[4]) if bb.shape[-1] > 4 else None
        if score is not None and score < score_thr:
            continue
        color = _PALETTE[int(labels[i]) % len(_PALETTE)]
        draw.rectangle([float(bb[0]), float(bb[1]),
                        float(bb[2]), float(bb[3])],
                       outline=color, width=thickness)
        name = (class_names[int(labels[i])] if class_names is not None
                and 0 <= int(labels[i]) < len(class_names)
                else f"cls{int(labels[i])}")
        text = f"{name}" + (f"|{score:.2f}" if score is not None else "")
        draw.text((float(bb[0]), max(float(bb[1]) - 10, 0)), text, fill=color)
    out = np.asarray(pil)
    if out_file:
        pil.save(out_file)
    return out


def imshow_gt_det_bboxes(img, gt_bboxes, gt_labels, det_bboxes, det_labels,
                         class_names=None, score_thr: float = 0.0,
                         out_file: Optional[str] = None) -> np.ndarray:
    """GT (green) vs predictions side by side on one canvas."""
    arr = imshow_det_bboxes(img, det_bboxes, det_labels, class_names,
                            score_thr)
    pil = Image.fromarray(arr)
    draw = ImageDraw.Draw(pil)
    for i in range(len(gt_bboxes)):
        bb = np.asarray(gt_bboxes[i])
        draw.rectangle([float(bb[0]), float(bb[1]),
                        float(bb[2]), float(bb[3])],
                       outline=(0, 255, 0), width=1)
    out = np.asarray(pil)
    if out_file:
        pil.save(out_file)
    return out
