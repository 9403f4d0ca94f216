"""Batch collation for inference: static-shape padding plus image metas.

Counterpart of pointtinybenchmark_tpu/data/loader.py::DetCollator, the
inference part: each sample's (H, W, 3) float image is padded at the bottom
and right to the batch's shape, `pad_shape` or the largest image rounded up
to a multiple of `size_divisor`, and the batch carries each image's content
shape, its scale factor (from `img_metas`, [1, 1, 1, 1] when absent) and
the metas themselves. The padding of ground truth and proposals comes with
training. Host numpy in, host numpy out; `engine/test.py::run_test` moves
the arrays to the model's device.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["DetCollator"]


class DetCollator:

    def __init__(self, pad_shape: Optional[Tuple[int, int]] = None,
                 size_divisor: int = 32):
        self.pad_shape = pad_shape      # (H, W); None: largest, rounded up
        self.size_divisor = size_divisor

    def __call__(self, samples: List[dict]) -> Dict[str, Any]:
        samples = [s for s in samples if s is not None]
        if not samples:
            raise ValueError("every sample of the batch was filtered out")
        imgs = [s["img"] for s in samples]
        if self.pad_shape is not None:
            th, tw = self.pad_shape
        else:
            d = self.size_divisor
            th = -(-max(im.shape[0] for im in imgs) // d) * d
            tw = -(-max(im.shape[1] for im in imgs) // d) * d
        img = np.zeros((len(imgs), th, tw, imgs[0].shape[2]), np.float32)
        img_shape = np.zeros((len(imgs), 2), np.int32)
        for i, im in enumerate(imgs):
            h, w = im.shape[:2]
            if h > th or w > tw:
                raise ValueError(f"image ({h}, {w}) exceeds the pad shape "
                                 f"({th}, {tw})")
            img[i, :h, :w] = im
            img_shape[i] = (h, w)
        metas = [s.get("img_metas", {}) for s in samples]
        scale_factor = np.stack([
            np.asarray(m.get("scale_factor", [1, 1, 1, 1]), np.float32)
            for m in metas])
        return {"img": img, "img_shape": img_shape,
                "scale_factor": scale_factor, "img_metas": metas}
