"""Tiled protocol inference: uint8 frames in, globally merged detections out.

Counterpart of pointtinybenchmark_tpu/engine/test.py (`DeviceTiledInference`,
`run_device_tiled_test`): normalize and tile on the device, one batched
forward over every tile of every frame, one batched per-tile NMS, a shift of
each tile's boxes by its offset, then one batched global class-aware NMS
over all frames (the JAX engine unrolls the merge per image; here the batch
axis of the NMS kernels takes the frames).
"""
from __future__ import annotations

import logging
from typing import Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core.post_processing import DetResult
from ..data.device_pipeline import DevicePreprocessor
from ..ops.nms import batched_nms

__all__ = ["DeviceTiledInference", "run_device_tiled_test"]

logger = logging.getLogger("ptb_torch")

DEFAULT_MEAN = (123.675, 116.28, 103.53)
DEFAULT_STD = (58.395, 57.12, 57.375)


class DeviceTiledInference:
    """Args:
        model: a built detector (`models.build_detector`), in eval mode.
        frame_hw: (H, W) of the decoded frames.
        tile_hw: (tile_h, tile_w) of the protocol's tiles.
        tile_overlap: (overlap_w, overlap_h).
        img_norm: dict(mean=..., std=...).
        merge_iou_threshold / max_per_img: the global merge.
    """

    def __init__(self, model, frame_hw, tile_hw, tile_overlap=(100, 100),
                 img_norm: Optional[dict] = None,
                 merge_iou_threshold: float = 0.5, max_per_img: int = 1000):
        self.model = model
        self.device = next(model.parameters()).device
        norm = img_norm or {}
        self.pre = DevicePreprocessor(
            frame_hw, mean=norm.get("mean", DEFAULT_MEAN),
            std=norm.get("std", DEFAULT_STD), tile_hw=tile_hw,
            tile_overlap=tile_overlap, device=self.device)
        self.merge_iou_threshold = float(merge_iou_threshold)
        self.max_per_img = int(max_per_img)
        offs = torch.from_numpy(self.pre.tile_offsets).to(self.device)
        self._shift = torch.cat([offs, offs], dim=1)[:, None, :]   # (V, 1, 4)
        self._img_shape = torch.tensor(tile_hw, dtype=torch.int32,
                                       device=self.device)

    def merge(self, dets: DetResult) -> Tuple[torch.Tensor, ...]:
        """The global merge of the per-tile detections (n_img * V rows,
        image-major): shift each tile's boxes by its offset, then one
        class-aware NMS per frame, batched over frames. Returns boxes
        (n_img, V*M, 4), scores and labels (n_img, V*M), and keep
        (n_img, max_per_img) indices into them, padded with -1."""
        v = self.pre.n_views
        n_img = dets.bboxes.shape[0] // v
        m = dets.bboxes.shape[1]
        boxes = (dets.bboxes[..., :4].reshape(n_img, v, m, 4)
                 + self._shift).reshape(n_img, v * m, 4)
        scores = dets.bboxes[..., 4].reshape(n_img, v * m)
        labels = dets.labels.reshape(n_img, v * m)
        keep, _ = batched_nms(boxes, scores, labels, self.merge_iou_threshold,
                              self.max_per_img,
                              valid_mask=dets.valid.reshape(n_img, v * m))
        return boxes, scores, labels, keep

    @torch.no_grad()
    def __call__(self, frames) -> List[dict]:
        """frames: (n_images, H, W, 3) or (H, W, 3) uint8. Returns one dict
        per frame: bboxes (n, 5) in the frame's coordinates, labels (n,)."""
        tiles = self.pre(frames)
        dets = self.model.simple_test(
            tiles, self._img_shape.expand(tiles.shape[0], 2))
        boxes, scores, labels, keep = (t.cpu().numpy()
                                       for t in self.merge(dets))
        results = []
        for i in range(keep.shape[0]):
            sel = keep[i][keep[i] >= 0]
            results.append(dict(
                bboxes=np.concatenate([boxes[i][sel], scores[i][sel][:, None]],
                                      axis=1),
                labels=labels[i][sel]))
        return results


def run_device_tiled_test(model, frames: Iterable[Union[np.ndarray, str]],
                          frame_hw, tile_hw, tile_overlap=(100, 100),
                          img_norm: Optional[dict] = None,
                          merge_iou_threshold: float = 0.5,
                          max_per_img: int = 1000) -> List[dict]:
    """Tiled evaluation over decoded uint8 frames (or image paths)."""
    eng = DeviceTiledInference(model, frame_hw, tile_hw, tile_overlap,
                               img_norm, merge_iou_threshold, max_per_img)
    results: List[dict] = []
    for idx, frame in enumerate(frames):
        if isinstance(frame, str):
            from PIL import Image
            frame = np.asarray(Image.open(frame).convert("RGB"))
        results.extend(eng(frame))
        if idx % 20 == 0:
            logger.info("device tiled test %d (%d tiles)", idx + 1,
                        eng.pre.n_views)
    return results
