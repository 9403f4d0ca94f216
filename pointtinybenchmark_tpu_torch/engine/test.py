"""Inference engines: the plain test loop and tiled protocol inference.

Counterpart of pointtinybenchmark_tpu/engine/test.py (`run_test`,
`DeviceTiledInference`, `run_device_tiled_test`).

- `run_test`: collated batches of preprocessed images through
  `simple_test`, boxes rescaled to each original image; a Mask R-CNN's
  mask probabilities are pasted into the original frame on the host and
  RLE-encoded (`_to_result`).
- Tiled protocol: uint8 frames in, globally merged detections out. Normalize
  and tile on the device, one batched forward over every tile of every
  frame, one batched per-tile NMS, a shift of each tile's boxes by its
  offset, then one batched global class-aware NMS over all frames (the JAX
  engine unrolls the merge per image; here the batch axis of the NMS
  kernels takes the frames). Mask probabilities, where the model makes
  them, are dropped there, as the JAX engine drops them: there is no tiled
  mask merge.
"""
from __future__ import annotations

import logging
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core.post_processing import DetResult
from ..data.device_pipeline import DevicePreprocessor
from ..evaluation.mask_utils import paste_masks, rle_encode
from ..ops.nms import batched_nms

__all__ = ["run_test", "DeviceTiledInference", "run_device_tiled_test"]

logger = logging.getLogger("ptb_torch")

DEFAULT_MEAN = (123.675, 116.28, 103.53)
DEFAULT_STD = (58.395, 57.12, 57.375)


def _to_result(bboxes: np.ndarray, labels: np.ndarray, valid: np.ndarray,
               mask_crops: Optional[np.ndarray],
               ori_shape) -> Dict[str, object]:
    """One image's valid detections; with mask crops (M, s, s), also their
    masks pasted into the original frame of shape `ori_shape` and
    RLE-encoded (mmdet FCNMaskHead.get_seg_masks + _segm2json), the boxes
    being in that frame already."""
    keep = valid.astype(bool)
    out = dict(bboxes=bboxes[keep], labels=labels[keep])
    if mask_crops is not None:
        h, w = int(ori_shape[0]), int(ori_shape[1])
        full = paste_masks(np.asarray(mask_crops[keep], np.float32),
                           out["bboxes"][:, :4], h, w)
        out["masks"] = [rle_encode(m) for m in full]
    return out


@torch.no_grad()
def run_test(model, dataset, collator, batch_size: int = 1,
             rescale: bool = True) -> List[dict]:
    """The plain (untiled) test loop. `dataset` is any indexable of
    preprocessed samples (`img` (H, W, 3) float32, `img_metas` with
    `scale_factor` and `ori_shape`), or of samples whose `views[0]` is one;
    `collator` batches them (`data/loader.py::DetCollator`). The batches go
    to the model's device. Returns per image bboxes (n, 5) and labels (n,),
    with `rescale` in the original image's frame, and for a Mask R-CNN the
    RLE `masks` of the original image's size."""
    device = next(model.parameters()).device
    results: List[dict] = []
    n = len(dataset)
    for start in range(0, n, batch_size):
        flat = []
        for i in range(start, min(start + batch_size, n)):
            s = dataset[i]
            flat.append(s["views"][0] if "views" in s else s)
        batch = collator(flat)
        out = model.simple_test(
            torch.from_numpy(batch["img"]).to(device),
            torch.from_numpy(batch["img_shape"]).to(device),
            torch.from_numpy(batch["scale_factor"]).to(device), rescale)
        masks = None
        if not isinstance(out, DetResult):
            out, masks = out
            masks = masks.cpu().numpy()
        db, dl, dv = (t.cpu().numpy() for t in out)
        for i, sample in enumerate(flat):
            ori = sample.get("img_metas", {}).get("ori_shape",
                                                  sample["img"].shape[:2])
            results.append(_to_result(
                db[i], dl[i], dv[i], masks[i] if masks is not None else None,
                ori))
        if (start // batch_size) % 50 == 0:
            logger.info("test %d/%d", start + len(flat), n)
    return results


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
        if not isinstance(dets, DetResult):       # (detections, masks)
            dets = dets[0]
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
