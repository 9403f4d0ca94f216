"""Inference engines: the plain test loop and tiled protocol inference.

Counterpart of pointtinybenchmark_tpu/engine/test.py (`run_test`,
`run_tiled_test`, `run_tta_test`, `merge_tile_dets`,
`DeviceTiledInference`, `run_device_tiled_test`, `run_refine_test`).

- `run_test`: collated batches of preprocessed images through
  `simple_test`, boxes rescaled to each original image; a Mask R-CNN's
  mask probabilities are pasted into the original frame on the host and
  RLE-encoded (`_to_result`).
- `run_tiled_test`: the tiled protocol on a dataset whose pipeline ends in
  CroppedTilesFlipAug (host decode, crop, normalize and pad per tile):
  per sample, its tile views are collated into one batch through
  `simple_test`, each tile's boxes shifted by its `tile_offset`, and one
  class-aware NMS (`merge_tile_dets`, K1 on the card) merges them.
- `run_tta_test`: test-time augmentation over a dataset whose pipeline
  ends in MultiScaleFlipAug: a sample's views (scale x flip) through one
  batched `simple_test`, each view's boxes flipped back and divided by its
  scale factor, then the same class-aware merge.
- Tiled protocol: uint8 frames in, globally merged detections out. Normalize
  and tile on the device, one batched forward over every tile of every
  frame, one batched per-tile NMS, a shift of each tile's boxes by its
  offset, then one batched global class-aware NMS over all frames (the JAX
  engine unrolls the merge per image; here the batch axis of the NMS
  kernels takes the frames). Mask probabilities, where the model makes
  them, are dropped there, as the JAX engine drops them: there is no tiled
  mask merge.
- `run_refine_test`: CPR's inference, the refinement of each image's
  annotated points; one row per valid gt, joinable back to the
  annotations by tools/result2ann.py.
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

__all__ = ["run_test", "run_tiled_test", "run_tta_test", "merge_tile_dets",
           "DeviceTiledInference", "run_device_tiled_test", "run_refine_test"]

logger = logging.getLogger("ptb_torch")

DEFAULT_MEAN = (123.675, 116.28, 103.53)
DEFAULT_STD = (58.395, 57.12, 57.375)


def _to_result(bboxes: np.ndarray, labels: np.ndarray, valid: np.ndarray,
               mask_crops: Optional[np.ndarray], ori_shape,
               points: Optional[np.ndarray] = None) -> Dict[str, object]:
    """One image's valid detections, with a point detector's points where
    given; with mask crops (M, s, s), also their masks pasted into
    the original frame of shape `ori_shape` and RLE-encoded (mmdet
    FCNMaskHead.get_seg_masks + _segm2json), the boxes being in that frame
    already."""
    keep = valid.astype(bool)
    out = dict(bboxes=bboxes[keep], labels=labels[keep])
    if points is not None:
        out["points"] = points[keep]
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
    with `rescale` in the original image's frame, for a point detector
    (P2P: `simple_test` gives the detections and their points) the
    `points` (n, k), and for a Mask R-CNN the RLE `masks` of the original
    image's size."""
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
        masks = points = None
        if not isinstance(out, DetResult):
            # (detections, mask crops (B, M, s, s) or points (B, M, k))
            out, extra = out
            if extra.dim() == 4:
                masks = extra.cpu().numpy()
            else:
                points = extra.cpu().numpy()
        db, dl, dv = (t.cpu().numpy() for t in out)
        for i, sample in enumerate(flat):
            ori = sample.get("img_metas", {}).get("ori_shape",
                                                  sample["img"].shape[:2])
            results.append(_to_result(
                db[i], dl[i], dv[i], masks[i] if masks is not None else None,
                ori, points[i] if points is not None else None))
        if (start // batch_size) % 50 == 0:
            logger.info("test %d/%d", start + len(flat), n)
    return results


def merge_tile_dets(boxes: torch.Tensor, scores: torch.Tensor,
                    labels: torch.Tensor, valid: torch.Tensor,
                    iou_threshold: float, max_per_img: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The global class-aware NMS across one image's tiles (fork
    two_stage.py:244-253): boxes (N, 4) in the image's frame, scores,
    labels and valid (N,), on their device. Returns the kept boxes, scores
    and labels in pick order, as numpy."""
    keep, _ = batched_nms(boxes, scores, labels, iou_threshold, max_per_img,
                          valid_mask=valid)
    keep = keep.cpu().numpy()
    sel = keep[keep >= 0]
    return (boxes.cpu().numpy()[sel], scores.cpu().numpy()[sel],
            labels.cpu().numpy()[sel])


@torch.no_grad()
def run_tiled_test(model, dataset, collator,
                   merge_iou_threshold: float = 0.5, max_per_img: int = 1000,
                   rescale: bool = True) -> List[dict]:
    """Tiled evaluation over `dataset`, whose samples hold `views`: the
    tile views of one image (CroppedTilesFlipAug), each with its
    `tile_offset` in `img_metas`. A sample's views go through one batched
    `simple_test` on the model's device; the boxes are shifted back into
    the image's frame and merged (`merge_tile_dets`). Returns per image
    bboxes (n, 5) and labels (n,)."""
    device = next(model.parameters()).device
    results: List[dict] = []
    for idx in range(len(dataset)):
        views = dataset[idx]["views"]
        batch = collator(views)
        dets = model.simple_test(
            torch.from_numpy(batch["img"]).to(device),
            torch.from_numpy(batch["img_shape"]).to(device),
            torch.from_numpy(batch["scale_factor"]).to(device), rescale)
        if not isinstance(dets, DetResult):       # (detections, masks)
            dets = dets[0]
        offs = np.stack([np.asarray(v["img_metas"].get(
            "tile_offset", [0.0, 0.0]), np.float32) for v in views])
        shift = torch.from_numpy(np.concatenate([offs, offs], 1)).to(device)
        boxes = dets.bboxes[..., :4] + shift[:, None, :]
        mb, ms, ml = merge_tile_dets(
            boxes.reshape(-1, 4), dets.bboxes[..., 4].reshape(-1),
            dets.labels.reshape(-1), dets.valid.reshape(-1),
            merge_iou_threshold, max_per_img)
        results.append(dict(bboxes=np.concatenate([mb, ms[:, None]], 1),
                            labels=ml))
        if idx % 20 == 0:
            logger.info("tiled test %d/%d (%d tiles)", idx + 1, len(dataset),
                        len(views))
    return results


def unflip_boxes(boxes: torch.Tensor, meta: dict,
                 view_hw: Tuple[int, int]) -> torch.Tensor:
    """A flipped view's boxes (n, 4) mapped back through its flip
    (`flip`, `flip_direction` of its img_metas) about the resized image's
    extent, `img_shape` of the metas (mmdet bbox_flip); `view_hw` stands in
    where the metas have no img_shape."""
    if not meta.get("flip"):
        return boxes
    h, w = (meta["img_shape"][:2] if "img_shape" in meta else view_hw)
    x1, y1, x2, y2 = boxes.unbind(-1)
    if meta.get("flip_direction", "horizontal") == "horizontal":
        return torch.stack([w - x2, y1, w - x1, y2], -1)
    return torch.stack([x1, h - y2, x2, h - y1], -1)


@torch.no_grad()
def run_tta_test(model, dataset, collator, merge_iou_threshold: float = 0.5,
                 max_per_img: int = 100, rescale: bool = True) -> List[dict]:
    """Test-time augmentation (mmdet merge_aug_bboxes path,
    core/post_processing/merge_augs.py): each sample's `views` (one per
    scale and flip) through one batched `simple_test` on the model's
    device; each view's boxes flipped back (`unflip_boxes`) and, with
    `rescale`, divided by its scale factor; then one class-aware NMS over
    all views (`merge_tile_dets`, K1 on the card), the views' detections
    in view order. Returns per image bboxes (n, 5) and labels (n,).

    The JAX package flips about the view's padded width
    (`view["img"].shape`); this one about the resized image's, which is
    mmdet's: the two agree where the pipeline pads nothing."""
    device = next(model.parameters()).device
    results: List[dict] = []
    for idx in range(len(dataset)):
        sample = dataset[idx]
        views = sample["views"] if "views" in sample else [sample]
        batch = collator(views)
        dets = model.simple_test(
            torch.from_numpy(batch["img"]).to(device),
            torch.from_numpy(batch["img_shape"]).to(device))
        if not isinstance(dets, DetResult):       # (detections, masks)
            dets = dets[0]
        boxes = []
        for vi, view in enumerate(views):
            meta = view.get("img_metas", {})
            b = unflip_boxes(dets.bboxes[vi, :, :4], meta,
                             view["img"].shape[:2])
            if rescale:
                b = b / torch.as_tensor(
                    np.asarray(meta.get("scale_factor", [1, 1, 1, 1]),
                               np.float32), device=device)
            boxes.append(b)
        mb, ms, ml = merge_tile_dets(
            torch.cat(boxes), dets.bboxes[..., 4].reshape(-1),
            dets.labels.reshape(-1), dets.valid.reshape(-1),
            merge_iou_threshold, max_per_img)
        results.append(dict(bboxes=np.concatenate([mb, ms[:, None]], 1),
                            labels=ml))
        if idx % 50 == 0:
            logger.info("tta test %d/%d (%d views)", idx + 1, len(dataset),
                        len(views))
    return results


@torch.no_grad()
def run_refine_test(model, dataset, collator, batch_size: int = 1,
                    pseudo_wh=(16, 16), rescale: bool = True) -> List[dict]:
    """CPR annotation refinement over `dataset` (samples with img,
    gt_bboxes, gt_labels and optionally gt_anns_id and img_metas, or whose
    `views[0]` is one), batched by `collator` onto the model's device
    through `refine_test`. Per image and valid gt: bboxes (n, 5), the
    pseudo box and score; labels (n,); points (n, 3), the refined point and
    score; with `rescale` in the original image's frame; and anns_id (n,)
    where the samples carry gt_anns_id."""
    device = next(model.parameters()).device
    results: List[dict] = []
    n = len(dataset)
    for start in range(0, n, batch_size):
        samples = []
        for i in range(start, min(start + batch_size, n)):
            s = dataset[i]
            samples.append(s["views"][0] if "views" in s else s)
        batch = collator(samples)
        t = {k: torch.from_numpy(batch[k]).to(device)
             for k in ("img", "gt_bboxes", "gt_labels", "gt_valid",
                       "img_shape")}
        pts, scores, boxes, _ = (x.cpu().numpy() for x in model.refine_test(
            t["img"], t, pseudo_wh))
        valid, labels = batch["gt_valid"], batch["gt_labels"]
        for bi in range(len(samples)):
            keep = valid[bi]
            sf = batch["scale_factor"][bi]
            bb, pp = boxes[bi][keep], pts[bi][keep]
            if rescale:
                bb = bb / sf
                pp = pp / sf[:2]
            sc = scores[bi][keep][:, None]
            res = dict(bboxes=np.concatenate([bb, sc], 1),
                       labels=labels[bi][keep],
                       points=np.concatenate([pp, sc], 1))
            if "gt_anns_id" in batch:
                res["anns_id"] = batch["gt_anns_id"][bi][keep]
            results.append(res)
        if (start // batch_size) % 50 == 0:
            logger.info("refine test %d/%d", start + len(samples), n)
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
