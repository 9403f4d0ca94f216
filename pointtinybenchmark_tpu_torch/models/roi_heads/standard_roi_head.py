"""StandardRoIHead, the second stage of Faster R-CNN and Mask R-CNN:
inference.

Counterpart of pointtinybenchmark_tpu/models/roi_heads/standard_roi_head.py
(`_extractor_cfg`, `_mask_extractor_cfg`, `simple_test`). The proposals of
every tile go through one RoIAlign call (`single_roi_extract`: the CUDA
kernel on the card) and one pass of the bbox head; then a softmax over
num_classes + 1, the class-wise delta decode with the head's coder, a clip
to each tile, with `rescale` a division by each image's scale factor, and
one `multiclass_nms` batched over tiles, in which the proposals' validity
mask keeps the empty proposal slots out. With a mask head, every slot of
the detections (the empty ones are zero boxes), back in the network's frame,
goes through the mask extractor (one more RoIAlign call) and the mask head;
each slot keeps the sigmoid of its label's channel. The heads come built
(`models/builder.py` builds them from the config's dicts).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ...core.bbox import delta_decoder
from ...core.post_processing import DetResult, multiclass_nms
from .bbox_head import Shared2FCBBoxHead
from .mask_head import FCNMaskHead
from .roi_extractor import single_roi_extract

__all__ = ["StandardRoIHead"]


def _extractor_cfg(cfg: Optional[dict], output_size: int) -> dict:
    """single_roi_extract's arguments from an extractor's config; mmcv's
    adaptive sampling_ratio=0 becomes a static 2, as in JAX."""
    cfg = dict(cfg or {})
    if cfg.get("type", "SingleRoIExtractor") != "SingleRoIExtractor":
        raise NotImplementedError(f"{cfg['type']} is not ported")
    roi_layer = dict(cfg.get("roi_layer", {}))
    return dict(
        featmap_strides=tuple(cfg.get("featmap_strides", (4, 8, 16, 32))),
        output_size=int(roi_layer.get("output_size", output_size)),
        sampling_ratio=int(roi_layer.get("sampling_ratio", 0)) or 2,
        finest_scale=float(cfg.get("finest_scale", 56)),
        aligned=bool(roi_layer.get("aligned", True)))


class StandardRoIHead(nn.Module):

    def __init__(self, bbox_head: Shared2FCBBoxHead,
                 bbox_roi_extractor: Optional[dict] = None,
                 mask_roi_extractor: Optional[dict] = None,
                 mask_head: Optional[FCNMaskHead] = None,
                 test_cfg: Optional[dict] = None):
        super().__init__()
        self.bbox_extractor = _extractor_cfg(bbox_roi_extractor, 7)
        # without its own extractor the mask branch shares the bbox one's
        # (mmdet share_roi_extractor), with its own default output size
        self.mask_extractor = _extractor_cfg(
            mask_roi_extractor or bbox_roi_extractor, 14)
        self.bbox_head = bbox_head
        self.mask_head = mask_head
        coder = self.bbox_head.bbox_coder
        self.decode = delta_decoder(coder)
        self.means = tuple(coder.get("target_means", (0., 0., 0., 0.)))
        self.stds = tuple(coder.get("target_stds", (0.1, 0.1, 0.2, 0.2)))
        self.test_cfg = dict(test_cfg or {})

    @property
    def num_classes(self) -> int:
        return self.bbox_head.num_classes

    def init_weights(self, generator: torch.Generator) -> None:
        self.bbox_head.init_weights(generator)
        if self.mask_head is not None:
            self.mask_head.init_weights(generator)

    @staticmethod
    def _extract(feats: Sequence[torch.Tensor], boxes: torch.Tensor,
                 cfg: dict) -> torch.Tensor:
        """boxes (B, P, 4) -> RoI features (B * P, C, S, S), image-major."""
        b, p = boxes.shape[:2]
        batch_idx = torch.arange(b, dtype=boxes.dtype,
                                 device=boxes.device).repeat_interleave(p)
        rois = torch.cat([batch_idx[:, None], boxes.reshape(b * p, 4)], 1)
        return single_roi_extract(feats[:len(cfg["featmap_strides"])], rois,
                                  **cfg)

    def forward(self, feats: Sequence[torch.Tensor], proposals: torch.Tensor):
        """feats: per-level (B, C, H, W); proposals (B, P, 4) -> bbox head
        outputs for all B * P rois, image-major."""
        return self.bbox_head(self._extract(feats, proposals,
                                            self.bbox_extractor))

    def mask_forward(self, feats: Sequence[torch.Tensor],
                     boxes: torch.Tensor) -> torch.Tensor:
        """feats: per-level (B, C, H, W); boxes (B, M, 4) in the network's
        frame -> mask logits (B * M, num_classes, 2S, 2S), image-major."""
        return self.mask_head(self._extract(feats, boxes,
                                            self.mask_extractor))

    def simple_test(self, feats: Sequence[torch.Tensor],
                    proposals: torch.Tensor, prop_valid: torch.Tensor,
                    img_shapes: torch.Tensor,
                    scale_factors: Optional[torch.Tensor] = None,
                    rescale: bool = False
                    ) -> Union[DetResult, Tuple[DetResult, torch.Tensor]]:
        """The detections of each image, (B, max_per_img) slots; with
        `rescale` their boxes are divided by `scale_factors` (B, 4). With a
        mask head, also the mask probabilities of every slot,
        (B, max_per_img, 2S, 2S)."""
        cfg = self.test_cfg
        nc = self.num_classes
        b, p = proposals.shape[:2]
        cls_score, bbox_pred = self(feats, proposals)
        scores = torch.softmax(cls_score, -1).reshape(b, p, nc + 1)
        if bbox_pred.shape[-1] == 4:
            deltas = bbox_pred.reshape(b, p, 1, 4).expand(b, p, nc, 4)
        else:
            deltas = bbox_pred.reshape(b, p, nc, 4)
        boxes = self.decode(proposals[:, :, None, :], deltas, self.means,
                            self.stds)                           # (B, P, C, 4)
        h = img_shapes[:, 0].to(boxes.dtype)[:, None, None]
        w = img_shapes[:, 1].to(boxes.dtype)[:, None, None]
        zero = boxes.new_zeros(())
        x1, y1, x2, y2 = boxes.unbind(-1)
        boxes = torch.stack([
            torch.minimum(torch.maximum(x1, zero), w),
            torch.minimum(torch.maximum(y1, zero), h),
            torch.minimum(torch.maximum(x2, zero), w),
            torch.minimum(torch.maximum(y2, zero), h)], dim=-1)
        rescale = rescale and scale_factors is not None
        if rescale:
            boxes = boxes / scale_factors[:, None, None, :]
        dets = multiclass_nms(
            boxes.reshape(b, p, nc * 4), scores,
            float(cfg.get("score_thr", 0.05)),
            float(cfg.get("nms", {}).get("iou_threshold", 0.5)),
            int(cfg.get("max_per_img", 100)), valid_mask=prop_valid)
        if self.mask_head is None:
            return dets
        det_boxes = dets.bboxes[..., :4]
        if rescale:
            det_boxes = det_boxes * scale_factors[:, None, :]
        logits = self.mask_forward(feats, det_boxes)
        m = det_boxes.shape[1]
        label = dets.labels.reshape(-1).clamp(0, nc - 1).long()
        masks = torch.sigmoid(logits[torch.arange(b * m, device=label.device),
                                     label])
        return dets, masks.reshape(b, m, *masks.shape[1:])
