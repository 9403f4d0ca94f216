"""StandardRoIHead, the second stage of Faster R-CNN: inference, bbox branch.

Counterpart of pointtinybenchmark_tpu/models/roi_heads/standard_roi_head.py
(`_extractor_cfg`, `simple_test` without the mask branch). The proposals of
every tile go through one RoIAlign call (`single_roi_extract`: the CUDA
kernel on the card) and one pass of the bbox head; then a softmax over
num_classes + 1, the class-wise delta decode with the head's coder, a clip
to each tile and one `multiclass_nms` batched over tiles, in which the
proposals' validity mask keeps the empty proposal slots out. The bbox head
comes built (`models/builder.py` builds it from the config's dict).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ...core.bbox import delta_decoder
from ...core.post_processing import DetResult, multiclass_nms
from .bbox_head import Shared2FCBBoxHead
from .roi_extractor import single_roi_extract

__all__ = ["StandardRoIHead"]


class StandardRoIHead(nn.Module):

    def __init__(self, bbox_head: Shared2FCBBoxHead,
                 bbox_roi_extractor: Optional[dict] = None,
                 mask_roi_extractor: Optional[dict] = None,
                 mask_head: Optional[dict] = None,
                 test_cfg: Optional[dict] = None):
        super().__init__()
        if mask_head or mask_roi_extractor:
            raise NotImplementedError("the mask branch is not ported")
        cfg = dict(bbox_roi_extractor or {})
        if cfg.get("type", "SingleRoIExtractor") != "SingleRoIExtractor":
            raise NotImplementedError(f"{cfg['type']} is not ported")
        roi_layer = dict(cfg.get("roi_layer", {}))
        self.featmap_strides = tuple(cfg.get("featmap_strides", (4, 8, 16, 32)))
        self.output_size = int(roi_layer.get("output_size", 7))
        # mmcv's adaptive sampling_ratio=0 becomes a static 2, as in JAX
        self.sampling_ratio = int(roi_layer.get("sampling_ratio", 0)) or 2
        self.finest_scale = float(cfg.get("finest_scale", 56))
        self.aligned = bool(roi_layer.get("aligned", True))
        self.bbox_head = bbox_head
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

    def forward(self, feats: Sequence[torch.Tensor], proposals: torch.Tensor):
        """feats: per-level (B, C, H, W); proposals (B, P, 4) -> bbox head
        outputs for all B * P rois, image-major."""
        b, p = proposals.shape[:2]
        batch_idx = torch.arange(b, dtype=proposals.dtype,
                                 device=proposals.device).repeat_interleave(p)
        rois = torch.cat([batch_idx[:, None], proposals.reshape(b * p, 4)], 1)
        n_lvl = len(self.featmap_strides)
        roi_feats = single_roi_extract(
            feats[:n_lvl], rois, self.featmap_strides, self.output_size,
            self.sampling_ratio, self.finest_scale, self.aligned)
        return self.bbox_head(roi_feats)

    def simple_test(self, feats: Sequence[torch.Tensor],
                    proposals: torch.Tensor, prop_valid: torch.Tensor,
                    img_shapes: torch.Tensor) -> DetResult:
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
        return multiclass_nms(
            boxes.reshape(b, p, nc * 4), scores,
            float(cfg.get("score_thr", 0.05)),
            float(cfg.get("nms", {}).get("iou_threshold", 0.5)),
            int(cfg.get("max_per_img", 100)), valid_mask=prop_valid)
