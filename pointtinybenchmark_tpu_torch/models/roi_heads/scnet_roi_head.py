"""SCNet's RoI head (mmdet roi_heads/scnet_roi_head.py,
mask_heads/global_context_head.py, mask_heads/feature_relay_head.py).

Counterpart of pointtinybenchmark_tpu/models/roi_heads/scnet_roi_head.py::
GlobalContextHead and SCNetRoIHead, on the port's HTC head, with the JAX
head's documented deviations from mmdet kept as the behaviour to match:

- `GlobalContextHead`: `num_convs` ReLU'd 3x3 convolutions on the top
  pyramid level, the global average (the context feature) and a dense
  `fc` to one logit a class; its loss is binary cross-entropy against
  each image's class presence (of its valid gts), averaged, times
  `loss_weight`. Its classes default to the RoI head's.
- one mask head (`mask_head.0`), no mask information flow;
- the global context, projected to the RoI channels by the dense
  `glbctx_proj`, is added to the mask features only (not the box ones);
- the feature relay is `relay_conv`, a 1x1 convolution on the last
  stage's box-extractor RoI features (at conv resolution, not mmdet's
  fc bottleneck), added to the mask features.

Training: the semantic loss, `loss_glbctx`, the stages as HTC's without a
mask branch, then one `loss_mask` (not weighted by a stage) on the last
stage's sampled rois: their features plus the semantic ones, the context
and the relay, through the mask head, as HTC's mask loss. The JAX head
extracts the last stage's rois from the FPN three times (box, relay and
mask features) and the semantic map twice: the same rois on the same maps,
so here each once (the relay of the stages before the last is never read,
and its extraction is not run). Test: the HTC cascade's detections, then
the mask head on every slot's features plus the semantic ones, the context
and the relay of the same features; the sigmoid at the slot's label.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..losses.cross_entropy_loss import binary_cross_entropy_with_logits
from ..utils import lecun_normal_, one_hot
from .bbox_head import Shared2FCBBoxHead
from .htc_roi_head import (FusedSemanticHead, HTCMaskHead,
                           HybridTaskCascadeRoIHead)
from .standard_roi_head import StandardRoIHead

__all__ = ["GlobalContextHead", "SCNetRoIHead"]


class GlobalContextHead(nn.Module):

    def __init__(self, num_convs: int = 4, in_channels: int = 256,
                 conv_out_channels: int = 256, num_classes: int = 80,
                 loss_weight: float = 1.0):
        super().__init__()
        self.num_classes = num_classes
        self.loss_weight = float(loss_weight)
        self.convs = nn.ModuleList(
            nn.Conv2d(in_channels if i == 0 else conv_out_channels,
                      conv_out_channels, 3, padding=1)
            for i in range(num_convs))
        self.out_channels = conv_out_channels if num_convs else in_channels
        self.fc = nn.Linear(self.out_channels, num_classes)

    def init_weights(self, generator: torch.Generator) -> None:
        for m in list(self.convs) + [self.fc]:
            lecun_normal_(m, generator)

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """feats: per-level (B, C, H, W) -> class logits (B, K) and the
        context feature (B, C')."""
        x = feats[-1]
        for conv in self.convs:
            x = torch.relu(conv(x))
        pooled = x.mean((2, 3))
        return self.fc(pooled), pooled

    def loss(self, logits: torch.Tensor, gt_labels: torch.Tensor,
             gt_valid: torch.Tensor) -> torch.Tensor:
        present = (one_hot(gt_labels, self.num_classes)
                   * gt_valid[..., None].float()).amax(1)
        return self.loss_weight * binary_cross_entropy_with_logits(
            logits, present).mean()


class SCNetRoIHead(HybridTaskCascadeRoIHead):

    def __init__(self, bbox_head: Sequence[Shared2FCBBoxHead],
                 mask_head: Optional[Sequence[HTCMaskHead]] = None,
                 semantic_head: Optional[FusedSemanticHead] = None,
                 semantic_roi_extractor: Optional[dict] = None,
                 semantic_fusion: Sequence[str] = ("bbox", "mask"),
                 glbctx_head: Optional[GlobalContextHead] = None,
                 feat_relay_head: Optional[dict] = None,
                 interleaved: bool = True, mask_info_flow: bool = True,
                 num_stages: int = 3,
                 stage_loss_weights: Sequence[float] = (1.0, 0.5, 0.25),
                 bbox_roi_extractor: Optional[dict] = None,
                 train_cfg=None, test_cfg: Optional[dict] = None):
        # the JAX head's own paths use neither interleaving nor info flow
        super().__init__(bbox_head, mask_head, semantic_head,
                         semantic_roi_extractor, semantic_fusion,
                         interleaved, mask_info_flow, num_stages,
                         stage_loss_weights, bbox_roi_extractor, train_cfg,
                         test_cfg)
        roi_ch = int(dict(bbox_roi_extractor or {}).get("out_channels", 256))
        self.glbctx_head = glbctx_head
        self.glbctx_proj = (nn.Linear(glbctx_head.out_channels, roi_ch)
                            if glbctx_head is not None else None)
        self.relay_conv = (nn.Conv2d(roi_ch, roi_ch, 1)
                           if feat_relay_head is not None else None)

    def init_weights(self, generator: torch.Generator) -> None:
        super().init_weights(generator)
        if self.glbctx_head is not None:
            self.glbctx_head.init_weights(generator)
            lecun_normal_(self.glbctx_proj, generator)
        if self.relay_conv is not None:
            lecun_normal_(self.relay_conv, generator)

    def _mask_input(self, boxes: torch.Tensor, extracted: torch.Tensor,
                    semantic: Optional[torch.Tensor],
                    glbctx_feat: Optional[torch.Tensor]) -> torch.Tensor:
        """The mask head's input on boxes (B, P, 4): their box-extractor
        features `extracted`, plus the semantic ones `semantic` (where the
        mask is fused), the projected context of each roi's image and the
        relay of `extracted`."""
        x = extracted
        if semantic is not None and "mask" in self.semantic_fusion:
            x = x + semantic
        if glbctx_feat is not None:
            b, p = boxes.shape[:2]
            ctx = self.glbctx_proj(glbctx_feat).repeat_interleave(p, 0)
            x = x + ctx[:, :, None, None]
        if self.relay_conv is not None:
            x = x + self.relay_conv(extracted)
        return x

    # ---------------------------------------------------------------- train
    def forward_train(self, feats: Sequence[torch.Tensor],
                      proposals: torch.Tensor, prop_valid: torch.Tensor,
                      batch: Dict[str, torch.Tensor],
                      generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """The cascade's losses with loss_semantic_seg, loss_glbctx and,
        with gt_masks in the batch, loss_mask."""
        losses: Dict[str, torch.Tensor] = {}
        semantic_feat = glbctx_feat = None
        if self.semantic_head is not None:
            seg_logits, semantic_feat = self.semantic_head(feats)
            losses["loss_semantic_seg"] = self._semantic_loss(seg_logits,
                                                              batch)
        if self.glbctx_head is not None:
            mc_logits, glbctx_feat = self.glbctx_head(feats)
            losses["loss_glbctx"] = self.glbctx_head.loss(
                mc_logits, batch["gt_labels"], batch["gt_valid"])
        have_masks = self.mask_head is not None and "gt_masks" in batch
        last = self.num_stages - 1
        for i in range(self.num_stages):
            boxes, labels, deltas, pos, sampled, gt_idx = self._stage_sample(
                i, proposals, prop_valid, batch, generator, True)
            x = StandardRoIHead._extract(feats, boxes, self.bbox_extractor)
            masked = have_masks and i == last
            semantic = None
            if semantic_feat is not None and (
                    "bbox" in self.semantic_fusion
                    or (masked and "mask" in self.semantic_fusion)):
                semantic = self._semantic_roi(semantic_feat, boxes,
                                              x.shape[-1])
            box_in = (x + semantic if semantic is not None
                      and "bbox" in self.semantic_fusion else x)
            cls_score, bbox_pred = self.bbox_head[i](box_in)
            losses.update(self._stage_losses(i, cls_score, bbox_pred, labels,
                                             deltas, pos, sampled))
            if masked:
                logits = self.mask_head[0](
                    self._mask_input(boxes, x, semantic, glbctx_feat),
                    return_feat=False)
                losses["loss_mask"] = self._mask_bce(
                    logits, boxes, labels, pos, gt_idx, batch["gt_masks"])
            if i < last:
                proposals = self._refine(i, boxes, cls_score, bbox_pred,
                                         batch["img_shape"])
                prop_valid = torch.ones(proposals.shape[:2], dtype=torch.bool,
                                        device=proposals.device)
        return losses

    # ----------------------------------------------------------------- test
    def simple_test(self, feats: Sequence[torch.Tensor],
                    proposals: torch.Tensor, prop_valid: torch.Tensor,
                    img_shapes: torch.Tensor,
                    scale_factors: Optional[torch.Tensor] = None,
                    rescale: bool = False):
        semantic_feat = (self.semantic_head(feats)[1]
                         if self.semantic_head is not None else None)
        glbctx_feat = (self.glbctx_head(feats)[1]
                       if self.glbctx_head is not None else None)
        dets = self._test_boxes(
            lambda boxes: self._fused(feats, boxes, semantic_feat, "bbox"),
            proposals, prop_valid, img_shapes, scale_factors, rescale)
        if self.mask_head is None:
            return dets
        boxes = self._mask_boxes(dets, scale_factors, rescale)
        x = StandardRoIHead._extract(feats, boxes, self.bbox_extractor)
        semantic = (self._semantic_roi(semantic_feat, boxes, x.shape[-1])
                    if semantic_feat is not None
                    and "mask" in self.semantic_fusion else None)
        logits = self.mask_head[0](
            self._mask_input(boxes, x, semantic, glbctx_feat),
            return_feat=False)
        return dets, self._label_masks(torch.sigmoid(logits), dets)
