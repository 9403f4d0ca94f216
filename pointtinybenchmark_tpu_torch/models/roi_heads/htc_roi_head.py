"""Hybrid Task Cascade's RoI head (mmdet roi_heads/htc_roi_head.py,
mask_heads/htc_mask_head.py, mask_heads/fused_semantic_head.py).

Counterpart of pointtinybenchmark_tpu/models/roi_heads/htc_roi_head.py::
HTCMaskHead, FusedSemanticHead and HybridTaskCascadeRoIHead, on the
port's `CascadeRoIHead` (its stage sampling, losses, refinement and test
loop).

`HTCMaskHead` is the FCN mask head with `conv_res`, a 1x1 convolution of
the previous stage's mask features added to its input (the mask
information flow; heads 1.. have it with `mask_info_flow`, as only they are
given features in the JAX head). It returns the logits, the features
after its convolutions, or both.

`FusedSemanticHead`: a 1x1 lateral a level (`lateral_convs.{i}`, JAX
`lateral{i}`) of the first `num_ins` levels, each resized to the
`fusion_level` map and summed; bilinear with half-pixel centres, as
`jax.image.resize(..., "bilinear")`, which antialiases where it shrinks:
`antialias=True` exactly for a level larger than the target (at full width
level 0, 200x334 -> 100x167, is 1.3 off without it). Then `num_convs` 3x3
convolutions with ReLU, a ReLU'd 1x1 `conv_embedding` (the semantic
features) and a 1x1 `conv_logits` (the segmentation logits).

The RoI head's semantic RoI features are RoIAlign (the CUDA kernel on the
card) of the one-level semantic map at `semantic_roi_extractor`'s stride
(8), the box features' S, sampling ratio 2, aligned; they are added to the
box features and the mask features (`semantic_fusion`).

Training (`forward_train`): the semantic loss first (`_semantic_loss`:
the gt bitmaps painted by a max over the instances of label + 1, 0 the
background, unless the batch has `gt_semantic_seg`; nearest-sampled to the
logits' size at floor((i + 0.5) * in / out), which is torch's
"nearest-exact" and `jax.image.resize(..., "nearest")`; sampling before
painting gives the same pixels with (B, G, h, w) masks; cross-entropy over
the pixels that are not 255, times 0.2). Then every stage as the cascade's
(the gts prepended unless its sampler says otherwise), and with masks its
mask loss `loss_s{i}_mask` (weighted like the stage's): on all of the
stage's sampled rois, after the stage's own refinement (`interleaved`,
detached), whose features (with the semantic ones) go through mask heads
0..i-1 for their features (`mask_info_flow`) and head i for logits; binary
cross-entropy at the roi's label against `mask_target` at the logits' size,
averaged over each crop, weighted by the positives, divided by
max(positives, 1). The mask branch extracts at the box extractor's S (7),
so the logits are 14x14 (JAX `_extract`; mmdet uses a 14 -> 28 mask
extractor).

Test (`simple_test`): the semantic features, then the cascade's test with
the semantic RoI features added in every stage (decoded with stage 0's
coder, as the cascade's); with masks, every detection slot's features
through every mask head in turn (each given the previous head's features),
the sigmoids averaged over the stages and taken at the slot's label:
(B, max_per_img, 14, 14).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.post_processing import DetResult
from ..losses.cross_entropy_loss import binary_cross_entropy_with_logits
from ..utils import lecun_normal_
from .bbox_head import Shared2FCBBoxHead
from .cascade_roi_head import CascadeRoIHead
from .mask_head import FCNMaskHead, mask_target
from .roi_extractor import single_roi_extract
from .standard_roi_head import StandardRoIHead

__all__ = ["HTCMaskHead", "FusedSemanticHead", "HybridTaskCascadeRoIHead"]


class HTCMaskHead(FCNMaskHead):

    def __init__(self, num_convs: int = 4, in_channels: int = 256,
                 conv_out_channels: int = 256, num_classes: int = 80,
                 with_conv_res: bool = False):
        super().__init__(num_convs, in_channels, conv_out_channels,
                         num_classes)
        self.conv_res = (nn.Conv2d(conv_out_channels, conv_out_channels, 1)
                         if with_conv_res else None)

    def init_weights(self, generator: torch.Generator) -> None:
        super().init_weights(generator)
        if self.conv_res is not None:
            lecun_normal_(self.conv_res, generator)

    def forward(self, x: torch.Tensor, res_feat: Optional[torch.Tensor] = None,
                return_logits: bool = True, return_feat: bool = True):
        """x (R, C, S, S), res_feat the previous head's features -> logits
        (R, num_classes, 2S, 2S) and/or features (R, C', S, S)."""
        if res_feat is not None:
            x = x + self.conv_res(res_feat)
        for conv in self.convs:
            x = conv(x)
        outs = []
        if return_logits:
            outs.append(self.conv_logits(torch.relu(self.upsample(x))))
        if return_feat:
            outs.append(x)
        return outs[0] if len(outs) == 1 else tuple(outs)


class FusedSemanticHead(nn.Module):

    def __init__(self, num_ins: int = 5, fusion_level: int = 1,
                 num_convs: int = 4, in_channels: int = 256,
                 conv_out_channels: int = 256, num_classes: int = 183):
        super().__init__()
        self.num_ins = num_ins
        self.fusion_level = fusion_level
        self.lateral_convs = nn.ModuleList(
            nn.Conv2d(in_channels, in_channels, 1) for _ in range(num_ins))
        self.convs = nn.ModuleList(
            nn.Conv2d(in_channels if i == 0 else conv_out_channels,
                      conv_out_channels, 3, padding=1)
            for i in range(num_convs))
        last = conv_out_channels if num_convs else in_channels
        self.conv_embedding = nn.Conv2d(last, conv_out_channels, 1)
        self.conv_logits = nn.Conv2d(last, num_classes, 1)

    def init_weights(self, generator: torch.Generator) -> None:
        """Every conv flax's default (`lecun_normal_`), as the JAX head's."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m, generator)

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """feats: per-level (B, C, H, W) -> segmentation logits and the
        semantic features, both at the fusion level's size."""
        fl = self.fusion_level
        h, w = feats[fl].shape[-2:]
        x = self.lateral_convs[fl](feats[fl])
        for i, f in enumerate(feats[:self.num_ins]):
            if i == fl:
                continue
            y = self.lateral_convs[i](f)
            x = x + F.interpolate(
                y, size=(h, w), mode="bilinear", align_corners=False,
                antialias=y.shape[-2] > h or y.shape[-1] > w)
        for conv in self.convs:
            x = torch.relu(conv(x))
        return self.conv_logits(x), torch.relu(self.conv_embedding(x))


class HybridTaskCascadeRoIHead(CascadeRoIHead):

    def __init__(self, bbox_head: Sequence[Shared2FCBBoxHead],
                 mask_head: Optional[Sequence[HTCMaskHead]] = None,
                 semantic_head: Optional[FusedSemanticHead] = None,
                 semantic_roi_extractor: Optional[dict] = None,
                 semantic_fusion: Sequence[str] = ("bbox", "mask"),
                 interleaved: bool = True, mask_info_flow: bool = True,
                 num_stages: int = 3,
                 stage_loss_weights: Sequence[float] = (1.0, 0.5, 0.25),
                 bbox_roi_extractor: Optional[dict] = None,
                 train_cfg=None, test_cfg: Optional[dict] = None):
        super().__init__(bbox_head, num_stages, stage_loss_weights,
                         bbox_roi_extractor, train_cfg, test_cfg)
        self.mask_head = nn.ModuleList(mask_head) if mask_head else None
        self.semantic_head = semantic_head
        self.semantic_strides = tuple(dict(semantic_roi_extractor or {}).get(
            "featmap_strides", (8,)))
        self.semantic_fusion = tuple(semantic_fusion)
        self.interleaved = interleaved
        self.mask_info_flow = mask_info_flow

    def init_weights(self, generator: torch.Generator) -> None:
        super().init_weights(generator)
        for head in self.mask_head or []:
            head.init_weights(generator)
        if self.semantic_head is not None:
            self.semantic_head.init_weights(generator)

    # ------------------------------------------------------------- features
    def _semantic_roi(self, semantic_feat: torch.Tensor,
                      boxes: torch.Tensor, size: int) -> torch.Tensor:
        """RoIAlign of the one-level semantic map: (B * P, C, S, S)."""
        return single_roi_extract(
            [semantic_feat], StandardRoIHead._rois(boxes),
            self.semantic_strides, size, sampling_ratio=2, finest_scale=1e8)

    def _fused(self, feats: Sequence[torch.Tensor], boxes: torch.Tensor,
               semantic_feat: Optional[torch.Tensor], kind: str
               ) -> torch.Tensor:
        """The box extractor's features of boxes (B, P, 4), plus the
        semantic ones where `kind` ("bbox" or "mask") is fused."""
        x = StandardRoIHead._extract(feats, boxes, self.bbox_extractor)
        if semantic_feat is not None and kind in self.semantic_fusion:
            x = x + self._semantic_roi(semantic_feat, boxes, x.shape[-1])
        return x

    # ---------------------------------------------------------------- train
    def _semantic_loss(self, seg_logits: torch.Tensor,
                       batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Cross-entropy of the (B, K, h, w) logits against the painted
        gts (or `gt_semantic_seg`) sampled to (h, w); 255 is ignored."""
        h, w = seg_logits.shape[-2:]
        if "gt_semantic_seg" in batch:
            seg = F.interpolate(batch["gt_semantic_seg"][:, None].float(),
                                size=(h, w), mode="nearest-exact")[:, 0]
        else:
            gm = F.interpolate(batch["gt_masks"], size=(h, w),
                               mode="nearest-exact")          # (B, G, h, w)
            lbl = batch["gt_labels"].long() + 1
            on = (gm > 0) & batch["gt_valid"][..., None, None]
            seg = torch.where(on, lbl[..., None, None], 0).amax(1)
        seg = seg.long()
        valid = (seg != 255).float()
        tgt = seg.clamp(0, seg_logits.shape[1] - 1)
        ce = -torch.log_softmax(seg_logits, 1).gather(1, tgt[:, None])[:, 0]
        return 0.2 * (ce * valid).sum() / valid.sum().clamp(min=1.0)

    def forward_train(self, feats: Sequence[torch.Tensor],
                      proposals: torch.Tensor, prop_valid: torch.Tensor,
                      batch: Dict[str, torch.Tensor],
                      generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """The cascade's losses, with loss_semantic_seg and, with a mask
        head and gt_masks (B, G, H, W) uint8 in the batch, loss_s{i}_mask."""
        losses: Dict[str, torch.Tensor] = {}
        semantic_feat = None
        if self.semantic_head is not None:
            seg_logits, semantic_feat = self.semantic_head(feats)
            losses["loss_semantic_seg"] = self._semantic_loss(seg_logits,
                                                              batch)
        have_masks = self.mask_head is not None and "gt_masks" in batch
        last = self.num_stages - 1
        for i in range(self.num_stages):
            boxes, labels, deltas, pos, sampled, gt_idx = self._stage_sample(
                i, proposals, prop_valid, batch, generator, True)
            cls_score, bbox_pred = self.bbox_head[i](
                self._fused(feats, boxes, semantic_feat, "bbox"))
            losses.update(self._stage_losses(i, cls_score, bbox_pred, labels,
                                             deltas, pos, sampled))
            if i < last or (have_masks and self.interleaved):
                refined = self._refine(i, boxes, cls_score, bbox_pred,
                                       batch["img_shape"])
            if have_masks:
                mask_boxes = refined if self.interleaved else boxes
                x = self._fused(feats, mask_boxes, semantic_feat, "mask")
                res = None
                if self.mask_info_flow:
                    for j in range(i):
                        res = self.mask_head[j](x, res, return_logits=False)
                logits = self.mask_head[i](x, res, return_feat=False)
                losses[f"loss_s{i}_mask"] = self.stage_loss_weights[i] * \
                    self._mask_bce(logits, mask_boxes, labels, pos, gt_idx,
                                   batch["gt_masks"])
            if i < last:
                proposals = refined
                prop_valid = torch.ones(proposals.shape[:2], dtype=torch.bool,
                                        device=proposals.device)
        return losses

    def _mask_bce(self, logits: torch.Tensor, boxes: torch.Tensor,
                  labels: torch.Tensor, pos: torch.Tensor,
                  gt_idx: torch.Tensor, gt_masks: torch.Tensor
                  ) -> torch.Tensor:
        """The mask loss of the logits (B * S, nc, m, m) of the rois on
        boxes (B, S, 4): at each roi's label against its gt's crop."""
        nc = self.num_classes
        targets = mask_target(gt_masks, StandardRoIHead._rois(boxes),
                              gt_idx.reshape(-1), logits.shape[-1])
        logit = logits[torch.arange(logits.shape[0], device=logits.device),
                       labels.reshape(-1).clamp(0, nc - 1)]
        pos = pos.reshape(-1).float()
        bce = binary_cross_entropy_with_logits(logit, targets)
        return (bce.mean(dim=(1, 2)) * pos).sum() / pos.sum().clamp(min=1.0)

    # ----------------------------------------------------------------- test
    def _mask_boxes(self, dets: DetResult,
                    scale_factors: Optional[torch.Tensor],
                    rescale: bool) -> torch.Tensor:
        """Every detection slot's box back in the network's frame."""
        boxes = dets.bboxes[..., :4]
        if rescale and scale_factors is not None:
            boxes = boxes * scale_factors[:, None, :]
        return boxes

    def _label_masks(self, probs: torch.Tensor, dets: DetResult
                     ) -> torch.Tensor:
        """(B * M, nc, m, m) probabilities -> each slot's at its label,
        (B, M, m, m)."""
        b, m = dets.labels.shape
        label = dets.labels.reshape(-1).clamp(0, self.num_classes - 1).long()
        out = probs[torch.arange(b * m, device=label.device), label]
        return out.reshape(b, m, *out.shape[1:])

    def simple_test(self, feats: Sequence[torch.Tensor],
                    proposals: torch.Tensor, prop_valid: torch.Tensor,
                    img_shapes: torch.Tensor,
                    scale_factors: Optional[torch.Tensor] = None,
                    rescale: bool = False):
        """The detections (B, max_per_img) and, with mask heads, their
        masks' probabilities (B, max_per_img, 2S, 2S)."""
        semantic_feat = (self.semantic_head(feats)[1]
                         if self.semantic_head is not None else None)
        dets = self._test_boxes(
            lambda boxes: self._fused(feats, boxes, semantic_feat, "bbox"),
            proposals, prop_valid, img_shapes, scale_factors, rescale)
        if self.mask_head is None:
            return dets
        x = self._fused(feats, self._mask_boxes(dets, scale_factors, rescale),
                        semantic_feat, "mask")
        probs, res = 0.0, None
        for head in self.mask_head:
            if self.mask_info_flow:
                logits, res = head(x, res)
            else:
                logits = head(x, return_feat=False)
            probs = probs + torch.sigmoid(logits)
        return dets, self._label_masks(probs / self.num_stages, dets)
