"""ATSSHead: Adaptive Training Sample Selection (mmdet atss_head.py and
atss_assigner.py).

Counterpart of pointtinybenchmark_tpu/models/dense_heads/atss_head.py::
atss_assign and ATSSHead: GN-stacked cls and reg branches over the
AnchorHead machinery, with `atss_cls`, `atss_reg` and `atss_centerness`
(on the reg branch); `norm_cfg=None` builds GroupNorm, as in the JAX head.

`atss_assign` runs on the anchors' device, batched over images: per level
the k anchors whose centres lie closest to a gt's centre are its
candidates (every anchor at the k-th distance counts: `<= kth`); the IoU
threshold is the candidates' mean IoU plus their unbiased standard
deviation (divided by count - 1); a positive is a candidate at or above
the threshold whose centre lies inside the gt by more than 0.01; an
anchor positive for several gts takes the highest IoU, the first on a tie.
Losses: focal over the positives' count, GIoU (weight 2 in the configs) on
the decoded boxes weighted by the centerness of the anchor centre in its
gt over the weights' sum, and the centerness BCE. Inference is
AnchorHead's with the centerness as score factor.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ...core.post_processing import DetResult
from ...ops.iou import bbox_overlaps
from ..losses import build_loss
from ..utils import bias_init_with_prob, lecun_normal_, normal_init
from .anchor_head import AnchorHead
from .fcos_head import (FOCAL, centerness_bce, check_centerness_loss,
                        flat_levels, gn_branches)

__all__ = ["ATSSHead", "atss_assign"]


def atss_assign(anchors: torch.Tensor, level_sizes: Sequence[int],
                gt_bboxes: torch.Tensor, gt_valid: torch.Tensor,
                topk: int = 9) -> torch.Tensor:
    """anchors (N, 4) of every level, `level_sizes` their counts per level,
    gts (B, G, 4) with gt_valid (B, G) -> (B, N) int64: 0 background,
    j + 1 for gt j."""
    b = gt_bboxes.shape[0]
    cx = (anchors[:, 0] + anchors[:, 2]) / 2
    cy = (anchors[:, 1] + anchors[:, 3]) / 2
    gx = (gt_bboxes[..., 0] + gt_bboxes[..., 2]) / 2
    gy = (gt_bboxes[..., 1] + gt_bboxes[..., 3]) / 2
    dx = cx[None, :, None] - gx[:, None, :]
    dy = cy[None, :, None] - gy[:, None, :]
    dist = torch.sqrt(dx * dx + dy * dy)                       # (B, N, G)
    ious = bbox_overlaps(anchors.expand(b, -1, -1), gt_bboxes)
    cand = []
    for d_lvl in dist.split(list(level_sizes), dim=1):
        k = min(topk, d_lvl.shape[1])
        kth = d_lvl.topk(k, dim=1, largest=False).values[:, k - 1]
        cand.append(d_lvl <= kth[:, None, :])
    cand = torch.cat(cand, 1) & gt_valid[:, None, :]
    cnt = cand.sum(1).clamp(min=1)                             # (B, G)
    mean = (ious * cand).sum(1) / cnt
    var = ((ious - mean[:, None, :]) ** 2 * cand).sum(1) / (cnt - 1).clamp(
        min=1)
    thr = mean + torch.sqrt(var)
    inside = torch.minimum(
        torch.minimum(cx[None, :, None] - gt_bboxes[:, None, :, 0],
                      gt_bboxes[:, None, :, 2] - cx[None, :, None]),
        torch.minimum(cy[None, :, None] - gt_bboxes[:, None, :, 1],
                      gt_bboxes[:, None, :, 3] - cy[None, :, None])) > 0.01
    pos = cand & (ious >= thr[:, None, :]) & inside
    iou_masked = torch.where(pos, ious, -1.0)
    best = iou_masked.amax(-1)
    return torch.where(best > -1.0, iou_masked.argmax(-1) + 1, 0)


class ATSSHead(AnchorHead):

    def __init__(self, num_classes: int, in_channels: int,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 norm_cfg: Optional[dict] = None,
                 anchor_generator: Optional[dict] = None,
                 bbox_coder: Optional[dict] = None,
                 loss_cls: Optional[dict] = None,
                 loss_bbox: Optional[dict] = None,
                 loss_centerness: Optional[dict] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None):
        self.stacked_convs = stacked_convs
        self.norm_cfg = norm_cfg
        check_centerness_loss(loss_centerness)
        super().__init__(num_classes, in_channels, feat_channels,
                         anchor_generator, bbox_coder, loss_cls or FOCAL,
                         loss_bbox or dict(type="GIoULoss", loss_weight=2.0),
                         train_cfg, test_cfg)

    def _init_layers(self) -> None:
        self.cls_convs, self.reg_convs = gn_branches(
            self.in_channels, self.feat_channels, self.stacked_convs,
            self.norm_cfg)
        a = self.num_base_anchors
        self.atss_cls = nn.Conv2d(self.feat_channels,
                                  a * self.cls_out_channels, 3, padding=1)
        self.atss_reg = nn.Conv2d(self.feat_channels, a * 4, 3, padding=1)
        self.atss_centerness = nn.Conv2d(self.feat_channels, a, 3, padding=1)

    def init_weights(self, generator: torch.Generator) -> None:
        """As the JAX head's: the stacked convs `lecun_normal_`, the output
        convs normal(0.01) with the 0.01 prior on `atss_cls`'s bias."""
        for m in list(self.cls_convs) + list(self.reg_convs):
            lecun_normal_(m.conv, generator)
        normal_init(self.atss_cls, 0.01, generator,
                    bias=bias_init_with_prob(0.01))
        normal_init(self.atss_reg, 0.01, generator)
        normal_init(self.atss_centerness, 0.01, generator)

    def forward(self, feats: Sequence[torch.Tensor]):
        """Per-level NCHW features -> per-level (cls_outs, reg_outs,
        ctr_outs)."""
        cls_outs, reg_outs, ctr_outs = [], [], []
        for feat in feats:
            cf, rf = feat, feat
            for conv in self.cls_convs:
                cf = conv(cf)
            for conv in self.reg_convs:
                rf = conv(rf)
            cls_outs.append(self.atss_cls(cf))
            reg_outs.append(self.atss_reg(rf))
            ctr_outs.append(self.atss_centerness(rf))
        return cls_outs, reg_outs, ctr_outs

    @staticmethod
    def centerness_from_anchor(anchors: torch.Tensor,
                               gts: torch.Tensor) -> torch.Tensor:
        """The centerness of each anchor's centre in its gt (..., 4)."""
        ax = (anchors[..., 0] + anchors[..., 2]) / 2
        ay = (anchors[..., 1] + anchors[..., 3]) / 2
        lr = torch.stack([ax - gts[..., 0], gts[..., 2] - ax], -1)
        tb = torch.stack([ay - gts[..., 1], gts[..., 3] - ay], -1)
        c = ((lr.amin(-1) / lr.amax(-1).clamp(min=1e-12))
             * (tb.amin(-1) / tb.amax(-1).clamp(min=1e-12)))
        return c.clamp(min=1e-12).sqrt()

    def loss(self, cls_outs, reg_outs, ctr_outs,
             batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        """The head's losses on a batch (gt_bboxes (B, G, 4), gt_labels,
        gt_valid); nothing is sampled, so `generator` is unused."""
        del generator
        levels = self.level_anchors([tuple(c.shape[-2:]) for c in cls_outs],
                                    cls_outs[0].device)
        anchors = torch.cat(levels)
        cls_cat, box_cat = self._flatten_preds(cls_outs, reg_outs)
        b, n = cls_cat.shape[:2]
        ctr_cat = torch.cat(flat_levels(ctr_outs, b, None), 1)
        gt = batch["gt_bboxes"]
        assigned = atss_assign(
            anchors, [len(a) for a in levels], gt, batch["gt_valid"],
            int(self.train_cfg.get("assigner", {}).get("topk", 9)))
        pos = assigned > 0
        safe = (assigned - 1).clamp(0, gt.shape[1] - 1)
        tgt = gt.gather(1, safe[..., None].expand(-1, -1, 4))
        labels = torch.where(pos, batch["gt_labels"].long().gather(1, safe),
                             self.num_classes)
        pos_f = pos.to(cls_cat.dtype)
        num_pos = pos_f.sum().clamp(min=1.0)
        loss_cls = build_loss(self.loss_cls_cfg)(
            cls_cat.reshape(b * n, -1), labels.reshape(-1),
            avg_factor=num_pos)
        anchors_b = anchors[None].expand(b, n, 4)
        decoded = self.decode(anchors_b, box_cat, self.means, self.stds)
        ctr_t = torch.where(pos, self.centerness_from_anchor(anchors_b, tgt),
                            0.0)
        loss_bbox = build_loss(self.loss_bbox_cfg)(
            decoded.reshape(-1, 4), tgt.reshape(-1, 4),
            weight=ctr_t.reshape(-1), avg_factor=ctr_t.sum().clamp(min=1e-6))
        return {"loss_cls": loss_cls, "loss_bbox": loss_bbox,
                "loss_centerness": centerness_bce(ctr_cat, ctr_t, pos_f,
                                                  num_pos),
                "num_pos": pos_f.sum()}

    def get_bboxes(self, cls_outs, reg_outs, ctr_outs,
                   img_shapes: torch.Tensor,
                   scale_factors: Optional[torch.Tensor] = None
                   ) -> DetResult:
        return AnchorHead.get_bboxes(self, cls_outs, reg_outs, img_shapes,
                                     factor_outs=ctr_outs,
                                     scale_factors=scale_factors)
