"""VFNetHead: VarifocalNet, the IoU-aware dense head (mmdet vfnet_head.py).

Counterpart of pointtinybenchmark_tpu/models/dense_heads/vfnet_head.py::
VFNetHead, the Adap TinyPerson baseline's head: GN-stacked cls and reg
branches (`norm_cfg=None` builds GroupNorm, as in the JAX head); a level's
initial box is exp(scale_i * vfnet_reg) * stride, ltrb in pixels. The
star-shaped deformable convolutions of the reference are, as in the JAX
head, a bilinear gather of 9 taps ("zeros" padding) at the corners, edge
midpoints and centre of the initial box, in feature cells from each
position (`star_gather`), followed by a 1x1 conv over the 9 C gathered
channels, tap-major (`reg_refine_dcn`, `cls_dcn`). The gather's points
come from (1 - g) detach(init) + g init, so they pass a tenth of the
gradient at the configs' `gradient_mul` 0.1. The refined box is
exp(scale_refine_i * vfnet_reg_refine) * detach(init); `vfnet_cls`
scores the classes on the cls branch's gathered features.

Training: ATSS (`atss_assign`) on squares of half-side stride *
anchor_scale / 2 at the cell centres of one flat point set; the varifocal
target is the detached IoU of the refined box with its gt, clipped into
[0, 1], on the positives (VarifocalLoss over the positives of the whole
batch); GIoU on the initial boxes weighted by their detached clipped IoU,
and on the refined boxes weighted by the varifocal target, each over its
weights' sum (at least 1e-6). Inference, per level: the top `nms_pre`
cells by max(sigmoid(cls)) (a stable sort), the refined boxes decoded and
clipped, then one batched `multiclass_nms` (IoU 0.6 unless the config
says otherwise).

Forward outputs are NCHW: (cls_outs, init_outs, refine_outs); flat views
follow the JAX head's (H, W) order.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ...core.bbox import distance2bbox
from ...core.post_processing import DetResult
from ...ops.grid_sample import point_sample_pixel
from ...ops.iou import bbox_overlaps_aligned
from ..losses import build_loss
from ..utils import bias_init_with_prob, lecun_normal_, normal_init, one_hot
from .anchor_head import (clip_to_image, nms_of_config, top_indices,
                          with_background)
from .atss_head import atss_assign
from .fcos_head import Scale, flat_levels, flat_points, gn_branches

__all__ = ["VFNetHead"]

# the star's (dy, dx) signs over the initial box's sides, row-major: -1
# takes the top / left distance, 1 the bottom / right one, 0 the centre
STAR = ((-1, -1), (-1, 0), (-1, 1),
        (0, -1), (0, 0), (0, 1),
        (1, -1), (1, 0), (1, 1))
VFL = dict(type="VarifocalLoss", use_sigmoid=True, alpha=0.75, gamma=2.0,
           iou_weighted=True, loss_weight=1.0)


class VFNetHead(nn.Module):

    def __init__(self, num_classes: int, in_channels: int,
                 feat_channels: int = 256, stacked_convs: int = 3,
                 strides: Sequence[int] = (8, 16, 32, 64, 128),
                 gradient_mul: float = 0.1, anchor_scale: int = 8,
                 atss_topk: int = 9, norm_cfg: Optional[dict] = None,
                 loss_cls: Optional[dict] = None,
                 loss_bbox: Optional[dict] = None,
                 loss_bbox_refine: Optional[dict] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None):
        super().__init__()
        self.num_classes = num_classes
        self.strides = list(strides)
        self.gradient_mul = gradient_mul
        self.anchor_scale = anchor_scale
        self.atss_topk = atss_topk
        self.loss_cls_cfg = dict(loss_cls or VFL)
        self.loss_bbox_cfg = dict(loss_bbox or dict(type="GIoULoss",
                                                    loss_weight=1.5))
        self.loss_refine_cfg = dict(loss_bbox_refine or dict(
            type="GIoULoss", loss_weight=2.0))
        self.train_cfg = dict(train_cfg or {})
        self.test_cfg = dict(test_cfg or {})
        self.cls_convs, self.reg_convs = gn_branches(
            in_channels, feat_channels, stacked_convs, norm_cfg)
        c = feat_channels if stacked_convs else in_channels
        k = len(STAR)
        self.vfnet_reg = nn.Conv2d(c, 4, 3, padding=1)
        self.reg_refine_dcn = nn.Conv2d(k * c, feat_channels, 1)
        self.vfnet_reg_refine = nn.Conv2d(feat_channels, 4, 3, padding=1)
        self.cls_dcn = nn.Conv2d(k * c, feat_channels, 1)
        self.vfnet_cls = nn.Conv2d(feat_channels, num_classes, 3, padding=1)
        self.scales = nn.ModuleList(Scale() for _ in self.strides)
        self.scales_refine = nn.ModuleList(Scale() for _ in self.strides)
        self._points: Dict[tuple, Tuple[torch.Tensor, ...]] = {}

    def init_weights(self, generator: torch.Generator) -> None:
        """As the JAX head's: flax's default (`lecun_normal_`) for the
        stacked convs and the 1x1 `reg_refine_dcn` / `cls_dcn` (fan_in
        9 C, zero bias); normal(0.01) for `vfnet_reg`, `vfnet_reg_refine`
        and `vfnet_cls` (with the 0.01 prior on its bias); the scales 1."""
        for m in list(self.cls_convs) + list(self.reg_convs):
            lecun_normal_(m.conv, generator)
        for m in (self.reg_refine_dcn, self.cls_dcn):
            lecun_normal_(m, generator)
        normal_init(self.vfnet_reg, 0.01, generator)
        normal_init(self.vfnet_reg_refine, 0.01, generator)
        normal_init(self.vfnet_cls, 0.01, generator,
                    bias=bias_init_with_prob(0.01))
        for s in list(self.scales) + list(self.scales_refine):
            nn.init.ones_(s.scale)

    # ----------------------------------------------------------- network
    def star_gather(self, feat: torch.Tensor,
                    ltrb_cells: torch.Tensor) -> torch.Tensor:
        """feat (B, C, H, W); ltrb_cells (B, 4, H, W), each position's box
        sides in feature cells -> (B, 9 C, H, W), the star's 9 taps sampled
        bilinearly (zeros outside the map), tap-major, channels-last in
        memory."""
        b, c, h, w = feat.shape
        gy = torch.arange(h, dtype=feat.dtype, device=feat.device)[
            None, :, None]
        gx = torch.arange(w, dtype=feat.dtype, device=feat.device)[
            None, None, :]
        left, top, right, bottom = ltrb_cells.unbind(1)
        zero = ltrb_cells.new_zeros(())
        pts = []
        for sy, sx in STAR:
            dy = -top if sy < 0 else (bottom if sy > 0 else zero)
            dx = -left if sx < 0 else (right if sx > 0 else zero)
            pts.append(torch.stack([(gx + dx).expand(b, h, w),
                                    (gy + dy).expand(b, h, w)], -1))
        p = torch.stack(pts, 3).reshape(b, h * w * len(STAR), 2)
        out = point_sample_pixel(feat.permute(0, 2, 3, 1), p,
                                 padding_mode="zeros")
        return out.reshape(b, h, w, len(STAR) * c).permute(0, 3, 1, 2)

    def forward(self, feats: Sequence[torch.Tensor]):
        """Per-level NCHW features -> per-level (cls_outs, init_outs,
        refine_outs), the boxes ltrb in pixels."""
        cls_outs, init_outs, refine_outs = [], [], []
        g = self.gradient_mul
        for feat, s, scale, scale_r in zip(feats, self.strides, self.scales,
                                           self.scales_refine):
            cf, rf = feat, feat
            for conv in self.cls_convs:
                cf = conv(cf)
            for conv in self.reg_convs:
                rf = conv(rf)
            s = float(s)
            init = torch.exp(scale(self.vfnet_reg(rf))) * s
            init_d = init.detach()
            cells = ((1 - g) * init_d + g * init) / s
            ref_feat = torch.relu(self.reg_refine_dcn(
                self.star_gather(rf, cells)))
            refine = torch.exp(scale_r(self.vfnet_reg_refine(ref_feat))) \
                * init_d
            cls_feat = torch.relu(self.cls_dcn(self.star_gather(cf, cells)))
            cls_outs.append(self.vfnet_cls(cls_feat))
            init_outs.append(init)
            refine_outs.append(refine)
        return cls_outs, init_outs, refine_outs

    def flat_points(self, featmap_sizes: Sequence[Tuple[int, int]],
                    device: torch.device) -> Tuple[torch.Tensor, ...]:
        """Every level's cell centres (N, 2) and strides (N,), float32 on
        `device`."""
        return flat_points(self._points, featmap_sizes, self.strides, device)

    # -------------------------------------------------------------- loss
    def loss(self, cls_outs, init_outs, refine_outs,
             batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        """The head's losses on a batch (gt_bboxes (B, G, 4), gt_labels,
        gt_valid); nothing is sampled, so `generator` is unused."""
        del generator
        b = cls_outs[0].shape[0]
        sizes = [tuple(c.shape[-2:]) for c in cls_outs]
        points, strides = self.flat_points(sizes, cls_outs[0].device)
        cls_cat = torch.cat(flat_levels(cls_outs, b, self.num_classes), 1)
        init_cat = torch.cat(flat_levels(init_outs, b, 4), 1)
        ref_cat = torch.cat(flat_levels(refine_outs, b, 4), 1)
        half = strides[:, None] * self.anchor_scale / 2
        anchors = torch.cat([points - half, points + half], -1)
        gt = batch["gt_bboxes"]
        assigned = atss_assign(anchors, [h * w for h, w in sizes], gt,
                               batch["gt_valid"], self.atss_topk)
        pos = assigned > 0
        safe = (assigned - 1).clamp(0, gt.shape[1] - 1)
        gb = gt.gather(1, safe[..., None].expand(-1, -1, 4))
        labels = torch.where(pos, batch["gt_labels"].long().gather(1, safe),
                             self.num_classes)
        pts_b = points[None].expand(b, -1, -1)
        boxes_init = distance2bbox(pts_b, init_cat)
        boxes_ref = distance2bbox(pts_b, ref_cat)
        pos_f = pos.to(cls_cat.dtype)
        num_pos = pos_f.sum().clamp(min=1.0)
        q = bbox_overlaps_aligned(boxes_ref, gb).detach().clamp(0, 1) * pos_f
        w_init = bbox_overlaps_aligned(boxes_init, gb).detach().clamp(
            0, 1) * pos_f
        target = one_hot(labels, self.num_classes) * q[..., None]
        loss_cls = build_loss(self.loss_cls_cfg)(
            cls_cat.reshape(-1, self.num_classes),
            target.reshape(-1, self.num_classes), avg_factor=num_pos)
        loss_bbox = build_loss(self.loss_bbox_cfg)(
            boxes_init.reshape(-1, 4), gb.reshape(-1, 4),
            weight=w_init.reshape(-1), avg_factor=w_init.sum().clamp(
                min=1e-6))
        loss_refine = build_loss(self.loss_refine_cfg)(
            boxes_ref.reshape(-1, 4), gb.reshape(-1, 4),
            weight=q.reshape(-1), avg_factor=q.sum().clamp(min=1e-6))
        return {"loss_cls": loss_cls, "loss_bbox": loss_bbox,
                "loss_bbox_rf": loss_refine, "num_pos": num_pos}

    # --------------------------------------------------------- inference
    def get_bboxes(self, cls_outs, init_outs, refine_outs,
                   img_shapes: torch.Tensor,
                   scale_factors: Optional[torch.Tensor] = None
                   ) -> DetResult:
        del init_outs
        nms_pre = int(self.test_cfg.get("nms_pre", 1000))
        nms = dict(self.test_cfg.get("nms") or {})
        nms.setdefault("iou_threshold", 0.6)
        b = cls_outs[0].shape[0]
        sizes = [tuple(c.shape[-2:]) for c in cls_outs]
        points, _ = self.flat_points(sizes, cls_outs[0].device)
        boxes, scores = [], []
        for pts, sc, ref in zip(
                points.split([h * w for h, w in sizes]),
                flat_levels(cls_outs, b, self.num_classes),
                flat_levels(refine_outs, b, 4)):
            sc = sc.sigmoid()
            idx = top_indices(sc.amax(-1), nms_pre)
            dist = ref.gather(1, idx[..., None].expand(-1, -1, 4))
            boxes.append(clip_to_image(distance2bbox(pts[idx], dist),
                                       img_shapes))
            scores.append(sc.gather(
                1, idx[..., None].expand(-1, -1, self.num_classes)))
        return nms_of_config(dict(self.test_cfg, nms=nms),
                             torch.cat(boxes, 1), with_background(scores),
                             scale_factors=scale_factors)
