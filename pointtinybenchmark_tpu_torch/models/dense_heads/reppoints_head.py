"""RepPointsHead: the point-set single-stage head (mmdet reppoints_head.py).

Counterpart of pointtinybenchmark_tpu/models/dense_heads/reppoints_head.py::
point_assign and RepPointsHead, the Adap TinyPerson baseline's head:
GN-stacked cls and reg branches (`norm_cfg=None` builds GroupNorm, as in
the JAX head); `pts_init_conv` -> relu -> `pts_init_out` gives 9 initial
points per cell, offsets in strides, (y, x) channel order. The deformable
convolutions of the reference are, as in the JAX head, a bilinear gather
of the 9 taps at the initial points ("zeros" padding; the points pass
their gradient at `gradient_mul`, (1 - g) detach(p) + g p) followed by a
1x1 conv over the 9 C gathered channels, tap-major (`cls_dcn`,
`refine_dcn`): `cls_out` scores the classes, `pts_refine_out` adds
refinements to the detached initial points. `points2bbox` turns a point
set into a box ("moment": the mean and the population standard
deviation, scaled by exp of the head's learnable `moment_transfer`, which
passes its gradient at `moment_mul`; "minmax"; "partial_minmax").

Training: the initial points' targets come from `point_assign` (a gt's
level is (log2(w / s) + log2(h / s)) / 2 truncated toward zero, clipped
to the point levels; on that level the `pos_num` points closest in
normalised distance are its candidates, and a point takes the closest
candidate gt, the first on a tie), the refined points' from MaxIoUAssigner
on the detached initial boxes shifted to the cell centres. Losses: focal
with the assigner's label weights over the refine stage's positives;
SmoothL1 on boxes normalised by point_base_scale * stride, both stages.
Inference: per level the top `nms_pre` cells by max(sigmoid(cls)) (a
stable sort), the refined points' boxes, clipped, then one batched
`multiclass_nms`.

Forward outputs are NCHW: (cls_outs, init_outs, refine_outs,
moment_transfer); flat views follow the JAX head's (H, W) order.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ...core.assigners import MaxIoUAssigner
from ...core.post_processing import DetResult
from ...ops.grid_sample import point_sample_pixel
from ..losses import build_loss
from ..utils import bias_init_with_prob, lecun_normal_, normal_init
from .anchor_head import (clip_to_image, nms_of_config, top_indices,
                          with_background)
from .fcos_head import FOCAL, flat_levels, flat_points, gn_branches

__all__ = ["RepPointsHead", "point_assign"]

TRANSFORMS = ("moment", "minmax", "partial_minmax")


def point_assign(points: torch.Tensor, strides: torch.Tensor,
                 gt_bboxes: torch.Tensor, gt_valid: torch.Tensor,
                 scale: float = 4.0, pos_num: int = 1) -> torch.Tensor:
    """points (N, 2) cell centres and their strides (N,) (powers of two),
    gts (B, G, 4) with gt_valid (B, G) -> (B, N) int64: 0 background, j + 1
    for gt j (the reference's PointAssigner, batched over images)."""
    pts_lvl = torch.log2(strides).to(torch.int32)
    gt_xy = (gt_bboxes[..., :2] + gt_bboxes[..., 2:]) / 2
    gt_wh = (gt_bboxes[..., 2:] - gt_bboxes[..., :2]).clamp(min=1e-6)
    gt_lvl = ((torch.log2(gt_wh[..., 0] / scale)
               + torch.log2(gt_wh[..., 1] / scale)) / 2).to(torch.int32)
    gt_lvl = torch.maximum(torch.minimum(gt_lvl, pts_lvl.max()),
                           pts_lvl.min())                      # (B, G)
    d = (points[None, :, None, :] - gt_xy[:, None]) / gt_wh[:, None]
    dist = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
    ok = (pts_lvl[None, :, None] == gt_lvl[:, None, :]) & gt_valid[:, None, :]
    dist = torch.where(ok, dist, math.inf)                     # (B, N, G)
    kth = dist.topk(pos_num, dim=1, largest=False).values[:, pos_num - 1]
    masked = torch.where(dist <= kth[:, None, :], dist, math.inf)
    best = masked.amin(-1)
    return torch.where(torch.isfinite(best), masked.argmin(-1) + 1, 0)


class RepPointsHead(nn.Module):

    def __init__(self, num_classes: int, in_channels: int,
                 feat_channels: int = 256, point_feat_channels: int = 256,
                 stacked_convs: int = 3, num_points: int = 9,
                 gradient_mul: float = 0.1, point_base_scale: int = 4,
                 point_strides: Sequence[int] = (8, 16, 32, 64, 128),
                 transform_method: str = "moment", moment_mul: float = 0.01,
                 norm_cfg: Optional[dict] = None,
                 loss_cls: Optional[dict] = None,
                 loss_bbox_init: Optional[dict] = None,
                 loss_bbox_refine: Optional[dict] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None):
        super().__init__()
        if transform_method not in TRANSFORMS:
            raise ValueError(f"transform_method {transform_method!r}")
        if int(math.isqrt(num_points)) ** 2 != num_points:
            raise ValueError(f"num_points {num_points} is not a square")
        self.num_classes = num_classes
        self.num_points = num_points
        self.gradient_mul = gradient_mul
        self.point_base_scale = point_base_scale
        self.point_strides = list(point_strides)
        self.transform_method = transform_method
        self.moment_mul = moment_mul
        self.loss_cls_cfg = dict(loss_cls or FOCAL)
        self.loss_init_cfg = dict(loss_bbox_init or dict(
            type="SmoothL1Loss", beta=0.11, loss_weight=0.5))
        self.loss_refine_cfg = dict(loss_bbox_refine or dict(
            type="SmoothL1Loss", beta=0.11, loss_weight=1.0))
        self.train_cfg = dict(train_cfg or {})
        self.test_cfg = dict(test_cfg or {})
        self.cls_convs, self.reg_convs = gn_branches(
            in_channels, feat_channels, stacked_convs, norm_cfg)
        pf, k2 = point_feat_channels, 2 * num_points
        self.pts_init_conv = nn.Conv2d(feat_channels, pf, 3, padding=1)
        self.pts_init_out = nn.Conv2d(pf, k2, 1)
        self.cls_dcn = nn.Conv2d(num_points * feat_channels, pf, 1)
        self.cls_out = nn.Conv2d(pf, num_classes, 1)
        self.refine_dcn = nn.Conv2d(num_points * feat_channels, pf, 1)
        self.pts_refine_out = nn.Conv2d(pf, k2, 1)
        self.moment_transfer = (nn.Parameter(torch.zeros(2))
                                if transform_method == "moment" else None)
        self._points: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def init_weights(self, generator: torch.Generator) -> None:
        """As the JAX head's: flax's default (`lecun_normal_`) for the
        stacked convs, `pts_init_conv` and the 1x1 `cls_dcn` / `refine_dcn`
        (fan_in 9 C); normal(0.01) for `pts_init_out`, `cls_out` (with the
        0.01 prior on its bias) and `pts_refine_out`; `moment_transfer`
        zeros."""
        for m in list(self.cls_convs) + list(self.reg_convs):
            lecun_normal_(m.conv, generator)
        for m in (self.pts_init_conv, self.cls_dcn, self.refine_dcn):
            lecun_normal_(m, generator)
        normal_init(self.pts_init_out, 0.01, generator)
        normal_init(self.cls_out, 0.01, generator,
                    bias=bias_init_with_prob(0.01))
        normal_init(self.pts_refine_out, 0.01, generator)
        if self.moment_transfer is not None:
            nn.init.zeros_(self.moment_transfer)

    # ----------------------------------------------------------- network
    def deform_gather(self, feat: torch.Tensor,
                      offsets: torch.Tensor) -> torch.Tensor:
        """feat (B, C, H, W); offsets (B, 2K, H, W), (y, x) per point in
        cells from each position -> (B, K*C, H, W), the K taps sampled
        bilinearly (zeros outside the map), tap-major, channels-last in
        memory."""
        b, c, h, w = feat.shape
        o = offsets.permute(0, 2, 3, 1).reshape(b, h, w, self.num_points, 2)
        gy = torch.arange(h, dtype=feat.dtype, device=feat.device)
        gx = torch.arange(w, dtype=feat.dtype, device=feat.device)
        sy = gy[None, :, None, None] + o[..., 0]
        sx = gx[None, None, :, None] + o[..., 1]
        pts = torch.stack([sx, sy], -1).reshape(b, h * w * self.num_points, 2)
        out = point_sample_pixel(feat.permute(0, 2, 3, 1), pts,
                                 padding_mode="zeros")
        return out.reshape(b, h, w, self.num_points * c).permute(0, 3, 1, 2)

    def forward(self, feats: Sequence[torch.Tensor]):
        cls_outs, init_outs, refine_outs = [], [], []
        g = self.gradient_mul
        for feat in feats:
            cf, rf = feat, feat
            for conv in self.cls_convs:
                cf = conv(cf)
            for conv in self.reg_convs:
                rf = conv(rf)
            pts_init = self.pts_init_out(torch.relu(self.pts_init_conv(rf)))
            pts_gm = (1 - g) * pts_init.detach() + g * pts_init
            cls_outs.append(self.cls_out(torch.relu(
                self.cls_dcn(self.deform_gather(cf, pts_gm)))))
            refine = self.pts_refine_out(torch.relu(
                self.refine_dcn(self.deform_gather(rf, pts_gm))))
            init_outs.append(pts_init)
            refine_outs.append(refine + pts_init.detach())
        return cls_outs, init_outs, refine_outs, self.moment_transfer

    # ------------------------------------------------------------ decode
    def points2bbox(self, pts_xy: torch.Tensor,
                    moment_transfer: Optional[torch.Tensor]) -> torch.Tensor:
        """(..., 2K) point sets in (x, y) order -> (..., 4) xyxy boxes."""
        pts = pts_xy.reshape(pts_xy.shape[:-1] + (self.num_points, 2))
        x, y = pts[..., 0], pts[..., 1]
        if self.transform_method == "partial_minmax":
            x, y = x[..., :4], y[..., :4]
        if self.transform_method != "moment":
            return torch.stack([x.amin(-1), y.amin(-1), x.amax(-1),
                                y.amax(-1)], -1)
        xm, ym = x.mean(-1), y.mean(-1)
        xs = (x - xm[..., None]).std(-1, correction=0)
        ys = (y - ym[..., None]).std(-1, correction=0)
        mt = (moment_transfer * self.moment_mul
              + moment_transfer.detach() * (1 - self.moment_mul))
        hw = xs * torch.exp(mt[0])
        hh = ys * torch.exp(mt[1])
        return torch.stack([xm - hw, ym - hh, xm + hw, ym + hh], -1)

    def flat_points(self, featmap_sizes: Sequence[Tuple[int, int]],
                    device: torch.device) -> Tuple[torch.Tensor, ...]:
        """Every level's cell centres (N, 2) and strides (N,), float32 on
        `device`."""
        return flat_points(self._points, featmap_sizes, self.point_strides,
                           device)

    def _relative_xy(self, pts_out: torch.Tensor) -> torch.Tensor:
        """(..., 2K) (y, x) offsets -> (..., 2K) (x, y)."""
        o = pts_out.reshape(pts_out.shape[:-1] + (self.num_points, 2))
        return o.flip(-1).reshape(pts_out.shape)

    # -------------------------------------------------------------- loss
    def loss(self, cls_outs, init_outs, refine_outs, moment_transfer,
             batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        """The head's losses on a batch (gt_bboxes (B, G, 4), gt_labels,
        gt_valid); nothing is sampled, so `generator` is unused."""
        del generator
        init_cfg = dict(self.train_cfg.get("init") or dict(
            assigner=dict(type="PointAssigner", scale=4, pos_num=1)))
        refine_cfg = dict(self.train_cfg.get("refine") or dict(
            assigner=dict(type="MaxIoUAssigner", pos_iou_thr=0.5,
                          neg_iou_thr=0.4, min_pos_iou=0,
                          ignore_iof_thr=-1)))
        b = cls_outs[0].shape[0]
        k2 = 2 * self.num_points
        centers, strides = self.flat_points(
            [tuple(c.shape[-2:]) for c in cls_outs], cls_outs[0].device)
        cls_cat = torch.cat(flat_levels(cls_outs, b, self.num_classes), 1)
        init_cat = torch.cat(flat_levels(init_outs, b, k2), 1)
        refine_cat = torch.cat(flat_levels(refine_outs, b, k2), 1)
        ctr2 = centers.repeat(1, self.num_points)               # (N, 2K)
        scale = strides[:, None]
        gt, gt_valid = batch["gt_bboxes"], batch["gt_valid"]

        def gather_gts(assigned):
            safe = (assigned - 1).clamp(0, gt.shape[1] - 1)
            return gt.gather(1, safe[..., None].expand(-1, -1, 4))

        def norm_count(pos):
            return pos.sum(1).clamp(min=1).sum().to(cls_cat.dtype).clamp(
                min=1.0)

        ia = dict(init_cfg["assigner"])
        assigned_init = point_assign(centers, strides, gt, gt_valid,
                                     float(ia.get("scale", 4)),
                                     int(ia.get("pos_num", 1)))
        pos_init = assigned_init > 0
        ra = dict(refine_cfg["assigner"])
        ra.pop("type", None)
        with torch.no_grad():
            rel_box = self.points2bbox(self._relative_xy(init_cat),
                                       moment_transfer)
            cand = rel_box * scale[None] + torch.cat([centers, centers],
                                                     -1)[None]
            assigned, _, labels = MaxIoUAssigner(**ra).assign(
                cand, gt, gt_valid, batch["gt_labels"])
        pos_refine = assigned > 0
        labels = torch.where(pos_refine, labels, self.num_classes)
        label_w = (pos_refine | (assigned == 0)).to(cls_cat.dtype)
        num_init, num_refine = norm_count(pos_init), norm_count(pos_refine)

        loss_cls = build_loss(self.loss_cls_cfg)(
            cls_cat.reshape(-1, self.num_classes), labels.reshape(-1),
            weight=label_w.reshape(-1), avg_factor=num_refine)
        norm4 = (self.point_base_scale * strides)[None, :, None]

        def boxes(pts_out):
            xy = self._relative_xy(pts_out) * scale[None] + ctr2[None]
            return self.points2bbox(xy, moment_transfer) / norm4
        loss_init = build_loss(self.loss_init_cfg)(
            boxes(init_cat), gather_gts(assigned_init) / norm4,
            weight=pos_init.to(cls_cat.dtype)[..., None],
            avg_factor=num_init)
        loss_refine = build_loss(self.loss_refine_cfg)(
            boxes(refine_cat), gather_gts(assigned) / norm4,
            weight=pos_refine.to(cls_cat.dtype)[..., None],
            avg_factor=num_refine)
        return {"loss_cls": loss_cls, "loss_pts_init": loss_init,
                "loss_pts_refine": loss_refine,
                "num_pos": pos_refine.sum().to(cls_cat.dtype)}

    # --------------------------------------------------------- inference
    def get_bboxes(self, cls_outs, init_outs, refine_outs, moment_transfer,
                   img_shapes: torch.Tensor,
                   scale_factors: Optional[torch.Tensor] = None
                   ) -> DetResult:
        del init_outs
        nms_pre = int(self.test_cfg.get("nms_pre", 1000))
        b = cls_outs[0].shape[0]
        sizes = [tuple(c.shape[-2:]) for c in cls_outs]
        centers, _ = self.flat_points(sizes, cls_outs[0].device)
        level_centers = centers.split([h * w for h, w in sizes])
        k2 = 2 * self.num_points
        boxes, scores = [], []
        for ctr, s, sc, pts in zip(
                level_centers, self.point_strides,
                flat_levels(cls_outs, b, self.num_classes),
                flat_levels(refine_outs, b, k2)):
            sc = sc.sigmoid()
            idx = top_indices(sc.amax(-1), nms_pre)
            rel = self.points2bbox(self._relative_xy(
                pts.gather(1, idx[..., None].expand(-1, -1, k2))),
                moment_transfer)
            boxes.append(clip_to_image(
                rel * s + torch.cat([ctr, ctr], -1)[idx], img_shapes))
            scores.append(sc.gather(
                1, idx[..., None].expand(-1, -1, self.num_classes)))
        return nms_of_config(self.test_cfg, torch.cat(boxes, 1),
                             with_background(scores),
                             scale_factors=scale_factors)
