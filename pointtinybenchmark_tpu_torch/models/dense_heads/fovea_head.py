"""FoveaHead: the anchor-free head of FoveaBox (mmdet fovea_head.py).

Counterpart of pointtinybenchmark_tpu/models/dense_heads/fovea_head.py::
FoveaHead (its `align=False` form, the one the JAX package has):
`stacked_convs` 3x3 ConvModules on a cls and a reg branch, then `conv_cls`
and `conv_reg`. Unlike the FCOS, ATSS and RepPoints heads, `norm_cfg=None`
builds no norm here, as in the JAX head: the stacked convs are then
biased 3x3 convs with a ReLU. Points sit at the cell centres, x = ix * s
+ s / 2 (FCOS's are s // 2; the two agree at even strides).

Training, batched over images as a (B, N, G) reduction: a point is a
candidate of a gt when the gt's edge sqrt(max(w h, 1e-6)) lies in the
level's scale range (inclusive at both ends, so an edge on a bound
matches two levels) and the point lies in the gt shrunk about its centre
to `sigma` of its size, cx +- 0.5 sigma w (inclusive too); among several
candidates the gt of least area wins, the first on a tie; padded gts
never match. The regression target is log(clip(d / base_edge, 1/16, 16))
of the point's four side distances to its gt. Losses: the focal loss
over the positives' count and smooth L1 on the positives' four sides over
four times that count.

Inference, per level: the top `nms_pre` points by their best sigmoid
score (a stable sort: lax.top_k's order), boxes exp(reg) * base_edge
about the point, clipped to the image, then one batched `multiclass_nms`
(K1 on a card). Forward outputs are NCHW; the flat (B, H*W, C) views
follow the JAX head's (H, W) order.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ...core.bbox import distance2bbox
from ...core.post_processing import DetResult
from ..losses import build_loss
from ..utils import (ConvModule, bias_init_with_prob, lecun_normal_,
                     normal_init)
from .anchor_head import (clip_to_image, nms_of_config, top_indices,
                          with_background)
from .fcos_head import FOCAL, flat_levels

__all__ = ["FoveaHead"]

INF = 1e8
SMOOTH_L1 = dict(type="SmoothL1Loss", beta=0.11, loss_weight=1.0)


class FoveaHead(nn.Module):

    def __init__(self, num_classes: int, in_channels: int,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 strides: Sequence[int] = (8, 16, 32, 64, 128),
                 base_edge_list: Sequence[int] = (16, 32, 64, 128, 256),
                 scale_ranges: Sequence[Tuple[float, float]] = (
                     (1, 64), (32, 128), (64, 256), (128, 512), (256, 2048)),
                 sigma: float = 0.4,
                 norm_cfg: Optional[dict] = None,
                 loss_cls: Optional[dict] = None,
                 loss_bbox: Optional[dict] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None):
        super().__init__()
        del train_cfg                   # the assignment takes no config
        self.num_classes = num_classes
        self.strides = list(strides)
        self.base_edges = [float(e) for e in base_edge_list]
        self.scale_ranges = [tuple(map(float, r)) for r in scale_ranges]
        self.sigma = sigma
        self.loss_cls_cfg = dict(loss_cls or FOCAL)
        self.loss_bbox_cfg = dict(loss_bbox or SMOOTH_L1)
        self.test_cfg = dict(test_cfg or {})
        norm = (norm_cfg or {}).get("type")
        groups = (norm_cfg or {}).get("num_groups", 32)
        chans = [in_channels] + [feat_channels] * stacked_convs
        self.cls_convs, self.reg_convs = (nn.ModuleList(
            ConvModule(chans[i], chans[i + 1], 3, norm=norm,
                       num_groups=groups)
            for i in range(stacked_convs)) for _ in range(2))
        self.conv_cls = nn.Conv2d(chans[-1], num_classes, 3, padding=1)
        self.conv_reg = nn.Conv2d(chans[-1], 4, 3, padding=1)
        self._points: Dict[tuple, Tuple[torch.Tensor, ...]] = {}

    def init_weights(self, generator: torch.Generator) -> None:
        """As the JAX head's: the stacked convs flax's default
        (`lecun_normal_`, bias 0), the output convs normal(0.01) with the
        0.01 prior on `conv_cls`'s bias."""
        for m in list(self.cls_convs) + list(self.reg_convs):
            lecun_normal_(m.conv, generator)
        normal_init(self.conv_cls, 0.01, generator,
                    bias=bias_init_with_prob(0.01))
        normal_init(self.conv_reg, 0.01, generator)

    def forward(self, feats: Sequence[torch.Tensor]):
        """Per-level NCHW features -> per-level (cls_outs, reg_outs)."""
        cls_outs, reg_outs = [], []
        for feat in feats:
            cf, rf = feat, feat
            for conv in self.cls_convs:
                cf = conv(cf)
            for conv in self.reg_convs:
                rf = conv(rf)
            cls_outs.append(self.conv_cls(cf))
            reg_outs.append(self.conv_reg(rf))
        return cls_outs, reg_outs

    # ------------------------------------------------------------ points
    def flat_points(self, featmap_sizes: Sequence[Tuple[int, int]],
                    device: torch.device) -> Tuple[torch.Tensor, ...]:
        """Every level's cell centres (N, 2), base edge (N,) and scale range
        (N, 2), concatenated, float32 on `device`; kept by sizes and
        device."""
        key = (tuple(featmap_sizes), str(device))
        if key not in self._points:
            pts, bases, ranges = [], [], []
            for (h, w), s, be, rr in zip(featmap_sizes, self.strides,
                                         self.base_edges, self.scale_ranges):
                xs = (np.arange(w) * s + s / 2).astype(np.float32)
                ys = (np.arange(h) * s + s / 2).astype(np.float32)
                xx, yy = np.meshgrid(xs, ys)
                pts.append(np.stack([xx.ravel(), yy.ravel()], -1))
                bases.append(np.full(h * w, be, np.float32))
                ranges.append(np.tile(np.asarray(rr, np.float32), (h * w, 1)))
            self._points[key] = tuple(
                torch.from_numpy(np.concatenate(t)).to(device)
                for t in (pts, bases, ranges))
        return self._points[key]

    # ----------------------------------------------------------- targets
    def get_targets(self, points: torch.Tensor, bases: torch.Tensor,
                    ranges: torch.Tensor, batch: Dict[str, torch.Tensor]):
        """labels (B, N) (num_classes where not positive), the log-space
        side targets (B, N, 4) and the positives (B, N) bool, for every
        image at once: gts (B, G, 4) with gt_labels and gt_valid."""
        gt = batch["gt_bboxes"]
        w = gt[..., 2] - gt[..., 0]
        h = gt[..., 3] - gt[..., 1]
        edge = torch.sqrt((w * h).clamp(min=1e-6))[:, None, :]  # (B, 1, G)
        in_range = ((edge >= ranges[None, :, None, 0])
                    & (edge <= ranges[None, :, None, 1]))       # (B, N, G)
        cx = ((gt[..., 0] + gt[..., 2]) / 2)[:, None, :]
        cy = ((gt[..., 1] + gt[..., 3]) / 2)[:, None, :]
        hw = (0.5 * self.sigma * w)[:, None, :]
        hh = (0.5 * self.sigma * h)[:, None, :]
        px = points[None, :, None, 0]
        py = points[None, :, None, 1]
        inside = ((px >= cx - hw) & (px <= cx + hw)
                  & (py >= cy - hh) & (py <= cy + hh))
        cand = in_range & inside & batch["gt_valid"][:, None, :]
        area_mat = torch.where(cand, (w * h)[:, None, :], INF)
        pos = area_mat.amin(-1) < INF
        gt_idx = area_mat.argmin(-1)        # the first minimum, as JAX's
        labels = torch.where(pos, batch["gt_labels"].long().gather(1, gt_idx),
                             self.num_classes)
        gb = gt.gather(1, gt_idx[..., None].expand(-1, -1, 4))  # (B, N, 4)
        p = points[None]
        d = torch.stack([p[..., 0] - gb[..., 0], p[..., 1] - gb[..., 1],
                         gb[..., 2] - p[..., 0], gb[..., 3] - p[..., 1]], -1)
        tgt = torch.log((d / bases[None, :, None]).clamp(1.0 / 16, 16.0))
        return labels, tgt, pos

    # -------------------------------------------------------------- loss
    def loss(self, cls_outs, reg_outs, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        """The head's losses on a batch (gt_bboxes (B, G, 4), gt_labels,
        gt_valid); nothing is sampled, so `generator` is unused."""
        del generator
        b = cls_outs[0].shape[0]
        points, bases, ranges = self.flat_points(
            [tuple(c.shape[-2:]) for c in cls_outs], cls_outs[0].device)
        cls_cat = torch.cat(flat_levels(cls_outs, b, self.num_classes), 1)
        reg_cat = torch.cat(flat_levels(reg_outs, b, 4), 1)
        labels, tgt, pos = self.get_targets(points, bases, ranges, batch)
        pos_f = pos.to(cls_cat.dtype).reshape(-1)
        num_pos = pos_f.sum().clamp(min=1.0)
        loss_cls = build_loss(self.loss_cls_cfg)(
            cls_cat.reshape(-1, self.num_classes), labels.reshape(-1),
            avg_factor=num_pos)
        loss_bbox = build_loss(self.loss_bbox_cfg)(
            reg_cat.reshape(-1, 4), tgt.reshape(-1, 4),
            weight=pos_f[:, None].expand(-1, 4), avg_factor=num_pos * 4)
        return {"loss_cls": loss_cls, "loss_bbox": loss_bbox,
                "num_pos": num_pos}

    # --------------------------------------------------------- inference
    def get_bboxes(self, cls_outs, reg_outs, img_shapes: torch.Tensor,
                   scale_factors: Optional[torch.Tensor] = None
                   ) -> DetResult:
        nms_pre = int(self.test_cfg.get("nms_pre", 1000))
        b = cls_outs[0].shape[0]
        sizes = [tuple(c.shape[-2:]) for c in cls_outs]
        points, _, _ = self.flat_points(sizes, cls_outs[0].device)
        level_points = points.split([h * w for h, w in sizes])
        boxes, scores = [], []
        for pts, be, sc, reg in zip(
                level_points, self.base_edges,
                flat_levels(cls_outs, b, self.num_classes),
                flat_levels(reg_outs, b, 4)):
            sc = sc.sigmoid()
            idx = top_indices(sc.amax(-1), nms_pre)
            dist = reg.gather(1, idx[..., None].expand(-1, -1, 4)).exp() * be
            boxes.append(clip_to_image(distance2bbox(pts[idx], dist),
                                       img_shapes))
            scores.append(sc.gather(
                1, idx[..., None].expand(-1, -1, self.num_classes)))
        return nms_of_config(self.test_cfg, torch.cat(boxes, 1),
                             with_background(scores),
                             scale_factors=scale_factors)
