"""FCOSHead: the anchor-free single-stage head (mmdet fcos_head.py).

Counterpart of pointtinybenchmark_tpu/models/dense_heads/fcos_head.py::
FCOSHead, the Adap TinyPerson baseline's head: `stacked_convs` 3x3 convs
with GroupNorm (eps 1e-5) on a cls and a reg branch, then `conv_cls`,
`conv_reg` and `conv_centerness` (on the cls branch); a level's
regression is exp(scale_i * conv_reg), the learnable `Scale` of the
level. Points sit at the cell centres, x = ix * s + s // 2. As in the JAX
head, `norm_cfg=None` still builds GroupNorm (of 32 groups).

Training: a point is a positive of a gt when it lies inside the gt (every
distance > 0) and its largest distance lies in the level's regress range
(>= low, <= high); among several gts the one of least area wins, the
first on a tie (the first-index argmin); padded gts never match. Losses:
focal over the positives' count; IoU loss on the decoded boxes weighted
by the centerness targets over their sum; the centerness BCE in the JAX
form max(x, 0) - x t + log1p(exp(-|x|)) over the positives' count.

Inference, per level: the top `nms_pre` points by max(sigmoid(cls)) *
sigmoid(centerness) (a stable sort: lax.top_k's tie order), decoded and
clipped, then one batched `multiclass_nms` with the centerness as score
factor: the threshold gates the raw class score, the output score is the
product.

`gn_branches` builds the stacked GN branches the dense heads share (FCOS,
ATSS, RepPoints). Forward outputs are NCHW; the flat (B, H*W, C) views
follow the JAX head's (H, W) order.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ...core.bbox import distance2bbox
from ...core.post_processing import DetResult
from ..losses import build_loss
from ..losses.cross_entropy_loss import binary_cross_entropy_with_logits
from ..utils import (ConvModule, bias_init_with_prob, lecun_normal_,
                     normal_init)
from .anchor_head import (clip_to_image, nms_of_config, top_indices,
                          with_background)

__all__ = ["FCOSHead", "Scale", "gn_branches", "center_points",
           "centerness_bce", "flat_levels", "flat_points"]

INF = 1e8
FOCAL = dict(type="FocalLoss", use_sigmoid=True, gamma=2.0, alpha=0.25,
             loss_weight=1.0)
CENTERNESS = dict(type="CrossEntropyLoss", use_sigmoid=True, loss_weight=1.0)


class Scale(nn.Module):
    """A learnable scalar factor (mmcv's Scale), initialised to 1."""

    def __init__(self, scale: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(scale, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale


def gn_branches(in_channels: int, feat_channels: int, stacked_convs: int,
                norm_cfg: Optional[dict]) -> Tuple[nn.ModuleList, ...]:
    """(cls_convs, reg_convs): `stacked_convs` 3x3 ConvModules each, with
    the norm of `norm_cfg` and GroupNorm(32) where it is None, as the JAX
    heads' `(norm_cfg or {"type": "GN"})`."""
    norm = (norm_cfg or {"type": "GN"}).get("type")
    groups = (norm_cfg or {}).get("num_groups", 32)
    chans = [in_channels] + [feat_channels] * stacked_convs
    return tuple(nn.ModuleList(
        ConvModule(chans[i], chans[i + 1], 3, norm=norm, num_groups=groups)
        for i in range(stacked_convs)) for _ in range(2))


def check_centerness_loss(cfg: Optional[dict]) -> None:
    """The heads compute the centerness BCE themselves, in the JAX form;
    any other `loss_centerness` raises."""
    if cfg is not None and dict(cfg) != CENTERNESS:
        raise NotImplementedError(
            f"loss_centerness {cfg} is not ported (the head computes "
            f"{CENTERNESS})")


def centerness_bce(logits: torch.Tensor, targets: torch.Tensor,
                   pos: torch.Tensor, num_pos: torch.Tensor) -> torch.Tensor:
    """The JAX heads' sigmoid BCE on the positives, over num_pos."""
    return (binary_cross_entropy_with_logits(logits, targets)
            * pos).sum() / num_pos


def center_points(featmap_sizes: Sequence[Tuple[int, int]],
                  strides: Sequence[int]) -> List[np.ndarray]:
    """Per level the (H*W, 2) float32 cell centres (x, y), row-major,
    x = ix * s + s // 2."""
    out = []
    for (h, w), s in zip(featmap_sizes, strides):
        xs = (np.arange(w) * s + s // 2).astype(np.float32)
        ys = (np.arange(h) * s + s // 2).astype(np.float32)
        xx, yy = np.meshgrid(xs, ys)
        out.append(np.stack([xx.ravel(), yy.ravel()], -1))
    return out


def flat_points(cache: Dict[tuple, Tuple[torch.Tensor, ...]],
                featmap_sizes: Sequence[Tuple[int, int]],
                strides: Sequence[int], device: torch.device,
                ranges: Optional[Sequence[Tuple[float, float]]] = None
                ) -> Tuple[torch.Tensor, ...]:
    """Every level's cell centres (N, 2) and strides (N,), and with
    `ranges` each level's range (N, 2), concatenated, float32 on `device`;
    kept in `cache` by sizes and device."""
    key = (tuple(featmap_sizes), str(device))
    if key not in cache:
        pts = center_points(featmap_sizes, strides)
        tables = [pts, [np.full(len(p), s, np.float32)
                        for p, s in zip(pts, strides)]]
        if ranges is not None:
            tables.append([np.tile(np.asarray(r, np.float32), (len(p), 1))
                           for p, r in zip(pts, ranges)])
        cache[key] = tuple(torch.from_numpy(np.concatenate(t)).to(device)
                           for t in tables)
    return cache[key]


def flat_levels(outs: Sequence[torch.Tensor], b: int,
                last: Optional[int]) -> List[torch.Tensor]:
    """NCHW level outputs -> (B, H*W, last) views ((B, H*W) without
    `last`), in the (H, W) order of the points."""
    shape = (b, -1) if last is None else (b, -1, last)
    return [o.permute(0, 2, 3, 1).reshape(shape) for o in outs]


class FCOSHead(nn.Module):

    def __init__(self, num_classes: int, in_channels: int,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 strides: Sequence[int] = (4, 8, 16, 32, 64),
                 regress_ranges: Sequence[Tuple[float, float]] = (
                     (-1, 64), (64, 128), (128, 256), (256, 512),
                     (512, INF)),
                 norm_cfg: Optional[dict] = None,
                 loss_cls: Optional[dict] = None,
                 loss_bbox: Optional[dict] = None,
                 loss_centerness: Optional[dict] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None):
        super().__init__()
        self.num_classes = num_classes
        self.strides = list(strides)
        self.regress_ranges = [tuple(map(float, r)) for r in regress_ranges]
        self.loss_cls_cfg = dict(loss_cls or FOCAL)
        self.loss_bbox_cfg = dict(loss_bbox or dict(type="IoULoss",
                                                    loss_weight=1.0))
        check_centerness_loss(loss_centerness)
        self.train_cfg = dict(train_cfg or {})
        self.test_cfg = dict(test_cfg or {})
        self.cls_convs, self.reg_convs = gn_branches(
            in_channels, feat_channels, stacked_convs, norm_cfg)
        self.conv_cls = nn.Conv2d(feat_channels, num_classes, 3, padding=1)
        self.conv_reg = nn.Conv2d(feat_channels, 4, 3, padding=1)
        self.conv_centerness = nn.Conv2d(feat_channels, 1, 3, padding=1)
        self.scales = nn.ModuleList(Scale() for _ in self.strides)
        self._points: Dict[tuple, Tuple[torch.Tensor, ...]] = {}

    def init_weights(self, generator: torch.Generator) -> None:
        """As the JAX head's: the stacked convs flax's default
        (`lecun_normal_`), the output convs normal(0.01) with the 0.01
        prior on `conv_cls`'s bias, the scales 1."""
        for m in list(self.cls_convs) + list(self.reg_convs):
            lecun_normal_(m.conv, generator)
        normal_init(self.conv_cls, 0.01, generator,
                    bias=bias_init_with_prob(0.01))
        normal_init(self.conv_reg, 0.01, generator)
        normal_init(self.conv_centerness, 0.01, generator)
        for s in self.scales:
            nn.init.ones_(s.scale)

    def forward(self, feats: Sequence[torch.Tensor]):
        """Per-level NCHW features -> per-level (cls_outs, reg_outs (the
        exp'd distances), ctr_outs)."""
        cls_outs, reg_outs, ctr_outs = [], [], []
        for feat, scale in zip(feats, self.scales):
            cf, rf = feat, feat
            for conv in self.cls_convs:
                cf = conv(cf)
            for conv in self.reg_convs:
                rf = conv(rf)
            cls_outs.append(self.conv_cls(cf))
            ctr_outs.append(self.conv_centerness(cf))
            reg_outs.append(torch.exp(scale(self.conv_reg(rf))))
        return cls_outs, reg_outs, ctr_outs

    # ------------------------------------------------------------ points
    def flat_points(self, featmap_sizes: Sequence[Tuple[int, int]],
                    device: torch.device) -> Tuple[torch.Tensor, ...]:
        """Every level's points (N, 2), their stride (N,) and regress range
        (N, 2), concatenated, float32 on `device`."""
        return flat_points(self._points, featmap_sizes, self.strides, device,
                           self.regress_ranges)

    # ----------------------------------------------------------- targets
    def get_targets(self, points: torch.Tensor, ranges: torch.Tensor,
                    batch: Dict[str, torch.Tensor]):
        """labels (B, N) (num_classes where not positive), ltrb targets
        (B, N, 4) and the positives (B, N) bool, for every image at once:
        gts (B, G, 4) with gt_labels and gt_valid."""
        gt = batch["gt_bboxes"]
        areas = (gt[..., 2] - gt[..., 0]) * (gt[..., 3] - gt[..., 1])
        px = points[None, :, None, 0]
        py = points[None, :, None, 1]
        ltrb = torch.stack([px - gt[:, None, :, 0], py - gt[:, None, :, 1],
                            gt[:, None, :, 2] - px, gt[:, None, :, 3] - py],
                           -1)                                 # (B, N, G, 4)
        inside = ltrb.amin(-1) > 0
        max_reg = ltrb.amax(-1)
        in_range = ((max_reg >= ranges[None, :, None, 0])
                    & (max_reg <= ranges[None, :, None, 1]))
        cand = inside & in_range & batch["gt_valid"][:, None, :]
        area_mat = torch.where(cand, areas[:, None, :], INF)
        pos = area_mat.amin(-1) < INF
        gt_idx = area_mat.argmin(-1)        # the first minimum, as JAX's
        labels = torch.where(pos, batch["gt_labels"].long().gather(1, gt_idx),
                             self.num_classes)
        tgt = ltrb.gather(2, gt_idx[..., None, None].expand(
            -1, -1, 1, 4))[:, :, 0]
        return labels, tgt, pos

    @staticmethod
    def centerness_target(ltrb: torch.Tensor) -> torch.Tensor:
        lr = ltrb[..., [0, 2]]
        tb = ltrb[..., [1, 3]]
        c = ((lr.amin(-1) / lr.amax(-1).clamp(min=1e-12))
             * (tb.amin(-1) / tb.amax(-1).clamp(min=1e-12)))
        return c.clamp(min=0).sqrt()

    # -------------------------------------------------------------- loss
    def loss(self, cls_outs, reg_outs, ctr_outs,
             batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        """The head's losses on a batch (gt_bboxes (B, G, 4), gt_labels,
        gt_valid); nothing is sampled, so `generator` is unused."""
        del generator
        b = cls_outs[0].shape[0]
        points, _, ranges = self.flat_points(
            [tuple(c.shape[-2:]) for c in cls_outs], cls_outs[0].device)
        cls_cat = torch.cat(flat_levels(cls_outs, b, self.num_classes), 1)
        reg_cat = torch.cat(flat_levels(reg_outs, b, 4), 1)
        ctr_cat = torch.cat(flat_levels(ctr_outs, b, None), 1)
        labels, bbox_targets, pos = self.get_targets(points, ranges, batch)
        pos_f = pos.to(cls_cat.dtype)
        num_pos = pos_f.sum().clamp(min=1.0)
        loss_cls = build_loss(self.loss_cls_cfg)(
            cls_cat.reshape(-1, self.num_classes), labels.reshape(-1),
            avg_factor=num_pos)
        ctr_targets = self.centerness_target(bbox_targets)
        pts_b = points[None].expand(b, -1, -1)
        ctr_w = ctr_targets * pos_f
        loss_bbox = build_loss(self.loss_bbox_cfg)(
            distance2bbox(pts_b, reg_cat).reshape(-1, 4),
            distance2bbox(pts_b, bbox_targets).reshape(-1, 4),
            weight=ctr_w.reshape(-1), avg_factor=ctr_w.sum().clamp(min=1e-6))
        return {"loss_cls": loss_cls, "loss_bbox": loss_bbox,
                "loss_centerness": centerness_bce(ctr_cat, ctr_targets,
                                                  pos_f, num_pos),
                "num_pos": num_pos}

    # --------------------------------------------------------- inference
    def get_bboxes(self, cls_outs, reg_outs, ctr_outs,
                   img_shapes: torch.Tensor,
                   scale_factors: Optional[torch.Tensor] = None
                   ) -> DetResult:
        nms_pre = int(self.test_cfg.get("nms_pre", 1000))
        b = cls_outs[0].shape[0]
        dev = cls_outs[0].device
        sizes = [tuple(c.shape[-2:]) for c in cls_outs]
        points, _, _ = self.flat_points(sizes, dev)
        level_points = points.split([h * w for h, w in sizes])
        boxes, scores, factors = [], [], []
        for pts, sc, reg, ctr in zip(
                level_points, flat_levels(cls_outs, b, self.num_classes),
                flat_levels(reg_outs, b, 4), flat_levels(ctr_outs, b, None)):
            sc, ctr = sc.sigmoid(), ctr.sigmoid()
            idx = top_indices(sc.amax(-1) * ctr, nms_pre)
            dist = reg.gather(1, idx[..., None].expand(-1, -1, 4))
            boxes.append(clip_to_image(distance2bbox(pts[idx], dist),
                                       img_shapes))
            scores.append(sc.gather(
                1, idx[..., None].expand(-1, -1, self.num_classes)))
            factors.append(ctr.gather(1, idx))
        return nms_of_config(self.test_cfg, torch.cat(boxes, 1),
                             with_background(scores), torch.cat(factors, 1),
                             scale_factors)
