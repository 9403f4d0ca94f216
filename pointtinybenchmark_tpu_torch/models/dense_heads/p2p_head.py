"""P2PHead: the P2PNet-style point predictor (the fork's P2PHead).

Counterpart of pointtinybenchmark_tpu/models/dense_heads/p2p_head.py::
P2PHead: `stacked_convs` 3x3 convs (GN in the configs) on a cls and a reg
branch, then `cls_out` (K * classes) and `reg_out` (K * 2) convs, K point
anchors per cell. A prediction is anchor + offset * pts_gamma * stride.
Training matches predictions to gt points with HungarianAssignerV2 (focal
and distance costs, the top-k auction; invalid predictions cost 1e8), then
a focal classification loss over every valid prediction and a SmoothL1 on
stride-normalised points over the positives, both averaged by the number
of positives. Inference: per level the top `nms_pre` cells by score (a
stable descending sort: lax.top_k's tie order), clamped into the image,
16x16 pseudo boxes round each point, then one batched `multiclass_nms`
over the batch (the NMS kernel pair), and (cx, cy, score) rows of the kept
boxes.

Forward outputs are NCHW; the flat (B, H*W*K, C) view follows the JAX
head's (H, W, K) order.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ...core.anchors import PointGenerator
from ...core.assigners import HungarianAssignerV2, topk_auction_match
from ...core.post_processing import DetResult, multiclass_nms
from ..losses import build_loss
from ..utils import ConvModule, bias_init_with_prob, normal_init

__all__ = ["P2PHead"]


class P2PHead(nn.Module):

    def __init__(self, num_classes: int, in_channels: int,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 strides: Sequence[int] = (4,),
                 point_anchor: Sequence[Tuple[float, float]] = ((0.0, 0.0),),
                 assign_before_pred: bool = False, pts_gamma: float = 1.0,
                 reg_norm: float = 1.0, norm_cfg: Optional[dict] = None,
                 loss_cls: Optional[dict] = None,
                 loss_reg: Optional[dict] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None):
        super().__init__()
        self.num_classes = num_classes
        self.in_channels = in_channels
        self.feat_channels = feat_channels
        self.stacked_convs = stacked_convs
        self.strides = list(strides)
        self.point_anchor = [tuple(p) for p in point_anchor]
        if assign_before_pred:
            raise NotImplementedError("assign_before_pred is not ported")
        self.pts_gamma = pts_gamma
        self.reg_norm = reg_norm
        self.loss_cls_cfg = dict(loss_cls or dict(type="CrossEntropyLoss",
                                                  use_sigmoid=True))
        if not self.loss_cls_cfg.get("use_sigmoid", False):
            raise NotImplementedError("only sigmoid classification is ported")
        self.loss_reg_cfg = dict(loss_reg or dict(type="SmoothL1Loss"))
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        norm = (norm_cfg or {}).get("type")
        groups = (norm_cfg or {}).get("num_groups", 32)
        chans = [in_channels] + [feat_channels] * stacked_convs
        self.cls_convs = nn.ModuleList(
            ConvModule(chans[i], chans[i + 1], 3, norm=norm, num_groups=groups)
            for i in range(stacked_convs))
        self.reg_convs = nn.ModuleList(
            ConvModule(chans[i], chans[i + 1], 3, norm=norm, num_groups=groups)
            for i in range(stacked_convs))
        self.cls_out = nn.Conv2d(chans[-1], num_classes * self.num_points, 3,
                                 padding=1)
        self.reg_out = nn.Conv2d(chans[-1], self.num_points * 2, 3, padding=1)

    @property
    def num_points(self) -> int:
        return len(self.point_anchor)

    def init_weights(self, generator: torch.Generator) -> None:
        """Conv kernels normal(0.01), biases 0, cls_out's bias the 0.01
        prior, GN's scale 1 and bias 0 (the JAX head's convs keep flax's
        default init; the seeded draw here is the port's own)."""
        for m in list(self.cls_convs) + list(self.reg_convs):
            normal_init(m.conv, 0.01, generator)
        normal_init(self.cls_out, 0.01, generator,
                    bias=bias_init_with_prob(0.01))
        normal_init(self.reg_out, 0.01, generator)

    def forward(self, feats: Sequence[torch.Tensor]):
        """Per-level NCHW features -> per-level (cls_outs, pts_outs)."""
        cls_outs, pts_outs = [], []
        for feat in feats:
            cf, rf = feat, feat
            for conv in self.cls_convs:
                cf = conv(cf)
            for conv in self.reg_convs:
                rf = conv(rf)
            cls_outs.append(self.cls_out(cf))
            pts_outs.append(self.reg_out(rf))
        return cls_outs, pts_outs

    # ----------------------------------------------------------- decoding
    def get_points(self, featmap_sizes: Sequence[Tuple[int, int]],
                   pad_shape: Tuple[int, int]):
        """Anchor points of all levels, K per cell: (N, 3) float32 rows of
        (x, y, stride) and (N,) validity, numpy."""
        gen = PointGenerator()
        pts_list, valid_list = [], []
        for (h, w), stride in zip(featmap_sizes, self.strides):
            base = gen.grid_points((h, w), stride)
            offs = np.asarray(self.point_anchor, np.float32) * stride
            pts = np.repeat(base[:, None, :], self.num_points, axis=1)
            pts[..., :2] += offs[None, :, :]
            pts_list.append(pts.reshape(-1, 3))
            vh = min(int(np.ceil(pad_shape[0] / stride)), h)
            vw = min(int(np.ceil(pad_shape[1] / stride)), w)
            valid_list.append(np.repeat(gen.valid_flags((h, w), (vh, vw)),
                                        self.num_points))
        return (np.concatenate(pts_list).astype(np.float32),
                np.concatenate(valid_list))

    def decode_points(self, cls_outs: List[torch.Tensor],
                      pts_outs: List[torch.Tensor],
                      pad_shape: Tuple[int, int]):
        """Returns anchor_pts (N, 3), pred_pts (B, N, 3), valid (N,) and
        cls_scores (B, N, classes), tensors on the outputs' device."""
        b = cls_outs[0].shape[0]
        dev = cls_outs[0].device
        sizes = [tuple(c.shape[-2:]) for c in cls_outs]
        anchor_np, valid_np = self.get_points(sizes, pad_shape)
        anchor_pts = torch.from_numpy(anchor_np).to(dev)
        valid = torch.from_numpy(valid_np).to(dev)
        cls_cat = torch.cat([c.permute(0, 2, 3, 1).reshape(
            b, -1, self.num_classes) for c in cls_outs], 1)
        pts_cat = torch.cat([p.permute(0, 2, 3, 1).reshape(b, -1, 2)
                             for p in pts_outs], 1)
        stride = anchor_pts[None, :, 2:3]
        pred_xy = anchor_pts[None, :, :2] + pts_cat * self.pts_gamma * stride
        pred_pts = torch.cat([pred_xy, stride.expand(b, -1, 1)], -1)
        return anchor_pts, pred_pts, valid, cls_cat

    # ----------------------------------------------------------- training
    def build_assigner(self) -> HungarianAssignerV2:
        cfg = dict(self.train_cfg["assigner"])
        cfg.pop("type", None)
        return HungarianAssignerV2(**cfg)

    def loss(self, cls_outs, pts_outs, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        """batch: gt_bboxes (B, G, 4), gt_labels (B, G), gt_valid (B, G),
        img_shape (B, 2) [h, w], pad_shape (static). `generator` is unused
        (the matching draws nothing)."""
        anchor_pts, pred_pts, valid, cls_cat = self.decode_points(
            cls_outs, pts_outs, batch["pad_shape"])
        b, n = pred_pts.shape[:2]
        gt_bboxes = batch["gt_bboxes"]
        gt_points = (gt_bboxes[..., :2] + gt_bboxes[..., 2:]) / 2
        gt_labels = batch["gt_labels"]
        gt_valid = batch["gt_valid"]
        assigner = self.build_assigner()
        with torch.no_grad():
            cost = assigner.cost_matrix(pred_pts[..., :2], cls_cat,
                                        gt_points, gt_labels,
                                        batch["img_shape"], gt_valid)
            # invalid (outside) predictions can never match
            cost = torch.where(valid[None, :, None], cost, 1e8)
            assigned = topk_auction_match(cost, gt_valid, assigner.topk_k)

        pos = assigned > 0
        safe = (assigned.long() - 1).clamp(0, gt_points.shape[1] - 1)
        labels = torch.where(pos, gt_labels.long().gather(1, safe),
                             self.num_classes)
        target_pts = gt_points.gather(1, safe[..., None].expand(-1, -1, 2))
        pos_weight = float(self.train_cfg.get("pos_weight", 1.0))
        neg_weight = float(self.train_cfg.get("neg_weight", 1.0))
        label_weights = torch.where(pos, pos_weight, neg_weight)
        label_weights = torch.where(valid[None, :], label_weights, 0.0)
        pts_weights = (pos & valid[None, :]).to(torch.float32)
        num_total_pos = pts_weights.sum().clamp(min=1.0)
        cls_avg = (float(b * n)
                   if self.loss_cls_cfg["type"] == "CrossEntropyLoss"
                   else num_total_pos)
        loss_cls = build_loss(self.loss_cls_cfg)(
            cls_cat.reshape(b * n, -1), labels.reshape(-1),
            weight=label_weights.reshape(-1), avg_factor=cls_avg)
        norm = pred_pts[..., 2:3] * self.reg_norm
        loss_pts = build_loss(self.loss_reg_cfg)(
            pred_pts[..., :2] / norm, target_pts / norm,
            weight=pts_weights[..., None], avg_factor=num_total_pos)
        return {"loss_cls": loss_cls, "loss_pts": loss_pts,
                "num_pos": num_total_pos}

    # ---------------------------------------------------------- inference
    def get_bboxes(self, cls_outs, pts_outs, img_shapes: torch.Tensor,
                   pad_shape: Tuple[int, int],
                   scale_factors: Optional[torch.Tensor] = None,
                   rescale: bool = False
                   ) -> Tuple[DetResult, torch.Tensor]:
        """Batched inference. img_shapes (B, 2) [h, w]. Returns the NMS's
        pseudo-box detections and (B, max_per_img, 3) rows of (cx, cy,
        score), zero where not valid."""
        cfg = self.test_cfg
        nms_pre = int(cfg.get("nms_pre", 1000))
        pseudo_wh = tuple(cfg.get("pseudo_wh", (16, 16)))
        score_thr = float(cfg.get("score_thr", 0.05))
        iou_thr = float(cfg["nms"]["iou_threshold"])
        max_per_img = int(cfg.get("max_per_img", 100))
        level_sizes = [c.shape[2] * c.shape[3] * self.num_points
                       for c in cls_outs]
        _, pred_pts, valid, cls_cat = self.decode_points(cls_outs, pts_outs,
                                                         pad_shape)
        scores_all = torch.sigmoid(cls_cat)
        b = scores_all.shape[0]
        img_h = img_shapes[:, 0].to(torch.float32)[:, None]
        img_w = img_shapes[:, 1].to(torch.float32)[:, None]
        zero = torch.zeros((), dtype=torch.float32, device=cls_cat.device)
        pts_list, sc_list = [], []
        start = 0
        for ls in level_sizes:
            s = scores_all[:, start:start + ls]
            p = pred_pts[:, start:start + ls, :2]
            max_s = torch.where(valid[start:start + ls][None], s.amax(2),
                                -1.0)
            k = min(nms_pre, ls) if nms_pre > 0 else ls
            # lax.top_k's order: a stable descending sort
            idx = torch.sort(max_s, dim=1, descending=True,
                             stable=True)[1][:, :k]
            s = s.gather(1, idx[..., None].expand(-1, -1, s.shape[2]))
            p = p.gather(1, idx[..., None].expand(-1, -1, 2))
            x = torch.minimum(torch.maximum(p[..., 0], zero), img_w)
            y = torch.minimum(torch.maximum(p[..., 1], zero), img_h)
            pts_list.append(torch.stack([x, y], -1))
            sc_list.append(s)
            start += ls
        points = torch.cat(pts_list, 1)
        scores = torch.cat(sc_list, 1)
        if rescale and scale_factors is not None:
            points = points / scale_factors[:, None, :2]
        scores = torch.cat([scores, scores.new_zeros(scores.shape[:2] + (1,))],
                           -1)
        wh = torch.tensor(pseudo_wh, dtype=points.dtype, device=points.device)
        pseudo = torch.cat([points - wh / 2, points + wh / 2], -1)
        det = multiclass_nms(pseudo, scores, score_thr, iou_thr, max_per_img)
        cxy = (det.bboxes[..., :2] + det.bboxes[..., 2:4]) / 2
        pts_out = torch.cat([cxy, det.bboxes[..., 4:5]], -1)
        return det, pts_out
