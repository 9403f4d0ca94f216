"""P2BNet's point-to-box MIL head, and SSD-Det's noisy-box variant.

Counterpart of pointtinybenchmark_tpu/models/dense_heads/p2b_head.py
(`cbp_proposals`, `pbr_proposals`, `merge_boxes`, P2BNetHead, SSDDetHead),
batched with gts padded to (B, G) and a validity mask, in the JAX
operation order:

- stage 0 scores a bag of P proposals per gt: anchor-like boxes centred on
  the annotated point (CBP, `cbp_proposals`) or, for SSD-Det
  (`bag_source` "box"), a scale x offset jitter of the noisy annotated box
  (`pbr_proposals`); each later stage (PBR, `pbr_stages` of them) scores
  a jitter grid around the previous stage's merged box;
- a stage's network is RoIAlign (S = `roi_size`, `sampling_ratio`, one
  FPN level per roi by `finest_scale`: models/roi_heads/roi_extractor.py)
  of every (image, gt, proposal) roi, two shared Linear + ReLU layers and
  two classifiers, `cls` (num_classes + 1 with `with_bg`) and `ins`
  (num_classes); the selection score of a proposal is the softmax class
  probability of the gt's class (background column dropped) times the
  instance softmax over the bag;
- the merged box is the selection-weighted mean of the top-k proposals
  (`merge_boxes`: lax.top_k's order, a stable descending sort);
- the negative pass scores a scale x offset grid around the last stage's
  merged boxes with the last stage's modules; the loss counts a candidate
  as negative where its IoU with every valid pseudo box of its image
  stays below `neg_iou_thr`.

The gradient runs through the boxes: a later stage's rois are built from
the previous merge, so its loss reaches the earlier stage's parameters
through RoIAlign's roi-coordinate gradient and the merge weights, as in
the JAX package. Outside training (`mode` other than "train") the
negative pass, which only the loss reads, is not run; the JAX head runs
it and discards it. A stage's modules are `stages[s].shared_fcs`,
`.cls` and `.ins` (the JAX scope names stage{s}_shared_fc{i}, stage{s}_cls,
stage{s}_ins; utils/jax_weights.py maps them). The RoI features are
(R, C, S, S) and flatten in (c, h, w) order; the JAX head's flatten as
(h, w, c), which the weight loader bridges by permuting the rows of each
stage's first FC.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ...ops.iou import bbox_overlaps
from ..losses import MILLoss
from ..roi_heads.roi_extractor import single_roi_extract
from ..utils import lecun_normal_, one_hot

__all__ = ["P2BNetHead", "SSDDetHead", "cbp_proposals", "pbr_proposals",
           "merge_boxes"]


def cbp_proposals(points: torch.Tensor, scales: Sequence[float],
                  ratios: Sequence[float]) -> torch.Tensor:
    """points (..., 2) -> (..., P, 4) xyxy boxes centred on each point,
    P = len(scales) * len(ratios), w = s sqrt(r), h = s / sqrt(r)."""
    s = np.asarray(scales, np.float32)
    r = np.asarray(ratios, np.float32)
    w = (s[:, None] * np.sqrt(r)[None, :]).reshape(-1)
    h = (s[:, None] / np.sqrt(r)[None, :]).reshape(-1)
    half = torch.from_numpy(np.stack([-w, -h, w, h], -1) / 2).to(points)
    return torch.cat([points, points], -1)[..., None, :] + half


def pbr_proposals(boxes: torch.Tensor, scale_jitter: Sequence[float],
                  offset_frac: Sequence[float]) -> torch.Tensor:
    """boxes (..., 4) -> (..., P, 4), P = len(scale_jitter) *
    len(offset_frac)^2: each box rescaled about its centre by a scale and
    shifted by (ox w, oy h), scale-major."""
    sj = np.asarray(scale_jitter, np.float32)
    of = np.asarray(offset_frac, np.float32)
    ctr = (boxes[..., :2] + boxes[..., 2:]) / 2
    wh = boxes[..., 2:] - boxes[..., :2]
    oxy = np.stack(np.meshgrid(of, of, indexing="ij"), -1).reshape(-1, 2)
    sc = torch.from_numpy(np.repeat(sj, len(oxy))[:, None]).to(boxes)
    off = torch.from_numpy(np.tile(oxy, (len(sj), 1))).to(boxes)
    new_wh = wh[..., None, :] * sc
    new_ctr = ctr[..., None, :] + wh[..., None, :] * off
    return torch.cat([new_ctr - new_wh / 2, new_ctr + new_wh / 2], -1)


def merge_boxes(boxes: torch.Tensor, scores: torch.Tensor,
                topk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """boxes (..., P, 4), scores (..., P) -> the score-weighted mean of the
    top-k boxes (..., 4) and the top score (...,). Ties keep the lower
    index first, as lax.top_k; the gradient reaches the chosen scores and
    boxes."""
    k = min(topk, boxes.shape[-2])
    idx = torch.sort(scores, dim=-1, descending=True, stable=True)[1][..., :k]
    top_s = scores.gather(-1, idx)
    top_b = boxes.gather(-2, idx[..., None].expand(*idx.shape, 4))
    w = top_s / top_s.sum(-1, keepdim=True).clamp(min=1e-12)
    return (top_b * w[..., None]).sum(-2), top_s[..., 0]


class _Stage(nn.Module):
    """One MIL stage's modules: two shared FCs, `cls` and `ins`."""

    def __init__(self, in_features: int, fc_channels: int, n_cls: int,
                 num_classes: int):
        super().__init__()
        self.shared_fcs = nn.ModuleList([nn.Linear(in_features, fc_channels),
                                         nn.Linear(fc_channels, fc_channels)])
        self.cls = nn.Linear(fc_channels, n_cls)
        self.ins = nn.Linear(fc_channels, num_classes)


class P2BNetHead(nn.Module):

    needs_gt_in_forward = True
    default_bag_source = "point"
    default_neg_scale_jitter = (1.0, 3.0)

    def __init__(self, num_classes: int, in_channels: int = 256,
                 fc_channels: int = 1024, roi_size: int = 7,
                 sampling_ratio: int = 2,
                 featmap_strides: Sequence[int] = (4, 8, 16, 32),
                 finest_scale: float = 56.0,
                 cbp_scales: Sequence[float] = (8, 16, 32, 64, 128),
                 cbp_ratios: Sequence[float] = (1.0 / 3, 0.5, 1.0, 2.0, 3.0),
                 pbr_scale_jitter: Sequence[float] = (0.8, 1.0, 1.2),
                 pbr_offset_frac: Sequence[float] = (-0.2, 0.0, 0.2),
                 pbr_stages: int = 1, merge_topk: int = 4,
                 neg_iou_thr: float = 0.3,
                 neg_scale_jitter: Optional[Sequence[float]] = None,
                 neg_offset: Sequence[float] = (-1.2, -0.6, 0.0, 0.6, 1.2),
                 with_bg: bool = True, bag_source: Optional[str] = None,
                 box_bag_scale_jitter: Sequence[float] = (0.5, 0.7, 1.0, 1.4,
                                                          2.0),
                 box_bag_offset_frac: Sequence[float] = (-0.3, 0.0, 0.3),
                 loss_mil: Optional[dict] = None,
                 neg_loss_weight: float = 0.75,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None):
        super().__init__()
        self.bag_source = bag_source or self.default_bag_source
        if self.bag_source not in ("point", "box"):
            raise ValueError(f"bag_source {self.bag_source!r}: 'point' or "
                             f"'box'")
        mil = dict(loss_mil or dict(type="MILLoss", binary_ins=False,
                                    loss_weight=0.25))
        if mil.pop("type", "MILLoss") != "MILLoss":
            raise NotImplementedError(f"loss_mil {loss_mil} (MILLoss is "
                                      f"ported)")
        self.mil = MILLoss(**mil)
        self.num_classes = num_classes
        self.roi_size = roi_size
        self.sampling_ratio = sampling_ratio
        self.featmap_strides = tuple(featmap_strides)
        self.finest_scale = finest_scale
        self.cbp_scales, self.cbp_ratios = tuple(cbp_scales), tuple(cbp_ratios)
        self.pbr_scale_jitter = tuple(pbr_scale_jitter)
        self.pbr_offset_frac = tuple(pbr_offset_frac)
        self.pbr_stages = pbr_stages
        self.merge_topk = merge_topk
        self.neg_iou_thr = neg_iou_thr
        self.neg_scale_jitter = tuple(neg_scale_jitter if neg_scale_jitter
                                      is not None
                                      else self.default_neg_scale_jitter)
        self.neg_offset = tuple(neg_offset)
        self.with_bg = with_bg
        self.box_bag_scale_jitter = tuple(box_bag_scale_jitter)
        self.box_bag_offset_frac = tuple(box_bag_offset_frac)
        self.neg_loss_weight = neg_loss_weight
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        n_cls = num_classes + (1 if with_bg else 0)
        self.stages = nn.ModuleList(
            _Stage(in_channels * roi_size * roi_size, fc_channels, n_cls,
                   num_classes) for _ in range(1 + pbr_stages))

    def init_weights(self, generator: torch.Generator) -> None:
        """Every linear flax Dense's default (`lecun_normal_`), as the JAX
        head's."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                lecun_normal_(m, generator)

    # ----------------------------------------------------------- network
    def _mil_scores(self, stage: _Stage, feats: Sequence[torch.Tensor],
                    rois: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """rois (R, 5) -> cls and ins logits (R, C[+1]) and (R, C)."""
        x = single_roi_extract(feats, rois, self.featmap_strides,
                               self.roi_size, self.sampling_ratio,
                               self.finest_scale).flatten(1)
        for fc in stage.shared_fcs:
            x = torch.relu(fc(x))
        return stage.cls(x), stage.ins(x)

    def _cls_prob(self, cls_logits: torch.Tensor) -> torch.Tensor:
        """Softmax over the classes (and background, then dropped)."""
        return torch.softmax(cls_logits, dim=-1)[..., :self.num_classes]

    @staticmethod
    def _rois(boxes: torch.Tensor) -> torch.Tensor:
        """(B, G, P, 4) -> (B G P, 5) rois with the image index first."""
        b, g, p, _ = boxes.shape
        bidx = torch.arange(b, dtype=boxes.dtype, device=boxes.device)
        return torch.cat([bidx[:, None, None, None].expand(b, g, p, 1),
                          boxes], -1).reshape(b * g * p, 5)

    def _bag_pass(self, stage: _Stage, feats, boxes: torch.Tensor,
                  labels: torch.Tensor):
        """Score a (B, G, P, 4) bag: cls (B, G, P, C[+1]), ins (B, G, P, C)
        and the gt class's selection score (B, G, P)."""
        b, g, p, _ = boxes.shape
        cls, ins = self._mil_scores(stage, feats, self._rois(boxes))
        cls = cls.reshape(b, g, p, -1)
        ins = ins.reshape(b, g, p, -1)
        onehot = one_hot(labels, self.num_classes)
        sel = (self._cls_prob(cls) * torch.softmax(ins, dim=2)
               * onehot[:, :, None, :]).sum(-1)
        return cls, ins, sel

    def forward(self, feats: Sequence[torch.Tensor], batch: Dict[str, Any],
                mode: str = "train") -> Dict[str, Any]:
        """feats: the FPN levels, NCHW. batch: gt_points (B, G, R, 2) (the
        locator's gt box centres), gt_bboxes (B, G, 4), gt_labels,
        gt_valid (B, G). Returns per stage boxes, cls, ins, sel, merged and
        score, the pseudo boxes and scores and, in "train" mode, the
        negative boxes and their cls logits (B, G, P_neg, C[+1])."""
        labels = batch["gt_labels"]
        if self.bag_source == "box":
            boxes = pbr_proposals(batch["gt_bboxes"],
                                  self.box_bag_scale_jitter,
                                  self.box_bag_offset_frac)
        else:
            boxes = cbp_proposals(batch["gt_points"][:, :, 0, :],
                                  self.cbp_scales, self.cbp_ratios)
        stages = []
        for si, stage in enumerate(self.stages):
            cls, ins, sel = self._bag_pass(stage, feats, boxes, labels)
            merged, top_score = merge_boxes(boxes, sel, self.merge_topk)
            stages.append(dict(boxes=boxes, cls=cls, ins=ins, sel=sel,
                               merged=merged, score=top_score))
            if si < self.pbr_stages:
                boxes = pbr_proposals(merged, self.pbr_scale_jitter,
                                      self.pbr_offset_frac)
        final = stages[-1]["merged"]
        outputs = dict(stages=stages, pseudo_boxes=final,
                       pseudo_scores=stages[-1]["score"])
        if mode == "train":
            neg = pbr_proposals(final, self.neg_scale_jitter, self.neg_offset)
            neg_cls, _ = self._mil_scores(self.stages[-1], feats,
                                          self._rois(neg))
            outputs["neg_boxes"] = neg
            outputs["neg_cls"] = neg_cls.reshape(*neg.shape[:3], -1)
        return outputs

    # ------------------------------------------------------------ losses
    def loss(self, outputs: Dict[str, Any], batch: Dict[str, Any],
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        """The MIL loss of each stage (`loss_cbp`, then `loss_pbr` or
        `loss_pbr{i}`, with `bag_acc_cbp` / `bag_acc{i}`) and `loss_neg`,
        the generalized focal loss pushing the negatives' class
        probabilities to 0, over the number of valid gts. Nothing is
        drawn: `generator` is unused."""
        del generator
        labels = batch["gt_labels"]
        valid = batch["gt_valid"]
        b, g = labels.shape
        n_stages = len(outputs["stages"])
        losses: Dict[str, torch.Tensor] = {}
        for si, st in enumerate(outputs["stages"]):
            p = st["cls"].shape[2]
            cls_prob = self._cls_prob(st["cls"]).reshape(b * g, p, -1)
            ins = st["ins"].reshape(b * g, p, -1)
            val = valid.reshape(b * g, 1, 1).to(torch.float32).expand(
                b * g, p, 1)
            li, acc, _ = self.mil(cls_prob, ins, labels.reshape(-1), val)
            name = "loss_cbp" if si == 0 else (
                "loss_pbr" if n_stages == 2 else f"loss_pbr{si - 1}")
            losses[name] = li
            losses["bag_acc_cbp" if si == 0 else f"bag_acc{si}"] = acc

        neg = outputs["neg_boxes"]                           # (B, G, P, 4)
        bn, gn, pn, _ = neg.shape
        ious = bbox_overlaps(neg.reshape(bn, gn * pn, 4),
                             outputs["pseudo_boxes"])
        ious = torch.where(valid[:, None, :], ious, 0.0)
        is_neg = (ious.amax(-1) < self.neg_iou_thr).reshape(bn, gn, pn)
        neg_w = (is_neg & valid[:, :, None]).to(torch.float32)
        neg_prob = self._cls_prob(outputs["neg_cls"])
        neg_loss = self.mil.gfocal_loss(
            neg_prob.reshape(-1, self.num_classes),
            neg_prob.new_zeros((bn * gn * pn, self.num_classes)),
            neg_w.reshape(-1, 1))
        num_pos = valid.sum().to(torch.float32).clamp(min=1.0)
        losses["loss_neg"] = self.neg_loss_weight * neg_loss.sum() / num_pos
        return losses


class SSDDetHead(P2BNetHead):
    """SSD-Det: the stage-0 bag is a scale x offset jitter of the noisy
    annotated box, and the negative grid adds an under-scale (0.4)."""

    default_bag_source = "box"
    default_neg_scale_jitter = (0.4, 1.0, 2.5)
