"""FreeAnchorRetinaHead: RetinaNet with learned anchor matching (mmdet
free_anchor_retina_head.py, arXiv 1909.02466).

Counterpart of pointtinybenchmark_tpu/models/dense_heads/
free_anchor_retina_head.py::FreeAnchorRetinaHead: RetinaHead's network and
inference (AnchorHead.get_bboxes); only the loss is new. It runs batched
over images as (B, G, N) tensors, gts by anchors:

- the matched probability P{a in A+} of each anchor and class: the IoU of
  each gt with the detached decoded predictions, mapped to [0, 1] between
  `bbox_thr` and the gt's best IoU, and scattered along the classes by
  the gt's label with a max (when several gts share a label the largest
  wins; a padded gt has label 0 and probability 0, so it changes
  nothing);
- each gt's bag: its top `pre_anchor_topk` anchors by anchor IoU, in
  lax.top_k's order (a stable descending sort, ties to the lower index:
  the anchors of one shape that contain a tiny gt all have the same IoU
  with it, anchors of IoU 0 fill a bag larger than the anchors its gt
  overlaps, and torch.topk on a card fixes no order among ties);
- a bag's probabilities: the classifier's at the gt's label times
  exp(-smooth L1) of the bag's deltas to the gt, summed over the four
  coordinates; the positive loss -alpha log of their mean-max over the
  valid gts' count, the negative loss a focal term on P_cls (1 - P{a in
  A+}) over that count times the bag size.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ...ops.iou import bbox_overlaps
from ..losses import build_loss
from .retina_head import RetinaHead

__all__ = ["FreeAnchorRetinaHead"]

EPS = 1e-12
BAG_SMOOTH_L1 = dict(type="SmoothL1Loss", beta=0.11, loss_weight=0.75)


class FreeAnchorRetinaHead(RetinaHead):

    def __init__(self, num_classes: int, in_channels: int,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 pre_anchor_topk: int = 50, bbox_thr: float = 0.6,
                 gamma: float = 2.0, alpha: float = 0.5,
                 norm_cfg: Optional[dict] = None,
                 anchor_generator: Optional[dict] = None,
                 bbox_coder: Optional[dict] = None,
                 loss_cls: Optional[dict] = None,
                 loss_bbox: Optional[dict] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None):
        self.pre_anchor_topk = pre_anchor_topk
        self.bbox_thr = bbox_thr
        self.gamma = gamma
        self.alpha = alpha
        super().__init__(num_classes, in_channels, feat_channels,
                         stacked_convs, norm_cfg, anchor_generator,
                         bbox_coder, loss_cls, loss_bbox or BAG_SMOOTH_L1,
                         train_cfg, test_cfg)

    def matched_prob(self, anchors: torch.Tensor, box_cat: torch.Tensor,
                     batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """P{a in A+} (B, N, C) from the detached predictions."""
        gt, valid = batch["gt_bboxes"], batch["gt_valid"]
        with torch.no_grad():
            pred = self.decode(anchors[None], box_cat, self.means, self.stds)
            obj_iou = torch.where(valid[..., None],
                                  bbox_overlaps(gt, pred), 0.0)  # (B, G, N)
            t1 = self.bbox_thr
            t2 = obj_iou.amax(-1, keepdim=True).clamp(min=t1 + EPS)
            obp = ((obj_iou - t1) / (t2 - t1)).clamp(0.0, 1.0)
            obp = torch.where(valid[..., None], obp, 0.0)
            b, n = box_cat.shape[:2]
            labels = batch["gt_labels"].long()[..., None].expand_as(obp)
            return obp.new_zeros(b, self.cls_out_channels, n).scatter_reduce(
                1, labels, obp, "amax").transpose(1, 2)

    def bags(self, anchors: torch.Tensor,
             gt_bboxes: torch.Tensor) -> torch.Tensor:
        """(B, G, K) indices of each gt's top-K anchors by IoU, K =
        min(pre_anchor_topk, N), in lax.top_k's order."""
        k = min(self.pre_anchor_topk, anchors.shape[0])
        iou = bbox_overlaps(gt_bboxes, anchors)                 # (B, G, N)
        return torch.sort(iou, dim=-1, descending=True,
                          stable=True)[1][..., :k]

    def loss(self, cls_outs, bbox_outs, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        """The head's losses on a batch (gt_bboxes (B, G, 4), gt_labels,
        gt_valid, pad_shape); nothing is sampled, so `generator` is
        unused."""
        del generator
        anchors, _ = self.flat_anchors([tuple(c.shape[-2:]) for c in cls_outs],
                                       batch["pad_shape"], cls_outs[0].device)
        cls_cat, box_cat = self._flatten_preds(cls_outs, bbox_outs)
        gt, valid = batch["gt_bboxes"], batch["gt_valid"]
        cls_prob = cls_cat.sigmoid()
        box_prob = self.matched_prob(anchors, box_cat, batch)

        matched = self.bags(anchors, gt)                        # (B, G, K)
        k = matched.shape[-1]
        rows = torch.arange(gt.shape[0], device=gt.device)[:, None, None]
        m_cls = cls_prob[rows, matched,
                         batch["gt_labels"].long()[..., None]]  # (B, G, K)
        m_anchors = anchors[matched]                            # (B, G, K, 4)
        m_targets = self.encode(m_anchors, gt[:, :, None].expand_as(m_anchors),
                                self.means, self.stds)
        lb = build_loss(dict(self.loss_bbox_cfg, reduction="none"))(
            box_cat[rows, matched], m_targets).sum(-1)
        m_prob = m_cls * torch.exp(-lb)
        # positive bag loss: -alpha log(mean-max(P))
        w = 1.0 / (1.0 - m_prob).clamp(min=EPS)
        w = w / w.sum(-1, keepdim=True)
        bag_prob = (w * m_prob).sum(-1).clamp(EPS, 1.0)
        pos_loss = torch.where(valid, -self.alpha * torch.log(bag_prob), 0.0)
        num_pos = valid.sum().to(cls_prob.dtype)
        positive_loss = pos_loss.sum() / num_pos.clamp(min=1.0)
        # negative: FL(P_cls (1 - P{a in A+}))
        prob = (cls_prob * (1 - box_prob)).clamp(EPS, 1 - EPS)
        neg = (1 - self.alpha) * prob ** self.gamma * (-torch.log(1 - prob))
        negative_loss = neg.sum() / (num_pos * k).clamp(min=1.0)
        return {"loss_positive_bag": positive_loss,
                "loss_negative_bag": negative_loss,
                "num_pos": num_pos.clamp(min=1.0)}
