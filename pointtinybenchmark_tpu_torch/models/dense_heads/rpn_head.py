"""RPNHead: region proposal network head, inference path.

Counterpart of pointtinybenchmark_tpu/models/dense_heads/rpn_head.py
(`__call__`, `get_proposals`) with mmdet's module names (`rpn_conv`,
`rpn_cls`, `rpn_reg`). The JAX head proposes for one image under vmap; this
one works on the whole batch of tiles: per level a sigmoid, a stable-sorted
top-`nms_pre` (ties to the lower index, as lax.top_k), delta decode with the
RPN's own coder and a clip to the image; a box not wider and taller than
`min_bbox_size` gets score -1. Then one batched NMS with the level as the
class, so levels never suppress each other. The first `max_per_img` kept
boxes are the proposals; slots left empty hold the tile's first candidate
box with score 0 and are marked not valid, as in the JAX head.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.nms import batched_nms
from ..utils import normal_init
from .anchor_head import AnchorHead

__all__ = ["RPNHead"]


class RPNHead(AnchorHead):

    def _init_layers(self) -> None:
        a = self.num_base_anchors
        self.rpn_conv = nn.Conv2d(self.in_channels, self.feat_channels, 3,
                                  padding=1)
        self.rpn_cls = nn.Conv2d(self.feat_channels,
                                 a * self.cls_out_channels, 1)
        self.rpn_reg = nn.Conv2d(self.feat_channels, a * 4, 1)

    def init_weights(self, generator: torch.Generator) -> None:
        for m in (self.rpn_conv, self.rpn_cls, self.rpn_reg):
            normal_init(m, 0.01, generator)

    def forward(self, feats: Sequence[torch.Tensor]):
        cls_outs, reg_outs = [], []
        for f in feats:
            x = F.relu(self.rpn_conv(f))
            cls_outs.append(self.rpn_cls(x))
            reg_outs.append(self.rpn_reg(x))
        return cls_outs, reg_outs

    def get_proposals(self, cls_outs, reg_outs, img_shapes: torch.Tensor,
                      proposal_cfg: dict
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Returns proposals (B, P, 4), scores (B, P) and valid (B, P),
        P = max_per_img. img_shapes (B, 2) is (h, w) of each image."""
        nms_pre = int(proposal_cfg.get("nms_pre", 1000))
        max_per_img = int(proposal_cfg.get("max_per_img", 1000))
        iou_thr = float(proposal_cfg.get("nms", {}).get("iou_threshold", 0.7))
        min_size = float(proposal_cfg.get("min_bbox_size", 0))
        b = cls_outs[0].shape[0]
        dev = cls_outs[0].device
        anchors = self.level_anchors([tuple(c.shape[-2:]) for c in cls_outs],
                                     dev)
        h = img_shapes[:, 0:1].to(torch.float32)
        w = img_shapes[:, 1:2].to(torch.float32)
        zero = h.new_zeros(())
        all_boxes, all_scores, all_ids = [], [], []
        for lvl, (cls_o, reg_o, anc) in enumerate(zip(cls_outs, reg_outs,
                                                      anchors)):
            # (B, H*W*A), flat order (H, W, A) as the anchor grid
            sc = cls_o.permute(0, 2, 3, 1).reshape(
                b, -1, self.cls_out_channels)[..., 0].sigmoid()
            deltas = reg_o.permute(0, 2, 3, 1).reshape(b, -1, 4)
            n = sc.shape[1]
            k = min(nms_pre, n) if nms_pre > 0 else n
            top_sc, idx = torch.sort(sc, dim=1, descending=True, stable=True)
            top_sc, idx = top_sc[:, :k], idx[:, :k]
            boxes = self.decode(anc[idx], deltas.gather(
                1, idx[..., None].expand(-1, -1, 4)), self.means, self.stds)
            x1, y1, x2, y2 = boxes.unbind(-1)
            boxes = torch.stack([
                torch.minimum(torch.maximum(x1, zero), w),
                torch.minimum(torch.maximum(y1, zero), h),
                torch.minimum(torch.maximum(x2, zero), w),
                torch.minimum(torch.maximum(y2, zero), h)], dim=-1)
            bw = boxes[..., 2] - boxes[..., 0]
            bh = boxes[..., 3] - boxes[..., 1]
            ok = (bw > min_size) & (bh > min_size)
            all_boxes.append(boxes)
            all_scores.append(torch.where(ok, top_sc, -1.0))
            all_ids.append(torch.full((b, k), lvl, dtype=torch.int32,
                                      device=dev))
        boxes = torch.cat(all_boxes, dim=1)
        scores = torch.cat(all_scores, dim=1)
        ids = torch.cat(all_ids, dim=1)
        keep, _ = batched_nms(boxes, scores, ids, iou_thr, max_per_img,
                              valid_mask=scores > -1.0)
        valid = keep >= 0
        safe = torch.where(valid, keep, 0).long()
        proposals = boxes.gather(1, safe[..., None].expand(-1, -1, 4))
        return (proposals, torch.where(valid, scores.gather(1, safe), 0.0),
                valid)
