"""AnchorHead: anchor-based dense head, inference path.

Counterpart of pointtinybenchmark_tpu/models/dense_heads/anchor_head.py
(`__call__` and `get_bboxes`). The JAX head runs one image under vmap; this
one works on the whole batch of images or tiles at once, with no per-image
loop: per level sigmoid, a top-`nms_pre` by the best class score, delta
decode and clip, then one batched `multiclass_nms`.

Forward outputs are NCHW. Before the flat (B, H*W*A, C) view they are
permuted to NHWC, so the flat order is (H, W, A) as in the JAX head and the
anchor grids.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ...core.anchors import AnchorGenerator
from ...core.bbox import delta_decoder
from ...core.post_processing import DetResult, multiclass_nms
from ..utils import bias_init_with_prob, normal_init

__all__ = ["AnchorHead"]

DEFAULT_ANCHORS = dict(scales=[8], ratios=[0.5, 1.0, 2.0],
                       strides=[4, 8, 16, 32, 64])


class AnchorHead(nn.Module):

    def __init__(self, num_classes: int, in_channels: int,
                 feat_channels: int = 256,
                 anchor_generator: Optional[dict] = None,
                 bbox_coder: Optional[dict] = None,
                 loss_cls: Optional[dict] = None,
                 test_cfg: Optional[dict] = None):
        super().__init__()
        lc = loss_cls or dict(use_sigmoid=True)
        if not lc.get("use_sigmoid", False):
            raise NotImplementedError("only sigmoid classification is ported")
        self.num_classes = num_classes
        self.cls_out_channels = num_classes
        self.in_channels = in_channels
        self.feat_channels = feat_channels
        gen_cfg = dict(anchor_generator or DEFAULT_ANCHORS)
        gen_type = gen_cfg.pop("type", "AnchorGenerator")
        if gen_type != "AnchorGenerator":
            raise NotImplementedError(f"{gen_type} is not ported")
        self.anchor_generator = AnchorGenerator(**gen_cfg)
        self.num_base_anchors = self.anchor_generator.num_base_anchors[0]
        coder = dict(bbox_coder or {})
        self.decode = delta_decoder(coder)
        self.means = tuple(coder.get("target_means", (0., 0., 0., 0.)))
        self.stds = tuple(coder.get("target_stds", (1., 1., 1., 1.)))
        self.test_cfg = dict(test_cfg or {})
        self._anchor_cache: Dict[tuple, List[torch.Tensor]] = {}
        self._init_layers()

    def _init_layers(self) -> None:
        a = self.num_base_anchors
        self.conv_cls = nn.Conv2d(self.in_channels,
                                  a * self.cls_out_channels, 1)
        self.conv_reg = nn.Conv2d(self.in_channels, a * 4, 1)

    def init_weights(self, generator: torch.Generator) -> None:
        normal_init(self.conv_cls, 0.01, generator,
                    bias=bias_init_with_prob(0.01))
        normal_init(self.conv_reg, 0.01, generator)

    def forward(self, feats: Sequence[torch.Tensor]):
        return ([self.conv_cls(f) for f in feats],
                [self.conv_reg(f) for f in feats])

    def level_anchors(self, featmap_sizes: Sequence[Tuple[int, int]],
                      device: torch.device) -> List[torch.Tensor]:
        key = (tuple(featmap_sizes), str(device))
        if key not in self._anchor_cache:
            grids = self.anchor_generator.grid_anchors(featmap_sizes)
            self._anchor_cache[key] = [
                torch.from_numpy(np.ascontiguousarray(g, np.float32)).to(device)
                for g in grids]
        return self._anchor_cache[key]

    def candidates(self, cls_outs, bbox_outs, img_shapes: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Everything before NMS: (B, K, 4) boxes clipped to `img_shapes`
        (B, 2) (h, w), and (B, K, C+1) scores with a zero background column.
        K is the sum over levels of min(nms_pre, H*W*A)."""
        nms_pre = int(self.test_cfg.get("nms_pre", 1000))
        b = cls_outs[0].shape[0]
        dev = cls_outs[0].device
        anchors = self.level_anchors([tuple(c.shape[-2:]) for c in cls_outs],
                                     dev)
        h = img_shapes[:, 0:1].to(torch.float32)
        w = img_shapes[:, 1:2].to(torch.float32)
        all_boxes, all_scores = [], []
        for cls_o, box_o, anc in zip(cls_outs, bbox_outs, anchors):
            sc = cls_o.permute(0, 2, 3, 1).reshape(b, -1, self.cls_out_channels)
            sc = sc.sigmoid()
            deltas = box_o.permute(0, 2, 3, 1).reshape(b, -1, 4)
            n = sc.shape[1]
            k = min(nms_pre, n) if nms_pre > 0 else n
            # stable sort, sliced: the order of lax.top_k, ties to the lower
            # index (torch.topk on CUDA fixes no order among ties)
            _, idx = torch.sort(sc.amax(-1), dim=1, descending=True,
                                stable=True)
            idx = idx[:, :k]
            idx4 = idx[..., None].expand(-1, -1, 4)
            boxes = self.decode(anc[idx], deltas.gather(1, idx4),
                                self.means, self.stds)
            x1, y1, x2, y2 = boxes.unbind(-1)
            zero = boxes.new_zeros(())
            boxes = torch.stack([
                torch.minimum(torch.maximum(x1, zero), w),
                torch.minimum(torch.maximum(y1, zero), h),
                torch.minimum(torch.maximum(x2, zero), w),
                torch.minimum(torch.maximum(y2, zero), h)], dim=-1)
            all_boxes.append(boxes)
            all_scores.append(sc.gather(
                1, idx[..., None].expand(-1, -1, self.cls_out_channels)))
        boxes = torch.cat(all_boxes, dim=1)
        scores = torch.cat(all_scores, dim=1)
        scores = torch.cat([scores, scores.new_zeros(scores.shape[:2] + (1,))],
                           dim=-1)
        return boxes, scores

    def get_bboxes(self, cls_outs, bbox_outs,
                   img_shapes: torch.Tensor) -> DetResult:
        boxes, scores = self.candidates(cls_outs, bbox_outs, img_shapes)
        cfg = self.test_cfg
        return multiclass_nms(
            boxes, scores, float(cfg.get("score_thr", 0.05)),
            float(cfg.get("nms", {}).get("iou_threshold", 0.5)),
            int(cfg.get("max_per_img", 100)))
