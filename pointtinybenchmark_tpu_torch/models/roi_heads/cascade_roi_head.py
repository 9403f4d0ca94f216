"""CascadeRoIHead: Cascade R-CNN's multi-stage box refinement (mmdet
models/roi_heads/cascade_roi_head.py).

Counterpart of pointtinybenchmark_tpu/models/roi_heads/cascade_roi_head.py::
CascadeRoIHead (`_refine`, `forward_train`, `_stage_forward_train`,
`simple_test`). Each stage has its own `Shared2FCBBoxHead` (`bbox_head.{i}`,
each with its coder's stds) and its own MaxIoU thresholds and sampler
(`train_cfg[i]`); the stages share one RoI extractor (RoIAlign: the CUDA
kernels on the card). The StandardRoIHead's pieces do the work: its
extraction, its sampler's fixed-size gather and its box loss.

Training: stage i samples its rois from its proposals (with the gts
prepended where its sampler's `add_gt_as_proposals`, which defaults to
i == 0 as in JAX), its losses come back as `loss_s{i}_cls` and
`loss_s{i}_bbox`, weighted by `stage_loss_weights[i]`, with `s{i}_num_pos`;
the next stage's proposals are every sampled roi decoded by stage i's
coder with the deltas of the roi's argmax class, clipped to the image and
without gradient (JAX `_refine`, kept as written there: mmdet refines with
the gt labels of the positives and drops the gt rois).

Test: every stage runs on the boxes the stage before refined (argmax
class), the softmax scores of the stages are averaged, and the last
stage's deltas are decoded on its input boxes with stage 0's coder (as
JAX does; mmdet decodes with the last stage's), clipped, and go through
one `multiclass_nms`. The JAX head has no mask branch, so neither has
this one: `build_detector` refuses a `mask_head` key. HTC's and SCNet's
heads (htc_roi_head.py, scnet_roi_head.py) build on its stage sampling,
losses, refinement and test loop.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn

from ...core.bbox import delta_coder_fns
from ...core.post_processing import DetResult
from .bbox_head import Shared2FCBBoxHead
from .standard_roi_head import StandardRoIHead, _extractor_cfg

__all__ = ["CascadeRoIHead"]


class CascadeRoIHead(nn.Module):

    def __init__(self, bbox_head: Sequence[Shared2FCBBoxHead],
                 num_stages: int = 3,
                 stage_loss_weights: Sequence[float] = (1.0, 0.5, 0.25),
                 bbox_roi_extractor: Optional[dict] = None,
                 train_cfg=None, test_cfg: Optional[dict] = None):
        super().__init__()
        if len(bbox_head) != num_stages:
            raise ValueError(f"{len(bbox_head)} bbox heads for "
                             f"{num_stages} stages")
        self.num_stages = num_stages
        self.stage_loss_weights = [float(w) for w in stage_loss_weights]
        self.bbox_extractor = _extractor_cfg(bbox_roi_extractor, 7)
        self.bbox_head = nn.ModuleList(bbox_head)
        self.coders = [delta_coder_fns(h.bbox_coder) for h in bbox_head]
        self.means = [tuple(h.bbox_coder.get("target_means", (0.,) * 4))
                      for h in bbox_head]
        self.stds = [tuple(h.bbox_coder.get("target_stds",
                                            (0.1, 0.1, 0.2, 0.2)))
                     for h in bbox_head]
        self.stage_cfgs = [dict(train_cfg[i] if isinstance(
            train_cfg, (list, tuple)) else train_cfg or {})
            for i in range(num_stages)]
        self.test_cfg = dict(test_cfg or {})

    @property
    def num_classes(self) -> int:
        return self.bbox_head[0].num_classes

    @property
    def roi_feat_size(self) -> int:
        return self.bbox_head[0].roi_feat_size

    def init_weights(self, generator: torch.Generator) -> None:
        for head in self.bbox_head:
            head.init_weights(generator)

    def stage_forward(self, i: int, feats: Sequence[torch.Tensor],
                      boxes: torch.Tensor):
        """Stage i's bbox head on the RoI features of boxes (B, P, 4):
        cls logits (B * P, C + 1) and deltas, image-major."""
        return self.bbox_head[i](StandardRoIHead._extract(
            feats, boxes, self.bbox_extractor))

    def _refine(self, i: int, boxes: torch.Tensor, cls_score: torch.Tensor,
                bbox_pred: torch.Tensor,
                img_shapes: torch.Tensor) -> torch.Tensor:
        """Stage i's outputs on boxes (B, P, 4) -> the next stage's
        proposals: the deltas of each roi's argmax foreground class
        decoded by stage i's coder, clipped to the image, no gradient."""
        nc = self.num_classes
        b, p = boxes.shape[:2]
        if bbox_pred.shape[-1] == 4:
            deltas = bbox_pred.reshape(b, p, 4)
        else:
            best = cls_score.reshape(b, p, nc + 1)[..., :nc].argmax(-1)
            deltas = bbox_pred.reshape(b, p, nc, 4).gather(
                2, best[..., None, None].expand(b, p, 1, 4))[:, :, 0]
        out = self.coders[i][1](boxes, deltas, self.means[i], self.stds[i])
        h = img_shapes[:, 0:1].to(out.dtype)
        w = img_shapes[:, 1:2].to(out.dtype)
        zero = out.new_zeros(())
        x1, y1, x2, y2 = out.unbind(-1)
        return torch.stack([
            torch.minimum(torch.maximum(x1, zero), w),
            torch.minimum(torch.maximum(y1, zero), h),
            torch.minimum(torch.maximum(x2, zero), w),
            torch.minimum(torch.maximum(y2, zero), h)], dim=-1).detach()

    # ---------------------------------------------------------------- train
    def forward_train(self, feats: Sequence[torch.Tensor],
                      proposals: torch.Tensor, prop_valid: torch.Tensor,
                      batch: Dict[str, torch.Tensor],
                      generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """feats: per-level (B, C, H, W); proposals (B, P, 4) with validity
        (B, P); batch: gt_bboxes (B, G, 4), gt_labels, gt_valid,
        img_shape (B, 2). Returns loss_s{i}_cls, loss_s{i}_bbox (weighted)
        and s{i}_num_pos of every stage."""
        losses: Dict[str, torch.Tensor] = {}
        for i in range(self.num_stages):
            boxes, labels, deltas, pos, sampled, _ = self._stage_sample(
                i, proposals, prop_valid, batch, generator, i == 0)
            cls_score, bbox_pred = self.stage_forward(i, feats, boxes)
            losses.update(self._stage_losses(i, cls_score, bbox_pred, labels,
                                             deltas, pos, sampled))
            if i < self.num_stages - 1:
                proposals = self._refine(i, boxes, cls_score, bbox_pred,
                                         batch["img_shape"])
                prop_valid = torch.ones(proposals.shape[:2], dtype=torch.bool,
                                        device=proposals.device)
        return losses

    def _stage_sample(self, i: int, proposals: torch.Tensor,
                      prop_valid: torch.Tensor, batch: Dict[str, torch.Tensor],
                      generator: torch.Generator, add_gt_default: bool):
        """Stage i's sampled rois (`StandardRoIHead._sample_rois` under its
        assigner and sampler; the gts prepended where the sampler's
        `add_gt_as_proposals`, else `add_gt_default`)."""
        cfg = self.stage_cfgs[i]
        scfg = dict(cfg.get("sampler", dict(
            num=512, pos_fraction=0.25, add_gt_as_proposals=True)))
        return StandardRoIHead._sample_rois(
            proposals, prop_valid, batch, generator,
            StandardRoIHead._build_assigner(cfg), scfg,
            bool(scfg.get("add_gt_as_proposals", add_gt_default)),
            self.coders[i][0], self.means[i], self.stds[i], self.num_classes)

    def _stage_losses(self, i: int, cls_score: torch.Tensor,
                      bbox_pred: torch.Tensor, labels: torch.Tensor,
                      deltas: torch.Tensor, pos: torch.Tensor,
                      sampled: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = StandardRoIHead._bbox_loss(
            self.bbox_head[i], cls_score, bbox_pred, labels, deltas,
            pos.float(), sampled.float())
        w = self.stage_loss_weights[i]
        return {f"loss_s{i}_cls": out["loss_cls"] * w,
                f"loss_s{i}_bbox": out["loss_bbox"] * w,
                f"s{i}_num_pos": out["num_pos"]}

    # ----------------------------------------------------------------- test
    def simple_test(self, feats: Sequence[torch.Tensor],
                    proposals: torch.Tensor, prop_valid: torch.Tensor,
                    img_shapes: torch.Tensor,
                    scale_factors: Optional[torch.Tensor] = None,
                    rescale: bool = False) -> DetResult:
        """The detections of each image, (B, max_per_img) slots; with
        `rescale` their boxes are divided by `scale_factors` (B, 4)."""
        return self._test_boxes(
            lambda boxes: StandardRoIHead._extract(feats, boxes,
                                                   self.bbox_extractor),
            proposals, prop_valid, img_shapes, scale_factors, rescale)

    def _test_boxes(self, roi_feats: Callable[[torch.Tensor], torch.Tensor],
                    proposals: torch.Tensor, prop_valid: torch.Tensor,
                    img_shapes: torch.Tensor,
                    scale_factors: Optional[torch.Tensor],
                    rescale: bool) -> DetResult:
        """`simple_test` with `roi_feats`, boxes (B, P, 4) -> the bbox
        heads' input (B * P, C, S, S)."""
        nc = self.num_classes
        b, p = proposals.shape[:2]
        scores_sum = 0.0
        boxes = proposals
        for i in range(self.num_stages):
            cls_score, bbox_pred = self.bbox_head[i](roi_feats(boxes))
            scores_sum = scores_sum + torch.softmax(
                cls_score.reshape(b, p, nc + 1), -1)
            if i < self.num_stages - 1:
                boxes = self._refine(i, boxes, cls_score, bbox_pred,
                                     img_shapes)
        return StandardRoIHead._detect(
            self, boxes, bbox_pred, scores_sum / self.num_stages, prop_valid,
            img_shapes, scale_factors, rescale,
            (self.coders[0][1], self.means[0], self.stds[0]))
