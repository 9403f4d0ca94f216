"""StandardRoIHead, the second stage of Faster R-CNN and Mask R-CNN:
inference and the Faster R-CNN training loss.

Counterpart of pointtinybenchmark_tpu/models/roi_heads/standard_roi_head.py
(`_extractor_cfg`, `_mask_extractor_cfg`, `simple_test`, `forward_train`,
`_bbox_loss`, `_build_assigner`). Inference: the proposals of every tile go
through one RoIAlign call (`single_roi_extract`: the CUDA kernel on the
card) and one pass of the bbox head; then a softmax over num_classes + 1,
the class-wise delta decode with the head's coder, a clip to each tile,
with `rescale` a division by each image's scale factor, and one
`multiclass_nms` batched over tiles, in which the proposals' validity mask
keeps the empty proposal slots out. With a mask head, every slot of the
detections (the empty ones are zero boxes), back in the network's frame,
goes through the mask extractor (one more RoIAlign call) and the mask head;
each slot keeps the sigmoid of its label's channel. The heads come built
(`models/builder.py` builds them from the config's dicts).

Training (`forward_train`), batched over images with static shapes: the gt
boxes are prepended to the proposals, MaxIoU assigns them (0.5, no
low-quality matches), positives and negatives are drawn by random
priorities within the sampler's budgets (positives up to num *
pos_fraction, negatives up to num minus the positives taken, as JAX's
inline sampler has it), and a fixed-size top-k gathers `num` rois per image
(sampled positives first, then sampled negatives, then the rest with zero
weight); their RoIAlign features (the kernel's forward, and its backward in
the gradient) go through the bbox head into softmax cross-entropy and L1 on
the label's deltas, both averaged over the sampled rois. Proposals carry no
gradient. The mask loss is not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ...core.assigners import MaxIoUAssigner
from ...core.bbox import delta_coder_fns
from ...core.post_processing import DetResult, multiclass_nms
from ...core.samplers import topk_mask
from ..losses import build_loss
from .bbox_head import Shared2FCBBoxHead
from .mask_head import FCNMaskHead
from .roi_extractor import single_roi_extract

__all__ = ["StandardRoIHead"]


def _extractor_cfg(cfg: Optional[dict], output_size: int) -> dict:
    """single_roi_extract's arguments from an extractor's config; mmcv's
    adaptive sampling_ratio=0 becomes a static 2, as in JAX."""
    cfg = dict(cfg or {})
    if cfg.get("type", "SingleRoIExtractor") != "SingleRoIExtractor":
        raise NotImplementedError(f"{cfg['type']} is not ported")
    roi_layer = dict(cfg.get("roi_layer", {}))
    return dict(
        featmap_strides=tuple(cfg.get("featmap_strides", (4, 8, 16, 32))),
        output_size=int(roi_layer.get("output_size", output_size)),
        sampling_ratio=int(roi_layer.get("sampling_ratio", 0)) or 2,
        finest_scale=float(cfg.get("finest_scale", 56)),
        aligned=bool(roi_layer.get("aligned", True)))


class StandardRoIHead(nn.Module):

    def __init__(self, bbox_head: Shared2FCBBoxHead,
                 bbox_roi_extractor: Optional[dict] = None,
                 mask_roi_extractor: Optional[dict] = None,
                 mask_head: Optional[FCNMaskHead] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None):
        super().__init__()
        self.bbox_extractor = _extractor_cfg(bbox_roi_extractor, 7)
        # without its own extractor the mask branch shares the bbox one's
        # (mmdet share_roi_extractor), with its own default output size
        self.mask_extractor = _extractor_cfg(
            mask_roi_extractor or bbox_roi_extractor, 14)
        self.bbox_head = bbox_head
        self.mask_head = mask_head
        coder = self.bbox_head.bbox_coder
        self.encode, self.decode = delta_coder_fns(coder)
        self.means = tuple(coder.get("target_means", (0., 0., 0., 0.)))
        self.stds = tuple(coder.get("target_stds", (0.1, 0.1, 0.2, 0.2)))
        self.train_cfg = dict(train_cfg or {})
        self.test_cfg = dict(test_cfg or {})

    @property
    def num_classes(self) -> int:
        return self.bbox_head.num_classes

    def init_weights(self, generator: torch.Generator) -> None:
        self.bbox_head.init_weights(generator)
        if self.mask_head is not None:
            self.mask_head.init_weights(generator)

    @staticmethod
    def _extract(feats: Sequence[torch.Tensor], boxes: torch.Tensor,
                 cfg: dict) -> torch.Tensor:
        """boxes (B, P, 4) -> RoI features (B * P, C, S, S), image-major."""
        b, p = boxes.shape[:2]
        batch_idx = torch.arange(b, dtype=boxes.dtype,
                                 device=boxes.device).repeat_interleave(p)
        rois = torch.cat([batch_idx[:, None], boxes.reshape(b * p, 4)], 1)
        return single_roi_extract(feats[:len(cfg["featmap_strides"])], rois,
                                  **cfg)

    def forward(self, feats: Sequence[torch.Tensor], proposals: torch.Tensor):
        """feats: per-level (B, C, H, W); proposals (B, P, 4) -> bbox head
        outputs for all B * P rois, image-major."""
        return self.bbox_head(self._extract(feats, proposals,
                                            self.bbox_extractor))

    def mask_forward(self, feats: Sequence[torch.Tensor],
                     boxes: torch.Tensor) -> torch.Tensor:
        """feats: per-level (B, C, H, W); boxes (B, M, 4) in the network's
        frame -> mask logits (B * M, num_classes, 2S, 2S), image-major."""
        return self.mask_head(self._extract(feats, boxes,
                                            self.mask_extractor))

    def simple_test(self, feats: Sequence[torch.Tensor],
                    proposals: torch.Tensor, prop_valid: torch.Tensor,
                    img_shapes: torch.Tensor,
                    scale_factors: Optional[torch.Tensor] = None,
                    rescale: bool = False
                    ) -> Union[DetResult, Tuple[DetResult, torch.Tensor]]:
        """The detections of each image, (B, max_per_img) slots; with
        `rescale` their boxes are divided by `scale_factors` (B, 4). With a
        mask head, also the mask probabilities of every slot,
        (B, max_per_img, 2S, 2S)."""
        cfg = self.test_cfg
        nc = self.num_classes
        b, p = proposals.shape[:2]
        cls_score, bbox_pred = self(feats, proposals)
        scores = torch.softmax(cls_score, -1).reshape(b, p, nc + 1)
        if bbox_pred.shape[-1] == 4:
            deltas = bbox_pred.reshape(b, p, 1, 4).expand(b, p, nc, 4)
        else:
            deltas = bbox_pred.reshape(b, p, nc, 4)
        boxes = self.decode(proposals[:, :, None, :], deltas, self.means,
                            self.stds)                           # (B, P, C, 4)
        h = img_shapes[:, 0].to(boxes.dtype)[:, None, None]
        w = img_shapes[:, 1].to(boxes.dtype)[:, None, None]
        zero = boxes.new_zeros(())
        x1, y1, x2, y2 = boxes.unbind(-1)
        boxes = torch.stack([
            torch.minimum(torch.maximum(x1, zero), w),
            torch.minimum(torch.maximum(y1, zero), h),
            torch.minimum(torch.maximum(x2, zero), w),
            torch.minimum(torch.maximum(y2, zero), h)], dim=-1)
        rescale = rescale and scale_factors is not None
        if rescale:
            boxes = boxes / scale_factors[:, None, None, :]
        dets = multiclass_nms(
            boxes.reshape(b, p, nc * 4), scores,
            float(cfg.get("score_thr", 0.05)),
            float(cfg.get("nms", {}).get("iou_threshold", 0.5)),
            int(cfg.get("max_per_img", 100)), valid_mask=prop_valid)
        if self.mask_head is None:
            return dets
        det_boxes = dets.bboxes[..., :4]
        if rescale:
            det_boxes = det_boxes * scale_factors[:, None, :]
        logits = self.mask_forward(feats, det_boxes)
        m = det_boxes.shape[1]
        label = dets.labels.reshape(-1).clamp(0, nc - 1).long()
        masks = torch.sigmoid(logits[torch.arange(b * m, device=label.device),
                                     label])
        return dets, masks.reshape(b, m, *masks.shape[1:])

    # ---------------------------------------------------------------- train
    def _build_assigner(self) -> MaxIoUAssigner:
        cfg = dict(self.train_cfg.get("assigner", dict(
            type="MaxIoUAssigner", pos_iou_thr=0.5, neg_iou_thr=0.5,
            min_pos_iou=0.5, match_low_quality=False, ignore_iof_thr=-1)))
        cfg.pop("type", None)
        return MaxIoUAssigner(**cfg)

    def forward_train(self, feats: Sequence[torch.Tensor],
                      proposals: torch.Tensor, prop_valid: torch.Tensor,
                      batch: Dict[str, torch.Tensor],
                      generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """feats: per-level (B, C, H, W); proposals (B, P, 4) with validity
        (B, P); batch: gt_bboxes (B, G, 4), gt_labels, gt_valid. Returns
        loss_cls, loss_bbox, acc and num_pos."""
        if self.mask_head is not None and "gt_masks" in batch:
            raise NotImplementedError("the mask loss is not ported yet")
        scfg = dict(self.train_cfg.get("sampler", dict(
            type="RandomSampler", num=512, pos_fraction=0.25, neg_pos_ub=-1,
            add_gt_as_proposals=True)))
        num_sample = int(scfg.get("num", 512))
        pos_budget = int(num_sample * float(scfg.get("pos_fraction", 0.25)))
        gt_bboxes = batch["gt_bboxes"]
        gt_labels = batch["gt_labels"].long()
        gt_valid = batch["gt_valid"]
        if bool(scfg.get("add_gt_as_proposals", True)):
            proposals = torch.cat([gt_bboxes, proposals], 1)
            prop_valid = torch.cat([gt_valid, prop_valid], 1)
        proposals = proposals.detach()
        p = proposals.shape[1]
        assigned, _, _ = self._build_assigner().assign(
            proposals, gt_bboxes, gt_valid, gt_labels, bbox_valid=prop_valid)
        pos_sel, neg_sel = self._sample(assigned, num_sample, pos_budget,
                                        generator)
        sampled = pos_sel | neg_sel
        # the fixed-size gather: sampled positives, sampled negatives, rest
        key = (pos_sel.float() * 2.0 + neg_sel.float()
               + torch.rand(assigned.shape, generator=generator,
                            device=assigned.device) * 0.1)
        idx = torch.sort(key, dim=1, descending=True,
                         stable=True)[1][:, :min(num_sample, p)]
        sel_boxes = proposals.gather(1, idx[..., None].expand(-1, -1, 4))
        sel_pos = pos_sel.gather(1, idx)
        safe = (assigned.gather(1, idx) - 1).clamp(0, gt_bboxes.shape[1] - 1)
        tgt = gt_bboxes.gather(1, safe[..., None].expand(-1, -1, 4))
        deltas = self.encode(sel_boxes, tgt, self.means, self.stds)
        labels = torch.where(sel_pos, gt_labels.gather(1, safe),
                             self.num_classes)
        cls_score, bbox_pred = self(feats, sel_boxes)
        return self._bbox_loss(cls_score, bbox_pred, labels, deltas,
                               sel_pos.float(), sampled.gather(1, idx).float())

    @staticmethod
    def _sample(assigned: torch.Tensor, num_sample: int, pos_budget: int,
                generator: torch.Generator
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, P) assignments -> the sampled positives and negatives, by
        random priorities (JAX's inline sampler, standard_roi_head.py:
        150-158): the positives whose priority reaches the pos_budget-th
        largest, then negatives up to num_sample minus the positives taken
        (at most pos_budget of them)."""
        pos_cand = assigned > 0
        neg_cand = assigned == 0
        dev = assigned.device
        pr_pos = torch.where(pos_cand, torch.rand(assigned.shape,
                                                  generator=generator,
                                                  device=dev), -1.0)
        k = min(pos_budget, assigned.shape[1])
        pos_th = torch.sort(pr_pos, dim=1, descending=True)[0][:, k - 1]
        pos_sel = pos_cand & (pr_pos >= pos_th.clamp(min=0.0)[:, None])
        neg_budget = num_sample - pos_sel.sum(1).clamp(max=pos_budget)
        pr_neg = torch.where(neg_cand, torch.rand(assigned.shape,
                                                  generator=generator,
                                                  device=dev), -1.0)
        return pos_sel, neg_cand & topk_mask(pr_neg, neg_budget)

    def _bbox_loss(self, cls_score: torch.Tensor, bbox_pred: torch.Tensor,
                   roi_labels: torch.Tensor, roi_deltas: torch.Tensor,
                   pos_w: torch.Tensor,
                   samp_w: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Classification and regression losses of the gathered rois, both
        over max(sampled, 1); acc is the sampled rois' top-1 accuracy (%),
        num_pos the positives."""
        nc = self.num_classes
        labels = roi_labels.reshape(-1)
        samp = samp_w.reshape(-1)
        pos = pos_w.reshape(-1)
        num_sampled = samp.sum().clamp(min=1.0)
        loss_cls = build_loss(self.bbox_head.loss_cls)(
            cls_score, labels, weight=samp, avg_factor=num_sampled)
        if bbox_pred.shape[-1] == 4:
            pred = bbox_pred
        else:
            safe = labels.clamp(0, nc - 1)
            pred = bbox_pred.reshape(-1, nc, 4).gather(
                1, safe[:, None, None].expand(-1, 1, 4))[:, 0]
        loss_bbox = build_loss(self.bbox_head.loss_bbox)(
            pred, roi_deltas.reshape(-1, 4), weight=pos[:, None],
            avg_factor=num_sampled)
        acc = (cls_score.argmax(-1) == labels).float()
        acc = (acc * samp).sum() / num_sampled * 100
        return {"loss_cls": loss_cls, "loss_bbox": loss_bbox, "acc": acc,
                "num_pos": pos.sum()}
