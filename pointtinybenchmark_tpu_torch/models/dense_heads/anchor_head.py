"""AnchorHead: anchor-based dense head, inference and training.

Counterpart of pointtinybenchmark_tpu/models/dense_heads/anchor_head.py
(`__call__`, `get_bboxes`, and the training half: `sampling`,
`flat_anchors`, `_flatten_preds`, `get_targets`, `loss`). The JAX head runs
one image under vmap; this one works on the whole batch of images or tiles
at once, with no per-image loop. Inference: per level sigmoid, a
top-`nms_pre` by the best class score (times a score factor where the
head has one, ATSS's centerness), delta decode and clip, then one
batched `multiclass_nms`. Training: MaxIoU assignment of every anchor of
every level (batched over images), delta-encoded targets, the
RandomSampler's budgets for a sampling loss (cross-entropy; not for focal
losses), and each image normalised by max(positives, 1) (+ max(negatives,
1) when sampling), as the reference does.

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
from ...core.assigners import MaxIoUAssigner
from ...core.bbox import delta_coder_fns
from ...core.post_processing import DetResult, multiclass_nms
from ...core.samplers import RandomSampler
from ..losses import build_loss
from ..utils import bias_init_with_prob, normal_init

__all__ = ["AnchorHead", "top_indices", "clip_to_image", "with_background",
           "nms_of_config"]

DEFAULT_ANCHORS = dict(scales=[8], ratios=[0.5, 1.0, 2.0],
                       strides=[4, 8, 16, 32, 64])
# classification losses that keep every anchor (no sampler), as in mmdet
DENSE_LOSSES = ("FocalLoss", "GHMC", "QualityFocalLoss")


def top_indices(rank: torch.Tensor, nms_pre: int) -> torch.Tensor:
    """(B, N) ranking scores -> (B, k) indices of the top k = min(nms_pre,
    N) (all N where nms_pre <= 0): a stable descending sort, sliced, which
    is lax.top_k's order, ties to the lower index (torch.topk on CUDA fixes
    no order among ties)."""
    n = rank.shape[1]
    k = min(nms_pre, n) if nms_pre > 0 else n
    _, idx = torch.sort(rank, dim=1, descending=True, stable=True)
    return idx[:, :k]


def clip_to_image(boxes: torch.Tensor, img_shapes: torch.Tensor
                  ) -> torch.Tensor:
    """(B, K, 4) boxes clipped into each image's [0, w] x [0, h];
    img_shapes (B, 2) (h, w)."""
    h = img_shapes[:, 0:1].to(boxes.dtype)
    w = img_shapes[:, 1:2].to(boxes.dtype)
    x1, y1, x2, y2 = boxes.unbind(-1)
    zero = boxes.new_zeros(())
    return torch.stack([
        torch.minimum(torch.maximum(x1, zero), w),
        torch.minimum(torch.maximum(y1, zero), h),
        torch.minimum(torch.maximum(x2, zero), w),
        torch.minimum(torch.maximum(y2, zero), h)], dim=-1)


def with_background(level_scores) -> torch.Tensor:
    """Per-level (B, k, C) scores -> (B, K, C+1) with the zero background
    column that multiclass_nms drops."""
    scores = torch.cat(level_scores, dim=1)
    return torch.cat([scores, scores.new_zeros(scores.shape[:2] + (1,))],
                     dim=-1)


def nms_of_config(test_cfg: dict, boxes: torch.Tensor, scores: torch.Tensor,
                  factors: Optional[torch.Tensor] = None,
                  scale_factors: Optional[torch.Tensor] = None) -> DetResult:
    """multiclass_nms with a head's test_cfg (score_thr, nms.iou_threshold,
    max_per_img) and optional score factors. With `scale_factors` (B, 4)
    the boxes (B, N, 4) are divided by them before the NMS, into the
    original image's frame, as the JAX heads' `rescale` does."""
    if scale_factors is not None:
        boxes = boxes / scale_factors[:, None, :]
    return multiclass_nms(
        boxes, scores, float(test_cfg.get("score_thr", 0.05)),
        float(test_cfg.get("nms", {}).get("iou_threshold", 0.5)),
        int(test_cfg.get("max_per_img", 100)), score_factors=factors)


class AnchorHead(nn.Module):

    def __init__(self, num_classes: int, in_channels: int,
                 feat_channels: int = 256,
                 anchor_generator: Optional[dict] = None,
                 bbox_coder: Optional[dict] = None,
                 loss_cls: Optional[dict] = None,
                 loss_bbox: Optional[dict] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None):
        super().__init__()
        lc = dict(loss_cls or dict(type="CrossEntropyLoss", use_sigmoid=True))
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
        self.encode, self.decode = delta_coder_fns(coder)
        self.means = tuple(coder.get("target_means", (0., 0., 0., 0.)))
        self.stds = tuple(coder.get("target_stds", (1., 1., 1., 1.)))
        self.loss_cls_cfg = lc
        self.loss_bbox_cfg = dict(loss_bbox or {})
        self.train_cfg = dict(train_cfg or {})
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

    def candidates(self, cls_outs, bbox_outs, img_shapes: torch.Tensor,
                   factor_outs=None):
        """Everything before NMS: (B, K, 4) boxes clipped to `img_shapes`
        (B, 2) (h, w), (B, K, C+1) scores with a zero background column,
        and, with `factor_outs` (per level (B, A, H, W) centerness or
        objectness logits), their sigmoids (B, K), else None. A factor
        multiplies the best class score for the top-`nms_pre` ranking;
        K is the sum over levels of min(nms_pre, H*W*A)."""
        nms_pre = int(self.test_cfg.get("nms_pre", 1000))
        b = cls_outs[0].shape[0]
        dev = cls_outs[0].device
        anchors = self.level_anchors([tuple(c.shape[-2:]) for c in cls_outs],
                                     dev)
        all_boxes, all_scores, all_factors = [], [], []
        for lvl, (cls_o, box_o, anc) in enumerate(zip(cls_outs, bbox_outs,
                                                      anchors)):
            sc = cls_o.permute(0, 2, 3, 1).reshape(
                b, -1, self.cls_out_channels).sigmoid()
            deltas = box_o.permute(0, 2, 3, 1).reshape(b, -1, 4)
            rank = sc.amax(-1)
            if factor_outs is not None:
                fac = factor_outs[lvl].permute(0, 2, 3, 1).reshape(
                    b, -1).sigmoid()
                rank = rank * fac
            idx = top_indices(rank, nms_pre)
            idx4 = idx[..., None].expand(-1, -1, 4)
            boxes = self.decode(anc[idx], deltas.gather(1, idx4),
                                self.means, self.stds)
            all_boxes.append(clip_to_image(boxes, img_shapes))
            all_scores.append(sc.gather(
                1, idx[..., None].expand(-1, -1, self.cls_out_channels)))
            if factor_outs is not None:
                all_factors.append(fac.gather(1, idx))
        return (torch.cat(all_boxes, dim=1), with_background(all_scores),
                torch.cat(all_factors, dim=1) if all_factors else None)

    def get_bboxes(self, cls_outs, bbox_outs, img_shapes: torch.Tensor,
                   factor_outs=None,
                   scale_factors: Optional[torch.Tensor] = None
                   ) -> DetResult:
        """Detections per image. With `factor_outs` (ATSS's centerness) the
        factor ranks the candidates with the class score and multiplies
        the output score, while the score threshold gates the raw class
        score (mmdet bbox_nms.py's score_factors)."""
        boxes, scores, factors = self.candidates(cls_outs, bbox_outs,
                                                 img_shapes, factor_outs)
        return nms_of_config(self.test_cfg, boxes, scores, factors,
                             scale_factors)

    # ---------------------------------------------------------------- train
    @property
    def sampling(self) -> bool:
        """Whether the classification loss samples anchors (mmdet: unless it
        is a focal-type loss, which keeps them all, normalised by the
        positives)."""
        return self.loss_cls_cfg.get("type",
                                     "CrossEntropyLoss") not in DENSE_LOSSES

    def flat_anchors(self, featmap_sizes: Sequence[Tuple[int, int]],
                     pad_shape: Tuple[int, int], device: torch.device
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every level's anchors, concatenated (N, 4) f32, and their
        validity (N,) bool: the anchor's grid cell lies inside `pad_shape`
        and, with train_cfg allowed_border >= 0, the anchor lies inside it
        by that margin (the RPN's -1 keeps them all)."""
        key = ("flat", tuple(featmap_sizes), tuple(pad_shape), str(device))
        if key not in self._anchor_cache:
            gen = self.anchor_generator
            anchors = np.concatenate(gen.grid_anchors(featmap_sizes))
            valid = np.concatenate(gen.valid_flags(featmap_sizes, pad_shape))
            border = int(self.train_cfg.get("allowed_border", 0))
            if border >= 0:
                valid = valid & ((anchors[:, 0] >= -border)
                                 & (anchors[:, 1] >= -border)
                                 & (anchors[:, 2] < pad_shape[1] + border)
                                 & (anchors[:, 3] < pad_shape[0] + border))
            self._anchor_cache[key] = (
                torch.from_numpy(np.ascontiguousarray(anchors, np.float32)
                                 ).to(device),
                torch.from_numpy(np.ascontiguousarray(valid)).to(device))
        return self._anchor_cache[key]

    def _flatten_preds(self, cls_outs, bbox_outs
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-level NCHW outputs -> (B, N, C) scores and (B, N, 4) deltas,
        flat in the anchors' (level, H, W, A) order."""
        b = cls_outs[0].shape[0]
        cls_cat = torch.cat([c.permute(0, 2, 3, 1).reshape(
            b, -1, self.cls_out_channels) for c in cls_outs], 1)
        box_cat = torch.cat([r.permute(0, 2, 3, 1).reshape(b, -1, 4)
                             for r in bbox_outs], 1)
        return cls_cat, box_cat

    def build_assigner(self) -> MaxIoUAssigner:
        cfg = dict(self.train_cfg["assigner"])
        cfg.pop("type", None)
        return MaxIoUAssigner(**cfg)

    def get_targets(self, anchors: torch.Tensor, anchor_valid: torch.Tensor,
                    batch: Dict[str, torch.Tensor]):
        """Batched target assignment. Returns labels (B, N) (num_classes
        where not positive), label_weights (B, N), bbox_targets (B, N, 4)
        and the positives (B, N) as float."""
        gt_bboxes = batch["gt_bboxes"]
        assigned, _, labels = self.build_assigner().assign(
            anchors, gt_bboxes, batch["gt_valid"], batch["gt_labels"],
            gt_bboxes_ignore=batch.get("gt_bboxes_ignore"),
            gt_ignore_valid=batch.get("gt_ignore_valid"),
            bbox_valid=anchor_valid)
        pos = assigned > 0
        neg = assigned == 0
        safe = (assigned - 1).clamp(0, gt_bboxes.shape[1] - 1)
        tgt = gt_bboxes.gather(1, safe[..., None].expand(-1, -1, 4))
        bbox_targets = self.encode(anchors, tgt, self.means, self.stds)
        bbox_targets = torch.where(pos[..., None], bbox_targets, 0.0)
        out_labels = torch.where(pos, labels, self.num_classes)
        pos_weight = float(self.train_cfg.get("pos_weight", -1))
        lw_pos = 1.0 if pos_weight <= 0 else pos_weight
        label_weights = pos.float() * lw_pos + neg.float()
        return out_labels, label_weights, bbox_targets, pos.float()

    def loss(self, cls_outs, bbox_outs, batch: Dict[str, torch.Tensor],
             generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """The head's losses on a batch: `batch` holds gt_bboxes (B, G, 4),
        gt_labels, gt_valid, optionally the ignore regions, and pad_shape
        (h, w). `generator` draws the sampler's priorities."""
        featmap_sizes = [tuple(c.shape[-2:]) for c in cls_outs]
        anchors, anchor_valid = self.flat_anchors(
            featmap_sizes, batch["pad_shape"], cls_outs[0].device)
        cls_cat, box_cat = self._flatten_preds(cls_outs, bbox_outs)
        b, n = cls_cat.shape[:2]
        labels, label_weights, bbox_targets, pos_mask = self.get_targets(
            anchors, anchor_valid, batch)

        if self.sampling and self.train_cfg.get("sampler"):
            scfg = dict(self.train_cfg["sampler"])
            sampler = RandomSampler(
                num=int(scfg.get("num", 256)),
                pos_fraction=float(scfg.get("pos_fraction", 0.5)),
                neg_pos_ub=int(scfg.get("neg_pos_ub", -1)))
            assigned = torch.where(pos_mask > 0, 1,
                                   torch.where(label_weights > 0, 0, -1))
            res = sampler.sample(generator, assigned, labels)
            label_weights = label_weights * (res.pos_mask
                                             | res.neg_mask).float()
            pos_mask = pos_mask * res.pos_mask.float()

        # each image adds max(positives, 1) (and max(negatives, 1) when
        # sampling), an image without gts included
        pos_per_img = pos_mask.sum(1)
        num_pos = pos_per_img.clamp(min=1.0).sum()
        if self.sampling:
            neg_per_img = (label_weights > 0).sum(1) - pos_per_img
            num_total = num_pos + neg_per_img.clamp(min=1.0).sum()
        else:
            num_total = num_pos
        loss_cls = build_loss(self.loss_cls_cfg)(
            cls_cat.reshape(b * n, -1), labels.reshape(-1),
            weight=label_weights.reshape(-1), avg_factor=num_total)
        loss_bbox = build_loss(self.loss_bbox_cfg)(
            box_cat, bbox_targets, weight=pos_mask[..., None],
            avg_factor=num_total)
        return {"loss_cls": loss_cls, "loss_bbox": loss_bbox,
                "num_pos": num_pos}
