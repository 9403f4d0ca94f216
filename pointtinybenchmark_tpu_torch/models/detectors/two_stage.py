"""Two-stage detector (Faster R-CNN, Mask R-CNN, Grid R-CNN, Cascade R-CNN,
HTC, SCNet, DetectoRS): backbone -> neck -> RPN -> RoI head.

Counterpart of pointtinybenchmark_tpu/models/detectors/two_stage.py::
TwoStageDetector / FasterRCNN / MaskRCNN / GridRCNN / CascadeRCNN /
HybridTaskCascade / SCNet / DetectoRS / RPN. The RPN
proposes with `test_cfg["rpn"]` and the RoI head detects with
`test_cfg["rcnn"]` (each head holds its part); Mask R-CNN is the same
detector with a mask head in its RoI head, whose results then carry the
mask probabilities; Grid R-CNN the same detector with a `GridRoIHead`,
which refines the boxes. Public functions take NHWC images, like the JAX
model and the single-stage detector.

`forward_train` is the whole training forward: the RPN's loss (class
agnostic: every gt is class 0), proposals from `train_cfg["rpn_proposal"]`
computed without gradient on the RPN's outputs (the proposal NMS runs
here), then the RoI head's loss on them. The losses come back under the
JAX package's names: loss_rpn_cls, loss_rpn_bbox, rpn_num_pos, loss_cls,
loss_bbox, rcnn_acc, rcnn_num_pos (and Grid R-CNN's loss_grid).

`RPN` is the standalone region-proposal network (mmdet
models/detectors/rpn.py): backbone, neck and RPN head alone, trained with
every gt as class 0; its detections are the class-agnostic proposals with
their scores and label 0 (the NMS at IoU 0.7 unless its test config sets
one).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from ...core.post_processing import DetResult
from ..dense_heads.rpn_head import RPNHead
from ..roi_heads.standard_roi_head import StandardRoIHead

__all__ = ["TwoStageDetector", "MaskRCNN", "GridRCNN", "CascadeRCNN",
           "HybridTaskCascade", "SCNet", "DetectoRS", "RPN"]

DEFAULT_PROPOSAL_CFG = dict(nms_pre=1000, max_per_img=1000,
                            nms=dict(iou_threshold=0.7), min_bbox_size=0)
DEFAULT_TRAIN_PROPOSAL_CFG = dict(nms_pre=2000, max_per_img=1000,
                                  nms=dict(iou_threshold=0.7),
                                  min_bbox_size=0)


class TwoStageDetector(nn.Module):

    def __init__(self, backbone: nn.Module, rpn_head: RPNHead,
                 roi_head: StandardRoIHead, neck: Optional[nn.Module] = None,
                 train_cfg: Optional[dict] = None):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.rpn_head = rpn_head
        self.roi_head = roi_head
        self.train_proposal_cfg = dict((train_cfg or {}).get(
            "rpn_proposal", DEFAULT_TRAIN_PROPOSAL_CFG))

    def init_weights(self, generator: torch.Generator) -> None:
        for m in (self.backbone, self.neck, self.rpn_head, self.roi_head):
            if m is not None:
                m.init_weights(generator)

    def extract_feat(self, img: torch.Tensor):
        """img (B, H, W, 3) -> tuple of NCHW feature maps."""
        x = self.backbone(img.permute(0, 3, 1, 2))
        return self.neck(x) if self.neck is not None else x

    def forward(self, img: torch.Tensor
                ) -> Union[DetResult, Tuple[DetResult, torch.Tensor]]:
        """The whole network on (B, H, W, 3) images, each image's shape its
        own (JAX `__call__`): the per-tile detections before any merge (and
        their mask probabilities, with a mask head)."""
        b, h, w = img.shape[:3]
        img_shapes = torch.tensor([[h, w]], dtype=torch.int32,
                                  device=img.device).expand(b, 2)
        return self.simple_test(img, img_shapes)

    def simple_test(self, img: torch.Tensor, img_shapes: torch.Tensor,
                    scale_factors: Optional[torch.Tensor] = None,
                    rescale: bool = False
                    ) -> Union[DetResult, Tuple[DetResult, torch.Tensor]]:
        """img (B, H, W, 3), img_shapes (B, 2) (h, w) of each image's
        content. With `rescale`, boxes are divided by `scale_factors`
        (B, 4): the original image's frame. Returns the RoI head's result:
        the detections, and with a mask head (detections, masks)."""
        feats = self.extract_feat(img)
        proposals, _, valid = self.rpn_head.get_proposals(
            *self.rpn_head(feats), img_shapes,
            self.rpn_head.test_cfg or DEFAULT_PROPOSAL_CFG)
        return self.roi_head.simple_test(feats, proposals, valid, img_shapes,
                                         scale_factors, rescale)


    def forward_train(self, img: torch.Tensor, batch: Dict[str, torch.Tensor],
                      generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """img (B, H, W, 3); batch: gt_bboxes (B, G, 4), gt_labels (B, G),
        gt_valid (B, G), img_shape (B, 2) and optionally gt_bboxes_ignore,
        gt_ignore_valid. `generator` (on the img's device) draws both
        samplers' priorities. Returns every loss and metric."""
        feats = self.extract_feat(img)
        batch = dict(batch, pad_shape=tuple(img.shape[1:3]))
        rpn_outs = self.rpn_head(feats)
        rpn_batch = dict(batch, gt_labels=torch.zeros_like(batch["gt_labels"]))
        rpn_losses = {
            (f"loss_rpn_{k.split('loss_')[-1]}" if k.startswith("loss")
             else f"rpn_{k}"): v
            for k, v in self.rpn_head.loss(*rpn_outs, rpn_batch,
                                           generator).items()}
        with torch.no_grad():
            proposals, _, valid = self.rpn_head.get_proposals(
                *[[o.detach() for o in outs] for outs in rpn_outs],
                batch["img_shape"], self.train_proposal_cfg)
        roi_losses = {
            (k if k.startswith("loss") else f"rcnn_{k}"): v
            for k, v in self.roi_head.forward_train(feats, proposals, valid,
                                                    batch, generator).items()}
        return {**rpn_losses, **roi_losses}


class MaskRCNN(TwoStageDetector):
    """Mask R-CNN (mmdet models/detectors/mask_rcnn.py): the mask branch
    lives in the RoI head (its `mask_head`)."""


class GridRCNN(TwoStageDetector):
    """Grid R-CNN (mmdet models/detectors/grid_rcnn.py): the grid branch
    lives in the RoI head (`roi_heads/grid_roi_head.py::GridRoIHead`)."""


class CascadeRCNN(TwoStageDetector):
    """Cascade R-CNN (mmdet models/detectors/cascade_rcnn.py): the stages
    live in the RoI head (`roi_heads/cascade_roi_head.py::CascadeRoIHead`);
    its losses come back as loss_s{i}_cls, loss_s{i}_bbox and
    rcnn_s{i}_num_pos."""


class HybridTaskCascade(TwoStageDetector):
    """HTC (mmdet models/detectors/htc.py): the interleaved cascade, its
    mask information flow and the semantic branch live in the RoI head
    (`roi_heads/htc_roi_head.py`); with masks it returns (detections,
    14x14 mask probabilities)."""


class SCNet(TwoStageDetector):
    """SCNet (mmdet models/detectors/scnet.py): the global context and
    the feature relay live in the RoI head (`roi_heads/scnet_roi_head.py`)."""


class DetectoRS(TwoStageDetector):
    """DetectoRS (JAX `DetectoRS`): a `DetectoRS_ResNet` backbone with
    `output_img` and the `RFP` neck over the RoI head of its config (the
    repo's over Cascade R-CNN's)."""


class RPN(nn.Module):
    """The standalone RPN (JAX two_stage.py::RPN). `simple_test` proposes
    with the head's test config (JAX: test_cfg["rpn"], or the whole
    test_cfg without one), its NMS at IoU 0.7 unless set."""

    def __init__(self, backbone: nn.Module, rpn_head: RPNHead,
                 neck: Optional[nn.Module] = None):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.rpn_head = rpn_head

    def init_weights(self, generator: torch.Generator) -> None:
        for m in (self.backbone, self.neck, self.rpn_head):
            if m is not None:
                m.init_weights(generator)

    extract_feat = TwoStageDetector.extract_feat

    def forward(self, img: torch.Tensor) -> DetResult:
        b, h, w = img.shape[:3]
        img_shapes = torch.tensor([[h, w]], dtype=torch.int32,
                                  device=img.device).expand(b, 2)
        return self.simple_test(img, img_shapes)

    def simple_test(self, img: torch.Tensor, img_shapes: torch.Tensor,
                    scale_factors: Optional[torch.Tensor] = None,
                    rescale: bool = False) -> DetResult:
        """img (B, H, W, 3) -> the proposals as detections: bboxes
        (B, P, 5) with the score, labels 0, valid (B, P); with `rescale`
        divided by `scale_factors` (B, 4)."""
        feats = self.extract_feat(img)
        cfg = dict(self.rpn_head.test_cfg or {})
        cfg.setdefault("nms", dict(iou_threshold=0.7))
        proposals, scores, valid = self.rpn_head.get_proposals(
            *self.rpn_head(feats), img_shapes, cfg)
        if rescale and scale_factors is not None:
            proposals = proposals / scale_factors[:, None, :]
        return DetResult(torch.cat([proposals, scores[..., None]], -1),
                         torch.zeros(scores.shape, dtype=torch.int32,
                                     device=scores.device), valid)

    def forward_train(self, img: torch.Tensor, batch: Dict[str, torch.Tensor],
                      generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """The RPN head's loss, every gt of class 0."""
        feats = self.extract_feat(img)
        rpn_batch = dict(batch, pad_shape=tuple(img.shape[1:3]),
                         gt_labels=torch.zeros_like(batch["gt_labels"]))
        return self.rpn_head.loss(*self.rpn_head(feats), rpn_batch, generator)
