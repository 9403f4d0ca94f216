"""Single-stage detector: backbone -> neck -> dense head, and the point
locator shell.

Counterpart of pointtinybenchmark_tpu/models/detectors/single_stage.py::
SingleStageDetector and ::BasicLocator. The public functions take NHWC
images, like the JAX model; the input is permuted once to NCHW, which
leaves it physically channels-last in memory, the layout cuDNN prefers. `forward_train` is the
network's outputs into the head's `loss`, with the padded batch shape as
`pad_shape`.

BasicLocator carries the point heads. P2P's is a dense head like any
other, and its `simple_test` returns the pseudo-box detections and the
(cx, cy, score) points. A head that samples features at the gt points
inside the network (CPR: `needs_gt_in_forward`) gets the batch in its
forward, with the gt boxes' centres as `gt_points` (B, G, 1, 2);
`refine_test` refines the annotated points (CPR's inference).

P2BNet and SSDDet are locators whose head needs the gts: their
`refine_test` returns the pseudo boxes' centres, scores, the pseudo boxes
(real extents, so `pseudo_wh` is unused) and the invalid gts as
not_refine, the contract `engine/test.py::run_refine_test` reads.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ...core.post_processing import DetResult

__all__ = ["SingleStageDetector", "BasicLocator", "P2BNet", "SSDDet"]


class SingleStageDetector(nn.Module):

    def __init__(self, backbone: nn.Module, bbox_head: nn.Module,
                 neck: Optional[nn.Module] = None):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.bbox_head = bbox_head

    def init_weights(self, generator: torch.Generator) -> None:
        for m in (self.backbone, self.neck, self.bbox_head):
            if m is not None:
                m.init_weights(generator)

    def extract_feat(self, img: torch.Tensor):
        """img (B, H, W, 3) -> tuple of NCHW feature maps."""
        x = self.backbone(img.permute(0, 3, 1, 2))
        return self.neck(x) if self.neck is not None else x

    def forward(self, img: torch.Tensor):
        """img (B, H, W, 3) -> the head's per-level NCHW outputs."""
        return self.bbox_head(self.extract_feat(img))

    def forward_train(self, img: torch.Tensor, batch: Dict[str, torch.Tensor],
                      generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """img (B, H, W, 3); batch: gt_bboxes (B, G, 4), gt_labels (B, G),
        gt_valid (B, G) and optionally gt_bboxes_ignore, gt_ignore_valid.
        `generator` (on the img's device) draws a sampling loss's
        priorities. Returns the head's losses and num_pos."""
        batch = dict(batch, pad_shape=tuple(img.shape[1:3]))
        return self.bbox_head.loss(*self(img), batch, generator)

    def simple_test(self, img: torch.Tensor, img_shapes: torch.Tensor,
                    scale_factors: Optional[torch.Tensor] = None,
                    rescale: bool = False) -> DetResult:
        """The head's detections from all its outputs (RetinaNet's two,
        FCOS's and ATSS's three, RepPoints' four), as the JAX detector
        passes `*outs`; with `rescale`, boxes divided by `scale_factors`
        (B, 4) before the NMS: the original image's frame."""
        return self.bbox_head.get_bboxes(
            *self(img), img_shapes,
            scale_factors=scale_factors if rescale else None)


class BasicLocator(SingleStageDetector):

    @property
    def _needs_gt(self) -> bool:
        return getattr(self.bbox_head, "needs_gt_in_forward", False)

    @staticmethod
    def _head_batch(img: torch.Tensor,
                    batch: Dict[str, Any]) -> Dict[str, Any]:
        gt_bboxes = batch["gt_bboxes"]
        centers = (gt_bboxes[..., :2] + gt_bboxes[..., 2:]) / 2
        return dict(batch, gt_points=centers[:, :, None, :],
                    pad_shape=tuple(img.shape[1:3]))

    def forward(self, img: torch.Tensor,
                batch: Optional[Dict[str, Any]] = None, mode: str = "train"):
        """img (B, H, W, 3). A dense point head gives its per-level
        outputs; a head that needs the gts gets `batch` and gives the
        outputs of `mode`."""
        feats = self.extract_feat(img)
        if self._needs_gt:
            return self.bbox_head(feats, self._head_batch(img, batch),
                                  mode=mode)
        return self.bbox_head(feats)

    def forward_train(self, img: torch.Tensor, batch: Dict[str, torch.Tensor],
                      generator: torch.Generator) -> Dict[str, torch.Tensor]:
        if self._needs_gt:
            outputs = self(img, batch, mode="train")
            return self.bbox_head.loss(outputs, self._head_batch(img, batch),
                                       generator)
        return super().forward_train(img, batch, generator)

    def simple_test(self, img: torch.Tensor, img_shapes: torch.Tensor,
                    scale_factors: Optional[torch.Tensor] = None,
                    rescale: bool = False):
        """A dense point head's detections: (DetResult of pseudo boxes,
        (B, max_per_img, 3) points)."""
        cls_outs, pts_outs = self(img)
        return self.bbox_head.get_bboxes(cls_outs, pts_outs, img_shapes,
                                         tuple(img.shape[1:3]),
                                         scale_factors, rescale)

    def refine_test(self, img: torch.Tensor, batch: Dict[str, torch.Tensor],
                    pseudo_wh=(16, 16)) -> Tuple[torch.Tensor, ...]:
        """CPR annotation refinement: refined points (B, G, 2), scores
        (B, G), pseudo boxes (B, G, 4) and not_refine (B, G)."""
        head = self.bbox_head
        if getattr(head, "cascade_stages", 1) > 1:
            refine_pts, scores, not_refine = self(img, batch,
                                                  mode="cascade_refine")
        else:
            outputs = self(img, batch, mode="refine")
            refine_pts, scores, not_refine = head.refine(
                outputs, self._head_batch(img, batch))
        return (refine_pts, scores,
                head.center_to_pseudo_bbox(refine_pts, pseudo_wh), not_refine)


class P2BNet(BasicLocator):
    """Point-to-box MIL (P2BNetHead); the pseudo boxes it refines train a
    Faster R-CNN."""

    def refine_test(self, img: torch.Tensor, batch: Dict[str, torch.Tensor],
                    pseudo_wh=(16, 16)) -> Tuple[torch.Tensor, ...]:
        """Pseudo-box refinement: centres (B, G, 2), scores (B, G), boxes
        (B, G, 4) and not_refine (B, G), the gts that are not valid."""
        del pseudo_wh
        outputs = self(img, batch, mode="refine")
        boxes = outputs["pseudo_boxes"]
        centers = (boxes[..., :2] + boxes[..., 2:]) / 2
        return centers, outputs["pseudo_scores"], boxes, ~batch["gt_valid"]


class SSDDet(P2BNet):
    """Noisy-box self-distillation (SSDDetHead), P2BNet's workflow."""
