"""Single-stage detector: backbone -> neck -> dense head.

Counterpart of pointtinybenchmark_tpu/models/detectors/single_stage.py::
SingleStageDetector. The public functions take NHWC images, like the JAX
model; the input is permuted once to NCHW, which leaves it physically
channels-last in memory, the layout cuDNN prefers. `forward_train` is the
network's outputs into the head's `loss`, with the padded batch shape as
`pad_shape`.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ...core.post_processing import DetResult

__all__ = ["SingleStageDetector"]


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
        """img (B, H, W, 3) -> per-level (cls_outs, reg_outs), NCHW."""
        return self.bbox_head(self.extract_feat(img))

    def forward_train(self, img: torch.Tensor, batch: Dict[str, torch.Tensor],
                      generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """img (B, H, W, 3); batch: gt_bboxes (B, G, 4), gt_labels (B, G),
        gt_valid (B, G) and optionally gt_bboxes_ignore, gt_ignore_valid.
        `generator` (on the img's device) draws a sampling loss's
        priorities. Returns the head's losses and num_pos."""
        batch = dict(batch, pad_shape=tuple(img.shape[1:3]))
        return self.bbox_head.loss(*self(img), batch, generator)

    def simple_test(self, img: torch.Tensor,
                    img_shapes: torch.Tensor) -> DetResult:
        cls_outs, reg_outs = self(img)
        return self.bbox_head.get_bboxes(cls_outs, reg_outs, img_shapes)
