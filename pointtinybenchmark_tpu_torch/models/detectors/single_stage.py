"""Single-stage detector: backbone -> neck -> dense head.

Counterpart of pointtinybenchmark_tpu/models/detectors/single_stage.py::
SingleStageDetector. The public functions take NHWC images, like the JAX
model; the input is permuted once to NCHW, which leaves it physically
channels-last in memory, the layout cuDNN prefers.
"""
from __future__ import annotations

from typing import Optional

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

    def simple_test(self, img: torch.Tensor,
                    img_shapes: torch.Tensor) -> DetResult:
        cls_outs, reg_outs = self(img)
        return self.bbox_head.get_bboxes(cls_outs, reg_outs, img_shapes)
