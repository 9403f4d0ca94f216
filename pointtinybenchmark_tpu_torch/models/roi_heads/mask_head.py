"""FCNMaskHead, Mask R-CNN's mask branch: inference.

Counterpart of pointtinybenchmark_tpu/models/roi_heads/mask_head.py::
FCNMaskHead (mmdet fcn_mask_head.py) with mmdet's module names: `num_convs`
3x3 convolutions with ReLU (`convs.{i}.conv`), a 2x2 stride-2 transposed
convolution with ReLU (`upsample`) and a 1x1 convolution to one logit map
per class (`conv_logits`). RoI features (R, C, S, S) give logits
(R, num_classes, 2S, 2S). The JAX head's flax `ConvTranspose` indexes its
2x2 taps the other way round from `nn.ConvTranspose2d`, which
`utils/jax_weights.py` bridges. `mask_target` and the loss wait for
training.
"""
from __future__ import annotations

import torch
from torch import nn

from ..utils import ConvModule, kaiming_init, normal_init

__all__ = ["FCNMaskHead"]


class FCNMaskHead(nn.Module):

    def __init__(self, num_convs: int = 4, in_channels: int = 256,
                 conv_out_channels: int = 256, num_classes: int = 80):
        super().__init__()
        self.num_classes = num_classes
        self.convs = nn.ModuleList(
            ConvModule(in_channels if i == 0 else conv_out_channels,
                       conv_out_channels, 3, padding=1)
            for i in range(num_convs))
        last = conv_out_channels if num_convs else in_channels
        self.upsample = nn.ConvTranspose2d(last, conv_out_channels, 2,
                                           stride=2)
        self.conv_logits = nn.Conv2d(conv_out_channels, num_classes, 1)

    def init_weights(self, generator: torch.Generator) -> None:
        for m in self.convs:
            kaiming_init(m.conv, generator)
        kaiming_init(self.upsample, generator)
        normal_init(self.conv_logits, 0.001, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (R, C, S, S) -> mask logits (R, num_classes, 2S, 2S)."""
        for conv in self.convs:
            x = conv(x)
        return self.conv_logits(torch.relu(self.upsample(x)))
