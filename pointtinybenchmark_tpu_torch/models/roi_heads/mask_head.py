"""FCNMaskHead, Mask R-CNN's mask branch, and its training targets.

Counterpart of pointtinybenchmark_tpu/models/roi_heads/mask_head.py::
FCNMaskHead (mmdet fcn_mask_head.py) with mmdet's module names: `num_convs`
3x3 convolutions with ReLU (`convs.{i}.conv`), a 2x2 stride-2 transposed
convolution with ReLU (`upsample`) and a 1x1 convolution to one logit map
per class (`conv_logits`). RoI features (R, C, S, S) give logits
(R, num_classes, 2S, 2S). The JAX head's flax `ConvTranspose` indexes its
2x2 taps the other way round from `nn.ConvTranspose2d`, which
`utils/jax_weights.py` bridges.

`mask_target` (JAX `mask_target`) crops each roi's gt bitmap: the (B, G)
bitmaps are one stack indexed by b * G + g, RoIAligned at spatial scale 1
with S = mask_size and sr = 2 by the plain single-level
`ops/roi_align.py::roi_align` (the JAX function is not a Pallas kernel
either) and thresholded at 0.5. The taps are gathered from the uint8 stack
and cast after the gather: the values are 0 and 1, so the numbers are
those of a float stack, without its memory (0.86 GB at COCO's 2 x 100
bitmaps of 800 x 1344).
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops.roi_align import roi_align
from ..utils import ConvModule, lecun_normal_, normal_init

__all__ = ["FCNMaskHead", "mask_target"]


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
        """The convs and the upsample flax's default (`lecun_normal_`),
        conv_logits normal(0.001), biases 0, as the JAX head's."""
        for m in self.convs:
            lecun_normal_(m.conv, generator)
        lecun_normal_(self.upsample, generator)
        normal_init(self.conv_logits, 0.001, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (R, C, S, S) -> mask logits (R, num_classes, 2S, 2S)."""
        for conv in self.convs:
            x = conv(x)
        return self.conv_logits(torch.relu(self.upsample(x)))


def mask_target(gt_masks: torch.Tensor, rois: torch.Tensor,
                gt_inds: torch.Tensor, mask_size: int = 28) -> torch.Tensor:
    """gt_masks (B, G, H, W) uint8; rois (R, 5) with the batch index;
    gt_inds (R,) indices into G. Returns (R, mask_size, mask_size) float32
    of 0 and 1."""
    b, g, h, w = gt_masks.shape
    flat_idx = rois[:, 0].long() * g + gt_inds.long()
    rois_flat = torch.cat([flat_idx[:, None].to(rois.dtype), rois[:, 1:5]],
                          1)
    crop = roi_align(gt_masks.reshape(b * g, 1, h, w), rois_flat, 1.0,
                     mask_size, sampling_ratio=2)
    return (crop[:, 0] >= 0.5).to(torch.float32)
