"""RFP, DetectoRS's recursive feature pyramid (mmdet necks/rfp.py), NCHW.

Counterpart of pointtinybenchmark_tpu/models/necks/rfp.py (`ASPP`, `RFP`)
with its module names. The input is the backbone's output with
`output_img=True`: (image, C2, ..., C5). One FPN (`fpn`) is shared by
every step. Each of the `rfp_steps - 1` feedback steps runs its own copy
of the backbone (`rfp_backbone{step}`, a `DetectoRS_ResNet` with
`rfp_inplanes` = ASPP's width x its branches) on the image, fed the
pyramid's level i > 0 through the shared `rfp_aspp` into block 0 of stage
i + 1, puts its outputs through the FPN, and blends each level as
sigmoid(`rfp_weight`(new)) * new + (1 - sigmoid(.)) * old, `rfp_weight`
being one zero-init 1x1 convolution to one channel for every level.
`ASPP` is three ReLU'd convolutions (1x1, then 3x3 at the dilations and
paddings of `dilations`) and a ReLU'd 1x1 on the global average,
broadcast, concatenated. ASPP runs on the levels the backbone reads (1 to
its stages - 1); JAX's also on the others, whose results nothing reads.

The JAX detector calls its neck without `train` (models/detectors/
two_stage.py:50), so the feedback backbones always normalise by BN's
running statistics: `train()` keeps their BN in eval mode here too.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from ..backbones.detectors_resnet import DetectoRS_ResNet
from ..utils import lecun_normal_
from .fpn import FPN

__all__ = ["ASPP", "RFP"]


class ASPP(nn.Module):

    def __init__(self, in_channels: int, out_channels: int,
                 dilations: Sequence[int] = (1, 3, 6, 1)):
        super().__init__()
        if dilations[-1] != 1:
            raise ValueError(f"ASPP's last dilation is its global branch's "
                             f"1: {dilations}")
        self.n = len(dilations)
        for i, d in enumerate(dilations):
            self.add_module(f"aspp{i}", nn.Conv2d(
                in_channels, out_channels, 3 if d > 1 else 1,
                padding=d if d > 1 else 0, dilation=d))

    def init_weights(self, generator: torch.Generator) -> None:
        for m in self.children():
            lecun_normal_(m, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [torch.relu(getattr(self, f"aspp{i}")(x))
                for i in range(self.n - 1)]
        gap = torch.relu(getattr(self, f"aspp{self.n - 1}")(
            x.mean((2, 3), keepdim=True)))
        return torch.cat(outs + [gap.expand_as(outs[-1])], 1)


class RFP(nn.Module):

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5,
                 start_level: int = 0,
                 add_extra_convs: Union[bool, str] = False,
                 rfp_steps: int = 2, rfp_backbone: Optional[dict] = None,
                 aspp_out_channels: int = 64,
                 aspp_dilations: Sequence[int] = (1, 3, 6, 1)):
        super().__init__()
        self.in_channels = list(in_channels)
        self.fpn = FPN(in_channels, out_channels, num_outs, start_level,
                       add_extra_convs=add_extra_convs)
        self.rfp_weight = nn.Conv2d(out_channels, 1, 1)
        self.rfp_aspp = ASPP(out_channels, aspp_out_channels, aspp_dilations)
        bb = dict(rfp_backbone or {})
        for key in ("type", "rfp_inplanes", "output_img"):
            bb.pop(key, None)
        self.rfp_steps = rfp_steps
        for step in range(rfp_steps - 1):
            self.add_module(f"rfp_backbone{step}", DetectoRS_ResNet(
                rfp_inplanes=aspp_out_channels * len(aspp_dilations),
                output_img=False, **bb))

    def init_weights(self, generator: torch.Generator) -> None:
        self.fpn.init_weights(generator)
        nn.init.zeros_(self.rfp_weight.weight)
        nn.init.zeros_(self.rfp_weight.bias)
        self.rfp_aspp.init_weights(generator)
        for step in range(self.rfp_steps - 1):
            getattr(self, f"rfp_backbone{step}").init_weights(generator)

    def train(self, mode: bool = True) -> "RFP":
        super().train(mode)
        for m in self.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.eval()
        return self

    def forward(self, inputs):
        if len(inputs) != len(self.in_channels) + 1:
            raise ValueError(f"{len(inputs)} inputs: the image and "
                             f"{len(self.in_channels)} levels expected")
        img, feats = inputs[0], tuple(inputs[1:])
        x = self.fpn(feats)
        for step in range(self.rfp_steps - 1):
            backbone = getattr(self, f"rfp_backbone{step}")
            n_fed = len(backbone.res_layers)
            rfp_feats = [x[0]] + [self.rfp_aspp(x[i])
                                  for i in range(1, n_fed)]
            new = self.fpn(backbone(img, rfp_feats))
            blended = []
            for a, b in zip(new, x):
                w = torch.sigmoid(self.rfp_weight(a))
                blended.append(w * a + (1 - w) * b)
            x = tuple(blended)
        return x
