"""DetectoRS backbone: ResNet with switchable atrous convolution (SAC) and
the recursive feature pyramid's feedback input (mmdet
backbones/detectors_resnet.py, mmcv ops/saconv.py).

Counterpart of pointtinybenchmark_tpu/models/backbones/detectors_resnet.py
(`SAConv2d`, `_SACBottleneck`, `DetectoRS_ResNet`, `DetectoRS_ResNeXt`),
with the JAX module names: the stem is `stem_conv` / `stem_bn`, a block's
layers `conv1`, `bn1`, `conv2` (or `conv2_sac`), `bn2`, `conv3`, `bn3`,
`downsample_conv`, `downsample_bn` and `rfp_conv`, block j of stage i is
`layer{i}.{j}` (JAX `layer{i}_block{j}`).

`SAConv2d` as the JAX module computes it: the weight standardised over
(in, kh, kw) per output channel by its mean and its standard deviation with
ddof 0, plus 1e-5, then `weight_gamma * (w - mean) / std + weight_beta`
(gamma drawn constant at the he std sqrt(2 / (9 in / groups)), beta 0);
a zero-init 1x1 `pre_context` of the input's global average added to the
input; a `switch` (1x1 to one channel, weight 0, bias 1) on the 5x5
average pool, at the conv's stride, of the input reflect-padded by 2
(`reflect_pad2`: numpy's reflection also on maps of 2 or fewer rows); the
3x3 conv at dilation 1 with the standardised weight and at dilation 3 (and
padding 3) with it plus `weight_diff` (zero-init), blended by the switch;
a zero-init 1x1 `post_context` of the output's global average added. The
weight is drawn he_normal (a truncated normal over fan_in = 9 in /
groups). The JAX module's mmcv `use_deform` refinement is omitted there
and here.

BN is flax's (`FlaxBatchNorm2d`); with `norm_eval` it keeps its running
statistics in training too. `rfp_inplanes` gives block 0 of stages 2-4 a
zero-init 1x1 `rfp_conv` on the fed-back feature, added before the last
ReLU, when `forward` is given `rfp_feats`. `output_img` puts the input
image first in the outputs (the RFP neck's input). `frozen_stages` is kept
for the optimizer, which freezes by name as the JAX package does
(engine/optimizer.py::frozen_param_names): the stages `layer1` ..
`layer{frozen_stages}`, but not this stem, whose names are not the
anonymous `Conv_0` / `BatchNorm_0` that JAX's rule looks for.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils import he_normal_, lecun_normal_
from .resnet import FlaxBatchNorm2d

__all__ = ["reflect_pad2", "SAConv2d", "SACBottleneck", "DetectoRS_ResNet",
           "DetectoRS_ResNeXt"]

ARCH = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def reflect_pad2(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) reflect-padded by 2 on each side of H and W, as
    `jnp.pad(..., "reflect")`: where a side is 2 or less (which
    `F.pad` refuses) the rows are numpy's reflect indices, which reflect
    again at each end."""
    if min(x.shape[-2:]) > 2:
        return F.pad(x, (2, 2, 2, 2), mode="reflect")
    for dim in (2, 3):
        idx = np.pad(np.arange(x.shape[dim]), 2, mode="reflect")
        x = x.index_select(dim, torch.from_numpy(idx).to(x.device))
    return x


class SAConv2d(nn.Module):
    """Switchable atrous 3x3 convolution, no bias (see the module note)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 groups: int = 1):
        super().__init__()
        self.stride = stride
        self.groups = groups
        shape = (out_channels, in_channels // groups, 3, 3)
        self.weight = nn.Parameter(torch.empty(shape))
        self.weight_gamma = nn.Parameter(torch.empty(out_channels, 1, 1, 1))
        self.weight_beta = nn.Parameter(torch.empty(out_channels, 1, 1, 1))
        self.weight_diff = nn.Parameter(torch.empty(shape))
        self.pre_context = nn.Conv2d(in_channels, in_channels, 1)
        self.switch = nn.Conv2d(in_channels, 1, 1)
        self.post_context = nn.Conv2d(out_channels, out_channels, 1)
        self.he_std = math.sqrt(2.0 / (9 * in_channels // groups))

    def init_weights(self, generator: torch.Generator) -> None:
        he_normal_(self.weight, generator)
        nn.init.constant_(self.weight_gamma, self.he_std)
        for p in (self.weight_beta, self.weight_diff):
            nn.init.zeros_(p)
        for m in (self.pre_context, self.switch, self.post_context):
            nn.init.zeros_(m.weight)
            nn.init.zeros_(m.bias)
        nn.init.ones_(self.switch.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        var, mean = torch.var_mean(w, dim=(1, 2, 3), correction=0,
                                   keepdim=True)
        w = self.weight_gamma * (w - mean) / (var.sqrt() + 1e-5) \
            + self.weight_beta
        x = x + self.pre_context(x.mean((2, 3), keepdim=True))
        avg = F.avg_pool2d(reflect_pad2(x), 5, stride=self.stride)
        switch = self.switch(avg)
        out_s = F.conv2d(x, w, None, self.stride, 1, 1, self.groups)
        out_l = F.conv2d(x, w + self.weight_diff, None, self.stride, 3, 3,
                         self.groups)
        out = switch * out_s + (1 - switch) * out_l
        return out + self.post_context(out.mean((2, 3), keepdim=True))


class SACBottleneck(nn.Module):
    """The bottleneck whose 3x3 is SAC in the `with_sac` stages; ResNeXt
    width `planes * base_width / 64 * groups` where groups > 1."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, with_sac: bool = False,
                 rfp_inplanes: Optional[int] = None, groups: int = 1,
                 base_width: int = 64):
        super().__init__()
        width = (planes * base_width // 64) * groups if groups != 1 \
            else planes
        out = planes * 4
        self.conv1 = nn.Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = FlaxBatchNorm2d(width)
        self.with_sac = with_sac
        if with_sac:
            self.conv2_sac = SAConv2d(width, width, stride, groups)
        else:
            self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1,
                                   groups=groups, bias=False)
        self.bn2 = FlaxBatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, out, 1, bias=False)
        self.bn3 = FlaxBatchNorm2d(out)
        if downsample:
            self.downsample_conv = nn.Conv2d(inplanes, out, 1, stride=stride,
                                             bias=False)
            self.downsample_bn = FlaxBatchNorm2d(out)
        self.downsample = downsample
        self.rfp_conv = (nn.Conv2d(rfp_inplanes, out, 1)
                         if rfp_inplanes is not None else None)

    def forward(self, x: torch.Tensor,
                rfp_feat: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.conv2_sac(y) if self.with_sac else self.conv2(y)
        y = torch.relu(self.bn2(y))
        y = self.bn3(self.conv3(y))
        identity = (self.downsample_bn(self.downsample_conv(x))
                    if self.downsample else x)
        out = y + identity
        if self.rfp_conv is not None and rfp_feat is not None:
            out = out + self.rfp_conv(rfp_feat)
        return torch.relu(out)


class DetectoRS_ResNet(nn.Module):

    def __init__(self, depth: int = 50, num_stages: int = 4,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 strides: Sequence[int] = (1, 2, 2, 2),
                 frozen_stages: int = -1, norm_eval: bool = True,
                 base_channels: int = 64, sac: Optional[dict] = None,
                 stage_with_sac: Sequence[bool] = (False,) * 4,
                 rfp_inplanes: Optional[int] = None, output_img: bool = False,
                 groups: int = 1, base_width: int = 64):
        super().__init__()
        if depth not in ARCH:
            raise NotImplementedError(
                f"DetectoRS_ResNet depth {depth}: one of {sorted(ARCH)}")
        self.frozen_stages = frozen_stages
        self.norm_eval = norm_eval
        self.out_indices = tuple(out_indices)
        self.output_img = output_img
        self.stem_conv = nn.Conv2d(3, base_channels, 7, stride=2, padding=3,
                                   bias=False)
        self.stem_bn = FlaxBatchNorm2d(base_channels)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        planes = in_ch = base_channels
        self.res_layers = []
        for i in range(num_stages):
            blocks = []
            for j in range(ARCH[depth][i]):
                s = strides[i] if j == 0 else 1
                blocks.append(SACBottleneck(
                    in_ch, planes, s, j == 0 and (s != 1
                                                  or in_ch != planes * 4),
                    bool(sac) and bool(stage_with_sac[i]),
                    rfp_inplanes if i > 0 and j == 0 else None,
                    groups, base_width))
                in_ch = planes * 4
            self.add_module(f"layer{i + 1}", nn.ModuleList(blocks))
            self.res_layers.append(f"layer{i + 1}")
            planes *= 2

    def init_weights(self, generator: torch.Generator) -> None:
        """The plain convs flax's default (`lecun_normal_`), `rfp_conv`
        zeros, SAC's own draws; BN's scale 1, bias 0, statistics 0 and 1."""
        for m in self.modules():
            if isinstance(m, SAConv2d):
                m.init_weights(generator)
            elif isinstance(m, SACBottleneck):
                for name in ("conv1", "conv2", "conv3", "downsample_conv"):
                    if hasattr(m, name):
                        lecun_normal_(getattr(m, name), generator)
                if m.rfp_conv is not None:
                    nn.init.zeros_(m.rfp_conv.weight)
                    nn.init.zeros_(m.rfp_conv.bias)
        lecun_normal_(self.stem_conv, generator)

    def train(self, mode: bool = True) -> "DetectoRS_ResNet":
        # norm_eval: BN keeps using its running statistics
        super().train(mode)
        if self.norm_eval:
            for m in self.modules():
                if isinstance(m, nn.BatchNorm2d):
                    m.eval()
        return self

    def forward(self, x: torch.Tensor,
                rfp_feats: Optional[Sequence[torch.Tensor]] = None):
        """x (B, 3, H, W); rfp_feats: the fed-back pyramid, level i into
        block 0 of stage i + 1 (i > 0). Returns the `out_indices` stages'
        outputs, after the image with `output_img`."""
        img = x
        x = self.maxpool(torch.relu(self.stem_bn(self.stem_conv(x))))
        outs = [img] if self.output_img else []
        for i, name in enumerate(self.res_layers):
            for j, block in enumerate(getattr(self, name)):
                x = block(x, rfp_feats[i] if rfp_feats is not None
                          and i > 0 and j == 0 else None)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)


class DetectoRS_ResNeXt(DetectoRS_ResNet):
    """DetectoRS over ResNeXt bottlenecks (JAX `DetectoRS_ResNeXt`): grouped
    3x3 and SAC convs, base_width 4 by default."""

    def __init__(self, depth: int = 50, num_stages: int = 4,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 strides: Sequence[int] = (1, 2, 2, 2),
                 frozen_stages: int = -1, norm_eval: bool = True,
                 base_channels: int = 64, sac: Optional[dict] = None,
                 stage_with_sac: Sequence[bool] = (False,) * 4,
                 rfp_inplanes: Optional[int] = None, output_img: bool = False,
                 groups: int = 1, base_width: int = 4):
        super().__init__(depth, num_stages, out_indices, strides,
                         frozen_stages, norm_eval, base_channels, sac,
                         stage_with_sac, rfp_inplanes, output_img, groups,
                         base_width)
