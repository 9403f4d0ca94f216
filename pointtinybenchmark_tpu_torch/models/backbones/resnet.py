"""ResNet backbone (mmdet resnet.py, style='pytorch').

Counterpart of pointtinybenchmark_tpu/models/backbones/resnet.py (`ResNet`,
`BasicBlock`, `Bottleneck`): basic blocks for depths 18/34, bottlenecks for
50/101/152. The stride sits on the (first) 3x3 conv; with `norm_eval`
(every config of the repo) BN always uses its running statistics; without
it, BN in training mode normalises by the batch's statistics and updates
the running ones as flax's BatchNorm does (`FlaxBatchNorm2d`). Padding
matches the flax model: the 1x1 stride-2
downsample pads nothing (flax SAME is 0 there), and the stem max-pool pads
with -inf, as MaxPool2d(3, 2, 1) does. `frozen_stages` is kept for the
optimizer, which leaves the stem and stages 1..frozen_stages unchanged
(engine/optimizer.py): as in the JAX package it stops no gradient.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..utils import kaiming_init

__all__ = ["ResNet", "BasicBlock", "Bottleneck", "FlaxBatchNorm2d"]


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d whose training mode is flax's: normalise by the batch's
    mean and biased variance, and move the running statistics by momentum
    0.99 towards them, the running variance towards the biased variance
    (torch's keeps the unbiased one). Evaluation uses the running
    statistics, as torch's does."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.01)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        return nn.functional.batch_norm(x, None, None, self.weight, self.bias,
                                        True, 0.0, self.eps)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn1 = FlaxBatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = FlaxBatchNorm2d(planes)
        self.downsample = (nn.Sequential(
            nn.Conv2d(inplanes, planes, 1, stride=stride, bias=False),
            FlaxBatchNorm2d(planes)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FlaxBatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = FlaxBatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = FlaxBatchNorm2d(out)
        self.downsample = (nn.Sequential(
            nn.Conv2d(inplanes, out, 1, stride=stride, bias=False),
            FlaxBatchNorm2d(out)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + identity)


ARCH_SETTINGS = {18: (BasicBlock, (2, 2, 2, 2)),
                 34: (BasicBlock, (3, 4, 6, 3)),
                 50: (Bottleneck, (3, 4, 6, 3)),
                 101: (Bottleneck, (3, 4, 23, 3)),
                 152: (Bottleneck, (3, 8, 36, 3))}


class ResNet(nn.Module):

    def __init__(self, depth: int = 50, num_stages: int = 4,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 strides: Sequence[int] = (1, 2, 2, 2),
                 base_channels: int = 64, frozen_stages: int = -1,
                 norm_eval: bool = True):
        super().__init__()
        self.frozen_stages = frozen_stages
        self.norm_eval = norm_eval
        if depth not in ARCH_SETTINGS:
            raise NotImplementedError(f"ResNet depth {depth} is not ported")
        self.out_indices = tuple(out_indices)
        self.conv1 = nn.Conv2d(3, base_channels, 7, stride=2, padding=3,
                               bias=False)
        self.bn1 = FlaxBatchNorm2d(base_channels)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        block, stage_blocks = ARCH_SETTINGS[depth]
        inplanes, planes = base_channels, base_channels
        self.res_layers = []
        for i in range(num_stages):
            blocks = []
            for j in range(stage_blocks[i]):
                s = strides[i] if j == 0 else 1
                need_down = j == 0 and (s != 1 or
                                        inplanes != planes * block.expansion)
                blocks.append(block(inplanes, planes, s, need_down))
                inplanes = planes * block.expansion
            name = f"layer{i + 1}"
            self.add_module(name, nn.Sequential(*blocks))
            self.res_layers.append(name)
            planes *= 2

    def init_weights(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                kaiming_init(m, generator)

    def train(self, mode: bool = True) -> "ResNet":
        # norm_eval: BN keeps using its running statistics
        super().train(mode)
        if self.norm_eval:
            for m in self.modules():
                if isinstance(m, nn.BatchNorm2d):
                    m.eval()
        return self

    def forward(self, x: torch.Tensor):
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        outs = []
        for i, name in enumerate(self.res_layers):
            x = getattr(self, name)(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
