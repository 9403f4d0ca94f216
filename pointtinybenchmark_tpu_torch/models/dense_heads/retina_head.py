"""RetinaHead: 4 stacked 3x3 convs on each of the cls and reg branches over
the AnchorHead machinery (mmdet dense_heads/retina_head.py).

Counterpart of pointtinybenchmark_tpu/models/dense_heads/retina_head.py,
without norm layers (the ported configs set none).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..utils import ConvModule, bias_init_with_prob, normal_init
from .anchor_head import AnchorHead

__all__ = ["RetinaHead"]


class RetinaHead(AnchorHead):

    def __init__(self, num_classes: int, in_channels: int,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 norm_cfg: Optional[dict] = None,
                 anchor_generator: Optional[dict] = None,
                 bbox_coder: Optional[dict] = None,
                 loss_cls: Optional[dict] = None,
                 test_cfg: Optional[dict] = None):
        if norm_cfg:
            raise NotImplementedError("RetinaHead norm_cfg is not ported")
        self.stacked_convs = stacked_convs
        super().__init__(num_classes, in_channels, feat_channels,
                         anchor_generator, bbox_coder, loss_cls,
                         test_cfg=test_cfg)

    def _init_layers(self) -> None:
        chans = [self.in_channels] + [self.feat_channels] * self.stacked_convs
        self.cls_convs = nn.ModuleList(
            ConvModule(chans[i], chans[i + 1], 3)
            for i in range(self.stacked_convs))
        self.reg_convs = nn.ModuleList(
            ConvModule(chans[i], chans[i + 1], 3)
            for i in range(self.stacked_convs))
        a = self.num_base_anchors
        self.retina_cls = nn.Conv2d(chans[-1], a * self.cls_out_channels, 3,
                                    padding=1)
        self.retina_reg = nn.Conv2d(chans[-1], a * 4, 3, padding=1)

    def init_weights(self, generator: torch.Generator) -> None:
        for conv in list(self.cls_convs) + list(self.reg_convs):
            normal_init(conv.conv, 0.01, generator)
        normal_init(self.retina_cls, 0.01, generator,
                    bias=bias_init_with_prob(0.01))
        normal_init(self.retina_reg, 0.01, generator)

    def forward(self, feats: Sequence[torch.Tensor]):
        cls_outs, reg_outs = [], []
        for f in feats:
            cf, rf = f, f
            for conv in self.cls_convs:
                cf = conv(cf)
            for conv in self.reg_convs:
                rf = conv(rf)
            cls_outs.append(self.retina_cls(cf))
            reg_outs.append(self.retina_reg(rf))
        return cls_outs, reg_outs
