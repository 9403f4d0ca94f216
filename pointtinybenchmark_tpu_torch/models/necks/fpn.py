"""Feature Pyramid Network (mmdet necks/fpn.py), NCHW.

Counterpart of pointtinybenchmark_tpu/models/necks/fpn.py::FPN: lateral 1x1
convs, a top-down nearest-neighbour pathway, 3x3 output convs, `start_level`
(the Adap recipe keeps stride 4 with start_level=0) and extra stride-2
levels. With `add_extra_convs=False`, the default as in the JAX FPN, each
extra level is the last output subsampled by 2 (a 1x1 max-pool of stride
2, the RPN configs' form); with "on_input" (or True) it is a stride-2 conv
on the last input (the RetinaNet configs' form). Module names follow mmdet:
the extra convs sit in `fpn_convs` after the per-lateral output convs.

`norm_cfg` is taken and builds no norm layer: the JAX FPN has no such
field and its builder drops the key, so the point configs' FPN
(`norm_cfg=GN`) runs without a norm in the JAX package, and so here, to
stay the same network (mmdet's FPN would put GN after each conv).
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import ConvModule, lecun_normal_

__all__ = ["FPN"]

EXTRA_SOURCES = (False, True, "on_input", "on_lateral", "on_output")


class FPN(nn.Module):

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5,
                 start_level: int = 0, end_level: int = -1,
                 add_extra_convs: Union[bool, str] = False,
                 relu_before_extra_convs: bool = False,
                 norm_cfg: Optional[dict] = None):
        super().__init__()
        del norm_cfg        # no norm, as the JAX FPN (see the module note)
        self.in_channels = list(in_channels)
        self.num_outs = num_outs
        self.start_level = start_level
        self.end = len(in_channels) if end_level == -1 else end_level + 1
        n_used = self.end - start_level
        if add_extra_convs not in EXTRA_SOURCES:
            raise ValueError(f"add_extra_convs={add_extra_convs!r}: one of "
                             f"{EXTRA_SOURCES}")
        self.extra_source = ("on_input" if add_extra_convs is True
                             else add_extra_convs)
        self.relu_before_extra_convs = relu_before_extra_convs
        self.lateral_convs = nn.ModuleList(
            ConvModule(self.in_channels[start_level + i], out_channels, 1,
                       padding=0, act=False) for i in range(n_used))
        convs = [ConvModule(out_channels, out_channels, 3, act=False)
                 for _ in range(min(n_used, num_outs))]
        for k in range(num_outs - n_used if self.extra_source else 0):
            cin = (self.in_channels[self.end - 1]
                   if k == 0 and self.extra_source == "on_input"
                   else out_channels)
            convs.append(ConvModule(cin, out_channels, 3, stride=2, act=False))
        self.fpn_convs = nn.ModuleList(convs)

    def init_weights(self, generator: torch.Generator) -> None:
        """Every conv flax's default (`lecun_normal_`), as the JAX FPN's."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m, generator)

    def forward(self, inputs):
        if len(inputs) != len(self.in_channels):
            raise ValueError(f"{len(inputs)} inputs for "
                             f"{len(self.in_channels)} in_channels")
        used = inputs[self.start_level:self.end]
        n_used = len(used)
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, used)]
        for i in range(n_used - 1, 0, -1):
            # half-pixel nearest, as jax.image.resize(method="nearest");
            # equal to mmdet's "nearest" at the integer factors FPN meets
            laterals[i - 1] = laterals[i - 1] + F.interpolate(
                laterals[i], size=laterals[i - 1].shape[-2:],
                mode="nearest-exact")
        n_out = min(n_used, self.num_outs)
        outs = [self.fpn_convs[i](laterals[i]) for i in range(n_out)]
        if not self.extra_source:
            # nn.max_pool(x, (1, 1), strides=(2, 2)) of the JAX FPN: VALID
            # padding keeps ceil(H / 2) rows, as [::2] does
            for _ in range(self.num_outs - n_used):
                outs.append(outs[-1][:, :, ::2, ::2])
            return tuple(outs)
        x = {"on_input": inputs[self.end - 1], "on_lateral": laterals[-1],
             "on_output": outs[-1]}[self.extra_source]
        for k in range(self.num_outs - n_used):
            if k > 0 and self.relu_before_extra_convs:
                x = torch.relu(x)
            x = self.fpn_convs[n_out + k](x)
            outs.append(x)
        return tuple(outs)
