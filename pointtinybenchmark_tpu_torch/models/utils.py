"""Shared model building blocks and seeded initialisers."""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

__all__ = ["ConvModule", "bias_init_with_prob", "normal_init",
           "lecun_normal_", "he_normal_", "one_hot"]


def bias_init_with_prob(prior_prob: float) -> float:
    """Bias so sigmoid(bias) == prior_prob (RetinaNet focal init)."""
    return float(-math.log((1 - prior_prob) / prior_prob))


def one_hot(labels: torch.Tensor, c: int) -> torch.Tensor:
    """jax.nn.one_hot as float32: a label outside [0, c) gives a zero
    row."""
    return (labels.long()[..., None]
            == torch.arange(c, device=labels.device)).to(torch.float32)


def normal_init(m: nn.Conv2d, std: float, generator: torch.Generator,
                bias: float = 0.0) -> None:
    nn.init.normal_(m.weight, 0.0, std, generator=generator)
    if m.bias is not None:
        nn.init.constant_(m.bias, bias)


def _truncated_fan_in_(w: torch.Tensor, fan_in: int, scale: float,
                       generator: torch.Generator) -> None:
    """flax's variance_scaling(scale, "fan_in", "truncated_normal"): a
    normal of standard deviation sqrt(scale / fan_in) / 0.8796 truncated
    at two of them."""
    std = math.sqrt(scale / fan_in) / .87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


def lecun_normal_(m: nn.Module, generator: torch.Generator) -> None:
    """flax's default initialiser, which the JAX modules use wherever they
    set none: the kernel from a normal of standard deviation
    sqrt(1 / fan_in) / 0.8796 truncated at two of them (lecun_normal), the
    bias 0. fan_in is flax's, from the JAX kernel's layout: `in` for
    nn.Dense and kh * kw * in for nn.Conv and nn.ConvTranspose. The port's
    ConvTranspose2d weight is (in, out, kh, kw), on which torch's own fan
    calculation would count `out`."""
    w = m.weight
    if isinstance(m, nn.ConvTranspose2d):
        fan_in = w.shape[0] * w.shape[2] * w.shape[3]
    else:
        fan_in = w[0].numel()           # (out, in[, kh, kw])
    _truncated_fan_in_(w, fan_in, 1.0, generator)
    if m.bias is not None:
        nn.init.zeros_(m.bias)


def he_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax's he_normal on a conv weight (out, in / groups, kh, kw): the
    truncated normal of `lecun_normal_` at twice its variance, fan_in
    kh * kw * in / groups (the JAX kernel's (kh, kw, in / groups, out))."""
    _truncated_fan_in_(w, w[0].numel(), 2.0, generator)


class ConvModule(nn.Module):
    """conv -> (GroupNorm) -> (relu), NCHW; mmcv ConvModule names (`.conv`,
    `.gn`). Counterpart of pointtinybenchmark_tpu/models/utils.py::
    ConvModule without a norm or with GN: GroupNorm of `num_groups` groups,
    eps 1e-5, with an affine scale and bias; the conv has a bias only
    without a norm, as in the JAX module. BN, which no ported head uses,
    is not ported."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1,
                 norm: Optional[str] = None, num_groups: int = 32,
                 act: bool = True):
        super().__init__()
        if norm not in (None, "GN"):
            raise NotImplementedError(
                f"ConvModule norm={norm!r} is not ported")
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size,
                              stride=stride, padding=padding,
                              bias=norm is None)
        self.gn = (nn.GroupNorm(num_groups, out_channels, eps=1e-5)
                   if norm == "GN" else None)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.gn is not None:
            x = self.gn(x)
        return torch.relu(x) if self.act else x
