"""BFP, Libra R-CNN's balanced feature pyramid, NCHW.

Counterpart of pointtinybenchmark_tpu/models/necks/extra_necks.py::BFP:
every level resized to the `refine_level`'s size, averaged, refined by one
3x3 convolution with a bias (`refine`, for refine_type "conv"), then
resized back to each level and added to it. The resize is JAX's
`jax.image.resize(..., "nearest")`: output index i reads input index
floor((i + 0.5) * in / out), computed in float32 as JAX computes it (half-
pixel centres; a 2x downsample reads 2i + 1, where torch's "nearest" reads
2i). The JAX package's `build_detector` cannot build a detector with
this neck (a list neck, which the port's `build_detector` refuses), so the
port builds it as a module only.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..utils import lecun_normal_

__all__ = ["BFP", "resize_nearest"]


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    pos = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) \
        * np.float32(n_in) / np.float32(n_out)
    return np.floor(pos).astype(np.int64)


def resize_nearest(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """x (B, C, H, W) -> (B, C, hw[0], hw[1]) by `jax.image.resize`'s
    nearest rule."""
    h, w = x.shape[-2:]
    if (h, w) == tuple(hw):
        return x
    if h != hw[0]:
        x = x.index_select(-2, torch.from_numpy(
            _nearest_index(h, hw[0])).to(x.device))
    if w != hw[1]:
        x = x.index_select(-1, torch.from_numpy(
            _nearest_index(w, hw[1])).to(x.device))
    return x


class BFP(nn.Module):

    def __init__(self, in_channels: int = 256, num_levels: int = 5,
                 refine_level: int = 2, refine_type: Optional[str] = "conv"):
        super().__init__()
        if refine_type not in (None, "conv"):
            raise NotImplementedError(
                f"BFP refine_type={refine_type!r} is not ported (the JAX BFP "
                f"builds no refinement for it)")
        self.num_levels = num_levels
        self.refine_level = refine_level
        self.refine = (nn.Conv2d(in_channels, in_channels, 3, padding=1)
                       if refine_type == "conv" else None)

    def init_weights(self, generator: torch.Generator) -> None:
        if self.refine is not None:
            lecun_normal_(self.refine, generator)

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, ...]:
        if len(feats) != self.num_levels:
            raise ValueError(f"BFP takes {self.num_levels} levels, got "
                             f"{len(feats)}")
        mid = tuple(feats[self.refine_level].shape[-2:])
        bsf = sum(resize_nearest(f, mid) for f in feats) / len(feats)
        if self.refine is not None:
            bsf = self.refine(bsf)
        return tuple(f + resize_nearest(bsf, tuple(f.shape[-2:]))
                     for f in feats)
