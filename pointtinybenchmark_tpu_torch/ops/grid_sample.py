"""Bilinear sampling of NHWC feature maps at pixel-space points.

Counterpart of pointtinybenchmark_tpu/ops/grid_sample.py::point_sample_pixel
(`_bilinear_one`): a point (x, y) in feature-map pixel units, cell centres
at integer coordinates, samples between its four surrounding cells. It
serves the feature extraction of CPR's point bags ("border" padding) and
RepPoints' deformable gather ("zeros"). Plain PyTorch, as the JAX function
is plain XLA (no Pallas kernel): a four-corner gather in the JAX operation
order, so that values and gradients agree with it. With "border" padding
the point is first clamped into [0, W - 1] x [0, H - 1] (torch.maximum /
minimum, which split the gradient at a tie as JAX's clip does); with
"zeros" a corner outside the map gets weight 0 (its index clamped), so
the map reads as zero beyond its edge. The corners are rows of the
(N * H * W, C) map picked by `index_select`, whose backward adds into the
map with `index_add_` (on the card one atomic add per value; advanced
indexing's backward sorts the indices first, a tenth of a CPR train
step's device time).
"""
from __future__ import annotations

import torch

__all__ = ["point_sample_pixel"]


def point_sample_pixel(feat: torch.Tensor, points: torch.Tensor,
                       padding_mode: str = "border") -> torch.Tensor:
    """feat (N, H, W, C), points (N, P, 2) pixel coordinates (x, y) on the
    feature grid -> (N, P, C). `padding_mode` is "border" or "zeros"."""
    if padding_mode not in ("border", "zeros"):
        raise ValueError(f"padding_mode {padding_mode!r}")
    n, h, w, c = feat.shape
    x, y = points[..., 0], points[..., 1]
    if padding_mode == "border":
        zero = torch.zeros((), dtype=points.dtype, device=points.device)
        x = torch.minimum(torch.maximum(x, zero), zero + (w - 1.0))
        y = torch.minimum(torch.maximum(y, zero), zero + (h - 1.0))
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    x1 = x0 + 1.0
    y1 = y0 + 1.0
    wx1 = x - x0
    wy1 = y - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    flat = feat.reshape(n * h * w, c)
    base = torch.arange(n, device=feat.device)[:, None] * (h * w)

    def corner(yc, xc, wgt):
        if padding_mode == "zeros":
            inb = (xc >= 0) & (xc <= w - 1) & (yc >= 0) & (yc <= h - 1)
            wgt = torch.where(inb, wgt, 0.0)
        iyc = yc.clamp(0, h - 1).long()
        ixc = xc.clamp(0, w - 1).long()
        v = flat.index_select(0, (base + iyc * w + ixc).reshape(-1)).reshape(
            yc.shape + (c,))                                   # (N, P, C)
        return v * wgt[..., None]

    return (corner(y0, x0, wy0 * wx0) + corner(y0, x1, wy0 * wx1)
            + corner(y1, x0, wy1 * wx0) + corner(y1, x1, wy1 * wx1))
