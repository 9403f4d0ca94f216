"""RoIAlign (mmcv semantics, static sampling ratio), NCHW.

Counterpart of pointtinybenchmark_tpu/ops/roi_align.py (`roi_align`,
`roi_align_multilevel`) and of its Pallas kernel
ops/roi_align_pallas.py::roi_align_multilevel_pallas. mmcv's adaptive
`sampling_ratio=0` is replaced by a static ratio, as in the JAX package.
Feature maps are (B, C, H, W) and outputs (R, C, S, S), mmdet's layout; the
JAX functions take NHWC and return (R, S, S, C), with the same values.

`roi_align_multilevel` is the public entry: rois on the CPU go to
`roi_align_multilevel_plain`, rois on a CUDA card to the hand-written kernel
(`roi_align_cuda.roi_align_forward`), any other device raises.

The plain versions follow the JAX code operation for operation: sample
points at `x1 + ((k // sr) + ((k % sr) + 0.5) / sr) * bin_w`, the in-bounds
test on the raw coordinate against [-1, W] / [-1, H], clamp to
[0, dim - 1], the upper tap at min(x0 + 1, dim - 1), the four taps summed in
one order, zero outside, then the mean over the sr x sr samples of a bin,
summed in row-major order. Two roundings follow what XLA compiles the JAX
code to, since one ulp of a sample coordinate moves a tap weight by ~4e-6
at 50 cells: the divisions by constants (`roi_w / S`, `/ sr`, the mean's
`/ sr**2`) are multiplications by the float32 reciprocal, and the sample
coordinate `x1 + frac * bin_w` is a fused multiply-add (`_fused_madd`).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from . import roi_align_cuda

__all__ = ["roi_align", "roi_align_multilevel", "roi_align_multilevel_plain",
           "sample_taps", "level_tables"]


def _fused_madd(a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor) -> torch.Tensor:
    """a * b + c in float32 with one rounding, as an FMA gives it: the
    float64 product of two float32 values is exact, and the float64 sum
    rounds to float32 as the FMA does (barring a double-rounding tie)."""
    return (a.double() * b.double() + c.double()).float()


def sample_taps(rois: torch.Tensor, scale: torch.Tensor, hf: torch.Tensor,
                wf: torch.Tensor, output_size: int, sampling_ratio: int,
                aligned: bool) -> Tuple[torch.Tensor, ...]:
    """Bilinear taps of every sample point of every roi.

    rois (R, 5); scale, hf, wf (R,) f32: 1 / stride and the level's H and
    W for each roi. Returns y0, y1, x0, x1 (R, S, S) int64 cell
    coordinates, the weights w00, w01, w10, w11 (R, S, S) and the in-bounds
    mask (R, S, S), with S = output_size * sampling_ratio; axis 1 runs over
    y samples and axis 2 over x samples."""
    r = rois.shape[0]
    out, sr = output_size, sampling_ratio
    offset = 0.5 if aligned else 0.0
    x1 = rois[:, 1] * scale - offset
    y1 = rois[:, 2] * scale - offset
    x2 = rois[:, 3] * scale - offset
    y2 = rois[:, 4] * scale - offset
    roi_w = x2 - x1
    roi_h = y2 - y1
    if not aligned:
        roi_w = roi_w.clamp(min=1.0)
        roi_h = roi_h.clamp(min=1.0)
    bin_w = roi_w * (1.0 / out)
    bin_h = roi_h * (1.0 / out)

    side = torch.arange(out * sr, dtype=rois.dtype, device=rois.device)
    frac = (torch.div(side, sr, rounding_mode="floor")
            + ((side % sr) + 0.5) * (1.0 / sr))
    sx = _fused_madd(frac[None, :], bin_w[:, None], x1[:, None])   # (R, S)
    sy = _fused_madd(frac[None, :], bin_h[:, None], y1[:, None])

    s = out * sr
    xg = sx[:, None, :].expand(r, s, s)
    yg = sy[:, :, None].expand(r, s, s)
    wf = wf[:, None, None]
    hf = hf[:, None, None]
    inb = (xg >= -1.0) & (xg <= wf) & (yg >= -1.0) & (yg <= hf)
    zero = xg.new_zeros(())
    xc = torch.minimum(torch.maximum(xg, zero), wf - 1.0)
    yc = torch.minimum(torch.maximum(yg, zero), hf - 1.0)
    x0 = torch.floor(xc)
    y0 = torch.floor(yc)
    x1i = torch.minimum(x0 + 1, wf - 1).long()
    y1i = torch.minimum(y0 + 1, hf - 1).long()
    wx1 = xc - x0
    wy1 = yc - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    return (y0.long(), y1i, x0.long(), x1i,
            wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1, inb)


def _pool(flat: torch.Tensor, base: torch.Tensor, width: torch.Tensor,
          taps, output_size: int, sampling_ratio: int) -> torch.Tensor:
    """Gather the taps from `flat` (rows of C channels; row of cell (y, x)
    of roi i at base[i] + y * width[i] + x), weight, mask, average over
    each bin's samples. Returns (R, C, S, S)."""
    y0, y1, x0, x1, w00, w01, w10, w11, inb = taps
    r, s = y0.shape[:2]
    c = flat.shape[1]
    out, sr = output_size, sampling_ratio
    base = base[:, None, None]
    width = width[:, None, None]

    def g(yi, xi):
        return flat[(base + yi * width + xi).reshape(-1)].reshape(r, s, s, c)

    val = (g(y0, x0) * w00[..., None] + g(y0, x1) * w01[..., None]
           + g(y1, x0) * w10[..., None] + g(y1, x1) * w11[..., None])
    val = torch.where(inb[..., None], val, 0.0)
    val = val.reshape(r, out, sr, out, sr, c)
    acc = val[:, :, 0, :, 0]
    for k in range(1, sr * sr):
        acc = acc + val[:, :, k // sr, :, k % sr]
    return (acc * (1.0 / (sr * sr))).permute(0, 3, 1, 2).contiguous()


def roi_align(feat: torch.Tensor, rois: torch.Tensor, spatial_scale: float,
              output_size: int = 7, sampling_ratio: int = 2,
              aligned: bool = True) -> torch.Tensor:
    """Single-level RoIAlign, plain PyTorch. feat (B, C, H, W); rois (R, 5)
    (batch_idx, x1, y1, x2, y2) in input-image coordinates. Returns
    (R, C, output_size, output_size)."""
    b, c, h, w = feat.shape
    r = rois.shape[0]
    flat = feat.permute(0, 2, 3, 1).reshape(b * h * w, c)
    full = rois.new_full((r,), 1.0)
    taps = sample_taps(rois, full * spatial_scale, full * h, full * w,
                       output_size, sampling_ratio, aligned)
    base = rois[:, 0].long() * (h * w)
    return _pool(flat, base, torch.full_like(base, w), taps, output_size,
                 sampling_ratio)


def level_tables(feats, rois, lvls, strides):
    """Per roi: 1 / stride, H, W (f32), the level's first row in the
    concatenated (B*H_l*W_l rows per level) buffer plus the batch offset,
    and W as an integer."""
    b = feats[0].shape[0]
    dev = rois.device
    lv = lvls.long()
    hs = torch.tensor([f.shape[2] for f in feats], device=dev)[lv]
    ws = torch.tensor([f.shape[3] for f in feats], device=dev)[lv]
    starts, total = [], 0
    for f in feats:
        starts.append(total)
        total += b * f.shape[2] * f.shape[3]
    scale = 1.0 / torch.tensor([float(s) for s in strides],
                               dtype=rois.dtype, device=dev)[lv]
    base = (torch.tensor(starts, device=dev)[lv]
            + rois[:, 0].long() * hs * ws)
    return scale, hs.to(rois.dtype), ws.to(rois.dtype), base, ws


def roi_align_multilevel_plain(feats: Sequence[torch.Tensor],
                               rois: torch.Tensor, lvls: torch.Tensor,
                               strides: Sequence[int], output_size: int = 7,
                               sampling_ratio: int = 2,
                               aligned: bool = True) -> torch.Tensor:
    """RoIAlign of each roi from its own level `lvls[i]`, plain PyTorch, on
    the tensors' device. feats: per-level (B, C, H_l, W_l); rois (R, 5);
    lvls (R,) integer. Returns (R, C, S, S)."""
    c = feats[0].shape[1]
    flat = torch.cat([f.permute(0, 2, 3, 1).reshape(-1, c) for f in feats])
    scale, hf, wf, base, width = level_tables(feats, rois, lvls, strides)
    taps = sample_taps(rois, scale, hf, wf, output_size, sampling_ratio,
                       aligned)
    return _pool(flat, base, width, taps, output_size, sampling_ratio)


def roi_align_multilevel(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                         lvls: torch.Tensor, strides: Sequence[int],
                         output_size: int = 7, sampling_ratio: int = 2,
                         aligned: bool = True) -> torch.Tensor:
    """Multilevel RoIAlign: the kernel for CUDA tensors, the plain version
    for CPU tensors. Same arguments as `roi_align_multilevel_plain`."""
    if rois.device.type == "cpu":
        return roi_align_multilevel_plain(feats, rois, lvls, strides,
                                          output_size, sampling_ratio,
                                          aligned)
    if rois.device.type == "cuda":
        return roi_align_cuda.roi_align_forward(feats, rois, lvls, strides,
                                                output_size, sampling_ratio,
                                                aligned)
    raise RuntimeError(f"no RoIAlign kernel for device {rois.device}")
