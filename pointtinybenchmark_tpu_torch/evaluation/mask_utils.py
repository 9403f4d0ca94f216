"""Mask paste and COCO RLE encoding, host numpy.

Counterpart of pointtinybenchmark_tpu/evaluation/mask_utils.py
(`paste_masks`, `rle_encode`, `_counts_to_string`), kept in this package so
that it imports nothing of the JAX package; the functions are the same
numpy code, so the port's masks and RLE strings equal the JAX package's bit
for bit. `paste_masks` resamples each (s, s) probability crop into its box
of the image, half-pixel aligned (mmdet FCNMaskHead._do_paste_mask,
grid_sample with align_corners=False), and thresholds it; `rle_encode`
writes pycocotools' compressed RLE (column-major run lengths starting with
a run of zeros, maskApi.c's rleToString).
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

__all__ = ["paste_masks", "rle_encode"]

RLE = Dict[str, object]  # {"size": [h, w], "counts": str}

# paste_masks: elements per gathered plane per chunk (~128 MB of f32 across
# the gathers and the patch); module-level so that a test can shrink it to
# force the multi-chunk path
_PASTE_CHUNK_BUDGET = 1 << 24


def _counts_to_string(cnts: Sequence[int]) -> str:
    """maskApi.c rleToString: delta + base-32 varint with 0x20 continuation."""
    out = []
    for i, c in enumerate(cnts):
        x = int(c)
        if i > 2:
            x -= int(cnts[i - 2])
        more = True
        while more:
            ch = x & 0x1F
            x >>= 5
            more = (x != -1) if (ch & 0x10) else (x != 0)
            if more:
                ch |= 0x20
            out.append(chr(ch + 48))
    return "".join(out)


def rle_encode(mask: np.ndarray) -> RLE:
    """Binary (H, W) mask -> compressed RLE dict."""
    h, w = mask.shape
    flat = np.asfortranarray(mask.astype(bool)).ravel(order="F")
    # run lengths, first run counts zeros (may be 0-length)
    if flat.size == 0:
        return {"size": [h, w], "counts": _counts_to_string([0])}
    change = np.nonzero(flat[1:] != flat[:-1])[0] + 1
    idx = np.concatenate([[0], change, [flat.size]])
    runs = np.diff(idx).tolist()
    if flat[0]:
        runs = [0] + runs
    return {"size": [h, w], "counts": _counts_to_string(runs)}


def paste_masks(crops: np.ndarray, boxes: np.ndarray, h: int, w: int,
                threshold: float = 0.5) -> np.ndarray:
    """Paste (M, s, s) probability crops into (M, H, W) binary masks.

    Half-pixel-aligned bilinear sampling over the box extent, matching
    mmdet FCNMaskHead._do_paste_mask (grid_sample align_corners=False).

    Batched over masks (pad-to-max patch) like the reference's batched
    torch `_do_paste_mask`, instead of a per-mask Python loop. The
    bilinear resample is separable, so it runs as a cheap row stage on
    the (n, hp, s) workspace followed by a column stage on the full
    (n, hp, wp) patch — two gathers over the big array instead of four.
    Masks are processed in chunks (sorted by patch area) so the padded
    workspace stays bounded even for frame-sized boxes.
    """
    M, s, _ = crops.shape
    out = np.zeros((M, h, w), np.uint8)
    if M == 0:
        return out
    b = np.asarray(boxes, np.float64)[:, :4]
    x1, y1, x2, y2 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    bx1 = np.maximum(np.floor(x1).astype(np.int64), 0)
    by1 = np.maximum(np.floor(y1).astype(np.int64), 0)
    bx2 = np.minimum(np.ceil(x2).astype(np.int64) + 1, w)
    by2 = np.minimum(np.ceil(y2).astype(np.int64) + 1, h)
    ok = (bx2 > bx1) & (by2 > by1) & (x2 > x1) & (y2 > y1)
    ph = np.where(ok, by2 - by1, 0)
    pw = np.where(ok, bx2 - bx1, 0)
    # Chunk by padded workspace size: sort by patch area so frame-sized
    # boxes don't inflate the pad-to-max of tiny ones.
    order = np.argsort(ph * pw, kind="stable")
    order = order[ok[order]]
    M = len(order)
    budget = _PASTE_CHUNK_BUDGET
    start = 0
    while start < M:
        hp = wp = 1
        end = start
        area = 0
        while end < M:
            i = order[end]
            nhp = max(hp, int(ph[i]))
            nwp = max(wp, int(pw[i]))
            narea = area + int(ph[i] * pw[i])
            padded = (end - start + 1) * nhp * nwp
            # Budget bounds the workspace; the 0.5 efficiency floor stops
            # pad-to-max waste from growing past 2x the useful pixels.
            if end > start and (padded > budget or narea < padded // 2):
                break
            hp, wp, area = nhp, nwp, narea
            end += 1
        idx = order[start:end]
        start = end
        if hp * wp == 0:
            continue
        n = len(idx)
        ry = np.arange(hp)
        rx = np.arange(wp)
        ys = ((by1[idx, None] + ry[None, :] + 0.5 - y1[idx, None])
              / np.maximum(y2[idx] - y1[idx], 1e-12)[:, None] * s - 0.5)
        xs = ((bx1[idx, None] + rx[None, :] + 0.5 - x1[idx, None])
              / np.maximum(x2[idx] - x1[idx], 1e-12)[:, None] * s - 0.5)
        y0 = np.clip(np.floor(ys).astype(np.int32), 0, s - 1)
        x0 = np.clip(np.floor(xs).astype(np.int32), 0, s - 1)
        y1i = np.minimum(y0 + 1, s - 1)
        x1i = np.minimum(x0 + 1, s - 1)
        wy = np.clip(ys - y0, 0.0, 1.0)[:, :, None]            # (n, hp, 1)
        wx = np.clip(xs - x0, 0.0, 1.0)[:, None, :]            # (n, 1, wp)
        c = crops[idx]                                         # (n, s, s)
        ii = np.arange(n)[:, None]
        # Row stage on the small (n, hp, s) workspace.
        ty = c[ii, y0] * (1 - wy) + c[ii, y1i] * wy            # (n, hp, s)
        # Column stage: only two gathers touch the full (n, hp, wp) patch.
        ii3 = ii[:, :, None]
        patch = (ty[ii3, ry[None, :, None], x0[:, None, :]] * (1 - wx)
                 + ty[ii3, ry[None, :, None], x1i[:, None, :]] * wx)
        hit = patch >= threshold
        for j, i in enumerate(idx):
            out[i, by1[i]:by2[i], bx1[i]:bx2[i]] = \
                hit[j, :ph[i], :pw[i]]
    return out
