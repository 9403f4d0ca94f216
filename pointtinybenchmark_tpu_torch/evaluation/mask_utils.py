"""Mask paste, COCO RLE and mask IoU, host numpy.

Counterpart of pointtinybenchmark_tpu/evaluation/mask_utils.py
(`paste_masks`, `rle_encode` / `rle_decode`, `rle_area`, `rle_to_bbox`,
`mask_iou`, `ann_to_rle`, `polys_to_mask`), kept in this package so that
it imports nothing of the JAX package; the functions are the same numpy
code, so the port's masks and RLE strings equal the JAX package's bit for
bit. `paste_masks` resamples each (s, s) probability crop into its box
of the image, half-pixel aligned (mmdet FCNMaskHead._do_paste_mask,
grid_sample with align_corners=False), and thresholds it; `rle_encode`
writes pycocotools' compressed RLE (column-major run lengths starting with
a run of zeros, maskApi.c's rleToString). `mask_iou` takes the native
run-length IoU (`evaluation/native.py`, which raises if it cannot be
built) or, with `native=False`, the numpy reference; polygons are
rasterized with PIL's scanline fill, gts and results alike.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np

__all__ = ["paste_masks", "rle_encode", "rle_decode", "rle_area",
           "rle_to_bbox", "mask_iou", "ann_to_rle", "polys_to_mask"]

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


def _string_to_counts(s: str) -> List[int]:
    """maskApi.c rleFrString."""
    cnts: List[int] = []
    p = 0
    while p < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return cnts


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


def _rle_counts(rle: RLE) -> List[int]:
    counts = rle["counts"]
    if isinstance(counts, bytes):
        counts = counts.decode()
    if isinstance(counts, str):
        return _string_to_counts(counts)
    return [int(c) for c in counts]


def rle_decode(rle: RLE) -> np.ndarray:
    """RLE dict -> binary (H, W) uint8 mask."""
    h, w = rle["size"]
    cnts = _rle_counts(rle)
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for c in cnts:
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape((w, h)).T  # column-major


def rle_area(rle: RLE) -> int:
    cnts = _rle_counts(rle)
    return int(sum(cnts[1::2]))


def rle_to_bbox(rle: RLE) -> List[float]:
    """[x, y, w, h] of the mask extent (maskApi rleToBbox)."""
    m = rle_decode(rle)
    ys, xs = np.nonzero(m)
    if len(xs) == 0:
        return [0.0, 0.0, 0.0, 0.0]
    x0, x1 = xs.min(), xs.max()
    y0, y1 = ys.min(), ys.max()
    return [float(x0), float(y0), float(x1 - x0 + 1), float(y1 - y0 + 1)]


def mask_iou(dt: List[RLE], gt: List[RLE], iscrowd: Sequence[int],
             native: bool = True) -> np.ndarray:
    """(D, G) IoU matrix; crowd gt columns use union = area(dt)
    (pycocotools maskUtils.iou semantics)."""
    D, G = len(dt), len(gt)
    if D == 0 or G == 0:
        return np.zeros((D, G))
    if native:
        from .native import rle_iou_native
        return rle_iou_native([_rle_counts(r) for r in dt],
                              [_rle_counts(r) for r in gt], list(iscrowd))
    dm = np.stack([rle_decode(r).astype(bool).ravel() for r in dt])  # (D,P)
    gm = np.stack([rle_decode(r).astype(bool).ravel() for r in gt])  # (G,P)
    inter = (dm.astype(np.float64) @ gm.T.astype(np.float64))        # (D,G)
    da = dm.sum(1).astype(np.float64)[:, None]
    ga = gm.sum(1).astype(np.float64)[None, :]
    crowd = np.asarray(iscrowd, bool)[None, :]
    union = np.where(crowd, da, da + ga - inter)
    return inter / np.maximum(union, 1e-10)


def polys_to_mask(polys: List[Sequence[float]], h: int, w: int) -> np.ndarray:
    """Flattened [x0,y0,x1,y1,...] polygon list -> (H, W) uint8 mask."""
    from PIL import Image, ImageDraw
    img = Image.new("L", (int(w), int(h)), 0)
    draw = ImageDraw.Draw(img)
    for poly in polys:
        if poly is None or len(poly) < 6:
            continue
        draw.polygon([float(v) for v in poly], fill=1)
    return np.asarray(img, np.uint8)


def ann_to_rle(segm: Union[RLE, List], h: int, w: int) -> RLE:
    """COCO `segmentation` field (polygons / uncompressed / compressed RLE)
    -> compressed RLE (pycocotools COCO.annToRLE)."""
    if isinstance(segm, dict):
        if isinstance(segm.get("counts"), (list, tuple)):
            return {"size": segm["size"],
                    "counts": _counts_to_string(list(segm["counts"]))}
        return segm
    # polygon list
    polys = segm if segm and isinstance(segm[0], (list, tuple)) else [segm]
    return rle_encode(polys_to_mask(polys, h, w))


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
