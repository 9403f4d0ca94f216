#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the kernels of ops/csrc with nvcc (one nvcc per source, started
together), then runs two main paths, the tiled TinyPerson protocol of Adap
RetinaNet-c and of Adap Faster R-CNN, each on two 1920x1080 uint8 frames:

1. kernel vs plain, NMS: the IoU-bitmask and greedy-reduce kernels against
   their plain PyTorch version on the card, on synthetic TinyPerson-like
   boxes: `batched_nms` at the per-tile shape (B=12, N=8,720) and the
   global-merge shape (B=2, N=12,000, class offsets), keep sets identical;
   then each kernel alone at every launch shape of both main paths
   (K1_SHAPES), kernel A's defined bits and kernel B's keep sets identical,
   with times, bounds and the walk's serial steps; and on box pairs whose
   IoU is the threshold or one of its float neighbours;
2. kernel vs plain, RoIAlign: the multilevel RoIAlign kernel against its
   plain version on synthetic channels-last FPN maps of 256 channels and
   TinyPerson-sized rois (plus large and off-edge ones, so that every level
   is hit), at the Faster R-CNN shape (24 tiles, R=24,000, S=7, sr=1) and
   the Mask R-CNN mask-crop shape (12 tiles, R=1,200, S=14, sr=2);
3. the RetinaNet slice at full width (ResNet-50, FPN-256, RetinaHead, built
   from its config with seeded weights) through `inference_detector_tiled`:
   launches counted from zero around it, NMS doing real work, sane boxes,
   the card's forward against the CPU's on one tile, detections equal to
   those with the plain NMS; then protocol and forward-only img/s and the
   NMS times, and a torch.profiler trace of warm protocol calls (idle share
   and device time by kernel family; Chrome trace in build/);
4. the Faster R-CNN slice at full width (ResNet-50, FPN-256 with max-pool
   P6, RPN, RoIAlign, 2-FC head, built from its config with seeded
   weights): the same checks (launches {iou_bitmask: 3, greedy_reduce: 3,
   roi_align: 1}; RPN, RoIAlign and both NMS stages doing work; backbone,
   neck, RPN and RoI-head outputs against the CPU on one tile; detections
   against those with every kernel swapped for its plain version), then
   img/s, the RoIAlign kernel on the slice's own rois and levels, and the
   profile.

Float32 throughout with TF32 off (cuDNN would otherwise run the convolutions
in TF32). Every failure raises; there is no CPU mode. The last line is
{"ok": true, "device": {...}}; the line before it is the card's name and
power limit, and the line before that lists each kernel with its launches on
the main paths, its error against the plain version, its time, the plain
version's time and its bound.
"""
import collections
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "configs/tinyperson/retinanet_r50_fpns4_1x_tinyperson640_clipg.py"
FRCNN_CONFIG = REPO / "configs/tinyperson/faster_rcnn_r50_fpn_1x_tinyperson640.py"
DEVICE = "cuda"
FRAME_HW = (1080, 1920)
N_FRAMES = 2
ITERS = 10
PLAIN_ITERS = 3
# (name, B, N, classes): the per-tile NMS of one frame and the global merge
NMS_SHAPES = (("per-tile", 12, 8720, 1), ("global", 2, 12000, 3))
# (name, B, N, classes, IoU threshold): the NMS kernel pair's launch shapes
# on both main paths, after the B=12 row of the kernels' first measurements
K1_SHAPES = (("per-tile B=12", 12, 8720, 1, 0.5),
             ("RetinaNet-c per-tile", 24, 8720, 1, 0.5),
             ("global merge", 2, 12000, 3, 0.5),
             ("Faster R-CNN RPN", 24, 7200, 5, 0.7),
             ("Faster R-CNN RoI head", 24, 1000, 1, 0.5))
MAX_OUT = 1000
# (name, tiles, rois, S, sr): the Faster R-CNN bbox extractor and the Mask
# R-CNN mask extractor the JAX bench runs on the Pallas kernel
ROI_SHAPES = (("faster_rcnn", 24, 24000, 7, 1), ("mask_rcnn", 12, 1200, 14, 2))
ROI_LEVELS = ((128, 160), (64, 80), (32, 40), (16, 20))   # 512x640 tiles
ROI_STRIDES = (4, 8, 16, 32)
ROI_CHANNELS = 256
FRCNN_LAUNCHES = {"iou_bitmask": 3, "greedy_reduce": 3, "roi_align": 1}
KERNELS = {
    "iou_bitmask": ("pointtinybenchmark_tpu_torch/ops/csrc/nms_kernel.cu",
                    "pointtinybenchmark_tpu/ops/pallas_kernels.py:55"),
    "greedy_reduce": ("pointtinybenchmark_tpu_torch/ops/csrc/nms_kernel.cu",
                      "pointtinybenchmark_tpu/ops/pallas_kernels.py:55"),
    "roi_align": ("pointtinybenchmark_tpu_torch/ops/csrc/roi_align_kernel.cu",
                  "pointtinybenchmark_tpu/ops/roi_align_pallas.py:359"),
}
# published H100 SXM peaks: HBM bytes/s and
# float32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# kernel A's f32 operations per pair: the overlap test, and the exact IoU
# of a pair that overlaps (iou_bitmask_work)
OVERLAP_OPS = 4
IOU_OPS = 15
PROFILE_CALLS = 5
# substrings of device kernel names, first match wins
KERNEL_FAMILIES = (
    ("iou_bitmask", "NMS kernel A iou_bitmask"),
    ("greedy_reduce", "NMS kernel B greedy_reduce"),
    ("roi_align", "RoIAlign kernel"),
    ("nhwctonchw", "cuDNN layout transpose"),
    ("nchwtonhwc", "cuDNN layout transpose"),
    ("memcpy", "memcpy"), ("memset", "memset"),
    ("batch_norm", "BN inference"), ("bn_", "BN inference"),
    ("fprop", "convolution"), ("conv", "convolution"), ("fft", "convolution"),
    ("winograd", "convolution"),
    ("gemm", "matrix product (cuBLAS)"), ("xmma", "convolution"),
    ("elementwise", "elementwise"), ("vectorized", "elementwise"))


def time_ms(fn, iters):
    """Mean ms per call on the current stream, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, flops):
    """(ms, what bounds it): the larger of bytes over the memory rate and
    float32 operations over the float32 rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def synthetic_boxes(rng, b, n, n_classes=1):
    """TinyPerson-like NMS input as numpy: 10-40 px boxes around cluster
    centres in a 640x512 tile (real suppression), scores on a 1e-3 grid
    (exact ties), ~5% invalid rows. Returns boxes (b, n, 4) f32, scores
    (b, n) f32, valid (b, n) bool, labels (b, n) int32."""
    n_clusters = max(n // 8, 1)
    centres = rng.rand(b, n_clusters, 2) * np.asarray([640.0, 512.0])
    pick = rng.randint(0, n_clusters, (b, n))
    c = np.take_along_axis(centres, pick[..., None], 1) + rng.randn(b, n, 2) * 6
    wh = rng.uniform(10, 40, (b, n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    scores = (rng.randint(0, 1000, (b, n)) / 1000.0).astype(np.float32)
    valid = rng.rand(b, n) > 0.05
    labels = rng.randint(0, n_classes, (b, n)).astype(np.int32)
    return boxes, scores, valid, labels


def threshold_tie_boxes(thr, per_target=4):
    """Box pairs whose float32 IoU, computed as ops/nms.py::_pairwise_iou
    does, is exactly thr or one of its two float neighbours: numpy (2P, 4)
    f32, pair p an outer box (row 2p) and an inner one (2p + 1) nested on
    the 1-px band y in [2p, 2p + 1], so that no two pairs overlap. With
    integer widths o > i below 2**24, inter = i and union = (o + i) - i in
    float32, which the search below repeats. Returns (boxes, iou (P,) f32)."""
    t = np.float32(thr)
    targets = (np.nextafter(t, np.float32(-1)), t,
               np.nextafter(t, np.float32(2)))
    outer = np.arange(12_000_000, 12_200_000, dtype=np.float32)
    pairs = []
    for target in targets:
        found = []
        for d in (-1, 0, 1):
            inner = np.rint(outer * t) + np.float32(d)
            iou = inner / ((outer + inner) - inner)
            hit = iou == target
            found += list(zip(outer[hit], inner[hit], iou[hit]))
        if len(found) < per_target:
            raise AssertionError(f"no IoU of {target!r} among the widths")
        pairs += found[:per_target]
    boxes = np.zeros((2 * len(pairs), 4), np.float32)
    for p, (o, i, _) in enumerate(pairs):
        boxes[2 * p] = (0, 2 * p, o, 2 * p + 1)
        boxes[2 * p + 1] = (0, 2 * p, i, 2 * p + 1)
    return boxes, np.asarray([q for *_, q in pairs], np.float32)


def synthetic_rois(rng, b, r, tile_hw=(512, 640)):
    """RoIAlign input as numpy (R, 5) f32 rows (tile, x1, y1, x2, y2):
    80% TinyPerson-sized (10-60 px sides), 20% log-uniform up to the tile
    (every FPN level gets rois), centres spread past the tile's edges by
    up to 40 px so that some rois hang off the map."""
    h, w = tile_hw
    big = rng.rand(r) < 0.2
    side = np.where(big[:, None], np.exp(rng.uniform(np.log(60), np.log(w),
                                                     (r, 2))),
                    rng.uniform(10, 60, (r, 2)))
    ctr = rng.uniform(-40, 40, (r, 2)) + rng.rand(r, 2) * [w, h]
    tiles = rng.randint(0, b, r)
    return np.concatenate([tiles[:, None], ctr - side / 2, ctr + side / 2],
                          1).astype(np.float32)


@contextlib.contextmanager
def plain_nms():
    """Inside this block ops/nms.py runs the plain versions of the two
    kernels, on whatever device its tensors are: the reference a kernel
    run is held against. The package itself has no such switch."""
    from pointtinybenchmark_tpu_torch.ops import nms_cuda

    saved = nms_cuda.iou_bitmask, nms_cuda.greedy_reduce
    nms_cuda.iou_bitmask = nms_cuda.iou_bitmask_plain
    nms_cuda.greedy_reduce = nms_cuda.greedy_reduce_plain
    try:
        yield
    finally:
        nms_cuda.iou_bitmask, nms_cuda.greedy_reduce = saved


@contextlib.contextmanager
def plain_roi_align():
    """Inside this block ops/roi_align.py runs the plain RoIAlign on CUDA
    tensors too, in place of the kernel."""
    from pointtinybenchmark_tpu_torch.ops import roi_align, roi_align_cuda

    saved = roi_align_cuda.roi_align_forward
    roi_align_cuda.roi_align_forward = roi_align.roi_align_multilevel_plain
    try:
        yield
    finally:
        roi_align_cuda.roi_align_forward = saved


def reset_launches():
    from pointtinybenchmark_tpu_torch.ops import nms_cuda, roi_align_cuda

    for counts in (nms_cuda.launches, roi_align_cuda.launches):
        for k in counts:
            counts[k] = 0


def read_launches():
    from pointtinybenchmark_tpu_torch.ops import nms_cuda, roi_align_cuda

    return {**nms_cuda.launches, **roi_align_cuda.launches}


def sorted_nms_inputs(boxes, scores, labels, valid):
    """What ops/nms.py::batched_nms hands the kernel pair: class-offset boxes
    sorted by masked score, ok, order (int32) and n_valid."""
    from pointtinybenchmark_tpu_torch.ops import nms

    masked = nms._masked_scores(scores, valid, float("-inf"))
    sboxes, ok, order, n_valid = nms._sort(nms._offset_boxes(boxes, labels),
                                           masked)
    return sboxes, ok, order.to(torch.int32), n_valid


def kept_rows(order, keep):
    """(B, max_out) sorted-order row of each kept box (-1 past num_kept)."""
    b, n = order.shape
    pos = torch.empty_like(order)
    pos.scatter_(1, order.long(), torch.arange(n, device=order.device,
                                               dtype=order.dtype).expand(b, n))
    row = torch.gather(pos, 1, keep.clamp(min=0).long())
    return torch.where(keep >= 0, row, -1)


def greedy_reduce_bytes(max_out, order, keep, n_valid):
    """Bytes the greedy walk needs on this data: from each kept row's mask,
    the words from its own up to the last valid one; ok, order of the valid
    rows, n_valid and the outputs once."""
    b = order.shape[0]
    row = kept_rows(order, keep)
    last_word = (n_valid.long()[:, None] + 63) // 64
    mask_words = int(((last_word - row // 64) * (row >= 0)).sum())
    return (8 * mask_words + int(n_valid.sum()) * (1 + 4)
            + 4 * b * max_out + 8 * b)


def overlapping_pairs(sboxes, n_valid):
    """Valid pairs i < j < n_valid whose boxes overlap, min(x2) > max(x1)
    and min(y2) > max(y1) (false with a NaN or an empty box), summed over
    the batch: the pairs whose bit needs the exact IoU on these inputs."""
    b, n, _ = sboxes.shape
    x1, y1, x2, y2 = sboxes.unbind(-1)
    dev = sboxes.device
    cols = torch.arange(n, device=dev)
    past = cols[None, None, :] < n_valid.long()[:, None, None]
    total = 0
    for r0 in range(0, n, 512):
        sl = slice(r0, min(r0 + 512, n))
        ov = ((torch.minimum(x2[:, sl, None], x2[:, None])
               > torch.maximum(x1[:, sl, None], x1[:, None]))
              & (torch.minimum(y2[:, sl, None], y2[:, None])
                 > torch.maximum(y1[:, sl, None], y1[:, None])))
        ov &= cols[None, None, :] > cols[sl][None, :, None]
        total += int((ov & past).sum())
    return total


def iou_bitmask_work(sboxes, n_valid):
    """(bytes, valid pairs above the diagonal, overlapping pairs among them)
    for kernel A on these inputs. The bytes: each valid box read once, each
    word the reduce can read (rows i < n_valid, words i // 64 up to the last
    valid one) written once. The operations: 4 f32 compares settle a pair
    that does not overlap (OVERLAP_OPS); one that overlaps takes the 15 f32
    operations of the exact IoU (IOU_OPS: 4 min/max, 2 differences, 2
    clamps, the product, union: add, subtract, max, the divide, the
    compare)."""
    nbytes, pairs = 0, 0
    for nv in n_valid.tolist():
        words = -(-nv // 64)
        nbytes += 16 * nv + 8 * sum(min(64, nv - 64 * k) * (words - k)
                                    for k in range(words))
        pairs += nv * (nv - 1) // 2
    return nbytes, pairs, overlapping_pairs(sboxes, n_valid)


def iou_bitmask_ops(pairs, overlaps):
    """f32 operations kernel A needs: the overlap test for every pair and
    the exact IoU for the overlapping ones."""
    return OVERLAP_OPS * pairs + IOU_OPS * overlaps


def reduce_steps(order, keep, num_kept, n_valid, max_out):
    """Serial steps (64-row blocks) of each walk: up to the block of the
    max_out-th kept row, else all valid rows."""
    last = kept_rows(order, keep)[:, -1]
    full = (n_valid.long() + 63) // 64
    return torch.where(num_kept >= max_out, last.long() // 64 + 1,
                       full).tolist()


def roi_align_bound(feats, rois, lvls, out, sr):
    """(ms, bounded by): the output written once, rois and levels read once,
    and every feature cell that an in-bounds tap reads, read once; 8 * sr^2
    float32 operations per output value (4 products and 3 sums per sample,
    the sample sum, the scale)."""
    from pointtinybenchmark_tpu_torch.ops import roi_align

    scale, hf, wf, base, width = roi_align.level_tables(feats, rois, lvls,
                                                        ROI_STRIDES)
    y0, y1, x0, x1, *_, inb = roi_align.sample_taps(rois, scale, hf, wf, out,
                                                    sr, True)
    base, width = base[:, None, None], width[:, None, None]
    cells = torch.cat([(base + yy * width + xx)[inb]
                       for yy, xx in ((y0, x0), (y0, x1), (y1, x0), (y1, x1))])
    r, c = rois.shape[0], feats[0].shape[1]
    nbytes = 4 * (r * c * out * out + torch.unique(cells).numel() * c
                  + r * 5 + r)
    return bound(nbytes, 8 * sr * sr * r * c * out * out)


def k1_row(card, name, sboxes, ok, order, n_valid, thr):
    """Each kernel of the pair alone against its plain version at one launch
    shape: kernel A's defined bits and kernel B's keep set must be equal.
    Returns {kernel: record} with times, bound and, for B, the walk's
    serial steps."""
    from pointtinybenchmark_tpu_torch.ops import nms_cuda

    b, n, _ = sboxes.shape
    mask = nms_cuda.iou_bitmask(sboxes, thr, n_valid)
    mask_plain = nms_cuda.iou_bitmask_plain(sboxes, thr)
    keep, num = nms_cuda.greedy_reduce(mask, ok, order, MAX_OUT, n_valid)
    keep_plain, num_plain = nms_cuda.greedy_reduce_plain(mask_plain, ok,
                                                         order, MAX_OUT)
    torch.cuda.synchronize()
    bits_err = float((nms_cuda.defined_words(mask, n_valid)
                      != nms_cuda.defined_words(mask_plain, n_valid)).sum())
    keep_err = float((keep - keep_plain).abs().max())
    if bits_err or keep_err or not torch.equal(num, num_plain):
        raise AssertionError(f"{name}: kernel vs plain: {bits_err} bitmask "
                             f"bits, keep {keep_err}")
    if int(num.min()) <= 0:
        raise AssertionError(f"{name}: NMS kept nothing")
    steps = reduce_steps(order, keep, num, n_valid, MAX_OUT)
    a_bytes, pairs, overlaps = iou_bitmask_work(sboxes, n_valid)
    times = {
        "iou_bitmask": (
            time_ms(lambda: nms_cuda.iou_bitmask(sboxes, thr, n_valid), ITERS),
            time_ms(lambda: nms_cuda.iou_bitmask_plain(sboxes, thr),
                    PLAIN_ITERS), bits_err,
            bound(a_bytes, iou_bitmask_ops(pairs, overlaps))),
        "greedy_reduce": (
            time_ms(lambda: nms_cuda.greedy_reduce(mask, ok, order, MAX_OUT,
                                                   n_valid), ITERS),
            time_ms(lambda: nms_cuda.greedy_reduce_plain(mask_plain, ok, order,
                                                         MAX_OUT),
                    PLAIN_ITERS), keep_err,
            bound(greedy_reduce_bytes(MAX_OUT, order, keep, n_valid), 0))}
    nv = n_valid.tolist()
    print(f"phase 1 {name} B={b} N={n} thr={thr}: n_valid {min(nv)}..{max(nv)},"
          f" kept {int(num.min())}..{int(num.max())} (kernel == plain: "
          f"defined bits and keep sets)")
    out = {}
    for k, (kms, pms, err, (bms, by)) in times.items():
        rec = dict(shape=name, B=b, N=n, thr=thr, max_abs_err=err, ms=kms,
                   plain_ms=pms, bound_ms=bms, bound_by=by)
        extra = ""
        if k == "iou_bitmask":
            # the bound of the first measurements, comparable with their
            # rows: the exact IoU for every valid pair
            all_ms = bound(a_bytes, IOU_OPS * pairs)[0]
            rec.update(pairs=pairs, overlapping_pairs=overlaps,
                       bound_ms_15_ops_per_pair=all_ms)
            extra = (f", {overlaps} of {pairs} pairs overlap; bound with "
                     f"{IOU_OPS} operations for every pair {all_ms:.4f} ms, "
                     f"share {all_ms / kms:.3f}")
        if k == "greedy_reduce":
            rec.update(steps=max(steps), ns_per_step=kms * 1e6 / max(steps))
            extra = (f", {max(steps)} serial steps per walk (64 rows each), "
                     f"{rec['ns_per_step']:.1f} ns per step")
        print(f"phase 1 {k} {name}: kernel {kms:.4f} ms, plain {pms:.4f} ms, "
              f"bound {bms:.4f} ms ({by}), share of bound "
              f"{bms / kms:.3f}{extra} [{card}]")
        out[k] = rec
    return out


def phase_kernels(card):
    from pointtinybenchmark_tpu_torch.ops import nms, nms_cuda

    rng = np.random.RandomState(0)
    for name, b, n, n_classes in NMS_SHAPES:
        boxes, scores, valid, labels = (
            torch.from_numpy(x).to(DEVICE)
            for x in synthetic_boxes(rng, b, n, n_classes))

        def run():
            return nms.batched_nms(boxes, scores, labels, 0.5, MAX_OUT,
                                   valid_mask=valid)
        got = run()
        with plain_nms():
            want = run()
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"{name}: kernel keep set differs from plain")
        kept = got[1].tolist()
        print(f"phase 1 {name} B={b} N={n}: valid {valid.sum(1).tolist()}, "
              f"kept {kept} (kernel == plain, exact)")
        if not all(0 < k for k in kept):
            raise AssertionError(f"{name}: NMS kept nothing")
        ms = time_ms(run, ITERS)
        with plain_nms():
            plain_ms = time_ms(run, PLAIN_ITERS)
        print(f"phase 1 {name} NMS: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
              f" [{card}]")

    # each kernel alone at every launch shape of the main paths
    rows = []
    for name, b, n, n_classes, thr in K1_SHAPES:
        boxes, scores, valid, labels = (
            torch.from_numpy(x).to(DEVICE)
            for x in synthetic_boxes(rng, b, n, n_classes))
        rows.append(k1_row(card, name, *sorted_nms_inputs(
            boxes, scores, labels, valid), thr))

    # kernel A at the first shape on boxes of which no two overlap: the
    # branch-free overlap test alone, without the exact IoU of close pairs
    _, b, n, _, thr = K1_SHAPES[0]
    i = torch.arange(n, dtype=torch.float32, device=DEVICE)
    x, y = (i % 128) * 50, torch.div(i, 128, rounding_mode="floor") * 50
    apart = torch.stack([x, y, x + 10, y + 10], -1).expand(b, n, 4).contiguous()
    every = torch.full((b,), n, dtype=torch.int32, device=DEVICE)
    if nms_cuda.defined_words(nms_cuda.iou_bitmask(apart, thr, every),
                              every).any():
        raise AssertionError("boxes apart: a suppression bit is set")
    ms = time_ms(lambda: nms_cuda.iou_bitmask(apart, thr, every), ITERS)
    a_bytes, pairs, overlaps = iou_bitmask_work(apart, every)
    if overlaps:
        raise AssertionError(f"boxes apart: {overlaps} pairs overlap")
    bms, by = bound(a_bytes, iou_bitmask_ops(pairs, overlaps))
    rows[0]["iou_bitmask"]["ms_no_overlap"] = ms
    print(f"phase 1 iou_bitmask B={b} N={n}, no two boxes overlapping: kernel "
          f"{ms:.4f} ms, bound {bms:.4f} ms ({by}) [{card}]")

    # IoUs on the threshold and its float neighbours
    for thr in (0.5, 0.7):
        tie, iou = threshold_tie_boxes(thr)
        tie = torch.from_numpy(tie)[None].to(DEVICE)
        every = torch.tensor([tie.shape[1]], dtype=torch.int32, device=DEVICE)
        got = nms_cuda.defined_words(nms_cuda.iou_bitmask(tie, thr, every),
                                     every)
        want = nms_cuda.defined_words(nms_cuda.iou_bitmask_plain(tie, thr),
                                      every)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"threshold ties at {thr}: kernel != plain")
        print(f"phase 1 threshold ties at {thr}: {len(iou)} pairs with IoU "
              f"{np.unique(iou).tolist()}, kernel bits == plain bits")

    # the JSON line keeps the B=12 row, comparable with earlier measurements
    return {k: dict(rows[0][k], by_shape=[r[k] for r in rows])
            for k in ("iou_bitmask", "greedy_reduce")}


def compare_roi_align(feats, rois, lvls, out, sr):
    """Kernel vs plain on the same inputs: (kernel out, max abs err, bit
    exact). Fails beyond 1e-5 * max|feat|."""
    from pointtinybenchmark_tpu_torch.ops import roi_align, roi_align_cuda

    got = roi_align_cuda.roi_align_forward(feats, rois, lvls, ROI_STRIDES,
                                           out, sr)
    want = roi_align.roi_align_multilevel_plain(feats, rois, lvls,
                                                ROI_STRIDES, out, sr)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tol = 1e-5 * max(float(f.abs().max()) for f in feats)
    if not err <= tol:
        raise AssertionError(f"RoIAlign kernel vs plain: {err} > {tol}")
    return got, err, torch.equal(got, want)


def time_roi_align(feats, rois, lvls, out, sr):
    from pointtinybenchmark_tpu_torch.ops import roi_align, roi_align_cuda

    ms = time_ms(lambda: roi_align_cuda.roi_align_forward(
        feats, rois, lvls, ROI_STRIDES, out, sr), ITERS)
    plain_ms = time_ms(lambda: roi_align.roi_align_multilevel_plain(
        feats, rois, lvls, ROI_STRIDES, out, sr), PLAIN_ITERS)
    return ms, plain_ms


def phase_roi_align(card):
    from pointtinybenchmark_tpu_torch.models.roi_heads.roi_extractor import \
        map_roi_levels

    rng = np.random.RandomState(2)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    for name, b, r, out, sr in ROI_SHAPES:
        # channels-last maps, as the FPN's convolutions leave them
        feats = [torch.randn((b, h, w, ROI_CHANNELS), generator=gen,
                             device=DEVICE).permute(0, 3, 1, 2)
                 for h, w in ROI_LEVELS]
        rois = torch.from_numpy(synthetic_rois(rng, b, r)).to(DEVICE)
        lvls = map_roi_levels(rois, len(ROI_LEVELS))
        per_level = torch.bincount(lvls, minlength=len(ROI_LEVELS)).tolist()
        if min(per_level) == 0:
            raise AssertionError(f"{name}: a level got no roi: {per_level}")
        got, err, exact = compare_roi_align(feats, rois, lvls, out, sr)
        ms, plain_ms = time_roi_align(feats, rois, lvls, out, sr)
        bms, by = roi_align_bound(feats, rois, lvls, out, sr)
        print(f"phase 2 RoIAlign {name} R={r} S={out} sr={sr} C={ROI_CHANNELS}"
              f" ({b} tiles, rois per level {per_level}): out "
              f"{tuple(got.shape)}, max_abs_err {err} (bit-exact: {exact}); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bms:.4f} ms ({by}) [{card}]")


def check_frames(results, label):
    h, w = FRAME_HW
    for i, r in enumerate(results):
        bb = r["bboxes"]
        n = bb.shape[0]
        print(f"{label} frame {i}: {n} boxes kept by the global merge")
        if not 1 <= n <= 1000 or bb.shape != (n, 5):
            raise AssertionError(f"frame {i}: {bb.shape} detections")
        if not (np.isfinite(bb).all() and (bb[:, 0] >= 0).all()
                and (bb[:, 1] >= 0).all() and (bb[:, 2] <= w).all()
                and (bb[:, 3] <= h).all()):
            raise AssertionError(f"frame {i}: boxes outside the frame")


def rel_err(got, ref):
    return max(float((g.cpu() - r).abs().max() / r.abs().max())
               for g, r in zip(got, ref))


def phase_slice(card, frames):
    from pointtinybenchmark_tpu_torch.apis.inference import (
        inference_detector_tiled, init_detector)
    from pointtinybenchmark_tpu_torch.core.post_processing import \
        multiclass_nms

    handle = init_detector(str(CONFIG), device=DEVICE, seed=0)
    model = handle.model
    head = model.bbox_head
    # The focal prior (retina_cls.bias = log(0.01/0.99)) keeps every score of
    # random weights at or below ~0.02, under score_thr 0.05: NMS would get
    # no candidate at all. A zero bias puts scores near 0.5.
    with torch.no_grad():
        head.retina_cls.bias.zero_()
    print("phase 3: retina_cls.bias set to 0 so that candidates pass "
          "score_thr (with the focal prior no score of random weights does)")

    torch.backends.cudnn.deterministic = True   # the two runs must match bit for bit
    reset_launches()
    results = inference_detector_tiled(handle, list(frames))
    launches = read_launches()
    print(f"phase 3 launches on the RetinaNet path: {launches}")
    if launches != {"iou_bitmask": 2, "greedy_reduce": 2, "roi_align": 0}:
        raise AssertionError(f"expected one per-tile and one global launch of "
                             f"each NMS kernel, got {launches}")
    with plain_nms():
        results_plain = inference_detector_tiled(handle, list(frames))
    torch.backends.cudnn.deterministic = False
    check_frames(results, "phase 3")
    for i, (r, p) in enumerate(zip(results, results_plain)):
        if not (np.array_equal(r["bboxes"], p["bboxes"])
                and np.array_equal(r["labels"], p["labels"])):
            raise AssertionError(f"frame {i}: kernel and plain NMS disagree")
    print("phase 3: detections with the kernels == detections with plain NMS")

    eng = next(iter(handle.tiled_engines.values()))
    tiles = eng.pre(frames)
    img_shapes = torch.tensor([eng.pre.tile_hw], dtype=torch.int32,
                              device=DEVICE).expand(tiles.shape[0], 2)
    cfg = head.test_cfg
    score_thr = float(cfg["score_thr"])
    nms_args = (score_thr, float(cfg["nms"]["iou_threshold"]),
                int(cfg["max_per_img"]))
    with torch.no_grad():
        cls_outs, reg_outs = model(tiles)
        boxes, scores = head.candidates(cls_outs, reg_outs, img_shapes)
        dets = multiclass_nms(boxes, scores, *nms_args)
    cands = (scores[..., :-1] > score_thr).sum((1, 2)).tolist()
    kept = dets.valid.sum(1).tolist()
    print(f"phase 3 per-tile NMS input: {boxes.shape[1]} candidates per tile, "
          f"valid {cands}")
    print(f"phase 3 per-tile NMS kept: {kept}")
    if min(cands) <= 0 or min(kept) <= 0:
        raise AssertionError("NMS got no work")

    # the card's forward against the CPU forward on one tile
    cpu_model = init_detector(str(CONFIG), device="cpu", seed=0).model
    with torch.no_grad():
        cpu_model.bbox_head.retina_cls.bias.zero_()
        ref = cpu_model(tiles[:1].cpu())
    err = rel_err([g[:1] for g in cls_outs + reg_outs], ref[0] + ref[1])
    print(f"phase 3 forward, card vs CPU on one tile: max rel err {err:.3e}")
    if err > 1e-4:
        raise AssertionError(f"card forward differs from CPU: {err}")
    return launches, handle, tiles, (boxes, scores, nms_args, dets, eng)


def phase_timing(card, handle, frames, tiles, stage):
    from pointtinybenchmark_tpu_torch.core.post_processing import \
        multiclass_nms

    boxes, scores, nms_args, dets, eng = stage
    protocol, forward = throughput(handle, frames, tiles)
    v = eng.pre.n_views
    m = dets.bboxes.shape[1]

    def per_tile():
        return multiclass_nms(boxes, scores, *nms_args)

    def merge():
        return eng.merge(dets)
    tile_ms, merge_ms = time_ms(per_tile, ITERS), time_ms(merge, ITERS)
    with plain_nms():
        tile_plain, merge_plain = (time_ms(per_tile, PLAIN_ITERS),
                                   time_ms(merge, PLAIN_ITERS))
    print(f"phase 3 protocol ({N_FRAMES} frames of {v} tiles, host in the "
          f"loop): {protocol:.4f} img/s [{card}]")
    print(f"phase 3 forward only ({tiles.shape[0]} tiles, f32, TF32 off): "
          f"{forward:.4f} img/s [{card}]")
    print(f"phase 3 per-tile NMS (multiclass_nms, B={tiles.shape[0]}, "
          f"N={boxes.shape[1]}): kernel {tile_ms:.4f} ms, plain "
          f"{tile_plain:.4f} ms [{card}]")
    print(f"phase 3 global merge (engine merge: shift + batched_nms, "
          f"B={N_FRAMES}, N={v * m}): kernel {merge_ms:.4f} ms, plain "
          f"{merge_plain:.4f} ms [{card}]")


def throughput(handle, frames, tiles):
    """(protocol img/s with the host in the loop, forward-only img/s)."""
    from pointtinybenchmark_tpu_torch.apis.inference import \
        inference_detector_tiled

    frame_list = list(frames)
    inference_detector_tiled(handle, frame_list)
    t0 = time.perf_counter()
    for _ in range(ITERS):
        inference_detector_tiled(handle, frame_list)
    protocol = N_FRAMES * ITERS / (time.perf_counter() - t0)
    with torch.no_grad():
        handle.model(tiles)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            handle.model(tiles)
        torch.cuda.synchronize()
        forward = N_FRAMES * ITERS / (time.perf_counter() - t0)
    return protocol, forward


def phase_frcnn(card, frames):
    from pointtinybenchmark_tpu_torch.apis.inference import (
        inference_detector_tiled, init_detector)
    from pointtinybenchmark_tpu_torch.models.roi_heads.roi_extractor import \
        map_roi_levels

    handle = init_detector(str(FRCNN_CONFIG), device=DEVICE, seed=0)
    model = handle.model
    torch.backends.cudnn.deterministic = True   # the two runs must match bit for bit
    reset_launches()
    results = inference_detector_tiled(handle, list(frames))
    launches = read_launches()
    print(f"phase 4 launches on the Faster R-CNN path: {launches}")
    if launches != FRCNN_LAUNCHES:
        raise AssertionError(f"expected {FRCNN_LAUNCHES}, got {launches}")
    check_frames(results, "phase 4")

    # the stages of one call, kept for the work checks and the timings
    eng = next(iter(handle.tiled_engines.values()))
    tiles = eng.pre(frames)
    b = tiles.shape[0]
    img_shapes = torch.tensor([eng.pre.tile_hw], dtype=torch.int32,
                              device=DEVICE).expand(b, 2)
    rpn_cfg = model.rpn_head.test_cfg
    with torch.no_grad():
        feats = model.extract_feat(tiles)
        rpn_outs = model.rpn_head(feats)
        props, prop_scores, valid = model.rpn_head.get_proposals(
            *rpn_outs, img_shapes, rpn_cfg)
        dets = model.roi_head.simple_test(feats, props, valid, img_shapes)
    n_cands = sum(min(int(rpn_cfg["nms_pre"]), c[0].numel())
                  for c in rpn_outs[0])
    sig = torch.cat([c.flatten(1) for c in rpn_outs[0]], 1).sigmoid()
    print(f"phase 4 RPN: {n_cands} candidates per tile, objectness "
          f"{float(sig.min()):.4f}..{float(sig.max()):.4f}; proposals kept "
          f"per tile {valid.sum(1).min().item()}..{valid.sum(1).max().item()}")
    rois = torch.cat([torch.arange(b, dtype=props.dtype, device=DEVICE)
                      .repeat_interleave(props.shape[1])[:, None],
                      props.reshape(-1, 4)], 1)
    lvls = map_roi_levels(rois, len(ROI_STRIDES))
    per_level = torch.bincount(lvls, minlength=len(ROI_STRIDES)).tolist()
    kept = dets.valid.sum(1)
    scores = dets.bboxes[..., 4][dets.valid]
    print(f"phase 4 RoIAlign: {rois.shape[0]} rois, per level {per_level}; "
          f"RoI-head NMS kept per tile {kept.min().item()}..{kept.max().item()}"
          f", scores {float(scores.min()):.4f}..{float(scores.max()):.4f}")
    if valid.sum(1).min() <= 0 or kept.min() <= 0:
        raise AssertionError("an NMS stage got no work")

    # the RoIAlign kernel on the slice's own levels and rois
    k_feats = list(feats[:len(ROI_STRIDES)])
    _, k2_err, k2_exact = compare_roi_align(k_feats, rois, lvls, 7, 1)
    print(f"phase 4 RoIAlign kernel vs plain on the slice's rois: max_abs_err "
          f"{k2_err} (bit-exact: {k2_exact})")

    with plain_nms(), plain_roi_align():
        results_plain = inference_detector_tiled(handle, list(frames))
    torch.backends.cudnn.deterministic = False
    for i, (r, p) in enumerate(zip(results, results_plain)):
        rb, pb = r["bboxes"], p["bboxes"]
        same = (np.array_equal(rb, pb)
                and np.array_equal(r["labels"], p["labels"]))
        close = (not k2_exact and rb.shape == pb.shape
                 and np.array_equal(r["labels"], p["labels"])
                 and np.allclose(rb[:, :4], pb[:, :4], atol=2e-3, rtol=0)
                 and np.allclose(rb[:, 4], pb[:, 4], atol=1e-4, rtol=0))
        if not (same or close):
            raise AssertionError(f"frame {i}: kernels and plain disagree")
    print(f"phase 4: detections with the kernels "
          f"{'==' if k2_exact else 'match (box atol 2e-3, score atol 1e-4)'} "
          f"detections with every kernel swapped for its plain version")

    # the card against the CPU on one tile: backbone, neck, RPN, and the RoI
    # head on the card's own proposals of that tile
    cpu_model = init_detector(str(FRCNN_CONFIG), device="cpu", seed=0).model
    with torch.no_grad():
        t0 = tiles[:1]
        c_back = cpu_model.backbone(t0.cpu().permute(0, 3, 1, 2))
        g_back = model.backbone(t0.permute(0, 3, 1, 2))
        c_feats = cpu_model.neck(c_back)
        c_rpn = cpu_model.rpn_head(c_feats)
        c_roi = cpu_model.roi_head(c_feats, props[:1].cpu())
        g_roi = model.roi_head([f[:1] for f in feats], props[:1])
    errs = {"backbone": rel_err(g_back, c_back),
            "neck": rel_err([f[:1] for f in feats], c_feats),
            "rpn": rel_err([o[:1] for o in rpn_outs[0] + rpn_outs[1]],
                           c_rpn[0] + c_rpn[1]),
            "roi_head": rel_err(g_roi, c_roi)}
    print("phase 4 card vs CPU on one tile, max rel err: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    if max(errs.values()) > 1e-4:
        raise AssertionError(f"card differs from CPU: {errs}")

    protocol, forward = throughput(handle, frames, tiles)
    ms, plain_ms = time_roi_align(k_feats, rois, lvls, 7, 1)
    bms, by = roi_align_bound(k_feats, rois, lvls, 7, 1)
    print(f"phase 4 protocol ({N_FRAMES} frames of {eng.pre.n_views} tiles, "
          f"host in the loop): {protocol:.4f} img/s [{card}]")
    print(f"phase 4 forward only (whole network incl. proposals, RoI head and "
          f"per-tile NMS, {b} tiles, f32, TF32 off): {forward:.4f} img/s "
          f"[{card}]")
    print(f"phase 4 RoIAlign in the slice (R={rois.shape[0]}, S=7, sr=1): "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms "
          f"({by}) [{card}]")
    record = dict(max_abs_err=k2_err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                  bound_by=by)
    return launches, handle, record


def _busy_us(events):
    """Length of the union of the events' [ts, ts + dur) intervals, in us."""
    busy, cur = 0.0, None
    for s, e in sorted((ev["ts"], ev["ts"] + ev["dur"]) for ev in events):
        if cur is not None and s <= cur[1]:
            cur[1] = max(cur[1], e)
        else:
            busy += cur[1] - cur[0] if cur is not None else 0.0
            cur = [s, e]
    return busy + (cur[1] - cur[0] if cur is not None else 0.0)


def phase_profile(card, handle, frames, label):
    from torch.profiler import ProfilerActivity, profile

    from pointtinybenchmark_tpu_torch.apis.inference import \
        inference_detector_tiled

    frame_list = list(frames)
    inference_detector_tiled(handle, frame_list)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_CALLS):
            inference_detector_tiled(handle, frame_list)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_CALLS
    trace = REPO / "build" / f"protocol_trace_{label}.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              and "dur" in e]
    if not events:
        raise AssertionError("the profiler traced no device activity")
    busy_ms = _busy_us(events) / 1e3 / PROFILE_CALLS
    family, by_name, count = (collections.Counter() for _ in range(3))
    for e in events:
        low = e["name"].lower()
        family[next((f for key, f in KERNEL_FAMILIES if key in low),
                    "rest")] += e["dur"]
        by_name[e["name"][:90]] += e["dur"]
        count[e["name"][:90]] += 1
    print(f"profile {label} ({PROFILE_CALLS} warm protocol calls of "
          f"{N_FRAMES} frames, profiler on, trace {trace}): per call wall "
          f"{wall_ms:.4f} ms, device busy {busy_ms:.4f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.4f} [{card}]")
    print(f"profile {label} device ms per call by family (share of busy):")
    for name, us in family.most_common():
        ms = us / 1e3 / PROFILE_CALLS
        print(f"  {name:28s} {ms:10.4f} ms  {ms / busy_ms:.4f}")
    print(f"profile {label} top kernels (ms per call, launches per call):")
    for name, us in by_name.most_common(15):
        print(f"  {us / 1e3 / PROFILE_CALLS:9.4f}  "
              f"{count[name] / PROFILE_CALLS:6.1f}  {name}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs on a CUDA card only")
    from pointtinybenchmark_tpu_torch.ops import (cuda_build, nms_cuda,
                                                  roi_align_cuda)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    t0 = time.perf_counter()
    cuda_build.compile_sources([nms_cuda.SOURCE, roi_align_cuda.SOURCE])
    nms_cuda.build_library()
    roi_align_cuda.build_library()
    print(f"kernel build (nvcc, sm_90a, both sources in parallel) + load: "
          f"{time.perf_counter() - t0:.2f} s")
    for log in sorted(cuda_build.BUILD_DIR.glob("*.log")):
        print(log.read_text().strip())

    records = phase_kernels(card)
    phase_roi_align(card)
    frames = np.random.RandomState(1).randint(
        0, 256, (N_FRAMES,) + FRAME_HW + (3,), np.uint8)
    retina_launches, handle, tiles, stage = phase_slice(card, frames)
    phase_timing(card, handle, frames, tiles, stage)
    phase_profile(card, handle, frames, "retinanet")
    del handle, tiles, stage
    torch.cuda.empty_cache()
    frcnn_launches, handle, records["roi_align"] = phase_frcnn(card, frames)
    phase_profile(card, handle, frames, "faster_rcnn")

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=KERNELS[name][0],
             replaces=KERNELS[name][1],
             launches=retina_launches[name] + frcnn_launches[name],
             launches_by_path={"adap_retinanet_c": retina_launches[name],
                               "faster_rcnn": frcnn_launches[name]},
             library_ms=None, **records[name])
        for name in KERNELS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
