#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the kernels of ops/csrc with nvcc (one nvcc per source, started
together), then runs six main paths, the tiled protocol of Adap
RetinaNet-c, Adap Faster R-CNN and COCO Mask R-CNN, each on two 1920x1080
uint8 frames, and the training of Adap Faster R-CNN, Adap RetinaNet-c and
COCO Mask R-CNN:

1. kernel vs plain, NMS: the IoU-bitmask and greedy-reduce kernels against
   their plain PyTorch version on the card, on synthetic TinyPerson-like
   boxes: `batched_nms` at the per-tile shape (B=12, N=8,720) and the
   global-merge shape (B=2, N=12,000, class offsets), keep sets identical;
   then each kernel alone at every launch shape of both main paths
   (K1_SHAPES), kernel A's defined bits and kernel B's keep sets identical,
   with times, bounds and the walk's serial steps; and on box pairs whose
   IoU is the threshold or one of its float neighbours, also moved right by
   the largest class offset of an 80-class NMS;
2. kernel vs plain, RoIAlign: the multilevel RoIAlign kernel against its
   plain version, bit for bit (torch.equal), on synthetic channels-last FPN
   maps of 256 channels and TinyPerson-sized rois of many tiles in shuffled
   order (plus large ones, so that every level is hit, and `edge_rois`: a
   whole-tile roi and 1:8 rois at level 0, whose windows exceed the
   kernel's shared-memory budget, zero-area, inverted and off-edge rois),
   at the Faster R-CNN shape (24 tiles, R=24,000, S=7, sr=1), the Mask
   R-CNN mask-crop shape (12 tiles, R=1,200, S=14, sr=2) and its bbox shape
   (24 tiles, R=24,000, S=7, sr=2): the rois on each kernel path, times in
   the shuffled order and in tile-major order (the order of the main path's
   rois), bound, ps per sample and channel;
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
   equal to those with every kernel swapped for its plain version), the
   RoIAlign kernel bit for bit against its plain version on the slice's own
   rois and levels (rois per level, rois per kernel path, whether the
   wrapper's channels-last view of each FPN map copied it), then img/s, the
   kernel's time on those rois, and the profile;
5. the Mask R-CNN slice at full width (configs/coco/mask_rcnn_r50_fpn_1x_
   coco.py: Faster R-CNN's network with 80 classes, RoIAlign S=7 sr=2, and
   the FCN mask head on S=14 sr=2 crops of every detection slot), with
   fc_cls.bias raised on 8 classes so that random weights detect: launches
   {iou_bitmask: 3, greedy_reduce: 3, roi_align: 2}, candidates and
   detections in every tile, the RoIAlign kernel bit for bit against its
   plain version on the slice's bbox and mask rois, detections and mask
   probabilities of `simple_test` and the merged detections equal to those
   with every kernel swapped for its plain version, the card against the
   CPU on one tile (mask head included), `run_test` with `DetCollator` on
   two 800x1333 COCO-preprocessed frames (RLE masks in the 1080x1920
   frame), then img/s, the mask head's share, the host paste and RLE time,
   and the profile;
6. training: (a) the RoIAlign backward kernel against the plain backward
   (autograd through the plain forward) on channels-last 256-channel maps
   of two 512x640 images at Faster R-CNN training's rois (R=1,024, S=7,
   sr=1) and Mask R-CNN training's (R=1,024, S=7, sr=2; R=256, S=14,
   sr=2, on uniform and on `clustered_rois`), on `edge_rois`, and rois out
   of range (which add nothing): error against BWD_TOL, the rois on each
   kernel path (the kernel's own counts), call times, bound, and the
   kernel's and the zero fill's device time from a profile taken after
   every other timing of the run; (b) Adap Faster R-CNN built from its
   config with seeded weights through `train_detector` for 20 iterations on
   4 synthetic 512x640 images with 20-60 TinyPerson-like gts each: launches
   per step {iou_bitmask: 1, greedy_reduce: 1, roi_align: 1,
   roi_align_backward: 1}, every loss finite, positives in both stages, the
   frozen stem and layer1 bit-identical and every other parameter changed;
   (c) one step with the kernels against one with the plain RoIAlign
   (forward and backward) from the same weights and draws: equal losses,
   gradients within GRAD_TOL; (d) the card against the CPU on one step
   (both samplers taking every candidate, the CPU fed the card's
   proposals, which must equal those of the plain NMS on the same RPN
   outputs): losses within LOSS_TOL; (e) train-step ms and img/s, the K2
   forward and backward on the step's own rois and their share, the peak
   memory above what the earlier phases hold; (f) a profile of warm steps,
   then the backward's device time on the step's rois, whose inputs go to
   STEP_BACKWARD for time_backward.py;
7. Adap RetinaNet-c training (the clipg config at full width: ResNet-50
   with frozen_stages=1, FPN-256 from stride 4, RetinaHead with 4 stacked
   convs and 9 anchors, focal loss, grad_clip max_norm 1) with seeded
   weights: (a) `train_detector` for 20 iterations on 4 synthetic 512x640
   images: launches per step {0, 0, 0, 0} (the path has no NMS and no
   RoIAlign, so it runs none of the port's kernels), finite losses,
   positives in every step, the frozen stem and layer1 bit-identical and
   every other parameter changed; (b) the card against the CPU on one
   step: float32 losses within LOSS_TOL, and in float64 each gradient
   within GRAD_TOL of its parameter's max (float32 rounding alone moves
   the full-width network's gradients by ~6e-3 of that, printed); (c)
   train-step ms, img/s, peak memory; (d) a profile of warm steps (idle
   share, device ms by family);
8. COCO Mask R-CNN training (configs/coco/mask_rcnn_r50_fpn_1x_coco.py at
   full width with its train_cfg, samples_per_gpu 2) with seeded weights on
   synthetic 800x1333 images padded to 32, 5-30 objects of COCO-like sizes
   each with an elliptical bitmask, 80 classes: (a) `train_detector`:
   launches per step {iou_bitmask: 1, greedy_reduce: 1, roi_align: 2,
   roi_align_backward: 2}, finite losses (loss_mask included), positives in
   both stages, frozen parameters unchanged, the rest changed; (b) one step
   with the kernels against one with the plain RoIAlign from the same
   weights and draws: equal losses, gradients within GRAD_TOL; (c) on that
   step's own launches: K2 forward torch.equal and backward within BWD_TOL
   of their plain versions on the bbox rois (S=7, sr=2) and the mask rois
   (S=14, sr=2), rois per kernel path, times and bounds, and K1 alone at
   the step's RPN NMS; (d) the card against the CPU on one step of one
   smaller image (MASK_CPU_HW; fewer proposals, both samplers taking every
   candidate, the CPU fed the card's proposals, which must equal the plain
   NMS's): losses within LOSS_TOL; (e) train-step ms, img/s, peak memory;
   (f) a profile of warm steps and the backward's device time on the
   step's rois.

Float32 throughout with TF32 off (cuDNN would otherwise run the convolutions
in TF32). Every failure raises; there is no CPU mode. The last line is
{"ok": true, "device": {...}}; the line before it is the card's name and
power limit, and the line before that lists each kernel with its launches on
the main paths, its error against the plain version, its time, the plain
version's time and its bound (`by_shape`: K1 at every launch shape and
the Mask R-CNN train step's RPN NMS; for RoIAlign the phase-2 shapes, the
slices' rois and the train steps' rois; for its backward the phase-6
shapes and the train steps' rois; `ms` is whole wrapper calls
between CUDA events, as for every kernel, and the backward adds
`device_ms`, its kernel's and zero fill's device time from a profile).
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
MASK_CONFIG = REPO / "configs/coco/mask_rcnn_r50_fpn_1x_coco.py"
DEVICE = "cuda"
FRAME_HW = (1080, 1920)
COCO_HW = (800, 1333)            # mmdet's COCO test scale, (h, w)
N_FRAMES = 2
ITERS = 10
PLAIN_ITERS = 3
# (name, B, N, classes): the per-tile NMS of one frame and the global merge
NMS_SHAPES = (("per-tile", 12, 8720, 1), ("global", 2, 12000, 3))
# (name, B, N, classes, IoU threshold): the NMS kernel pair's launch shapes
# on the main paths, after the B=12 row of the kernels' first measurements;
# Mask R-CNN's RoI head hands NMS 1,000 proposals x 80 classes capped at
# multiclass_nms's pre_nms_limit of 20,000, its merge 12 tiles x 100
K1_SHAPES = (("per-tile B=12", 12, 8720, 1, 0.5),
             ("RetinaNet-c per-tile", 24, 8720, 1, 0.5),
             ("global merge", 2, 12000, 3, 0.5),
             ("Faster R-CNN RPN", 24, 7200, 5, 0.7),
             ("Faster R-CNN RoI head", 24, 1000, 1, 0.5),
             ("Faster R-CNN train RPN", 1, 7200, 5, 0.7),
             ("Mask R-CNN RPN", 24, 4200, 5, 0.7),
             ("Mask R-CNN RoI head", 24, 20000, 80, 0.5),
             ("Mask R-CNN merge", 2, 1200, 80, 0.5))
# class 79's coordinate offset on a 640-px tile (ops/nms.py::_offset_boxes)
OFFSET_80_CLASSES = 79 * 641
MAX_OUT = 1000
# (name, tiles, rois, S, sr): the Faster R-CNN bbox extractor, the Mask
# R-CNN mask extractor the JAX bench runs on the Pallas kernel, and the Mask
# R-CNN bbox extractor (sampling_ratio 0 becomes 2)
ROI_SHAPES = (("faster_rcnn", 24, 24000, 7, 1), ("mask_rcnn", 12, 1200, 14, 2),
              ("mask_rcnn bbox", 24, 24000, 7, 2))
ROI_LEVELS = ((128, 160), (64, 80), (32, 40), (16, 20))   # 512x640 tiles
ROI_STRIDES = (4, 8, 16, 32)
ROI_CHANNELS = 256
RETINA_LAUNCHES = {"iou_bitmask": 2, "greedy_reduce": 2, "roi_align": 0,
                   "roi_align_backward": 0}
FRCNN_LAUNCHES = {"iou_bitmask": 3, "greedy_reduce": 3, "roi_align": 1,
                  "roi_align_backward": 0}
MASK_LAUNCHES = {"iou_bitmask": 3, "greedy_reduce": 3, "roi_align": 2,
                 "roi_align_backward": 0}
# phase 6: a train step of Faster R-CNN launches each kernel once (the RPN's
# proposal NMS, RoIAlign of the sampled rois and its backward)
TRAIN_LAUNCHES = {"iou_bitmask": 1, "greedy_reduce": 1, "roi_align": 1,
                  "roi_align_backward": 1}
TRAIN_HW = (512, 640)            # the config's loader pad_shape
TRAIN_IMAGES = 4
TRAIN_EPOCHS = 5                 # 20 iterations at samples_per_gpu=1
TRAIN_TIMED_STEPS = 10
TRAIN_PROFILE_STEPS = 5
# phase 7: RetinaNet-c training runs no TPU kernel (no NMS, no RoIAlign)
RETINA_TRAIN_LAUNCHES = {"iou_bitmask": 0, "greedy_reduce": 0,
                         "roi_align": 0, "roi_align_backward": 0}
# phase 8: a Mask R-CNN train step launches K1 once (the RPN's proposal
# NMS), K2 forward and backward twice (the bbox rois, S=7 sr=2, and the
# mask rois, S=14 sr=2)
MASK_TRAIN_LAUNCHES = {"iou_bitmask": 1, "greedy_reduce": 1, "roi_align": 2,
                       "roi_align_backward": 2}
MASK_TRAIN_IMAGES = 4
MASK_TRAIN_EPOCHS = 5            # 10 iterations at samples_per_gpu=2
# objects an image and their sides in px (log-uniform, COCO's small to
# large), 80 classes
COCO_OBJECTS = (5, 30)
COCO_SIDES = (10.0, 400.0)
# phase 8 (d), the card against the CPU: one image at this size (padded to
# 32), at most this many gts, rpn_proposal max_per_img this many
MASK_CPU_HW = (400, 667)
MASK_CPU_GTS = 32
MASK_CPU_PROPOSALS = 100
# (name, images, rois, S, sr, roi set): the K2 backward at Faster R-CNN
# training's rois (512 an image), Mask R-CNN training's bbox rois and its
# mask rois (128 positives an image; standard_roi_head.py:207-219), on
# `synthetic_rois` and, at the mask shape, on `clustered_rois` too
BWD_SHAPES = (("faster_rcnn train", 2, 1024, 7, 1, "uniform"),
              ("mask_rcnn train bbox", 2, 1024, 7, 2, "uniform"),
              ("mask_rcnn train mask", 2, 256, 14, 2, "uniform"),
              ("mask_rcnn train mask clustered", 2, 256, 14, 2, "clustered"))
# warm backward calls traced for its device time
BWD_PROFILE_CALLS = 20
# the train step's backward inputs (g, rois, levels, shapes, S, sr), saved
# by phase 6 (e) for time_backward.py
STEP_BACKWARD = REPO / "build" / "train_step_backward.pt"
# the K2 backward's bar against its plain version: float atomics sum in no
# fixed order, so each level within this share of its max |gradient|
BWD_TOL = 1e-5
# a train step with the kernels against one with the plain RoIAlign: each
# parameter's gradient within this share of its max |gradient| (the
# backward's sums run in another order); the card against the CPU: losses
# within this relative error
GRAD_TOL = 1e-4
LOSS_TOL = 1e-4
PRE_NMS_LIMIT = 20000            # multiclass_nms's default cap
# fc_cls.bias raised on the first classes so that some softmax scores of
# random weights clear score_thr 0.05 (81 logits near 0 give ~1/81 each;
# +3 on 8 classes gives ~0.086 each)
MASK_BIAS = (8, 3.0)
# host paste + RLE: detections of bench.py's bench_mask (fixed 10-20 px
# boxes in a 1080x1920 frame, 28x28 crops), repetitions
PASTE_DETS = 100
PASTE_REPS = 5
KERNELS = {
    "iou_bitmask": ("pointtinybenchmark_tpu_torch/ops/csrc/nms_kernel.cu",
                    "pointtinybenchmark_tpu/ops/pallas_kernels.py:55"),
    "greedy_reduce": ("pointtinybenchmark_tpu_torch/ops/csrc/nms_kernel.cu",
                      "pointtinybenchmark_tpu/ops/pallas_kernels.py:55"),
    "roi_align": ("pointtinybenchmark_tpu_torch/ops/csrc/roi_align_kernel.cu",
                  "pointtinybenchmark_tpu/ops/roi_align_pallas.py:359"),
    "roi_align_backward": (
        "pointtinybenchmark_tpu_torch/ops/csrc/roi_align_kernel.cu",
        "pointtinybenchmark_tpu/ops/roi_align_pallas.py:376"),
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
# substrings of device kernel names, first match wins; cuDNN runs some
# convolutions through FFTs (complex GEMMs and products), a convolution's
# data gradient as dgrad (in inference: the mask head's transposed
# convolution) and its weight gradient as wgrad; the optimizer's _foreach
# updates run as multi_tensor_apply kernels
KERNEL_FAMILIES = (
    ("iou_bitmask", "NMS kernel A iou_bitmask"),
    ("greedy_reduce", "NMS kernel B greedy_reduce"),
    ("roi_align_backward", "RoIAlign backward kernel"),
    ("roi_align", "RoIAlign kernel"),
    ("cf32", "convolution by FFT"), ("complex", "convolution by FFT"),
    ("fft", "convolution by FFT"),
    ("dgrad", "convolution dgrad (data gradient)"),
    ("wgrad", "convolution wgrad (weight gradient)"),
    ("multi_tensor_apply", "optimizer (foreach elementwise)"),
    ("sort", "sort"),
    ("nhwctonchw", "cuDNN layout transpose"),
    ("nchwtonhwc", "cuDNN layout transpose"),
    ("memcpy", "memcpy"), ("memset", "memset"),
    ("batch_norm", "BN inference"), ("bn_", "BN inference"),
    ("fprop", "convolution"), ("conv", "convolution"),
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


def threshold_tie_boxes(thr, per_target=4, x_offset=0):
    """Box pairs whose float32 IoU, computed as ops/nms.py::_pairwise_iou
    does, is exactly thr or one of its two float neighbours: numpy (2P, 4)
    f32, pair p an outer box (row 2p) and an inner one (2p + 1) nested on
    the 1-px band y in [2p, 2p + 1], so that no two pairs overlap. With
    integer widths o > i below 2**24, inter = i and union = (o + i) - i in
    float32, which the search below repeats. An integer `x_offset` (a class
    offset of ops/nms.py::_offset_boxes, such as 79 classes of a 640-px
    tile) moves every box right; the coordinates stay below 2**24, so the
    IoUs stay. Returns (boxes, iou (P,) f32)."""
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
        boxes[2 * p] = (x_offset, 2 * p, o + x_offset, 2 * p + 1)
        boxes[2 * p + 1] = (x_offset, 2 * p, i + x_offset, 2 * p + 1)
    if boxes[:, 2].max() >= 2 ** 24:
        raise ValueError(f"x_offset {x_offset}: coordinates reach 2**24")
    return boxes, np.asarray([q for *_, q in pairs], np.float32)


def edge_rois(b, tile_hw=(512, 640)):
    """RoIAlign rows that stress the kernel's paths, as numpy (13 b, 5) f32,
    13 per tile: the whole tile (level 3 of `map_roi_levels`), 1:8 and 8:1
    rois at level 0 (24 x 192 px: windows over the shared-memory budget), a
    zero-area and an inverted roi, rois hanging off each edge and two
    corners, and two wholly outside the map."""
    h, w = tile_hw
    rows = ((0, 0, w, h), (10, 10, 34, 202), (100, 20, 292, 44),
            (50, 50, 50, 50), (80, 90, 40, 30),
            (-30, 100, 40, 160), (w - 40, 100, w + 30, 160),
            (100, -30, 160, 40), (100, h - 40, 160, h + 30),
            (-50, -50, 20, 20), (w - 20, h - 20, w + 50, h + 50),
            (-300, -200, -100, -50), (w + 10, h + 10, w + 90, h + 60))
    return np.asarray([(i, *row) for i in range(b) for row in rows],
                      np.float32)


def phase2_rois(rng, b, r):
    """R rois of b tiles in shuffled order: `edge_rois` and the rest
    `synthetic_rois`, as a (R, 5) f32 numpy array."""
    edge = edge_rois(b)
    rois = np.concatenate([edge, synthetic_rois(rng, b, r - len(edge))])
    return rois[rng.permutation(r)]


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


def box_iou_rows(a, b):
    """IoU of each row of a with the same row of b, numpy (n, 4) each."""
    wh = np.clip(np.minimum(a[:, 2:], b[:, 2:]) - np.maximum(a[:, :2],
                                                            b[:, :2]), 0, None)
    inter = wh[:, 0] * wh[:, 1]
    area = lambda x: (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])
    return inter / (area(a) + area(b) - inter)


def clustered_rois(rng, b, per_image, hw=None):
    """Sampled positive rois, as numpy (b * per_image, 5) f32 rows (image,
    x1, y1, x2, y2): per image, 20-60 TinyPerson-like gts (`train_samples`'
    kind: 10-40 px boxes in clusters) and `per_image` rois jittered around
    them to an IoU of at least 0.5 with their gt, as the RoI head's
    sampler takes them, so that rois pile onto the same cells."""
    h, w = hw or TRAIN_HW
    out = []
    for i in range(b):
        k = rng.randint(20, 61)
        boxes, _, valid, _ = synthetic_boxes(rng, 1, 2 * k)
        gts = np.clip(boxes[0][valid[0]][:k], 0, [w, h, w, h])
        kept, n = [], 0
        while n < per_image:
            gt = gts[rng.randint(0, len(gts), per_image)]
            size = gt[:, 2:] - gt[:, :2]
            ctr = (gt[:, :2] + gt[:, 2:]) / 2 \
                + rng.uniform(-0.15, 0.15, size.shape) * size
            side = size * np.exp(rng.uniform(-0.25, 0.25, size.shape))
            cand = np.concatenate([ctr - side / 2, ctr + side / 2], 1)
            kept.append(cand[box_iou_rows(cand, gt) >= 0.5])
            n += len(kept[-1])
        rois = np.concatenate(kept)[:per_image]
        out.append(np.concatenate([np.full((per_image, 1), i), rois], 1))
    return np.concatenate(out).astype(np.float32)


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
    tensors too, in place of the kernels: the plain forward, and autograd
    through it in place of the backward kernel."""
    from pointtinybenchmark_tpu_torch.ops import roi_align, roi_align_cuda

    saved = roi_align_cuda.roi_align_forward, roi_align_cuda.roi_align_backward
    roi_align_cuda.roi_align_forward = roi_align.roi_align_multilevel_plain
    roi_align_cuda.roi_align_backward = roi_align.roi_align_backward_plain
    try:
        yield
    finally:
        (roi_align_cuda.roi_align_forward,
         roi_align_cuda.roi_align_backward) = saved


@contextlib.contextmanager
def nms_shapes(shapes):
    """Inside this block each NMS bitmask launch appends the (B, N) of its
    boxes to `shapes`, and then launches as it would."""
    from pointtinybenchmark_tpu_torch.ops import nms_cuda

    saved = nms_cuda.iou_bitmask

    def record(boxes, *args, **kwargs):
        shapes.append(tuple(boxes.shape[:2]))
        return saved(boxes, *args, **kwargs)
    nms_cuda.iou_bitmask = record
    try:
        yield
    finally:
        nms_cuda.iou_bitmask = saved


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


def k1_row(card, name, sboxes, ok, order, n_valid, thr, phase="1"):
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
    print(f"phase {phase} {name} B={b} N={n} thr={thr}: n_valid "
          f"{min(nv)}..{max(nv)},"
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
        print(f"phase {phase} {k} {name}: kernel {kms:.4f} ms, plain "
              f"{pms:.4f} ms, "
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

    # IoUs on the threshold and its float neighbours, also moved by the
    # largest class offset of Mask R-CNN's 80-class NMS
    for thr, x_offset in ((0.5, 0), (0.7, 0), (0.5, OFFSET_80_CLASSES),
                          (0.7, OFFSET_80_CLASSES)):
        tie, iou = threshold_tie_boxes(thr, x_offset=x_offset)
        tie = torch.from_numpy(tie)[None].to(DEVICE)
        every = torch.tensor([tie.shape[1]], dtype=torch.int32, device=DEVICE)
        got = nms_cuda.defined_words(nms_cuda.iou_bitmask(tie, thr, every),
                                     every)
        want = nms_cuda.defined_words(nms_cuda.iou_bitmask_plain(tie, thr),
                                      every)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"threshold ties at {thr}, x offset "
                                 f"{x_offset}: kernel != plain")
        print(f"phase 1 threshold ties at {thr}, x offset {x_offset}: "
              f"{len(iou)} pairs with IoU {np.unique(iou).tolist()}, kernel "
              f"bits == plain bits")

    # the JSON line keeps the B=12 row, comparable with earlier measurements
    return {k: dict(rows[0][k], by_shape=[r[k] for r in rows])
            for k in ("iou_bitmask", "greedy_reduce")}


def compare_roi_align(feats, rois, lvls, out, sr):
    """Kernel vs plain on the same inputs: (kernel out, max abs err). Fails
    unless the two are equal (torch.equal)."""
    from pointtinybenchmark_tpu_torch.ops import roi_align, roi_align_cuda

    got = roi_align_cuda.roi_align_forward(feats, rois, lvls, ROI_STRIDES,
                                           out, sr)
    want = roi_align.roi_align_multilevel_plain(feats, rois, lvls,
                                                ROI_STRIDES, out, sr)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"RoIAlign kernel != plain: max abs err {err}")
    return got, err


def roi_paths(feats, rois, lvls, out, sr):
    """{kernel path: rois that take it} for these inputs, from the kernel's
    own counts (one launch, outside any counted run)."""
    from pointtinybenchmark_tpu_torch.ops import roi_align_cuda

    counts = torch.zeros(len(roi_align_cuda.PATHS), dtype=torch.int32,
                         device=rois.device)
    roi_align_cuda.roi_align_forward(feats, rois, lvls, ROI_STRIDES, out, sr,
                                     path_counts=counts)
    return dict(zip(roi_align_cuda.PATHS, counts.tolist()))


def shares(counts):
    """'path n (share of all)' for each path of a `roi_paths` dict."""
    total = max(sum(counts.values()), 1)
    return ", ".join(f"{k} {v} ({v / total:.4f})" for k, v in counts.items())


def ps_per_sample(ms, feats, r, out, sr):
    """Kernel time per bilinear sample and channel, in picoseconds: the time
    over R S^2 sr^2 C."""
    return ms * 1e9 / (r * out * out * sr * sr * feats[0].shape[1])


def time_roi_align(feats, rois, lvls, out, sr):
    from pointtinybenchmark_tpu_torch.ops import roi_align, roi_align_cuda

    ms = time_ms(lambda: roi_align_cuda.roi_align_forward(
        feats, rois, lvls, ROI_STRIDES, out, sr), ITERS)
    plain_ms = time_ms(lambda: roi_align.roi_align_multilevel_plain(
        feats, rois, lvls, ROI_STRIDES, out, sr), PLAIN_ITERS)
    return ms, plain_ms


def phase_roi_align(card):
    """Returns one record per ROI_SHAPES row."""
    from pointtinybenchmark_tpu_torch.models.roi_heads.roi_extractor import \
        map_roi_levels
    from pointtinybenchmark_tpu_torch.ops import roi_align_cuda

    rng = np.random.RandomState(2)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    records = []
    for name, b, r, out, sr in ROI_SHAPES:
        # channels-last maps, as the FPN's convolutions leave them
        feats = [torch.randn((b, h, w, ROI_CHANNELS), generator=gen,
                             device=DEVICE).permute(0, 3, 1, 2)
                 for h, w in ROI_LEVELS]
        rois = torch.from_numpy(phase2_rois(rng, b, r)).to(DEVICE)
        lvls = map_roi_levels(rois, len(ROI_LEVELS))
        per_level = torch.bincount(lvls, minlength=len(ROI_LEVELS)).tolist()
        if min(per_level) == 0:
            raise AssertionError(f"{name}: a level got no roi: {per_level}")
        got, err = compare_roi_align(feats, rois, lvls, out, sr)
        paths = roi_paths(feats, rois, lvls, out, sr)
        edge = torch.from_numpy(edge_rois(b)).to(DEVICE)
        edge_lvls = map_roi_levels(edge, len(ROI_LEVELS))
        edge_paths = roi_paths(feats, edge, edge_lvls, out, sr)
        ms, plain_ms = time_roi_align(feats, rois, lvls, out, sr)
        order = torch.argsort(rois[:, 0], stable=True)
        rois_tm, lvls_tm = rois[order], lvls[order]
        ms_tile_major = time_ms(lambda: roi_align_cuda.roi_align_forward(
            feats, rois_tm, lvls_tm, ROI_STRIDES, out, sr), ITERS)
        bms, by = roi_align_bound(feats, rois, lvls, out, sr)
        ps = ps_per_sample(ms, feats, r, out, sr)
        print(f"phase 2 RoIAlign {name} R={r} S={out} sr={sr} C={ROI_CHANNELS}"
              f" ({b} tiles in shuffled order, rois per level {per_level}): "
              f"out {tuple(got.shape)}, kernel == plain (torch.equal)")
        print(f"phase 2 RoIAlign {name} kernel paths: {shares(paths)}; of "
              f"the {edge.shape[0]} edge rois among them: {shares(edge_paths)}")
        print(f"phase 2 RoIAlign {name}: kernel {ms:.4f} ms (shuffled), "
              f"{ms_tile_major:.4f} ms (tile-major), plain {plain_ms:.4f} ms, "
              f"bound {bms:.4f} ms ({by}); {ps:.4f} ps per sample and "
              f"channel [{card}]")
        records.append(dict(shape=name, R=r, S=out, sr=sr, max_abs_err=err,
                            ms=ms, ms_tile_major=ms_tile_major,
                            plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                            ps_per_sample=ps, paths=paths))
    return records


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
    if launches != RETINA_LAUNCHES:
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
    rois = slice_rois(props)
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
    _, k2_err = compare_roi_align(k_feats, rois, lvls, 7, 1)
    paths = roi_paths(k_feats, rois, lvls, 7, 1)
    # the wrapper's (B, H, W, C) view of a channels-last map is the map
    copied = [i for i, f in enumerate(k_feats)
              if f.permute(0, 2, 3, 1).contiguous().data_ptr() != f.data_ptr()]
    print(f"phase 4 RoIAlign kernel == plain (torch.equal) on the slice's "
          f"rois; kernel paths: {shares(paths)}; FPN maps the wrapper "
          f"copies: {copied or 'none'}")

    with plain_nms(), plain_roi_align():
        results_plain = inference_detector_tiled(handle, list(frames))
    torch.backends.cudnn.deterministic = False
    for i, (r, p) in enumerate(zip(results, results_plain)):
        if not (np.array_equal(r["bboxes"], p["bboxes"])
                and np.array_equal(r["labels"], p["labels"])):
            raise AssertionError(f"frame {i}: kernels and plain disagree")
    print("phase 4: detections with the kernels == detections with every "
          "kernel swapped for its plain version")

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
    record = dict(shape="faster_rcnn slice", R=rois.shape[0], S=7, sr=1,
                  max_abs_err=k2_err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                  bound_by=by, paths=paths, maps_copied=len(copied))
    return launches, handle, record


def lift_scores(model):
    """Raise fc_cls.bias on MASK_BIAS's first classes (see there)."""
    n, value = MASK_BIAS
    with torch.no_grad():
        model.roi_head.bbox_head.fc_cls.bias[:n] += value


def slice_rois(boxes):
    """(B, P, 4) boxes -> (B * P, 5) rois, image-major, as the RoI head
    builds them."""
    b, p = boxes.shape[:2]
    idx = torch.arange(b, dtype=boxes.dtype, device=boxes.device)
    return torch.cat([idx.repeat_interleave(p)[:, None],
                      boxes.reshape(-1, 4)], 1)


def roi_align_on_slice(card, label, feats, rois, out, sr):
    """The RoIAlign kernel bit for bit against its plain version on a
    slice's own rois and levels, with rois per level and kernel path, the
    kernel's, the plain version's and the bound's times."""
    from pointtinybenchmark_tpu_torch.models.roi_heads.roi_extractor import \
        map_roi_levels

    lvls = map_roi_levels(rois, len(ROI_STRIDES))
    per_level = torch.bincount(lvls, minlength=len(ROI_STRIDES)).tolist()
    _, err = compare_roi_align(feats, rois, lvls, out, sr)
    paths = roi_paths(feats, rois, lvls, out, sr)
    ms, plain_ms = time_roi_align(feats, rois, lvls, out, sr)
    bms, by = roi_align_bound(feats, rois, lvls, out, sr)
    r = rois.shape[0]
    ps = ps_per_sample(ms, feats, r, out, sr)
    print(f"phase 5 RoIAlign {label} (R={r}, S={out}, sr={sr}, rois per "
          f"level {per_level}): kernel == plain (torch.equal); kernel paths: "
          f"{shares(paths)}")
    print(f"phase 5 RoIAlign {label}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bms:.4f} ms ({by}); {ps:.4f} ps per "
          f"sample and channel [{card}]")
    return dict(shape=f"mask_rcnn slice, {label}", R=r, S=out, sr=sr,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, ps_per_sample=ps, per_level=per_level,
                paths=paths)


def mask_head_flops(head, r, s):
    """f32 operations of the FCN mask head on r crops of s x s: the 3x3
    convolutions at s, the 2x2 stride-2 transposed convolution (one tap per
    output pixel and input channel) and the 1x1 logits at 2s; 2 per
    multiply-add."""
    convs = sum(2 * r * s * s * 9 * m.conv.in_channels * m.conv.out_channels
                for m in head.convs)
    up = head.upsample
    deconv = 2 * r * (2 * s) ** 2 * up.in_channels * up.out_channels
    logits = 2 * r * (2 * s) ** 2 * up.out_channels * head.num_classes
    return convs + deconv + logits


def coco_samples(frames):
    """Two preprocessed samples as the COCO test pipeline hands them to the
    collator: each frame resized to 800x1333 (mmdet's test scale) and
    normalized, float32 (H, W, 3) numpy, with its scale factor
    (w, h, w, h) and original shape."""
    from pointtinybenchmark_tpu_torch.engine.test import (DEFAULT_MEAN,
                                                          DEFAULT_STD)

    h, w = FRAME_HW
    mean = torch.tensor(DEFAULT_MEAN, device=DEVICE)
    std = torch.tensor(DEFAULT_STD, device=DEVICE)
    samples = []
    for f in frames:
        x = torch.from_numpy(f).to(DEVICE).permute(2, 0, 1)[None].float()
        x = torch.nn.functional.interpolate(x, size=COCO_HW, mode="bilinear",
                                            align_corners=False)
        x = (x[0].permute(1, 2, 0) - mean) / std
        sf = np.asarray([COCO_HW[1] / w, COCO_HW[0] / h] * 2, np.float32)
        samples.append(dict(img=x.cpu().numpy(), img_metas=dict(
            scale_factor=sf, ori_shape=(h, w))))
    return samples


def phase_run_test(card, model, frames):
    """`run_test` with the port's DetCollator on two COCO-preprocessed
    frames, rescale on: boxes in the 1080x1920 frame, one RLE mask of that
    size per detection, at least one not empty."""
    from pointtinybenchmark_tpu_torch.data.loader import DetCollator
    from pointtinybenchmark_tpu_torch.engine.test import run_test
    from pointtinybenchmark_tpu_torch.evaluation.mask_utils import rle_encode

    h, w = FRAME_HW
    samples = coco_samples(frames)
    collator = DetCollator(size_divisor=32)
    pad = collator(samples)["img"].shape[1:3]
    results = run_test(model, samples, collator, batch_size=len(samples))
    empty = rle_encode(np.zeros(FRAME_HW, bool))["counts"]
    for i, r in enumerate(results):
        bb, masks = r["bboxes"], r["masks"]
        n = bb.shape[0]
        filled = sum(m["counts"] != empty for m in masks)
        print(f"phase 5 run_test image {i}: {n} detections, {len(masks)} RLE "
              f"masks of size {masks[0]['size'] if masks else None}, "
              f"{filled} not empty")
        if not n or len(masks) != n or filled == 0 \
                or any(m["size"] != [h, w] for m in masks):
            raise AssertionError(f"run_test image {i}: {n} detections, "
                                 f"{len(masks)} masks, {filled} not empty")
        if not (np.isfinite(bb).all() and (bb[:, :4] >= 0).all()
                and (bb[:, [0, 2]] <= w + 1e-3).all()
                and (bb[:, [1, 3]] <= h + 1e-3).all()):
            raise AssertionError(f"run_test image {i}: boxes outside the "
                                 f"original frame")
    t0 = time.perf_counter()
    run_test(model, samples, collator, batch_size=len(samples))
    ips = len(samples) / (time.perf_counter() - t0)
    print(f"phase 5 run_test: {len(samples)} images of {COCO_HW} padded to "
          f"{tuple(pad)}, rescaled to {FRAME_HW}, masks pasted and "
          f"RLE-encoded on the host: {ips:.4f} img/s (one warm call) "
          f"[{card}]")
    return ips


def paste_ms():
    """Host paste of PASTE_DETS crops into a 1080x1920 frame (the boxes and
    crops of bench.py's bench_mask), and the paste with the RLE encoding of
    each mask, ms per call (host clock)."""
    from pointtinybenchmark_tpu_torch.evaluation.mask_utils import (
        paste_masks, rle_encode)

    h, w = FRAME_HW
    rng = np.random.RandomState(1)
    crops = rng.rand(PASTE_DETS, 28, 28).astype(np.float32)
    cx, cy = rng.uniform(0, w, PASTE_DETS), rng.uniform(0, h, PASTE_DETS)
    bw, bh = rng.uniform(10, 20, PASTE_DETS), rng.uniform(10, 20, PASTE_DETS)
    boxes = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2],
                     1).astype(np.float32)

    def ms(fn):
        fn()
        t0 = time.perf_counter()
        for _ in range(PASTE_REPS):
            fn()
        return (time.perf_counter() - t0) * 1e3 / PASTE_REPS
    return (ms(lambda: paste_masks(crops, boxes, h, w)),
            ms(lambda: [rle_encode(m) for m in paste_masks(crops, boxes, h,
                                                            w)]))


def phase_mask(card, frames):
    from pointtinybenchmark_tpu_torch.apis.inference import (
        inference_detector_tiled, init_detector)
    from pointtinybenchmark_tpu_torch.core.post_processing import DetResult

    handle = init_detector(str(MASK_CONFIG), device=DEVICE, seed=0)
    model = handle.model
    lift_scores(model)
    n_lift, lift = MASK_BIAS
    print(f"phase 5: fc_cls.bias +{lift} on classes 0..{n_lift - 1} so that "
          f"scores pass score_thr (random weights put all 81 near 1/81)")
    torch.backends.cudnn.deterministic = True   # the two runs must match bit for bit
    reset_launches()
    results = inference_detector_tiled(handle, list(frames))
    launches = read_launches()
    print(f"phase 5 launches on the Mask R-CNN path: {launches}")
    if launches != MASK_LAUNCHES:
        raise AssertionError(f"expected {MASK_LAUNCHES}, got {launches}")
    check_frames(results, "phase 5")

    # the stages of one call, kept for the work checks and the timings
    eng = next(iter(handle.tiled_engines.values()))
    tiles = eng.pre(frames)
    b = tiles.shape[0]
    img_shapes = torch.tensor([eng.pre.tile_hw], dtype=torch.int32,
                              device=DEVICE).expand(b, 2)
    head = model.roi_head
    cfg = head.test_cfg
    shapes = []
    with torch.no_grad(), nms_shapes(shapes):
        feats = model.extract_feat(tiles)
        rpn_outs = model.rpn_head(feats)
        props, _, valid = model.rpn_head.get_proposals(
            *rpn_outs, img_shapes, model.rpn_head.test_cfg)
        cls_score, _ = head(feats, props)
        dets, masks = head.simple_test(feats, props, valid, img_shapes)
    p, nc = props.shape[1], head.num_classes
    print(f"phase 5 NMS bitmask shapes (B, N): RPN {shapes[0]}, RoI head "
          f"{shapes[1]} ({p} proposals x {nc} classes capped at "
          f"multiclass_nms's pre_nms_limit)")
    if shapes[1] != (b, min(PRE_NMS_LIMIT, p * nc)):
        raise AssertionError(f"RoI-head NMS at {shapes[1]}")
    scores = torch.softmax(cls_score, -1).reshape(b, p, nc + 1)[..., :nc]
    cands = ((scores > float(cfg["score_thr"])) & valid[..., None]).sum((1, 2))
    kept = dets.valid.sum(1)
    print(f"phase 5 RPN proposals per tile {valid.sum(1).min().item()}.."
          f"{valid.sum(1).max().item()}; RoI-head NMS candidates over "
          f"score_thr per tile {cands.tolist()}; detections per tile "
          f"{kept.tolist()}; mask "
          f"probabilities {tuple(masks.shape)}, "
          f"{float(masks.min()):.4f}..{float(masks.max()):.4f}")
    if valid.sum(1).min() <= 0 or cands.min() <= 0 or kept.min() <= 0:
        raise AssertionError("a tile has no proposal, candidate or detection")

    # the RoIAlign kernel on the slice's own rois: the bbox extractor's
    # (S=7, sr=2) and the mask extractor's (S=14, sr=2: every detection slot)
    k_feats = list(feats[:len(ROI_STRIDES)])
    bbox_record = roi_align_on_slice(card, "bbox rois", k_feats,
                                     slice_rois(props), 7, 2)
    mask_record = roi_align_on_slice(card, "mask rois", k_feats,
                                     slice_rois(dets.bboxes[..., :4]), 14, 2)

    # every kernel swapped for its plain version: the same detections and
    # mask probabilities, per tile and after the merge
    def per_tile():
        with torch.no_grad():
            return model.simple_test(tiles, img_shapes)
    got = per_tile()
    with plain_nms(), plain_roi_align():
        want = per_tile()
        results_plain = inference_detector_tiled(handle, list(frames))
    torch.backends.cudnn.deterministic = False
    for name, g, w in zip(DetResult._fields + ("masks",),
                          tuple(got[0]) + (got[1],),
                          tuple(want[0]) + (want[1],)):
        if not torch.equal(g, w):
            raise AssertionError(f"simple_test {name}: kernels and plain "
                                 f"disagree")
    for i, (r, q) in enumerate(zip(results, results_plain)):
        if not (np.array_equal(r["bboxes"], q["bboxes"])
                and np.array_equal(r["labels"], q["labels"])):
            raise AssertionError(f"frame {i}: kernels and plain disagree")
    print("phase 5: detections and mask probabilities of every tile, and "
          "the merged detections, with the kernels == with every kernel "
          "swapped for its plain version")

    # the card against the CPU on one tile: backbone, neck, RPN, the RoI
    # head on the card's proposals and the mask branch on the card's
    # detections of that tile
    cpu_model = init_detector(str(MASK_CONFIG), device="cpu", seed=0).model
    lift_scores(cpu_model)
    with torch.no_grad():
        t0 = tiles[:1]
        c_back = cpu_model.backbone(t0.cpu().permute(0, 3, 1, 2))
        g_back = model.backbone(t0.permute(0, 3, 1, 2))
        c_feats = cpu_model.neck(c_back)
        c_rpn = cpu_model.rpn_head(c_feats)
        c_roi = cpu_model.roi_head(c_feats, props[:1].cpu())
        g_roi = head([f[:1] for f in feats], props[:1])
        det0 = dets.bboxes[:1, :, :4]
        c_mask = cpu_model.roi_head.mask_forward(c_feats, det0.cpu())
        g_mask = head.mask_forward([f[:1] for f in feats], det0)
    errs = {"backbone": rel_err(g_back, c_back),
            "neck": rel_err([f[:1] for f in feats], c_feats),
            "rpn": rel_err([o[:1] for o in rpn_outs[0] + rpn_outs[1]],
                           c_rpn[0] + c_rpn[1]),
            "roi_head": rel_err(g_roi, c_roi),
            "mask_head": rel_err([g_mask], [c_mask])}
    print("phase 5 card vs CPU on one tile, max rel err: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    if max(errs.values()) > 1e-4:
        raise AssertionError(f"card differs from CPU: {errs}")
    del cpu_model

    run_test_ips = phase_run_test(card, model, frames)
    protocol, forward = throughput(handle, frames, tiles)
    mask_feats = head._extract(feats, dets.bboxes[..., :4],
                               head.mask_extractor)
    with torch.no_grad():
        mh_ms = time_ms(lambda: head.mask_head(mask_feats), ITERS)
        fwd_ms = time_ms(lambda: model(tiles), ITERS)
    s = mask_feats.shape[-1]
    mh_flop = mask_head_flops(head.mask_head, mask_feats.shape[0], s)
    host_paste_ms, host_ms = paste_ms()
    print(f"phase 5 protocol ({N_FRAMES} frames of {eng.pre.n_views} tiles, "
          f"host in the loop, detections merged, masks not returned): "
          f"{protocol:.4f} img/s [{card}]")
    print(f"phase 5 forward only (tiles -> detections + 28x28 mask "
          f"probabilities, {b} tiles, f32, TF32 off): {forward:.4f} img/s; "
          f"{fwd_ms:.4f} ms per forward by CUDA events [{card}]")
    print(f"phase 5 mask head alone ({mask_feats.shape[0]} crops of {s}x{s}, "
          f"{mh_flop / 1e12:.4f} TFLOP): {mh_ms:.4f} ms, "
          f"{mh_flop / mh_ms / 1e9:.2f} TFLOP/s, share of the forward "
          f"{mh_ms / fwd_ms:.4f} [{card}]")
    print(f"phase 5 host paste of {PASTE_DETS} detections into {FRAME_HW} "
          f"(bench_mask's boxes): {host_paste_ms:.4f} ms; paste + RLE "
          f"{host_ms:.4f} ms (host clock)")
    numbers = dict(protocol_img_s=protocol, forward_img_s=forward,
                   forward_ms=fwd_ms, run_test_img_s=run_test_ips,
                   mask_head_ms=mh_ms, mask_head_tflop=mh_flop / 1e12,
                   paste_ms_per_100=host_paste_ms * 100 / PASTE_DETS,
                   paste_rle_ms_per_100=host_ms * 100 / PASTE_DETS)
    print(json.dumps({"mask_rcnn": numbers}))
    return launches, handle, [bbox_record, mask_record]


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
    from pointtinybenchmark_tpu_torch.apis.inference import \
        inference_detector_tiled

    frame_list = list(frames)
    inference_detector_tiled(handle, frame_list)
    device_profile(card, lambda: inference_detector_tiled(handle, frame_list),
                   label, PROFILE_CALLS,
                   f"warm protocol calls of {N_FRAMES} frames")


def device_profile(card, run, label, calls, what):
    """`calls` runs of `run` (warm) under torch.profiler: wall and device
    busy ms per call, the idle share, device ms by kernel family and the
    top kernels; the Chrome trace goes to build/. Returns (wall ms, busy
    ms, {family: ms}) per call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    trace = REPO / "build" / f"protocol_trace_{label}.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              and "dur" in e]
    if not events:
        raise AssertionError("the profiler traced no device activity")
    busy_ms = _busy_us(events) / 1e3 / calls
    family, by_name, count = (collections.Counter() for _ in range(3))
    for e in events:
        low = e["name"].lower()
        family[next((f for key, f in KERNEL_FAMILIES if key in low),
                    "rest")] += e["dur"]
        by_name[e["name"][:90]] += e["dur"]
        count[e["name"][:90]] += 1
    print(f"profile {label} ({calls} {what}, profiler on, trace {trace}): "
          f"per call wall {wall_ms:.4f} ms, device busy {busy_ms:.4f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.4f} [{card}]")
    print(f"profile {label} device ms per call by family (share of busy):")
    fam_ms = {}
    for name, us in family.most_common():
        ms = us / 1e3 / calls
        fam_ms[name] = ms
        print(f"  {name:36s} {ms:10.4f} ms  {ms / busy_ms:.4f}")
    print(f"profile {label} top kernels (ms per call, launches per call):")
    for name, us in by_name.most_common(15):
        print(f"  {us / 1e3 / calls:9.4f}  "
              f"{count[name] / calls:6.1f}  {name}")
    return wall_ms, busy_ms, fam_ms


# ------------------------------------------------------ phase 6: training
def roi_align_backward_bound(r, c, out, sr, shapes):
    """(ms, bounded by) of the K2 backward: the upstream gradient (R, C, S,
    S) read once, rois and levels read once, each level's gradient written
    once; 1 product per upstream value and 8 operations per sample and
    channel (4 weight products, 4 adds)."""
    cells = sum(b * h * w for b, _, h, w in shapes)
    nbytes = 4 * (r * c * out * out + r * 5 + r + cells * c)
    return bound(nbytes, r * c * out * out * (1 + 8 * sr * sr))


def compare_roi_align_backward(g, rois, lvls, shapes, out, sr):
    """The backward kernel against the plain backward (autograd through the
    plain forward) on the same inputs: (max abs err, worst err over the
    level's max |gradient|). Fails above BWD_TOL of a level's max."""
    from pointtinybenchmark_tpu_torch.ops import roi_align, roi_align_cuda

    cl = [True] * len(shapes)
    got = roi_align_cuda.roi_align_backward(g, rois, lvls, shapes, cl,
                                            ROI_STRIDES, out, sr)
    want = roi_align.roi_align_backward_plain(g, rois, lvls, shapes, cl,
                                              ROI_STRIDES, out, sr)
    torch.cuda.synchronize()
    err, share = 0.0, 0.0
    for a, b in zip(got, want):
        e = float((a - b).abs().max())
        m = float(b.abs().max())
        err = max(err, e)
        share = max(share, e / m if m else (0.0 if e == 0 else float("inf")))
    if share > BWD_TOL or not any(bool(w.any()) for w in want):
        raise AssertionError(f"RoIAlign backward kernel vs plain: max abs err "
                             f"{err}, {share:.3e} of a level's max |grad| "
                             f"(bar {BWD_TOL})")
    return err, share


def time_roi_align_backward(g, rois, lvls, shapes, out, sr):
    """(call ms, plain ms): whole wrapper calls between CUDA events, the
    zero fill, argument checks and ctypes call included."""
    from pointtinybenchmark_tpu_torch.ops import roi_align, roi_align_cuda

    cl = [True] * len(shapes)
    ms = time_ms(lambda: roi_align_cuda.roi_align_backward(
        g, rois, lvls, shapes, cl, ROI_STRIDES, out, sr), ITERS)
    plain_ms = time_ms(lambda: roi_align.roi_align_backward_plain(
        g, rois, lvls, shapes, cl, ROI_STRIDES, out, sr), PLAIN_ITERS)
    return ms, plain_ms


def backward_paths(g, rois, lvls, shapes, out, sr):
    """{kernel path: rois that take it} of the backward for these inputs,
    from the kernel's own counts (one launch, outside any counted run)."""
    from pointtinybenchmark_tpu_torch.ops import roi_align_cuda

    counts = torch.zeros(len(roi_align_cuda.PATHS), dtype=torch.int32,
                         device=rois.device)
    roi_align_cuda.roi_align_backward(g, rois, lvls, shapes,
                                      [True] * len(shapes), ROI_STRIDES, out,
                                      sr, path_counts=counts)
    return dict(zip(roi_align_cuda.PATHS, counts.tolist()))


def backward_device_ms(g, rois, lvls, shapes, out, sr, label,
                       calls=BWD_PROFILE_CALLS):
    """The backward's device time per wrapper call, from a torch.profiler
    trace of `calls` warm calls (no host time in it): (the backward kernel,
    the rest of the call's device work: the zero fill of the level
    gradients and the levels' int32 copy, the sum of both, which run one
    after the other on the stream). The trace goes to build/."""
    from torch.profiler import ProfilerActivity, profile

    from pointtinybenchmark_tpu_torch.ops import roi_align_cuda

    def run():
        roi_align_cuda.roi_align_backward(g, rois, lvls, shapes,
                                          [True] * len(shapes), ROI_STRIDES,
                                          out, sr)
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    trace = REPO / "build" / f"backward_trace_{label}.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              and "dur" in e]
    # the trace may miss some of the calls' activity: each kind of event
    # (by name) gives its mean duration, once a call
    by_name = collections.defaultdict(list)
    for e in events:
        by_name[e["name"]].append(e["dur"])
    kernel = [n for n in by_name if "roi_align_backward" in n]
    if len(kernel) != 1 or len(by_name[kernel[0]]) < calls // 2:
        raise AssertionError(f"{calls} calls traced as "
                             f"{ {n: len(v) for n, v in by_name.items()} }")
    means = {n: sum(v) / len(v) / 1e3 for n, v in by_name.items()}
    kernel_ms = means.pop(kernel[0])
    rest_ms = sum(means.values())
    return kernel_ms, rest_ms, kernel_ms + rest_ms


def backward_inputs():
    """Phase 6 (a)'s inputs, made from seeds: for each of BWD_SHAPES,
    (name, images, uniform or clustered, the upstream gradient g, rois,
    levels, level shapes, S, sr), on DEVICE."""
    from pointtinybenchmark_tpu_torch.models.roi_heads.roi_extractor import \
        map_roi_levels

    rng = np.random.RandomState(6)
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    for name, b, r, out, sr, kind in BWD_SHAPES:
        shapes = [(b, ROI_CHANNELS, h, w) for h, w in ROI_LEVELS]
        rois = torch.from_numpy(synthetic_rois(rng, b, r) if kind == "uniform"
                                else clustered_rois(rng, b, r // b)).to(DEVICE)
        lvls = map_roi_levels(rois, len(ROI_LEVELS))
        g = torch.randn((r, ROI_CHANNELS, out, out), generator=gen,
                        device=DEVICE)
        yield name, b, kind, g, rois, lvls, shapes, out, sr


def phase_roi_align_backward(card):
    """Phase 6 (a): the backward kernel against the plain backward at
    BWD_SHAPES on synthetic channels-last 256-channel maps of 512x640
    images, on `edge_rois` and on rois out of range (which must add
    nothing); call times, and the rois on each kernel path. Returns one
    record per shape and a function that adds each shape's device time
    from a profile, to be run after every other timing."""
    from pointtinybenchmark_tpu_torch.models.roi_heads.roi_extractor import \
        map_roi_levels
    from pointtinybenchmark_tpu_torch.ops import roi_align_cuda

    gen = torch.Generator(device=DEVICE).manual_seed(8)   # edge, bad rois
    records, inputs = [], []
    for name, b, kind, g, rois, lvls, shapes, out, sr in backward_inputs():
        r = rois.shape[0]
        per_level = torch.bincount(lvls, minlength=len(ROI_LEVELS)).tolist()
        err, share = compare_roi_align_backward(g, rois, lvls, shapes, out,
                                                sr)
        paths = backward_paths(g, rois, lvls, shapes, out, sr)
        edge = torch.from_numpy(edge_rois(b)).to(DEVICE)
        edge_lvls = map_roi_levels(edge, len(ROI_LEVELS))
        ge = torch.randn((edge.shape[0], ROI_CHANNELS, out, out),
                         generator=gen, device=DEVICE)
        edge_err, edge_share = compare_roi_align_backward(
            ge, edge, edge_lvls, shapes, out, sr)
        edge_paths = backward_paths(ge, edge, edge_lvls, shapes, out, sr)
        # out of range: batch index b, -1, NaN; level 7 of 4
        bad = rois[:4].clone()
        bad[0, 0], bad[1, 0], bad[2, 0] = float(b), -1.0, float("nan")
        bad_lvls = torch.tensor([0, 1, 2, 7], device=DEVICE)
        gb = torch.randn((4, ROI_CHANNELS, out, out), generator=gen,
                         device=DEVICE)
        none = roi_align_cuda.roi_align_backward(
            gb, bad, bad_lvls, shapes, [True] * len(shapes), ROI_STRIDES, out,
            sr)
        torch.cuda.synchronize()
        if any(bool(x.any()) for x in none):
            raise AssertionError(f"{name}: rois out of range wrote gradient")
        bad_paths = backward_paths(gb, bad, bad_lvls, shapes, out, sr)
        if bad_paths["invalid"] != 4 or sum(paths.values()) != r:
            raise AssertionError(f"{name}: paths {paths}, out of range "
                                 f"{bad_paths}")
        ms, plain_ms = time_roi_align_backward(g, rois, lvls, shapes, out, sr)
        bms, by = roi_align_backward_bound(r, ROI_CHANNELS, out, sr, shapes)
        print(f"phase 6 RoIAlign backward {name} R={r} S={out} sr={sr} "
              f"C={ROI_CHANNELS} ({b} images of {TRAIN_HW}, {kind} rois, "
              f"rois per level {per_level}): kernel vs plain max abs err "
              f"{err:.3e} ({share:.3e} of the level's max |grad|, bar "
              f"{BWD_TOL}); {edge.shape[0]} edge rois {edge_err:.3e} "
              f"({edge_share:.3e}); 4 rois out of range wrote nothing")
        print(f"phase 6 RoIAlign backward {name} kernel paths: "
              f"{shares(paths)}; edge rois: {shares(edge_paths)}; out of "
              f"range: {shares(bad_paths)}")
        print(f"phase 6 RoIAlign backward {name}: call {ms:.4f} ms (CUDA "
              f"events around whole wrapper calls), plain {plain_ms:.4f} ms, "
              f"bound {bms:.4f} ms ({by}) [{card}]")
        records.append(dict(shape=name, R=r, S=out, sr=sr, rois=kind,
                            max_abs_err=err, err_share=share,
                            edge_err_share=edge_share, ms=ms,
                            plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                            per_level=per_level, paths=paths))
        inputs.append((g, rois, lvls, shapes, out, sr))

    def device_times():
        """Each shape's device ms from a profile (`backward_device_ms`):
        `device_ms` is the kernel and the zero fill, the call's device
        work."""
        for rec, args in zip(records, inputs):
            add_device_ms(card, rec, *args)
    return records, device_times


def add_device_ms(card, rec, g, rois, lvls, shapes, out, sr, phase="6"):
    """Put the backward's device times for these inputs into `rec`
    (device_ms: the kernel and the rest of the call's device work) and
    print them beside the call time and the bound."""
    label = rec["shape"].replace(" ", "_")
    k_ms, rest_ms, busy_ms = backward_device_ms(g, rois, lvls, shapes, out,
                                                sr, label)
    rec.update(device_ms=busy_ms, kernel_ms=k_ms, fill_ms=rest_ms)
    print(f"phase {phase} RoIAlign backward {rec['shape']} (R={rec['R']}, "
          f"S={out}, sr={sr}), device time per call from a profile of "
          f"{BWD_PROFILE_CALLS} calls: kernel {k_ms:.4f} ms, zero fill and "
          f"level copy {rest_ms:.4f} ms, together {busy_ms:.4f} ms (call "
          f"{rec['ms']:.4f} ms); bound {rec['bound_ms']:.4f} ms, share "
          f"{rec['bound_ms'] / busy_ms:.3f} (kernel alone "
          f"{rec['bound_ms'] / k_ms:.3f}) [{card}]")


def train_samples(rng, n, hw=None):
    """n training samples as a dataset hands them to the collator: a
    normalised (H, W, 3) float32 image, 20-60 TinyPerson-like gts (10-40 px
    boxes around cluster centres, `synthetic_boxes`' kind) of class 0, and
    two ignore regions."""
    h, w = hw or TRAIN_HW
    out = []
    for _ in range(n):
        k = rng.randint(20, 61)
        boxes, _, valid, _ = synthetic_boxes(rng, 1, 2 * k)
        boxes = boxes[0][valid[0]][:k]
        boxes = np.clip(boxes, 0, [w, h, w, h]).astype(np.float32)
        out.append(dict(
            img=rng.randn(h, w, 3).astype(np.float32),
            gt_bboxes=boxes, gt_labels=np.zeros(len(boxes), np.int64),
            gt_bboxes_ignore=np.asarray([[0, 0, 30, 30],
                                         [w - 40, h - 40, w, h]],
                                        np.float32)))
    return out


def train_model(cfg, seed=0, device=None):
    from pointtinybenchmark_tpu_torch.models.builder import build_detector

    return build_detector(dict(cfg.model), cfg.get("train_cfg"),
                          cfg.get("test_cfg"), device=device or DEVICE,
                          seed=seed)


def one_step(model, cfg, batch, seed, device=None):
    """One train step from the model's current weights with a fresh
    optimizer: (metrics as floats, {name: gradient})."""
    from pointtinybenchmark_tpu_torch.engine.optimizer import build_optimizer
    from pointtinybenchmark_tpu_torch.engine.train import (init_train_state,
                                                           make_train_step)

    device = device or DEVICE
    opt = build_optimizer(model, cfg.optimizer, cfg.get("optimizer_config"),
                          cfg.get("lr_config"), 1, 1,
                          model.backbone.frozen_stages)
    step = make_train_step(model, opt)
    metrics = step(init_train_state(device), batch,
                   torch.Generator(device=device).manual_seed(seed))
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.grad.detach().clone() for n, p in model.named_parameters()})


@contextlib.contextmanager
def recorded(module, name, calls):
    """Inside this block each call of `module.<name>` appends its
    arguments (and keyword arguments) and result to `calls`."""
    saved = getattr(module, name)

    def record(*args, **kwargs):
        out = saved(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out
    setattr(module, name, record)
    try:
        yield
    finally:
        setattr(module, name, saved)


def covering_budgets(model, anchors, gts):
    """Sampler budgets of at least every candidate: both samplers then take
    every positive and negative whatever their generator draws (the card's
    and the CPU's generators give different numbers)."""
    model.rpn_head.train_cfg["sampler"] = dict(
        model.rpn_head.train_cfg["sampler"], num=4 * anchors,
        pos_fraction=0.5)
    props = int(model.train_proposal_cfg["max_per_img"]) + gts
    model.roi_head.train_cfg["sampler"] = dict(
        model.roi_head.train_cfg["sampler"], num=4 * props, pos_fraction=0.5)


def train_run(card, phase, cfg, samples, epochs, expected, positives):
    """`train_detector` from seeded weights on `samples` for `epochs`, with
    the kernels' launches counted from zero around it: the launches per step
    must be `expected`, every loss finite, each count of `positives` above
    its floor in every step, the frozen stem and stages bit-identical and
    every other parameter changed. Returns the model (back at its initial
    weights), those weights and the run's launches."""
    import tempfile

    from pointtinybenchmark_tpu_torch.engine.optimizer import \
        frozen_param_names
    from pointtinybenchmark_tpu_torch.engine.train import train_detector

    spg = int(cfg.data["samples_per_gpu"])
    model = train_model(cfg)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    run_cfg = cfg.to_dict()
    run_cfg.update(runner=dict(type="EpochBasedRunner", max_epochs=epochs),
                   log_config=dict(interval=1),
                   checkpoint_config=dict(interval=epochs),
                   evaluation=dict(interval=epochs + 1))
    iters = epochs * len(samples) // spg
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=REPO / "build") as work:
        result = train_detector(model, samples, run_cfg, work, device=DEVICE,
                                seed=0)
        ckpts = sorted(p.name for p in Path(work).glob("*.pth"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    history = result["history"]
    per_step = {k: v / iters for k, v in launches.items()}
    print(f"phase {phase} train_detector: {len(history)} iterations logged "
          f"in {wall:.2f} s (host clock, a sync per iteration for the log); "
          f"checkpoints {ckpts}; launches {launches}, per step {per_step}")
    if len(history) != iters or per_step != expected:
        raise AssertionError(f"{len(history)} iterations, launches per step "
                             f"{per_step}, expected {expected}")
    keys = [k for k in history[0] if k.startswith("loss") or "num_pos" in k
            or k in ("rcnn_acc", "nan_seen")]
    for e in history:
        print("  step {step}: ".format(**e) + ", ".join(
            f"{k} {e[k]:.5f}" for k in keys) + f", lr {e['lr']:.3e}")
    if not all(np.isfinite(e[k]) for e in history for k in keys) \
            or any(e["nan_seen"] for e in history):
        raise AssertionError("a loss of the run is not finite")
    # a dense head's count is at least 1 an image by its normalisation
    low = {k: min(e[k] for e in history) for k in positives}
    if any(low[k] <= floor for k, floor in positives.items()):
        raise AssertionError(f"a stage had no positive: least counts {low}, "
                             f"floors {positives}")
    frozen = set(frozen_param_names(model, model.backbone.frozen_stages))
    after = model.state_dict()
    unchanged = [n for n, _ in model.named_parameters()
                 if n not in frozen and torch.equal(after[n], init[n])]
    moved = [n for n in frozen if not torch.equal(after[n], init[n])]
    print(f"phase {phase} after the run: {len(frozen)} frozen tensors (stem, "
          f"layer1) bit-identical: {not moved}; trainable tensors unchanged: "
          f"{unchanged or 'none'}")
    if moved or unchanged:
        raise AssertionError(f"frozen moved {moved[:4]}, trainable unchanged "
                             f"{unchanged[:4]}")
    del result, after
    model.load_state_dict(init)
    return model, init, launches


def phase_train(card):
    """Phase 6 (b)-(e): Adap Faster R-CNN training at full width. Returns
    the launches of the train_detector run, the forward's and the
    backward's records on the step's rois, and the profile (f), to be run
    after every timing."""
    from pointtinybenchmark_tpu_torch.data.loader import DetCollator
    from pointtinybenchmark_tpu_torch.engine.optimizer import build_optimizer
    from pointtinybenchmark_tpu_torch.engine.train import (
        batch_to_device, init_train_state, make_train_step)
    from pointtinybenchmark_tpu_torch.ops import roi_align_cuda
    from pointtinybenchmark_tpu_torch.utils.config import Config

    cfg = Config.fromfile(str(FRCNN_CONFIG))
    spg = int(cfg.data["samples_per_gpu"])
    samples = train_samples(np.random.RandomState(8), TRAIN_IMAGES)
    print(f"phase 6 training config: {FRCNN_CONFIG.name}, samples_per_gpu "
          f"{spg}, pad_shape {tuple(cfg.loader['pad_shape'])}, max_gt "
          f"{cfg.loader['max_gt']}, optimizer {dict(cfg.optimizer)}, "
          f"grad_clip {cfg.optimizer_config.get('grad_clip')}, lr_config "
          f"{dict(cfg.lr_config)}; {TRAIN_IMAGES} synthetic images, gts per "
          f"image {[len(s['gt_bboxes']) for s in samples]}")

    # what the earlier phases hold on the card: (e) reports the peak above it
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()

    # (b) train_detector, launches counted from zero
    model, init, launches = train_run(card, "6", cfg, samples, TRAIN_EPOCHS,
                                      TRAIN_LAUNCHES,
                                      {"rpn_num_pos": spg, "rcnn_num_pos": 0})

    collator = DetCollator(tuple(cfg.loader["pad_shape"]),
                           max_gt=int(cfg.loader["max_gt"]),
                           max_gt_ignore=int(cfg.loader["max_gt_ignore"]))
    batch = batch_to_device(collator(samples[:spg]), DEVICE)

    # (c) one step with the kernels against one with the plain RoIAlign
    # (forward and backward), from the same weights and draws
    torch.backends.cudnn.deterministic = True
    reset_launches()
    got, got_grads = one_step(model, cfg, batch, seed=3)
    k_launches = read_launches()
    model.load_state_dict(init)
    reset_launches()
    with plain_roi_align():
        want, want_grads = one_step(model, cfg, batch, seed=3)
    p_launches = read_launches()
    model.load_state_dict(init)
    torch.backends.cudnn.deterministic = False
    loss_keys = [k for k in want if k.startswith("loss") or "num_pos" in k]
    worst = max(float((got_grads[n] - w).abs().max())
                / max(float(w.abs().max()), 1e-30)
                for n, w in want_grads.items())
    print(f"phase 6 one step, kernels vs plain RoIAlign: launches "
          f"{k_launches} vs {p_launches}; losses equal: "
          f"{all(got[k] == want[k] for k in loss_keys)}; worst gradient "
          f"error {worst:.3e} of its parameter's max |grad| (bar "
          f"{GRAD_TOL})")
    if k_launches != TRAIN_LAUNCHES or p_launches["roi_align"] \
            or p_launches["roi_align_backward"]:
        raise AssertionError(f"launches {k_launches}, plain {p_launches}")
    if any(got[k] != want[k] for k in loss_keys) or worst > GRAD_TOL:
        raise AssertionError(f"kernels vs plain: {got} vs {want}, gradient "
                             f"{worst}")

    # (d) the card against the CPU on one step, both samplers covering
    # every candidate, the CPU fed the card's proposals, which must be
    # those of the plain NMS on the same RPN outputs
    anchors = 3 * sum(-(-TRAIN_HW[0] // s) * -(-TRAIN_HW[1] // s)
                      for s in (4, 8, 16, 32, 64))
    covering_budgets(model, anchors, int(cfg.loader["max_gt"]))
    calls = []
    with recorded(model.rpn_head, "get_proposals", calls):
        card_m, _ = one_step(model, cfg, batch, seed=4)
    args, kwargs, got_props = calls[0]
    with torch.no_grad(), plain_nms():
        want_props = model.rpn_head.get_proposals(*args, **kwargs)
    torch.cuda.synchronize()
    same = all(torch.equal(g, w) for g, w in zip(got_props, want_props))
    print(f"phase 6 the step's proposals (B={got_props[0].shape[0]}, "
          f"{got_props[0].shape[1]} an image, valid "
          f"{got_props[2].sum(1).tolist()}): NMS kernels == plain NMS "
          f"(torch.equal): {same}")
    if not same:
        raise AssertionError("the train step's proposals differ from those "
                             "of the plain NMS")
    cpu_model = train_model(cfg, device="cpu")
    covering_budgets(cpu_model, anchors, int(cfg.loader["max_gt"]))
    props = tuple(t.cpu() for t in calls[0][2])
    cpu_model.rpn_head.get_proposals = lambda *a, **k: props
    cpu_m, _ = one_step(cpu_model, cfg, batch_to_device(
        collator(samples[:spg]), "cpu"), seed=4, device="cpu")
    errs = {k: abs(card_m[k] - cpu_m[k]) / max(abs(cpu_m[k]), 1e-30)
            for k in loss_keys}
    print("phase 6 one step, card vs CPU (every candidate sampled, the "
          "card's proposals), rel err: " + ", ".join(
              f"{k} {v:.3e}" for k, v in errs.items()))
    if max(errs.values()) > LOSS_TOL:
        raise AssertionError(f"card vs CPU: {card_m} vs {cpu_m}")
    del cpu_model, calls, props, args, kwargs, got_props, want_props, init
    model = train_model(cfg)

    # (e) timing: warm steps by CUDA events, the K2 kernels on the step's
    # own rois, peak memory
    opt = build_optimizer(model, cfg.optimizer, cfg.get("optimizer_config"),
                          cfg.get("lr_config"), TRAIN_IMAGES, 12,
                          model.backbone.frozen_stages)
    step = make_train_step(model, opt)
    state = init_train_state(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    fwd, bwd = [], []
    with recorded(roi_align_cuda, "roi_align_forward", fwd), \
            recorded(roi_align_cuda, "roi_align_backward", bwd):
        step(state, batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(lambda: step(state, batch, gen), TRAIN_TIMED_STEPS)
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    (feats, rois, lvls, *rest), _, _ = fwd[0]
    (g, *_), _, _ = bwd[0]
    feats = [f.detach() for f in feats]
    shapes = [tuple(f.shape) for f in feats]
    out, sr = rest[1], rest[2]
    per_level = torch.bincount(lvls, minlength=len(ROI_LEVELS)).tolist()
    _, f_err = compare_roi_align(feats, rois, lvls, out, sr)
    err, share = compare_roi_align_backward(g, rois, lvls, shapes, out, sr)
    f_ms, f_plain = time_roi_align(feats, rois, lvls, out, sr)
    f_bms, f_by = roi_align_bound(feats, rois, lvls, out, sr)
    b_ms, b_plain = time_roi_align_backward(g, rois, lvls, shapes, out, sr)
    b_paths = backward_paths(g, rois, lvls, shapes, out, sr)
    b_bms, b_by = roi_align_backward_bound(rois.shape[0], g.shape[1], out, sr,
                                           shapes)
    print(f"phase 6 train step (Adap Faster R-CNN, {spg} image of "
          f"{TRAIN_HW}, f32, TF32 off, warm, CUDA events over "
          f"{TRAIN_TIMED_STEPS} steps, no host sync between them): "
          f"{step_ms:.4f} ms, {spg * 1e3 / step_ms:.4f} img/s; peak memory "
          f"{peak:.3f} GiB above the {held / 2 ** 30:.3f} GiB the earlier "
          f"phases hold [{card}]")
    print(f"phase 6 the step's own rois (R={rois.shape[0]}, S={out}, sr={sr},"
          f" per level {per_level}): forward kernel == plain (torch.equal); "
          f"backward kernel vs plain {err:.3e} "
          f"({share:.3e} of the level's max); forward kernel {f_ms:.4f} ms "
          f"(plain {f_plain:.4f}, bound {f_bms:.4f} {f_by}), backward call "
          f"{b_ms:.4f} ms (plain {b_plain:.4f}, bound {b_bms:.4f} {b_by}; "
          f"paths {shares(b_paths)}); forward + backward {f_ms + b_ms:.4f} "
          f"ms, share of the step {(f_ms + b_ms) / step_ms:.4f} [{card}]")
    slice_bwd = dict(shape="faster_rcnn train slice", R=rois.shape[0], S=out,
                     sr=sr, rois="train step", max_abs_err=err,
                     err_share=share, ms=b_ms, plain_ms=b_plain,
                     bound_ms=b_bms, bound_by=b_by, per_level=per_level,
                     paths=b_paths)
    bwd_args = (g, rois, lvls, shapes, out, sr)
    STEP_BACKWARD.parent.mkdir(parents=True, exist_ok=True)
    torch.save(bwd_args, STEP_BACKWARD)
    slice_fwd = dict(shape="faster_rcnn train slice", R=rois.shape[0], S=out,
                     sr=sr, max_abs_err=f_err, ms=f_ms, plain_ms=f_plain,
                     bound_ms=f_bms, bound_by=f_by, per_level=per_level)
    del fwd, bwd, feats, g

    def profile():
        """(f) a profile of warm steps."""
        wall_ms, busy_ms, fam = device_profile(
            card, lambda: step(state, batch, gen), "faster_rcnn_train",
            TRAIN_PROFILE_STEPS, f"warm train steps of {spg} image")
        k2 = (fam.get("RoIAlign kernel", 0.0)
              + fam.get("RoIAlign backward kernel", 0.0))
        print(f"phase 6 profile: K2 forward + backward {k2:.4f} ms of "
              f"{busy_ms:.4f} ms busy ({k2 / busy_ms:.4f}) [{card}]")
        after_ms = time_ms(lambda: step(state, batch, gen),
                           TRAIN_TIMED_STEPS)
        print(f"phase 6 train step again, after every profile of the run: "
              f"{after_ms:.4f} ms (before them {step_ms:.4f} ms) [{card}]")
        add_device_ms(card, slice_bwd, *bwd_args)
        numbers = dict(step_ms=step_ms, img_s=spg * 1e3 / step_ms,
                       peak_gib=peak, k2_fwd_ms=f_ms, k2_bwd_call_ms=b_ms,
                       k2_bwd_device_ms=slice_bwd["device_ms"],
                       k2_share_of_step=(f_ms + b_ms) / step_ms,
                       profile_wall_ms=wall_ms, profile_busy_ms=busy_ms,
                       idle_share=1 - busy_ms / wall_ms,
                       step_ms_after_profiles=after_ms)
        print(json.dumps({"faster_rcnn_train": numbers}))
    return launches, slice_fwd, slice_bwd, profile


# ------------------------------------------- phase 7: RetinaNet-c training
def double_step(cfg, collated, seed, device):
    """one_step of a fresh seeded model in float64 on `device`: (metrics,
    gradients)."""
    from pointtinybenchmark_tpu_torch.engine.train import batch_to_device

    batch = {k: v.double() if v.is_floating_point() else v
             for k, v in batch_to_device(collated, device).items()}
    return one_step(train_model(cfg, device=device).double(), cfg, batch,
                    seed, device=device)


def grad_error(got, want):
    """The worst |gradient difference| of a parameter over that
    parameter's max |gradient|, over every parameter of `want`."""
    return max(float((got[n].cpu() - w.cpu()).abs().max())
               / max(float(w.abs().max()), 1e-30) for n, w in want.items())


def time_step(card, phase, label, cfg, model, batch, held, images):
    """Warm train steps of `model` on `batch` by CUDA events (no host sync
    between them), and the peak memory above `held`. Returns the numbers
    and a function that profiles warm steps and prints them as JSON, to be
    run after every timing of the run."""
    from pointtinybenchmark_tpu_torch.engine.optimizer import build_optimizer
    from pointtinybenchmark_tpu_torch.engine.train import (init_train_state,
                                                           make_train_step)

    opt = build_optimizer(model, cfg.optimizer, cfg.get("optimizer_config"),
                          cfg.get("lr_config"), 4, 12,
                          model.backbone.frozen_stages)
    step = make_train_step(model, opt)
    state = init_train_state(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    step(state, batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(lambda: step(state, batch, gen), TRAIN_TIMED_STEPS)
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    hw = tuple(batch["img"].shape[1:3])
    print(f"phase {phase} train step ({label}, {images} image(s) of {hw}, "
          f"f32, TF32 off, warm, CUDA events over {TRAIN_TIMED_STEPS} steps, "
          f"no host sync between them): {step_ms:.4f} ms, "
          f"{images * 1e3 / step_ms:.4f} img/s; peak memory {peak:.3f} GiB "
          f"above the {held / 2 ** 30:.3f} GiB the earlier phases hold "
          f"[{card}]")
    numbers = dict(step_ms=step_ms, img_s=images * 1e3 / step_ms,
                   peak_gib=peak)

    def profile():
        wall_ms, busy_ms, fam = device_profile(
            card, lambda: step(state, batch, gen), label,
            TRAIN_PROFILE_STEPS, f"warm train steps of {images} image(s)")
        numbers.update(profile_wall_ms=wall_ms, profile_busy_ms=busy_ms,
                       idle_share=1 - busy_ms / wall_ms,
                       unprofiled_idle_share=1 - busy_ms / step_ms,
                       families=fam)
        print(json.dumps({label: numbers}))
    return numbers, profile


def phase_retina_train(card):
    """Phase 7: Adap RetinaNet-c training at full width (the clipg config:
    ResNet-50 with frozen_stages=1, FPN-256 from stride 4, RetinaHead with 4
    stacked convs and 9 anchors, focal loss, grad_clip max_norm 1) with
    seeded weights: (a) `train_detector` for 20 iterations on 4 synthetic
    512x640 images (launches, losses, positives, frozen and trainable
    parameters: `train_run`); (b) the card against the CPU on one step
    (the focal loss samples nothing, so both see the same step): losses in
    float32 within LOSS_TOL, and gradients in float64 within GRAD_TOL of
    each parameter's max (in float32 the full-width network's gradients
    carry rounding of ~6e-3 of a parameter's max on one device alone,
    ReLU masks and sums in another order: the float32 difference is
    printed beside the CPU's own float32-vs-float64 one, not held to
    GRAD_TOL); (c) train-step ms, img/s and peak memory. Returns the run's
    launches and the profile (d), to be run after every timing."""
    from pointtinybenchmark_tpu_torch.data.loader import DetCollator
    from pointtinybenchmark_tpu_torch.engine.train import batch_to_device
    from pointtinybenchmark_tpu_torch.utils.config import Config

    cfg = Config.fromfile(str(CONFIG))
    spg = int(cfg.data["samples_per_gpu"])
    samples = train_samples(np.random.RandomState(9), TRAIN_IMAGES)
    print(f"phase 7 training config: {CONFIG.name}, samples_per_gpu {spg}, "
          f"pad_shape {tuple(cfg.loader['pad_shape'])}, optimizer "
          f"{dict(cfg.optimizer)}, grad_clip "
          f"{cfg.optimizer_config.get('grad_clip')}, lr_config "
          f"{dict(cfg.lr_config)}; {TRAIN_IMAGES} synthetic images, gts per "
          f"image {[len(s['gt_bboxes']) for s in samples]}; no NMS and no "
          f"RoIAlign on this path, so no kernel of the port launches")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()

    # (a) train_detector, launches counted from zero
    model, init, launches = train_run(card, "7", cfg, samples, TRAIN_EPOCHS,
                                      RETINA_TRAIN_LAUNCHES,
                                      {"num_pos": spg})

    # (b) the card against the CPU on one step
    collator = DetCollator(tuple(cfg.loader["pad_shape"]),
                           max_gt=int(cfg.loader["max_gt"]),
                           max_gt_ignore=int(cfg.loader["max_gt_ignore"]))
    collated = collator(samples[:spg])
    batch = batch_to_device(collated, DEVICE)
    card_m, card_g = one_step(model, cfg, batch, seed=3)
    model.load_state_dict(init)
    cpu_m, cpu_g = one_step(train_model(cfg, device="cpu"), cfg,
                            batch_to_device(collated, "cpu"), seed=3,
                            device="cpu")
    loss_keys = [k for k in cpu_m if k.startswith("loss") or k == "num_pos"]
    errs = {k: abs(card_m[k] - cpu_m[k]) / max(abs(cpu_m[k]), 1e-30)
            for k in loss_keys}
    f32_worst = grad_error(card_g, cpu_g)
    del card_g, init
    _, card_g64 = double_step(cfg, collated, 3, DEVICE)
    _, cpu_g64 = double_step(cfg, collated, 3, "cpu")
    worst = grad_error(card_g64, cpu_g64)
    rounding = grad_error(cpu_g, cpu_g64)
    print("phase 7 one step, card vs CPU, float32 rel err: " + ", ".join(
        f"{k} {v:.3e}" for k, v in errs.items()) + f" (bar {LOSS_TOL}); "
        f"worst gradient error of its parameter's max |grad|: float64 "
        f"{worst:.3e} (bar {GRAD_TOL}), float32 {f32_worst:.3e} (not held; "
        f"the CPU's float32 against its float64: {rounding:.3e})")
    if max(errs.values()) > LOSS_TOL or worst > GRAD_TOL:
        raise AssertionError(f"card vs CPU: {card_m} vs {cpu_m}, gradient "
                             f"{worst}")
    del cpu_g, card_g64, cpu_g64

    # (c) timing
    _, profile = time_step(card, "7", "retinanet_c_train", cfg, model, batch,
                           held, spg)
    return launches, profile


# ------------------------------------------ phase 8: Mask R-CNN training
def coco_train_samples(rng, n, hw=None):
    """n training samples as a COCO dataset hands them to the collator: a
    normalised (H, W, 3) float32 image and 5-30 objects (COCO_OBJECTS) with
    log-uniform sides of 10-400 px (COCO_SIDES: small to large), aspect
    ratios around 1, labels of 80 classes, and for each object the ellipse
    inscribed in its box as an (H, W) uint8 bitmask."""
    h, w = hw or COCO_HW
    out = []
    for _ in range(n):
        k = rng.randint(COCO_OBJECTS[0], COCO_OBJECTS[1] + 1)
        side = np.exp(rng.uniform(*np.log(COCO_SIDES), k))
        aspect = np.exp(rng.normal(0.0, 0.4, k))
        bw = np.minimum(side * np.sqrt(aspect), w - 1)
        bh = np.minimum(side / np.sqrt(aspect), h - 1)
        x1, y1 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
        boxes = np.stack([x1, y1, x1 + bw, y1 + bh], 1).astype(np.float32)
        masks = np.zeros((k, h, w), np.uint8)
        for i, (a, b, c, d) in enumerate(boxes.astype(np.float64)):
            ya, yb = int(b), min(int(np.ceil(d)), h)
            xa, xb = int(a), min(int(np.ceil(c)), w)
            yy, xx = np.mgrid[ya:yb, xa:xb] + 0.5
            masks[i, ya:yb, xa:xb] = (((xx - (a + c) / 2) / ((c - a) / 2)) ** 2
                                      + ((yy - (b + d) / 2) / ((d - b) / 2))
                                      ** 2 <= 1.0)
        out.append(dict(img=rng.randn(h, w, 3).astype(np.float32),
                        gt_bboxes=boxes,
                        gt_labels=rng.randint(0, 80, k).astype(np.int64),
                        gt_masks=masks))
    return out


def step_rois(card, fwd, bwd):
    """The K2 forward (torch.equal) and backward (within BWD_TOL) against
    their plain versions on one train step's recorded launches, with the
    rois on each kernel path, call times and bounds. Returns the forward's
    and the backward's records and the backward's inputs, one per forward
    launch."""
    f_rows, b_rows, b_inputs = [], [], []
    for (feats, rois, lvls, _, out, sr, *_), _, _ in fwd:
        feats = [f.detach() for f in feats]
        g = next(args[0] for args, _, _ in bwd if args[0].shape[-1] == out)
        shapes = [tuple(f.shape) for f in feats]
        name = f"mask_rcnn train step {'bbox' if out == 7 else 'mask'} rois"
        r = rois.shape[0]
        per_level = torch.bincount(lvls, minlength=len(ROI_LEVELS)).tolist()
        _, f_err = compare_roi_align(feats, rois, lvls, out, sr)
        f_paths = roi_paths(feats, rois, lvls, out, sr)
        err, share = compare_roi_align_backward(g, rois, lvls, shapes, out,
                                                sr)
        b_paths = backward_paths(g, rois, lvls, shapes, out, sr)
        f_ms, f_plain = time_roi_align(feats, rois, lvls, out, sr)
        f_bms, f_by = roi_align_bound(feats, rois, lvls, out, sr)
        b_ms, b_plain = time_roi_align_backward(g, rois, lvls, shapes, out,
                                                sr)
        b_bms, b_by = roi_align_backward_bound(r, g.shape[1], out, sr, shapes)
        print(f"phase 8 {name} (R={r}, S={out}, sr={sr}, per level "
              f"{per_level}): forward kernel == plain (torch.equal), paths "
              f"{shares(f_paths)}; backward kernel vs plain {err:.3e} "
              f"({share:.3e} of the level's max, bar {BWD_TOL}), paths "
              f"{shares(b_paths)}")
        print(f"phase 8 {name}: forward kernel {f_ms:.4f} ms (plain "
              f"{f_plain:.4f}, bound {f_bms:.4f} {f_by}), backward call "
              f"{b_ms:.4f} ms (plain {b_plain:.4f}, bound {b_bms:.4f} {b_by})"
              f" [{card}]")
        f_rows.append(dict(shape=name, R=r, S=out, sr=sr, max_abs_err=f_err,
                           ms=f_ms, plain_ms=f_plain, bound_ms=f_bms,
                           bound_by=f_by, per_level=per_level,
                           paths=f_paths))
        b_rows.append(dict(shape=name, R=r, S=out, sr=sr, rois="train step",
                           max_abs_err=err, err_share=share, ms=b_ms,
                           plain_ms=b_plain, bound_ms=b_bms, bound_by=b_by,
                           per_level=per_level, paths=b_paths))
        b_inputs.append((g, rois, lvls, shapes, out, sr))
    return f_rows, b_rows, b_inputs


def phase_mask_train(card):
    """Phase 8: COCO Mask R-CNN training at full width
    (configs/coco/mask_rcnn_r50_fpn_1x_coco.py with its train_cfg,
    samples_per_gpu 2) with seeded weights, on synthetic 800x1333 images
    padded to 32 (`coco_train_samples`): (a) `train_detector` (launches per
    step {1, 1, 2, 2}, finite losses, loss_mask included, positives in both
    stages, frozen and trainable parameters: `train_run`); (b) one step
    with the kernels against one with the plain RoIAlign from the same
    weights and draws: equal losses, gradients within GRAD_TOL; (c) on that
    step's own launches, K2 forward (torch.equal) and backward (BWD_TOL)
    against their plain versions with paths, times and bounds, and K1
    alone at the step's RPN NMS (`k1_row`); (d) the card against the CPU
    on one step of one MASK_CPU_HW image (rpn_proposal max_per_img
    MASK_CPU_PROPOSALS, at most MASK_CPU_GTS gts, both samplers taking
    every candidate, the CPU fed the card's proposals, which must equal
    the plain NMS's): losses within LOSS_TOL; (e) train-step ms, img/s and
    peak memory. Returns the run's launches, the K1 and K2 records at the
    step's shapes and the profile (f) with the backward's device times,
    to be run after every timing."""
    from pointtinybenchmark_tpu_torch.data.loader import DetCollator
    from pointtinybenchmark_tpu_torch.engine.train import batch_to_device
    from pointtinybenchmark_tpu_torch.ops import nms_cuda, roi_align_cuda
    from pointtinybenchmark_tpu_torch.utils.config import Config

    cfg = Config.fromfile(str(MASK_CONFIG))
    spg = int(cfg.data["samples_per_gpu"])
    samples = coco_train_samples(np.random.RandomState(10), MASK_TRAIN_IMAGES)
    print(f"phase 8 training config: {MASK_CONFIG.name}, samples_per_gpu "
          f"{spg}, loader {dict(cfg.loader)}, optimizer "
          f"{dict(cfg.optimizer)}, rpn sampler "
          f"{dict(cfg.train_cfg['rpn']['sampler'])}, rpn_proposal "
          f"{dict(cfg.train_cfg['rpn_proposal'])}, rcnn sampler "
          f"{dict(cfg.train_cfg['rcnn']['sampler'])}; {MASK_TRAIN_IMAGES} "
          f"synthetic {COCO_HW} images, objects per image "
          f"{[len(s['gt_bboxes']) for s in samples]}, sides "
          f"{COCO_SIDES} px, 80 classes, an elliptical bitmask each")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()

    # (a) train_detector, launches counted from zero
    model, init, launches = train_run(card, "8", cfg, samples,
                                      MASK_TRAIN_EPOCHS, MASK_TRAIN_LAUNCHES,
                                      {"rpn_num_pos": spg, "rcnn_num_pos": 0})
    collator = DetCollator(None, int(cfg.loader["size_divisor"]),
                           max_gt=int(cfg.loader["max_gt"]))
    batch = batch_to_device(collator(samples[:spg]), DEVICE)
    print(f"phase 8 batch: img {tuple(batch['img'].shape)}, gt_masks "
          f"{tuple(batch['gt_masks'].shape)} {batch['gt_masks'].dtype}")

    # (b) one step with the kernels against one with the plain RoIAlign
    # (forward and backward), from the same weights and draws; the kernel
    # step's launches are recorded for (c)
    torch.backends.cudnn.deterministic = True
    fwd, bwd, bits, walks = [], [], [], []
    reset_launches()
    with recorded(roi_align_cuda, "roi_align_forward", fwd), \
            recorded(roi_align_cuda, "roi_align_backward", bwd), \
            recorded(nms_cuda, "iou_bitmask", bits), \
            recorded(nms_cuda, "greedy_reduce", walks):
        got, got_grads = one_step(model, cfg, batch, seed=3)
    k_launches = read_launches()
    model.load_state_dict(init)
    reset_launches()
    with plain_roi_align():
        want, want_grads = one_step(model, cfg, batch, seed=3)
    p_launches = read_launches()
    model.load_state_dict(init)
    torch.backends.cudnn.deterministic = False
    loss_keys = [k for k in want if k.startswith("loss") or "num_pos" in k]
    worst = grad_error(got_grads, want_grads)
    print(f"phase 8 one step, kernels vs plain RoIAlign: launches "
          f"{k_launches} vs {p_launches}; " + ", ".join(
              f"{k} {got[k]:.6f}" for k in loss_keys) + f"; losses equal: "
          f"{all(got[k] == want[k] for k in loss_keys)}; worst gradient "
          f"error {worst:.3e} of its parameter's max |grad| (bar "
          f"{GRAD_TOL})")
    if k_launches != MASK_TRAIN_LAUNCHES or p_launches["roi_align"] \
            or p_launches["roi_align_backward"]:
        raise AssertionError(f"launches {k_launches}, plain {p_launches}")
    if any(got[k] != want[k] for k in loss_keys) or worst > GRAD_TOL:
        raise AssertionError(f"kernels vs plain: {got} vs {want}, gradient "
                             f"{worst}")
    del got_grads, want_grads

    # (c) the kernels on the step's own launches
    f_rows, b_rows, b_inputs = step_rois(card, fwd, bwd)
    (sboxes, thr, n_valid), _, _ = bits[0]
    (_, ok, order, max_out, _), _, _ = walks[0]
    if max_out != MAX_OUT:
        raise AssertionError(f"the RPN's NMS keeps {max_out}, not {MAX_OUT}")
    k1 = k1_row(card, "mask_rcnn train step RPN", sboxes, ok, order, n_valid,
                thr, phase="8")
    del fwd, bwd, bits, walks

    # (d) the card against the CPU on one step of one smaller image
    small = coco_train_samples(np.random.RandomState(11), 1, MASK_CPU_HW)
    small_collator = DetCollator(None, int(cfg.loader["size_divisor"]),
                                 max_gt=MASK_CPU_GTS)
    small_batch = small_collator(small)
    hw = small_batch["img"].shape[1:3]
    anchors = 3 * sum(-(-hw[0] // s) * -(-hw[1] // s)
                      for s in (4, 8, 16, 32, 64))

    def prepare(m):
        m.train_proposal_cfg["max_per_img"] = MASK_CPU_PROPOSALS
        covering_budgets(m, anchors, MASK_CPU_GTS)
        return m
    prepare(model)
    calls = []
    with recorded(model.rpn_head, "get_proposals", calls):
        card_m, _ = one_step(model, cfg, batch_to_device(small_batch, DEVICE),
                             seed=4)
    args, kwargs, got_props = calls[0]
    with torch.no_grad(), plain_nms():
        want_props = model.rpn_head.get_proposals(*args, **kwargs)
    torch.cuda.synchronize()
    same = all(torch.equal(g, w) for g, w in zip(got_props, want_props))
    print(f"phase 8 (d) the step's proposals ({tuple(hw)} image, "
          f"{got_props[0].shape[1]} proposals, valid "
          f"{got_props[2].sum(1).tolist()}): NMS kernels == plain NMS "
          f"(torch.equal): {same}")
    if not same:
        raise AssertionError("the train step's proposals differ from those "
                             "of the plain NMS")
    cpu_model = prepare(train_model(cfg, device="cpu"))
    props = tuple(t.cpu() for t in got_props)
    cpu_model.rpn_head.get_proposals = lambda *a, **k: props
    cpu_m, _ = one_step(cpu_model, cfg, batch_to_device(small_batch, "cpu"),
                        seed=4, device="cpu")
    errs = {k: abs(card_m[k] - cpu_m[k]) / max(abs(cpu_m[k]), 1e-30)
            for k in loss_keys}
    print(f"phase 8 (d) one step, card vs CPU (one {tuple(hw)} image, "
          f"{len(small[0]['gt_bboxes'])} gts, rpn_proposal max_per_img "
          f"{MASK_CPU_PROPOSALS}, every candidate sampled, the card's "
          f"proposals), rel err: " + ", ".join(
              f"{k} {v:.3e}" for k, v in errs.items()))
    if max(errs.values()) > LOSS_TOL:
        raise AssertionError(f"card vs CPU: {card_m} vs {cpu_m}")
    del cpu_model, calls, props, args, kwargs, got_props, want_props, init
    model = train_model(cfg)

    # (e) timing
    numbers, step_profile = time_step(card, "8", "mask_rcnn_train", cfg,
                                      model, batch, held, spg)

    def profile():
        """(f) a profile of warm steps, then the backward's device time on
        the step's rois."""
        step_profile()
        for rec, args in zip(b_rows, b_inputs):
            add_device_ms(card, rec, *args, phase="8")
    return launches, k1, f_rows, b_rows, profile


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs on a CUDA card only")
    from pointtinybenchmark_tpu_torch.ops import (cuda_build, nms_cuda,
                                                  roi_align_cuda)

    t_start = time.perf_counter()
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
    roi_shapes = phase_roi_align(card)
    frames = np.random.RandomState(1).randint(
        0, 256, (N_FRAMES,) + FRAME_HW + (3,), np.uint8)
    retina_launches, retina, tiles, stage = phase_slice(card, frames)
    phase_timing(card, retina, frames, tiles, stage)
    del tiles, stage
    frcnn_launches, frcnn, slice_record = phase_frcnn(card, frames)
    mask_launches, mask, mask_records = phase_mask(card, frames)
    bwd_shapes, bwd_device_times = phase_roi_align_backward(card)
    train_launches, train_fwd, train_bwd, train_profile = phase_train(card)
    retina_train_launches, retina_train_profile = phase_retina_train(card)
    (mask_train_launches, mask_train_k1, mask_train_fwd, mask_train_bwd,
     mask_train_profile) = phase_mask_train(card)
    # the profiles last: once torch.profiler has traced the card, later
    # launches of the process can cost more host time (phase 6 times the
    # train step before and after them)
    phase_profile(card, retina, frames, "retinanet")
    phase_profile(card, frcnn, frames, "faster_rcnn")
    phase_profile(card, mask, frames, "mask_rcnn")
    train_profile()
    bwd_device_times()
    retina_train_profile()
    mask_train_profile()
    for k in ("iou_bitmask", "greedy_reduce"):
        records[k]["by_shape"].append(mask_train_k1[k])
    records["roi_align"] = dict(
        slice_record, by_shape=roi_shapes + [slice_record] + mask_records
        + [train_fwd] + mask_train_fwd)
    records["roi_align_backward"] = dict(
        train_bwd, by_shape=bwd_shapes + [train_bwd] + mask_train_bwd)

    by_path = {"adap_retinanet_c": retina_launches,
               "faster_rcnn": frcnn_launches, "mask_rcnn": mask_launches,
               "faster_rcnn_train": train_launches,
               "adap_retinanet_c_train": retina_train_launches,
               "mask_rcnn_train": mask_train_launches}
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=KERNELS[name][0],
             replaces=KERNELS[name][1],
             launches=sum(n[name] for n in by_path.values()),
             launches_by_path={k: n[name] for k, n in by_path.items()},
             library_ms=None, **records[name])
        for name in KERNELS]}))
    print(f"smoke wall time {time.perf_counter() - t_start:.1f} s (host "
          f"clock, the kernels' build included)")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
