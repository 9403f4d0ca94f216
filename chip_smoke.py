#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the kernels of ops/csrc with nvcc (one nvcc per source, started
together), then runs forty main paths, the tiled protocol of Adap
RetinaNet-c, Adap Faster R-CNN, COCO Mask R-CNN, Adap P2P, Adap FCOS, Adap
ATSS, Adap RepPoints, Adap FoveaBox, Adap FreeAnchor, Adap VFNet and Adap
Grid R-CNN, each on two 1920x1080 uint8 frames, the training of Adap
Faster R-CNN, Adap RetinaNet-c, COCO Mask R-CNN, P2P, CPR, P2BNet, SSD-Det,
FCOS, ATSS, RepPoints, FoveaBox, FreeAnchor, VFNet and Grid R-CNN,
the refinement of CPR, P2BNet and SSD-Det, Adap Faster R-CNN's train
and test command-line tools on a TinyPerson-format dataset, the Scale
Match pretraining of Faster R-CNN and RetinaNet through the train CLI,
and the workflow tools (CPR -> result2ann -> P2P with a resumed run, VOC
Faster R-CNN, the standalone RPN, whole-image and TTA inference, the
offline tile merge):

1. kernel vs plain, NMS: the IoU-bitmask and greedy-reduce kernels against
   their plain PyTorch version on the card, on synthetic TinyPerson-like
   boxes: `batched_nms` at the per-tile shape (B=12, N=8,720) and the
   global-merge shape (B=2, N=12,000, class offsets), keep sets identical;
   then each kernel alone at every launch shape of both main paths
   (K1_SHAPES), kernel A's defined bits and kernel B's keep sets identical,
   with times, bounds and the walk's serial steps; and on box pairs whose
   IoU is the threshold or one of its float neighbours, also moved right by
   the largest class offset of an 80-class NMS, and on pairs of 16x16
   boxes (P2P's pseudo boxes) at P2P's threshold 0.01, with and without
   that offset (`square_tie_boxes`);
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
   the FCN mask head on S=14 sr=2 crops of every detection slot; the
   seeded draw detects as it is): launches
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
   step's rois;
9. Adap P2P on TinyPerson (configs/tinyperson/p2p_r50_fpns4_1x_
   tinyperson640.py at full width: ResNet-50, FPN-256 at stride 4 only,
   P2PHead with 4+4 GN(32) convs) with seeded weights and cls_out.bias set
   to 0 so that candidates pass score_thr: (a) `inference_detector_tiled`
   on the two frames: launches {iou_bitmask: 2, greedy_reduce: 2} (the
   per-tile pseudo-box NMS at IoU 0.01, the global merge), candidates and
   kept points per tile, merged detections and points equal to those with
   the plain NMS, the head's outputs against the CPU on one tile, K1 alone
   against its plain version on the run's own two launches, protocol and
   forward-only img/s; (b) `train_detector` (Adam, the top-k auction at
   topk_k 5) for 20 iterations on 4 synthetic 512x640 images with 20-200
   TinyPerson-like gts: no kernel launch, finite losses, num_pos a
   multiple of topk_k and equal to topk_k x the valid gts of a step, the
   frozen stem and layer1 bit-identical and the rest changed; the auction's
   rounds, iterations and host reads per step; the card's auction equal to
   the CPU's on the card's own cost matrix (both stopped at
   AUCTION_CPU_ITERS iterations a round); the CPU's step, fed the card's
   assignment, against the card's; the auction's ms, train-step ms, img/s,
   peak memory and a profile (GroupNorm's share among the families);
10. CPR on TinyPersonV2 (configs/tinypersonv2/cpr/coarse_point_refine_r50_
   fpns4_1x_tinypersonv2_640.py at full width) with seeded weights and
   cls_out.bias set to 0 so that bag scores pass merge_th: (a)
   `run_test`'s counterpart `run_refine_test` on 8 640x640 images with 50
   coarse points each (no kernel launch; every row's ids, finite points
   within the bag radius), `refine_test` on the card against the CPU on
   one image (points, scores, not_refine), img/s; (b) `train_detector` at
   random_remove_rate 0.4 (the bag-point drop drawn from the step's
   generator) for 10 iterations of 2 images with 20-200 gts: finite
   losses; one step at rate 0 on the card against the CPU; train-step ms,
   img/s, peak memory; profiles of both paths;
11. P2BNet and SSD-Det on COCO (configs/p2b/, configs/ssd_det/ at full
   width: ResNet-50, FPN-256 from stride 4, two MIL stages of 2 FCs of
   1,024 on S=7 sr=2 RoIAlign, 80 classes) with seeded weights: (a) the
   roi-coordinate kernel (RoIAlign's gradient in x1, y1, x2, y2), K2
   forward and backward against their plain versions (the roi-coordinate
   one within ROIS_BWD_TOL of each column's max; the backward against the
   plain version in float64, within BWD_TOL of a level's max or twice the
   plain float32 version's own error) on channels-last FPN maps of two
   800x1344 images at P2BNet's stage-0 bags (points and the padding's
   origin), its
   negatives and `edge_rois` with `bound_tie_rois` (samples exactly on the
   clamp bounds), and at S=7 sr=BUDGET_SR on level-0 rois up to the whole
   image (`budget_rois`), with times and bounds; each roi-coordinate launch
   repeated bit for bit, its rois per path (grid staged whole, in bands,
   read from global memory, invalid: each path taken); (b)-(d)
   `phase_p2b`: P2BNet's
   `train_detector` (launches {K2 3, backward 3, roi-coordinate 2} a
   step), the three kernels on the step's own launches, a step against
   the plain RoIAlign and against the CPU, step ms, `run_refine_test`
   against the all-plain run, refine img/s; SSD-Det's step and
   refinement; (f) `phase_seeded`: the port's seeded weights train, 16
   SGD steps of each config's schedule from `build_detector(seed=0)`
   (P2BNet held: finite, and the last 4 losses' mean below the first 4's;
   SSD-Det printed); (e) `phase_learn`: tests/test_models_p2b.py's two
   learnability scenarios on the card from that test's initial weights,
   several runs in parallel processes, held on their means: P2BNet's to
   the test's floors, SSD-Det's to JAX's own perturbed runs' mean (within
   LEARN_SE standard errors) and above the noisy boxes' IoU;
12. the dense TinyPerson baselines, FCOS, ATSS, RepPoints, FoveaBox,
   FreeAnchor and VFNet (configs/tinyperson/{fcos,atss,reppoints,fovea,
   free_anchor,vfnet}_r50_fpns4_1x_tinyperson640.py at full width:
   ResNet-50, FPN-256 from stride 4; GN heads, FoveaBox's biased convs
   without a norm, FreeAnchor's RetinaNet-c head with its bag loss,
   VFNet's star gathers and varifocal loss) with seeded weights:
   (a) `phase_dense`, the classifier's bias set to 0 (what the seeded
   weights keep before is printed): `inference_detector_tiled` on the two
   frames, launches {iou_bitmask: 2, greedy_reduce: 2}, detections equal
   to those with the plain NMS, K1 alone against its plain version on the
   run's own two launches (per tile B=24 N=5,680, VFNet's at thr 0.6,
   FreeAnchor's 9 anchors a cell N=8,720, the merge B=2 N=12,000), the
   card against the CPU on
   one tile (head outputs, and the
   detections at tests/test_detector_golden.py:88's tolerances), protocol
   and forward-only img/s, a protocol call's peak memory; (b)
   `phase_dense_train`: `train_run` for 8 iterations (no kernel launch,
   positives every step, for FreeAnchor a positive bag loss above 0, for
   VFNet a refined-box loss above 0, frozen stem and layer1
   bit-identical), FCOS's and VFNet's paramwise_cfg against a
   hand-computed update of a conv bias and a GroupNorm bias, one step on
   the card against the CPU (losses within LOSS_TOL), step ms, img/s and
   peak memory; RepPoints' and VFNet's gathers timed alone against the
   forward (`gather_share`); (c) profiles of warm protocol calls and steps
   with the others at the end (the gather and the index_add_ scatter of
   the deformable heads' sampling as families).
13. Adap Grid R-CNN (configs/tinyperson/grid_rcnn_r50_fpn_1x_
   tinyperson640.py at full width: Faster R-CNN's network and a grid head
   of 8 GN(36) 3x3 convs at 576, 9 point branches with first-order fusion
   and two transposed convs to 56x56 heat maps, on K2's S=14 sr=2 crops)
   with seeded weights, no random-weight fix: (a) `phase_grid`,
   `inference_detector_tiled` on the two frames, launches {iou_bitmask: 3,
   greedy_reduce: 3, roi_align: 2} (K2 at S=7 sr=1 for the proposals, at
   S=14 sr=2 for every valid detection slot), merged detections equal to
   those with every kernel swapped for its plain version, K2 torch.equal
   to its plain version on the protocol's own grid rois (PLAIN_CHUNK rois
   a call), the grid head on the card against the CPU's on GRID_CPU_ROIS
   rois of one tile, protocol and forward-only img/s over GRID_ITERS
   calls, the grid branch's share of the forward, the grid head's TFLOP/s,
   a protocol call's peak memory; (b) `phase_grid_train`: `train_run` for
   20 iterations (launches {1, 1, 2, 2} a step, no roi-coordinate launch:
   the jittered grid rois carry no gradient), one step with the kernels
   against one with the plain RoIAlign (equal losses, gradients within
   GRAD_TOL), K2 forward and backward on that step's bbox and grid rois
   against their plain versions, GRID_TIMED_STEPS steps from the seeded
   weights by CUDA events; (c) profiles with the others at the end, and
   the K2 forward's and backward's device times on the grid rois.
14. Adap Faster R-CNN from a dataset (`phase_dataset`): a synthetic
   TinyPerson-format set written to a temporary folder under build/
   (DATASET_TEST_FRAMES JPEG frames of 1920x1080 with 20-200 persons of
   2-20 px, some tagged ignore or uncertain; DATASET_TRAIN_FRAMES frames
   cut by the port's `generate_corner_dataset` into the config's 640x512
   corners with 100 px overlap); (a) the train CLI
   (`pointtinybenchmark_tpu_torch.tools.train`, the config at full width
   with `--cfg-options` for the data and an IterBasedRunner of
   DATASET_ITERS iterations): launches {1, 1, 1, 1} a step and {3, 3, 1,
   0} a validation frame, the loss finite at every logged step, it/s from
   the loader; the validation at the end by `run_tiled_test` and the tiny
   COCO evaluation; (b) the test CLI (`tools.test`) on its checkpoint:
   launches {3, 3, 1, 0} a frame, detections in `--out`, metrics equal to
   the train CLI's; (c) `run_tiled_test` with the kernels against the
   all-plain run (merged detections and metrics equal) and against
   `DeviceTiledInference` on the decoded frames (tests/
   test_detector_golden.py:88's tolerances), the dataset path's img/s,
   its host pipeline's share and parts, the device protocol's img/s on the
   same frames; (d) the evaluation's native and Python loops (equal stats,
   seconds each), and the gts as detections at score 1 (every AP*_all and
   AP*_tiny 1.0).
15. Scale Match pretraining (`phase_scale_match`): a synthetic
   COCO-format set (SM_TRAIN_IMAGES + SM_VAL_IMAGES JPEGs of 640x480 and
   480x640, 2-15 objects of 32-256 px of the 80 categories) and TinyPerson
   frames (the target distribution's json, and the tiled validation),
   laid out in a temporary folder under build/ where the configs name
   them (data/coco/..., data/tiny_set/...); from that folder the train CLI
   runs configs/tinyperson/scale_match/faster_rcnn_r50_fpn_1x_coco_msm_
   tinyperson.py (MonotonicityScaleMatch, 8 images a step: K1 1 + 1, K2
   and its backward 1 a step; validation by the tiled protocol, {3, 3, 1,
   0} a frame) and retinanet_r50_fpns4_1x_coco_sm_tinyperson.py
   (ScaleMatch, 4 images a step, no launch; validation by `run_test` at
   (333, 200), K1 1 + 1 an image), as written, for SM_ITERS iterations of
   an IterBasedRunner: launches, finite losses at every step, it/s from
   the loader, the validation's metrics; K1 and K2 (forward and backward)
   against their plain versions at the Faster R-CNN step's first launches;
   ScaleMatchResize's host ms a sample, the matched images'
   geometric-mean box sizes beside the target's, and the share of scales
   at a bound of scale_range.
16. The workflow tools (`phase_workflow`, in a temporary folder under
   build/): (a) CPR -> result2ann -> P2P through the port's CLIs on a
   synthetic TinyPersonV2-format point set (WF_TRAIN_FRAMES frames cut by
   `generate_corner_dataset` into 640x640 corners, 16x16 pseudo boxes
   round points drawn in each box's central quarter): the CPR config
   trained WF_CPR_ITERS iterations, its refinement by the test CLI
   (`--split val --out`), `tools.result2ann --wh 16`, the P2P config
   trained 2k iterations (k an epoch) on the refined json straight and
   stopped at k and continued with `--resume-from iter_k.pth` (last
   losses and weights of the two printed), the P2P tested by the test CLI
   on the test frames' corners with its cls_out.bias set to 0 as in
   phase 9 (K1 1 + 1 a corner, a point in every row of `--out`); K1 and
   K2 held to their plain versions at the first launch of each new
   launch shape of (a)-(e); (b) VOC Faster R-CNN
   (configs/voc/) through the train CLI on a synthetic VOC set (XML and
   JPEG, some `difficult`), its train set the two splits as a list of
   dataset configs (ConcatDataset), launches a step and a test image, step
   ms, the VOC07 mAP of random weights, K1 and K2 (forward and backward)
   against their plain versions at the step's first launches; (c) the
   standalone RPN (configs/coco/rpn_r50_fpn_1x_coco.py) through `run_test`
   on phase 15's COCO-format images, proposals equal to the plain NMS's,
   `proposal_fast`, K1 against its plain version at its first launch; (d)
   COCO Faster R-CNN on two 800x1333 images by `inference_detector` and
   by `run_tta_test` with a flip MultiScaleFlipAug, each equal to the
   all-plain run, the card against the CPU on one image; (e) phase 14's
   test set cut into its corners, `run_test` on every corner and the
   evaluation with `merge_after_infer_kwargs` (the host merge): the
   detections before and after the merge.

Float32 throughout with TF32 off (cuDNN would otherwise run the convolutions
in TF32). Every failure raises; there is no CPU mode. The last line is
{"ok": true, "device": {...}}; the line before it is the card's name and
power limit, and the line before that lists each kernel with its launches on
the main paths, its error against the plain version, its time, the plain
version's time and its bound (`by_shape`: K1 at every launch shape, the
Mask R-CNN train step's RPN NMS, the two protocol launches of P2P and of
the dense baselines, and phase 15's first launches; for
RoIAlign the phase-2 shapes, the slices' rois (Grid R-CNN's grid rois
included) and the train steps' rois (phase 15's too); for its backward
the phase-6 shapes and the train steps' rois; for the
roi-coordinate kernel phase 11 (a)'s shapes and the P2BNet step's two
launches; `ms` is whole wrapper calls
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
                   "roi_align_backward": 0, "roi_align_rois_backward": 0}
FRCNN_LAUNCHES = {"iou_bitmask": 3, "greedy_reduce": 3, "roi_align": 1,
                  "roi_align_backward": 0, "roi_align_rois_backward": 0}
MASK_LAUNCHES = {"iou_bitmask": 3, "greedy_reduce": 3, "roi_align": 2,
                 "roi_align_backward": 0, "roi_align_rois_backward": 0}
# phase 6: a train step of Faster R-CNN launches each kernel once (the RPN's
# proposal NMS, RoIAlign of the sampled rois and its backward)
TRAIN_LAUNCHES = {"iou_bitmask": 1, "greedy_reduce": 1, "roi_align": 1,
                  "roi_align_backward": 1, "roi_align_rois_backward": 0}
TRAIN_HW = (512, 640)            # the config's loader pad_shape
TRAIN_IMAGES = 4
TRAIN_EPOCHS = 5                 # 20 iterations at samples_per_gpu=1
TRAIN_TIMED_STEPS = 10
TRAIN_PROFILE_STEPS = 5
# phase 7: RetinaNet-c training runs no TPU kernel (no NMS, no RoIAlign)
RETINA_TRAIN_LAUNCHES = {"iou_bitmask": 0, "greedy_reduce": 0,
                         "roi_align": 0, "roi_align_backward": 0,
                         "roi_align_rois_backward": 0}
# phase 8: a Mask R-CNN train step launches K1 once (the RPN's proposal
# NMS), K2 forward and backward twice (the bbox rois, S=7 sr=2, and the
# mask rois, S=14 sr=2)
MASK_TRAIN_LAUNCHES = {"iou_bitmask": 1, "greedy_reduce": 1, "roi_align": 2,
                       "roi_align_backward": 2, "roi_align_rois_backward": 0}
MASK_TRAIN_IMAGES = 4
MASK_TRAIN_EPOCHS = 5            # 10 iterations at samples_per_gpu=2
# phase 9: Adap P2P on TinyPerson. Its protocol launches K1 twice, the
# per-tile pseudo-box NMS (IoU 0.01) and the global merge; its training
# and CPR's (phase 10) launch no kernel of the port
P2P_CONFIG = REPO / "configs/tinyperson/p2p_r50_fpns4_1x_tinyperson640.py"
P2P_LAUNCHES = {"iou_bitmask": 2, "greedy_reduce": 2, "roi_align": 0,
                "roi_align_backward": 0, "roi_align_rois_backward": 0}
NO_LAUNCHES = {"iou_bitmask": 0, "greedy_reduce": 0, "roi_align": 0,
               "roi_align_backward": 0, "roi_align_rois_backward": 0}
P2P_THR = 0.01                   # the config's pseudo-box NMS threshold
P2P_GTS = (20, 201)              # gts an image, TinyPerson-like
P2P_TRAIN_IMAGES = 4
P2P_TRAIN_EPOCHS = 5             # 20 iterations at samples_per_gpu=1
AUCTION_TIMED = 5
# the card's auction against the CPU's on the step's cost matrix, both
# stopped at this many iterations a round (then the greedy completion):
# the whole auction runs for tens of thousands of iterations there, too
# long for the CPU
AUCTION_CPU_ITERS = 128
# phase 10: CPR on TinyPersonV2: refinement of 8 640x640 images with 50
# coarse points each (16x16 pseudo boxes, the JAX bench's cpr shape), and
# training at samples_per_gpu 2
CPR_CONFIG = REPO / ("configs/tinypersonv2/cpr/"
                     "coarse_point_refine_r50_fpns4_1x_tinypersonv2_640.py")
CPR_HW = (640, 640)
CPR_IMAGES = 8
CPR_POINTS = 50
CPR_TRAIN_IMAGES = 4
CPR_TRAIN_EPOCHS = 5             # 10 iterations at samples_per_gpu=2
# phase 11: P2BNet and SSD-Det on COCO at full width. A train step runs
# three bag passes through RoIAlign (S=7 sr=2): stage 0's bag, stage 1's
# bag and the negatives; K2 forward and backward for each, and the
# roi-coordinate kernel for the two whose rois come from a merge (stage
# 1's bag and the negatives). Refinement runs the two bag passes only.
# phase 12: the dense TinyPerson baselines (name, config, classifier).
# Their protocol launches K1 twice (per-tile NMS, global merge), their
# training none
DENSE = (
    ("fcos", REPO / "configs/tinyperson/fcos_r50_fpns4_1x_tinyperson640.py",
     "conv_cls"),
    ("atss", REPO / "configs/tinyperson/atss_r50_fpns4_1x_tinyperson640.py",
     "atss_cls"),
    ("reppoints",
     REPO / "configs/tinyperson/reppoints_r50_fpns4_1x_tinyperson640.py",
     "cls_out"),
    ("fovea", REPO / "configs/tinyperson/fovea_r50_fpns4_1x_tinyperson640.py",
     "conv_cls"),
    ("free_anchor",
     REPO / "configs/tinyperson/free_anchor_r50_fpns4_1x_tinyperson640.py",
     "retina_cls"),
    ("vfnet", REPO / "configs/tinyperson/vfnet_r50_fpns4_1x_tinyperson640.py",
     "vfnet_cls"))
# what each dense baseline's training must keep above 0 in every step: the
# positives, or for FreeAnchor, whose num_pos counts the gts, the positive
# bag loss, and for VFNet, whose num_pos is at least 1 by its clamp, the
# refined boxes' GIoU loss (0 without a positive)
DENSE_POSITIVES = {"free_anchor": {"loss_positive_bag": 0},
                   "vfnet": {"loss_bbox_rf": 0}}
# the head's sampling methods of the deformable heads: RepPoints' 9 taps
# at its initial points, VFNet's star at its initial box
GATHERS = ("deform_gather", "star_gather")
DENSE_STRIDES = (4, 8, 16, 32, 64)
DENSE_TRAIN_EPOCHS = 2           # 8 iterations at samples_per_gpu=1
# phase 13: Adap Grid R-CNN, Faster R-CNN's network with a grid head on
# K2's S=14 sr=2 crops: of every valid detection slot in the protocol
# (after the RPN's and the RoI head's NMS, so K1 3 + 3 and K2 2 a call),
# of the 96 jittered sampled rois of a train step (K2 and its backward
# twice a step: the bbox rois at S=7 sr=1 and the grid rois; the proposals
# carry no gradient, so no roi-coordinate launch)
GRID_CONFIG = REPO / "configs/tinyperson/grid_rcnn_r50_fpn_1x_tinyperson640.py"
GRID_LAUNCHES = {"iou_bitmask": 3, "greedy_reduce": 3, "roi_align": 2,
                 "roi_align_backward": 0, "roi_align_rois_backward": 0}
GRID_TRAIN_LAUNCHES = {"iou_bitmask": 1, "greedy_reduce": 1, "roi_align": 2,
                       "roi_align_backward": 2, "roi_align_rois_backward": 0}
# a protocol call runs the grid head on every valid slot (~6 s at full
# width on random weights, which keep ~1,000 slots a tile): warm calls
# timed, warm calls profiled, and rois of one tile held against the CPU's
# grid head
GRID_ITERS = 1
GRID_PROFILE_CALLS = 1
GRID_CPU_ROIS = 16
GRID_TIMED_STEPS = 20
# calls of a kernel traced for its device time
DEVICE_MS_CALLS = 20
# phase 14: Adap Faster R-CNN from a dataset, through the port's train and
# test CLIs: a synthetic TinyPerson-format set (JPEG frames of 1920x1080,
# 20-200 persons of 2-20 px each in disjoint DATASET_CELL-px cells, so that
# no two gts overlap; ~10% tagged ignore, ~5% uncertain), its train frames
# cut into the config's sw640_sh512 corners with 100 px overlap
DATASET_TEST_FRAMES = 8
DATASET_TRAIN_FRAMES = 4
DATASET_PERSONS = (20, 201)
DATASET_SIDES = (2.0, 20.0)
DATASET_CELL = 24
DATASET_CORNER = dict(sub_img_w=640, sub_img_h=512, overlap_w=100,
                      overlap_h=100)
DATASET_ITERS = 40               # an IterBasedRunner at samples_per_gpu=1
# a frame of the tiled test: K1 for the RPN NMS, the RoI head's NMS and the
# global merge, K2 once
DATASET_FRAME_LAUNCHES = {"iou_bitmask": 3, "greedy_reduce": 3,
                          "roi_align": 1, "roi_align_backward": 0,
                          "roi_align_rois_backward": 0}
# phase 15: Scale Match pretraining through the train CLI, each config as
# written, run from a folder that holds its `data/` files: a synthetic
# COCO-format set (SM_TRAIN_IMAGES + SM_VAL_IMAGES JPEGs of 640x480 and
# 480x640, 2-15 objects of 32-256 px of the 80 categories) and TinyPerson
# frames (the target distribution's json, and Faster R-CNN's tiled
# validation); (name, config, launches a step, launches a validation
# image, validation images)
SM_DIR = REPO / "configs/tinyperson/scale_match"
SM_TRAIN_IMAGES = 32
SM_VAL_IMAGES = 4
SM_TARGET_FRAMES = 3
SM_TINY_VAL_FRAMES = 2
SM_OBJECTS = (2, 16)
SM_SIDES = (32.0, 256.0)
SM_ITERS = 20                    # an IterBasedRunner
SM_RUNS = (
    ("faster_rcnn_msm", SM_DIR / "faster_rcnn_r50_fpn_1x_coco_msm_tinyperson.py",
     TRAIN_LAUNCHES, DATASET_FRAME_LAUNCHES, SM_TINY_VAL_FRAMES),
    # run_test: one multiclass_nms an image
    ("retinanet_sm", SM_DIR / "retinanet_r50_fpns4_1x_coco_sm_tinyperson.py",
     NO_LAUNCHES, dict(NO_LAUNCHES, iou_bitmask=1, greedy_reduce=1),
     SM_VAL_IMAGES))
# COCO's 80 category ids
COCO_IDS = tuple(i for i in range(1, 91) if i not in
                 (12, 26, 29, 30, 45, 66, 68, 69, 71, 83))
# phase 16: the workflow tools. (a) CPR -> result2ann -> P2P through the
# CLIs on TinyPersonV2-format corner tiles of WF_TRAIN_FRAMES frames (640x640
# with 100 px overlap, 16x16 pseudo boxes round points drawn in the central
# quarter of each box), CPR trained WF_CPR_ITERS iterations, P2P 2k
# iterations (k an epoch) straight and stopped at k and resumed
WF_P2P_CONFIG = REPO / ("configs/tinypersonv2/p2p/"
                        "p2p_r50_fpns4_1x_fl_sl1_tinypersonv2_640.py")
WF_TRAIN_FRAMES = 2
WF_TEST_FRAMES = 2
WF_CORNER = dict(sub_img_w=640, sub_img_h=640, overlap_w=100, overlap_h=100)
WF_CPR_ITERS = 4
# P2P's get_bboxes: one pseudo-box NMS an image (run_test, batches of 1)
WF_P2P_TEST_LAUNCHES = dict(NO_LAUNCHES, iou_bitmask=1, greedy_reduce=1)
# (b) VOC Faster R-CNN: VOC07 and VOC12 trainval (the list form of
# voc0712.py, as ConcatDataset) and VOC07 test, JPEGs of 500x375 and
# 375x500 with 2-6 objects of the 20 classes, ~20% difficult
VOC_CONFIG = REPO / "configs/voc/faster_rcnn_r50_fpn_1x_voc0712.py"
VOC_TRAIN_IMAGES = 6             # a split
VOC_TEST_IMAGES = 4
VOC_ITERS = 8
# run_test of a two-stage detector: the RPN's and the RoI head's NMS and
# one RoIAlign an image
TWO_STAGE_IMAGE_LAUNCHES = dict(NO_LAUNCHES, iou_bitmask=2, greedy_reduce=2,
                                roi_align=1)
# (c) the standalone RPN on phase 15's COCO-format images
RPN_CONFIG = REPO / "configs/coco/rpn_r50_fpn_1x_coco.py"
RPN_IMAGES = 4
# (d) COCO Faster R-CNN, whole images and flip TTA
COCO_FRCNN_CONFIG = REPO / "configs/coco/faster_rcnn_r50_fpn_1x_coco.py"
TTA_IMAGE_LAUNCHES = dict(NO_LAUNCHES, iou_bitmask=3, greedy_reduce=3,
                          roi_align=1)
# (d)'s classifier fix: e^4 / (8 e^4 + 73) ~ 0.107 for each lifted class
LIFT_CLASSES = 8
LIFT_BIAS = 4.0
# phase 17: Cascade R-CNN, the V1.x legacy configs, the last datasets and
# transforms. (a) Cascade R-CNN on two COCO_HW images: the RPN's and the
# final NMS, one RoIAlign a stage; a train step: the RPN's NMS, each
# stage's RoIAlign and its backward
CASCADE_CONFIG = REPO / "configs/coco/cascade_rcnn_r50_fpn_1x_coco.py"
CASCADE_IMAGE_LAUNCHES = dict(NO_LAUNCHES, iou_bitmask=2, greedy_reduce=2,
                              roi_align=3)
CASCADE_TRAIN_LAUNCHES = dict(NO_LAUNCHES, iou_bitmask=1, greedy_reduce=1,
                              roi_align=3, roi_align_backward=3)
CASCADE_TRAIN_IMAGES = 2         # samples_per_gpu
CASCADE_KINDS = ((7, "bbox s0"), (7, "bbox s1"), (7, "bbox s2"))
# (b) the V1.x configs: RoIAlign aligned=False, the legacy coder and anchors
LEGACY_RUNS = (
    ("legacy_cascade", REPO / "configs/legacy_1x/"
     "cascade_mask_rcnn_r50_fpn_1x_coco_v1.py", CASCADE_IMAGE_LAUNCHES,
     CASCADE_TRAIN_LAUNCHES, CASCADE_KINDS),
    ("legacy_mask_rcnn", REPO / "configs/legacy_1x/"
     "mask_rcnn_r50_fpn_1x_coco_v1.py", dict(
         NO_LAUNCHES, iou_bitmask=2, greedy_reduce=2, roi_align=2),
     MASK_TRAIN_LAUNCHES, ((7, "bbox"), (14, "mask"))))
EDGE_TILES = 2
# (c) the train CLI: CLI_ITERS iterations of an IterBasedRunner on
# CLI_TRAIN_IMAGES synthetic COCO-format JPEGs with masks, validation on
# CLI_VAL_IMAGES at the end (run_test, one image a batch)
CLI_ITERS = 4
CLI_TRAIN_IMAGES = 4
CLI_VAL_IMAGES = 2
MASK_IMAGE_LAUNCHES = dict(NO_LAUNCHES, iou_bitmask=2, greedy_reduce=2,
                           roi_align=2)
CITYSCAPES_CLASSES = ("person", "rider", "car", "truck", "bus", "train",
                      "motorcycle", "bicycle")
DEEPFASHION_CLASSES = ("top", "skirt", "leggings", "dress", "outer", "pants",
                       "bag", "neckwear", "headwear", "eyeglass", "belt",
                       "footwear", "hair", "skin", "face")
CLI_RUNS = (
    ("instaboost_cascade", REPO / "configs/instaboost/cascade_mask_rcnn_r50_"
     "fpn_instaboost_4x_coco.py", CASCADE_TRAIN_LAUNCHES,
     CASCADE_IMAGE_LAUNCHES, None),
    ("instaboost_mask_rcnn", REPO / "configs/instaboost/mask_rcnn_r50_fpn_"
     "instaboost_4x_coco.py", MASK_TRAIN_LAUNCHES, MASK_IMAGE_LAUNCHES, None),
    ("albu_mask_rcnn", REPO / "configs/albu_example/mask_rcnn_r50_fpn_albu_"
     "1x_coco.py", MASK_TRAIN_LAUNCHES, MASK_IMAGE_LAUNCHES, None),
    ("deepfashion_mask_rcnn", REPO / "configs/deepfashion/mask_rcnn_r50_fpn_"
     "15e_deepfashion.py", MASK_TRAIN_LAUNCHES, MASK_IMAGE_LAUNCHES,
     DEEPFASHION_CLASSES),
    ("cityscapes_faster_rcnn", REPO / "configs/cityscapes/faster_rcnn_r50_"
     "fpn_1x_cityscapes.py", TRAIN_LAUNCHES, TWO_STAGE_IMAGE_LAUNCHES,
     CITYSCAPES_CLASSES))
GHM_CONFIG = REPO / "configs/coco/retinanet_ghm_r50_fpn_1x_coco.py"
# the JAX package's reasons (its GHMC takes label_weight, not weight=; its
# SeesawLoss takes the C foreground logits, the RoI head hands it C + 1)
GHM_REASON = "GHMC.__call__() got an unexpected keyword argument 'weight'"
SEESAW_REASON = ("mul got incompatible shapes for broadcasting: (1024, "
                 "1204), (1024, 1203).")
# (d) the LVIS Seesaw config: 1,203 classes; e^8 / (8 e^8 + 1,196) ~ 0.12
# for each lifted class, over the config's score_thr of 0.05
LVIS_CONFIG = REPO / "configs/coco/faster_rcnn_r50_fpn_seesaw_1x_lvis.py"
LVIS_CLASSES = 1203
LVIS_IMAGES = 2
LVIS_LIFT_BIAS = 8.0
P2B_CONFIG = REPO / "configs/p2b/p2bnet_r50_fpn_1x_coco.py"
SSD_CONFIG = REPO / "configs/ssd_det/ssd_det_r50_fpn_1x_coco.py"
P2B_TRAIN_LAUNCHES = {"iou_bitmask": 0, "greedy_reduce": 0, "roi_align": 3,
                      "roi_align_backward": 3, "roi_align_rois_backward": 2}
P2B_REFINE_LAUNCHES = {"iou_bitmask": 0, "greedy_reduce": 0, "roi_align": 2,
                       "roi_align_backward": 0, "roi_align_rois_backward": 0}
P2B_TRAIN_IMAGES = 4
P2B_TRAIN_EPOCHS = 1             # 2 iterations at samples_per_gpu=2
P2B_REFINE_IMAGES = 8
P2B_LEVELS = ((200, 336), (100, 168), (50, 84), (25, 42))   # 800x1344
# the card against the CPU: one image of this size, at most this many gts
P2B_CPU_HW = (400, 667)
P2B_CPU_GTS = 12
# plain RoIAlign versions on the card run on at most this many rois a call
PLAIN_CHUNK = 2048
# timed calls of the plain K2 backward at phase 11's bags, after a warm
# one (1-8 s a call: torch's index_add on the padding's origin cells)
P2B_PLAIN_BWD_ITERS = 1
# the roi-coordinate kernel against its plain version: each coordinate
# column within this share of its max |gradient| (the kernel sums a roi's
# samples and channels in another order than autograd)
ROIS_BWD_TOL = 1e-4
# (f) SGD steps of the port's seeded P2BNet and SSD-Det
P2B_SEEDED_STEPS = 16
# phase 11 (a)'s rois on level 0 up to the whole image: their count, and
# a sampling ratio other than P2BNet's, at which their grids exceed the
# roi-coordinate kernel's shared memory (S = 7: 42 samples an axis)
BUDGET_ROIS = 48
BUDGET_SR = 6
# (e) tests/test_models_p2b.py's learnability scenarios
# (learnability_p2b.py): the test's floors are met by JAX's one float
# trajectory from its initial draw, not robustly (its runs from the draw
# perturbed by 1e-7 to 3e-6 of each parameter spread widely), so the port
# runs several trajectories from the draw (the card's float atomics make
# each differ) and is held on their means: LEARN_PROCS processes a
# scenario, in parallel, of LEARN_RUNS runs each
LEARN_PROCS = {"P2BNet": 4, "SSDDet": 4}
LEARN_RUNS = 2
# JAX's runs from the draw perturbed by 1e-7 to 3e-6 (learnability_p2b.py
# --jax --perturb, on the CPU): their number, the mean and the sample
# standard deviation of the pseudo boxes' mean IoU, and how many met the
# floors. SSD-Det's port mean is held to no more than LEARN_SE standard
# errors of the difference of the two means below JAX's
LEARN_JAX = {"P2BNet": (7, 0.5056, 0.0347, 6),
             "SSDDet": (11, 0.5430, 0.1946, 8)}
LEARN_SE = 2.0
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
    # no Pallas counterpart: XLA's autodiff of the JAX RoIAlign in the rois
    "roi_align_rois_backward": (
        "pointtinybenchmark_tpu_torch/ops/csrc/roi_align_kernel.cu",
        "pointtinybenchmark_tpu/ops/roi_align.py:111"),
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
# traces of one profile, taken again where one lost the device activity
PROFILE_ATTEMPTS = 3
# substrings of device kernel names, first match wins; cuDNN runs some
# convolutions through FFTs (complex GEMMs and products), a convolution's
# data gradient as dgrad (in inference: the mask head's transposed
# convolution) and its weight gradient as wgrad; the optimizer's _foreach
# updates run as multi_tensor_apply kernels
KERNEL_FAMILIES = (
    ("iou_bitmask", "NMS kernel A iou_bitmask"),
    ("greedy_reduce", "NMS kernel B greedy_reduce"),
    ("roi_align_rois_backward", "RoIAlign roi-coordinate kernel"),
    ("roi_align_backward", "RoIAlign backward kernel"),
    ("roi_align", "RoIAlign kernel"),
    ("cf32", "convolution by FFT"), ("complex", "convolution by FFT"),
    ("fft", "convolution by FFT"),
    ("dgrad", "convolution dgrad (data gradient)"),
    ("wgrad", "convolution wgrad (weight gradient)"),
    ("multi_tensor_apply", "optimizer (foreach elementwise)"),
    ("rowwisemoments", "GroupNorm"), ("computefusedparams", "GroupNorm"),
    ("groupnorm", "GroupNorm"), ("group_norm", "GroupNorm"),
    ("computeinternalgradients", "GroupNorm"),
    ("backwardfusedparams", "GroupNorm"), ("gammabeta", "GroupNorm"),
    ("sort", "sort"),
    ("nhwctonchw", "cuDNN layout transpose"),
    ("nchwtonhwc", "cuDNN layout transpose"),
    ("memcpy", "memcpy"), ("memset", "memset"),
    ("batch_norm", "BN inference"), ("bn_", "BN inference"),
    ("fprop", "convolution"), ("conv", "convolution"),
    ("winograd", "convolution"),
    ("gemm", "matrix product (cuBLAS)"), ("xmma", "convolution"),
    ("vectorized_gather", "row gather (index_select)"),
    ("indexselect", "row gather (index_select)"),
    ("indexfunc", "row scatter (index_add_)"),
    ("scatter_gather", "torch.gather / scatter"),
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


def events_ms(fn, iters):
    """Mean ms per call of `iters` calls on the current stream by CUDA
    events, without a warm-up call (for work that is warm already and
    takes seconds a call)."""
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


def _ulps(v, k):
    """The float32 values from k ulps below v to k above (v > 0)."""
    i = np.asarray(v, np.float32).view(np.int32)
    return (i + np.arange(-k, k + 1, dtype=np.int32)).view(np.float32)


def _pair_iou(a, b):
    """float32 IoU of box a against boxes b (..., 4), in the operation order
    of nms_cuda.iou_bitmask_plain."""
    ix1, iy1 = np.maximum(a[0], b[..., 0]), np.maximum(a[1], b[..., 1])
    ix2, iy2 = np.minimum(a[2], b[..., 2]), np.minimum(a[3], b[..., 3])
    inter = np.maximum(ix2 - ix1, 0) * np.maximum(iy2 - iy1, 0)
    area_a = (a[2] - a[0]) * (a[3] - a[1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = np.maximum((area_a + area_b) - inter, np.float32(1e-6))
    return inter / union


def square_tie_boxes(thr, side=16, per_target=4, x_offset=0):
    """Pairs of side x side boxes (P2P's pseudo boxes) whose float32 IoU is
    exactly thr or one of its two float neighbours: numpy (2P, 4) f32, pair
    p an anchor box at (x_offset, 40 p) (row 2p) and a box shifted right
    and down by about side - sqrt(inter) (row 2p + 1), where inter is the
    overlap that gives thr; no two pairs overlap. The IoU of two boxes of
    one size depends on the overlap alone, and at 0.01 the float32 values
    it takes skip some: so the shifted box's right edge may also move by up
    to 4 float32 steps (its width is side within 1e-5 px). Each pair is
    searched at its own position, since float32 rounds the shifted
    coordinates differently at each: near the solution, x over up to 2,001
    float32 values (overlap widths of 1-4 px) and, for each, y over 257.
    Returns (boxes, iou (P,) f32)."""
    t, s = np.float32(thr), np.float32(side)
    targets = (np.nextafter(t, np.float32(-1)), t,
               np.nextafter(t, np.float32(2)))
    inter = float(t) * 2 * side * side / (1 + float(t))
    boxes, ious = [], []
    for k, target in enumerate(targets):
        for q in range(per_target):
            p = k * per_target + q
            ox, oy = np.float32(x_offset), np.float32(40 * p)
            a = np.asarray([ox, oy, ox + s, oy + s], np.float32)
            xs = _ulps(ox + s - np.float32(np.sqrt(inter)), 1000)
            iw = a[2] - xs
            xs, iw = xs[(iw >= 1) & (iw <= 4)], iw[(iw >= 1) & (iw <= 4)]
            ys = np.stack([_ulps(oy + s - np.float32(inter / w), 128)
                           for w in iw])                        # (X, Y)
            for step in (0, 1, -1, 2, -2, 3, -3, 4, -4):
                x2 = (xs + s).view(np.int32) + np.int32(step)
                b = np.stack(np.broadcast_arrays(
                    xs[:, None], ys, x2.view(np.float32)[:, None], ys + s),
                    -1)
                iou = _pair_iou(a, b)
                hit = np.argwhere(iou == target)
                if len(hit):
                    break
            else:
                raise AssertionError(f"no IoU of {target!r} at {ox}, {oy}")
            i, j = hit[0]
            boxes += [a, b[i, j]]
            ious.append(iou[i, j])
    boxes = np.stack(boxes).astype(np.float32)
    if boxes[:, 2].max() >= 2 ** 24:
        raise ValueError(f"x_offset {x_offset}: coordinates reach 2**24")
    return boxes, np.asarray(ious, np.float32)


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
    tensors too, in place of the kernels: the plain forward (PLAIN_CHUNK
    rois a call: each roi's output is its own, and Grid R-CNN's tens of
    thousands of 14x14 crops would take tens of GB at once), and autograd
    through it in place of the two backward kernels."""
    from pointtinybenchmark_tpu_torch.ops import roi_align, roi_align_cuda

    saved = (roi_align_cuda.roi_align_forward,
             roi_align_cuda.roi_align_backward,
             roi_align_cuda.roi_align_rois_backward)
    def forward(feats, rois, lvls, *args, **kwargs):
        return torch.cat([roi_align.roi_align_multilevel_plain(
            feats, rois[c], lvls[c], *args, **kwargs)
            for c in chunks(rois.shape[0])]) if rois.shape[0] else \
            roi_align.roi_align_multilevel_plain(feats, rois, lvls, *args,
                                                 **kwargs)
    roi_align_cuda.roi_align_forward = forward
    roi_align_cuda.roi_align_backward = roi_align.roi_align_backward_plain
    roi_align_cuda.roi_align_rois_backward = \
        roi_align.roi_align_rois_backward_plain
    try:
        yield
    finally:
        (roi_align_cuda.roi_align_forward, roi_align_cuda.roi_align_backward,
         roi_align_cuda.roi_align_rois_backward) = saved


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


def roi_align_bound(feats, rois, lvls, out, sr, aligned=True):
    """(ms, bounded by): the output written once, rois and levels read once,
    and every feature cell that an in-bounds tap reads, read once; 8 * sr^2
    float32 operations per output value (4 products and 3 sums per sample,
    the sample sum, the scale)."""
    from pointtinybenchmark_tpu_torch.ops import roi_align

    scale, hf, wf, base, width = roi_align.level_tables(feats, rois, lvls,
                                                        ROI_STRIDES)
    y0, y1, x0, x1, *_, inb = roi_align.sample_taps(rois, scale, hf, wf, out,
                                                    sr, aligned)
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
    # largest class offset of Mask R-CNN's 80-class NMS; at P2P's 0.01 on
    # its 16x16 pseudo boxes
    for thr, x_offset, make in (
            (0.5, 0, threshold_tie_boxes), (0.7, 0, threshold_tie_boxes),
            (0.5, OFFSET_80_CLASSES, threshold_tie_boxes),
            (0.7, OFFSET_80_CLASSES, threshold_tie_boxes),
            (P2P_THR, 0, square_tie_boxes),
            (P2P_THR, OFFSET_80_CLASSES, square_tie_boxes)):
        tie, iou = make(thr, x_offset=x_offset)
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
        print(f"phase 1 threshold ties at {thr}, x offset {x_offset} "
              f"({make.__name__}): {len(iou)} pairs with IoU "
              f"{np.unique(iou).tolist()}, kernel bits == plain bits")

    # the JSON line keeps the B=12 row, comparable with earlier measurements
    return {k: dict(rows[0][k], by_shape=[r[k] for r in rows])
            for k in ("iou_bitmask", "greedy_reduce")}


def compare_roi_align(feats, rois, lvls, out, sr, aligned=True):
    """Kernel vs plain on the same inputs: (kernel out, max abs err). Fails
    unless the two are equal (torch.equal)."""
    from pointtinybenchmark_tpu_torch.ops import roi_align, roi_align_cuda

    got = roi_align_cuda.roi_align_forward(feats, rois, lvls, ROI_STRIDES,
                                           out, sr, aligned)
    want = roi_align.roi_align_multilevel_plain(feats, rois, lvls,
                                                ROI_STRIDES, out, sr, aligned)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"RoIAlign kernel != plain: max abs err {err}")
    return got, err


def roi_paths(feats, rois, lvls, out, sr, aligned=True):
    """{kernel path: rois that take it} for these inputs, from the kernel's
    own counts (one launch, outside any counted run)."""
    from pointtinybenchmark_tpu_torch.ops import roi_align_cuda

    counts = torch.zeros(len(roi_align_cuda.PATHS), dtype=torch.int32,
                         device=rois.device)
    roi_align_cuda.roi_align_forward(feats, rois, lvls, ROI_STRIDES, out, sr,
                                     aligned, path_counts=counts)
    return dict(zip(roi_align_cuda.PATHS, counts.tolist()))


def shares(counts):
    """'path n (share of all)' for each path of a `roi_paths` dict."""
    total = max(sum(counts.values()), 1)
    return ", ".join(f"{k} {v} ({v / total:.4f})" for k, v in counts.items())


def ps_per_sample(ms, feats, r, out, sr):
    """Kernel time per bilinear sample and channel, in picoseconds: the time
    over R S^2 sr^2 C."""
    return ms * 1e9 / (r * out * out * sr * sr * feats[0].shape[1])


def time_roi_align(feats, rois, lvls, out, sr, aligned=True):
    from pointtinybenchmark_tpu_torch.ops import roi_align, roi_align_cuda

    ms = time_ms(lambda: roi_align_cuda.roi_align_forward(
        feats, rois, lvls, ROI_STRIDES, out, sr, aligned), ITERS)
    plain_ms = time_ms(lambda: roi_align.roi_align_multilevel_plain(
        feats, rois, lvls, ROI_STRIDES, out, sr, aligned), PLAIN_ITERS)
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


def unfixed(label, handle, frames):
    """What the seeded draw detects on `frames` before the phase's
    random-weight fix: printed, so that a run shows whether the fix is
    still needed (its launches are not counted: the phase resets the
    counts after)."""
    from pointtinybenchmark_tpu_torch.apis.inference import \
        inference_detector_tiled

    scores = np.concatenate([r["bboxes"][:, 4] for r in
                             inference_detector_tiled(handle, list(frames))])
    print(f"{label}: without the fix the seeded weights keep {scores.size} "
          f"detections on the {len(frames)} frames"
          + (f" (top score {scores.max():.5f})" if scores.size else ""))


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
    unfixed("phase 3", handle, frames)
    # The focal prior (retina_cls.bias = log(0.01/0.99)) keeps every score of
    # the seeded weights under score_thr 0.05 (`unfixed` prints it): NMS
    # would get no candidate at all. A zero bias puts scores near 0.5.
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
        boxes, scores, _ = head.candidates(cls_outs, reg_outs, img_shapes)
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


def phase_profile(card, handle, frames, label, calls=PROFILE_CALLS,
                  warm=True):
    from pointtinybenchmark_tpu_torch.apis.inference import \
        inference_detector_tiled

    frame_list = list(frames)
    if warm:
        inference_detector_tiled(handle, frame_list)
    device_profile(card, lambda: inference_detector_tiled(handle, frame_list),
                   label, calls, f"warm protocol calls of {N_FRAMES} frames")


def traced_events(run, calls, trace, enough, cpu=False):
    """The device events (kernels, copies, fills) of `calls` warm runs of
    `run` under torch.profiler, the Chrome trace written to `trace`. A
    trace can lose a run's device activity, some of it or all: one whose
    events fail `enough(events)` is taken again, PROFILE_ATTEMPTS traces in
    all. Returns (events, or None if every trace lost it; the wall ms per
    call of the last trace; what the traces held, by event name)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    trace.parent.mkdir(parents=True, exist_ok=True)
    for attempt in range(PROFILE_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / calls
        prof.export_chrome_trace(str(trace))
        events = [e for e in json.loads(trace.read_text())["traceEvents"]
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                  and "dur" in e]
        traced = collections.Counter(e["name"][:60] for e in events)
        if enough(events):
            return events, wall_ms, traced
        print(f"trace {attempt + 1} of {PROFILE_ATTEMPTS} of {calls} calls "
              f"({trace.name}) lost device activity: {dict(traced)}")
    return None, wall_ms, traced


def device_profile(card, run, label, calls, what):
    """`calls` runs of `run` (warm) under torch.profiler: wall and device
    busy ms per call, the idle share, device ms by kernel family and the
    top kernels; the Chrome trace goes to build/. Returns (wall ms, busy
    ms, {family: ms}) per call."""
    trace = REPO / "build" / f"protocol_trace_{label}.json"
    events, wall_ms, _ = traced_events(run, calls, trace, bool, cpu=True)
    if events is None:
        raise AssertionError(f"{label}: {PROFILE_ATTEMPTS} traces held no "
                             f"device activity")
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


def compare_roi_align_backward(g, rois, lvls, shapes, out, sr, aligned=True):
    """The backward kernel against the plain backward (autograd through the
    plain forward) on the same inputs: (max abs err, worst err over the
    level's max |gradient|). Fails above BWD_TOL of a level's max."""
    from pointtinybenchmark_tpu_torch.ops import roi_align, roi_align_cuda

    cl = [True] * len(shapes)
    got = roi_align_cuda.roi_align_backward(g, rois, lvls, shapes, cl,
                                            ROI_STRIDES, out, sr, aligned)
    want = roi_align.roi_align_backward_plain(g, rois, lvls, shapes, cl,
                                              ROI_STRIDES, out, sr, aligned)
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


def time_roi_align_backward(g, rois, lvls, shapes, out, sr, aligned=True):
    """(call ms, plain ms): whole wrapper calls between CUDA events, the
    zero fill, argument checks and ctypes call included."""
    from pointtinybenchmark_tpu_torch.ops import roi_align, roi_align_cuda

    cl = [True] * len(shapes)
    ms = time_ms(lambda: roi_align_cuda.roi_align_backward(
        g, rois, lvls, shapes, cl, ROI_STRIDES, out, sr, aligned), ITERS)
    plain_ms = time_ms(lambda: roi_align.roi_align_backward_plain(
        g, rois, lvls, shapes, cl, ROI_STRIDES, out, sr, aligned),
        PLAIN_ITERS)
    return ms, plain_ms


def backward_paths(g, rois, lvls, shapes, out, sr, aligned=True):
    """{kernel path: rois that take it} of the backward for these inputs,
    from the kernel's own counts (one launch, outside any counted run)."""
    from pointtinybenchmark_tpu_torch.ops import roi_align_cuda

    counts = torch.zeros(len(roi_align_cuda.PATHS), dtype=torch.int32,
                         device=rois.device)
    roi_align_cuda.roi_align_backward(g, rois, lvls, shapes,
                                      [True] * len(shapes), ROI_STRIDES, out,
                                      sr, aligned, path_counts=counts)
    return dict(zip(roi_align_cuda.PATHS, counts.tolist()))


def backward_device_ms(g, rois, lvls, shapes, out, sr, label,
                       calls=BWD_PROFILE_CALLS):
    """The backward's device time per wrapper call, from a torch.profiler
    trace of `calls` warm calls (no host time in it): (the backward kernel,
    the rest of the call's device work: the zero fill of the level
    gradients and the levels' int32 copy, the sum of both, which run one
    after the other on the stream), and whence the times came. The trace
    goes to build/; where every trace lost the kernel's events, the call
    is timed by CUDA events instead, kernel and fill together."""
    from pointtinybenchmark_tpu_torch.ops import roi_align_cuda

    def run():
        roi_align_cuda.roi_align_backward(g, rois, lvls, shapes,
                                          [True] * len(shapes), ROI_STRIDES,
                                          out, sr)

    def enough(events):
        return sum("roi_align_backward" in e["name"]
                   for e in events) >= calls // 2
    run()
    torch.cuda.synchronize()
    trace = REPO / "build" / f"backward_trace_{label}.json"
    # each kind of event (by name) gives its mean duration, once a call
    events, _, traced = traced_events(run, calls, trace, enough)
    if events is None:
        ms = events_ms(run, calls)
        print(f"{label}: every trace lost the backward kernel's events "
              f"({dict(traced)}); the call's time by CUDA events instead: "
              f"{ms:.4f} ms, kernel and fill not apart")
        return ms, 0.0, ms, f"CUDA events over {calls} calls"
    by_name = collections.defaultdict(list)
    for e in events:
        by_name[e["name"]].append(e["dur"])
    kernel = [n for n in by_name if "roi_align_backward" in n]
    if len(kernel) != 1:
        raise AssertionError(f"{calls} calls traced as {dict(traced)}")
    means = {n: sum(v) / len(v) / 1e3 for n, v in by_name.items()}
    kernel_ms = means.pop(kernel[0])
    rest_ms = sum(means.values())
    return (kernel_ms, rest_ms, kernel_ms + rest_ms,
            f"a profile of {calls} calls")


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
    k_ms, rest_ms, busy_ms, how = backward_device_ms(g, rois, lvls, shapes,
                                                     out, sr, label)
    rec.update(device_ms=busy_ms, kernel_ms=k_ms, fill_ms=rest_ms)
    print(f"phase {phase} RoIAlign backward {rec['shape']} (R={rec['R']}, "
          f"S={out}, sr={sr}), device time per call from {how}: kernel {k_ms:.4f} ms, zero fill and "
          f"level copy {rest_ms:.4f} ms, together {busy_ms:.4f} ms (call "
          f"{rec['ms']:.4f} ms); bound {rec['bound_ms']:.4f} ms, share "
          f"{rec['bound_ms'] / busy_ms:.3f} (kernel alone "
          f"{rec['bound_ms'] / k_ms:.3f}) [{card}]")


def train_samples(rng, n, hw=None, gts=(20, 61)):
    """n training samples as a dataset hands them to the collator: a
    normalised (H, W, 3) float32 image, 20-60 (`gts`) TinyPerson-like gts
    (10-40 px
    boxes around cluster centres, `synthetic_boxes`' kind) of class 0, and
    two ignore regions."""
    h, w = hw or TRAIN_HW
    out = []
    for _ in range(n):
        k = rng.randint(*gts)
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


def train_run(card, phase, cfg, samples, epochs, expected, positives,
              require_change=True):
    """`train_detector` from seeded weights on `samples` for `epochs`, with
    the kernels' launches counted from zero around it: the launches per step
    must be `expected`, every loss finite, each count of `positives` above
    its floor in every step, the frozen stem and stages bit-identical and
    every other parameter changed (with `require_change`; else the
    unchanged ones are only listed: a warmup from lr x 0.001 moves some by
    less than a float32 step in a few iterations). Returns the model (back
    at its initial weights), those weights and the run's launches."""
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
          f"{unchanged or 'none'}" + ("" if require_change else
                                       " (listed, not held)"))
    if moved or (unchanged and require_change):
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
        batch_to_device, init_train_state)
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
    state = init_train_state(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    fwd, bwd = [], []
    with recorded(roi_align_cuda, "roi_align_forward", fwd), \
            recorded(roi_align_cuda, "roi_align_backward", bwd):
        run, restore, check, saved = replayed_steps(model, opt, state, batch,
                                                    gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_replayed(run, restore, TRAIN_TIMED_STEPS)
    peak = (torch.cuda.max_memory_allocated() - held - saved) / 2 ** 30
    check("phase 6 timed steps")
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
          f"{TRAIN_HW}, f32, TF32 off, warm, CUDA events round each of "
          f"{TRAIN_TIMED_STEPS} steps from the seeded weights, restored "
          f"between them untimed, no host sync between them): "
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
        def call():
            restore()
            run()
        wall_ms, busy_ms, fam = device_profile(
            card, call, "faster_rcnn_train", TRAIN_PROFILE_STEPS,
            f"warm train steps of {spg} image, each after its restore")
        check("phase 6 profiled steps")
        k2 = (fam.get("RoIAlign kernel", 0.0)
              + fam.get("RoIAlign backward kernel", 0.0))
        print(f"phase 6 profile: K2 forward + backward {k2:.4f} ms of "
              f"{busy_ms:.4f} ms busy ({k2 / busy_ms:.4f}) [{card}]")
        after_ms = time_replayed(run, restore, TRAIN_TIMED_STEPS)
        check("phase 6 steps after the profiles")
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


def replayed_steps(model, opt, state, batch, gen):
    """One warm train step of `model` on `batch` from its current weights,
    then steps that each start from those same weights and the optimizer
    state the warm step left, restored before each: every timed or
    profiled step is one sound step from the seeded weights, however far
    repeated steps would drive them (a diverged model's NaN rois would
    take RoIAlign's invalid-roi exit). Returns (run: one step, restore, check:
    every step's losses finite, `nan_seen` false and the last step's
    gradients finite, else it raises; the bytes of the saved start)."""
    from pointtinybenchmark_tpu_torch.engine.train import make_train_step

    step = make_train_step(model, opt)
    live = list(model.state_dict().values())
    start = [t.clone() for t in live]
    seen = [step(state, batch, gen)]
    saved = opt.state_dict()

    def restore():
        torch._foreach_copy_(live, start)
        opt.load_state_dict(saved)

    def run():
        seen.append(step(state, batch, gen))

    def check(what):
        bad = sorted({k for m in seen for k, v in m.items()
                      if not bool(torch.isfinite(v).all())})
        nan_seen = any(bool(m["nan_seen"]) for m in seen)
        finite = all(bool(torch.isfinite(p.grad).all())
                     for p in model.parameters() if p.grad is not None)
        print(f"{what}: {len(seen)} steps from the seeded weights, losses "
              f"finite {not bad}, nan_seen {nan_seen}, the last step's "
              f"gradients finite {finite}")
        seen.clear()
        if bad or nan_seen or not finite:
            raise AssertionError(f"{what}: non-finite {bad}, nan_seen "
                                 f"{nan_seen}, gradients finite {finite}")
    return run, restore, check, sum(t.nbytes for t in start)


def time_replayed(run, restore, iters):
    """Mean ms of `iters` calls of `run` after one warm call, each after
    `restore`: CUDA events round each call, the restores between them
    untimed, no host sync between calls."""
    restore()
    run()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in events:
        restore()
        start.record()
        run()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def time_step(card, phase, label, cfg, model, batch, held, images,
              steps=TRAIN_TIMED_STEPS):
    """Warm train steps of `model` on `batch` from its weights
    (`replayed_steps`) by CUDA events, and the peak memory above `held`
    (the saved start not counted). Returns the numbers and a function that
    profiles warm steps (each after its restore) and prints them as JSON,
    to be run after every timing of the run."""
    from pointtinybenchmark_tpu_torch.engine.optimizer import build_optimizer
    from pointtinybenchmark_tpu_torch.engine.train import init_train_state

    opt = build_optimizer(model, cfg.optimizer, cfg.get("optimizer_config"),
                          cfg.get("lr_config"), 4, 12,
                          model.backbone.frozen_stages)
    state = init_train_state(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    run, restore, check, saved = replayed_steps(model, opt, state, batch,
                                                gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_replayed(run, restore, steps)
    peak = (torch.cuda.max_memory_allocated() - held - saved) / 2 ** 30
    check(f"phase {phase} {label} timed steps")
    restore_ms = time_ms(restore, TRAIN_TIMED_STEPS)
    hw = tuple(batch["img"].shape[1:3])
    print(f"phase {phase} train step ({label}, {images} image(s) of {hw}, "
          f"f32, TF32 off, warm, CUDA events round each of "
          f"{steps} steps from the seeded weights, restored "
          f"between them untimed ({restore_ms:.4f} ms a restore), no host "
          f"sync between them): {step_ms:.4f} ms, "
          f"{images * 1e3 / step_ms:.4f} img/s; peak memory {peak:.3f} GiB "
          f"above the {held / 2 ** 30:.3f} GiB the earlier phases hold and "
          f"the {saved / 2 ** 30:.3f} GiB of the saved start [{card}]")
    numbers = dict(step_ms=step_ms, img_s=images * 1e3 / step_ms,
                   peak_gib=peak, restore_ms=restore_ms)

    def profile():
        def call():
            restore()
            run()
        wall_ms, busy_ms, fam = device_profile(
            card, call, label, TRAIN_PROFILE_STEPS,
            f"warm train steps of {images} image(s), each after its "
            f"restore ({restore_ms:.4f} ms)")
        check(f"phase {phase} {label} profiled steps")
        numbers.update(profile_wall_ms=wall_ms, profile_busy_ms=busy_ms,
                       idle_share=1 - busy_ms / wall_ms,
                       unprofiled_idle_share=1 - (busy_ms - restore_ms)
                       / step_ms, families=fam)
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
def coco_objects(rng, hw):
    """One image's 5-30 objects (COCO_OBJECTS) with log-uniform sides of
    10-400 px (COCO_SIDES: small to large) and aspect ratios around 1, as
    (k, 4) xyxy float32 boxes in an (h, w) image."""
    h, w = hw
    k = rng.randint(COCO_OBJECTS[0], COCO_OBJECTS[1] + 1)
    side = np.exp(rng.uniform(*np.log(COCO_SIDES), k))
    aspect = np.exp(rng.normal(0.0, 0.4, k))
    bw = np.minimum(side * np.sqrt(aspect), w - 1)
    bh = np.minimum(side / np.sqrt(aspect), h - 1)
    x1, y1 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
    return np.stack([x1, y1, x1 + bw, y1 + bh], 1).astype(np.float32)


def coco_train_samples(rng, n, hw=None):
    """n training samples as a COCO dataset hands them to the collator: a
    normalised (H, W, 3) float32 image and 5-30 objects (COCO_OBJECTS) with
    log-uniform sides of 10-400 px (COCO_SIDES: small to large), aspect
    ratios around 1, labels of 80 classes, and for each object the ellipse
    inscribed in its box as an (H, W) uint8 bitmask."""
    h, w = hw or COCO_HW
    out = []
    for _ in range(n):
        boxes = coco_objects(rng, (h, w))
        k = len(boxes)
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


def step_rois(card, fwd, bwd, phase="8", label="mask_rcnn train step",
              kinds=((7, "bbox"), (14, "mask"))):
    """The K2 forward (torch.equal) and backward (within BWD_TOL) against
    their plain versions on one train step's recorded launches, with the
    rois on each kernel path, call times and bounds; `kinds` names the
    launches by S, one name a launch of that S in launch order (a
    cascade's stages). The k-th forward of an S pairs with the k-th last
    backward of that S (autograd runs the backwards in reverse). Returns
    the forward's and the backward's records and the backward's inputs,
    one per forward launch."""
    f_rows, b_rows, b_inputs = [], [], []
    for (feats, rois, lvls, _, out, sr, *rest), _, _ in fwd:
        aligned = rest[0] if rest else True
        feats = [f.detach() for f in feats]
        k = sum(1 for row in f_rows if row["S"] == out)
        g = [args[0] for args, _, _ in bwd if args[0].shape[-1] == out][
            -1 - k]
        shapes = [tuple(f.shape) for f in feats]
        name = f"{label} {[n for s, n in kinds if s == out][k]} rois"
        r = rois.shape[0]
        per_level = torch.bincount(lvls, minlength=len(ROI_LEVELS)).tolist()
        _, f_err = compare_roi_align(feats, rois, lvls, out, sr, aligned)
        f_paths = roi_paths(feats, rois, lvls, out, sr, aligned)
        err, share = compare_roi_align_backward(g, rois, lvls, shapes, out,
                                                sr, aligned)
        b_paths = backward_paths(g, rois, lvls, shapes, out, sr, aligned)
        f_ms, f_plain = time_roi_align(feats, rois, lvls, out, sr, aligned)
        f_bms, f_by = roi_align_bound(feats, rois, lvls, out, sr, aligned)
        b_ms, b_plain = time_roi_align_backward(g, rois, lvls, shapes, out,
                                                sr, aligned)
        b_bms, b_by = roi_align_backward_bound(r, g.shape[1], out, sr, shapes)
        print(f"phase {phase} {name} (R={r}, S={out}, sr={sr}, aligned "
              f"{aligned}, per level {per_level}): forward kernel == plain "
              f"(torch.equal), paths "
              f"{shares(f_paths)}; backward kernel vs plain {err:.3e} "
              f"({share:.3e} of the level's max, bar {BWD_TOL}), paths "
              f"{shares(b_paths)}")
        print(f"phase {phase} {name}: forward kernel {f_ms:.4f} ms (plain "
              f"{f_plain:.4f}, bound {f_bms:.4f} {f_by}), backward call "
              f"{b_ms:.4f} ms (plain {b_plain:.4f}, bound {b_bms:.4f} {b_by})"
              f" [{card}]")
        f_rows.append(dict(shape=name, R=r, S=out, sr=sr, aligned=aligned,
                           max_abs_err=f_err, ms=f_ms, plain_ms=f_plain,
                           bound_ms=f_bms, bound_by=f_by, per_level=per_level,
                           paths=f_paths))
        b_rows.append(dict(shape=name, R=r, S=out, sr=sr, aligned=aligned,
                           rois="train step",
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


# ------------------------------------------------ phase 9: P2P (points)
@contextlib.contextmanager
def swapped(module, name, fn):
    """Inside this block `module.<name>` is `fn`."""
    saved = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, saved)


def check_points(results, label, side=16.0):
    """Each frame's merged P2P detections: pseudo boxes of `side` round
    finite points inside the frame."""
    h, w = FRAME_HW
    for i, r in enumerate(results):
        bb = r["bboxes"]
        n = bb.shape[0]
        cx, cy = (bb[:, 0] + bb[:, 2]) / 2, (bb[:, 1] + bb[:, 3]) / 2
        first = [(round(float(a), 2), round(float(b), 2), round(float(c), 4))
                 for a, b, c in zip(cx[:3], cy[:3], bb[:3, 4])]
        print(f"{label} frame {i}: {n} points kept by the global merge, "
              f"first (cx, cy, score) {first}")
        if not 1 <= n <= 1000 or not np.isfinite(bb).all():
            raise AssertionError(f"frame {i}: {bb.shape} detections")
        if not ((cx >= 0).all() and (cy >= 0).all() and (cx <= w).all()
                and (cy <= h).all()
                and np.allclose(bb[:, 2:4] - bb[:, :2], side, atol=1e-3)):
            raise AssertionError(f"frame {i}: points outside the frame")


def phase_p2p(card, frames):
    """Phase 9 (a): Adap P2P's tiled protocol at full width (ResNet-50,
    FPN-256 at stride 4, P2PHead with 4+4 GN(32) convs) on the two frames:
    launches, candidates and kept points per tile, the card against the CPU
    on one tile, detections equal to those with the plain NMS, K1 against
    its plain version on the run's own two launches, img/s. Returns the
    launches, the handle (for the profile) and the K1 rows."""
    from pointtinybenchmark_tpu_torch.apis.inference import (
        inference_detector_tiled, init_detector)
    from pointtinybenchmark_tpu_torch.ops import nms_cuda

    handle = init_detector(str(P2P_CONFIG), device=DEVICE, seed=0)
    model, head = handle.model, handle.model.bbox_head
    unfixed("phase 9", handle, frames)
    # cls_out.bias = logit(0.01) keeps every score of the seeded weights
    # under score_thr 0.05 (`unfixed` prints it); a zero bias puts them near
    # 0.5
    with torch.no_grad():
        head.cls_out.bias.zero_()
    print("phase 9: cls_out.bias set to 0 so that candidates pass score_thr "
          "(with the focal prior no score of random weights does)")

    torch.backends.cudnn.deterministic = True
    bits, walks = [], []
    reset_launches()
    with recorded(nms_cuda, "iou_bitmask", bits), \
            recorded(nms_cuda, "greedy_reduce", walks):
        results = inference_detector_tiled(handle, list(frames))
    launches = read_launches()
    print(f"phase 9 launches on the P2P path: {launches}")
    if launches != P2P_LAUNCHES:
        raise AssertionError(f"expected one per-tile and one global launch of "
                             f"each NMS kernel, got {launches}")
    with plain_nms():
        results_plain = inference_detector_tiled(handle, list(frames))
    torch.backends.cudnn.deterministic = False
    check_points(results, "phase 9")
    for i, (r, p) in enumerate(zip(results, results_plain)):
        if not (np.array_equal(r["bboxes"], p["bboxes"])
                and np.array_equal(r["labels"], p["labels"])):
            raise AssertionError(f"frame {i}: kernel and plain NMS disagree")
    print("phase 9: merged detections and points with the kernels == with "
          "the plain NMS")

    # K1 alone on the run's own launches: the per-tile NMS, then the merge
    rows = []
    for ((sboxes, thr, n_valid), _, _), ((_, ok, order, max_out, _), _, _), \
            name in zip(bits, walks, ("P2P per-tile", "P2P global merge")):
        if max_out != MAX_OUT:
            raise AssertionError(f"{name} keeps {max_out}, not {MAX_OUT}")
        rows.append(k1_row(card, name, sboxes, ok, order, n_valid, thr,
                           phase="9"))
    want = [((24, 1000, 4), P2P_THR), ((N_FRAMES, 12000, 4), 0.5)]
    got = [(tuple(a[0].shape), a[1]) for a, _, _ in bits]
    if got != want:
        raise AssertionError(f"K1 launch shapes {got}, expected {want}")
    del bits, walks

    eng = next(iter(handle.tiled_engines.values()))
    tiles = eng.pre(frames)
    img_shapes = torch.tensor([eng.pre.tile_hw], dtype=torch.int32,
                              device=DEVICE).expand(tiles.shape[0], 2)
    cfg = head.test_cfg
    with torch.no_grad():
        cls_outs, pts_outs = model(tiles)
        dets, _ = head.get_bboxes(cls_outs, pts_outs, img_shapes,
                                  tuple(tiles.shape[1:3]))
    top = torch.sigmoid(cls_outs[0]).flatten(1).sort(
        1, descending=True).values[:, :int(cfg["nms_pre"])]
    cands = (top > float(cfg["score_thr"])).sum(1).tolist()
    kept = dets.valid.sum(1).tolist()
    print(f"phase 9 per-tile NMS input (top {cfg['nms_pre']} of "
          f"{cls_outs[0][0].numel()} cells, 16x16 pseudo boxes, IoU "
          f"{P2P_THR}): candidates over score_thr {cands}")
    print(f"phase 9 per-tile NMS kept points: {kept}")
    if min(cands) <= 0 or min(kept) <= 0:
        raise AssertionError("NMS got no work")

    cpu_model = init_detector(str(P2P_CONFIG), device="cpu", seed=0).model
    with torch.no_grad():
        cpu_model.bbox_head.cls_out.bias.zero_()
        ref = cpu_model(tiles[:1].cpu())
    err = rel_err([cls_outs[0][:1], pts_outs[0][:1]], [ref[0][0], ref[1][0]])
    print(f"phase 9 head outputs (cls_out, reg_out), card vs CPU on one "
          f"tile: max rel err {err:.3e}")
    if err > 1e-4:
        raise AssertionError(f"card forward differs from CPU: {err}")
    del cpu_model, ref

    protocol, forward = throughput(handle, frames, tiles)

    def post():
        return head.get_bboxes(cls_outs, pts_outs, img_shapes,
                               tuple(tiles.shape[1:3]))

    def merge():
        return eng.merge(dets)
    post_ms, merge_ms = time_ms(post, ITERS), time_ms(merge, ITERS)
    with plain_nms():
        post_plain, merge_plain = (time_ms(post, PLAIN_ITERS),
                                   time_ms(merge, PLAIN_ITERS))
    print(f"phase 9 protocol ({N_FRAMES} frames of {eng.pre.n_views} tiles, "
          f"host in the loop): {protocol:.4f} img/s [{card}]")
    print(f"phase 9 forward only ({tiles.shape[0]} tiles, f32, TF32 off): "
          f"{forward:.4f} img/s [{card}]")
    print(f"phase 9 get_bboxes (top-k, pseudo boxes, per-tile NMS, "
          f"B={tiles.shape[0]}): kernel {post_ms:.4f} ms, plain "
          f"{post_plain:.4f} ms; global merge: kernel {merge_ms:.4f} ms, "
          f"plain {merge_plain:.4f} ms [{card}]")
    return launches, handle, rows


def phase_p2p_train(card):
    """Phase 9 (b): Adap P2P training at full width (Adam at lr 1e-4 with
    linear warmup, grad_clip 35, HungarianAssignerV2 at topk_k 5, one
    512x640 image a step, max_gt 200) with seeded weights on synthetic
    images of 20-200 TinyPerson-like gts: `train_run` (no kernel launch, a
    finite Adam step each iteration, num_pos a multiple of topk_k), the
    auction's rounds, iterations and host reads per step; one step: num_pos
    == topk_k x valid gts, the card's auction equal to the CPU auction on
    the card's own cost matrix (both stopped at AUCTION_CPU_ITERS), the
    CPU's step (fed the card's assignment) against the card's; the
    auction's ms, train-step ms, img/s and peak memory. Returns the
    launches and the profile."""
    from pointtinybenchmark_tpu_torch.core import assigners
    from pointtinybenchmark_tpu_torch.data.loader import DetCollator
    from pointtinybenchmark_tpu_torch.engine.optimizer import Adam
    from pointtinybenchmark_tpu_torch.engine.train import batch_to_device
    from pointtinybenchmark_tpu_torch.models.dense_heads import p2p_head
    from pointtinybenchmark_tpu_torch.utils.config import Config

    cfg = Config.fromfile(str(P2P_CONFIG))
    spg = int(cfg.data["samples_per_gpu"])
    topk = int(cfg.train_cfg["assigner"]["topk_k"])
    samples = train_samples(np.random.RandomState(12), P2P_TRAIN_IMAGES,
                            gts=P2P_GTS)
    print(f"phase 9 training config: {P2P_CONFIG.name}, samples_per_gpu "
          f"{spg}, pad_shape {tuple(cfg.loader['pad_shape'])}, max_gt "
          f"{cfg.loader['max_gt']}, optimizer {dict(cfg.optimizer)}, "
          f"grad_clip {cfg.optimizer_config.get('grad_clip')}, assigner "
          f"topk_k {topk}; {P2P_TRAIN_IMAGES} synthetic images, gts per "
          f"image {[len(s['gt_bboxes']) for s in samples]}")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()

    stats = assigners.auction_stats
    for k in stats:
        stats[k] = 0
    model, init, launches = train_run(
        card, "9", cfg, samples, P2P_TRAIN_EPOCHS, NO_LAUNCHES,
        {"num_pos": topk * P2P_GTS[0] - 1})
    iters = P2P_TRAIN_EPOCHS * P2P_TRAIN_IMAGES // spg
    print(f"phase 9 auction in train_detector: per step "
          f"{stats['rounds'] / iters:.1f} rounds, "
          f"{stats['iterations'] / iters:.1f} iterations, "
          f"{stats['syncs'] / iters:.1f} host reads (every "
          f"{assigners.AUCTION_CHECK_EVERY} iterations and one a round for "
          f"the completion)")

    collator = DetCollator(tuple(cfg.loader["pad_shape"]),
                           max_gt=int(cfg.loader["max_gt"]))
    collated = collator(samples[:spg])
    batch = batch_to_device(collated, DEVICE)
    calls = []
    with recorded(p2p_head, "topk_auction_match", calls):
        card_m, _ = one_step(model, cfg, batch, seed=3)
    model.load_state_dict(init)
    (cost, gv, k), _, card_assigned = calls[0]
    n_gts = int(collated["gt_valid"].sum())
    print(f"phase 9 one step: num_pos {card_m['num_pos']:.0f} == topk_k "
          f"{topk} x {n_gts} valid gts: {card_m['num_pos'] == topk * n_gts}")
    if card_m["num_pos"] != topk * n_gts:
        raise AssertionError(f"num_pos {card_m['num_pos']}")
    capped = assigners.topk_auction_match(cost, gv, k,
                                          max_iters=AUCTION_CPU_ITERS)
    t0 = time.perf_counter()
    cpu_capped = assigners.topk_auction_match(cost.cpu(), gv.cpu(), k,
                                              max_iters=AUCTION_CPU_ITERS)
    cpu_s = time.perf_counter() - t0
    same = torch.equal(capped.cpu(), cpu_capped)
    print(f"phase 9 auction, card vs CPU on the card's cost matrix "
          f"{tuple(cost.shape)}, both stopped at {AUCTION_CPU_ITERS} "
          f"iterations a round: assignments equal: {same} (the CPU took "
          f"{cpu_s:.2f} s)")
    if not same:
        raise AssertionError("the card's auction differs from the CPU's")
    a0 = dict(stats)
    auction_ms = time_ms(lambda: assigners.topk_auction_match(cost, gv, k),
                         AUCTION_TIMED)
    per = {key: (stats[key] - a0[key]) / (AUCTION_TIMED + 1) for key in stats}
    print(f"phase 9 auction alone on the step's cost matrix: {auction_ms:.4f} "
          f"ms a call (CUDA events, the host reads inside), {per} per call "
          f"[{card}]")

    with swapped(p2p_head, "topk_auction_match",
                 lambda *args: card_assigned.cpu()):
        cpu_m, _ = one_step(train_model(cfg, device="cpu"), cfg,
                            batch_to_device(collated, "cpu"), seed=3,
                            device="cpu")
    keys = [key for key in cpu_m if key.startswith("loss") or key == "num_pos"]
    errs = {key: abs(card_m[key] - cpu_m[key]) / max(abs(cpu_m[key]), 1e-30)
            for key in keys}
    print("phase 9 one step, card vs CPU (the CPU fed the card's "
          "assignment), rel err: " + ", ".join(
              f"{key} {v:.3e}" for key, v in errs.items())
          + f" (bar {LOSS_TOL})")
    if max(errs.values()) > LOSS_TOL:
        raise AssertionError(f"card vs CPU: {card_m} vs {cpu_m}")

    for key in stats:
        stats[key] = 0
    numbers, profile = time_step(card, "9", "p2p_train", cfg, model, batch,
                                 held, spg)
    steps = TRAIN_TIMED_STEPS + 2
    print(f"phase 9 the timed steps read the auction's convergence back "
          f"{stats['syncs'] / steps:.1f} times a step "
          f"({stats['iterations'] / steps:.1f} iterations)")
    from pointtinybenchmark_tpu_torch.engine.optimizer import build_optimizer
    if not isinstance(build_optimizer(model, cfg.optimizer), Adam):
        raise AssertionError("the P2P config does not build Adam")
    return launches, profile


# ------------------------------------------------ phase 10: CPR (points)
def cpr_samples(rng, n, hw, points):
    """n images with `points` coarse points each (annotation ids from 1000
    i), as 16x16 pseudo boxes round TinyPerson-like clusters, class 0; the
    image a normalised float32 map."""
    h, w = hw
    out = []
    for i in range(n):
        k = points if np.isscalar(points) else rng.randint(*points)
        centres = rng.rand(max(k // 5, 1), 2) * [w - 40, h - 40] + 20
        c = (centres[rng.randint(0, len(centres), k)]
             + rng.randn(k, 2) * 12).clip(2, [w - 2, h - 2])
        out.append(dict(
            img=rng.randn(h, w, 3).astype(np.float32),
            gt_bboxes=np.concatenate([c - 8, c + 8], 1).astype(np.float32),
            gt_labels=np.zeros(k, np.int64),
            gt_anns_id=np.arange(k) + 1000 * i))
    return out


def cpr_moved(samples, rows, radius=None):
    """Points that refinement moved, per image; with `radius`, every row
    is also checked: ids, finite values, and no point moved beyond it."""
    moved = []
    for s, r in zip(samples, rows):
        coarse = (s["gt_bboxes"][:, :2] + s["gt_bboxes"][:, 2:]) / 2
        d = np.linalg.norm(r["points"][:, :2] - coarse, axis=1)
        moved.append(int((d > 1e-3).sum()))
        if radius is not None and not (
                np.array_equal(r["anns_id"], s["gt_anns_id"])
                and np.isfinite(r["points"]).all() and (d <= radius).all()):
            raise AssertionError("refined rows: ids, values or distances")
    return moved


def phase_cpr(card):
    """Phase 10: CPR on TinyPersonV2 at full width (ResNet-50, FPN-256 at
    stride 4, CPRHead with 4 GN(32) convs, CirclePtFeatGenerator radius 5,
    class-wise OutCircle negatives, the MIL loss), cls_out.bias set to 0
    so that bag scores pass merge_th. (a) `run_refine_test` on 8 640x640
    images of 50 coarse points (no kernel launch), refine_test on the card
    against the CPU on one image, img/s; (b) `train_detector` at
    random_remove_rate 0.4 (finite losses), one step at rate 0 on the card
    against the CPU, train-step ms, img/s, peak memory. Returns the
    launches of both paths and their profiles."""
    from pointtinybenchmark_tpu_torch.data.loader import DetCollator
    from pointtinybenchmark_tpu_torch.engine.test import run_refine_test
    from pointtinybenchmark_tpu_torch.engine.train import batch_to_device
    from pointtinybenchmark_tpu_torch.utils.config import Config

    cfg = Config.fromfile(str(CPR_CONFIG))
    model = train_model(cfg).eval()
    samples = cpr_samples(np.random.RandomState(13), CPR_IMAGES, CPR_HW,
                          CPR_POINTS)
    collator = DetCollator(CPR_HW, max_gt=int(cfg.loader["max_gt"]))
    moved = cpr_moved(samples, run_refine_test(model, samples, collator,
                                               batch_size=CPR_IMAGES))
    print(f"phase 10: without the fix the seeded weights move {moved} "
          f"points per image")
    with torch.no_grad():
        model.bbox_head.cls_out.bias.zero_()
    print(f"phase 10: {CPR_CONFIG.name}, cls_out.bias set to 0 so that bag "
          f"scores pass merge_th; refinement of {CPR_IMAGES} images of "
          f"{CPR_HW} with {CPR_POINTS} coarse points each")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    reset_launches()
    rows = run_refine_test(model, samples, collator, batch_size=CPR_IMAGES)
    refine_launches = read_launches()
    radius = 5 * 4
    moved = cpr_moved(samples, rows, radius)
    print(f"phase 10 run_refine_test: launches {refine_launches}; "
          f"{len(rows)} images, rows {[len(r['points']) for r in rows]}, "
          f"points moved per image {moved} (every refined point within the "
          f"bag radius of {radius} px)")
    if refine_launches != NO_LAUNCHES or sum(moved) == 0:
        raise AssertionError(f"launches {refine_launches}, moved {moved}")

    batch = batch_to_device(collator(samples), DEVICE)
    with torch.no_grad():
        pts, scores, _, nr = model.refine_test(batch["img"], batch)
    cpu_model = train_model(cfg, device="cpu").eval()
    with torch.no_grad():
        cpu_model.bbox_head.cls_out.bias.zero_()
        one = batch_to_device(collator(samples[:1]), "cpu")
        c_pts, c_scores, _, c_nr = cpu_model.refine_test(one["img"], one)
    v = one["gt_valid"][0]
    p_err = float((pts[0].cpu() - c_pts[0])[v].abs().max())
    s_err = float(((scores[0].cpu() - c_scores[0]) / c_scores[0].abs()
                   .clamp(min=1e-12))[v].abs().max())
    same_nr = torch.equal(nr[0].cpu()[v], c_nr[0][v])
    print(f"phase 10 refine_test, card vs CPU on one image: points max abs "
          f"err {p_err:.3e} px, scores max rel err {s_err:.3e}, not_refine "
          f"equal {same_nr} ({int(c_nr[0][v].sum())} of {int(v.sum())} not "
          f"refined)")
    if p_err > 1e-3 or s_err > 1e-4 or not same_nr:
        raise AssertionError("card refinement differs from the CPU's")
    del cpu_model

    def refine():
        with torch.no_grad():
            return model.refine_test(batch["img"], batch)
    ms = time_ms(refine, ITERS)
    print(f"phase 10 refine_test ({CPR_IMAGES} images of {CPR_HW}, "
          f"{CPR_POINTS} points each, f32, TF32 off): {ms:.4f} ms, "
          f"{CPR_IMAGES * 1e3 / ms:.4f} img/s [{card}]")

    # (b) training
    spg = int(cfg.data["samples_per_gpu"])
    rate = float(cfg.model["bbox_head"]["loss_cfg"]["random_remove_rate"])
    train = cpr_samples(np.random.RandomState(14), CPR_TRAIN_IMAGES, CPR_HW,
                        P2P_GTS)
    print(f"phase 10 training: samples_per_gpu {spg}, optimizer "
          f"{dict(cfg.optimizer)}, grad_clip "
          f"{cfg.optimizer_config.get('grad_clip')}, random_remove_rate "
          f"{rate} (drawn from the step's generator); gts per image "
          f"{[len(s['gt_bboxes']) for s in train]}")
    tmodel, init, train_launches = train_run(
        card, "10", cfg, train, CPR_TRAIN_EPOCHS, NO_LAUNCHES, {},
        require_change=False)
    collated = collator(train[:spg])
    tbatch = batch_to_device(collated, DEVICE)
    tmodel.bbox_head.loss_cfg["random_remove_rate"] = 0.0
    card_m, _ = one_step(tmodel, cfg, tbatch, seed=3)
    tmodel.load_state_dict(init)
    tmodel.bbox_head.loss_cfg["random_remove_rate"] = rate
    cpu = train_model(cfg, device="cpu")
    cpu.bbox_head.loss_cfg["random_remove_rate"] = 0.0
    cpu_m, _ = one_step(cpu, cfg, batch_to_device(collated, "cpu"), seed=3,
                        device="cpu")
    del cpu
    keys = [k for k in cpu_m if k.startswith("loss")]
    errs = {k: abs(card_m[k] - cpu_m[k]) / max(abs(cpu_m[k]), 1e-30)
            for k in keys}
    print("phase 10 one step at random_remove_rate 0, card vs CPU, rel err: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (bar {LOSS_TOL})")
    if max(errs.values()) > LOSS_TOL:
        raise AssertionError(f"card vs CPU: {card_m} vs {cpu_m}")
    _, train_profile = time_step(card, "10", "cpr_train", cfg, tmodel, tbatch,
                                 held, spg)

    def profiles():
        device_profile(card, refine, "cpr_refine", PROFILE_CALLS,
                       f"warm refine_test calls of {CPR_IMAGES} images")
        train_profile()
    return refine_launches, train_launches, profiles


# ---------------------------------------- phase 11: P2BNet and SSD-Det
def p2b_samples(rng, n, noise_kwargs, kind="point", hw=None, gts=None):
    """n samples as the P2BNet (`kind` "point") or SSD-Det ("box") dataset
    hands them to the collator: a normalised float32 image, `coco_objects`
    (at most `gts`), and as gt_bboxes either the pseudo boxes round points
    that data/noise.py draws in each object with the config's
    `noise_kwargs` (P2BNet: 16x16 round a point within 25% of the centre),
    or each object's box shifted by up to 40% of its size (noisy boxes, as
    tests/test_models_p2b.py's SSD-Det scenario); the true boxes and
    annotation ids beside them."""
    from pointtinybenchmark_tpu_torch.data import noise

    h, w = hw or COCO_HW
    out = []
    for i in range(n):
        boxes = coco_objects(rng, (h, w))[:gts]
        labels = rng.randint(0, 80, len(boxes)).astype(np.int64)
        if kind == "point":
            ds = dict(annotations=[
                dict(id=j, bbox=[float(b[0]), float(b[1]),
                                 float(b[2] - b[0]), float(b[3] - b[1])])
                for j, b in enumerate(boxes)])
            anns = noise.generate_pseudo_bbox_for_point(
                ds, noise_kwargs["pseudo_wh"], noise_kwargs.get("noise_rg"),
                seed=i)["annotations"]
            xywh = np.asarray([a["bbox"] for a in anns], np.float32)
            gt = np.concatenate([xywh[:, :2], xywh[:, :2] + xywh[:, 2:]], 1)
        else:
            wh = boxes[:, 2:] - boxes[:, :2]
            gt = boxes + np.tile(rng.uniform(-0.4, 0.4, wh.shape) * wh, 2)
        out.append(dict(img=rng.randn(h, w, 3).astype(np.float32),
                        gt_bboxes=gt.astype(np.float32), gt_labels=labels,
                        gt_true_bboxes=boxes,
                        gt_anns_id=np.arange(len(gt)) + 1000 * i))
    return out


def bound_tie_rois(b, hw, rng, n=64):
    """Rois whose level-0 sample coordinates at sr=2 lie exactly on the
    clamp bounds 0 and W - 1 (and the in-map bounds -1 and W): two built
    so in each image, and n on a 1-px grid round the map's edges (their
    samples are multiples of 1/4 cell)."""
    h, w = hw
    rows = [(i, -3, -3, 25, 25) for i in range(b)]
    rows += [(i, w - 19, h - 19, w + 9, h + 9) for i in range(b)]
    xy = rng.randint(-12, 13, (n, 2)) + rng.randint(0, 2, (n, 2)) * [w, h]
    wh = rng.randint(4, 120, (n, 2))
    rows += [(rng.randint(0, b), x, y, x + dx, y + dy)
             for (x, y), (dx, dy) in zip(xy, wh)]
    return np.asarray(rows, np.float32)


def p2b_bag_rois(rng, cfg, kind):
    """Phase 11 (a)'s rois on two 800x1344 images of 100 gt slots, as
    P2BNet's step builds them (`p2b_head` functions, the config's grids):
    5-30 COCO objects an image, the rest padding, whose points and boxes
    the collator leaves at the origin. "cbp": stage 0's bags of 25 round
    the points (R = 5,000); "neg": the negatives' grid of 50 round boxes
    (the objects', and 32x32 at the origin for the padding: R = 10,000);
    "edge": `edge_rois` scaled to the image and `bound_tie_rois`."""
    from pointtinybenchmark_tpu_torch.models.dense_heads import p2b_head

    head = cfg.model["bbox_head"]
    b, g = 2, int(cfg.loader["max_gt"])
    if kind == "edge":
        hw = tuple(cfg.loader["pad_shape"])
        return np.concatenate([edge_rois(b, hw), bound_tie_rois(b, hw, rng)])
    boxes = np.zeros((b, g, 4), np.float32)
    boxes[..., :2], boxes[..., 2:] = -16, 16
    for i in range(b):
        obj = coco_objects(rng, COCO_HW)[:g]
        boxes[i, :len(obj)] = obj
    t = torch.from_numpy(boxes)
    if kind == "cbp":
        bags = p2b_head.cbp_proposals((t[..., :2] + t[..., 2:]) / 2,
                                      head["cbp_scales"], head["cbp_ratios"])
    else:
        bags = p2b_head.pbr_proposals(t, (1.0, 3.0),
                                      (-1.2, -0.6, 0.0, 0.6, 1.2))
    bidx = torch.arange(b, dtype=torch.float32)[:, None, None, None]
    return torch.cat([bidx.expand(*bags.shape[:3], 1), bags],
                     -1).reshape(-1, 5).numpy()


def chunks(r):
    return [slice(i, min(i + PLAIN_CHUNK, r)) for i in range(0, r, PLAIN_CHUNK)]


def forward_plain(feats, rois, lvls, out, sr):
    """The plain forward, PLAIN_CHUNK rois a call (each roi's output is its
    own, so the result is the same)."""
    from pointtinybenchmark_tpu_torch.ops import roi_align

    return torch.cat([roi_align.roi_align_multilevel_plain(
        feats, rois[c], lvls[c], ROI_STRIDES, out, sr)
        for c in chunks(rois.shape[0])])


def backward_plain(g, rois, lvls, shapes, out, sr):
    """The plain backward for the maps, PLAIN_CHUNK rois a call, the
    chunks' level gradients summed (the op is linear), in g's type."""
    from pointtinybenchmark_tpu_torch.ops import roi_align

    total = None
    for c in chunks(rois.shape[0]):
        part = roi_align.roi_align_backward_plain(
            g[c], rois[c], lvls[c], shapes, [True] * len(shapes),
            ROI_STRIDES, out, sr)
        total = part if total is None else [a + p for a, p in
                                            zip(total, part)]
    return total


def rois_backward_plain(g, feats, rois, lvls, out, sr):
    """The plain roi-coordinate gradient, PLAIN_CHUNK rois a call."""
    from pointtinybenchmark_tpu_torch.ops import roi_align

    return torch.cat([roi_align.roi_align_rois_backward_plain(
        g[c], feats, rois[c], lvls[c], ROI_STRIDES, out, sr)
        for c in chunks(rois.shape[0])])


def compare_rois_backward(g, feats, rois, lvls, out, sr):
    """The roi-coordinate kernel against its plain version: (max abs err,
    worst err over its column's max |gradient|). Fails above ROIS_BWD_TOL,
    or if the gradient is zero everywhere."""
    from pointtinybenchmark_tpu_torch.ops import roi_align_cuda

    got = roi_align_cuda.roi_align_rois_backward(g, feats, rois, lvls,
                                                 ROI_STRIDES, out, sr)
    want = rois_backward_plain(g, feats, rois, lvls, out, sr)
    torch.cuda.synchronize()
    err = (got - want).abs().amax(0)
    top = want.abs().amax(0)
    share = float((err / top.clamp(min=1e-30)).max())
    if share > ROIS_BWD_TOL or not bool((top > 0).all()):
        raise AssertionError(f"roi-coordinate kernel vs plain: max abs err "
                             f"{err.tolist()} of column max {top.tolist()}, "
                             f"{share:.3e} (bar {ROIS_BWD_TOL})")
    return float(err.max()), share


def compare_backward_chunked(g, rois, lvls, shapes, out, sr):
    """The K2 backward against the plain backward in float64 (PLAIN_CHUNK
    rois a call): P2B's padding piles thousands of rois onto a few cells
    near the origin, whose float32 sums (the kernel's atomics in no fixed
    order, the plain version's sequential scatter-add) carry most of the
    rounding. Each level's error over its max |gradient|, for the kernel
    and for the plain float32 version; fails where the kernel's is above
    BWD_TOL and above twice the plain float32 version's own (two float32
    sums in different orders). Returns (the
    kernel's max abs err, its worst share, the plain version's worst
    share)."""
    from pointtinybenchmark_tpu_torch.ops import roi_align_cuda

    got = roi_align_cuda.roi_align_backward(g, rois, lvls, shapes,
                                            [True] * len(shapes), ROI_STRIDES,
                                            out, sr)
    plain = backward_plain(g, rois, lvls, shapes, out, sr)
    exact = backward_plain(g.double(), rois, lvls, shapes, out, sr)
    torch.cuda.synchronize()
    err, share, plain_share, failed = 0.0, 0.0, 0.0, []
    for lv, (a, p, b) in enumerate(zip(got, plain, exact)):
        m = float(b.abs().max())
        e = float((a - b).abs().max())
        s_k = e / m if m else (0.0 if e == 0 else float("inf"))
        s_p = float((p - b).abs().max()) / m if m else 0.0
        err, share, plain_share = max(err, e), max(share, s_k), max(
            plain_share, s_p)
        if s_k > max(BWD_TOL, 2 * s_p):
            failed.append((lv, s_k, s_p))
    if failed:
        raise AssertionError(f"RoIAlign backward kernel vs plain float64: "
                             f"(level, kernel, plain float32) {failed} of a "
                             f"level's max (bar {BWD_TOL} or twice the "
                             f"plain float32 version's)")
    return err, share, plain_share


def rois_backward_bound(feats, rois, lvls, out, sr):
    """(ms, bounded by) of the roi-coordinate gradient: the upstream
    gradient read once, every map cell an in-map sample's taps read, read
    once (C channels), rois and levels read and (R, 4) written once; 14
    float32 operations per in-map sample and channel (4 tap differences, 4
    weight products, 2 sums, 2 upstream products, 2 accumulations) and one
    scale per upstream value."""
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
                  + r * 5 + r + r * 4)
    samples = int(inb.sum())
    return bound(nbytes, 14 * samples * c + r * c * out * out), samples


def kernel_rows(card, label, feats, rois, lvls, g, out, sr, rois_grad=True):
    """K2 forward (torch.equal), K2 backward (BWD_TOL) and, with
    `rois_grad`, the roi-coordinate kernel (ROIS_BWD_TOL) on one set of
    inputs against their plain versions (PLAIN_CHUNK rois a call), with
    the rois on each forward path, times and bounds. Returns the three
    records (the third None without `rois_grad`)."""
    from pointtinybenchmark_tpu_torch.ops import roi_align_cuda

    r = rois.shape[0]
    shapes = [tuple(f.shape) for f in feats]
    per_level = torch.bincount(lvls, minlength=len(feats)).tolist()
    got = roi_align_cuda.roi_align_forward(feats, rois, lvls, ROI_STRIDES,
                                           out, sr)
    want = forward_plain(feats, rois, lvls, out, sr)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{label}: RoIAlign kernel != plain")
    del got, want
    paths = roi_paths(feats, rois, lvls, out, sr)
    f_ms = time_ms(lambda: roi_align_cuda.roi_align_forward(
        feats, rois, lvls, ROI_STRIDES, out, sr), ITERS)
    f_plain = time_ms(lambda: forward_plain(feats, rois, lvls, out, sr),
                      PLAIN_ITERS)
    f_bms, f_by = roi_align_bound(feats, rois, lvls, out, sr)
    fwd = dict(shape=label, R=r, S=out, sr=sr, max_abs_err=0.0, ms=f_ms,
               plain_ms=f_plain, bound_ms=f_bms, bound_by=f_by,
               per_level=per_level, paths=paths)
    b_err, b_share, b_plain_share = compare_backward_chunked(
        g, rois, lvls, shapes, out, sr)
    b_ms = time_ms(lambda: roi_align_cuda.roi_align_backward(
        g, rois, lvls, shapes, [True] * len(shapes), ROI_STRIDES, out, sr),
        ITERS)
    b_plain = time_ms(lambda: backward_plain(g, rois, lvls, shapes, out, sr),
                      P2B_PLAIN_BWD_ITERS)
    b_bms, b_by = roi_align_backward_bound(r, g.shape[1], out, sr, shapes)
    bwd = dict(shape=label, R=r, S=out, sr=sr, max_abs_err=b_err,
               err_share=b_share, plain_err_share=b_plain_share, ms=b_ms,
               plain_ms=b_plain, bound_ms=b_bms, bound_by=b_by,
               per_level=per_level)
    print(f"phase 11 {label} (R={r}, S={out}, sr={sr}, per level "
          f"{per_level}): forward kernel == plain, paths {shares(paths)}, "
          f"{f_ms:.4f} ms (plain {f_plain:.4f}, bound {f_bms:.4f} {f_by}); "
          f"backward vs plain float64 {b_err:.3e} ({b_share:.3e} of a "
          f"level's max, the plain float32 version's {b_plain_share:.3e}; "
          f"bar {BWD_TOL} or twice that), {b_ms:.4f} ms (plain "
          f"{b_plain:.4f}, bound {b_bms:.4f} {b_by}) [{card}]")
    if not rois_grad:
        return fwd, bwd, None
    err, share = compare_rois_backward(g, feats, rois, lvls, out, sr)
    counts = torch.zeros(len(roi_align_cuda.PATHS), dtype=torch.int32,
                         device=rois.device)
    first = roi_align_cuda.roi_align_rois_backward(
        g, feats, rois, lvls, ROI_STRIDES, out, sr, path_counts=counts)
    repeats = torch.equal(first, roi_align_cuda.roi_align_rois_backward(
        g, feats, rois, lvls, ROI_STRIDES, out, sr))
    rpaths = dict(zip(roi_align_cuda.PATHS, counts.tolist()))
    if not repeats:
        raise AssertionError(f"{label}: two launches of the roi-coordinate "
                             f"kernel differ")
    del first
    ms = time_ms(lambda: roi_align_cuda.roi_align_rois_backward(
        g, feats, rois, lvls, ROI_STRIDES, out, sr), ITERS)
    plain_ms = time_ms(lambda: rois_backward_plain(g, feats, rois, lvls, out,
                                                   sr), PLAIN_ITERS)
    (bms, by), samples = rois_backward_bound(feats, rois, lvls, out, sr)
    print(f"phase 11 {label}: roi-coordinate kernel vs plain max abs err "
          f"{err:.3e} ({share:.3e} of its column's max, bar {ROIS_BWD_TOL}); "
          f"rois per path {shares(rpaths)}; a second launch equal bit for "
          f"bit: {repeats}; {ms:.4f} ms (plain {plain_ms:.4f} in chunks of "
          f"{PLAIN_CHUNK}, "
          f"bound {bms:.4f} {by}, {samples} in-map samples of "
          f"{r * (out * sr) ** 2}) [{card}]")
    return fwd, bwd, dict(shape=label, R=r, S=out, sr=sr, max_abs_err=err,
                          err_share=share, ms=ms, plain_ms=plain_ms,
                          bound_ms=bms, bound_by=by, per_level=per_level,
                          in_map_samples=samples, paths=rpaths,
                          repeats=repeats)


def budget_rois(rng, b, hw, n=BUDGET_ROIS):
    """(n, 5) rois on `b` images of `hw`, of sizes log-uniform from 16 px
    to the image, inside it. At S = 7 sr = BUDGET_SR on level 0 their
    grids are over the roi-coordinate kernel's shared memory (read from
    global memory), in its generic form (sr not 2)."""
    h, w = hw
    size = np.minimum(np.exp(rng.uniform(np.log(16), np.log(max(h, w)),
                                         (n, 2))), [w, h])
    x1 = rng.uniform(0, w - size[:, 0])
    y1 = rng.uniform(0, h - size[:, 1])
    return np.stack([rng.randint(0, b, n), x1, y1, x1 + size[:, 0],
                     y1 + size[:, 1]], 1).astype(np.float32)


def rois_backward_inputs():
    """Phase 11 (a)'s inputs, one set at a time: (label, feats, rois, lvls,
    upstream gradient, S, sr) on channels-last 256-channel FPN maps of two
    800x1344 images: `p2b_bag_rois`' stage 0 bags, negatives and edge and
    bound-tie rois at S=7 sr=2 (their levels by scale), then
    `budget_rois` at S=7 sr=BUDGET_SR, all on level 0."""
    from pointtinybenchmark_tpu_torch.models.roi_heads.roi_extractor import \
        map_roi_levels
    from pointtinybenchmark_tpu_torch.utils.config import Config

    cfg = Config.fromfile(str(P2B_CONFIG))
    rng = np.random.RandomState(15)
    gen = torch.Generator(device=DEVICE).manual_seed(16)
    feats = [torch.randn((2, h, w, ROI_CHANNELS), generator=gen,
                         device=DEVICE).permute(0, 3, 1, 2)
             for h, w in P2B_LEVELS]
    for kind in ("cbp", "neg", "edge"):
        rois = torch.from_numpy(p2b_bag_rois(rng, cfg, kind)).to(DEVICE)
        lvls = map_roi_levels(rois, len(P2B_LEVELS))
        g = torch.randn((rois.shape[0], ROI_CHANNELS, 7, 7), generator=gen,
                        device=DEVICE)
        yield f"p2b {kind} rois", feats, rois, lvls, g, 7, 2
    rois = torch.from_numpy(budget_rois(
        rng, 2, tuple(cfg.loader["pad_shape"]))).to(DEVICE)
    lvls = torch.zeros(rois.shape[0], dtype=torch.int64, device=DEVICE)
    g = torch.randn((rois.shape[0], ROI_CHANNELS, 7, 7), generator=gen,
                    device=DEVICE)
    yield "rois on level 0 up to the whole image", feats, rois, lvls, g, 7, \
        BUDGET_SR


def phase_rois_backward(card):
    """Phase 11 (a): the roi-coordinate kernel (and K2 forward and
    backward) against their plain versions on `rois_backward_inputs`,
    each launch repeated bit for bit, the rois on each of the kernel's
    paths (every path taken somewhere). Returns the roi-coordinate
    kernel's records."""
    from pointtinybenchmark_tpu_torch.ops import roi_align_cuda

    rows = []
    for label, feats, rois, lvls, g, out, sr in rois_backward_inputs():
        rows.append(kernel_rows(card, label, feats, rois, lvls, g, out,
                                sr)[2])
        last = feats, rois, lvls, g
    # rois out of range (batch index 2, -1, NaN; level 7) get zeros
    feats, rois, lvls, g = last
    bad, bad_lvls = rois[:4].clone(), lvls[:4].clone()
    bad[:3, 0] = torch.tensor([2.0, -1.0, float("nan")], device=DEVICE)
    bad_lvls[3] = 7
    counts = torch.zeros(len(roi_align_cuda.PATHS), dtype=torch.int32,
                         device=DEVICE)
    zero = roi_align_cuda.roi_align_rois_backward(
        g[:4], feats, bad, bad_lvls, ROI_STRIDES, 7, BUDGET_SR,
        path_counts=counts)
    invalid = dict(zip(roi_align_cuda.PATHS, counts.tolist()))
    print(f"phase 11 (a) roi-coordinate kernel on 4 rois out of range: "
          f"rois per path {shares(invalid)}, all zero "
          f"{bool((zero == 0).all())}")
    if invalid["invalid"] != 4 or not bool((zero == 0).all()):
        raise AssertionError(f"rois out of range: {invalid}, {zero}")
    paths = {k: sum(r["paths"][k] for r in rows) + invalid[k]
             for k in invalid}
    print(f"phase 11 (a) roi-coordinate kernel, rois per path over its "
          f"{len(rows)} launch shapes: {shares(paths)}")
    if not all(paths.values()):
        raise AssertionError(f"a path of the roi-coordinate kernel is never "
                             f"taken: {paths}")
    return rows


def held_to_float64(kernel, plain, exact):
    """Each parameter's gradient error over its max |gradient| against a
    float64 step (`exact`) for the kernel step and the plain float32 step:
    float32 rounding alone moves P2BNet's full-width gradients by ~5e-4 of
    a parameter's max (the plain step's own error), so the kernel step
    passes where its error is within GRAD_TOL or within twice the plain
    step's. Returns (the kernel step's worst error, the plain step's
    worst, the parameters that fail). The instance biases as in
    `p2b_grad_error`."""
    p2b_grad_error(kernel, exact)
    p2b_grad_error(plain, exact)
    worst_k, worst_p, failed = 0.0, 0.0, []
    for n, w in exact.items():
        if n.endswith("ins.bias"):
            continue
        top = max(float(w.abs().max()), 1e-30)
        e_k = float((kernel[n].double() - w).abs().max()) / top
        e_p = float((plain[n].double() - w).abs().max()) / top
        worst_k, worst_p = max(worst_k, e_k), max(worst_p, e_p)
        if e_k > max(GRAD_TOL, 2 * e_p):
            failed.append((n, e_k, e_p))
    return worst_k, worst_p, failed


def p2b_grad_error(got, want):
    """`grad_error` over every parameter but the instance branches' biases,
    whose exact gradient is 0 (the bag softmax does not change when a
    constant is added to a class's logits): those must stay under 1e-6 of
    the largest gradient on both sides. Returns the worst share."""
    largest = max(float(w.abs().max()) for w in want.values())
    zero = [n for n in want if n.endswith("ins.bias")]
    noise = max(max(float(got[n].abs().max()), float(want[n].abs().max()))
                for n in zero)
    if noise > 1e-6 * largest:
        raise AssertionError(f"an ins.bias gradient of {noise} (exactly 0 "
                             f"in exact arithmetic)")
    return grad_error(got, {n: w for n, w in want.items() if n not in zero})


def step_launches(model, cfg, batch):
    """One train step's RoIAlign launches, recorded (forward, backward,
    roi-coordinate); the model's weights are put back after the step."""
    from pointtinybenchmark_tpu_torch.ops import roi_align_cuda

    calls = ([], [], [])
    init = {k: v.clone() for k, v in model.state_dict().items()}
    with recorded(roi_align_cuda, "roi_align_forward", calls[0]), \
            recorded(roi_align_cuda, "roi_align_backward", calls[1]), \
            recorded(roi_align_cuda, "roi_align_rois_backward", calls[2]):
        one_step(model, cfg, batch, seed=3)
    model.load_state_dict(init)
    return calls


def p2b_step_rows(card, label, fwd, bwd, rbw, slots):
    """The three kernels on one train step's recorded launches
    (`kernel_rows`), each bag pass by its rois: `slots` gt slots times the
    bag's size. Returns the forward, backward and roi-coordinate records,
    and a function that adds the backward's device times from a profile
    (`add_device_ms`), to be run after every timing of the run."""
    rows = ([], [], [])
    later = []
    for (feats, rois, lvls, _, out, sr, _), _, _ in fwd:
        r = rois.shape[0]
        g = next(args[0] for args, _, _ in bwd if args[0].shape[0] == r)
        grad_rois = any(args[2].shape[0] == r for args, _, _ in rbw)
        recs = kernel_rows(card, f"{label} step's bags of {r // slots}",
                           [f.detach() for f in feats], rois.detach(), lvls,
                           g, out, sr, rois_grad=grad_rois)
        for rec, acc in zip(recs, rows):
            if rec is not None:
                acc.append(rec)
        later.append((recs[1], g, rois.detach(), lvls,
                      [tuple(f.shape) for f in feats], out, sr))

    def device_times():
        for rec, *args in later:
            add_device_ms(card, rec, *args, phase="11")
    return rows, device_times


def refine_run(card, label, model, samples, collator, spg, expected,
               against_plain=False):
    """`run_refine_test` on `samples`, batches of `spg`, launches counted:
    `expected` a batch, one row per image with its annotation ids and
    finite boxes, points (the boxes' centres) and scores; with
    `against_plain` the rows equal those of the all-plain run; img/s from
    warm runs (host clock, the rows back as numpy). Returns the launches,
    img/s and a function that refines the first batch, for the profile."""
    from pointtinybenchmark_tpu_torch.engine.test import run_refine_test
    from pointtinybenchmark_tpu_torch.engine.train import batch_to_device

    n_batches = -(-len(samples) // spg)
    model.eval()
    torch.backends.cudnn.deterministic = True
    reset_launches()
    rows = run_refine_test(model, samples, collator, batch_size=spg)
    launches = read_launches()
    same = None
    if against_plain:
        with plain_roi_align():
            plain = run_refine_test(model, samples, collator, batch_size=spg)
        same = all(np.array_equal(a[k], b[k]) for a, b in zip(rows, plain)
                   for k in a)
    torch.backends.cudnn.deterministic = False
    for s, r in zip(samples, rows):
        ctr = (r["bboxes"][:, :2] + r["bboxes"][:, 2:4]) / 2
        if not (np.array_equal(r["anns_id"], s["gt_anns_id"])
                and np.isfinite(r["bboxes"]).all()
                and np.allclose(r["points"][:, :2], ctr, atol=1e-3)):
            raise AssertionError(f"{label} refined rows: ids or values")
    t0 = time.perf_counter()
    run_refine_test(model, samples, collator, batch_size=spg)
    img_s = len(samples) / (time.perf_counter() - t0)
    per_batch = {k: v / n_batches for k, v in launches.items()}
    print(f"phase 11 {label} run_refine_test: {len(samples)} images in "
          f"batches of {spg}, launches {launches}, per batch {per_batch}; "
          f"rows {[len(r['bboxes']) for r in rows]}, mean score "
          f"{np.mean([r['bboxes'][:, 4].mean() for r in rows]):.5f}"
          + ("" if same is None else f"; equal to the all-plain run's: "
             f"{same}") + f"; {img_s:.4f} img/s (warm, host clock, "
          f"collation and host rows included) [{card}]")
    if per_batch != expected or same is False:
        raise AssertionError(f"{label} refinement: launches {per_batch}, "
                             f"equal to plain {same}")
    first = batch_to_device(collator(samples[:spg]), DEVICE)

    def refine():
        with torch.no_grad():
            return model.refine_test(first["img"], first)
    return launches, img_s, refine


def phase_p2b(card):
    """Phase 11 (b)-(d): P2BNet and SSD-Det on COCO at full width
    (configs/p2b/p2bnet_r50_fpn_1x_coco.py, configs/ssd_det/
    ssd_det_r50_fpn_1x_coco.py: ResNet-50 with frozen_stages=1, FPN-256
    from stride 4, two MIL stages of 2 FCs of 1,024 on 7x7 sr=2 RoIAlign,
    80 classes; SGD 0.02 with linear warmup, no grad_clip; padded to
    800x1344 and 100 gts) with seeded weights, on synthetic 800x1333
    images of 5-30 COCO-sized objects (`p2b_samples`). P2BNet: (b)
    `train_detector` on 4 images, two a step (launches {K2 3, backward
    3, roi-coordinate 2} a step, finite losses, frozen stem and layer1
    bit-identical); one step with the
    kernels against one with the plain RoIAlign at the main path's 100
    slots (equal losses; gradients held to a float64 step,
    `held_to_float64`; the plain version holds four (R, 14, 14, 256)
    gathers a pass for autograd: 16 GB for the step's 20,400 rois in
    float32, twice that in float64);
    the card against the CPU on one P2B_CPU_HW image of at most
    P2B_CPU_GTS gts in float64 (losses within LOSS_TOL, gradients within
    GRAD_TOL; the card's float64 step on the plain RoIAlign, as the
    kernels take float32; float32 printed beside the CPU's own float32
    against float64, which reaches 1e-4 of loss_cbp and 1e-3 of a
    gradient's max); step ms, img/s, peak memory; the three kernels on a
    step's own recorded launches against their plain versions, with times
    and bounds; (c) `run_refine_test` on 8 images (2 launches a batch,
    rows equal to the all-plain run's, img/s). (d) SSD-Det on noisy
    boxes: the same `train_detector` run, the three kernels on its step's
    own launches, step time and refinement. Returns the launches by path,
    the step records (P2BNet's, then SSD-Det's) and the profiles, to be
    run after every timing."""
    from pointtinybenchmark_tpu_torch.data.loader import DetCollator
    from pointtinybenchmark_tpu_torch.engine.train import batch_to_device
    from pointtinybenchmark_tpu_torch.ops import roi_align_cuda
    from pointtinybenchmark_tpu_torch.utils.config import Config

    cfg = Config.fromfile(str(P2B_CONFIG))
    spg = int(cfg.data["samples_per_gpu"])
    max_gt = int(cfg.loader["max_gt"])
    pad = tuple(cfg.loader["pad_shape"])
    nk = dict(cfg.data["train"]["noise_kwargs"])
    samples = p2b_samples(np.random.RandomState(17), P2B_TRAIN_IMAGES, nk,
                          gts=max_gt)
    print(f"phase 11 training config: {P2B_CONFIG.name}, samples_per_gpu "
          f"{spg}, loader {dict(cfg.loader)}, optimizer {dict(cfg.optimizer)},"
          f" grad_clip {cfg.optimizer_config.get('grad_clip')}, lr_config "
          f"{dict(cfg.lr_config)}, points {nk}; {P2B_TRAIN_IMAGES} synthetic "
          f"{COCO_HW} images, objects per image "
          f"{[len(s['gt_bboxes']) for s in samples]}")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    model, init, train_launches = train_run(
        card, "11", cfg, samples, P2B_TRAIN_EPOCHS, P2B_TRAIN_LAUNCHES, {},
        require_change=False)
    collator = DetCollator(pad, max_gt=max_gt)
    batch = batch_to_device(collator(samples[:spg]), DEVICE)

    # one step with the kernels against one with the plain RoIAlign, both
    # held to a float64 step (plain RoIAlign) from the same weights, on the
    # main path's batch (100 gt slots)
    collated = collator(samples[:spg])
    torch.backends.cudnn.deterministic = True
    reset_launches()
    got, got_grads = one_step(model, cfg, batch, seed=3)
    k_launches = read_launches()
    model.load_state_dict(init)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with plain_roi_align():
        want, want_grads = one_step(model, cfg, batch, seed=3)
        p_launches = read_launches()
        torch.cuda.synchronize()
        plain_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        _, exact = double_step(cfg, collated, 3, DEVICE)
        torch.cuda.synchronize()
        exact_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    model.load_state_dict(init)
    torch.backends.cudnn.deterministic = False
    loss_keys = [k for k in want if k.startswith(("loss", "bag_acc"))]
    direct = p2b_grad_error(got_grads, want_grads)
    worst_k, worst_p, failed = held_to_float64(got_grads, want_grads, exact)
    s0 = "bbox_head.stages.0.shared_fcs.0.weight"
    print(f"phase 11 one step at {max_gt} gt slots, kernels vs plain "
          f"RoIAlign: launches {k_launches} vs {p_launches}; peak memory "
          f"of the plain float32 step {plain_peak:.3f} GiB, of the float64 "
          f"one {exact_peak:.3f} GiB (all the process holds); " +
          ", ".join(f"{k} {got[k]:.6f}" for k in loss_keys) + f"; losses "
          f"equal: {all(got[k] == want[k] for k in loss_keys)}; gradients "
          f"against a float64 step, worst error of a parameter's max "
          f"|grad|: kernels {worst_k:.3e}, plain {worst_p:.3e} (bar: "
          f"{GRAD_TOL} or twice the plain step's; failing {failed}); "
          f"kernels vs plain directly {direct:.3e}; stage 0's first FC max "
          f"|grad| {float(got_grads[s0].abs().max()):.4e}")
    if k_launches != P2B_TRAIN_LAUNCHES or any(
            p_launches[k] for k in roi_align_cuda.launches):
        raise AssertionError(f"launches {k_launches}, plain {p_launches}")
    if any(got[k] != want[k] for k in loss_keys) or failed:
        raise AssertionError(f"kernels vs plain: {got} vs {want}, gradients "
                             f"{failed}")
    del got_grads, want_grads, exact

    # the card against the CPU on one smaller image
    one = p2b_samples(np.random.RandomState(18), 1, nk, hw=P2B_CPU_HW,
                      gts=P2B_CPU_GTS)
    collated = DetCollator(None, int(cfg.loader.get("size_divisor", 32)),
                           max_gt=P2B_CPU_GTS)(one)
    card_m, _ = one_step(model, cfg, batch_to_device(collated, DEVICE),
                         seed=4)
    model.load_state_dict(init)
    cpu_m, cpu_g = one_step(train_model(cfg, device="cpu"), cfg,
                            batch_to_device(collated, "cpu"), seed=4,
                            device="cpu")
    with plain_roi_align():
        card_m64, card_g64 = double_step(cfg, collated, 4, DEVICE)
    cpu_m64, cpu_g64 = double_step(cfg, collated, 4, "cpu")

    def rel(a, b):
        return {k: abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                for k in loss_keys}
    errs, errs64 = rel(card_m, cpu_m), rel(card_m64, cpu_m64)
    own = rel(cpu_m, cpu_m64)
    worst64 = p2b_grad_error(card_g64, cpu_g64)
    rounding = p2b_grad_error(cpu_g, cpu_g64)
    print(f"phase 11 one step, card vs CPU (one {collated['img'].shape[1:3]} "
          f"image, {len(one[0]['gt_bboxes'])} gts; the card's float64 step "
          f"on the plain RoIAlign: the kernels take float32), float64 rel "
          f"err: " + ", ".join(f"{k} {v:.3e}" for k, v in errs64.items())
          + f" (bar {LOSS_TOL}), worst gradient error of its parameter's "
          f"max |grad| {worst64:.3e} (bar {GRAD_TOL}); float32 (not held) "
          f"rel err: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + "; the CPU's float32 against its float64: losses " + ", ".join(
              f"{k} {v:.3e}" for k, v in own.items()) + f", gradients "
          f"{rounding:.3e}")
    if max(errs64.values()) > LOSS_TOL or worst64 > GRAD_TOL:
        raise AssertionError(f"card vs CPU in float64: {card_m64} vs "
                             f"{cpu_m64}, gradient {worst64}")
    del cpu_g, card_g64, cpu_g64

    _, step_profile = time_step(card, "11", "p2bnet_train", cfg, model,
                                batch, held, spg)
    # the launches of a step from the seeded weights (after the timing, so
    # that the peak above is the step's own)
    model.load_state_dict(init)
    step_rows, step_bwd_times = p2b_step_rows(
        card, "p2bnet train", *step_launches(model, cfg, batch),
        spg * max_gt)
    del model, init

    # (c) refinement
    refine_model = train_model(cfg)
    refine_samples = p2b_samples(np.random.RandomState(19), P2B_REFINE_IMAGES,
                                 nk, gts=max_gt)
    refine_launches, _, refine = refine_run(
        card, "p2bnet", refine_model, refine_samples, collator, spg,
        P2B_REFINE_LAUNCHES, against_plain=True)

    # (d) SSD-Det
    scfg = Config.fromfile(str(SSD_CONFIG))
    ssd = p2b_samples(np.random.RandomState(20), P2B_TRAIN_IMAGES, None,
                      kind="box", gts=max_gt)
    print(f"phase 11 (d) {SSD_CONFIG.name}: bbox_head "
          f"{ {k: v for k, v in scfg.model['bbox_head'].items()} }, dataset "
          f"noise_kwargs {dict(scfg.data['train']['noise_kwargs'])} (P2BNet's "
          f"pseudo_wh merged in: the JAX Config gives the same); fed noisy "
          f"boxes (shifted by up to 40% of their size) as the JAX test does")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    smodel, sinit, ssd_launches = train_run(
        card, "11 (d)", scfg, ssd, P2B_TRAIN_EPOCHS, P2B_TRAIN_LAUNCHES, {},
        require_change=False)
    sbatch = batch_to_device(collator(ssd[:spg]), DEVICE)
    _, ssd_profile = time_step(card, "11 (d)", "ssd_det_train", scfg, smodel,
                               sbatch, held, spg)
    smodel.load_state_dict(sinit)
    ssd_rows, ssd_bwd_times = p2b_step_rows(
        card, "ssd_det train", *step_launches(smodel, scfg, sbatch),
        spg * max_gt)
    step_rows = tuple(a + b for a, b in zip(step_rows, ssd_rows))
    del smodel, sinit, sbatch
    ssd_refine = p2b_samples(np.random.RandomState(21), P2B_REFINE_IMAGES,
                             None, kind="box", gts=max_gt)
    ssd_refine_launches, _, ssd_refine_fn = refine_run(
        card, "ssd_det", train_model(scfg), ssd_refine, collator, spg,
        P2B_REFINE_LAUNCHES)

    def profiles():
        step_profile()
        step_bwd_times()
        ssd_bwd_times()
        device_profile(card, refine, "p2bnet_refine", PROFILE_CALLS,
                       f"warm refine_test calls of {spg} images")
        ssd_profile()
        device_profile(card, ssd_refine_fn, "ssd_det_refine", PROFILE_CALLS,
                       f"warm refine_test calls of {spg} images")
    by_path = {"p2bnet_train": train_launches,
               "p2bnet_refine": refine_launches,
               "ssd_det_train": ssd_launches,
               "ssd_det_refine": ssd_refine_launches}
    return by_path, step_rows, profiles


# ------------------------------------- (f) the port's seeded weights train
def seeded_steps(card, label, cfg, batch):
    """P2B_SEEDED_STEPS SGD steps of the config's model from
    `build_detector(seed=0)`, at the config's schedule (as `time_step`
    builds it: 4 iterations an epoch, 12 epochs, so step i runs at
    iteration i's warmup lr), on `batch` repeated. Returns the total losses
    and whether every metric stayed finite with `nan_seen` false."""
    from pointtinybenchmark_tpu_torch.engine.optimizer import build_optimizer
    from pointtinybenchmark_tpu_torch.engine.train import (init_train_state,
                                                           make_train_step)

    model = train_model(cfg)
    opt = build_optimizer(model, cfg.optimizer, cfg.get("optimizer_config"),
                          cfg.get("lr_config"), 4, 12,
                          model.backbone.frozen_stages)
    step = make_train_step(model, opt)
    state = init_train_state(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    seen = [step(state, batch, gen) for _ in range(P2B_SEEDED_STEPS)]
    losses = [float(m["loss"]) for m in seen]
    finite = all(bool(torch.isfinite(v).all()) for m in seen
                 for v in m.values()) and not any(
        bool(m["nan_seen"]) for m in seen)
    head, tail = np.mean(losses[:4]), np.mean(losses[-4:])
    print(f"phase 11 (f) {label} from build_detector(seed=0), "
          f"{P2B_SEEDED_STEPS} SGD steps at the config's schedule on one "
          f"batch of 2 images: losses {[round(v, 4) for v in losses]}; "
          f"finite {finite}; mean of the first 4 {head:.4f}, of the last 4 "
          f"{tail:.4f} [{card}]")
    return losses, finite


def phase_seeded(card):
    """Phase 11 (f): the port's seeded weights train. P2BNet (held): every
    loss of `seeded_steps` finite and the mean of the last 4 below that of
    the first 4. SSD-Det's run is printed, not held: the JAX package's own
    SSD-Det diverges at this schedule too (ROADMAP.md queue 3)."""
    from pointtinybenchmark_tpu_torch.data.loader import DetCollator
    from pointtinybenchmark_tpu_torch.engine.train import batch_to_device
    from pointtinybenchmark_tpu_torch.utils.config import Config

    runs = {}
    for label, path, kind, seed in (("P2BNet", P2B_CONFIG, "point", 17),
                                    ("SSD-Det", SSD_CONFIG, "box", 20)):
        cfg = Config.fromfile(str(path))
        max_gt = int(cfg.loader["max_gt"])
        nk = (dict(cfg.data["train"]["noise_kwargs"]) if kind == "point"
              else None)
        samples = p2b_samples(np.random.RandomState(seed), 2, nk, kind=kind,
                              gts=max_gt)
        batch = batch_to_device(DetCollator(tuple(cfg.loader["pad_shape"]),
                                            max_gt=max_gt)(samples), DEVICE)
        runs[label] = seeded_steps(card, label, cfg, batch)
    losses, finite = runs["P2BNet"]
    if not finite or not np.mean(losses[-4:]) < np.mean(losses[:4]):
        raise AssertionError(f"the port's seeded P2BNet does not train: "
                             f"{losses}")
    return runs


# ------------------------------------------- (e) learnability on the card
def phase_learn(card):
    """Phase 11 (e): tests/test_models_p2b.py's two learnability scenarios
    on the card from the JAX test's initial weights, LEARN_PROCS processes
    of LEARN_RUNS runs each, all at once (`learnability_p2b.py`). Held:
    every loss finite; P2BNet: the test's floors met by the means of its
    runs; SSD-Det, whose floor JAX's own perturbed runs meet in 8 of 11
    and not on their mean: its runs' mean IoU at most LEARN_SE standard
    errors of the difference below JAX's perturbed runs' mean (LEARN_JAX),
    and above the noisy boxes' IoU. Printed beside them: each run's floors,
    the spread and JAX's numbers. Returns the runs by scenario."""
    import learnability_p2b as lp

    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "learnability_p2b.py"), "--reps",
         str(LEARN_RUNS), "--kinds", kind], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for kind, n in LEARN_PROCS.items() for _ in range(n)]
    outs = [p.communicate()[0] for p in procs]
    if any(p.returncode for p in procs):
        raise AssertionError("a learnability process failed:\n" + "\n".join(
            o[-2000:] for p, o in zip(procs, outs) if p.returncode))
    runs = collections.defaultdict(list)
    for o in outs:
        for line in o.splitlines():
            if line.startswith("{"):
                r = json.loads(line)
                runs[r["kind"]].append(r)
    failed = []
    for kind, n in LEARN_PROCS.items():
        rs = runs[kind]
        if len(rs) != n * LEARN_RUNS:
            failed.append(f"{kind}: {len(rs)} runs")
            continue
        iou = np.array([r["mean_iou"] for r in rs])
        mean = {k: (np.mean([r[k] for r in rs], 0).tolist()
                    if k == "scale_mass"
                    else float(np.mean([r[k] for r in rs])))
                for k in ("mean_iou", "above_half", "scale_mass", "noisy_iou")
                if k in rs[0]}
        met = [lp.learn_floors(kind, r) for r in rs]
        n_j, mean_j, sd_j, met_j = LEARN_JAX[kind]
        se = float(np.sqrt(iou.var(ddof=1) / len(rs) + sd_j ** 2 / n_j))
        if kind == "P2BNet":
            ok = lp.learn_floors(kind, mean)
            held = f"the floors on the means (held): {ok}"
        else:
            ok = (mean["mean_iou"] >= mean_j - LEARN_SE * se
                  and mean["mean_iou"] > mean["noisy_iou"])
            held = (f"held: the mean at least JAX's {mean_j:.4f} less "
                    f"{LEARN_SE} x {se:.4f} (the difference's standard "
                    f"error) = {mean_j - LEARN_SE * se:.4f}, and above the "
                    f"noisy IoU {mean['noisy_iou']:.4f}: {ok}; the floors on "
                    f"the means (not held): {lp.learn_floors(kind, mean)}")
        print(f"phase 11 (e) {kind} learnability, {len(rs)} runs of "
              f"{lp.LEARN_STEPS} Adam steps of {lp.LEARN_BATCH} "
              f"{lp.LEARN_SIZE}x{lp.LEARN_SIZE} images from the JAX test's "
              f"initial weights: mean IoU {iou.mean():.4f} (sd "
              f"{iou.std(ddof=1):.4f}, min {iou.min():.4f}, max "
              f"{iou.max():.4f}; means {json.dumps(mean)}); {held}; the "
              f"floors met by {sum(met)} of {len(rs)} runs; JAX's {n_j} "
              f"perturbed runs {mean_j:.4f} (sd {sd_j:.4f}, the floors met "
              f"by {met_j}), JAX's own trajectory "
              f"{'0.5585' if kind == 'P2BNet' else '0.6973'} [{card}]")
        if not all(np.isfinite(r["final_loss"]) for r in rs):
            failed.append(f"{kind}: a loss is not finite")
        if not ok:
            failed.append(f"{kind}: the means miss their bar")
    if failed:
        raise AssertionError(f"learnability: {failed}")
    return runs


# ---- phase 12: FCOS, ATSS, RepPoints, FoveaBox, FreeAnchor (dense heads)
def dets_match(ref, got, atol_box=2e-3, atol_score=1e-4):
    """tests/test_detector_golden.py:88's tolerances: each detection of
    `ref` ((n, 5) rows, labels) matched to its own of `got` with the same
    label, a score within atol_score and a box within atol_box (both rtol
    1e-4), the same count. Returns the count or raises."""
    (rb, rl), (gb, gl) = ref, got
    if gb.shape != rb.shape:
        raise AssertionError(f"detections {gb.shape} vs {rb.shape}")
    used = np.zeros(len(gb), bool)
    for i in range(len(rb)):
        ok = (~used & (gl == rl[i])
              & (np.abs(gb[:, 4] - rb[i, 4])
                 <= atol_score + 1e-4 * abs(rb[i, 4]))
              & (np.abs(gb[:, :4] - rb[i, :4])
                 <= atol_box + 1e-4 * np.abs(rb[i, :4])).all(1))
        if not ok.any():
            raise AssertionError(f"detection {i} {rb[i]} has no match")
        used[np.argmax(ok)] = True
    return len(rb)


def tile_dets(dets, i=0):
    """Tile i's valid detections as score-sorted ((n, 5), labels)."""
    v = dets.valid[i].cpu().numpy()
    boxes = dets.bboxes[i].cpu().numpy()[v]
    labels = dets.labels[i].cpu().numpy()[v]
    order = np.argsort(-boxes[:, 4], kind="stable")
    return boxes[order], labels[order]


def head_outputs(outs):
    """The head's per-level output tensors (RepPoints' moment_transfer, a
    parameter, left out)."""
    return [t for group in outs if isinstance(group, (list, tuple))
            for t in group]


def phase_dense(card, frames, name, config, cls_name):
    """Phase 12 (a): a dense TinyPerson baseline's tiled protocol at full
    width (ResNet-50, FPN-256 from stride 4, the config's head with its GN
    convs) on the two frames, `cls_name`'s bias set to 0 after `unfixed`:
    launches, candidates and kept boxes per tile, detections equal to
    those with the plain NMS, K1 against its plain version on the run's
    own two launches, the card against the CPU on one tile (head outputs,
    and detections at the golden tolerances), protocol and forward-only
    img/s, the protocol's peak memory. Returns the launches, the handle
    (for the profile) and the K1 rows."""
    from pointtinybenchmark_tpu_torch.apis.inference import (
        inference_detector_tiled, init_detector)
    from pointtinybenchmark_tpu_torch.ops import nms_cuda

    handle = init_detector(str(config), device=DEVICE, seed=0)
    model, head = handle.model, handle.model.bbox_head
    unfixed(f"phase 12 {name}", handle, frames)
    with torch.no_grad():
        getattr(head, cls_name).bias.zero_()
    print(f"phase 12 {name}: {cls_name}.bias set to 0 so that candidates "
          f"pass score_thr (with the focal prior no score of random weights "
          f"does)")
    cfg = head.test_cfg
    thr = float(cfg["nms"]["iou_threshold"])

    torch.backends.cudnn.deterministic = True
    bits, walks = [], []
    reset_launches()
    with recorded(nms_cuda, "iou_bitmask", bits), \
            recorded(nms_cuda, "greedy_reduce", walks):
        results = inference_detector_tiled(handle, list(frames))
    launches = read_launches()
    print(f"phase 12 launches on the {name} path: {launches}")
    if launches != RETINA_LAUNCHES:
        raise AssertionError(f"expected one per-tile and one global launch of "
                             f"each NMS kernel, got {launches}")
    with plain_nms():
        results_plain = inference_detector_tiled(handle, list(frames))
    torch.backends.cudnn.deterministic = False
    check_frames(results, f"phase 12 {name}")
    for i, (r, p) in enumerate(zip(results, results_plain)):
        if not (np.array_equal(r["bboxes"], p["bboxes"])
                and np.array_equal(r["labels"], p["labels"])):
            raise AssertionError(f"frame {i}: kernel and plain NMS disagree")
    print(f"phase 12 {name}: detections with the kernels == detections "
          f"with the plain NMS")

    eng = next(iter(handle.tiled_engines.values()))
    tiles = eng.pre(frames)
    # a cell gives one candidate, or one an anchor (FreeAnchor's 9)
    per_cell = getattr(head, "num_base_anchors", 1)
    h, w = eng.pre.tile_hw
    n_cand = sum(min(int(cfg["nms_pre"]),
                     (h + s - 1) // s * ((w + s - 1) // s) * per_cell)
                 for s in DENSE_STRIDES)
    rows = []
    for ((sboxes, k1_thr, n_valid), _, _), ((_, ok, order, max_out, _), _,
                                            _), what in zip(
            bits, walks, ("per-tile", "global merge")):
        if max_out != MAX_OUT:
            raise AssertionError(f"{what} keeps {max_out}, not {MAX_OUT}")
        rows.append(k1_row(card, f"{name} {what}", sboxes, ok, order,
                           n_valid, k1_thr, phase="12"))
    want = [((tiles.shape[0], n_cand, 4), thr),
            ((N_FRAMES, eng.pre.n_views * MAX_OUT, 4), 0.5)]
    got = [(tuple(a[0].shape), a[1]) for a, _, _ in bits]
    if got != want:
        raise AssertionError(f"K1 launch shapes {got}, expected {want}")
    del bits, walks

    img_shapes = torch.tensor([eng.pre.tile_hw], dtype=torch.int32,
                              device=DEVICE).expand(tiles.shape[0], 2)
    with torch.no_grad():
        outs = model(tiles)
        dets = head.get_bboxes(*outs, img_shapes)
    score_thr = float(cfg["score_thr"])
    cands = sum((o.sigmoid().amax(1) > score_thr).flatten(1).sum(1)
                for o in outs[0]).tolist()
    kept = dets.valid.sum(1).tolist()
    print(f"phase 12 {name} per-tile NMS input: {n_cand} candidates a tile "
          f"(top {cfg['nms_pre']} a level of {per_cell} a cell), cells over "
          f"score_thr {cands}")
    print(f"phase 12 {name} per-tile NMS kept: {kept}")
    if min(cands) <= 0 or min(kept) <= 0:
        raise AssertionError("NMS got no work")

    cpu_model = init_detector(str(config), device="cpu", seed=0).model
    with torch.no_grad():
        getattr(cpu_model.bbox_head, cls_name).bias.zero_()
        ref = cpu_model(tiles[:1].cpu())
        ref_dets = cpu_model.bbox_head.get_bboxes(*ref, img_shapes[:1].cpu())
    err = rel_err([t[:1] for t in head_outputs(outs)], head_outputs(ref))
    n = dets_match(tile_dets(ref_dets), tile_dets(dets))
    print(f"phase 12 {name} head outputs, card vs CPU on one tile: max rel "
          f"err {err:.3e}; its {n} detections match at the golden "
          f"tolerances (box 2e-3, score 1e-4)")
    if err > 1e-4:
        raise AssertionError(f"card forward differs from CPU: {err}")
    del cpu_model, ref, outs

    if any(hasattr(head, a) for a in GATHERS):
        gather_share(card, name, model, head, tiles)
    protocol, forward = throughput(handle, frames, tiles)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    inference_detector_tiled(handle, list(frames))
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    print(f"phase 12 {name} protocol ({N_FRAMES} frames of "
          f"{eng.pre.n_views} tiles, host in the loop): {protocol:.4f} img/s; "
          f"forward only ({tiles.shape[0]} tiles, f32, TF32 off): "
          f"{forward:.4f} img/s; a protocol call's peak memory "
          f"{peak:.3f} GiB above the {held / 2 ** 30:.3f} GiB held [{card}]")
    return launches, handle, rows


def gather_share(card, name, model, head, tiles):
    """A deformable head's gathers (RepPoints' `deform_gather`, VFNet's
    `star_gather`: 9 taps bilinear from the map, per branch and level) on
    the forward's own inputs, timed alone by CUDA events, against the
    whole forward's time."""
    calls = []
    attr = next(a for a in GATHERS if hasattr(head, a))
    gather = getattr(head, attr)

    def record(feat, offsets):
        calls.append((feat, offsets))
        return gather(feat, offsets)
    setattr(head, attr, record)
    try:
        with torch.no_grad():
            model(tiles)
    finally:
        delattr(head, attr)
    with torch.no_grad():
        gather_ms = time_ms(lambda: [gather(f, o) for f, o in calls], ITERS)
        forward_ms = time_ms(lambda: model(tiles), ITERS)
    out_gb = sum(f.numel() * 9 * 4 for f, _ in calls) / 1e9
    print(f"phase 12 {name} deformable gathers ({attr}): {len(calls)} a "
          f"forward "
          f"(2 branches x {len(calls) // 2} levels, {tiles.shape[0]} tiles, "
          f"{out_gb:.2f} GB of taps written), {gather_ms:.4f} ms alone, "
          f"{gather_ms / forward_ms:.4f} of the forward's {forward_ms:.4f} ms "
          f"[{card}]")
    del calls


def paramwise_check(model, init, grads, cfg, name):
    """FCOS's and VFNet's paramwise_cfg on the first step from `init`: a
    conv bias (the regression conv's) moves by 2 lr times its clipped
    gradient with no decay, a GroupNorm bias (a norm leaf) by lr times its
    clipped gradient plus the decay; the clip factor from the global norm
    of every gradient."""
    from pointtinybenchmark_tpu_torch.engine.optimizer import \
        build_lr_schedule

    opt = dict(cfg.optimizer)
    lr = float(build_lr_schedule(opt["lr"], cfg.lr_config, 1, 1)(0))
    wd = opt["weight_decay"]
    max_norm = float(cfg.optimizer_config["grad_clip"]["max_norm"])
    norm = float(torch.stack([g.double().norm() for g in grads.values()])
                 .norm())
    clip = 1.0 if norm < max_norm else max_norm / norm
    after = model.state_dict()
    errs = {}
    reg = ("bbox_head.vfnet_reg.bias" if "bbox_head.vfnet_reg.bias" in grads
           else "bbox_head.conv_reg.bias")
    for leaf, lr_mult, decay in ((reg, 2.0, 0.0),
                                 ("bbox_head.cls_convs.0.gn.bias", 1.0, wd)):
        p0 = init[leaf].double()
        want = p0 - lr * lr_mult * (grads[leaf].double() * clip + decay * p0)
        moved = float((want - p0).abs().max())
        errs[leaf] = float((after[leaf].double() - want).abs().max())
        print(f"phase 12 {name} paramwise: {leaf} moved by up to "
              f"{moved:.4e} (lr_mult {lr_mult}, decay {decay}), the "
              f"hand-computed update's error {errs[leaf]:.3e} (gradient "
              f"norm {norm:.4f}, clip factor {clip:.4f})")
        if errs[leaf] > 1e-6 + 1e-3 * moved:
            raise AssertionError(f"{leaf}: not the paramwise update")


def phase_dense_train(card, name, config):
    """Phase 12 (b): the config's training at full width with seeded
    weights: `train_run` (no kernel launch, finite losses, positives in
    every step (FreeAnchor: a positive bag loss above 0), the frozen stem
    and layer1 bit-identical and the rest changed); one step on the card
    against the CPU (losses within
    LOSS_TOL); for FCOS its paramwise_cfg against a hand-computed update;
    then train-step ms, img/s and peak memory. Returns the launches and
    the profile (c), to be run after every timing."""
    from pointtinybenchmark_tpu_torch.data.loader import DetCollator
    from pointtinybenchmark_tpu_torch.engine.train import batch_to_device
    from pointtinybenchmark_tpu_torch.utils.config import Config

    cfg = Config.fromfile(str(config))
    spg = int(cfg.data["samples_per_gpu"])
    samples = train_samples(np.random.RandomState(14), TRAIN_IMAGES)
    print(f"phase 12 {name} training config: {config.name}, samples_per_gpu "
          f"{spg}, optimizer {dict(cfg.optimizer)}, grad_clip "
          f"{cfg.optimizer_config.get('grad_clip')}, lr_config "
          f"{dict(cfg.lr_config)}; {TRAIN_IMAGES} synthetic images, gts per "
          f"image {[len(s['gt_bboxes']) for s in samples]}")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    model, init, launches = train_run(card, f"12 {name}", cfg, samples,
                                      DENSE_TRAIN_EPOCHS, NO_LAUNCHES,
                                      DENSE_POSITIVES.get(name,
                                                          {"num_pos": 0}))
    collator = DetCollator(tuple(cfg.loader["pad_shape"]),
                           max_gt=int(cfg.loader["max_gt"]),
                           max_gt_ignore=int(cfg.loader["max_gt_ignore"]))
    collated = collator(samples[:spg])
    batch = batch_to_device(collated, DEVICE)
    card_m, card_g = one_step(model, cfg, batch, seed=3)
    if cfg.optimizer.get("paramwise_cfg"):
        paramwise_check(model, init, card_g, cfg, name)
    model.load_state_dict(init)
    cpu_m, _ = one_step(train_model(cfg, device="cpu"), cfg,
                        batch_to_device(collated, "cpu"), seed=3,
                        device="cpu")
    keys = [k for k in cpu_m if k.startswith("loss") or k == "num_pos"]
    errs = {k: abs(card_m[k] - cpu_m[k]) / max(abs(cpu_m[k]), 1e-30)
            for k in keys}
    print(f"phase 12 {name} one step, card vs CPU, rel err: " + ", ".join(
        f"{k} {v:.3e} ({card_m[k]:.5f})" for k, v in errs.items())
        + f" (bar {LOSS_TOL})")
    if max(errs.values()) > LOSS_TOL or not card_m["num_pos"] > 0:
        raise AssertionError(f"card vs CPU: {card_m} vs {cpu_m}")
    del card_g
    _, profile = time_step(card, f"12 {name}", f"{name}_train", cfg, model,
                           batch, held, spg)
    return launches, profile


# -------------------------------------------- phase 13: Adap Grid R-CNN
def forward_device_ms(feats, rois, lvls, out, sr, label,
                      calls=DEVICE_MS_CALLS):
    """The K2 forward kernel's device time per call, the mean of its
    events in a torch.profiler trace of `calls` warm wrapper calls (the
    trace goes to build/), and whence it came: where every trace lost the
    kernel's events, the call's time by CUDA events instead."""
    from pointtinybenchmark_tpu_torch.ops import roi_align_cuda

    def run():
        roi_align_cuda.roi_align_forward(feats, rois, lvls, ROI_STRIDES, out,
                                         sr)

    def durs(events):
        return [e["dur"] for e in events if e.get("cat") == "kernel"
                and "roi_align_kernel" in e["name"]]
    run()
    torch.cuda.synchronize()
    trace = REPO / "build" / f"forward_trace_{label}.json"
    events, _, traced = traced_events(
        run, calls, trace, lambda ev: len(durs(ev)) >= calls // 2)
    if events is None:
        ms = events_ms(run, calls)
        print(f"{label}: every trace lost the forward kernel's events "
              f"({dict(traced)}); the call's time by CUDA events instead: "
              f"{ms:.4f} ms")
        return ms, f"CUDA events over {calls} calls"
    d = durs(events)
    return sum(d) / len(d) / 1e3, f"a profile of {calls} calls"


def grid_head_flops(head, r, s):
    """f32 operations of the grid head on r crops of s x s: the 3x3
    convolutions and the point features at s, the 5x5 fusions at s, the
    two 2x2 stride-2 transposed convolutions (one tap per output pixel and
    input channel) at 2s and 4s; 2 per multiply-add."""
    convs = sum(2 * r * s * s * 9 * m.in_channels * m.out_channels
                for name, m in head.named_children()
                if name.startswith("conv"))
    rest = sum(2 * r * s * s * m.weight[0].numel() * m.out_channels
               for name, m in head.named_children()
               if name.startswith(("point_feat", "fuse")))
    up = sum(2 * r * (2 * s * (2 if name.startswith("deconv2") else 1)) ** 2
             * m.in_channels * m.out_channels
             for name, m in head.named_children()
             if name.startswith("deconv"))
    return convs + rest + up


def phase_grid(card, frames):
    """Phase 13 (a): Adap Grid R-CNN's tiled protocol at full width
    (Faster R-CNN's network, the grid head of 8 GN(36) convs at 576 on
    S=14 sr=2 crops) with seeded weights on the two frames: launches
    (K2 once at S=7 sr=1, once at S=14 sr=2), detections equal to those of
    the run with every kernel swapped for its plain version, K2 on the
    protocol's own grid rois torch.equal to the plain version (PLAIN_CHUNK
    rois a call), with paths, times, device time and bound; the grid head
    on the card against the CPU's on GRID_CPU_ROIS rois of one tile;
    protocol and forward-only img/s (GRID_ITERS calls), the grid branch's
    share of the forward, the grid head's TFLOP/s, a protocol call's peak
    memory. Returns the launches, the handle (for the profile), the K2
    record and a function that adds K2's device time to it, to be run
    after every timing."""
    import copy

    from pointtinybenchmark_tpu_torch.apis.inference import (
        inference_detector_tiled, init_detector)
    from pointtinybenchmark_tpu_torch.models.roi_heads.grid_roi_head import \
        grid_refine_boxes
    from pointtinybenchmark_tpu_torch.models.roi_heads.roi_extractor import \
        map_roi_levels
    from pointtinybenchmark_tpu_torch.models.roi_heads.standard_roi_head \
        import StandardRoIHead
    from pointtinybenchmark_tpu_torch.ops import roi_align_cuda

    handle = init_detector(str(GRID_CONFIG), device=DEVICE, seed=0)
    model = handle.model
    head = model.roi_head
    gh = head.grid_head
    ext = head.grid_extractor
    print(f"phase 13: {GRID_CONFIG.name} with seeded weights, no "
          f"random-weight fix; grid head {gh.num_convs} convs of "
          f"{gh.conv0.out_channels} with GroupNorm({gh.gn0.num_groups}), "
          f"point features {gh.point_feat0.out_channels}, on S="
          f"{ext['output_size']} sr={ext['sampling_ratio']} crops of the "
          f"valid detection slots, {head.chunk} rois a pass")
    torch.backends.cudnn.deterministic = True
    fwd = []
    reset_launches()
    with recorded(roi_align_cuda, "roi_align_forward", fwd):
        results = inference_detector_tiled(handle, list(frames))
    launches = read_launches()
    print(f"phase 13 launches on the Grid R-CNN path: {launches}")
    got_shapes = sorted(tuple(args[4:6]) for args, _, _ in fwd)
    if launches != GRID_LAUNCHES or got_shapes != [(7, 1), (14, 2)]:
        raise AssertionError(f"expected {GRID_LAUNCHES} with K2 at (S, sr) "
                             f"(7, 1) and (14, 2), got {launches}, "
                             f"{got_shapes}")
    grid_rois = next(args[1] for args, _, _ in fwd if args[4] == 14)
    del fwd
    check_frames(results, "phase 13")
    # the bbox branch's detections of one call, as deterministic as the run
    eng = next(iter(handle.tiled_engines.values()))
    tiles = eng.pre(frames)
    b = tiles.shape[0]
    img_shapes = torch.tensor([eng.pre.tile_hw], dtype=torch.int32,
                              device=DEVICE).expand(b, 2)
    with torch.no_grad():
        feats = model.extract_feat(tiles)
        props, _, valid = model.rpn_head.get_proposals(
            *model.rpn_head(feats), img_shapes, model.rpn_head.test_cfg)
        dets = StandardRoIHead.simple_test(head, feats, props, valid,
                                           img_shapes)
    with plain_nms(), plain_roi_align():
        results_plain = inference_detector_tiled(handle, list(frames))
    torch.backends.cudnn.deterministic = False
    for i, (r, p) in enumerate(zip(results, results_plain)):
        if not (np.array_equal(r["bboxes"], p["bboxes"])
                and np.array_equal(r["labels"], p["labels"])):
            raise AssertionError(f"frame {i}: kernels and plain disagree")
    print("phase 13: merged detections (grid-refined boxes) with the "
          "kernels == with every kernel swapped for its plain version")
    slots = dets.valid.reshape(-1).nonzero()[:, 0]
    rois = slice_rois(dets.bboxes[..., :4])[slots]
    kept = dets.valid.sum(1)
    print(f"phase 13 RPN proposals per tile {valid.sum(1).min().item()}.."
          f"{valid.sum(1).max().item()}; valid detection slots per tile "
          f"{kept.tolist()}: {rois.shape[0]} of {dets.valid.numel()} slots "
          f"go through the grid head, {-(-rois.shape[0] // head.chunk)} "
          f"passes of at most {head.chunk} rois")
    if kept.min() <= 0 or not torch.equal(rois, grid_rois):
        raise AssertionError("a tile has no detection, or the protocol's "
                             "grid rois are not the valid slots' boxes")
    del grid_rois

    # K2 on the protocol's own grid rois
    k_feats = list(feats[:len(ROI_STRIDES)])
    out, sr = ext["output_size"], ext["sampling_ratio"]
    lvls = map_roi_levels(rois, len(ROI_STRIDES))
    per_level = torch.bincount(lvls, minlength=len(ROI_STRIDES)).tolist()
    crops = roi_align_cuda.roi_align_forward(k_feats, rois, lvls,
                                             ROI_STRIDES, out, sr)
    want = forward_plain(k_feats, rois, lvls, out, sr)
    torch.cuda.synchronize()
    k2_err = float((crops - want).abs().max())
    if not torch.equal(crops, want):
        raise AssertionError(f"RoIAlign kernel != plain on the grid rois: "
                             f"{k2_err}")
    del want
    paths = roi_paths(k_feats, rois, lvls, out, sr)
    k2_ms = time_ms(lambda: roi_align_cuda.roi_align_forward(
        k_feats, rois, lvls, ROI_STRIDES, out, sr), ITERS)
    k2_plain = time_ms(lambda: forward_plain(k_feats, rois, lvls, out, sr),
                       PLAIN_ITERS)
    bms, by = roi_align_bound(k_feats, rois, lvls, out, sr)
    r = rois.shape[0]
    print(f"phase 13 RoIAlign grid rois (R={r}, S={out}, sr={sr}, rois per "
          f"level {per_level}): kernel == plain (torch.equal); kernel "
          f"paths: {shares(paths)}")
    print(f"phase 13 RoIAlign grid rois: kernel {k2_ms:.4f} ms, plain "
          f"{k2_plain:.4f} ms ({PLAIN_CHUNK} rois a call), bound {bms:.4f} "
          f"ms ({by}); {ps_per_sample(k2_ms, k_feats, r, out, sr):.4f} ps "
          f"per sample and channel [{card}]")
    record = dict(shape="grid_rcnn slice, grid rois", R=r, S=out, sr=sr,
                  max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain,
                  bound_ms=bms, bound_by=by, per_level=per_level,
                  paths=paths)

    # the grid head on the card against the CPU's, on rois of tile 0
    n = min(GRID_CPU_ROIS, int(kept[0]))
    cpu_head = copy.deepcopy(gh).cpu()
    with torch.no_grad():
        g_heat = gh(crops[:n])
        c_heat = cpu_head(crops[:n].cpu())
        g_box = grid_refine_boxes(rois[:n], torch.sigmoid(g_heat))
        c_box = grid_refine_boxes(rois[:n].cpu(), torch.sigmoid(c_heat))
    err = rel_err([g_heat], [c_heat])
    box_err = float((g_box.cpu() - c_box).abs().max())
    print(f"phase 13 grid head, card vs CPU on {n} rois of tile 0: heat-map "
          f"logits max rel err {err:.3e}; refined boxes max abs diff "
          f"{box_err:.4f} px")
    if err > 1e-4:
        raise AssertionError(f"grid head, card vs CPU: {err}")
    del cpu_head, g_heat, c_heat

    # timing: the model is warm (the runs above), so each number is one
    # call (a call is seconds), the protocol's with its peak memory
    frame_list = list(frames)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(GRID_ITERS):
        inference_detector_tiled(handle, frame_list)
    protocol = N_FRAMES * GRID_ITERS / (time.perf_counter() - t0)
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    with torch.no_grad():
        fwd_ms = events_ms(lambda: model(tiles), GRID_ITERS)
        grid_ms = events_ms(lambda: head.grid_refine(feats, rois),
                            GRID_ITERS)
    flop = grid_head_flops(gh, r, out)
    print(f"phase 13 protocol ({N_FRAMES} frames of {eng.pre.n_views} "
          f"tiles, host in the loop, {GRID_ITERS} warm call(s)): "
          f"{protocol:.4f} img/s; forward only (tiles -> grid-refined "
          f"detections, {b} tiles, f32, TF32 off): "
          f"{N_FRAMES * 1e3 / fwd_ms:.4f} img/s, {fwd_ms:.4f} ms per forward "
          f"by CUDA events; a protocol call's peak memory {peak:.3f} GiB "
          f"above the {held / 2 ** 30:.3f} GiB held [{card}]")
    print(f"phase 13 grid branch (K2 on the {r} grid rois, {k2_ms:.4f} ms; "
          f"the grid head in passes of {head.chunk}; the refinement): "
          f"{grid_ms:.4f} ms, share of the forward {grid_ms / fwd_ms:.4f}; "
          f"the grid head's {flop / 1e12:.3f} TFLOP at "
          f"{flop / (grid_ms - k2_ms) / 1e9:.2f} TFLOP/s of the branch's "
          f"time without K2 [{card}]")
    print(json.dumps({"grid_rcnn": dict(
        protocol_img_s=protocol, forward_img_s=N_FRAMES * 1e3 / fwd_ms,
        forward_ms=fwd_ms, grid_branch_ms=grid_ms,
        grid_share=grid_ms / fwd_ms, grid_head_tflop=flop / 1e12,
        grid_rois=r, chunk=head.chunk, peak_gib=peak)}))
    del crops, feats, tiles

    def device_ms():
        record["device_ms"], how = forward_device_ms(
            k_feats, rois, lvls, out, sr, "grid_rcnn_slice")
        print(f"phase 13 RoIAlign grid rois (R={r}), device time per call "
              f"from {how}: "
              f"{record['device_ms']:.4f} ms (call {k2_ms:.4f} ms, bound "
              f"{bms:.4f} ms) [{card}]")
    return launches, handle, record, device_ms


def phase_grid_train(card):
    """Phase 13 (b): Adap Grid R-CNN training at full width with seeded
    weights: `train_run` for 20 iterations of one 512x640 image (launches
    per step {1, 1, 2, 2} and no roi-coordinate launch, finite losses,
    loss_grid included, positives in both stages, frozen and trainable
    parameters); one step with the kernels against one with the plain
    RoIAlign from the same weights and draws (equal losses, gradients
    within GRAD_TOL); on that step's own launches K2 forward (torch.equal)
    and backward (BWD_TOL) at the bbox rois (S=7 sr=1) and the grid rois
    (S=14 sr=2), with paths, times and bounds; the grid branch alone on
    the step's own inputs and GRID_TIMED_STEPS train steps from the seeded
    weights, by CUDA events. Returns the run's
    launches, the K2 records and the profile, with the kernels' device
    times, to be run after every timing."""
    from pointtinybenchmark_tpu_torch.data.loader import DetCollator
    from pointtinybenchmark_tpu_torch.engine.train import batch_to_device
    from pointtinybenchmark_tpu_torch.ops import roi_align_cuda
    from pointtinybenchmark_tpu_torch.utils.config import Config

    cfg = Config.fromfile(str(GRID_CONFIG))
    spg = int(cfg.data["samples_per_gpu"])
    samples = train_samples(np.random.RandomState(17), TRAIN_IMAGES)
    print(f"phase 13 training config: {GRID_CONFIG.name}, samples_per_gpu "
          f"{spg}, optimizer {dict(cfg.optimizer)}, lr_config "
          f"{dict(cfg.lr_config)}; {TRAIN_IMAGES} synthetic images, gts per "
          f"image {[len(s['gt_bboxes']) for s in samples]}")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    model, init, launches = train_run(card, "13", cfg, samples, TRAIN_EPOCHS,
                                      GRID_TRAIN_LAUNCHES,
                                      {"rpn_num_pos": spg, "rcnn_num_pos": 0})
    collator = DetCollator(tuple(cfg.loader["pad_shape"]),
                           max_gt=int(cfg.loader["max_gt"]),
                           max_gt_ignore=int(cfg.loader["max_gt_ignore"]))
    batch = batch_to_device(collator(samples[:spg]), DEVICE)

    torch.backends.cudnn.deterministic = True
    fwd, bwd, grid_calls = [], [], []
    reset_launches()
    with recorded(roi_align_cuda, "roi_align_forward", fwd), \
            recorded(roi_align_cuda, "roi_align_backward", bwd), \
            recorded(model.roi_head, "grid_loss", grid_calls):
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
    print(f"phase 13 one step, kernels vs plain RoIAlign: launches "
          f"{k_launches} vs {p_launches}; " + ", ".join(
              f"{k} {got[k]:.6f}" for k in loss_keys) + f"; losses equal: "
          f"{all(got[k] == want[k] for k in loss_keys)}; worst gradient "
          f"error {worst:.3e} of its parameter's max |grad| (bar "
          f"{GRAD_TOL})")
    if k_launches != GRID_TRAIN_LAUNCHES or p_launches["roi_align"] \
            or p_launches["roi_align_backward"]:
        raise AssertionError(f"launches {k_launches}, plain {p_launches}")
    if any(got[k] != want[k] for k in loss_keys) or worst > GRAD_TOL \
            or not got["loss_grid"] > 0:
        raise AssertionError(f"kernels vs plain: {got} vs {want}, gradient "
                             f"{worst}")
    del got_grads, want_grads
    f_rows, b_rows, b_inputs = step_rois(
        card, fwd, bwd, phase="13", label="grid_rcnn train step",
        kinds=((7, "bbox"), (14, "grid")))
    f_inputs = [(tuple(f.detach() for f in args[0]),) + tuple(args[1:6])
                for args, _, _ in fwd]
    # the grid branch alone on the step's own inputs: K2 on the 96 jittered
    # rois, the grid head and the loss, forward and backward to the maps
    (g_feats, *g_args), _, _ = grid_calls[0]
    g_feats = [f.detach().requires_grad_() for f in g_feats]
    grid_head = model.roi_head.grid_head
    grid_loss = model.roi_head.grid_loss

    def grid_branch():
        grid_loss(g_feats, *g_args).backward()
        for t in g_feats + list(grid_head.parameters()):
            t.grad = None
    del fwd, bwd, init, grid_calls
    grid_ms = time_ms(grid_branch, TRAIN_TIMED_STEPS)
    del g_feats, g_args
    model = train_model(cfg)
    numbers, step_profile = time_step(card, "13", "grid_rcnn_train", cfg,
                                      model, batch, held, spg,
                                      steps=GRID_TIMED_STEPS)
    k2 = sum(rec["ms"] for rec in f_rows + b_rows)
    print(f"phase 13 K2 forward + backward calls on the step's two "
          f"launches {k2:.4f} ms, share of the step "
          f"{k2 / numbers['step_ms']:.4f}; the grid branch alone (K2 on the "
          f"grid rois, the grid head, the loss, forward and backward, by "
          f"CUDA events) {grid_ms:.4f} ms, share of the step "
          f"{grid_ms / numbers['step_ms']:.4f} [{card}]")
    numbers.update(grid_branch_ms=grid_ms,
                   grid_share=grid_ms / numbers["step_ms"])

    def profile():
        step_profile()
        for rec, (feats, rois, lvls, _, out, sr) in zip(f_rows, f_inputs):
            rec["device_ms"], how = forward_device_ms(
                list(feats), rois, lvls, out, sr, rec["shape"].replace(" ",
                                                                       "_"))
            print(f"phase 13 RoIAlign {rec['shape']} (R={rec['R']}), "
                  f"forward device time per call from {how}: "
                  f"{rec['device_ms']:.4f} ms "
                  f"(call {rec['ms']:.4f} ms, bound {rec['bound_ms']:.4f} "
                  f"ms) [{card}]")
        for rec, args in zip(b_rows, b_inputs):
            add_device_ms(card, rec, *args, phase="13")
    return launches, f_rows, b_rows, profile


def write_tinyperson_set(root, name, n, rng):
    """`n` JPEG frames of FRAME_HW under root/name/ and their COCO json
    root/name.json, TinyPerson's format: one class "person", persons of
    DATASET_SIDES px (bright blocks on a dark noisy ground) in disjoint
    DATASET_CELL-px cells, ~10% tagged `ignore`, ~5% `uncertain`."""
    from PIL import Image

    h, w = FRAME_HW
    c = DATASET_CELL
    cells = [(x, y) for y in range(0, h - c + 1, c)
             for x in range(0, w - c + 1, c)]
    (root / name).mkdir()
    images, anns = [], []
    for i in range(n):
        img = rng.randint(0, 70, (h, w, 3)).astype(np.uint8)
        for k in rng.permutation(len(cells))[:rng.randint(*DATASET_PERSONS)]:
            bw, bh = (float(v) for v in np.round(rng.uniform(
                *DATASET_SIDES, 2), 2))
            x = float(np.round(cells[k][0] + rng.uniform(0, c - bw), 2))
            y = float(np.round(cells[k][1] + rng.uniform(0, c - bh), 2))
            img[int(y):int(np.ceil(y + bh)),
                int(x):int(np.ceil(x + bw))] = rng.randint(150, 256, 3)
            ann = dict(id=len(anns) + 1, image_id=i + 1, category_id=1,
                       bbox=[x, y, bw, bh], area=bw * bh, iscrowd=0)
            kind = rng.rand()
            if kind < 0.10:
                ann["ignore"] = 1
            elif kind < 0.15:
                ann["uncertain"] = 1
            anns.append(ann)
        fn = f"{name}_{i}.jpg"
        Image.fromarray(img).save(root / name / fn, quality=90)
        images.append(dict(id=i + 1, file_name=fn, width=w, height=h))
    path = root / f"{name}.json"
    path.write_text(json.dumps(dict(
        images=images, annotations=anns,
        categories=[dict(id=1, name="person")])))
    return path


class TimedDataset:
    """A dataset whose __getitem__ (the host pipeline) is timed."""

    def __init__(self, dataset):
        self.dataset = dataset
        self.seconds = 0.0

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        t0 = time.perf_counter()
        sample = self.dataset[i]
        self.seconds += time.perf_counter() - t0
        return sample


def phase_dataset(card):
    """Phase 14: Adap Faster R-CNN on a TinyPerson-format dataset through
    the port's own entry points, at full width: (a) the train CLI
    (`tools.train`) for DATASET_ITERS iterations of an IterBasedRunner on
    the corner tiles of DATASET_TRAIN_FRAMES frames, its validation at the
    end by `run_tiled_test` on DATASET_TEST_FRAMES frames and the tiny COCO
    evaluation; (b) the test CLI (`tools.test`) on that checkpoint, its
    metrics equal to the train CLI's last ones; (c) `run_tiled_test` with
    the kernels against the all-plain run (merged detections and metrics
    equal), against `DeviceTiledInference` on the same decoded frames
    (tests/test_detector_golden.py:88's tolerances), the dataset path's
    img/s and host share beside the device protocol's img/s; (d) the native
    and the Python evaluation loops (equal stats, seconds), and the gts as
    detections at score 1 (every AP*_all and AP*_tiny 1.0). Returns the
    launches of the two CLI runs."""
    import copy
    import tempfile

    from PIL import Image

    from pointtinybenchmark_tpu_torch.apis.inference import init_detector
    from pointtinybenchmark_tpu_torch.data import build_dataset
    from pointtinybenchmark_tpu_torch.data.tiling import \
        generate_corner_dataset
    from pointtinybenchmark_tpu_torch.engine.test import (
        DeviceTiledInference, run_tiled_test)
    from pointtinybenchmark_tpu_torch.tools import test as test_cli
    from pointtinybenchmark_tpu_torch.tools import train as train_cli

    build = REPO / "build"
    build.mkdir(exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=build, prefix="tinyperson_set_")
    root = Path(tmp.name)
    t0 = time.perf_counter()
    rng = np.random.RandomState(14)
    test_json = write_tinyperson_set(root, "test", DATASET_TEST_FRAMES, rng)
    train_json = write_tinyperson_set(root, "train", DATASET_TRAIN_FRAMES,
                                      rng)
    corner = generate_corner_dataset(str(train_json), DATASET_CORNER)
    corner_json = root / "train_corner_sw640_sh512.json"
    corner_json.write_text(json.dumps(corner))
    gt = json.loads(test_json.read_text())
    n_gt = [sum(a["image_id"] == im["id"] for a in gt["annotations"])
            for im in gt["images"]]
    print(f"phase 14: synthetic TinyPerson set written in "
          f"{time.perf_counter() - t0:.2f} s: {DATASET_TEST_FRAMES} test "
          f"frames of {FRAME_HW[1]}x{FRAME_HW[0]} (JPEG by PIL) with "
          f"{n_gt} persons, {DATASET_TRAIN_FRAMES} train frames cut into "
          f"{len(corner['images'])} corners of 640x512 "
          f"(generate_corner_dataset, 100 px overlap) with "
          f"{len(corner['annotations'])} clipped annotations")
    data = [f"data.train.ann_file={corner_json}",
            f"data.train.img_prefix={root / 'train'}"]
    for split in ("val", "test"):
        data += [f"data.{split}.ann_file={test_json}",
                 f"data.{split}.img_prefix={root / 'test'}"]
    work = root / "work"
    # the two CLI runs and the comparisons below must match bit for bit
    torch.backends.cudnn.deterministic = True
    reset_launches()
    t0 = time.perf_counter()
    train_metrics = train_cli.main([
        str(FRCNN_CONFIG), "--work-dir", str(work), "--seed", "0",
        "--device", DEVICE, "--cfg-options", *data, "runner.type=IterBasedRunner",
        f"runner.max_iters={DATASET_ITERS}",
        f"checkpoint_config.interval={DATASET_ITERS}",
        f"evaluation.interval={DATASET_ITERS}", "log_config.interval=1"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = read_launches()
    want = {k: DATASET_ITERS * TRAIN_LAUNCHES[k]
            + DATASET_TEST_FRAMES * DATASET_FRAME_LAUNCHES[k]
            for k in TRAIN_LAUNCHES}
    print(f"phase 14 (a) train CLI: {train_s:.1f} s (host clock); launches "
          f"{train_launches} ({DATASET_ITERS} steps x {TRAIN_LAUNCHES} + "
          f"{DATASET_TEST_FRAMES} validation frames x "
          f"{DATASET_FRAME_LAUNCHES})")
    if train_launches != want:
        raise AssertionError(f"expected {want}")
    log = [json.loads(line) for line in open(work / "log.json")]
    losses = [e["loss"] for e in log]
    if ([e["step"] for e in log] != list(range(1, DATASET_ITERS + 1))
            or not np.isfinite(losses).all()):
        raise AssertionError(f"logged steps {[e['step'] for e in log]}, "
                             f"losses {losses}")
    # log.json's iter_time is the mean since the epoch began
    half = DATASET_ITERS // 2
    late_ms = (log[-1]["iter_time"] * DATASET_ITERS - log[half - 1][
        "iter_time"] * half) / (DATASET_ITERS - half) * 1e3
    print(f"phase 14 (a) loss at every step finite: first {losses[0]:.4f}, "
          f"last {losses[-1]:.4f}; loader + step {1 / log[-1]['iter_time']:.2f}"
          f" it/s over the {DATASET_ITERS} iterations (mean "
          f"{log[-1]['iter_time'] * 1e3:.2f} ms), {1e3 / late_ms:.2f} it/s "
          f"over the last {DATASET_ITERS - half} ({late_ms:.2f} ms; host "
          f"clock, a host sync a step for the log, cudnn deterministic); "
          f"validation metrics {train_metrics}")

    ckpt = work / f"iter_{DATASET_ITERS}.pth"
    out = root / "results.json"
    reset_launches()
    test_metrics = test_cli.main([str(FRCNN_CONFIG), str(ckpt), "--out",
                                  str(out), "--device", DEVICE,
                                  "--cfg-options", *data])
    test_launches = read_launches()
    want = {k: DATASET_TEST_FRAMES * v
            for k, v in DATASET_FRAME_LAUNCHES.items()}
    n_dets = len(json.loads(out.read_text()))
    print(f"phase 14 (b) test CLI: launches {test_launches}, "
          f"{n_dets / DATASET_TEST_FRAMES:.1f} detections a frame in "
          f"{out.name}; metrics {test_metrics}")
    if test_launches != want or n_dets == 0:
        raise AssertionError(f"expected {want} and detections")
    if test_metrics != train_metrics:
        raise AssertionError("the test CLI's metrics differ from the train "
                             "CLI's last validation")
    print(f"phase 14 (b): the test CLI's metrics == the train CLI's last "
          f"validation's (random weights after {DATASET_ITERS} steps: AP "
          f"near 0, not a quality number)")

    cfg = test_cli.load_config(str(FRCNN_CONFIG), data)
    model = init_detector(cfg, str(ckpt), device=DEVICE).model.eval()
    ds_cfg = dict(cfg.data["test"])
    ds_cfg["test_mode"] = True
    dataset = TimedDataset(build_dataset(ds_cfg))
    eval_kwargs, _, collator = test_cli.eval_settings(cfg)
    results = run_tiled_test(model, dataset, collator)      # warm
    dataset.seconds = 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = run_tiled_test(model, dataset, collator)
    wall = time.perf_counter() - t0
    host = dataset.seconds
    with plain_nms(), plain_roi_align():
        plain = run_tiled_test(model, dataset.dataset, collator)
    for i, (r, p) in enumerate(zip(results, plain)):
        if not (np.array_equal(r["bboxes"], p["bboxes"])
                and np.array_equal(r["labels"], p["labels"])):
            raise AssertionError(f"frame {i}: kernels and plain disagree")
    metrics = dataset.dataset.evaluate(results, **eval_kwargs)
    if (metrics != dataset.dataset.evaluate(plain, **eval_kwargs)
            or dict(metrics) != test_metrics):
        raise AssertionError("metrics of the kernels' run, the plain run "
                             "and the test CLI differ")
    print("phase 14 (c): run_tiled_test's merged detections and metrics "
          "with the kernels == with every kernel swapped for its plain "
          "version == the test CLI's")

    # the host pipeline's parts: decode, the views' deep copies, the rest
    # of the tiler (crop, normalize, pad, collect)
    ds = dataset.dataset
    load, tiler = ds.pipeline.transforms
    t_load = t_copy = t_tile = 0.0
    for i in range(len(ds)):
        r = ds._base_results(i)
        r["ann_info"] = ds.get_ann_info(i)
        t0 = time.perf_counter()
        r = load(r)
        t1 = time.perf_counter()
        n_views = len(tiler(r)["views"])
        t2 = time.perf_counter()
        for _ in range(n_views):
            copy.deepcopy({k: r[k] for k in r if k != "img"})
        t3 = time.perf_counter()
        t_load, t_tile, t_copy = (t_load + t1 - t0, t_tile + t2 - t1,
                                  t_copy + t3 - t2)
    n = len(ds)
    print(f"phase 14 (c) host pipeline a frame: decode "
          f"{t_load * 1e3 / n:.1f} ms, the tiler {t_tile * 1e3 / n:.1f} ms "
          f"(of which the {n_views} views' deep copies "
          f"{t_copy * 1e3 / n:.1f} ms, timed apart)")
    t0 = time.perf_counter()
    frames = np.stack([np.asarray(Image.open(root / "test" / im["file_name"])
                                  .convert("RGB")) for im in gt["images"]])
    decode_ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    norm = next(t for t in cfg.data["test"]["pipeline"][1]["transforms"]
                if t["type"] == "Normalize")
    eng = DeviceTiledInference(model, FRAME_HW, (512, 640), (100, 100),
                               img_norm=dict(mean=norm["mean"],
                                             std=norm["std"]))
    for i, r in enumerate(results):
        dev = eng(frames[i])[0]
        order = np.argsort(-dev["bboxes"][:, 4], kind="stable")
        ref = np.argsort(-r["bboxes"][:, 4], kind="stable")
        dets_match((r["bboxes"][ref], r["labels"][ref]),
                   (dev["bboxes"][order], dev["labels"][order]))
    pairs = [frames[i:i + N_FRAMES] for i in range(0, len(frames), N_FRAMES)]
    for p in pairs:
        eng(p)                                               # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in pairs:
        eng(p)
    device_s = time.perf_counter() - t0
    torch.backends.cudnn.deterministic = False
    print(f"phase 14 (c): run_tiled_test == DeviceTiledInference on the "
          f"decoded frames within tests/test_detector_golden.py:88's "
          f"tolerances, every frame")
    print(f"phase 14 (c) dataset path (run_tiled_test: decode, crop, "
          f"normalize and pad on the host, 12 tiles a sample): "
          f"{len(results) / wall:.4f} img/s, host pipeline "
          f"{host / wall:.3f} of the wall ({host * 1e3 / len(results):.1f} "
          f"ms a frame); device protocol (DeviceTiledInference, "
          f"{N_FRAMES} decoded frames a call): "
          f"{len(frames) / device_s:.4f} img/s on the same frames, decode "
          f"{decode_ms:.1f} ms a frame besides ({card})")

    t0 = time.perf_counter()
    native = dataset.dataset.evaluate(results, **eval_kwargs)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    python = dataset.dataset.evaluate(results, native=False, **eval_kwargs)
    python_s = time.perf_counter() - t0
    if list(native.items()) != list(python.items()):
        raise AssertionError(f"native {native} vs Python {python}")
    print(f"phase 14 (d) evaluation of {sum(len(r['bboxes']) for r in results)}"
          f" detections on {len(results)} frames: native {native_s:.3f} s, "
          f"Python loops {python_s:.3f} s, stats equal")
    gts = []
    for im in gt["images"]:
        b = np.asarray([a["bbox"] for a in gt["annotations"]
                        if a["image_id"] == im["id"]], np.float32)
        b[:, 2:] += b[:, :2]
        gts.append(dict(bboxes=np.hstack([b, np.ones((len(b), 1),
                                                     np.float32)]),
                        labels=np.zeros(len(b), np.int64)))
    perfect = dataset.dataset.evaluate(gts, **eval_kwargs)
    print(f"phase 14 (d) the gts as detections at score 1: {dict(perfect)}")
    ones = {k: v for k, v in perfect.items() if k.startswith("AP")
            and (k.endswith("_all") or k.endswith("_tiny"))}
    if len(ones) != 6 or any(v != 1.0 for v in ones.values()):
        raise AssertionError(f"expected 1.0: {ones}")
    print(f"phase 14 launches per frame {DATASET_FRAME_LAUNCHES}, per train "
          f"step {TRAIN_LAUNCHES}")
    del model, eng
    tmp.cleanup()
    torch.cuda.empty_cache()
    return {"faster_rcnn_dataset_train_cli": train_launches,
            "faster_rcnn_dataset_test_cli": test_launches}


# ------------------------------- phase 15: Scale Match pretraining
def write_coco_set(img_dir, path, n, rng, masks=False, names=None):
    """`n` JPEG images in `img_dir`, 640x480 and 480x640 in turn, each
    with SM_OBJECTS boxes of SM_SIDES px (log-uniform, bright blocks on a
    dark noisy ground) of the 80 COCO categories (or of the classes
    `names`), ~5% iscrowd; with `masks` each object's ellipse inscribed in
    its box, a 16-gon polygon, painted brighter and kept as its
    segmentation. Their COCO json at `path`, the file names prefixed by
    its stem."""
    from PIL import Image

    from PIL import ImageDraw

    img_dir.mkdir(parents=True, exist_ok=True)
    path.parent.mkdir(parents=True, exist_ok=True)
    ids = COCO_IDS if names is None else tuple(range(1, len(names) + 1))
    names = names or [f"class{c}" for c in COCO_IDS]
    angles = np.linspace(0, 2 * np.pi, 16, endpoint=False)
    images, anns = [], []
    for i in range(n):
        h, w = ((480, 640), (640, 480))[i % 2]
        img = rng.randint(0, 70, (h, w, 3)).astype(np.uint8)
        for _ in range(rng.randint(*SM_OBJECTS)):
            bw, bh = np.minimum(np.exp(rng.uniform(*np.log(SM_SIDES), 2)),
                                [w, h])
            x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            img[int(y):int(y + bh), int(x):int(x + bw)] = rng.randint(
                120, 256, 3)
            anns.append(dict(id=len(anns) + 1, image_id=i + 1,
                             category_id=int(rng.choice(ids)),
                             bbox=[round(float(v), 2) for v in (x, y, bw, bh)],
                             area=float(bw * bh),
                             iscrowd=int(rng.rand() < 0.05)))
            if masks:
                poly = np.stack([x + bw / 2 * (1 + np.cos(angles)),
                                 y + bh / 2 * (1 + np.sin(angles))], 1)
                anns[-1]["segmentation"] = [poly.round(2).ravel().tolist()]
                pil = Image.fromarray(img)
                ImageDraw.Draw(pil).polygon([tuple(p) for p in poly],
                                            fill=(255, 255, 255))
                img = np.asarray(pil).copy()
        fn = f"{path.stem}_{i}.jpg"
        Image.fromarray(img).save(img_dir / fn, quality=90)
        images.append(dict(id=i + 1, file_name=fn, width=w, height=h))
    path.write_text(json.dumps(dict(
        images=images, annotations=anns,
        categories=[dict(id=c, name=nm) for c, nm in zip(ids, names)])))
    return len(anns)


class FirstCalls(list):
    """A list that keeps only the first `n` items appended (`recorded`
    then holds a run's first launches, not every step's tensors)."""

    def __init__(self, n=1):
        super().__init__()
        self.n = n

    def append(self, item):
        if len(self) < self.n:
            super().append(item)


def matched_sizes(cfg):
    """The train pipeline once over the dataset, host only: the
    ScaleMatchResize transform's ms a sample, each matched image's
    geometric-mean box size, and the share of its scales at a bound of
    the config's scale_range."""
    from pointtinybenchmark_tpu_torch.data import build_dataset

    ds = build_dataset(dict(cfg.data["train"]))
    smr = next(t for t in ds.pipeline.transforms
               if type(t).__name__ == "ScaleMatchResize")
    lo, hi = smr.scale_match.scale_range
    call, seconds, at_bound = smr.__call__, [0.0], []

    def timed(results):
        t0 = time.perf_counter()
        h = results["img"].shape[0]
        out = call(results)
        seconds[0] += time.perf_counter() - t0
        scale = out["img"].shape[0] / h
        at_bound.append(min(abs(scale - lo), abs(scale - hi)) <= 1.0 / h)
        return out
    ds.pipeline.transforms[ds.pipeline.transforms.index(smr)] = timed
    sizes = []
    for i in range(len(ds)):
        b = ds[i]["gt_bboxes"]
        wh = np.clip(b[:, 2:] - b[:, :2], 1e-3, None)
        if len(b):
            sizes.append(float(np.exp(np.log(np.sqrt(wh.prod(1))).mean())))
    return seconds[0] * 1e3 / len(ds), np.asarray(sizes), np.mean(at_bound)


def phase_scale_match(card):
    """Phase 15: Scale Match pretraining (COCO resized so that its object
    sizes follow TinyPerson's) through the port's train CLI at full width,
    the two configs of SM_RUNS as written, from a folder holding their
    `data/` files: SM_ITERS iterations of an IterBasedRunner at the
    configs' samples_per_gpu, launches per step and per validation image,
    the loss finite at every logged step, it/s from the loader, the
    validation at the end (Faster R-CNN msm: the TinyPerson tiled protocol
    and the tiny evaluation; RetinaNet sm: `run_test` at (333, 200) and the
    COCO evaluation); K1 and K2 (forward and backward) held to their plain
    versions at the Faster R-CNN step's first launches (the RetinaNet
    step launches none); ScaleMatchResize's host ms a
    sample, the matched images' geometric-mean box sizes beside the
    target's, and the share of scales at a bound. Returns the launches by
    path and the kernel rows."""
    import os
    import tempfile

    from pointtinybenchmark_tpu_torch.ops import nms_cuda, roi_align_cuda
    from pointtinybenchmark_tpu_torch.tools import train as train_cli
    from pointtinybenchmark_tpu_torch.utils.config import Config

    build = REPO / "build"
    build.mkdir(exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=build, prefix="scale_match_")
    root = Path(tmp.name)
    t0 = time.perf_counter()
    rng = np.random.RandomState(15)
    coco = root / "data/coco"
    n_train = write_coco_set(coco / "images", coco / "annotations/"
                             "instances_train2017.json", SM_TRAIN_IMAGES, rng)
    n_val = write_coco_set(coco / "images", coco / "annotations/"
                           "instances_val2017.json", SM_VAL_IMAGES, rng)
    tiny = root / "data/tiny_set"
    tiny.mkdir(parents=True)
    (tiny / "mini_annotations").mkdir()
    target = tiny / "mini_annotations/tiny_set_train_all_erase.json"
    write_tinyperson_set(tiny, "erase", SM_TARGET_FRAMES, rng).rename(target)
    write_tinyperson_set(tiny, "test", SM_TINY_VAL_FRAMES, rng).rename(
        tiny / "mini_annotations/tiny_set_test_all.json")
    want_sizes = np.asarray([np.sqrt(a["bbox"][2] * a["bbox"][3]) for a in
                             json.loads(target.read_text())["annotations"]
                             if not a.get("ignore")])
    print(f"phase 15: synthetic sets written in {time.perf_counter() - t0:.2f}"
          f" s: COCO-format {SM_TRAIN_IMAGES} train images ({n_train} "
          f"objects) and {SM_VAL_IMAGES} val ({n_val}), 640x480 and 480x640 "
          f"JPEGs with {SM_OBJECTS[0]}-{SM_OBJECTS[1] - 1} objects of "
          f"{SM_SIDES[0]:.0f}-{SM_SIDES[1]:.0f} px of 80 classes; the target "
          f"json of {len(want_sizes)} TinyPerson persons (not ignored) on "
          f"{SM_TARGET_FRAMES} frames; {SM_TINY_VAL_FRAMES} TinyPerson "
          f"frames for the tiled validation [{card}]")
    q = (10, 50, 90)
    by_path, k1_rows, f_rows, b_rows = {}, [], [], []
    cwd = os.getcwd()
    os.chdir(root)
    try:
        for name, config, step, val, n_val_images in SM_RUNS:
            cfg = Config.fromfile(str(config))
            spg = int(cfg.data["samples_per_gpu"])
            work = root / f"work_{name}"
            bits, walks, fwd, bwd = (FirstCalls() for _ in range(4))
            torch.backends.cudnn.deterministic = True
            reset_launches()
            t0 = time.perf_counter()
            with recorded(nms_cuda, "iou_bitmask", bits), \
                    recorded(nms_cuda, "greedy_reduce", walks), \
                    recorded(roi_align_cuda, "roi_align_forward", fwd), \
                    recorded(roi_align_cuda, "roi_align_backward", bwd):
                metrics = train_cli.main([
                    str(config), "--work-dir", str(work), "--seed", "0",
                    "--device", DEVICE, "--cfg-options",
                    "runner.type=IterBasedRunner",
                    f"runner.max_iters={SM_ITERS}",
                    f"checkpoint_config.interval={SM_ITERS}",
                    f"evaluation.interval={SM_ITERS}",
                    "log_config.interval=1"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            torch.backends.cudnn.deterministic = False
            launches = read_launches()
            want = {k: SM_ITERS * step[k] + n_val_images * val[k]
                    for k in step}
            head = (cfg.model.get("bbox_head")
                    or cfg.model["roi_head"]["bbox_head"])
            print(f"phase 15 {name} train CLI ({config.name} as written, "
                  f"samples_per_gpu {spg}, pad shape "
                  f"{tuple(cfg.loader['pad_shape'])}, "
                  f"{head['num_classes']} classes in the head): {wall:.1f} s "
                  f"(host clock) [{card}]; "
                  f"launches {launches} ({SM_ITERS} steps x {step} + "
                  f"{n_val_images} validation images x {val})")
            if launches != want:
                raise AssertionError(f"expected {want}")
            log = [json.loads(line) for line in open(work / "log.json")]
            losses = [e["loss"] for e in log]
            if ([e["step"] for e in log] != list(range(1, SM_ITERS + 1))
                    or not np.isfinite(losses).all()):
                raise AssertionError(f"logged steps "
                                     f"{[e['step'] for e in log]}, losses "
                                     f"{losses}")
            half = SM_ITERS // 2
            late_ms = (log[-1]["iter_time"] * SM_ITERS - log[half - 1][
                "iter_time"] * half) / (SM_ITERS - half) * 1e3
            print(f"phase 15 {name}: loss finite at every step, first "
                  f"{losses[0]:.4f}, last {losses[-1]:.4f}; loader + step "
                  f"{1 / log[-1]['iter_time']:.3f} it/s over the {SM_ITERS} "
                  f"iterations ({spg * 1 / log[-1]['iter_time']:.2f} img/s), "
                  f"{1e3 / late_ms:.3f} it/s over the last "
                  f"{SM_ITERS - half} ({late_ms:.2f} ms; host clock, a host "
                  f"sync a step for the log, cudnn deterministic); "
                  f"validation metrics {metrics} (random weights after "
                  f"{SM_ITERS} steps, not a quality number) [{card}]")
            if metrics is None:
                raise AssertionError("no validation ran")
            sm_ms, sizes, bound_share = matched_sizes(cfg)
            print(f"phase 15 {name} ScaleMatchResize "
                  f"({cfg.data['train']['pipeline'][2]['scale_match_type']}): "
                  f"{sm_ms:.2f} ms a sample on the host (PIL bilinear resize "
                  f"included), scales at a bound of scale_range "
                  f"{bound_share:.3f}; matched images' geometric-mean box "
                  f"size p{q} {np.percentile(sizes, q).round(2).tolist()} px, "
                  f"the target's boxes p{q} "
                  f"{np.percentile(want_sizes, q).round(2).tolist()} px "
                  f"[{card}]")
            (sboxes, thr, n_valid), _, _ = bits[0]
            (_, ok, order, _, _), _, _ = walks[0]
            if step["iou_bitmask"]:
                k1_rows.append(k1_row(card, f"{name} train RPN", sboxes, ok,
                                      order, n_valid, thr, phase="15"))
            else:
                # the step launches no kernel; the validation's NMS gets
                # no candidate from random weights under the focal prior
                print(f"phase 15 {name}: no launch in a step; the first "
                      f"validation image's K1 launch B={sboxes.shape[0]} "
                      f"N={sboxes.shape[1]}, {n_valid.tolist()} valid "
                      f"candidates (the classifier's 0.01 prior keeps every "
                      f"score under score_thr)")
            if step["roi_align"]:
                f, b, _ = step_rois(card, fwd, bwd, phase="15",
                                    label=f"{name} train step",
                                    kinds=((7, "bbox"),))
                f_rows += f
                b_rows += b
            del bits, walks, fwd, bwd
            by_path[f"{name}_train_cli"] = launches
    finally:
        os.chdir(cwd)
        tmp.cleanup()
        torch.cuda.empty_cache()
    return by_path, k1_rows, f_rows, b_rows


# ------------------------------------ phase 16: the workflow tools
def log_steps(work, iters):
    """log.json's entries of an IterBasedRunner run: their steps must be
    1..iters (or the resumed tail) and the losses finite."""
    log = [json.loads(line) for line in open(work / "log.json")]
    losses = [e["loss"] for e in log]
    if not np.isfinite(losses).all() or [e["step"] for e in log] != iters:
        raise AssertionError(f"{work.name}: logged steps "
                             f"{[e['step'] for e in log]}, losses {losses}")
    return log


def late_ms(log):
    """The mean step ms over the second half of a run's log (log.json's
    iter_time is the mean since the epoch began)."""
    n, half = len(log), len(log) // 2
    return (log[-1]["iter_time"] * n - log[half - 1]["iter_time"] * half) \
        / (n - half) * 1e3


def expect(launches, want, what):
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, expected {want}")


def first_k1_rows(card, labels, bits, walks, phase="16"):
    """K1 alone against its plain version at a run's first launches, one
    row a label (launch order); a launch with no valid candidate (random
    weights whose scores all fall under score_thr) is printed, not held."""
    rows = []
    for label, ((sboxes, thr, n_valid), _, _), ((_, ok, order, _, _), _, _) \
            in zip(labels, bits, walks):
        if int(n_valid.max()) == 0:
            print(f"phase {phase} {label}: K1 launch B={sboxes.shape[0]} "
                  f"N={sboxes.shape[1]} with no valid candidate (every "
                  f"score under score_thr)")
            continue
        rows.append(k1_row(card, label, sboxes, ok, order, n_valid, thr,
                           phase=phase))
    return rows


def k2_forward_row(card, label, call, phase="16"):
    """K2's forward (torch.equal) against its plain version on one recorded
    inference launch, with the rois on each path, times and bound."""
    (feats, rois, lvls, _, out, sr, *rest), _, _ = call
    aligned = rest[0] if rest else True
    per_level = torch.bincount(lvls, minlength=len(ROI_LEVELS)).tolist()
    _, err = compare_roi_align(feats, rois, lvls, out, sr, aligned)
    paths = roi_paths(feats, rois, lvls, out, sr, aligned)
    ms, plain_ms = time_roi_align(feats, rois, lvls, out, sr, aligned)
    bms, by = roi_align_bound(feats, rois, lvls, out, sr, aligned)
    r = rois.shape[0]
    print(f"phase {phase} {label} (R={r}, S={out}, sr={sr}, aligned "
          f"{aligned}, per level "
          f"{per_level}): forward kernel == plain (torch.equal), paths "
          f"{shares(paths)}; kernel {ms:.4f} ms (plain {plain_ms:.4f}, "
          f"bound {bms:.4f} {by}) [{card}]")
    return dict(shape=label, R=r, S=out, sr=sr, aligned=aligned,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, per_level=per_level, paths=paths)


def phase_point_workflow(card, root):
    """Phase 16 (a): the CPR -> result2ann -> P2P workflow of README.md
    through the port's CLIs at full width."""
    from pointtinybenchmark_tpu_torch.data import build_dataset
    from pointtinybenchmark_tpu_torch.data.noise import \
        generate_pseudo_bbox_for_point
    from pointtinybenchmark_tpu_torch.data.tiling import \
        generate_corner_dataset
    from pointtinybenchmark_tpu_torch.ops import nms_cuda
    from pointtinybenchmark_tpu_torch.tools import result2ann
    from pointtinybenchmark_tpu_torch.tools import test as test_cli
    from pointtinybenchmark_tpu_torch.tools import train as train_cli

    rng = np.random.RandomState(16)
    v2 = root / "data/tiny_set_v2"
    v2.mkdir(parents=True)
    train_json = write_tinyperson_set(v2, "train", WF_TRAIN_FRAMES, rng)
    test_json = write_tinyperson_set(v2, "test", WF_TEST_FRAMES, rng)
    coarse = generate_pseudo_bbox_for_point(
        generate_corner_dataset(str(train_json), WF_CORNER), (16, 16),
        noise_rg=0.25, seed=16)
    coarse_json = v2 / "train_corner_coarse.json"
    coarse_json.write_text(json.dumps(coarse))
    # the loader's pad shape is 640x640: the test frames too go in corners
    test_tiles = generate_corner_dataset(str(test_json), WF_CORNER)
    test_corner_json = v2 / "test_corner.json"
    test_corner_json.write_text(json.dumps(test_tiles))
    n_test = len(test_tiles["images"])
    data = [f"data.test.ann_file={test_corner_json}",
            f"data.test.img_prefix={v2 / 'test'}"]
    for split in ("train", "val"):
        data += [f"data.{split}.ann_file={coarse_json}",
                 f"data.{split}.img_prefix={v2 / 'train'}"]
    iters = ["runner.type=IterBasedRunner", "log_config.interval=1"]
    print(f"phase 16 (a): {WF_TRAIN_FRAMES} train frames of "
          f"{FRAME_HW[1]}x{FRAME_HW[0]} cut into {len(coarse['images'])} "
          f"corners of 640x640 with {len(coarse['annotations'])} coarse "
          f"points (16x16 pseudo boxes), {WF_TEST_FRAMES} test frames in "
          f"{n_test} corners")

    t0 = time.perf_counter()
    cpr_work = root / "cpr"
    reset_launches()
    train_cli.main([str(CPR_CONFIG), "--work-dir", str(cpr_work), "--seed",
                    "0", "--device", DEVICE, "--no-validate",
                    "--cfg-options", *data, *iters,
                    f"runner.max_iters={WF_CPR_ITERS}",
                    f"checkpoint_config.interval={WF_CPR_ITERS}"])
    cpr_train = read_launches()
    expect(cpr_train, NO_LAUNCHES, "CPR train CLI")
    log = log_steps(cpr_work, list(range(1, WF_CPR_ITERS + 1)))
    print(f"phase 16 (a) CPR train CLI: {WF_CPR_ITERS} iterations in "
          f"{time.perf_counter() - t0:.1f} s (host clock), losses "
          f"{[round(e['loss'], 4) for e in log]}, launches {cpr_train}")

    dets_json = root / "cpr_refined_dets.json"
    reset_launches()
    refine_metrics = test_cli.main([
        str(CPR_CONFIG), str(cpr_work / f"iter_{WF_CPR_ITERS}.pth"),
        "--split", "val", "--out", str(dets_json), "--device", DEVICE,
        "--cfg-options", *data])
    cpr_refine = read_launches()
    expect(cpr_refine, NO_LAUNCHES, "CPR refine (test CLI)")
    dets = json.loads(dets_json.read_text())
    coarse_pts = {a["id"]: a["point"] for a in coarse["annotations"]}
    moved = sum(1 for d in dets if np.hypot(
        d["point"][0] - coarse_pts[d["ann_id"]][0],
        d["point"][1] - coarse_pts[d["ann_id"]][1]) > 1e-3)
    refined_json = v2 / "train_corner_refined.json"
    n_updated = result2ann.main([
        "--ori_ann", str(coarse_json), "--det_file", str(dets_json),
        "--save_ann", str(refined_json), "--wh", "16"])
    kept = sum(1 for a in coarse["annotations"] if not a.get("ignore"))
    print(f"phase 16 (a) CPR refine (test CLI --split val --out): "
          f"{len(dets)} rows with ann_id, metrics {refine_metrics}; "
          f"result2ann --wh 16 updated {n_updated} of "
          f"{len(coarse['annotations'])} annotations ({kept} not ignored)")
    if not (0 < n_updated == len(dets) <= kept):
        raise AssertionError("result2ann: every refined row must update one "
                             "annotation")
    refined = json.loads(refined_json.read_text())
    if any(a["bbox"][2:] != [16, 16] for a in refined["annotations"]
           if not a.get("ignore") and "point" in a):
        raise AssertionError("refined boxes are not 16x16")

    p2p_data = [f"data.train.ann_file={refined_json}",
                f"data.train.img_prefix={v2 / 'train'}", *data[:2]]
    cfg = test_cli.load_config(str(WF_P2P_CONFIG), p2p_data)
    k = len(build_dataset(dict(cfg.data["train"]))) // int(
        cfg.data["samples_per_gpu"])
    runs = {}
    for name, extra, steps in (
            ("straight", [], list(range(1, 2 * k + 1))),
            ("resumed", ["--resume-from",
                         str(root / "p2p_straight" / f"iter_{k}.pth")],
             list(range(k + 1, 2 * k + 1)))):
        work = root / f"p2p_{name}"
        t0 = time.perf_counter()
        reset_launches()
        train_cli.main([str(WF_P2P_CONFIG), "--work-dir", str(work),
                        "--seed", "0", "--device", DEVICE, "--no-validate",
                        *extra, "--cfg-options", *p2p_data, *iters,
                        f"runner.max_iters={2 * k}",
                        f"checkpoint_config.interval={k}"])
        launches = read_launches()
        expect(launches, NO_LAUNCHES, f"P2P train CLI {name}")
        log = log_steps(work, steps)
        runs[name] = (log, torch.load(work / f"iter_{2 * k}.pth",
                                      map_location="cpu",
                                      weights_only=True)["state_dict"])
        print(f"phase 16 (a) P2P train CLI {name}: steps {steps[0]}.."
              f"{steps[-1]} in {time.perf_counter() - t0:.1f} s (host "
              f"clock), {late_ms(log):.1f} ms a step over the second half, "
              f"last loss {log[-1]['loss']:.6f}, launches {launches} [{card}]")
    (log_a, sd_a), (log_b, sd_b) = runs["straight"], runs["resumed"]
    floats = [n for n in sd_a if sd_a[n].is_floating_point()]
    diff = max(float((sd_a[n] - sd_b[n]).abs().max())
               / max(float(sd_a[n].abs().max()), 1e-30) for n in floats)
    abs_diff = max(float((sd_a[n] - sd_b[n]).abs().max()) for n in floats)
    loss_a, loss_b = log_a[-1]["loss"], log_b[-1]["loss"]
    print(f"phase 16 (a) P2P straight vs stopped at iter {k} and resumed "
          f"(--resume-from iter_{k}.pth): last losses {loss_a:.6f} vs "
          f"{loss_b:.6f} (relative {abs(loss_a - loss_b) / abs(loss_a):.3e}"
          f"), weights at most {abs_diff:.3e} apart, {diff:.3e} of a "
          f"tensor's max (the card's convolution backward sums in no fixed "
          f"order; Adam moves each weight by ~lr a step, {log_a[-1]['lr']:.3e}"
          f" at the last)")

    # as phase 9: the classifier's focal prior keeps every score under
    # score_thr, so its bias is set to 0 in a copy of the checkpoint
    ck = torch.load(root / "p2p_straight" / f"iter_{2 * k}.pth",
                    map_location="cpu", weights_only=True)
    ck["state_dict"]["bbox_head.cls_out.bias"].zero_()
    lifted = root / "p2p_cls_bias_0.pth"
    torch.save(ck, lifted)
    results_json = root / "p2p_results.json"
    bits, walks = FirstCalls(), FirstCalls()
    reset_launches()
    with recorded(nms_cuda, "iou_bitmask", bits), \
            recorded(nms_cuda, "greedy_reduce", walks):
        p2p_metrics = test_cli.main([
            str(WF_P2P_CONFIG), str(lifted), "--out", str(results_json),
            "--device", DEVICE, "--cfg-options", *p2p_data])
    p2p_test = read_launches()
    rows = json.loads(results_json.read_text())
    if not rows or any(len(r.get("point", ())) != 2 for r in rows):
        raise AssertionError("the P2P results json must hold a point a row")
    expect(p2p_test, {n: n_test * v for n, v in
                      WF_P2P_TEST_LAUNCHES.items()}, "P2P test CLI")
    print(f"phase 16 (a) P2P test CLI on the {n_test} test corners "
          f"(cls_out.bias 0): launches {p2p_test}, {len(rows)} rows with a "
          f"point in --out, metrics {p2p_metrics} (random weights after "
          f"{2 * k} steps, not a quality number) [{card}]")
    k1 = first_k1_rows(card, ["P2P test corner"], bits, walks)
    return {"cpr_train_cli": cpr_train, "cpr_refine_cli": cpr_refine,
            "p2p_test_cli": p2p_test}, moved, k1


def write_voc_split(base, name, n, rng):
    """`n` JPEGs of 500x375 / 375x500 under base/JPEGImages, their XML
    under base/Annotations (2-6 objects of the 20 classes, ~20%
    `difficult`) and base/ImageSets/Main/<name>.txt. Returns the ids
    file."""
    from PIL import Image

    from pointtinybenchmark_tpu_torch.data.voc import VOC_CLASSES

    for d in ("JPEGImages", "Annotations", "ImageSets/Main"):
        (base / d).mkdir(parents=True, exist_ok=True)
    ids = []
    for i in range(n):
        img_id = f"{name}_{i:06d}"
        h, w = ((375, 500), (500, 375))[i % 2]
        img = rng.randint(0, 70, (h, w, 3)).astype(np.uint8)
        objs = []
        for b in coco_objects(rng, (h, w))[:rng.randint(2, 7)]:
            x1, y1, x2, y2 = (int(v) + 1 for v in b)
            img[y1:y2, x1:x2] = rng.randint(120, 256, 3)
            objs.append(
                f"<object><name>{VOC_CLASSES[rng.randint(20)]}</name>"
                f"<difficult>{int(rng.rand() < 0.2)}</difficult><bndbox>"
                f"<xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x2}</xmax>"
                f"<ymax>{y2}</ymax></bndbox></object>")
        Image.fromarray(img).save(base / "JPEGImages" / f"{img_id}.jpg",
                                  quality=90)
        (base / "Annotations" / f"{img_id}.xml").write_text(
            f"<annotation><size><width>{w}</width><height>{h}</height>"
            f"<depth>3</depth></size>{''.join(objs)}</annotation>")
        ids.append(img_id)
    path = base / "ImageSets/Main" / f"{name}.txt"
    path.write_text("\n".join(ids) + "\n")
    return path


def phase_voc(card, root):
    """Phase 16 (b): VOC Faster R-CNN through the train CLI, its train set
    the two VOC splits as a list of dataset configs (ConcatDataset), its
    validation the mAP on VOC2007 test."""
    from pointtinybenchmark_tpu_torch.ops import nms_cuda, roi_align_cuda
    from pointtinybenchmark_tpu_torch.tools import train as train_cli
    from pointtinybenchmark_tpu_torch.utils.config import Config

    rng = np.random.RandomState(161)
    voc = root / "data/VOCdevkit"
    pipeline = Config.fromfile(str(VOC_CONFIG)).to_dict()["data"]["train"][
        "pipeline"]
    splits = [dict(type="VOCDataset", ann_file=str(write_voc_split(
        voc / f"VOC{year}", "trainval", VOC_TRAIN_IMAGES, rng)),
        img_prefix=str(voc / f"VOC{year}") + "/", pipeline=pipeline)
        for year in (2007, 2012)]
    test = dict(ann_file=str(write_voc_split(voc / "VOC2007", "test",
                                             VOC_TEST_IMAGES, rng)),
                img_prefix=str(voc / "VOC2007") + "/")
    cfg_path = root / "faster_rcnn_r50_fpn_1x_voc0712_synthetic.py"
    cfg_path.write_text(f"_base_ = [{str(VOC_CONFIG)!r}]\n"
                        f"data = dict(train={splits!r}, val={test!r}, "
                        f"test={test!r})\n")
    work = root / "voc"
    bits, walks, fwd, bwd = (FirstCalls() for _ in range(4))
    torch.backends.cudnn.deterministic = True
    reset_launches()
    t0 = time.perf_counter()
    with recorded(nms_cuda, "iou_bitmask", bits), \
            recorded(nms_cuda, "greedy_reduce", walks), \
            recorded(roi_align_cuda, "roi_align_forward", fwd), \
            recorded(roi_align_cuda, "roi_align_backward", bwd):
        metrics = train_cli.main([
            str(cfg_path), "--work-dir", str(work), "--seed", "0",
            "--device", DEVICE, "--cfg-options",
            "runner.type=IterBasedRunner", f"runner.max_iters={VOC_ITERS}",
            f"checkpoint_config.interval={VOC_ITERS}",
            f"evaluation.interval={VOC_ITERS}", "log_config.interval=1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    torch.backends.cudnn.deterministic = False
    launches = read_launches()
    expect(launches, {k: VOC_ITERS * TRAIN_LAUNCHES[k] + VOC_TEST_IMAGES
                      * TWO_STAGE_IMAGE_LAUNCHES[k] for k in TRAIN_LAUNCHES},
           "VOC train CLI")
    log = log_steps(work, list(range(1, VOC_ITERS + 1)))
    if metrics is None or not 0.0 <= metrics["mAP"] <= 1.0:
        raise AssertionError(f"VOC validation: {metrics}")
    print(f"phase 16 (b) VOC Faster R-CNN train CLI (ConcatDataset of VOC2007"
          f" and VOC2012 trainval, {VOC_TRAIN_IMAGES} images each; "
          f"aspect-grouped batches of 2): {wall:.1f} s (host clock); "
          f"launches {launches} = {VOC_ITERS} steps x {TRAIN_LAUNCHES} + "
          f"{VOC_TEST_IMAGES} test images x {TWO_STAGE_IMAGE_LAUNCHES}; "
          f"losses first {log[0]['loss']:.4f} last {log[-1]['loss']:.4f}; "
          f"{late_ms(log):.1f} ms a step over the second half (host clock, "
          f"loader included, cudnn deterministic); VOC07 11-point mAP "
          f"{metrics['mAP']:.6f} from random weights after {VOC_ITERS} steps "
          f"[{card}]")
    (sboxes, thr, n_valid), _, _ = bits[0]
    (_, ok, order, _, _), _, _ = walks[0]
    k1 = k1_row(card, "VOC train RPN", sboxes, ok, order, n_valid, thr,
                phase="16 (b)")
    f_rows, b_rows, _ = step_rois(card, fwd, bwd, phase="16 (b)",
                                  label="VOC train step",
                                  kinds=((7, "bbox"),))
    return {"voc_train_cli": launches}, k1, f_rows, b_rows


def phase_rpn(card, root):
    """Phase 16 (c): the standalone RPN through `run_test` on phase 15's
    COCO-format images, proposal_fast."""
    from pointtinybenchmark_tpu_torch.apis.inference import init_detector
    from pointtinybenchmark_tpu_torch.data import build_dataset
    from pointtinybenchmark_tpu_torch.data.loader import DetCollator
    from pointtinybenchmark_tpu_torch.engine.test import run_test
    from pointtinybenchmark_tpu_torch.ops import nms_cuda
    from pointtinybenchmark_tpu_torch.utils.config import Config

    coco = root / "data/coco"
    n_obj = write_coco_set(coco / "images", coco / "annotations/"
                           "instances_val2017.json", RPN_IMAGES,
                           np.random.RandomState(15))
    cfg = Config.fromfile(str(RPN_CONFIG))
    ds = build_dataset(dict(cfg.data["test"], test_mode=True,
                            ann_file=str(coco / "annotations/"
                                         "instances_val2017.json"),
                            img_prefix=str(coco / "images")))
    model = init_detector(cfg, device=DEVICE).model.eval()
    collator = DetCollator(size_divisor=32)
    bits, walks = FirstCalls(), FirstCalls()
    reset_launches()
    t0 = time.perf_counter()
    with recorded(nms_cuda, "iou_bitmask", bits), \
            recorded(nms_cuda, "greedy_reduce", walks):
        results = run_test(model, ds, collator)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    expect(launches, dict(NO_LAUNCHES, iou_bitmask=RPN_IMAGES,
                          greedy_reduce=RPN_IMAGES), "RPN run_test")
    with plain_nms():
        plain = run_test(model, ds, collator)
    for i, (r, p) in enumerate(zip(results, plain)):
        if not (np.array_equal(r["bboxes"], p["bboxes"])
                and not r["labels"].any() and len(r["bboxes"])):
            raise AssertionError(f"RPN image {i}: proposals with the kernels "
                                 f"differ from the plain NMS's, or labels")
    metrics = ds.evaluate(results, metric="proposal_fast")
    print(f"phase 16 (c) standalone RPN (rpn_r50_fpn_1x_coco.py, seeded "
          f"weights) run_test on {RPN_IMAGES} COCO-format images of 640x480 "
          f"and 480x640 ({n_obj} objects): launches {launches}, "
          f"{[len(r['bboxes']) for r in results]} proposals an image, equal "
          f"to the plain NMS's; {wall:.2f} s (host clock, first call); "
          f"proposal_fast {dict(metrics)} [{card}]")
    (sboxes, thr, n_valid), _, _ = bits[0]
    (_, ok, order, _, _), _, _ = walks[0]
    k1 = k1_row(card, "standalone RPN", sboxes, ok, order, n_valid, thr,
                phase="16 (c)")
    return {"rpn_run_test": launches}, k1


def lift_classes(model, bias=LIFT_BIAS):
    """A random 81-way softmax scores every class near 1/81, under the
    config's score_thr of 0.05: raise the first LIFT_CLASSES classes'
    logits (in every stage of a cascade) so that the RoI head detects."""
    heads = model.roi_head.bbox_head
    with torch.no_grad():
        for head in (heads if isinstance(heads, torch.nn.ModuleList)
                     else [heads]):
            head.fc_cls.bias[:LIFT_CLASSES] += bias


def phase_whole_image(card, root):
    """Phase 16 (d): COCO Faster R-CNN on two 800x1333 images, whole
    (`inference_detector`) and by flip TTA (`run_tta_test`): launches, the
    kernels against the plain versions, the card against the CPU."""
    from PIL import Image

    from pointtinybenchmark_tpu_torch.apis.inference import (
        inference_detector, init_detector)
    from pointtinybenchmark_tpu_torch.data import build_dataset
    from pointtinybenchmark_tpu_torch.data.loader import DetCollator
    from pointtinybenchmark_tpu_torch.engine.test import run_tta_test
    from pointtinybenchmark_tpu_torch.ops import nms_cuda, roi_align_cuda

    rng = np.random.RandomState(164)
    h, w = COCO_HW
    img_dir = root / "tta"
    img_dir.mkdir()
    imgs, images = [], []
    for i in range(2):
        img = rng.randint(0, 70, (h, w, 3)).astype(np.uint8)
        for x1, y1, x2, y2 in coco_objects(rng, (h, w)).astype(int):
            img[y1:y2, x1:x2] = rng.randint(120, 256, 3)
        Image.fromarray(img).save(img_dir / f"{i}.png")
        imgs.append(img.astype(np.float32))
        images.append(dict(id=i + 1, file_name=f"{i}.png", width=w,
                           height=h))
    ann = root / "tta.json"
    ann.write_text(json.dumps(dict(images=images, annotations=[],
                                   categories=[dict(id=c, name=f"class{c}")
                                               for c in COCO_IDS])))
    handle = init_detector(str(COCO_FRCNN_CONFIG), device=DEVICE)
    seeded = [len(r["bboxes"]) for r in inference_detector(handle, imgs)]
    lift_classes(handle.model)
    bits, walks, fwd = FirstCalls(2), FirstCalls(2), FirstCalls()
    reset_launches()
    t0 = time.perf_counter()
    with recorded(nms_cuda, "iou_bitmask", bits), \
            recorded(nms_cuda, "greedy_reduce", walks), \
            recorded(roi_align_cuda, "roi_align_forward", fwd):
        dets = inference_detector(handle, imgs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = infer_launches = read_launches()
    expect(launches, {k: 2 * v for k, v in TWO_STAGE_IMAGE_LAUNCHES.items()},
           "inference_detector")
    with plain_nms(), plain_roi_align():
        plain = inference_detector(handle, imgs)
    for i, (r, p) in enumerate(zip(dets, plain)):
        if not len(r["bboxes"]) or not (
                np.array_equal(r["bboxes"], p["bboxes"])
                and np.array_equal(r["labels"], p["labels"])):
            raise AssertionError(f"inference_detector image {i}: no "
                                 f"detection, or kernels vs plain differ")
    cpu = init_detector(str(COCO_FRCNN_CONFIG), device="cpu")
    lift_classes(cpu.model)
    ref = inference_detector(cpu, imgs[0])
    order = np.argsort(-dets[0]["bboxes"][:, 4], kind="stable")
    ref_order = np.argsort(-ref["bboxes"][:, 4], kind="stable")
    n = dets_match((ref["bboxes"][ref_order], ref["labels"][ref_order]),
                   (dets[0]["bboxes"][order], dets[0]["labels"][order]))
    print(f"phase 16 (d) inference_detector (coco faster_rcnn, seeded "
          f"weights: {seeded} detections; then fc_cls's bias raised by "
          f"{LIFT_BIAS} on its first {LIFT_CLASSES} classes) on two {w}x{h} "
          f"images: launches {launches}, "
          f"{[len(r['bboxes']) for r in dets]} detections, equal to the "
          f"all-plain run's; {wall:.2f} s (host clock, first call); the CPU's "
          f"{n} detections of image 0 matched at tests/test_detector_golden."
          f"py:88's tolerances [{card}]")

    ds = build_dataset(dict(
        type="CocoFmtDataset", ann_file=str(ann), img_prefix=str(img_dir),
        test_mode=True, pipeline=[
            dict(type="LoadImageFromFile"),
            dict(type="MultiScaleFlipAug", img_scale=(w, h), flip=True,
                 transforms=[dict(type="Resize", keep_ratio=True),
                             dict(type="RandomFlip"),
                             dict(type="Normalize",
                                  mean=[123.675, 116.28, 103.53],
                                  std=[58.395, 57.12, 57.375]),
                             dict(type="Pad", size_divisor=32),
                             dict(type="Collect", keys=["img"])])]))
    model = handle.model
    collator = DetCollator(size_divisor=32)
    merges = []
    t_bits, t_walks, t_fwd = FirstCalls(3), FirstCalls(3), FirstCalls()
    reset_launches()
    t0 = time.perf_counter()
    with nms_shapes(merges), recorded(nms_cuda, "iou_bitmask", t_bits), \
            recorded(nms_cuda, "greedy_reduce", t_walks), \
            recorded(roi_align_cuda, "roi_align_forward", t_fwd):
        tta = run_tta_test(model, ds, collator)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    expect(launches, {k: 2 * v for k, v in TTA_IMAGE_LAUNCHES.items()},
           "run_tta_test")
    with plain_nms(), plain_roi_align():
        tta_plain = run_tta_test(model, ds, collator)
    for i, (r, p) in enumerate(zip(tta, tta_plain)):
        if not len(r["bboxes"]) or not (
                np.array_equal(r["bboxes"], p["bboxes"])
                and np.array_equal(r["labels"], p["labels"])):
            raise AssertionError(f"run_tta_test image {i}: no detection, or "
                                 f"kernels vs plain differ")
        # boxes are clipped to the collated views' extent, padded to 32
        # (the JAX engine passes the same img_shape)
        pad_h, pad_w = -(-h // 32) * 32, -(-w // 32) * 32
        if not (np.isfinite(r["bboxes"]).all()
                and (r["bboxes"][:, :4] >= -1e-3).all()
                and (r["bboxes"][:, [0, 2]] <= pad_w + 1e-3).all()
                and (r["bboxes"][:, [1, 3]] <= pad_h + 1e-3).all()):
            raise AssertionError("TTA boxes outside the views' extent")
    print(f"phase 16 (d) run_tta_test (MultiScaleFlipAug, 2 views an "
          f"image, one batched simple_test, boxes flipped back, the merge "
          f"on K1): launches {launches}, NMS shapes (B, N) {merges}, "
          f"{[len(r['bboxes']) for r in tta]} merged detections, equal to "
          f"the all-plain run's; {wall:.2f} s (host clock, first call) "
          f"[{card}]")
    k1 = first_k1_rows(card, ["whole-image RPN", "whole-image RoI head"],
                       bits, walks) + first_k1_rows(
        card, ["TTA RPN", "TTA RoI head", "TTA merge"], t_bits, t_walks)
    k2 = [k2_forward_row(card, "whole-image rois", fwd[0]),
          k2_forward_row(card, "TTA rois", t_fwd[0])]
    return {"faster_rcnn_inference_detector": infer_launches,
            "faster_rcnn_tta": launches}, k1, k2


def phase_offline_merge(card, root):
    """Phase 16 (e): phase 14's test set cut into its corner tiles, Adap
    Faster R-CNN's `run_test` on every tile, and the evaluation with
    `merge_after_infer_kwargs` (the host merge of evaluation/merge.py)."""
    from pointtinybenchmark_tpu_torch.apis.inference import init_detector
    from pointtinybenchmark_tpu_torch.data import build_dataset
    from pointtinybenchmark_tpu_torch.data.loader import DetCollator
    from pointtinybenchmark_tpu_torch.engine.test import run_test
    from pointtinybenchmark_tpu_torch.evaluation.merge import merge_det_result
    from pointtinybenchmark_tpu_torch.ops import nms_cuda, roi_align_cuda
    from pointtinybenchmark_tpu_torch.tools import test as test_cli

    test_json = write_tinyperson_set(root, "merge", DATASET_TEST_FRAMES,
                                     np.random.RandomState(14))
    cfg = test_cli.load_config(str(FRCNN_CONFIG), [])
    norm = next(t for t in cfg.data["test"]["pipeline"][1]["transforms"]
                if t["type"] == "Normalize")
    ds = build_dataset(dict(
        type="CocoFmtDataset", ann_file=str(test_json),
        img_prefix=str(root / "merge"), test_mode=True,
        corner_kwargs=dict(DATASET_CORNER),
        merge_after_infer_kwargs=dict(merge_gt_file=str(test_json),
                                      merge_nms_th=0.5),
        pipeline=[dict(type="LoadImageFromFile"),
                  dict(type="NoAug", transforms=[
                      dict(type="Resize", keep_ratio=True),
                      dict(type="Normalize", mean=norm["mean"],
                           std=norm["std"]),
                      dict(type="Pad", size_divisor=32),
                      dict(type="Collect", keys=["img"])])]))
    model = init_detector(cfg, device=DEVICE).model.eval()
    bits, walks, fwd = FirstCalls(2), FirstCalls(2), FirstCalls()
    reset_launches()
    t0 = time.perf_counter()
    with recorded(nms_cuda, "iou_bitmask", bits), \
            recorded(nms_cuda, "greedy_reduce", walks), \
            recorded(roi_align_cuda, "roi_align_forward", fwd):
        results = run_test(model, ds, DetCollator(pad_shape=(512, 640)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    expect(launches, {k: len(ds) * v for k, v in
                      TWO_STAGE_IMAGE_LAUNCHES.items()}, "corner run_test")
    det_json = ds.format_results(results)
    t0 = time.perf_counter()
    merged, _ = merge_det_result(det_json, ds.coco, str(test_json), 0.5)
    merge_s = time.perf_counter() - t0
    eval_kwargs, _, _ = test_cli.eval_settings(cfg)
    metrics = ds.evaluate(results, **eval_kwargs)
    if not (0 < len(merged) < len(det_json)) or {d["image_id"] for d in
                                                 merged} - set(range(
                                                     1, DATASET_TEST_FRAMES
                                                     + 1)):
        raise AssertionError("the merge must keep fewer detections, each of "
                             "an original frame")
    print(f"phase 16 (e) offline tile merge: {DATASET_TEST_FRAMES} frames in "
          f"{len(ds)} corner tiles of {DATASET_CORNER['sub_img_w']}x"
          f"{DATASET_CORNER['sub_img_h']}, run_test {wall:.2f} s (host "
          f"clock), launches {launches}; {len(det_json)} tile detections -> "
          f"{len(merged)} after the merge (host NMS at 0.5, {merge_s:.2f} "
          f"s); the tiny evaluation against the frames' json "
          f"{dict(metrics)} (random weights) [{card}]")
    k1 = first_k1_rows(card, ["corner RPN", "corner RoI head"], bits, walks)
    return {"faster_rcnn_corner_run_test": launches}, k1, [
        k2_forward_row(card, "corner rois", fwd[0])]


def phase_workflow(card):
    """Phase 16: (a)-(e) in a temporary folder under build/, from which
    the CPR config's `save_result_file` (exp/) is written."""
    import os
    import tempfile

    build = REPO / "build"
    build.mkdir(exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=build, prefix="workflow_")
    root = Path(tmp.name)
    (root / "exp").mkdir()
    cwd = os.getcwd()
    os.chdir(root)
    laps = [time.perf_counter()]

    def lap(what):
        laps.append(time.perf_counter())
        print(f"phase 16 {what}: {laps[-1] - laps[-2]:.1f} s (host clock)")
    try:
        by_path, moved, k1_p2p = phase_point_workflow(card, root)
        print(f"phase 16 (a): {moved} refined points moved off their "
              f"coarse point")
        lap("(a)")
        voc_path, k1_voc, f_rows, b_rows = phase_voc(card, root)
        lap("(b)")
        rpn_path, k1_rpn = phase_rpn(card, root)
        lap("(c)")
        whole_path, k1_whole, k2_whole = phase_whole_image(card, root)
        lap("(d)")
        merge_path, k1_merge, k2_merge = phase_offline_merge(card, root)
        lap("(e)")
    finally:
        os.chdir(cwd)
        tmp.cleanup()
        torch.cuda.empty_cache()
    print(f"phase 16 whole: {laps[-1] - laps[0]:.1f} s (host clock) [{card}]")
    return ({**by_path, **voc_path, **rpn_path, **whole_path, **merge_path},
            k1_p2p + [k1_voc, k1_rpn] + k1_whole + k1_merge,
            f_rows + k2_whole + k2_merge, b_rows)


# ---------- phase 17: Cascade R-CNN, the V1.x configs, the last datasets
def cascade_images(rng, n):
    """n COCO_HW float32 images, bright blocks (`coco_objects`) on a dark
    noisy ground."""
    h, w = COCO_HW
    out = []
    for _ in range(n):
        img = rng.randint(0, 70, (h, w, 3)).astype(np.uint8)
        for x1, y1, x2, y2 in coco_objects(rng, (h, w)).astype(int):
            img[y1:y2, x1:x2] = rng.randint(120, 256, 3)
        out.append(img.astype(np.float32))
    return out


def detect_and_hold(card, phase, label, config, imgs, expected, names):
    """`inference_detector` of `config`'s seeded model, fc_cls lifted in
    every stage (`lift_classes`), on `imgs`: the launches (`expected` an
    image), the detections equal to the all-plain run's; K1 alone at the
    first image's RPN and RoI head NMS, and K2's forward at its RoIAlign
    launches (`names`, in launch order), against their plain versions.
    Returns the handle, the seeded model's detection counts, the
    detections, the launches and the K1 and K2 rows."""
    from pointtinybenchmark_tpu_torch.apis.inference import (
        inference_detector, init_detector)
    from pointtinybenchmark_tpu_torch.ops import nms_cuda, roi_align_cuda

    handle = init_detector(str(config), device=DEVICE)
    seeded = [len(r["bboxes"]) for r in inference_detector(handle, imgs)]
    lift_classes(handle.model)
    bits, walks, fwd = FirstCalls(2), FirstCalls(2), FirstCalls(len(names))
    reset_launches()
    t0 = time.perf_counter()
    with recorded(nms_cuda, "iou_bitmask", bits), \
            recorded(nms_cuda, "greedy_reduce", walks), \
            recorded(roi_align_cuda, "roi_align_forward", fwd):
        dets = inference_detector(handle, imgs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    expect(launches, {k: len(imgs) * v for k, v in expected.items()},
           f"{label} inference_detector")
    with plain_nms(), plain_roi_align():
        plain = inference_detector(handle, imgs)
    for i, (r, p) in enumerate(zip(dets, plain)):
        if not len(r["bboxes"]) or not (
                np.array_equal(r["bboxes"], p["bboxes"])
                and np.array_equal(r["labels"], p["labels"])):
            raise AssertionError(f"{label} image {i}: no detection, or "
                                 f"kernels vs plain differ")
    print(f"phase {phase} {label} inference_detector ({config.name}, seeded "
          f"weights: {seeded} detections; then fc_cls's bias raised by "
          f"{LIFT_BIAS} on its first {LIFT_CLASSES} classes in every stage) "
          f"on {len(imgs)} {COCO_HW[1]}x{COCO_HW[0]} image(s): launches "
          f"{launches}, {[len(r['bboxes']) for r in dets]} detections, equal "
          f"to the all-plain run's; {wall:.2f} s (host clock, first call) "
          f"[{card}]")
    k1 = first_k1_rows(card, [f"{label} RPN", f"{label} RoI head"], bits,
                       walks, phase=phase)
    k2 = [k2_forward_row(card, f"{label} {n} rois", call, phase=phase)
          for n, call in zip(names, fwd)]
    return handle, seeded, dets, launches, k1, k2


def step_and_hold(card, phase, label, config, expected, kinds, seed):
    """One train step of `config`'s seeded model at its samples_per_gpu on
    synthetic COCO_HW images with masks (`coco_train_samples`), with the
    kernels and with the plain RoIAlign, from the same weights and draws:
    the launches, equal losses, gradients within GRAD_TOL; on the step's
    own launches K2 forward and backward (`step_rois`) and K1 alone at
    the RPN's NMS. Returns the model (at its seeded weights), the config,
    the batch, the launches and the K1, K2 forward and backward rows and
    the backward's inputs."""
    from pointtinybenchmark_tpu_torch.data.loader import DetCollator
    from pointtinybenchmark_tpu_torch.engine.train import batch_to_device
    from pointtinybenchmark_tpu_torch.ops import nms_cuda, roi_align_cuda
    from pointtinybenchmark_tpu_torch.utils.config import Config

    cfg = Config.fromfile(str(config))
    spg = int(cfg.data["samples_per_gpu"])
    samples = coco_train_samples(np.random.RandomState(seed), spg)
    collator = DetCollator(None, int(cfg.loader["size_divisor"]),
                           max_gt=int(cfg.loader["max_gt"]))
    batch = batch_to_device(collator(samples), DEVICE)
    model = train_model(cfg)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    torch.backends.cudnn.deterministic = True
    fwd, bwd, bits, walks = [], [], [], []
    reset_launches()
    with recorded(roi_align_cuda, "roi_align_forward", fwd), \
            recorded(roi_align_cuda, "roi_align_backward", bwd), \
            recorded(nms_cuda, "iou_bitmask", bits), \
            recorded(nms_cuda, "greedy_reduce", walks):
        got, got_grads = one_step(model, cfg, batch, seed=3)
    launches = read_launches()
    model.load_state_dict(init)
    reset_launches()
    with plain_roi_align():
        want, want_grads = one_step(model, cfg, batch, seed=3)
    p_launches = read_launches()
    model.load_state_dict(init)
    torch.backends.cudnn.deterministic = False
    keys = [k for k in want if k.startswith("loss") or "num_pos" in k]
    worst = grad_error(got_grads, want_grads)
    print(f"phase {phase} {label} one train step ({config.name}, "
          f"{spg} images of {tuple(batch['img'].shape[1:3])}, "
          f"{[len(s['gt_bboxes']) for s in samples]} objects), kernels vs "
          f"plain RoIAlign: launches {launches} vs {p_launches}; " + ", ".join(
              f"{k} {got[k]:.6f}" for k in keys) + f"; losses equal: "
          f"{all(got[k] == want[k] for k in keys)}; worst gradient error "
          f"{worst:.3e} of its parameter's max |grad| (bar {GRAD_TOL}) "
          f"[{card}]")
    if launches != expected or p_launches["roi_align"] \
            or p_launches["roi_align_backward"]:
        raise AssertionError(f"{label}: launches {launches}, plain "
                             f"{p_launches}, expected {expected}")
    if any(got[k] != want[k] or not np.isfinite(got[k]) for k in keys) \
            or worst > GRAD_TOL:
        raise AssertionError(f"{label} kernels vs plain: {got} vs {want}, "
                             f"gradient {worst}")
    del got_grads, want_grads
    f_rows, b_rows, b_inputs = step_rois(card, fwd, bwd, phase=phase,
                                         label=f"{label} train step",
                                         kinds=kinds)
    (sboxes, thr, n_valid), _, _ = bits[0]
    (_, ok, order, _, _), _, _ = walks[0]
    k1 = k1_row(card, f"{label} train RPN", sboxes, ok, order, n_valid, thr,
                phase=phase)
    return model, cfg, batch, launches, k1, f_rows, b_rows, b_inputs


def phase_cascade(card):
    """Phase 17 (a): COCO Cascade R-CNN at full width, seeded weights:
    `inference_detector` on two COCO_HW images (launches, the kernels
    against the plain versions, K2's forward at each stage's rois), the
    card against the CPU on the first; a train step at samples_per_gpu 2
    (the kernels against the plain RoIAlign, each stage's K2 forward and
    backward on the step's rois); train-step ms, peak memory, and a
    profile (to be run after every timing) for the idle share."""
    from pointtinybenchmark_tpu_torch.apis.inference import (
        inference_detector, init_detector)

    imgs = cascade_images(np.random.RandomState(171), 2)
    names = [n for _, n in CASCADE_KINDS]
    handle, _, dets, launches, k1, k2 = detect_and_hold(
        card, "17 (a)", "cascade_rcnn", CASCADE_CONFIG, imgs,
        CASCADE_IMAGE_LAUNCHES, names)
    cpu = init_detector(str(CASCADE_CONFIG), device="cpu")
    lift_classes(cpu.model)
    ref = inference_detector(cpu, imgs[0])
    order = np.argsort(-dets[0]["bboxes"][:, 4], kind="stable")
    ref_order = np.argsort(-ref["bboxes"][:, 4], kind="stable")
    n = dets_match((ref["bboxes"][ref_order], ref["labels"][ref_order]),
                   (dets[0]["bboxes"][order], dets[0]["labels"][order]))
    print(f"phase 17 (a) cascade_rcnn: the CPU's {n} detections of image 0 "
          f"matched at tests/test_detector_golden.py:88's tolerances "
          f"[{card}]")
    del handle, cpu, ref
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    model, cfg, batch, train_launches, k1_train, f_rows, b_rows, b_inputs = \
        step_and_hold(card, "17 (a)", "cascade_rcnn", CASCADE_CONFIG,
                      CASCADE_TRAIN_LAUNCHES, CASCADE_KINDS, 172)
    numbers, step_profile = time_step(card, "17 (a)", "cascade_rcnn_train",
                                      cfg, model, batch, held,
                                      CASCADE_TRAIN_IMAGES)
    del model, batch

    def profile():
        step_profile()
        for rec, args in zip(b_rows, b_inputs):
            add_device_ms(card, rec, *args, phase="17 (a)")
    return ({"cascade_rcnn_inference_detector": launches,
             "cascade_rcnn_train_step": train_launches},
            k1 + [k1_train], k2 + f_rows, b_rows, profile)


def phase_edge_unaligned(card):
    """Phase 17 (b): K2 forward and backward at aligned=False against
    their plain versions on phase 2's edge rois (`edge_rois` of EDGE_TILES
    512x640 tiles) at S=7 and S=14, sr 2: paths, times, bounds."""
    from pointtinybenchmark_tpu_torch.models.roi_heads.roi_extractor import \
        map_roi_levels

    gen = torch.Generator(device=DEVICE).manual_seed(173)
    feats = [torch.randn((EDGE_TILES, h, w, ROI_CHANNELS), generator=gen,
                         device=DEVICE).permute(0, 3, 1, 2)
             for h, w in ROI_LEVELS]
    shapes = [tuple(f.shape) for f in feats]
    rois = torch.from_numpy(edge_rois(EDGE_TILES)).to(DEVICE)
    lvls = map_roi_levels(rois, len(ROI_LEVELS))
    r = rois.shape[0]
    f_rows, b_rows = [], []
    for out, sr in ((7, 2), (14, 2)):
        g = torch.randn((r, ROI_CHANNELS, out, out), generator=gen,
                        device=DEVICE)
        _, f_err = compare_roi_align(feats, rois, lvls, out, sr, False)
        err, share = compare_roi_align_backward(g, rois, lvls, shapes, out,
                                                sr, False)
        f_paths = roi_paths(feats, rois, lvls, out, sr, False)
        b_paths = backward_paths(g, rois, lvls, shapes, out, sr, False)
        f_ms, f_plain = time_roi_align(feats, rois, lvls, out, sr, False)
        f_bms, f_by = roi_align_bound(feats, rois, lvls, out, sr, False)
        b_ms, b_plain = time_roi_align_backward(g, rois, lvls, shapes, out,
                                                sr, False)
        b_bms, b_by = roi_align_backward_bound(r, ROI_CHANNELS, out, sr,
                                               shapes)
        name = f"edge rois aligned=False S={out}"
        print(f"phase 17 (b) {name} (R={r}: {EDGE_TILES} tiles of "
              f"edge_rois, sr={sr}): forward kernel == plain (torch.equal), "
              f"paths {shares(f_paths)}; backward kernel vs plain "
              f"{err:.3e} ({share:.3e} of the level's max, bar {BWD_TOL}), "
              f"paths {shares(b_paths)}; forward {f_ms:.4f} ms (plain "
              f"{f_plain:.4f}, bound {f_bms:.4f} {f_by}), backward call "
              f"{b_ms:.4f} ms (plain {b_plain:.4f}, bound {b_bms:.4f} "
              f"{b_by}) [{card}]")
        f_rows.append(dict(shape=name, R=r, S=out, sr=sr, aligned=False,
                           max_abs_err=f_err, ms=f_ms, plain_ms=f_plain,
                           bound_ms=f_bms, bound_by=f_by, paths=f_paths))
        b_rows.append(dict(shape=name, R=r, S=out, sr=sr, aligned=False,
                           rois="edge", max_abs_err=err, err_share=share,
                           ms=b_ms, plain_ms=b_plain, bound_ms=b_bms,
                           bound_by=b_by, paths=b_paths))
    return f_rows, b_rows


def phase_legacy(card):
    """Phase 17 (b): the V1.x legacy Cascade R-CNN and Mask R-CNN at full
    width (LEGACY_RUNS): one `inference_detector` and one train step each
    (`detect_and_hold`, `step_and_hold`: RoIAlign at aligned=False, the
    kernels against their plain versions on the calls' own launches),
    then K2 at aligned=False on the edge rois."""
    imgs = cascade_images(np.random.RandomState(174), 1)
    by_path, k1_rows, f_rows, b_rows = {}, [], [], []
    for i, (name, config, image, step, kinds) in enumerate(LEGACY_RUNS):
        _, _, _, launches, k1, k2 = detect_and_hold(
            card, "17 (b)", name, config, imgs, image,
            [n for _, n in kinds])
        model, _, _, train_launches, k1_train, f, b, _ = step_and_hold(
            card, "17 (b)", name, config, step, kinds, 175 + i)
        if not all(row["aligned"] is False for row in k2 + f + b):
            raise AssertionError(f"{name}: a RoIAlign launch was aligned")
        by_path.update({f"{name}_inference_detector": launches,
                        f"{name}_train_step": train_launches})
        k1_rows += k1 + [k1_train]
        f_rows += k2 + f
        b_rows += b
        del model
        torch.cuda.empty_cache()
    f_edge, b_edge = phase_edge_unaligned(card)
    return by_path, k1_rows, f_rows + f_edge, b_rows + b_edge


def train_cli_run(name, config, opts, iters):
    """The port's train CLI on `config` with `opts` (--cfg-options), an
    IterBasedRunner of `iters` iterations, validation at the end: the
    launches, the logged steps, the it/s and the metrics."""
    from pointtinybenchmark_tpu_torch.tools import train as train_cli

    work = Path.cwd() / f"work_{name}"
    reset_launches()
    t0 = time.perf_counter()
    metrics = train_cli.main([
        str(config), "--work-dir", str(work), "--seed", "0", "--device",
        DEVICE, "--cfg-options", "runner.type=IterBasedRunner",
        f"runner.max_iters={iters}", f"checkpoint_config.interval={iters}",
        f"evaluation.interval={iters}", "log_config.interval=1", *opts])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return metrics, read_launches(), wall, work


def phase_cli(card, root):
    """Phase 17 (c): the train CLI (CLI_RUNS) on synthetic COCO-format sets
    with masks (`write_coco_set`: 80 COCO, 15 DeepFashion or 8 Cityscapes
    classes): CLI_ITERS iterations and the validation at the end, the
    launches a step and a validation image, it/s; the GHM RetinaNet's
    first step refuses with the JAX package's reason."""
    rng = np.random.RandomState(176)
    sets = {}
    for names in {r[4] for r in CLI_RUNS}:
        tag = "coco" if names is None else f"{len(names)}_classes"
        img_dir = root / f"data/{tag}/images"
        anns = [root / f"data/{tag}/{split}.json" for split in ("train",
                                                                 "val")]
        n = [write_coco_set(img_dir, a, k, rng, masks=True, names=names)
             for a, k in zip(anns, (CLI_TRAIN_IMAGES, CLI_VAL_IMAGES))]
        sets[names] = (anns, img_dir, n)
    by_path = {}
    for name, config, step, val, names in CLI_RUNS:
        (train_ann, val_ann), img_dir, n = sets[names]
        opts = [f"data.train.ann_file={train_ann}",
                f"data.train.img_prefix={img_dir}",
                f"data.val.ann_file={val_ann}", f"data.val.img_prefix={img_dir}"]
        metrics, launches, wall, work = train_cli_run(name, config, opts,
                                                      CLI_ITERS)
        expect(launches, {k: CLI_ITERS * step[k] + CLI_VAL_IMAGES * val[k]
                          for k in step}, f"{name} train CLI")
        log = log_steps(work, list(range(1, CLI_ITERS + 1)))
        if metrics is None:
            raise AssertionError(f"{name}: no validation ran")
        print(f"phase 17 (c) {name} train CLI ({config.name}, {n[0]} + {n[1]} "
              f"objects in {CLI_TRAIN_IMAGES} train and {CLI_VAL_IMAGES} val "
              f"images): {wall:.1f} s (host clock); launches {launches} = "
              f"{CLI_ITERS} steps x {step} + {CLI_VAL_IMAGES} val images x "
              f"{val}; losses first {log[0]['loss']:.4f} last "
              f"{log[-1]['loss']:.4f}; {1 / log[-1]['iter_time']:.3f} it/s "
              f"(host clock, loader included, a log sync a step); "
              f"validation {metrics} (random weights, not a quality number) "
              f"[{card}]")
        by_path[f"{name}_train_cli"] = launches
    (train_ann, val_ann), img_dir, _ = sets[None]
    try:
        train_cli_run("ghm_retinanet", GHM_CONFIG, [
            f"data.train.ann_file={train_ann}",
            f"data.train.img_prefix={img_dir}", f"data.val.ann_file={val_ann}",
            f"data.val.img_prefix={img_dir}"], 1)
    except TypeError as e:
        if str(e) != GHM_REASON:
            raise
        print(f"phase 17 (c) ghm_retinanet train CLI ({GHM_CONFIG.name}): "
              f"the first step refuses with the JAX package's reason: "
              f"TypeError: {e}")
    else:
        raise AssertionError("the GHM RetinaNet trained; the JAX package "
                             "refuses it")
    return by_path


def write_lvis_set(root, split, n, rng):
    """An LVIS v1-format split: LVIS_CLASSES categories (frequency r, c, f
    in turn), `n` JPEGs of 640x480 / 480x640 under root/{split}2017 named
    by their `coco_url`, each with 3-8 objects (bright blocks), 70% of them
    of the first 16 classes, its `neg_category_ids` (4 of the first 16
    classes it lacks) and `not_exhaustive_category_ids` (one it has).
    Returns the json's path and the number of objects."""
    from PIL import Image

    img_dir = root / f"{split}2017"
    img_dir.mkdir(parents=True, exist_ok=True)
    images, anns = [], []
    for i in range(n):
        h, w = ((480, 640), (640, 480))[i % 2]
        img = rng.randint(0, 70, (h, w, 3)).astype(np.uint8)
        cats = set()
        for _ in range(rng.randint(3, 9)):
            c = int(rng.randint(1, 17)) if rng.rand() < 0.7 else \
                int(rng.randint(17, LVIS_CLASSES + 1))
            bw, bh = np.exp(rng.uniform(np.log(16), np.log(256), 2))
            x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            img[int(y):int(y + bh), int(x):int(x + bw)] = rng.randint(
                120, 256, 3)
            anns.append(dict(id=len(anns) + 1, image_id=i + 1, category_id=c,
                             bbox=[float(x), float(y), float(bw), float(bh)],
                             area=float(bw * bh), iscrowd=0))
            cats.add(c)
        image_id = 1000 * (split == "train") + i + 1
        Image.fromarray(img).save(img_dir / f"{image_id:012d}.jpg",
                                  quality=90)
        absent = [c for c in range(1, 17) if c not in cats]
        images.append(dict(
            id=i + 1, width=w, height=h,
            coco_url=f"http://images.cocodataset.org/{split}2017/"
                     f"{image_id:012d}.jpg",
            neg_category_ids=absent[:4],
            not_exhaustive_category_ids=sorted(cats)[:1]))
    path = root / f"lvis_v1_{split}.json"
    path.write_text(json.dumps(dict(
        images=images, annotations=anns,
        categories=[dict(id=c, name=f"lvis{c}", frequency="rcf"[c % 3])
                    for c in range(1, LVIS_CLASSES + 1)])))
    return path, len(anns)


def phase_lvis(card, root):
    """Phase 17 (d): the LVIS Seesaw config (1,203 classes) at full width:
    the test CLI on a synthetic LVIS val split from a checkpoint of the
    seeded weights with fc_cls's bias raised (LVIS_LIFT_BIAS on the first
    LIFT_CLASSES classes): launches, the LVIS metrics, K1 alone at the RoI
    head's 1,203-class launch; the train CLI's first step refuses with the
    JAX package's reason."""
    from pointtinybenchmark_tpu_torch.apis.inference import init_detector
    from pointtinybenchmark_tpu_torch.ops import nms_cuda
    from pointtinybenchmark_tpu_torch.tools import test as test_cli

    rng = np.random.RandomState(177)
    lvis = root / "data/lvis_v1"
    val_ann, n_val = write_lvis_set(lvis, "val", LVIS_IMAGES, rng)
    train_ann, _ = write_lvis_set(lvis, "train", 2, rng)
    model = init_detector(str(LVIS_CONFIG), device=DEVICE).model
    lift_classes(model, LVIS_LIFT_BIAS)
    ckpt = root / "lvis_lifted.pth"
    torch.save({"state_dict": model.state_dict()}, ckpt)
    del model
    opts = [f"data.test.ann_file={val_ann}", f"data.test.img_prefix={lvis}/"]
    bits, walks = FirstCalls(2), FirstCalls(2)
    reset_launches()
    t0 = time.perf_counter()
    with recorded(nms_cuda, "iou_bitmask", bits), \
            recorded(nms_cuda, "greedy_reduce", walks):
        metrics = test_cli.main([str(LVIS_CONFIG), str(ckpt), "--device",
                                 DEVICE, "--cfg-options", *opts])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    expect(launches, {k: LVIS_IMAGES * v for k, v in
                      TWO_STAGE_IMAGE_LAUNCHES.items()}, "LVIS test CLI")
    want = ["mAP", "AP50", "AP75", "APs", "APm", "APl", "APr", "APc", "APf",
            "AR@300"]
    if list(metrics) != want or not all(-1.0 <= v <= 1.0
                                        for v in metrics.values()):
        raise AssertionError(f"LVIS metrics {metrics}")
    (sboxes, thr, n_valid), _, _ = bits[1]
    print(f"phase 17 (d) LVIS Seesaw test CLI ({LVIS_CONFIG.name}, "
          f"{LVIS_CLASSES} classes, seeded weights with fc_cls's bias raised "
          f"by {LVIS_LIFT_BIAS} on {LIFT_CLASSES} classes) on {LVIS_IMAGES} "
          f"synthetic LVIS images ({n_val} objects): {wall:.1f} s (host "
          f"clock); launches {launches}; the RoI head's NMS B="
          f"{sboxes.shape[0]} N={sboxes.shape[1]}, {n_valid.tolist()} valid "
          f"candidates; LVIS metrics {metrics} (random weights) [{card}]")
    k1 = first_k1_rows(card, ["LVIS RPN", "LVIS RoI head (1,203 classes)"],
                       bits, walks, phase="17 (d)")
    try:
        train_cli_run("lvis_seesaw", LVIS_CONFIG, [
            f"data.train.ann_file={train_ann}",
            f"data.train.img_prefix={lvis}/", "--no-validate"], 1)
    except TypeError as e:
        if str(e) != SEESAW_REASON:
            raise
        print(f"phase 17 (d) LVIS Seesaw train CLI: the first step refuses "
              f"with the JAX package's reason: TypeError: {e}")
    else:
        raise AssertionError("the Seesaw config trained; the JAX package "
                             "refuses it")
    return {"lvis_test_cli": launches}, k1


def phase_cascades(card):
    """Phase 17: (a)-(d) in a temporary folder under build/."""
    import os
    import tempfile

    build = REPO / "build"
    build.mkdir(exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=build, prefix="cascade_")
    root = Path(tmp.name)
    cwd = os.getcwd()
    os.chdir(root)
    laps = [time.perf_counter()]

    def lap(what):
        laps.append(time.perf_counter())
        print(f"phase 17 {what}: {laps[-1] - laps[-2]:.1f} s (host clock)")
    try:
        a_path, a_k1, a_fwd, a_bwd, a_profile = phase_cascade(card)
        lap("(a)")
        b_path, b_k1, b_fwd, b_bwd = phase_legacy(card)
        lap("(b)")
        c_path = phase_cli(card, root)
        lap("(c)")
        d_path, d_k1 = phase_lvis(card, root)
        lap("(d)")
    finally:
        os.chdir(cwd)
        tmp.cleanup()
        torch.cuda.empty_cache()
    print(f"phase 17 whole: {laps[-1] - laps[0]:.1f} s (host clock) [{card}]")
    return ({**a_path, **b_path, **c_path, **d_path}, a_k1 + b_k1 + d_k1,
            a_fwd + b_fwd, a_bwd + b_bwd, a_profile)


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
    p2p_launches, p2p, p2p_k1 = phase_p2p(card, frames)
    p2p_train_launches, p2p_train_profile = phase_p2p_train(card)
    cpr_launches, cpr_train_launches, cpr_profiles = phase_cpr(card)
    laps = [t_start]

    def lap(what):
        laps.append(time.perf_counter())
        print(f"{what}: {laps[-1] - laps[-2]:.1f} s (host clock)")
    lap("kernel build and phases 1-10")
    rois_rows = phase_rois_backward(card)
    lap("phase 11 (a)")
    p2b_by_path, p2b_rows, p2b_profiles = phase_p2b(card)
    lap("phase 11 (b)-(d)")
    phase_seeded(card)
    lap("phase 11 (f)")
    phase_learn(card)
    lap("phase 11 (e)")
    dense = {}
    for name, config, cls_name in DENSE:
        dense[name] = phase_dense(card, frames, name, config, cls_name)
        dense[name + "_train"] = phase_dense_train(card, name, config)
    lap("phase 12 (a), (b)")
    grid_launches, grid, grid_record, grid_device_ms = phase_grid(card,
                                                                  frames)
    (grid_train_launches, grid_train_fwd, grid_train_bwd,
     grid_train_profile) = phase_grid_train(card)
    lap("phase 13 (a), (b)")
    dataset_launches = phase_dataset(card)
    lap("phase 14")
    sm_by_path, sm_k1, sm_fwd, sm_bwd = phase_scale_match(card)
    lap("phase 15")
    wf_by_path, wf_k1, wf_fwd, wf_bwd = phase_workflow(card)
    lap("phase 16")
    cc_by_path, cc_k1, cc_fwd, cc_bwd, cascade_profile = phase_cascades(card)
    lap("phase 17")
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
    phase_profile(card, p2p, frames, "p2p")
    p2p_train_profile()
    cpr_profiles()
    p2b_profiles()
    for name, _, _ in DENSE:
        phase_profile(card, dense[name][1], frames, name)
        dense[name + "_train"][1]()
    # its model is warm from phase 13's calls
    phase_profile(card, grid, frames, "grid_rcnn", GRID_PROFILE_CALLS,
                  warm=False)
    grid_device_ms()
    grid_train_profile()
    cascade_profile()
    lap("the profiles")
    for k in ("iou_bitmask", "greedy_reduce"):
        records[k]["by_shape"].append(mask_train_k1[k])
        records[k]["by_shape"] += [row[k] for row in p2p_k1]
        records[k]["by_shape"] += [row[k] for name, _, _ in DENSE
                                   for row in dense[name][2]]
        records[k]["by_shape"] += [row[k] for row in sm_k1 + wf_k1 + cc_k1]
    records["roi_align"] = dict(
        slice_record, by_shape=roi_shapes + [slice_record] + mask_records
        + [train_fwd] + mask_train_fwd + p2b_rows[0] + [grid_record]
        + grid_train_fwd + sm_fwd + wf_fwd + cc_fwd)
    records["roi_align_backward"] = dict(
        train_bwd, by_shape=bwd_shapes + [train_bwd] + mask_train_bwd
        + p2b_rows[1] + grid_train_bwd + sm_bwd + wf_bwd + cc_bwd)
    # the P2BNet step's negatives, its largest launch
    records["roi_align_rois_backward"] = dict(
        p2b_rows[2][1], by_shape=rois_rows + p2b_rows[2])

    by_path = {"adap_retinanet_c": retina_launches,
               "faster_rcnn": frcnn_launches, "mask_rcnn": mask_launches,
               "faster_rcnn_train": train_launches,
               "adap_retinanet_c_train": retina_train_launches,
               "mask_rcnn_train": mask_train_launches,
               "p2p": p2p_launches, "p2p_train": p2p_train_launches,
               "cpr_refine": cpr_launches, "cpr_train": cpr_train_launches,
               **p2b_by_path,
               **{k: v[0] for k, v in dense.items()},
               "grid_rcnn": grid_launches,
               "grid_rcnn_train": grid_train_launches,
               **dataset_launches, **sm_by_path, **wf_by_path, **cc_by_path}
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
