#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the NMS kernel pair from ops/csrc with nvcc, then:

1. kernel vs plain: the IoU-bitmask and greedy-reduce kernels against their
   plain PyTorch version on the card, on synthetic TinyPerson-like boxes, at
   the per-tile shape (B=12, N=8,720) and the global-merge shape (B=2,
   N=12,000, class offsets); keep sets must be identical;
2. the slice at full width: Adap RetinaNet-c (ResNet-50, FPN-256,
   RetinaHead) built from its config with seeded weights, two 1920x1080
   uint8 frames through `inference_detector_tiled` (24 tiles, per-tile NMS,
   global merge); the kernels must have been launched, NMS must do real
   work, the boxes must be sane, the card's forward must agree with the CPU
   forward on one tile, and the detections must equal those with the plain
   NMS;
3. timing: protocol and forward-only img/s, and per-tile and global NMS ms;
4. profile: warm protocol calls under torch.profiler, the card's idle
   share of the wall time and its time by kernel family (the Chrome trace
   goes to build/protocol_trace.json).

Float32 throughout with TF32 off (cuDNN would otherwise run the convolutions
in TF32). Every failure raises; there is no CPU mode. The last line is
{"ok": true, "device": {...}}; the line before it lists each kernel with its
launches on the main path, its error against the plain version and both
times.
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
DEVICE = "cuda"
FRAME_HW = (1080, 1920)
N_FRAMES = 2
ITERS = 10
PLAIN_ITERS = 3
# (name, B, N, classes): the per-tile NMS of one frame and the global merge
NMS_SHAPES = (("per-tile", 12, 8720, 1), ("global", 2, 12000, 3))
KERNEL_SOURCE = "pointtinybenchmark_tpu_torch/ops/csrc/nms_kernel.cu"
REPLACES = "pointtinybenchmark_tpu/ops/pallas_kernels.py:55"
PROFILE_CALLS = 5
# substrings of device kernel names, first match wins
KERNEL_FAMILIES = (
    ("iou_bitmask", "NMS kernel A iou_bitmask"),
    ("greedy_reduce", "NMS kernel B greedy_reduce"),
    ("nhwctonchw", "cuDNN layout transpose"),
    ("nchwtonhwc", "cuDNN layout transpose"),
    ("memcpy", "memcpy"), ("memset", "memset"),
    ("batch_norm", "BN inference"), ("bn_", "BN inference"),
    ("xmma", "convolution"), ("conv", "convolution"), ("gemm", "convolution"),
    ("fft", "convolution"), ("winograd", "convolution"),
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


def phase_kernels(card):
    from pointtinybenchmark_tpu_torch.ops import nms, nms_cuda

    rng = np.random.RandomState(0)
    records = {}
    for name, b, n, n_classes in NMS_SHAPES:
        boxes, scores, valid, labels = (
            torch.from_numpy(x).to(DEVICE)
            for x in synthetic_boxes(rng, b, n, n_classes))

        def run():
            return nms.batched_nms(boxes, scores, labels, 0.5, 1000,
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

        if name == "per-tile":
            # each kernel alone, against its plain version, on the same input
            masked = torch.where(valid, scores, nms.NEG_INF)
            _, order = torch.sort(masked, dim=1, descending=True, stable=True)
            sboxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
            sboxes = sboxes.contiguous()
            ok = torch.gather(valid, 1, order)
            order = order.to(torch.int32)
            mask = nms_cuda.iou_bitmask(sboxes, 0.5)
            mask_plain = nms_cuda.iou_bitmask_plain(sboxes, 0.5)
            keep = nms_cuda.greedy_reduce(mask, ok, order, 1000)
            keep_plain = nms_cuda.greedy_reduce_plain(mask, ok, order, 1000)
            torch.cuda.synchronize()
            mask_err = float((mask != mask_plain).any())
            keep_err = float((keep[0] - keep_plain[0]).abs().max())
            if mask_err or keep_err or not torch.equal(keep[1], keep_plain[1]):
                raise AssertionError(f"kernel vs plain: bitmask {mask_err}, "
                                     f"reduce {keep_err}")
            times = {
                "iou_bitmask": (time_ms(lambda: nms_cuda.iou_bitmask(
                    sboxes, 0.5), ITERS), time_ms(
                    lambda: nms_cuda.iou_bitmask_plain(sboxes, 0.5),
                    PLAIN_ITERS), mask_err),
                "greedy_reduce": (time_ms(lambda: nms_cuda.greedy_reduce(
                    mask, ok, order, 1000), ITERS), time_ms(
                    lambda: nms_cuda.greedy_reduce_plain(mask, ok, order,
                                                         1000),
                    PLAIN_ITERS), keep_err)}
            for k, (kms, pms, err) in times.items():
                print(f"phase 1 {k} B={b} N={n}: kernel {kms:.4f} ms, plain "
                      f"{pms:.4f} ms, max_abs_err {err} [{card}]")
                records[k] = dict(ms=kms, plain_ms=pms, max_abs_err=err)
    return records


def phase_slice(card):
    from pointtinybenchmark_tpu_torch.apis.inference import (
        inference_detector_tiled, init_detector)
    from pointtinybenchmark_tpu_torch.core.post_processing import \
        multiclass_nms
    from pointtinybenchmark_tpu_torch.ops import nms_cuda

    handle = init_detector(str(CONFIG), device=DEVICE, seed=0)
    model = handle.model
    head = model.bbox_head
    # The focal prior (retina_cls.bias = log(0.01/0.99)) keeps every score of
    # random weights at or below ~0.02, under score_thr 0.05: NMS would get
    # no candidate at all. A zero bias puts scores near 0.5.
    with torch.no_grad():
        head.retina_cls.bias.zero_()
    print("phase 2: retina_cls.bias set to 0 so that candidates pass "
          "score_thr (with the focal prior no score of random weights does)")
    frames = np.random.RandomState(1).randint(
        0, 256, (N_FRAMES,) + FRAME_HW + (3,), np.uint8)

    torch.backends.cudnn.deterministic = True   # the two runs must match bit for bit
    for k in nms_cuda.launches:
        nms_cuda.launches[k] = 0
    results = inference_detector_tiled(handle, list(frames))
    launches = dict(nms_cuda.launches)
    print(f"phase 2 launches on the main path: {launches}")
    if launches != {"iou_bitmask": 2, "greedy_reduce": 2}:
        raise AssertionError(f"expected one per-tile and one global launch of "
                             f"each kernel, got {launches}")
    with plain_nms():
        results_plain = inference_detector_tiled(handle, list(frames))
    torch.backends.cudnn.deterministic = False
    h, w = FRAME_HW
    for i, (r, p) in enumerate(zip(results, results_plain)):
        bb = r["bboxes"]
        n = bb.shape[0]
        print(f"phase 2 frame {i}: {n} boxes kept by the global merge")
        if not 1 <= n <= 1000 or bb.shape != (n, 5):
            raise AssertionError(f"frame {i}: {bb.shape} detections")
        if not (np.isfinite(bb).all() and (bb[:, 0] >= 0).all()
                and (bb[:, 1] >= 0).all() and (bb[:, 2] <= w).all()
                and (bb[:, 3] <= h).all()):
            raise AssertionError(f"frame {i}: boxes outside the frame")
        if not (np.array_equal(bb, p["bboxes"])
                and np.array_equal(r["labels"], p["labels"])):
            raise AssertionError(f"frame {i}: kernel and plain NMS disagree")
    print("phase 2: detections with the kernels == detections with plain NMS")

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
    print(f"phase 2 per-tile NMS input: {boxes.shape[1]} candidates per tile, "
          f"valid {cands}")
    print(f"phase 2 per-tile NMS kept: {kept}")
    if min(cands) <= 0 or min(kept) <= 0:
        raise AssertionError("NMS got no work")

    # the card's forward against the CPU forward on one tile
    cpu_model = init_detector(str(CONFIG), device="cpu", seed=0).model
    with torch.no_grad():
        cpu_model.bbox_head.retina_cls.bias.zero_()
        ref = cpu_model(tiles[:1].cpu())
    err = max(float((g[:1].cpu() - r).abs().max() / r.abs().max())
              for g, r in zip(cls_outs + reg_outs, ref[0] + ref[1]))
    print(f"phase 2 forward, card vs CPU on one tile: max rel err {err:.3e}")
    if err > 1e-4:
        raise AssertionError(f"card forward differs from CPU: {err}")
    return launches, handle, frames, tiles, (boxes, scores, nms_args, dets,
                                             eng)


def phase_timing(card, handle, frames, tiles, stage):
    from pointtinybenchmark_tpu_torch.apis.inference import \
        inference_detector_tiled
    from pointtinybenchmark_tpu_torch.core.post_processing import \
        multiclass_nms

    boxes, scores, nms_args, dets, eng = stage
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


def phase_profile(card, handle, frames):
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
    trace = REPO / "build" / "protocol_trace.json"
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
    print(f"phase 4 profile ({PROFILE_CALLS} warm protocol calls of "
          f"{N_FRAMES} frames, profiler on, trace {trace}): per call wall "
          f"{wall_ms:.4f} ms, device busy {busy_ms:.4f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.4f} [{card}]")
    print("phase 4 device ms per call by family (share of busy):")
    for name, us in family.most_common():
        ms = us / 1e3 / PROFILE_CALLS
        print(f"  {name:28s} {ms:10.4f} ms  {ms / busy_ms:.4f}")
    print("phase 4 top kernels (ms per call, launches per call):")
    for name, us in by_name.most_common(15):
        print(f"  {us / 1e3 / PROFILE_CALLS:9.4f}  "
              f"{count[name] / PROFILE_CALLS:6.1f}  {name}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs on a CUDA card only")
    from pointtinybenchmark_tpu_torch.ops import nms_cuda

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
    nms_cuda.build_library()
    print(f"kernel build (nvcc, sm_90a) + load: "
          f"{time.perf_counter() - t0:.2f} s")
    for log in sorted(nms_cuda.BUILD_DIR.glob("*.log")):
        print(log.read_text().strip())

    records = phase_kernels(card)
    launches, handle, frames, tiles, stage = phase_slice(card)
    phase_timing(card, handle, frames, tiles, stage)
    phase_profile(card, handle, frames)

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=KERNEL_SOURCE, replaces=REPLACES,
             launches=launches[name], **records[name])
        for name in ("iou_bitmask", "greedy_reduce")]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
