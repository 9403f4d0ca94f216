#!/usr/bin/env python3
"""Forward-only timing of both slices of the PyTorch/CUDA port on one card.

    python3 time_forward.py [--root DIR] [--rounds 5]

Imports pointtinybenchmark_tpu_torch from DIR (default: this file's
directory), so that one script times two trees of the port, run in turns
(parent, change, change, parent) as separate processes. Builds Adap
RetinaNet-c and Adap Faster R-CNN at full width with seeded weights, as
chip_smoke.py does, and times the forward on the 24 tiles of two seeded
1920x1080 frames, float32 with TF32 off: per round, chip_smoke.ITERS
forwards on the host's clock (img/s, the smoke's forward-only figure) and
between CUDA events (ms per forward); then PROFILE_FORWARDS forwards under
torch.profiler, device ms per forward by chip_smoke's kernel families.
Prints one JSON line.
"""
import argparse
import collections
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
PROFILE_FORWARDS = 4


def load_smoke():
    """chip_smoke.py beside this file, whatever tree --root names."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def forward_times(smoke, model, tiles, rounds):
    """(img/s per round, CUDA-event ms per forward per round)."""
    img_s, event_ms = [], []
    model(tiles)
    torch.cuda.synchronize()
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(smoke.ITERS):
            model(tiles)
        end.record()
        torch.cuda.synchronize()
        img_s.append(smoke.N_FRAMES * smoke.ITERS / (time.perf_counter() - t0))
        event_ms.append(start.elapsed_time(end) / smoke.ITERS)
    return img_s, event_ms


def device_families(smoke, model, tiles, root, label):
    """(device busy ms per forward, {family: device ms per forward})."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_FORWARDS):
            model(tiles)
        torch.cuda.synchronize()
    trace = root / "build" / f"forward_trace_{label}.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              and "dur" in e]
    if not events:
        raise AssertionError("the profiler traced no device activity")
    family = collections.Counter()
    for e in events:
        low = e["name"].lower()
        family[next((f for key, f in smoke.KERNEL_FAMILIES if key in low),
                    "rest")] += e["dur"] / 1e3 / PROFILE_FORWARDS
    return smoke._busy_us(events) / 1e3 / PROFILE_FORWARDS, dict(family)


def time_model(smoke, root, config, label, frames, rounds):
    from pointtinybenchmark_tpu_torch.apis.inference import (
        inference_detector_tiled, init_detector)

    handle = init_detector(str(root / config.relative_to(smoke.REPO)),
                           device="cuda", seed=0)
    if label == "retinanet":
        # as chip_smoke.phase_slice; the forward does the same work either way
        with torch.no_grad():
            handle.model.bbox_head.retina_cls.bias.zero_()
    inference_detector_tiled(handle, list(frames))   # builds the tiling engine
    tiles = next(iter(handle.tiled_engines.values())).pre(frames)
    with torch.no_grad():
        img_s, event_ms = forward_times(smoke, handle.model, tiles, rounds)
        busy, family = device_families(smoke, handle.model, tiles, root, label)
    return dict(img_s=img_s, event_ms=event_ms, busy_ms=busy,
                family_ms=family)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", type=Path, default=HERE)
    parser.add_argument("--rounds", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_forward: torch.cuda.is_available() is false")
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    smoke = load_smoke()
    from pointtinybenchmark_tpu_torch.ops import (cuda_build, nms_cuda,
                                                  roi_align_cuda)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cuda_build.compile_sources([nms_cuda.SOURCE, roi_align_cuda.SOURCE])
    frames = np.random.RandomState(1).randint(
        0, 256, (smoke.N_FRAMES,) + smoke.FRAME_HW + (3,), np.uint8)
    out = dict(root=str(root), card=card)
    for label, config in (("retinanet", smoke.CONFIG),
                          ("faster_rcnn", smoke.FRCNN_CONFIG)):
        out[label] = time_model(smoke, root, config, label, frames,
                                args.rounds)
        torch.cuda.empty_cache()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
