#!/usr/bin/env python3
"""Time the RoIAlign backward kernel of one tree of the port on one card.

    python3 time_backward.py [--root DIR] [--step FILE]

Imports pointtinybenchmark_tpu_torch from DIR (default: this file's
directory) and chip_smoke.py from beside this file, so that one script
times two trees' kernels on the same inputs, run in turns (parent, change,
change, parent) as separate processes. The inputs: the train step's own
backward inputs that a run of chip_smoke.py saved (FILE, default
chip_smoke.STEP_BACKWARD; left out when it is not there), then phase 6
(a)'s (chip_smoke.backward_inputs). At each it holds DIR's kernel to the
plain backward (within chip_smoke.BWD_TOL of each level's max |gradient|)
and times it two ways: whole wrapper calls between CUDA events (call ms,
the kernels line's `ms`), and the kernel's and the zero fill's device time
from a torch.profiler trace (chip_smoke.backward_device_ms). Prints one
line per shape and one JSON line, after the card's name and power limit.
Needs the card and nvcc; fails otherwise.
"""
import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", type=Path, default=HERE)
    parser.add_argument("--step", type=Path, default=None)
    args = parser.parse_args()
    root = args.root.resolve()
    if not torch.cuda.is_available():
        raise SystemExit("time_backward: no CUDA card")
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from pointtinybenchmark_tpu_torch.ops import roi_align_cuda

    if not Path(roi_align_cuda.__file__).resolve().is_relative_to(root):
        raise AssertionError(f"imported {roi_align_cuda.__file__}, not the "
                             f"tree {root}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    roi_align_cuda.build_library()
    print(card)
    torch.backends.cudnn.allow_tf32 = False
    step = args.step or smoke.STEP_BACKWARD
    cases = []
    if step.exists():
        cases.append(("faster_rcnn train step", "train step",
                      torch.load(step)))
    cases += [(name, kind, (g, rois, lvls, shapes, out, sr))
              for name, _, kind, g, rois, lvls, shapes, out, sr
              in smoke.backward_inputs()]
    rows = []
    for name, kind, (g, rois, lvls, shapes, out, sr) in cases:
        r = rois.shape[0]
        _, share = smoke.compare_roi_align_backward(g, rois, lvls, shapes,
                                                    out, sr)
        call_ms = smoke.time_ms(lambda: roi_align_cuda.roi_align_backward(
            g, rois, lvls, shapes, [True] * len(shapes), smoke.ROI_STRIDES,
            out, sr), smoke.ITERS)
        kernel_ms, fill_ms, device_ms = smoke.backward_device_ms(
            g, rois, lvls, shapes, out, sr, f"time_backward_{root.name}")
        bound_ms, _ = smoke.roi_align_backward_bound(r, g.shape[1], out, sr,
                                                     shapes)
        rows.append(dict(shape=name, R=r, S=out, sr=sr, rois=kind,
                         err_share=share, call_ms=call_ms,
                         kernel_ms=kernel_ms, fill_ms=fill_ms,
                         device_ms=device_ms, bound_ms=bound_ms))
        print(f"{root.name}: backward {name} R={r} S={out} sr={sr} ({kind}):"
              f" kernel {kernel_ms:.4f} ms, fill {fill_ms:.4f} ms, device "
              f"{device_ms:.4f} ms, call {call_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms; {share:.3e} of the level's max [{card}]")
    print(json.dumps({"root": str(root), "card": card, "rows": rows}))


if __name__ == "__main__":
    main()
