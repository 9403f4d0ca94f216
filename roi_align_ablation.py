#!/usr/bin/env python3
"""What bounds the RoIAlign kernel: its time with one part taken out.

    python3 roi_align_ablation.py

Builds copies of ops/csrc/roi_align_kernel.cu, each with one part of the
kernel removed or changed by a text substitution, into build/ablation/ (one
nvcc each, started together), and times every copy beside the kernel itself
on the card at chip_smoke.py's RoIAlign shapes (ROI_SHAPES), on three roi sets
made from a seed: phase 2's rois in shuffled tile order, the same rois in
tile-major order (the order of the main path's rois), and small rois only
(10-50 px, tile-major, about the slice's mix: nearly all at level 0). The
parts:

- no_loads: no cell is staged (the compute reads whatever shared memory
  holds); the kernel's time without the tap reads;
- no_compute: the staged cells are loaded and never read;
- no_stores: the output tiles are computed and never written out;
- plain_stores: 16-byte stores with the default cache policy in place of
  the streaming `__stcs` (the S = 7 tile path);
- one_block_per_roi: no split of a roi's channel chunks over blocks;
- templated_7_2: S = 7, sr = 2 (Mask R-CNN's bbox crops) as compile-time
  constants like the two main shapes, in place of the generic form.

A copy without a part computes a wrong result: it is timed, not checked.
The kernel itself and the copies that change no result (EXACT) are checked
against the plain version (torch.equal).
Prints a line per shape and roi set and one JSON line, after the card's
name and power limit. Needs the card and nvcc; fails otherwise.
"""
import json
import subprocess

import numpy as np
import torch

import chip_smoke as smoke
from pointtinybenchmark_tpu_torch.models.roi_heads.roi_extractor import \
    map_roi_levels
from pointtinybenchmark_tpu_torch.ops import (cuda_build, roi_align,
                                              roi_align_cuda)

OUT_DIR = smoke.REPO / "build" / "ablation"
ITERS = 20
# (name, [(text in the source, its replacement)])
ABLATIONS = (
    ("kernel", []),
    ("no_loads", [("  load(0);\n", "\n"),
                  ("    if (t + 1 < n_stages) load(t + 1);", "")]),
    ("no_compute", [("      compute_rows<kS, kSr>(\n          SharedCells{",
                     "      if (false) compute_rows<kS, kSr>(\n"
                     "          SharedCells{")]),
    ("no_stores", [("        store_chunk<kVec>(tile, ld, bins, width,\n"
                    "                          dst + static_cast<size_t>(c0)"
                    " * bins);", "")]),
    ("plain_stores", [("__stcs(reinterpret_cast<float4*>(out) + i, t4[i]);",
                       "reinterpret_cast<float4*>(out)[i] = t4[i];")]),
    ("one_block_per_roi", [("const int groups = static_cast<int>(want < "
                            "n_chunks ? want : n_chunks);",
                            "const int groups = 1;")]),
    ("templated_7_2", [("  return launch<kVec, 0, 0>(",
                        "  if (out_size == 7 && sr == 2) {\n"
                        "    return launch<kVec, 7, 2>(lv, channels, rois, "
                        "lvls, n_rois, out_size, sr, aligned, output, "
                        "path_counts, stream);\n  }\n"
                        "  return launch<kVec, 0, 0>(")]),
)
# the copies whose results must equal the plain version's
EXACT = ("kernel", "plain_stores", "one_block_per_roi", "templated_7_2")


def build():
    """{ablation: its library, bound by roi_align_cuda.build_library}."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    kernel_source = roi_align_cuda.SOURCE
    text = kernel_source.read_text()
    paths = {}
    for name, subs in ABLATIONS:
        ablated = text
        for old, new in subs:
            if old not in ablated:
                raise RuntimeError(f"{name}: the kernel source no longer has "
                                   f"{old!r}")
            ablated = ablated.replace(old, new)
        paths[name] = OUT_DIR / f"roi_align_{name}.cu"
        paths[name].write_text(ablated)
    cuda_build.compile_sources(paths.values())
    libs = {}
    for name, path in paths.items():
        roi_align_cuda.SOURCE, roi_align_cuda._lib = path, None
        libs[name] = roi_align_cuda.build_library()
    roi_align_cuda.SOURCE, roi_align_cuda._lib = kernel_source, None
    return libs


def roi_sets(rng, b, r):
    """(label, numpy rois) for the three sets."""
    shuffled = smoke.phase2_rois(rng, b, r)
    tile_major = shuffled[np.argsort(shuffled[:, 0], kind="stable")]
    small = smoke.synthetic_rois(rng, b, r)
    small[:, 3:] = small[:, 1:3] + rng.uniform(10, 50, (r, 2))
    small = small[np.argsort(small[:, 0], kind="stable")]
    return (("shuffled", shuffled), ("tile-major", tile_major),
            ("small tile-major", small))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("roi_align_ablation: no CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    libs = build()
    print(card)
    rng = np.random.RandomState(2)
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for shape, b, r, out, sr in smoke.ROI_SHAPES:
        feats = [torch.randn((b, h, w, smoke.ROI_CHANNELS), generator=gen,
                             device="cuda").permute(0, 3, 1, 2)
                 for h, w in smoke.ROI_LEVELS]
        for label, array in roi_sets(rng, b, r):
            rois = torch.from_numpy(array).cuda()
            lvls = map_roi_levels(rois, len(smoke.ROI_LEVELS))

            def run():
                return roi_align_cuda.roi_align_forward(
                    feats, rois, lvls, smoke.ROI_STRIDES, out, sr)
            bound_ms, _ = smoke.roi_align_bound(feats, rois, lvls, out, sr)
            row = dict(shape=shape, rois=label, bound_ms=bound_ms,
                       per_level=torch.bincount(
                           lvls, minlength=len(smoke.ROI_LEVELS)).tolist())
            want = roi_align.roi_align_multilevel_plain(
                feats, rois, lvls, smoke.ROI_STRIDES, out, sr)
            for name, lib in libs.items():
                roi_align_cuda._lib = lib
                if name in EXACT and not torch.equal(run(), want):
                    raise AssertionError(f"{shape} {label}: {name} != plain")
                row[name] = smoke.time_ms(run, ITERS)
            del want
            roi_align_cuda._lib = None
            rows.append(row)
            print(f"{shape} R={r} S={out} sr={sr}, {label} rois (per level "
                  f"{row['per_level']}), ms: "
                  + ", ".join(f"{n} {row[n]:.4f}" for n, _ in ABLATIONS)
                  + f"; bound {bound_ms:.4f} [{card}]")
    print(json.dumps({"card": card, "rows": rows}))


if __name__ == "__main__":
    main()
