#!/usr/bin/env python3
"""What bounds the RoIAlign kernels: their time with one part taken out.

    python3 roi_align_ablation.py [--part forward|backward|both]

Builds copies of ops/csrc/roi_align_kernel.cu, each with one part of a
kernel removed or changed by a text substitution, into build/ablation/ (one
nvcc each, started together), and times every copy beside the kernel itself
on the card.

The forward, at chip_smoke.py's RoIAlign shapes (ROI_SHAPES), on three roi
sets made from a seed: phase 2's rois in shuffled tile order, the same rois
in tile-major order (the order of the main path's rois), and small rois
only (10-50 px, tile-major, about the slice's mix: nearly all at level 0).
Times are CUDA events around whole calls. The parts:

- no_loads: no cell is staged (the compute reads whatever shared memory
  holds); the kernel's time without the tap reads;
- no_compute: the staged cells are loaded and never read;
- no_stores: the output tiles are computed and never written out;
- plain_stores: 16-byte stores with the default cache policy in place of
  the streaming `__stcs` (the S = 7 tile path);
- one_block_per_roi: no split of a roi's channel chunks over blocks;
- templated_7_2: S = 7, sr = 2 (Mask R-CNN's bbox crops) as compile-time
  constants like the two main shapes, in place of the generic form.

The backward, at phase 6's shapes and inputs (chip_smoke.backward_inputs:
uniform and clustered rois).
Times are the kernel's device time from a torch.profiler trace
(chip_smoke.backward_device_ms), so the wrapper's host time does not enter.
The parts:

- no_flush: each cell's sum is computed and never added to the level
  gradient (a test the compiler cannot drop keeps the sum alive);
- scalar_flush: four scalar atomics in place of one 16-byte vector atomic;
- no_stage: the upstream gradient read from global memory (the global
  path) in place of the staged, transposed copy in shared memory;
- bwd_one_block_per_roi: one block walks all the stages of its roi, the
  next stage's copy in flight during this one's gather (BWD_WALK, put into
  the copy's kernel in place of its one stage), in place of a block per
  stage;
- bwd_block_per_chunk: stages of one 32-channel chunk, so a block per
  (roi, chunk), in place of up to four chunks.

A copy without a part computes a wrong result: it is timed, not checked.
The kernel itself and the copies that change no result (EXACT) are checked
against the plain version: the forward's bit for bit (torch.equal), the
backward's within chip_smoke.BWD_TOL of each level's max |gradient|.
Prints a line per shape and roi set and one JSON line, after the card's
name and power limit. Needs the card and nvcc; fails otherwise.
"""
import argparse
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
# the backward kernel's one stage (its end) -> a walk over all the roi's
# stages from the block's first chunk, the next stage's copy in flight
# during this one's gather
BWD_WALK = (
    """  cp_async_wait<0>();
  __syncthreads();         // the stage landed, the tables are built
  transpose_stage(gs, buf, nk, min(nk * kChunk, channels - k * kChunk), bins,
                  inv_count);
  __syncthreads();
  gather_stage<kVec>(gs, bins, kc, sy, sx, cy, cx, my.n, mx.n, nk, k,
                     channels, gmap, wl);
}""",
    """  for (int kt = k; kt < n_chunks; kt += kc) {
    const int nt = min(kc, n_chunks - kt);
    cp_async_wait<0>();
    __syncthreads();       // stage kt landed, the last gather is done
    transpose_stage(gs, buf, nt, min(nt * kChunk, channels - kt * kChunk),
                    bins, inv_count);
    __syncthreads();       // buf is free: the next stage loads meanwhile
    if (kt + kc < n_chunks) {
      copy_stage<kVec>(buf, src, kt + kc, min(kc, n_chunks - kt - kc),
                       channels, bins);
    }
    cp_async_commit();
    gather_stage<kVec>(gs, bins, kc, sy, sx, cy, cx, my.n, mx.n, nt, kt,
                       channels, gmap, wl);
  }
}""")
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
BWD_ABLATIONS = (
    ("bwd_kernel", []),
    ("no_flush", [("        flush<kVec>(dst + p * kChunk, acc[p], channels "
                   "- c);", "        if (acc[p].x == 1.5e-38f) flush<kVec>("
                   "dst + p * kChunk, acc[p], channels - c);")]),
    ("scalar_flush", [("    atomicAdd(reinterpret_cast<float4*>(dst), v);",
                       "    atomicAdd(dst, v.x);\n    atomicAdd(dst + 1, v.y);"
                       "\n    atomicAdd(dst + 2, v.z);\n"
                       "    atomicAdd(dst + 3, v.w);")]),
    ("no_stage", [("  const bool staged = 2 * chunk + tables <= kBlockBudget;",
                   "  const bool staged = false;")]),
    ("bwd_one_block_per_roi", [
        ("  const int stages = (n_chunks + kc_max - 1) / kc_max;\n"
         "  const int kc = (n_chunks + stages - 1) / stages;",
         "  const int stages = 1;\n"
         "  const int kc = kc_max < n_chunks ? kc_max : n_chunks;"),
        BWD_WALK]),
    ("bwd_block_per_chunk", [("constexpr int kBwdMaxStage = 4;",
                              "constexpr int kBwdMaxStage = 1;")]),
)
# the copies whose results must equal the plain version's (the forward's
# bit for bit, the backward's within BWD_TOL)
EXACT = ("kernel", "plain_stores", "one_block_per_roi", "templated_7_2",
         "bwd_kernel", "scalar_flush", "no_stage", "bwd_one_block_per_roi",
         "bwd_block_per_chunk")


def build(ablations):
    """{ablation: its library, bound by roi_align_cuda.build_library}."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    kernel_source = roi_align_cuda.SOURCE
    text = kernel_source.read_text()
    paths = {}
    for name, subs in ablations:
        ablated = text
        for old, new in subs:
            if ablated.count(old) != 1:
                raise RuntimeError(f"{name}: the kernel source has "
                                   f"{ablated.count(old)} copies of {old!r}")
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


def forward(card, libs):
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
                  + ", ".join(f"{n} {row[n]:.4f}" for n in libs)
                  + f"; bound {bound_ms:.4f} [{card}]")
    return rows


def backward(card, libs):
    rows = []
    for shape, _, kind, g, rois, lvls, shapes, out, sr in \
            smoke.backward_inputs():
        r = rois.shape[0]
        bound_ms, _ = smoke.roi_align_backward_bound(r, smoke.ROI_CHANNELS,
                                                     out, sr, shapes)
        row = dict(shape=shape, rois=kind, bound_ms=bound_ms)
        for name, lib in libs.items():
            roi_align_cuda._lib = lib
            if name in EXACT:
                smoke.compare_roi_align_backward(g, rois, lvls, shapes, out,
                                                 sr)
            row[name], row[name + "_fill"], _ = smoke.backward_device_ms(
                g, rois, lvls, shapes, out, sr, f"ablation_{name}")
        roi_align_cuda._lib = None
        rows.append(row)
        print(f"backward {shape} R={r} S={out} sr={sr}, {kind} rois, kernel "
              f"device ms: " + ", ".join(f"{n} {row[n]:.4f}" for n in libs)
              + f"; zero fill {row['bwd_kernel_fill']:.4f}; bound "
              f"{bound_ms:.4f} [{card}]")
    return rows


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--part", choices=("forward", "backward", "both"),
                        default="both")
    part = parser.parse_args().part
    if not torch.cuda.is_available():
        raise SystemExit("roi_align_ablation: no CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    fwd = ABLATIONS if part != "backward" else ()
    bwd = BWD_ABLATIONS if part != "forward" else ()
    libs = build(fwd + bwd)
    print(card)
    result = {"card": card}
    if fwd:
        result["rows"] = forward(card, {n: libs[n] for n, _ in fwd})
    if bwd:
        result["backward_rows"] = backward(card, {n: libs[n] for n, _ in bwd})
    print(json.dumps(result))


if __name__ == "__main__":
    main()
