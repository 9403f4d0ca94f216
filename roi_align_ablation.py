#!/usr/bin/env python3
"""What bounds the RoIAlign kernels: their time with one part taken out.

    python3 roi_align_ablation.py [--part forward|backward|both|rois]

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

The roi-coordinate kernel (`--part rois`, not part of "both"), at phase
11 (a)'s shapes and inputs (chip_smoke.rois_backward_inputs) and on the
two launches of one P2BNet and one SSD-Det train step from the seeded
weights (chip_smoke.step_launches), timed in turns with its first
version, the simple form it replaced (FIRST_ROIS: its text, put into the
copy beside the kernel and bound to the entry point in its place), CUDA
events round ITERS calls, order rois_first, rois_kernel, the parts,
rois_kernel, rois_first. The parts, each changing one thing of the design
and none its result:

- rois_no_stage: every roi reads its cells from the map (the global
  path; the upstream gradient is still staged);
- rois_stage_all: every grid that fits is staged, however few times its
  bins read its cells (kRoisMinReuse 0 in place of 2);
- rois_budget_40k, rois_budget_55k: more shared memory a block (40 or 55
  KB in place of 32: larger cell buffers, less of the SM's 256 KB left to
  L1);
- rois_no_overlap: each stage waits for its own copies and the next
  stage's before it computes, so no copy overlaps the gather;
- rois_no_fma: each multiply-add rounded twice (__fmul_rn, __fadd_rn);
- rois_no_merge: a bin's repeated taps are not merged: each in-map tap of
  its samples is read and weighted on its own.

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
# the roi-coordinate kernel's first version, put into the copy
# "rois_first" in a namespace of its own inside the source's anonymous
# namespace (its names shadow the kernel's there), with a C entry point of
# the kernel's arguments (it counts no paths) in place of the kernel's
FIRST_ROIS = r"""
// One sample coordinate along one axis, for the roi-coordinate gradient:
// its taps as the forward's (`axis_tap`: i0 with kOutside, i1, w0, w1),
// and what carries a gradient of the sample's value with respect to the
// clamped coordinate to the roi's two edges on this axis, in level units:
// d1 = clip' * (1 - f) for x1 (or y1) and d2 = clip' * f for x2 (or y2),
// with f = frac / S * max'(x2 - x1) the coordinate's share of the width.
// clip' is jnp.clip's gradient (maximum with 0, then minimum with
// dim - 1, each 1 strictly inside, 0.5 on the bound, 0 beyond), max' that
// of the unaligned width's maximum with 1 (1 when aligned).
struct RoiTap {
  int i0, i1;
  float w0, w1;
  float d1, d2;
};

__device__ __forceinline__ float tie_grad(bool above, bool at) {
  return above ? 1.0f : at ? 0.5f : 0.0f;
}

// The roi's RoiTap table, ty[i] and tx[i] for 0 <= i < S * sr, filled by
// the block's threads (the caller synchronises): `sample_table`'s taps,
// computed by the same functions, and the chain factors.
__device__ __forceinline__ void roi_tap_table(const Levels& lv,
                                              const float* roi, int l,
                                              int out_size, int sr,
                                              int aligned, RoiTap* ty,
                                              RoiTap* tx) {
  const int s = out_size * sr;
  const float hf = static_cast<float>(lv.h[l]);
  const float wf = static_cast<float>(lv.w[l]);
  const float scale = __fdiv_rn(1.0f, lv.stride[l]);
  const float offset = aligned ? 0.5f : 0.0f;
  const float x1 = __fsub_rn(__fmul_rn(roi[1], scale), offset);
  const float y1 = __fsub_rn(__fmul_rn(roi[2], scale), offset);
  const float x2 = __fsub_rn(__fmul_rn(roi[3], scale), offset);
  const float y2 = __fsub_rn(__fmul_rn(roi[4], scale), offset);
  float roi_w = __fsub_rn(x2, x1);
  float roi_h = __fsub_rn(y2, y1);
  float dw = 1.0f;
  float dh = 1.0f;
  if (!aligned) {
    dw = tie_grad(roi_w > 1.0f, roi_w == 1.0f);
    dh = tie_grad(roi_h > 1.0f, roi_h == 1.0f);
    roi_w = fmaxf(roi_w, 1.0f);
    roi_h = fmaxf(roi_h, 1.0f);
  }
  const float inv_out = __fdiv_rn(1.0f, static_cast<float>(out_size));
  const float inv_sr = __fdiv_rn(1.0f, static_cast<float>(sr));
  const float bin_w = __fmul_rn(roi_w, inv_out);
  const float bin_h = __fmul_rn(roi_h, inv_out);
  for (int t = threadIdx.x; t < 2 * s; t += kThreads) {
    const bool is_y = t < s;
    const int k = is_y ? t : t - s;
    const float bin = is_y ? bin_h : bin_w;
    const float start = is_y ? y1 : x1;
    const float dimf = is_y ? hf : wf;
    const float dm1 = __fsub_rn(dimf, 1.0f);
    const Tap a = axis_tap(k, sr, inv_sr, bin, start, dimf, dm1);
    const float frac = sample_frac(k, sr, inv_sr);
    const float g = fused_madd(frac, bin, start);
    const float lo = fmaxf(g, 0.0f);
    const float clip = __fmul_rn(tie_grad(g > 0.0f, g == 0.0f),
                                 tie_grad(lo < dm1, lo == dm1));
    const float f = __fmul_rn(__fmul_rn(frac, inv_out), is_y ? dh : dw);
    (is_y ? ty : tx)[k] = RoiTap{a.i0, a.i1, a.w0, a.w1,
                                 __fmul_rn(clip, __fsub_rn(1.0f, f)),
                                 __fmul_rn(clip, f)};
  }
}

// 4 channels of a map cell (n of them exist; with kVec a 16-byte load)
template <bool kVec>
__device__ __forceinline__ float4 load_cell(const float* p, int n) {
  if constexpr (kVec) {
    return __ldg(reinterpret_cast<const float4*>(p));
  } else {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = j < n ? __ldg(p + j) : 0.0f;
    return make_float4(v[0], v[1], v[2], v[3]);
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(a.x, b.x),
                                       __fmul_rn(a.y, b.y)),
                             __fmul_rn(a.z, b.z)),
                   __fmul_rn(a.w, b.w));
}

// wa * (hi_a - lo_a) + wb * (hi_b - lo_b), channel by channel: the
// derivative of a bilinear sample along one axis
__device__ __forceinline__ float4 axis_diff(float wa, float4 lo_a,
                                            float4 hi_a, float wb,
                                            float4 lo_b, float4 hi_b) {
  return f4_add(f4_scale(make_float4(__fsub_rn(hi_a.x, lo_a.x),
                                     __fsub_rn(hi_a.y, lo_a.y),
                                     __fsub_rn(hi_a.z, lo_a.z),
                                     __fsub_rn(hi_a.w, lo_a.w)), wa),
                f4_scale(make_float4(__fsub_rn(hi_b.x, lo_b.x),
                                     __fsub_rn(hi_b.y, lo_b.y),
                                     __fsub_rn(hi_b.z, lo_b.z),
                                     __fsub_rn(hi_b.w, lo_b.w)), wb));
}

// shared memory of the roi-coordinate kernel: the staged chunk of cw
// channels of every bin (rows of cw + 4 floats) and the two tap tables
__host__ __device__ __forceinline__ size_t rois_bwd_smem(int out_size,
                                                         int sr, int cw) {
  return static_cast<size_t>(out_size) * out_size * (cw + 4) * sizeof(float)
         + 2 * static_cast<size_t>(out_size) * sr * sizeof(RoiTap);
}

// Block r: the gradient of roi r's RoIAlign output with respect to its
// coordinates, grad_rois[r] = (x1, y1, x2, y2). For every in-map sample
// (iy, ix) and channel c, with g the upstream gradient of the sample's bin
// times 1 / sr^2 and v00..v11 its four taps:
//   d/dx = g (wy0 (v01 - v00) + wy1 (v11 - v10)),
//   d/dy = g (wx0 (v10 - v00) + wx1 (v11 - v01)),
// carried to the edges by the samples' RoiTap factors and, at the end, by
// 1 / stride. A thread owns (sample, 4 channels) units of a chunk of cw
// channels, the chunk's upstream gradient staged in shared memory as
// (bin, channel); it keeps four partial sums, and one block reduction in a
// fixed order gives the four values: no atomics. A roi whose batch index
// or level is out of range gets zeros.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
roi_align_rois_backward_kernel(const Levels lv, int channels,
                               const float* __restrict__ rois,
                               const int* __restrict__ lvls, int out_size,
                               int sr, int aligned, int cw,
                               const float* __restrict__ grad_out,
                               float* __restrict__ grad_rois) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float partial[4][kThreads / 32];
  const int s = out_size * sr;
  const int bins = out_size * out_size;
  const int ld = cw + 4;
  float* gs = smem;                                    // bins rows of ld
  RoiTap* ty = reinterpret_cast<RoiTap*>(gs + bins * ld);
  RoiTap* tx = ty + s;

  const size_t r = blockIdx.x;
  const float* roi = rois + r * 5;
  const int l = lvls[r];
  if (!valid_roi(lv, roi, l)) {
    if (threadIdx.x < 4) grad_rois[r * 4 + threadIdx.x] = 0.0f;
    return;
  }
  roi_tap_table(lv, roi, l, out_size, sr, aligned, ty, tx);
  const int hl = lv.h[l];
  const int wl = lv.w[l];
  const size_t cs = static_cast<size_t>(channels);
  const float* feat = lv.feat[l] + static_cast<size_t>(roi[0]) * hl * wl * cs;
  const float* src = grad_out + r * cs * bins;          // the roi's (C, S, S)
  const float inv_count = bin_scale(sr);
  const int groups = cw / 4;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};             // x1, y1, x2, y2

  for (int c0 = 0; c0 < channels; c0 += cw) {
    const int width = min(cw, channels - c0);
    __syncthreads();       // the tables are built, the last chunk is done
    for (int i = threadIdx.x; i < cw * bins; i += kThreads) {
      const int c = i / bins;
      const int bin = i - c * bins;
      gs[bin * ld + c] =
          c < width ? __fmul_rn(__ldg(src + (c0 + c) * bins + bin), inv_count)
                    : 0.0f;
    }
    __syncthreads();
    for (int u = threadIdx.x; u < s * s * groups; u += kThreads) {
      const int g4 = u % groups;
      const int k = u / groups;
      const int c = 4 * g4;
      if (c >= width) continue;
      const int iy = k / s;
      const int ix = k - iy * s;
      const RoiTap ay = ty[iy];
      const RoiTap ax = tx[ix];
      if ((ay.i0 | ax.i0) & kOutside) continue;        // outside: no gradient
      const float4 g = *reinterpret_cast<const float4*>(
          gs + ((iy / sr) * out_size + ix / sr) * ld + c);
      const float* base = feat + c0 + c;
      const int n = width - c;
      const float4 v00 = load_cell<kVec>(base + (static_cast<size_t>(ay.i0) *
                                                 wl + ax.i0) * cs, n);
      const float4 v01 = load_cell<kVec>(base + (static_cast<size_t>(ay.i0) *
                                                 wl + ax.i1) * cs, n);
      const float4 v10 = load_cell<kVec>(base + (static_cast<size_t>(ay.i1) *
                                                 wl + ax.i0) * cs, n);
      const float4 v11 = load_cell<kVec>(base + (static_cast<size_t>(ay.i1) *
                                                 wl + ax.i1) * cs, n);
      const float dx = dot4(g, axis_diff(ay.w0, v00, v01, ay.w1, v10, v11));
      const float dy = dot4(g, axis_diff(ax.w0, v00, v10, ax.w1, v01, v11));
      acc[0] = __fadd_rn(acc[0], __fmul_rn(dx, ax.d1));
      acc[1] = __fadd_rn(acc[1], __fmul_rn(dy, ay.d1));
      acc[2] = __fadd_rn(acc[2], __fmul_rn(dx, ax.d2));
      acc[3] = __fadd_rn(acc[3], __fmul_rn(dy, ay.d2));
    }
  }
  // the block's sum, in a fixed order: each warp by shuffles, then warp 0
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float v = acc[j];
    for (int off = 16; off > 0; off >>= 1) {
      v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
    }
    if (lane == 0) partial[j][warp] = v;
  }
  __syncthreads();
  if (warp == 0) {
    const float scale = __fdiv_rn(1.0f, lv.stride[l]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = lane < kThreads / 32 ? partial[j][lane] : 0.0f;
      for (int off = 16; off > 0; off >>= 1) {
        v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
      }
      if (lane == 0) grad_rois[r * 4 + j] = __fmul_rn(v, scale);
    }
  }
}

// the chunk width: the widest of 256, 128, ..., 4 channels (no wider than
// C rounded up to 4) whose staged gradient and tables fit the 48 KB of
// static shared memory (with the reduction's 128 bytes), 0 if none does
// (S > 38)
int rois_bwd_chunk(int channels, int out_size, int sr) {
  const int c4 = (channels + 3) / 4 * 4;
  for (int cw = 256; cw >= 4; cw /= 2) {
    if (cw > c4 && cw > 4) continue;
    if (rois_bwd_smem(out_size, sr, cw) + 4 * (kThreads / 32) * 4 <=
        48 * 1024) {
      return cw;
    }
  }
  return 0;
}
"""
FIRST_ENTRY = r"""
extern "C" int ptb_roi_align_rois_backward(
    const void* grad_out, const void* const* feats, const int* heights,
    const int* widths, const float* strides, int n_levels, int batch,
    int channels, const void* rois, const void* lvls, int n_rois,
    int out_size, int sampling_ratio, int aligned, void* grad_rois,
    void*, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || out_size < 1 ||
      sampling_ratio < 1 || channels < 1 || n_rois < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cw = first_form::rois_bwd_chunk(channels, out_size,
                                            sampling_ratio);
  if (cw == 0) return static_cast<int>(cudaErrorInvalidValue);
  Levels lv;
  lv.n = n_levels;
  lv.batch = batch;
  bool vec = channels % 4 == 0;
  for (int l = 0; l < n_levels; ++l) {
    lv.feat[l] = static_cast<const float*>(feats[l]);
    lv.h[l] = heights[l];
    lv.w[l] = widths[l];
    lv.stride[l] = strides[l];
    vec = vec && reinterpret_cast<size_t>(feats[l]) % 16 == 0;
  }
  const auto* g = static_cast<const float*>(grad_out);
  const auto* r = static_cast<const float*>(rois);
  const auto* lv_idx = static_cast<const int*>(lvls);
  auto* out = static_cast<float*>(grad_rois);
  auto st = static_cast<cudaStream_t>(stream);
  const size_t smem = first_form::rois_bwd_smem(out_size, sampling_ratio,
                                                cw);
  if (vec) {
    first_form::roi_align_rois_backward_kernel<true>
        <<<static_cast<unsigned>(n_rois), kThreads, smem, st>>>(
            lv, channels, r, lv_idx, out_size, sampling_ratio, aligned, cw, g,
            out);
  } else {
    first_form::roi_align_rois_backward_kernel<false>
        <<<static_cast<unsigned>(n_rois), kThreads, smem, st>>>(
            lv, channels, r, lv_idx, out_size, sampling_ratio, aligned, cw, g,
            out);
  }
  return static_cast<int>(cudaGetLastError());
}
"""
ROIS_ABLATIONS = (
    ("rois_kernel", []),
    ("rois_first", [("}  // namespace\n",
                    "namespace first_form {\n" + FIRST_ROIS
                    + "\n}  // namespace first_form\n}  // namespace\n"),
                   ('extern "C" int ptb_roi_align_rois_backward(',
                    'extern "C" int ptb_roi_align_rois_backward_new('),
                   ("                                           g, out, "
                    "counts, st);\n}\n",
                    "                                           g, out, "
                    "counts, st);\n}\n" + FIRST_ENTRY)]),
    ("rois_no_stage", [("  const int cap = gstage ? ",
                        "  const int cap = false ? ")]),
    ("rois_stage_all", [("constexpr int kRoisMinReuse = 2;",
                         "constexpr int kRoisMinReuse = 0;")]),
    ("rois_budget_40k", [("constexpr size_t kRoisBudget = 32 * 1024;",
                          "constexpr size_t kRoisBudget = 40 * 1024;")]),
    ("rois_budget_55k", [("constexpr size_t kRoisBudget = 32 * 1024;",
                          "constexpr size_t kRoisBudget = 55 * 1024;")]),
    ("rois_no_overlap", [("      cp_async_wait<1>();          // stage t "
                          "landed; t + 1 stays in flight",
                          "      cp_async_wait<0>();")]),
    ("rois_no_fma", [("  return __fmaf_rn(a, b, c);",
                      "  return __fadd_rn(__fmul_rn(a, b), c);")]),
    ("rois_no_merge", [("        while (j < n && e[j].cell != cell) ++j;",
                        "        j = n;")]),
)
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


def rois_inputs():
    """(label, feats, rois, lvls, upstream gradient, S, sr): phase 11
    (a)'s, then the roi-coordinate launches of one P2BNet and one SSD-Det
    train step from the seeded weights on two 800x1344 images of 100 gt
    slots, as phase 11 (b) and (d) record them."""
    from pointtinybenchmark_tpu_torch.data.loader import DetCollator
    from pointtinybenchmark_tpu_torch.engine.train import batch_to_device
    from pointtinybenchmark_tpu_torch.utils.config import Config

    yield from smoke.rois_backward_inputs()
    for label, path, kind, seed in (
            ("p2bnet", smoke.P2B_CONFIG, "point", 17),
            ("ssd_det", smoke.SSD_CONFIG, "box", 20)):
        cfg = Config.fromfile(str(path))
        max_gt = int(cfg.loader["max_gt"])
        nk = (dict(cfg.data["train"]["noise_kwargs"]) if kind == "point"
              else None)
        samples = smoke.p2b_samples(np.random.RandomState(seed), 2, nk,
                                    kind=kind, gts=max_gt)
        collate = DetCollator(tuple(cfg.loader["pad_shape"]), max_gt=max_gt)
        batch = batch_to_device(collate(samples), smoke.DEVICE)
        model = smoke.train_model(cfg)
        _, _, calls = smoke.step_launches(model, cfg, batch)
        del model
        for (g, feats, rois, lvls, _, out, sr, *_), _, _ in calls:
            yield (f"{label} step's bags of {rois.shape[0] // (2 * max_gt)}",
                   [f.detach() for f in feats], rois.detach(), lvls,
                   g.detach(), out, sr)


def rois(card, libs):
    """The roi-coordinate kernel, its first version and the parts in
    turns."""
    order = (["rois_first", "rois_kernel"]
             + [n for n in libs if n not in ("rois_first", "rois_kernel")]
             + ["rois_kernel", "rois_first"])
    rows = []
    for label, feats, rois_, lvls, g, out, sr in rois_inputs():
        (bound_ms, _), samples = smoke.rois_backward_bound(feats, rois_,
                                                           lvls, out, sr)
        row = dict(shape=label, R=rois_.shape[0], S=out, sr=sr,
                   bound_ms=bound_ms, in_map_samples=samples)
        for name in dict.fromkeys(order):
            roi_align_cuda._lib = libs[name]
            smoke.compare_rois_backward(g, feats, rois_, lvls, out, sr)
        times = {n: [] for n in libs}
        for name in order:
            roi_align_cuda._lib = libs[name]
            times[name].append(smoke.time_ms(
                lambda: roi_align_cuda.roi_align_rois_backward(
                    g, feats, rois_, lvls, smoke.ROI_STRIDES, out, sr),
                ITERS))
        roi_align_cuda._lib = None
        for name, ts in times.items():
            row[name] = float(np.mean(ts))
            row[name + "_runs"] = ts
        row["speedup"] = row["rois_first"] / row["rois_kernel"]
        rows.append(row)
        print(f"rois {label} R={row['R']} S={out} sr={sr}, ms (mean of "
              f"the turns): " + ", ".join(f"{n} {row[n]:.4f}" for n in libs)
              + f"; first / kernel {row['speedup']:.3f}; bound "
              f"{bound_ms:.4f} [{card}]")
    return rows


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--part", choices=("forward", "backward", "both",
                                           "rois"), default="both")
    part = parser.parse_args().part
    if not torch.cuda.is_available():
        raise SystemExit("roi_align_ablation: no CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    fwd = ABLATIONS if part in ("forward", "both") else ()
    bwd = BWD_ABLATIONS if part in ("backward", "both") else ()
    rbw = ROIS_ABLATIONS if part == "rois" else ()
    libs = build(fwd + bwd + rbw)
    print(card)
    result = {"card": card}
    if fwd:
        result["rows"] = forward(card, {n: libs[n] for n, _ in fwd})
    if bwd:
        result["backward_rows"] = backward(card, {n: libs[n] for n, _ in bwd})
    if rbw:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        result["rois_rows"] = rois(card, {n: libs[n] for n, _ in rbw})
    print(json.dumps(result))


if __name__ == "__main__":
    main()
