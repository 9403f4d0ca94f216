// Multilevel RoIAlign forward and backward on Hopper: mmcv RoIAlign (`aligned`
// or not) with a static sampling ratio, each roi read from its own FPN level.
//
// Replaces the TPU kernel pointtinybenchmark_tpu/ops/roi_align_pallas.py::
// roi_align_multilevel_pallas (_pallas_fwd, _kernel_factory, _prep): one
// window DMA per roi into VMEM, then separable tent-weight matmuls on the
// MXU. It computes the port's plain version, ops/roi_align.py::
// roi_align_multilevel_plain (the operation order of the JAX package's
// ops/roi_align.py::roi_align_multilevel), not the Pallas kernel: that one
// clamps rois wider than its 64x40 window.
//
// Inputs: level maps (B, H_l, W_l, C) f32 in memory (the channels-last
// layout the FPN's cuDNN convolutions already leave them in, so the wrapper's
// permute is free on the main path; an NCHW-contiguous map costs one copy),
// rois (R, 5) f32 (batch index, x1, y1, x2, y2 in image coordinates), levels
// (R,) int32. Output (R, C, S, S) f32: mmdet's order, so the first FC of the
// bbox head flattens it as (c, h, w). A roi whose batch index or level is out
// of range reads nothing and gets NaN: no read outside the maps.
//
// What bounds it on this card: bytes. At the Faster R-CNN shape (R = 24,000,
// S = 7, sr = 1, C = 256) the output is 1.20 GB to write, ~0.36 ms at
// 3.35 TB/s, and the distinct cells the taps touch add ~0.3 GB; the
// arithmetic is 8 * sr^2 flops per output value, far below the f32 rate.
// The first version (one block per roi, four dependent 128-byte loads per
// sample straight from L2, 4-byte stores) ran at a quarter of that. This
// one:
//
// 1. Stages the taps in shared memory, with 16-byte cp.async, as a grid of
//    cells x channels. Along each axis the grid is the roi's window (every
//    cell between its lowest and highest tap, clamped as the taps are: the
//    Pallas kernel's `_prep.axis` extent) or its slots (the two taps of
//    each of the s = S * sr samples), whichever is shorter: a TinyPerson
//    roi spans 3-15 cells and takes its window; a roi whose bins are wider
//    than a cell reads only the cells its taps use. A grid over the block's
//    budget (`cap` cells of 32 channels) is cut into bands of output rows;
//    one output row needs at most 2 sr x 2 s cells, which the budget holds
//    at S = 7 and S = 14, so every roi of the main paths is staged. A roi
//    that does not fit even so reads its taps from global memory, with the
//    same arithmetic.
// 2. Overlaps loads with compute: a stage is one band of one 32-channel
//    chunk or, for a small grid, several chunks at once (up to half of the
//    block's chunks, so that two stages alternate). Stage t + 1's cp.async
//    group is in flight while stage t computes; the output tile is
//    double-buffered. A block holds ~63 KB at S = 7 (three per SM) and
//    ~112 KB at S = 14, sr = 2 (two), and the blocks of an SM interleave
//    each other's prologue (the sample table: 2s entries by 2s threads).
// 3. Uses wide accesses: a thread computes 4 channels of one bin, one
//    16-byte shared read per tap; the (32 x S*S) chunk of the output goes
//    through a shared tile (row length odd, so the transposing writes hit
//    distinct banks) and out as 16-byte streaming stores (`__stcs`,
//    evict-first), so the output stream does not push the maps out of L2.
// 4. Fills the card at small R: under ~16 blocks per SM the launch splits
//    each roi's chunks over several blocks (R = 1,200: 2 blocks per roi).
//
// Rounding: the result must equal the plain PyTorch version bit for bit, so
// every operation is written with the round-to-nearest intrinsics in the
// plain version's order (divisions by S, sr and sr^2 are multiplications by
// their float32 reciprocals, the sample coordinate is one fused
// multiply-add, as XLA compiles the JAX code; the four taps summed in order,
// then the sr x sr samples in row-major order), and the library is built
// with -fmad=false (no other FMA contraction) and without --use_fast_math.
// Where the taps come from changes nothing in that order.
//
// The backward (roi_align_backward_kernel) replaces the custom_vjp backward
// of the TPU kernel, roi_align_pallas.py::_vjp_bwd: the VJP of the XLA
// gather form with respect to the level maps (rois and levels get none).
// Each sample's upstream gradient, times the float32 1/sr^2, times each of
// its four tap weights, is added at that tap of the roi's level, in a
// zeroed channels-last (B, H_l, W_l, C) gradient per level. The taps come
// from the forward's own sample table (`sample_table`), so they are the
// forward's bit for bit; each added value is the plain version's autograd
// term, (g * (1/sr^2)) * (wy * wx), rounded alike. Only the order of the
// sums differs: rois add to shared cells by float atomics in no fixed
// order, so the result is not bit-exact.
//
// What bounds it on this card: bytes, in principle (the upstream gradient
// read and the level gradients written once, at S = 7 sr = 1 ~8 operations
// per upstream value). The first version sent every tap of every sample to
// global memory as its own scalar atomicAdd (4 S^2 sr^2 per roi and
// channel), most of them onto the same few cells of a small roi, and ran at
// 6-14% of the bound. This one is the transpose of the forward:
//
// 1. Once per block, the roi's sample table and, per axis, the forward's
//    grid (`axis_map`: the roi's window of cells or its tap slots,
//    whichever is shorter), each sample's taps as grid cells, and for each
//    grid cell the samples that touch it (a contiguous run: taps are
//    monotone in the sample index).
// 2. Gather: a thread owns (grid cell, 4 channels) for each chunk of its
//    stage and sums, in a fixed order, the terms of the samples that touch
//    its cell; the sums stay in registers (no shared-memory grid, so no roi
//    needs bands and there are no shared atomics), and go to the level
//    gradient once:
// 3. one 16-byte vector atomic (`atomicAdd(float4*, float4)`, sm_90's
//    red.global.add.v4.f32) for 4 channels when C % 4 == 0 and the buffers
//    are 16-byte aligned (chosen per launch, as the forward's kVec), else a
//    scalar atomic a channel. Cells no in-map sample touches are skipped.
// 4. The upstream gradient of a stage (up to 4 chunks of 32 channels at
//    S = 7, one at S = 14: one contiguous run of the (R, C, S, S) input)
//    is copied to shared memory with cp.async while the tables are built,
//    then transposed to (bin, channel) and scaled by 1/sr^2 there, so that
//    a thread reads 4 channels of a bin as one 16-byte load. A launch where
//    two copies of one chunk and the tables do not fit the block's budget
//    (kBlockBudget: from S = 21 at sr = 1, S = 20 at sr >= 5) reads the
//    upstream gradient from global memory instead, a chunk a block (the
//    global path).
// 5. Blocks: one per stage of a roi (R = 512 at S = 7: 2 blocks of 4
//    chunks a roi; at S = 14: 8 of one), and a block holds exactly one
//    stage. Measured on the H100 (roi_align_ablation.py, its
//    bwd_one_block_per_roi and bwd_block_per_chunk copies): one block per
//    roi walking its stages, the next stage's copy in flight during this
//    one's gather, is slower at every shape (most at S = 14, where 256
//    rois then fill only 256 blocks); a block per chunk is slower at S = 7
//    (the tables built 8 times a roi).
// What bounds it now (same ablation): at S = 14 sr = 2 the gather (the
// flush adds nothing measurable); at S = 7 sr = 1 the gather and the
// flush, a third of the time (scalar atomics would double it).
// A roi whose batch index or level is out of range writes nothing.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;
constexpr int kChunk = 32;            // channels per staged chunk
constexpr int kGroups = kChunk / 4;   // 4-channel groups in a chunk
// shared memory a block aims at: two blocks fit the SM's 228 KB
constexpr size_t kBlockBudget = 112 * 1024;
// blocks the launch aims at before it splits rois over channel groups
constexpr int kBlocksPerSm = 16;
constexpr int kOutside = static_cast<int>(0x80000000u);   // Tap::i0 flag
constexpr int kCell = 0x7fffffff;

// the path of a roi, and the index of its count
enum Path { kWhole = 0, kBands = 1, kGlobal = 2, kInvalid = 3 };

struct Levels {
  const float* feat[kMaxLevels];     // (B, H, W, C) contiguous
  int h[kMaxLevels];
  int w[kMaxLevels];
  float stride[kMaxLevels];
  int n;                             // levels in use
  int batch;                         // B
};

// one sample coordinate along one axis: its two tap cells (map row or
// column; i0 | kOutside when the coordinate is outside [-1, dim]) and
// their weights
struct __align__(16) Tap {
  int i0, i1;
  float w0, w1;
};

// (k // sr) + ((k % sr) + 0.5) * (1 / sr): the offset of sample k, in bins
__device__ __forceinline__ float sample_frac(int k, int sr, float inv_sr) {
  return __fadd_rn(static_cast<float>(k / sr),
                   __fmul_rn(__fadd_rn(static_cast<float>(k % sr), 0.5f),
                             inv_sr));
}

// a * b + c as the plain version's _fused_madd computes it: the float64
// product of two floats is exact, one float64 add, then one float rounding
__device__ __forceinline__ float fused_madd(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn(static_cast<double>(a), static_cast<double>(b)),
                static_cast<double>(c)));
}

// sample k along one axis, in the plain version's operations
__device__ __forceinline__ Tap axis_tap(int k, int sr, float inv_sr,
                                        float bin, float start, float dimf,
                                        float dm1) {
  const float g = fused_madd(sample_frac(k, sr, inv_sr), bin, start);
  const float c = fminf(fmaxf(g, 0.0f), dm1);
  const float f = floorf(c);
  Tap t;
  t.i0 = static_cast<int>(f);
  if (!(g >= -1.0f && g <= dimf)) t.i0 |= kOutside;
  t.i1 = static_cast<int>(fminf(__fadd_rn(f, 1.0f), dm1));
  t.w1 = __fsub_rn(c, f);
  t.w0 = __fsub_rn(1.0f, t.w1);
  return t;
}

// false for a roi whose level or batch index is out of range (or NaN)
__device__ __forceinline__ bool valid_roi(const Levels& lv, const float* roi,
                                          int l) {
  return l >= 0 && l < lv.n && roi[0] >= 0.0f && roi[0] < lv.batch;
}

// 1 / sr^2 in float32, by which the sr x sr samples of a bin are averaged
__device__ __forceinline__ float bin_scale(int sr) {
  return __fdiv_rn(1.0f, static_cast<float>(sr * sr));
}

// The roi's sample table: ty[i] and tx[i], the map taps and weights of
// sample i (0 <= i < S * sr) along y and along x on level l, filled by the
// block's threads (the caller synchronises). The forward and the backward
// both take their taps from here.
__device__ __forceinline__ void sample_table(const Levels& lv,
                                             const float* roi, int l,
                                             int out_size, int sr,
                                             int aligned, Tap* ty, Tap* tx) {
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
  if (!aligned) {
    roi_w = fmaxf(roi_w, 1.0f);
    roi_h = fmaxf(roi_h, 1.0f);
  }
  // the plain version multiplies by float32 reciprocals (see its note);
  // 1.0f / n rounded equals the rounded double 1.0 / n for every n < 1e5
  const float inv_out = __fdiv_rn(1.0f, static_cast<float>(out_size));
  const float inv_sr = __fdiv_rn(1.0f, static_cast<float>(sr));
  const float bin_w = __fmul_rn(roi_w, inv_out);
  const float bin_h = __fmul_rn(roi_h, inv_out);
  for (int t = threadIdx.x; t < 2 * s; t += kThreads) {
    if (t < s) {
      ty[t] = axis_tap(t, sr, inv_sr, bin_h, y1, hf, __fsub_rn(hf, 1.0f));
    } else {
      tx[t - s] = axis_tap(t - s, sr, inv_sr, bin_w, x1, wf,
                           __fsub_rn(wf, 1.0f));
    }
  }
}

// How the taps of samples first..last along one axis index the staged grid:
// the window (grid cell j is map cell lo + j) or, if shorter, the slots
// (cells 2 (i - first) and 2 (i - first) + 1 are sample i's two taps, lo is
// -1). A sample coordinate is a rounded, hence monotone, function of its
// offset (increasing, or decreasing for an inverted roi), and so are the
// clamp, floor and upper tap: the extreme taps are the first's and the
// last's.
struct AxisMap {
  int first;
  int lo;
  int n;     // grid cells along the axis
};

__device__ __forceinline__ AxisMap axis_map(const Tap* t, int first,
                                            int last) {
  const Tap a = t[first];
  const Tap b = t[last];
  const int lo = min(a.i0 & kCell, b.i0 & kCell);
  const int window = max(a.i1, b.i1) - lo + 1;
  const int slots = 2 * (last - first + 1);
  return window <= slots ? AxisMap{first, lo, window}
                         : AxisMap{first, -1, slots};
}

// the rows of band `band` of bh output rows
__device__ __forceinline__ AxisMap band_map(const Tap* ty, int band, int bh,
                                            int out_size, int sr) {
  return axis_map(ty, band * bh * sr, min(out_size, (band + 1) * bh) * sr - 1);
}

// the map row (or column) of grid cell j
__device__ __forceinline__ int grid_source(const Tap* t, const AxisMap& m,
                                           int j) {
  if (m.lo >= 0) return m.lo + j;
  const Tap a = t[m.first + (j >> 1)];
  return (j & 1) ? a.i1 : a.i0 & kCell;
}

__host__ __device__ __forceinline__ int tile_ld(int bins) { return bins | 1; }

// shared memory besides the staged cells: two output tiles and, for both
// axes, the sample table and its grid form
__host__ __device__ __forceinline__ size_t fixed_smem(int out_size, int sr) {
  return 2 * kChunk * tile_ld(out_size * out_size) * sizeof(float)
         + 4 * out_size * sr * sizeof(Tap);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ float4 f4_scale(float4 a, float s) {
  return make_float4(__fmul_rn(a.x, s), __fmul_rn(a.y, s), __fmul_rn(a.z, s),
                     __fmul_rn(a.w, s));
}

__device__ __forceinline__ float4 f4_add(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// ((v00 * w00 + v01 * w01) + v10 * w10) + v11 * w11, the plain order
__device__ __forceinline__ float4 bilerp(float4 v00, float4 v01, float4 v10,
                                         float4 v11, float w00, float w01,
                                         float w10, float w11) {
  return f4_add(f4_add(f4_add(f4_scale(v00, w00), f4_scale(v01, w01)),
                       f4_scale(v10, w10)),
                f4_scale(v11, w11));
}

// 4 channels of a cell: from a staged chunk (cells of kChunk floats)
struct SharedCells {
  const float4* cells;
  __device__ __forceinline__ float4 operator()(int cell, int g) const {
    return cells[cell * kGroups + g];
  }
};

// 4 channels of a cell straight from the map (the global path); with
// kVec the map rows are 16-byte aligned, else the channels past the chunk's
// width are not read
template <bool kVec>
struct GlobalCells {
  const float* base;   // map of this roi's image, at the chunk's channel
  size_t cs;           // C
  int width;           // channels in the chunk
  __device__ __forceinline__ float4 operator()(int cell, int g) const {
    const float* p = base + cell * cs + 4 * g;
    if constexpr (kVec) {
      return __ldg(reinterpret_cast<const float4*>(p));
    } else {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = 4 * g + j < width ? __ldg(p + j) : 0.0f;
      }
      return make_float4(v[0], v[1], v[2], v[3]);
    }
  }
};

// The output values of rows [oy_begin, oy_end) of one chunk into `tile`
// (kChunk rows of `ld`): thread unit u is 4 channels (group u % kGroups) of
// bin oy_begin * S + u / kGroups. gy, gx: each sample's taps as grid cells
// (rows already times the grid's row length; kOutside on i0 of a sample
// outside the map). kS, kSr: S and sr when known at compile time, else 0.
template <int kS, int kSr, class Cells>
__device__ __forceinline__ void compute_rows(
    const Cells& cells, const Tap* gy, const Tap* gx, int out_size, int sr,
    int oy_begin, int oy_end, float inv_count, int width, float* tile,
    int ld) {
  const int S = kS ? kS : out_size;
  const int SR = kSr ? kSr : sr;
  const int n_units = kGroups * (oy_end - oy_begin) * S;
  for (int u = threadIdx.x; u < n_units; u += kThreads) {
    const int g = u % kGroups;
    if (4 * g >= width) continue;
    const int bin = oy_begin * S + u / kGroups;
    const int oy = bin / S;
    const int ox = bin - oy * S;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll(kSr > 0 ? kSr : 1)
    for (int iy = 0; iy < SR; ++iy) {
      const Tap a = gy[oy * SR + iy];
      const int y0 = a.i0 & kCell;
#pragma unroll(kSr > 0 ? kSr : 1)
      for (int ix = 0; ix < SR; ++ix) {
        const Tap b = gx[ox * SR + ix];
        const int x0 = b.i0 & kCell;
        float4 v = bilerp(cells(y0 + x0, g), cells(y0 + b.i1, g),
                          cells(a.i1 + x0, g), cells(a.i1 + b.i1, g),
                          __fmul_rn(a.w0, b.w0), __fmul_rn(a.w0, b.w1),
                          __fmul_rn(a.w1, b.w0), __fmul_rn(a.w1, b.w1));
        if ((a.i0 | b.i0) < 0) v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        acc = iy == 0 && ix == 0 ? v : f4_add(acc, v);
      }
    }
    acc = f4_scale(acc, inv_count);
    float* t = tile + 4 * g * ld + bin;
    t[0] = acc.x;
    t[ld] = acc.y;
    t[2 * ld] = acc.z;
    t[3 * ld] = acc.w;
  }
}

// the staged tile (width rows of ld, bins used) to its contiguous run of
// the output, with streaming stores
template <bool kVec>
__device__ __forceinline__ void store_chunk(const float* tile, int ld,
                                            int bins, int width, float* out) {
  const int n = width * bins;
  if (kVec && ld == bins) {          // the tile is the run itself
    const float4* t4 = reinterpret_cast<const float4*>(tile);
    for (int i = threadIdx.x; i < n / 4; i += kThreads) {
      __stcs(reinterpret_cast<float4*>(out) + i, t4[i]);
    }
  } else if (kVec) {
    for (int i = threadIdx.x; i < n / 4; i += kThreads) {
      int c = 4 * i / bins;
      int b = 4 * i - c * bins;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = tile[c * ld + b];
        if (++b == bins) {
          b = 0;
          ++c;
        }
      }
      __stcs(reinterpret_cast<float4*>(out) + i,
             make_float4(v[0], v[1], v[2], v[3]));
    }
  } else {
    for (int k = threadIdx.x; k < n; k += kThreads) {
      const int c = k / bins;
      __stcs(out + k, tile[c * ld + (k - c * bins)]);
    }
  }
}

// Block (roi r, channel group grp): the chunks [k_begin, k_end) of roi r.
// kVec: C % 4 == 0 and 16-byte aligned maps (16-byte copies and stores).
// The two main shapes run 3 (S = 7) and 2 (S = 14) blocks per SM, which
// their registers allow; the generic form asks for one, and spills nothing.
template <bool kVec, int kS, int kSr>
__global__ void __launch_bounds__(kThreads, kS == 0 ? 1 : 3)
roi_align_kernel(const Levels lv, int channels, const float* __restrict__ rois,
                 const int* __restrict__ lvls, int out_size, int sr,
                 int aligned, int groups, int cap,
                 float* __restrict__ output, int* __restrict__ path_counts) {
  extern __shared__ __align__(16) float smem[];
  const int s = out_size * sr;
  const int bins = out_size * out_size;
  const int ld = tile_ld(bins);
  float* win = smem;                                      // 2 * cap * kChunk
  float* tiles = win + 2 * cap * kChunk;                  // 2 * kChunk * ld
  Tap* ty = reinterpret_cast<Tap*>(tiles + 2 * kChunk * ld);   // s: map cells
  Tap* tx = ty + s;                                       // s
  Tap* gy = tx + s;                                       // s: grid cells
  Tap* gx = gy + s;                                       // s

  const size_t r = blockIdx.x / groups;
  const int grp = blockIdx.x - static_cast<int>(r) * groups;
  const int n_chunks = (channels + kChunk - 1) / kChunk;
  const int k_begin = grp * n_chunks / groups;
  const int k_end = (grp + 1) * n_chunks / groups;
  const float* roi = rois + r * 5;
  const int l = lvls[r];
  const size_t cs = static_cast<size_t>(channels);
  float* dst = output + r * cs * bins;
  const bool count = path_counts != nullptr && grp == 0 && threadIdx.x == 0;
  if (!valid_roi(lv, roi, l)) {
    const size_t c_end = min(static_cast<size_t>(k_end) * kChunk, cs);
    for (size_t k = static_cast<size_t>(k_begin) * kChunk * bins +
                    threadIdx.x;
         k < c_end * bins; k += kThreads) {
      __stcs(dst + k, __int_as_float(0x7fc00000));   // quiet NaN
    }
    if (count) atomicAdd(path_counts + kInvalid, 1);
    return;
  }
  const int hl = lv.h[l];
  const int wl = lv.w[l];
  sample_table(lv, roi, l, out_size, sr, aligned, ty, tx);
  const float inv_count = bin_scale(sr);
  __syncthreads();

  // The grid: columns once for the roi, rows per band of bh output rows,
  // with bh as large as the budget allows (every thread decides alike).
  const AxisMap mx = axis_map(tx, 0, s - 1);
  int bh = out_size;
  for (; bh > 0; --bh) {
    int rows = 0;
    for (int band = 0; band * bh < out_size; ++band) {
      rows = max(rows, band_map(ty, band, bh, out_size, sr).n);
    }
    if (rows * mx.n <= cap) break;
  }
  const Path path = bh == 0 ? kGlobal : bh == out_size ? kWhole : kBands;
  if (count) atomicAdd(path_counts + path, 1);
  // each sample's taps as cells of the grid (of its band), or of the map
  for (int t = threadIdx.x; t < 2 * s; t += kThreads) {
    const bool is_x = t >= s;
    const int i = is_x ? t - s : t;
    Tap a = is_x ? tx[i] : ty[i];
    const int outside = a.i0 & kOutside;
    const AxisMap m = path == kGlobal ? AxisMap{0, 0, 0}
                      : is_x ? mx
                             : band_map(ty, i / (bh * sr), bh, out_size, sr);
    int c0 = a.i0 & kCell;
    int c1 = a.i1;
    if (m.lo >= 0) {
      c0 -= m.lo;
      c1 -= m.lo;
    } else {
      c0 = 2 * (i - m.first);
      c1 = c0 + 1;
    }
    const int row_len = is_x ? 1 : path == kGlobal ? wl : mx.n;
    a.i0 = c0 * row_len | outside;
    a.i1 = c1 * row_len;
    (is_x ? gx : gy)[i] = a;
  }

  const int b = static_cast<int>(roi[0]);
  const float* base = lv.feat[l] + static_cast<size_t>(b) * hl * wl * cs;
  if (path == kGlobal) {
    __syncthreads();
    for (int k = k_begin; k < k_end; ++k) {
      const int c0 = k * kChunk;
      const int width = min(kChunk, channels - c0);
      float* tile = tiles + ((k - k_begin) & 1) * kChunk * ld;
      compute_rows<kS, kSr>(GlobalCells<kVec>{base + c0, cs, width}, gy, gx,
                            out_size, sr, 0, out_size, inv_count, width, tile,
                            ld);
      __syncthreads();
      store_chunk<kVec>(tile, ld, bins, width,
                        dst + static_cast<size_t>(c0) * bins);
    }
    return;
  }

  // Stage t: band t % nb of the chunks from k_begin + (t / nb) * kc, kc of
  // them in one band (each a plane of the grid's cells), one in bands.
  const int nb = (out_size + bh - 1) / bh;
  const int n_own = k_end - k_begin;
  const int kc = nb > 1 ? 1
                        : max(1, min(cap / (band_map(ty, 0, bh, out_size, sr).n
                                            * mx.n),
                                     (n_own + 1) / 2));
  const int n_stages = (n_own + kc - 1) / kc * nb;
  // a cell's channels go to kLanes threads, each copying kPer floats of
  // every chunk of the stage
  constexpr int kPer = kVec ? 4 : 1;
  constexpr int kLanes = kChunk / kPer;
  auto load = [&](int t) {
    const AxisMap my = band_map(ty, t % nb, bh, out_size, sr);
    const int n_cells = my.n * mx.n;
    const int k = k_begin + t / nb * kc;
    const int nk = min(kc, k_end - k);
    const int q = threadIdx.x % kLanes * kPer;
    float* buf = win + (t & 1) * cap * kChunk + q;
    for (int cell = threadIdx.x / kLanes; cell < n_cells;
         cell += kThreads / kLanes) {
      const int j = cell / mx.n;
      const int row = grid_source(ty, my, j);
      const int col = grid_source(tx, mx, cell - j * mx.n);
      const float* src = base + (static_cast<size_t>(row) * wl + col) * cs +
                         k * kChunk + q;
      for (int p = 0; p < nk && (k + p) * kChunk + q < channels; ++p) {
        float* d = buf + (p * n_cells + cell) * kChunk;
        if constexpr (kVec) {
          cp_async16(d, src + p * kChunk);
        } else {
          cp_async4(d, src + p * kChunk);
        }
      }
    }
  };
  load(0);
  cp_async_commit();
  int tsel = 0;                      // the tile of the chunk in progress
  for (int t = 0; t < n_stages; ++t) {
    if (t + 1 < n_stages) load(t + 1);
    cp_async_commit();
    cp_async_wait<1>();              // this thread's copies of stage t landed
    __syncthreads();                 // and everyone's
    const int band = t % nb;
    const int k = k_begin + t / nb * kc;
    const int plane = band_map(ty, band, bh, out_size, sr).n * mx.n * kChunk;
    const float* buf = win + (t & 1) * cap * kChunk;
    for (int j = 0; j < min(kc, k_end - k); ++j) {
      const int c0 = (k + j) * kChunk;
      const int width = min(kChunk, channels - c0);
      float* tile = tiles + tsel * kChunk * ld;
      compute_rows<kS, kSr>(
          SharedCells{reinterpret_cast<const float4*>(buf + j * plane)}, gy,
          gx, out_size, sr, band * bh, min(out_size, (band + 1) * bh),
          inv_count, width, tile, ld);
      __syncthreads();               // the plane is read, the tile written
      if (band == nb - 1) {
        store_chunk<kVec>(tile, ld, bins, width,
                          dst + static_cast<size_t>(c0) * bins);
        tsel ^= 1;
      }
    }
  }
  cp_async_wait<0>();
}

template <bool kVec, int kS, int kSr>
int launch(const Levels& lv, int channels, const float* rois, const int* lvls,
           int n_rois, int out_size, int sr, int aligned, float* output,
           int* path_counts, cudaStream_t stream) {
  // staged cells (of kChunk channels) a block holds per stage: the slots of
  // a whole roi, as far as the budget allows beside the fixed part
  const size_t fixed = fixed_smem(out_size, sr);
  const long long s = static_cast<long long>(out_size) * sr;
  const long long room = fixed < kBlockBudget
      ? static_cast<long long>((kBlockBudget - fixed) / (2 * kChunk * 4)) : 0;
  const int cap = static_cast<int>(room < 4 * s * s ? room : 4 * s * s);
  const size_t smem = fixed + 2 * static_cast<size_t>(cap) * kChunk * 4;
  auto kernel = roi_align_kernel<kVec, kS, kSr>;
  // above 48 KB the launch opts in; above the card's 227 KB (S > 30: the
  // two output tiles alone) the attribute is refused and so is the launch
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // a roi's chunks split over blocks while R alone is under the target
  const int n_chunks = (channels + kChunk - 1) / kChunk;
  const long long target = static_cast<long long>(kBlocksPerSm) * sms;
  const long long want = (target + n_rois - 1) / n_rois;
  const int groups = static_cast<int>(want < n_chunks ? want : n_chunks);
  kernel<<<static_cast<unsigned>(n_rois) * groups, kThreads, smem, stream>>>(
      lv, channels, rois, lvls, out_size, sr, aligned, groups, cap, output,
      path_counts);
  return static_cast<int>(cudaGetLastError());
}

// the instantiation for these arguments: S and sr of the two main shapes
// (Faster R-CNN's bbox crops, Mask R-CNN's mask crops) known at compile time
template <bool kVec>
int dispatch(const Levels& lv, int channels, const float* rois,
             const int* lvls, int n_rois, int out_size, int sr, int aligned,
             float* output, int* path_counts, cudaStream_t stream) {
  if (out_size == 7 && sr == 1) {
    return launch<kVec, 7, 1>(lv, channels, rois, lvls, n_rois, out_size, sr,
                              aligned, output, path_counts, stream);
  }
  if (out_size == 14 && sr == 2) {
    return launch<kVec, 14, 2>(lv, channels, rois, lvls, n_rois, out_size, sr,
                               aligned, output, path_counts, stream);
  }
  return launch<kVec, 0, 0>(lv, channels, rois, lvls, n_rois, out_size, sr,
                            aligned, output, path_counts, stream);
}

// the level gradients, (B, H, W, C) contiguous each, zeroed by the caller
// (a __grid_constant__ argument: indexed by the roi's level in place, not
// copied to the stack)
struct LevelGrads {
  float* grad[kMaxLevels];
};

// the backward's stage: up to kBwdMaxStage chunks of the upstream gradient,
// as far as two copies of it (as loaded, and transposed) fit kBwdStageBudget
constexpr size_t kBwdStageBudget = 56 * 1024;
constexpr int kBwdMaxStage = 4;

// One sample along one axis, for the backward: the grid cell of its tap 0
// (kOutside set when the sample is outside the map; tap 1 is the next grid
// cell, or in a window the same clamped cell with weight 0), the offset of
// its bin along the axis (oy * S along y, ox along x) and its tap weights.
struct __align__(16) BwdSample {
  int c0;
  int bin;
  float w0, w1;
};

// One grid cell along one axis: its map row or column, and the samples
// k_lo..k_hi whose taps touch it (none when k_lo > k_hi). In a window they
// are those whose tap 0 is the cell or the one before: a contiguous run,
// since taps are monotone in the sample index; in slots, sample j / 2.
struct __align__(16) BwdCell {
  int src;
  int k_lo, k_hi;
  int pad;
};

// 4 channels (group g of chunk p of the stage) of the scaled upstream
// gradient of a bin: staged and transposed, (chunk, bin, kChunk channels)
struct SharedGrad {
  const float4* g;
  int bins;
  __device__ __forceinline__ float4 operator()(int p, int bin, int g4) const {
    return g[(p * bins + bin) * kGroups + g4];
  }
};

// the same read from the (R, C, S, S) input and scaled here (the global
// path, one chunk a stage): src is the chunk's first channel of the roi
struct GlobalGrad {
  const float* src;
  int bins;
  int width;         // channels in the chunk
  float inv_count;
  __device__ __forceinline__ float4 operator()(int, int bin, int g4) const {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 4 * g4 + j;
      v[j] = c < width ? __fmul_rn(__ldg(src + c * bins + bin), inv_count)
                       : 0.0f;
    }
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};

// v added to 4 channels of a cell of the level gradient, n of which exist:
// one 16-byte vector atomic (sm_90) when kVec, else one atomic a channel
template <bool kVec>
__device__ __forceinline__ void flush(float* dst, float4 v, int n) {
  if constexpr (kVec) {
    atomicAdd(reinterpret_cast<float4*>(dst), v);
  } else {
    atomicAdd(dst, v.x);
    if (n > 1) atomicAdd(dst + 1, v.y);
    if (n > 2) atomicAdd(dst + 2, v.z);
    if (n > 3) atomicAdd(dst + 3, v.w);
  }
}

// The gather: thread unit u is (grid cell, 4-channel group), for each of the
// nk chunks of the stage (at most kMaxNk, one accumulator each: the sample
// loads and weights serve all of them; kMaxNk = 1 for stages of one chunk,
// where more accumulators cost time). It sums, over the samples
// whose taps touch its cell along y and along x (a fixed order), the
// sample's scaled upstream gradient times the tap's weight (wy * wx, the
// plain version's product), and adds each chunk's sum to the cell's level
// gradient once. c_first: the stage's first channel.
template <bool kVec, int kMaxNk, class Grad>
__device__ __forceinline__ void gather_flush(
    const Grad& grad, const BwdSample* sy, const BwdSample* sx,
    const BwdCell* cy, const BwdCell* cx, int ny, int nx, int nk,
    int c_first, int channels, float* gmap, int wl) {
  const int n_units = ny * nx * kGroups;
  const size_t cs = static_cast<size_t>(channels);
  for (int u = threadIdx.x; u < n_units; u += kThreads) {
    const int g4 = u % kGroups;
    const int cell = u / kGroups;
    const int j = cell / nx;
    const int i = cell - j * nx;
    const BwdCell ay = cy[j];
    const BwdCell ax = cx[i];
    float4 acc[kMaxNk];
#pragma unroll
    for (int p = 0; p < kMaxNk; ++p) {
      acc[p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    bool any = false;
    for (int ky = ay.k_lo; ky <= ay.k_hi; ++ky) {
      const BwdSample a = sy[ky];
      if (a.c0 < 0) continue;            // outside the map: no gradient
      const float wy = a.c0 == j ? a.w0 : a.w1;
      for (int kx = ax.k_lo; kx <= ax.k_hi; ++kx) {
        const BwdSample b = sx[kx];
        if (b.c0 < 0) continue;
        const float w = __fmul_rn(wy, b.c0 == i ? b.w0 : b.w1);
#pragma unroll
        for (int p = 0; p < kMaxNk; ++p) {
          if (p < nk) {
            acc[p] = f4_add(acc[p], f4_scale(grad(p, a.bin + b.bin, g4), w));
          }
        }
        any = true;
      }
    }
    if (!any) continue;
    float* dst = gmap + (static_cast<size_t>(ay.src) * wl + ax.src) * cs +
                 c_first + 4 * g4;
#pragma unroll
    for (int p = 0; p < kMaxNk; ++p) {
      const int c = c_first + p * kChunk + 4 * g4;
      if (p < nk && c < channels) {
        flush<kVec>(dst + p * kChunk, acc[p], channels - c);
      }
    }
  }
}

// The copy of a stage into buf: the chunks [k, k + nk) of a roi's upstream
// gradient src, one contiguous run, with cp.async (the caller commits the
// group)
template <bool kVec>
__device__ __forceinline__ void copy_stage(float* buf, const float* src,
                                           int k, int nk, int channels,
                                           int bins) {
  const int c_lo = k * kChunk;
  const int c_hi = min((k + nk) * kChunk, channels);
  const float* from = src + static_cast<size_t>(c_lo) * bins;
  const int n = (c_hi - c_lo) * bins;
  if constexpr (kVec) {
    for (int i = threadIdx.x; i < n / 4; i += kThreads) {
      cp_async16(buf + 4 * i, from + 4 * i);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      cp_async4(buf + i, from + i);
    }
  }
}

// A landed stage of nk chunks (width channels), (channel, bin) as loaded
// in buf -> (chunk, bin, channel) in gs, times 1 / sr^2: the plain
// version's gradient of each sample (channels past width are 0)
__device__ __forceinline__ void transpose_stage(float* gs, const float* buf,
                                                int nk, int width, int bins,
                                                float inv_count) {
  for (int i = threadIdx.x; i < nk * kChunk * bins; i += kThreads) {
    const int cc = i % kChunk;
    const int rest = i / kChunk;
    const int p = rest / bins;
    const int c = p * kChunk + cc;
    gs[i] = c < width ? __fmul_rn(buf[c * bins + rest - p * bins], inv_count)
                      : 0.0f;
  }
}

// The gather of a transposed stage (nk chunks from chunk k), kc chunks a
// stage at most
template <bool kVec>
__device__ __forceinline__ void gather_stage(
    const float* gs, int bins, int kc, const BwdSample* sy,
    const BwdSample* sx, const BwdCell* cy, const BwdCell* cx, int ny,
    int nx, int nk, int k, int channels, float* gmap, int wl) {
  const SharedGrad grad{reinterpret_cast<const float4*>(gs), bins};
  if (kc == 1) {
    gather_flush<kVec, 1>(grad, sy, sx, cy, cx, ny, nx, nk, k * kChunk,
                          channels, gmap, wl);
  } else {
    gather_flush<kVec, kBwdMaxStage>(grad, sy, sx, cy, cx, ny, nx, nk,
                                     k * kChunk, channels, gmap, wl);
  }
}

// Block (roi r, stage t): the upstream gradient of the chunks [t kc, t kc +
// kc) of roi r into the level gradient of its level (see the note at the
// top). grad_out is (R, C, S, S) contiguous. staged: the stage is copied to
// shared memory; else it is one chunk, read from global memory.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 4)
roi_align_backward_kernel(const Levels lv,
                          const __grid_constant__ LevelGrads lg,
                          int channels, const float* __restrict__ rois,
                          const int* __restrict__ lvls, int out_size, int sr,
                          int aligned, int stages, int kc, int staged,
                          const float* __restrict__ grad_out,
                          int* __restrict__ path_counts) {
  extern __shared__ __align__(16) float smem[];
  const int s = out_size * sr;
  const int bins = out_size * out_size;
  const int stage = staged ? kc * kChunk * bins : 0;
  float* buf = smem;                                   // stage, as loaded
  float* gs = buf + stage;                             // stage, transposed
  Tap* ty = reinterpret_cast<Tap*>(gs + stage);        // s: map cells
  Tap* tx = ty + s;                                    // s
  BwdSample* sy = reinterpret_cast<BwdSample*>(tx + s);   // s: grid cells
  BwdSample* sx = sy + s;                              // s
  BwdCell* cy = reinterpret_cast<BwdCell*>(sx + s);    // 2 s
  BwdCell* cx = cy + 2 * s;                            // 2 s

  const size_t r = blockIdx.x / stages;
  const int t = blockIdx.x - static_cast<int>(r) * stages;
  const int n_chunks = (channels + kChunk - 1) / kChunk;
  const int k = t * kc;                                // the first chunk
  const int nk = min(kc, n_chunks - k);
  const float* roi = rois + r * 5;
  const int l = lvls[r];
  const bool count = path_counts != nullptr && t == 0 && threadIdx.x == 0;
  if (!valid_roi(lv, roi, l)) {                        // writes nothing
    if (count) atomicAdd(path_counts + kInvalid, 1);
    return;
  }
  if (count) atomicAdd(path_counts + (staged ? kWhole : kGlobal), 1);
  const float* src = grad_out + r * channels * bins;   // the roi's (C, S, S)
  if (staged) copy_stage<kVec>(buf, src, k, nk, channels, bins);
  cp_async_commit();
  // the tables, while the stage is in flight: the forward's taps, its grid
  // per axis (window or slots), each sample's taps as grid cells and each
  // grid cell's samples
  sample_table(lv, roi, l, out_size, sr, aligned, ty, tx);
  __syncthreads();
  const AxisMap my = axis_map(ty, 0, s - 1);
  const AxisMap mx = axis_map(tx, 0, s - 1);
  for (int u = threadIdx.x; u < 2 * s; u += kThreads) {
    const bool is_x = u >= s;
    const int j = is_x ? u - s : u;
    const Tap a = is_x ? tx[j] : ty[j];
    const AxisMap m = is_x ? mx : my;
    const int c0 = m.lo >= 0 ? (a.i0 & kCell) - m.lo : 2 * j;
    (is_x ? sx : sy)[j] = BwdSample{c0 | (a.i0 & kOutside),
                                    is_x ? j / sr : j / sr * out_size,
                                    a.w0, a.w1};
  }
  for (int u = threadIdx.x; u < my.n + mx.n; u += kThreads) {
    const bool is_x = u >= my.n;
    const int j = is_x ? u - my.n : u;
    const Tap* tp = is_x ? tx : ty;
    const AxisMap m = is_x ? mx : my;
    int k_lo = j >> 1;
    int k_hi = j >> 1;
    if (m.lo >= 0) {
      k_lo = s;
      k_hi = -1;
      for (int q = 0; q < s; ++q) {
        if ((tp[q].i0 & kCell) - m.lo == j || tp[q].i1 - m.lo == j) {
          k_lo = min(k_lo, q);
          k_hi = q;
        }
      }
    }
    (is_x ? cx : cy)[j] = BwdCell{grid_source(tp, m, j), k_lo, k_hi, 0};
  }
  const int hl = lv.h[l];
  const int wl = lv.w[l];
  float* gmap = lg.grad[l] +
                static_cast<size_t>(roi[0]) * hl * wl * channels;
  const float inv_count = bin_scale(sr);

  if (!staged) {
    __syncthreads();
    const int c0 = k * kChunk;
    gather_flush<kVec, 1>(
        GlobalGrad{src + static_cast<size_t>(c0) * bins, bins,
                   min(kChunk, channels - c0), inv_count},
        sy, sx, cy, cx, my.n, mx.n, 1, c0, channels, gmap, wl);
    return;
  }
  cp_async_wait<0>();
  __syncthreads();         // the stage landed, the tables are built
  transpose_stage(gs, buf, nk, min(nk * kChunk, channels - k * kChunk), bins,
                  inv_count);
  __syncthreads();
  gather_stage<kVec>(gs, bins, kc, sy, sx, cy, cx, my.n, mx.n, nk, k,
                     channels, gmap, wl);
}

// the backward's launch: chunks a stage, stages a roi (a block each),
// shared memory
template <bool kVec>
int launch_backward(const Levels& lv, const LevelGrads& lg, int channels,
                    const float* rois, const int* lvls, int n_rois,
                    int out_size, int sr, int aligned, const float* grad_out,
                    int* path_counts, cudaStream_t stream) {
  // the upstream gradient is staged when two copies of one chunk (as
  // loaded, and transposed) and the tables fit the block's budget
  // (kBlockBudget: S <= 20 at sr <= 4, not S = 21 at sr = 1), up to
  // kBwdMaxStage chunks a stage as far as kBwdStageBudget allows; else a
  // block reads its one chunk from global memory (the global path)
  const size_t chunk = static_cast<size_t>(kChunk) * out_size * out_size * 4;
  const size_t tables = 8 * static_cast<size_t>(out_size) * sr * sizeof(Tap);
  const bool staged = 2 * chunk + tables <= kBlockBudget;
  const int fit = static_cast<int>(kBwdStageBudget / (2 * chunk));
  const int kc_max = !staged ? 1
                     : fit < 1 ? 1 : fit < kBwdMaxStage ? fit : kBwdMaxStage;
  // the roi's chunks in even stages of at most kc_max
  const int n_chunks = (channels + kChunk - 1) / kChunk;
  const int stages = (n_chunks + kc_max - 1) / kc_max;
  const int kc = (n_chunks + stages - 1) / stages;
  const long long blocks = static_cast<long long>(n_rois) * stages;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (staged ? 2 * static_cast<size_t>(kc) * chunk : 0) +
                      tables;
  auto kernel = roi_align_backward_kernel<kVec>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      lv, lg, channels, rois, lvls, out_size, sr, aligned, stages, kc,
      staged ? 1 : 0, grad_out, path_counts);
  return static_cast<int>(cudaGetLastError());
}

// ---- the gradient with respect to the roi coordinates

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

}  // namespace

// Plain C interface, loaded with ctypes. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launch (or the error
// of a refused argument or attribute). `path_counts`, when not null, is 4
// int32 on the card to which each roi adds one at its path: staged whole,
// staged in bands, global, invalid (the caller zeroes them).
extern "C" int ptb_roi_align(const void* const* feats, const int* heights,
                             const int* widths, const float* strides,
                             int n_levels, int batch, int channels,
                             const void* rois,
                             const void* lvls, int n_rois, int out_size,
                             int sampling_ratio, int aligned, void* output,
                             void* path_counts, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || out_size < 1 ||
      sampling_ratio < 1 || channels < 1 || n_rois < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  const auto* r = static_cast<const float*>(rois);
  const auto* lv_idx = static_cast<const int*>(lvls);
  auto* out = static_cast<float*>(output);
  auto* counts = static_cast<int*>(path_counts);
  auto st = static_cast<cudaStream_t>(stream);
  return vec ? dispatch<true>(lv, channels, r, lv_idx, n_rois, out_size,
                              sampling_ratio, aligned, out, counts, st)
             : dispatch<false>(lv, channels, r, lv_idx, n_rois, out_size,
                               sampling_ratio, aligned, out, counts, st);
}

// Plain C interface of the backward, loaded with ctypes: grad_out (R, C, S,
// S) f32 contiguous into `grads`, one zeroed (B, H_l, W_l, C) f32 buffer per
// level (the caller zeroes them). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launch (or the error
// of a refused argument or attribute). `path_counts`, when not null, is 4
// int32 on the card to which each roi adds one at its path: staged (whole),
// never bands, the upstream gradient read from global memory, invalid.
extern "C" int ptb_roi_align_backward(const void* grad_out,
                                      void* const* grads, const int* heights,
                                      const int* widths, const float* strides,
                                      int n_levels, int batch, int channels,
                                      const void* rois, const void* lvls,
                                      int n_rois, int out_size,
                                      int sampling_ratio, int aligned,
                                      void* path_counts, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || out_size < 1 ||
      sampling_ratio < 1 || channels < 1 || n_rois < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels lv;
  LevelGrads lg;
  lv.n = n_levels;
  lv.batch = batch;
  bool vec = channels % 4 == 0 && reinterpret_cast<size_t>(grad_out) % 16 == 0;
  for (int l = 0; l < n_levels; ++l) {
    lv.feat[l] = nullptr;
    lg.grad[l] = static_cast<float*>(grads[l]);
    lv.h[l] = heights[l];
    lv.w[l] = widths[l];
    lv.stride[l] = strides[l];
    vec = vec && reinterpret_cast<size_t>(grads[l]) % 16 == 0;
  }
  const auto* g = static_cast<const float*>(grad_out);
  const auto* r = static_cast<const float*>(rois);
  const auto* lv_idx = static_cast<const int*>(lvls);
  auto* counts = static_cast<int*>(path_counts);
  auto st = static_cast<cudaStream_t>(stream);
  return vec ? launch_backward<true>(lv, lg, channels, r, lv_idx, n_rois,
                                     out_size, sampling_ratio, aligned, g,
                                     counts, st)
             : launch_backward<false>(lv, lg, channels, r, lv_idx, n_rois,
                                      out_size, sampling_ratio, aligned, g,
                                      counts, st);
}

// Plain C interface of the roi-coordinate gradient, loaded with ctypes:
// grad_out (R, C, S, S) f32 contiguous and the level maps (B, H_l, W_l, C)
// f32 contiguous, as the forward took them, into grad_rois (R, 4) f32, the
// gradients of x1, y1, x2, y2 (every row written). Launches on `stream`,
// does not synchronise, and returns cudaGetLastError() after the launch
// (or the error of a refused argument).
extern "C" int ptb_roi_align_rois_backward(
    const void* grad_out, const void* const* feats, const int* heights,
    const int* widths, const float* strides, int n_levels, int batch,
    int channels, const void* rois, const void* lvls, int n_rois,
    int out_size, int sampling_ratio, int aligned, void* grad_rois,
    void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || out_size < 1 ||
      sampling_ratio < 1 || channels < 1 || n_rois < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cw = rois_bwd_chunk(channels, out_size, sampling_ratio);
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
  const size_t smem = rois_bwd_smem(out_size, sampling_ratio, cw);
  if (vec) {
    roi_align_rois_backward_kernel<true>
        <<<static_cast<unsigned>(n_rois), kThreads, smem, st>>>(
            lv, channels, r, lv_idx, out_size, sampling_ratio, aligned, cw, g,
            out);
  } else {
    roi_align_rois_backward_kernel<false>
        <<<static_cast<unsigned>(n_rois), kThreads, smem, st>>>(
            lv, channels, r, lv_idx, out_size, sampling_ratio, aligned, cw, g,
            out);
  }
  return static_cast<int>(cudaGetLastError());
}
