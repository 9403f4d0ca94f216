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
//
// The roi-coordinate kernel (roi_align_rois_backward_kernel) replaces no
// Pallas kernel: the Pallas custom_vjp gives the rois zeros, and JAX
// differentiates P2BNet's bags through XLA's autodiff of the gather form,
// pointtinybenchmark_tpu/ops/roi_align.py:111 roi_align_multilevel. It
// computes that gradient with respect to each roi's x1, y1, x2, y2: per
// in-map sample, g . (wy0 (v01 - v00) + wy1 (v11 - v10)) along x (and the
// transpose along y), carried to the two edges by the sample's offset, with
// jnp.clip's 0.5 on a clamp bound, then 1 / stride. What bounds it on this
// card: bytes, the upstream gradient read once (0.50 GB at R = 10,000, S =
// 7, C = 256: ~0.15 ms at 3.35 TB/s), the maps' distinct cells the taps
// touch and the (R, 4) output; its arithmetic is far below the f32 rate.
// The first version (one block a roi, a thread per (sample, 4 channels),
// four 16-byte loads of the map per sample from L2, the upstream gradient
// transposed through shared memory with 8-way bank conflicts, every
// multiply-add rounded twice) ran at 11-17% of that bound: P2BNet's padded
// gt slots put 80-85% of a step's rois at the origin, half or more of
// their samples off the map, and small windows repeat their taps ~10x.
// This one (one block a roi, 4 an SM):
//
// 1. Walks each bin's distinct cells, not its samples' taps: per axis the
//    bin's in-map taps are merged by map cell, their weights and chain
//    factors summed (`BinTap`); a sample is in the map when it is along
//    both axes, so the per-axis sums factor. A group of 16 lanes takes a
//    bin and 64 channels, a lane 4 of them: one 16-byte load a cell, q =
//    g . v once per cell, then q times the two axes' factors into the
//    lane's four sums. A small window's bin reads ~4 cells, not 16 taps.
//    A roi with no sample in the map reads nothing; bins, and bin rows
//    of the upstream gradient, with none are skipped.
// 2. Stages, with cp.async in two buffers each, each 64-channel chunk's
//    upstream gradient (its active rows; read in place, lanes on
//    consecutive channels: no transpose, no bank conflict) and, where it
//    pays, the roi's grid of map cells (the forward's `axis_map`: per axis
//    the window or the tap slots, whichever is shorter; in bands of
//    output rows where it exceeds a buffer). Chunk t + 1 is in flight
//    while chunk t computes. The grid is staged only where its bins read
//    its cells kRoisMinReuse times or more; elsewhere (and where even one
//    band does not fit) the cells are read from the map, through L1.
// 3. Rounds each multiply-add once (__fmaf_rn: -fmad=false leaves the
//    intrinsic alone); autograd's chain sums g . v per tap before it
//    weights the taps, and so does this.
// The threads' sums and the block reduction run in a fixed order, with no
// atomics: a launch repeats bit for bit.
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

template <class T>
__device__ __forceinline__ AxisMap axis_map(const T* t, int first, int last) {
  const T a = t[first];
  const T b = t[last];
  const int lo = min(a.i0 & kCell, b.i0 & kCell);
  const int window = max(a.i1, b.i1) - lo + 1;
  const int slots = 2 * (last - first + 1);
  return window <= slots ? AxisMap{first, lo, window}
                         : AxisMap{first, -1, slots};
}

// the rows of band `band` of bh output rows
template <class T>
__device__ __forceinline__ AxisMap band_map(const T* ty, int band, int bh,
                                            int out_size, int sr) {
  return axis_map(ty, band * bh * sr, min(out_size, (band + 1) * bh) * sr - 1);
}

// the map row (or column) of grid cell j
template <class T>
__device__ __forceinline__ int grid_source(const T* t, const AxisMap& m,
                                           int j) {
  if (m.lo >= 0) return m.lo + j;
  const T a = t[m.first + (j >> 1)];
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

// a * b + c, rounded once (-fmad=false leaves the intrinsic alone)
__device__ __forceinline__ float rfma(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

// One distinct cell that the in-map samples of a bin read along one axis,
// and the sums over the taps of those samples that read it: `a` of the
// tap weights (w0 or w1), b1 and b2 of the chain factors d1 and d2 times
// -1 for tap 0 and +1 for tap 1 (the derivative of the tap weights with
// respect to the coordinate). `cell`: the grid row times the grid's row
// length, or the grid column (staged); the map row times W, or the map
// column (global path).
struct __align__(16) BinTap {
  int cell;
  float a, b1, b2;
};

// shared memory of the roi-coordinate kernel besides its two stage
// buffers: the RoiTap tables, and per bin row and column its BinTaps
// (2 sr at most), their first taps' slots and their count
__host__ __device__ __forceinline__ size_t rois_bwd_tables(int out_size,
                                                           int sr) {
  return 2 * static_cast<size_t>(out_size) * sr * sizeof(RoiTap)
         + 2 * static_cast<size_t>(out_size) * 2 * sr
               * (sizeof(BinTap) + sizeof(int))
         + 2 * static_cast<size_t>(out_size) * sizeof(int);
}

// a roi's grid is staged only where its bins read at least this many of
// its cells for each one staged; below that the copy costs more than the
// reads it saves (measured: roi_align_ablation.py --part rois)
constexpr int kRoisMinReuse = 2;

// The gather of one stage (a chunk of `width` <= kc channels) for the
// output rows [oy_begin, oy_end): a group of kc / 4 lanes takes a bin
// (two bins a warp at kc = 64), lane i of it channels 4 i .. 4 i + 3 of
// the chunk (one 16-byte load a cell). For each distinct cell (cy, cx) of
// the bin (the rows `tab` lists for its bin row, times the columns it
// lists for its bin column) a lane takes q = its channels' upstream
// gradient . the cell's, and adds
//   x1: q * Ay(cy) * B1x(cx)   y1: q * B1y(cy) * Ax(cx)
//   x2: q * Ay(cy) * B2x(cx)   y2: q * B2y(cy) * Ax(cx)
// to acc (x1, y1, x2, y2): the sum over the bin's in-map samples s and
// their taps (a, b) of g . v_ab(s) times d(w_a(s) w_b(s)) / d(edge), which
// is the plain version's chain regrouped by cell (a sample is in the map
// when it is along both axes, so the per-axis sums factor). A bin's taps
// repeat where its samples are closer than a cell: each is read once. A
// bin with no in-map sample is skipped. `cells(cell, c)` reads channels
// c .. c + 3 of the chunk (staged, or from the map), `grad(c, bin)` one
// channel's upstream gradient (staged, or from the input). kSr: sr when
// known at compile time (the loops over a bin's entries unrolled), else
// 0.
template <int kSr, class Cells, class Grad>
__device__ __forceinline__ void rois_gather(
    const Cells& cells, const Grad& grad, int kc, int width,
    float inv_count, const BinTap* tab, const int* cnt, int out_size,
    int kt, int oy_begin, int oy_end, float* acc) {
  constexpr int kT = kSr > 0 ? 2 * kSr : 1;
  const int S = out_size;
  const int group = kc / 4;                            // lanes a bin
  const int c = 4 * (threadIdx.x % group);             // the lane's channels
  if (c >= width) return;
  for (int bin = oy_begin * S + threadIdx.x / group; bin < oy_end * S;
       bin += kThreads / group) {
    const int oy = bin / S;
    const int ox = bin - oy * S;
    const BinTap* ey = tab + oy * kt;
    const BinTap* ex = tab + (S + ox) * kt;
    const int ny = cnt[oy];
    const int nx = cnt[S + ox];
    if (ny == 0 || nx == 0) continue;
    float g[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      g[q] = c + q < width ? __fmul_rn(grad(c + q, bin), inv_count) : 0.0f;
    }
#pragma unroll(kSr > 0 ? kT : 1)
    for (int j = 0; j < (kSr > 0 ? kT : ny); ++j) {
      if (kSr > 0 && j >= ny) continue;
      const BinTap ye = ey[j];
      float r1 = 0.0f;
      float r2 = 0.0f;
      float ra = 0.0f;
      auto term = [&](const BinTap& xe) {
        const float4 v = cells(ye.cell + xe.cell, c);
        const float q = rfma(g[3], v.w, rfma(g[2], v.z,
                            rfma(g[1], v.y, __fmul_rn(g[0], v.x))));
        r1 = rfma(q, xe.b1, r1);
        r2 = rfma(q, xe.b2, r2);
        ra = rfma(q, xe.a, ra);
      };
      if constexpr (kSr > 0) {
#pragma unroll
        for (int i = 0; i < kT; ++i) {
          if (i < nx) term(ex[i]);
        }
      } else {
        for (int i = 0; i < nx; ++i) term(ex[i]);
      }
      acc[0] = rfma(ye.a, r1, acc[0]);
      acc[1] = rfma(ye.b1, ra, acc[1]);
      acc[2] = rfma(ye.a, r2, acc[2]);
      acc[3] = rfma(ye.b2, ra, acc[3]);
    }
  }
}

// a stage's staged cells: kc floats a cell (0 past the map's channels)
struct StagedCells {
  const float* cells;
  int kc;
  __device__ __forceinline__ float4 operator()(int cell, int c) const {
    return *reinterpret_cast<const float4*>(cells + cell * kc + c);
  }
};

// the cells from the map: `base` at the chunk's first channel, a cell is
// its map row * W + column; with kVec one 16-byte load, else the channels
// past `width` read as 0
template <bool kVec>
struct MapCells {
  const float* base;
  size_t cs;
  int width;
  __device__ __forceinline__ float4 operator()(int cell, int c) const {
    const float* p = base + cell * cs + c;
    if constexpr (kVec) {
      return __ldg(reinterpret_cast<const float4*>(p));
    } else {
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = c + q < width ? __ldg(p + q) : 0.0f;
      return make_float4(v[0], v[1], v[2], v[3]);
    }
  }
};

// a chunk's upstream gradient as copied: (channel, bin), or the input's
// (C, S, S) at the chunk's first channel
template <bool kLdg>
struct StageGrad {
  const float* g;
  int bins;
  __device__ __forceinline__ float operator()(int c, int bin) const {
    const float* p = g + c * bins + bin;
    return kLdg ? __ldg(p) : *p;
  }
};

// Block r: the gradient of roi r's RoIAlign output with respect to its
// coordinates, grad_rois[r] = (x1, y1, x2, y2), times 1 / stride at the
// end (see the note at the top). A stage is one band of output rows of
// one chunk of kc channels (64, or 32 where two of its gradient buffers
// would not fit): unless the roi takes the global path, the band's grid
// of map cells (kc floats a cell, `cap` cells at most), in one of two
// cell buffers; with a chunk's first band, the chunk's upstream gradient
// of the bin rows that have an in-map sample, in one of two gradient
// buffers (so a chunk's gradient is copied once for all its bands). The
// roi's whole grid when it fits, else bands of as many of those rows as
// fit; a roi whose grid does not fit even in bands of one row reads its
// cells from the map (the global path), its gradient still staged. A roi
// with no sample in the map reads nothing and gets zeros. gstage = 0 (S
// too large for a staged chunk): nothing is staged. The block's threads
// sum in a fixed order, and one block reduction gives the four values: no
// atomics. A roi whose batch index or level is out of range gets zeros.
// `path_counts` as the forward's.
template <bool kVec, int kSr>
__global__ void __launch_bounds__(kThreads, 4)
roi_align_rois_backward_kernel(const Levels lv, int channels,
                               const float* __restrict__ rois,
                               const int* __restrict__ lvls, int out_size,
                               int sr, int aligned, int kc, int cap,
                               int gstage,
                               const float* __restrict__ grad_out,
                               float* __restrict__ grad_rois,
                               int* __restrict__ path_counts) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float partial[4][kThreads / 32];
  const int s = out_size * sr;
  const int bins = out_size * out_size;
  const int kt = 2 * sr;
  const int gsz = gstage ? kc * bins : 0;              // a chunk's gradient
  float* gbufs = smem;                                 // 2 * gsz
  float* cbufs = gbufs + 2 * gsz;                      // 2 * cap * kc
  RoiTap* ty = reinterpret_cast<RoiTap*>(cbufs + 2 * cap * kc);   // s
  RoiTap* tx = ty + s;                                 // s
  BinTap* tab = reinterpret_cast<BinTap*>(tx + s);     // 2 S kt
  int* slots = reinterpret_cast<int*>(tab + 2 * out_size * kt);   // 2 S kt
  int* cnt = slots + 2 * out_size * kt;                // 2 S

  const size_t r = blockIdx.x;
  const float* roi = rois + r * 5;
  const int l = lvls[r];
  const bool count = path_counts != nullptr && threadIdx.x == 0;
  if (!valid_roi(lv, roi, l)) {
    if (threadIdx.x < 4) grad_rois[r * 4 + threadIdx.x] = 0.0f;
    if (count) atomicAdd(path_counts + kInvalid, 1);
    return;
  }
  roi_tap_table(lv, roi, l, out_size, sr, aligned, ty, tx);
  __syncthreads();
  const int hl = lv.h[l];
  const int wl = lv.w[l];
  const size_t cs = static_cast<size_t>(channels);
  const float* feat = lv.feat[l] + static_cast<size_t>(roi[0]) * hl * wl * cs;
  const float* src = grad_out + r * cs * bins;          // the roi's (C, S, S)
  const float inv_count = bin_scale(sr);
  const int n_chunks = (channels + kc - 1) / kc;

  // the bin rows [oy_lo, oy_hi] with a sample in the map along y, and
  // whether a column has one: a roi with neither reads nothing
  int oy_lo = out_size;
  int oy_hi = -1;
  bool any_x = false;
  for (int k = 0; k < s; ++k) {
    if (!(ty[k].i0 & kOutside)) {
      oy_lo = min(oy_lo, k / sr);
      oy_hi = k / sr;
    }
    any_x = any_x || !(tx[k].i0 & kOutside);
  }
  const int n_rows = oy_hi + 1 - oy_lo;
  // the grid, as the forward's: columns once for the roi, rows per band of
  // bh of the active output rows, bh as large as a buffer's `cap` cells
  // allow
  const AxisMap mx = axis_map(tx, 0, s - 1);
  auto band_rows = [&](int band, int h) {
    const int r0 = oy_lo + band * h;
    return axis_map(ty, r0 * sr, min(oy_hi + 1, r0 + h) * sr - 1);
  };
  int bh = max(n_rows, 0);
  for (; bh > 0; --bh) {
    int rows = 0;
    for (int band = 0; band * bh < n_rows; ++band) {
      rows = max(rows, band_rows(band, bh).n);
    }
    if (rows * mx.n <= cap) break;
  }
  if (n_rows <= 0 || !any_x) {                         // nothing in the map
    if (count) atomicAdd(path_counts + kWhole, 1);
    if (threadIdx.x < 4) grad_rois[r * 4 + threadIdx.x] = 0.0f;
    return;
  }
  // per bin row (t < S) and bin column, the distinct map cells of its
  // in-map samples' taps, and for each the slot of its first tap (2 k + q:
  // tap q of sample k), for the grid's slot form
  for (int t = threadIdx.x; t < 2 * out_size; t += kThreads) {
    const bool is_x = t >= out_size;
    const int o = is_x ? t - out_size : t;
    const RoiTap* taps = is_x ? tx : ty;
    BinTap* e = tab + t * kt;
    int* es = slots + t * kt;
    int n = 0;
    for (int k = o * sr; k < (o + 1) * sr; ++k) {
      const RoiTap a = taps[k];
      if (a.i0 & kOutside) continue;                   // no gradient
      for (int q = 0; q < 2; ++q) {
        const int cell = q ? a.i1 : a.i0 & kCell;
        const float w = q ? a.w1 : a.w0;
        const float b1 = q ? a.d1 : -a.d1;
        const float b2 = q ? a.d2 : -a.d2;
        int j = 0;
        while (j < n && e[j].cell != cell) ++j;        // a repeated tap
        if (j == n) {
          es[n] = 2 * k + q;
          e[n++] = BinTap{cell, w, b1, b2};
        } else {
          e[j].a = __fadd_rn(e[j].a, w);
          e[j].b1 = __fadd_rn(e[j].b1, b1);
          e[j].b2 = __fadd_rn(e[j].b2, b2);
        }
      }
    }
    cnt[t] = n;
  }
  __syncthreads();
  // stage the grid only where the bins read its cells kRoisMinReuse times
  // or more: (the bins' reads a chunk) = (the sum over rows of a row's
  // cells) x (the sum over columns), against the cells the bands stage
  int reads_y = 0;
  int reads_x = 0;
  for (int o = 0; o < out_size; ++o) {
    reads_y += cnt[o];
    reads_x += cnt[out_size + o];
  }
  int staged = 0;
  for (int band = 0; bh > 0 && band * bh < n_rows; ++band) {
    staged += band_rows(band, bh).n * mx.n;
  }
  if (static_cast<long long>(reads_y) * reads_x <
      static_cast<long long>(kRoisMinReuse) * staged) {
    bh = 0;
  }
  const Path path = bh == n_rows ? kWhole : bh == 0 ? kGlobal : kBands;
  if (count) atomicAdd(path_counts + path, 1);
  // the entries' cells in the path's terms: grid row (of the row's band)
  // times the grid's row length, or grid column; map row times W, or map
  // column
  for (int t = threadIdx.x; t < 2 * out_size; t += kThreads) {
    const bool is_x = t >= out_size;
    const int o = is_x ? t - out_size : t;
    if (cnt[t] == 0) continue;
    const AxisMap m = path == kGlobal ? AxisMap{0, 0, 0}
                      : is_x ? mx
                             : band_rows((o - oy_lo) / bh, bh);
    const int row_len = is_x ? 1 : path == kGlobal ? wl : mx.n;
    for (int j = 0; j < cnt[t]; ++j) {
      BinTap& e = tab[t * kt + j];
      const int grid = m.lo >= 0 ? e.cell - m.lo
                                 : slots[t * kt + j] - 2 * m.first;
      e.cell = grid * row_len;
    }
  }
  __syncthreads();

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};             // x1, y1, x2, y2
  if (!gstage) {
    for (int k = 0; k < n_chunks; ++k) {
      const int c0 = k * kc;
      const int width = min(kc, channels - c0);
      rois_gather<kSr>(MapCells<kVec>{feat + c0, cs, width},
                       StageGrad<true>{src + static_cast<size_t>(c0) * bins,
                                       bins},
                       kc, width, inv_count, tab, cnt, out_size, kt, oy_lo,
                       oy_hi + 1, acc);
    }
  } else {
    // Stage t: band t % nb of chunk t / nb.
    const int nb = path == kGlobal ? 1 : (n_rows + bh - 1) / bh;
    const int n_stages = n_chunks * nb;
    constexpr int kPer = kVec ? 4 : 1;                 // floats a copy
    // the gradient's bins [b_lo, b_hi) of each channel: the active rows
    const int b_lo = oy_lo * out_size;
    const int b_n = (oy_hi + 1) * out_size - b_lo;
    auto stage_load = [&](int t) {
      const int c0 = t / nb * kc;
      const int width = min(kc, channels - c0);
      if (t % nb == 0) {
        // the chunk's upstream gradient: one contiguous run of the input,
        // or of each channel's active rows
        float* gd = gbufs + (t / nb & 1) * gsz;
        const float* from = src + static_cast<size_t>(c0) * bins;
        if (kVec && b_n == bins) {
          for (int i = threadIdx.x * 4; i < width * bins; i += kThreads * 4) {
            cp_async16(gd + i, from + i);
          }
        } else {
          for (int i = threadIdx.x; i < width * b_n; i += kThreads) {
            const int c = i / b_n;
            const int b = b_lo + i - c * b_n;
            cp_async4(gd + c * bins + b, from + c * bins + b);
          }
        }
      }
      if (path == kGlobal) return;
      float* buf = cbufs + (t & 1) * cap * kc;
      // the band's cells, kc floats a cell (the chunk's width of them)
      const AxisMap my = band_rows(t % nb, bh);
      const int n_cells = my.n * mx.n;
      const int per_cell = kc / kPer;
      for (int i = threadIdx.x; i < n_cells * per_cell; i += kThreads) {
        const int cell = i / per_cell;
        const int c = (i - cell * per_cell) * kPer;
        if (kVec && c >= width) continue;
        const int j = cell / mx.n;
        const int row = grid_source(ty, my, j);
        const int col = grid_source(tx, mx, cell - j * mx.n);
        const float* p = feat + (static_cast<size_t>(row) * wl + col) * cs
                         + c0 + c;
        float* d = buf + cell * kc + c;
        if constexpr (kVec) {
          cp_async16(d, p);
        } else if (c < width) {
          cp_async4(d, p);
        } else {
          *d = 0.0f;                                   // past the map's C
        }
      }
    };
    stage_load(0);
    cp_async_commit();
    for (int t = 0; t < n_stages; ++t) {
      if (t + 1 < n_stages) stage_load(t + 1);
      cp_async_commit();
      cp_async_wait<1>();          // stage t landed; t + 1 stays in flight
      __syncthreads();             // everyone's copies
      const int band = t % nb;
      const int c0 = t / nb * kc;
      const float* gs = gbufs + (t / nb & 1) * gsz;
      const int oy_begin = path == kGlobal ? oy_lo : oy_lo + band * bh;
      const int oy_end = path == kGlobal ? oy_hi + 1
                                         : min(oy_hi + 1, oy_begin + bh);
      const int width = min(kc, channels - c0);
      if (path == kGlobal) {
        rois_gather<kSr>(MapCells<kVec>{feat + c0, cs, width},
                         StageGrad<false>{gs, bins}, kc, width, inv_count,
                         tab, cnt, out_size, kt, oy_begin, oy_end, acc);
      } else {
        rois_gather<kSr>(StagedCells{cbufs + (t & 1) * cap * kc, kc},
                         StageGrad<false>{gs, bins}, kc, width, inv_count,
                         tab, cnt, out_size, kt, oy_begin, oy_end, acc);
      }
      __syncthreads();             // read before stage t + 2 lands in it
    }
    cp_async_wait<0>();
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

// shared memory a block of the roi-coordinate kernel takes: four blocks
// an SM (by registers) leave ~120 KB of the SM's 256 KB to L1, which
// serves the grids that are not staged (measured against 40 and 55 KB:
// roi_align_ablation.py --part rois)
constexpr size_t kRoisBudget = 32 * 1024;

// the roi-coordinate launch for these arguments: sr = 2 (P2BNet's bags)
// known at compile time, else the generic form; one block a roi
template <bool kVec>
int launch_rois_backward(const Levels& lv, int channels, const float* rois,
                         const int* lvls, int n_rois, int out_size, int sr,
                         int aligned, const float* grad_out, float* grad_rois,
                         int* path_counts, cudaStream_t stream) {
  const size_t tables = rois_bwd_tables(out_size, sr);
  if (tables > kRoisBudget) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bins = static_cast<size_t>(out_size) * out_size;
  // chunks of 64 channels, or of 32 where two buffers of a 64-channel
  // chunk's gradient do not fit, or nothing staged (chunks of 64)
  size_t kc = 64;
  while (kc >= 32 && 2 * kc * bins * sizeof(float) + tables > kRoisBudget) {
    kc /= 2;
  }
  const int gstage = kc >= 32;
  kc = gstage ? kc : 64;
  const size_t gbytes = gstage ? 2 * kc * bins * sizeof(float) : 0;
  // cells a stage buffer holds beside the chunk's gradient
  const int cap = gstage ? static_cast<int>((kRoisBudget - tables - gbytes)
                                            / (2 * kc * sizeof(float))) : 0;
  const size_t smem = gbytes + 2 * cap * kc * sizeof(float) + tables;
  auto kernel = sr == 2 ? roi_align_rois_backward_kernel<kVec, 2>
                        : roi_align_rois_backward_kernel<kVec, 0>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(n_rois), kThreads, smem, stream>>>(
      lv, channels, rois, lvls, out_size, sr, aligned, static_cast<int>(kc),
      cap, gstage, grad_out, grad_rois, path_counts);
  return static_cast<int>(cudaGetLastError());
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
// (or the error of a refused argument or attribute). `path_counts`, when
// not null, is 4 int32 on the card to which each roi adds one at its path:
// its grid staged whole, staged in bands, read from global memory,
// invalid (the caller zeroes them).
extern "C" int ptb_roi_align_rois_backward(
    const void* grad_out, const void* const* feats, const int* heights,
    const int* widths, const float* strides, int n_levels, int batch,
    int channels, const void* rois, const void* lvls, int n_rois,
    int out_size, int sampling_ratio, int aligned, void* grad_rois,
    void* path_counts, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || out_size < 1 ||
      sampling_ratio < 1 || channels < 1 || n_rois < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels lv;
  lv.n = n_levels;
  lv.batch = batch;
  bool vec = channels % 4 == 0 && reinterpret_cast<size_t>(grad_out) % 16 == 0;
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
  auto* counts = static_cast<int*>(path_counts);
  auto st = static_cast<cudaStream_t>(stream);
  return vec ? launch_rois_backward<true>(lv, channels, r, lv_idx, n_rois,
                                          out_size, sampling_ratio, aligned,
                                          g, out, counts, st)
             : launch_rois_backward<false>(lv, channels, r, lv_idx, n_rois,
                                           out_size, sampling_ratio, aligned,
                                           g, out, counts, st);
}
