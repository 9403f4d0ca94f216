// Multilevel RoIAlign forward on Hopper: mmcv RoIAlign (`aligned` or not)
// with a static sampling ratio, each roi read from its own FPN level.
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
  if (l < 0 || l >= lv.n || !(roi[0] >= 0.0f && roi[0] < lv.batch)) {
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
  const float hf = static_cast<float>(hl);
  const float wf = static_cast<float>(wl);
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
  const float inv_count = __fdiv_rn(1.0f, static_cast<float>(sr * sr));
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
