// Multilevel RoIAlign forward on Hopper: mmcv RoIAlign (`aligned` or not)
// with a static sampling ratio, each roi read from its own FPN level.
//
// Replaces the TPU kernel pointtinybenchmark_tpu/ops/roi_align_pallas.py::
// roi_align_multilevel_pallas (_pallas_fwd, _kernel_factory, _prep): one
// window DMA per roi into VMEM, then separable tent-weight matmuls on the
// MXU. It computes the port's plain version, ops/roi_align.py::
// roi_align_multilevel_plain (the operation order of the JAX package's
// ops/roi_align.py::roi_align_multilevel), not the Pallas kernel: that one
// clamps rois wider than its 64x40 window, and this kernel has no window.
//
// Inputs: level maps (B, H_l, W_l, C) f32 in memory (the channels-last
// layout the FPN's cuDNN convolutions already leave them in, so the wrapper's
// permute is free on the main path; an NCHW-contiguous map costs one copy,
// about 0.67 GB read and written for the 24 tiles of two 1920x1080 frames),
// rois (R, 5) f32 (batch index, x1, y1, x2, y2 in image coordinates), levels
// (R,) int32. Output (R, C, S, S) f32: mmdet's order, so the first FC of the
// bbox head flattens it as (c, h, w). A roi whose batch index or level is out
// of range reads nothing and gets NaN: no read outside the maps.
//
// Design: one block per roi.
// 1. The roi's (S*sr)^2 sample points are computed once into shared memory:
//    their four tap cells (y * W + x), four bilinear weights (wy * wx) and
//    the in-bounds flag (mmcv's "outside [-1, dim] is zero" rule).
// 2. The block walks the channels in chunks of 32. A warp's lanes take 32
//    consecutive channels of one output bin, so every tap is one 128-byte
//    read from the channels-last map; the warps split the S*S bins.
// 3. The 32-channel x S*S chunk is staged in shared memory (row length
//    padded to an odd count, so the lanes' writes hit distinct banks) and
//    written out as one contiguous run of the (R, C, S, S) output.
//
// What bounds it on this card: bytes. At the slice's shape (R = 24,000,
// S = 7, sr = 1, C = 256) the output is 1.20 GB to write, ~0.36 ms at
// 3.35 TB/s; the taps read only the cells the rois cover, at most the
// 0.67 GB of the four level maps. The arithmetic is 8 * sr^2 flops per
// output element, ~2.4 GFLOP, far below the f32 rate. Overlapping rois
// re-read their cells through L1/L2; making it fast (TMA windows, several
// rois per block) is later work.
//
// Rounding: the result must equal the plain PyTorch version bit for bit, so
// every operation is written with the round-to-nearest intrinsics in the
// plain version's order (divisions by S, sr and sr^2 are multiplications by
// their float32 reciprocals and the sample coordinate is one fused
// multiply-add, as XLA compiles the JAX code), and the library is built with
// -fmad=false (no other FMA contraction) and without --use_fast_math.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;
constexpr int kChunk = 32;           // channels per staged tile = warp width

struct Levels {
  const float* feat[kMaxLevels];     // (B, H, W, C) contiguous
  int h[kMaxLevels];
  int w[kMaxLevels];
  float stride[kMaxLevels];
  int n;                             // levels in use
  int batch;                         // B
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

__host__ __device__ __forceinline__ int tile_ld(int bins) { return bins | 1; }

// dynamic shared memory of one block; above 48 KB the launch opts in, and
// above the card's 227 KB it is refused (S > 38 at sr = 1)
__host__ __device__ __forceinline__ size_t smem_bytes(int out_size, int sr) {
  const int bins = out_size * out_size;
  const int s = out_size * sr;
  const size_t pts = static_cast<size_t>(s) * s;
  return kChunk * tile_ld(bins) * sizeof(float)      // staged output chunk
         + pts * 4 * (sizeof(float) + sizeof(int))   // weights, tap cells
         + pts;                                       // in-bounds flags
}

__global__ void __launch_bounds__(kThreads)
roi_align_kernel(const Levels lv, int channels, const float* __restrict__ rois,
                 const int* __restrict__ lvls, int out_size, int sr,
                 int aligned, float* __restrict__ output) {
  extern __shared__ float smem[];
  const int s = out_size * sr;
  const int n_pts = s * s;
  const int bins = out_size * out_size;
  const int ld = tile_ld(bins);
  float* tile = smem;                                           // kChunk * ld
  float* wts = tile + kChunk * ld;                              // 4 * n_pts
  int* cells = reinterpret_cast<int*>(wts + 4 * n_pts);         // 4 * n_pts
  unsigned char* inb = reinterpret_cast<unsigned char*>(cells + 4 * n_pts);

  const size_t r = blockIdx.x;
  const float* roi = rois + r * 5;
  const int l = lvls[r];
  const size_t cs = static_cast<size_t>(channels);
  float* dst = output + r * cs * bins;
  if (l < 0 || l >= lv.n || !(roi[0] >= 0.0f && roi[0] < lv.batch)) {
    for (size_t k = threadIdx.x; k < cs * bins; k += blockDim.x) {
      dst[k] = __int_as_float(0x7fc00000);   // quiet NaN
    }
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
  const float wm1 = __fsub_rn(wf, 1.0f);
  const float hm1 = __fsub_rn(hf, 1.0f);

  for (int p = threadIdx.x; p < n_pts; p += blockDim.x) {
    const int i = p / s;             // y sample
    const int j = p - i * s;         // x sample
    const float yg = fused_madd(sample_frac(i, sr, inv_sr), bin_h, y1);
    const float xg = fused_madd(sample_frac(j, sr, inv_sr), bin_w, x1);
    inb[p] = (xg >= -1.0f) && (xg <= wf) && (yg >= -1.0f) && (yg <= hf);
    const float xc = fminf(fmaxf(xg, 0.0f), wm1);
    const float yc = fminf(fmaxf(yg, 0.0f), hm1);
    const float x0 = floorf(xc);
    const float y0 = floorf(yc);
    const int x0i = static_cast<int>(x0);
    const int y0i = static_cast<int>(y0);
    const int x1i = static_cast<int>(fminf(__fadd_rn(x0, 1.0f), wm1));
    const int y1i = static_cast<int>(fminf(__fadd_rn(y0, 1.0f), hm1));
    const float wx1 = __fsub_rn(xc, x0);
    const float wy1 = __fsub_rn(yc, y0);
    const float wx0 = __fsub_rn(1.0f, wx1);
    const float wy0 = __fsub_rn(1.0f, wy1);
    cells[p] = y0i * wl + x0i;
    cells[n_pts + p] = y0i * wl + x1i;
    cells[2 * n_pts + p] = y1i * wl + x0i;
    cells[3 * n_pts + p] = y1i * wl + x1i;
    wts[p] = __fmul_rn(wy0, wx0);
    wts[n_pts + p] = __fmul_rn(wy0, wx1);
    wts[2 * n_pts + p] = __fmul_rn(wy1, wx0);
    wts[3 * n_pts + p] = __fmul_rn(wy1, wx1);
  }
  __syncthreads();

  const int b = static_cast<int>(roi[0]);
  const float* base = lv.feat[l] + static_cast<size_t>(b) * hl * wl * cs;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int n_warps = blockDim.x / 32;
  for (int c0 = 0; c0 < channels; c0 += kChunk) {
    const int width = min(kChunk, channels - c0);
    if (lane < width) {
      const float* f = base + c0 + lane;
      for (int bin = warp; bin < bins; bin += n_warps) {
        const int oy = bin / out_size;
        const int ox = bin - oy * out_size;
        float acc = 0.0f;
        for (int iy = 0; iy < sr; ++iy) {
          for (int ix = 0; ix < sr; ++ix) {
            const int p = (oy * sr + iy) * s + ox * sr + ix;
            float v = 0.0f;
            if (inb[p]) {
              const float v00 = f[cells[p] * cs];
              const float v01 = f[cells[n_pts + p] * cs];
              const float v10 = f[cells[2 * n_pts + p] * cs];
              const float v11 = f[cells[3 * n_pts + p] * cs];
              v = __fadd_rn(
                  __fadd_rn(__fadd_rn(__fmul_rn(v00, wts[p]),
                                      __fmul_rn(v01, wts[n_pts + p])),
                            __fmul_rn(v10, wts[2 * n_pts + p])),
                  __fmul_rn(v11, wts[3 * n_pts + p]));
            }
            acc = (iy == 0 && ix == 0) ? v : __fadd_rn(acc, v);
          }
        }
        tile[lane * ld + bin] = __fmul_rn(acc, inv_count);
      }
    }
    __syncthreads();
    float* out = dst + static_cast<size_t>(c0) * bins;
    for (int k = threadIdx.x; k < width * bins; k += blockDim.x) {
      const int c = k / bins;
      out[k] = tile[c * ld + (k - c * bins)];
    }
    __syncthreads();
  }
}

}  // namespace

// Plain C interface, loaded with ctypes. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launch (or the error
// of a refused argument or attribute).
extern "C" int ptb_roi_align(const void* const* feats, const int* heights,
                             const int* widths, const float* strides,
                             int n_levels, int batch, int channels,
                             const void* rois,
                             const void* lvls, int n_rois, int out_size,
                             int sampling_ratio, int aligned, void* output,
                             void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || out_size < 1 ||
      sampling_ratio < 1 || channels < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels lv;
  lv.n = n_levels;
  lv.batch = batch;
  for (int l = 0; l < n_levels; ++l) {
    lv.feat[l] = static_cast<const float*>(feats[l]);
    lv.h[l] = heights[l];
    lv.w[l] = widths[l];
    lv.stride[l] = strides[l];
  }
  const size_t smem = smem_bytes(out_size, sampling_ratio);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        roi_align_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  roi_align_kernel<<<n_rois, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      lv, channels, static_cast<const float*>(rois),
      static_cast<const int*>(lvls), out_size, sampling_ratio, aligned,
      static_cast<float*>(output));
  return static_cast<int>(cudaGetLastError());
}
