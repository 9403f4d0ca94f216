// Greedy NMS on Hopper: an IoU suppression bitmask, then a greedy reduce.
//
// Replaces the TPU kernel pointtinybenchmark_tpu/ops/pallas_kernels.py::
// iou_suppression_matrix (the (N, N) bool matrix written from (128, 256)
// VMEM tiles) and the XLA loops that consume the same matrix in
// pointtinybenchmark_tpu/ops/nms.py (_fixpoint_sorted, nms_vblocked,
// nms_blocked).
//
// Kernel A, iou_bitmask: boxes (B, N, 4) f32, already sorted by descending
// score (and class-offset by the caller). Output (B, N, ceil(N / 64)) uint64:
// bit j of row i is set iff j > i and inter / max(union, 1e-6) > thr. The
// division form of ops/nms.py::_pairwise_iou is the main path's semantics
// (the Pallas kernel compares inter > thr * union, which rounds differently
// at the threshold). One block per (batch, 64-row block, 64-column block);
// the 64 column boxes are staged in shared memory. Blocks left of the
// diagonal hold no bits (j < i) and only write zeros.
//
// Kernel B, greedy_reduce: one block per batch item walks the rows in sorted
// order with a `removed` bitset in shared memory (188 words for N = 12,000).
// A row that is valid and not removed is kept; the block's threads then OR
// its mask row into `removed` in parallel over the words. The walk stops at
// max_out kept. Output keep (B, max_out) int32 in pick order (original
// indices through `order`), padded with -1, and num_kept (B,).
//
// What bounds it on this card: A does N^2 / 2 IoU evaluations (IEEE divide
// included) and writes N^2 / 8 bytes; B is serial in N, with one block
// barrier per kept row. At the protocol's per-tile shape (12 tiles of
// N = 8,720 candidates per frame) the mask is 12 * 8,720 * 137 * 8 B, about
// 115 MB per frame. wgmma and TMA do not apply: there is no matrix product,
// and each row block reads only 64 boxes. Making it fast is later work.
//
// Rounding: keep sets must be identical to the JAX package's, so every
// operation that decides a bit is written with the round-to-nearest
// intrinsics (__fsub_rn, __fmul_rn, __fadd_rn, __fdiv_rn): nvcc may neither
// contract area_a + w * h into an FMA nor use an approximate divide. The
// library is also built with -fmad=false and without --use_fast_math.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 64;            // boxes per row/column block = bits per word
constexpr int kReduceThreads = 256;

__device__ __forceinline__ bool suppresses(const float4 a, const float4 b,
                                           const float thr) {
  const float ix1 = fmaxf(a.x, b.x);
  const float iy1 = fmaxf(a.y, b.y);
  const float ix2 = fminf(a.z, b.z);
  const float iy2 = fminf(a.w, b.w);
  const float inter = __fmul_rn(fmaxf(__fsub_rn(ix2, ix1), 0.0f),
                                fmaxf(__fsub_rn(iy2, iy1), 0.0f));
  const float area_a = __fmul_rn(__fsub_rn(a.z, a.x), __fsub_rn(a.w, a.y));
  const float area_b = __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
  const float uni = fmaxf(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-6f);
  return __fdiv_rn(inter, uni) > thr;
}

__global__ void iou_bitmask_kernel(const float4* __restrict__ boxes, int n,
                                   int words, float thr,
                                   unsigned long long* __restrict__ mask) {
  const int col_blk = blockIdx.x;
  const int row_blk = blockIdx.y;
  const size_t b = blockIdx.z;
  const int i = row_blk * kBlock + threadIdx.x;
  const float4* bb = boxes + b * n;
  unsigned long long* out = mask + (b * n + i) * words + col_blk;
  if (col_blk < row_blk) {  // every column precedes every row: no bits
    if (i < n) *out = 0ull;
    return;
  }
  __shared__ float4 cols[kBlock];
  const int j0 = col_blk * kBlock;
  if (j0 + threadIdx.x < n) cols[threadIdx.x] = bb[j0 + threadIdx.x];
  __syncthreads();
  if (i >= n) return;
  const float4 bi = bb[i];
  const int jn = min(kBlock, n - j0);
  unsigned long long bits = 0ull;
  for (int t = (col_blk == row_blk) ? threadIdx.x + 1 : 0; t < jn; ++t) {
    if (suppresses(bi, cols[t], thr)) bits |= 1ull << t;
  }
  *out = bits;
}

__global__ void greedy_reduce_kernel(const unsigned long long* __restrict__ mask,
                                     const unsigned char* __restrict__ ok,
                                     const int* __restrict__ order, int n,
                                     int words, int max_out,
                                     int* __restrict__ keep,
                                     int* __restrict__ num_kept) {
  extern __shared__ unsigned long long removed[];
  const size_t b = blockIdx.x;
  const unsigned long long* m = mask + b * n * words;
  const unsigned char* okb = ok + b * n;
  const int* ord = order + b * n;
  int* kb = keep + b * max_out;
  for (int w = threadIdx.x; w < words; w += blockDim.x) removed[w] = 0ull;
  __syncthreads();
  // Every thread takes the same branch at every row: all read the same
  // `removed` word, and a kept row's mask only sets bits of later rows, so
  // the ORs of this row cannot change the bit being read. The barrier after
  // the ORs publishes them before the next row is tested.
  int kept = 0;
  for (int i = 0; i < n && kept < max_out; ++i) {
    const int w0 = i / kBlock;
    if (!okb[i] || ((removed[w0] >> (i % kBlock)) & 1ull)) continue;
    if (threadIdx.x == 0) kb[kept] = ord[i];
    ++kept;
    const unsigned long long* row = m + static_cast<size_t>(i) * words;
    for (int w = w0 + threadIdx.x; w < words; w += blockDim.x) {
      removed[w] |= row[w];
    }
    __syncthreads();
  }
  for (int k = kept + threadIdx.x; k < max_out; k += blockDim.x) kb[k] = -1;
  if (threadIdx.x == 0) num_kept[b] = kept;
}

}  // namespace

// Plain C interface, loaded with ctypes. Each function launches on `stream`,
// does not synchronise, and returns cudaGetLastError() after the launch.
extern "C" int ptb_iou_bitmask(const void* boxes, int batch, int n, float thr,
                               void* mask, void* stream) {
  const int blocks = (n + kBlock - 1) / kBlock;
  const dim3 grid(blocks, blocks, batch);
  iou_bitmask_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), n, blocks, thr,
      static_cast<unsigned long long*>(mask));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ptb_greedy_reduce(const void* mask, const void* ok,
                                 const void* order, int batch, int n,
                                 int max_out, void* keep, void* num_kept,
                                 void* stream) {
  const int words = (n + kBlock - 1) / kBlock;
  const size_t smem = static_cast<size_t>(words) * sizeof(unsigned long long);
  greedy_reduce_kernel<<<batch, kReduceThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(mask),
      static_cast<const unsigned char*>(ok), static_cast<const int*>(order), n,
      words, max_out, static_cast<int*>(keep), static_cast<int*>(num_kept));
  return static_cast<int>(cudaGetLastError());
}
