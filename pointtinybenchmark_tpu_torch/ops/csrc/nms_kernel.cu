// Greedy NMS on Hopper: an IoU suppression bitmask, then a greedy reduce.
//
// Replaces the TPU kernel pointtinybenchmark_tpu/ops/pallas_kernels.py::
// iou_suppression_matrix (the (N, N) bool matrix written from (128, 256)
// VMEM tiles) and the XLA loops that consume the same matrix in
// pointtinybenchmark_tpu/ops/nms.py (_fixpoint_sorted, nms_vblocked,
// nms_blocked).
//
// Both kernels take n_valid (B,) int32 on the device: the rows the caller
// may keep are a prefix of the score-sorted order, so rows and columns at or
// past n_valid[b] are never needed.
//
// Kernel A, iou_bitmask: boxes (B, N, 4) f32, already sorted by descending
// score (and class-offset by the caller). Output (B, N, ceil(N / 64)) uint64:
// bit j of row i is set iff j > i and inter / max(union, 1e-6) > thr. The
// division form of ops/nms.py::_pairwise_iou is the main path's semantics
// (the Pallas kernel compares inter > thr * union, which rounds differently
// at the threshold). Only the words the reduce reads are written: for rows
// i < n_valid, the words w >= i / 64 that hold columns < n_valid. Everything
// else (the words left of a row's diagonal word, rows and columns past
// n_valid) is left as the caller allocated it.
//
// Kernel B, greedy_reduce: one 1,024-thread block per batch item walks the
// sorted rows 64 at a time with a `removed` bitset in shared memory. For each
// 64-row block, warp 0 resolves the block alone: candidates are the ok rows
// not yet removed, and the greedy set inside the block is the fixpoint of
// "kept = candidates minus the rows that kept rows suppress", taken from the
// rows' diagonal words with two warp OR-reductions per round (a few rounds,
// as long as the longest chain of suppressions in the block). Then every warp
// takes kept rows and ORs their words after the block into `removed`, lanes
// on consecutive words, all of a row's loads issued together, a shared atomic
// only for a nonzero word. The walk stops at max_out kept or at n_valid.
// Output keep (B, max_out) int32 in pick order (original indices through
// `order`, looked up once at the end), padded with -1, and num_kept (B,).
//
// What bounds them on this card, and what the design does about it:
// - A is bound by operations: N^2 / 2 pair tests, four f32 compares each,
//   plus the 15 operations of the exact IoU for the pairs that overlap
//   (about 1% of them on TinyPerson boxes). The first version ran one 64-thread block per 64x64 tile, half
//   of them left of the diagonal writing zeros, and every pair paid two box
//   areas and an IEEE divide. Now a 128-thread block takes a 256x256 tile of
//   the upper triangle only (a linear block index mapped to (row tile,
//   column tile >= row tile)), each thread two rows, so that one shared-memory
//   read of a column box serves two pairs. Each column box and its area are
//   staged once. The inner loop is four compares per pair (`overlaps`) with
//   constant bit positions; only the few pairs that overlap (TinyPerson boxes
//   are small and spread) take the exact IoU, which keeps __fdiv_rn. Rows and
//   columns past n_valid are skipped.
// - B is bound by latency, not bytes: the walk is a chain. The first version
//   paid a global load of ok per row and, per kept row, a dependent load of
//   its mask row plus a block barrier. Now the ok flags and the 64 diagonal
//   words of the next row block (cp.async) are in flight while the current
//   one resolves, and the chain has one round of loads and two barriers per
//   64 rows (one barrier for a block that keeps nothing). B still runs one
//   block per batch item, so it fills B of the card's 132 SMs; a walk split
//   across a cluster is later work.
//
// Rounding: keep sets must be identical to the JAX package's, so every
// operation that decides a bit is written with the round-to-nearest
// intrinsics (__fsub_rn, __fmul_rn, __fadd_rn, __fdiv_rn): nvcc may neither
// contract area_a + w * h into an FMA nor use an approximate divide. Areas
// computed once per box use the same intrinsics in the same order, so they
// are bit-identical to the per-pair ones of ops/nms.py. The library is also
// built with -fmad=false and without --use_fast_math.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kWord = 64;                  // bits per mask word = rows per row block
constexpr int kTileWords = 4;              // kernel A: a 256 x 256 tile per block,
constexpr int kTile = kTileWords * kWord;  // two rows per thread, 128 apart
constexpr int kTileThreads = kTile / 2;
constexpr int kReduceThreads = 1024;
constexpr int kWarps = kReduceThreads / 32;

using u64 = unsigned long long;

__device__ __forceinline__ float box_area(const float4 a) {
  return __fmul_rn(__fsub_rn(a.z, a.x), __fsub_rn(a.w, a.y));
}

// ops/nms.py::_pairwise_iou(a, b) > thr, in its operation order
__device__ __forceinline__ bool iou_above(const float4 a, const float area_a,
                                          const float4 b, const float area_b,
                                          const float thr) {
  const float ix1 = fmaxf(a.x, b.x);
  const float iy1 = fmaxf(a.y, b.y);
  const float ix2 = fminf(a.z, b.z);
  const float iy2 = fminf(a.w, b.w);
  const float inter = __fmul_rn(fmaxf(__fsub_rn(ix2, ix1), 0.0f),
                                fmaxf(__fsub_rn(iy2, iy1), 0.0f));
  // max(union, 1e-6) that keeps a NaN union (inf - inf), as the plain
  // version's clamp does; fmaxf would return 1e-6 there
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, uni < 1e-6f ? 1e-6f : uni) > thr;
}

// A box with x2 > x1 and y2 > y1 as it is, any other (empty, inverted, or
// with a NaN) as a box that overlaps nothing. Two boxes of the first kind
// overlap, min(x2) > max(x1) and min(y2) > max(y1), iff each one's x2 and y2
// lie above the other's x1 and y1: four compares per pair. A pair that does
// not overlap has inter = 0, or NaN where the plain version's NaN-propagating
// max meets a NaN, and its IoU is above no thr >= 0.
__device__ __forceinline__ float4 overlap_form(const float4 a) {
  const bool solid = (a.z > a.x) & (a.w > a.y);
  return solid ? a : make_float4(INFINITY, INFINITY, -INFINITY, -INFINITY);
}

__device__ __forceinline__ bool overlaps(const float4 a, const float4 o) {
  return (a.z > o.x) & (o.z > a.x) & (a.w > o.y) & (o.w > a.y);
}

__device__ __forceinline__ int valid_count(const int* n_valid, size_t b,
                                           int n) {
  return min(max(n_valid[b], 0), n);
}

// Bits t of one row's word (columns t of `cw`) that suppress it, from the
// overlapping columns only; `overlap` holds no column at or left of the row.
__device__ __forceinline__ u64 exact_bits(u64 overlap, const float4 a,
                                          const float area_a,
                                          const float4* cw, const float* aw,
                                          const float thr) {
  u64 bits = 0ull;
  while (overlap != 0ull) {
    const int t = __ffsll(static_cast<long long>(overlap)) - 1;
    overlap &= overlap - 1;
    if (iou_above(a, area_a, cw[t], aw[t], thr)) bits |= 1ull << t;
  }
  return bits;
}

__global__ void __launch_bounds__(kTileThreads)
    iou_bitmask_kernel(const float4* __restrict__ boxes,
                       const int* __restrict__ n_valid, int n, int words,
                       int tiles, float thr, u64* __restrict__ mask) {
  // Upper-triangle tiles numbered from the last row tile up: row tile
  // tiles - 1 - u holds u + 1 tiles, which start at u (u + 1) / 2.
  const int lin = blockIdx.x;
  int u = static_cast<int>((sqrtf(8.0f * lin + 1.0f) - 1.0f) * 0.5f);
  while ((u + 1) * (u + 2) / 2 <= lin) ++u;
  while (u * (u + 1) / 2 > lin) --u;
  const int row_tile = tiles - 1 - u;
  const int col_tile = row_tile + (lin - u * (u + 1) / 2);
  const size_t b = blockIdx.y;
  const int nv = valid_count(n_valid, b, n);
  const int col0 = col_tile * kTile;
  if (col0 >= nv) return;  // and every row, since col_tile >= row_tile

  __shared__ float4 cols[kTile];       // as the overlap test reads them
  __shared__ float4 raw[kTile];        // as the exact test reads them
  __shared__ float col_area[kTile];
  const float4* bb = boxes + b * n;
  for (int t = threadIdx.x; t < kTile; t += kTileThreads) {
    // past N: a box that overlaps nothing
    float4 c = make_float4(INFINITY, INFINITY, -INFINITY, -INFINITY);
    if (col0 + t < n) c = bb[col0 + t];
    raw[t] = c;
    cols[t] = overlap_form(c);
    col_area[t] = box_area(c);
  }
  __syncthreads();

  // rows i0 and i1 = i0 + 128; each warp's 32 rows share a diagonal word
  const int i0 = row_tile * kTile + threadIdx.x;
  const int i1 = i0 + kTileThreads;
  if (i0 >= nv) return;
  const bool live1 = i1 < nv;
  const float4 a0 = bb[i0];
  const float4 a1 = live1 ? bb[i1] : make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 f0 = overlap_form(a0);
  const float4 f1 = overlap_form(live1 ? a1 : make_float4(0.f, 0.f, 0.f, 0.f));
  const float area0 = box_area(a0);
  const float area1 = box_area(a1);
  const int wd0 = i0 / kWord;
  const int wd1 = i1 / kWord;
  const int w0 = col_tile * kTileWords;
  const int w_end = min(w0 + kTileWords, (nv + kWord - 1) / kWord);
  u64* out0 = mask + (b * n + i0) * words;
  u64* out1 = out0 + static_cast<size_t>(kTileThreads) * words;
  for (int w = max(w0, wd0); w < w_end; ++w) {
    const float4* cw = cols + (w - w0) * kWord;
    u64 ov0 = 0ull;
    u64 ov1 = 0ull;
#pragma unroll
    for (int t = 0; t < kWord; ++t) {
      const float4 o = cw[t];
      if (overlaps(f0, o)) ov0 |= 1ull << t;
      if (overlaps(f1, o)) ov1 |= 1ull << t;
    }
    // columns j > i only; row i1 owns no word left of its diagonal one
    if (w == wd0) ov0 &= ~0ull << (i0 % kWord) << 1;
    if (w == wd1) ov1 &= ~0ull << (i1 % kWord) << 1;
    const float4* rw = raw + (w - w0) * kWord;
    const float* aw = col_area + (w - w0) * kWord;
    out0[w] = exact_bits(ov0, a0, area0, rw, aw, thr);
    if (live1 && w >= wd1) out1[w] = exact_bits(ov1, a1, area1, rw, aw, thr);
  }
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// warp 0: the diagonal words of row block k, mask[k * 64 + t][k], into `dst`
__device__ __forceinline__ void fetch_diagonal(const u64* m, int words, int nv,
                                               int k, u64* dst, int lane) {
  for (int t = lane; t < kWord; t += 32) {
    const int row = k * kWord + t;
    if (row < nv) cp_async8(dst + t, m + static_cast<size_t>(row) * words + k);
  }
}

__global__ void __launch_bounds__(kReduceThreads)
    greedy_reduce_kernel(const u64* __restrict__ mask,
                         const unsigned char* __restrict__ ok,
                         const int* __restrict__ order,
                         const int* __restrict__ n_valid, int n, int words,
                         int max_out, int* __restrict__ keep,
                         int* __restrict__ num_kept) {
  // dynamic: removed[words], then diag[2][64] (the cp.async ring)
  extern __shared__ u64 smem[];
  u64* removed = smem;
  u64* diag = smem + words;
  __shared__ int kept_rows[kWord];
  __shared__ int block_kept[2];

  const size_t b = blockIdx.x;
  const int nv = valid_count(n_valid, b, n);
  const int blocks = (nv + kWord - 1) / kWord;
  const u64* m = mask + b * n * words;
  const unsigned char* okb = ok + b * n;
  int* kb = keep + b * max_out;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;

  for (int w = threadIdx.x; w < blocks; w += kReduceThreads) removed[w] = 0ull;
  // warp 0 holds the ok flags of rows k * 64 + lane and + 32 in registers
  bool ok_lo = false;
  bool ok_hi = false;
  if (warp == 0 && blocks > 0) {
    fetch_diagonal(m, words, nv, 0, diag, lane);
    ok_lo = lane < nv && okb[lane];
    ok_hi = lane + 32 < nv && okb[lane + 32];
  }
  if (warp == 0) cp_async_commit();
  __syncthreads();

  int kept = 0;  // the same in every thread
  for (int k = 0; k < blocks; ++k) {
    if (warp == 0) {
      // the next block's ok flags and diagonal words are fetched while this
      // one resolves
      const int r = (k + 1) * kWord + lane;
      const bool next_lo = r < nv && okb[r];
      const bool next_hi = r + 32 < nv && okb[r + 32];
      if (k + 1 < blocks) {
        fetch_diagonal(m, words, nv, k + 1, diag + ((k + 1) & 1) * kWord, lane);
      }
      cp_async_commit();
      cp_async_wait<1>();  // row block k's diagonal words have landed
      __syncwarp();
      const u64* d = diag + (k & 1) * kWord;
      const u64 cand = (__ballot_sync(~0u, ok_lo)
                        | (static_cast<u64>(__ballot_sync(~0u, ok_hi)) << 32))
                       & ~removed[k];
      // Greedy inside the block as a fixpoint: a candidate is kept iff no
      // kept candidate before it suppresses it. Row t's diagonal word holds
      // only rows after t, so iterate from "all kept" until nothing changes:
      // the statuses settle in row order, and the fixpoint is the greedy set.
      const u64 d_lo = d[lane];
      const u64 d_hi = d[lane + 32];
      u64 take = cand;
      while (true) {
        const u64 mine = (((take >> lane) & 1ull) ? d_lo : 0ull)
                         | (((take >> (lane + 32)) & 1ull) ? d_hi : 0ull);
        const u64 hit =
            __reduce_or_sync(~0u, static_cast<unsigned>(mine))
            | (static_cast<u64>(__reduce_or_sync(
                   ~0u, static_cast<unsigned>(mine >> 32))) << 32);
        const u64 next = cand & ~hit;
        if (next == take) break;
        take = next;
      }
      // stop at max_out: the first max_out - kept rows of the block
      for (int extra = __popcll(take) - (max_out - kept); extra > 0; --extra) {
        take &= ~(1ull << (63 - __clzll(static_cast<long long>(take))));
      }
      // sorted rows for now; turned into original indices at the end
      for (int t = lane; t < kWord; t += 32) {
        if ((take >> t) & 1ull) {
          const int rank = __popcll(take & ((1ull << t) - 1));
          kept_rows[rank] = k * kWord + t;
          kb[kept + rank] = k * kWord + t;
        }
      }
      if (lane == 0) block_kept[k & 1] = __popcll(take);
      ok_lo = next_lo;
      ok_hi = next_hi;
    }
    __syncthreads();
    const int nk = block_kept[k & 1];
    kept += nk;
    if (kept >= max_out) break;
    if (nk == 0) continue;  // nothing to OR; the next block reads no kept_rows
    // the kept rows' words after this block into `removed`: a warp per row,
    // lanes on consecutive words, all loads of a row issued together; most
    // words are 0 and need no atomic
    for (int q = warp; q < nk; q += kWarps) {
      const u64* row = m + static_cast<size_t>(kept_rows[q]) * words;
      for (int w0 = k + 1; w0 < blocks; w0 += 4 * 32) {
        u64 v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int w = w0 + 32 * j + lane;
          v[j] = w < blocks ? row[w] : 0ull;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (v[j] != 0ull) atomicOr(&removed[w0 + 32 * j + lane], v[j]);
        }
      }
    }
    __syncthreads();
  }
  // no cp.async may still write this block's shared memory when it exits
  if (warp == 0) cp_async_wait<0>();
  __syncthreads();  // warp 0's sorted rows in keep are visible to all
  const int* ord = order + b * n;
  for (int q = threadIdx.x; q < max_out; q += kReduceThreads) {
    kb[q] = q < kept ? ord[kb[q]] : -1;
  }
  if (threadIdx.x == 0) num_kept[b] = kept;
}

}  // namespace

// Plain C interface, loaded with ctypes. Each function launches on `stream`,
// does not synchronise, and returns cudaGetLastError() after the launch.
extern "C" int ptb_iou_bitmask(const void* boxes, const void* n_valid,
                               int batch, int n, float thr, void* mask,
                               void* stream) {
  const int words = (n + kWord - 1) / kWord;
  const int tiles = (n + kTile - 1) / kTile;
  const dim3 grid(tiles * (tiles + 1) / 2, batch);
  iou_bitmask_kernel<<<grid, kTileThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const int*>(n_valid), n,
      words, tiles, thr, static_cast<u64*>(mask));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ptb_greedy_reduce(const void* mask, const void* ok,
                                 const void* order, const void* n_valid,
                                 int batch, int n, int max_out, void* keep,
                                 void* num_kept, void* stream) {
  const int words = (n + kWord - 1) / kWord;
  // under 48 KB (the wrapper refuses more): no opt-in needed
  const size_t smem = (static_cast<size_t>(words) + 2 * kWord) * sizeof(u64);
  greedy_reduce_kernel<<<batch, kReduceThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(mask), static_cast<const unsigned char*>(ok),
      static_cast<const int*>(order), static_cast<const int*>(n_valid), n,
      words, max_out, static_cast<int*>(keep), static_cast<int*>(num_kept));
  return static_cast<int>(cudaGetLastError());
}
