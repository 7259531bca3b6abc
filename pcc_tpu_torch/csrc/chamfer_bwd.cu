// The per-cloud chamfer backward, both clouds, one launch, deterministic.
//
// Replaces the TPU kernel pcc_tpu/ops/chamfer_pallas.py::_bwd_kernel. With
// the forward's indices ixy [P, k], iyx [P, K] and the cotangents of its
// distances gx [P, k], gy [P, K], every point a_i of one side (x or y) gets
//
//   da_i = e_i - sum_{j: ib[j] = i, ascending j} e'_j,
//   e_i  = 2 (a_i - b_ia[i]) ga_i,   e'_j = 2 (b_j - a_ib[j]) gb_j,
//
// the direct term of its own distance minus the gathers the other side
// made at it. Outputs dx [P, k, 3], dy [P, K, 3] f32.
//
// What bounds it on an H100: bytes. The function needs 15 operations per
// point against 32 bytes per point in and out; the floor is the bytes over
// 3.35 TB/s (about 1 us for the 128-cloud train batch at N = 512, 2 us at
// 8 clouds of 16384 and 8192 points).
// What the design does about it: O(k + K) work per cloud pair, as a stable
// counting sort of the gathering points by the point they gathered at,
// where TPU's one-hot transpose (and a scan of the other side for every
// point) costs k * K. A block owns a tile of up to kMaxTargets points of
// one side of one cloud pair (its targets) and up to kMaxWarps warps that
// each read a contiguous run of the other side's indices, 32 at a time
// (kBatch rounds' worth loaded together):
//  1. count: per warp and target, in shared memory, the gathering points
//     of the warp's run; __match_any_sync groups a round's lanes by target
//     and the group's first lane adds the group's size (integers: no order
//     to depend on);
//  2. scan: per target over the warps (each (warp, target) now holds how
//     many of the target's points earlier warps hold), then over the
//     targets (a block-wide exclusive scan) plus the points gathered at
//     earlier tiles: where each target's segment starts;
//  3. place: the runs again; each point's place is its target's start plus
//     its (warp, target) cursor plus its rank among its round's lanes of
//     the same target, and the group's first lane then advances the
//     cursor. Warps hold runs in
//     order, rounds in order, lanes in order: each target's segment lists
//     its gathering points in ascending order;
//  4. sum, kTermChunk gathering points at a time in segment order: the
//     block computes their terms e'_j into shared memory (the counters are
//     spent), a thread a point, so the gathers run in parallel; then one
//     thread per target adds its segment's terms in that order to its
//     running sums, from zero, one rounding per operation, and at the end
//     subtracts them from its direct term: the plain version's
//     association, so two launches are bitwise equal. No atomics at all.
// Decoded clouds crowd: at random weights a point of one side is gathered
// by some 100-400 of the other's (tools/chamfer_breakdown.py, "longest
// segment"). Such a sum is a chain of dependent adds, but of shared-memory
// operands: a few cycles a term, where a gather from device memory each
// would cost a memory latency.

#include <cuda_runtime.h>

#include "chamfer_common.cuh"

namespace {

using namespace pcc;

constexpr int kMaxTargets = 1024;   // targets per block
constexpr int kMaxWarps = 16;       // counting warps per block
constexpr int kBatch = 8;           // rounds of 32 indices loaded together
constexpr int kTermChunk = 4096;    // gathering points' terms in shared memory at once
constexpr unsigned kFull = 0xffffffffu;

// 2 (a - b) g, per coordinate
__device__ __forceinline__ float gather_term(float a, float b, float g) {
  return __fmul_rn(__fmul_rn(2.0f, __fsub_rn(a, b)), g);
}

// Counting warps for m gathering points: one batch of rounds each at
// least, at most kMaxWarps (the counters, W * R ints, are zeroed and
// scanned by every block).
__host__ __device__ __forceinline__ int counting_warps(int m) {
  return max(1, min(kMaxWarps, cdiv(m, 32 * kBatch)));
}

__host__ __device__ __forceinline__ int targets_per_block(int n) {
  return min(n, kMaxTargets);
}

// Dynamic shared memory of a block whose side has n targets and m
// gathering points: the counters, then (reused) a chunk of float4 terms.
__host__ __device__ __forceinline__ int bwd_smem(int n, int m) {
  return max(counting_warps(m) * targets_per_block(n) * static_cast<int>(sizeof(int)),
             min(m, kTermChunk) * static_cast<int>(sizeof(float4)));
}

// A lane's indices of kBatch rounds from j0 (-1 past end), loaded together
// so that the rounds wait for one load latency, not kBatch.
__device__ __forceinline__ void load_targets(const int* __restrict__ ib, int j0, int end,
                                             int (&tv)[kBatch]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int j = j0 + 32 * u + lane;
    tv[u] = j < end ? ib[j] : -1;
  }
}

// Exclusive scan of v over the block's threads; also their total.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums, int& total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, warps = blockDim.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) warp_sums[w] = incl;
  __syncthreads();
  if (w == 0) {
    int s = lane < warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += u;
    }
    if (lane < warps) warp_sums[lane] = s;   // inclusive
  }
  __syncthreads();
  total = warp_sums[warps - 1];
  return incl - v + (w > 0 ? warp_sums[w - 1] : 0);
}

__global__ void chamfer_bwd_kernel(const float* __restrict__ x, const float* __restrict__ y,
                                   const int* __restrict__ ixy, const int* __restrict__ iyx,
                                   const float* __restrict__ gx, const float* __restrict__ gy,
                                   int k, int K, float* __restrict__ dx, float* __restrict__ dy,
                                   int* __restrict__ order) {
  extern __shared__ float4 dyn[];    // the counters, then the terms
  int* cnt = reinterpret_cast<int*>(dyn);   // [W][R]: per counting warp and target
  __shared__ int warp_sums[32];
  __shared__ int below[kMaxWarps];   // per warp: its points gathered at earlier tiles
  __shared__ int first[kMaxTargets]; // per target: where its segment starts

  // blockIdx -> (cloud, side, tile of targets); the side's points are the
  // targets, the other side's gather at them
  const int tiles_x = cdiv(k, targets_per_block(k));
  const int tiles = tiles_x + cdiv(K, targets_per_block(K));
  const int p = blockIdx.x / tiles;
  const int r = blockIdx.x % tiles;
  const bool is_x = r < tiles_x;
  const ChamferDir d = chamfer_dir(x, y, k, K, p, is_x);
  const int n = d.n, m = d.m;
  const int R = targets_per_block(n);
  const int t0 = (is_x ? r : r - tiles_x) * R;
  const int rt = min(R, n - t0);               // targets in this tile
  const size_t pn = static_cast<size_t>(p) * n, pm = static_cast<size_t>(p) * m;
  const int* ia = (is_x ? ixy : iyx) + pn;     // this side's nearest points
  const int* ib = (is_x ? iyx : ixy) + pm;     // the other side's
  const float* ga = (is_x ? gx : gy) + pn;
  const float* gb = (is_x ? gy : gx) + pm;
  // this side's sorted gathering points: m places per cloud and side, x's first
  int* seg = order + static_cast<size_t>(p) * (k + K) + (is_x ? 0 : K);

  const int W = counting_warps(m);
  const int run = cdiv(cdiv(m, W), 32) * 32;   // points per counting warp
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;

  for (int i = threadIdx.x; i < W * R; i += blockDim.x) cnt[i] = 0;
  __syncthreads();

  // 1. count
  if (w < W) {
    int before = 0;
    const int end = min(m, (w + 1) * run);
    for (int j0 = w * run; j0 < end; j0 += 32 * kBatch) {
      int tv[kBatch];
      load_targets(ib, j0, end, tv);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = j0 + 32 * u + lane, t = tv[u];
        before += __popc(__ballot_sync(kFull, j < end && t >= 0 && t < t0));
        const bool in = j < end && t >= t0 && t < t0 + rt;
        const unsigned peers = __match_any_sync(kFull, in ? t : -1);
        if (in && (peers & lower) == 0) cnt[w * R + (t - t0)] += __popc(peers);
      }
    }
    if (lane == 0) below[w] = before;
  }
  __syncthreads();

  // 2. scan: per target over the warps, then over the targets
  const int tgt = threadIdx.x;
  int count = 0;
  if (tgt < rt) {
    for (int v = 0; v < W; ++v) {
      const int c = cnt[v * R + tgt];
      cnt[v * R + tgt] = count;
      count += c;
    }
  }
  int in_tile;                       // gathering points at this tile's targets
  int start = block_exclusive_scan(count, warp_sums, in_tile);
  int base = 0;                      // ... and at earlier tiles'
  for (int v = 0; v < W; ++v) base += below[v];
  start += base;
  if (tgt < rt) first[tgt] = start;
  __syncthreads();

  // 3. place
  if (w < W) {
    const int end = min(m, (w + 1) * run);
    for (int j0 = w * run; j0 < end; j0 += 32 * kBatch) {
      int tv[kBatch];
      load_targets(ib, j0, end, tv);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = j0 + 32 * u + lane, t = tv[u];
        const bool in = j < end && t >= t0 && t < t0 + rt;
        const unsigned peers = __match_any_sync(kFull, in ? t : -1);
        const int c = in ? w * R + (t - t0) : 0;
        if (in) seg[first[t - t0] + cnt[c] + __popc(peers & lower)] = j;
        __syncwarp();
        if (in && (peers & lower) == 0) cnt[c] += __popc(peers);
        __syncwarp();
      }
    }
  }
  __syncthreads();

  // 4. sum, a chunk of the tile's segments at a time: the block computes
  // the terms of the chunk's gathering points into shared memory (the
  // counters are spent), then each target adds those of its segment, in
  // order, to its running sums
  float4* term = dyn;
  const int chunk = min(m, kTermChunk);
  const bool mine = tgt < rt;
  const int i = t0 + (mine ? tgt : 0);
  const float ax = d.a[3 * i], ay = d.a[3 * i + 1], az = d.a[3 * i + 2];
  float sx = 0.0f, sy = 0.0f, sz = 0.0f;
  for (int c0 = 0; c0 < in_tile; c0 += chunk) {
    const int len = min(chunk, in_tile - c0);
    for (int q = threadIdx.x; q < len; q += blockDim.x) {
      const int j = seg[base + c0 + q];
      const int t = ib[j];
      const float g = gb[j];
      term[q] = make_float4(gather_term(d.b[3 * j], d.a[3 * t], g),
                            gather_term(d.b[3 * j + 1], d.a[3 * t + 1], g),
                            gather_term(d.b[3 * j + 2], d.a[3 * t + 2], g), 0.0f);
    }
    __syncthreads();
    if (mine) {
      const int lo = max(start - base, c0), hi = min(start - base + count, c0 + len);
#pragma unroll 4
      for (int q = lo; q < hi; ++q) {
        const float4 e = term[q - c0];
        sx = __fadd_rn(sx, e.x);
        sy = __fadd_rn(sy, e.y);
        sz = __fadd_rn(sz, e.z);
      }
    }
    __syncthreads();   // the chunk's terms are read
  }
  if (!mine) return;
  const int t = ia[i];
  const float g = ga[i];
  float* out = (is_x ? dx : dy) + 3 * (pn + i);
  out[0] = __fsub_rn(gather_term(ax, d.b[3 * t], g), sx);
  out[1] = __fsub_rn(gather_term(ay, d.b[3 * t + 1], g), sy);
  out[2] = __fsub_rn(gather_term(az, d.b[3 * t + 2], g), sz);
}

}  // namespace

// x: [p, k, 3], y: [p, K, 3] f32; ixy [p, k], iyx [p, K] int32; gx [p, k],
// gy [p, K] f32. dx [p, k, 3], dy [p, K, 3] f32; order: p * (k + K) ints of
// scratch. Returns a cudaError_t value.
extern "C" int chamfer_bwd_launch(const float* x, const float* y, const int* ixy,
                                  const int* iyx, const float* gx, const float* gy, int p,
                                  int k, int K, float* dx, float* dy, int* order,
                                  void* stream) {
  if (p <= 0 || k <= 0 || K <= 0 || k > kChamferMaxPoints || K > kChamferMaxPoints)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(p) *
                           (cdiv(k, targets_per_block(k)) + cdiv(K, targets_per_block(K)));
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // one block shape for both sides: enough warps to count and threads to sum
  int threads = 32, smem = 0;
  const int sides[2][2] = {{k, K}, {K, k}};   // (targets, gathering points)
  for (const auto& nm : sides) {
    threads = max(threads, max(32 * counting_warps(nm[1]),
                               cdiv(targets_per_block(nm[0]), 32) * 32));
    smem = max(smem, bwd_smem(nm[0], nm[1]));
  }
  // the most any launch takes, set once
  constexpr int kCounters = kMaxWarps * kMaxTargets * static_cast<int>(sizeof(int));
  constexpr int kTerms = kTermChunk * static_cast<int>(sizeof(float4));
  constexpr int kMaxSmem = kCounters > kTerms ? kCounters : kTerms;
  static bool smem_set = false;
  if (smem > 48 * 1024 && !smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        chamfer_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  chamfer_bwd_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(x, y, ixy, iyx, gx, gy, k, K, dx,
                                                            dy, order);
  return static_cast<int>(cudaGetLastError());
}
