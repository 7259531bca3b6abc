// The per-cloud chamfer forward, both directions.
//
// Replaces the TPU kernel pcc_tpu/ops/chamfer_pallas.py::_fwd_kernel
// (entry chamfer_min_dists). For clouds x [P, k, 3] and y [P, K, 3] it
// gives every point of x its nearest point of y, and every point of y its
// nearest point of x, by the argmin of the expansion (a2 - 2 a.b) + b2
// (unclamped, ties to the lowest index), then recomputes the distance at
// that index exactly as |a - b_near|^2. Outputs dxy [P, k], dyx [P, K]
// f32 and ixy [P, k], iyx [P, K] int32.
//
// What bounds it on an H100: operations, 9 per point pair and direction
// (the cross term's 3 products and 2 sums, the doubling, the difference,
// the sum, the minimum) against 12 bytes per point. None may be contracted
// into an FMA, or the indices would differ from the plain version's, so
// each is one instruction: the instruction floor, 9 instructions a pair at
// one per lane and cycle (33.5 T/s), is twice the operations bound at 67
// TFLOP/s (which counts an FMA as two): about 0.29 ms at [8, 8192, 3]
// both ways, 0.02 ms at [128, 512, 3].
// What the design does about it: it spends as close to those 9
// instructions per pair as it can, and keeps every SM issuing.
//  - Each thread holds Q query points in registers (Q = 2 or 8, a template
//    parameter: 8 where both clouds are large, 2 for small clouds, whose
//    blocks would otherwise be too few); the block's candidates sit in
//    shared memory as float4
//    (x, y, z, b2), so one broadcast 16-byte load serves Q pairs and the Q
//    queries' chains are independent.
//  - The candidates run in sub-tiles of kSub: per query a running fminf
//    over the sub-tile (1 instruction a pair, no compare-and-select), then
//    one compare per sub-tile keeps the first sub-tile whose minimum is
//    strictly smaller than the best so far. At the end each query rescans
//    only its best sub-tile for the first index whose expansion equals the
//    minimum: the lowest index among equal minima, as torch.argmin gives.
//  - The candidate side is cut into chunks of `chunk` points (a launch
//    parameter, at most kMaxChunk), one block per (direction, cloud, tile
//    of 128 * Q queries, chunk), so that 8 clouds of 8192 points still
//    give some thousand equal blocks. Where a direction has more than one
//    chunk, each block writes its (minimum, index) and a second kernel
//    merges them in chunk order, an earlier chunk winning ties; (distance,
//    index) with the lowest index winning ties is a total order, so the
//    split changes nothing. The exact distance is recomputed once, by
//    whichever kernel writes the output.

#include <climits>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "chamfer_common.cuh"

namespace {

using namespace pcc;

constexpr int kThreads = 128;
constexpr int kSub = 16;          // candidates per running minimum
constexpr int kMaxChunk = 2048;   // candidates per block (32 KB of float4)
constexpr int kMergeThreads = 256;

// The launch's shape: per direction its query tiles and candidate chunks.
struct FwdShape {
  int P, k, K, qb, chunk;
  __host__ __device__ int tiles(bool is_x) const { return cdiv(is_x ? k : K, qb); }
  __host__ __device__ int splits(bool is_x) const { return cdiv(is_x ? K : k, chunk); }
  __host__ __device__ long long blocks(bool is_x) const {
    return static_cast<long long>(P) * tiles(is_x) * splits(is_x);
  }
  // the partials of a direction: [splits][P * n] floats and ints, x's first;
  // none where a direction has one chunk
  __host__ __device__ size_t part_size(bool is_x) const {
    return splits(is_x) > 1 ? static_cast<size_t>(splits(is_x)) * P * (is_x ? k : K) : 0;
  }
  __host__ __device__ size_t part_offset(bool is_x) const {
    return is_x ? 0 : part_size(true);
  }
};

// The exact |a - b[idx]|^2 and idx into the outputs.
__device__ __forceinline__ void write_nearest(const ChamferDir& d, int p, int i, float ax,
                                              float ay, float az, int idx, float* dxy,
                                              float* dyx, int* ixy, int* iyx) {
  const float dx = __fsub_rn(ax, d.b[3 * idx]);
  const float dy = __fsub_rn(ay, d.b[3 * idx + 1]);
  const float dz = __fsub_rn(az, d.b[3 * idx + 2]);
  const size_t o = static_cast<size_t>(p) * d.n + i;
  (d.is_x ? dxy : dyx)[o] = sq_norm3(dx, dy, dz);
  (d.is_x ? ixy : iyx)[o] = idx;
}

template <int Q>
__global__ void __launch_bounds__(kThreads)
chamfer_fwd_kernel(const float* __restrict__ x, const float* __restrict__ y, FwdShape s,
                   float* __restrict__ dxy, float* __restrict__ dyx, int* __restrict__ ixy,
                   int* __restrict__ iyx, float* __restrict__ part_d, int* __restrict__ part_i) {
  __shared__ float4 cand[kMaxChunk];
  // blockIdx -> (direction, cloud, query tile, chunk), the chunk fastest
  long long b = blockIdx.x;
  const bool is_x = b < s.blocks(true);
  if (!is_x) b -= s.blocks(true);
  const int splits = s.splits(is_x), tiles = s.tiles(is_x);
  const int split = static_cast<int>(b % splits);
  b /= splits;
  const int tile = static_cast<int>(b % tiles);
  const int p = static_cast<int>(b / tiles);
  const ChamferDir d = chamfer_dir(x, y, s.k, s.K, p, is_x);
  const int c0 = split * s.chunk;
  const int len = min(s.chunk, d.m - c0);
  const int padded = cdiv(len, kSub) * kSub;

  // the chunk's candidates, padded to whole sub-tiles with points that no
  // query takes ((a2 - 0) + inf = inf)
  for (int j = threadIdx.x; j < padded; j += kThreads) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, CUDART_INF_F);
    if (j < len) {
      const float* q = d.b + 3 * (c0 + j);
      v = make_float4(q[0], q[1], q[2], sq_norm3(q[0], q[1], q[2]));
    }
    cand[j] = v;
  }
  float ax[Q], ay[Q], az[Q], aa[Q], best[Q];
  int bt[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int i = tile * kThreads * Q + q * kThreads + threadIdx.x;
    ax[q] = ay[q] = az[q] = 0.0f;
    if (i < d.n) {
      ax[q] = d.a[3 * i];
      ay[q] = d.a[3 * i + 1];
      az[q] = d.a[3 * i + 2];
    }
    aa[q] = sq_norm3(ax[q], ay[q], az[q]);
    best[q] = CUDART_INF_F;
    bt[q] = 0;
  }
  __syncthreads();

  for (int t = 0; t < padded; t += kSub) {
    float m[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) m[q] = CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      const float4 c = cand[t + j];
#pragma unroll
      for (int q = 0; q < Q; ++q)
        m[q] = fminf(m[q], expansion(ax[q], ay[q], az[q], aa[q], c.x, c.y, c.z, c.w));
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      if (m[q] < best[q]) {
        best[q] = m[q];
        bt[q] = t;
      }
    }
  }

#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int i = tile * kThreads * Q + q * kThreads + threadIdx.x;
    if (i >= d.n) continue;
    // the first index of the best sub-tile whose expansion is the minimum
    // (the same instructions give the same bits); if none is (NaN inputs),
    // the sub-tile's first
    int jj = bt[q];
    for (int j = 0; j < kSub; ++j) {
      const float4 c = cand[bt[q] + j];
      if (expansion(ax[q], ay[q], az[q], aa[q], c.x, c.y, c.z, c.w) == best[q]) {
        jj = bt[q] + j;
        break;
      }
    }
    if (splits == 1) {
      write_nearest(d, p, i, ax[q], ay[q], az[q], c0 + jj, dxy, dyx, ixy, iyx);
    } else {
      const size_t o = s.part_offset(is_x) + (static_cast<size_t>(split) * s.P + p) * d.n + i;
      part_d[o] = best[q];
      part_i[o] = c0 + jj;
    }
  }
}

// One thread per query of each direction that has more than one chunk: the
// chunks' (minimum, index) in chunk order, a later chunk taken only when
// strictly closer, then the exact distance.
__global__ void __launch_bounds__(kMergeThreads)
chamfer_merge_kernel(const float* __restrict__ x, const float* __restrict__ y, FwdShape s,
                     float* __restrict__ dxy, float* __restrict__ dyx, int* __restrict__ ixy,
                     int* __restrict__ iyx, const float* __restrict__ part_d,
                     const int* __restrict__ part_i) {
  long long g = static_cast<long long>(blockIdx.x) * kMergeThreads + threadIdx.x;
  const long long nx = s.splits(true) > 1 ? static_cast<long long>(s.P) * s.k : 0;
  const long long ny = s.splits(false) > 1 ? static_cast<long long>(s.P) * s.K : 0;
  const bool is_x = g < nx;
  if (!is_x) {
    g -= nx;
    if (g >= ny) return;
  }
  const int n = is_x ? s.k : s.K;
  const size_t stride = static_cast<size_t>(s.P) * n;
  const float* pd = part_d + s.part_offset(is_x) + g;
  const int* pi = part_i + s.part_offset(is_x) + g;
  float best = pd[0];
  int idx = pi[0];
  for (int c = 1; c < s.splits(is_x); ++c) {
    const float v = pd[c * stride];
    if (v < best) {
      best = v;
      idx = pi[c * stride];
    }
  }
  const int p = static_cast<int>(g / n), i = static_cast<int>(g % n);
  const ChamferDir d = chamfer_dir(x, y, s.k, s.K, p, is_x);
  write_nearest(d, p, i, d.a[3 * i], d.a[3 * i + 1], d.a[3 * i + 2], idx, dxy, dyx, ixy, iyx);
}

}  // namespace

// x: [p, k, 3], y: [p, K, 3] f32; q queries per thread (2 or 8), chunks
// of `chunk` candidates (a multiple of kSub, at most kMaxChunk). dxy [p, k],
// dyx [p, K] f32; ixy [p, k], iyx [p, K] int32; part_d, part_i: part_len
// floats and ints of scratch for the partial minima, which must be what the
// launch needs (ops/chamfer_cuda.py::fwd_scratch: (splits) * p * n for each
// direction with more than one chunk, x's first). Returns a cudaError_t
// value.
extern "C" int chamfer_fwd_launch(const float* x, const float* y, int p, int k, int K, int q,
                                  int chunk, float* dxy, float* dyx, int* ixy, int* iyx,
                                  float* part_d, int* part_i, long long part_len,
                                  void* stream) {
  if (p <= 0 || k <= 0 || K <= 0 || (q != 2 && q != 8) || chunk <= 0 || chunk > kMaxChunk ||
      chunk % kSub != 0 || k > kChamferMaxPoints || K > kChamferMaxPoints)
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdShape s{p, k, K, kThreads * q, chunk};
  const long long blocks = s.blocks(true) + s.blocks(false);
  if (blocks > INT_MAX ||
      part_len != static_cast<long long>(s.part_size(true) + s.part_size(false)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto grid = static_cast<unsigned>(blocks);
  if (q == 8)
    chamfer_fwd_kernel<8><<<grid, kThreads, 0, st>>>(x, y, s, dxy, dyx, ixy, iyx, part_d,
                                                     part_i);
  else
    chamfer_fwd_kernel<2><<<grid, kThreads, 0, st>>>(x, y, s, dxy, dyx, ixy, iyx, part_d,
                                                     part_i);
  cudaError_t err = cudaGetLastError();
  const long long merged = (s.splits(true) > 1 ? static_cast<long long>(p) * k : 0) +
                           (s.splits(false) > 1 ? static_cast<long long>(p) * K : 0);
  if (err == cudaSuccess && merged > 0) {
    const auto mblocks = static_cast<unsigned>((merged + kMergeThreads - 1) / kMergeThreads);
    chamfer_merge_kernel<<<mblocks, kMergeThreads, 0, st>>>(x, y, s, dxy, dyx, ixy, iyx,
                                                            part_d, part_i);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
