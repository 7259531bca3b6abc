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
// 3.35 TB/s (about 1 us for the 128-cloud train batch at N = 512).
// What the design does about it: nothing yet; it is simple and
// deterministic. TPU's one-hot transpose becomes, per output point, a scan
// of the other side's indices: one thread per point of one side, the other
// side's (index, e') pairs computed into shared memory kChamferTile at a
// time (chamfer_common.cuh), and each thread sums, in ascending order, the
// terms whose index is its own. No atomicAdd, so two launches are bitwise
// equal. The scan costs k * K comparisons per cloud pair and direction,
// the forward's number of pairs; a sort or a counting pass is the faster
// form for a later PR.

#include <cuda_runtime.h>

#include "chamfer_common.cuh"

namespace {

using namespace pcc;

// 2 (a - b) g, per coordinate
__device__ __forceinline__ float gather_term(float a, float b, float g) {
  return __fmul_rn(__fmul_rn(2.0f, __fsub_rn(a, b)), g);
}

__global__ void __launch_bounds__(kChamferThreads)
chamfer_bwd_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   const int* __restrict__ ixy, const int* __restrict__ iyx,
                   const float* __restrict__ gx, const float* __restrict__ gy, int k, int K,
                   float* __restrict__ dx, float* __restrict__ dy) {
  __shared__ int sidx[kChamferTile];
  __shared__ float ex[kChamferTile], ey[kChamferTile], ez[kChamferTile];
  const ChamferSide side = chamfer_side(x, y, k, K);
  const size_t p = blockIdx.x;
  // this side's indices and cotangents, the other side's
  const int* ia = (side.is_x ? ixy + p * k : iyx + p * K);
  const int* ib = (side.is_x ? iyx + p * K : ixy + p * k);
  const float* ga = (side.is_x ? gx + p * k : gy + p * K);
  const float* gb = (side.is_x ? gy + p * K : gx + p * k);
  const int i = side.tile * kChamferThreads + threadIdx.x;
  const bool active = i < side.n;
  float sx = 0.0f, sy = 0.0f, sz = 0.0f;
  for (int s = 0; s < side.m; s += kChamferTile) {
    const int len = min(kChamferTile, side.m - s);
    __syncthreads();   // the previous tile is read
    for (int j = threadIdx.x; j < len; j += blockDim.x) {
      const int jj = s + j;
      const int t = ib[jj];
      const float g = gb[jj];
      sidx[j] = t;
      ex[j] = gather_term(side.b[3 * jj], side.a[3 * t], g);
      ey[j] = gather_term(side.b[3 * jj + 1], side.a[3 * t + 1], g);
      ez[j] = gather_term(side.b[3 * jj + 2], side.a[3 * t + 2], g);
    }
    __syncthreads();
    if (active) {
      for (int j = 0; j < len; ++j) {
        if (sidx[j] == i) {
          sx = __fadd_rn(sx, ex[j]);
          sy = __fadd_rn(sy, ey[j]);
          sz = __fadd_rn(sz, ez[j]);
        }
      }
    }
  }
  if (!active) return;
  const int t = ia[i];
  const float g = ga[i];
  float* out = (side.is_x ? dx + p * k * 3 : dy + p * K * 3) + 3 * i;
  out[0] = __fsub_rn(gather_term(side.a[3 * i], side.b[3 * t], g), sx);
  out[1] = __fsub_rn(gather_term(side.a[3 * i + 1], side.b[3 * t + 1], g), sy);
  out[2] = __fsub_rn(gather_term(side.a[3 * i + 2], side.b[3 * t + 2], g), sz);
}

}  // namespace

// x: [p, k, 3], y: [p, K, 3] f32; ixy [p, k], iyx [p, K] int32; gx [p, k],
// gy [p, K] f32. dx [p, k, 3], dy [p, K, 3] f32. Returns a cudaError_t
// value.
extern "C" int chamfer_bwd_launch(const float* x, const float* y, const int* ixy,
                                  const int* iyx, const float* gx, const float* gy, int p,
                                  int k, int K, float* dx, float* dy, void* stream) {
  if (p <= 0 || k <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(p, chamfer_tiles(k, K));
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  chamfer_bwd_kernel<<<grid, kChamferThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, ixy, iyx, gx, gy, k, K, dx, dy);
  return static_cast<int>(cudaGetLastError());
}
