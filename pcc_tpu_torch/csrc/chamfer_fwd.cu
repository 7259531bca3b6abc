// The per-cloud chamfer forward, both directions, one launch.
//
// Replaces the TPU kernel pcc_tpu/ops/chamfer_pallas.py::_fwd_kernel
// (entry chamfer_min_dists). For clouds x [P, k, 3] and y [P, K, 3] it
// gives every point of x its nearest point of y, and every point of y its
// nearest point of x, by the argmin of the expansion (a2 - 2 a.b) + b2
// (unclamped, ties to the lowest index), then recomputes the distance at
// that index exactly as |a - b_near|^2. Outputs dxy [P, k], dyx [P, K]
// f32 and ixy [P, k], iyx [P, K] int32.
//
// What bounds it on an H100: on paper, operations: 9 per point pair and
// direction against 12 bytes per point, so at 512 x 512 points per cloud
// about 400 operations per byte, far above the card's balance; the floor is
// FLOPs / 67 TFLOP/s (about 9 us for the 128-cloud train batch at N = 512).
// In practice its time is set by latency: a block's loop over the other
// side is a dependent chain of compare-and-select per thread, and small
// clouds give few blocks.
// What the design does about it: one thread per query point keeps its
// running (min, index) in registers; the other side's points and squared
// norms stream through shared memory in tiles of kChamferTile
// (chamfer_common.cuh), all threads reading the same entry (a broadcast).
// Both directions are tiles of one grid, so a launch fills the card with
// P * (k + K) / 128 blocks. A later tile replaces the running minimum only
// when strictly closer, so the lowest index wins across tiles as within.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "chamfer_common.cuh"

namespace {

using namespace pcc;

__global__ void __launch_bounds__(kChamferThreads)
chamfer_fwd_kernel(const float* __restrict__ x, const float* __restrict__ y, int k, int K,
                   float* __restrict__ dxy, float* __restrict__ dyx,
                   int* __restrict__ ixy, int* __restrict__ iyx) {
  __shared__ float sx[kChamferTile], sy[kChamferTile], sz[kChamferTile], sq[kChamferTile];
  const ChamferSide side = chamfer_side(x, y, k, K);
  const int i = side.tile * kChamferThreads + threadIdx.x;
  const bool active = i < side.n;
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  if (active) {
    ax = side.a[3 * i];
    ay = side.a[3 * i + 1];
    az = side.a[3 * i + 2];
  }
  const float aa = sq_norm3(ax, ay, az);
  float best = CUDART_INF_F;
  int bi = 0;
  for (int s = 0; s < side.m; s += kChamferTile) {
    const int len = min(kChamferTile, side.m - s);
    __syncthreads();   // the previous tile is read
    for (int j = threadIdx.x; j < len; j += blockDim.x) {
      const float bx = side.b[3 * (s + j)], by = side.b[3 * (s + j) + 1],
                  bz = side.b[3 * (s + j) + 2];
      sx[j] = bx;
      sy[j] = by;
      sz[j] = bz;
      sq[j] = sq_norm3(bx, by, bz);
    }
    __syncthreads();
    if (active) {
      for (int j = 0; j < len; ++j) {
        const float d = expansion(ax, ay, az, aa, sx[j], sy[j], sz[j], sq[j]);
        if (d < best) {
          best = d;
          bi = s + j;
        }
      }
    }
  }
  if (!active) return;
  const float dx = __fsub_rn(ax, side.b[3 * bi]);
  const float dy = __fsub_rn(ay, side.b[3 * bi + 1]);
  const float dz = __fsub_rn(az, side.b[3 * bi + 2]);
  const size_t o = static_cast<size_t>(blockIdx.x) * side.n + i;
  (side.is_x ? dxy : dyx)[o] = sq_norm3(dx, dy, dz);
  (side.is_x ? ixy : iyx)[o] = bi;
}

}  // namespace

// x: [p, k, 3], y: [p, K, 3] f32. dxy [p, k], dyx [p, K] f32; ixy [p, k],
// iyx [p, K] int32. Returns a cudaError_t value.
extern "C" int chamfer_fwd_launch(const float* x, const float* y, int p, int k, int K,
                                  float* dxy, float* dyx, int* ixy, int* iyx,
                                  void* stream) {
  if (p <= 0 || k <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(p, chamfer_tiles(k, K));
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  chamfer_fwd_kernel<<<grid, kChamferThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, k, K, dxy, dyx, ixy, iyx);
  return static_cast<int>(cudaGetLastError());
}
