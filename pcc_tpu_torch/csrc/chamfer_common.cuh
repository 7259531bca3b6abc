// The chamfer kernels' shared arithmetic and layout (chamfer_fwd.cu,
// chamfer_bwd.cu).
//
// Both kernels run one launch over a grid (cloud, tile of points), the
// tiles of x's points first, then y's: a block owns kThreads points of one
// side of one cloud pair, one point per thread, and streams the other
// side's points through shared memory kTile at a time, so no cloud is
// ever staged whole (pcc_tpu's domain reaches k = 8 against K = 65536).
//
// Every operation rounds once (__f*_rn intrinsics, which are never
// contracted into FMAs), in the order of the plain PyTorch version
// (pcc_tpu_torch/ops/knn.py::expanded_sq_dists, ops/chamfer_cuda.py), so
// the nearest-neighbour indices are bit-equal on the card and the CPU.

#pragma once

#include <cuda_runtime.h>

namespace pcc {

constexpr int kChamferThreads = 128;   // points of one side per block
constexpr int kChamferTile = 1024;     // points of the other side per pass

// One side of a cloud pair as a block sees it: its own points `a` (n of
// them), the other side's points `b` (m of them), both [., 3] row-major,
// and which of the grid's tiles this block's points are.
struct ChamferSide {
  const float* a;
  const float* b;
  int n, m;
  int tile;
  bool is_x;
};

// The side of blockIdx: tiles [0, tiles_x) are x's points, the rest y's.
__device__ __forceinline__ ChamferSide chamfer_side(const float* x, const float* y,
                                                    int k, int K) {
  const int p = blockIdx.x;
  const int tiles_x = (k + kChamferThreads - 1) / kChamferThreads;
  const float* xp = x + static_cast<size_t>(p) * k * 3;
  const float* yp = y + static_cast<size_t>(p) * K * 3;
  const int t = blockIdx.y;
  if (t < tiles_x) return ChamferSide{xp, yp, k, K, t, true};
  return ChamferSide{yp, xp, K, k, t - tiles_x, false};
}

__host__ inline int chamfer_tiles(int k, int K) {
  return (k + kChamferThreads - 1) / kChamferThreads +
         (K + kChamferThreads - 1) / kChamferThreads;
}

// (x*x + y*y) + z*z
__device__ __forceinline__ float sq_norm3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// The selection distance (aa - 2 (ax*bx + ay*by + az*bz)) + bb, unclamped.
__device__ __forceinline__ float expansion(float ax, float ay, float az, float aa,
                                           float bx, float by, float bz, float bb) {
  const float cross =
      __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)), __fmul_rn(az, bz));
  return __fadd_rn(__fsub_rn(aa, __fmul_rn(2.0f, cross)), bb);
}

}  // namespace pcc
