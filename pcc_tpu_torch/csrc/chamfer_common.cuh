// The chamfer kernels' shared arithmetic (chamfer_fwd.cu, chamfer_bwd.cu).
//
// Every operation rounds once (__f*_rn intrinsics, which are never
// contracted into FMAs), in the order of the plain PyTorch version
// (pcc_tpu_torch/ops/knn.py::expanded_sq_dists, ops/chamfer_cuda.py), so
// the nearest-neighbour indices are bit-equal on the card and the CPU.
//
// Limits of both launches: a cloud holds at most kChamferMaxPoints points,
// so that a point's index and 3 * index stay in int32; the forward's grid
// has at most INT_MAX blocks. No other bound: neither kernel stages a whole
// cloud, so k * K is free (pcc_tpu's Pallas kernel, which holds one pair's
// [k, K] problem in VMEM, keeps k * K <= 2^19).

#pragma once

#include <cuda_runtime.h>

namespace pcc {

constexpr int kChamferMaxPoints = 1 << 29;

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

// One direction of a cloud pair: the points `a` (n of them) that look for
// their nearest point among the other side's `b` (m of them), both [., 3]
// row-major; is_x when a is x.
struct ChamferDir {
  const float* a;
  const float* b;
  int n, m;
  bool is_x;
};

__device__ __forceinline__ ChamferDir chamfer_dir(const float* x, const float* y, int k,
                                                  int K, int p, bool is_x) {
  const float* xp = x + static_cast<size_t>(p) * k * 3;
  const float* yp = y + static_cast<size_t>(p) * K * 3;
  return is_x ? ChamferDir{xp, yp, k, K, true} : ChamferDir{yp, xp, K, k, false};
}

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace pcc
