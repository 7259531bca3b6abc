// A bf16 reduction as XLA computes it: the sum of a bf16 cotangent over its
// rows, every add rounded to bf16, in the order of XLA's CPU backend.
//
// Replaces no TPU kernel. pcc_tpu's bf16 train step takes the gradient of
// flax's Dense(dtype=bfloat16) bias, and of a bf16 feature tiled over
// points, as a reduce_sum of a bf16 array: an HLO reduction whose adder
// rounds every partial sum to bf16. The order of those adds decides the
// result (a sum of 512 rows moves by several percent between two orders),
// so the port takes XLA's (ops/bf16.py::bf16_reduce_plain is the plain
// version and states it): the rows are a grid of up to three dimensions
// [A, M, K] (the reduced dimensions; a PN++ stage's [B, S, nsample]); where
// a dimension exceeds 32, XLA cuts it into windows of 32 (a dimension of at
// most 32 whole), padding it with zeros at both ends equally, and sums each
// window in row-major order from 0; the windows' sums are then reduced the
// same way, and a grid of at most 32 rows a dimension is summed whole.
// One launch computes one such level.
//
// What bounds it on an H100: the chain of dependent adds, at most 32^3 a
// level per output (a rounded add's latency each), not bytes (the
// cotangent is read once) or operations. A thread takes one (window,
// column) output and walks its window; the threads of a warp take
// neighbouring columns, so each of their loads is one coalesced row. Adds
// and rounding are float32 operations on bf16 values (no FMA: the add is a
// lone __fadd_rn), bit for bit the plain version's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// g: [A, M, K, C]; out: [A2, M2, K2, C], out[a2][m2][k2][c] = the rounded
// sum over the window (a2, m2, k2) of wa x wm x wk rows, rows a = a2 * wa +
// i - pa, m = m2 * wm + h - pm, k = k2 * wk + j - pk (zero outside the
// grid), (i, h, j) in row-major order.
__global__ void bf16_reduce_kernel(const float* __restrict__ g, float* __restrict__ out, int A,
                                   int M, int K, int C, int wa, int wm, int wk, int pa, int pm,
                                   int pk, int A2, int M2, int K2) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<long long>(A2) * M2 * K2 * C) return;
  const int c = static_cast<int>(e % C);
  const long long w = e / C;
  const int a0 = static_cast<int>(w / (static_cast<long long>(M2) * K2)) * wa - pa;
  const int m0 = static_cast<int>((w / K2) % M2) * wm - pm;
  const int k0 = static_cast<int>(w % K2) * wk - pk;
  float acc = 0.0f;
  for (int i = 0; i < wa; ++i) {
    const int a = a0 + i;
    for (int h = 0; h < wm; ++h) {
      const int m = m0 + h;
      for (int j = 0; j < wk; ++j) {
        const int k = k0 + j;
        const float v = (a >= 0 && a < A && m >= 0 && m < M && k >= 0 && k < K)
                            ? g[((static_cast<long long>(a) * M + m) * K + k) * C + c]
                            : 0.0f;
        acc = round_bf16(__fadd_rn(acc, v));
      }
    }
  }
  out[e] = acc;
}

}  // namespace

// One level of the reduction (ops/bf16.py::bf16_reduce sizes it): g [A, M,
// K, C] f32 holding bf16 values, out [A2, M2, K2, C] f32. Returns a
// cudaError_t value.
extern "C" int bf16_reduce_launch(const float* g, float* out, int A, int M, int K, int C,
                                  int wa, int wm, int wk, int pa, int pm, int pk, int A2,
                                  int M2, int K2, void* stream) {
  if (A <= 0 || M <= 0 || K <= 0 || C <= 0 || wa <= 0 || wm <= 0 || wk <= 0 ||
      wa > 32 || wm > 32 || wk > 32 || pa < 0 || pm < 0 || pk < 0 || A2 <= 0 || M2 <= 0 ||
      K2 <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(A2) * M2 * K2 * C;
  const int threads = 256;
  bf16_reduce_kernel<<<static_cast<unsigned>((n + threads - 1) / threads), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(g, out, A, M, K, C, wa, wm, wk, pa,
                                                            pm, pk, A2, M2, K2);
  return static_cast<int>(cudaGetLastError());
}
