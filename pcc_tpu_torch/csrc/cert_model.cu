// A check of certified.cuh's model of the bf16 tensor cores on the card:
// for rows x [m, K] and a weight w [K, n] (bf16 values), three sums of each
// output, as the certified kernels form them.
//
// Replaces no TPU kernel. The bf16 encoder and the bf16 "pppf" stage
// (patch_encoder.cu's enc16, pppf_sa_stage.cu's st16) are bit for bit their
// k-order replays only if every tensor-core sum s_tc of certified.cuh's
// cert_mma lies within the bound E of the k-order float32 sum s_k
// (cert_kdot): |s_tc - s_k| <= E, E = cert_err(R, cert_a(K)) from the same
// product's R register. That rests on a model of how Hopper's bf16
// mma.sync accumulates (certified.cuh's header: truncation at every
// addition, a k16 block aligned to its largest exponent). This kernel
// computes s_tc, s_k and E with those very functions, so the ratio
// |s_tc - s_k| / E, measured on rows built to stress the model
// (ops/certified.py::stress_rows), says whether the model holds on this
// card. One warp a (16-row, 8-column) tile: its rows copied to shared
// memory as the kernels keep them (bf16, ld = Kp + 8), one cert_mma<1, 1>,
// then cert_kdot of each of its entries. Bound by nothing that matters: it
// runs on a few thousand entries, once.

#include <cuda_runtime.h>

#include "certified.cuh"

namespace {

using namespace pcc_cert;

__global__ void __launch_bounds__(32)
cert_model_kernel(const unsigned short* __restrict__ x, int kp, int k_depth,
                  const uint2* __restrict__ frag, int n, float* __restrict__ s_tc,
                  float* __restrict__ s_k, float* __restrict__ err) {
  extern __shared__ __align__(16) unsigned short rows[];
  const int ld = kp + 8;
  const int lane = threadIdx.x, j = blockIdx.x, r0 = 16 * blockIdx.y;
  for (int e = lane; e < 16 * kp; e += 32) rows[(e / kp) * ld + e % kp] = x[r0 * kp + e];
  __syncwarp();
  const int ks = kp / 16;
  float s[1][1][4], r[1][1][4];
  cert_mma<1, 1, false>(rows, ld, 0, frag, ks, j, s, r);
  const float ak = cert_a(k_depth);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), c = 8 * j + 2 * t + (e & 1);
    const size_t o = static_cast<size_t>(r0 + row) * n + c;
    s_tc[o] = s[0][0][e];
    err[o] = cert_err(r[0][0][e], ak);
    s_k[o] = cert_kdot<false>(rows + row * ld, frag, ks, c);
  }
}

}  // namespace

// x: [m, kp] bf16 (m a multiple of 16, kp of 16, zeros past the depth
// k_depth); frag: w [k_depth, n] packed by ops/certified.py::pack_frags (n
// a multiple of 8, n_align 8); s_tc, s_k, err: [m, n] f32. Returns a
// cudaError_t value.
extern "C" int cert_model_launch(const unsigned short* x, int m, int kp, int k_depth,
                                 const void* frag, int n, float* s_tc, float* s_k, float* err,
                                 void* stream) {
  if (m <= 0 || m % 16 != 0 || kp <= 0 || kp % 16 != 0 || k_depth <= 0 || k_depth > kp ||
      n <= 0 || n % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(16) * (kp + 8) * sizeof(unsigned short);
  cudaError_t e = cudaFuncSetAttribute(cert_model_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cert_model_kernel<<<dim3(n / 8, m / 16), 32, smem, static_cast<cudaStream_t>(stream)>>>(
      x, kp, k_depth, static_cast<const uint2*>(frag), n, s_tc, s_k, err);
  return static_cast<int>(cudaGetLastError());
}
