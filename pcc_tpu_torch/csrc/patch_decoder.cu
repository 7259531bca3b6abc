// The IPDAE patch decoder after its first two layers: expansion, fold,
// latent tile + concat and the point MLP, one launch.
//
// Replaces the TPU kernel pcc_tpu/ops/decoder_pallas.py::_decoder_kernel
// (entry patch_decoder_fused). Inputs: h2 [P, C] (C = 1024, the inv_pool
// activations after layer 2, computed outside the kernel as pcc_tpu does
// too), the quantized latent lat [P, d], the layer-3 expansion weight w3r
// [C, k*128] with its columns pre-permuted point-major (permute_expansion:
// column j*128 + c holds the reference's channel c of point j) and its bias,
// and the inv_mlp weights (128+d) -> 128 -> 64 -> 32 -> 3. For every patch
// p and point j: fold = relu(h2[p] @ w3r[:, j*128:(j+1)*128] + b3r[...]),
// x = [fold | lat[p]], then the MLP (relu on all but the last layer).
// Output [P, k, 3].
//
// What bounds it on an H100: operations. About 41 MFLOP per patch at
// k = 128, d = 16 (168 GFLOP per batch of 4096 patches), 82% of it the
// 1024 -> k*128 expansion; the expansion weight is 64 MB, larger than L2.
// What the design does about it: a block owns a tile of 64 patches and one
// point j, so it reads its 1024 x 128 weight slice once for the whole tile
// and h2 (16 MB per batch) stays in L2; blockIdx.x runs over patch tiles,
// so the blocks resident at one time share one weight slice. The
// expansion is a shared-memory tiled product with a 4 x 8 register tile per
// thread; the fold and the MLP activations never leave shared memory, so
// device memory sees h2 and lat in and [P, k, 3] out. CUDA cores in float32,
// not tensor cores: the simple form comes first.

#include <cuda_runtime.h>

#include "dense.cuh"

namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr int kBP = 64;         // patches per block
constexpr int kBC = 128;        // fold channels = expansion columns per point
constexpr int kBK = 32;         // reduction depth per staged tile
constexpr int kM1 = 128, kM2 = 64, kM3 = 32, kM4 = 3;   // inv_mlp widths
constexpr int kMaxD = 64;
constexpr int kStage = kBP * (kBK + 1) + kBK * kBC;     // A and B tiles

static_assert(kBP * kM2 + kBP * kM3 <= kStage, "MLP rows must fit the tile area");

__host__ __device__ inline size_t smem_bytes(int d) {
  return sizeof(float) * (static_cast<size_t>(kStage) + kBP * (kBC + d) + kBP * kM1);
}

__global__ void __launch_bounds__(kThreads)
patch_decoder_kernel(const float* __restrict__ h2, const float* __restrict__ lat,
                     int P, int C, int d, int k,
                     const float* __restrict__ w3r, const float* __restrict__ b3r,
                     const float* __restrict__ mw1, const float* __restrict__ mb1,
                     const float* __restrict__ mw2, const float* __restrict__ mb2,
                     const float* __restrict__ mw3, const float* __restrict__ mb3,
                     const float* __restrict__ mw4, const float* __restrict__ mb4,
                     float* __restrict__ out) {
  extern __shared__ float smem[];
  float* as = smem;                        // [kBP, kBK + 1] h2 tile
  float* bs = smem + kBP * (kBK + 1);      // [kBK, kBC] weight tile
  float* y2 = smem;                        // [kBP, kM2] (aliases the tiles)
  float* y3 = smem + kBP * kM2;            // [kBP, kM3]
  const int ldx = kBC + d;
  float* x = smem + kStage;                // [kBP, kBC + d]: fold | lat
  float* y1 = x + kBP * ldx;               // [kBP, kM1]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int p0 = blockIdx.x * kBP;
  const int j = blockIdx.y;
  const size_t ldw = static_cast<size_t>(k) * kBC;
  const float* wj = w3r + static_cast<size_t>(j) * kBC;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;

  for (int k0 = 0; k0 < C; k0 += kBK) {
#pragma unroll
    for (int t = 0; t < (kBP * kBK) / kThreads; ++t) {
      const int e = tid + t * kThreads;
      const int r = e / kBK, kk = e % kBK;
      const int p = p0 + r;
      as[r * (kBK + 1) + kk] = p < P ? h2[static_cast<size_t>(p) * C + k0 + kk] : 0.0f;
    }
#pragma unroll
    for (int t = 0; t < (kBK * kBC) / kThreads; ++t) {
      const int e = tid + t * kThreads;
      const int kk = e / kBC, c = e % kBC;
      bs[kk * kBC + c] = wj[static_cast<size_t>(k0 + kk) * ldw + c];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[(ty + 16 * i) * (kBK + 1) + kk];
#pragma unroll
      for (int c = 0; c < 8; ++c) b[c] = bs[kk * kBC + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
    }
    __syncthreads();
  }

  // fold slot j: relu(expansion + bias), then the tiled latent beside it
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = tx + 16 * c;
      x[(ty + 16 * i) * ldx + col] =
          fmaxf(acc[i][c] + __ldg(b3r + static_cast<size_t>(j) * kBC + col), 0.0f);
    }
  for (int e = tid; e < kBP * d; e += kThreads) {
    const int r = e / d, q = e % d;
    const int p = p0 + r;
    x[r * ldx + kBC + q] = p < P ? lat[static_cast<size_t>(p) * d + q] : 0.0f;
  }
  __syncthreads();
  pcc::dense_rows<8, true, true>(x, ldx, kBP, kBC + d, mw1, mb1, kM1, y1, kM1);
  __syncthreads();
  pcc::dense_rows<8, true, true>(y1, kM1, kBP, kM1, mw2, mb2, kM2, y2, kM2);
  __syncthreads();
  pcc::dense_rows<8, true, true>(y2, kM2, kBP, kM2, mw3, mb3, kM3, y3, kM3);
  __syncthreads();
  for (int e = tid; e < kBP * kM4; e += kThreads) {
    const int r = e / kM4, o = e % kM4;
    const int p = p0 + r;
    if (p < P) {
      float v = 0.0f;
#pragma unroll 8
      for (int kk = 0; kk < kM3; ++kk) v = fmaf(y3[r * kM3 + kk], __ldg(mw4 + kk * kM4 + o), v);
      out[(static_cast<size_t>(p) * k + j) * kM4 + o] = v + __ldg(mb4 + o);
    }
  }
}

}  // namespace

// h2: [P, C] f32 (C % 32 == 0); lat: [P, d]; w3r: [C, k*128]; b3r: [k*128];
// mw1: [128+d, 128], mw2: [128, 64], mw3: [64, 32], mw4: [32, 3] with their
// biases; out: [P, k, 3]. Returns a cudaError_t value.
extern "C" int patch_decoder_launch(const float* h2, const float* lat, int P, int C,
                                    int d, int k, const float* w3r, const float* b3r,
                                    const float* mw1, const float* mb1,
                                    const float* mw2, const float* mb2,
                                    const float* mw3, const float* mb3,
                                    const float* mw4, const float* mb4, float* out,
                                    void* stream) {
  if (P <= 0 || C <= 0 || C % kBK != 0 || d <= 0 || d > kMaxD || k <= 0 || k > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      patch_decoder_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((P + kBP - 1) / kBP, k);
  patch_decoder_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      h2, lat, P, C, d, k, w3r, b3r, mw1, mb1, mw2, mb2, mw3, mb3, mw4, mb4, out);
  return static_cast<int>(cudaGetLastError());
}
