// The whole IPDAE patch encoder, one block per patch, one launch.
//
// Replaces the TPU kernel pcc_tpu/ops/sa_pallas.py::_encoder_kernel
// (entry patch_encoder_fused). Per [N, 3] patch it computes: the
// expanded-form squared distances max((sq_i - 2 cross_ij) + sq_j, 0); the
// knn nearest neighbours of every point in ascending (distance, index)
// order; the centred neighbours; the SetAbstraction MLP 3 -> 32 -> 64 ->
// 128 with relu and a max over neighbours; the concat with xyz (131
// channels); the PointNet MLP 131 -> 128 -> 256 -> 512 -> D (no relu on the
// last layer) and a max over points. Output: the pre-spread latent [P, D].
//
// What bounds it on an H100: operations. About 181 MFLOP per patch at
// N = 256, knn = 16, D = 16 (0.74 TFLOP per 64-cloud batch of 4096
// patches) against 12 KB of input, so far above the card's bytes-to-FLOP
// balance; in float32 on CUDA cores the floor is FLOPs / 67 TFLOP/s.
// What the design does about it: nothing of the grouped activations leaves
// the SM. The TPU kernel's [N, N] distance matrix (256 KB) does not fit in
// shared memory, so each thread keeps a sorted top-knn list of one query
// in registers while it scans the patch's points (held in shared memory).
// The MLPs then run over chunks of 16 query points: the 16 x knn grouped
// rows of the SetAbstraction MLP, and the 16 rows of the PointNet MLP, live
// in shared memory; the SetAbstraction weights (41 KB) sit in shared
// memory and the PointNet weights (755 KB) are read through L2. Each layer
// is the simple register-reuse product of dense.cuh on CUDA cores, not a
// tensor-core product; that, and one 256-thread block per SM (about 165 KB
// of shared memory), are what a later, faster version changes.
//
// Selection is bit-equal to the plain PyTorch version
// (pcc_tpu_torch/ops/sa_cuda.py::patch_encoder_plain): the same distance
// formula, one rounding per operation (__f*_rn intrinsics are never
// contracted into FMAs), and an insertion that keeps the lower index first
// among equal distances, as a stable ascending sort does.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "dense.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQ = 16;                     // query points per MLP chunk
constexpr int kC1 = 32, kC2 = 64, kC3 = 128;     // SetAbstraction widths
constexpr int kP1 = 128, kP2 = 256, kP3 = 512;   // PointNet widths
constexpr int kMaxD = 64;                  // latent width the buffers hold
constexpr int kMaxN = 1024;                // points per patch
constexpr int kX0 = 3 + kC3 + 1;           // concat row stride (131, padded)

struct Layout {
  int sx, sy, sz, sq;                // patch points (SoA) and squared norms
  int w1, b1, w2, b2, w3, b3;        // SetAbstraction weights
  int h;                             // grouped rows; aliased by PointNet rows
  int x0, o, lat;                    // concat rows, last-layer rows, running max
  int floats;                        // float words before the neighbour table
  size_t bytes;                      // total dynamic shared memory
};

__host__ __device__ inline Layout make_layout(int n, int knn) {
  Layout L;
  int off = 0;
  L.sx = off; off += n;
  L.sy = off; off += n;
  L.sz = off; off += n;
  L.sq = off; off += n;
  L.w1 = off; off += 3 * kC1;
  L.b1 = off; off += kC1;
  L.w2 = off; off += kC1 * kC2;
  L.b2 = off; off += kC2;
  L.w3 = off; off += kC2 * kC3;
  L.b3 = off; off += kC3;
  const int grouped = kQ * knn * (kC1 + kC2);
  const int pointnet = kQ * (kP1 + kP2 + kP3);
  L.h = off; off += grouped > pointnet ? grouped : pointnet;
  L.x0 = off; off += kQ * kX0;
  L.o = off; off += kQ * kMaxD;
  L.lat = off; off += kMaxD;
  L.floats = off;
  L.bytes = static_cast<size_t>(off) * sizeof(float) +
            static_cast<size_t>(n) * knn * sizeof(unsigned short);
  return L;
}

template <int KNN>
__global__ void __launch_bounds__(kThreads)
patch_encoder_kernel(const float* __restrict__ pts, int n,
                     const float* __restrict__ w1, const float* __restrict__ b1,
                     const float* __restrict__ w2, const float* __restrict__ b2,
                     const float* __restrict__ w3, const float* __restrict__ b3,
                     const float* __restrict__ pw1, const float* __restrict__ pb1,
                     const float* __restrict__ pw2, const float* __restrict__ pb2,
                     const float* __restrict__ pw3, const float* __restrict__ pb3,
                     const float* __restrict__ pw4, const float* __restrict__ pb4,
                     int dout, float* __restrict__ out) {
  const Layout L = make_layout(n, KNN);
  extern __shared__ float smem[];
  float* sx = smem + L.sx;
  float* sy = smem + L.sy;
  float* sz = smem + L.sz;
  float* sq = smem + L.sq;
  float* sw1 = smem + L.w1;
  float* sb1 = smem + L.b1;
  float* sw2 = smem + L.w2;
  float* sb2 = smem + L.b2;
  float* sw3 = smem + L.w3;
  float* sb3 = smem + L.b3;
  float* h1 = smem + L.h;                  // [kQ*KNN, kC1]
  float* h2 = h1 + kQ * KNN * kC1;         // [kQ*KNN, kC2]
  float* x1 = smem + L.h;                  // [kQ, kP1] (aliases h1/h2)
  float* x2 = x1 + kQ * kP1;               // [kQ, kP2]
  float* x3 = x2 + kQ * kP2;               // [kQ, kP3]
  float* x0 = smem + L.x0;                 // [kQ, kX0]
  float* o4 = smem + L.o;                  // [kQ, dout]
  float* lat = smem + L.lat;               // [dout]
  unsigned short* nbr = reinterpret_cast<unsigned short*>(smem + L.floats);

  const int tid = threadIdx.x;
  const float* patch = pts + static_cast<size_t>(blockIdx.x) * n * 3;
  for (int j = tid; j < n; j += blockDim.x) {
    sx[j] = patch[3 * j];
    sy[j] = patch[3 * j + 1];
    sz[j] = patch[3 * j + 2];
  }
  for (int i = tid; i < 3 * kC1; i += blockDim.x) sw1[i] = w1[i];
  for (int i = tid; i < kC1 * kC2; i += blockDim.x) sw2[i] = w2[i];
  for (int i = tid; i < kC2 * kC3; i += blockDim.x) sw3[i] = w3[i];
  for (int i = tid; i < kC1; i += blockDim.x) sb1[i] = b1[i];
  for (int i = tid; i < kC2; i += blockDim.x) sb2[i] = b2[i];
  for (int i = tid; i < kC3; i += blockDim.x) sb3[i] = b3[i];
  for (int i = tid; i < dout; i += blockDim.x) lat[i] = -CUDART_INF_F;
  __syncthreads();
  for (int j = tid; j < n; j += blockDim.x) {
    sq[j] = __fadd_rn(__fadd_rn(__fmul_rn(sx[j], sx[j]), __fmul_rn(sy[j], sy[j])),
                      __fmul_rn(sz[j], sz[j]));
  }
  __syncthreads();

  // knn selection: one query per thread, a sorted list in registers
  for (int q = tid; q < n; q += blockDim.x) {
    float bd[KNN];
    int bi[KNN];
#pragma unroll
    for (int s = 0; s < KNN; ++s) {
      bd[s] = CUDART_INF_F;
      bi[s] = 0;
    }
    const float qx = sx[q], qy = sy[q], qz = sz[q], qq = sq[q];
    for (int j = 0; j < n; ++j) {
      const float cross = __fadd_rn(
          __fadd_rn(__fmul_rn(qx, sx[j]), __fmul_rn(qy, sy[j])), __fmul_rn(qz, sz[j]));
      const float d =
          fmaxf(__fadd_rn(__fsub_rn(qq, __fmul_rn(2.0f, cross)), sq[j]), 0.0f);
      if (d < bd[KNN - 1]) {
        // insert after every entry <= d: equal distances keep index order
        bool placed = false;
#pragma unroll
        for (int s = KNN - 1; s >= 0; --s) {
          if (!placed) {
            if (s > 0 && d < bd[s - 1]) {
              bd[s] = bd[s - 1];
              bi[s] = bi[s - 1];
            } else {
              bd[s] = d;
              bi[s] = j;
              placed = true;
            }
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < KNN; ++s) nbr[q * KNN + s] = static_cast<unsigned short>(bi[s]);
  }
  __syncthreads();

  constexpr int kRows = kQ * KNN;
  for (int c0 = 0; c0 < n; c0 += kQ) {
    // SetAbstraction layer 1 on the centred neighbours (row = query * KNN + slot)
    for (int e = tid; e < kRows * kC1; e += blockDim.x) {
      const int o = e % kC1;
      const int r = e / kC1;
      const int q = c0 + r / KNN;
      const int j = nbr[c0 * KNN + r];
      const float cx = sx[j] - sx[q];
      const float cy = sy[j] - sy[q];
      const float cz = sz[j] - sz[q];
      float acc = cx * sw1[o];
      acc = fmaf(cy, sw1[kC1 + o], acc);
      acc = fmaf(cz, sw1[2 * kC1 + o], acc);
      h1[r * kC1 + o] = fmaxf(acc + sb1[o], 0.0f);
    }
    __syncthreads();
    pcc::dense_rows<8, true, false>(h1, kC1, kRows, kC1, sw2, sb2, kC2, h2, kC2);
    __syncthreads();
    // layer 3, relu and the max over each query's KNN neighbours, straight
    // into the concat rows after the query's xyz
    pcc::dense_relu_groupmax<KNN, false>(h2, kC2, kQ, kC2, sw3, sb3, kC3, x0 + 3, kX0);
    for (int e = tid; e < kQ * 3; e += blockDim.x) {
      const int qi = e / 3, c = e % 3;
      const int q = c0 + qi;
      x0[qi * kX0 + c] = c == 0 ? sx[q] : (c == 1 ? sy[q] : sz[q]);
    }
    __syncthreads();
    pcc::dense_rows<8, true, true>(x0, kX0, kQ, 3 + kC3, pw1, pb1, kP1, x1, kP1);
    __syncthreads();
    pcc::dense_rows<16, true, true>(x1, kP1, kQ, kP1, pw2, pb2, kP2, x2, kP2);
    __syncthreads();
    pcc::dense_rows<16, true, true>(x2, kP2, kQ, kP2, pw3, pb3, kP3, x3, kP3);
    __syncthreads();
    pcc::dense_rows<1, false, true>(x3, kP3, kQ, kP3, pw4, pb4, dout, o4, dout);
    __syncthreads();
    if (tid < dout) {
      float m = lat[tid];
      for (int r = 0; r < kQ; ++r) m = fmaxf(m, o4[r * dout + tid]);
      lat[tid] = m;
    }
  }
  __syncthreads();
  if (tid < dout) out[static_cast<size_t>(blockIdx.x) * dout + tid] = lat[tid];
}

template <int KNN>
int launch(const float* pts, int p, int n, const float* const* w, int dout,
           float* out, cudaStream_t stream) {
  const Layout L = make_layout(n, KNN);
  cudaError_t err = cudaFuncSetAttribute(patch_encoder_kernel<KNN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  patch_encoder_kernel<KNN><<<p, kThreads, L.bytes, stream>>>(
      pts, n, w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7], w[8], w[9], w[10],
      w[11], w[12], w[13], dout, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pts: [p, n, 3] f32. Weights [in, out] row-major f32 and biases [out]:
// SetAbstraction 3->32->64->128, PointNet 131->128->256->512->dout.
// out: [p, dout] f32. Returns a cudaError_t value.
extern "C" int patch_encoder_launch(const float* pts, int p, int n, int knn,
                                    const float* w1, const float* b1,
                                    const float* w2, const float* b2,
                                    const float* w3, const float* b3,
                                    const float* pw1, const float* pb1,
                                    const float* pw2, const float* pb2,
                                    const float* pw3, const float* pb3,
                                    const float* pw4, const float* pb4, int dout,
                                    float* out, void* stream) {
  if (p <= 0 || n % kQ != 0 || n > kMaxN || n < knn || dout <= 0 || dout > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* w[14] = {w1, b1, w2, b2, w3, b3, pw1, pb1, pw2, pb2, pw3, pb3, pw4, pb4};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (knn) {
    case 8:
      return launch<8>(pts, p, n, w, dout, out, s);
    case 16:
      return launch<16>(pts, p, n, w, dout, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
