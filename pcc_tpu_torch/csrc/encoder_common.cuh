// The IPDAE patch encoder's forward, shared by the forward kernel
// (patch_encoder.cu) and the backward kernel (patch_encoder_bwd.cu), so
// that the backward's recomputed selection and activations are the
// forward's bit for bit and the two files cannot drift apart.
//
// Selection: the expanded-form squared distance
// max((sq_i - 2 cross_ij) + sq_j, 0) with one rounding per operation
// (__f*_rn intrinsics are never contracted into FMAs), and an insertion
// that keeps the lower index first among equal distances, as a stable
// ascending sort does: bit-equal to pcc_tpu_torch/ops/knn.py.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "dense.cuh"

namespace pcc {

constexpr int kEncQ = 16;                               // query points per chunk
constexpr int kEncC1 = 32, kEncC2 = 64, kEncC3 = 128;   // SetAbstraction widths
constexpr int kEncP1 = 128, kEncP2 = 256, kEncP3 = 512; // PointNet widths
constexpr int kEncMaxD = 64;                            // latent width the buffers hold
constexpr int kEncMaxN = 1024;                          // points per patch
constexpr int kEncX0 = 3 + kEncC3 + 1;                  // concat row stride (131, padded)
constexpr int kEncSaW = 3 * kEncC1 + kEncC1 + kEncC1 * kEncC2 + kEncC2 +
                        kEncC2 * kEncC3 + kEncC3;       // SetAbstraction weights + biases

// Weights are passed as separate pointers, never gathered in a struct: a
// struct of them made the forward kernel measurably slower on an H100, with
// identical outputs.

// Load one [n, 3] patch as SoA plus squared norms into shared memory.
// Ends with __syncthreads().
__device__ __forceinline__ void load_patch(const float* patch, int n, float* sx,
                                           float* sy, float* sz, float* sq) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    sx[j] = patch[3 * j];
    sy[j] = patch[3 * j + 1];
    sz[j] = patch[3 * j + 2];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    sq[j] = __fadd_rn(__fadd_rn(__fmul_rn(sx[j], sx[j]), __fmul_rn(sy[j], sy[j])),
                      __fmul_rn(sz[j], sz[j]));
  }
  __syncthreads();
}

// Copy the SetAbstraction weights and biases ([in, out] row-major) into
// shared memory at sw (kEncSaW floats, in the order w1 b1 w2 b2 w3 b3).
// No trailing barrier.
__device__ __forceinline__ void load_sa_weights(const float* w1, const float* b1,
                                                const float* w2, const float* b2,
                                                const float* w3, const float* b3,
                                                float* sw) {
  for (int i = threadIdx.x; i < 3 * kEncC1; i += blockDim.x) sw[i] = w1[i];
  sw += 3 * kEncC1;
  for (int i = threadIdx.x; i < kEncC1; i += blockDim.x) sw[i] = b1[i];
  sw += kEncC1;
  for (int i = threadIdx.x; i < kEncC1 * kEncC2; i += blockDim.x) sw[i] = w2[i];
  sw += kEncC1 * kEncC2;
  for (int i = threadIdx.x; i < kEncC2; i += blockDim.x) sw[i] = b2[i];
  sw += kEncC2;
  for (int i = threadIdx.x; i < kEncC2 * kEncC3; i += blockDim.x) sw[i] = w3[i];
  sw += kEncC2 * kEncC3;
  for (int i = threadIdx.x; i < kEncC3; i += blockDim.x) sw[i] = b3[i];
}

// The KNN nearest neighbours of every point of the patch, ascending
// (distance, index): one query per thread, a sorted list in registers.
// nbr[q * KNN + s]. Ends with __syncthreads().
template <int KNN>
__device__ __forceinline__ void select_knn(const float* sx, const float* sy,
                                           const float* sz, const float* sq, int n,
                                           unsigned short* nbr) {
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
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
}

// The patch points of a chunk's queries: qs[i] is query i's point.
// QueryRange is the forward's contiguous chunk c0, c0 + 1, ... (an index
// computation, no barrier to publish it); QueryList is a list in shared
// memory, the backward's winning points.
struct QueryRange {
  int c0;
  __device__ __forceinline__ int operator[](int i) const { return c0 + i; }
};
struct QueryList {
  const int* qs;
  __device__ __forceinline__ int operator[](int i) const { return qs[i]; }
};

// SetAbstraction layer 1 on the centred neighbours of nq queries qs[0..nq):
// h1[r][o], r = i * KNN + slot. No trailing barrier.
template <int KNN, class Q>
__device__ __forceinline__ void sa_layer1(int nq, Q qs,
                                          const unsigned short* nbr, const float* sx,
                                          const float* sy, const float* sz,
                                          const float* sw1, const float* sb1, float* h1) {
  // unsigned indices: / and % by the powers of two are shifts and masks
  const unsigned items = nq * KNN * kEncC1;
  for (unsigned e = threadIdx.x; e < items; e += blockDim.x) {
    const unsigned o = e % kEncC1;
    const unsigned r = e / kEncC1;
    const int q = qs[r / KNN];
    const int j = nbr[q * KNN + r % KNN];
    const float cx = sx[j] - sx[q];
    const float cy = sy[j] - sy[q];
    const float cz = sz[j] - sz[q];
    float acc = cx * sw1[o];
    acc = fmaf(cy, sw1[kEncC1 + o], acc);
    acc = fmaf(cz, sw1[2 * kEncC1 + o], acc);
    h1[r * kEncC1 + o] = fmaxf(acc + sb1[o], 0.0f);
  }
}

// The xyz columns of the concat rows of kEncQ queries. No trailing barrier.
template <class Q>
__device__ __forceinline__ void concat_xyz(Q qs, const float* sx,
                                           const float* sy, const float* sz, float* x0) {
  for (int e = threadIdx.x; e < kEncQ * 3; e += blockDim.x) {
    const int qi = e / 3, c = e % 3;
    const int q = qs[qi];
    x0[qi * kEncX0 + c] = c == 0 ? sx[q] : (c == 1 ? sy[q] : sz[q]);
  }
}

// PointNet layers 1-3 (relu) on kEncQ concat rows x0 -> x1, x2, x3.
// Starts after a barrier; ends with __syncthreads().
__device__ __forceinline__ void pointnet_123(const float* x0, const float* pw1,
                                             const float* pb1, const float* pw2,
                                             const float* pb2, const float* pw3,
                                             const float* pb3, float* x1, float* x2,
                                             float* x3) {
  dense_rows<8, true, true>(x0, kEncX0, kEncQ, 3 + kEncC3, pw1, pb1, kEncP1, x1, kEncP1);
  __syncthreads();
  dense_rows<16, true, true>(x1, kEncP1, kEncQ, kEncP1, pw2, pb2, kEncP2, x2, kEncP2);
  __syncthreads();
  dense_rows<16, true, true>(x2, kEncP2, kEncQ, kEncP2, pw3, pb3, kEncP3, x3, kEncP3);
  __syncthreads();
}

// The whole encoder for the kEncQ queries qs[]: the
// SetAbstraction MLP (weights sw1..sb3 in shared memory) with relu and a max
// over each query's KNN neighbours, the concat with xyz, the PointNet MLP
// (pw1..pb4 in global memory) -> o4 [kEncQ, dout] (no relu on the last
// layer). h1/h2 hold the grouped rows, x1..x3 may alias them. Starts after
// a barrier; ends with __syncthreads().
template <int KNN, class Q>
__device__ __forceinline__ void encoder_chunk(
    Q qs, const unsigned short* nbr, const float* sx, const float* sy,
    const float* sz, const float* sw1, const float* sb1, const float* sw2,
    const float* sb2, const float* sw3, const float* sb3, const float* pw1,
    const float* pb1, const float* pw2, const float* pb2, const float* pw3,
    const float* pb3, const float* pw4, const float* pb4, int dout, float* h1, float* h2,
    float* x0, float* x1, float* x2, float* x3, float* o4) {
  constexpr int kRows = kEncQ * KNN;
  sa_layer1<KNN>(kEncQ, qs, nbr, sx, sy, sz, sw1, sb1, h1);
  __syncthreads();
  dense_rows<8, true, false>(h1, kEncC1, kRows, kEncC1, sw2, sb2, kEncC2, h2, kEncC2);
  __syncthreads();
  // layer 3, relu and the max over each query's KNN neighbours, straight
  // into the concat rows after the query's xyz
  dense_relu_groupmax<KNN, false>(h2, kEncC2, kEncQ, kEncC2, sw3, sb3, kEncC3, x0 + 3,
                                  kEncX0);
  concat_xyz(qs, sx, sy, sz, x0);
  __syncthreads();
  pointnet_123(x0, pw1, pb1, pw2, pb2, pw3, pb3, x1, x2, x3);
  dense_rows<1, false, true>(x3, kEncP3, kEncQ, kEncP3, pw4, pb4, dout, o4, dout);
  __syncthreads();
}

}  // namespace pcc
