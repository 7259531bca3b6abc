// The IPDAE patch encoder's forward, shared by the forward kernel
// (patch_encoder.cu), the backward kernel (patch_encoder_bwd.cu) and
// SetAbstraction alone (sa_fused.cu), so that the backward's recomputed
// selection and activations are the forward's bit for bit and the files
// cannot drift apart. Blocks of kEncThreads threads.
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

constexpr int kEncThreads = 256;                        // threads per block
constexpr int kEncQ = 16;                               // N % kEncQ == 0; the backward's winners per chunk
constexpr int kEncPnQ = 32;                             // points per PointNet chunk
constexpr int kEncSaRows = 128;                         // grouped rows per SetAbstraction step
constexpr int kEncC1 = 32, kEncC2 = 64, kEncC3 = 128;   // SetAbstraction widths
constexpr int kEncP1 = 128, kEncP2 = 256, kEncP3 = 512; // PointNet widths
constexpr int kEncMaxD = 64;                            // latent width the buffers hold
constexpr int kEncMaxN = 1024;                          // points per patch
constexpr int kEncX0 = 3 + kEncC3 + 1;                  // concat row stride (131, padded)
constexpr int kEncSaW = 3 * kEncC1 + kEncC1 + kEncC1 * kEncC2 + kEncC2 +
                        kEncC2 * kEncC3 + kEncC3;       // SetAbstraction weights + biases
constexpr int kEncP3Step = 256;                         // PointNet layer-3 columns per step
constexpr int kEncX3 = kEncP3Step + 4;                  // their row stride (rows in other banks)
// A chunk's shared memory, in floats: x0 [kEncPnQ][kEncX0], x1 [kEncPnQ][kEncP1],
// x2 [kEncPnQ][kEncP2], one after the other. The SetAbstraction rows
// h1 [kEncSaRows][kEncC1] and h2 [kEncSaRows][kEncC2] alias x1 and x2; a step
// of layer 3 [kEncPnQ][kEncX3] aliases x0 and x1; the last layer's rows o4
// [kEncPnQ][dout] alias x2.
constexpr int kEncX1Off = kEncPnQ * kEncX0;
constexpr int kEncX2Off = kEncX1Off + kEncPnQ * kEncP1;
constexpr int kEncChunkWords = kEncX2Off + kEncPnQ * kEncP2;
static_assert(kEncSaRows * (kEncC1 + kEncC2) <= kEncChunkWords - kEncX1Off,
              "the grouped rows fit in x1 and x2");
static_assert(kEncPnQ * kEncX3 <= kEncX2Off, "a layer-3 step fits in x0 and x1");
static_assert(kEncPnQ * kEncMaxD <= kEncPnQ * kEncP2, "o4 fits in x2");
static_assert(kEncPnQ % kEncQ == 0 && kEncQ % (kEncSaRows / 8) == 0,
              "chunks hold whole SetAbstraction steps");

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

// The KNN nearest neighbours of point q of the patch, ascending (distance,
// index), a sorted list in registers: nbr[q * KNN + s].
template <int KNN>
__device__ __forceinline__ void knn_of(int q, const float* sx, const float* sy, const float* sz,
                                       const float* sq, int n, unsigned short* nbr) {
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

// The KNN nearest neighbours of every point of the patch (knn_of): one
// query per thread. Ends with __syncthreads().
template <int KNN>
__device__ __forceinline__ void select_knn(const float* sx, const float* sy,
                                           const float* sz, const float* sq, int n,
                                           unsigned short* nbr) {
  for (int q = threadIdx.x; q < n; q += blockDim.x) knn_of<KNN>(q, sx, sy, sz, sq, n, nbr);
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
// h1[r][o], r = i * KNN + slot. kBf16: the centred neighbour and the output
// rounded to bf16 (the weights are bf16-exact). No trailing barrier.
template <int KNN, bool kBf16 = false, class Q>
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
    const float cx = pcc_bf16::act_round<kBf16>(sx[j] - sx[q]);
    const float cy = pcc_bf16::act_round<kBf16>(sy[j] - sy[q]);
    const float cz = pcc_bf16::act_round<kBf16>(sz[j] - sz[q]);
    float acc = cx * sw1[o];
    acc = fmaf(cy, sw1[kEncC1 + o], acc);
    acc = fmaf(cz, sw1[2 * kEncC1 + o], acc);
    h1[r * kEncC1 + o] = pcc_bf16::act_round<kBf16>(fmaxf(acc + sb1[o], 0.0f));
  }
}

// The xyz columns of the concat rows of nq queries (rounded to bf16 with
// kBf16). No trailing barrier.
template <bool kBf16 = false, class Q>
__device__ __forceinline__ void concat_xyz(int nq, Q qs, const float* sx,
                                           const float* sy, const float* sz, float* x0) {
  for (int e = threadIdx.x; e < nq * 3; e += blockDim.x) {
    const int qi = e / 3, c = e % 3;
    const int q = qs[qi];
    x0[qi * kEncX0 + c] = pcc_bf16::act_round<kBf16>(c == 0 ? sx[q] : (c == 1 ? sy[q] : sz[q]));
  }
}

// PointNet layers 1-3 (relu) on kEncQ concat rows x0 -> x1, x2, x3, in the
// simple product of dense.cuh (the backward's winners); kBf16: every output
// rounded to bf16. Starts after a barrier; ends with __syncthreads().
template <bool kBf16 = false>
__device__ __forceinline__ void pointnet_123(const float* x0, const float* pw1,
                                             const float* pb1, const float* pw2,
                                             const float* pb2, const float* pw3,
                                             const float* pb3, float* x1, float* x2,
                                             float* x3) {
  dense_rows<8, true, true, kBf16>(x0, kEncX0, kEncQ, 3 + kEncC3, pw1, pb1, kEncP1, x1,
                                   kEncP1);
  __syncthreads();
  dense_rows<16, true, true, kBf16>(x1, kEncP1, kEncQ, kEncP1, pw2, pb2, kEncP2, x2, kEncP2);
  __syncthreads();
  dense_rows<16, true, true, kBf16>(x2, kEncP2, kEncQ, kEncP2, pw3, pb3, kEncP3, x3, kEncP3);
  __syncthreads();
}

// SetAbstraction for the kEncSaRows / KNN queries qs[0 ..): layer 1 on the
// centred neighbours into h1, layer 2 into h2, layer 3 with relu and the max
// over each query's KNN neighbours into out[i][0 .. kEncC3) (row stride
// ld_out, shared or device memory). Weights [in, out] and biases in device
// memory, 16-byte aligned. Starts after a barrier that frees h2 from its
// last reader; no trailing barrier (the next step's layer 1 may start: it
// writes h1, which layer 3 does not read). kBf16: every layer's input and
// output bf16 (sa_layer1, dense_tile).
template <int KNN, bool kBf16 = false, class Q>
__device__ __forceinline__ void sa_step(Q qs, const unsigned short* nbr, const float* sx,
                                        const float* sy, const float* sz,
                                        const float* __restrict__ w1,
                                        const float* __restrict__ b1,
                                        const float* __restrict__ w2,
                                        const float* __restrict__ b2,
                                        const float* __restrict__ w3,
                                        const float* __restrict__ b3, float* h1, float* h2,
                                        float* out, int ld_out) {
  sa_layer1<KNN, kBf16>(kEncSaRows / KNN, qs, nbr, sx, sy, sz, w1, b1, h1);
  __syncthreads();
  dense_tile<8, kTileRelu, kBf16>(h1, kEncC1, kEncSaRows, kEncC1, w2, kEncC2, b2, kEncC2, h2,
                                  kEncC2);
  __syncthreads();
  dense_tile<KNN, kTileGroupMax, kBf16>(h2, kEncC2, kEncSaRows, kEncC2, w3, kEncC3, b3, kEncC3,
                                        out, ld_out);
}

// PointNet's last layer, a step of it: acc[i] += x3[r][k] * pw4[c0 + k][o]
// for k in [0, kEncP3Step) in order, over the items e = threadIdx.x + i *
// kEncThreads of the kEncPnQ x dout outputs (4 columns an item with kVec).
template <bool kVec>
__device__ __forceinline__ void last_layer_step(const float* x3, const float* __restrict__ pw4,
                                                int c0, int dout, float* acc) {
  constexpr int kV = kVec ? 4 : 1;
  const int per_row = dout / kV;
#pragma unroll
  for (int i = 0; i < kEncPnQ * kEncMaxD / kEncThreads / kV; ++i) {
    const int e = threadIdx.x + i * kEncThreads;
    if (e >= kEncPnQ * per_row) break;
    const int r = e / per_row, o = (e % per_row) * kV;
    const float* x = x3 + r * kEncX3;
    const float* w = pw4 + static_cast<size_t>(c0) * dout + o;
    float* a = acc + kV * i;
    for (int k = 0; k < kEncP3Step; ++k) {
      const float xv = x[k];
      if (kVec) {
        const float4 wv = __ldg(reinterpret_cast<const float4*>(w + k * dout));
        a[0] = fmaf(xv, wv.x, a[0]);
        a[1] = fmaf(xv, wv.y, a[1]);
        a[2] = fmaf(xv, wv.z, a[2]);
        a[3] = fmaf(xv, wv.w, a[3]);
      } else {
        a[0] = fmaf(xv, __ldg(w + k * dout), a[0]);
      }
    }
  }
}

// The whole encoder for the nq points c0, c0 + 1, ... of the patch (nq <=
// kEncPnQ, a multiple of kEncQ): the SetAbstraction MLP with relu and a max
// over each point's KNN neighbours, the concat with xyz, the PointNet MLP ->
// o4 [nq][dout] at buf + kEncX2Off (no relu on the last layer). buf:
// kEncChunkWords floats of shared memory. Weights [in, out] and biases in
// device memory, 16-byte aligned. Every output sums acc = fma(x[k], w[k][o],
// acc) for k = 0, 1, ... from 0, then + b: the sums of dense_rows. PointNet
// runs on kEncPnQ rows (rows past nq are 0), layer 1 with 4 rows a thread
// (every warp busy), layers 2 and 3 with 8; layer 3 in steps of kEncP3Step
// columns, each folded straight into the last layer's sums, which stay in
// registers. Starts after a barrier; ends with __syncthreads(). kBf16 (the
// bf16 instance, pcc_tpu's sa_pallas.py:163-210 with compute_dtype
// bfloat16; the weights and biases bf16-exact, rounded by the wrapper): the
// centred neighbours, xyz and every layer's output rounded to bf16, the last
// layer's after its bias; the maxima are float32 over those bf16 values.
template <int KNN, bool kBf16 = false>
__device__ __forceinline__ void encoder_chunk(
    int c0, int nq, const unsigned short* nbr, const float* sx, const float* sy,
    const float* sz, const float* w1, const float* b1, const float* w2, const float* b2,
    const float* w3, const float* b3, const float* pw1, const float* pb1, const float* pw2,
    const float* pb2, const float* pw3, const float* pb3, const float* __restrict__ pw4,
    const float* __restrict__ pb4, int dout, float* buf) {
  float* x0 = buf;
  float* x1 = buf + kEncX1Off;
  float* x2 = buf + kEncX2Off;
  float* x3 = buf;
  constexpr int kSaQ = kEncSaRows / KNN;
  for (int q0 = 0; q0 < nq; q0 += kSaQ)
    sa_step<KNN, kBf16>(QueryRange{c0 + q0}, nbr, sx, sy, sz, w1, b1, w2, b2, w3, b3, x1,
                        x1 + kEncSaRows * kEncC1, x0 + q0 * kEncX0 + 3, kEncX0);
  concat_xyz<kBf16>(nq, QueryRange{c0}, sx, sy, sz, x0);
  for (int e = nq * kEncX0 + threadIdx.x; e < kEncPnQ * kEncX0; e += blockDim.x) x0[e] = 0.0f;
  __syncthreads();
  dense_tile<4, kTileRelu, kBf16>(x0, kEncX0, kEncPnQ, 3 + kEncC3, pw1, kEncP1, pb1, kEncP1, x1,
                                  kEncP1);
  __syncthreads();
  dense_tile<8, kTileRelu, kBf16>(x1, kEncP1, kEncPnQ, kEncP1, pw2, kEncP2, pb2, kEncP2, x2,
                                  kEncP2);
  __syncthreads();
  const bool vec = dout % 4 == 0;
  float acc[kEncPnQ * kEncMaxD / kEncThreads];
#pragma unroll
  for (int i = 0; i < kEncPnQ * kEncMaxD / kEncThreads; ++i) acc[i] = 0.0f;
  for (int c = 0; c < kEncP3; c += kEncP3Step) {
    dense_tile<8, kTileRelu, kBf16>(x2, kEncP2, kEncPnQ, kEncP2, pw3 + c, kEncP3, pb3 + c,
                                    kEncP3Step, x3, kEncX3);
    __syncthreads();
    if (vec) {
      last_layer_step<true>(x3, pw4, c, dout, acc);
    } else {
      last_layer_step<false>(x3, pw4, c, dout, acc);
    }
    __syncthreads();
  }
  float* o4 = x2;
  const int kV = vec ? 4 : 1;
#pragma unroll
  for (int i = 0; i < kEncPnQ * kEncMaxD / kEncThreads; ++i) {
    const int e = threadIdx.x + (i / kV) * kEncThreads;
    if (e >= kEncPnQ * dout / kV) break;
    const int o = (e % (dout / kV)) * kV + i % kV;
    o4[(e / (dout / kV)) * dout + o] = pcc_bf16::act_round<kBf16>(acc[i] + __ldg(pb4 + o));
  }
  __syncthreads();
}

}  // namespace pcc
