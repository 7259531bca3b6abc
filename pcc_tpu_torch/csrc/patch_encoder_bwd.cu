// Backward of the IPDAE patch encoder: the gradients of
// latent = encoder(patches; 14 weights and biases) against a cotangent.
//
// Replaces the TPU kernel pcc_tpu/ops/sa_pallas.py::_encoder_bwd_kernel
// (entry patch_encoder_trainable, the custom VJP of patch_encoder_fused).
// Inputs: patches [P, N, 3], the cotangent g [P, D], the 14 weights and
// biases of csrc/patch_encoder.cu ([in, out] row-major). Outputs: dpatches
// [P, N, 3] and the 14 gradients, each summed over the P patches, in one
// flat buffer (w1, b1, w2, b2, w3, b3, pw1, pb1, ..., pw4, pb4).
//
// Semantics (those of the TPU kernel, sa_pallas.py:324-468): the knn
// selection carries no gradient; the SetAbstraction max routes each
// (point, channel) to the first slot that reaches it, and only where the
// max is > 0; the PointNet global max routes each channel to the first
// point that reaches it; relu masks are (z > 0); the neighbour gather
// transposes to a scatter-add onto the neighbour, minus the centred term on
// the query point. At ties these agree with amax-based autograd (ties of
// distinct positive values are measure-zero; all-dead ties die in the relu
// mask), which is what the plain version is.
//
// What bounds it on an H100: operations. Written densely, as the TPU
// kernel does, the backward is the forward recomputed plus two products per
// layer for every point and slot: about 3x the forward's MLP FLOPs, 0.28
// TFLOP at P = 512 (a batch of 8 clouds of 64 patches), about 4 ms at 67
// TFLOP/s in float32. What the design does about it: the gradient of the
// global max over points is nonzero on at most D rows per patch (one
// winning point per latent channel), and every gradient upstream of it is
// zero on every other point. So after one forward pass to find the
// winners, only the U <= D distinct winning points (and their knn slots)
// are recomputed and backpropagated: the dense backward's 2x becomes about
// U/N of it, and the kernel costs about one forward (93 GFLOP at P = 512,
// 1.4 ms at the float32 peak). The forward is the forward kernel's own code
// (encoder_common.cuh), so the selection, the activations and hence the
// max routing are those of csrc/patch_encoder.cu bit for bit.
//
// Memory: the TPU kernel keeps every slot's activations (49 MB of VMEM at
// a block of 4 patches); here nothing is saved between passes: pass 1 runs
// the forward kernel's chunks of 32 points (encoder_common.cuh::
// encoder_chunk), pass 2 the winners in chunks of 16 through shared memory
// (about 155 KB at N = 256, the SetAbstraction weights among it), one
// 256-thread block per SM.
//
// Determinism: the weight gradients are sums over P * N * knn rows. A fixed
// grid of persistent blocks walks the patches in a fixed order; each block
// adds its patches' contributions into its own slice of a partial buffer
// [grid, total] (each element owned by one thread, added in a fixed order,
// no atomics), and a second kernel sums the partials over the blocks in
// block order. The dpatches scatter is one thread per point, walking the
// rows in a fixed order. Two launches give bitwise equal outputs.
//
// Float32 on CUDA cores: pass 1 with the forward's register-tiled
// products, pass 2 with the simple register-reuse products of dense.cuh;
// tensor cores, wgmma and TMA are later work.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "encoder_common.cuh"

namespace {

using namespace pcc;

constexpr int kThreads = kEncThreads;
constexpr int kG = 4;                   // winning queries per SetAbstraction group
constexpr unsigned char kDead = 0xFF;   // SetAbstraction max <= 0: no gradient

// Offsets of the 14 gradients in the flat buffer; off[14] is the total.
struct GradOffsets {
  int off[15];
};

__host__ __device__ inline GradOffsets grad_offsets(int dout) {
  const int sizes[14] = {3 * kEncC1,         kEncC1, kEncC1 * kEncC2, kEncC2,
                         kEncC2 * kEncC3,    kEncC3, (3 + kEncC3) * kEncP1, kEncP1,
                         kEncP1 * kEncP2,    kEncP2, kEncP2 * kEncP3, kEncP3,
                         kEncP3 * dout,      dout};
  GradOffsets g;
  int o = 0;
  for (int i = 0; i < 14; ++i) {
    g.off[i] = o;
    o += sizes[i];
  }
  g.off[14] = o;
  return g;
}

struct Layout {
  int sx, sy, sz, sq, sa, dpts;      // patch, SetAbstraction weights, patch gradient
  int qs, win, winv, winners, nwin;  // chunk queries, per-channel winners, distinct winners
  int chunk;                         // pass 1: a chunk's rows (encoder_common.cuh)
  int bx0, bx1, bx2, bx3, dz4;       // pass 2: the winners' PointNet rows
  int a1, a2, best, dinp;            // pass 2: one group's SetAbstraction rows
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
  L.sa = off; off += kEncSaW;
  L.dpts = off; off += 3 * n;
  L.qs = off; off += kEncQ;
  L.win = off; off += kEncMaxD;
  L.winv = off; off += kEncMaxD;
  L.winners = off; off += kEncMaxD;
  L.nwin = off; off += 4;
  const int region = off;
  // pass 1 (the forward over all points)
  L.chunk = region;
  const int end1 = L.chunk + kEncChunkWords;
  // pass 2 (the winners), aliasing pass 1
  L.bx0 = region;
  L.bx1 = L.bx0 + kEncQ * kEncX0;
  L.bx2 = L.bx1 + kEncQ * kEncP1;
  L.bx3 = L.bx2 + kEncQ * kEncP2;
  L.dz4 = L.bx3 + kEncQ * kEncP3;
  L.a1 = L.dz4 + kEncQ * kEncMaxD;
  L.a2 = L.a1 + kG * knn * kEncC1;
  L.best = L.a2 + kG * knn * kEncC2;
  L.dinp = L.best + kEncQ * kEncC3 / 4;
  const int end2 = L.dinp + kG * knn * 3;
  L.floats = end1 > end2 ? end1 : end2;
  L.bytes = static_cast<size_t>(L.floats) * sizeof(float) +
            static_cast<size_t>(n) * knn * sizeof(unsigned short);
  return L;
}

// part[i * cout + o] += sum_r x[r][i] * dz[r][o]
__device__ __forceinline__ void add_wgrad(const float* x, int ldx, const float* dz,
                                          int ldz, int rows, int cin, int cout,
                                          float* part) {
  for (int e = threadIdx.x; e < cin * cout; e += blockDim.x) {
    const int o = e % cout, i = e / cout;
    float s = 0.0f;
    for (int r = 0; r < rows; ++r) s = fmaf(x[r * ldx + i], dz[r * ldz + o], s);
    part[e] += s;
  }
}

// part[o] += sum_r dz[r][o]
__device__ __forceinline__ void add_bgrad(const float* dz, int ldz, int rows, int cout,
                                          float* part) {
  for (int o = threadIdx.x; o < cout; o += blockDim.x) {
    float s = 0.0f;
    for (int r = 0; r < rows; ++r) s += dz[r * ldz + o];
    part[o] += s;
  }
}

// x[r][k] = sum_o dz[r][o] * w[k][o], times (x[r][k] > 0) when kMask: the
// input gradient of a layer z = x @ w + b, written over x (each element is
// read and written by the same thread). RT rows per work item; rows % RT == 0.
template <int RT, bool kGlobalW, bool kMask>
__device__ __forceinline__ void dense_bwd_x(const float* dz, int ldz, int rows, int cout,
                                            const float* w, int cin, float* x, int ldx) {
  const int items = (rows / RT) * cin;
  for (int e = threadIdx.x; e < items; e += blockDim.x) {
    const int k = e % cin;
    const int gq = e / cin;
    const float* d = dz + gq * RT * ldz;
    float acc[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) acc[i] = 0.0f;
    for (int o = 0; o < cout; ++o) {
      const float wk = load_w<kGlobalW>(w + k * cout + o);
#pragma unroll
      for (int i = 0; i < RT; ++i) acc[i] = fmaf(d[i * ldz + o], wk, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      float* xi = x + (gq * RT + i) * ldx + k;
      *xi = (kMask && !(*xi > 0.0f)) ? 0.0f : acc[i];
    }
  }
}

// SetAbstraction layers 1-2 for kG queries qs[0..kG): a1, a2 rows
// r = i * KNN + slot, as the forward computes them. Ends with a barrier.
template <int KNN>
__device__ __forceinline__ void sa_group_forward(const int* qs, const unsigned short* nbr,
                                                 const float* sx, const float* sy,
                                                 const float* sz, const float* sw1,
                                                 const float* sb1, const float* sw2,
                                                 const float* sb2, float* a1, float* a2) {
  sa_layer1<KNN>(kG, QueryList{qs}, nbr, sx, sy, sz, sw1, sb1, a1);
  __syncthreads();
  dense_rows<8, true, false>(a1, kEncC1, kG * KNN, kEncC1, sw2, sb2, kEncC2, a2, kEncC2);
  __syncthreads();
}

// SetAbstraction layer 3 and the max over slots for kG queries: the pooled
// features (equal to the forward's: rounding is monotone, so
// max_s(acc_s + b) == max_s(acc_s) + b) into the concat rows, and the first
// slot that reaches the max, or kDead where the max is <= 0. Ends with a
// barrier.
template <int KNN>
__device__ __forceinline__ void sa_group_max(const float* a2, const float* sw3,
                                             const float* sb3, float* feats,
                                             unsigned char* best) {
  for (int e = threadIdx.x; e < kG * kEncC3; e += blockDim.x) {
    const int o = e % kEncC3;
    const int qi = e / kEncC3;
    const float* x = a2 + qi * KNN * kEncC2;
    float acc[KNN];
#pragma unroll
    for (int i = 0; i < KNN; ++i) acc[i] = 0.0f;
    for (int k = 0; k < kEncC2; ++k) {
      const float wk = sw3[k * kEncC3 + o];
#pragma unroll
      for (int i = 0; i < KNN; ++i) acc[i] = fmaf(x[i * kEncC2 + k], wk, acc[i]);
    }
    const float b = sb3[o];
    float m = acc[0] + b;
    int s = 0;
#pragma unroll
    for (int i = 1; i < KNN; ++i) {
      const float v = acc[i] + b;
      if (v > m) {
        m = v;
        s = i;
      }
    }
    feats[qi * kEncX0 + o] = fmaxf(m, 0.0f);
    best[qi * kEncC3 + o] = m > 0.0f ? static_cast<unsigned char>(s) : kDead;
  }
  __syncthreads();
}

// The SetAbstraction backward of kG queries qs[0..kG) whose a1/a2 rows were
// just recomputed, given the pooled features' gradient dfeats (row stride
// kEncX0): adds the SetAbstraction weight gradients into `part` and the
// patch gradient into dpts. Ends with a barrier.
template <int KNN>
__device__ __forceinline__ void sa_group_backward(
    const int* qs, const unsigned short* nbr, const float* sx, const float* sy,
    const float* sz, int n, const float* sw1, const float* sw2, const float* sw3,
    float* a1, float* a2,
    const unsigned char* best, const float* dfeats, float* dinp, float* dpts,
    float* part, const GradOffsets& go) {
  constexpr int kRows = kG * KNN;
  // layer 3: each (query, channel) gradient flows to its winning slot only
  for (int e = threadIdx.x; e < kEncC2 * kEncC3; e += blockDim.x) {
    const int o = e % kEncC3, i = e / kEncC3;
    float s = 0.0f;
    for (int qi = 0; qi < kG; ++qi) {
      const int b = best[qi * kEncC3 + o];
      if (b != kDead) s = fmaf(a2[(qi * KNN + b) * kEncC2 + i], dfeats[qi * kEncX0 + o], s);
    }
    part[go.off[4] + e] += s;
  }
  for (int o = threadIdx.x; o < kEncC3; o += blockDim.x) {
    float s = 0.0f;
    for (int qi = 0; qi < kG; ++qi)
      if (best[qi * kEncC3 + o] != kDead) s += dfeats[qi * kEncX0 + o];
    part[go.off[5] + o] += s;
  }
  __syncthreads();
  // da2 = (dz3 @ w3^T) * (a2 > 0), over a2
  for (int e = threadIdx.x; e < kRows * kEncC2; e += blockDim.x) {
    const int i = e % kEncC2, r = e / kEncC2;
    const int qi = r / KNN, slot = r % KNN;
    float s = 0.0f;
    if (a2[e] > 0.0f) {
      for (int o = 0; o < kEncC3; ++o)
        if (best[qi * kEncC3 + o] == slot)
          s = fmaf(dfeats[qi * kEncX0 + o], sw3[i * kEncC3 + o], s);
    }
    a2[e] = s;
  }
  __syncthreads();
  add_wgrad(a1, kEncC1, a2, kEncC2, kRows, kEncC1, kEncC2, part + go.off[2]);
  add_bgrad(a2, kEncC2, kRows, kEncC2, part + go.off[3]);
  __syncthreads();
  dense_bwd_x<8, false, true>(a2, kEncC2, kRows, kEncC2, sw2, kEncC1, a1, kEncC1);
  __syncthreads();
  // layer 1 on the centred neighbours, and the centred input's gradient
  for (int e = threadIdx.x; e < 3 * kEncC1; e += blockDim.x) {
    const int o = e % kEncC1, d = e / kEncC1;
    const float* c = d == 0 ? sx : (d == 1 ? sy : sz);
    float s = 0.0f;
    for (int r = 0; r < kRows; ++r) {
      const int q = qs[r / KNN];
      const int j = nbr[q * KNN + r % KNN];
      s = fmaf(c[j] - c[q], a1[r * kEncC1 + o], s);
    }
    part[go.off[0] + e] += s;
  }
  add_bgrad(a1, kEncC1, kRows, kEncC1, part + go.off[1]);
  for (int e = threadIdx.x; e < kRows * 3; e += blockDim.x) {
    const int d = e % 3, r = e / 3;
    float s = 0.0f;
    for (int o = 0; o < kEncC1; ++o) s = fmaf(a1[r * kEncC1 + o], sw1[d * kEncC1 + o], s);
    dinp[e] = s;
  }
  __syncthreads();
  // the gather transposed: onto each neighbour, minus the query's own term;
  // one thread per point, rows in a fixed order
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    float ax = 0.0f, ay = 0.0f, az = 0.0f;
    for (int r = 0; r < kRows; ++r) {
      const int q = qs[r / KNN];
      const float* di = dinp + 3 * r;
      if (nbr[q * KNN + r % KNN] == j) {
        ax += di[0];
        ay += di[1];
        az += di[2];
      }
      if (q == j) {
        ax -= di[0];
        ay -= di[1];
        az -= di[2];
      }
    }
    dpts[3 * j] += ax;
    dpts[3 * j + 1] += ay;
    dpts[3 * j + 2] += az;
  }
  __syncthreads();
}

template <int KNN>
__global__ void __launch_bounds__(kThreads)
patch_encoder_bwd_kernel(const float* __restrict__ pts, const float* __restrict__ g,
                         int np, int n,
                         const float* __restrict__ w1, const float* __restrict__ b1,
                         const float* __restrict__ w2, const float* __restrict__ b2,
                         const float* __restrict__ w3, const float* __restrict__ b3,
                         const float* __restrict__ pw1, const float* __restrict__ pb1,
                         const float* __restrict__ pw2, const float* __restrict__ pb2,
                         const float* __restrict__ pw3, const float* __restrict__ pb3,
                         const float* __restrict__ pw4, const float* __restrict__ pb4,
                         int dout, float* __restrict__ dpatches,
                         float* __restrict__ partial) {
  const Layout L = make_layout(n, KNN);
  const GradOffsets go = grad_offsets(dout);
  extern __shared__ __align__(16) float smem[];
  float* sx = smem + L.sx;
  float* sy = smem + L.sy;
  float* sz = smem + L.sz;
  float* sq = smem + L.sq;
  float* dpts = smem + L.dpts;
  int* qs = reinterpret_cast<int*>(smem + L.qs);
  int* win = reinterpret_cast<int*>(smem + L.win);
  float* winv = smem + L.winv;
  int* winners = reinterpret_cast<int*>(smem + L.winners);
  int* nwin = reinterpret_cast<int*>(smem + L.nwin);
  float* chunk = smem + L.chunk;
  const float* o4 = chunk + kEncX2Off;     // [kEncPnQ, dout]
  float* bx0 = smem + L.bx0;
  float* bx1 = smem + L.bx1;
  float* bx2 = smem + L.bx2;
  float* bx3 = smem + L.bx3;
  float* dz4 = smem + L.dz4;
  float* a1 = smem + L.a1;
  float* a2 = smem + L.a2;
  unsigned char* best = reinterpret_cast<unsigned char*>(smem + L.best);
  float* dinp = smem + L.dinp;
  unsigned short* nbr = reinterpret_cast<unsigned short*>(smem + L.floats);
  float* sw1 = smem + L.sa;                // SetAbstraction weights, as loaded
  float* sb1 = sw1 + 3 * kEncC1;
  float* sw2 = sb1 + kEncC1;
  float* sb2 = sw2 + kEncC1 * kEncC2;
  float* sw3 = sb2 + kEncC2;
  float* sb3 = sw3 + kEncC2 * kEncC3;
  const int tid = threadIdx.x;

  float* part = partial + static_cast<size_t>(blockIdx.x) * go.off[14];
  for (int e = tid; e < go.off[14]; e += blockDim.x) part[e] = 0.0f;

  load_sa_weights(w1, b1, w2, b2, w3, b3, sw1);
  for (int p = blockIdx.x; p < np; p += gridDim.x) {
    for (int e = tid; e < 3 * n; e += blockDim.x) dpts[e] = 0.0f;
    if (tid < dout) {
      winv[tid] = -CUDART_INF_F;
      win[tid] = 0;
    }
    load_patch(pts + static_cast<size_t>(p) * n * 3, n, sx, sy, sz, sq);
    select_knn<KNN>(sx, sy, sz, sq, n, nbr);

    // pass 1: the forward over all points, and each channel's first
    // arg-max over points
    for (int c0 = 0; c0 < n; c0 += kEncPnQ) {
      const int nq = min(kEncPnQ, n - c0);
      encoder_chunk<KNN>(c0, nq, nbr, sx, sy, sz, w1, b1, w2, b2, w3, b3, pw1, pb1, pw2, pb2,
                         pw3, pb3, pw4, pb4, dout, chunk);
      if (tid < dout) {
        for (int r = 0; r < nq; ++r) {
          const float v = o4[r * dout + tid];
          if (v > winv[tid]) {
            winv[tid] = v;
            win[tid] = c0 + r;
          }
        }
      }
    }
    __syncthreads();
    if (tid == 0) {
      int u = 0;
      for (int c = 0; c < dout; ++c) {
        bool seen = false;
        for (int i = 0; i < u; ++i) seen = seen || winners[i] == win[c];
        if (!seen) winners[u++] = win[c];
      }
      *nwin = u;
    }
    __syncthreads();
    const int U = *nwin;
    const float* gp = g + static_cast<size_t>(p) * dout;

    // pass 2: the distinct winning points, kEncQ at a time (rows past W
    // repeat the last winner with a zero cotangent)
    for (int w0 = 0; w0 < U; w0 += kEncQ) {
      const int Wn = min(kEncQ, U - w0);
      if (tid < kEncQ) qs[tid] = winners[w0 + min(tid, Wn - 1)];
      __syncthreads();
      for (int g0 = 0; g0 < kEncQ; g0 += kG) {
        sa_group_forward<KNN>(qs + g0, nbr, sx, sy, sz, sw1, sb1, sw2, sb2, a1, a2);
        sa_group_max<KNN>(a2, sw3, sb3, bx0 + g0 * kEncX0 + 3, best + g0 * kEncC3);
      }
      concat_xyz(kEncQ, QueryList{qs}, sx, sy, sz, bx0);
      for (int e = tid; e < kEncQ * dout; e += blockDim.x) {
        const int r = e / dout, c = e % dout;
        dz4[e] = (r < Wn && win[c] == qs[r]) ? gp[c] : 0.0f;
      }
      __syncthreads();
      pointnet_123(bx0, pw1, pb1, pw2, pb2, pw3, pb3, bx1, bx2, bx3);

      // PointNet backward, each delta written over its layer's activations
      add_wgrad(bx3, kEncP3, dz4, dout, kEncQ, kEncP3, dout, part + go.off[12]);
      add_bgrad(dz4, dout, kEncQ, dout, part + go.off[13]);
      __syncthreads();
      dense_bwd_x<16, true, true>(dz4, dout, kEncQ, dout, pw4, kEncP3, bx3, kEncP3);
      __syncthreads();
      add_wgrad(bx2, kEncP2, bx3, kEncP3, kEncQ, kEncP2, kEncP3, part + go.off[10]);
      add_bgrad(bx3, kEncP3, kEncQ, kEncP3, part + go.off[11]);
      __syncthreads();
      dense_bwd_x<16, true, true>(bx3, kEncP3, kEncQ, kEncP3, pw3, kEncP2, bx2, kEncP2);
      __syncthreads();
      add_wgrad(bx1, kEncP1, bx2, kEncP2, kEncQ, kEncP1, kEncP2, part + go.off[8]);
      add_bgrad(bx2, kEncP2, kEncQ, kEncP2, part + go.off[9]);
      __syncthreads();
      dense_bwd_x<16, true, true>(bx2, kEncP2, kEncQ, kEncP2, pw2, kEncP1, bx1, kEncP1);
      __syncthreads();
      add_wgrad(bx0, kEncX0, bx1, kEncP1, kEncQ, 3 + kEncC3, kEncP1, part + go.off[6]);
      add_bgrad(bx1, kEncP1, kEncQ, kEncP1, part + go.off[7]);
      __syncthreads();
      dense_bwd_x<16, true, false>(bx1, kEncP1, kEncQ, kEncP1, pw1, 3 + kEncC3, bx0,
                                   kEncX0);
      __syncthreads();
      // the concat's xyz columns straight onto the (distinct) winners
      for (int e = tid; e < Wn * 3; e += blockDim.x) {
        const int r = e / 3, d = e % 3;
        dpts[3 * qs[r] + d] += bx0[r * kEncX0 + d];
      }
      __syncthreads();
      // SetAbstraction backward of the pooled features' gradient
      for (int g0 = 0; g0 < Wn; g0 += kG) {
        sa_group_forward<KNN>(qs + g0, nbr, sx, sy, sz, sw1, sb1, sw2, sb2, a1, a2);
        sa_group_backward<KNN>(qs + g0, nbr, sx, sy, sz, n, sw1, sw2, sw3, a1, a2,
                               best + g0 * kEncC3, bx0 + g0 * kEncX0 + 3, dinp, dpts,
                               part, go);
      }
    }
    float* out = dpatches + static_cast<size_t>(p) * n * 3;
    for (int e = tid; e < 3 * n; e += blockDim.x) out[e] = dpts[e];
    __syncthreads();
  }
}

// grads[e] = sum over blocks b, in order, of partial[b][e]
__global__ void reduce_partials(const float* __restrict__ partial, int grid, int total,
                                float* __restrict__ grads) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  float s = 0.0f;
  for (int b = 0; b < grid; ++b) s += partial[static_cast<size_t>(b) * total + e];
  grads[e] = s;
}

template <int KNN>
int launch(const float* pts, const float* g, int p, int n, const float* const* w, int dout,
           float* dpatches, float* grads, float* partial, int grid, cudaStream_t stream) {
  const Layout L = make_layout(n, KNN);
  cudaError_t err = cudaFuncSetAttribute(patch_encoder_bwd_kernel<KNN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  patch_encoder_bwd_kernel<KNN><<<grid, kThreads, L.bytes, stream>>>(
      pts, g, p, n, w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7], w[8], w[9], w[10],
      w[11], w[12], w[13], dout, dpatches, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = grad_offsets(dout).off[14];
  reduce_partials<<<(total + 255) / 256, 256, 0, stream>>>(partial, grid, total, grads);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pts: [p, n, 3] f32; g: [p, dout] f32; weights [in, out] row-major f32 and
// biases [out] as for patch_encoder_launch. dpatches: [p, n, 3] f32; grads:
// the 14 gradients flattened in that order; partial: scratch of grid times
// as many floats, 0 < grid <= p. Returns a cudaError_t value.
extern "C" int patch_encoder_bwd_launch(const float* pts, const float* g, int p, int n,
                                        int knn, const float* w1, const float* b1,
                                        const float* w2, const float* b2,
                                        const float* w3, const float* b3,
                                        const float* pw1, const float* pb1,
                                        const float* pw2, const float* pb2,
                                        const float* pw3, const float* pb3,
                                        const float* pw4, const float* pb4, int dout,
                                        float* dpatches, float* grads, float* partial,
                                        int grid, void* stream) {
  if (p <= 0 || n % kEncQ != 0 || n > kEncMaxN || n < knn || dout <= 0 ||
      dout > kEncMaxD || grid <= 0 || grid > p)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* w[14] = {w1, b1, w2, b2, w3, b3, pw1, pb1, pw2, pb2, pw3, pb3, pw4, pb4};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (knn) {
    case 8:
      return launch<8>(pts, g, p, n, w, dout, dpatches, grads, partial, grid, s);
    case 16:
      return launch<16>(pts, g, p, n, w, dout, dpatches, grads, partial, grid, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
