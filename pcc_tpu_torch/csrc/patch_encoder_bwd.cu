// Backward of the IPDAE patch encoder: the gradients of
// latent = encoder(patches; 14 weights and biases) against a cotangent.
//
// Replaces the TPU kernel pcc_tpu/ops/sa_pallas.py::_encoder_bwd_kernel
// (entry patch_encoder_trainable, the custom VJP of patch_encoder_fused).
// Inputs: patches [P, N, 3], the cotangent g [P, D], each latent channel's
// winning point [P, D] (the forward kernel's), the 14 weights and biases of
// csrc/patch_encoder.cu ([in, out] row-major). Outputs: dpatches [P, N, 3]
// and the 14 gradients, each summed over the P patches, in one flat buffer
// (w1, b1, w2, b2, w3, b3, pw1, pb1, ..., pw4, pb4).
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
// The work: written densely, as the TPU kernel does, the backward is the
// forward recomputed plus two products per layer for every point and slot,
// about 0.28 TFLOP at P = 512 (a batch of 8 clouds of 64 patches). But the
// gradient of the global max over points is nonzero on at most D rows per
// patch (one winning point per latent channel), and every gradient upstream
// of it is zero on every other point. So only the U <= D distinct winning
// points (and their knn slots) are recomputed and backpropagated: about 11
// GFLOP at P = 512, 0.16 ms at the float32 peak. Finding the winners takes
// a forward over all points (about 5 ms at P = 512 on an H100), which the
// forward kernel has just run: it keeps each channel's first arg-max point
// in its fold when asked (csrc/patch_encoder.cu), the train step's forward
// asks, and this kernel takes them. The recomputed rows use
// the forward kernel's code (encoder_common.cuh), so their selection and
// activations, hence the max routing, are the forward's bit for bit.
//
// What bounds it on an H100: not its operations but the latency of a chain
// of small steps per group of 16 winners between the barriers of a
// 256-thread block (pcc_tpu_torch/tools/bwd_breakdown.py times each step by
// taking it out). Summing the weight gradients there, one output per thread
// into a per-block slice of partials for each group, cost about as much as
// the SetAbstraction backward (1.4 and 1.6 ms at P = 512 in an earlier
// design). So the kernel only recomputes the winners' rows and propagates
// the gradients through them, and writes each layer's input rows and the
// gradients of its pre-activation to device memory (about 0.23 GB at P =
// 512); each layer's weight gradient is then a split-K 3xTF32 product over
// those rows (tf32_mma.cuh::wgrad_tile, as the PN++ stage backward computes
// its own), its bias gradient the column sums of the same pass: the seven
// products in one grouped launch and their sums in one more, after the
// kernel and a launch that transposes PointNet's weights for it (4 launches
// a call, 22 before).
//
// Against the latency: two blocks on an SM (about 105 KB of shared memory
// each at N = 256: w3 is read through the cache, a group's SetAbstraction
// rows share bx3's space, w3 transposed shares PointNet's rows while they
// are dead: make_layout); the input gradients read each weight transposed,
// so that a warp's loads coalesce (PointNet's from device memory, a launch
// before the kernel transposes them; w2 and w3 in shared memory without
// bank conflicts); the neighbours of the winners alone are selected
// (U <= D queries, not all N); and layer 3's input gradient, which is
// nonzero only at the channels whose max a slot won (each channel routes to
// one slot), sums over each slot's channels in ascending order, listed once
// per group, in place of a test of every channel for every (row, input) (1.1
// of the earlier 3.6 ms of the bf16 instance at P = 512). Each of these
// keeps every sum's terms and order, so the outputs are the earlier design's
// bit for bit.
//
// The bf16 instance (patch_encoder_bwd_bf16_launch; pcc_tpu's compute_dtype
// bfloat16, sa_pallas.py:288-470) is this kernel templated on the rounding
// (bf16.cuh), with the TPU kernel's rounding points. The wrapper hands it
// the weights rounded to bf16 and the biases float32, as the TPU kernel
// casts them (ops/sa_cuda.py::replay_wb). The forward replay rounds the
// centred neighbours, xyz and every layer's output after its relu
// (`dense_fwd`), and the SetAbstraction max routes to the first slot of
// the rounded maximum (:376-378), from the winners that the forward
// kernel found on the same replay. Every input gradient is round(dz) @
// round(w).T in float32 (`matmul`, :404, :450, :455, :460): the cotangent
// is rounded where it is read, so each stored dz stays float32, as the
// weight gradients take it. The weight gradients are float32 products of
// the stored activations (:400-402, :446, :456), among them the two that
// the forward rounds but the TPU kernel stores unrounded: x0's xyz columns
// (:382) and the centred neighbours (`inp`, :456-458). So the rows and
// the weight-gradient products are the float32 instance's; only the
// recomputed rows and the input-gradient chain round. Products of bf16
// values are exact in float32, so the chain needs no bf16 arithmetic.
//
// Determinism: every sum runs in a fixed order (the products' splits are
// fixed by the shapes and summed in order; the dpatches scatter is one
// thread per point, walking the rows in a fixed order); no float atomics.
// Two launches give bitwise equal outputs.

#include <cuda_runtime.h>

#include "encoder_common.cuh"
#include "tf32_mma.cuh"

namespace {

using namespace pcc;
using namespace pcc_mma;

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

// SetAbstraction weights and biases kept in shared memory: w1 b1 w2 b2 b3
// (w3 is read through the cache, and transposed for its input gradient)
constexpr int kSaShared = 3 * kEncC1 + kEncC1 + kEncC1 * kEncC2 + kEncC2 + kEncC3;

struct Layout {
  int sx, sy, sz, sq, sa, dpts;      // patch, SetAbstraction weights, patch gradient
  int qs, win, winners, nwin;        // chunk queries, per-channel winners, distinct winners
  int bx0, bx1, bx2, bx3, dz4;       // the winners' PointNet rows
  int a1, a2, w2t, w3t;              // one group's SetAbstraction rows; w2, w3 transposed
  int best, order, start, dinp;      // the max's slots, each slot's channels, gradients
  int floats;                        // float words before the neighbour table
  size_t bytes;                      // total dynamic shared memory
};

// A group's SetAbstraction rows a1 and a2 live in the last floats of bx3,
// which is dead while they are (before PointNet's forward and after its
// backward), and w3 transposed [kEncC3][kEncC2] in bx1, bx2 and the rest of
// bx3 during the SetAbstraction backward: about 105 KB at n = 256, knn =
// 16, so that two blocks fit on an SM.
__host__ __device__ inline Layout make_layout(int n, int knn) {
  Layout L;
  int off = 0;
  L.sx = off; off += n;
  L.sy = off; off += n;
  L.sz = off; off += n;
  L.sq = off; off += n;
  L.sa = off; off += kSaShared;
  L.w2t = off; off += kEncC1 * kEncC2;
  L.dpts = off; off += 3 * n;
  L.qs = off; off += kEncQ;
  L.win = off; off += kEncMaxD;
  L.winners = off; off += kEncMaxD;
  L.nwin = off; off += 4;
  L.bx0 = off;
  L.bx1 = L.bx0 + kEncQ * kEncX0;
  L.bx2 = L.bx1 + kEncQ * kEncP1;
  L.bx3 = L.bx2 + kEncQ * kEncP2;
  L.dz4 = L.bx3 + kEncQ * kEncP3;
  L.a1 = L.dz4 - kG * knn * (kEncC1 + kEncC2);
  L.a2 = L.a1 + kG * knn * kEncC1;
  L.w3t = L.bx1;
  L.best = L.dz4 + kEncQ * kEncMaxD;
  L.order = L.best + kEncQ * kEncC3 / 4;
  L.start = L.order + kG * kEncC3 / 4;
  L.dinp = L.start + kG * (knn + 1);
  L.floats = L.dinp + kG * knn * 3;
  L.bytes = static_cast<size_t>(L.floats) * sizeof(float) +
            static_cast<size_t>(n) * knn * sizeof(unsigned short);
  return L;
}
static_assert(kEncQ * (kEncP1 + kEncP2 + kEncP3) >= kEncC2 * kEncC3 + kG * 16 * (kEncC1 + kEncC2),
              "w3 transposed and a group's rows fit in bx1..bx3");

// The winners' rows in device memory, for the weight-gradient products. A
// patch has rs = D rounded up to kEncQ row slots (slots past its winners
// hold zeros); per slot, PointNet's layer inputs x0 [132] (the concat row;
// column 131 zero), x1 [128], x2 [256], x3 [512] and the gradients of its
// pre-activations dz1 [128], dz2 [256], dz3 [512], dz4 [round4(D)]; per
// slot and neighbour (knn SetAbstraction rows a slot), the centred
// neighbour c [4], layer 1's output a1 [32] and gradient da1 [32], layer
// 2's a2 [64] and da2 [64], and layer 3's gradient sdz3 [128] (nonzero only
// at each channel's winning slot). Offsets in floats.
struct Rows {
  int rs, ldd;
  size_t pn, sa;                                  // rows of each kind
  size_t x0, dz1, x1, dz2, x2, dz3, x3, dz4;
  size_t c, a1, da1, a2, da2, sdz3;
  size_t floats;
};

__host__ __device__ inline Rows make_rows(int p, int dout, int knn) {
  Rows R;
  R.rs = (dout + kEncQ - 1) / kEncQ * kEncQ;
  R.ldd = (dout + 3) & ~3;
  R.pn = static_cast<size_t>(p) * R.rs;
  R.sa = R.pn * knn;
  size_t o = 0;
  R.x0 = o; o += R.pn * kEncX0;
  R.dz1 = o; o += R.pn * kEncP1;
  R.x1 = o; o += R.pn * kEncP1;
  R.dz2 = o; o += R.pn * kEncP2;
  R.x2 = o; o += R.pn * kEncP2;
  R.dz3 = o; o += R.pn * kEncP3;
  R.x3 = o; o += R.pn * kEncP3;
  R.dz4 = o; o += R.pn * R.ldd;
  R.c = o; o += R.sa * 4;
  R.a1 = o; o += R.sa * kEncC1;
  R.da1 = o; o += R.sa * kEncC1;
  R.a2 = o; o += R.sa * kEncC2;
  R.da2 = o; o += R.sa * kEncC2;
  R.sdz3 = o; o += R.sa * kEncC3;
  R.floats = o;
  return R;
}

// dst[r * ld + c] = src[r * lds + c] for c < cols, 0 for cols <= c < ld,
// r < nrows (src null: zeros). No trailing barrier.
__device__ __forceinline__ void store_rows(const float* src, int lds, int cols, int nrows,
                                           float* dst, int ld) {
  for (int e = threadIdx.x; e < nrows * ld; e += blockDim.x) {
    const int r = e / ld, c = e % ld;
    dst[static_cast<size_t>(r) * ld + c] = src && c < cols ? src[r * lds + c] : 0.0f;
  }
}

// Zeros in every SetAbstraction row [r0, r0 + nrows). No trailing barrier.
__device__ __forceinline__ void zero_sa_rows(float* rows, const Rows& R, size_t r0, int nrows) {
  store_rows(nullptr, 0, 0, nrows, rows + R.c + r0 * 4, 4);
  store_rows(nullptr, 0, 0, nrows, rows + R.a1 + r0 * kEncC1, kEncC1);
  store_rows(nullptr, 0, 0, nrows, rows + R.da1 + r0 * kEncC1, kEncC1);
  store_rows(nullptr, 0, 0, nrows, rows + R.a2 + r0 * kEncC2, kEncC2);
  store_rows(nullptr, 0, 0, nrows, rows + R.da2 + r0 * kEncC2, kEncC2);
  store_rows(nullptr, 0, 0, nrows, rows + R.sdz3 + r0 * kEncC3, kEncC3);
}

// x[r][k] = sum_o dz[r][o] * w[k][o], times (x[r][k] > 0) when kMask: the
// input gradient of a layer z = x @ w + b, written over x (each element is
// read and written by the same thread), from w transposed, wt [cout][cin]:
// the threads of a warp take neighbouring k, so their weight loads are one
// coalesced row (w itself, [cin][cout], would put them cout apart). RT rows
// per work item; rows % RT == 0. kBf16: dz rounded to bf16 where it is read
// (w is bf16-exact).
template <int RT, bool kGlobalW, bool kMask, bool kBf16 = false>
__device__ __forceinline__ void dense_bwd_x(const float* dz, int ldz, int rows, int cout,
                                            const float* wt, int cin, float* x, int ldx) {
  const int items = (rows / RT) * cin;
  for (int e = threadIdx.x; e < items; e += blockDim.x) {
    const int k = e % cin;
    const int gq = e / cin;
    const float* d = dz + gq * RT * ldz;
    float acc[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) acc[i] = 0.0f;
    for (int o = 0; o < cout; ++o) {
      const float wk = load_w<kGlobalW>(wt + o * cin + k);
#pragma unroll
      for (int i = 0; i < RT; ++i)
        acc[i] = fmaf(pcc_bf16::act_round<kBf16>(d[i * ldz + o]), wk, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      float* xi = x + (gq * RT + i) * ldx + k;
      *xi = (kMask && !(*xi > 0.0f)) ? 0.0f : acc[i];
    }
  }
}

// SetAbstraction layers 1-2 for kG queries qs[0..kG): a1, a2 rows
// r = i * KNN + slot, as the forward computes them (rounded with kBf16).
// Ends with a barrier.
template <int KNN, bool kBf16>
__device__ __forceinline__ void sa_group_forward(const int* qs, const unsigned short* nbr,
                                                 const float* sx, const float* sy,
                                                 const float* sz, const float* sw1,
                                                 const float* sb1, const float* sw2,
                                                 const float* sb2, float* a1, float* a2) {
  sa_layer1<KNN, kBf16>(kG, QueryList{qs}, nbr, sx, sy, sz, sw1, sb1, a1);
  __syncthreads();
  dense_rows<8, true, false, kBf16>(a1, kEncC1, kG * KNN, kEncC1, sw2, sb2, kEncC2, a2, kEncC2);
  __syncthreads();
}

// SetAbstraction layer 3 (w3 through the read-only cache) and the max over
// slots for kG queries: the pooled
// features (equal to the forward's: rounding is monotone, so
// max_s(acc_s + b) == max_s(acc_s) + b) into the concat rows, and the first
// slot that reaches the max, or kDead where the max is <= 0. kBf16: the
// slots' values rounded to bf16 before the max, so that the first of the
// rounded maxima wins, as the TPU kernel picks it. Ends with a barrier.
template <int KNN, bool kBf16>
__device__ __forceinline__ void sa_group_max(const float* a2, const float* __restrict__ w3,
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
      const float wk = __ldg(w3 + k * kEncC3 + o);
#pragma unroll
      for (int i = 0; i < KNN; ++i) acc[i] = fmaf(x[i * kEncC2 + k], wk, acc[i]);
    }
    const float b = sb3[o];
    float m = pcc_bf16::act_round<kBf16>(acc[0] + b);
    int s = 0;
#pragma unroll
    for (int i = 1; i < KNN; ++i) {
      const float v = pcc_bf16::act_round<kBf16>(acc[i] + b);
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
// kEncX0): writes their SetAbstraction rows (from r0 on) for the weight
// gradients and adds the patch gradient into dpts. w2t, w3t: w2 and w3
// transposed; order, start: scratch for each (query, slot)'s channels.
// kBf16: each gradient rounded to bf16 where a product reads it. Ends with a
// barrier.
template <int KNN, bool kBf16>
__device__ __forceinline__ void sa_group_backward(
    const int* qs, const unsigned short* nbr, const float* sx, const float* sy,
    const float* sz, int n, const float* sw1, const float* w2t, const float* w3t,
    float* a1, float* a2, const unsigned char* best, const float* dfeats, float* dinp,
    float* dpts, float* rows, const Rows& R, size_t r0, unsigned char* order, int* start) {
  constexpr int kRows = kG * KNN;
  // each (query, slot)'s channels, ascending: the channels whose max that
  // slot won (a counting sort of best by slot, a warp a query, a lane a slot)
  {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (warp < kG) {
      const unsigned char* b = best + warp * kEncC3;
      int cnt = 0;
      if (lane < KNN)
        for (int o = 0; o < kEncC3; ++o) cnt += b[o] == lane;
      int incl = cnt;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += v;
      }
      int pos = incl - cnt;
      if (lane <= KNN) start[warp * (KNN + 1) + lane] = pos;
      if (lane < KNN)
        for (int o = 0; o < kEncC3; ++o)
          if (b[o] == lane) order[warp * kEncC3 + pos++] = static_cast<unsigned char>(o);
    }
  }
  // the layers' inputs, and layer 3's gradient: each (query, channel)
  // gradient flows to its winning slot only
  for (int e = threadIdx.x; e < kRows * 4; e += blockDim.x) {
    const int d = e % 4, r = e / 4;
    const int q = qs[r / KNN];
    const int j = nbr[q * KNN + r % KNN];
    const float* c = d == 0 ? sx : (d == 1 ? sy : sz);
    rows[R.c + r0 * 4 + e] = d < 3 ? c[j] - c[q] : 0.0f;
  }
  for (int e = threadIdx.x; e < kRows * kEncC1; e += blockDim.x) rows[R.a1 + r0 * kEncC1 + e] = a1[e];
  for (int e = threadIdx.x; e < kRows * kEncC2; e += blockDim.x) rows[R.a2 + r0 * kEncC2 + e] = a2[e];
  for (int e = threadIdx.x; e < kRows * kEncC3; e += blockDim.x) {
    const int o = e % kEncC3, r = e / kEncC3;
    const int qi = r / KNN, slot = r % KNN;
    rows[R.sdz3 + r0 * kEncC3 + e] =
        best[qi * kEncC3 + o] == slot ? dfeats[qi * kEncX0 + o] : 0.0f;
  }
  __syncthreads();
  // da2 = (dz3 @ w3^T) * (a2 > 0), over a2: dz3 is nonzero on a row only at
  // the channels whose max its slot won, so the sum runs over those, in
  // ascending order (the order of the dense sum, whose other terms are 0)
  for (int e = threadIdx.x; e < kRows * kEncC2; e += blockDim.x) {
    const int i = e % kEncC2, r = e / kEncC2;
    const int qi = r / KNN, slot = r % KNN;
    float s = 0.0f;
    if (a2[e] > 0.0f) {
      const int* st = start + qi * (KNN + 1);
      for (int t = st[slot]; t < st[slot + 1]; ++t) {
        const int o = order[qi * kEncC3 + t];
        s = fmaf(pcc_bf16::act_round<kBf16>(dfeats[qi * kEncX0 + o]), w3t[o * kEncC2 + i], s);
      }
    }
    a2[e] = s;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kRows * kEncC2; e += blockDim.x) rows[R.da2 + r0 * kEncC2 + e] = a2[e];
  dense_bwd_x<8, false, true, kBf16>(a2, kEncC2, kRows, kEncC2, w2t, kEncC1, a1, kEncC1);
  __syncthreads();
  for (int e = threadIdx.x; e < kRows * kEncC1; e += blockDim.x) rows[R.da1 + r0 * kEncC1 + e] = a1[e];
  // the centred input's gradient
  for (int e = threadIdx.x; e < kRows * 3; e += blockDim.x) {
    const int d = e % 3, r = e / 3;
    float s = 0.0f;
    for (int o = 0; o < kEncC1; ++o)
      s = fmaf(pcc_bf16::act_round<kBf16>(a1[r * kEncC1 + o]), sw1[d * kEncC1 + o], s);
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

// PointNet's weights transposed ([out][in]) for the input gradients, one
// after the other in device memory (floats): pw1 at 0, then pw2, pw3, pw4.
constexpr int kPw2T = (3 + kEncC3) * kEncP1;
constexpr int kPw3T = kPw2T + kEncP1 * kEncP2;
constexpr int kPw4T = kPw3T + kEncP2 * kEncP3;
__host__ __device__ inline int pw_t_floats(int dout) { return kPw4T + kEncP3 * dout; }

// wt = pw1..pw4 transposed: wt[off + o * in + k] = w[k * out + o].
__global__ void __launch_bounds__(256)
transpose_pn_kernel(const float* __restrict__ pw1, const float* __restrict__ pw2,
                    const float* __restrict__ pw3, const float* __restrict__ pw4, int dout,
                    float* __restrict__ wt) {
  const int total = pw_t_floats(dout);
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total; e += gridDim.x * blockDim.x) {
    const float* w;
    int off, cin, cout;
    if (e < kPw2T) {
      w = pw1, off = 0, cin = 3 + kEncC3, cout = kEncP1;
    } else if (e < kPw3T) {
      w = pw2, off = kPw2T, cin = kEncP1, cout = kEncP2;
    } else if (e < kPw4T) {
      w = pw3, off = kPw3T, cin = kEncP2, cout = kEncP3;
    } else {
      w = pw4, off = kPw4T, cin = kEncP3, cout = dout;
    }
    const int i = e - off, k = i / cout, o = i % cout;
    wt[off + o * cin + k] = w[i];
  }
}

// One block per patch, two on an SM; kBf16: the bf16 instance (the header
// note).
template <int KNN, bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
patch_encoder_bwd_kernel(const float* __restrict__ pts, const float* __restrict__ g,
                         const int* __restrict__ pwin, int n,
                         const float* __restrict__ w1, const float* __restrict__ b1,
                         const float* __restrict__ w2, const float* __restrict__ b2,
                         const float* __restrict__ w3, const float* __restrict__ b3,
                         const float* __restrict__ pw1, const float* __restrict__ pb1,
                         const float* __restrict__ pw2, const float* __restrict__ pb2,
                         const float* __restrict__ pw3, const float* __restrict__ pb3,
                         const float* __restrict__ pw4, const float* __restrict__ pb4,
                         const float* __restrict__ wt, int dout,
                         float* __restrict__ dpatches, float* __restrict__ rows, const Rows R) {
  const Layout L = make_layout(n, KNN);
  extern __shared__ __align__(16) float smem[];
  float* sx = smem + L.sx;
  float* sy = smem + L.sy;
  float* sz = smem + L.sz;
  float* sq = smem + L.sq;
  float* dpts = smem + L.dpts;
  int* qs = reinterpret_cast<int*>(smem + L.qs);
  int* win = reinterpret_cast<int*>(smem + L.win);
  int* winners = reinterpret_cast<int*>(smem + L.winners);
  int* nwin = reinterpret_cast<int*>(smem + L.nwin);
  float* bx0 = smem + L.bx0;
  float* bx1 = smem + L.bx1;
  float* bx2 = smem + L.bx2;
  float* bx3 = smem + L.bx3;
  float* dz4 = smem + L.dz4;
  float* a1 = smem + L.a1;
  float* a2 = smem + L.a2;
  float* w2t = smem + L.w2t;
  float* w3t = smem + L.w3t;
  unsigned char* best = reinterpret_cast<unsigned char*>(smem + L.best);
  unsigned char* order = reinterpret_cast<unsigned char*>(smem + L.order);
  int* start = reinterpret_cast<int*>(smem + L.start);
  float* dinp = smem + L.dinp;
  unsigned short* nbr = reinterpret_cast<unsigned short*>(smem + L.floats);
  float* sw1 = smem + L.sa;                // SetAbstraction weights, as loaded (not w3)
  float* sb1 = sw1 + 3 * kEncC1;
  float* sw2 = sb1 + kEncC1;
  float* sb2 = sw2 + kEncC1 * kEncC2;
  float* sb3 = sb2 + kEncC2;
  const int tid = threadIdx.x;
  const int p = blockIdx.x;

  for (int i = tid; i < 3 * kEncC1; i += blockDim.x) sw1[i] = w1[i];
  for (int i = tid; i < kEncC1; i += blockDim.x) sb1[i] = b1[i];
  for (int i = tid; i < kEncC1 * kEncC2; i += blockDim.x) {
    sw2[i] = w2[i];
    w2t[(i % kEncC2) * kEncC1 + i / kEncC2] = w2[i];
  }
  for (int i = tid; i < kEncC2; i += blockDim.x) sb2[i] = b2[i];
  for (int i = tid; i < kEncC3; i += blockDim.x) sb3[i] = b3[i];
  for (int e = tid; e < 3 * n; e += blockDim.x) dpts[e] = 0.0f;
  // each channel's first arg-max point, from the forward
  if (tid < dout) win[tid] = pwin[static_cast<size_t>(p) * dout + tid];
  load_patch(pts + static_cast<size_t>(p) * n * 3, n, sx, sy, sz, sq);
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
  // the neighbours of the winners only: the rows below read no others
  for (int i = tid; i < U; i += blockDim.x) knn_of<KNN>(winners[i], sx, sy, sz, sq, n, nbr);
  __syncthreads();
  const float* gp = g + static_cast<size_t>(p) * dout;

  // the distinct winning points, kEncQ at a time (rows past Wn repeat the
  // last winner with a zero cotangent: their gradients are zeros)
  int w0 = 0;
  for (; w0 < U; w0 += kEncQ) {
    const int Wn = min(kEncQ, U - w0);
    const size_t pr = static_cast<size_t>(p) * R.rs + w0;   // first PointNet row
    if (tid < kEncQ) qs[tid] = winners[w0 + min(tid, Wn - 1)];
    __syncthreads();
    for (int g0 = 0; g0 < kEncQ; g0 += kG) {
      sa_group_forward<KNN, kBf16>(qs + g0, nbr, sx, sy, sz, sw1, sb1, sw2, sb2, a1, a2);
      sa_group_max<KNN, kBf16>(a2, w3, sb3, bx0 + g0 * kEncX0 + 3, best + g0 * kEncC3);
    }
    concat_xyz(kEncQ, QueryList{qs}, sx, sy, sz, bx0);
    for (int e = tid; e < kEncQ * dout; e += blockDim.x) {
      const int r = e / dout, c = e % dout;
      dz4[e] = (r < Wn && win[c] == qs[r]) ? gp[c] : 0.0f;
    }
    __syncthreads();
    // x0's rows for the weight gradient keep xyz unrounded (sa_pallas.py:382,
    // :400); the product rounds it
    store_rows(bx0, kEncX0, 3 + kEncC3, kEncQ, rows + R.x0 + pr * kEncX0, kEncX0);
    if (kBf16) {
      __syncthreads();
      for (int e = tid; e < kEncQ * 3; e += blockDim.x) {
        float* x = bx0 + (e / 3) * kEncX0 + e % 3;
        *x = pcc_bf16::round_bf16(*x);
      }
      __syncthreads();
    }
    pointnet_123<kBf16>(bx0, pw1, pb1, pw2, pb2, pw3, pb3, bx1, bx2, bx3);

    // PointNet backward, each gradient written over its layer's activations,
    // every layer's input rows and pre-activation gradients to `rows`
    store_rows(bx1, kEncP1, kEncP1, kEncQ, rows + R.x1 + pr * kEncP1, kEncP1);
    store_rows(bx2, kEncP2, kEncP2, kEncQ, rows + R.x2 + pr * kEncP2, kEncP2);
    store_rows(bx3, kEncP3, kEncP3, kEncQ, rows + R.x3 + pr * kEncP3, kEncP3);
    store_rows(dz4, dout, dout, kEncQ, rows + R.dz4 + pr * R.ldd, R.ldd);
    __syncthreads();
    const float* pwt = wt;                         // pw1..pw4 transposed, in turn
    dense_bwd_x<16, true, true, kBf16>(dz4, dout, kEncQ, dout, pwt + kPw4T, kEncP3, bx3,
                                       kEncP3);
    __syncthreads();
    store_rows(bx3, kEncP3, kEncP3, kEncQ, rows + R.dz3 + pr * kEncP3, kEncP3);
    dense_bwd_x<16, true, true, kBf16>(bx3, kEncP3, kEncQ, kEncP3, pwt + kPw3T, kEncP2, bx2,
                                       kEncP2);
    __syncthreads();
    store_rows(bx2, kEncP2, kEncP2, kEncQ, rows + R.dz2 + pr * kEncP2, kEncP2);
    dense_bwd_x<16, true, true, kBf16>(bx2, kEncP2, kEncQ, kEncP2, pwt + kPw2T, kEncP1, bx1,
                                       kEncP1);
    __syncthreads();
    store_rows(bx1, kEncP1, kEncP1, kEncQ, rows + R.dz1 + pr * kEncP1, kEncP1);
    dense_bwd_x<16, true, false, kBf16>(bx1, kEncP1, kEncQ, kEncP1, pwt, 3 + kEncC3, bx0,
                                        kEncX0);
    __syncthreads();
    // the concat's xyz columns straight onto the (distinct) winners
    for (int e = tid; e < Wn * 3; e += blockDim.x) {
      const int r = e / 3, d = e % 3;
      dpts[3 * qs[r] + d] += bx0[r * kEncX0 + d];
    }
    __syncthreads();
    // SetAbstraction backward of the pooled features' gradient, kG winners
    // at a time; the rows of the groups past Wn are zeros. w3 transposed
    // over PointNet's rows, dead now (the groups' barriers publish it)
    for (int e = tid; e < kEncC2 * kEncC3; e += blockDim.x) {
      const int i = e % kEncC2, o = e / kEncC2;
      w3t[o * kEncC2 + i] = __ldg(w3 + i * kEncC3 + o);
    }
    int g0 = 0;
    for (; g0 < Wn; g0 += kG) {
      sa_group_forward<KNN, kBf16>(qs + g0, nbr, sx, sy, sz, sw1, sb1, sw2, sb2, a1, a2);
      sa_group_backward<KNN, kBf16>(qs + g0, nbr, sx, sy, sz, n, sw1, w2t, w3t, a1, a2,
                             best + g0 * kEncC3, bx0 + g0 * kEncX0 + 3, dinp, dpts, rows, R,
                             (pr + g0) * KNN, order, start);
    }
    zero_sa_rows(rows, R, (pr + g0) * KNN, (kEncQ - g0) * KNN);
  }
  // the patch's row slots past its winners' groups: zeros
  const size_t pr = static_cast<size_t>(p) * R.rs + w0;
  const int rest = R.rs - w0;
  if (rest > 0) {
    store_rows(nullptr, 0, 0, rest, rows + R.x0 + pr * kEncX0, kEncX0);
    store_rows(nullptr, 0, 0, rest, rows + R.x1 + pr * kEncP1, kEncP1);
    store_rows(nullptr, 0, 0, rest, rows + R.x2 + pr * kEncP2, kEncP2);
    store_rows(nullptr, 0, 0, rest, rows + R.x3 + pr * kEncP3, kEncP3);
    store_rows(nullptr, 0, 0, rest, rows + R.dz1 + pr * kEncP1, kEncP1);
    store_rows(nullptr, 0, 0, rest, rows + R.dz2 + pr * kEncP2, kEncP2);
    store_rows(nullptr, 0, 0, rest, rows + R.dz3 + pr * kEncP3, kEncP3);
    store_rows(nullptr, 0, 0, rest, rows + R.dz4 + pr * R.ldd, R.ldd);
    zero_sa_rows(rows, R, pr * KNN, rest * KNN);
  }
  __syncthreads();
  float* out = dpatches + static_cast<size_t>(p) * n * 3;
  for (int e = tid; e < 3 * n; e += blockDim.x) out[e] = dpts[e];
}

// The seven weight-gradient products, grouped: one launch computes every
// output tile of every split of all seven (block b belongs to the last
// product whose first block is <= b, and there to the tile and split that
// wgrad_tf32_kernel's grid would give it), one more sums each product's
// splits and its bias column sums (split_sum_kernel's blocks, likewise).
// Each tile and each sum is computed exactly as the launch per product
// computed it, so the bits are the same. The job tables are
// __grid_constant__: a block reads its job in place, with no copy of the
// table per thread.
constexpr int kProducts = 7;

struct WgradJob {
  const float* x;
  const float* d;
  float* part;
  float* vpart;
  int ldx, cin, ldd, cout, rows, chunk, tiles_n, tiles_m, first;
};
struct WgradGroup {
  WgradJob job[kProducts];
};

__global__ void __launch_bounds__(kWThreads)
wgrad_group_kernel(const __grid_constant__ WgradGroup grp) {
  extern __shared__ __align__(16) float wsm[];
  int j = kProducts - 1;
  while (static_cast<int>(blockIdx.x) < grp.job[j].first) --j;
  const WgradJob& w = grp.job[j];
  const int b = blockIdx.x - w.first;
  wgrad_tile(w.x, w.ldx, w.cin, w.d, w.ldd, w.cout, nullptr, w.rows, w.chunk, w.part, w.vpart,
             (b % w.tiles_n) * kWBN, ((b / w.tiles_n) % w.tiles_m) * kWBM,
             b / (w.tiles_n * w.tiles_m), wsm);
}

struct SumJob {
  const float* part;
  float* out;
  size_t stride;
  int size, splits, first;
};
struct SumGroup {
  SumJob job[2 * kProducts];
};

__global__ void __launch_bounds__(256)
split_sum_group_kernel(const __grid_constant__ SumGroup grp) {
  int j = 2 * kProducts - 1;
  while (static_cast<int>(blockIdx.x) < grp.job[j].first) --j;
  const SumJob& s = grp.job[j];
  split_sum_block(s.part, s.size, s.stride, s.splits, nullptr, 1, 0, s.out,
                  blockIdx.x - s.first);
}

// The weight-gradient scratch for `rows` rows of a cin x cout product: its
// splits' partial products and column sums.
inline size_t part_floats(size_t rows, int cin, int cout) {
  int chunk;
  return static_cast<size_t>(wgrad_splits(static_cast<int>(rows), cin, cout, &chunk)) *
         (cin + 3) * cout;
}

template <int KNN, bool kBf16>
int launch(const float* pts, const float* g, const int* winners, int p, int n,
           const float* const* w, int dout, float* dpatches, float* grads, float* rows,
           float* part, long long part_n, cudaStream_t stream) {
  const Layout L = make_layout(n, KNN);
  const Rows R = make_rows(p, dout, KNN);
  // (X rows, row stride, cin, gradient rows, row stride, cout, rows) of the
  // seven layers, in the gradients' order
  struct Product {
    size_t x;
    int ldx, cin;
    size_t d;
    int ldd, cout;
    size_t rows;
  };
  const Product prods[kProducts] = {
      {R.c, 4, 3, R.da1, kEncC1, kEncC1, R.sa},
      {R.a1, kEncC1, kEncC1, R.da2, kEncC2, kEncC2, R.sa},
      {R.a2, kEncC2, kEncC2, R.sdz3, kEncC3, kEncC3, R.sa},
      {R.x0, kEncX0, 3 + kEncC3, R.dz1, kEncP1, kEncP1, R.pn},
      {R.x1, kEncP1, kEncP1, R.dz2, kEncP2, kEncP2, R.pn},
      {R.x2, kEncP2, kEncP2, R.dz3, kEncP3, kEncP3, R.pn},
      {R.x3, kEncP3, kEncP3, R.dz4, R.ldd, dout, R.pn},
  };
  // each product's scratch after the last's
  const GradOffsets go = grad_offsets(dout);
  WgradGroup wg;
  SumGroup sg;
  long long used = 0;
  int blocks = 0, sum_blocks = 0;
  for (int i = 0; i < kProducts; ++i) {
    const Product& pr = prods[i];
    int chunk;
    const int nr = static_cast<int>(pr.rows);
    const int splits = wgrad_splits(nr, pr.cin, pr.cout, &chunk);
    float* ppart = part + used;
    float* vpart = ppart + static_cast<size_t>(splits) * pr.cin * pr.cout;
    used += static_cast<long long>(part_floats(pr.rows, pr.cin, pr.cout));
    if (used > part_n) return static_cast<int>(cudaErrorInvalidValue);
    const int tn = (pr.cout + kWBN - 1) / kWBN, tm = (pr.cin + kWBM - 1) / kWBM;
    wg.job[i] = WgradJob{rows + pr.x, rows + pr.d, ppart, vpart, pr.ldx, pr.cin, pr.ldd,
                         pr.cout, nr, chunk, tn, tm, blocks};
    blocks += tn * tm * splits;
    const int size = pr.cin * pr.cout;
    sg.job[2 * i] = SumJob{ppart, grads + go.off[2 * i], static_cast<size_t>(size), size,
                           splits, sum_blocks};
    sum_blocks += (size + 31) / 32;
    sg.job[2 * i + 1] = SumJob{vpart, grads + go.off[2 * i + 1],
                               3 * static_cast<size_t>(pr.cout), pr.cout, splits, sum_blocks};
    sum_blocks += (pr.cout + 31) / 32;
  }
  float* wt = part + used;
  used += pw_t_floats(dout);
  if (used > part_n) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(patch_encoder_bwd_kernel<KNN, kBf16>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(L.bytes))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(wgrad_group_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(kWSmemBytes))) != cudaSuccess)
    return static_cast<int>(err);
  transpose_pn_kernel<<<(pw_t_floats(dout) + 255) / 256, 256, 0, stream>>>(w[6], w[8], w[10],
                                                                          w[12], dout, wt);
  patch_encoder_bwd_kernel<KNN, kBf16><<<p, kThreads, L.bytes, stream>>>(
      pts, g, winners, n, w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7], w[8], w[9], w[10],
      w[11], w[12], w[13], wt, dout, dpatches, rows, R);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  wgrad_group_kernel<<<blocks, kWThreads, kWSmemBytes, stream>>>(wg);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  split_sum_group_kernel<<<sum_blocks, 256, 0, stream>>>(sg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace {

template <bool kBf16>
int dispatch(const float* pts, const float* g, const int* winners, int p, int n, int knn,
             const float* const* w, int dout, float* dpatches, float* grads, float* rows,
             float* part, long long part_n, void* stream) {
  if (p <= 0 || n % kEncQ != 0 || n > kEncMaxN || n < knn || dout <= 0 || dout > kEncMaxD ||
      static_cast<long long>(p) * ((dout + kEncQ - 1) / kEncQ * kEncQ) * knn > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (knn) {
    case 8:
      return launch<8, kBf16>(pts, g, winners, p, n, w, dout, dpatches, grads, rows, part,
                              part_n, s);
    case 16:
      return launch<16, kBf16>(pts, g, winners, p, n, w, dout, dpatches, grads, rows, part,
                               part_n, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// pts: [p, n, 3] f32; g: [p, dout] f32; winners: [p, dout] int32, each
// latent channel's first arg-max point (patch_encoder_launch's winners
// output); weights [in, out] row-major f32 and biases [out] as for
// patch_encoder_launch. dpatches: [p, n, 3] f32; grads: the 14 gradients
// flattened in that order. Scratch, as pcc_tpu_torch/ops/sa_cuda.py sizes
// it: rows (make_rows(p, dout, knn).floats floats), part (part_n floats, at
// least the seven layers' splits * (in + 3) * out summed, tf32_mma.cuh::
// wgrad_splits, and PointNet's weights transposed, pw_t_floats). Returns a
// cudaError_t value.
extern "C" int patch_encoder_bwd_launch(const float* pts, const float* g, const int* winners,
                                        int p, int n, int knn, const float* w1, const float* b1,
                                        const float* w2, const float* b2,
                                        const float* w3, const float* b3,
                                        const float* pw1, const float* pb1,
                                        const float* pw2, const float* pb2,
                                        const float* pw3, const float* pb3,
                                        const float* pw4, const float* pb4, int dout,
                                        float* dpatches, float* grads, float* rows, float* part,
                                        long long part_n, void* stream) {
  const float* w[14] = {w1, b1, w2, b2, w3, b3, pw1, pb1, pw2, pb2, pw3, pb3, pw4, pb4};
  return dispatch<false>(pts, g, winners, p, n, knn, w, dout, dpatches, grads, rows, part,
                         part_n, stream);
}

// The bf16 instance: the arguments of patch_encoder_bwd_launch, the weights
// bf16-exact and the biases float32 (ops/sa_cuda.py::replay_wb), the
// winners those of patch_encoder_bf16_launch's replay half.
extern "C" int patch_encoder_bwd_bf16_launch(
    const float* pts, const float* g, const int* winners, int p, int n, int knn,
    const float* w1, const float* b1, const float* w2, const float* b2, const float* w3,
    const float* b3, const float* pw1, const float* pb1, const float* pw2, const float* pb2,
    const float* pw3, const float* pb3, const float* pw4, const float* pb4, int dout,
    float* dpatches, float* grads, float* rows, float* part, long long part_n, void* stream) {
  const float* w[14] = {w1, b1, w2, b2, w3, b3, pw1, pb1, pw2, pb2, pw3, pb3, pw4, pb4};
  return dispatch<true>(pts, g, winners, p, n, knn, w, dout, dpatches, grads, rows, part,
                        part_n, stream);
}
