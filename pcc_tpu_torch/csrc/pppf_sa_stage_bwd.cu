// Backward of one PointNet++ set-abstraction stage ("pppf" layout) with
// BatchNorm in its eval-affine form: the gradients of
// out = stage(new_xyz, xyz, feat; per layer W, b, mean, mul, beta) against a
// cotangent gout [P, S, C_out].
//
// Replaces the TPU kernel pcc_tpu/ops/pppf_sa_pallas.py::_stage_bwd_kernel
// (entry pppf_sa_trainable, the custom VJP of pppf_sa_fused). Outputs: dxyz
// [P, N, 3], dfeat [P, N, C] (when there are features), and per layer dW
// [cin, cout], db, dmul, dbeta [cout], summed over the patches, in one flat
// buffer (dW, db, dmul, dbeta of layer 0, then layer 1, ...). mean and
// new_xyz get no gradient (new_xyz enters only the selection and the mask).
//
// Semantics (those of the TPU kernel, pppf_sa_pallas.py:258-456): selection
// and ball mask are the forward's, slots in ascending (distance, index)
// order; the max over samples routes each (patch,
// query, channel) to the first slot, in selection order, whose activation
// equals the maximum, and only where that maximum is > 0; inner relu masks
// are (activation > 0); the affine h = (z - mean) * mul + beta gives
// dmul = sum dh (z - mean), dbeta = sum dh, dz = dh mul; an in-radius slot
// sends its row gradient to its point, a masked slot to point 0.
//
// What the design does: in the "pppf" layout a slot's row is its point's
// [feat | xyz], uncentred, so every slot that reads point j carries point
// j's activations: the stack depends on the point, not on the slot. The
// backward therefore replays the stack once per point (P * N rows) instead
// of once per slot (P * S * nsample rows, 32x more at the PPPF-AE stages),
// and backpropagates per point the sum of the gradients its slots win. The
// TPU kernel replays every slot twice; the sums are the same, regrouped.
// The replay is the forward kernel's own arithmetic (pppf_sa_common.cuh),
// so the selection and the activations, and hence the max routing, are
// those of csrc/pppf_sa_stage.cu.
//
// One launch runs these kernels in order, over device-memory buffers the
// caller allocates (1 and 2 only with `replay`: the train step's forward
// runs csrc/pppf_sa_stage.cu in its store mode, which writes sel, act and t
// itself, bit for bit what 1 and 2 compute, so its backward starts at 3):
//  1. select:   per patch and group of queries, the forward's selection and
//               ball mask -> sel [P, S, nsample], ranked by (distance, index)
//               also where nsample >= N, since the first winner depends on
//               the order (coincident float32 values tie exactly, about one
//               maximum in 1e5 at the PPPF-AE stages);
//  2. forward:  per tile of points, every layer's input x_l and shifted
//               pre-activation t_l = (z + b) - mean -> act, t;
//  3. route:    per (patch, chunk of output channels): that chunk of the last
//               activations of the patch's points in shared memory; per
//               (query, channel), slots in order, the first slot reaching
//               the maximum; then per channel, queries in order, each live
//               maximum's gout added to its point's gradient (the last
//               layer's da), in shared memory, stored once;
//  4. dx:       per layer, from the last: dx = da (W mul)^T as one 3xTF32
//               product over all points (the BatchNorm scale folded into the
//               transposed, zero-padded weights), da of the layer below =
//               dx * (x > 0); the first layer's dx is the point's
//               [dfeat | dxyz];
//  5. wgrad:    per layer, dW = sum over points x^T da as one split-K 3xTF32
//               product (tf32_mma.cuh::wgrad_tf32_kernel; the split count
//               fills the card), the column sums of da and da * t in the
//               same pass; then the splits summed in order, dW and db scaled
//               by mul.
// No float atomics: every sum runs in a fixed order, so two launches give
// bitwise equal outputs.
//
// What bounds it on an H100: operations. Per point the replay and the two
// backward products are 6 FLOP per multiply-add of the stack (0.35 TFLOP at
// the PPPF-AE train step's 512 patches), plus the selection (9 FLOP per
// query-point pair) and one comparison per slot and channel for the routing.
// The replay must be float32 on CUDA cores in the forward's k-order (the
// routing and the relu masks are read from its last bits): 0.12 TFLOP, 1.7
// ms at 67 TFLOP/s. The two products that make no choice (dx = dz W^T and
// dW = x^T dz) run on the tensor cores in 3xTF32 (about float32's accuracy,
// at three TF32 products' cost against 495 TFLOP/s): 0.23 TFLOP of float32
// work, 1.4 ms as 0.69 TFLOP of TF32.
// What the design does about it, piece by piece (times at P = 512 on an
// NVIDIA H100 80GB HBM3, measured by taking pieces out and by
// pcc_tpu_torch/tools/bwd_breakdown.py):
//  - the weight gradients are depth-65536-131072 products into at most
//    512 x 1024 outputs: a fixed split of the rows leaves most SMs idle on
//    the narrow layers (a float32 64 x 64 tile over 16 fixed ranges took
//    15.4 ms). So one split-K 3xTF32 mma.sync product per layer, tiles
//    double-buffered by cp.async, the split count chosen per layer so that
//    tiles x splits are about 8 x 132 blocks (3.4 ms; 2.7 with the
//    operands split by masking);
//  - the routing reads each point's last activations once per query that
//    holds it, about 32 times (268 MB at sa3, more than L2: 5.0 ms when
//    gathered from device memory). So a block owns (patch, channel chunk),
//    loads that chunk and the patch's slots once into shared memory and
//    also routes, which the same block owns (2.0 ms);
//  - dx: taking a tile of points through every layer in shared memory, the
//    two widest buffers at sa3 (1024 + 512 floats a row) leave 16-row
//    tiles, and every weight is read from L2 for each 16 rows (7.5 ms). So
//    one product per layer over all points with 64 x 64 tiles on 3xTF32
//    fragments, a weight tile serving 64 rows; da of each layer goes
//    through device memory, which the weight gradients read anyway (2.5 ms);
//  - the selection and the replay (1.2 and 5.7 ms) are the forward's work
//    done again: the forward kernel's store mode hands them over (0.9 ms
//    more in the forward, about 1.9 GB of activations kept from the forward
//    to the backward at P = 512). Called without them, the backward
//    replays, with dense_layer, bit for bit the forward kernel's
//    arithmetic.

//
// The bf16 instance (pppf_sa_stage_bwd_bf16_launch; replaces the same TPU
// kernel with compute_dtype bfloat16, the backward of PPPF_AE(dtype=
// bfloat16, fused_train=True)). Its rounding points are _stage_bwd_kernel's
// (pppf_sa_pallas.py:326-436): the replay rounds each layer's input and
// relu output to bf16 (the bf16 store mode of pppf_sa_stage.cu stores those
// rounded inputs, so no replay runs on the train path); the max routes to
// the first slot in selection order that reaches the maximum (ties between
// distinct points are common in bf16); dz = dh * mul in float32, and the
// input gradient is round(dz) @ round(W)^T per SLOT. Rounding dz per slot
// is not linear, so the per-point regrouping of the float32 instance does
// not hold below the last layer's routing: there the cotangent is carried
// per slot (P * S * nsample rows, 8.4 M at sa1 of the 512-patch step), as
// the TPU kernel carries it. What stays per point is exact in real
// arithmetic: the routing, and the weight gradients and column sums, taken
// on each point's sum of its slots' dh (no rounding sits between them), by
// the float32 instance's route and wgrad kernels.
// What bounds it on an H100: the per-slot products, 2 operations per
// multiply-add of the stack on the slot rows (4.2 TFLOP at the 512-patch
// step, 3.3 of them at sa3), exact bf16 x bf16 products with float32
// accumulation: mma.sync m16n8k16 on the bf16 tensor cores (989 TFLOP/s
// dense), one pass. What the design does (a simple first version): per
// chunk of patches (CHAIN_BYTES of per-slot buffers in the wrapper), the
// last layer's round(dz) per slot row from the routing's winning slots
// (top_kernel); then per layer, from the last, one product over the
// chunk's slot rows (chain_kernel: 128 x 128 tiles, k-slabs of 32 by
// cp.async, both operands k-contiguous), its epilogue masking by the slot's
// point's stored activation and writing dh (float32) and round(dh * mul)
// (bf16, the next product's A); and the per-point sums of dh
// (regroup_kernel: a block per patch and 32 columns, slots in order, a few
// groups of slots summed in a fixed order, so two launches give the same
// bits). The first layer's product gives each slot's row gradient, summed
// per point into [dfeat | dxyz] (masked slots read point 0).

#include <cuda_runtime.h>

#include "pppf_sa_common.cuh"
#include "tf32_mma.cuh"

namespace {

using namespace pcc_sa;
using namespace pcc_mma;

constexpr int kMinBlocks = 2;
constexpr int kRouteCh = 32;        // output channels per route block, at most

struct Bwd {
  const float* new_xyz;   // [P, S, 3]
  const float* xyz;       // [P, N, 3]
  const float* feat;      // [P, N, C] or nullptr
  const float* gout;      // [P, S, width[n_layers]]
  float* dxyz;            // [P, N, 3]
  float* dfeat;           // [P, N, C] or nullptr
  int* sel;               // [P, S, nsample]
  float* act;             // x_l, l = 0..n_layers: [P * N, ld[l]] each
  float* t;               // t_l, l = 0..n_layers-1: [P * N, ld[l + 1]] each
  float* da;              // da_l, laid out as t
  unsigned char* win;     // bf16: the winning slot of each (patch, query, channel)
  int p, s, n, c, nsample, n_layers;
  float r2;
  int rows;               // point tile of the forward replay
  int lda, ldb;           // forward replay buffers
  int qb;                 // queries per select block
  int ch;                 // output channels per route block
  int width[kMaxLayers + 1];
  int ld[kMaxLayers + 1];
  size_t act_off[kMaxLayers + 1];
  size_t t_off[kMaxLayers];
  const float* w[kMaxLayers];
  const float* b[kMaxLayers];
  const float* mu[kMaxLayers];
  const float* mul[kMaxLayers];
  const float* beta[kMaxLayers];
};

// 1. selection and ball mask, qb queries of one patch per block
__global__ void __launch_bounds__(kThreads) select_kernel(const __grid_constant__ Bwd st) {
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                      // [qb][4]
  float* dist = sq + 4 * st.qb;          // [qb][select_words(n, nsample)]
  const int qblocks = (st.s + st.qb - 1) / st.qb;
  const int p = blockIdx.x / qblocks;
  const int q0 = (blockIdx.x % qblocks) * st.qb;
  const int nq = min(st.qb, st.s - q0);
  load_queries(st.new_xyz + (static_cast<size_t>(p) * st.s + q0) * 3, nq, sq);
  __syncthreads();
  select_slots(st.xyz + static_cast<size_t>(p) * st.n * 3, sq, nq, st.n, st.nsample, true,
               true, st.r2, dist, st.sel + (static_cast<size_t>(p) * st.s + q0) * st.nsample);
}

// 2. the stack on every point's row [feat | xyz], storing x_l and t_l
// (kBf16: the rows and every layer's output rounded to bf16, as the bf16
// forward kernel computes them)
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
forward_kernel(const __grid_constant__ Bwd st) {
  extern __shared__ __align__(16) float smem[];
  float* buf_a = smem;
  float* buf_b = buf_a + st.rows * st.lda;
  const int total = st.p * st.n;
  const int row0 = blockIdx.x * st.rows;
  const int valid = min(st.rows, total - row0);
  const int cin = st.width[0];
  for (int e = threadIdx.x; e < st.rows * cin; e += kThreads) {
    const int rl = e / cin, c = e % cin;
    const size_t r = static_cast<size_t>(row0) + rl;
    float v = 0.0f;
    if (rl < valid) {
      v = pcc_bf16::act_round<kBf16>(c < st.c ? __ldg(st.feat + r * st.c + c)
                                             : __ldg(st.xyz + r * 3 + (c - st.c)));
      st.act[st.act_off[0] + r * st.ld[0] + c] = v;
    }
    buf_a[rl * st.lda + c] = v;
  }
  __syncthreads();
  for (int l = 0; l < st.n_layers; ++l) {
    const float* src = (l & 1) ? buf_b : buf_a;
    float* dst = l == st.n_layers - 1 ? nullptr : (l & 1) ? buf_a : buf_b;
    const size_t off = static_cast<size_t>(row0) * st.ld[l + 1];
    const GlobalRows g{st.act + st.act_off[l + 1] + off, st.t + st.t_off[l] + off,
                       st.ld[l + 1], valid};
    dense_layer<kStoreGlobal, kBf16>(src, (l & 1) ? st.ldb : st.lda, st.rows, st.width[l], st.w[l],
                              st.width[l + 1], st.b[l], st.mu[l], st.mul[l], st.beta[l], st.width[l + 1], dst,
                              (l & 1) ? st.lda : st.ldb, nullptr, 0, 0, 1, g);
    __syncthreads();
  }
}

// Shared memory of a route block with ch channels: the patch's slots
// [s][nsample] (where staged; 0 otherwise), the chunk of act[L] (then of da)
// [n][ch], the routed cotangents [s][ch] and the winners [s][ch] (unsigned
// short).
__host__ __device__ inline size_t route_bytes(int n, int s, int nsample, int ch) {
  return static_cast<size_t>(4) * s * nsample + static_cast<size_t>(ch) * (4 * n + 4 * s + 2 * s);
}
constexpr unsigned short kDead = 0xFFFF;   // maximum <= 0: no gradient (N <= kMaxN < 0xFFFF)

// 3. per (patch, chunk of ch output channels): the first slot in selection
// order whose last activation reaches the maximum, for every query, from the
// chunk of act[L] in shared memory; then each channel's thread adds the live
// maxima's cotangents to their points, queries in order (the block alone
// owns these columns of this patch), and the chunk of the last layer's da
// is stored. kStaged: the patch's slots are first copied to shared memory
// (where they fit), so that the winners' loop reads no device memory.
// kSlots (the bf16 instance): each winner's slot is also stored, win[p][q][c]
// (kDeadSlot where the maximum is not live), for the per-slot chain.
constexpr unsigned char kDeadSlot = 0xFF;   // nsample <= kMaxSlots < 0xFF
constexpr int kMaxSlots = 254;
template <bool kStaged, bool kSlots>
__global__ void __launch_bounds__(kThreads) route_kernel(const __grid_constant__ Bwd st) {
  extern __shared__ __align__(16) float smem[];
  const int L = st.n_layers, cout = st.width[L], ld = st.ld[L], ch = st.ch;
  const int chunks = (cout + ch - 1) / ch;
  const int p = blockIdx.x / chunks, c0 = (blockIdx.x % chunks) * ch;
  const int nch = min(ch, cout - c0);
  int* ssel = reinterpret_cast<int*>(smem);                    // [s][nsample], kStaged
  float* a = smem + (kStaged ? st.s * st.nsample : 0);         // [n][ch]
  float* gw = a + st.n * ch;                                   // [s][ch]
  unsigned short* win = reinterpret_cast<unsigned short*>(gw + st.s * ch);   // [s][ch]
  const float* act = st.act + st.act_off[L] + static_cast<size_t>(p) * st.n * ld + c0;
  const int* psel = st.sel + static_cast<size_t>(p) * st.s * st.nsample;
  // copies with several loads in flight per thread
  if (kStaged) {
#pragma unroll 8
    for (int e = threadIdx.x; e < st.s * st.nsample; e += kThreads) ssel[e] = __ldg(psel + e);
  }
#pragma unroll 8
  for (int e = threadIdx.x; e < st.n * ch; e += kThreads) {
    const int j = e / ch, c = e % ch;
    a[e] = c < nch ? __ldg(act + static_cast<size_t>(j) * ld + c) : 0.0f;
  }
  __syncthreads();
  {
    const int c = threadIdx.x % ch, lanes = kThreads / ch;
    const float* go = st.gout + static_cast<size_t>(p) * st.s * cout + c0 + c;
    for (int q = threadIdx.x / ch; q < st.s; q += lanes) {
      const int* sel = (kStaged ? ssel : psel) + q * st.nsample;
      float best = -1.0f;
      int bj = 0, bk = 0;
      int k = 0;
      // eight slots' loads in flight, compared in slot order
      for (; k + 8 <= st.nsample; k += 8) {
        int j[8];
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) j[i] = sel[k + i];
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = a[j[i] * ch + c];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (v[i] > best) {
            best = v[i];
            bj = j[i];
            bk = k + i;
          }
      }
      for (; k < st.nsample; ++k) {
        const int j = sel[k];
        const float v = a[j * ch + c];
        if (v > best) {
          best = v;
          bj = j;
          bk = k;
        }
      }
      const bool live = best > 0.0f && c < nch;
      win[q * ch + c] = live ? static_cast<unsigned short>(bj) : kDead;
      if (kSlots && c < nch)
        st.win[(static_cast<size_t>(p) * st.s + q) * cout + c0 + c] =
            live ? static_cast<unsigned char>(bk) : kDeadSlot;
      gw[q * ch + c] = live ? __ldg(go + static_cast<size_t>(q) * cout) : 0.0f;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < st.n * ch; e += kThreads) a[e] = 0.0f;
  __syncthreads();
  if (threadIdx.x < ch) {
    const int c = threadIdx.x;
    for (int q = 0; q < st.s; ++q) {
      const unsigned short j = win[q * ch + c];
      if (j != kDead) a[j * ch + c] += gw[q * ch + c];
    }
  }
  __syncthreads();
  // (zeros past cout, up to ld: the dx product reads them)
  float* g = st.da + st.t_off[L - 1] + static_cast<size_t>(p) * st.n * ld + c0;
  for (int e = threadIdx.x; e < st.n * ch; e += kThreads) {
    const int j = e / ch, c = e % ch;
    if (c0 + c < ld) g[static_cast<size_t>(j) * ld + c] = a[e];
  }
}

// 4. per layer l, from the last: dx = da_{l+1} (W_l mul_l)^T, the input
// gradient of the layer's product (the BatchNorm scale folded into the
// weights: dz = da * mul never needs storing), one 3xTF32 product over all
// P * N rows: a block 64 rows x 64 columns, 4 warps of 32 x 32, the da and
// weight tiles double-buffered by cp.async (A rows 36 floats apart, B rows
// 72: conflict-free fragments). Epilogue: for l > 0, da_l = dx * (x_l > 0)
// into da's layout (zeros past cin, so the next layer's product reads zeros
// there); for l = 0, dx is the point's [dfeat | dxyz].
constexpr int kXBM = 64, kXBN = 64, kXK = 32;
constexpr int kXLdA = kXK + 4, kXLdB = kXBN + 8;
constexpr int kXStage = kXBM * kXLdA + kXK * kXLdB;
constexpr size_t kXSmemBytes = 2 * kXStage * sizeof(float);

// A [rows][lda] (lda = round4(cout), zeros past cout), B [lda][ldb] (ldb =
// round4(cin), zero-padded), x and out [rows][ldb] (x null for the first
// layer, whose dx goes to dfeat [rows][c] and dxyz [rows][3]).
__global__ void __launch_bounds__(kWThreads)
dx_kernel(const float* __restrict__ A, int lda, const float* __restrict__ B, int ldb, int cin,
          const float* __restrict__ x, float* __restrict__ out, int rows,
          float* __restrict__ dfeat, float* __restrict__ dxyz, int c) {
  extern __shared__ __align__(16) float xsm[];
  // consecutive blocks: the column tiles of one row tile (its da rows in L2)
  const int ntiles = (ldb + kXBN - 1) / kXBN;
  const int n0 = (blockIdx.x % ntiles) * kXBN, row0 = (blockIdx.x / ntiles) * kXBM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  auto load = [&](int stage, int k0) {
    float* as = xsm + stage * kXStage;
    float* bs = as + kXBM * kXLdA;
    for (int e = tid; e < kXBM * (kXK / 4); e += kWThreads) {
      const int rr = e / (kXK / 4), k = k0 + (e % (kXK / 4)) * 4, r = row0 + rr;
      const bool ok = r < rows && k < lda;
      cp_async16(as + rr * kXLdA + (k - k0), ok ? A + static_cast<size_t>(r) * lda + k : A,
                 ok ? 16 : 0);
    }
    for (int e = tid; e < kXK * (kXBN / 4); e += kWThreads) {
      const int kk = e / (kXBN / 4), n = n0 + (e % (kXBN / 4)) * 4, k = k0 + kk;
      const bool ok = k < lda && n < ldb;
      cp_async16(bs + kk * kXLdB + (n - n0), ok ? B + static_cast<size_t>(k) * ldb + n : B,
                 ok ? 16 : 0);
    }
  };
  float acc[2][4][4] = {};
  load(0, 0);
  cp_async_commit();
  int stage = 0;
  for (int k0 = 0; k0 < lda; k0 += kXK, stage ^= 1) {
    if (k0 + kXK < lda) load(stage ^ 1, k0 + kXK);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* as = xsm + stage * kXStage;
    const float* bs = as + kXBM * kXLdA;
#pragma unroll
    for (int kk = 0; kk < kXK; kk += 8) {
      unsigned a_hi[2][4], a_lo[2][4], b_hi[4][2], b_lo[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* a = as + (wm + mt * 16 + g) * kXLdA + kk + t;
        split_tf32(a[0], a_hi[mt][0], a_lo[mt][0]);
        split_tf32(a[8 * kXLdA], a_hi[mt][1], a_lo[mt][1]);
        split_tf32(a[4], a_hi[mt][2], a_lo[mt][2]);
        split_tf32(a[8 * kXLdA + 4], a_hi[mt][3], a_lo[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* b = bs + (kk + t) * kXLdB + wn + nt * 8 + g;
        split_tf32(b[0], b_hi[nt][0], b_lo[nt][0]);
        split_tf32(b[4 * kXLdB], b_hi[nt][1], b_lo[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_3xtf32(acc[mt][nt], a_hi[mt], a_lo[mt], b_hi[nt], b_lo[nt]);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + wm + mt * 16 + g + 8 * h;
        const int n = n0 + wn + nt * 8 + 2 * t;
        if (r >= rows || n >= ldb) continue;
        const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        const size_t o = static_cast<size_t>(r) * ldb + n;
        if (x) {
          const float2 xv = *reinterpret_cast<const float2*>(x + o);
          *reinterpret_cast<float2*>(out + o) = make_float2(
              n < cin && xv.x > 0.0f ? v0 : 0.0f, n + 1 < cin && xv.y > 0.0f ? v1 : 0.0f);
        } else {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int k = n + i;
            const float v = i ? v1 : v0;
            if (k < c) {
              dfeat[static_cast<size_t>(r) * c + k] = v;
            } else if (k < cin) {
              dxyz[static_cast<size_t>(r) * 3 + (k - c)] = v;
            }
          }
        }
      }
}

// ---- the bf16 instance's per-slot chain (see the note at the top) ----
//
// Slot rows of a chunk of patches [p0, p0 + chunk): row r is slot k of query
// q of patch p0 + r / (s * nsample), r % (s * nsample) = q * nsample + k, so
// the chunk's rows are contiguous in sel. A buffers hold round(dz) per slot
// row in bf16, [rows][pad16(width)], zero past the width; D holds a layer's
// masked cotangent dh per slot row in float32, [rows][pad16(width)].

__device__ __forceinline__ unsigned short bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// The last layer's round(dz) per slot row: gout * mul at the slot that wins
// (win), 0 elsewhere, rounded to bf16; zeros up to lda.
__global__ void top_kernel(const __grid_constant__ Bwd st, int p0, int rows, int lda,
                           unsigned short* __restrict__ A) {
  const int L = st.n_layers, cout = st.width[L];
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<long long>(rows) * lda) return;
  const int c = static_cast<int>(e % lda);
  const long long r = e / lda;
  float v = 0.0f;
  if (c < cout) {
    const long long slot = static_cast<long long>(p0) * st.s * st.nsample + r;
    const long long pq = slot / st.nsample;          // patch * s + query
    const int k = static_cast<int>(slot % st.nsample);
    if (st.win[pq * cout + c] == k)
      v = __ldg(st.gout + pq * cout + c) * __ldg(st.mul[L - 1] + c);
  }
  A[e] = bf16_bits(v);
}

// The per-slot input-gradient product of layer l, G = A Wb^T (A [rows][lda]
// round(dz) in bf16, Wb [pad16(cin)][lda] = bf16(W_l), cin = width[l]): bf16
// mma.sync m16n8k16, float32 accumulators, a block 128 rows x 128 columns,
// 8 warps of 32 x 64, k-slabs of 32 double-buffered by cp.async (rows 40
// bf16 apart: conflict-free fragments). Epilogue, for columns n < ldo =
// pad16(cin): l > 0: dh = G * (x_l > 0) at the slot's point (the stored
// relu output of layer l - 1) into D, round(dh * mul_{l-1}) into Aout (zeros
// past cin); l = 0: G (the slot's row gradient [dfeat | dxyz]) into D.
constexpr int kGBM = 128, kGBN = 128, kGBK = 32, kGLd = kGBK + 8;
constexpr int kGStage = (kGBM + kGBN) * kGLd;              // bf16 per stage
constexpr size_t kGSmemBytes = 2 * kGStage * sizeof(unsigned short);

__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads)
chain_kernel(const __grid_constant__ Bwd st, int l, int p0, int rows,
             const unsigned short* __restrict__ A, int lda, const unsigned short* __restrict__ Wb,
             float* __restrict__ D, unsigned short* __restrict__ Aout) {
  extern __shared__ __align__(16) unsigned short gsm[];
  const int cin = st.width[l], ldo = (cin + 15) & ~15;
  const int ntiles = (ldo + kGBN - 1) / kGBN;
  const int n0 = (blockIdx.x % ntiles) * kGBN, row0 = (blockIdx.x / ntiles) * kGBM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
  auto load = [&](int stage, int k0) {
    unsigned short* as = gsm + stage * kGStage;
    unsigned short* bs = as + kGBM * kGLd;
    for (int e = tid; e < kGBM * (kGBK / 8); e += kThreads) {
      const int rr = e / (kGBK / 8), k = k0 + (e % (kGBK / 8)) * 8, r = row0 + rr;
      const bool ok = r < rows && k < lda;
      cp_async16(as + rr * kGLd + (k - k0), ok ? A + static_cast<size_t>(r) * lda + k : A,
                 ok ? 16 : 0);
    }
    for (int e = tid; e < kGBN * (kGBK / 8); e += kThreads) {
      const int nn = e / (kGBK / 8), k = k0 + (e % (kGBK / 8)) * 8, n = n0 + nn;
      const bool ok = n < ldo && k < lda;
      cp_async16(bs + nn * kGLd + (k - k0), ok ? Wb + static_cast<size_t>(n) * lda + k : Wb,
                 ok ? 16 : 0);
    }
  };
  float acc[2][8][4] = {};
  load(0, 0);
  cp_async_commit();
  int stage = 0;
  for (int k0 = 0; k0 < lda; k0 += kGBK, stage ^= 1) {
    if (k0 + kGBK < lda) load(stage ^ 1, k0 + kGBK);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const unsigned short* as = gsm + stage * kGStage;
    const unsigned short* bs = as + kGBM * kGLd;
#pragma unroll
    for (int kk = 0; kk < kGBK; kk += 16) {
      unsigned a[2][4], b[8][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const unsigned short* ap = as + (wm + mt * 16 + g) * kGLd + kk + 2 * t;
        a[mt][0] = *reinterpret_cast<const unsigned*>(ap);
        a[mt][1] = *reinterpret_cast<const unsigned*>(ap + 8 * kGLd);
        a[mt][2] = *reinterpret_cast<const unsigned*>(ap + 8);
        a[mt][3] = *reinterpret_cast<const unsigned*>(ap + 8 * kGLd + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const unsigned short* bp = bs + (wn + nt * 8 + g) * kGLd + kk + 2 * t;
        b[nt][0] = *reinterpret_cast<const unsigned*>(bp);
        b[nt][1] = *reinterpret_cast<const unsigned*>(bp + 8);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  const size_t chunk_slot0 = static_cast<size_t>(p0) * st.s * st.nsample;
  const int per_patch = st.s * st.nsample;
  const float* x = l > 0 ? st.act + st.act_off[l] : nullptr;
  const float* mul = l > 0 ? st.mul[l - 1] : nullptr;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + wm + mt * 16 + g + 8 * h;
      if (r >= rows) continue;
      const float* xr = nullptr;
      if (l > 0) {
        const int pt = st.sel[chunk_slot0 + r];
        xr = x + (static_cast<size_t>(p0 + r / per_patch) * st.n + pt) * st.ld[l];
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int n = n0 + wn + nt * 8 + 2 * t + i;
          if (n >= ldo) continue;
          float v = acc[mt][nt][2 * h + i];
          const size_t o = static_cast<size_t>(r) * ldo + n;
          if (l > 0) {
            v = n < cin && __ldg(xr + n) > 0.0f ? v : 0.0f;
            Aout[o] = bf16_bits(n < cin ? v * __ldg(mul + n) : 0.0f);
          }
          D[o] = v;
        }
    }
}

// Per (patch of the chunk, chunk of 32 columns): the per-slot rows of D
// summed per point, slots in order, into the point's row: kGroups groups of
// 32 threads each take a contiguous range of the patch's slots into their
// own copy in shared memory, the copies then added in group order (a fixed
// order: two launches give the same bits). l > 0: into da_{l-1} (row p * n
// + point, stride ld[l], zeros from width[l] to ld[l]); l = 0: into dfeat
// and dxyz.
__host__ __device__ inline int regroup_groups(int n) {
  int g = static_cast<int>(kSmemLimit / (static_cast<size_t>(n) * 32 * sizeof(float)));
  return g > kWarps ? kWarps : g;
}

__global__ void __launch_bounds__(kThreads)
regroup_kernel(const __grid_constant__ Bwd st, int l, int p0, const float* __restrict__ D) {
  extern __shared__ __align__(16) float rsm[];
  const int cin = st.width[l], ldo = (cin + 15) & ~15, n = st.n;
  const int groups = regroup_groups(n);
  const int cols = l > 0 ? st.ld[l] : cin;
  const int chunks = (cols + 31) / 32;
  const int pl = blockIdx.x / chunks, c0 = (blockIdx.x % chunks) * 32;
  const int per_patch = st.s * st.nsample;
  const int* sel = st.sel + (static_cast<size_t>(p0) + pl) * per_patch;
  const float* d = D + static_cast<size_t>(pl) * per_patch * ldo;
  for (int e = threadIdx.x; e < groups * n * 32; e += blockDim.x) rsm[e] = 0.0f;
  __syncthreads();
  const int gi = threadIdx.x / 32, c = threadIdx.x % 32, col = c0 + c;
  if (gi < groups && col < cin) {
    const int span = (per_patch + groups - 1) / groups;
    const int r1 = min(per_patch, (gi + 1) * span);
    float* acc = rsm + static_cast<size_t>(gi) * n * 32 + c;
    int r = gi * span;
    for (; r + 8 <= r1; r += 8) {
      int j[8];
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) j[i] = __ldg(sel + r + i);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = __ldg(d + static_cast<size_t>(r + i) * ldo + col);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[j[i] * 32] += v[i];
    }
    for (; r < r1; ++r) acc[__ldg(sel + r) * 32] += __ldg(d + static_cast<size_t>(r) * ldo + col);
  }
  __syncthreads();
  const size_t prow = static_cast<size_t>(p0 + pl) * n;
  for (int e = threadIdx.x; e < n * 32; e += blockDim.x) {
    const int j = e / 32, cc = e % 32, k = c0 + cc;
    if (k >= cols) continue;
    float v = 0.0f;
    for (int q = 0; q < groups; ++q) v += rsm[static_cast<size_t>(q) * n * 32 + e];
    if (l > 0) {
      st.da[st.t_off[l - 1] + (prow + j) * st.ld[l] + k] = k < cin ? v : 0.0f;
    } else if (k < st.c) {
      st.dfeat[(prow + j) * st.c + k] = v;
    } else {
      st.dxyz[(prow + j) * 3 + (k - st.c)] = v;
    }
  }
}

// The largest tile of up to kMaxRows rows (a multiple of kTM) whose two
// buffers of lda + ldb words a row let kMinBlocks blocks share an SM (a block
// is charged 1 KB more than it asks for); failing that, the largest of which
// one fits. 0 if none does.
int pick_rows(int lda, int ldb) {
  const size_t budgets[2] = {(kSmemLimit + 1024) / kMinBlocks - 1024, kSmemLimit};
  for (size_t budget : budgets)
    for (int rows = kMaxRows; rows >= kTM; rows -= kTM)
      if (static_cast<size_t>(rows) * (lda + ldb) * sizeof(float) <= budget) return rows;
  return 0;
}

// Floats of the weight-gradient scratch: per layer, splits x cin x cout
// partial products and splits x 3 x cout partial sums; the largest layer's.
size_t part_floats(int rows, int n_layers, const int* widths) {
  size_t most = 0;
  for (int l = 0; l < n_layers; ++l) {
    int chunk;
    const int splits = wgrad_splits(rows, widths[l], widths[l + 1], &chunk);
    const size_t f = static_cast<size_t>(splits) * (widths[l] + 3) * widths[l + 1];
    if (f > most) most = f;
  }
  return most;
}

// The bf16 instance's buffers (pppf_sa_stage_bwd_bf16_launch).
struct Bf16Chain {
  unsigned char* win;      // [p, s, widths[n_layers]]
  unsigned short* a0;      // [chunk * s * nsample, pad16(max widths[1..])] bf16, twice
  unsigned short* a1;
  float* d;                // [chunk * s * nsample, pad16(max widths[0..n_layers-1])]
  int chunk;               // patches per pass of the chain
};

int bwd_launch(const float* new_xyz, const float* xyz, const float* feat, const float* gout,
               int p, int s, int n, int c, int nsample, float r2, int n_layers,
               const void* const* layers, const int* widths, float* dxyz, float* dfeat,
               float* grads, int* sel, float* act, float* t, float* da, float* part,
               long long part_n, int replay, const Bf16Chain* x16, cudaStream_t cs) {
  if (p <= 0 || s <= 0 || n <= 0 || n > kMaxN || nsample <= 0 || n_layers <= 0 ||
      n_layers > kMaxLayers || c < 0 || (c > 0) != (feat != nullptr) ||
      (c > 0) != (dfeat != nullptr) || widths[0] != c + 3)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(p) * n > 0x7fffffffLL / 2) return static_cast<int>(cudaErrorInvalidValue);
  const bool bf16 = x16 != nullptr;
  if (bf16 && (nsample > kMaxSlots || x16->chunk <= 0 || x16->win == nullptr ||
               x16->a0 == nullptr || x16->a1 == nullptr || x16->d == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Bwd st;
  st.new_xyz = new_xyz;
  st.xyz = xyz;
  st.feat = feat;
  st.gout = gout;
  st.dxyz = dxyz;
  st.dfeat = dfeat;
  st.sel = sel;
  st.act = act;
  st.t = t;
  st.da = da;
  st.win = bf16 ? x16->win : nullptr;
  st.p = p;
  st.s = s;
  st.n = n;
  st.c = c;
  st.nsample = nsample;
  st.n_layers = n_layers;
  st.r2 = r2;
  const size_t total = static_cast<size_t>(p) * n;
  st.lda = st.ldb = 4;
  for (int l = 0; l <= n_layers; ++l)
    if (widths[l] <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const ActLayout lay = act_layout(total, n_layers, widths);
  for (int l = 0; l <= n_layers; ++l) {
    st.width[l] = widths[l];
    st.ld[l] = lay.ld[l];
    st.act_off[l] = lay.act_off[l];
    if (l < n_layers) {
      int& ld = (l & 1) ? st.ldb : st.lda;
      if (st.ld[l] > ld) ld = st.ld[l];
      st.w[l] = static_cast<const float*>(layers[6 * l]);
      st.b[l] = static_cast<const float*>(layers[6 * l + 2]);
      st.mu[l] = static_cast<const float*>(layers[6 * l + 3]);
      st.mul[l] = static_cast<const float*>(layers[6 * l + 4]);
      st.beta[l] = static_cast<const float*>(layers[6 * l + 5]);
      st.t_off[l] = lay.t_off[l];
    }
  }
  st.rows = pick_rows(st.lda, st.ldb);
  if (replay && st.rows == 0) return static_cast<int>(cudaErrorInvalidValue);
  st.qb = 4096 / n > 0 ? 4096 / n : 1;
  if (st.qb > s) st.qb = s;
  const int cout = widths[n_layers];
  // route blocks: up to kRouteCh channels, fewer where two blocks would not
  // share an SM, or one would not fit
  // the slots are staged where they fit beside 4 channels
  const int staged_ns = route_bytes(n, s, nsample, 4) <= kSmemLimit ? nsample : 0;
  int ch0 = 4;
  while (ch0 < kRouteCh && ch0 < cout) ch0 *= 2;
  auto route_ch = [&](size_t budget) {
    int ch = ch0;
    while (ch > 4 && route_bytes(n, s, staged_ns, ch) > budget) ch /= 2;
    return ch;
  };
  const size_t shared2 = (kSmemLimit + 1024) / kMinBlocks - 1024;
  st.ch = route_ch(shared2);
  if (route_bytes(n, s, staged_ns, st.ch) > shared2) st.ch = route_ch(kSmemLimit);
  if (route_bytes(n, s, staged_ns, st.ch) > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  if (part_n < static_cast<long long>(part_floats(static_cast<int>(total), n_layers, widths)))
    return static_cast<int>(cudaErrorInvalidValue);

  const size_t sel_bytes =
      static_cast<size_t>(st.qb) * (4 + select_words(n, nsample)) * sizeof(float);
  const size_t fwd_bytes = static_cast<size_t>(st.rows) * (st.lda + st.ldb) * sizeof(float);
  const size_t rt_bytes = route_bytes(n, s, staged_ns, st.ch);
  auto route = bf16 ? (staged_ns ? route_kernel<true, true> : route_kernel<false, true>)
                    : (staged_ns ? route_kernel<true, false> : route_kernel<false, false>);
  auto forward = bf16 ? forward_kernel<true> : forward_kernel<false>;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(forward, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(fwd_bytes))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(kXSmemBytes))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(route, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(rt_bytes))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(wgrad_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(kWSmemBytes))) != cudaSuccess)
    return static_cast<int>(err);

  if (replay) {
    const long long qblocks = (s + st.qb - 1) / st.qb;
    select_kernel<<<static_cast<unsigned>(p * qblocks), kThreads, sel_bytes, cs>>>(st);
    forward<<<static_cast<unsigned>((total + st.rows - 1) / st.rows), kThreads, fwd_bytes,
              cs>>>(st);
  }
  route<<<static_cast<unsigned>(p * ((cout + st.ch - 1) / st.ch)), kThreads, rt_bytes, cs>>>(st);
  if (bf16) {
    // the per-slot chain, a chunk of patches at a time
    const size_t rg_bytes = static_cast<size_t>(regroup_groups(n)) * n * 32 * sizeof(float);
    if (regroup_groups(n) < 1 ||
        (err = cudaFuncSetAttribute(chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(kGSmemBytes))) != cudaSuccess ||
        (err = cudaFuncSetAttribute(regroup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(rg_bytes))) != cudaSuccess)
      return static_cast<int>(regroup_groups(n) < 1 ? cudaErrorInvalidValue : err);
    for (int p0 = 0; p0 < p; p0 += x16->chunk) {
      const int pc = min(x16->chunk, p - p0);
      const int rows = pc * s * nsample;
      const int lda_top = (cout + 15) & ~15;
      const long long top = static_cast<long long>(rows) * lda_top;
      top_kernel<<<static_cast<unsigned>((top + 255) / 256), 256, 0, cs>>>(st, p0, rows, lda_top,
                                                                           x16->a0);
      unsigned short* a = x16->a0;
      unsigned short* aout = x16->a1;
      for (int l = n_layers - 1; l >= 0; --l) {
        const int lda = (widths[l + 1] + 15) & ~15, ldo = (widths[l] + 15) & ~15;
        const long long blocks =
            static_cast<long long>((ldo + kGBN - 1) / kGBN) * ((rows + kGBM - 1) / kGBM);
        chain_kernel<<<static_cast<unsigned>(blocks), kThreads, kGSmemBytes, cs>>>(
            st, l, p0, rows, a, lda, static_cast<const unsigned short*>(layers[6 * l + 1]),
            x16->d, aout);
        const int cols = l > 0 ? st.ld[l] : widths[l];
        regroup_kernel<<<static_cast<unsigned>(pc * ((cols + 31) / 32)), kThreads, rg_bytes,
                         cs>>>(st, l, p0, x16->d);
        unsigned short* tmp = a;
        a = aout;
        aout = tmp;
      }
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
  }
  for (int l = n_layers - 1; l >= 0 && !bf16; --l) {
    const int ci = widths[l], ldi = st.ld[l];
    const size_t blocks = ((ldi + kXBN - 1) / kXBN) * ((total + kXBM - 1) / kXBM);
    dx_kernel<<<static_cast<unsigned>(blocks), kWThreads, kXSmemBytes, cs>>>(
        da + st.t_off[l], st.ld[l + 1], static_cast<const float*>(layers[6 * l + 1]), ldi, ci,
        l > 0 ? act + st.act_off[l] : nullptr, l > 0 ? da + st.t_off[l - 1] : nullptr,
        static_cast<int>(total), dfeat, dxyz, c);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  float* out = grads;
  for (int l = 0; l < n_layers; ++l) {
    const int ci = widths[l], co = widths[l + 1];
    int chunk;
    const int splits = wgrad_splits(static_cast<int>(total), ci, co, &chunk);
    float* vpart = part + static_cast<size_t>(splits) * ci * co;
    wgrad_tf32_kernel<<<dim3((co + kWBN - 1) / kWBN, (ci + kWBM - 1) / kWBM, splits), kWThreads,
                        kWSmemBytes, cs>>>(act + st.act_off[l], st.ld[l], ci, da + st.t_off[l],
                                           st.ld[l + 1], co, t + st.t_off[l],
                                           static_cast<int>(total), chunk, part, vpart);
    // dW = mul * sum, then (db, dmul, dbeta) = (mul * sum da, sum da t, sum da)
    split_sum_kernel<<<(ci * co + 31) / 32, 256, 0, cs>>>(part, ci * co, ci * co, splits,
                                                          st.mul[l], co, ci * co, out);
    out += static_cast<size_t>(ci) * co;
    split_sum_kernel<<<(3 * co + 31) / 32, 256, 0, cs>>>(vpart, 3 * co, 3 * co, splits,
                                                         st.mul[l], co, co, out);
    out += 3 * static_cast<size_t>(co);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// new_xyz [p, s, 3], xyz [p, n, 3], feat [p, n, c] or null (c = 0), gout
// [p, s, widths[n_layers]], all f32 contiguous. layers: host array of
// 6 * n_layers device pointers per layer: W [in, out], (W * mul)^T
// [round4(out), round4(in)] zero-padded, b, mean, mul, beta (16-byte
// aligned); widths: host
// array of n_layers + 1 ints, widths[0] = c + 3. Outputs dxyz [p, n, 3],
// dfeat [p, n, c] (or null), grads (per layer dW, db, dmul, dbeta). Scratch,
// as pcc_tpu_torch/ops/pppf_sa_cuda.py::_bwd_workspace sizes it: sel (p * s
// * nsample ints), act (p * n * sum_l round4(widths[l]) floats, l =
// 0..n_layers), t and da (p * n * sum_l round4(widths[l]) floats each, l =
// 1..n_layers; both as pppf_sa_common.cuh::act_layout(p * n, ...) lays them
// out), part (part_n floats: for each layer, splits * (in + 3) * out with
// tf32_mma.cuh::wgrad_splits(p * n, in, out); the largest). replay: 1 to
// select and replay the stack into sel, act and t first; 0 where the forward
// kernel's store mode wrote them. Returns a cudaError_t value.
extern "C" int pppf_sa_stage_bwd_launch(const float* new_xyz, const float* xyz,
                                        const float* feat, const float* gout, int p, int s,
                                        int n, int c, int nsample, float r2, int n_layers,
                                        const void* const* layers, const int* widths,
                                        float* dxyz, float* dfeat, float* grads, int* sel,
                                        float* act, float* t, float* da, float* part,
                                        long long part_n, int replay, void* stream) {
  return bwd_launch(new_xyz, xyz, feat, gout, p, s, n, c, nsample, r2, n_layers, layers, widths,
                    dxyz, dfeat, grads, sel, act, t, da, part, part_n, replay, nullptr,
                    static_cast<cudaStream_t>(stream));
}

// The bf16 instance: the arguments of pppf_sa_stage_bwd_launch, the second
// pointer of each layer being bf16(W) [pad16(in)][pad16(out)] zero-padded (in
// place of (W * mul)^T), W bf16-exact, and where replay is 0, sel, act and t
// from the bf16 store mode (pppf_sa_stage_bf16_save_launch); then the
// chain's buffers: win (p * s * widths[n_layers] bytes), a0 and a1 (chunk *
// s * nsample * pad16(max widths[1..n_layers]) bf16 each), d (chunk * s *
// nsample * pad16(max widths[0..n_layers-1]) floats) and chunk, the patches
// per pass. nsample <= 254. Returns a cudaError_t value.
extern "C" int pppf_sa_stage_bwd_bf16_launch(
    const float* new_xyz, const float* xyz, const float* feat, const float* gout, int p, int s,
    int n, int c, int nsample, float r2, int n_layers, const void* const* layers,
    const int* widths, float* dxyz, float* dfeat, float* grads, int* sel, float* act, float* t,
    float* da, float* part, long long part_n, int replay, unsigned char* win,
    unsigned short* a0, unsigned short* a1, float* d, int chunk, void* stream) {
  const Bf16Chain x16{win, a0, a1, d, chunk};
  return bwd_launch(new_xyz, xyz, feat, gout, p, s, n, c, nsample, r2, n_layers, layers, widths,
                    dxyz, dfeat, grads, sel, act, t, da, part, part_n, replay, &x16,
                    static_cast<cudaStream_t>(stream));
}
