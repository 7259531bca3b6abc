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
      v = c < st.c ? __ldg(st.feat + r * st.c + c) : __ldg(st.xyz + r * 3 + (c - st.c));
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
    dense_layer<kStoreGlobal>(src, (l & 1) ? st.ldb : st.lda, st.rows, st.width[l], st.w[l],
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
template <bool kStaged>
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
      int bj = 0;
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
          }
      }
      for (; k < st.nsample; ++k) {
        const int j = sel[k];
        const float v = a[j * ch + c];
        if (v > best) {
          best = v;
          bj = j;
        }
      }
      const bool live = best > 0.0f && c < nch;
      win[q * ch + c] = live ? static_cast<unsigned short>(bj) : kDead;
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
  if (p <= 0 || s <= 0 || n <= 0 || n > kMaxN || nsample <= 0 || n_layers <= 0 ||
      n_layers > kMaxLayers || c < 0 || (c > 0) != (feat != nullptr) ||
      (c > 0) != (dfeat != nullptr) || widths[0] != c + 3)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(p) * n > 0x7fffffffLL / 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
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
  auto route = staged_ns ? route_kernel<true> : route_kernel<false>;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
    forward_kernel<<<static_cast<unsigned>((total + st.rows - 1) / st.rows), kThreads,
                     fwd_bytes, cs>>>(st);
  }
  route<<<static_cast<unsigned>(p * ((cout + st.ch - 1) / st.ch)), kThreads, rt_bytes, cs>>>(st);
  for (int l = n_layers - 1; l >= 0; --l) {
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
