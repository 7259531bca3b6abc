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
// caller allocates:
//  1. select:   per patch and group of queries, the forward's selection and
//               ball mask -> sel [P, S, nsample], ranked by (distance, index)
//               also where nsample >= N, since the first winner depends on
//               the order (coincident float32 values tie exactly, about one
//               maximum in 1e5 at the PPPF-AE stages);
//  2. forward:  per tile of points, every layer's input x_l and shifted
//               pre-activation t_l = (z + b) - mean -> act, t;
//  3. winners:  per (patch, query, channel), slots in order: the first slot
//               reaching the maximum; then per (patch, channel), queries in
//               order, each live maximum's gout added to its point's
//               gradient (the last layer's da);
//  4. backward: per tile of points, layer by layer down: dz = da * mul,
//               dx = dz W^T (the forward's product on the transposed,
//               zero-padded weights), da of the layer below = dx * (x > 0);
//               the first layer's dx is the point's [dfeat | dxyz];
//  5. wgrad:    dW = sum over points x^T dz, split over kSplit fixed row
//               ranges into a partial buffer; db, dmul, dbeta the same way
//               over kVSplit ranges;
//  6. sum:      the partials summed in order.
// No float atomics: every sum runs in a fixed order, so two launches give
// bitwise equal outputs.
//
// What bounds it on an H100: operations. Per point the replay and the two
// backward products are 6 FLOP per multiply-add of the stack (0.4 TFLOP at
// the PPPF-AE train step's 512 patches, 6 ms at 67 TFLOP/s float32), plus the
// selection (9 FLOP per query-point pair) and one comparison per slot and
// channel for the routing. Float32 on CUDA cores (TF32 would not hold the
// 1e-4 agreement with the plain version); the activations go through device
// memory between the six kernels (about 1.7 GB at sa3), and the weight
// gradients are a simple tiled product: tensor cores, and keeping the
// activations on chip, are later work.

#include <cuda_runtime.h>

#include "pppf_sa_common.cuh"

namespace {

using namespace pcc_sa;

constexpr int kSplit = 16;          // row ranges of the weight-gradient sums
constexpr int kVSplit = 128;        // row ranges of the bias and BatchNorm gradient sums
constexpr int kMinBlocks = 2;
constexpr int kWTile = 64;          // weight-gradient output tile (kWTile x kWTile)
constexpr int kWRows = 16;          // rows staged per step of the weight gradient

struct Bwd {
  const float* new_xyz;   // [P, S, 3]
  const float* xyz;       // [P, N, 3]
  const float* feat;      // [P, N, C] or nullptr
  const float* gout;      // [P, S, width[n_layers]]
  float* dxyz;            // [P, N, 3]
  float* dfeat;           // [P, N, C] or nullptr
  int* sel;               // [P, S, nsample]
  int* win;               // [P, S, width[n_layers]]: the point each max routes to, or -1
  float* act;             // x_l, l = 0..n_layers: [P * N, ld[l]] each
  float* t;               // t_l, l = 0..n_layers-1: [P * N, ld[l + 1]] each
  float* da;              // da_l, laid out as t
  int p, s, n, c, nsample, n_layers;
  float r2;
  int rows;               // point tile of the forward replay
  int rows_b;             // point tile of the backward
  int lda, ldb;           // forward replay buffers
  int ldA, ldB;           // backward buffers
  int qb;                 // queries per select block
  int width[kMaxLayers + 1];
  int ld[kMaxLayers + 1];
  size_t act_off[kMaxLayers + 1];
  size_t t_off[kMaxLayers];
  const float* w[kMaxLayers];
  const float* wt[kMaxLayers];   // W^T [cout, round4(cin)], zero-padded
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

// 3a. max routing: per (patch, query, channel), the first slot in selection
// order whose last activation reaches the maximum: win = its point where the
// maximum is > 0, else -1.
__global__ void __launch_bounds__(kThreads) winners_kernel(const __grid_constant__ Bwd st) {
  const int L = st.n_layers, cout = st.width[L];
  const int p = blockIdx.x;
  const int e = blockIdx.y * kThreads + threadIdx.x;
  if (e >= st.s * cout) return;
  const int q = e / cout, o = e % cout;
  const int ld = st.ld[L];
  const float* a = st.act + st.act_off[L] + static_cast<size_t>(p) * st.n * ld + o;
  const int* sel = st.sel + (static_cast<size_t>(p) * st.s + q) * st.nsample;
  float best = -1.0f;
  int bj = 0;
  for (int k = 0; k < st.nsample; ++k) {
    const int j = __ldg(sel + k);
    const float v = a[static_cast<size_t>(j) * ld];
    if (v > best) {
      best = v;
      bj = j;
    }
  }
  st.win[static_cast<size_t>(p) * st.s * cout + e] = best > 0.0f ? bj : -1;
}

// 3b. thread (patch, channel) adds each live maximum's cotangent to its
// winner's row of the last layer's da, queries in order (it owns column o of
// patch p: no other thread writes it).
__global__ void __launch_bounds__(128) route_kernel(const __grid_constant__ Bwd st) {
  const int L = st.n_layers, cout = st.width[L];
  const int p = blockIdx.x;
  const int o = blockIdx.y * blockDim.x + threadIdx.x;
  if (o >= cout) return;
  const int ld = st.ld[L];
  float* g = st.da + st.t_off[L - 1] + static_cast<size_t>(p) * st.n * ld + o;
  for (int j = 0; j < st.n; ++j) g[static_cast<size_t>(j) * ld] = 0.0f;
  const int* win = st.win + static_cast<size_t>(p) * st.s * cout + o;
  const float* go = st.gout + static_cast<size_t>(p) * st.s * cout + o;
  for (int q = 0; q < st.s; ++q) {
    const int j = win[static_cast<size_t>(q) * cout];
    if (j >= 0) g[static_cast<size_t>(j) * ld] += __ldg(go + static_cast<size_t>(q) * cout);
  }
}

// 4. per tile of points, the layers backwards: dz_l = da_l * mul_l in one
// shared buffer, dx_l = dz_l W_l^T into the other, then da_{l-1} = dx_l *
// (x_l > 0), stored for the weight gradients and scaled in place into
// dz_{l-1}. The first layer's dx is [dfeat | dxyz].
__global__ void __launch_bounds__(kThreads, kMinBlocks)
backward_kernel(const __grid_constant__ Bwd st) {
  extern __shared__ __align__(16) float smem[];
  float* bufs[2] = {smem, smem + st.rows_b * st.ldA};
  const int lds[2] = {st.ldA, st.ldB};
  const int total = st.p * st.n;
  const int row0 = blockIdx.x * st.rows_b;
  const int valid = min(st.rows_b, total - row0);
  const int L = st.n_layers;
  {
    const int w = st.width[L], ld = st.ld[L];
    const float* g = st.da + st.t_off[L - 1] + static_cast<size_t>(row0) * ld;
    for (int e = threadIdx.x; e < st.rows_b * w; e += kThreads) {
      const int rl = e / w, o = e % w;
      bufs[0][rl * st.ldA + o] = rl < valid ? __fmul_rn(g[rl * ld + o], __ldg(st.mul[L - 1] + o))
                                            : 0.0f;
    }
  }
  __syncthreads();
  for (int l = L - 1, cur = 0; l >= 0; --l, cur ^= 1) {
    float* dz = bufs[cur];
    float* dx = bufs[cur ^ 1];
    const int cin = st.width[l];
    dense_layer<kLinear>(dz, lds[cur], st.rows_b, st.width[l + 1], st.wt[l], round4(cin),
                         nullptr, nullptr, nullptr, nullptr, round4(cin), dx, lds[cur ^ 1],
                         nullptr, 0, 0, 1, GlobalRows{});
    __syncthreads();
    if (l > 0) {
      const int ld = st.ld[l];
      const float* x = st.act + st.act_off[l] + static_cast<size_t>(row0) * ld;
      float* da = st.da + st.t_off[l - 1] + static_cast<size_t>(row0) * ld;
      for (int e = threadIdx.x; e < st.rows_b * cin; e += kThreads) {
        const int rl = e / cin, k = e % cin;
        float v = 0.0f;
        if (rl < valid) {
          v = x[rl * ld + k] > 0.0f ? dx[rl * lds[cur ^ 1] + k] : 0.0f;
          da[rl * ld + k] = v;
        }
        dx[rl * lds[cur ^ 1] + k] = __fmul_rn(v, __ldg(st.mul[l - 1] + k));
      }
    } else {
      for (int e = threadIdx.x; e < valid * cin; e += kThreads) {
        const int rl = e / cin, k = e % cin;
        const size_t r = static_cast<size_t>(row0) + rl;
        const float v = dx[rl * lds[cur ^ 1] + k];
        if (k < st.c) {
          st.dfeat[r * st.c + k] = v;
        } else {
          st.dxyz[r * 3 + (k - st.c)] = v;
        }
      }
    }
    __syncthreads();
  }
}

// 5a. part[split][i][o] = sum over the split's rows r of x[r][i] * da[r][o] * mul[o]
// for one kWTile x kWTile tile; 256 threads, 4 x 4 outputs each.
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const float* __restrict__ x, int ldx, const float* __restrict__ da, int ldd,
             const float* __restrict__ mul, int rows, int cin, int cout, float* part) {
  __shared__ float xs[kWRows][kWTile];
  __shared__ float ds[kWRows][kWTile];
  const int o0 = blockIdx.x * kWTile, i0 = blockIdx.y * kWTile, split = blockIdx.z;
  const int chunk = (rows + kSplit - 1) / kSplit;
  const int r_begin = split * chunk, r_end = min(rows, r_begin + chunk);
  const int ti = threadIdx.x / 16, to = threadIdx.x % 16;
  float acc[4][4] = {};
  for (int r0 = r_begin; r0 < r_end; r0 += kWRows) {
    for (int e = threadIdx.x; e < kWRows * kWTile; e += kThreads) {
      const int rr = e / kWTile, cc = e % kWTile, r = r0 + rr;
      const bool row_ok = r < r_end;
      xs[rr][cc] = row_ok && i0 + cc < cin ? x[static_cast<size_t>(r) * ldx + i0 + cc] : 0.0f;
      ds[rr][cc] = row_ok && o0 + cc < cout
                       ? __fmul_rn(da[static_cast<size_t>(r) * ldd + o0 + cc], __ldg(mul + o0 + cc))
                       : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kWRows; ++rr) {
      float xv[4], dv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        xv[a] = xs[rr][ti + 16 * a];
        dv[a] = ds[rr][to + 16 * a];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(xv[a], dv[c], acc[a][c]);
    }
    __syncthreads();
  }
  float* pp = part + static_cast<size_t>(split) * cin * cout;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = i0 + ti + 16 * a, o = o0 + to + 16 * c;
      if (i < cin && o < cout) pp[static_cast<size_t>(i) * cout + o] = acc[a][c];
    }
}

// 5b. part[split][v][o], v = db, dmul, dbeta: sums over the split's rows of
// da * mul, da * t and da.
__global__ void __launch_bounds__(128)
vgrad_kernel(const float* __restrict__ da, const float* __restrict__ t, int ld,
             const float* __restrict__ mul, int rows, int cout, float* part) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x, split = blockIdx.y;
  if (o >= cout) return;
  const int chunk = (rows + kVSplit - 1) / kVSplit;
  const int r_end = min(rows, (split + 1) * chunk);
  const float m = __ldg(mul + o);
  float sb = 0.0f, sm = 0.0f, sg = 0.0f;
  for (int r = split * chunk; r < r_end; ++r) {
    const float d = da[static_cast<size_t>(r) * ld + o];
    sb += __fmul_rn(d, m);
    sm = fmaf(d, t[static_cast<size_t>(r) * ld + o], sm);
    sg += d;
  }
  float* pp = part + static_cast<size_t>(split) * 3 * cout;
  pp[o] = sb;
  pp[cout + o] = sm;
  pp[2 * cout + o] = sg;
}

// 6. out[e] = sum over the splits, in order, of part[split][e]
__global__ void __launch_bounds__(kThreads)
sum_kernel(const float* __restrict__ part, int size, int splits, float* out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= size) return;
  float s = 0.0f;
  for (int k = 0; k < splits; ++k) s += part[static_cast<size_t>(k) * size + e];
  out[e] = s;
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

}  // namespace

// new_xyz [p, s, 3], xyz [p, n, 3], feat [p, n, c] or null (c = 0), gout
// [p, s, widths[n_layers]], all f32 contiguous. layers: host array of
// 6 * n_layers device pointers per layer: W [in, out], W^T [out, round4(in)]
// zero-padded, b, mean, mul, beta (16-byte aligned); widths: host array of
// n_layers + 1 ints, widths[0] = c + 3. Outputs dxyz [p, n, 3], dfeat
// [p, n, c] (or null), grads (per layer dW, db, dmul, dbeta). Scratch, as
// pcc_tpu_torch/ops/pppf_sa_cuda.py::_bwd_workspace sizes it: sel (p * s *
// nsample ints), win (p * s * widths[n_layers] ints), act (p * n * sum_l
// round4(widths[l]) floats, l = 0..n_layers), t and da (p * n * sum_l
// round4(widths[l]) floats each, l = 1..n_layers), part (max over layers of
// kSplit * in * out and kVSplit * 3 * out floats). Returns a cudaError_t value.
extern "C" int pppf_sa_stage_bwd_launch(const float* new_xyz, const float* xyz,
                                        const float* feat, const float* gout, int p, int s,
                                        int n, int c, int nsample, float r2, int n_layers,
                                        const void* const* layers, const int* widths,
                                        float* dxyz, float* dfeat, float* grads, int* sel,
                                        int* win, float* act, float* t, float* da,
                                        float* part, void* stream) {
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
  st.win = win;
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
  size_t act_off = 0, t_off = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (widths[l] <= 0) return static_cast<int>(cudaErrorInvalidValue);
    st.width[l] = widths[l];
    st.ld[l] = round4(widths[l]);
    st.act_off[l] = act_off;
    act_off += total * st.ld[l];
    if (l < n_layers) {
      int& ld = (l & 1) ? st.ldb : st.lda;
      if (st.ld[l] > ld) ld = st.ld[l];
      st.w[l] = static_cast<const float*>(layers[6 * l]);
      st.wt[l] = static_cast<const float*>(layers[6 * l + 1]);
      st.b[l] = static_cast<const float*>(layers[6 * l + 2]);
      st.mu[l] = static_cast<const float*>(layers[6 * l + 3]);
      st.mul[l] = static_cast<const float*>(layers[6 * l + 4]);
      st.beta[l] = static_cast<const float*>(layers[6 * l + 5]);
    }
    if (l > 0) {
      st.t_off[l - 1] = t_off;
      t_off += total * st.ld[l];
    }
  }
  // backward buffers: dz of layer n_layers - 1 in A, then alternating
  st.ldA = st.ldB = 4;
  for (int l = n_layers, k = 0; l >= 0; --l, k ^= 1) {
    int& ld = k ? st.ldB : st.ldA;
    if (st.ld[l] > ld) ld = st.ld[l];
  }
  st.rows = pick_rows(st.lda, st.ldb);
  st.rows_b = pick_rows(st.ldA, st.ldB);
  if (st.rows == 0 || st.rows_b == 0) return static_cast<int>(cudaErrorInvalidValue);
  st.qb = 4096 / n > 0 ? 4096 / n : 1;
  if (st.qb > s) st.qb = s;

  const size_t sel_bytes =
      static_cast<size_t>(st.qb) * (4 + select_words(n, nsample)) * sizeof(float);
  const size_t fwd_bytes = static_cast<size_t>(st.rows) * (st.lda + st.ldb) * sizeof(float);
  const size_t bwd_bytes = static_cast<size_t>(st.rows_b) * (st.ldA + st.ldB) * sizeof(float);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(fwd_bytes))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(bwd_bytes))) != cudaSuccess)
    return static_cast<int>(err);

  const long long qblocks = (s + st.qb - 1) / st.qb;
  select_kernel<<<static_cast<unsigned>(p * qblocks), kThreads, sel_bytes, cs>>>(st);
  forward_kernel<<<static_cast<unsigned>((total + st.rows - 1) / st.rows), kThreads,
                   fwd_bytes, cs>>>(st);
  const int cout = widths[n_layers];
  winners_kernel<<<dim3(p, (s * cout + kThreads - 1) / kThreads), kThreads, 0, cs>>>(st);
  route_kernel<<<dim3(p, (cout + 127) / 128), 128, 0, cs>>>(st);
  backward_kernel<<<static_cast<unsigned>((total + st.rows_b - 1) / st.rows_b), kThreads,
                    bwd_bytes, cs>>>(st);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  float* out = grads;
  for (int l = 0; l < n_layers; ++l) {
    const int ci = widths[l], co = widths[l + 1];
    wgrad_kernel<<<dim3((co + kWTile - 1) / kWTile, (ci + kWTile - 1) / kWTile, kSplit),
                   kThreads, 0, cs>>>(act + st.act_off[l], st.ld[l], da + st.t_off[l],
                                      st.ld[l + 1], st.mul[l], static_cast<int>(total), ci, co,
                                      part);
    sum_kernel<<<(ci * co + kThreads - 1) / kThreads, kThreads, 0, cs>>>(part, ci * co, kSplit,
                                                                          out);
    out += static_cast<size_t>(ci) * co;
    vgrad_kernel<<<dim3((co + 127) / 128, kVSplit), 128, 0, cs>>>(
        da + st.t_off[l], t + st.t_off[l], st.ld[l + 1], st.mul[l], static_cast<int>(total),
        co, part);
    sum_kernel<<<(3 * co + kThreads - 1) / kThreads, kThreads, 0, cs>>>(part, 3 * co, kVSplit,
                                                                         out);
    out += 3 * static_cast<size_t>(co);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
