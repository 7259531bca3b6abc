// One PointNet++ set-abstraction stage, fused: selection, ball mask, the
// Conv + BatchNorm(eval) + ReLU stack and the max over samples, one launch.
//
// Replaces the TPU kernel pcc_tpu/ops/pppf_sa_pallas.py::_stage_kernel
// (entry pppf_sa_fused). Per patch and query point it computes: the
// expanded-form squared distances max((q2 - 2 cross) + p2, 0) to the patch's
// N points; the nsample nearest as a set (ties to the lower index; slots
// beyond N read point 0); layout "pppf": the rows [feat | xyz] of the
// selected points, uncentred, with every slot whose exactly recomputed
// distance exceeds the radius replaced by point 0's row; layout "pppe": the
// rows [xyz - query | feat], no mask; then per layer
// relu(((x W + b) - mean) * mul + beta) and the max over the nsample rows.
// Output [P, S, C_out]. Each layout's design follows.
//
// Layout "pppf", per point. A slot's row is its point's [feat | xyz],
// uncentred, so its activations depend on the point alone, and the max over
// a query's slots is the max over the set of points its slots read: its
// selected in-ball points, and point 0 when a slot is masked or lies beyond
// N (duplicates do not change a max). The work the function needs is the
// stack on P * N point rows, 32x fewer than the P * S * nsample slot rows at
// each PPPF-AE stage, plus the selection (9 FLOP per query-point distance,
// where nsample < N) and one comparison per (query, slot, output channel)
// for the max: about 267 GFLOP for the three stages at a 16-cloud batch
// (P = 1024), 4.0 ms at 67 TFLOP/s.
// What bounds it on an H100: operations (a few KB of input per patch against
// MFLOPs of products), float32 on CUDA cores (TF32 would not hold the 1e-4
// agreement with the plain version).
// What the design does: a block owns one patch. It first selects, a group of
// queries at a time, with pppf_sa_common.cuh::select_slots (a warp per
// query: the nsample-th smallest distance by a binary search on its bits,
// then the selected points ranked among themselves, nsample^2 comparisons
// where ranking every point would take N^2), and keeps
// each query's set as a bitmask over the patch's points (N / 32 words per
// query). Then it runs the stack
// on the patch's points in tiles of rows, with the register-tiled product of
// pppf_sa_common.cuh (a thread 8 rows x 4 columns, 16-byte activation
// broadcasts, 16-byte weight loads through the read-only cache; each output
// summed in k-order from 0, so every point's activations are those of its
// slots in the per-slot path, bit for bit). The BatchNorm affine and relu
// apply per row before the max, since scales can be negative. The last layer
// is never stored whole (128 points x 1024 channels would be 512 KB at the
// widest stage): it runs a column chunk at a time into shared memory, and
// each (8 queries, 4 channels) item walks the chunk's rows that any of its
// queries holds (the set bits of their masks in the tile's range), each row
// read once for the 8, into the queries' maxima in the output, which the
// block alone owns (written at the first tile, read and rewritten at later
// ones; relu outputs are >= 0, so a maximum from 0 is exact). Why a block per patch and not per patch x column tile: the
// selection and every layer but the last would be repeated per column tile
// (1.33x the products at the widest stage with two tiles), while P = 1024
// patches at the serving batch already give about 4 waves of two blocks per
// SM (2 at the train step's P = 512). Tiles are sized so that two blocks
// share an SM (128 rows at sa1, 64 at sa2, 32 at sa3): 16 resident warps
// hide the weight loads' latency (one block per SM with 64-row tiles, and
// 16 rows a thread, were no faster over the three stages on an H100).
//
// Store mode ("pppf" per point; the train step's forward asks for it): the
// same kernel, templated, also writes each query's slots ranked by
// (distance, index), every layer's input x_l and shifted pre-activation t_l
// and the last activations to device memory (pppf_sa_common.cuh::
// ActLayout), so that the backward kernel (pppf_sa_stage_bwd.cu) neither
// selects nor replays the stack. Its outputs are bit for bit the serving
// mode's, which is compiled without the stores.
//
// Layout "pppf" where the queries' masks do not fit in shared memory beside
// the smallest tile, and layout "pppe" where the slot kernel below finds no
// tile (a layer between the first and the last wider than 1024, or 32 rows
// of the widest layer but the last beyond shared memory), per slot: the
// rows as the layout gathers them; a block owns a few queries of one patch (as
// many as fill a tile of up to 64 rows; one query when nsample is larger,
// its rows taken tile by tile), gathers a tile's rows and runs the layers
// between two activation buffers in shared memory; each thread folds the
// last layer's rows into a per-query maximum in shared memory (integer
// atomicMax on the float's bits, started from 0: exact because every layer,
// the last included, ends in a relu, so every value is >= 0 and orders as
// its bits do).
//
// Layout "pppe": a slot's row [x_j - c | f_j] is centred on its query, so
// every layer but the first depends on the slot; the first is linear, and
// its product with the point's features f_j W1[3:] is the same in every slot
// that reads the point. PPPE's sa2 and sa3 (models/pppe.py: 128 of 512 and
// 32 of 128 points, widths 195-128-128-256 and 259-256-256-512, nsample 32,
// no radius, 32 clouds a serving batch) need 14.1 and 13.6 GFLOP that way
// (ops/pppf_sa_cuda.py::stage_flops), 37 where every slot runs the whole
// stack. What bounds it on an H100: operations, 0.41 ms for the two in
// float32 at 67 TFLOP/s; 0.17 ms with the products as 3xTF32 on the tensor
// cores (three TF32 products each at 495 TFLOP/s dense; plain TF32 would not
// hold the 1e-4 agreement with the plain version). What the design does:
// two kernels, one launch. The feature block (pppe_feature_kernel) computes
// y = F W1[3:] once per point, a 3xTF32 mma.sync product (mma_tile.cuh) of
// 128 x 128 tiles with k-slabs of F and W double-buffered by cp.async, into
// a scratch [P, N, C1] the wrapper allocates (none where C = 0). The slots
// (pppe_slots_kernel): a block selects its queries' slots (select_slots, no
// mask), then per tile of up to 128 rows (4 queries at nsample 32) gathers
// the rows y[j] by cp.async and completes layer 1 in place, y[j] + (x_j -
// c) W1[:3] from the centred coordinates in float32 (three multiply-adds a
// channel; folding c W1[:3] into y would cancel far from the origin), the
// BatchNorm affine and relu; layers 2 .. L run as 3xTF32 mma.sync on the
// tile in shared memory, their weights streamed in k-slabs (cp.async,
// double-buffered, zero-padded past the edges, so widths need not be
// multiples of 8; split hi / lo per fragment as a warp reads them, which
// measured faster than splitting each slab once, mma_tile.cuh::warp_mma); a
// layer before the last keeps its whole output in the accumulators and
// overwrites its input in place, so a tile of 128 rows fits at sa3's
// 256-wide layers; the last layer folds from the fragments
// into the queries' maxima (shuffles first where a warp's 32 rows are one
// query's). The tile and the blocks an SM follow the widths (launch_pppe):
// sa2 two blocks of 128 rows with passes of 128 columns, sa3 one block with
// passes of 256.

// The bf16 instances, layout "pppf" (pcc_tpu's compute_dtype bfloat16): W
// rounded to bf16 by the wrapper, b, mean, mul and beta float32, as
// pcc_tpu/ops/pppf_sa_pallas.py's bf16 stage keeps them. Each layer's input
// rows are bf16 (the gathered rows rounded, the uncentred xyz lanes
// included; later layers read the previous layer's rounded outputs), each
// relu output is rounded to bf16, and the max over samples is float32 over
// those bf16 values. Products of bf16 values are exact in float32, so each
// output is the float32 sum of exact products in k-order, which
// pppf_sa_cuda.py::stack_replay(bf16=True) replays.
// In serving (pppf_sa_stage_bf16_launch, namespace st16) the products run
// on the bf16 tensor cores, its outputs bit for bit the k-order ones. What
// bounds it on an H100: operations, 0.43 ms for PPPF-AE's three stages at
// the serving batch on the bf16 tensor cores (ops/pppf_sa_cuda.py::
// stage_flops), 4.0 ms in float32 on the CUDA cores, where the float32
// instance computes them. What the design does: the float32 instance's
// per-point design (a block per patch, select_slots, the queries' bitmasks,
// the fold into their maxima) on bf16 tiles of 16 to 128 point rows in
// shared memory, every layer at least 16 deep as mma.sync m16n8k16 with
// certified rounding (certified.cuh: a proven bound on each sum's distance
// from the k-order sum, the epilogue (z + b) - mean, fma(t, mul, beta),
// relu, round evaluated at both ends, which is monotone for either sign of
// mul; the 0.5-4% of entries a layer whose ends differ recomputed in
// k-order on the CUDA cores), the weights' fragments read through the
// read-only cache a step ahead; layers less deep (sa1's first two, K = 3)
// on the CUDA cores in k-order. The store mode (pppf_sa_stage_bf16_save_
// launch, the bf16 train step's forward) keeps the float32 instance's
// kernel templated on the rounding, the k-order arithmetic on the CUDA
// cores: its output is the serving launch's bit for bit, because both are
// that arithmetic's (tests/test_torch_port_cuda.py holds the two equal).
//
// The bf16 "pppe" instance (pppe_sa_stage_bf16_launch; pcc_tpu's
// compute_dtype bfloat16 with layout "pppe", PPPE's sa2 and sa3 in bf16
// eval mode): the slot kernel and the feature block templated on the
// rounding, and, where they find no tile, the per-slot kernel's bf16
// instance. W rounded by the wrapper, b, mean, mul and beta float32, as
// pcc_tpu's stage keeps them. pcc_tpu rounds each entry of a slot's row
// [x_j - c | f_j], so the first layer still splits per entry: the feature
// block round(f_j) W1[3:] once per point, then per slot round(x_j - c)
// W1[:3] (the centred coordinates rounded after the float32 subtraction);
// only the float32 order of the sum changes. Each layer's relu output is
// rounded (the last layer's at the end: rounding is monotone, so the
// rounded max is the max of the rounded values). The products of layers 2
// .. L and of the feature block take one TF32 mma.sync product a k = 8
// step on bf16 operands (mma_tile.cuh::warp_mma<NT, true>: a bf16 value is
// a TF32 value, and the product of two is exact in float32) where float32
// takes three; bf16 mma.sync m16n8k16 would halve the k-steps again. The
// bound: the float32 instance's work with the products on the bf16 tensor
// cores at 989 TFLOP/s.
//
// Selection is bit-equal to the plain PyTorch version
// (pcc_tpu_torch/ops/pppf_sa_cuda.py::pppf_sa_plain): the same distance
// formulas with one rounding per operation (__f*_rn intrinsics are never
// contracted into FMAs). The products sum in another order, so outputs
// agree to float32 rounding; pppf_sa_cuda.py::stack_replay repeats the
// kernel's own arithmetic. The selection, the mask and the layer product
// live in pppf_sa_common.cuh, which the backward kernel shares.

#include <cuda_runtime.h>

#include "certified.cuh"
#include "mma_tile.cuh"
#include "pppf_sa_common.cuh"

namespace {

using namespace pcc_sa;

// Blocks meant to share an SM: the registers allow two, and a tile is sized
// so that two fit in the SM's shared memory too. Two blocks per SM and 8 rows
// per thread won on the sum of the three PPPF-AE stages on an H100 in the
// per-slot form; 16 rows per thread was faster at the widest stage alone and
// slower at the other two.
constexpr int kMinBlocks = 2;
// per-point tiles: whole multiples of kTM * kWarps rows (every warp takes a
// row group of each 128-column chunk) up to this many, else multiples of kTM
constexpr int kMaxPointRows = 128;

struct Stage {
  const float* new_xyz;   // [P, S, 3]
  const float* xyz;       // [P, N, 3]
  const float* feat;      // [P, N, C] or nullptr
  float* out;             // [P, S, width[n_layers]]
  int s, n, c, nsample, n_layers;
  int pppe;               // the per-slot kernel's layout: 0 "pppf", 1 "pppe"
  float r2;
  int rows;               // rows per tile, a multiple of kTM
  int qb;                 // per slot: queries per block; per point: queries per selection group
  int lda, ldb;           // row strides of the two activation buffers
  int region;             // per point: words of the activation buffers and selection scratch
  int cc;                 // per point: columns per chunk of the last layer
  const float* y;         // "pppe": the feature block [P, N, width[1]] (null where c = 0)
  int ks;                 // "pppe": rows per k-slab of the weights
  int* gsel;              // store mode: the slots [P, S, nsample], ranked
  float* gact;            // store mode: every layer's input and the last
  float* gt;              //   activations, and t_l (pppf_sa_common.cuh::ActLayout)
  ActLayout lay;
  int width[kMaxLayers + 1];
  const float* w[kMaxLayers];
  const float* b[kMaxLayers];
  const float* mu[kMaxLayers];
  const float* mul[kMaxLayers];
  const float* beta[kMaxLayers];
};

// Per slot, shared memory in 4-byte words: the two activation buffers, the
// distances, the per-query maxima, the selected indices and the queries'
// coordinates.
__host__ __device__ inline size_t smem_words(int rows, int qb, int lda, int ldb, int cout,
                                             int n, int nsample) {
  return static_cast<size_t>(rows) * (lda + ldb) +
         (nsample < n ? static_cast<size_t>(qb) * select_words(n, nsample) : 0) +
         static_cast<size_t>(qb) * cout + static_cast<size_t>(qb) * nsample +
         static_cast<size_t>(qb) * 4;
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
pppf_sa_stage_kernel(const __grid_constant__ Stage st) {
  extern __shared__ __align__(16) float smem[];
  const int cout = st.width[st.n_layers];
  const int cin = st.width[0];
  float* buf_a = smem;
  float* buf_b = buf_a + st.rows * st.lda;
  float* dist = buf_b + st.rows * st.ldb;
  int* qmax = reinterpret_cast<int*>(
      dist + (st.nsample < st.n ? st.qb * select_words(st.n, st.nsample) : 0));
  int* sel = qmax + st.qb * cout;
  float* sq = reinterpret_cast<float*>(sel + st.qb * st.nsample);   // [qb][4]: x y z |q|^2

  const int tid = threadIdx.x;
  const int qblocks = (st.s + st.qb - 1) / st.qb;
  const int p = blockIdx.x / qblocks;
  const int q0 = (blockIdx.x % qblocks) * st.qb;
  const int nq = min(st.qb, st.s - q0);
  const int rows_total = nq * st.nsample;
  const int n = st.n;
  const float* pts = st.xyz + static_cast<size_t>(p) * n * 3;
  const float* ft = st.feat ? st.feat + static_cast<size_t>(p) * n * st.c : nullptr;

  load_queries(st.new_xyz + (static_cast<size_t>(p) * st.s + q0) * 3, nq, sq);
  for (int e = tid; e < nq * cout; e += kThreads) qmax[e] = 0;
  __syncthreads();
  select_slots(pts, sq, nq, n, st.nsample, !st.pppe, false, st.r2, dist, sel);

  for (int row0 = 0; row0 < rows_total; row0 += st.rows) {
    // gather the tile's rows into buf_a ("pppf": [feat | xyz]; "pppe":
    // [xyz - query | feat]), rounded to bf16 in the bf16 instance
    for (int e = tid; e < st.rows * cin; e += kThreads) {
      const int rl = e / cin, c = e % cin, r = row0 + rl;
      float v = 0.0f;
      if (r < rows_total) {
        const int j = sel[r];
        if (st.pppe) {
          v = c < 3 ? __ldg(pts + 3 * j + c) - sq[4 * (r / st.nsample) + c]
                    : __ldg(ft + static_cast<size_t>(j) * st.c + (c - 3));
        } else {
          v = c < st.c ? __ldg(ft + static_cast<size_t>(j) * st.c + c)
                       : __ldg(pts + 3 * j + (c - st.c));
        }
      }
      buf_a[rl * st.lda + c] = pcc_bf16::act_round<kBf16>(v);
    }
    __syncthreads();
    for (int l = 0; l < st.n_layers; ++l) {
      const float* src = (l & 1) ? buf_b : buf_a;
      float* dst = (l & 1) ? buf_a : buf_b;
      const int ld_src = (l & 1) ? st.ldb : st.lda;
      const int ld_dst = (l & 1) ? st.lda : st.ldb;
      const int w = st.width[l + 1];
      if (l == st.n_layers - 1) {
        dense_layer<kQueryMax, kBf16>(src, ld_src, st.rows, st.width[l], st.w[l], w, st.b[l],
                                      st.mu[l], st.mul[l], st.beta[l], w, dst, ld_dst, qmax,
                                      row0, rows_total, st.nsample, GlobalRows{});
      } else {
        dense_layer<kStore, kBf16>(src, ld_src, st.rows, st.width[l], st.w[l], w, st.b[l],
                                   st.mu[l], st.mul[l], st.beta[l], w, dst, ld_dst, qmax, row0,
                                   rows_total, st.nsample, GlobalRows{});
      }
      __syncthreads();
    }
  }
  float* o = st.out + (static_cast<size_t>(p) * st.s + q0) * cout;
  for (int e = tid; e < nq * cout; e += kThreads) o[e] = __int_as_float(qmax[e]);
}

// A row's kV activations from a chunk of the last layer: float32 rows (the
// k-order kernels) or bf16 rows (st16's).
template <int kV>
__device__ __forceinline__ void load_row(const float* row, float (&x)[kV]) {
  if constexpr (kV == 4) {
    const float4 v = *reinterpret_cast<const float4*>(row);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    x[0] = row[0];
  }
}
template <int kV>
__device__ __forceinline__ void load_row(const unsigned short* row, float (&x)[kV]) {
  if constexpr (kV == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(row);
    x[0] = pcc_cert::bf16_lo(v.x);
    x[1] = pcc_cert::bf16_hi(v.x);
    x[2] = pcc_cert::bf16_lo(v.y);
    x[3] = pcc_cert::bf16_hi(v.y);
  } else {
    x[0] = pcc_cert::bf16_val(row[0]);
  }
}

// Folds the rows [row0, row0 + valid) of the points, whose last-layer
// columns [c0, c0 + cc) are t[r - row0][0 .. cc) (row stride ldt), into the
// maxima out[q][c0 ..] (row stride ld_out) of the s queries, whose point sets
// are the bitmasks masks[q][0 .. nw). At the first tile the maxima start
// from 0. An item is kFoldQ queries x 4 columns (kVec, cc % 4 == 0) or 1: it
// walks the points any of its queries holds, so that each activation read
// from shared memory serves up to kFoldQ queries. No trailing barrier.
constexpr int kFoldQ = 8;
template <bool kVec, class Row>
__device__ __forceinline__ void fold_query_max(const Row* t, int ldt, int row0, int valid,
                                               int cc, int c0, const unsigned* masks,
                                               int nw, int s, float* out, int ld_out) {
  constexpr int kV = kVec ? 4 : 1;
  const int per_g = cc / kV;
  const int groups = (s + kFoldQ - 1) / kFoldQ;
  const int w0 = row0 >> 5, w1 = (row0 + valid + 31) >> 5;
  for (int e = threadIdx.x; e < groups * per_g; e += kThreads) {
    const int q0 = (e / per_g) * kFoldQ, o = (e % per_g) * kV;
    float acc[kFoldQ][kV];
#pragma unroll
    for (int g = 0; g < kFoldQ; ++g)
#pragma unroll
      for (int v = 0; v < kV; ++v) acc[g][v] = 0.0f;
    unsigned any = 0u;   // bit g: query q0 + g holds a point of the tile
    for (int wi = w0; wi < w1; ++wi) {
      // the bits of word wi that fall in the tile
      const int lo = max(row0 - 32 * wi, 0), hi = min(row0 + valid - 32 * wi, 32);
      const unsigned range = (0xffffffffu >> (32 - hi)) & (0xffffffffu << lo);
      unsigned m[kFoldQ], u = 0u;
#pragma unroll
      for (int g = 0; g < kFoldQ; ++g) {
        m[g] = q0 + g < s ? masks[(q0 + g) * nw + wi] & range : 0u;
        u |= m[g];
        any |= m[g] != 0u ? 1u << g : 0u;
      }
      while (u) {
        const int b = __ffs(u) - 1;
        u &= u - 1u;
        float x[kV];
        load_row<kV>(t + (32 * wi + b - row0) * ldt + o, x);
#pragma unroll
        for (int g = 0; g < kFoldQ; ++g)
          if ((m[g] >> b) & 1u)
#pragma unroll
            for (int v = 0; v < kV; ++v) acc[g][v] = fmaxf(acc[g][v], x[v]);
      }
    }
#pragma unroll
    for (int g = 0; g < kFoldQ; ++g) {
      if (q0 + g >= s || (row0 > 0 && !((any >> g) & 1u))) continue;
      float* dst = out + static_cast<size_t>(q0 + g) * ld_out + c0 + o;
#pragma unroll
      for (int v = 0; v < kV; ++v) dst[v] = row0 == 0 ? acc[g][v] : fmaxf(acc[g][v], dst[v]);
    }
  }
}

// Layout "pppf", one block per patch: the queries' point sets, then the stack
// on the patch's points tile by tile, the last layer folded into the maxima.
// kSave (the store mode the train step's forward asks for): the same
// arithmetic, and also the ranked slots, every layer's input x_l and t_l and
// the last activations stored for the backward kernel (pppf_sa_stage_bwd.cu),
// which then neither selects nor replays the stack. kBf16: the point rows
// and every layer's output rounded to bf16; with kSave too (the bf16 store
// mode), the stored inputs x_l are the rounded ones, which the bf16
// backward's weight gradients read, and t_l is the float32 (z + b) - mean.
template <bool kSave, bool kBf16>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
pppf_sa_points_kernel(const __grid_constant__ Stage st) {
  extern __shared__ __align__(16) float smem[];
  const int L = st.n_layers, cout = st.width[L], cin = st.width[0];
  const int n = st.n, s = st.s, ns = st.nsample, nw = (n + 31) >> 5;
  const int tid = threadIdx.x;
  const int p = blockIdx.x;
  const float* pts = st.xyz + static_cast<size_t>(p) * n * 3;
  const float* ft = st.feat ? st.feat + static_cast<size_t>(p) * n * st.c : nullptr;
  unsigned* masks = reinterpret_cast<unsigned*>(smem + st.region);   // [s][nw]
  int* queues = reinterpret_cast<int*>(masks + s * nw);   // kWarps * kQueue, then kWarps counts

  // 1. each query's set: the points its slots read after the ball mask
  // (masked slots and slots beyond N read point 0), as bits of its mask.
  // The selection scratch aliases the activation buffers.
  float* sq = smem;                                         // [qb][4]
  float* dist = sq + 4 * st.qb;                             // where ns < n or kSave
  int* sel = reinterpret_cast<int*>(dist + (ns < n || kSave ? st.qb * select_words(n, ns) : 0));
  for (int e = tid; e < s * nw; e += kThreads) masks[e] = 0u;
  for (int q0 = 0; q0 < s; q0 += st.qb) {
    const int nq = min(st.qb, s - q0);
    load_queries(st.new_xyz + (static_cast<size_t>(p) * s + q0) * 3, nq, sq);
    __syncthreads();
    // with kSave, ranked also where every point is taken (the same set; the
    // backward's first winner depends on the order)
    select_slots(pts, sq, nq, n, ns, true, kSave, st.r2, dist, sel);
    for (int e = tid; e < nq * ns; e += kThreads) {
      const int j = sel[e];
      atomicOr(masks + (q0 + e / ns) * nw + (j >> 5), 1u << (j & 31));
      if (kSave) st.gsel[(static_cast<size_t>(p) * s + q0) * ns + e] = j;
    }
  }
  __syncthreads();

  // 2. the stack on the points, tile by tile
  float* buf_a = smem;
  float* buf_b = buf_a + st.rows * st.lda;
  float* o = st.out + static_cast<size_t>(p) * s * cout;
  for (int row0 = 0; row0 < n; row0 += st.rows) {
    const int valid = min(st.rows, n - row0);
    // this tile's rows of the saved layers (kSave)
    const size_t grow = static_cast<size_t>(p) * n + row0;
    auto saved = [&](int l, int c0) {
      return GlobalRows{st.gact + st.lay.act_off[l + 1] + grow * st.lay.ld[l + 1] + c0,
                        st.gt + st.lay.t_off[l] + grow * st.lay.ld[l + 1] + c0,
                        st.lay.ld[l + 1], valid};
    };
    for (int e = tid; e < st.rows * cin; e += kThreads) {
      const int rl = e / cin, c = e % cin, j = row0 + rl;
      float v = 0.0f;
      if (rl < valid) {
        v = c < st.c ? __ldg(ft + static_cast<size_t>(j) * st.c + c)
                     : __ldg(pts + 3 * j + (c - st.c));
        v = pcc_bf16::act_round<kBf16>(v);
        if (kSave) st.gact[st.lay.act_off[0] + (grow + rl) * st.lay.ld[0] + c] = v;
      }
      buf_a[rl * st.lda + c] = v;
    }
    __syncthreads();
    for (int l = 0; l < L - 1; ++l) {
      const int w = st.width[l + 1];
      dense_layer<kSave ? kStoreGlobal : kStore, kBf16>(
          (l & 1) ? buf_b : buf_a, (l & 1) ? st.ldb : st.lda, st.rows, st.width[l], st.w[l], w,
          st.b[l], st.mu[l], st.mul[l], st.beta[l], w, (l & 1) ? buf_a : buf_b,
          (l & 1) ? st.lda : st.ldb, nullptr, 0, 0, 1, kSave ? saved(l, 0) : GlobalRows{});
      __syncthreads();
    }
    // the last layer, a column chunk at a time into the buffer it does not read
    const int l = L - 1;
    const float* src = (l & 1) ? buf_b : buf_a;
    float* t = (l & 1) ? buf_a : buf_b;
    const int ld_src = (l & 1) ? st.ldb : st.lda, ldt = (l & 1) ? st.lda : st.ldb;
    for (int c0 = 0; c0 < cout; c0 += st.cc) {
      const int cc = min(st.cc, cout - c0);
      dense_layer<kSave ? kStoreGlobal : kStore, kBf16>(
          src, ld_src, st.rows, st.width[l], st.w[l] + c0, cout, st.b[l] + c0, st.mu[l] + c0,
          st.mul[l] + c0, st.beta[l] + c0, cc, t, ldt, nullptr, 0, 0, 1,
          kSave ? saved(l, c0) : GlobalRows{});
      __syncthreads();
      if (cout % 4 == 0) {
        fold_query_max<true>(t, ldt, row0, valid, cc, c0, masks, nw, s, o, cout);
      } else {
        fold_query_max<false>(t, ldt, row0, valid, cc, c0, masks, nw, s, o, cout);
      }
      __syncthreads();
    }
  }
}

// The per-point tile: the largest of up to kMaxPointRows rows (capped at the
// patch's points rounded up to kTM) whose activation buffers, selection
// scratch and masks fit in `budget` bytes. Sets st.rows, lda, ldb, region,
// cc and qb; returns the bytes, or 0 if no tile fits.
size_t point_tile(Stage& st, int lda0, int ldb0, size_t budget, bool save) {
  const int L = st.n_layers, cout = st.width[L];
  const int nw = (st.n + 31) / 32;
  const size_t per_query =
      4 + st.nsample + (st.nsample < st.n || save ? select_words(st.n, st.nsample) : 0);
  const int cap = (st.n + kTM - 1) / kTM * kTM;
  for (int rows = kMaxPointRows; rows >= kTM;
       rows -= rows > kTM * kWarps ? kTM * kWarps : kTM) {
    if (rows > cap && rows - kTM >= cap) continue;
    // the last layer's column chunk: as many 128-column chunks as leave no
    // warp without a row group
    const int groups = rows / kTM;
    int cc = 128 * (groups >= kWarps ? 1 : kWarps / groups);
    if (cout % 4 != 0 || cc > cout) cc = cout;
    int lda = lda0, ldb = ldb0;
    int& ldt = ((L - 1) & 1) ? lda : ldb;
    if (round4(cc) > ldt) ldt = round4(cc);
    size_t region = static_cast<size_t>(rows) * (lda + ldb);
    if (region < per_query) region = per_query;
    const size_t bytes = (region + static_cast<size_t>(st.s) * nw) * sizeof(float);
    if (bytes <= budget) {
      st.rows = rows;
      st.lda = lda;
      st.ldb = ldb;
      st.region = static_cast<int>(region);
      st.cc = cc;
      const size_t qb = region / per_query;
      st.qb = qb < static_cast<size_t>(st.s) ? static_cast<int>(qb) : st.s;
      return bytes;
    }
  }
  return 0;
}

// Layout "pppe": the feature block. y[r][o] = sum_k f[r][k] * w[k][o] for
// the rows r < rows of the points' features f [rows][c] and the first
// layer's feature rows w = W1[3 .. c + 3) [c][c1] (kBf16: f rounded, w bf16
// values, one TF32 product): a 3xTF32 product, a block
// per kFeatRows x kFeatCols tile of y, k-slabs of f and w double-buffered
// through shared memory by cp.async (zeros past the edges).
constexpr int kFeatRows = 128, kFeatCols = 128, kFeatK = 32;
constexpr int kFeatLdA = kFeatK + 4;   // pcc_tile::a_ld(kFeatK)
constexpr size_t kFeatSmemBytes =
    (2 * kFeatRows * kFeatLdA + 2 * kFeatK * (kFeatCols + 8)) * sizeof(float);

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
pppe_feature_kernel(const float* __restrict__ f, int rows, int c, const float* __restrict__ w,
                    int c1, float* __restrict__ y) {
  using namespace pcc_tile;
  extern __shared__ __align__(16) float smem[];
  constexpr int ldb = kFeatCols + 8;   // b_ld(kFeatCols)
  float* as = smem;                                 // [2][kFeatRows][kFeatLdA]
  float* bs = as + 2 * kFeatRows * kFeatLdA;        // [2][kFeatK][ldb]
  const int r0 = blockIdx.x * kFeatRows, n0 = blockIdx.y * kFeatCols;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;          // 4 x 2 warps of 32 rows x 64 columns
  const bool va = aligned16(f, c), vb = aligned16(w, c1);
  const int vr = min(kFeatRows, rows - r0), vc = min(kFeatCols, c1 - n0);
  auto load = [&](int stage, int k0) {
    load_tile_async<kThreads>(as + stage * kFeatRows * kFeatLdA, kFeatLdA,
                              f + static_cast<size_t>(r0) * c + k0, c, kFeatRows, kFeatK, vr,
                              c - k0, va);
    load_tile_async<kThreads>(bs + stage * kFeatK * ldb, ldb,
                              w + static_cast<size_t>(k0) * c1 + n0, c1, kFeatK, kFeatCols,
                              c - k0, vc, vb);
  };
  float acc[2][8][4];
  zero(acc);
  const int nk = (c + kFeatK - 1) / kFeatK;
  load(0, 0);
  pcc_mma::cp_async_commit();
  for (int s = 0; s < nk; ++s) {
    if (s + 1 < nk) load((s + 1) & 1, (s + 1) * kFeatK);
    pcc_mma::cp_async_commit();
    pcc_mma::cp_async_wait<1>();
    __syncthreads();
    warp_mma<8, kBf16>(acc, as + (s & 1) * kFeatRows * kFeatLdA + wm * 32 * kFeatLdA,
                       kFeatLdA, bs + (s & 1) * kFeatK * ldb + wn * 64, ldb,
                       min(kFeatK, pad8(c) - s * kFeatK) / 8);
    __syncthreads();
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + wm * 32 + mt * 16 + g + 8 * h;
        const int o = n0 + wn * 64 + nt * 8 + 2 * t;
        if (r < rows) {
          float* dst = y + static_cast<size_t>(r) * c1 + o;
          if (o < c1) dst[0] = acc[mt][nt][2 * h];
          if (o + 1 < c1) dst[1] = acc[mt][nt][2 * h + 1];
        }
      }
}

// Layout "pppe": the slots. A block owns qb queries of one patch: it selects
// their slots (select_slots, no mask), then takes their rows kM = 32 * WM at
// a time. Layer 1 per slot: y[j] (the feature block; 0 where c = 0) plus
// (x_j - c_q) W1[0 .. 3), three fused multiply-adds a channel, then the
// BatchNorm affine and relu, into the tile's activations in shared memory
// (a single layer folds it straight into the maxima). Layers 2 .. L on the
// tensor cores (pcc_tile::warp_mma): 8 warps of 32 rows x 8 * NT columns
// (WM x 8 / WM of them), in passes of kCW columns whose weights stream in
// k-slabs of st.ks rows through shared memory (cp.async, double-buffered,
// zeros past the edges). A layer before the last has at most kCW columns:
// its one pass keeps the whole output in the accumulators and, after a
// barrier, overwrites its own input with the activations. The last layer's
// passes fold into the queries' maxima (integer atomicMax on the float's
// bits in shared memory, from 0: exact, every value being a relu output):
// where a warp's 32 rows are one query's, first the max over its rows by
// shuffles. Each query's maxima are written once, at the end. kBf16: the
// centred coordinates and every layer's relu output rounded to bf16 (the
// last layer's maxima when they are written), the products on bf16 values.
// The BatchNorm terms of the columns o and o + 1 (zeros from co on), and
// a value of column o + i through them and relu.
struct ColTerms {
  float b[2], mu[2], mul[2], beta[2];
};
__device__ __forceinline__ ColTerms col_terms(const float* __restrict__ b,
                                              const float* __restrict__ mu,
                                              const float* __restrict__ mul,
                                              const float* __restrict__ beta, int o, int co) {
  ColTerms c;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool ok = o + i < co;
    c.b[i] = ok ? __ldg(b + o + i) : 0.0f;
    c.mu[i] = ok ? __ldg(mu + o + i) : 0.0f;
    c.mul[i] = ok ? __ldg(mul + o + i) : 0.0f;
    c.beta[i] = ok ? __ldg(beta + o + i) : 0.0f;
  }
  return c;
}
__device__ __forceinline__ float bn_relu(float acc, const ColTerms& c, int i) {
  return fmaxf(fmaf(bn_shift(acc, c.b[i], c.mu[i]), c.mul[i], c.beta[i]), 0.0f);
}

constexpr int kL1Cols = 4;   // layer 1 in place: columns a lane holds the terms of at a time

template <int WM, int NT, bool kBf16>
__global__ void __launch_bounds__(kThreads, NT == 8 ? 2 : 1)
pppe_slots_kernel(const __grid_constant__ Stage st) {
  using pcc_bf16::act_round;
  using namespace pcc_tile;
  constexpr int kWN = kWarps / WM, kM = 32 * WM, kCW = 8 * NT * kWN;
  extern __shared__ __align__(16) float smem[];
  const int L = st.n_layers, c1 = st.width[1], cout = st.width[L], ns = st.nsample;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int wm = warp / kWN, wn = warp % kWN;
  const int ldx = st.lda, ldw = b_ld(kCW), ks = st.ks;
  float* xs = smem;                                      // [kM][ldx]; selection scratch first
  float* slab = xs + kM * ldx;                           // [2][ks][ldw]
  float4* rowc = reinterpret_cast<float4*>(smem + st.region);  // [kM]: point, x - c
  int* sel = reinterpret_cast<int*>(rowc + kM);          // [qb][ns]
  float* sq = reinterpret_cast<float*>(sel + st.qb * ns);      // [qb][4]
  int* qmax = reinterpret_cast<int*>(sq + 4 * st.qb);          // [qb][cout]

  const int qblocks = (st.s + st.qb - 1) / st.qb;
  const int p = blockIdx.x / qblocks, q0 = (blockIdx.x % qblocks) * st.qb;
  const int nq = min(st.qb, st.s - q0), rows_total = nq * ns;
  const float* pts = st.xyz + static_cast<size_t>(p) * st.n * 3;
  const float* yp = st.y ? st.y + static_cast<size_t>(p) * st.n * c1 : nullptr;
  const float* w1 = st.w[0];

  load_queries(st.new_xyz + (static_cast<size_t>(p) * st.s + q0) * 3, nq, sq);
  for (int e = tid; e < nq * cout; e += kThreads) qmax[e] = 0;
  __syncthreads();
  select_slots(pts, sq, nq, st.n, ns, false, false, 0.0f, xs, sel);

  // layer 1 of tile row r (point j, centred coordinates d), channel o
  auto first = [&](float4 d, int o) {
    float acc = yp ? yp[static_cast<size_t>(__float_as_int(d.x)) * c1 + o] : 0.0f;
    acc = fmaf(d.y, __ldg(w1 + o), acc);
    acc = fmaf(d.z, __ldg(w1 + c1 + o), acc);
    acc = fmaf(d.w, __ldg(w1 + 2 * c1 + o), acc);
    const float t = bn_shift(acc, __ldg(st.b[0] + o), __ldg(st.mu[0] + o));
    return fmaxf(fmaf(t, __ldg(st.mul[0] + o), __ldg(st.beta[0] + o)), 0.0f);
  };

  for (int row0 = 0; row0 < rows_total; row0 += kM) {
    const int valid = min(kM, rows_total - row0);
    for (int r = tid; r < kM; r += kThreads) {
      float4 d = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r < valid) {
        const int j = sel[row0 + r], qi = (row0 + r) / ns;
        d = make_float4(__int_as_float(j), act_round<kBf16>(__ldg(pts + 3 * j) - sq[4 * qi]),
                        act_round<kBf16>(__ldg(pts + 3 * j + 1) - sq[4 * qi + 1]),
                        act_round<kBf16>(__ldg(pts + 3 * j + 2) - sq[4 * qi + 2]));
      }
      rowc[r] = d;
    }
    __syncthreads();
    if (L == 1) {
      for (int r = warp; r < valid; r += kWarps) {
        const float4 d = rowc[r];
        int* qm = qmax + ((row0 + r) / ns) * cout;
        for (int o = lane; o < c1; o += 32) atomicMax(qm + o, __float_as_int(first(d, o)));
      }
      __syncthreads();
      continue;
    }
    // the tile's rows of the feature block, gathered into xs by cp.async
    // (zeros past c1 and past the valid rows), then layer 1 in place: a
    // lane holds its columns' weights and BatchNorm terms for every row
    const int c1p = pad8(c1);
    if (yp) {
      const bool vec = aligned16(yp, c1);
      const int per_row = vec ? c1p / 4 : c1p;
      for (int e = tid; e < kM * per_row; e += kThreads) {
        const int r = e / per_row, o = (e % per_row) * (vec ? 4 : 1);
        const bool ok = r < valid && o < c1;
        const float* src = ok ? yp + static_cast<size_t>(__float_as_int(rowc[r].x)) * c1 + o : yp;
        if (vec) {
          pcc_mma::cp_async16(xs + r * ldx + o, src, ok ? 16 : 0);
        } else {
          cp_async4(xs + r * ldx + o, src, ok ? 4 : 0);
        }
      }
      pcc_mma::cp_async_commit();
      pcc_mma::cp_async_wait<0>();
      __syncthreads();
    }
    for (int o0 = 0; o0 < c1p; o0 += 32 * kL1Cols) {
      float cw[kL1Cols][7];
#pragma unroll
      for (int k = 0; k < kL1Cols; ++k) {
        const int o = o0 + 32 * k + lane;
        const bool ok = o < c1;
        cw[k][0] = ok ? __ldg(w1 + o) : 0.0f;
        cw[k][1] = ok ? __ldg(w1 + c1 + o) : 0.0f;
        cw[k][2] = ok ? __ldg(w1 + 2 * c1 + o) : 0.0f;
        cw[k][3] = ok ? __ldg(st.b[0] + o) : 0.0f;
        cw[k][4] = ok ? __ldg(st.mu[0] + o) : 0.0f;
        cw[k][5] = ok ? __ldg(st.mul[0] + o) : 0.0f;
        cw[k][6] = ok ? __ldg(st.beta[0] + o) : 0.0f;
      }
      for (int r = warp; r < kM; r += kWarps) {
        const float4 d = rowc[r];
#pragma unroll
        for (int k = 0; k < kL1Cols; ++k) {
          const int o = o0 + 32 * k + lane;
          if (o >= c1p) continue;
          float v = 0.0f;
          if (r < valid && o < c1) {
            float acc = yp ? xs[r * ldx + o] : 0.0f;
            acc = fmaf(d.y, cw[k][0], acc);
            acc = fmaf(d.z, cw[k][1], acc);
            acc = fmaf(d.w, cw[k][2], acc);
            v = act_round<kBf16>(
                fmaxf(fmaf(bn_shift(acc, cw[k][3], cw[k][4]), cw[k][5], cw[k][6]), 0.0f));
          }
          xs[r * ldx + o] = v;
        }
      }
    }
    __syncthreads();

    for (int l = 1; l < L; ++l) {
      const int K = st.width[l], co = st.width[l + 1];
      const float* w = st.w[l];
      const bool vec = aligned16(w, co);
      const int nk = (K + ks - 1) / ks;
      for (int n0 = 0; n0 < co; n0 += kCW) {
        float acc[2][NT][4];
        zero(acc);
        load_tile_async<kThreads>(slab, ldw, w + n0, co, ks, kCW, K, co - n0, vec);
        pcc_mma::cp_async_commit();
        for (int s = 0; s < nk; ++s) {
          if (s + 1 < nk)
            load_tile_async<kThreads>(slab + ((s + 1) & 1) * ks * ldw, ldw,
                                      w + static_cast<size_t>(s + 1) * ks * co + n0, co, ks,
                                      kCW, K - (s + 1) * ks, co - n0, vec);
          pcc_mma::cp_async_commit();
          pcc_mma::cp_async_wait<1>();
          __syncthreads();
          warp_mma<NT, kBf16>(acc, xs + wm * 32 * ldx + s * ks, ldx,
                              slab + (s & 1) * ks * ldw + wn * 8 * NT, ldw,
                              min(ks, pad8(K) - s * ks) / 8);
          __syncthreads();
        }
        const float *b = st.b[l], *mu = st.mu[l], *mul = st.mul[l], *beta = st.beta[l];
        if (l < L - 1) {
          // co <= kCW: the whole layer is in the accumulators, and every
          // warp has read its input (the barrier above)
          const int cop = pad8(co);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int o = wn * 8 * NT + nt * 8 + 2 * t;
            if (o >= cop) continue;
            const ColTerms ct = col_terms(b, mu, mul, beta, o, co);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int r = wm * 32 + mt * 16 + g + 8 * h;
                float2 v;
                v.x = o < co ? act_round<kBf16>(bn_relu(acc[mt][nt][2 * h], ct, 0)) : 0.0f;
                v.y = o + 1 < co ? act_round<kBf16>(bn_relu(acc[mt][nt][2 * h + 1], ct, 1))
                                 : 0.0f;
                *reinterpret_cast<float2*>(xs + r * ldx + o) = v;
              }
          }
          continue;
        }
        // the last layer: relu, then the max over each query's rows; where
        // the warp's 32 rows are one query's, by shuffles first
        const int rbase = row0 + wm * 32;
        if (rbase + 31 < rows_total && rbase / ns == (rbase + 31) / ns) {
          int* qm = qmax + (rbase / ns) * cout;
#pragma unroll
          for (int h8 = 0; h8 < NT / 8; ++h8) {
            float m[8][2];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int nt = 8 * h8 + i, o = n0 + wn * 8 * NT + nt * 8 + 2 * t;
              const ColTerms ct = col_terms(b, mu, mul, beta, o, co);
#pragma unroll
              for (int k = 0; k < 2; ++k)
                m[i][k] = o + k < co ? fmaxf(fmaxf(bn_relu(acc[0][nt][k], ct, k),
                                                   bn_relu(acc[0][nt][2 + k], ct, k)),
                                             fmaxf(bn_relu(acc[1][nt][k], ct, k),
                                                   bn_relu(acc[1][nt][2 + k], ct, k)))
                                     : 0.0f;
            }
            const float2 r = max_over_rows_scattered(m);
            const int o = n0 + wn * 8 * NT + (8 * h8 + g) * 8 + 2 * t;
            if (o < co) atomicMax(qm + o, __float_as_int(r.x));
            if (o + 1 < co) atomicMax(qm + o + 1, __float_as_int(r.y));
          }
        } else {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int o = n0 + wn * 8 * NT + nt * 8 + 2 * t;
            const ColTerms ct = col_terms(b, mu, mul, beta, o, co);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int r = rbase + mt * 16 + g + 8 * (i >> 1), c = o + (i & 1);
                if (r < rows_total && c < co)
                  atomicMax(qmax + (r / ns) * cout + c,
                            __float_as_int(bn_relu(acc[mt][nt][i], ct, i & 1)));
              }
          }
        }
      }
      __syncthreads();
    }
  }
  __syncthreads();
  float* o = st.out + (static_cast<size_t>(p) * st.s + q0) * cout;
  for (int e = tid; e < nq * cout; e += kThreads) o[e] = act_round<kBf16>(__int_as_float(qmax[e]));
}

// Shared memory (floats) of pppe_slots_kernel at kM rows, kCW columns a
// pass, k-slabs of ks rows and qb queries; sets st.region.
size_t pppe_words(Stage& st, int kM, int kCW, int ks, int qb) {
  const int L = st.n_layers, ns = st.nsample;
  const size_t dist = ns < st.n ? static_cast<size_t>(qb) * select_words(st.n, ns) : 0;
  const size_t tiles = L > 1 ? static_cast<size_t>(kM) * st.lda +
                                   2 * static_cast<size_t>(ks) * pcc_tile::b_ld(kCW)
                             : 0;
  const size_t region = ((dist > tiles ? dist : tiles) + 3) & ~static_cast<size_t>(3);
  st.region = static_cast<int>(region);
  return region + 4 * static_cast<size_t>(kM) + static_cast<size_t>(qb) * ns + 4 * qb +
         static_cast<size_t>(qb) * st.width[L];
}

// The "pppe" layout: the feature block (where c > 0) into y [p, n, c1],
// then the slots. Tiles: the first of (WM, NT) = (4, 8), (4, 16), (2, 16),
// (1, 16) whose pass is as wide as every layer between the first and the
// last (so that it can run in place), with the largest k-slab (32, 16, 8
// rows) and then the most queries (up to kM / nsample) that fit: two blocks
// an SM for (4, 8) where they fit, else one. Where none fits (a middle layer
// wider than 1024, or 32 rows of the widest layer but the last beyond shared
// memory) it returns kNoTile and the caller runs the per-slot kernel
// (pppf_sa_stage_kernel's "pppe" branch); ops/pppf_sa_cuda.py::pppe_plan
// mirrors this search, so that the wrapper hands y over only where a tile
// fits.
constexpr int kNoTile = -1;

template <bool kBf16>
int launch_pppe(Stage& st, int p, float* y, cudaStream_t strm) {
  const int L = st.n_layers, c1 = st.width[1];
  // the widest output of a layer between the first and the last, and of any but the last
  int mid = 0, widest = 0;
  for (int l = 1; l < L; ++l) {
    if (l > 1 && st.width[l] > mid) mid = st.width[l];
    if (st.width[l] > widest) widest = st.width[l];
  }
  const int lda0 = st.lda;
  st.lda = L > 1 ? pcc_tile::a_ld(widest) : 0;
  const int plans[4][2] = {{4, 8}, {4, 16}, {2, 16}, {1, 16}};
  const size_t two = (kSmemLimit + 1024) / 2 - 1024;
  int plan = -1;
  size_t bytes = 0;
  for (int i = 0; i < 4 && plan < 0; ++i) {
    const int wm = plans[i][0], nt = plans[i][1], kM = 32 * wm, kCW = 8 * nt * (kWarps / wm);
    if (mid > kCW) continue;
    for (int b = nt == 8 ? 0 : 1; b < 2 && plan < 0; ++b) {
      const size_t budget = b == 0 ? two : kSmemLimit;
      for (int ks = 32; ks >= 8 && plan < 0; ks /= 2) {
        int qb = st.nsample <= kM ? kM / st.nsample : 1;
        if (qb > st.s) qb = st.s;
        while (qb > 1 && pppe_words(st, kM, kCW, ks, qb) * sizeof(float) > budget) --qb;
        bytes = pppe_words(st, kM, kCW, ks, qb) * sizeof(float);
        if (bytes <= budget) {
          plan = i;
          st.ks = ks;
          st.qb = qb;
        }
      }
    }
  }
  if (plan < 0) {
    st.lda = lda0;
    st.region = 0;
    return kNoTile;
  }
  if ((st.c > 0) != (y != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  st.y = y;
  const long long blocks = static_cast<long long>(p) * ((st.s + st.qb - 1) / st.qb);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (st.c > 0) {
    err = cudaFuncSetAttribute(pppe_feature_kernel<kBf16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kFeatSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((p * st.n + kFeatRows - 1) / kFeatRows, (c1 + kFeatCols - 1) / kFeatCols);
    pppe_feature_kernel<kBf16><<<grid, kThreads, kFeatSmemBytes, strm>>>(
        st.feat, p * st.n, st.c, st.w[0] + 3 * c1, c1, y);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int wm = plans[plan][0], nt = plans[plan][1];
  void (*kernel)(Stage) = wm == 4   ? (nt == 8 ? pppe_slots_kernel<4, 8, kBf16>
                                               : pppe_slots_kernel<4, 16, kBf16>)
                          : wm == 2 ? pppe_slots_kernel<2, 16, kBf16>
                                    : pppe_slots_kernel<1, 16, kBf16>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kThreads, bytes, strm>>>(st);
  return static_cast<int>(cudaGetLastError());
}

// Per point where the queries' masks fit beside a tile ("pppf"), else per
// slot; "pppe" per slot where launch_pppe finds no tile. kBf16: the bf16
// instances ("pppf" in serving and store mode, "pppe").
template <bool kBf16>
int launch_stage(Stage& st, int p, bool save, int* saved, float* y, cudaStream_t strm) {
  const int s = st.s, n = st.n, nsample = st.nsample, cout = st.width[st.n_layers];
  // budgets: kMinBlocks blocks per SM (a block is charged 1 KB more than it
  // asks for), failing that one
  const size_t budgets[2] = {(kSmemLimit + 1024) / kMinBlocks - 1024, kSmemLimit};
  const int lda0 = st.lda, ldb0 = st.ldb;
  size_t bytes = 0;
  if (st.pppe) {
    const int r = launch_pppe<kBf16>(st, p, y, strm);
    if (r != kNoTile) return r;
  } else if (save || !kBf16) {
    // (bf16 serving takes st16's per-point kernel, and this one per slot
    // where that finds no tile)
    for (int i = 0; i < 2 && bytes == 0; ++i)
      bytes = point_tile(st, lda0, ldb0, budgets[i], save);
    if (bytes > 0) {
      auto kernel = pppf_sa_points_kernel<true, kBf16>;
      if constexpr (!kBf16)
        if (!save) kernel = pppf_sa_points_kernel<false, false>;
      cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(bytes));
      if (err != cudaSuccess) return static_cast<int>(err);
      kernel<<<static_cast<unsigned>(p), kThreads, bytes, strm>>>(st);
      err = cudaGetLastError();
      if (err == cudaSuccess && save) *saved = 1;
      return static_cast<int>(err);
    }
  }
  st.lda = lda0;
  st.ldb = ldb0;
  // per slot: the largest tile of up to kMaxRows rows of which kMinBlocks
  // fit in an SM's shared memory; failing that, the largest of which one does
  st.rows = 0;
  for (int i = 0; i < 2 && st.rows < kTM; ++i) {
    for (st.rows = kMaxRows; st.rows >= kTM; st.rows -= kTM) {
      st.qb = st.rows >= nsample ? st.rows / nsample : 1;
      if (st.qb > s) st.qb = s;
      bytes = smem_words(st.rows, st.qb, st.lda, st.ldb, cout, n, nsample) * sizeof(float);
      if (bytes <= budgets[i]) break;
    }
  }
  if (st.rows < kTM) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(p) * ((s + st.qb - 1) / st.qb);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(pppf_sa_stage_kernel<kBf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  pppf_sa_stage_kernel<kBf16><<<static_cast<unsigned>(blocks), kThreads, bytes, strm>>>(st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The bf16 "pppf" instance in serving (pppf_sa_stage_bf16_launch), per
// point: the products of every layer at least 16 deep on the bf16 tensor
// cores, its outputs bit for bit those of the k-order CUDA-core arithmetic
// (certified.cuh). See the file's note.
namespace st16 {

using namespace pcc_sa;
using namespace pcc_cert;

__host__ __device__ inline int pad16(int v) { return (v + 15) & ~15; }
// a layer input's bf16 row stride: the width padded to 16, + 8
__host__ __device__ inline int ld_of(int width) { return pad16(width) + 8; }

struct St16 {
  const float* new_xyz;   // [P, S, 3]
  const float* xyz;       // [P, N, 3]
  const float* feat;      // [P, N, C] or nullptr
  float* out;             // [P, S, width[n_layers]]
  int s, n, c, nsample, n_layers;
  float r2;
  int rows;               // rows per tile: 16, 32 or a multiple of 64
  int qb;                 // queries per selection group
  int lda, ldb;           // bf16 row strides of the two activation buffers
  int region;             // bytes of the activation buffers and selection scratch
  int cc;                 // columns per chunk of the last layer
  int width[kMaxLayers + 1];
  const float* w[kMaxLayers];
  const uint2* frag[kMaxLayers];   // packed W (layers at least 16 deep), else null
  const float* b[kMaxLayers];
  const float* mu[kMaxLayers];
  const float* mul[kMaxLayers];
  const float* beta[kMaxLayers];
};

// round_bf16(relu(fma((s + b) - mean, mul, beta))): pppf_sa_common.cuh's
// epilogue of a layer on a k-order sum
struct BnRelu {
  const float *b, *mu, *mul, *beta;
  __device__ __forceinline__ float operator()(float s, int c) const {
    const float t = bn_shift(s, __ldg(b + c), __ldg(mu + c));
    return pcc_bf16::round_bf16(fmaxf(fmaf(t, __ldg(mul + c), __ldg(beta + c)), 0.0f));
  }
};

// A layer less than 16 deep, on the CUDA cores: out[r][c - c0] for the
// columns [c0, c0 + cols) below cout, acc = fma(x[k], w[k][c], acc) from
// k = 0; a lane per column (its weights in registers), the warps taking
// the rows. No trailing barrier.
__device__ __forceinline__ void small_layer(const unsigned short* in, int ldi, int rows, int cin,
                                            const float* __restrict__ w, int cout, int c0,
                                            int cols, const BnRelu& f, unsigned short* out,
                                            int ldo) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  for (int c = c0 + lane; c < c0 + cols && c < cout; c += 32) {
    float wk[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) wk[k] = k < cin ? __ldg(w + k * cout + c) : 0.0f;
    for (int r = warp; r < rows; r += warps) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < 16; ++k)
        if (k < cin) acc = fmaf(bf16_val(in[r * ldi + k]), wk[k], acc);
      out[r * ldo + (c - c0)] = bf16_bits(f(acc, c));
    }
  }
}

// Layer l on a tile: the columns [c0, c0 + cols) of its output into out
// (row stride ldo), the pad columns up to `zero_to` zeroed. A layer at
// least 16 deep runs certified on the tensor cores (MT m16 tiles x 8 / MT
// n8 tiles a warp item; its packed weights have columns to a multiple of
// 64). Ends with __syncthreads().
template <int MT>
__device__ __forceinline__ void stage_layer(const St16& st, int l, const unsigned short* in,
                                            int ldi, int c0, int cols, unsigned short* out,
                                            int ldo, int zero_to, int* queues) {
  constexpr int kNT = 8 / MT;
  const int cin = st.width[l], cout = st.width[l + 1], rows = st.rows;
  const BnRelu f{st.b[l], st.mu[l], st.mul[l], st.beta[l]};
  if (st.frag[l] == nullptr) {
    small_layer(in, ldi, rows, cin, st.w[l], cout, c0, cols, f, out, ldo);
  } else {
    const int span = 8 * kNT;
    cert_layer<MT, kNT, false>(in, ldi, rows, st.frag[l], pad16(cin) / 16, cin, c0,
                               (cols + span - 1) / span * span, cout, f, out, ldo, l, queues,
                               queues + kWarps * kQueue);
  }
  const int first = cout - c0 > 0 ? cout - c0 : 0, pad = zero_to - first;
  for (int e = threadIdx.x; e < rows * pad; e += blockDim.x)
    out[(e / pad) * ldo + first + e % pad] = 0;
  __syncthreads();
}

template <int MT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
points_kernel(const __grid_constant__ St16 st) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = st.n_layers, cout = st.width[L], cin = st.width[0];
  const int n = st.n, s = st.s, ns = st.nsample, nw = (n + 31) >> 5;
  const int tid = threadIdx.x;
  const int p = blockIdx.x;
  const float* pts = st.xyz + static_cast<size_t>(p) * n * 3;
  const float* ft = st.feat ? st.feat + static_cast<size_t>(p) * n * st.c : nullptr;
  unsigned* masks = reinterpret_cast<unsigned*>(smem + st.region);   // [s][nw]
  int* queues = reinterpret_cast<int*>(masks + s * nw);   // kWarps * kQueue, then kWarps counts

  // 1. each query's set of points, as bits of its mask (the float32
  // kernel's selection, pppf_sa_points_kernel), the scratch aliasing the
  // activation buffers
  float* sq = reinterpret_cast<float*>(smem);                // [qb][4]
  float* dist = sq + 4 * st.qb;                              // where ns < n
  int* sel = reinterpret_cast<int*>(dist + (ns < n ? st.qb * select_words(n, ns) : 0));
  for (int e = tid; e < s * nw; e += kThreads) masks[e] = 0u;
  for (int q0 = 0; q0 < s; q0 += st.qb) {
    const int nq = min(st.qb, s - q0);
    load_queries(st.new_xyz + (static_cast<size_t>(p) * s + q0) * 3, nq, sq);
    __syncthreads();
    select_slots(pts, sq, nq, n, ns, true, false, st.r2, dist, sel);
    for (int e = tid; e < nq * ns; e += kThreads) {
      const int j = sel[e];
      atomicOr(masks + (q0 + e / ns) * nw + (j >> 5), 1u << (j & 31));
    }
  }
  __syncthreads();

  // 2. the stack on the points, tile by tile
  unsigned short* buf_a = reinterpret_cast<unsigned short*>(smem);
  unsigned short* buf_b = buf_a + st.rows * st.lda;
  float* o = st.out + static_cast<size_t>(p) * s * cout;
  const int kp0 = pad16(cin);
  for (int row0 = 0; row0 < n; row0 += st.rows) {
    const int valid = min(st.rows, n - row0);
    // the rows [feat | xyz] rounded to bf16, zeros past cin and past the points
    for (int e = tid; e < st.rows * kp0; e += kThreads) {
      const int rl = e / kp0, c = e % kp0, j = row0 + rl;
      float v = 0.0f;
      if (rl < valid && c < cin)
        v = pcc_bf16::round_bf16(c < st.c ? __ldg(ft + static_cast<size_t>(j) * st.c + c)
                                          : __ldg(pts + 3 * j + (c - st.c)));
      buf_a[rl * st.lda + c] = bf16_bits(v);
    }
    __syncthreads();
    for (int l = 0; l < L - 1; ++l) {
      const int w = st.width[l + 1];
      stage_layer<MT>(st, l, (l & 1) ? buf_b : buf_a, (l & 1) ? st.ldb : st.lda, 0, pad16(w),
                      (l & 1) ? buf_a : buf_b, (l & 1) ? st.lda : st.ldb, pad16(w), queues);
    }
    // the last layer, a column chunk at a time into the buffer it does not read
    const int l = L - 1;
    const unsigned short* src = (l & 1) ? buf_b : buf_a;
    unsigned short* t = (l & 1) ? buf_a : buf_b;
    const int ld_src = (l & 1) ? st.ldb : st.lda, ldt = (l & 1) ? st.lda : st.ldb;
    for (int c0 = 0; c0 < cout; c0 += st.cc) {
      const int cc = min(st.cc, cout - c0);
      stage_layer<MT>(st, l, src, ld_src, c0, pad16(cc), t, ldt, 0, queues);
      if (cout % 4 == 0) {
        fold_query_max<true>(t, ldt, row0, valid, cc, c0, masks, nw, s, o, cout);
      } else {
        fold_query_max<false>(t, ldt, row0, valid, cc, c0, masks, nw, s, o, cout);
      }
      __syncthreads();
    }
  }
}

// The tile: the most rows (128, 64, 32, 16; no more than the patch's
// points need) whose buffers, selection scratch, masks and fix-up queues
// fit in `budget` bytes; the selection scratch, which the buffers alias,
// then takes what is left of the budget, so that a selection group holds
// as many queries as it can. Sets st.rows, lda, ldb, region, cc and qb;
// returns the bytes, or 0 if none fits.
size_t tile(St16& st, size_t budget) {
  const int L = st.n_layers, cout = st.width[L];
  const int nw = (st.n + 31) / 32;
  const size_t per_query =
      4 * (4 + st.nsample + (st.nsample < st.n ? select_words(st.n, st.nsample) : 0));
  const int cc = cout < 128 ? pad16(cout) : 128;
  int ld[2] = {8, 8};
  for (int l = 0; l <= L; ++l) {
    const int need = l < L ? ld_of(st.width[l]) : cc + 8;
    if (need > ld[l & 1]) ld[l & 1] = need;
  }
  for (int rows = 128; rows >= 16; rows /= 2) {
    if (rows / 2 >= pad16(st.n)) continue;
    size_t region = 2 * static_cast<size_t>(rows) * (ld[0] + ld[1]);
    if (region < per_query) region = per_query;
    const size_t rest = 4 * static_cast<size_t>(st.s) * nw + 4 * kWarps * (kQueue + 1);
    if (region + rest <= budget) {
      const size_t sel = (budget - rest) / per_query;
      const size_t want = (sel < static_cast<size_t>(st.s) ? sel : st.s) * per_query;
      if (want > region) region = want;
      const size_t bytes = region + rest;
      st.rows = rows;
      st.lda = ld[0];
      st.ldb = ld[1];
      st.region = static_cast<int>(region);
      st.cc = cc;
      const size_t qb = region / per_query;
      st.qb = qb < static_cast<size_t>(st.s) ? static_cast<int>(qb) : st.s;
      return bytes;
    }
  }
  return 0;
}

// Launch the per-point kernel where a tile fits; returns kNoTile where none
// does (the caller takes the per-slot kernel).
int launch(const Stage& base, const void* const* frags, int p, cudaStream_t strm) {
  St16 st;
  st.new_xyz = base.new_xyz;
  st.xyz = base.xyz;
  st.feat = base.feat;
  st.out = base.out;
  st.s = base.s;
  st.n = base.n;
  st.c = base.c;
  st.nsample = base.nsample;
  st.n_layers = base.n_layers;
  st.r2 = base.r2;
  for (int l = 0; l <= base.n_layers; ++l) st.width[l] = base.width[l];
  for (int l = 0; l < base.n_layers; ++l) {
    st.w[l] = base.w[l];
    st.frag[l] = static_cast<const uint2*>(frags[l]);
    if ((base.width[l] >= 16) != (st.frag[l] != nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    st.b[l] = base.b[l];
    st.mu[l] = base.mu[l];
    st.mul[l] = base.mul[l];
    st.beta[l] = base.beta[l];
  }
  const size_t budgets[2] = {(kSmemLimit + 1024) / kMinBlocks - 1024, kSmemLimit};
  size_t bytes = 0;
  for (int i = 0; i < 2 && bytes == 0; ++i) bytes = tile(st, budgets[i]);
  if (bytes == 0) return kNoTile;
  void (*kernel)(St16) = st.rows >= 64   ? points_kernel<4>
                         : st.rows == 32 ? points_kernel<2>
                                         : points_kernel<1>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(p), kThreads, bytes, strm>>>(st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace st16

namespace {

// The Stage of a launch's arguments (see pppf_sa_stage_launch), or false
// where they are invalid.
bool make_stage(Stage& st, const float* new_xyz, const float* xyz, const float* feat,
                float* out, int p, int s, int n, int c, int nsample, float r2, int pppe,
                int n_layers, const void* const* layers, const int* widths) {
  if (p <= 0 || s <= 0 || n <= 0 || n > kMaxN || nsample <= 0 || n_layers <= 0 ||
      n_layers > kMaxLayers || c < 0 || (c > 0) != (feat != nullptr) || widths[0] != c + 3)
    return false;
  st.gsel = nullptr;
  st.gact = nullptr;
  st.gt = nullptr;
  st.new_xyz = new_xyz;
  st.xyz = xyz;
  st.feat = feat;
  st.out = out;
  st.s = s;
  st.n = n;
  st.c = c;
  st.nsample = nsample;
  st.n_layers = n_layers;
  st.pppe = pppe;
  st.r2 = r2;
  st.lda = st.ldb = 4;
  st.region = 0;
  st.cc = 0;
  st.y = nullptr;
  st.ks = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (widths[l] <= 0) return false;
    st.width[l] = widths[l];
    if (l < n_layers) {
      int& ld = (l & 1) ? st.ldb : st.lda;
      if (round4(widths[l]) > ld) ld = round4(widths[l]);
      st.w[l] = static_cast<const float*>(layers[5 * l]);
      st.b[l] = static_cast<const float*>(layers[5 * l + 1]);
      st.mu[l] = static_cast<const float*>(layers[5 * l + 2]);
      st.mul[l] = static_cast<const float*>(layers[5 * l + 3]);
      st.beta[l] = static_cast<const float*>(layers[5 * l + 4]);
    }
  }
  st.lay = act_layout(static_cast<size_t>(p) * n, n_layers, widths);
  return true;
}

}  // namespace

// new_xyz [p, s, 3], xyz [p, n, 3], feat [p, n, c] or null (c = 0), all f32
// contiguous; out [p, s, widths[n_layers]] f32. layers: host array of
// 5 * n_layers device pointers (W [in, out] row-major, b, mean, mul, beta per
// layer, 16-byte aligned); widths: host array of n_layers + 1 ints, widths[0]
// = c + 3. pppe: 0 for the "pppf" layout, 1 for "pppe". Store mode, "pppf"
// only: gsel (p * s * nsample ints), gact and gt (laid out as
// pppf_sa_common.cuh::act_layout(p * n, ...) gives), or all null; *saved
// (host) is set to 1 where they were written (the per-point kernel ran),
// else 0. y: "pppe" with c > 0 where the slot kernel's tile fits
// (pppf_sa_cuda.py::pppe_plan), scratch for the feature block, p * n *
// widths[1] floats; else null. Returns a cudaError_t value.
extern "C" int pppf_sa_stage_launch(const float* new_xyz, const float* xyz, const float* feat,
                                    float* out, int p, int s, int n, int c, int nsample,
                                    float r2, int pppe, int n_layers,
                                    const void* const* layers, const int* widths, int* gsel,
                                    float* gact, float* gt, int* saved, float* y, void* stream) {
  Stage st;
  if (!make_stage(st, new_xyz, xyz, feat, out, p, s, n, c, nsample, r2, pppe, n_layers, layers,
                  widths) ||
      (gsel != nullptr) != (gact != nullptr) || (gsel != nullptr) != (gt != nullptr) ||
      (gsel != nullptr && (pppe || saved == nullptr)) || (!pppe && y != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool save = gsel != nullptr;
  if (saved) *saved = 0;
  st.gsel = gsel;
  st.gact = gact;
  st.gt = gt;
  return launch_stage<false>(st, p, save, saved, y, static_cast<cudaStream_t>(stream));
}

// The bf16 instance, layout "pppf", serving: the arguments of
// pppf_sa_stage_launch without pppe, the store mode and y; W bf16-exact
// (the wrapper rounds it), b, mean, mul and beta float32; frags: host array
// of n_layers device pointers, each layer's W packed for the tensor cores
// (ops/certified.py::pack_frags) where it is at least 16 deep, else null.
// Every layer's input rows and relu output are rounded to bf16; the
// selection and the ball mask are the float32 instance's bit for bit, the
// outputs those of the k-order arithmetic (st16; the per-slot kernel's
// bf16 instance where no per-point tile fits).
extern "C" int pppf_sa_stage_bf16_launch(const float* new_xyz, const float* xyz,
                                         const float* feat, float* out, int p, int s, int n,
                                         int c, int nsample, float r2, int n_layers,
                                         const void* const* layers, const int* widths,
                                         const void* const* frags, void* stream) {
  Stage st;
  if (!make_stage(st, new_xyz, xyz, feat, out, p, s, n, c, nsample, r2, 0, n_layers, layers,
                  widths) ||
      frags == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  const int r = st16::launch(st, frags, p, strm);
  if (r != kNoTile) return r;
  return launch_stage<true>(st, p, false, nullptr, nullptr, strm);
}

// The counting build's flagged and computed entries per layer (st16's
// tags: the layer index), copied to host[0 .. 2 * tags) and zeroed.
// Returns a cudaError_t value.
extern "C" int pppf_sa_stage_bf16_cert_counts(unsigned long long* host, int tags) {
  cudaError_t err = cudaMemcpyFromSymbol(host, pcc_cert::cert_counts,
                                         2 * tags * sizeof(unsigned long long));
  if (err != cudaSuccess) return static_cast<int>(err);
  static const unsigned long long zeros[64] = {};
  return static_cast<int>(cudaMemcpyToSymbol(pcc_cert::cert_counts, zeros, sizeof(zeros)));
}

// The bf16 instance's store mode (the bf16 train step's forward): the
// arguments of pppf_sa_stage_bf16_launch and the store mode's gsel, gact, gt
// and *saved, as pppf_sa_stage_launch takes them (all four not null). The
// output is the serving instance's bit for bit; gact holds the rounded
// layer inputs.
extern "C" int pppf_sa_stage_bf16_save_launch(const float* new_xyz, const float* xyz,
                                              const float* feat, float* out, int p, int s,
                                              int n, int c, int nsample, float r2, int n_layers,
                                              const void* const* layers, const int* widths,
                                              int* gsel, float* gact, float* gt, int* saved,
                                              void* stream) {
  Stage st;
  if (!make_stage(st, new_xyz, xyz, feat, out, p, s, n, c, nsample, r2, 0, n_layers, layers,
                  widths) ||
      gsel == nullptr || gact == nullptr || gt == nullptr || saved == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  *saved = 0;
  st.gsel = gsel;
  st.gact = gact;
  st.gt = gt;
  return launch_stage<true>(st, p, true, saved, nullptr, static_cast<cudaStream_t>(stream));
}

// The bf16 instance, layout "pppe" (PPPE's sa2 and sa3 in bf16 eval mode):
// the arguments of pppf_sa_stage_launch without r2, pppe and the store
// mode; W bf16-exact (the wrapper rounds it), b, mean, mul and beta
// float32; y as pppf_sa_stage_launch takes it for "pppe". Each layer's
// input rows (the centred coordinates and the features) and relu output
// are rounded to bf16; the selection is the float32 instance's bit for bit.
extern "C" int pppe_sa_stage_bf16_launch(const float* new_xyz, const float* xyz,
                                         const float* feat, float* out, int p, int s, int n,
                                         int c, int nsample, int n_layers,
                                         const void* const* layers, const int* widths, float* y,
                                         void* stream) {
  Stage st;
  if (!make_stage(st, new_xyz, xyz, feat, out, p, s, n, c, nsample, 0.0f, 1, n_layers, layers,
                  widths))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_stage<true>(st, p, false, nullptr, y, static_cast<cudaStream_t>(stream));
}
