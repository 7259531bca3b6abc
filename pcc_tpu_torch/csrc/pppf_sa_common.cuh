// Building blocks of the PointNet++ set-abstraction stage, shared by the
// stage kernel (pppf_sa_stage.cu) and its backward (pppf_sa_stage_bwd.cu):
// the queries' coordinates, the selection of the nsample nearest,
// the ball mask, and one Conv + BatchNorm(eval) + ReLU layer on a tile of
// rows in shared memory. Both kernels run this code, so the backward's
// replay computes the forward's selection and activations bit for bit.
//
// Float32 rounding, fixed so that a plain version can repeat it exactly:
// the distances are one rounding per operation (__f*_rn, never contracted);
// a layer's product is acc = fma(x[k], w[k][o], acc) for k = 0, 1, ... from
// 0; the BatchNorm affine is t = (acc + b) - mean, rounded twice, then
// relu(fma(t, mul, beta)).

#pragma once

#include <cuda_runtime.h>

#include "bf16.cuh"

namespace pcc_sa {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTM = 8;              // rows per thread
constexpr int kMaxLayers = 6;
constexpr int kMaxN = 1024;         // points per patch
constexpr int kMaxRows = 64;        // rows per tile, a multiple of kTM
constexpr int kSmemLimit = 227 * 1024;
static_assert(kMaxRows % kTM == 0, "a tile is whole row groups");

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

__device__ __forceinline__ float bn_shift(float acc, float b, float mu) {
  return __fsub_rn(__fadd_rn(acc, b), mu);
}

// Where a stage's activations lie in device memory, for its backward: x_l
// (the input of layer l, l = 0..n_layers; x_n_layers the last activation)
// as [rows][ld[l]] at act + act_off[l], and t_l = (z + b) - mean of layer l
// as [rows][ld[l + 1]] at t + t_off[l], ld[l] = round4(width[l]), rows = P *
// N points. The forward kernel writes them in its store mode, the backward
// kernel's replay otherwise.
struct ActLayout {
  int ld[kMaxLayers + 1];
  size_t act_off[kMaxLayers + 1];
  size_t t_off[kMaxLayers];
};

inline ActLayout act_layout(size_t rows, int n_layers, const int* widths) {
  ActLayout a;
  size_t act_off = 0, t_off = 0;
  for (int l = 0; l <= n_layers; ++l) {
    a.ld[l] = round4(widths[l]);
    a.act_off[l] = act_off;
    act_off += rows * a.ld[l];
    if (l > 0) {
      a.t_off[l - 1] = t_off;
      t_off += rows * a.ld[l];
    }
  }
  return a;
}

// What a layer does with its outputs.
enum Epilogue {
  kStore,        // out[r][o] = relu(fma(bn_shift(...), mul, beta))
  kQueryMax,     // only each query's maximum: atomicMax into qmax[query][o]
  kStoreGlobal,  // as kStore into out (if not null) and into gx, bn_shift into gt
  kLinear,       // out[r][o] = acc: a plain product, no bias, BatchNorm or relu
};

// Rows of a layer written to device memory by kStoreGlobal: row r of the
// tile goes to row r of gx / gt (already offset to the tile), if r < valid.
struct GlobalRows {
  float* gx;   // relu outputs, row stride ld
  float* gt;   // (acc + b) - mean, row stride ld
  int ld, valid;
};

// One layer on a tile: out[r][o] = epilogue(sum_k in[r][k] * w[k][o]) for the
// cout columns of w, whose rows are ldw floats apart (a column chunk of a
// wider layer: w, b, mu, mul and beta offset to the chunk). With kQueryMax
// the rows are not stored: row r of the tile is row row0 + r of the block,
// which belongs to query (row0 + r) / nsample, and only each query's maximum
// is kept in qmax[query][o]. kBf16 (the bf16 instance's serving modes,
// kStore and kQueryMax): every relu output rounded to bf16, as pcc_tpu's
// bf16 stage rounds each layer's output (the products then read bf16-exact
// activations and weights). No trailing barrier.
template <int kMode, bool kBf16 = false>
__device__ __forceinline__ void dense_layer(
    const float* in, int ld_in, int rows, int cin, const float* __restrict__ w, int ldw,
    const float* __restrict__ b, const float* __restrict__ mu,
    const float* __restrict__ mul, const float* __restrict__ beta, int cout, float* out,
    int ld_out, int* qmax, int row0, int rows_total, int nsample, GlobalRows g) {
  if (cout % 4 != 0) {
    // narrow layers (3 -> 3): one output per work item
    for (int e = threadIdx.x; e < rows * cout; e += kThreads) {
      const int o = e % cout, r = e / cout;
      float acc = 0.0f;
      for (int k = 0; k < cin; ++k) acc = fmaf(in[r * ld_in + k], __ldg(w + k * ldw + o), acc);
      if (kMode == kLinear) {
        out[r * ld_out + o] = acc;
        continue;
      }
      const float t = bn_shift(acc, __ldg(b + o), __ldg(mu + o));
      const float v =
          pcc_bf16::act_round<kBf16>(fmaxf(fmaf(t, __ldg(mul + o), __ldg(beta + o)), 0.0f));
      if (kMode == kQueryMax) {
        if (row0 + r < rows_total)
          atomicMax(qmax + ((row0 + r) / nsample) * cout + o, __float_as_int(v));
      } else {
        if (kMode == kStore || out) out[r * ld_out + o] = v;
        if (kMode == kStoreGlobal && r < g.valid) {
          g.gx[r * g.ld + o] = v;
          g.gt[r * g.ld + o] = t;
        }
      }
    }
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = rows / kTM;
  const int chunks = (cout + 127) / 128;
  const int cin4 = cin & ~3;
  // the warps of a block take the row groups of one 128-column chunk
  // together, so they read the same weights at the same time
  for (int item = warp; item < groups * chunks; item += kWarps) {
    const int gi = item % groups;
    const int col = (item / groups) * 128 + lane * 4;
    if (col >= cout) continue;
    const float* x = in + gi * kTM * ld_in;
    float acc[kTM][4];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
    const float* wc = w + col;
    for (int k = 0; k < cin4; k += 4) {
      const float4 w0 = __ldg(reinterpret_cast<const float4*>(wc + (k + 0) * ldw));
      const float4 w1 = __ldg(reinterpret_cast<const float4*>(wc + (k + 1) * ldw));
      const float4 w2 = __ldg(reinterpret_cast<const float4*>(wc + (k + 2) * ldw));
      const float4 w3 = __ldg(reinterpret_cast<const float4*>(wc + (k + 3) * ldw));
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const float4 xv = *reinterpret_cast<const float4*>(x + i * ld_in + k);
        acc[i][0] = fmaf(xv.x, w0.x, acc[i][0]);
        acc[i][1] = fmaf(xv.x, w0.y, acc[i][1]);
        acc[i][2] = fmaf(xv.x, w0.z, acc[i][2]);
        acc[i][3] = fmaf(xv.x, w0.w, acc[i][3]);
        acc[i][0] = fmaf(xv.y, w1.x, acc[i][0]);
        acc[i][1] = fmaf(xv.y, w1.y, acc[i][1]);
        acc[i][2] = fmaf(xv.y, w1.z, acc[i][2]);
        acc[i][3] = fmaf(xv.y, w1.w, acc[i][3]);
        acc[i][0] = fmaf(xv.z, w2.x, acc[i][0]);
        acc[i][1] = fmaf(xv.z, w2.y, acc[i][1]);
        acc[i][2] = fmaf(xv.z, w2.z, acc[i][2]);
        acc[i][3] = fmaf(xv.z, w2.w, acc[i][3]);
        acc[i][0] = fmaf(xv.w, w3.x, acc[i][0]);
        acc[i][1] = fmaf(xv.w, w3.y, acc[i][1]);
        acc[i][2] = fmaf(xv.w, w3.z, acc[i][2]);
        acc[i][3] = fmaf(xv.w, w3.w, acc[i][3]);
      }
    }
    for (int k = cin4; k < cin; ++k) {
      const float4 wk = __ldg(reinterpret_cast<const float4*>(wc + k * ldw));
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const float xv = x[i * ld_in + k];
        acc[i][0] = fmaf(xv, wk.x, acc[i][0]);
        acc[i][1] = fmaf(xv, wk.y, acc[i][1]);
        acc[i][2] = fmaf(xv, wk.z, acc[i][2]);
        acc[i][3] = fmaf(xv, wk.w, acc[i][3]);
      }
    }
    if (kMode == kLinear) {
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        *reinterpret_cast<float4*>(out + (gi * kTM + i) * ld_out + col) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      continue;
    }
    const float4 vb = __ldg(reinterpret_cast<const float4*>(b + col));
    const float4 vmu = __ldg(reinterpret_cast<const float4*>(mu + col));
    const float4 vmul = __ldg(reinterpret_cast<const float4*>(mul + col));
    const float4 vbeta = __ldg(reinterpret_cast<const float4*>(beta + col));
    int cur_q = -1;
    float4 m = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      float4 t, v;
      t.x = bn_shift(acc[i][0], vb.x, vmu.x);
      t.y = bn_shift(acc[i][1], vb.y, vmu.y);
      t.z = bn_shift(acc[i][2], vb.z, vmu.z);
      t.w = bn_shift(acc[i][3], vb.w, vmu.w);
      v.x = fmaxf(fmaf(t.x, vmul.x, vbeta.x), 0.0f);
      v.y = fmaxf(fmaf(t.y, vmul.y, vbeta.y), 0.0f);
      v.z = fmaxf(fmaf(t.z, vmul.z, vbeta.z), 0.0f);
      v.w = fmaxf(fmaf(t.w, vmul.w, vbeta.w), 0.0f);
      if (kBf16) {
        v.x = pcc_bf16::round_bf16(v.x);
        v.y = pcc_bf16::round_bf16(v.y);
        v.z = pcc_bf16::round_bf16(v.z);
        v.w = pcc_bf16::round_bf16(v.w);
      }
      if (kMode == kQueryMax) {
        const int r = row0 + gi * kTM + i;
        if (r < rows_total) {
          const int q = r / nsample;
          if (q != cur_q) {
            if (cur_q >= 0) {
              int* dst = qmax + cur_q * cout + col;
              atomicMax(dst + 0, __float_as_int(m.x));
              atomicMax(dst + 1, __float_as_int(m.y));
              atomicMax(dst + 2, __float_as_int(m.z));
              atomicMax(dst + 3, __float_as_int(m.w));
            }
            cur_q = q;
            m = v;
          } else {
            m.x = fmaxf(m.x, v.x);
            m.y = fmaxf(m.y, v.y);
            m.z = fmaxf(m.z, v.z);
            m.w = fmaxf(m.w, v.w);
          }
        }
      } else {
        const int r = gi * kTM + i;
        if (kMode == kStore || out) *reinterpret_cast<float4*>(out + r * ld_out + col) = v;
        if (kMode == kStoreGlobal && r < g.valid) {
          *reinterpret_cast<float4*>(g.gx + r * g.ld + col) = v;
          *reinterpret_cast<float4*>(g.gt + r * g.ld + col) = t;
        }
      }
    }
    if (kMode == kQueryMax && cur_q >= 0) {
      int* dst = qmax + cur_q * cout + col;
      atomicMax(dst + 0, __float_as_int(m.x));
      atomicMax(dst + 1, __float_as_int(m.y));
      atomicMax(dst + 2, __float_as_int(m.z));
      atomicMax(dst + 3, __float_as_int(m.w));
    }
  }
}

// sq[4 * qi .. 4 * qi + 3] = x, y, z, |q|^2 of the nq queries q[0 .. nq).
__device__ __forceinline__ void load_queries(const float* q, int nq, float* sq) {
  for (int qi = threadIdx.x; qi < nq; qi += kThreads) {
    const float x = q[3 * qi], y = q[3 * qi + 1], z = q[3 * qi + 2];
    sq[4 * qi] = x;
    sq[4 * qi + 1] = y;
    sq[4 * qi + 2] = z;
    sq[4 * qi + 3] = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
  }
}

// Words of select_slots' scratch per query where it ranks: the distances
// and the list of selected points.
__host__ __device__ inline int select_words(int n, int nsample) {
  return n + (nsample < n ? nsample : n);
}

// A distance's bits as an unsigned key that orders as the distance does
// (distances are >= 0; -0 and +0 both map to 0).
__device__ __forceinline__ unsigned dist_key(float d) {
  return d == 0.0f ? 0u : __float_as_uint(d);
}

// sel[qi * nsample + slot] = the point in `slot` of query qi, for the nq
// queries in sq (after a barrier that publishes sq): the nsample nearest of
// the n points pts, a point's rank among the (distance, index) pairs being
// its slot (ties to the lower index; slots beyond n read point 0). When
// nsample >= n every point is taken: then, unless `ordered`, in index order
// without ranking (the forward's max does not depend on the order; the
// backward's first winner does). With `mask`, every slot whose exactly
// recomputed distance exceeds r2 then reads point 0. dist: nq *
// select_words(n, nsample) words of shared memory, used when ranking. Ends
// with a barrier. sel may lie in shared or device memory.
//
// Ranking, a warp per query: the k = min(nsample, n)-th smallest distance t
// by a binary search on its bits (31 counts of the distances below a
// candidate); the selected points, in index order, are those below t and
// the first k - #{d < t} of those equal to t; a point's slot is its rank
// among them alone (k^2 comparisons, where ranking every point would take
// n^2).
__device__ __forceinline__ void select_slots(const float* __restrict__ pts, const float* sq,
                                             int nq, int n, int nsample, bool mask,
                                             bool ordered, float r2, float* dist, int* sel) {
  const int tid = threadIdx.x;
  const int rows_total = nq * nsample;
  if (nsample < n || ordered) {
    const int k = nsample < n ? nsample : n;
    const int words = select_words(n, nsample);
    for (int e = tid; e < nq * n; e += kThreads) {
      const int qi = e / n, j = e % n;
      const float px = __ldg(pts + 3 * j), py = __ldg(pts + 3 * j + 1),
                  pz = __ldg(pts + 3 * j + 2);
      const float pp =
          __fadd_rn(__fadd_rn(__fmul_rn(px, px), __fmul_rn(py, py)), __fmul_rn(pz, pz));
      const float cross = __fadd_rn(
          __fadd_rn(__fmul_rn(sq[4 * qi], px), __fmul_rn(sq[4 * qi + 1], py)),
          __fmul_rn(sq[4 * qi + 2], pz));
      dist[qi * words + j] =
          fmaxf(__fadd_rn(__fsub_rn(sq[4 * qi + 3], __fmul_rn(2.0f, cross)), pp), 0.0f);
    }
    __syncthreads();
    const int lane = tid & 31;
    const unsigned below = (1u << lane) - 1u;
    for (int qi = tid >> 5; qi < nq; qi += kWarps) {
      const float* d = dist + qi * words;
      int* list = reinterpret_cast<int*>(dist + qi * words + n);
      // t: the largest key with fewer than k keys below it (every key when k == n)
      unsigned t = 0xffffffffu;
      if (k < n) {
        t = 0u;
        for (int b = 30; b >= 0; --b) {
          const unsigned x = t | (1u << b);
          int c = 0;
          for (int j = lane; j < n; j += 32) c += dist_key(d[j]) < x ? 1 : 0;
          if (__reduce_add_sync(0xffffffffu, c) < k) t = x;
        }
      }
      int less = 0;
      for (int j = lane; j < n; j += 32) less += dist_key(d[j]) < t ? 1 : 0;
      int ties = k - __reduce_add_sync(0xffffffffu, less);
      // the selected points in index order
      int pos = 0;
      for (int j0 = 0; j0 < n; j0 += 32) {
        const int j = j0 + lane;
        const unsigned kj = j < n ? dist_key(d[j]) : 0xffffffffu;
        const bool tie = j < n && kj == t;
        const unsigned tb = __ballot_sync(0xffffffffu, tie);
        const bool take = (j < n && kj < t) || (tie && __popc(tb & below) < ties);
        const unsigned sb = __ballot_sync(0xffffffffu, take);
        if (take) list[pos + __popc(sb & below)] = j;
        pos += __popc(sb);
        ties -= __popc(tb);
      }
      __syncwarp();
      // each one's slot: its rank among them, (distance, index) ascending
      for (int e = lane; e < k; e += 32) {
        const int j = list[e];
        const unsigned kj = dist_key(d[j]);
        int rank = 0;
        for (int f = 0; f < k; ++f) {
          const unsigned kf = dist_key(d[list[f]]);
          rank += (kf < kj || (kf == kj && f < e)) ? 1 : 0;
        }
        sel[qi * nsample + rank] = j;
      }
    }
    for (int e = tid; e < rows_total; e += kThreads)
      if (e % nsample >= n) sel[e] = 0;
  } else {
    for (int e = tid; e < rows_total; e += kThreads) {
      const int slot = e % nsample;
      sel[e] = slot < n ? slot : 0;
    }
  }
  __syncthreads();
  if (mask) {
    // ball mask on exactly recomputed distances: outside -> point 0
    for (int e = tid; e < rows_total; e += kThreads) {
      const int qi = e / nsample, j = sel[e];
      const float dx = __fsub_rn(__ldg(pts + 3 * j), sq[4 * qi]);
      const float dy = __fsub_rn(__ldg(pts + 3 * j + 1), sq[4 * qi + 1]);
      const float dz = __fsub_rn(__ldg(pts + 3 * j + 2), sq[4 * qi + 2]);
      const float d =
          __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      if (!(d <= r2)) sel[e] = 0;
    }
    __syncthreads();
  }
}


}  // namespace pcc_sa
