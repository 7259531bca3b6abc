// One PointNet++ set-abstraction stage, fused: selection, gather, ball mask,
// the Conv + BatchNorm(eval) + ReLU stack and the max over samples, one launch.
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
// Output [P, S, C_out].
//
// What bounds it on an H100: operations. The stack is 2 * nsample *
// sum(cin * cout) FLOP per query against a few KB of input per patch, far
// above the card's bytes-to-FLOP balance; in float32 on CUDA cores the floor
// is FLOPs / 67 TFLOP/s.
// What the design does about it: the grouped activations never leave the SM.
// A block owns a few queries of one patch (as many as fill a tile of up to
// 64 rows; one query when nsample is larger, its rows taken tile by tile).
// The tile is cut so that two blocks share an SM (32 rows at the widest
// stage): 16 resident warps hide the weight loads' latency, which one
// 64-row block per SM does not.
// It ranks the patch's points for its queries in shared memory (a point's
// rank among (distance, index) pairs is its slot, so no sort and no
// compaction), gathers a tile's rows, and runs the layers between two
// activation buffers in shared memory. The last layer is never stored: each
// thread folds its rows into a per-query maximum in shared memory (ReLU
// outputs are >= 0, so an integer atomicMax on the float's bits, from 0, is
// exact). Each layer is a register-tiled product on CUDA cores: a warp takes
// 8 rows x 128 columns, a thread 8 rows x 4 columns, activations come as
// 16-byte shared-memory broadcasts and weights as 16-byte loads through the
// read-only cache (the weights of all layers, up to 3 MB, stay in L2; the 8
// warps of a block read the same columns together). It is not a tensor-core
// product (TF32 would not hold the 1e-4 agreement with the plain version);
// larger register tiles where the tile allows them, and weights staged
// through shared memory with asynchronous copies, are what a later, faster
// version adds.
//
// Selection is bit-equal to the plain PyTorch version
// (pcc_tpu_torch/ops/pppf_sa_cuda.py::pppf_sa_plain): the same distance
// formulas with one rounding per operation (__f*_rn intrinsics are never
// contracted into FMAs). The products sum in another order, so outputs
// agree to float32 rounding.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTM = 8;              // rows per thread
constexpr int kMaxLayers = 6;
constexpr int kMaxN = 1024;         // points per patch
constexpr int kMaxRows = 64;        // rows per tile, a multiple of kTM
constexpr int kSmemLimit = 227 * 1024;
// Blocks meant to share an SM: the registers allow two, and a tile is sized
// so that two fit in the SM's shared memory too (32 rows at the widest
// stage, 259 -> 256 -> 256 -> 512 -> 1024 with nsample 128, against one
// block of 64 rows). Two blocks per SM and 8 rows per thread won on the sum
// of the three PPPF-AE stages on an H100; 16 rows per thread was faster at
// the widest stage alone and slower at the other two.
constexpr int kMinBlocks = 2;
static_assert(kMaxRows % kTM == 0, "a tile is whole row groups");

struct Stage {
  const float* new_xyz;   // [P, S, 3]
  const float* xyz;       // [P, N, 3]
  const float* feat;      // [P, N, C] or nullptr
  float* out;             // [P, S, width[n_layers]]
  int s, n, c, nsample, n_layers, pppe;
  float r2;
  int rows;               // rows per tile, a multiple of kTM
  int qb;                 // queries per block
  int lda, ldb;           // row strides of the two activation buffers
  int width[kMaxLayers + 1];
  const float* w[kMaxLayers];
  const float* b[kMaxLayers];
  const float* mu[kMaxLayers];
  const float* mul[kMaxLayers];
  const float* beta[kMaxLayers];
};

__device__ __forceinline__ float bn_relu(float acc, float b, float mu, float mul,
                                         float beta) {
  return fmaxf(((acc + b) - mu) * mul + beta, 0.0f);
}

// One layer on a tile: out[r][o] = bn_relu(sum_k in[r][k] * w[k][o]). With
// kLast the rows are not stored: row r of the tile is row row0 + r of the
// block, which belongs to query (row0 + r) / nsample, and only each
// query's maximum is kept in qmax[query][o]. No trailing barrier.
template <bool kLast>
__device__ __forceinline__ void dense_bn_relu(
    const float* in, int ld_in, int rows, int cin, const float* __restrict__ w,
    const float* __restrict__ b, const float* __restrict__ mu,
    const float* __restrict__ mul, const float* __restrict__ beta, int cout, float* out,
    int ld_out, int* qmax, int row0, int rows_total, int nsample) {
  if (cout % 4 != 0) {
    // narrow layers (3 -> 3): one output per work item
    for (int e = threadIdx.x; e < rows * cout; e += kThreads) {
      const int o = e % cout, r = e / cout;
      float acc = 0.0f;
      for (int k = 0; k < cin; ++k) acc = fmaf(in[r * ld_in + k], __ldg(w + k * cout + o), acc);
      const float v = bn_relu(acc, __ldg(b + o), __ldg(mu + o), __ldg(mul + o), __ldg(beta + o));
      if (kLast) {
        if (row0 + r < rows_total)
          atomicMax(qmax + ((row0 + r) / nsample) * cout + o, __float_as_int(v));
      } else {
        out[r * ld_out + o] = v;
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
    const int g = item % groups;
    const int col = (item / groups) * 128 + lane * 4;
    if (col >= cout) continue;
    const float* x = in + g * kTM * ld_in;
    float acc[kTM][4];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
    const float* wc = w + col;
    for (int k = 0; k < cin4; k += 4) {
      const float4 w0 = __ldg(reinterpret_cast<const float4*>(wc + (k + 0) * cout));
      const float4 w1 = __ldg(reinterpret_cast<const float4*>(wc + (k + 1) * cout));
      const float4 w2 = __ldg(reinterpret_cast<const float4*>(wc + (k + 2) * cout));
      const float4 w3 = __ldg(reinterpret_cast<const float4*>(wc + (k + 3) * cout));
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
      const float4 wk = __ldg(reinterpret_cast<const float4*>(wc + k * cout));
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const float xv = x[i * ld_in + k];
        acc[i][0] = fmaf(xv, wk.x, acc[i][0]);
        acc[i][1] = fmaf(xv, wk.y, acc[i][1]);
        acc[i][2] = fmaf(xv, wk.z, acc[i][2]);
        acc[i][3] = fmaf(xv, wk.w, acc[i][3]);
      }
    }
    const float4 vb = __ldg(reinterpret_cast<const float4*>(b + col));
    const float4 vmu = __ldg(reinterpret_cast<const float4*>(mu + col));
    const float4 vmul = __ldg(reinterpret_cast<const float4*>(mul + col));
    const float4 vbeta = __ldg(reinterpret_cast<const float4*>(beta + col));
    int cur_q = -1;
    float4 m = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      float4 v;
      v.x = bn_relu(acc[i][0], vb.x, vmu.x, vmul.x, vbeta.x);
      v.y = bn_relu(acc[i][1], vb.y, vmu.y, vmul.y, vbeta.y);
      v.z = bn_relu(acc[i][2], vb.z, vmu.z, vmul.z, vbeta.z);
      v.w = bn_relu(acc[i][3], vb.w, vmu.w, vmul.w, vbeta.w);
      if (kLast) {
        const int r = row0 + g * kTM + i;
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
        *reinterpret_cast<float4*>(out + (g * kTM + i) * ld_out + col) = v;
      }
    }
    if (kLast && cur_q >= 0) {
      int* dst = qmax + cur_q * cout + col;
      atomicMax(dst + 0, __float_as_int(m.x));
      atomicMax(dst + 1, __float_as_int(m.y));
      atomicMax(dst + 2, __float_as_int(m.z));
      atomicMax(dst + 3, __float_as_int(m.w));
    }
  }
}

// Shared memory, in 4-byte words: the two activation buffers, the per-query
// maxima, the selected indices, the distances and the queries' coordinates.
__host__ __device__ inline size_t smem_words(int rows, int qb, int lda, int ldb, int cout,
                                             int n, int nsample) {
  return static_cast<size_t>(rows) * (lda + ldb) + static_cast<size_t>(qb) * cout +
         static_cast<size_t>(qb) * nsample + (nsample < n ? static_cast<size_t>(qb) * n : 0) +
         static_cast<size_t>(qb) * 4;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
pppf_sa_stage_kernel(const __grid_constant__ Stage st) {
  extern __shared__ __align__(16) float smem[];
  const int cout = st.width[st.n_layers];
  const int cin = st.width[0];
  float* buf_a = smem;
  float* buf_b = buf_a + st.rows * st.lda;
  int* qmax = reinterpret_cast<int*>(buf_b + st.rows * st.ldb);
  int* sel = qmax + st.qb * cout;
  float* dist = reinterpret_cast<float*>(sel + st.qb * st.nsample);
  float* sq = dist + (st.nsample < st.n ? st.qb * st.n : 0);   // [qb][4]: x y z |q|^2

  const int tid = threadIdx.x;
  const int qblocks = (st.s + st.qb - 1) / st.qb;
  const int p = blockIdx.x / qblocks;
  const int q0 = (blockIdx.x % qblocks) * st.qb;
  const int nq = min(st.qb, st.s - q0);
  const int rows_total = nq * st.nsample;
  const int n = st.n;
  const float* pts = st.xyz + static_cast<size_t>(p) * n * 3;
  const float* ft = st.feat ? st.feat + static_cast<size_t>(p) * n * st.c : nullptr;

  for (int qi = tid; qi < nq; qi += kThreads) {
    const float* q = st.new_xyz + (static_cast<size_t>(p) * st.s + q0 + qi) * 3;
    const float x = q[0], y = q[1], z = q[2];
    sq[4 * qi] = x;
    sq[4 * qi + 1] = y;
    sq[4 * qi + 2] = z;
    sq[4 * qi + 3] = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
  }
  for (int e = tid; e < nq * cout; e += kThreads) qmax[e] = 0;
  __syncthreads();

  // the nsample nearest of each query, as a set: a point's rank among the
  // (distance, index) pairs is its slot
  if (st.nsample < n) {
    for (int e = tid; e < nq * n; e += kThreads) {
      const int qi = e / n, j = e % n;
      const float px = __ldg(pts + 3 * j), py = __ldg(pts + 3 * j + 1),
                  pz = __ldg(pts + 3 * j + 2);
      const float pp =
          __fadd_rn(__fadd_rn(__fmul_rn(px, px), __fmul_rn(py, py)), __fmul_rn(pz, pz));
      const float cross = __fadd_rn(
          __fadd_rn(__fmul_rn(sq[4 * qi], px), __fmul_rn(sq[4 * qi + 1], py)),
          __fmul_rn(sq[4 * qi + 2], pz));
      dist[e] = fmaxf(__fadd_rn(__fsub_rn(sq[4 * qi + 3], __fmul_rn(2.0f, cross)), pp), 0.0f);
    }
    __syncthreads();
    for (int e = tid; e < nq * n; e += kThreads) {
      const int qi = e / n, j = e % n;
      const float* d = dist + qi * n;
      const float dj = d[j];
      int rank = 0;
      for (int i = 0; i < n; ++i) {
        const float di = d[i];
        rank += (di < dj || (di == dj && i < j)) ? 1 : 0;
      }
      if (rank < st.nsample) sel[qi * st.nsample + rank] = j;
    }
  } else {
    for (int e = tid; e < rows_total; e += kThreads) {
      const int slot = e % st.nsample;
      sel[e] = slot < n ? slot : 0;
    }
  }
  __syncthreads();
  if (!st.pppe) {
    // ball mask on exactly recomputed distances: outside -> point 0
    for (int e = tid; e < rows_total; e += kThreads) {
      const int qi = e / st.nsample, j = sel[e];
      const float dx = __fsub_rn(__ldg(pts + 3 * j), sq[4 * qi]);
      const float dy = __fsub_rn(__ldg(pts + 3 * j + 1), sq[4 * qi + 1]);
      const float dz = __fsub_rn(__ldg(pts + 3 * j + 2), sq[4 * qi + 2]);
      const float d =
          __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      if (!(d <= st.r2)) sel[e] = 0;
    }
    __syncthreads();
  }

  for (int row0 = 0; row0 < rows_total; row0 += st.rows) {
    // gather the tile's rows into buf_a
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
      buf_a[rl * st.lda + c] = v;
    }
    __syncthreads();
    for (int l = 0; l < st.n_layers; ++l) {
      const float* src = (l & 1) ? buf_b : buf_a;
      float* dst = (l & 1) ? buf_a : buf_b;
      const int ld_src = (l & 1) ? st.ldb : st.lda;
      const int ld_dst = (l & 1) ? st.lda : st.ldb;
      if (l == st.n_layers - 1) {
        dense_bn_relu<true>(src, ld_src, st.rows, st.width[l], st.w[l], st.b[l], st.mu[l],
                            st.mul[l], st.beta[l], st.width[l + 1], dst, ld_dst, qmax, row0,
                            rows_total, st.nsample);
      } else {
        dense_bn_relu<false>(src, ld_src, st.rows, st.width[l], st.w[l], st.b[l], st.mu[l],
                             st.mul[l], st.beta[l], st.width[l + 1], dst, ld_dst, qmax, row0,
                             rows_total, st.nsample);
      }
      __syncthreads();
    }
  }
  float* o = st.out + (static_cast<size_t>(p) * st.s + q0) * cout;
  for (int e = tid; e < nq * cout; e += kThreads) o[e] = __int_as_float(qmax[e]);
}

inline int round4(int v) { return (v + 3) & ~3; }

}  // namespace

// new_xyz [p, s, 3], xyz [p, n, 3], feat [p, n, c] or null (c = 0), all f32
// contiguous; out [p, s, widths[n_layers]] f32. layers: host array of
// 5 * n_layers device pointers (W [in, out] row-major, b, mean, mul, beta per
// layer, 16-byte aligned); widths: host array of n_layers + 1 ints, widths[0]
// = c + 3. pppe: 0 for the "pppf" layout, 1 for "pppe". Returns a
// cudaError_t value.
extern "C" int pppf_sa_stage_launch(const float* new_xyz, const float* xyz, const float* feat,
                                    float* out, int p, int s, int n, int c, int nsample,
                                    float r2, int pppe, int n_layers,
                                    const void* const* layers, const int* widths,
                                    void* stream) {
  if (p <= 0 || s <= 0 || n <= 0 || n > kMaxN || nsample <= 0 || n_layers <= 0 ||
      n_layers > kMaxLayers || c < 0 || (c > 0) != (feat != nullptr) || widths[0] != c + 3)
    return static_cast<int>(cudaErrorInvalidValue);
  Stage st;
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
  for (int l = 0; l <= n_layers; ++l) {
    if (widths[l] <= 0) return static_cast<int>(cudaErrorInvalidValue);
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
  const int cout = widths[n_layers];
  // the largest tile of up to kMaxRows rows of which kMinBlocks fit in an SM's
  // shared memory (a block is charged 1 KB more than it asks for); failing
  // that, the largest of which one does
  size_t bytes = 0;
  const size_t budgets[2] = {(kSmemLimit + 1024) / kMinBlocks - 1024, kSmemLimit};
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
  cudaError_t err = cudaFuncSetAttribute(pppf_sa_stage_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  pppf_sa_stage_kernel<<<static_cast<unsigned>(blocks), kThreads, bytes,
                         static_cast<cudaStream_t>(stream)>>>(st);
  return static_cast<int>(cudaGetLastError());
}
