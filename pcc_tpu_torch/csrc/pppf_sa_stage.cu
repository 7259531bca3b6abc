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
// agree to float32 rounding. The selection, the mask and the layer product
// live in pppf_sa_common.cuh, which the backward kernel shares.

#include <cuda_runtime.h>

#include "pppf_sa_common.cuh"

namespace {

using namespace pcc_sa;

// Blocks meant to share an SM: the registers allow two, and a tile is sized
// so that two fit in the SM's shared memory too (32 rows at the widest
// stage, 259 -> 256 -> 256 -> 512 -> 1024 with nsample 128, against one
// block of 64 rows). Two blocks per SM and 8 rows per thread won on the sum
// of the three PPPF-AE stages on an H100; 16 rows per thread was faster at
// the widest stage alone and slower at the other two.
constexpr int kMinBlocks = 2;

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

  load_queries(st.new_xyz + (static_cast<size_t>(p) * st.s + q0) * 3, nq, sq);
  for (int e = tid; e < nq * cout; e += kThreads) qmax[e] = 0;
  __syncthreads();
  select_slots(pts, sq, nq, n, st.nsample, !st.pppe, false, st.r2, dist, sel);

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
        dense_layer<kQueryMax>(src, ld_src, st.rows, st.width[l], st.w[l], st.b[l], st.mu[l],
                               st.mul[l], st.beta[l], st.width[l + 1], dst, ld_dst, qmax, row0,
                               rows_total, st.nsample, GlobalRows{});
      } else {
        dense_layer<kStore>(src, ld_src, st.rows, st.width[l], st.w[l], st.b[l], st.mu[l],
                            st.mul[l], st.beta[l], st.width[l + 1], dst, ld_dst, qmax, row0,
                            rows_total, st.nsample, GlobalRows{});
      }
      __syncthreads();
    }
  }
  float* o = st.out + (static_cast<size_t>(p) * st.s + q0) * cout;
  for (int e = tid; e < nq * cout; e += kThreads) o[e] = __int_as_float(qmax[e]);
}

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
