// A bf16 reduction as XLA computes it: the sum of a bf16 cotangent over its
// rows, every add rounded to bf16, in the order of XLA's CPU backend.
//
// Replaces no TPU kernel. pcc_tpu's bf16 train step takes the gradient of
// flax's Dense(dtype=bfloat16) bias, and of a bf16 feature tiled over
// points, as a reduce_sum of a bf16 array: an HLO reduction whose adder
// rounds every partial sum to bf16. The order of those adds decides the
// result (a sum of 512 rows moves by several percent between two orders),
// so the port takes XLA's (ops/bf16.py::bf16_reduce_plain is the plain
// version and states it): the rows are a grid of up to three dimensions
// [A, M, K] (the reduced dimensions; a PN++ stage's [B, S, nsample]); where
// a dimension exceeds 32, XLA cuts it into windows of 32 (a dimension of at
// most 32 whole), padding it with zeros at both ends equally, and sums each
// window in row-major order from 0; the windows' sums are then reduced the
// same way (a level each), and a grid of at most 32 rows a dimension is
// summed whole.
//
// What bounds it on an H100: the chain of dependent adds of a window (up to
// 32^3 rows, a rounded add's latency each), the latency of the loads that
// feed it, the bytes of the cotangent (read once) for the large calls, and
// the launch itself: a bf16 train step makes 14 such calls (IPDAE), most of
// them short. So one launch computes every level of a call, and no rounding
// or copy pass runs before it: the first level reads the cotangent through
// its strides (a permuted view as it is) and rounds each value to bf16 as it
// stages it. A block owns one first-level window of a tile of 32 columns:
// its threads load the window's rows, 256 at a time (a lane a column, so
// each load is one coalesced row, all of a thread's loads issued before any
// is used), into shared memory as bf16, the next 256 while warp 0 walks the
// current ones in order; the walk adds in bf16 arithmetic (__hadd, about 4
// cycles a step on an H100 against 28 for a float32 add and a conversion:
// the same bits, window_sum says why). The last block of a column tile to
// finish (an integer ticket a tile, no float atomics) reduces the upper
// levels of its columns in the same way from the first level's sums in
// device memory, and resets its ticket for the next call; which block takes
// the upper levels does not change their order, so two launches give equal
// outputs. Calls that share the tickets run in stream order (one stream per
// device).
//
// Why the bf16 add is the plain version's float32 add rounded to bf16: two
// bf16 values (8 significant bits each) less than 16 binary places apart
// have an exact sum of at most 24 bits, which float32 holds, so the float32
// add is exact and one rounding remains; farther apart, the smaller is below
// 2^-16 of the larger, and the float32 rounding of their sum cannot reach a
// bf16 midpoint of the larger. Either way the result is the exact sum
// rounded once to nearest even, which is what the bf16 add computes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 32;                   // columns a block: a warp's lanes
constexpr int kMaxLevels = 8;               // 32^8 rows a dimension: past any int index
constexpr int kPlanInts = 12;               // d, w, p, n of the three dimensions, a level

// Each level's input grid d (dimensions), its windows w, the zeros p padded
// before each dimension and the windows n a dimension; off[l] the scratch
// offset (floats) of level l's sums, [n0, n1, n2, C] row-major.
struct Levels {
  int nlev;
  int d[kMaxLevels][3], w[kMaxLevels][3], p[kMaxLevels][3], n[kMaxLevels][3];
  long long off[kMaxLevels];
};

// Where a level reads its rows: row (a, m, k) of column c at base + a * s[0]
// + m * s[1] + k * s[2] + (c / c0) * sc1 + (c % c0) * sc0. The first level
// reads the cotangent through its strides, the upper ones their scratch.
struct Source {
  const float* base;
  long long s[3];
  int c0;
  long long sc1, sc0;
};

constexpr int kChunk = kThreads;            // window rows staged at a time
constexpr int kRowsEach = kChunk * kCols / kThreads;  // rows a thread loads a chunk
constexpr int kWarps = kThreads / kCols;

// The rounded sum of window (x0, x1, x2) of level l over the block's 32
// columns c0 + lane (c < C), every add rounded to bf16, the window's rows in
// row-major order from 0, zeros outside the grid; warp 0's lanes return
// their columns'. The block stages the rows in shared memory as bf16,
// kChunk rows at a time, double-buffered: each thread issues its kRowsEach
// loads of the next chunk (lane = column, so each load is one coalesced
// row; every load before any use, from a valid address) while warp 0 sums
// the current chunk in bf16 arithmetic (the header says why that is the
// plain version's rounded float32 add). kFirst: the cotangent, through the
// read-only cache, rounded to bf16 as it is staged; else a level's sums (bf16
// values already), from L2 (other blocks wrote them). Starts and ends with
// the block's threads in step (barriers inside).
template <bool kFirst>
__device__ __forceinline__ float window_sum(const Source& src, const Levels& lv, int l, int x0,
                                            int x1, int x2, int c0, int C,
                                            __nv_bfloat16 (*stage)[kChunk][kCols]) {
  const int wa = lv.w[l][0], wm = lv.w[l][1], wk = lv.w[l][2];
  const int rows = wa * wm * wk;
  const int a0 = x0 * wa - lv.p[l][0], m0 = x1 * wm - lv.p[l][1], k0 = x2 * wk - lv.p[l][2];
  const int da = lv.d[l][0], dm = lv.d[l][1], dk = lv.d[l][2];
  const int lane = threadIdx.x % kCols, r0 = threadIdx.x / kCols;
  const int c = c0 + lane;
  const float* col =
      src.base + (c < C ? (c / src.c0) * src.sc1 + (c % src.c0) * src.sc0 : 0);
  // this thread's rows are r0, r0 + kWarps, ...: (ia, im, ik) the next one
  int ia = r0 / (wm * wk), im = (r0 / wk) % wm, ik = r0 % wk;
  float v[kRowsEach];
  unsigned held = 0u;                         // bit i: v[i] is a row's value
  auto load = [&](int t0) {
    held = 0u;
#pragma unroll
    for (int i = 0; i < kRowsEach; ++i) {
      const int a = a0 + ia, m = m0 + im, k = k0 + ik;
      const bool in = c < C && t0 + r0 + kWarps * i < rows && a >= 0 && a < da && m >= 0 &&
                      m < dm && k >= 0 && k < dk;
      const float* q = in ? col + a * src.s[0] + m * src.s[1] + k * src.s[2] : src.base;
      v[i] = kFirst ? __ldg(q) : __ldcg(q);
      held |= static_cast<unsigned>(in) << i;
      ik += kWarps;
      while (ik >= wk) {
        ik -= wk;
        if (++im == wm) {
          im = 0;
          ++ia;
        }
      }
    }
  };
  auto store = [&](__nv_bfloat16 (*buf)[kCols]) {
#pragma unroll
    for (int i = 0; i < kRowsEach; ++i)
      buf[r0 + kWarps * i][lane] = __float2bfloat16_rn((held >> i) & 1u ? v[i] : 0.0f);
  };
  load(0);
  store(stage[0]);
  __syncthreads();
  __nv_bfloat16 acc = __float2bfloat16_rn(0.0f);
  for (int t0 = 0, b = 0; t0 < rows; t0 += kChunk, b ^= 1) {
    const bool more = t0 + kChunk < rows;
    if (more) load(t0 + kChunk);                   // in flight while warp 0 sums
    if (threadIdx.x < kCols) {
      const int n = min(kChunk, rows - t0);
      const __nv_bfloat16(*buf)[kCols] = stage[b];
      if (n == kChunk) {
#pragma unroll 32
        for (int t = 0; t < kChunk; ++t) acc = __hadd(acc, buf[t][lane]);
      } else {
#pragma unroll 8
        for (int t = 0; t < n; ++t) acc = __hadd(acc, buf[t][lane]);
      }
    }
    if (more) store(stage[b ^ 1]);
    __syncthreads();
  }
  return __bfloat162float(acc);
}

// window_sum for a window of few rows, by one warp alone (a lane a
// column): 32 rows at a time, each row's load issued before any is used,
// then their adds in order. The short first-level windows (at most 32 rows,
// a grid whose long dimension is cut in 32s: [1, 512] -> 16 windows) come
// in thousands of column tiles, which a warp each serves better than a
// block each.
template <bool kFirst>
__device__ __forceinline__ float warp_window_sum(const Source& src, const Levels& lv, int l,
                                                 int x0, int x1, int x2, int c, int C) {
  const int wa = lv.w[l][0], wm = lv.w[l][1], wk = lv.w[l][2];
  const int rows = wa * wm * wk;
  const int a0 = x0 * wa - lv.p[l][0], m0 = x1 * wm - lv.p[l][1], k0 = x2 * wk - lv.p[l][2];
  const int da = lv.d[l][0], dm = lv.d[l][1], dk = lv.d[l][2];
  const float* col =
      src.base + (c < C ? (c / src.c0) * src.sc1 + (c % src.c0) * src.sc0 : 0);
  int ia = 0, im = 0, ik = 0;
  __nv_bfloat16 acc = __float2bfloat16_rn(0.0f);
  for (int t0 = 0; t0 < rows; t0 += kCols) {
    float v[kCols];
    unsigned held = 0u;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int a = a0 + ia, m = m0 + im, k = k0 + ik;
      const bool in = c < C && t0 + j < rows && a >= 0 && a < da && m >= 0 && m < dm &&
                      k >= 0 && k < dk;
      const float* q = in ? col + a * src.s[0] + m * src.s[1] + k * src.s[2] : src.base;
      v[j] = kFirst ? __ldg(q) : __ldcg(q);
      held |= static_cast<unsigned>(in) << j;
      if (++ik == wk) {
        ik = 0;
        if (++im == wm) {
          im = 0;
          ++ia;
        }
      }
    }
    __nv_bfloat16 x[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) x[j] = __float2bfloat16_rn((held >> j) & 1u ? v[j] : 0.0f);
    const int n = min(kCols, rows - t0);
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if (j < n) acc = __hadd(acc, x[j]);
  }
  return __bfloat162float(acc);
}

// One call of the reduction. kWarpItems: a warp a (window, column tile),
// for first-level windows of at most 32 rows (warp_window_sum); else a
// block each (window_sum). The last warp or block of a column tile to
// finish takes its upper levels, in the same form.
template <bool kWarpItems>
__global__ void __launch_bounds__(kThreads)
bf16_reduce_kernel(const __grid_constant__ Source in, const __grid_constant__ Levels lv,
                   int C, float* __restrict__ scratch, float* __restrict__ out,
                   unsigned* __restrict__ tickets, long long items) {
  __shared__ __nv_bfloat16 stage[kWarpItems ? 1 : 2][kWarpItems ? 1 : kChunk][kCols];
  __shared__ bool last;
  const int lane = threadIdx.x % kCols;
  const long long item = kWarpItems
      ? static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / kCols : blockIdx.x;
  if (kWarpItems && item >= items) return;        // a whole warp
  const bool out_lane = kWarpItems || threadIdx.x < kCols;
  const int tiles = (C + kCols - 1) / kCols;
  const int tile = static_cast<int>(item % tiles), c0 = tile * kCols, c = c0 + lane;
  const long long wdx = item / tiles;             // the first level's window
  const int x2 = static_cast<int>(wdx % lv.n[0][2]),
            x1 = static_cast<int>((wdx / lv.n[0][2]) % lv.n[0][1]),
            x0 = static_cast<int>(wdx / (static_cast<long long>(lv.n[0][2]) * lv.n[0][1]));
  auto sum = [&](const Source& src, int l, int y0, int y1, int y2, bool first) {
    if constexpr (kWarpItems) {
      return first ? warp_window_sum<true>(src, lv, l, y0, y1, y2, c, C)
                   : warp_window_sum<false>(src, lv, l, y0, y1, y2, c, C);
    } else {
      return first ? window_sum<true>(src, lv, l, y0, y1, y2, c0, C, stage)
                   : window_sum<false>(src, lv, l, y0, y1, y2, c0, C, stage);
    }
  };
  const float v = sum(in, 0, x0, x1, x2, true);
  if (out_lane && c < C) (lv.nlev == 1 ? out : scratch + lv.off[0])[wdx * C + c] = v;
  if (lv.nlev == 1) return;
  // the last warp or block of the column tile takes its upper levels
  __threadfence();
  const unsigned windows = lv.n[0][0] * lv.n[0][1] * lv.n[0][2];
  bool mine;
  if constexpr (kWarpItems) {
    __syncwarp();
    unsigned t = 0;
    if (lane == 0) t = atomicAdd(tickets + tile, 1u) == windows - 1;
    mine = __shfl_sync(0xffffffffu, t, 0) != 0u;
  } else {
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(tickets + tile, 1u) == windows - 1;
    __syncthreads();
    mine = last;
  }
  if (!mine) return;
  __threadfence();
  for (int l = 1; l < lv.nlev; ++l) {
    const Source src{scratch + lv.off[l - 1],
                     {static_cast<long long>(lv.d[l][1]) * lv.d[l][2] * C,
                      static_cast<long long>(lv.d[l][2]) * C, C},
                     C, 0, 1};
    float* dst = l == lv.nlev - 1 ? out : scratch + lv.off[l];
    const int nw = lv.n[l][0] * lv.n[l][1] * lv.n[l][2];
    for (int w = 0; w < nw; ++w) {
      const float s = sum(src, l, w / (lv.n[l][2] * lv.n[l][1]), (w / lv.n[l][2]) % lv.n[l][1],
                          w % lv.n[l][2], false);
      if (out_lane && c < C) dst[static_cast<long long>(w) * C + c] = s;
    }
    if constexpr (kWarpItems) {
      __syncwarp();
    } else {
      __threadfence_block();
      __syncthreads();
    }
  }
  if (kWarpItems ? lane == 0 : threadIdx.x == 0) tickets[tile] = 0u;
}

}  // namespace

// The whole reduction of one call (ops/bf16.py::bf16_reduce plans it).
// g: the cotangent, float32 (not rounded: each value is rounded as it is
// loaded), row (a, m, k) of column c at g + a * sa + m * sm + k * sk + (c /
// c0) * sc1 + (c % c0) * sc0, C = c1 * c0 columns. plan: host ints, the
// level count then per level the grid d[3], windows w[3], pads p[3] and
// window counts n[3] (level l + 1's grid is level l's n). out: [C] f32;
// scratch: every level's sums but the last's, [n0, n1, n2, C] each in turn;
// tickets: one unsigned a tile of 32 columns, 0 between calls (the kernel
// leaves them so). Returns a cudaError_t value.
extern "C" int bf16_reduce_launch(const float* g, float* out, float* scratch, unsigned* tickets,
                                  const int* plan, long long sa, long long sm, long long sk,
                                  int c1, int c0, long long sc1, long long sc0, void* stream) {
  Levels lv;
  lv.nlev = plan[0];
  if (lv.nlev <= 0 || lv.nlev > kMaxLevels || c1 <= 0 || c0 <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int C = c1 * c0;
  long long off = 0;
  for (int l = 0; l < lv.nlev; ++l) {
    const int* q = plan + 1 + kPlanInts * l;
    for (int t = 0; t < 3; ++t) {
      lv.d[l][t] = q[t];
      lv.w[l][t] = q[3 + t];
      lv.p[l][t] = q[6 + t];
      lv.n[l][t] = q[9 + t];
      if (lv.d[l][t] <= 0 || lv.w[l][t] <= 0 || lv.w[l][t] > 32 || lv.p[l][t] < 0 ||
          lv.n[l][t] <= 0 || (l > 0 && lv.d[l][t] != lv.n[l - 1][t]))
        return static_cast<int>(cudaErrorInvalidValue);
    }
    lv.off[l] = off;
    off += static_cast<long long>(lv.n[l][0]) * lv.n[l][1] * lv.n[l][2] * C;
  }
  const long long items = static_cast<long long>(lv.n[0][0]) * lv.n[0][1] * lv.n[0][2] *
                          ((C + kCols - 1) / kCols);
  const bool warp_items = lv.w[0][0] * lv.w[0][1] * lv.w[0][2] <= kCols;
  const long long blocks = warp_items ? (items + kWarps - 1) / kWarps : items;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const Source in{g, {sa, sm, sk}, c0, sc1, sc0};
  if (warp_items) {
    bf16_reduce_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(in, lv, C, scratch, out,
                                                                    tickets, items);
  } else {
    bf16_reduce_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(in, lv, C, scratch, out,
                                                                     tickets, items);
  }
  return static_cast<int>(cudaGetLastError());
}
