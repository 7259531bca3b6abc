// Certified rounding: a layer's products on the bf16 tensor cores whose
// rounded outputs are, bit for bit, those of the float32 k-order sums that
// the CUDA-core kernels compute (acc = fma(a[k], w[k], acc) for k = 0, 1,
// ... from 0, products of bf16 values exact). Shared by the bf16 patch
// encoder (patch_encoder.cu, enc16) and the bf16 "pppf" stage
// (pppf_sa_stage.cu, st16).
//
// Why it holds. Each output a layer rounds is f(s), s the float32 sum of
// its K products in k-order, f a chain of float32 operations each monotone
// in s: the encoder's round_bf16(relu(s + b)) (and, for SetAbstraction's
// last layer, the max over a query's rows before them), the stage's
// round_bf16(relu(fma((s + b) - mean, mul, beta))), which is monotone for
// either sign of mul (a decreasing step keeps the chain monotone). If
// |s_tc - s_k| <= E for the tensor cores' sum s_tc, then f(s_k) lies
// between f(s_tc - E) and f(s_tc + E); where those two are equal (bit for
// bit), that is f(s_k). Where they differ, the entry is flagged, and the
// kernel recomputes it on the CUDA cores in k-order (cert_kdot) before any
// later step reads the layer's output.
//
// The bound E. u = 2^-24; the K products in blocks b of 16 (the k16
// steps), A_b = sum of |a_k w_k| over block b, A = sum_b A_b, S_b the exact
// sum of the blocks before b (S_0 = 0).
// - The k-order float32 sum rounds to nearest after each of the K
//   products; each rounding errs by at most u times the partial sum it
//   rounds, and a partial sum inside block b is at most |S_b| + A_b (plus
//   the error so far, a factor 1 + 2^-10 for K <= 1024). So |s_k - S| <=
//   16 u (sum_b |S_b| + A) (1 + 2^-10) + K 2^-150 (a rounding in the
//   subnormal range), S the exact sum.
// - The tensor cores' sum, modelled as truncation at every addition (u' =
//   2u, Hopper's bf16 mma accumulation is not IEEE round to nearest), obeys
//   the same bound with u': 32 u (sum_b |S_b| + A). In the model that aligns
//   a k16 block's 16 products and the accumulator to the largest exponent
//   and truncates each (Fasi et al.'s for earlier tensor cores), the 16
//   truncated terms and the block's normalisation err by at most 17 u' of
//   the block's largest magnitude, at most |S_b| + A_b: 34 u (sum_b |S_b| +
//   A). Products below 2^-126 may be flushed to zero: at most K 2^-100 for
//   factors below 2^26.
// - The kernel knows neither S_b nor A exactly: it accumulates, in the
//   register of a second tensor-core product on |a| x |w| (sign bits
//   cleared in the fragments, no extra memory), A and, after each k16 step
//   but the last, |acc|, the tensor cores' partial sum, which is within the
//   error above of S_b. That register (R) errs low by at most a factor 1 -
//   2^-10 (truncation and K / 16 roundings) for K <= 1024.
// Together E = c R + a_K with c = 50 u (1 + 2^-8) and a_K = (2 K + 2)
// 2^-100, formed with round up (__fmaf_ru), and the two ends with __fsub_rd
// / __fadd_ru. K is the layer's true depth (padding adds zero products).
// Bounding by the partial sums instead of K u A (a linear-in-K bound)
// flags about a fifth as many entries at the encoder's K = 256 layer
// (ops/certified.py's twin measures both); the second product doubles the
// tensor cores' work.
//
// The flagged entries go into a queue of the warp's own in shared memory
// (kQueue entries, appended in lane order); whenever 32 are queued the
// warp recomputes them, a lane each, so a round of the long k-order sums
// keeps every lane busy. What is left when a layer's items are done is
// recomputed by the whole block after a barrier, its threads taking the
// warps' queues in order (cert_layer), or by the warp itself where it owns
// its rows (cert_tile with drain). A recomputed entry reads the layer's
// input row, still in shared memory (a layer never overwrites its input),
// and the weight column; it depends only on its row and column, so the
// result is deterministic.
//
// Tiles are bf16 in shared memory, rows of ld = Kp + 8 values (Kp the
// depth padded to 16 with zeros): 16-byte rows whose 8 row addresses of an
// ldmatrix phase fall in distinct banks. Weights are packed by the wrapper
// (ops/certified.py::pack_frags) in mma.sync's B fragment order: uint2
// frag[(j * ks + s) * 32 + lane] = {b0, b1} of n8 tile j, k16 step s,
// b0 = {W[16 s + 2 t][8 j + g], W[16 s + 2 t + 1][8 j + g]}, b1 the same
// at k + 8 (g = lane / 4, t = lane % 4, the lower k in the lower 16 bits),
// zeros past K and past the layer's width: one coalesced 8-byte load a
// lane, and a column's 16 values of a k16 step are 32 contiguous bytes
// (lanes 4 g .. 4 g + 3), which cert_kdot reads.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace pcc_cert {

// Counting build (PCC_CERT_COUNT 1 before the include: the breakdown
// tool's variant, tools/cert_breakdown.py): every tile adds its flagged
// entries and its entries to cert_counts[2 * tag], [2 * tag + 1]. Off in
// the kernels the paths run.
#ifndef PCC_CERT_COUNT
#define PCC_CERT_COUNT 0
#endif
constexpr bool kCount = PCC_CERT_COUNT != 0;
// Timing builds of the same tool, wrong outputs: PCC_CERT_NOFIX 1 skips
// the fix-ups, PCC_CERT_NOABS 1 the second product (E then covers nothing).
#ifndef PCC_CERT_NOFIX
#define PCC_CERT_NOFIX 0
#endif
#ifndef PCC_CERT_NOABS
#define PCC_CERT_NOABS 0
#endif
__device__ unsigned long long cert_counts[64];

__device__ __forceinline__ void cert_count(int tag, unsigned flagged, unsigned entries) {
  if (kCount) {
    atomicAdd(&cert_counts[2 * tag], static_cast<unsigned long long>(flagged));
    atomicAdd(&cert_counts[2 * tag + 1], static_cast<unsigned long long>(entries));
  }
}

__device__ __forceinline__ float bf16_lo(unsigned x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16_hi(unsigned x) { return __uint_as_float(x & 0xffff0000u); }
__device__ __forceinline__ float bf16_val(unsigned short x) {
  return __uint_as_float(static_cast<unsigned>(x) << 16);
}
// the bits of a bf16-exact float32 value
__device__ __forceinline__ unsigned short bf16_bits(float v) {
  return static_cast<unsigned short>(__float_as_uint(v) >> 16);
}

// c and a_K of the header note, rounded up
constexpr float kCertC = 0x1.9p-19f * 0x1.01p0f;   // 50 u (1 + 2^-8), exact in float32
__device__ __forceinline__ float cert_a(int k) {
  return __fmul_ru(static_cast<float>(2 * k + 2), 0x1p-100f);
}
// E of a sum from its R register
__device__ __forceinline__ float cert_err(float r, float ak) { return __fmaf_ru(r, kCertC, ak); }

// a weight load: read-only cache from device memory, or shared memory
template <bool kShared, class T>
__device__ __forceinline__ T load_w(const T* p) {
  if constexpr (kShared) {
    return *p;
  } else {
    return __ldg(p);
  }
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a * b, m16n8k16, bf16 operands, float32 accumulator
__device__ __forceinline__ void mma16816(float* d, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The k-order sum of one row (bf16, Kp = 16 ks values) and one packed
// column n: acc = fma(a[k], w[k][n], acc) from k = 0. The loop is unrolled
// 4 deep so that 4 steps' weight loads are in flight together.
template <bool kSharedW>
__device__ __forceinline__ float cert_kdot(const unsigned short* row,
                                           const uint2* __restrict__ frag, int ks, int n) {
  const uint2* col = frag + static_cast<size_t>(n >> 3) * ks * 32 + 4 * (n & 7);
  float acc = 0.0f;
#pragma unroll 4
  for (int s = 0; s < ks; ++s) {
    const uint4 a0 = *reinterpret_cast<const uint4*>(row + 16 * s);
    const uint4 a1 = *reinterpret_cast<const uint4*>(row + 16 * s + 8);
    const uint4 w0 = load_w<kSharedW>(reinterpret_cast<const uint4*>(col + 32 * s));
    const uint4 w1 = load_w<kSharedW>(reinterpret_cast<const uint4*>(col + 32 * s + 2));
    // pair p (k = 2 p, 2 p + 1) of the column: w0.x, w0.z, w1.x, w1.z,
    // w0.y, w0.w, w1.y, w1.w (the lanes' b0, b1 order)
    const unsigned a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const unsigned w[8] = {w0.x, w0.z, w1.x, w1.z, w0.y, w0.w, w1.y, w1.w};
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      acc = fmaf(bf16_lo(a[p]), bf16_lo(w[p]), acc);
      acc = fmaf(bf16_hi(a[p]), bf16_hi(w[p]), acc);
    }
  }
  return acc;
}

// The products of a warp's MT m16 tiles (rows r0 ..) and NT n8 tiles
// (tiles j0 ..) of a layer, over its ks k16 steps: s[m][n][e] the sums,
// r[m][n][e] their R registers (the sums of |a| |w| and, before each step
// but the first, |s|). The next step's weights are loaded ahead.
template <int MT, int NT, bool kSharedW>
__device__ __forceinline__ void cert_mma(const unsigned short* in, int ldi, int r0,
                                         const uint2* __restrict__ frag, int ks, int j0,
                                         float (&s)[MT][NT][4], float (&r)[MT][NT][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[m][n][e] = r[m][n][e] = 0.0f;
  const unsigned short* arow = in + (r0 + (lane & 15)) * ldi + (lane >> 4) * 8;
  uint2 next[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n) next[n] = load_w<kSharedW>(frag + (j0 + n) * ks * 32 + lane);
#pragma unroll 1
  for (int k = 0; k < ks; ++k) {
    uint2 w[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      w[n] = next[n];
      if (k + 1 < ks) next[n] = load_w<kSharedW>(frag + ((j0 + n) * ks + k + 1) * 32 + lane);
    }
    unsigned a[MT][4], aa[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      ldmatrix_x4(a[m], arow + 16 * m * ldi + 16 * k);
#pragma unroll
      for (int e = 0; e < 4; ++e) aa[m][e] = a[m][e] & 0x7fff7fffu;
    }
    if (k > 0 && !PCC_CERT_NOABS) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) r[m][n][e] += fabsf(s[m][n][e]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const unsigned w0 = w[n].x & 0x7fff7fffu, w1 = w[n].y & 0x7fff7fffu;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma16816(s[m][n], a[m], w[n].x, w[n].y);
        if (!PCC_CERT_NOABS) mma16816(r[m][n], aa[m], w0, w1);
      }
    }
  }
}

constexpr int kQueue = 64;   // entries of a warp's fix-up queue

// A layer's fix-up: entry (r, c) of its output, recomputed in k-order
// from row r of the input and column c of the packed weights.
template <bool kSharedW, class F>
struct Fixup {
  const unsigned short* in;
  int ldi;
  const uint2* frag;
  int ks, c0;
  unsigned short* out;
  int ldo;
  F f;
  __device__ __forceinline__ void operator()(int rc) const {
    const int r = rc >> 16, c = rc & 0xffff;
    out[r * ldo + (c - c0)] = bf16_bits(f(cert_kdot<kSharedW>(in + r * ldi, frag, ks, c), c));
  }
};

// Append each lane's flagged entries (bit i of `flagged` -> rc(i)) to the
// warp's queue (q, n: the warp's count, uniform), and recompute 32 at a
// time whenever that many are queued.
template <class Rc, class Fix>
__device__ __forceinline__ void cert_enqueue(unsigned flagged, const Rc& rc, int* q, int& n,
                                             const Fix& fix) {
  const int lane = threadIdx.x & 31;
  while (__any_sync(0xffffffffu, flagged != 0u)) {
    const bool have = flagged != 0u;
    int entry = 0;
    if (have) {
      entry = rc(__ffs(flagged) - 1);
      flagged &= flagged - 1u;
    }
    const unsigned m = __ballot_sync(0xffffffffu, have);
    if (have) q[n + __popc(m & ((1u << lane) - 1u))] = entry;
    n += __popc(m);
    __syncwarp();
    if (n >= 32) {
      if (!PCC_CERT_NOFIX) fix(q[lane]);
      __syncwarp();
      if (lane < n - 32) q[lane] = q[32 + lane];
      n -= 32;
      __syncwarp();
    }
  }
}

// One warp item of a layer: out[r][c - c0] = f(sum_k in[r][k] w[k][c]) for
// the rows r0 .. r0 + 16 MT and the n8 tiles j0 .. j0 + NT, columns below
// cout (the others left as they are); f(s, c) the layer's epilogue on a
// k-order sum. MT * NT = 8: 32 entries a lane. Flagged entries go to the
// warp's queue (q, n); with `drain` the warp recomputes what is left of it
// at the end. k_depth the layer's depth (ks its k16 steps), tag the
// counting build's layer.
template <int MT, int NT, bool kSharedW, class F>
__device__ __forceinline__ void cert_tile(const unsigned short* in, int ldi, int r0,
                                          const uint2* __restrict__ frag, int ks, int k_depth,
                                          int j0, int c0, int cout, const F& f,
                                          unsigned short* out, int ldo, int tag, int* q, int& n,
                                          bool drain) {
  static_assert(MT * NT * 4 == 32, "32 entries a lane: one bit each");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float ak = cert_a(k_depth);
  float s[MT][NT][4], rr[MT][NT][4];
  cert_mma<MT, NT, kSharedW>(in, ldi, r0, frag, ks, j0, s, rr);
  unsigned flagged = 0u, entries = 0u;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * (j0 + nt) + 2 * t + (e & 1);
      if (c >= cout) continue;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int r = r0 + 16 * m + g + 8 * (e >> 1);
        const float err = cert_err(rr[m][nt][e], ak);
        const float lo = f(__fsub_rd(s[m][nt][e], err), c);
        const float hi = f(__fadd_ru(s[m][nt][e], err), c);
        if (__float_as_uint(lo) == __float_as_uint(hi)) {
          out[r * ldo + (c - c0)] = bf16_bits(lo);
        } else {
          flagged |= 1u << ((nt * 4 + e) * MT + m);
        }
        ++entries;
      }
    }
  cert_count(tag, __popc(flagged), entries);
  const Fixup<kSharedW, F> fix{in, ldi, frag, ks, c0, out, ldo, f};
  auto rc = [&](int i) {
    const int m = i % MT, e = (i / MT) % 4, nt = i / (4 * MT);
    return ((r0 + 16 * m + g + 8 * (e >> 1)) << 16) | (8 * (j0 + nt) + 2 * t + (e & 1));
  };
  cert_enqueue(flagged, rc, q, n, fix);
  if (drain) {
    if (lane < n && !PCC_CERT_NOFIX) fix(q[lane]);
    n = 0;
    __syncwarp();
  }
}

// A layer on a tile, the block's warps taking its items: the rows [0,
// rows) (a multiple of 16 MT) and the columns [c0, c0 + cols) (c0 and cols
// multiples of 8 NT), as cert_tile computes them; then, after a barrier,
// the entries left in the warps' queues (queues: kWarps * kQueue ints,
// counts: kWarps ints of shared memory), the block's threads taking them
// in the warps' order. No trailing barrier.
template <int MT, int NT, bool kSharedW, class F>
__device__ __forceinline__ void cert_layer(const unsigned short* in, int ldi, int rows,
                                           const uint2* __restrict__ frag, int ks, int k_depth,
                                           int c0, int cols, int cout, const F& f,
                                           unsigned short* out, int ldo, int tag, int* queues,
                                           int* counts) {
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int mi = rows / (16 * MT), ni = cols / (8 * NT);
  int* q = queues + warp * kQueue;
  int n = 0;
  for (int item = warp; item < mi * ni; item += warps)
    cert_tile<MT, NT, kSharedW>(in, ldi, (item % mi) * 16 * MT, frag, ks, k_depth,
                                c0 / 8 + (item / mi) * NT, c0, cout, f, out, ldo, tag, q, n,
                                false);
  if ((threadIdx.x & 31) == 0) counts[warp] = n;
  __syncthreads();
  int i = threadIdx.x;
  for (int w = 0; w < warps; ++w) {
    const int cw = counts[w];
    if (i < cw && !PCC_CERT_NOFIX)
      Fixup<kSharedW, F>{in, ldi, frag, ks, c0, out, ldo, f}(queues[w * kQueue + i]);
    i -= cw;
    if (i < 0) break;
  }
}

}  // namespace pcc_cert
