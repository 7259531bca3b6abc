// Row-tile products on the H100's tensor cores in 3xTF32 (tf32_mma.cuh; one
// TF32 product on bf16 values),
// from operands in shared memory, for the stage kernel's "pppe" layout
// (pppf_sa_stage.cu); and the max over an accumulator's rows, which
// SetAbstraction alone (sa_fused.cu) shares.
//
// A warp owns a 32-row x 8*NT-column block of the output: 2 m16 tiles x NT
// n8 tiles of mma.sync m16n8k8, 8 * NT accumulators a thread. A is [row][k]
// row-major with a row stride of 4 mod 8 floats (a_ld), so that a
// fragment's 32 lanes (8 rows x 4 columns) fall in 32 banks; B is [k][col]
// row-major with a row stride of 8 mod 16 (b_ld), for the same reason
// (4 rows x 8 columns). Every sum runs over k in a fixed order, so a launch
// is bitwise repeatable.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"
#include "tf32_mma.cuh"

namespace pcc_tile {

using pcc_mma::mma_3xtf32;
using pcc_mma::split_tf32;

__host__ __device__ inline int pad8(int v) { return (v + 7) & ~7; }
// row strides of A and B operand buffers holding `width` columns (zero-padded to 8)
__host__ __device__ inline int a_ld(int width) { return pad8(width) + 4; }
__host__ __device__ inline int b_ld(int width) { return ((width + 15) & ~15) + 8; }

// 4-byte asynchronous copy global -> shared; src_bytes = 0 writes a zero.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

// Starts copying the tile dst[i][j] = src[i][j] (row strides ldd, lds) for
// i < rows, j < cols (cols % 4 == 0), zeros where i >= vrows or j >= vcols.
// 16-byte copies where every row of src is 16-byte aligned (vec), else 4.
// The caller commits and waits (tf32_mma.cuh::cp_async_commit / _wait).
template <int kThreadsT>
__device__ __forceinline__ void load_tile_async(float* dst, int ldd, const float* src, int lds,
                                                int rows, int cols, int vrows, int vcols,
                                                bool vec) {
  if (vec) {
    const int per_row = cols >> 2;
    for (int e = threadIdx.x; e < rows * per_row; e += kThreadsT) {
      const int i = e / per_row, j = (e % per_row) << 2;
      const bool ok = i < vrows && j < vcols;
      pcc_mma::cp_async16(dst + i * ldd + j, ok ? src + static_cast<size_t>(i) * lds + j : src,
                          ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += kThreadsT) {
      const int i = e / cols, j = e % cols;
      const bool ok = i < vrows && j < vcols;
      cp_async4(dst + i * ldd + j, ok ? src + static_cast<size_t>(i) * lds + j : src,
                ok ? 4 : 0);
    }
  }
}

__device__ __forceinline__ bool aligned16(const float* p, int ld) {
  return (ld & 3) == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// A's fragments of the warp's two m16 tiles at column kk, split hi / lo.
__device__ __forceinline__ void load_a(const float* a, int lda, int kk, unsigned (&ah)[2][4],
                                       unsigned (&al)[2][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const float* p = a + (mt * 16 + g) * lda + kk + t;
    split_tf32(p[0], ah[mt][0], al[mt][0]);
    split_tf32(p[8 * lda], ah[mt][1], al[mt][1]);
    split_tf32(p[4], ah[mt][2], al[mt][2]);
    split_tf32(p[8 * lda + 4], ah[mt][3], al[mt][3]);
  }
}

// acc += A[0 .. 32)[0 .. 8 * ksteps) * B[0 .. 8 * ksteps)[0 .. 8 * NT): a at
// the warp's first row and the first k, b (float32) at the first k and the
// warp's first column; B is split per fragment. Each row warp splits the
// weights it reads again (an AND and a subtraction a value), which costs less
// than the alternative: splitting a k-slab once into hi and lo buffers takes
// a second shared load a value, a pass and a barrier a slab and a third slab
// buffer, and measured 20-28% slower on the "pppe" stage at PPPE's shapes on
// an H100 (tools/stage_breakdown.py, variant splitonce).
//
// kBf16 (the bf16 instances): A rounded to bf16 as the warp reads it (a
// no-op on activations that are bf16 values already) and B bf16 values (the
// wrapper rounds the weights). A bf16 value is a TF32 value and the product
// of two is exact, so one TF32 product a k-step gives the sum of the exact
// products, where float32 operands take three.
template <int NT, bool kBf16 = false>
__device__ __forceinline__ void warp_mma(float (&acc)[2][NT][4], const float* a, int lda,
                                         const float* b, int ldb, int ksteps) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (kBf16) {
    for (int ks = 0; ks < ksteps; ++ks) {
      const int kk = ks * 8;
      unsigned ar[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* p = a + (mt * 16 + g) * lda + kk + t;
        ar[mt][0] = __float_as_uint(pcc_bf16::round_bf16(p[0]));
        ar[mt][1] = __float_as_uint(pcc_bf16::round_bf16(p[8 * lda]));
        ar[mt][2] = __float_as_uint(pcc_bf16::round_bf16(p[4]));
        ar[mt][3] = __float_as_uint(pcc_bf16::round_bf16(p[8 * lda + 4]));
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* q = b + (kk + t) * ldb + nt * 8 + g;
        const unsigned br[2] = {__float_as_uint(q[0]), __float_as_uint(q[4 * ldb])};
        pcc_mma::mma_tf32(acc[0][nt], ar[0], br);
        pcc_mma::mma_tf32(acc[1][nt], ar[1], br);
      }
    }
    return;
  }
  for (int ks = 0; ks < ksteps; ++ks) {
    const int kk = ks * 8;
    unsigned ah[2][4], al[2][4];
    load_a(a, lda, kk, ah, al);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* q = b + (kk + t) * ldb + nt * 8 + g;
      unsigned bh[2], bl[2];
      split_tf32(q[0], bh[0], bl[0]);
      split_tf32(q[4 * ldb], bh[1], bl[1]);
      mma_3xtf32(acc[0][nt], ah[0], al[0], bh, bl);
      mma_3xtf32(acc[1][nt], ah[1], al[1], bh, bl);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[2][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] =
        acc[mt][nt][3] = 0.0f;
}

// The max over the 8 row groups g (lanes 4g + t) of every v[nt][i], the
// columns 8 nt + 2t + i of 8 n8 tiles (mma.sync's and wgmma's accumulator
// layout), scattered: the lanes of row group g return n tile g's two
// maxima. Three butterfly rounds that each halve the tiles a lane keeps:
// 14 shuffles, where a butterfly on every column would take 48.
__device__ __forceinline__ float2 max_over_rows_scattered(const float (&v)[8][2]) {
  const int g = (threadIdx.x & 31) >> 2;
  float a[4][2], b[2][2], c[2];
  const bool g4 = g & 4, g2 = g & 2, g1 = g & 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 2; ++k)
      a[i][k] = fmaxf(g4 ? v[i + 4][k] : v[i][k],
                      __shfl_xor_sync(0xffffffffu, g4 ? v[i][k] : v[i + 4][k], 16));
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int k = 0; k < 2; ++k)
      b[i][k] = fmaxf(g2 ? a[i + 2][k] : a[i][k],
                      __shfl_xor_sync(0xffffffffu, g2 ? a[i][k] : a[i + 2][k], 8));
#pragma unroll
  for (int k = 0; k < 2; ++k)
    c[k] = fmaxf(g1 ? b[1][k] : b[0][k],
                 __shfl_xor_sync(0xffffffffu, g1 ? b[0][k] : b[1][k], 4));
  return make_float2(c[0], c[1]);
}

}  // namespace pcc_tile
