// SetAbstraction alone, one launch: a persistent grid whose blocks walk the
// patches, layers 2 and 3 as wgmma on the tensor cores.
//
// Replaces the TPU kernel pcc_tpu/ops/sa_pallas.py::_sa_kernel (entry
// sa_fused). Per [N, 3] patch: the expanded-form squared distances
// max((sq_i - 2 cross_ij) + sq_j, 0); the knn nearest neighbours of every
// point in ascending (distance, index) order; the centred neighbours
// through the MLP 3 -> 32 -> 64 -> 128 with relu; the max over the
// neighbours. Output: per-point features [P, N, 128] f32.
//
// The selection is the patch encoder's (encoder_common.cuh::load_patch's
// and select_knn's arithmetic, knn_of, bit for bit); layer 1 is the
// encoder's expression (encoder_common.cuh::sa_layer1). Layers 2 and 3 sum
// in another order than the encoder's: the encoder (patch_encoder.cu,
// dense.cuh) does not run this code.
//
// What bounds it on an H100: operations. 2 * knn * 10336 FLOP per point
// (85 MFLOP per patch of 256 points at knn = 16, about 347 GFLOP for 4096
// such patches, 98% of it layers 2 and 3) against 12 bytes in and 512 bytes
// out per point: about 650 operations per byte, above the card's balance.
// The float32 floor is FLOPs / 67 TFLOP/s (5.2 ms at [4096, 256, 3]); with
// layers 2 and 3 as 3xTF32 on the tensor cores (three TF32 products each,
// 495 TFLOP/s dense) and the rest in float32, about 2.2 ms.
// What the design does about it: layers 2 and 3 run as 3xTF32 wgmma
// (wgmma_tf32.cuh: A in registers, B in shared memory), which keeps about
// float32's accuracy; mma.sync reached about half the rate on these
// products. The 10,240 weights are split into TF32 hi and lo parts once per
// block and held in shared memory for the block's life (80 KB: W^T in
// 128-byte-swizzled K-major tiles, as wgmma reads B), and the grid is one
// block per SM, each walking the patches, so no row reads a weight from
// device memory. A block is two row warpgroups and one selector warpgroup.
// The selector warps load the next patch and select its neighbours
// (encoder_common.cuh::knn_of, a thread per query, on the CUDA cores)
// while the row warps run this patch's rows on the tensor cores (double
// buffers, one barrier a patch). A row warpgroup takes 64 grouped rows
// (64 / knn queries) at a time, and nothing of them touches shared memory:
// each lane computes layer 1 (on the CUDA cores) for the rows and columns
// of its A fragments of layer 2; layer 2's accumulators, + bias and relu,
// are the A fragments of layer 3 as they lie (columns 2t and 2t + 1 of an
// n8 tile taken as k = t and t + 4, with W3's rows permuted to match, as
// patch_decoder.cu does); layer 3's accumulators, + bias and relu, fold to
// the max over each query's knn rows by a butterfly of shuffles across the
// fragment's row groups that leaves each lane its own columns
// (mma_tile.cuh::max_over_rows_scattered; knn = 16: a warp's 16 rows are
// one query, knn = 8: its two halves are two), each query's features
// written with 16-byte stores.
//
// The bf16 instance (entry sa_fused_bf16_launch; pcc_tpu's compute_dtype
// bfloat16): the same kernel, templated on the rounding, every weight and
// bias rounded to bf16 as it is loaded, as _sa_kernel's `load` rounds them
// (a no-op on sa_cuda.py::bf16_wb's, which SetAbstraction keeps). The centred
// neighbours are rounded before layer 1 and every layer's relu output
// after it; products and the bias adds are float32 (a product of two bf16
// values is exact in float32), and the max runs over the rounded values
// (rounding is monotone: the rounded max). Layers 2 and 3 are one bf16
// wgmma a k = 16 step (wgmma_bf16.cuh) instead of three TF32 products a
// k = 8 step, and the weights take 24 KB of shared memory instead of 80:
// W^T as bf16 in 128-byte rows of 64 K values, 128-byte swizzled (W2's 32
// K values padded to 64). With k16 fragments, layer 2's accumulators
// rounded and packed in pairs (columns 2t, 2t + 1 of n8 tiles 2q and
// 2q + 1) are layer 3's A for the k-step q as they lie: W3's rows keep
// their order. What bounds it: operations, 3.2 GFLOP of layer 1, the
// selection and the max on the CUDA cores at 67 TFLOP/s and 344 GFLOP of
// layers 2 and 3 on the bf16 tensor cores at 989 at [4096, 256, 3], knn 16.

#include <cuda_runtime.h>

#include <cstdint>

#include "encoder_common.cuh"
#include "bf16.cuh"
#include "mma_tile.cuh"
#include "wgmma_bf16.cuh"
#include "wgmma_tf32.cuh"

namespace {

using namespace pcc;
using namespace pcc_wgmma;

constexpr int kRowWarps = 8;            // two warpgroups that run the rows
constexpr int kThreads = 32 * (kRowWarps + 4);
constexpr int kSelThreads = 128;        // the selector warpgroup
constexpr int kGroupRows = 64;          // a row warpgroup's rows at a time
constexpr int kTileK = 32;              // K floats a row of a B tile (128 bytes)
// B tiles (W^T, [N][32] K-major, 128-byte swizzle), float offsets from the
// 1024-byte-aligned start: W2 hi, lo (64 rows); W3 hi, lo (two K tiles of 128 rows each)
constexpr int kW2Tile = kEncC2 * kTileK;
constexpr int kW3Tile = kEncC3 * kTileK;
constexpr int kW2Hi = 0, kW2Lo = kW2Tile, kW3Hi = 2 * kW2Tile, kW3Lo = kW3Hi + 2 * kW3Tile;
constexpr int kWFloats = kW3Lo + 2 * kW3Tile;
// bf16 B tiles (W^T, [N][64] bf16 K-major, 128-byte swizzle), bf16 offsets:
// W2 (64 rows, K 32 of 64 used), W3 (128 rows)
constexpr int kTileKBf16 = 64;          // bf16 values a row of a B tile (128 bytes)
constexpr int kW2Bf16 = 0, kW3Bf16 = kEncC2 * kTileKBf16;
constexpr int kWFloatsBf16 = (kEncC2 + kEncC3) * kTileKBf16 / 2;
constexpr size_t kSmemLimit = 227 * 1024;

template <bool kBf16>
__host__ __device__ constexpr int w_floats() {
  return kBf16 ? kWFloatsBf16 : kWFloats;
}

// Shared memory: the tiles, two buffers of a patch's points (SoA) and
// squared norms, then two neighbour tables.
template <bool kBf16>
inline size_t smem_bytes(int n, int knn) {
  return 1024 + (w_floats<kBf16>() + 2 * 4 * static_cast<size_t>(n)) * sizeof(float) +
         2 * static_cast<size_t>(n) * knn * sizeof(unsigned short);
}

// The float index of (row r, k) in a 128-byte-swizzled tile of 32-float rows.
__device__ __forceinline__ int swizzled(int r, int k) {
  return r * kTileK + (((k >> 2) ^ (r & 7)) << 2) + (k & 3);
}

// The tiles of W2 [32][64] and W3 [64][128] (row-major in device memory),
// split hi / lo. W3's rows are permuted within each 8: its k-step s's A
// fragments are layer 2's n8 tile s, whose columns 2t and 2t + 1 stand for
// k = t and t + 4.
__device__ __forceinline__ void load_weights(const float* __restrict__ w2,
                                             const float* __restrict__ w3, float* tiles) {
  for (int e = threadIdx.x; e < kEncC1 * kEncC2; e += kThreads) {
    const int k = e / kEncC2, o = e % kEncC2;
    unsigned hi, lo;
    pcc_mma::split_tf32(__ldg(w2 + e), hi, lo);
    tiles[kW2Hi + swizzled(o, k)] = __uint_as_float(hi);
    tiles[kW2Lo + swizzled(o, k)] = __uint_as_float(lo);
  }
  for (int e = threadIdx.x; e < kEncC2 * kEncC3; e += kThreads) {
    const int k = e / kEncC3, o = e % kEncC3, r = k & 7;
    const int kp = (k & ~7) + ((r & 1) ? (r >> 1) + 4 : r >> 1);
    const int at = (kp / kTileK) * kW3Tile + swizzled(o, kp % kTileK);
    unsigned hi, lo;
    pcc_mma::split_tf32(__ldg(w3 + e), hi, lo);
    tiles[kW3Hi + at] = __uint_as_float(hi);
    tiles[kW3Lo + at] = __uint_as_float(lo);
  }
}

// The bf16 index of (row r, k) in a 128-byte-swizzled tile of 64-bf16 rows.
__device__ __forceinline__ int swizzled_bf16(int r, int k) {
  return r * kTileKBf16 + ((((k >> 3) ^ (r & 7)) << 3) | (k & 7));
}

// The bf16 tiles of W2 [32][64] and W3 [64][128] (row-major in device
// memory), rounded: W^T, K-major, rows in their order; W2's K values 32 ..
// 63 zero.
__device__ __forceinline__ void load_weights_bf16(const float* __restrict__ w2,
                                                  const float* __restrict__ w3,
                                                  __nv_bfloat16* tiles) {
  for (int e = threadIdx.x; e < kEncC2 * kTileKBf16; e += kThreads) {
    const int o = e / kTileKBf16, k = e % kTileKBf16;
    tiles[kW2Bf16 + swizzled_bf16(o, k)] =
        __float2bfloat16_rn(k < kEncC1 ? __ldg(w2 + k * kEncC2 + o) : 0.0f);
  }
  for (int e = threadIdx.x; e < kEncC2 * kEncC3; e += kThreads) {
    const int k = e / kEncC3, o = e % kEncC3;
    tiles[kW3Bf16 + swizzled_bf16(o, k)] = __float2bfloat16_rn(__ldg(w3 + e));
  }
  // these generic-proxy stores are read by wgmma (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The bf16 instance's rows: a warp's 16 grouped rows r0 .. r0 + 15 of the
// warpgroup's 64 (this lane's r0 + g and r0 + g + 8) through the MLP, each
// query's max into feats. Layer 1 on the CUDA cores from the rounded
// centred neighbours into layer 2's bf16 A fragments (k-step s: columns
// 16 s + 2 t, + 1 in a0 / a1 and 16 s + 8 + 2 t, + 1 in a2 / a3, rows g and
// g + 8); layers 2 and 3 one bf16 wgmma a k-step.
template <int KNN>
__device__ __forceinline__ void rows_bf16(const float* sx, const float* sy, const float* sz,
                                          const unsigned short* nbr, int r0,
                                          const float* __restrict__ w1,
                                          const float* __restrict__ b1,
                                          const float* __restrict__ b2,
                                          const float* __restrict__ b3, uint64_t d2,
                                          uint64_t d3, float* feats) {
  using pcc_bf16::round_bf16;
  using pcc_tile::max_over_rows_scattered;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float cx[2], cy[2], cz[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h, q = r / KNN, j = nbr[q * KNN + r % KNN];
    cx[h] = round_bf16(sx[j] - sx[q]);
    cy[h] = round_bf16(sy[j] - sy[q]);
    cz[h] = round_bf16(sz[j] - sz[q]);
  }
  unsigned a[2][4];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int o = 16 * s + 8 * half + 2 * t;
      float v[2][2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float wx = round_bf16(__ldg(w1 + o + c)),
                    wy = round_bf16(__ldg(w1 + kEncC1 + o + c)),
                    wz = round_bf16(__ldg(w1 + 2 * kEncC1 + o + c)),
                    bo = round_bf16(__ldg(b1 + o + c));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float acc = cx[h] * wx;
          acc = fmaf(cy[h], wy, acc);
          acc = fmaf(cz[h], wz, acc);
          v[h][c] = fmaxf(acc + bo, 0.0f);
        }
      }
      a[s][2 * half] = pack_bf16(v[0][0], v[0][1]);
      a[s][2 * half + 1] = pack_bf16(v[1][0], v[1][1]);
    }
  // layer 2 (32 -> 64): the warpgroup's 64 rows x 64 columns
  float y2[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) y2[e] = 0.0f;
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 2; ++s) wgmma_bf16_m64n64k16(y2, a[s], d2 + 2 * s);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<32>(y2);
  fence_regs<8>(&a[0][0]);
  // + bias, relu, rounded: layer 3's A, k-step q = layer 2's n8 tiles 2q, 2q + 1
  unsigned x[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float2 bo = __ldg(reinterpret_cast<const float2*>(b2 + 16 * q + 8 * half + 2 * t));
      bo = make_float2(round_bf16(bo.x), round_bf16(bo.y));
      const float* d = y2 + 8 * q + 4 * half;
      x[q][2 * half] = pack_bf16(fmaxf(d[0] + bo.x, 0.0f), fmaxf(d[1] + bo.y, 0.0f));
      x[q][2 * half + 1] = pack_bf16(fmaxf(d[2] + bo.x, 0.0f), fmaxf(d[3] + bo.y, 0.0f));
    }
  // layer 3 (64 -> 128): the warpgroup's 64 rows x 128 columns
  float y3[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) y3[e] = 0.0f;
  wgmma_fence();
#pragma unroll
  for (int q = 0; q < 4; ++q) wgmma_bf16_m64n128k16(y3, x[q], d3 + 2 * q);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<64>(y3);
  fence_regs<16>(&x[0][0]);
  // + bias, relu, rounded, and the max over each query's rows, as in the
  // float32 instance (rounding and the bias add are monotone)
  constexpr int kHalves = KNN == 8 ? 2 : 1;
#pragma unroll
  for (int hq = 0; hq < kHalves; ++hq)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float v[8][2];
#pragma unroll
      for (int i8 = 0; i8 < 8; ++i8)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int e = 4 * (8 * c + i8);
          v[i8][k] = KNN == 8 ? y3[e + 2 * hq + k] : fmaxf(y3[e + k], y3[e + 2 + k]);
        }
      float2 m = max_over_rows_scattered(v);
      const float2 bo = __ldg(reinterpret_cast<const float2*>(b3 + 64 * c + 8 * g + 2 * t));
      m = make_float2(round_bf16(fmaxf(m.x + round_bf16(bo.x), 0.0f)),
                      round_bf16(fmaxf(m.y + round_bf16(bo.y), 0.0f)));
      const float n0 = __shfl_down_sync(0xffffffffu, m.x, 1);
      const float n1 = __shfl_down_sync(0xffffffffu, m.y, 1);
      if ((t & 1) == 0)
        *reinterpret_cast<float4*>(feats + static_cast<size_t>(r0 / KNN + hq) * kEncC3 +
                                   64 * c + 8 * g + 2 * t) = make_float4(m.x, m.y, n0, n1);
    }
}

template <int KNN, bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
sa_fused_kernel(const float* __restrict__ pts, int patches, int n,
                const float* __restrict__ w1, const float* __restrict__ b1,
                const float* __restrict__ w2, const float* __restrict__ b2,
                const float* __restrict__ w3, const float* __restrict__ b3,
                float* __restrict__ out) {
  using pcc_mma::split_tf32;
  using pcc_tile::max_over_rows_scattered;
  extern __shared__ uint8_t smem_raw[];
  float* tiles = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* bufs = tiles + w_floats<kBf16>();                                    // [2][4][n]
  unsigned short* tables = reinterpret_cast<unsigned short*>(bufs + 8 * n);   // [2][n * KNN]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;

  if constexpr (kBf16) {
    load_weights_bf16(w2, w3, reinterpret_cast<__nv_bfloat16*>(tiles));
  } else {
    load_weights(w2, w3, tiles);
  }
  // patch p's points and squared norms (load_patch's arithmetic) into
  // buffer b, and the knn of its queries first, first + stride, ...
  // (knn_of), by the threads first, first + stride, ...
  auto load = [&](int p, int b, int first, int stride) {
    const float* src = pts + static_cast<size_t>(p) * n * 3;
    float* q = bufs + b * 4 * n;
    for (int j = first; j < n; j += stride) {
      const float x = src[3 * j], y = src[3 * j + 1], z = src[3 * j + 2];
      q[j] = x;
      q[n + j] = y;
      q[2 * n + j] = z;
      q[3 * n + j] = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
    }
  };
  auto select = [&](int b, int first, int stride) {
    const float* q = bufs + b * 4 * n;
    for (int i = first; i < n; i += stride)
      knn_of<KNN>(i, q, q + n, q + 2 * n, q + 3 * n, n, tables + b * n * KNN);
  };
  if (blockIdx.x < patches) {
    load(blockIdx.x, 0, threadIdx.x, kThreads);
    __syncthreads();
    select(0, threadIdx.x, kThreads);
  }
  __syncthreads();

  const uint64_t d2h = smem_desc_sw128(tiles + kW2Hi), d2l = smem_desc_sw128(tiles + kW2Lo);
  const uint64_t d3h[2] = {smem_desc_sw128(tiles + kW3Hi),
                           smem_desc_sw128(tiles + kW3Hi + kW3Tile)};
  const uint64_t d3l[2] = {smem_desc_sw128(tiles + kW3Lo),
                           smem_desc_sw128(tiles + kW3Lo + kW3Tile)};
  const uint64_t d2b = smem_desc_sw128(tiles), d3b = smem_desc_sw128(tiles + kW3Bf16 / 2);
  const int groups = n * KNN / kGroupRows;
  for (int i = 0, p = blockIdx.x; p < patches; ++i, p += gridDim.x) {
    const int cur = i & 1;
    if (warp >= kRowWarps) {
      if (p + static_cast<int>(gridDim.x) < patches) {
        const int first = threadIdx.x - 32 * kRowWarps;
        load(p + gridDim.x, cur ^ 1, first, kSelThreads);
        asm volatile("bar.sync 1, %0;\n" ::"n"(kSelThreads));
        select(cur ^ 1, first, kSelThreads);
      }
    } else {
      const float* sx = bufs + cur * 4 * n;
      const float* sy = sx + n;
      const float* sz = sx + 2 * n;
      const unsigned short* nbr = tables + cur * n * KNN;
      float* feats = out + static_cast<size_t>(p) * n * kEncC3;
      for (int gi = warp / 4; gi < groups; gi += kRowWarps / 4) {
        // this warp's 16 rows; this lane's rows r0 + g and r0 + g + 8
        const int r0 = gi * kGroupRows + (warp % 4) * 16;
        if constexpr (kBf16) {
          rows_bf16<KNN>(sx, sy, sz, nbr, r0, w1, b1, b2, b3, d2b, d3b, feats);
        } else {
          float cx[2], cy[2], cz[2];
  #pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + g + 8 * h, q = r / KNN, j = nbr[q * KNN + r % KNN];
            cx[h] = sx[j] - sx[q];
            cy[h] = sy[j] - sy[q];
            cz[h] = sz[j] - sz[q];
          }
          // layer 1 (3 -> 32) on the CUDA cores, straight into layer 2's A
          // fragments: k-step s, columns 8 s + t (a0, a1) and 8 s + t + 4 (a2, a3)
          unsigned ah[4][4], al[4][4];
  #pragma unroll
          for (int s = 0; s < 4; ++s)
  #pragma unroll
            for (int c4 = 0; c4 < 2; ++c4) {
              const int o = 8 * s + t + 4 * c4;
              const float wx = __ldg(w1 + o), wy = __ldg(w1 + kEncC1 + o),
                          wz = __ldg(w1 + 2 * kEncC1 + o), bo = __ldg(b1 + o);
  #pragma unroll
              for (int h = 0; h < 2; ++h) {
                float acc = cx[h] * wx;
                acc = fmaf(cy[h], wy, acc);
                acc = fmaf(cz[h], wz, acc);
                split_tf32(fmaxf(acc + bo, 0.0f), ah[s][2 * c4 + h], al[s][2 * c4 + h]);
              }
            }
          // layer 2 (32 -> 64): the warpgroup's 64 rows x 64 columns
          float y2[32];
  #pragma unroll
          for (int e = 0; e < 32; ++e) y2[e] = 0.0f;
          wgmma_fence();
  #pragma unroll
          for (int s = 0; s < 4; ++s) {
            wgmma_m64n64k8(y2, al[s], d2h + 2 * s);
            wgmma_m64n64k8(y2, ah[s], d2l + 2 * s);
            wgmma_m64n64k8(y2, ah[s], d2h + 2 * s);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs<32>(y2);
          fence_regs<16>(&ah[0][0]);
          fence_regs<16>(&al[0][0]);
          // + bias and relu: layer 3's A fragments, k-step s = layer 2's n8 tile s
          unsigned xh[8][4], xl[8][4];
  #pragma unroll
          for (int s = 0; s < 8; ++s) {
            const float2 bo = __ldg(reinterpret_cast<const float2*>(b2 + 8 * s + 2 * t));
            split_tf32(fmaxf(y2[4 * s] + bo.x, 0.0f), xh[s][0], xl[s][0]);
            split_tf32(fmaxf(y2[4 * s + 2] + bo.x, 0.0f), xh[s][1], xl[s][1]);
            split_tf32(fmaxf(y2[4 * s + 1] + bo.y, 0.0f), xh[s][2], xl[s][2]);
            split_tf32(fmaxf(y2[4 * s + 3] + bo.y, 0.0f), xh[s][3], xl[s][3]);
          }
          // layer 3 (64 -> 128): the warpgroup's 64 rows x 128 columns
          float y3[64];
  #pragma unroll
          for (int e = 0; e < 64; ++e) y3[e] = 0.0f;
          wgmma_fence();
  #pragma unroll
          for (int s = 0; s < 8; ++s) {
            wgmma_m64n128k8(y3, xl[s], d3h[s / 4] + 2 * (s % 4));
            wgmma_m64n128k8(y3, xh[s], d3l[s / 4] + 2 * (s % 4));
            wgmma_m64n128k8(y3, xh[s], d3h[s / 4] + 2 * (s % 4));
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs<64>(y3);
          fence_regs<32>(&xh[0][0]);
          fence_regs<32>(&xl[0][0]);
          // + bias, relu and the max over each query's rows (rounding is
          // monotone: max(acc) + b = max(acc + b)); this lane keeps columns
          // 64 c + 8 g + 2 t, + 1, and lanes of even t store four with their
          // neighbour's two
          constexpr int kHalves = KNN == 8 ? 2 : 1;   // queries in the warp's 16 rows
  #pragma unroll
          for (int hq = 0; hq < kHalves; ++hq)
  #pragma unroll
            for (int c = 0; c < 2; ++c) {
              float v[8][2];
  #pragma unroll
              for (int i8 = 0; i8 < 8; ++i8)
  #pragma unroll
                for (int k = 0; k < 2; ++k) {
                  const int e = 4 * (8 * c + i8);
                  v[i8][k] = KNN == 8 ? y3[e + 2 * hq + k] : fmaxf(y3[e + k], y3[e + 2 + k]);
                }
              float2 m = max_over_rows_scattered(v);
              const float2 bo =
                  __ldg(reinterpret_cast<const float2*>(b3 + 64 * c + 8 * g + 2 * t));
              m = make_float2(fmaxf(m.x + bo.x, 0.0f), fmaxf(m.y + bo.y, 0.0f));
              const float n0 = __shfl_down_sync(0xffffffffu, m.x, 1);
              const float n1 = __shfl_down_sync(0xffffffffu, m.y, 1);
              if ((t & 1) == 0)
                *reinterpret_cast<float4*>(feats + static_cast<size_t>(r0 / KNN + hq) * kEncC3 +
                                           64 * c + 8 * g + 2 * t) = make_float4(m.x, m.y, n0, n1);
            }
        }
      }
    }
    __syncthreads();   // this patch's rows are done, the next one is selected
  }
}

template <int KNN, bool kBf16>
int launch(const float* pts, int p, int n, const float* const* w, float* out,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes<kBf16>(n, KNN);
  if (bytes > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(sa_fused_kernel<KNN, kBf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = p < sms ? p : sms;
  sa_fused_kernel<KNN, kBf16><<<blocks, kThreads, bytes, stream>>>(pts, p, n, w[0], w[1], w[2],
                                                                   w[3], w[4], w[5], out);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBf16>
int launch_knn(const float* pts, int p, int n, int knn, const float* const* w, float* out,
               cudaStream_t s) {
  if (p <= 0 || n % kEncQ != 0 || n > kEncMaxN || n < knn)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (knn) {
    case 8:
      return launch<8, kBf16>(pts, p, n, w, out, s);
    case 16:
      return launch<16, kBf16>(pts, p, n, w, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// pts: [p, n, 3] f32. Weights [in, out] row-major f32 and biases [out]:
// 3 -> 32 -> 64 -> 128, 16-byte aligned. out: [p, n, 128] f32. Returns a
// cudaError_t value.
extern "C" int sa_fused_launch(const float* pts, int p, int n, int knn, const float* w1,
                               const float* b1, const float* w2, const float* b2,
                               const float* w3, const float* b3, float* out, void* stream) {
  const float* w[6] = {w1, b1, w2, b2, w3, b3};
  return launch_knn<false>(pts, p, n, knn, w, out, static_cast<cudaStream_t>(stream));
}

// The bf16 instance: the arguments of sa_fused_launch; every weight and
// bias is rounded to bf16 as it is loaded; out holds bf16 values.
extern "C" int sa_fused_bf16_launch(const float* pts, int p, int n, int knn, const float* w1,
                                    const float* b1, const float* w2, const float* b2,
                                    const float* w3, const float* b3, float* out,
                                    void* stream) {
  const float* w[6] = {w1, b1, w2, b2, w3, b3};
  return launch_knn<true>(pts, p, n, knn, w, out, static_cast<cudaStream_t>(stream));
}
