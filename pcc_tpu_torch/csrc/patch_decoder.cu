// The IPDAE patch decoder after its first two layers: expansion, fold,
// latent tile + concat and the point MLP, one launch, its products in 3xTF32
// on the tensor cores (wgmma).
//
// Replaces the TPU kernel pcc_tpu/ops/decoder_pallas.py::_decoder_kernel
// (entry patch_decoder_fused). Inputs: h2 [P, C] (C = 1024, the inv_pool
// activations after layer 2, computed outside the kernel as pcc_tpu does
// too), the quantized latent lat [P, d], the layer-3 expansion weight
// K-major and point-major, w [k*128, C] (row j*128 + c holds the
// reference's output channel c of point j: nn.Linear's own weight layout
// with its rows permuted), as hi and lo (split_tf32), its bias b3r [k*128]
// point-major, and the inv_mlp (128+d) -> 128 -> 64 -> 32 -> 3, the first
// three layers K-major ([out, in], each 8-column group of the input in the
// order 0 2 4 6 1 3 5 7, see below) as hi and lo, the last [32, 3]. For every
// patch p and point j: fold = relu(h2[p] @ w[j*128:(j+1)*128].T + b3r[...]),
// x = [fold | lat[p]], then the MLP (relu on all but the last layer).
// Output [P, k, 3].
//
// What bounds it on an H100: operations. About 41 MFLOP per patch at
// k = 128, d = 16 (167.6 GFLOP per batch of 4096 patches), 82% of it the
// 1024 -> k*128 expansion. As 3xTF32 (three TF32 products per float32
// product) on the tensor cores at 495 TFLOP/s that is 1.02 ms; in float32 on
// the CUDA cores at 67 TFLOP/s, 2.50 ms. The bytes (h2, the weights, the
// output: about 85 MB) take 0.026 ms.
//
// What the design does about it:
// - The products run on the tensor cores as wgmma m64nNk8 .tf32 with A in
//   registers and B in shared memory. 3xTF32 keeps float32 accuracy: every
//   operand x is split into hi (x with its 13 low mantissa bits cleared,
//   which the tensor cores ignore) and lo = x - hi, and each k-step adds
//   lo*hi, hi*lo and hi*hi (tf32_mma.cuh). The weights' hi and lo are
//   prepared on the host; A's are made in registers.
// - A persistent grid (one block per SM) walks the tiles (point j, 128
//   patch rows) with the patch tile fastest, so the blocks resident at one
//   time share one or two points' weight slices: each slice leaves device
//   memory about once per batch, and h2 (16 MB) stays in L2.
// - Warp-specialized: one producer thread keeps TMA loads in flight through
//   a ring of kStages stages (h2 tile, weight hi, weight lo; 128 rows x 32
//   floats each, 128-byte swizzle) against full/empty mbarriers; two
//   consumer warpgroups of 64 rows each run the products on the stages that
//   have landed.
// - The epilogue never leaves registers: bias + relu on the accumulator,
//   which becomes the next product's A operand as it stands (the
//   accumulator's columns 8i + 2t and 8i + 2t + 1 are A's k = t and t + 4,
//   which is why each 8-column group of a layer's input is permuted
//   0 2 4 6 1 3 5 7 on the host), the latent loaded beside it. The layers
//   128+d -> 128 -> 64 -> 32 are 3xTF32 wgmma products whose weight chunks
//   stream through the same ring behind the tile's K stages (so the next
//   tile's loads overlap them); 32 -> 3 is on the CUDA cores with a fixed
//   shuffle order. Device memory sees h2, lat and the weights in and
//   [P, k, 3] out.
// - Sums in an order fixed by the code, no atomics: bitwise repeatable.
//
// The bf16 instance (patch_decoder_bf16_kernel, patch_decoder_bf16_launch;
// pcc_tpu's compute_dtype bfloat16, decoder_pallas.py:39-70): the same
// design on bf16 operands, each k = 16 step one .bf16 wgmma (wgmma_bf16.cuh)
// where the float32 instance takes three TF32 products per k = 8. What
// bounds it: the same 167.6 GFLOP per 4096 patches, 0.17 ms at the bf16
// tensor cores' 989 TFLOP/s. Rounding where the TPU kernel rounds: the
// weights are bf16 (the wrapper's layout, ops/decoder_cuda.py::
// pack_decoder: K-major, the expansion point-major, the inv_mlp layers in
// their natural order, since a bf16 accumulator's 8-column blocks 2q and
// 2q + 1 are the next product's A fragment of step q as they stand), the
// biases float32; h2 comes in float32 and is rounded to bf16 as the
// consumers make its A fragments; the fold and every inv_mlp output are
// rounded to bf16 after their bias and relu (the last layer's after its
// bias); the latent is integer-valued, exact in bf16. A stage holds 64
// columns of K: h2's two 32-float boxes and one 128-row box of 64 bf16 of
// the weights (48 KB, as a float32 stage), so the expansion takes C / 64
// stages where the float32 instance takes C / 32 with two weight boxes each.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "bf16.cuh"
#include "tf32_mma.cuh"
#include "wgmma_bf16.cuh"
#include "wgmma_tf32.cuh"

namespace {

using pcc_mma::split_tf32;
using namespace pcc_wgmma;

// parts that tools/decoder_breakdown.py leaves out, one at a time
constexpr bool kRunExpansion = true;
constexpr bool kRunMlp = true;

constexpr int kBM = 128;                   // patch rows per tile: 2 warpgroups x 64
constexpr int kBN = 128;                   // fold channels per point
constexpr int kBK = 32;                    // floats per stage row: one 128-byte swizzle span
constexpr int kStages = 4;
constexpr int kSlot = kBM * kBK;           // floats per operand tile (16 KB)
constexpr int kStageFloats = 3 * kSlot;    // h2 tile | B hi | B lo
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kM1 = 128, kM2 = 64, kM3 = 32, kM4 = 3;   // inv_mlp widths
constexpr int kMaxD = 64;
constexpr size_t kSmemBytes =
    1024 + sizeof(float) * kStages * kStageFloats + 2 * kStages * sizeof(uint64_t);

struct Params {
  CUtensorMap h2, w_hi, w_lo;              // [P, C], [k*128, C] x 2: boxes 128 x 32
  CUtensorMap m_hi[3], m_lo[3];            // [128, kp1], [64, 128], [32, 64]
  const float* lat;                        // [P, d]
  const float* b3r;                        // [k*128]
  const float* mb[3];                      // [128], [64], [32]
  const float* w4;                         // [32, 3]
  const float* b4;                         // [3]
  float* out;                              // [P, k, 3]
  int P, C, d, k, ptiles, tiles;
  int l1_chunks;                           // 32-column chunks of layer 1's input
  int lat_steps;                           // 8-column steps of the latent
};

__device__ __forceinline__ int layer_chunks(const Params& p, int l) {
  return l == 0 ? p.l1_chunks : (l == 1 ? kM1 / kBK : kM2 / kBK);
}

// Stage `it` of the block's sequence: its slot, and the parity its barriers
// complete with on this pass through the ring.
__device__ __forceinline__ int stage_of(int it) { return it % kStages; }
__device__ __forceinline__ unsigned parity_of(int it) { return (it / kStages) & 1; }

__device__ void producer(const Params& p, float* ring, uint64_t* full, uint64_t* empty) {
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int j = tile / p.ptiles, p0 = (tile % p.ptiles) * kBM;
    if (kRunExpansion) {
      for (int k0 = 0; k0 < p.C; k0 += kBK, ++it) {
        const int s = stage_of(it);
        mbar_wait(&empty[s], parity_of(it) ^ 1);
        float* st = ring + s * kStageFloats;
        mbar_expect_tx(&full[s], 3 * kSlot * sizeof(float));
        tma_load_2d(st, &p.h2, k0, p0, &full[s]);
        tma_load_2d(st + kSlot, &p.w_hi, k0, j * kBN, &full[s]);
        tma_load_2d(st + 2 * kSlot, &p.w_lo, k0, j * kBN, &full[s]);
      }
    }
    if (kRunMlp) {
      for (int l = 0; l < 3; ++l) {
        const unsigned rows = l == 0 ? kM1 : (l == 1 ? kM2 : kM3);
        for (int c = 0; c < layer_chunks(p, l); ++c, ++it) {
          const int s = stage_of(it);
          mbar_wait(&empty[s], parity_of(it) ^ 1);
          float* st = ring + s * kStageFloats;
          mbar_expect_tx(&full[s], 2 * rows * kBK * sizeof(float));
          tma_load_2d(st + kSlot, &p.m_hi[l], c * kBK, 0, &full[s]);
          tma_load_2d(st + 2 * kSlot, &p.m_lo[l], c * kBK, 0, &full[s]);
        }
      }
    }
  }
}

// A fragment (hi, lo) of one k = 8 step from four float32 values.
__device__ __forceinline__ void split4(float x0, float x1, float x2, float x3, unsigned* hi,
                                       unsigned* lo) {
  split_tf32(x0, hi[0], lo[0]);
  split_tf32(x1, hi[1], lo[1]);
  split_tf32(x2, hi[2], lo[2]);
  split_tf32(x3, hi[3], lo[3]);
}

// y += x * W over one 32-column chunk of W's input, in 3xTF32: steps q <
// nsteps of the chunk, A fragments hi[q] / lo[q], W's hi and lo tiles in
// slots 1 and 2 of stage st.
template <int N>
__device__ __forceinline__ void chunk_products(float* y, unsigned (*hi)[4], unsigned (*lo)[4],
                                               const float* st, int nsteps) {
  const uint64_t dhi = smem_desc_sw128(st + kSlot), dlo = smem_desc_sw128(st + 2 * kSlot);
  wgmma_fence();
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (q < nsteps) {
      if constexpr (N == 128) {
        wgmma_m64n128k8(y, lo[q], dhi + 2 * q);
        wgmma_m64n128k8(y, hi[q], dlo + 2 * q);
        wgmma_m64n128k8(y, hi[q], dhi + 2 * q);
      } else if constexpr (N == 64) {
        wgmma_m64n64k8(y, lo[q], dhi + 2 * q);
        wgmma_m64n64k8(y, hi[q], dlo + 2 * q);
        wgmma_m64n64k8(y, hi[q], dhi + 2 * q);
      } else {
        wgmma_m64n32k8(y, lo[q], dhi + 2 * q);
        wgmma_m64n32k8(y, hi[q], dlo + 2 * q);
        wgmma_m64n32k8(y, hi[q], dhi + 2 * q);
      }
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<N / 2>(y);
  fence_regs<16>(&hi[0][0]);
  fence_regs<16>(&lo[0][0]);
}

// y = relu(y + b) on an accumulator fragment of N columns.
template <int N>
__device__ __forceinline__ void bias_relu(float* y, const float* __restrict__ b, int t) {
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const float b0 = __ldg(b + 8 * i + 2 * t), b1 = __ldg(b + 8 * i + 2 * t + 1);
    y[4 * i] = fmaxf(y[4 * i] + b0, 0.0f);
    y[4 * i + 1] = fmaxf(y[4 * i + 1] + b1, 0.0f);
    y[4 * i + 2] = fmaxf(y[4 * i + 2] + b0, 0.0f);
    y[4 * i + 3] = fmaxf(y[4 * i + 3] + b1, 0.0f);
  }
}

// The next layer over a whole accumulator x of K columns: chunks of 32
// columns from the ring (stage counter it), y (N columns) += x * W.
template <int K, int N>
__device__ __forceinline__ void layer(float* y, const float* x, float* ring, uint64_t* full,
                                      uint64_t* empty, int& it, int lane) {
#pragma unroll
  for (int c = 0; c < K / kBK; ++c, ++it) {
    const int s = stage_of(it);
    unsigned hi[4][4], lo[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* xi = x + 4 * (4 * c + q);
      // the accumulator's columns 2t and 2t + 1 are A's k = t and t + 4
      split4(xi[0], xi[2], xi[1], xi[3], hi[q], lo[q]);
    }
    mbar_wait(&full[s], parity_of(it));
    chunk_products<N>(y, hi, lo, ring + s * kStageFloats, 4);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
}

__device__ void consumer(const Params& p, float* ring, uint64_t* full, uint64_t* empty) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = (warp / 4) * 64 + (warp % 4) * 16 + g;   // tile rows r0 and r0 + 8
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int j = tile / p.ptiles, p0 = (tile % p.ptiles) * kBM;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

    // the expansion: K = C in stages of 32 columns
    if (kRunExpansion) {
      for (int k0 = 0; k0 < p.C; k0 += kBK, ++it) {
        const int s = stage_of(it);
        const float* st = ring + s * kStageFloats;
        mbar_wait(&full[s], parity_of(it));
        unsigned hi[4][4], lo[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // columns 8q + t and 8q + t + 4 of rows r0 and r0 + 8: 16-byte
          // chunks 2q and 2q + 1, swizzled by the row (r0 % 8 == g)
          const float* ra = st + r0 * kBK + t;
          const float* rb = ra + 8 * kBK;
          const int c0 = ((2 * q) ^ g) * 4, c1 = ((2 * q + 1) ^ g) * 4;
          split4(ra[c0], rb[c0], ra[c1], rb[c1], hi[q], lo[q]);
        }
        chunk_products<128>(acc, hi, lo, st, 4);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
    }
    // the fold: relu(expansion + bias)
    bias_relu<kBN>(acc, p.b3r + static_cast<size_t>(j) * kBN, t);

    const int pa = p0 + r0, pb = pa + 8;
    if (kRunMlp) {
      // layer 1 over [fold | lat]: the fold's 4 chunks from registers
      float y1[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) y1[i] = 0.0f;
      layer<kBN, kM1>(y1, acc, ring, full, empty, it, lane);
      // then the latent's chunks, loaded here (columns past d are zero, as
      // are W's rows there)
      const float* la = p.lat + static_cast<size_t>(pa) * p.d;
      const float* lb = p.lat + static_cast<size_t>(pb) * p.d;
      for (int c = 0; c < p.l1_chunks - kBN / kBK; ++c, ++it) {
        const int s = stage_of(it);
        unsigned hi[4][4], lo[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int col = 8 * (4 * c + q) + 2 * t;
          float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          if (pa < p.P && col < p.d) v[0] = __ldg(la + col);
          if (pb < p.P && col < p.d) v[1] = __ldg(lb + col);
          if (pa < p.P && col + 1 < p.d) v[2] = __ldg(la + col + 1);
          if (pb < p.P && col + 1 < p.d) v[3] = __ldg(lb + col + 1);
          split4(v[0], v[1], v[2], v[3], hi[q], lo[q]);
        }
        mbar_wait(&full[s], parity_of(it));
        chunk_products<kM1>(y1, hi, lo, ring + s * kStageFloats, p.lat_steps - 4 * c);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
      bias_relu<kM1>(y1, p.mb[0], t);
      float y2[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) y2[i] = 0.0f;
      layer<kM1, kM2>(y2, y1, ring, full, empty, it, lane);
      bias_relu<kM2>(y2, p.mb[1], t);
      float y3[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) y3[i] = 0.0f;
      layer<kM2, kM3>(y3, y2, ring, full, empty, it, lane);
      bias_relu<kM3>(y3, p.mb[2], t);

      // 32 -> 3 on the CUDA cores: each lane's 8 columns of rows r0 and
      // r0 + 8, then the 4 lanes of a row in a fixed shuffle order
#pragma unroll
      for (int o = 0; o < kM4; ++o) {
        float sa = 0.0f, sb = 0.0f;
#pragma unroll
        for (int i = 0; i < kM3 / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float w = __ldg(p.w4 + (8 * i + 2 * t + e) * kM4 + o);
            sa = fmaf(y3[4 * i + e], w, sa);
            sb = fmaf(y3[4 * i + 2 + e], w, sb);
          }
        sa += __shfl_xor_sync(0xffffffffu, sa, 1);
        sb += __shfl_xor_sync(0xffffffffu, sb, 1);
        sa += __shfl_xor_sync(0xffffffffu, sa, 2);
        sb += __shfl_xor_sync(0xffffffffu, sb, 2);
        const float b = __ldg(p.b4 + o);
        if (t == 0 && pa < p.P) p.out[(static_cast<size_t>(pa) * p.k + j) * kM4 + o] = sa + b;
        if (t == 0 && pb < p.P) p.out[(static_cast<size_t>(pb) * p.k + j) * kM4 + o] = sb + b;
      }
    } else if (t == 0) {
      // breakdown variant without the MLP: store a little of the fold
#pragma unroll
      for (int o = 0; o < kM4; ++o) {
        if (pa < p.P) p.out[(static_cast<size_t>(pa) * p.k + j) * kM4 + o] = acc[o];
        if (pb < p.P) p.out[(static_cast<size_t>(pb) * p.k + j) * kM4 + o] = acc[4 + o];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
patch_decoder_kernel(const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  // stage tiles 1024-byte aligned (the 128-byte swizzle's period)
  float* ring = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageFloats);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) producer(p, ring, full, empty);
    return;
  }
  consumer(p, ring, full, empty);
}

// ---- the bf16 instance ----

constexpr int kBK16 = 64;                  // K per stage: bf16 per weight row, two h2 boxes

// The bf16 instance's Params: w_hi the expansion [k*128, C] and m_hi[] the
// inv_mlp layers [128, kp1], [64, 128], [32, 64], all bf16 (boxes of rows x
// 64); w_lo and m_lo unused; l1_chunks counts 64-column chunks, lat_steps
// 16-column steps.
__device__ __forceinline__ int layer_chunks16(const Params& p, int l) {
  return l == 0 ? p.l1_chunks : (l == 1 ? kM1 / kBK16 : kM2 / kBK16);
}

__device__ void producer_bf16(const Params& p, float* ring, uint64_t* full, uint64_t* empty) {
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int j = tile / p.ptiles, p0 = (tile % p.ptiles) * kBM;
    for (int k0 = 0; k0 < p.C; k0 += kBK16, ++it) {
      const int s = stage_of(it);
      mbar_wait(&empty[s], parity_of(it) ^ 1);
      float* st = ring + s * kStageFloats;
      mbar_expect_tx(&full[s], 3 * kSlot * sizeof(float));
      tma_load_2d(st, &p.h2, k0, p0, &full[s]);
      tma_load_2d(st + kSlot, &p.h2, k0 + kBK, p0, &full[s]);
      tma_load_2d(st + 2 * kSlot, &p.w_hi, k0, j * kBN, &full[s]);
    }
    for (int l = 0; l < 3; ++l) {
      const unsigned rows = l == 0 ? kM1 : (l == 1 ? kM2 : kM3);
      for (int c = 0; c < layer_chunks16(p, l); ++c, ++it) {
        const int s = stage_of(it);
        mbar_wait(&empty[s], parity_of(it) ^ 1);
        float* st = ring + s * kStageFloats;
        mbar_expect_tx(&full[s], rows * kBK16 * 2);
        tma_load_2d(st + 2 * kSlot, &p.m_hi[l], c * kBK16, 0, &full[s]);
      }
    }
  }
}

// y += x * W over one 64-column chunk of W's input: steps q < nsteps, A
// fragments a[q], W's bf16 tile in slot 2 of stage st.
template <int N>
__device__ __forceinline__ void chunk_products_bf16(float* y, unsigned (*a)[4], const float* st,
                                                    int nsteps) {
  const uint64_t desc = smem_desc_sw128(st + 2 * kSlot);
  wgmma_fence();
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (q < nsteps) {
      if constexpr (N == 128) {
        wgmma_bf16_m64n128k16(y, a[q], desc + 2 * q);
      } else if constexpr (N == 64) {
        wgmma_bf16_m64n64k16(y, a[q], desc + 2 * q);
      } else {
        wgmma_bf16_m64n32k16(y, a[q], desc + 2 * q);
      }
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<N / 2>(y);
  fence_regs<16>(&a[0][0]);
}

// y = round_bf16(relu(y + b)) on an accumulator fragment of N columns.
template <int N>
__device__ __forceinline__ void bias_relu_bf16(float* y, const float* __restrict__ b, int t) {
  using pcc_bf16::round_bf16;
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const float b0 = __ldg(b + 8 * i + 2 * t), b1 = __ldg(b + 8 * i + 2 * t + 1);
    y[4 * i] = round_bf16(fmaxf(y[4 * i] + b0, 0.0f));
    y[4 * i + 1] = round_bf16(fmaxf(y[4 * i + 1] + b1, 0.0f));
    y[4 * i + 2] = round_bf16(fmaxf(y[4 * i + 2] + b0, 0.0f));
    y[4 * i + 3] = round_bf16(fmaxf(y[4 * i + 3] + b1, 0.0f));
  }
}

// The next layer over a whole accumulator x of K columns: chunks of 64
// columns from the ring (stage counter it), y (N columns) += x * W; x's
// 8-column blocks 8c + 2q and 8c + 2q + 1 are step q of chunk c.
template <int K, int N>
__device__ __forceinline__ void layer_bf16(float* y, const float* x, float* ring, uint64_t* full,
                                           uint64_t* empty, int& it, int lane) {
#pragma unroll
  for (int c = 0; c < K / kBK16; ++c, ++it) {
    const int s = stage_of(it);
    unsigned a[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* x0 = x + 4 * (8 * c + 2 * q);
      a[q][0] = pack_bf16(x0[0], x0[1]);
      a[q][1] = pack_bf16(x0[2], x0[3]);
      a[q][2] = pack_bf16(x0[4], x0[5]);
      a[q][3] = pack_bf16(x0[6], x0[7]);
    }
    mbar_wait(&full[s], parity_of(it));
    chunk_products_bf16<N>(y, a, ring + s * kStageFloats, 4);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
}

__device__ void consumer_bf16(const Params& p, float* ring, uint64_t* full, uint64_t* empty) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = (warp / 4) * 64 + (warp % 4) * 16 + g;   // tile rows r0 and r0 + 8
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int j = tile / p.ptiles, p0 = (tile % p.ptiles) * kBM;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

    // the expansion: K = C in stages of 64 columns, h2 rounded to bf16 here
    for (int k0 = 0; k0 < p.C; k0 += kBK16, ++it) {
      const int s = stage_of(it);
      const float* st = ring + s * kStageFloats;
      mbar_wait(&full[s], parity_of(it));
      unsigned a[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // columns 16q + 2t (+1) and 16q + 8 + 2t (+1) of rows r0 and r0 + 8:
        // box q / 2, its 16-byte chunks 4 (q % 2) + t / 2 and 4 (q % 2) + 2 +
        // t / 2, swizzled by the row (r0 % 8 == g)
        const float* ra = st + (q >> 1) * kSlot + r0 * kBK;
        const float* rb = ra + 8 * kBK;
        const int c0 = ((4 * (q & 1) + (t >> 1)) ^ g) * 4 + (2 * t & 3);
        const int c1 = ((4 * (q & 1) + 2 + (t >> 1)) ^ g) * 4 + (2 * t & 3);
        a[q][0] = pack_bf16(ra[c0], ra[c0 + 1]);
        a[q][1] = pack_bf16(rb[c0], rb[c0 + 1]);
        a[q][2] = pack_bf16(ra[c1], ra[c1 + 1]);
        a[q][3] = pack_bf16(rb[c1], rb[c1 + 1]);
      }
      chunk_products_bf16<128>(acc, a, st, 4);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    // the fold: bf16(relu(expansion + bias))
    bias_relu_bf16<kBN>(acc, p.b3r + static_cast<size_t>(j) * kBN, t);

    const int pa = p0 + r0, pb = pa + 8;
    // layer 1 over [fold | lat]: the fold's 2 chunks from registers
    float y1[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) y1[i] = 0.0f;
    layer_bf16<kBN, kM1>(y1, acc, ring, full, empty, it, lane);
    // then the latent's chunks, loaded here (columns past d are zero, as
    // are W's rows there)
    const float* la = p.lat + static_cast<size_t>(pa) * p.d;
    const float* lb = p.lat + static_cast<size_t>(pb) * p.d;
    for (int c = 0; c < p.l1_chunks - kBN / kBK16; ++c, ++it) {
      const int s = stage_of(it);
      unsigned a[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = kBK16 * c + 16 * q + 8 * h + 2 * t;
          float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          if (pa < p.P && col < p.d) v[0] = __ldg(la + col);
          if (pa < p.P && col + 1 < p.d) v[1] = __ldg(la + col + 1);
          if (pb < p.P && col < p.d) v[2] = __ldg(lb + col);
          if (pb < p.P && col + 1 < p.d) v[3] = __ldg(lb + col + 1);
          a[q][2 * h] = pack_bf16(v[0], v[1]);
          a[q][2 * h + 1] = pack_bf16(v[2], v[3]);
        }
      }
      mbar_wait(&full[s], parity_of(it));
      chunk_products_bf16<kM1>(y1, a, ring + s * kStageFloats, p.lat_steps - 4 * c);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    bias_relu_bf16<kM1>(y1, p.mb[0], t);
    float y2[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) y2[i] = 0.0f;
    layer_bf16<kM1, kM2>(y2, y1, ring, full, empty, it, lane);
    bias_relu_bf16<kM2>(y2, p.mb[1], t);
    float y3[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) y3[i] = 0.0f;
    layer_bf16<kM2, kM3>(y3, y2, ring, full, empty, it, lane);
    bias_relu_bf16<kM3>(y3, p.mb[2], t);

    // 32 -> 3 on the CUDA cores (w4 bf16-exact, b4 float32), each lane's 8
    // columns of rows r0 and r0 + 8, then the 4 lanes of a row in a fixed
    // shuffle order, rounded to bf16 after the bias
#pragma unroll
    for (int o = 0; o < kM4; ++o) {
      float sa = 0.0f, sb = 0.0f;
#pragma unroll
      for (int i = 0; i < kM3 / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float w = __ldg(p.w4 + (8 * i + 2 * t + e) * kM4 + o);
          sa = fmaf(y3[4 * i + e], w, sa);
          sb = fmaf(y3[4 * i + 2 + e], w, sb);
        }
      sa += __shfl_xor_sync(0xffffffffu, sa, 1);
      sb += __shfl_xor_sync(0xffffffffu, sb, 1);
      sa += __shfl_xor_sync(0xffffffffu, sa, 2);
      sb += __shfl_xor_sync(0xffffffffu, sb, 2);
      const float b = __ldg(p.b4 + o);
      const float va = pcc_bf16::round_bf16(sa + b), vb = pcc_bf16::round_bf16(sb + b);
      if (t == 0 && pa < p.P) p.out[(static_cast<size_t>(pa) * p.k + j) * kM4 + o] = va;
      if (t == 0 && pb < p.P) p.out[(static_cast<size_t>(pb) * p.k + j) * kM4 + o] = vb;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
patch_decoder_bf16_kernel(const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  float* ring = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageFloats);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) producer_bf16(p, ring, full, empty);
    return;
  }
  consumer_bf16(p, ring, full, empty);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, reached through the runtime (no link
// against libcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A row-major [rows, cols] tensor in boxes of box_rows x 128 bytes (32
// float32 or 64 bf16 columns), 128-byte swizzled; out-of-bounds elements
// load as zeros.
bool make_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows,
              bool bf16 = false) {
  const size_t elem_bytes = bf16 ? 2 : sizeof(float);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elem_bytes),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encoder()(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                   2, const_cast<void*>(base), dims, strides, box, elem,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// h2: [P, C] f32 (C % 32 == 0); lat: [P, d] (0 < d <= 64); w_hi, w_lo: [k*128, C];
// b3r: [k*128]; m1: [128, kp1] with kp1 = 128 + round_up(d, 8), m2: [128 -> 64]
// as [64, 128], m3: [32, 64], each as hi and lo, with biases mb1..mb3; w4:
// [32, 3], b4: [3]; out: [P, k, 3]. Every tensor that TMA reads (h2, w_*,
// m*) 16-byte aligned. Returns a cudaError_t value.
extern "C" int patch_decoder_launch(const float* h2, const float* lat, int P, int C, int d,
                                    int k, const float* w_hi, const float* w_lo,
                                    const float* b3r, const float* m1_hi, const float* m1_lo,
                                    const float* mb1, const float* m2_hi, const float* m2_lo,
                                    const float* mb2, const float* m3_hi, const float* m3_lo,
                                    const float* mb3, const float* w4, const float* b4,
                                    float* out, void* stream) {
  const long long tiles = static_cast<long long>((P + kBM - 1) / kBM) * k;
  if (P <= 0 || C < kBK || C % kBK != 0 || d <= 0 || d > kMaxD || k <= 0 ||
      tiles > (1ll << 30) || static_cast<long long>(k) * kBN * C >= (1ll << 40))
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* ptr : {static_cast<const void*>(h2), static_cast<const void*>(w_hi),
                          static_cast<const void*>(w_lo), static_cast<const void*>(m1_hi),
                          static_cast<const void*>(m1_lo), static_cast<const void*>(m2_hi),
                          static_cast<const void*>(m2_lo), static_cast<const void*>(m3_hi),
                          static_cast<const void*>(m3_lo)})
    if (!aligned16(ptr)) return static_cast<int>(cudaErrorMisalignedAddress);
  if (encoder() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  Params p;
  const int kp1 = kBN + (d + 7) / 8 * 8;
  if (!make_map(&p.h2, h2, P, C, kBM) || !make_map(&p.w_hi, w_hi, k * kBN, C, kBN) ||
      !make_map(&p.w_lo, w_lo, k * kBN, C, kBN) || !make_map(&p.m_hi[0], m1_hi, kM1, kp1, kM1) ||
      !make_map(&p.m_lo[0], m1_lo, kM1, kp1, kM1) ||
      !make_map(&p.m_hi[1], m2_hi, kM2, kM1, kM2) || !make_map(&p.m_lo[1], m2_lo, kM2, kM1, kM2) ||
      !make_map(&p.m_hi[2], m3_hi, kM3, kM2, kM3) || !make_map(&p.m_lo[2], m3_lo, kM3, kM2, kM3))
    return static_cast<int>(cudaErrorInvalidValue);
  p.lat = lat;
  p.b3r = b3r;
  p.mb[0] = mb1;
  p.mb[1] = mb2;
  p.mb[2] = mb3;
  p.w4 = w4;
  p.b4 = b4;
  p.out = out;
  p.P = P;
  p.C = C;
  p.d = d;
  p.k = k;
  p.ptiles = (P + kBM - 1) / kBM;
  p.tiles = static_cast<int>(tiles);
  p.l1_chunks = (kp1 + kBK - 1) / kBK;
  p.lat_steps = (d + 7) / 8;

  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(patch_decoder_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  patch_decoder_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 instance: h2 [P, C] f32 (C % 64 == 0), lat [P, d] f32 (0 < d <=
// 64); w [k*128, C], m1 [128, kp1] with kp1 = 128 + round_up(d, 16), m2
// [64, 128], m3 [32, 64], all bf16 (2-byte) K-major in their natural column
// order, 16-byte aligned; biases b3r, mb1..mb3 and b4 f32, w4 [32, 3] f32
// (bf16-exact); out [P, k, 3] f32. Returns a cudaError_t value.
extern "C" int patch_decoder_bf16_launch(const float* h2, const float* lat, int P, int C, int d,
                                         int k, const void* w, const float* b3r, const void* m1,
                                         const float* mb1, const void* m2, const float* mb2,
                                         const void* m3, const float* mb3, const float* w4,
                                         const float* b4, float* out, void* stream) {
  const long long tiles = static_cast<long long>((P + kBM - 1) / kBM) * k;
  if (P <= 0 || C < kBK16 || C % kBK16 != 0 || d <= 0 || d > kMaxD || k <= 0 ||
      tiles > (1ll << 30) || static_cast<long long>(k) * kBN * C >= (1ll << 40))
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* ptr : {static_cast<const void*>(h2), w, m1, m2, m3})
    if (!aligned16(ptr)) return static_cast<int>(cudaErrorMisalignedAddress);
  if (encoder() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  Params p;
  const int kp1 = kBN + (d + 15) / 16 * 16;
  if (!make_map(&p.h2, h2, P, C, kBM) || !make_map(&p.w_hi, w, k * kBN, C, kBN, true) ||
      !make_map(&p.m_hi[0], m1, kM1, kp1, kM1, true) ||
      !make_map(&p.m_hi[1], m2, kM2, kM1, kM2, true) ||
      !make_map(&p.m_hi[2], m3, kM3, kM2, kM3, true))
    return static_cast<int>(cudaErrorInvalidValue);
  p.w_lo = p.w_hi;
  for (int l = 0; l < 3; ++l) p.m_lo[l] = p.m_hi[l];
  p.lat = lat;
  p.b3r = b3r;
  p.mb[0] = mb1;
  p.mb[1] = mb2;
  p.mb[2] = mb3;
  p.w4 = w4;
  p.b4 = b4;
  p.out = out;
  p.P = P;
  p.C = C;
  p.d = d;
  p.k = k;
  p.ptiles = (P + kBM - 1) / kBM;
  p.tiles = static_cast<int>(tiles);
  p.l1_chunks = (kp1 + kBK16 - 1) / kBK16;
  p.lat_steps = (d + 15) / 16;

  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(patch_decoder_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  patch_decoder_bf16_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
