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
// The bf16 instance (namespace dec16, patch_decoder_bf16_launch; pcc_tpu's
// compute_dtype bfloat16, decoder_pallas.py:39-70), a design of its own.
// Rounding where the TPU kernel rounds: the weights are bf16 (the wrapper's
// layout, ops/decoder_cuda.py::pack_decoder: K-major, the expansion
// point-major, the inv_mlp layers in their natural order), the biases
// float32; h2 arrives as bf16 (the wrapper rounds it once); the fold and
// every inv_mlp output are rounded to bf16 after their bias and relu (the
// last layer's after its bias); the latent is integer-valued, exact in bf16.
//
// What bounds it on an H100: the same 167.6 GFLOP per 4096 patches, 0.17 ms
// on the bf16 tensor cores at 989 TFLOP/s, reached only if the operands
// reach shared memory fast enough. The design the float32 instance uses
// (a tile of 128 patch rows x one point, h2 in float32) moved 768 KB from
// L2 per tile, 3.4 GB per batch with the inv_mlp's weights streamed per
// tile: L2-bound at about 6.5 TB/s, and slower than cuBLAS's expansion
// alone. What this design does about it:
// - A tile is 128 patch rows x 2 points (256 weight rows): per 64-column
//   stage 16 KB of h2 and 32 KB of weights, 768 KB a tile, 2048 tiles and
//   1.6 GB from L2 per batch of 4096 patches at k = 128, C = 1024.
// - h2 and the weights are both read by wgmma from shared memory
//   (m64n256k16, two descriptors), in bf16: nothing is converted per tile.
// - One group of products stays in flight (wgmma_wait<1>) while the next
//   stage lands; the slot of the one before is then released.
// - The inv_mlp's bf16 weights (68 KB) are loaded once per block and stay
//   resident; the epilogue never leaves registers: per point, the fold
//   (bias, relu, round) packed as layer 1's A, the latent's k16 steps, 144
//   -> 128 -> 64 -> 32 on bf16 wgmma with each accumulator the next A as
//   it lies, 32 -> 3 on the CUDA cores in a fixed shuffle order.
// - Three warpgroups: two consumers (64 rows each), a producer whose one
//   thread issues the TMA loads, its registers given to the consumers
//   (setmaxnreg).
// - One CTA a tile: pairing the CTAs of two patch tiles in a cluster, each
//   loading half of the weight rows and multicasting it to both, would
//   move a third fewer bytes, but the CTAs then wait on each other's slots,
//   and on an H100 that ran slower.
// Sums in an order fixed by the code, no atomics: bitwise repeatable.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "bf16.cuh"
#include "tf32_mma.cuh"
#include "wgmma_bf16.cuh"
#include "wgmma_tf32.cuh"

// TMA tensor maps of row-major 2-D tensors, built on the host through the
// runtime's driver entry point (no link against libcuda).
namespace {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, reached through the runtime.
inline EncodeTiled encoder() {
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
inline bool make_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows,
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

inline bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

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

// ---- the bf16 instance (design note: the last paragraphs of the top comment) ----

namespace dec16 {

constexpr int kPts = 2;                        // points per tile
constexpr int kBK = 64;                        // K per stage: one 128-byte row of bf16
constexpr int kStages = 3;
constexpr int kABytes = kBM * kBK * 2;         // h2: 128 patch rows x 64 (16 KB)
constexpr int kPointBytes = kBN * kBK * 2;     // one point's 128 weight rows x 64 (16 KB)
constexpr int kStageBytes = kABytes + kPts * kPointBytes;   // 48 KB
constexpr int kM1Tile = kM1 * kBK * 2, kM2Tile = kM2 * kBK * 2, kM3Tile = kM3 * kBK * 2;
constexpr int kMlpBytes = 3 * kM1Tile + 2 * kM2Tile + kM3Tile;   // 68 KB, resident
constexpr size_t kSmemBytes = 1024 + kStages * kStageBytes + kMlpBytes +
                              (2 * kStages + 1) * sizeof(uint64_t);

__device__ __forceinline__ int stage_of(int it) { return it % kStages; }
__device__ __forceinline__ unsigned parity_of(int it) { return (it / kStages) & 1; }

// TMA maps of bf16 tensors, boxes of rows x 64: h2 [P, C] (128-row boxes),
// the expansion w [k*128, C] (128), m[] the inv_mlp layers [128, kp1] (128),
// [64, 128] (64), [32, 64] (32).
struct Params {
  CUtensorMap h2, w, m[3];
  const float* lat;                        // [P, d]
  const float* b3r;                        // [k*128]
  const float* mb[3];                      // [128], [64], [32]
  const float* w4;                         // [32, 3]
  const float* b4;                         // [3]
  float* out;                              // [P, k, 3]
  int P, C, d, k;
  int ptiles;                              // tiles of 128 patch rows
  int tiles;                               // ptiles x point pairs
  int lat_steps;                           // k = 16 steps of the latent
};

// Tile `tile`: its point pair and first patch row (the patch tiles fastest:
// the blocks resident at one time share a pair's weight rows, which leave
// device memory about once per batch).
__device__ __forceinline__ void tile_of(const Params& p, int tile, int& jp, int& p0) {
  jp = tile / p.ptiles;
  p0 = (tile % p.ptiles) * kBM;
}

__device__ void producer(const Params& p, uint8_t* ring, uint8_t* mlp, uint64_t* full,
                         uint64_t* empty, uint64_t* wbar) {
  // the inv_mlp's bf16 tiles, once for the block's life
  mbar_expect_tx(wbar, kMlpBytes);
  for (int c = 0; c < 3; ++c) tma_load_2d(mlp + c * kM1Tile, &p.m[0], c * kBK, 0, wbar);
  for (int c = 0; c < 2; ++c)
    tma_load_2d(mlp + 3 * kM1Tile + c * kM2Tile, &p.m[1], c * kBK, 0, wbar);
  tma_load_2d(mlp + 3 * kM1Tile + 2 * kM2Tile, &p.m[2], 0, 0, wbar);
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    int jp, p0;
    tile_of(p, tile, jp, p0);
    for (int k0 = 0; k0 < p.C; k0 += kBK, ++it) {
      const int s = stage_of(it);
      mbar_wait_bounded(&empty[s], parity_of(it) ^ 1);
      uint8_t* st = ring + s * kStageBytes;
      mbar_expect_tx(&full[s], kStageBytes);
      tma_load_2d(st, &p.h2, k0, p0, &full[s]);
      for (int h = 0; h < kPts; ++h)
        tma_load_2d(st + kABytes + h * kPointBytes, &p.w, k0, (jp * kPts + h) * kBN, &full[s]);
    }
  }
}

// The inv_mlp's products, each one group of bf16 wgmma with B from the
// resident tiles: layer 1 over a point's fold (f, 8 steps) and the latent
// (la), layers 2 and 3 over the previous layer's packed output.
__device__ __forceinline__ void issue_l1(float* y1, unsigned (*f)[4], unsigned (*la)[4],
                                         uint64_t dm1, int lat_steps) {
#pragma unroll
  for (int i = 0; i < 64; ++i) y1[i] = 0.0f;
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 8; ++s)
    wgmma_bf16_m64n128k16(y1, f[s], dm1 + (s / 4) * (kM1Tile >> 4) + 2 * (s % 4));
#pragma unroll
  for (int s = 0; s < 4; ++s)
    if (s < lat_steps) wgmma_bf16_m64n128k16(y1, la[s], dm1 + 2 * (kM1Tile >> 4) + 2 * s);
  wgmma_commit();
}
__device__ __forceinline__ void issue_l2(float* y2, unsigned (*a2)[4], uint64_t dm2) {
#pragma unroll
  for (int i = 0; i < 32; ++i) y2[i] = 0.0f;
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 8; ++s)
    wgmma_bf16_m64n64k16(y2, a2[s], dm2 + (s / 4) * (kM2Tile >> 4) + 2 * (s % 4));
  wgmma_commit();
}
__device__ __forceinline__ void issue_l3(float* y3, unsigned (*a3)[4], uint64_t dm3) {
#pragma unroll
  for (int i = 0; i < 16; ++i) y3[i] = 0.0f;
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 4; ++s) wgmma_bf16_m64n32k16(y3, a3[s], dm3 + 2 * s);
  wgmma_commit();
}

// 32 -> 3 on the CUDA cores (w4 bf16-exact, b4 float32) after layer 3's
// bias, relu and rounding: each lane's 8 columns of rows pa and pa + 8,
// then the 4 lanes of a row in a fixed shuffle order, rounded to bf16
// after the bias, -> out[pa / pa + 8][j].
__device__ __forceinline__ void last_layer(const Params& p, float* y3, int j, int pa, int t) {
  bias_relu_bf16<kM3>(y3, p.mb[2], t);
  const int pb = pa + 8;
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

// One point's inv_mlp, each layer waited for before the next.
__device__ __forceinline__ void point_mlp(const Params& p, unsigned (*f)[4], unsigned (*la)[4],
                                          uint64_t dm1, uint64_t dm2, uint64_t dm3, int j,
                                          int pa, int t) {
  float y1[64];
  issue_l1(y1, f, la, dm1, p.lat_steps);
  wgmma_wait<0>();
  fence_regs<64>(y1);
  bias_relu_bf16<kM1>(y1, p.mb[0], t);
  unsigned a2[8][4];
  pack_steps<8>(a2, y1);
  float y2[32];
  issue_l2(y2, a2, dm2);
  wgmma_wait<0>();
  fence_regs<32>(y2);
  bias_relu_bf16<kM2>(y2, p.mb[1], t);
  unsigned a3[4][4];
  pack_steps<4>(a3, y2);
  float y3[16];
  issue_l3(y3, a3, dm3);
  wgmma_wait<0>();
  fence_regs<16>(y3);
  last_layer(p, y3, j, pa, t);
}

static_assert(kPts == 2, "pair_mlp takes a tile's two points");

// Both points' inv_mlp, interleaved: one point's products run while the
// other's bias, relu and packing run on the CUDA cores (wgmma groups end in
// order, so wgmma_wait<1> ends the older of the two in flight).
__device__ __forceinline__ void pair_mlp(const Params& p, unsigned (*f)[8][4],
                                         unsigned (*la)[4], uint64_t dm1, uint64_t dm2,
                                         uint64_t dm3, int j, int pa, int t) {
  float y1a[64], y1b[64];
  issue_l1(y1a, f[0], la, dm1, p.lat_steps);
  issue_l1(y1b, f[1], la, dm1, p.lat_steps);
  wgmma_wait<1>();
  fence_regs<64>(y1a);
  bias_relu_bf16<kM1>(y1a, p.mb[0], t);
  unsigned a2a[8][4];
  pack_steps<8>(a2a, y1a);
  float y2a[32];
  issue_l2(y2a, a2a, dm2);
  wgmma_wait<1>();
  fence_regs<64>(y1b);
  bias_relu_bf16<kM1>(y1b, p.mb[0], t);
  unsigned a2b[8][4];
  pack_steps<8>(a2b, y1b);
  float y2b[32];
  issue_l2(y2b, a2b, dm2);
  wgmma_wait<1>();
  fence_regs<32>(y2a);
  bias_relu_bf16<kM2>(y2a, p.mb[1], t);
  unsigned a3a[4][4];
  pack_steps<4>(a3a, y2a);
  float y3a[16];
  issue_l3(y3a, a3a, dm3);
  wgmma_wait<1>();
  fence_regs<32>(y2b);
  bias_relu_bf16<kM2>(y2b, p.mb[1], t);
  unsigned a3b[4][4];
  pack_steps<4>(a3b, y2b);
  float y3b[16];
  issue_l3(y3b, a3b, dm3);
  wgmma_wait<1>();
  fence_regs<16>(y3a);
  last_layer(p, y3a, j, pa, t);
  wgmma_wait<0>();
  fence_regs<16>(y3b);
  last_layer(p, y3b, j + 1, pa, t);
}

__device__ void consumer(const Params& p, const uint8_t* ring, const uint8_t* mlp,
                         uint64_t* full, uint64_t* empty, uint64_t* wbar) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, wg = warp / 4;
  const int r0 = wg * 64 + (warp % 4) * 16 + g;   // tile rows r0 and r0 + 8
  const uint64_t dm1 = smem_desc_sw128(mlp), dm2 = smem_desc_sw128(mlp + 3 * kM1Tile),
                 dm3 = smem_desc_sw128(mlp + 3 * kM1Tile + 2 * kM2Tile);
  // a consumed slot is free once every consumer warp is done with it
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  };
  mbar_wait_bounded(wbar, 0);
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    int jp, p0;
    tile_of(p, tile, jp, p0);
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;

    // the expansion, K = C in stages of 64 columns: both operands from the
    // slot (this warpgroup's 64 rows of h2, the two points' 256 weight
    // rows), one group of products in flight while the next slot lands
    int prev = -1;
    for (int k0 = 0; k0 < p.C; k0 += kBK, ++it) {
      const int s = stage_of(it);
      mbar_wait_bounded(&full[s], parity_of(it));
      const uint8_t* st = ring + s * kStageBytes;
      const uint64_t da = smem_desc_sw128(st + wg * 64 * 128), db = smem_desc_sw128(st + kABytes);
      fence_regs<128>(acc);
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < 4; ++q) wgmma_bf16_ss_m64n256k16(acc, da + 2 * q, db + 2 * q);
      wgmma_commit();
      fence_regs<128>(acc);
      if (prev >= 0) {
        wgmma_wait<1>();
        fence_regs<128>(acc);
        release(prev);
      }
      prev = s;
    }
    wgmma_wait<0>();
    fence_regs<128>(acc);
    release(prev);

    // the folds of both points, bf16(relu(expansion + bias)), as layer 1's A
    unsigned f[kPts][8][4];
#pragma unroll
    for (int h = 0; h < kPts; ++h) {
      const int j = min(jp * kPts + h, p.k - 1);
      bias_relu_bf16<kBN>(acc + 64 * h, p.b3r + static_cast<size_t>(j) * kBN, t);
      pack_steps<8>(f[h], acc + 64 * h);
    }
    // the latent's steps, the same for both points (columns past d are
    // zero, as are W's rows there; integer-valued, exact in bf16)
    const int pa = p0 + r0, pb = pa + 8;
    const float* la_row = p.lat + static_cast<size_t>(pa) * p.d;
    const float* lb_row = p.lat + static_cast<size_t>(pb) * p.d;
    unsigned la[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = 16 * s + 8 * h + 2 * t;
        float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (pa < p.P && col < p.d) v[0] = __ldg(la_row + col);
        if (pa < p.P && col + 1 < p.d) v[1] = __ldg(la_row + col + 1);
        if (pb < p.P && col < p.d) v[2] = __ldg(lb_row + col);
        if (pb < p.P && col + 1 < p.d) v[3] = __ldg(lb_row + col + 1);
        la[s][2 * h] = pack_bf16(v[0], v[1]);
        la[s][2 * h + 1] = pack_bf16(v[2], v[3]);
      }
    if (jp * kPts + 1 < p.k) {
      pair_mlp(p, f, la, dm1, dm2, dm3, jp * kPts, pa, t);
    } else {
      point_mlp(p, f[0], la, dm1, dm2, dm3, jp * kPts, pa, t);
    }
  }
}

// two consumer warpgroups and a producer warpgroup (one thread of it issues
// the loads), the producer's registers given to the consumers
constexpr int kThreads16 = kConsumers + 128;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

__global__ void __launch_bounds__(kThreads16, 1)
patch_decoder_bf16_kernel(const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* mlp = ring + kStages * kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(mlp + kMlpBytes);
  uint64_t* empty = full + kStages;
  uint64_t* wbar = empty + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    mbar_init(wbar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    regs_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers) producer(p, ring, mlp, full, empty, wbar);
  } else {
    regs_inc<kConsumerRegs>();
    consumer(p, ring, mlp, full, empty, wbar);
  }
}

}  // namespace dec16

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

// The bf16 instance: h2 [P, C] bf16 (C % 64 == 0), lat [P, d] f32 (0 < d <=
// 64); w [k*128, C], m1 [128, kp1] with kp1 = 128 + round_up(d, 16), m2
// [64, 128], m3 [32, 64], all bf16 (2-byte) K-major in their natural column
// order, 16-byte aligned; biases b3r, mb1..mb3 and b4 f32, w4 [32, 3] f32
// (bf16-exact); out [P, k, 3] f32. Returns a cudaError_t value.
extern "C" int patch_decoder_bf16_launch(const void* h2, const float* lat, int P, int C, int d,
                                         int k, const void* w, const float* b3r, const void* m1,
                                         const float* mb1, const void* m2, const float* mb2,
                                         const void* m3, const float* mb3, const float* w4,
                                         const float* b4, float* out, void* stream) {
  using dec16::kPts;
  const long long ptiles = (P + kBM - 1) / kBM, pairs = (k + kPts - 1) / kPts;
  if (P <= 0 || C < dec16::kBK || C % dec16::kBK != 0 || d <= 0 || d > kMaxD || k <= 0 ||
      ptiles * pairs > (1ll << 30) || static_cast<long long>(k) * kBN * C >= (1ll << 40))
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* ptr : {h2, w, m1, m2, m3})
    if (!aligned16(ptr)) return static_cast<int>(cudaErrorMisalignedAddress);
  if (encoder() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  dec16::Params p;
  const int kp1 = kBN + (d + 15) / 16 * 16;
  if (!make_map(&p.h2, h2, P, C, kBM, true) || !make_map(&p.w, w, k * kBN, C, kBN, true) ||
      !make_map(&p.m[0], m1, kM1, kp1, kM1, true) || !make_map(&p.m[1], m2, kM2, kM1, kM2, true) ||
      !make_map(&p.m[2], m3, kM3, kM2, kM3, true))
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
  p.lat_steps = (d + 15) / 16;

  p.ptiles = static_cast<int>(ptiles);
  p.tiles = static_cast<int>(ptiles * pairs);

  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dec16::patch_decoder_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dec16::kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = p.tiles < sms ? p.tiles : sms;
  dec16::patch_decoder_bf16_kernel<<<grid, dec16::kThreads16, dec16::kSmemBytes,
                                     static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
