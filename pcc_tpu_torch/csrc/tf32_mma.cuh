// 3xTF32 products on the H100's tensor cores, and the weight-gradient
// product built from them: shared by the backward kernels (the patch
// decoder takes split_tf32 for its wgmma products, wgmma_tf32.cuh).
//
// mma.sync m16n8k8 TF32 reads 10 bits of each operand's mantissa (the
// tensor cores ignore the 13 low bits of a float32 register). 3xTF32 splits
// every float32 operand into hi (x with those bits cleared) and lo = x - hi
// (exact in float32) and sums lo*hi + hi*lo + hi*hi into a float32
// accumulator: each product to about 2^-20 of its size (lo's own low bits
// and the lo*lo term are dropped), close to a float32 multiply-add, at three
// TF32 products' cost (495 TFLOP/s dense TF32 on an H100 SXM against 67
// TFLOP/s float32 on CUDA cores). The split is an AND and a subtraction, not
// cvt.rna.tf32 (a conversion per operand and half would cost more issue
// slots than the products). Accumulation order is fixed by the code, so a
// launch is bitwise repeatable.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 with .tf32), g = lane / 4,
// t = lane % 4: A (16 x 8, row) a0 = A[g][t], a1 = A[g + 8][t],
// a2 = A[g][t + 4], a3 = A[g + 8][t + 4]; B (8 x 8, col) b0 = B[t][g],
// b1 = B[t + 4][g]; C (16 x 8) c0 = C[g][2t], c1 = C[g][2t + 1],
// c2 = C[g + 8][2t], c3 = C[g + 8][2t + 1].

#pragma once

#include <cuda_runtime.h>

namespace pcc_mma {

// x -> (hi, lo) as TF32 operands: hi = x truncated to TF32, lo = x - hi.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b in 3xTF32: the small terms first, then hi * hi.
__device__ __forceinline__ void mma_3xtf32(float* c, const unsigned* a_hi, const unsigned* a_lo,
                                           const unsigned* b_hi, const unsigned* b_lo) {
  mma_tf32(c, a_lo, b_hi);
  mma_tf32(c, a_hi, b_lo);
  mma_tf32(c, a_hi, b_hi);
}

// 16-byte asynchronous copy global -> shared; src_bytes = 0 fills the 16
// bytes with zeros (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// The weight-gradient product: part[split][i][o] = sum over the split's
// rows r of X[r][i] * D[r][o], for i < cin, o < cout, rows in [split *
// chunk, min(rows, (split + 1) * chunk)). X [rows][ldx] and D [rows][ldd]
// are row-major in device memory, ldx >= round4(cin), ldd >= round4(cout),
// both multiples of 4, 16-byte aligned (their padding columns are read and
// may hold anything: they reach only outputs that are not stored). A block
// computes one kWBM x kWBN output tile (grid: cout tiles, cin tiles,
// splits) with 4 warps of 32 x 32, from kWK-row tiles of X and D that
// cp.async double-buffers in shared memory (rows past the range are filled
// with zeros). With vpart, the blocks of the first cin tile also sum, for
// their columns, D and D * T (T laid out as D; 0 where T is null) over
// their rows into vpart[split][0][o] (and the same sum again into
// vpart[split][2][o]) and vpart[split][1][o] (fixed order: per thread in row
// order, then the threads in order). Sums over a split in a fixed order; the
// caller adds the splits in order (split_sum_kernel).
constexpr int kWBM = 64, kWBN = 64, kWK = 32;
constexpr int kWThreads = 128;
constexpr int kWPad = 8;                           // row padding: conflict-free fragments
constexpr int kWLdX = kWBM + kWPad, kWLdD = kWBN + kWPad;
constexpr int kWStage = kWK * (kWLdX + 2 * kWLdD);  // floats per stage: X, D, T
constexpr size_t kWSmemBytes = 2 * kWStage * sizeof(float);
constexpr int kWMinSplitRows = 256;                 // rows per split, at least
constexpr int kWTargetBlocks = 8 * 132;             // blocks per product, about (132 SMs)

// Splits of `rows` for a cin x cout product: enough that the tiles times the
// splits fill the card several times over, none with fewer than
// kWMinSplitRows rows. Fixed by the shapes alone (not by the card), so the
// sums' order, and the bits, are too. Writes the rows per split to *chunk.
__host__ __device__ inline int wgrad_splits(int rows, int cin, int cout, int* chunk) {
  const int tiles = ((cin + kWBM - 1) / kWBM) * ((cout + kWBN - 1) / kWBN);
  int splits = (kWTargetBlocks + tiles - 1) / tiles;
  const int most = rows / kWMinSplitRows > 1 ? rows / kWMinSplitRows : 1;
  if (splits > most) splits = most;
  int c = (rows + splits - 1) / splits;
  c = (c + kWK - 1) / kWK * kWK;
  *chunk = c;
  return (rows + c - 1) / c;
}

// One block's tile of the weight-gradient product (wgrad_tf32_kernel's
// body): output tile (o0, i0) of split `split`; wsm the block's dynamic
// shared memory (kWSmemBytes).
__device__ __forceinline__ void wgrad_tile(const float* __restrict__ X, int ldx, int cin,
                                           const float* __restrict__ D, int ldd, int cout,
                                           const float* __restrict__ T, int rows, int chunk,
                                           float* __restrict__ part, float* __restrict__ vpart,
                                           int o0, int i0, int split, float* wsm) {
  const int r_begin = split * chunk;
  const int r_end = min(rows, r_begin + chunk);
  const bool vec = vpart != nullptr && i0 == 0;
  const bool vt = vec && T != nullptr;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  // one stage: kWK rows of X (kWBM columns), D and, with vec, T (kWBN columns)
  auto load = [&](int stage, int r0) {
    float* xs = wsm + stage * kWStage;
    float* ds = xs + kWK * kWLdX;
    float* ts = ds + kWK * kWLdD;
    for (int e = tid; e < kWK * (kWBM / 4); e += kWThreads) {
      const int rr = e / (kWBM / 4), c = (e % (kWBM / 4)) * 4, r = r0 + rr;
      const bool ok = r < r_end && i0 + c < ldx;
      cp_async16(xs + rr * kWLdX + c, ok ? X + static_cast<size_t>(r) * ldx + i0 + c : X,
                 ok ? 16 : 0);
    }
    for (int e = tid; e < kWK * (kWBN / 4); e += kWThreads) {
      const int rr = e / (kWBN / 4), c = (e % (kWBN / 4)) * 4, r = r0 + rr;
      const bool ok = r < r_end && o0 + c < ldd;
      const size_t off = ok ? static_cast<size_t>(r) * ldd + o0 + c : 0;
      cp_async16(ds + rr * kWLdD + c, D + off, ok ? 16 : 0);
      if (vt) cp_async16(ts + rr * kWLdD + c, T + off, ok ? 16 : 0);
    }
  };

  float acc[2][4][4] = {};
  const int vc = tid % kWBN, vh = tid / kWBN;      // vector sums: column, row phase
  constexpr int kVPhases = kWThreads / kWBN;
  float sd = 0.0f, sdt = 0.0f;
  if (r_begin < r_end) load(0, r_begin);
  cp_async_commit();
  int stage = 0;
  for (int r0 = r_begin; r0 < r_end; r0 += kWK, stage ^= 1) {
    if (r0 + kWK < r_end) load(stage ^ 1, r0 + kWK);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* xs = wsm + stage * kWStage;
    const float* ds = xs + kWK * kWLdX;
#pragma unroll
    for (int kk = 0; kk < kWK; kk += 8) {
      unsigned a_hi[2][4], a_lo[2][4], b_hi[4][2], b_lo[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* xa = xs + (kk + t) * kWLdX + wm + mt * 16 + g;
        split_tf32(xa[0], a_hi[mt][0], a_lo[mt][0]);
        split_tf32(xa[8], a_hi[mt][1], a_lo[mt][1]);
        split_tf32(xa[4 * kWLdX], a_hi[mt][2], a_lo[mt][2]);
        split_tf32(xa[4 * kWLdX + 8], a_hi[mt][3], a_lo[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* db = ds + (kk + t) * kWLdD + wn + nt * 8 + g;
        split_tf32(db[0], b_hi[nt][0], b_lo[nt][0]);
        split_tf32(db[4 * kWLdD], b_hi[nt][1], b_lo[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_3xtf32(acc[mt][nt], a_hi[mt], a_lo[mt], b_hi[nt], b_lo[nt]);
    }
    if (vec) {
      const float* ts = ds + kWK * kWLdD;
      for (int rr = vh; rr < kWK; rr += kVPhases) {
        const float d = ds[rr * kWLdD + vc];
        sd += d;
        if (vt) sdt = fmaf(d, ts[rr * kWLdD + vc], sdt);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  float* pp = part + static_cast<size_t>(split) * cin * cout;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + wm + mt * 16 + g + 8 * h;
        const int o = o0 + wn + nt * 8 + 2 * t;
        if (i < cin) {
          if (o < cout) pp[static_cast<size_t>(i) * cout + o] = acc[mt][nt][2 * h];
          if (o + 1 < cout) pp[static_cast<size_t>(i) * cout + o + 1] = acc[mt][nt][2 * h + 1];
        }
      }
  if (vec) {
    __syncthreads();
    float* red = wsm;                                  // [kVPhases][2][kWBN]
    red[(vh * 2) * kWBN + vc] = sd;
    red[(vh * 2 + 1) * kWBN + vc] = sdt;
    __syncthreads();
    if (tid < kWBN && o0 + tid < cout) {
      float a = 0.0f, b = 0.0f;
      for (int h = 0; h < kVPhases; ++h) {
        a += red[(h * 2) * kWBN + tid];
        b += red[(h * 2 + 1) * kWBN + tid];
      }
      float* vp = vpart + static_cast<size_t>(split) * 3 * cout + o0 + tid;
      vp[0] = a;
      vp[cout] = b;
      vp[2 * cout] = a;
    }
  }
}

__global__ void __launch_bounds__(kWThreads)
wgrad_tf32_kernel(const float* __restrict__ X, int ldx, int cin, const float* __restrict__ D,
                  int ldd, int cout, const float* __restrict__ T, int rows, int chunk,
                  float* __restrict__ part, float* __restrict__ vpart) {
  extern __shared__ __align__(16) float wsm[];
  wgrad_tile(X, ldx, cin, D, ldd, cout, T, rows, chunk, part, vpart, blockIdx.x * kWBN,
             blockIdx.y * kWBM, blockIdx.z, wsm);
}

// out[e] = sum over the splits, in order of k % 8 then k, of part[k *
// stride + e] for e < size (each of 8 lanes sums every 8th split, then the
// lanes in order), times scale[e % cols] for e < scaled. 256 threads: 32
// elements x 8 lanes.
__device__ __forceinline__ void split_sum_block(const float* __restrict__ part, int size,
                                                size_t stride, int splits,
                                                const float* __restrict__ scale, int cols,
                                                int scaled, float* __restrict__ out, int block) {
  __shared__ float red[8][32];
  const int e = block * 32 + threadIdx.x % 32, h = threadIdx.x / 32;
  float s = 0.0f;
  if (e < size) {
#pragma unroll 4
    for (int k = h; k < splits; k += 8) s += part[static_cast<size_t>(k) * stride + e];
  }
  red[h][threadIdx.x % 32] = s;
  __syncthreads();
  if (h == 0 && e < size) {
    float v = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) v += red[k][threadIdx.x];
    out[e] = e < scaled ? __fmul_rn(v, __ldg(scale + e % cols)) : v;
  }
}

__global__ void __launch_bounds__(256)
split_sum_kernel(const float* __restrict__ part, int size, size_t stride, int splits,
                 const float* __restrict__ scale, int cols, int scaled,
                 float* __restrict__ out) {
  split_sum_block(part, size, stride, splits, scale, cols, scaled, out, blockIdx.x);
}

}  // namespace pcc_mma
