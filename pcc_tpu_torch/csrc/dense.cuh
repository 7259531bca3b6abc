// Block-level dense layers over activations in shared memory, shared by the
// patch encoder, its backward and SetAbstraction alone.
//
// out[r][o] = act(sum_k in[r][k] * W[k][o] + bias[o]) for a tile of rows.
// W is [cin][cout] row-major (the flax "kernel" layout). Each work item is
// one output column o for RT consecutive rows, so every weight a thread
// loads is reused RT times from a register; the threads of a warp take
// consecutive columns, so their weight loads coalesce and their activation
// loads are shared-memory broadcasts. Loads per multiply-add approach
// (RT + 1) / RT: this is the simple form, not a tensor-core product.

#pragma once

#include <cuda_runtime.h>

#include "bf16.cuh"

namespace pcc {

template <bool kGlobal>
__device__ __forceinline__ float load_w(const float* p) {
  if constexpr (kGlobal) {
    return __ldg(p);
  } else {
    return *p;
  }
}

// RT rows per work item; kRelu applies max(., 0); kGlobalW reads W and bias
// through the read-only cache instead of shared memory; kBf16 rounds every
// output to bf16 after the bias and relu (the encoder backward's bf16
// instance). rows % RT == 0.
template <int RT, bool kRelu, bool kGlobalW, bool kBf16 = false>
__device__ __forceinline__ void dense_rows(const float* in, int ld_in, int rows,
                                           int cin, const float* w,
                                           const float* bias, int cout,
                                           float* out, int ld_out) {
  const int items = (rows / RT) * cout;
  for (int e = threadIdx.x; e < items; e += blockDim.x) {
    const int o = e % cout;
    const int g = e / cout;
    const float* x = in + g * RT * ld_in;
    float acc[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) acc[i] = 0.0f;
    for (int k = 0; k < cin; ++k) {
      const float wk = load_w<kGlobalW>(w + k * cout + o);
#pragma unroll
      for (int i = 0; i < RT; ++i) acc[i] = fmaf(x[i * ld_in + k], wk, acc[i]);
    }
    const float b = load_w<kGlobalW>(bias + o);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      float v = acc[i] + b;
      if (kRelu) v = fmaxf(v, 0.0f);
      out[(g * RT + i) * ld_out + o] = pcc_bf16::act_round<kBf16>(v);
    }
  }
}

// What dense_tile does with a work item's outputs.
enum TileEpilogue {
  kTileRelu,      // out[r][o] = max(acc + b, 0)
  kTileLinear,    // out[r][o] = acc + b
  kTileGroupMax,  // the TM rows are one group: out[g][o] = max(max_i acc_i + b, 0)
};

// The register-tiled form of the same product: a work item is TM rows x 4
// columns, so every 16-byte weight load serves TM rows and every 16-byte
// activation broadcast serves 4 columns (dense_rows reads one activation
// from shared memory per multiply-add, and shared memory issues loads at a
// quarter of the FMA rate). Each output is still acc = fma(x[k], w[k][o],
// acc) for k = 0, 1, ... from 0, then + b: dense_rows' sums bit for bit. The
// lanes of a warp take 4-column groups of the same rows (min(cout / 4, 32)
// lanes a row group), and the warps of a block take the row groups of one
// column span together, so that they read the same weights at the same time.
// W is [cin][ldw] row-major, read through the read-only cache from the
// column offset of w; w, the rows of in and out are 16-byte aligned
// (ldw, ld_in, ld_out % 4 == 0). cout / 4 divides 32 or is a multiple of 32;
// rows % TM == 0. With kTileGroupMax, rounding is monotone, so
// max_i(acc_i) + b equals max_i(acc_i + b), and out[g] is stored by scalars
// (its rows need not be aligned). kBf16 (the encoder's bf16 instance): every
// output rounded to bf16 after the bias and relu (with kTileGroupMax after
// the max, which rounding, being monotone, commutes with). No trailing
// barrier.
template <int TM, int kEpi, bool kBf16 = false>
__device__ __forceinline__ void dense_tile(const float* in, int ld_in, int rows, int cin,
                                           const float* __restrict__ w, int ldw,
                                           const float* __restrict__ bias, int cout,
                                           float* out, int ld_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int lanes = cout / 4 < 32 ? cout / 4 : 32;   // lanes per row group
  const int per_warp = 32 / lanes;                   // row groups per warp
  const int span = 4 * lanes;                        // columns per warp
  const int groups = rows / TM;
  const int gblocks = (groups + per_warp - 1) / per_warp;
  const int cin4 = cin & ~3;
  for (int item = warp; item < gblocks * (cout / span); item += warps) {
    const int g = (item % gblocks) * per_warp + lane / lanes;
    const int col = (item / gblocks) * span + (lane % lanes) * 4;
    if (g >= groups) continue;
    const float* x = in + g * TM * ld_in;
    const float* wc = w + col;
    float acc[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
    for (int k = 0; k < cin4; k += 4) {
      const float4 w0 = __ldg(reinterpret_cast<const float4*>(wc + (k + 0) * ldw));
      const float4 w1 = __ldg(reinterpret_cast<const float4*>(wc + (k + 1) * ldw));
      const float4 w2 = __ldg(reinterpret_cast<const float4*>(wc + (k + 2) * ldw));
      const float4 w3 = __ldg(reinterpret_cast<const float4*>(wc + (k + 3) * ldw));
#pragma unroll
      for (int i = 0; i < TM; ++i) {
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
      for (int i = 0; i < TM; ++i) {
        const float xv = x[i * ld_in + k];
        acc[i][0] = fmaf(xv, wk.x, acc[i][0]);
        acc[i][1] = fmaf(xv, wk.y, acc[i][1]);
        acc[i][2] = fmaf(xv, wk.z, acc[i][2]);
        acc[i][3] = fmaf(xv, wk.w, acc[i][3]);
      }
    }
    const float4 b = __ldg(reinterpret_cast<const float4*>(bias + col));
    if (kEpi == kTileGroupMax) {
      float m[4] = {acc[0][0], acc[0][1], acc[0][2], acc[0][3]};
#pragma unroll
      for (int i = 1; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) m[j] = fmaxf(m[j], acc[i][j]);
      float* o = out + g * ld_out + col;
      o[0] = pcc_bf16::act_round<kBf16>(fmaxf(m[0] + b.x, 0.0f));
      o[1] = pcc_bf16::act_round<kBf16>(fmaxf(m[1] + b.y, 0.0f));
      o[2] = pcc_bf16::act_round<kBf16>(fmaxf(m[2] + b.z, 0.0f));
      o[3] = pcc_bf16::act_round<kBf16>(fmaxf(m[3] + b.w, 0.0f));
    } else {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float4 v = make_float4(acc[i][0] + b.x, acc[i][1] + b.y, acc[i][2] + b.z,
                               acc[i][3] + b.w);
        if (kEpi == kTileRelu) {
          v.x = fmaxf(v.x, 0.0f);
          v.y = fmaxf(v.y, 0.0f);
          v.z = fmaxf(v.z, 0.0f);
          v.w = fmaxf(v.w, 0.0f);
        }
        v.x = pcc_bf16::act_round<kBf16>(v.x);
        v.y = pcc_bf16::act_round<kBf16>(v.y);
        v.z = pcc_bf16::act_round<kBf16>(v.z);
        v.w = pcc_bf16::act_round<kBf16>(v.w);
        *reinterpret_cast<float4*>(out + (g * TM + i) * ld_out + col) = v;
      }
    }
  }
}

}  // namespace pcc
