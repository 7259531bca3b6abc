// Block-level dense layers over activations in shared memory, shared by the
// patch encoder and patch decoder kernels.
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
// through the read-only cache instead of shared memory. rows % RT == 0.
template <int RT, bool kRelu, bool kGlobalW>
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
      out[(g * RT + i) * ld_out + o] = v;
    }
  }
}

// The same product for groups of RT rows, followed by relu and a max over
// each group: out[g][o] = max_i relu(row g*RT+i of the product + bias[o]).
// Rounding is monotone, so max_i(acc_i) + b equals max_i(acc_i + b).
template <int RT, bool kGlobalW>
__device__ __forceinline__ void dense_relu_groupmax(const float* in, int ld_in,
                                                    int groups, int cin,
                                                    const float* w,
                                                    const float* bias, int cout,
                                                    float* out, int ld_out) {
  const int items = groups * cout;
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
    float m = acc[0];
#pragma unroll
    for (int i = 1; i < RT; ++i) m = fmaxf(m, acc[i]);
    out[g * ld_out + o] = fmaxf(m + load_w<kGlobalW>(bias + o), 0.0f);
  }
}

}  // namespace pcc
