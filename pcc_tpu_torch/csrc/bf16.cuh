// bf16 rounding for the kernels' bf16 instances (the patch encoder, the
// patch decoder and the "pppf" stage): float32 -> bf16 -> float32, round to
// nearest even, by the conversion intrinsics (PyTorch's build flags forbid
// implicit bf16 conversions; these kernels use none). The instances keep
// their activations as float32 values that are bf16-exact: a product of
// two of them is exact in float32 (8 + 8 significant bits), so an fma chain
// over bf16 operands is the float32 sum of exact products, which is what
// pcc_tpu's kernels compute with bf16 operands and a float32 accumulator.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace pcc_bf16 {

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// x rounded to bf16 where kBf16, else x as it is
template <bool kBf16>
__device__ __forceinline__ float act_round(float x) {
  if constexpr (kBf16) {
    return round_bf16(x);
  } else {
    return x;
  }
}

}  // namespace pcc_bf16
