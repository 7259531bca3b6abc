// wgmma with bf16 operands and a float32 accumulator, A in registers (or,
// for the patch decoder's expansion, in shared memory too: the _ss_ form)
// and B K-major in shared memory (the bf16 instances): the
// companion of wgmma_tf32.cuh, whose mbarriers, TMA loads, descriptors,
// fences and fragment layout it shares. A B tile is R rows (its N) of 64
// bf16 (its K), 128 bytes a row, 128-byte swizzled by TMA: the same bytes per
// row as a TF32 tile of 32 floats, so smem_desc_sw128 describes it and adding
// 2 to the descriptor moves 32 bytes (16 bf16, one k = 16 step) along K.
//
// Fragments (PTX ISA, wgmma .m64nNk16 with A in registers), per warp w of
// the warpgroup, g = lane / 4, t = lane % 4: a0 = {A[g][2t], A[g][2t + 1]},
// a1 = {A[g + 8][2t], A[g + 8][2t + 1]}, a2 = {A[g][2t + 8], A[g][2t + 9]},
// a3 = {A[g + 8][2t + 8], A[g + 8][2t + 9]} of rows 16w + g (+8), the lower
// column in the lower 16 bits; the accumulator is laid out as for .tf32
// (d[4i + e]: row 16w + g + 8 * (e / 2), column 8i + 2t + e % 2), so an
// accumulator's 8-column blocks 2q and 2q + 1 are the next product's A for
// the k = 16 step q as they stand.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "bf16.cuh"
#include "wgmma_tf32.cuh"

namespace pcc_wgmma {

// two float32 values rounded to bf16 (round to nearest even) in one
// register, `lo` in the lower 16 bits
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// d[0:64] += a * B over k = 16 (m64n128k16, bf16 operands, float32
// accumulator): A (64 x 16) in registers as mma.m16n8k16 fragments per warp
// (pack_bf16), B (16 x 128) K-major in shared memory behind desc_b (not
// transposed); d is the warpgroup's 64 x 128 accumulator fragment.
__device__ __forceinline__ void wgmma_bf16_m64n128k16(float* d, const unsigned* a,
                                                     uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[0:32] += a * B over k = 16 (m64n64k16, bf16 operands, float32
// accumulator): A (64 x 16) in registers as mma.m16n8k16 fragments per warp
// (pack_bf16), B (16 x 64) K-major in shared memory behind desc_b (not
// transposed); d is the warpgroup's 64 x 64 accumulator fragment.
__device__ __forceinline__ void wgmma_bf16_m64n64k16(float* d, const unsigned* a,
                                                     uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[0:16] += a * B over k = 16 (m64n32k16, bf16 operands, float32
// accumulator): A (64 x 16) in registers as mma.m16n8k16 fragments per warp
// (pack_bf16), B (16 x 32) K-major in shared memory behind desc_b (not
// transposed); d is the warpgroup's 64 x 32 accumulator fragment.
__device__ __forceinline__ void wgmma_bf16_m64n32k16(float* d, const unsigned* a,
                                                     uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[0:128] += A * B over k = 16 (m64n256k16, bf16 operands, float32
// accumulator), both operands K-major in shared memory: A (64 x 16) behind
// desc_a, B (16 x 256) behind desc_b (neither transposed); d is the
// warpgroup's 64 x 256 accumulator fragment.
__device__ __forceinline__ void wgmma_bf16_ss_m64n256k16(float* d, uint64_t desc_a,
                                                        uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// y = round_bf16(relu(y + b)) on an accumulator fragment of N columns (b
// float32, this lane's columns 8 i + 2 t and + 1).
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

// a[s] = the next product's A fragment for k-step s: columns 16 s .. 16 s +
// 15 of an accumulator x (its n8 tiles 2 s and 2 s + 1) packed in bf16 pairs
template <int S>
__device__ __forceinline__ void pack_steps(unsigned (*a)[4], const float* x) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* xi = x + 4 * (2 * s + h);
      a[s][2 * h] = pack_bf16(xi[0], xi[1]);
      a[s][2 * h + 1] = pack_bf16(xi[2], xi[3]);
    }
}

}  // namespace pcc_wgmma
