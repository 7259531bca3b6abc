// wgmma with bf16 operands and a float32 accumulator, A in registers and B
// K-major in shared memory (the bf16 instance of the patch decoder): the
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

}  // namespace pcc_wgmma
