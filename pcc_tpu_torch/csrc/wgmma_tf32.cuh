// Hopper's asynchronous pieces for float32 products on the tensor cores:
// TMA tile loads against mbarriers, and wgmma with the A operand in
// registers and B in shared memory, in TF32 (the tensor cores read 10
// mantissa bits of each operand; 3xTF32 with split_tf32 of tf32_mma.cuh
// keeps float32 accuracy). Shared by the kernels that stream K-major
// operand tiles through a ring of shared-memory stages.
//
// Layout: a B tile is R rows (its N) of 32 floats (its K), 128 bytes a row,
// written by TMA with CU_TENSOR_MAP_SWIZZLE_128B at a 1024-byte-aligned
// address: the 16-byte chunk c of row r lies at r * 128 + ((c ^ (r % 8)) *
// 16). smem_desc_sw128 describes such a tile to wgmma (K-major, 128-byte
// swizzle, 8-row groups 1024 bytes apart); adding 2 to the descriptor moves
// its start 32 bytes (8 floats, one k = 8 step) along K, as the hardware
// applies the swizzle to the address bits. For .tf32, wgmma takes B only
// K-major (it has no transpose for 32-bit types).
//
// Fragments (PTX ISA, wgmma .m64nNk8 .tf32), per warp w of the warpgroup,
// g = lane / 4, t = lane % 4: A rows 16w + g (+8): a0 = A[g][t], a1 =
// A[g + 8][t], a2 = A[g][t + 4], a3 = A[g + 8][t + 4]; the accumulator
// d[4i + e] holds row 16w + g + 8 * (e / 2), column 8i + 2t + e % 2.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace pcc_wgmma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers ---
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// arrive once and add `bytes` to the transaction count the phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// mbar_wait that gives up: a wait that outlasts 2^22 polls (tenths of seconds,
// far beyond any phase of these kernels) traps, so that a fault in a barrier
// protocol ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait_bounded(uint64_t* bar, unsigned parity) {
  for (unsigned spins = 0;; ++spins) {
    unsigned done;
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.b32 %0, 1, 0, P1;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 22)) __trap();
  }
}

// --- registers: a warpgroup gives some back or takes more (every thread of
// the warpgroup executes it; R a multiple of 8 in [24, 256]) ---
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// --- TMA: one thread copies a box of a 2-D tensor map (c0 along the inner
// dimension, c1 along the outer) to shared memory; the box's bytes count
// against bar's transaction count (out-of-bounds elements arrive as zeros)
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// --- wgmma ---
__device__ __forceinline__ uint64_t smem_desc_sw128(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFFull) >> 4)       // start address, 16-byte units
         | (1ull << 16)                    // leading byte offset: unused (swizzled K-major)
         | ((1024ull >> 4) << 32)          // stride byte offset: 8-row groups
         | (1ull << 62);                   // 128-byte swizzle
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}
// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma uses across the wait that ends it.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(unsigned* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d[0:64] += a * B over k = 8 (m64n128k8): A (64 x 8) in registers as
// mma.m16n8k8 fragments per warp, B (8 x 128) K-major in shared memory
// behind desc_b; d is the warpgroup's 64 x 128 accumulator fragment.
__device__ __forceinline__ void wgmma_m64n128k8(float* d, const unsigned* a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
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

// d[0:32] += a * B over k = 8 (m64n64k8): A (64 x 8) in registers as
// mma.m16n8k8 fragments per warp, B (8 x 64) K-major in shared memory
// behind desc_b; d is the warpgroup's 64 x 64 accumulator fragment.
__device__ __forceinline__ void wgmma_m64n64k8(float* d, const unsigned* a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[0:16] += a * B over k = 8 (m64n32k8): A (64 x 8) in registers as
// mma.m16n8k8 fragments per warp, B (8 x 32) K-major in shared memory
// behind desc_b; d is the warpgroup's 64 x 32 accumulator fragment.
__device__ __forceinline__ void wgmma_m64n32k8(float* d, const unsigned* a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

}  // namespace pcc_wgmma
