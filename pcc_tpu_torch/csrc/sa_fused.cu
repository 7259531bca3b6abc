// SetAbstraction alone, one block per patch, one launch.
//
// Replaces the TPU kernel pcc_tpu/ops/sa_pallas.py::_sa_kernel (entry
// sa_fused). Per [N, 3] patch: the expanded-form squared distances
// max((sq_i - 2 cross_ij) + sq_j, 0); the knn nearest neighbours of every
// point in ascending (distance, index) order; the centred neighbours
// through the MLP 3 -> 32 -> 64 -> 128 with relu; the max over the
// neighbours. Output: per-point features [P, N, 128] f32.
//
// It is the first half of the patch encoder (patch_encoder.cu) and is
// built from the same pieces of encoder_common.cuh: the selection is the
// encoder's bit for bit, and the MLP sums run in the encoder's order.
//
// What bounds it on an H100: operations. 2 * knn * 10336 FLOP per point
// (85 MFLOP per patch of 256 points at knn = 16, about 347 GFLOP for 4096
// such patches) against 12 bytes in and 512 bytes out per point: about 650
// operations per byte, above the card's balance, so the floor is
// FLOPs / 67 TFLOP/s.
// What the design does about it: nothing of the grouped activations leaves
// the SM. Each thread keeps one query's sorted top-knn in registers
// while it scans the patch in shared memory; the MLP runs over steps of 128
// grouped rows (128 / knn query points), whose layers 1 and 2 live in
// shared memory; layer 3, its relu and the max over neighbours write each
// query's 128 features straight to device memory. Layers 2 and 3 are the
// encoder's register-tiled products (dense.cuh::dense_tile; a thread takes
// 8 rows, or one query's knn rows, x 4 columns), the weights are read
// through the read-only cache, and a block takes 61 KB of shared memory at
// N = 256, so that two share an SM. Tensor cores are later work.

#include <cuda_runtime.h>

#include "encoder_common.cuh"

namespace {

using namespace pcc;

constexpr int kThreads = kEncThreads;

struct Layout {
  int sx, sy, sz, sq;   // patch points (SoA) and squared norms
  int h;                // grouped rows of layers 1 and 2
  int floats;           // float words before the neighbour table
  size_t bytes;         // total dynamic shared memory
};

inline Layout make_layout(int n, int knn) {
  Layout L;
  int off = 0;
  L.sx = off; off += n;
  L.sy = off; off += n;
  L.sz = off; off += n;
  L.sq = off; off += n;
  L.h = off; off += kEncSaRows * (kEncC1 + kEncC2);
  L.floats = off;
  L.bytes = static_cast<size_t>(off) * sizeof(float) +
            static_cast<size_t>(n) * knn * sizeof(unsigned short);
  return L;
}

template <int KNN>
__global__ void __launch_bounds__(kThreads, 2)
sa_fused_kernel(const float* __restrict__ pts, int n, Layout L,
                const float* __restrict__ w1, const float* __restrict__ b1,
                const float* __restrict__ w2, const float* __restrict__ b2,
                const float* __restrict__ w3, const float* __restrict__ b3,
                float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* sx = smem + L.sx;
  float* sy = smem + L.sy;
  float* sz = smem + L.sz;
  float* sq = smem + L.sq;
  float* h1 = smem + L.h;                     // [kEncSaRows, kEncC1]
  float* h2 = h1 + kEncSaRows * kEncC1;       // [kEncSaRows, kEncC2]
  unsigned short* nbr = reinterpret_cast<unsigned short*>(smem + L.floats);

  load_patch(pts + static_cast<size_t>(blockIdx.x) * n * 3, n, sx, sy, sz, sq);
  select_knn<KNN>(sx, sy, sz, sq, n, nbr);
  float* feats = out + static_cast<size_t>(blockIdx.x) * n * kEncC3;
  // n % kEncQ == 0, and a step's kEncSaRows / KNN queries divide kEncQ
  for (int c0 = 0; c0 < n; c0 += kEncSaRows / KNN)
    sa_step<KNN>(QueryRange{c0}, nbr, sx, sy, sz, w1, b1, w2, b2, w3, b3, h1, h2,
                 feats + static_cast<size_t>(c0) * kEncC3, kEncC3);
}

template <int KNN>
int launch(const float* pts, int p, int n, const float* const* w, float* out,
           cudaStream_t stream) {
  const Layout L = make_layout(n, KNN);
  cudaError_t err = cudaFuncSetAttribute(sa_fused_kernel<KNN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  sa_fused_kernel<KNN><<<p, kThreads, L.bytes, stream>>>(pts, n, L, w[0], w[1], w[2], w[3],
                                                         w[4], w[5], out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pts: [p, n, 3] f32. Weights [in, out] row-major f32 and biases [out]:
// 3 -> 32 -> 64 -> 128. out: [p, n, 128] f32. Returns a cudaError_t value.
extern "C" int sa_fused_launch(const float* pts, int p, int n, int knn, const float* w1,
                               const float* b1, const float* w2, const float* b2,
                               const float* w3, const float* b3, float* out, void* stream) {
  if (p <= 0 || n % kEncQ != 0 || n > kEncMaxN || n < knn)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* w[6] = {w1, b1, w2, b2, w3, b3};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (knn) {
    case 8:
      return launch<8>(pts, p, n, w, out, s);
    case 16:
      return launch<16>(pts, p, n, w, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
