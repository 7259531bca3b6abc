// The whole IPDAE patch encoder, one block per patch, one launch.
//
// Replaces the TPU kernel pcc_tpu/ops/sa_pallas.py::_encoder_kernel
// (entry patch_encoder_fused). Per [N, 3] patch it computes: the
// expanded-form squared distances max((sq_i - 2 cross_ij) + sq_j, 0); the
// knn nearest neighbours of every point in ascending (distance, index)
// order; the centred neighbours; the SetAbstraction MLP 3 -> 32 -> 64 ->
// 128 with relu and a max over neighbours; the concat with xyz (131
// channels); the PointNet MLP 131 -> 128 -> 256 -> 512 -> D (no relu on the
// last layer) and a max over points. Output: the pre-spread latent [P, D].
//
// What bounds it on an H100: operations. About 181 MFLOP per patch at
// N = 256, knn = 16, D = 16 (0.74 TFLOP per 64-cloud batch of 4096
// patches) against 12 KB of input, so far above the card's bytes-to-FLOP
// balance; in float32 on CUDA cores the floor is FLOPs / 67 TFLOP/s.
// What the design does about it: nothing of the grouped activations leaves
// the SM. The TPU kernel's [N, N] distance matrix (256 KB) does not fit in
// shared memory, so each thread keeps a sorted top-knn list of one query
// in registers while it scans the patch's points (held in shared memory).
// The MLPs then run over chunks of 32 points (encoder_common.cuh): the
// SetAbstraction MLP on 128 grouped rows at a time (8 points x 16
// neighbours), its max written into the chunk's concat rows, then the
// PointNet MLP on the 32 rows, so that each weight the block reads from L2
// serves 32 points. Every layer is a register-tiled product
// (dense.cuh::dense_tile): a thread takes 4 or 8 rows (SetAbstraction's last
// layer: one point's 16 neighbours) x 4 columns, with 16-byte activation
// broadcasts from shared memory and 16-byte weight loads through the
// read-only cache, where the simple form read one activation from shared
// memory per multiply-add. The grouped rows alias the PointNet rows, the
// PointNet layer 3 runs in two 256-column steps folded straight into the
// last layer's sums (kept in registers), and the weights stay in device
// memory (L2 and the read-only cache): 78 KB of shared memory a block at
// N = 256, so two 256-thread blocks share an SM.
// Sums keep the simple form's order (k from 0, then the bias), so the
// latents are bit for bit those of that form. It is not a tensor-core
// product (TF32 would not hold the 1e-4 agreement with the plain version).
//
// On request (a non-null `winners`, as the train step's forward asks) the
// fold of each chunk into the latent also keeps, per latent channel, the
// first point that reaches its max (strict > from -inf, chunks and rows in
// order): the point through which the backward kernel
// (patch_encoder_bwd.cu) routes that channel's gradient, which it would
// otherwise have to find with a second forward. The latent itself stays the
// fmaxf fold, so it is the same bit for bit either way.
//
// The bf16 instance (patch_encoder_bf16_launch; pcc_tpu's compute_dtype
// bfloat16): the same kernel, templated on the rounding
// (encoder_common.cuh::encoder_chunk, bf16.cuh). The wrapper rounds every
// weight and bias to bf16, as the TPU kernel's `load` does; the kernel rounds
// the centred neighbours, xyz and every layer's output (after its relu, the
// last layer's after its bias) where sa_pallas.py:163-210 casts to bf16.
// Products of bf16 values are exact in float32, so every output is still
// the float32 sum of exact products in k-order, which
// ops/sa_cuda.py::_kernel_choices replays with the same rounding. Its bound
// is the float32 instance's work: bf16 tensor cores would take it at 989
// TFLOP/s, these CUDA cores at 67. In bf16 training the winners are not
// the forward's: pcc_tpu's bf16 backward kernel replays the forward with
// the weights rounded but the biases float32 (sa_pallas.py:305-314) and
// routes its gradient through that replay's arg-max points (:392). So the
// bf16 instance with winners runs a grid of two halves in one launch:
// blockIdx.y 0 computes the latent on the rounded biases, blockIdx.y 1 the
// same forward on the float32 biases the wrapper hands it beside them, and
// keeps only its winners. That doubles the forward's work in a bf16 train
// step, in exchange for the backward's own routing.
//
// Selection is bit-equal to the plain PyTorch version
// (pcc_tpu_torch/ops/sa_cuda.py::patch_encoder_plain): the same distance
// formula, one rounding per operation, and the lower index first among
// equal distances. The selection and the per-chunk forward live in
// encoder_common.cuh, which the backward kernel (patch_encoder_bwd.cu)
// shares, so its recomputed forward is this one bit for bit.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "encoder_common.cuh"

namespace {

using namespace pcc;

constexpr int kThreads = kEncThreads;

struct Layout {
  int sx, sy, sz, sq;                // patch points (SoA) and squared norms
  int chunk;                         // a chunk's rows (encoder_common.cuh)
  int lat;                           // running max
  int win;                           // running arg-max (int), with winners
  int floats;                        // float words before the neighbour table
  size_t bytes;                      // total dynamic shared memory
};

__host__ __device__ inline Layout make_layout(int n, int knn) {
  Layout L;
  int off = 0;
  L.sx = off; off += n;
  L.sy = off; off += n;
  L.sz = off; off += n;
  L.sq = off; off += n;
  L.chunk = off; off += kEncChunkWords;
  L.lat = off; off += kEncMaxD;
  L.win = off; off += kEncMaxD;
  L.floats = off;
  L.bytes = static_cast<size_t>(off) * sizeof(float) +
            static_cast<size_t>(n) * knn * sizeof(unsigned short);
  return L;
}

template <int KNN, bool kWinners, bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
patch_encoder_kernel(const float* __restrict__ pts, int n,
                     const float* __restrict__ w1, const float* __restrict__ b1,
                     const float* __restrict__ w2, const float* __restrict__ b2,
                     const float* __restrict__ w3, const float* __restrict__ b3,
                     const float* __restrict__ pw1, const float* __restrict__ pb1,
                     const float* __restrict__ pw2, const float* __restrict__ pb2,
                     const float* __restrict__ pw3, const float* __restrict__ pb3,
                     const float* __restrict__ pw4, const float* __restrict__ pb4,
                     int dout, float* __restrict__ out, int* __restrict__ winners,
                     const float* __restrict__ rb1, const float* __restrict__ rb2,
                     const float* __restrict__ rb3, const float* __restrict__ rpb1,
                     const float* __restrict__ rpb2, const float* __restrict__ rpb3,
                     const float* __restrict__ rpb4) {
  // bf16 with winners: blockIdx.y 1 is the backward's replay (biases rb*,
  // rpb*), which writes the winners; blockIdx.y 0 writes the latent
  constexpr bool kHalves = kWinners && kBf16;
  const bool replay = kHalves && blockIdx.y == 1;
  if (replay) {
    b1 = rb1;
    b2 = rb2;
    b3 = rb3;
    pb1 = rpb1;
    pb2 = rpb2;
    pb3 = rpb3;
    pb4 = rpb4;
  }
  const Layout L = make_layout(n, KNN);
  extern __shared__ __align__(16) float smem[];
  float* sx = smem + L.sx;
  float* sy = smem + L.sy;
  float* sz = smem + L.sz;
  float* sq = smem + L.sq;
  float* chunk = smem + L.chunk;
  const float* o4 = chunk + kEncX2Off;     // [kEncPnQ, dout]
  float* lat = smem + L.lat;               // [dout]
  int* win = reinterpret_cast<int*>(smem + L.win);   // [dout], with kWinners
  unsigned short* nbr = reinterpret_cast<unsigned short*>(smem + L.floats);

  const int tid = threadIdx.x;
  for (int i = tid; i < dout; i += blockDim.x) {
    lat[i] = -CUDART_INF_F;
    if (kWinners) win[i] = 0;
  }
  load_patch(pts + static_cast<size_t>(blockIdx.x) * n * 3, n, sx, sy, sz, sq);
  select_knn<KNN>(sx, sy, sz, sq, n, nbr);

  for (int c0 = 0; c0 < n; c0 += kEncPnQ) {
    const int nq = min(kEncPnQ, n - c0);
    encoder_chunk<KNN, kBf16>(c0, nq, nbr, sx, sy, sz, w1, b1, w2, b2, w3, b3, pw1, pb1, pw2,
                              pb2, pw3, pb3, pw4, pb4, dout, chunk);
    if (tid < dout) {
      float m = lat[tid];
      if (kWinners) {
        int w = win[tid];
        for (int r = 0; r < nq; ++r) {
          const float v = o4[r * dout + tid];
          if (v > m) w = c0 + r;
          m = fmaxf(m, v);
        }
        win[tid] = w;
      } else {
        for (int r = 0; r < nq; ++r) m = fmaxf(m, o4[r * dout + tid]);
      }
      lat[tid] = m;
    }
  }
  __syncthreads();
  if (tid < dout) {
    if (!replay) out[static_cast<size_t>(blockIdx.x) * dout + tid] = lat[tid];
    if (kWinners && (replay || !kHalves))
      winners[static_cast<size_t>(blockIdx.x) * dout + tid] = win[tid];
  }
}

// rb: the replay's 7 biases (bf16 with winners), else null.
template <int KNN, bool kWinners, bool kBf16 = false>
int launch(const float* pts, int p, int n, const float* const* w, int dout,
           float* out, int* winners, const float* const* rb, cudaStream_t stream) {
  const Layout L = make_layout(n, KNN);
  cudaError_t err = cudaFuncSetAttribute(patch_encoder_kernel<KNN, kWinners, kBf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* none[7] = {};
  if (rb == nullptr) rb = none;
  patch_encoder_kernel<KNN, kWinners, kBf16>
      <<<dim3(p, kWinners && kBf16 ? 2 : 1), kThreads, L.bytes, stream>>>(
          pts, n, w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7], w[8], w[9], w[10],
          w[11], w[12], w[13], dout, out, winners, rb[0], rb[1], rb[2], rb[3], rb[4], rb[5],
          rb[6]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pts: [p, n, 3] f32. Weights [in, out] row-major f32 and biases [out]:
// SetAbstraction 3->32->64->128, PointNet 131->128->256->512->dout.
// out: [p, dout] f32; winners: [p, dout] int32 (each latent channel's first
// arg-max point) or null. Returns a cudaError_t value.
extern "C" int patch_encoder_launch(const float* pts, int p, int n, int knn,
                                    const float* w1, const float* b1,
                                    const float* w2, const float* b2,
                                    const float* w3, const float* b3,
                                    const float* pw1, const float* pb1,
                                    const float* pw2, const float* pb2,
                                    const float* pw3, const float* pb3,
                                    const float* pw4, const float* pb4, int dout,
                                    float* out, int* winners, void* stream) {
  if (p <= 0 || n % kEncQ != 0 || n > kEncMaxN || n < knn || dout <= 0 ||
      dout > kEncMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* w[14] = {w1, b1, w2, b2, w3, b3, pw1, pb1, pw2, pb2, pw3, pb3, pw4, pb4};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (knn) {
    case 8:
      return winners ? launch<8, true>(pts, p, n, w, dout, out, winners, nullptr, s)
                     : launch<8, false>(pts, p, n, w, dout, out, nullptr, nullptr, s);
    case 16:
      return winners ? launch<16, true>(pts, p, n, w, dout, out, winners, nullptr, s)
                     : launch<16, false>(pts, p, n, w, dout, out, nullptr, nullptr, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bf16 instance: the arguments of patch_encoder_launch, the weights and
// biases bf16-exact (rounded by the wrapper), then (with winners, in bf16
// training) the replay's biases rb1, rb2, rb3, rpb1 .. rpb4 (float32, as
// pcc_tpu's bf16 backward adds them), on which the winners are found.
extern "C" int patch_encoder_bf16_launch(const float* pts, int p, int n, int knn,
                                         const float* w1, const float* b1,
                                         const float* w2, const float* b2,
                                         const float* w3, const float* b3,
                                         const float* pw1, const float* pb1,
                                         const float* pw2, const float* pb2,
                                         const float* pw3, const float* pb3,
                                         const float* pw4, const float* pb4, int dout,
                                         float* out, int* winners, void* stream,
                                         const float* rb1, const float* rb2, const float* rb3,
                                         const float* rpb1, const float* rpb2,
                                         const float* rpb3, const float* rpb4) {
  if (p <= 0 || n % kEncQ != 0 || n > kEncMaxN || n < knn || dout <= 0 ||
      dout > kEncMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* w[14] = {w1, b1, w2, b2, w3, b3, pw1, pb1, pw2, pb2, pw3, pb3, pw4, pb4};
  const float* rb[7] = {rb1, rb2, rb3, rpb1, rpb2, rpb3, rpb4};
  if (winners)
    for (const float* b : rb)
      if (b == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (knn) {
    case 8:
      return winners ? launch<8, true, true>(pts, p, n, w, dout, out, winners, rb, s)
                     : launch<8, false, true>(pts, p, n, w, dout, out, nullptr, nullptr, s);
    case 16:
      return winners ? launch<16, true, true>(pts, p, n, w, dout, out, winners, rb, s)
                     : launch<16, false, true>(pts, p, n, w, dout, out, nullptr, nullptr, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
