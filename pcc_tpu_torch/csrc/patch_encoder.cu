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
// The bf16 instance (patch_encoder_bf16_launch, namespace enc16; pcc_tpu's
// compute_dtype bfloat16): the wrapper rounds every weight and bias to
// bf16, as the TPU kernel's `load` does, and the kernel rounds the centred
// neighbours, xyz and every layer's output (after its relu, the last
// layer's after its bias) where sa_pallas.py:163-210 casts to bf16.
// Products of bf16 values are exact in float32, so every output is the
// float32 sum of exact products in k-order, which
// ops/sa_cuda.py::_kernel_choices replays with the same rounding; the
// kernel's outputs are those bit for bit. What bounds it on an H100:
// operations, 181 MFLOP a patch (0.74 TFLOP a 4096-patch batch), 0.787 ms
// on the bf16 tensor cores, 11.1 ms in float32 on the CUDA cores, where the
// float32 instance's design computes them. What the design does about it:
// every layer at least 16 deep (SetAbstraction's layers 2 and 3, PointNet's
// 1-3, 98% of the operations) runs as mma.sync m16n8k16 on the bf16
// tensor cores with certified rounding (certified.cuh): each output's sum
// comes with a proven bound on how far it lies from the k-order sum, its
// epilogue is evaluated at both ends, and the few entries whose two ends
// round differently (0.6-2% a layer on seeded weights, the counting build
// of tools/cert_breakdown.py) are recomputed in k-order on the CUDA cores.
// SetAbstraction's layer 1 (3 deep) and PointNet's last layer (512 -> D,
// whose sums the calibrated weights of chip_smoke.py phase 27 make cancel
// almost wholly, so a certificate would flag most of them) stay on the CUDA
// cores in k-order. Activations are bf16 in shared memory. A block per
// patch (256 threads, two blocks an SM): the selection (select_knn, a
// thread per query) as the float32 instance's, then passes of kQ = 64
// points: SetAbstraction a warp per 16 grouped rows with no block barrier
// (layer 1 a lane per column, layers 2 and 3 from their weights' fragments
// held in shared memory for the block's life, the max over each query's
// rows folded from both ends of its rows' sums), the PointNet layers on
// the pass's 64 rows with the block's warps taking 64 x 16 tiles, their
// weights' fragments read through the read-only cache a step ahead, layer
// 3 in steps of 128 columns folded straight into the last layer's k-order
// sums. The maxima over neighbours and over points fold the certified
// values, so they are the k-order kernel's.
//
// In bf16 training the winners are not the forward's: pcc_tpu's bf16
// backward kernel replays the forward with the weights rounded but the
// biases float32 (sa_pallas.py:305-314) and routes its gradient through
// that replay's arg-max points (:392). So the bf16 instance with winners
// runs a grid of two halves in one launch: blockIdx.y 0 computes the
// latent on the rounded biases, blockIdx.y 1 the same forward on the
// float32 biases the wrapper hands it beside them (only the epilogues'
// bias changes), and keeps only its winners, the first arg-max of values
// bit-equal to the replay's.
//
// Selection is bit-equal to the plain PyTorch version
// (pcc_tpu_torch/ops/sa_cuda.py::patch_encoder_plain): the same distance
// formula, one rounding per operation, and the lower index first among
// equal distances. The selection and the per-chunk forward live in
// encoder_common.cuh, which the backward kernel (patch_encoder_bwd.cu)
// shares, so its recomputed forward is this one bit for bit.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "certified.cuh"
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

template <int KNN, bool kWinners>
__global__ void __launch_bounds__(kThreads, 2)
patch_encoder_kernel(const float* __restrict__ pts, int n,
                     const float* __restrict__ w1, const float* __restrict__ b1,
                     const float* __restrict__ w2, const float* __restrict__ b2,
                     const float* __restrict__ w3, const float* __restrict__ b3,
                     const float* __restrict__ pw1, const float* __restrict__ pb1,
                     const float* __restrict__ pw2, const float* __restrict__ pb2,
                     const float* __restrict__ pw3, const float* __restrict__ pb3,
                     const float* __restrict__ pw4, const float* __restrict__ pb4,
                     int dout, float* __restrict__ out, int* __restrict__ winners) {
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
    encoder_chunk<KNN>(c0, nq, nbr, sx, sy, sz, w1, b1, w2, b2, w3, b3, pw1, pb1, pw2, pb2,
                       pw3, pb3, pw4, pb4, dout, chunk);
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
    out[static_cast<size_t>(blockIdx.x) * dout + tid] = lat[tid];
    if (kWinners) winners[static_cast<size_t>(blockIdx.x) * dout + tid] = win[tid];
  }
}

template <int KNN, bool kWinners>
int launch(const float* pts, int p, int n, const float* const* w, int dout,
           float* out, int* winners, cudaStream_t stream) {
  const Layout L = make_layout(n, KNN);
  cudaError_t err = cudaFuncSetAttribute(patch_encoder_kernel<KNN, kWinners>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  patch_encoder_kernel<KNN, kWinners><<<p, kThreads, L.bytes, stream>>>(
      pts, n, w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7], w[8], w[9], w[10], w[11], w[12],
      w[13], dout, out, winners);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The bf16 instance (patch_encoder_bf16_launch): the products on the bf16
// tensor cores, its outputs bit for bit those of the k-order CUDA-core
// arithmetic (certified.cuh). See the file's note.
namespace enc16 {

using namespace pcc;
using namespace pcc_cert;

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kQ = 64;                       // points per PointNet pass
constexpr int kX3Cols = 128;                 // PointNet layer-3 columns per step
constexpr int kPad1 = 144;                   // PointNet layer 1's depth 131 padded to 16
// bf16 row strides: the depth padded to 16, + 8
constexpr int kLdH1 = kEncC1 + 8, kLdH2 = kEncC2 + 8, kLdX0 = kPad1 + 8, kLdX1 = kEncP1 + 8,
              kLdX2 = kEncP2 + 8, kLdX3 = kX3Cols + 8;
// packed weights (certified.cuh), in uint2 units: W2, W3, PW1, PW2, PW3
constexpr int kKs2 = kEncC1 / 16, kKs3 = kEncC2 / 16, kKsP1 = kPad1 / 16, kKsP2 = kEncP1 / 16,
              kKsP3 = kEncP2 / 16;
constexpr int kF2 = 0, kF3 = kF2 + kKs2 * kEncC2 * 4, kFP1 = kF3 + kKs3 * kEncC3 * 4,
              kFP2 = kFP1 + kKsP1 * kEncP1 * 4, kFP3 = kFP2 + kKsP2 * kEncP2 * 4,
              kFrags = kFP3 + kKsP3 * kEncP3 * 4;
// shared memory regions, bytes: A holds x0 then x1, later a layer-3 step
// x3 and the last layer's rows o4 (floats); B holds x2, earlier each
// warp's SetAbstraction rows h1 and h2 (16 rows each)
constexpr int kX0Bytes = kQ * kLdX0 * 2, kRegionA = kX0Bytes + kQ * kLdX1 * 2;
constexpr int kRegionB = kQ * kLdX2 * 2;
constexpr int kWarpSa = 16 * (kLdH1 + kLdH2);      // a warp's h1 and h2, bf16 values
constexpr int kSaW = kF3 + kKs3 * kEncC3 * 4;      // W2 and W3's fragments, uint2 values
static_assert(kWarps * kWarpSa * 2 <= kRegionB, "the warps' h1 and h2 fit in x2");
static_assert(kQ * kLdX3 * 2 <= kX0Bytes, "a layer-3 step fits in x0");
static_assert(kQ * kEncMaxD * 4 <= kRegionA, "o4 fits in region A");
constexpr int kAcc = kQ * kEncMaxD / kThreads;   // last-layer sums a thread

struct Layout {
  int pts;       // sx, sy, sz, sq: 4 n floats
  int lat, win;  // [kEncMaxD] each
  int queue;     // the warps' fix-up queues (kWarps * kQueue ints) and counts (kWarps)
  int w;         // SetAbstraction layers 2 and 3's fragments
  int a, b;      // regions A and B
  int nbr;       // [n][knn] unsigned short
  size_t bytes;
};

__host__ __device__ inline Layout make_layout(int n, int knn) {
  Layout L;
  size_t off = 0;
  L.pts = 0;
  off += 16 * static_cast<size_t>(n);
  L.lat = static_cast<int>(off);
  off += 4 * kEncMaxD;
  L.win = static_cast<int>(off);
  off += 4 * kEncMaxD;
  L.queue = static_cast<int>(off);
  off += (4 * kWarps * (kQueue + 1) + 15) / 16 * 16;
  L.w = static_cast<int>(off);
  off += 8 * kSaW;
  L.a = static_cast<int>(off);
  off += kRegionA;
  L.b = static_cast<int>(off);
  off += kRegionB;
  L.nbr = static_cast<int>(off);
  off += 2 * static_cast<size_t>(n) * knn;
  L.bytes = off;
  return L;
}

// round_bf16(relu(s + b[c])): every relu layer's epilogue on a k-order sum
struct BiasRelu {
  const float* b;
  __device__ __forceinline__ float operator()(float s, int c) const {
    return pcc_bf16::round_bf16(fmaxf(__fadd_rn(s, __ldg(b + c)), 0.0f));
  }
};

// SetAbstraction for one warp's 16 grouped rows (rows row0 .. of the
// pass, query (row0 + i) / KNN of the pass's points from c0): layer 1 on
// the CUDA cores into h1 (encoder_common.cuh::sa_layer1's arithmetic, a
// lane per column), layer 2 certified into h2, layer 3 certified with the
// max over each query's KNN rows into x0[query][3 + c] (f(max) is the
// kernel's: the bias add and rounding are monotone). Weights W2, W3 from
// shared memory. Warp-synchronous: no block barrier.
template <int KNN>
__device__ __forceinline__ void sa_tile(int row0, int c0, const unsigned short* nbr,
                                        const float* sx, const float* sy, const float* sz,
                                        const float* __restrict__ w1,
                                        const float* __restrict__ b1, const uint2* f2,
                                        const uint2* f3, BiasRelu e2, BiasRelu e3,
                                        unsigned short* h1, unsigned short* h2,
                                        unsigned short* x0, int* q) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  {
    const float wx = __ldg(w1 + lane), wy = __ldg(w1 + kEncC1 + lane),
                wz = __ldg(w1 + 2 * kEncC1 + lane), bo = __ldg(b1 + lane);
#pragma unroll 4
    for (int i = 0; i < 16; ++i) {
      const int r = row0 + i, q = c0 + r / KNN;
      const int j = nbr[q * KNN + r % KNN];
      const float cx = pcc_bf16::round_bf16(__fsub_rn(sx[j], sx[q]));
      const float cy = pcc_bf16::round_bf16(__fsub_rn(sy[j], sy[q]));
      const float cz = pcc_bf16::round_bf16(__fsub_rn(sz[j], sz[q]));
      float acc = __fmul_rn(cx, wx);
      acc = fmaf(cy, wy, acc);
      acc = fmaf(cz, wz, acc);
      h1[i * kLdH1 + lane] = bf16_bits(pcc_bf16::round_bf16(fmaxf(__fadd_rn(acc, bo), 0.0f)));
    }
  }
  __syncwarp();
  int nq = 0;
  cert_tile<1, 8, true>(h1, kLdH1, 0, f2, kKs2, kEncC1, 0, 0, kEncC2, e2, h2, kLdH2, 0, q, nq,
                        true);
  __syncwarp();
  const float ak = cert_a(kEncC2);
  constexpr int kNT = 8, kH = KNN == 16 ? 1 : 2;   // queries in the m16 tile
#pragma unroll 1
  for (int half = 0; half < kEncC3 / (8 * kNT); ++half) {
    const int j0 = half * kNT;
    float s[1][kNT][4], rr[1][kNT][4];
    cert_mma<1, kNT, true>(h2, kLdH2, 0, f3, kKs3, j0, s, rr);
    unsigned fl = 0u;   // bit (n * 2 + cc) * 2 + h: column 8 (j0 + n) + 2 t + cc of query h
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int c = 8 * (j0 + n) + 2 * t + cc;
        float lo[2], hi[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float err = cert_err(rr[0][n][2 * h + cc], ak);
          lo[h] = __fsub_rd(s[0][n][2 * h + cc], err);
          hi[h] = __fadd_ru(s[0][n][2 * h + cc], err);
        }
        if (KNN == 16) {
          lo[0] = fmaxf(lo[0], lo[1]);
          hi[0] = fmaxf(hi[0], hi[1]);
        }
#pragma unroll
        for (int sh = 4; sh < 32; sh <<= 1)
#pragma unroll
          for (int h = 0; h < kH; ++h) {
            lo[h] = fmaxf(lo[h], __shfl_xor_sync(0xffffffffu, lo[h], sh));
            hi[h] = fmaxf(hi[h], __shfl_xor_sync(0xffffffffu, hi[h], sh));
          }
#pragma unroll
        for (int h = 0; h < kH; ++h) {
          const float vlo = e3(lo[h], c), vhi = e3(hi[h], c);
          if (__float_as_uint(vlo) != __float_as_uint(vhi)) {
            fl |= 1u << ((n * 2 + cc) * 2 + h);
          } else if (g == 0) {
            x0[((row0 / KNN) + h) * kLdX0 + 3 + c] = bf16_bits(vlo);
          }
        }
      }
    if (g == 0) cert_count(1, __popc(fl), kNT * 2 * kH);
    if (PCC_CERT_NOFIX) continue;
    // a flagged group: its 16 rows in k-order, two a lane (KNN 16) or one
    // of each query (KNN 8), the max over the lanes of a column
    unsigned all = __reduce_or_sync(0xffffffffu, fl);
    while (all) {
      const int i = __ffs(all) - 1;
      all &= all - 1u;
      const bool mine = (fl >> i) & 1u;
      const int h = i & 1, cc = (i >> 1) & 1, n = i >> 2;
      const int c = 8 * (j0 + n) + 2 * t + cc;
      float v = -CUDART_INF_F;
      if (mine) {
        if (KNN == 16) {
          v = fmaxf(cert_kdot<true>(h2 + g * kLdH2, f3, kKs3, c),
                    cert_kdot<true>(h2 + (g + 8) * kLdH2, f3, kKs3, c));
        } else {
          v = cert_kdot<true>(h2 + (g + 8 * h) * kLdH2, f3, kKs3, c);
        }
      }
#pragma unroll
      for (int sh = 4; sh < 32; sh <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, sh));
      if (mine && g == 0) x0[((row0 / KNN) + h) * kLdX0 + 3 + c] = bf16_bits(e3(v, c));
    }
  }
  __syncwarp();
}

// The last layer, a step of it: acc += x3[r][k] * pw4[c0 + k][o] for the
// step's kX3Cols values of k in order, over the items e = threadIdx.x + i *
// kThreads of the kQ x dout outputs (4 columns an item with kVec).
template <bool kVec>
__device__ __forceinline__ void last_step(const unsigned short* x3, const float* __restrict__ pw4,
                                          int c0, int dout, float* acc) {
  constexpr int kV = kVec ? 4 : 1;
  const int per_row = dout / kV;
#pragma unroll
  for (int i = 0; i < kAcc / kV; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (e >= kQ * per_row) break;
    const int r = e / per_row, o = (e % per_row) * kV;
    const unsigned* x = reinterpret_cast<const unsigned*>(x3 + r * kLdX3);
    const float* w = pw4 + static_cast<size_t>(c0) * dout + o;
    float* a = acc + kV * i;
    for (int k = 0; k < kX3Cols; k += 2) {
      const unsigned xv = x[k / 2];
      const float xs[2] = {bf16_lo(xv), bf16_hi(xv)};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (kVec) {
          const float4 wv = __ldg(reinterpret_cast<const float4*>(w + (k + h) * dout));
          a[0] = fmaf(xs[h], wv.x, a[0]);
          a[1] = fmaf(xs[h], wv.y, a[1]);
          a[2] = fmaf(xs[h], wv.z, a[2]);
          a[3] = fmaf(xs[h], wv.w, a[3]);
        } else {
          a[0] = fmaf(xs[h], __ldg(w + (k + h) * dout), a[0]);
        }
      }
    }
  }
}

template <int KNN, bool kWinners>
__global__ void __launch_bounds__(kThreads, 2)
encoder_kernel(const float* __restrict__ pts, int n, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ b2,
               const float* __restrict__ b3, const float* __restrict__ pb1,
               const float* __restrict__ pb2, const float* __restrict__ pb3,
               const float* __restrict__ pw4, const float* __restrict__ pb4,
               const uint2* __restrict__ frags, int dout, float* __restrict__ out,
               int* __restrict__ winners, const float* __restrict__ rb1,
               const float* __restrict__ rb2, const float* __restrict__ rb3,
               const float* __restrict__ rpb1, const float* __restrict__ rpb2,
               const float* __restrict__ rpb3, const float* __restrict__ rpb4) {
  // with winners, blockIdx.y 1 is the backward's replay (biases rb*, rpb*),
  // which writes the winners; blockIdx.y 0 writes the latent
  const bool replay = kWinners && blockIdx.y == 1;
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
  extern __shared__ __align__(16) unsigned char smem[];
  float* sx = reinterpret_cast<float*>(smem + L.pts);
  float* sy = sx + n;
  float* sz = sx + 2 * n;
  float* sq = sx + 3 * n;
  float* lat = reinterpret_cast<float*>(smem + L.lat);
  int* win = reinterpret_cast<int*>(smem + L.win);
  const int tid = threadIdx.x, warp = tid >> 5;
  uint2* wsa = reinterpret_cast<uint2*>(smem + L.w);
  int* queues = reinterpret_cast<int*>(smem + L.queue);
  int* counts = queues + kWarps * kQueue;
  unsigned short* x0 = reinterpret_cast<unsigned short*>(smem + L.a);
  unsigned short* x1 = reinterpret_cast<unsigned short*>(smem + L.a + kX0Bytes);
  unsigned short* x3 = x0;
  float* o4 = reinterpret_cast<float*>(smem + L.a);
  unsigned short* x2 = reinterpret_cast<unsigned short*>(smem + L.b);
  unsigned short* h1 = x2 + warp * kWarpSa;
  unsigned short* h2 = h1 + 16 * kLdH1;
  unsigned short* nbr = reinterpret_cast<unsigned short*>(smem + L.nbr);
  const uint2* fp1 = frags + kFP1;
  const uint2* fp2 = frags + kFP2;
  const uint2* fp3 = frags + kFP3;
  const BiasRelu e2{b2}, e3{b3}, ep1{pb1}, ep2{pb2}, ep3{pb3};

  for (int i = tid; i < dout; i += kThreads) {
    lat[i] = -CUDART_INF_F;
    win[i] = 0;
  }
  for (int i = tid; i < kSaW / 2; i += kThreads)
    reinterpret_cast<uint4*>(wsa)[i] = __ldg(reinterpret_cast<const uint4*>(frags) + i);
  load_patch(pts + static_cast<size_t>(blockIdx.x) * n * 3, n, sx, sy, sz, sq);
  select_knn<KNN>(sx, sy, sz, sq, n, nbr);

  const bool vec = dout % 4 == 0;
  for (int c0 = 0; c0 < n; c0 += kQ) {
    const int nq = min(kQ, n - c0);
    // SetAbstraction, a warp per 16 grouped rows, into x0's columns 3 .. 130
    for (int row0 = 16 * warp; row0 < nq * KNN; row0 += 16 * kWarps)
      sa_tile<KNN>(row0, c0, nbr, sx, sy, sz, w1, b1, wsa + kF2, wsa + kF3, e2, e3, h1, h2, x0,
                   queues + warp * kQueue);
    // the concat rows: xyz rounded, zeros past 131 and past the pass's points
    for (int e = tid; e < kQ * kPad1; e += kThreads) {
      const int r = e / kPad1, c = e % kPad1;
      if (r < nq && c >= 3 && c < 3 + kEncC3) continue;
      const int q = c0 + r;
      const float v = r >= nq || c >= 3 + kEncC3 ? 0.0f
                      : pcc_bf16::round_bf16(c == 0 ? sx[q] : (c == 1 ? sy[q] : sz[q]));
      x0[r * kLdX0 + c] = bf16_bits(v);
    }
    __syncthreads();
    cert_layer<4, 2, false>(x0, kLdX0, kQ, fp1, kKsP1, 3 + kEncC3, 0, kEncP1, kEncP1, ep1, x1,
                            kLdX1, 2, queues, counts);
    __syncthreads();
    cert_layer<4, 2, false>(x1, kLdX1, kQ, fp2, kKsP2, kEncP1, 0, kEncP2, kEncP2, ep2, x2,
                            kLdX2, 3, queues, counts);
    __syncthreads();
    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
    for (int cs = 0; cs < kEncP3; cs += kX3Cols) {
      cert_layer<4, 2, false>(x2, kLdX2, kQ, fp3, kKsP3, kEncP2, cs, kX3Cols, kEncP3, ep3, x3,
                              kLdX3, 4, queues, counts);
      __syncthreads();
      if (vec) {
        last_step<true>(x3, pw4, cs, dout, acc);
      } else {
        last_step<false>(x3, pw4, cs, dout, acc);
      }
      __syncthreads();
    }
    // o4 = round(acc + b) (no relu), then the fold into the latent (and
    // the winners), points in order
    const int kV = vec ? 4 : 1;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int e = tid + (i / kV) * kThreads;
      if (e >= kQ * dout / kV) break;
      const int o = (e % (dout / kV)) * kV + i % kV;
      o4[(e / (dout / kV)) * dout + o] = pcc_bf16::round_bf16(__fadd_rn(acc[i], __ldg(pb4 + o)));
    }
    __syncthreads();
    if (tid < dout) {
      float m = lat[tid];
      int w = win[tid];
      for (int r = 0; r < nq; ++r) {
        const float v = o4[r * dout + tid];
        if (kWinners && v > m) w = c0 + r;
        m = fmaxf(m, v);
      }
      lat[tid] = m;
      win[tid] = w;
    }
    __syncthreads();
  }
  if (tid < dout) {
    if (!replay) out[static_cast<size_t>(blockIdx.x) * dout + tid] = lat[tid];
    if (kWinners && replay) winners[static_cast<size_t>(blockIdx.x) * dout + tid] = win[tid];
  }
}

template <int KNN, bool kWinners>
int launch(const float* pts, int p, int n, const float* const* w, const uint2* frags, int dout,
           float* out, int* winners, const float* const* rb, cudaStream_t stream) {
  const Layout L = make_layout(n, KNN);
  if (L.bytes > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(encoder_kernel<KNN, kWinners>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* none[7] = {};
  if (rb == nullptr) rb = none;
  encoder_kernel<KNN, kWinners><<<dim3(p, kWinners ? 2 : 1), kThreads, L.bytes, stream>>>(
      pts, n, w[0], w[1], w[3], w[5], w[7], w[9], w[11], w[12], w[13], frags, dout, out,
      winners, rb[0], rb[1], rb[2], rb[3], rb[4], rb[5], rb[6]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace enc16

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
      return winners ? launch<8, true>(pts, p, n, w, dout, out, winners, s)
                     : launch<8, false>(pts, p, n, w, dout, out, nullptr, s);
    case 16:
      return winners ? launch<16, true>(pts, p, n, w, dout, out, winners, s)
                     : launch<16, false>(pts, p, n, w, dout, out, nullptr, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bf16 instance: the arguments of patch_encoder_launch, the weights and
// biases bf16-exact (rounded by the wrapper), then (with winners, in bf16
// training) the replay's biases rb1, rb2, rb3, rpb1 .. rpb4 (float32, as
// pcc_tpu's bf16 backward adds them), on which the winners are found, and
// frags: W2, W3, PW1, PW2, PW3 packed for the tensor cores
// (ops/certified.py::pack_frags, enc16::kFrags uint2 values).
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
                                         const float* rpb3, const float* rpb4,
                                         const void* frags) {
  if (p <= 0 || n % kEncQ != 0 || n > kEncMaxN || n < knn || dout <= 0 ||
      dout > kEncMaxD || frags == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* w[14] = {w1, b1, w2, b2, w3, b3, pw1, pb1, pw2, pb2, pw3, pb3, pw4, pb4};
  const float* rb[7] = {rb1, rb2, rb3, rpb1, rpb2, rpb3, rpb4};
  if (winners)
    for (const float* b : rb)
      if (b == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const uint2* f = static_cast<const uint2*>(frags);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (knn) {
    case 8:
      return winners ? enc16::launch<8, true>(pts, p, n, w, f, dout, out, winners, rb, s)
                     : enc16::launch<8, false>(pts, p, n, w, f, dout, out, nullptr, nullptr, s);
    case 16:
      return winners ? enc16::launch<16, true>(pts, p, n, w, f, dout, out, winners, rb, s)
                     : enc16::launch<16, false>(pts, p, n, w, f, dout, out, nullptr, nullptr, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The counting build's flagged and computed entries per layer tag (enc16:
// 0 SetAbstraction layer 2, 1 its layer 3 with the max, 2-4 PointNet
// layers 1-3), copied to host[0 .. 2 * tags) and zeroed. Returns a
// cudaError_t value.
extern "C" int patch_encoder_bf16_cert_counts(unsigned long long* host, int tags) {
  cudaError_t err = cudaMemcpyFromSymbol(host, pcc_cert::cert_counts,
                                         2 * tags * sizeof(unsigned long long));
  if (err != cudaSuccess) return static_cast<int>(err);
  static const unsigned long long zeros[64] = {};
  return static_cast<int>(cudaMemcpyToSymbol(pcc_cert::cert_counts, zeros, sizeof(zeros)));
}
