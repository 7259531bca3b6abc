// Farthest point sampling for a batch of clouds, all iterations in one launch.
//
// Replaces the TPU kernel pcc_tpu/ops/fps_pallas.py::_fps_kernel.
//
// What bounds it on an H100: neither bytes nor operations. The work is
// npoint dependent steps per cloud, each a pass over N points followed by a
// block-wide argmax, so it is latency-bound on the step chain (two
// __syncthreads and a shuffle tree per step). The design keeps everything
// a step touches on the SM: one block per cloud holds the cloud's N x 3
// points in shared memory (96 KB at N = 8192) and each thread keeps the
// running minimum distance of its N / blockDim points in registers. Only
// the chosen index leaves the SM. One block per cloud leaves SMs idle when
// B < 132 (B = 64 in a 64-cloud batch); splitting a cloud over a cluster
// of blocks is later work.
//
// Bit-equality: the indices fix the .s.bin stream, so they must equal the
// plain PyTorch version (pcc_tpu_torch/ops/fps.py::fps_plain) bit for bit.
// The squared distance is ((dx*dx + dy*dy) + dz*dz), each operation
// rounded once (the __f*_rn intrinsics cannot be contracted into FMAs, and
// the file is also compiled with --fmad=false); the argmax takes the lowest
// index among equal maxima.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxPerThread = 16;  // N <= kThreads * kMaxPerThread

__device__ __forceinline__ void keep_better(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, const int* __restrict__ starts,
           int* __restrict__ out, int n, int npoint) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = smem + n;
  float* sz = smem + 2 * n;
  __shared__ float red_v[kThreads / 32];
  __shared__ int red_i[kThreads / 32];
  __shared__ int s_far;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const float* p = xyz + static_cast<size_t>(b) * n * 3;
  for (int j = tid; j < n; j += blockDim.x) {
    sx[j] = p[3 * j];
    sy[j] = p[3 * j + 1];
    sz[j] = p[3 * j + 2];
  }
  float dist[kMaxPerThread];
#pragma unroll
  for (int t = 0; t < kMaxPerThread; ++t) dist[t] = 1e10f;
  int far = starts[b];
  __syncthreads();

  for (int it = 0; it < npoint; ++it) {
    if (tid == 0) out[static_cast<size_t>(b) * npoint + it] = far;
    const float cx = sx[far], cy = sy[far], cz = sz[far];
    float best_v = -1.0f;  // every distance is >= 0
    int best_i = n;
#pragma unroll
    for (int t = 0; t < kMaxPerThread; ++t) {
      const int j = tid + t * blockDim.x;
      if (j < n) {
        const float dx = __fsub_rn(sx[j], cx);
        const float dy = __fsub_rn(sy[j], cy);
        const float dz = __fsub_rn(sz[j], cz);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        dist[t] = fminf(dist[t], d);
        // j ascends with t: a strict '>' keeps the lowest index of a tie
        if (dist[t] > best_v) {
          best_v = dist[t];
          best_i = j;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float v2 = __shfl_down_sync(0xffffffffu, best_v, off);
      const int i2 = __shfl_down_sync(0xffffffffu, best_i, off);
      keep_better(best_v, best_i, v2, i2);
    }
    if (lane == 0) {
      red_v[warp] = best_v;
      red_i[warp] = best_i;
    }
    __syncthreads();
    if (warp == 0) {
      best_v = lane < nwarps ? red_v[lane] : -1.0f;
      best_i = lane < nwarps ? red_i[lane] : n;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float v2 = __shfl_down_sync(0xffffffffu, best_v, off);
        const int i2 = __shfl_down_sync(0xffffffffu, best_i, off);
        keep_better(best_v, best_i, v2, i2);
      }
      if (lane == 0) s_far = best_i;
    }
    __syncthreads();
    far = s_far;
  }
}

}  // namespace

// xyz: [b, n, 3] f32 contiguous; starts: [b] i32; out: [b, npoint] i32.
extern "C" int fps_launch(const float* xyz, const int* starts, int* out, int b,
                          int n, int npoint, void* stream) {
  if (b <= 0 || n <= 0 || npoint <= 0 || n > kThreads * kMaxPerThread)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(3) * n * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = ((n + 31) / 32) * 32;
  if (threads > kThreads) threads = kThreads;
  fps_kernel<<<b, threads, smem, static_cast<cudaStream_t>(stream)>>>(xyz, starts, out,
                                                                     n, npoint);
  return static_cast<int>(cudaGetLastError());
}
