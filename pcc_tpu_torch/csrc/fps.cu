// Farthest point sampling for a batch of clouds, all steps in one launch, on
// float32 coordinates (the codec's skeleton, the PN++ stages) and on int32
// grid coordinates (the integer probability model's selection).
//
// Replaces the TPU kernel pcc_tpu/ops/fps_pallas.py::_fps_kernel. The int32
// instance takes the place of pcc_tpu/coding/iprob_pppf.py::_int_fps_jnp,
// which pcc_tpu runs as an XLA fori_loop (no Pallas kernel).
//
// What bounds it on an H100: neither bytes nor operations. The work is
// npoint dependent steps per cloud; each step folds the distances to the
// last pick into the running minima of the cloud's N points (9 operations a
// point) and takes their argmax, which the next step needs. A cloud's time
// is npoint x the latency of one step, so the design shortens that chain:
//
// * Small clouds (N <= 512: the PN++ stages' patches, the CPM's stages): a
//   warp per cloud, several clouds per block. Each lane keeps its N / 32
//   points and their running minima in registers. The argmax is two warp
//   reductions (redux.sync: the largest distance, then the lowest index
//   that holds it); every lane ends with the winner, so a step has no
//   barrier and no shared-memory round trip. The winner's coordinates come
//   from one broadcast load of the warp's copy of its cloud.
// * Large clouds (the skeleton, N = 8192): `cluster` CTAs per cloud (a
//   thread block cluster where there are several), each owning a slice of
//   the points, up to 8 a thread, in registers. A warp reduces its points
//   as above and puts its winner into a double-buffered array in every CTA
//   of the cluster; every warp then reduces that array itself. One CTA
//   hands the array over with one __syncthreads a step; a cluster with
//   asynchronous stores into the other CTAs' shared memory (st.async),
//   each CTA waiting on its own mbarrier for the step's bytes, with no
//   cluster-wide barrier. Each CTA holds the whole cloud in shared memory
//   for the winner's coordinates. Splitting a cloud over CTAs puts more
//   SMs on each step's pass; the launcher (ops/fps.py::plan) picks the
//   split by shape.
// The indices are kept one per lane and stored 32 at a time, coalesced.
//
// Bit-equality: the indices fix the .s.bin stream and the CPM's weights, so
// they must equal the plain versions (pcc_tpu_torch/ops/fps.py::fps_plain,
// fps_int_plain) bit for bit. The float32 squared distance is ((dx*dx +
// dy*dy) + dz*dz), each operation rounded once (the __f*_rn intrinsics are
// never contracted into FMAs, and the file is compiled with --fmad=false);
// the int32 one is exact. Every argmax keeps the lowest index among equal
// maxima: (distance, index) under that rule is a total order, so splitting
// the reduction over lanes, warps and CTAs cannot change a pick. Distances
// are >= 0, so their bits as unsigned integers order like their values.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoPoint = 0x7fffffffu;  // the index of no point: loses every min
constexpr int kWarpMaxPer = 16;             // a warp per cloud: N <= 32 * 16
constexpr int kWarpMaxThreads = 256;        // 8 clouds a block at most
constexpr int kMaxPer = 8;                  // points a thread in a cluster's CTA
constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 8;              // the portable cluster size
constexpr size_t kMaxSmem = 232448;         // 227 KB a block

__device__ __forceinline__ float sq_dist(float px, float py, float pz, float cx, float cy,
                                         float cz) {
  const float dx = __fsub_rn(px, cx);
  const float dy = __fsub_rn(py, cy);
  const float dz = __fsub_rn(pz, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

__device__ __forceinline__ int sq_dist(int px, int py, int pz, int cx, int cy, int cz) {
  const int dx = px - cx, dy = py - cy, dz = pz - cz;
  return dx * dx + dy * dy + dz * dz;
}

__device__ __forceinline__ float dmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ int dmin(int a, int b) { return min(a, b); }

// Order key of a best distance; -1 (no point) maps to 0, beside kNoPoint.
__device__ __forceinline__ unsigned order_key(float v) { return __float_as_uint(fmaxf(v, 0.0f)); }
__device__ __forceinline__ unsigned order_key(int v) { return static_cast<unsigned>(max(v, 0)); }

// The warp's best (key, index): the largest key and the lowest index among
// equal keys, in every lane. Two redux.sync measured faster than a
// __shfl_xor_sync butterfly over (key, index) (tools/fps_breakdown.py).
__device__ __forceinline__ void warp_best(unsigned& key, unsigned& idx) {
  const unsigned m = __reduce_max_sync(kFull, key);
  idx = __reduce_min_sync(kFull, key == m ? idx : kNoPoint);
  key = m;
}

// Shared-memory addresses, the mbarriers and the asynchronous stores into
// another CTA's shared memory (st.async) that a cluster's exchange uses.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned cluster_addr(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// (a, b) into shared::cluster address `to`, counted on the mbarrier `bar` there.
__device__ __forceinline__ void send(unsigned to, unsigned bar, unsigned a, unsigned b) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.u32 [%0], {%1, %2}, [%3];"
               ::"r"(to), "r"(a), "r"(b), "r"(bar)
               : "memory");
}

// A thread's points first + k * stride (k < PER) and their running minima.
template <typename T, int PER>
struct Points {
  T x[PER], y[PER], z[PER], d[PER];

  // From a cloud held in shared memory as rows x | y | z. A slot at or past
  // `end` gets the distance -1, which no distance >= 0 replaces or beats.
  __device__ __forceinline__ void load(const T* sx, const T* sy, const T* sz, int first,
                                       int stride, int end, T init) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int j = first + k * stride;
      if (j < end) {
        x[k] = sx[j];
        y[k] = sy[j];
        z[k] = sz[j];
        d[k] = init;
      } else {
        x[k] = y[k] = z[k] = T(0);
        d[k] = T(-1);
      }
    }
  }

  // Fold in the distances to (cx, cy, cz); the largest minimum as an order
  // key, and its lowest index (kNoPoint where the thread has no point). The
  // argmax over the slots is a tree of adjacent pairs, in which the upper
  // slot wins only where it is strictly larger: ties keep the lower index,
  // and the chain is log2(PER) compares long, not PER.
  __device__ __forceinline__ void step(T cx, T cy, T cz, int first, int stride, unsigned& key,
                                       unsigned& idx) {
    T v[PER];
    int at[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      d[k] = dmin(d[k], sq_dist(x[k], y[k], z[k], cx, cy, cz));
      v[k] = d[k];
      at[k] = k;
    }
#pragma unroll
    for (int w = 1; w < PER; w *= 2) {
#pragma unroll
      for (int k = 0; k + w < PER; k += 2 * w) {
        if (v[k + w] > v[k]) {
          v[k] = v[k + w];
          at[k] = at[k + w];
        }
      }
    }
    key = order_key(v[0]);
    idx = v[0] < T(0) ? kNoPoint : static_cast<unsigned>(first + at[0] * stride);
  }
};

// [n, 3] interleaved in device memory -> rows x | y | z in shared memory.
template <typename T>
__device__ __forceinline__ void stage_cloud(const T* __restrict__ p, T* s, int n, int t,
                                            int nt) {
  for (int j = t; j < 3 * n; j += nt) {
    const int pt = j / 3;
    s[(j - 3 * pt) * n + pt] = p[j];
  }
}

// Pick `it` is `far`: lane it % 32 keeps it, and every 32 picks (and at the
// last) the warp stores what its lanes keep.
__device__ __forceinline__ void keep_pick(int* o, int it, int npoint, unsigned far, int lane,
                                          int& mine) {
  const int r = it & 31;
  if (lane == r) mine = static_cast<int>(far);
  if ((r == 31 || it + 1 == npoint) && lane <= r) o[it - r + lane] = mine;
}

template <typename T, int PER>
__global__ void __launch_bounds__(kWarpMaxThreads)
fps_warp_kernel(const T* __restrict__ xyz, const int* __restrict__ starts, int* __restrict__ out,
                int b, int n, int npoint, T init) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cloud = blockIdx.x * (blockDim.x >> 5) + warp;
  if (cloud >= b) return;  // no block barrier follows
  T* sx = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(warp) * 3 * n;
  T* sy = sx + n;
  T* sz = sy + n;
  stage_cloud(xyz + static_cast<size_t>(cloud) * n * 3, sx, n, lane, 32);
  __syncwarp();
  Points<T, PER> pts;
  pts.load(sx, sy, sz, lane, 32, n, init);
  unsigned far = starts ? static_cast<unsigned>(starts[cloud]) : 0u;
  int* o = out + static_cast<size_t>(cloud) * npoint;
  int mine = 0;
  for (int it = 0;; ++it) {
    keep_pick(o, it, npoint, far, lane, mine);
    if (it + 1 == npoint) break;
    unsigned key, idx;
    pts.step(sx[far], sy[far], sz[far], lane, 32, key, idx);
    warp_best(key, idx);
    far = idx;
  }
}

// Grid: csize CTAs per cloud, in clusters of csize where csize > 1; CTA
// `rank` owns points [rank * slice, (rank + 1) * slice). The warp winners
// of a step, [2][ne] double-buffered in every CTA: with one CTA a
// __syncthreads hands them over; in a cluster every warp sends its winner
// to each CTA with st.async, and each CTA waits on its own mbarrier (one per
// buffer) for the ne * 8 bytes of the step, with no cluster-wide barrier.
// A buffer is written again two steps later: a sender reaches that step
// only after every warp of every CTA has sent the step between, which each
// warp does after its last read of the buffer.
template <typename T, int PER>
__global__ void __launch_bounds__(kMaxThreads, 1)
fps_cluster_kernel(const T* __restrict__ xyz, const int* __restrict__ starts,
                   int* __restrict__ out, int n, int npoint, T init, int csize, int slice) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sx = reinterpret_cast<T*>(smem_raw);
  T* sy = sx + n;
  T* sz = sy + n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int ne = csize * nw;
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(
      smem_raw + ((3 * n * sizeof(T) + 15) & ~size_t(15)));
  uint2* winners = reinterpret_cast<uint2*>(bars + 2);
  const int cloud = blockIdx.x / csize, rank = blockIdx.x % csize;
  stage_cloud(xyz + static_cast<size_t>(cloud) * n * 3, sx, n, tid, blockDim.x);
  // lane r < csize sends the warp's winner to CTA r: its slots there
  unsigned to0 = 0u, to1 = 0u, to_bar0 = 0u, to_bar1 = 0u;
  if (csize > 1) {
    if (tid == 0) {
      mbar_init(smem_addr(bars), 1);
      mbar_init(smem_addr(bars + 1), 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    if (lane < csize) {
      to0 = cluster_addr(smem_addr(winners + rank * nw + warp), lane);
      to1 = cluster_addr(smem_addr(winners + ne + rank * nw + warp), lane);
      to_bar0 = cluster_addr(smem_addr(bars), lane);
      to_bar1 = cluster_addr(smem_addr(bars + 1), lane);
    }
    // every CTA of the cluster runs, its mbarriers initialised, before any
    // store into it
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
  const int first = rank * slice + tid;
  Points<T, PER> pts;
  pts.load(sx, sy, sz, first, blockDim.x, min(n, (rank + 1) * slice), init);
  unsigned far = starts ? static_cast<unsigned>(starts[cloud]) : 0u;
  int* o = out + static_cast<size_t>(cloud) * npoint;
  const bool writer = rank == 0 && warp == 0;
  int mine = 0;
  for (int it = 0;; ++it) {
    if (writer) keep_pick(o, it, npoint, far, lane, mine);
    if (it + 1 == npoint) break;
    const int b = it & 1;
    if (csize > 1 && tid == 0) mbar_expect(smem_addr(bars + b), ne * sizeof(uint2));
    unsigned key, idx;
    pts.step(sx[far], sy[far], sz[far], first, blockDim.x, key, idx);
    warp_best(key, idx);
    const uint2* buf = winners + b * ne;
    if (csize == 1) {
      if (lane == 0) winners[b * ne + warp] = make_uint2(key, idx);
      __syncthreads();
    } else {
      if (lane < csize) send(b ? to1 : to0, b ? to_bar1 : to_bar0, key, idx);
      mbar_wait(smem_addr(bars + b), (it >> 1) & 1);
    }
    key = 0;
    idx = kNoPoint;
    for (int q = lane; q < ne; q += 32) {
      const uint2 w = buf[q];
      if (w.x > key || (w.x == key && w.y < idx)) {
        key = w.x;
        idx = w.y;
      }
    }
    warp_best(key, idx);
    far = idx;
  }
}

int pow2_at_least(int need) {
  int p = 1;
  while (p < need) p <<= 1;
  return p;
}

// Raise a kernel's dynamic shared memory limit where `smem` needs it;
// `allowed` is the caller's record of the limit for that kernel, so the
// attribute is set once per size (a call per launch costs host time that
// short kernels feel).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, size_t& allowed) {
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) allowed = smem;
  return err;
}

template <typename T, int PER>
cudaError_t launch_warp(const T* xyz, const int* starts, int* out, int b, int n, int npoint,
                        T init, int threads, cudaStream_t stream) {
  const int wpb = threads / 32;
  const size_t smem = static_cast<size_t>(wpb) * 3 * n * sizeof(T);
  static size_t allowed = 48 * 1024;
  cudaError_t err = allow_smem(fps_warp_kernel<T, PER>, smem, allowed);
  if (err != cudaSuccess) return err;
  fps_warp_kernel<T, PER><<<(b + wpb - 1) / wpb, threads, smem, stream>>>(xyz, starts, out, b, n,
                                                                         npoint, init);
  return cudaGetLastError();
}

template <typename T, int PER>
cudaError_t launch_cluster(const T* xyz, const int* starts, int* out, int b, int n, int npoint,
                           T init, int csize, int slice, int threads, size_t smem,
                           cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  cudaError_t err = allow_smem(fps_cluster_kernel<T, PER>, smem, allowed);
  if (err != cudaSuccess) return err;
  if (csize == 1) {
    fps_cluster_kernel<T, PER><<<b, threads, smem, stream>>>(xyz, starts, out, n, npoint, init,
                                                             csize, slice);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * csize);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fps_cluster_kernel<T, PER>, xyz, starts, out, n, npoint, init,
                           csize, slice);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// cluster 0: a warp per cloud, threads / 32 clouds a block; cluster >= 1:
// that many CTAs of `threads` per cloud.
template <typename T>
int launch(const T* xyz, const int* starts, int* out, int b, int n, int npoint, T init,
           int cluster, int threads, cudaStream_t stream) {
  if (b <= 0 || n <= 0 || npoint <= 0 || threads < 32 || threads % 32 != 0 ||
      cluster < 0 || cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cluster == 0) {
    const int per = pow2_at_least((n + 31) / 32);
    if (per > kWarpMaxPer || threads > kWarpMaxThreads)
      return static_cast<int>(cudaErrorInvalidValue);
    switch (per) {
      case 1: return launch_warp<T, 1>(xyz, starts, out, b, n, npoint, init, threads, stream);
      case 2: return launch_warp<T, 2>(xyz, starts, out, b, n, npoint, init, threads, stream);
      case 4: return launch_warp<T, 4>(xyz, starts, out, b, n, npoint, init, threads, stream);
      case 8: return launch_warp<T, 8>(xyz, starts, out, b, n, npoint, init, threads, stream);
      default: return launch_warp<T, 16>(xyz, starts, out, b, n, npoint, init, threads, stream);
    }
  }
  const int slice = (n + cluster - 1) / cluster;
  const int per = pow2_at_least((slice + threads - 1) / threads);
  const size_t smem = ((3 * static_cast<size_t>(n) * sizeof(T) + 15) & ~size_t(15)) +
                      2 * sizeof(unsigned long long) +
                      2 * static_cast<size_t>(cluster) * (threads / 32) * sizeof(uint2);
  if (per > kMaxPer || threads > kMaxThreads || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (per) {
    case 1:
      err = launch_cluster<T, 1>(xyz, starts, out, b, n, npoint, init, cluster, slice, threads,
                                 smem, stream);
      break;
    case 2:
      err = launch_cluster<T, 2>(xyz, starts, out, b, n, npoint, init, cluster, slice, threads,
                                 smem, stream);
      break;
    case 4:
      err = launch_cluster<T, 4>(xyz, starts, out, b, n, npoint, init, cluster, slice, threads,
                                 smem, stream);
      break;
    default:
      err = launch_cluster<T, 8>(xyz, starts, out, b, n, npoint, init, cluster, slice, threads,
                                 smem, stream);
  }
  return static_cast<int>(err);
}

}  // namespace

// xyz: [b, n, 3] f32 contiguous; starts: [b] i32; out: [b, npoint] i32.
// (cluster, threads): the launch plan, ops/fps.py::plan.
extern "C" int fps_launch(const float* xyz, const int* starts, int* out, int b, int n,
                          int npoint, int cluster, int threads, void* stream) {
  return launch<float>(xyz, starts, out, b, n, npoint, 1e10f, cluster, threads,
                       static_cast<cudaStream_t>(stream));
}

// xyz: [b, n, 3] i32 grid coordinates; out: [b, npoint] i32; every cloud
// starts at index 0 with running minima `inf` (> every squared distance).
extern "C" int fps_int_launch(const int* xyz, int* out, int b, int n, int npoint, int inf,
                              int cluster, int threads, void* stream) {
  if (inf <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch<int>(xyz, nullptr, out, b, n, npoint, inf, cluster, threads,
                     static_cast<cudaStream_t>(stream));
}
