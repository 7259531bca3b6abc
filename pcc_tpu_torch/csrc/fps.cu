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
// * Clouds whose copy does not fit a CTA's shared memory (past 16384
//   points; the large-scene recipe's rooms of 50,000-100,000 points), or
//   whose slices need more than 8 points a thread: fps_slice_kernel. A CTA
//   holds only its own slice of the cloud in shared memory, and the
//   exchange carries the winner's coordinates: each warp sends its
//   (distance, index) record and, beside it, its winner's coordinates, read
//   from its own slice, so that no CTA needs the rest of the cloud. Up to 8
//   points a thread are kept in registers; past that (16, or 32 in CTAs of
//   up to 512 threads, whose threads have 128 registers) only their
//   running minima, the coordinates read from the slice in shared memory
//   on every step. So a cloud takes up to 8 CTAs x 1024 threads x 16
//   points = 8 x 512 x 32 = 131,072 points (MAX_POINTS), a slice of 16,384
//   points in 192 KB of a CTA's 227 KB. Fewer, fuller threads mean fewer
//   warp records to reduce a step, which the measured plans favour
//   (ops/fps.py::plan).
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
constexpr int kMaxPer = 8;                  // points a thread in registers
constexpr int kSliceMaxPer = 32;            // points a thread of a slice in shared memory
constexpr int kSlice32Threads = 512;        // 32 a thread only up to this many threads
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

// v (16 bytes) into shared::cluster address `to` (16-byte aligned), counted
// on the mbarrier `bar` there.
__device__ __forceinline__ void send4(unsigned to, unsigned bar, uint4 v) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];" ::"r"(to), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

// Coordinates as the bits that a record carries, and back.
__device__ __forceinline__ unsigned to_bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ unsigned to_bits(int v) { return static_cast<unsigned>(v); }
template <typename T>
__device__ __forceinline__ T from_bits(unsigned v);
template <>
__device__ __forceinline__ float from_bits<float>(unsigned v) { return __uint_as_float(v); }
template <>
__device__ __forceinline__ int from_bits<int>(unsigned v) { return static_cast<int>(v); }

// The largest of v[0 .. PER) and its slot, a tree of adjacent pairs in which
// the upper slot wins only where it is strictly larger: ties keep the lower
// slot, and the chain is log2(PER) compares long, not PER.
template <typename T, int PER>
__device__ __forceinline__ void tree_argmax(T (&v)[PER], int (&at)[PER]) {
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
  // key, and its lowest index (kNoPoint where the thread has no point), by
  // tree_argmax.
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
    tree_argmax(v, at);
    key = order_key(v[0]);
    idx = v[0] < T(0) ? kNoPoint : static_cast<unsigned>(first + at[0] * stride);
  }
};

// A thread's points first + k * stride (k < PER) of a slice held in shared
// memory as rows x | y | z: their running minima in registers, their
// coordinates read from the rows on every step (more points a thread than
// Points keeps in registers). The rows hold PER * stride entries, zeros past
// the slice's `end`, so no read is out of bounds.
template <typename T, int PER>
struct SlicePoints {
  T d[PER];
  const T *sx, *sy, *sz;

  __device__ __forceinline__ void load(const T* x, const T* y, const T* z, int first, int stride,
                                       int end, T init) {
    sx = x;
    sy = y;
    sz = z;
#pragma unroll
    for (int k = 0; k < PER; ++k) d[k] = first + k * stride < end ? init : T(-1);
  }

  __device__ __forceinline__ void step(T cx, T cy, T cz, int first, int stride, unsigned& key,
                                       unsigned& idx) {
    T v[PER];
    int at[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int j = first + k * stride;
      d[k] = dmin(d[k], sq_dist(sx[j], sy[j], sz[j], cx, cy, cz));
      v[k] = d[k];
      at[k] = k;
    }
    tree_argmax(v, at);
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

// Grid: csize CTAs per cloud, in clusters of csize where csize > 1; CTA
// `rank` owns points [rank * slice, (rank + 1) * slice) and holds only them
// in shared memory, as rows x | y | z of cap = PER * blockDim.x entries.
// Pts: Points (coordinates in registers) or SlicePoints (read from the
// rows). A step's records, double-buffered in every CTA: the warp winners'
// (key, index) [2][ne] and their coordinates [2][ne] (x, y, z, 0 as bits),
// which every warp reduces itself, taking the coordinates of the record
// that wins (the lowest index among the equal keys: the same record in
// every warp). With one CTA a __syncthreads hands them over; in a cluster
// each warp sends both to every CTA with st.async and each CTA waits on its
// own mbarrier for the step's ne * 24 bytes. A buffer is written again two
// steps later, as in fps_cluster_kernel: a warp sends the next step only
// after its last read of the buffer.
template <typename T, int PER, class Pts>
__global__ void __launch_bounds__(kMaxThreads, 1)
fps_slice_kernel(const T* __restrict__ xyz, const int* __restrict__ starts,
                 int* __restrict__ out, int n, int npoint, T init, int csize, int slice) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int ne = csize * nw;
  const int cap = PER * blockDim.x;
  T* sx = reinterpret_cast<T*>(smem_raw);
  T* sy = sx + cap;
  T* sz = sy + cap;
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(
      smem_raw + ((3 * static_cast<size_t>(cap) * sizeof(T) + 15) & ~size_t(15)));
  uint4* coords = reinterpret_cast<uint4*>(bars + 2);   // 16-byte aligned
  uint2* records = reinterpret_cast<uint2*>(coords + 2 * ne);
  const int cloud = blockIdx.x / csize, rank = blockIdx.x % csize;
  const int base = rank * slice;
  const int cnt = max(0, min(n, base + slice) - base);
  const T* p = xyz + static_cast<size_t>(cloud) * n * 3;
  for (int j = tid; j < cap; j += blockDim.x) {
    const bool in = j < cnt;
    const size_t at = 3 * static_cast<size_t>(base + j);
    sx[j] = in ? p[at] : T(0);
    sy[j] = in ? p[at + 1] : T(0);
    sz[j] = in ? p[at + 2] : T(0);
  }
  unsigned to_rec0 = 0u, to_rec1 = 0u, to_crd0 = 0u, to_crd1 = 0u, to_bar0 = 0u, to_bar1 = 0u;
  if (csize > 1) {
    if (tid == 0) {
      mbar_init(smem_addr(bars), 1);
      mbar_init(smem_addr(bars + 1), 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    if (lane < csize) {
      const int slot = rank * nw + warp;
      to_rec0 = cluster_addr(smem_addr(records + slot), lane);
      to_rec1 = cluster_addr(smem_addr(records + ne + slot), lane);
      to_crd0 = cluster_addr(smem_addr(coords + slot), lane);
      to_crd1 = cluster_addr(smem_addr(coords + ne + slot), lane);
      to_bar0 = cluster_addr(smem_addr(bars), lane);
      to_bar1 = cluster_addr(smem_addr(bars + 1), lane);
    }
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
  Pts pts;
  pts.load(sx, sy, sz, tid, blockDim.x, cnt, init);
  unsigned far = starts ? static_cast<unsigned>(starts[cloud]) : 0u;
  T cx = p[3 * static_cast<size_t>(far)], cy = p[3 * static_cast<size_t>(far) + 1],
    cz = p[3 * static_cast<size_t>(far) + 2];
  int* o = out + static_cast<size_t>(cloud) * npoint;
  const bool writer = rank == 0 && warp == 0;
  int mine = 0;
  for (int it = 0;; ++it) {
    if (writer) keep_pick(o, it, npoint, far, lane, mine);
    if (it + 1 == npoint) break;
    const int b = it & 1;
    if (csize > 1 && tid == 0)
      mbar_expect(smem_addr(bars + b), ne * (sizeof(uint2) + sizeof(uint4)));
    unsigned key, idx;
    pts.step(cx, cy, cz, tid, blockDim.x, key, idx);   // idx: in the slice
    warp_best(key, idx);
    const bool none = idx == kNoPoint;
    const uint4 c = none ? make_uint4(0u, 0u, 0u, 0u)
                         : make_uint4(to_bits(sx[idx]), to_bits(sy[idx]), to_bits(sz[idx]), 0u);
    idx = none ? kNoPoint : base + idx;
    if (csize == 1) {
      if (lane == 0) {
        records[b * ne + warp] = make_uint2(key, idx);
        coords[b * ne + warp] = c;
      }
      __syncthreads();
    } else {
      if (lane < csize) {
        send(b ? to_rec1 : to_rec0, b ? to_bar1 : to_bar0, key, idx);
        send4(b ? to_crd1 : to_crd0, b ? to_bar1 : to_bar0, c);
      }
      mbar_wait(smem_addr(bars + b), (it >> 1) & 1);
    }
    key = 0;
    idx = kNoPoint;
    unsigned q_best = 0u;
    for (int q = lane; q < ne; q += 32) {
      const uint2 w = records[b * ne + q];
      if (w.x > key || (w.x == key && w.y < idx)) {
        key = w.x;
        idx = w.y;
        q_best = q;
      }
    }
    const unsigned mine_idx = idx;
    warp_best(key, idx);
    // the winning record: indices are distinct, so one lane holds it
    q_best = __reduce_min_sync(kFull, mine_idx == idx ? q_best : 0xffffffffu);
    const uint4 w = coords[b * ne + q_best];
    cx = from_bits<T>(w.x);
    cy = from_bits<T>(w.y);
    cz = from_bits<T>(w.z);
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

// A cluster kernel (fps_cluster_kernel or fps_slice_kernel: the same
// arguments) on b clouds of csize CTAs each.
template <typename T, auto kKernel>
cudaError_t launch_cluster(const T* xyz, const int* starts, int* out, int b, int n, int npoint,
                           T init, int csize, int slice, int threads, size_t smem,
                           cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  cudaError_t err = allow_smem(kKernel, smem, allowed);
  if (err != cudaSuccess) return err;
  if (csize == 1) {
    kKernel<<<b, threads, smem, stream>>>(xyz, starts, out, n, npoint, init, csize, slice);
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
  err = cudaLaunchKernelEx(&cfg, kKernel, xyz, starts, out, n, npoint, init, csize, slice);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Shared memory of fps_cluster_kernel (the whole cloud) and of
// fps_slice_kernel (a slice of per * threads points), in bytes.
template <typename T>
size_t cloud_smem(int n, int cluster, int threads) {
  return ((3 * static_cast<size_t>(n) * sizeof(T) + 15) & ~size_t(15)) +
         2 * sizeof(unsigned long long) +
         2 * static_cast<size_t>(cluster) * (threads / 32) * sizeof(uint2);
}

template <typename T>
size_t slice_smem(int per, int cluster, int threads) {
  return ((3 * static_cast<size_t>(per) * threads * sizeof(T) + 15) & ~size_t(15)) +
         2 * sizeof(unsigned long long) +
         2 * static_cast<size_t>(cluster) * (threads / 32) * (sizeof(uint2) + sizeof(uint4));
}

// cluster 0: a warp per cloud, threads / 32 clouds a block; cluster >= 1:
// that many CTAs of `threads` per cloud, each with a slice of n / cluster
// points: fps_cluster_kernel where the whole cloud fits a CTA's shared
// memory and a thread keeps at most kMaxPer points, else fps_slice_kernel.
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
  if (threads > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  const int slice = (n + cluster - 1) / cluster;
  const int per = pow2_at_least((slice + threads - 1) / threads);
  const size_t csmem = cloud_smem<T>(n, cluster, threads);
  if (per <= kMaxPer && csmem <= kMaxSmem) {
    switch (per) {
      case 1: return static_cast<int>(launch_cluster<T, fps_cluster_kernel<T, 1>>(
          xyz, starts, out, b, n, npoint, init, cluster, slice, threads, csmem, stream));
      case 2: return static_cast<int>(launch_cluster<T, fps_cluster_kernel<T, 2>>(
          xyz, starts, out, b, n, npoint, init, cluster, slice, threads, csmem, stream));
      case 4: return static_cast<int>(launch_cluster<T, fps_cluster_kernel<T, 4>>(
          xyz, starts, out, b, n, npoint, init, cluster, slice, threads, csmem, stream));
      default: return static_cast<int>(launch_cluster<T, fps_cluster_kernel<T, 8>>(
          xyz, starts, out, b, n, npoint, init, cluster, slice, threads, csmem, stream));
    }
  }
  const size_t ssmem = slice_smem<T>(per, cluster, threads);
  if (per > kSliceMaxPer || (per > 16 && threads > kSlice32Threads) || ssmem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (per) {
    case 1: return static_cast<int>(launch_cluster<T, fps_slice_kernel<T, 1, Points<T, 1>>>(
        xyz, starts, out, b, n, npoint, init, cluster, slice, threads, ssmem, stream));
    case 2: return static_cast<int>(launch_cluster<T, fps_slice_kernel<T, 2, Points<T, 2>>>(
        xyz, starts, out, b, n, npoint, init, cluster, slice, threads, ssmem, stream));
    case 4: return static_cast<int>(launch_cluster<T, fps_slice_kernel<T, 4, Points<T, 4>>>(
        xyz, starts, out, b, n, npoint, init, cluster, slice, threads, ssmem, stream));
    case 8: return static_cast<int>(launch_cluster<T, fps_slice_kernel<T, 8, Points<T, 8>>>(
        xyz, starts, out, b, n, npoint, init, cluster, slice, threads, ssmem, stream));
    case 16: return static_cast<int>(
        launch_cluster<T, fps_slice_kernel<T, 16, SlicePoints<T, 16>>>(
            xyz, starts, out, b, n, npoint, init, cluster, slice, threads, ssmem, stream));
    default: return static_cast<int>(
        launch_cluster<T, fps_slice_kernel<T, 32, SlicePoints<T, 32>>>(
            xyz, starts, out, b, n, npoint, init, cluster, slice, threads, ssmem, stream));
  }
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
