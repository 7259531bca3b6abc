"""Farthest point sampling (counterpart of pcc_tpu/ops/fps.py::fps_batch and
its TPU kernel pcc_tpu/ops/fps_pallas.py::_fps_kernel), on float32
coordinates and, for the integer probability model, on int32 grid
coordinates (counterpart of pcc_tpu/coding/iprob_pppf.py::_int_fps_jnp).

`fps_batch` and `fps_int_batch` launch the two instances of the CUDA kernel
csrc/fps.cu on a CUDA tensor and run `fps_plain` / `fps_int_plain`, the
same functions in plain PyTorch, on a CPU tensor. Kernel and plain version
give bit-equal indices: both compute ((dx*dx + dy*dy) + dz*dz) with one
rounding per operation (exactly, in int32) and take the lowest index among
equal maxima. `plan` is the launcher's fixed rule by shape: a warp per
cloud for small clouds, a cluster of CTAs per cloud for large ones, each
CTA with the whole cloud up to 16384 points and with its own slice past
that, up to MAX_POINTS. The
kernel's design note (what bounds it on an H100, what it does about that)
is at the top of csrc/fps.cu.
"""

from __future__ import annotations

import torch

from pcc_tpu_torch.ops import cuda_lib

_ARGTYPES = [cuda_lib.PTR, cuda_lib.PTR, cuda_lib.PTR, cuda_lib.INT, cuda_lib.INT,
             cuda_lib.INT, cuda_lib.INT, cuda_lib.INT, cuda_lib.PTR]
_INT_ARGTYPES = [cuda_lib.PTR, cuda_lib.PTR, cuda_lib.INT, cuda_lib.INT, cuda_lib.INT,
                 cuda_lib.INT, cuda_lib.INT, cuda_lib.INT, cuda_lib.PTR]
MAX_POINTS = 131072       # csrc/fps.cu: 8 CTAs x 1024 x 16 = 8 x 512 x 32 points (16384 a CTA)
WARP_MAX_POINTS = 512     # a warp per cloud: at most 16 points a lane
_MAX_PER_THREAD = 8       # points a thread in registers
_SLICE_MAX_PER = 32       # points a thread of a slice in shared memory
_SLICE32_THREADS = 512    # 32 points a thread only in CTAs of up to 512 threads
_CLUSTERS = (1, 2, 4, 8)  # CTAs per cloud the kernel takes (8: the portable cluster size)
_MAX_CLUSTER_PICKED = 4
_SMS = 132                # an H100 SXM's SMs
_MAX_SMEM = 232448        # shared memory a block can have on an H100 (227 KB)
WHOLE_CLOUD_POINTS = 16384  # the largest cloud whose copy csrc/fps.cu keeps in every CTA


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def kernel_takes(N: int, cluster: int, threads: int) -> bool:
    """Whether csrc/fps.cu's launcher takes the plan (cluster, threads) at
    clouds of N points (its checks, mirrored): a warp per cloud up to 512
    points; else each of `cluster` CTAs holds the whole cloud in shared
    memory (up to 8 points a thread) or only its slice (up to 16, or 32
    with up to 512 threads)."""
    if threads % 32 or threads < 32:
        return False
    if cluster == 0:
        return N <= WARP_MAX_POINTS and threads <= 256
    if cluster not in _CLUSTERS or threads > 1024:
        return False
    slice_ = -(-N // cluster)
    per = _pow2_at_least(-(-slice_ // threads))
    warps = threads // 32
    whole = ((12 * N + 15) & ~15) + 16 + 2 * cluster * warps * 8
    if per <= _MAX_PER_THREAD and whole <= _MAX_SMEM:
        return True
    sliced = ((12 * per * threads + 15) & ~15) + 16 + 2 * cluster * warps * 24
    return (per <= _SLICE_MAX_PER and (per <= 16 or threads <= _SLICE32_THREADS)
            and sliced <= _MAX_SMEM)


def plan(B: int, N: int) -> tuple[int, int]:
    """The launch plan (cluster, threads) for B clouds of N points, the
    fastest measured at the paths' shapes (every candidate plan timed on an
    H100 by tools/fps_breakdown.py; PERF.md). cluster 0: a warp per
    cloud, 4 clouds a block. Up to 16384 points, cluster CTAs of `threads`
    threads per cloud, each thread with up to 8 points: as many CTAs as
    fill the card's SMs once, up to 4 (8 measured no faster at B = 8, slower
    at B = 16). Past 16384 points (the large-scene rooms), 8 CTAs of a
    power of two threads, up to 512, each CTA holding its slice, with 17-32
    points a thread read from the slice: the fastest plan measured at [4,
    65536] (256 threads, 0.774 ms; 512 threads 0.908, 1024 with the points
    in registers 0.957) and [1, 100000] (512 threads, 1.885 ms; 1024 threads
    2.235), fewer records to reduce a step outweighing the reads."""
    if N <= WARP_MAX_POINTS:
        return 0, 128
    if N > WHOLE_CLOUD_POINTS:
        c = _CLUSTERS[-1]
        return c, min(_SLICE32_THREADS, max(32, _pow2_at_least(-(-N // (c * 32)))))
    c = 1
    while c < _MAX_CLUSTER_PICKED and B * c * 2 <= _SMS:
        c *= 2
    return c, min(1024, _round32(-(-N // (c * _MAX_PER_THREAD))))


def candidate_plans(N: int) -> list[tuple[int, int]]:
    """Every plan the kernel takes for clouds of N points."""
    out = [(0, t) for t in (32, 64, 128, 256)] if N <= WARP_MAX_POINTS else []
    for c in _CLUSTERS:
        for t in (32, 64, 128, 256, 512, 1024):
            if t <= _round32(-(-N // c)) and kernel_takes(N, c, t):
                out.append((c, t))
    return out


def _round32(n: int) -> int:
    return max(32, -(-n // 32) * 32)


def fps_plain(xyz: torch.Tensor, npoint: int, starts: torch.Tensor) -> torch.Tensor:
    """[B, N, 3] f32 + first indices [B] -> [B, npoint] int32: npoint
    sequential farthest-point picks per cloud, running min of the squared
    distance to the chosen set, argmax with the lowest index on ties."""
    B, N, _ = xyz.shape
    x, y, z = xyz.unbind(-1)
    rows = torch.arange(B, device=xyz.device)
    iota = torch.arange(N, device=xyz.device)
    dist = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    far = starts.to(device=xyz.device, dtype=torch.int64)
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    for i in range(npoint):
        out[:, i] = far
        c = xyz[rows, far]                                   # [B, 3]
        dx = x - c[:, 0:1]
        dy = y - c[:, 1:2]
        dz = z - c[:, 2:3]
        # fmin, the kernel's fminf: a NaN distance leaves the minimum as it
        # was, so a cloud with NaN points still gives indices in range
        dist = torch.fmin(dist, dx * dx + dy * dy + dz * dz)
        m = dist.amax(dim=-1, keepdim=True)
        far = torch.where(dist == m, iota, N).amin(dim=-1)
    return out


def fps_int_plain(xs: torch.Tensor, npoint: int, inf: int) -> torch.Tensor:
    """[B, n, 3] int32 grid coordinates -> [B, npoint] int32: the same picks
    in exact int32 arithmetic, from index 0, running minima starting at inf
    (> every squared distance). npoint > n saturates: once every point is
    picked all minima are 0 and index 0 wins."""
    B, n, _ = xs.shape
    rows = torch.arange(B, device=xs.device)
    iota = torch.arange(n, device=xs.device)
    out = torch.empty((B, npoint), dtype=torch.int32, device=xs.device)
    dist = torch.full((B, n), inf, dtype=torch.int32, device=xs.device)
    far = torch.zeros((B,), dtype=torch.int64, device=xs.device)
    for i in range(npoint):
        out[:, i] = far
        c = xs[rows, far]                                  # [B, 3]
        dist = torch.minimum(dist, ((xs - c[:, None, :]) ** 2).sum(-1, dtype=torch.int32))
        # masked argmax: the lowest index among equal maxima
        far = torch.where(dist == dist.amax(dim=1, keepdim=True), iota, n).amin(dim=1)
    return out


def _check(name: str, x: torch.Tensor, npoint: int) -> None:
    B, N, C = x.shape
    if C != 3 or not 0 < N <= MAX_POINTS or B <= 0 or npoint <= 0:
        raise ValueError(f"{name}: unsupported shape {tuple(x.shape)}, npoint={npoint} "
                         f"(N <= {MAX_POINTS})")


def _launch(x: torch.Tensor, npoint: int, starts, inf, plan_) -> torch.Tensor:
    """One launch of the float32 instance (starts given) or the int32 one
    (inf given) under launch plan plan_ = (cluster, threads)."""
    B, N, _ = x.shape
    cluster, threads = plan_
    out = torch.empty((B, npoint), dtype=torch.int32, device=x.device)
    stream = cuda_lib.stream_ptr(x)
    if inf is None:
        cuda_lib.launch("fps", _ARGTYPES, x.data_ptr(), starts.data_ptr(), out.data_ptr(),
                        B, N, npoint, cluster, threads, stream)
    else:
        cuda_lib.launch("fps_int", _INT_ARGTYPES, x.data_ptr(), out.data_ptr(), B, N, npoint,
                        inf, cluster, threads, stream)
    return out


def fps_batch(xyz: torch.Tensor, npoint: int, starts: torch.Tensor) -> torch.Tensor:
    """Batched FPS with explicit start indices: [B, N, 3] f32 + starts [B]
    -> [B, npoint] int32. CUDA kernel on a CUDA tensor, plain version on a
    CPU tensor."""
    if xyz.device.type == "cpu":
        return fps_plain(xyz, npoint, starts)
    cuda_lib.require_cuda("fps_batch", xyz, torch.float32, 3)
    _check("fps_batch", xyz, npoint)
    B, N, _ = xyz.shape
    starts = starts.to(device=xyz.device, dtype=torch.int32).contiguous()
    if starts.shape != (B,):
        raise ValueError(f"fps_batch: starts shape {tuple(starts.shape)} != ({B},)")
    return _launch(xyz, npoint, starts, None, plan(B, N))


def fps_int_batch(xs: torch.Tensor, npoint: int, inf: int) -> torch.Tensor:
    """Integer FPS: [B, n, 3] int32 grid coordinates -> [B, npoint] int32,
    from index 0, running minima starting at inf. CUDA kernel on a CUDA
    tensor, plain version on a CPU tensor."""
    if xs.device.type == "cpu":
        return fps_int_plain(xs, npoint, inf)
    cuda_lib.require_cuda("fps_int_batch", xs, torch.int32, 3)
    _check("fps_int_batch", xs, npoint)
    if not 0 < inf < 2 ** 31:
        raise ValueError(f"fps_int_batch: inf={inf} is not a positive int32")
    B, N, _ = xs.shape
    return _launch(xs, npoint, None, int(inf), plan(B, N))
