"""Farthest point sampling (counterpart of pcc_tpu/ops/fps.py::fps_batch and
its TPU kernel pcc_tpu/ops/fps_pallas.py::_fps_kernel).

`fps_batch` launches the CUDA kernel csrc/fps.cu on a CUDA tensor and runs
`fps_plain`, the same function in plain PyTorch, on a CPU tensor. The two
give bit-equal indices: both compute ((dx*dx + dy*dy) + dz*dz) with one
rounding per operation and take the lowest index among equal maxima. The
kernel's design note (what bounds it on an H100, what it does about that)
is at the top of csrc/fps.cu.
"""

from __future__ import annotations

import torch

from pcc_tpu_torch.ops import cuda_lib

_ARGTYPES = [cuda_lib.PTR, cuda_lib.PTR, cuda_lib.PTR, cuda_lib.INT,
             cuda_lib.INT, cuda_lib.INT, cuda_lib.PTR]
MAX_POINTS = 16384   # csrc/fps.cu keeps N / 1024 <= 16 distances per thread


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
        dist = torch.minimum(dist, dx * dx + dy * dy + dz * dz)
        m = dist.amax(dim=-1, keepdim=True)
        far = torch.where(dist == m, iota, N).amin(dim=-1)
    return out


def fps_batch(xyz: torch.Tensor, npoint: int, starts: torch.Tensor) -> torch.Tensor:
    """Batched FPS with explicit start indices: [B, N, 3] f32 + starts [B]
    -> [B, npoint] int32. CUDA kernel on a CUDA tensor, plain version on a
    CPU tensor."""
    if xyz.device.type == "cpu":
        return fps_plain(xyz, npoint, starts)
    cuda_lib.require_cuda("fps_batch", xyz, torch.float32, 3)
    B, N, C = xyz.shape
    if C != 3 or not 0 < N <= MAX_POINTS or npoint <= 0:
        raise ValueError(f"fps_batch: unsupported shape {tuple(xyz.shape)}, "
                         f"npoint={npoint} (N <= {MAX_POINTS})")
    starts = starts.to(device=xyz.device, dtype=torch.int32).contiguous()
    if starts.shape != (B,):
        raise ValueError(f"fps_batch: starts shape {tuple(starts.shape)} != ({B},)")
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    cuda_lib.launch("fps", _ARGTYPES, xyz.data_ptr(), starts.data_ptr(),
                    out.data_ptr(), B, N, npoint, cuda_lib.stream_ptr(xyz))
    return out
