"""The per-cloud chamfer forward and its backward (counterpart of
pcc_tpu/ops/chamfer_pallas.py: TPU kernels _fwd_kernel and _bwd_kernel,
entry chamfer_min_dists).

For clouds x [P, k, 3] and y [P, K, 3], `chamfer_fwd` finds each point's
nearest neighbour in the other cloud of its pair, both ways, by the argmin
of the expansion (a2 - 2 a.b) + b2, unclamped, with ties to the lowest
index; the distance at that index is then recomputed exactly as
|a - b_near|^2. It returns (dxy [P, k], dyx [P, K], ixy [P, k], iyx [P, K]),
the indices int32. `chamfer_bwd` is the gradient of the two distance
vectors against cotangents gx [P, k], gy [P, K] through the gather at the
fixed argmin:

  dx_i = 2 (x_i - y_ixy[i]) gx_i - sum_{j: iyx[j] = i} 2 (y_j - x_i) gy_j

and symmetrically for dy. Each wrapper launches its CUDA kernel
(csrc/chamfer_fwd.cu, csrc/chamfer_bwd.cu) on CUDA tensors, runs its plain
version on CPU tensors and raises on anything else. The kernels take any
[P, k, 3] vs [P, K, 3] float32 clouds with 8 <= k, K <= MAX_POINTS
(`fits_kernel`): they stream the other side in chunks and never stage a
pair's [k, K] problem, so pcc_tpu's k * K <= 2^19 (its Pallas kernel's VMEM
bound) does not apply. The design notes are at the top of their sources.

The plain forward writes the cross term coordinate by coordinate, one
rounding per operation (ops/knn.py::expanded_sq_dists), as the kernel
does, so the indices are bit-equal on both devices.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pcc_tpu_torch.ops import cuda_lib
from pcc_tpu_torch.ops.knn import expanded_sq_dists, sq_norms

MIN_POINTS = 8            # pcc_tpu's lower bound, kept
# points per cloud: indices and 3 * index in int32 (csrc/chamfer_common.cuh)
MAX_POINTS = 1 << 29
PLAIN_PAIRS = 1 << 24     # point pairs per pass of the plain forward (bounds its memory)
# the forward's launch plans (csrc/chamfer_fwd.cu): query points per thread
# (128 threads a block) and candidates per block
QUERIES = (2, 8)
CHUNKS = (256, 512, 1024, 2048)
_SMS = 132                # an H100 SXM's SMs
_FWD_ARGTYPES = ([cuda_lib.PTR] * 2 + [cuda_lib.INT] * 5 + [cuda_lib.PTR] * 6
                 + [ctypes.c_longlong, cuda_lib.PTR])
_BWD_ARGTYPES = [cuda_lib.PTR] * 6 + [cuda_lib.INT] * 3 + [cuda_lib.PTR] * 4


def fits_kernel(x, y) -> bool:
    """Whether clouds x [P, k, 3] and y [P, K, 3] are in the kernels'
    domain: 3-D float32, the same P >= 1, MIN_POINTS <= k, K <= MAX_POINTS."""
    return (x.dim() == 3 and y.dim() == 3 and x.dtype == y.dtype == torch.float32
            and x.shape[0] == y.shape[0] >= 1 and x.shape[2] == y.shape[2] == 3
            and MIN_POINTS <= x.shape[1] <= MAX_POINTS
            and MIN_POINTS <= y.shape[1] <= MAX_POINTS)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _fwd_blocks(P: int, k: int, K: int, plan) -> int:
    q, chunk = plan
    return P * (_cdiv(k, 128 * q) * _cdiv(K, chunk) + _cdiv(K, 128 * q) * _cdiv(k, chunk))


def candidate_plans(P: int, k: int, K: int) -> list:
    """Every (queries per thread, chunk) the forward takes at these shapes
    that splits the candidates differently."""
    plans, seen = [], set()
    for q in QUERIES:
        for chunk in CHUNKS:
            key = (q, _cdiv(K, chunk), _cdiv(k, chunk))
            if key not in seen:
                seen.add(key)
                plans.append((q, chunk))
    return plans


@functools.lru_cache(maxsize=64)
def fwd_plan(P: int, k: int, K: int):
    """The launcher's rule, from every plan timed on an H100 at the train
    paths' shapes (tools/chamfer_breakdown.py): 8 query points a thread
    where both clouds have 1024 points or more, else 2; the largest chunk
    no longer than the smaller cloud (so no block does twice another's
    work), halved while the grid gives an SM fewer than two blocks."""
    q = 8 if min(k, K) >= 1024 else 2
    fit = [c for c in CHUNKS if c <= min(k, K)] or [min(CHUNKS)]
    chunk = max(fit)
    while chunk > min(CHUNKS) and _fwd_blocks(P, k, K, (q, chunk)) < 2 * _SMS:
        chunk //= 2
    return q, chunk


def fwd_scratch(P: int, k: int, K: int, plan) -> int:
    """Floats (and as many ints) the forward's partial minima take: per
    direction with more than one chunk, one per chunk and query point."""
    _, chunk = plan
    sx, sy = _cdiv(K, chunk), _cdiv(k, chunk)
    return (sx * P * k if sx > 1 else 0) + (sy * P * K if sy > 1 else 0)


def _gather(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [P, n, 3] at idx [P, m] -> [P, m, 3]."""
    return torch.gather(points, 1, idx.long()[..., None].expand(-1, -1, 3))


def _nearest(a: torch.Tensor, b: torch.Tensor):
    """(exact distance [P, n], index int32 [P, n]) of each point of a in b,
    about PLAIN_PAIRS point pairs at a time: whole cloud pairs where one
    fits, else rows of a's points of one pair (rows are independent)."""
    P, n, m = a.shape[0], a.shape[1], b.shape[1]
    step = PLAIN_PAIRS // max(1, n * m)
    if step >= 1:
        idx = torch.cat([expanded_sq_dists(a[s:s + step], b[s:s + step]).argmin(dim=-1)
                         for s in range(0, P, step)])
    else:
        rows = max(1, PLAIN_PAIRS // m)
        idx = torch.stack([torch.cat([expanded_sq_dists(a[p, r:r + rows], b[p]).argmin(dim=-1)
                                      for r in range(0, n, rows)]) for p in range(P)])
    return sq_norms(a - _gather(b, idx)), idx.to(torch.int32)


def chamfer_fwd_plain(x: torch.Tensor, y: torch.Tensor):
    """(dxy [P, k], dyx [P, K], ixy [P, k], iyx [P, K]) in plain PyTorch.
    torch.argmin returns the first of equal minima: ties go to the lowest
    index, as in the kernel."""
    dxy, ixy = _nearest(x, y)
    dyx, iyx = _nearest(y, x)
    return dxy, dyx, ixy, iyx


def chamfer_bwd_plain(x, y, ixy, iyx, gx, gy):
    """(dx [P, k, 3], dy [P, K, 3]) in plain PyTorch: the direct term of
    each side minus the scatter-back of the other side's gathers."""
    exy = 2.0 * (x - _gather(y, ixy)) * gx[..., None]
    eyx = 2.0 * (y - _gather(x, iyx)) * gy[..., None]
    back_x = torch.zeros_like(x).scatter_add_(1, iyx.long()[..., None].expand(-1, -1, 3), eyx)
    back_y = torch.zeros_like(y).scatter_add_(1, ixy.long()[..., None].expand(-1, -1, 3), exy)
    return exy - back_x, eyx - back_y


def _check(name: str, x: torch.Tensor, y: torch.Tensor) -> None:
    """Raise unless x [P, k, 3] and y [P, K, 3] are what the kernels take."""
    cuda_lib.require_cuda(f"{name} x", x, torch.float32, 3)
    cuda_lib.require_cuda(f"{name} y", y, torch.float32, 3)
    if x.device != y.device or not fits_kernel(x, y):
        raise ValueError(f"{name}: unsupported clouds {tuple(x.shape)} vs {tuple(y.shape)}: "
                         f"needs [P, k, 3] and [P, K, 3] on one device, "
                         f"{MIN_POINTS} <= k, K <= {MAX_POINTS}")


def chamfer_fwd(x: torch.Tensor, y: torch.Tensor, plan=None):
    """(dxy, dyx, ixy, iyx) of clouds x [P, k, 3], y [P, K, 3] f32: the CUDA
    kernel on CUDA tensors (by `plan`, (queries per thread, chunk), default
    the launcher's rule fwd_plan), the plain version on CPU tensors."""
    if x.device.type == "cpu" and y.device.type == "cpu":
        return chamfer_fwd_plain(x, y)
    _check("chamfer_fwd", x, y)
    P, k, _ = x.shape
    K = y.shape[1]
    plan = fwd_plan(P, k, K) if plan is None else tuple(plan)
    if plan[0] not in QUERIES or plan[1] not in CHUNKS:
        raise ValueError(f"chamfer_fwd: unsupported plan {plan}")
    if _fwd_blocks(P, k, K, plan) > 2**31 - 1:
        raise ValueError(f"chamfer_fwd: clouds {tuple(x.shape)} vs {tuple(y.shape)} need "
                         "more blocks than a grid holds")
    dev = x.device
    dxy = torch.empty((P, k), dtype=torch.float32, device=dev)
    dyx = torch.empty((P, K), dtype=torch.float32, device=dev)
    ixy = torch.empty((P, k), dtype=torch.int32, device=dev)
    iyx = torch.empty((P, K), dtype=torch.int32, device=dev)
    n_part = fwd_scratch(P, k, K, plan)
    parts = [torch.empty(n_part, dtype=t, device=dev) for t in (torch.float32, torch.int32)] \
        if n_part else []
    cuda_lib.launch("chamfer_fwd", _FWD_ARGTYPES, x.data_ptr(), y.data_ptr(), P, k, K, *plan,
                    dxy.data_ptr(), dyx.data_ptr(), ixy.data_ptr(), iyx.data_ptr(),
                    *([t.data_ptr() for t in parts] or [None, None]), n_part,
                    cuda_lib.stream_ptr(x))
    return dxy, dyx, ixy, iyx


def chamfer_bwd(x, y, ixy, iyx, gx, gy):
    """(dx [P, k, 3], dy [P, K, 3]) against cotangents gx [P, k], gy [P, K]:
    the CUDA kernel on CUDA tensors (deterministic: each point's gathers
    summed in ascending order, no atomics), the plain version on CPU
    tensors."""
    if all(t.device.type == "cpu" for t in (x, y, ixy, iyx, gx, gy)):
        return chamfer_bwd_plain(x, y, ixy, iyx, gx, gy)
    _check("chamfer_bwd", x, y)
    P, k, _ = x.shape
    K = y.shape[1]
    for nm, t, dtype, shape in (("ixy", ixy, torch.int32, (P, k)),
                                ("iyx", iyx, torch.int32, (P, K)),
                                ("gx", gx, torch.float32, (P, k)),
                                ("gy", gy, torch.float32, (P, K))):
        cuda_lib.require_cuda(f"chamfer_bwd {nm}", t, dtype, 2)
        if tuple(t.shape) != shape:
            raise ValueError(f"chamfer_bwd: {nm} {tuple(t.shape)} != {shape}")
        if t.device != x.device:
            raise ValueError(f"chamfer_bwd: {nm} on {t.device}, the clouds on {x.device}")
    dx, dy = torch.empty_like(x), torch.empty_like(y)
    order = torch.empty(P * (k + K), dtype=torch.int32, device=x.device)
    cuda_lib.launch("chamfer_bwd", _BWD_ARGTYPES, x.data_ptr(), y.data_ptr(),
                    ixy.data_ptr(), iyx.data_ptr(), gx.data_ptr(), gy.data_ptr(), P, k, K,
                    dx.data_ptr(), dy.data_ptr(), order.data_ptr(), cuda_lib.stream_ptr(x))
    return dx, dy


class ChamferFn(torch.autograd.Function):
    """(dxy, dyx) with the backward kernel (pcc_tpu's custom VJP,
    chamfer_pallas.py::_make_min_dists): forward `chamfer_fwd`, saving x, y
    and the indices; backward `chamfer_bwd`."""

    @staticmethod
    def forward(ctx, x, y):
        dxy, dyx, ixy, iyx = chamfer_fwd(x, y)
        ctx.save_for_backward(x, y, ixy, iyx)
        return dxy, dyx

    @staticmethod
    def backward(ctx, gx, gy):
        # autograd materializes the cotangent of an unused output as zeros
        x, y, ixy, iyx = ctx.saved_tensors
        return chamfer_bwd(x, y, ixy, iyx, gx.contiguous(), gy.contiguous())


def chamfer_min_dists(x: torch.Tensor, y: torch.Tensor):
    """Differentiable per-point min squared distances both ways, (dxy [P, k],
    dyx [P, K]), of clouds x [P, k, 3] and y [P, K, 3] (pcc_tpu's
    chamfer_min_dists)."""
    return ChamferFn.apply(x.contiguous(), y.contiguous())


def fwd_work(P: int, k: int, K: int):
    """(operations, bytes) the forward needs: 9 operations per point pair
    and direction (the cross term's 3 products and 2 sums, the doubling,
    the difference, the sum, the comparison), 5 per point for its squared
    norm and 8 for its exact recompute; x and y read once, the distances
    and indices written once."""
    flops = P * (2 * 9.0 * k * K + 13.0 * (k + K))
    return flops, 4.0 * P * (3 * (k + K) + 2 * (k + K))


def bwd_work(P: int, k: int, K: int):
    """(operations, bytes) the backward needs: per point 9 operations for
    its gather term 2 (a - b_near) g, 3 to add it into its neighbour's sum
    and 3 for the final difference; x, y, the indices and the cotangents
    read once, dx and dy written once."""
    return 15.0 * P * (k + K), 4.0 * P * (k + K) * (3 + 1 + 1 + 3)
