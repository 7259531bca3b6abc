"""Chamfer distance and chunked nearest-neighbour reductions (counterpart of
pcc_tpu/ops/chamfer.py; reference AE.py:67, pytorch3d's chamfer_distance).

Every function takes clouds with any leading batch dimensions: x [..., S, 3]
against y [..., N, 3]. The [S, N] distance matrix is never built whole: the
key side runs in chunks of 2048 points with a running minimum, the last
chunk padded and masked with inf. Ties go to the lowest index, as
jnp.argmin's do (torch.argmin returns the first minimum, and a later chunk
replaces the running best only when strictly closer).

`chamfer_distance(fast_search=True)`, the training loss's search, takes the
chamfer kernels (ops/chamfer_cuda.py: csrc/chamfer_fwd.cu and its backward
csrc/chamfer_bwd.cu on the card, their plain versions on the CPU) whenever
the clouds are in their domain, float32 [P, k, 3] against [P, K, 3] with
8 <= k, K <= 2^29 (`fits_kernel`). The function is pcc_tpu's (the same
selection rule, the same exact recompute, the same gradient through the
gather), but pcc_tpu takes its Pallas kernels only while one pair's [k, K]
problem fits in VMEM, k * K <= 2^19 (pcc_tpu/ops/chamfer.py:187-195); the
CUDA kernels stream the other side and take any size. Both trainers pass
whole clouds, [B, S*k, 3] against [B, N, 3], so every train step of both
families runs the kernels, at N = 512 and N = 8192 alike. Clouds outside
the domain (fewer than 8 points, another dtype) and fast_search=False take
the chunked plain path here.
"""

from __future__ import annotations

import torch

from pcc_tpu_torch.ops.chamfer_cuda import chamfer_min_dists, fits_kernel

_CHUNK = 2048


def _sq_diff(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[..., S, 3] x [..., M, 3] -> [..., S, M] exact squared distances
    (direct differences, not the expansion, which loses float32 precision
    near zero)."""
    return ((x[..., :, None, :] - y[..., None, :, :]) ** 2).sum(-1)


def _chunks(y: torch.Tensor, chunk: int):
    """Yield (start, [..., chunk, 3] slice, [chunk] validity) over y's
    points, the last chunk zero-padded to full width."""
    N = y.shape[-2]
    for s in range(0, N, chunk):
        yc = y[..., s:s + chunk, :]
        valid = torch.ones(chunk, dtype=torch.bool, device=y.device)
        if yc.shape[-2] < chunk:
            rem = chunk - yc.shape[-2]
            valid[chunk - rem:] = False
            yc = torch.cat([yc, yc.new_zeros(yc.shape[:-2] + (rem, yc.shape[-1]))], dim=-2)
        yield s, yc, valid


def _running_best(x: torch.Tensor, y: torch.Tensor, chunk: int, dist):
    """(min distance, argmin index int64) of each x over y's chunks, with
    `dist(x, y_chunk)` -> [..., S, chunk]."""
    best_d = best_i = None
    for s, yc, valid in _chunks(y, chunk):
        d = torch.where(valid, dist(x, yc), torch.inf)
        d_min, i_min = d.min(dim=-1)
        i_min = i_min + s
        if best_d is None:
            best_d, best_i = d_min, i_min
        else:
            take = d_min < best_d
            best_d = torch.where(take, d_min, best_d)
            best_i = torch.where(take, i_min, best_i)
    return best_d, best_i


def min_sq_dists(x: torch.Tensor, y: torch.Tensor, chunk: int = _CHUNK) -> torch.Tensor:
    """Per-point min squared distance from each x to the set y: [..., S]."""
    if y.shape[-2] <= chunk:
        return _sq_diff(x, y).min(dim=-1).values
    return _running_best(x, y, chunk, _sq_diff)[0]


def nearest_neighbor(x: torch.Tensor, y: torch.Tensor, chunk: int = _CHUNK):
    """Exact 1-NN of each x in y by chunked direct differences. Both sides
    are chunked, so memory stays at [..., chunk, chunk].
    Returns (min_sq_dist [..., S], idx [..., S] int64)."""
    S = x.shape[-2]
    if S > chunk:
        parts = [nearest_neighbor(x[..., s:s + chunk, :], y, chunk)
                 for s in range(0, S, chunk)]
        return (torch.cat([d for d, _ in parts], dim=-1),
                torch.cat([i for _, i in parts], dim=-1))
    if y.shape[-2] <= chunk:
        d = _sq_diff(x, y)
        return d.min(dim=-1).values, d.argmin(dim=-1)
    return _running_best(x, y, chunk, _sq_diff)


def _nn_expansion(x: torch.Tensor, y: torch.Tensor, chunk: int = _CHUNK) -> torch.Tensor:
    """1-NN index search by the expansion x2 - 2 x.y + y2: one matrix
    product per chunk. Selection-only precision (a near-tie can resolve to
    another point equidistant to float error): safe where the distance is
    recomputed exactly afterwards, as in the training loss.
    Returns idx [..., S] int64."""
    x2 = (x * x).sum(-1)[..., :, None]

    def dist(a, yc):
        return (x2 - 2.0 * (a @ yc.transpose(-1, -2))) + (yc * yc).sum(-1)[..., None, :]

    return _running_best(x, y, chunk, dist)[1]


def _directed_mean_sq(x: torch.Tensor, y: torch.Tensor,
                      fast_search: bool = False) -> torch.Tensor:
    """mean_i min_j |x_i - y_j|^2 -> [...], differentiable in both clouds.

    The argmin search runs without gradient, then the distance is
    recomputed through a gather: d(min)/dx is the gradient at the argmin,
    so this is exact (pcc_tpu/ops/chamfer.py:142-160)."""
    with torch.no_grad():
        if fast_search:
            idx = _nn_expansion(x, y)
        else:
            idx = nearest_neighbor(x, y)[1]
    y_near = torch.gather(y, -2, idx[..., None].expand(*idx.shape, y.shape[-1]))
    return ((x - y_near) ** 2).sum(-1).mean(-1)


def chamfer_distance(x: torch.Tensor, y: torch.Tensor, fast_search: bool = False):
    """Symmetric chamfer distance with pytorch3d's semantics: the mean over
    points of the min squared distance in each direction, summed, then
    averaged over the batch. x: [B, S, 3]; y: [B, N, 3]. Returns
    (loss, None), the tuple the reference unpacks (AE.py:67).

    fast_search=True searches by the expansion form (the loss is still the
    exactly recomputed gathered distance); the training step uses it. It
    goes through the chamfer kernels where `fits_kernel(x, y)` holds."""
    if fast_search and fits_kernel(x, y):
        dxy, dyx = chamfer_min_dists(x, y)
        return torch.mean(torch.mean(dxy, dim=-1) + torch.mean(dyx, dim=-1)), None
    d_xy = _directed_mean_sq(x, y, fast_search)
    d_yx = _directed_mean_sq(y, x, fast_search)
    return torch.mean(d_xy + d_yx), None
