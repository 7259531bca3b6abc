"""PCA normal estimation (counterpart of pcc_tpu/ops/normals.py).

Replaces open3d's estimate_normals(KNN=30) of the reference's D2 metric
(eval.py:59-60): for each point, the covariance of its 30 nearest
neighbours (itself included), and the eigenvector of the smallest
eigenvalue as its normal. The sign is irrelevant downstream (the projection
is squared, eval.py:81). No TPU kernel computes this in pcc_tpu: the
selection is ops/knn.py's (the expanded distances, a stable sort) and the
eigenvectors are torch.linalg.eigh's. Where the two smallest eigenvalues
nearly coincide, LAPACK on the CPU and cuSOLVER on the card may pick other
vectors of that plane.
"""

from __future__ import annotations

import torch

from pcc_tpu_torch.ops.knn import knn_gather, select_nearest, sq_dists

_CHUNK = 2048
# 3x3 matrices per torch.linalg.eigh call: cuSOLVER's batched eigensolver
# refuses a batch of 16 clouds x 8192 points (CUSOLVER_STATUS_INVALID_VALUE
# from its workspace query) on an H100 with CUDA 12.8
EIGH_BATCH = 16384


def self_knn_idx(pc: torch.Tensor, knn: int, chunk: int = _CHUNK) -> torch.Tensor:
    """[..., N, 3] clouds -> [..., N, knn] indices of each point's knn
    nearest points of its cloud, the query axis in chunks of `chunk` points
    so that memory stays at [..., chunk, N] (a whole [N, N] matrix at
    N = 50k would take 10 GB)."""
    N = pc.shape[-2]
    return torch.cat([select_nearest(sq_dists(pc[..., s:s + chunk, :], pc), knn)
                      for s in range(0, N, chunk)], dim=-2)


def estimate_normals(pc: torch.Tensor, knn: int = 30, chunk: int = _CHUNK) -> torch.Tensor:
    """Unit normals [B, N, 3] of clouds [B, N, 3] (pcc_tpu's
    estimate_normals, batched; the eigensolver EIGH_BATCH matrices a
    call)."""
    idx = self_knn_idx(pc, knn, chunk)                       # [B, N, knn]
    neigh = knn_gather(pc, idx)                              # [B, N, knn, 3]
    centered = neigh - neigh.mean(dim=2, keepdim=True)
    cov = centered.transpose(-1, -2) @ centered / knn        # [B, N, 3, 3]
    # eigh: ascending eigenvalues, so the first vector is the normal
    flat = cov.reshape(-1, 3, 3)
    normal = torch.cat([torch.linalg.eigh(flat[s:s + EIGH_BATCH]).eigenvectors[..., 0]
                        for s in range(0, flat.shape[0], EIGH_BATCH)]).reshape(pc.shape)
    return normal / torch.linalg.norm(normal, dim=-1, keepdim=True).clamp_min(1e-12)
