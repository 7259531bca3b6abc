"""KNN / gather / ball query on tensors (counterpart of pcc_tpu/ops/knn.py).

Selection uses the expanded distance q2 - 2 q.p + p2, written out
coordinate by coordinate so that every operation rounds once, in the same
order on the CPU and on the card, and the patch encoder and chamfer kernels
(csrc/encoder_common.cuh, csrc/chamfer_common.cuh) can repeat it bit for
bit. The returned distances are recomputed exactly on the gathered
neighbours, as pcc_tpu does.
"""

from __future__ import annotations

import torch


def sq_norms(p: torch.Tensor) -> torch.Tensor:
    """[..., N, 3] -> [..., N] squared norms, summed x, y, z in that order."""
    x, y, z = p.unbind(-1)
    return x * x + y * y + z * z


def expanded_sq_dists(query: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Pairwise (q2 - 2 q.p) + p2 [..., S, N] between [..., S, 3] and
    [..., N, 3], unclamped: near zero it can be negative (the chamfer's
    selection, ops/chamfer_cuda.py, keeps that sign)."""
    qx, qy, qz = (c[..., :, None] for c in query.unbind(-1))
    px, py, pz = (c[..., None, :] for c in points.unbind(-1))
    cross = qx * px + qy * py + qz * pz
    return (sq_norms(query)[..., :, None] - 2.0 * cross) + sq_norms(points)[..., None, :]


def sq_dists(query: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances [..., S, N] between [..., S, 3] and
    [..., N, 3], in pcc_tpu's expanded form max((q2 - 2 q.p) + p2, 0)."""
    return torch.clamp_min(expanded_sq_dists(query, points), 0.0)


def select_nearest(d: torch.Tensor, K: int) -> torch.Tensor:
    """Indices of the K smallest entries along the last axis, ascending
    distance, lowest index first among equal distances (the lax.top_k order
    of pcc_tpu). torch.topk is not stable, so a stable sort selects."""
    N = d.shape[-1]
    idx = torch.sort(d, dim=-1, stable=True).indices[..., :min(K, N)]
    if K > N:
        # fewer points than requested neighbours: pad with index 0, as
        # pcc_tpu does (the reference's clamp of pytorch3d's -1 padding)
        pad = idx.new_zeros(idx.shape[:-1] + (K - N,))
        idx = torch.cat([idx, pad], dim=-1)
    return idx


def knn_gather(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather [B, N, C] at [B, S, K] -> [B, S, K, C] (pytorch3d knn_gather)."""
    B, S, K = idx.shape
    flat = torch.gather(points, 1, idx.reshape(B, S * K, 1).expand(
        -1, -1, points.shape[-1]))
    return flat.reshape(B, S, K, points.shape[-1])


def knn_points(query: torch.Tensor, points: torch.Tensor, K: int,
               return_nn: bool = False):
    """K nearest neighbours of `query` [B, S, 3] in `points` [B, N, 3].

    Returns:
      (dists [B, S, K] squared, idx [B, S, K] int64, nn [B, S, K, 3] or None).
    """
    idx = select_nearest(sq_dists(query, points), K)
    nn = knn_gather(points, idx)
    dists = ((nn - query[..., None, :]) ** 2).sum(-1)
    return dists, idx, (nn if return_nn else None)


def ball_query(query: torch.Tensor, points: torch.Tensor, K: int,
               radius: float) -> torch.Tensor:
    """Radius grouping (pcc_tpu's ball_query): the K nearest neighbours,
    with every slot beyond `radius` set to index 0, the reference's clamp of
    pytorch3d's -1 padding (pointnet_sa_module.py:16-28). The radius test
    runs on exactly recomputed distances, summed x, y, z in that order as
    the fused stage kernel (csrc/pppf_sa_stage.cu) sums them.
    Returns idx [B, S, K] int64."""
    idx = select_nearest(sq_dists(query, points), K)
    d = sq_norms(knn_gather(points, idx) - query[..., None, :])
    r2 = torch.tensor(radius * radius, dtype=d.dtype, device=d.device)
    return torch.where(d <= r2, idx, 0)
