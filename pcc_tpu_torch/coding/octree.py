"""Octree analysis of the FPS skeleton as Morton-code reductions
(counterpart of pcc_tpu/coding/octree.py, batched over clouds).

  * voxelization at depth D == truncating a Morton code to 3D bits;
  * occupied octree nodes at level l == unique 3l-bit prefixes;
  * the reference's bit count at depth D == 1 + 8 * sum_l occupied(l)
    (one root bit plus an 8-bit child mask per occupied node,
    octree_np.py:17-44);
  * the adaptive-depth search == a first-true scan over all depths at once.

Codes are sorted descending, the reference DFS's emission order
(octree_np.py:31-40), so decoded skeleton point order matches the host
serializer (coding/octree_host.py). Integer operations throughout: the
result is bit-equal to pcc_tpu on any device. The one float step, the rate
test bits / N > min_bpp, runs in float32 as JAX's weakly typed scalars make
it run there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pcc_tpu_torch.config import MAX_OCTREE_DEPTH


def morton_encode(pc01: torch.Tensor, depth: int = MAX_OCTREE_DEPTH) -> torch.Tensor:
    """Morton codes at `depth` for points in the unit cube: [..., 3] f32 ->
    [...] int32, x the most significant bit of each level's triple."""
    v = torch.clamp(torch.floor(pc01 * float(1 << depth)).to(torch.int32),
                    0, (1 << depth) - 1)
    code = torch.zeros(pc01.shape[:-1], dtype=torch.int32, device=pc01.device)
    for level in range(depth):
        shift = depth - 1 - level
        trip = ((((v[..., 0] >> shift) & 1) << 2)
                | (((v[..., 1] >> shift) & 1) << 1)
                | ((v[..., 2] >> shift) & 1))
        code = (code << 3) | trip
    return code


def morton_decode(codes: torch.Tensor, depth: int) -> torch.Tensor:
    """Voxel-center coordinates for Morton codes at `depth` -> [..., 3] f32."""
    x = torch.zeros_like(codes)
    y = torch.zeros_like(codes)
    z = torch.zeros_like(codes)
    for level in range(depth):
        shift = depth - 1 - level
        x = x | (((codes >> (3 * shift + 2)) & 1) << shift)
        y = y | (((codes >> (3 * shift + 1)) & 1) << shift)
        z = z | (((codes >> (3 * shift)) & 1) << shift)
    inv = 1.0 / float(1 << depth)
    coords = torch.stack([x, y, z], dim=-1).to(torch.float32)
    return (coords + 0.5) * inv


class OctreeResult(NamedTuple):
    rec_xyz: torch.Tensor       # [B, S, 3] decoded voxel centers, descending Morton order
    depth: torch.Tensor         # [B] int32 chosen depth
    total_bits: torch.Tensor    # [B] int32 code length in bits
    sorted_codes: torch.Tensor  # [B, S] int32 max-depth codes, descending


def octree_analyze(sampled01: torch.Tensor, N: int, min_bpp: float | None,
                   max_depth: int = MAX_OCTREE_DEPTH) -> OctreeResult:
    """Adaptive-depth octree analysis for a batch of skeletons [B, S, 3].

    Chooses, per cloud, the first depth where bits/N > min_bpp (skipped when
    min_bpp is None) AND the voxelization is lossless (one voxel per point,
    the pc_rec.shape == pc.shape condition of pn_kit.py:393); falls back to
    max_depth. N is the full-cloud point count (the bpp denominator).
    """
    B, S, _ = sampled01.shape
    codes = morton_encode(sampled01, max_depth)
    sc = torch.sort(codes, dim=-1, descending=True).values

    # occupied-node counts per level 0..max_depth (level 0 = root = 1)
    uniqs = []
    for lvl in range(max_depth + 1):
        pref = sc >> (3 * (max_depth - lvl))
        uniqs.append(1 + (pref[:, :-1] != pref[:, 1:]).sum(-1, dtype=torch.int32))
    uniqs = torch.stack(uniqs, dim=-1)                       # [B, max_depth+1]
    csum = torch.cumsum(uniqs, dim=-1, dtype=torch.int32)

    # total bits if coded at depth d (d = 1..max_depth): 1 + 8 * sum_{l<d}
    bits_per_depth = 1 + 8 * csum[:, :-1]                    # [:, d-1] <-> depth d
    cond = uniqs[:, 1:] == S
    if min_bpp is not None:
        # both operands as float32 tensors: PyTorch's CUDA division by a
        # Python scalar multiplies by its reciprocal, which is not the
        # correctly rounded quotient the CPU (and pcc_tpu) computes
        n_f = torch.tensor(float(N), dtype=torch.float32, device=sc.device)
        floor = torch.tensor(min_bpp, dtype=torch.float32, device=sc.device)
        cond = cond & (bits_per_depth.to(torch.float32) / n_f > floor)
    first = torch.argmax(cond.to(torch.int32), dim=-1)
    idx = torch.where(cond.any(-1), first,
                      torch.full_like(first, max_depth - 1))  # [B]

    centers_all = torch.stack(
        [morton_decode(sc >> (3 * (max_depth - d)), d)
         for d in range(1, max_depth + 1)], dim=1)           # [B, max_depth, S, 3]
    rows = torch.arange(B, device=sc.device)
    return OctreeResult(
        rec_xyz=centers_all[rows, idx],
        depth=(idx + 1).to(torch.int32),
        total_bits=bits_per_depth[rows, idx],
        sorted_codes=sc,
    )
