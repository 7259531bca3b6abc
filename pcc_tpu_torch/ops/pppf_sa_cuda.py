"""The fused PointNet++ set-abstraction stage (counterpart of
pcc_tpu/ops/pppf_sa_pallas.py: TPU kernel _stage_kernel, entry
pppf_sa_fused).

`pppf_sa_fused` launches the CUDA kernel csrc/pppf_sa_stage.cu on CUDA
tensors and runs `pppf_sa_plain`, the same function in plain PyTorch, on
CPU tensors: per patch and query point, the nsample nearest of the patch's
N points, their rows gathered ("pppf": [feat | xyz] uncentred, slots beyond
the radius read point 0; "pppe": [xyz - query | feat], no mask), the
Conv + BatchNorm(eval) + ReLU stack and the max over samples ->
[P, S, C_out]. Selection and mask are bit-equal between the two (the same
float32 operations in the same order); the products sum in another order,
so outputs agree to float32 rounding. The kernel's design note (what
bounds it on an H100, what it does about that) is at the top of its source.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pcc_tpu_torch.ops import cuda_lib
from pcc_tpu_torch.ops.knn import ball_query, knn_gather, select_nearest, sq_dists

_ARGTYPES = ([cuda_lib.PTR] * 4 + [cuda_lib.INT] * 5 + [ctypes.c_float]
             + [cuda_lib.INT] * 2 + [cuda_lib.PTR] * 3)
LAYOUTS = ("pppf", "pppe")
MAX_POINTS = 1024      # csrc/pppf_sa_stage.cu: kMaxN
MAX_LAYERS = 6         # kMaxLayers
MIN_TILE_ROWS = 8      # kTM
# the kernel's smallest tile (MIN_TILE_ROWS rows of both activation buffers,
# one query's maxima, indices and distances) must fit in a block's shared memory
SMEM_WORDS = 227 * 1024 // 4
PLAIN_ELEMS = 1 << 27  # elements of the widest grouped activation per pass of the plain version


def fold_bn(bn, eps: float = 1e-5):
    """A BatchNorm's (weight, bias, running_mean, running_var) -> (mean, mul,
    bias) with mul = rsqrt(var + eps) * weight: the float32 expression of
    pcc_tpu's fold_bn, so the eval-mode affine is (h - mean) * mul + bias on
    both sides."""
    mul = torch.rsqrt(bn.running_var.float() + eps) * bn.weight.float()
    return bn.running_mean.float(), mul, bn.bias.float()


def _radius2(radius: float) -> float:
    """radius * radius as the float32 the comparison sees."""
    return float(np.float32(radius * radius))


def pppf_sa_plain(new_xyz: torch.Tensor, xyz: torch.Tensor, feat, layers, *,
                  nsample: int, radius: float, layout: str = "pppf") -> torch.Tensor:
    """new_xyz [P, S, 3], xyz [P, N, 3], feat [P, N, C] or None, layers a
    list of (W [cin, cout], b, mean, mul, bias) -> [P, S, C_out] f32. Runs
    a chunk of patches at a time to bound the memory of the grouped
    activations [chunk, S, nsample, C]."""
    if layout not in LAYOUTS:
        raise ValueError(f"pppf_sa: unknown layout {layout!r}")
    P, S, _ = new_xyz.shape
    widest = max([xyz.shape[-1] + (0 if feat is None else feat.shape[-1])]
                 + [w.shape[1] for w, *_ in layers])
    chunk = max(1, PLAIN_ELEMS // (S * nsample * widest))
    outs = []
    for s in range(0, P, chunk):
        q, pts = new_xyz[s:s + chunk], xyz[s:s + chunk]
        f = None if feat is None else feat[s:s + chunk]
        if layout == "pppe":
            idx = select_nearest(sq_dists(q, pts), nsample)        # [c, S, ns]
            x = knn_gather(pts, idx) - q[:, :, None, :]
            if f is not None:
                x = torch.cat([x, knn_gather(f, idx)], dim=-1)
        else:
            # out-of-radius slots read point 0, on exactly recomputed distances
            idx = ball_query(q, pts, nsample, radius)
            x = knn_gather(pts if f is None else torch.cat([f, pts], dim=-1), idx)
        for w, b, mean, mul, bias in layers:
            x = torch.relu(((x @ w + b) - mean) * mul + bias)
        outs.append(x.amax(dim=2))
    return torch.cat(outs)


def stage_flops(P: int, S: int, N: int, nsample: int, widths) -> float:
    """Operations of one stage: 9 per (query, point) distance pair where a
    selection is made (nsample < N; otherwise every point is taken), 2 per
    multiply-add of the stack plus 5 per output of a layer (bias, the
    BatchNorm affine, relu). Masked slots count as full rows although those
    of a patch all share point 0's activation, so this is an upper count of
    the work the function needs."""
    macs = sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    dist = 9.0 * N if nsample < N else 0.0
    return P * S * (dist + nsample * (2.0 * macs + 5.0 * sum(widths[1:])))


def _check(new_xyz, xyz, feat, layers, nsample: int, layout: str):
    """Raise on what the kernel does not take; return the layer widths."""
    if layout not in LAYOUTS:
        raise ValueError(f"pppf_sa_fused: unknown layout {layout!r}")
    cuda_lib.require_cuda("pppf_sa_fused new_xyz", new_xyz, torch.float32, 3)
    cuda_lib.require_cuda("pppf_sa_fused xyz", xyz, torch.float32, 3)
    P, S, _ = new_xyz.shape
    N = xyz.shape[1]
    C = 0
    if feat is not None:
        cuda_lib.require_cuda("pppf_sa_fused feat", feat, torch.float32, 3)
        C = feat.shape[2]
        if feat.shape[:2] != (P, N) or C == 0:
            raise ValueError(f"pppf_sa_fused: feat {tuple(feat.shape)} does not match "
                             f"xyz {tuple(xyz.shape)}")
    if (new_xyz.shape[2] != 3 or xyz.shape[2] != 3 or xyz.shape[0] != P or P == 0
            or S == 0 or not 0 < N <= MAX_POINTS or nsample <= 0
            or not 0 < len(layers) <= MAX_LAYERS):
        raise ValueError(
            f"pppf_sa_fused: unsupported new_xyz {tuple(new_xyz.shape)}, xyz "
            f"{tuple(xyz.shape)}, nsample={nsample}, {len(layers)} layers (N <= "
            f"{MAX_POINTS}, at most {MAX_LAYERS} layers)")
    widths = [C + 3]
    for lay in layers:
        w = lay[0]
        cuda_lib.require_cuda("pppf_sa_fused weight", w, torch.float32, 2)
        if w.shape[0] != widths[-1]:
            raise ValueError(f"pppf_sa_fused: weight {tuple(w.shape)} after width "
                             f"{widths[-1]}")
        for t in lay[1:]:
            cuda_lib.require_cuda("pppf_sa_fused bias/mean/mul", t, torch.float32, 1)
            if t.shape[0] != w.shape[1]:
                raise ValueError(f"pppf_sa_fused: vector {tuple(t.shape)} for weight "
                                 f"{tuple(w.shape)}")
        if any(t.data_ptr() % 16 for t in lay):
            raise ValueError("pppf_sa_fused: layer tensors must be 16-byte aligned")
        widths.append(w.shape[1])
    pad4 = [(v + 3) & ~3 for v in widths[:-1]]
    words = (MIN_TILE_ROWS * (max(pad4[0::2]) + max(pad4[1::2], default=4)) + widths[-1] + nsample
             + (N if nsample < N else 0) + 4)
    if words > SMEM_WORDS:
        raise ValueError(f"pppf_sa_fused: widths {widths} with nsample={nsample}, N={N} "
                         f"need {4 * words} bytes of shared memory for the smallest tile "
                         f"(limit {4 * SMEM_WORDS})")
    return widths


def pppf_sa_fused(new_xyz: torch.Tensor, xyz: torch.Tensor, feat, layers, *,
                  nsample: int, radius: float, layout: str = "pppf") -> torch.Tensor:
    """One fused PN++ SA stage over a flat patch batch (pcc_tpu's
    pppf_sa_fused): new_xyz [P, S, 3] query centroids, xyz [P, N, 3], feat
    [P, N, C] or None, layers a list of (W [cin, cout], b, mean, mul, bias)
    with the BatchNorm folded by `fold_bn` -> [P, S, C_out] f32. The CUDA
    kernel on CUDA tensors, the plain version on CPU tensors."""
    if new_xyz.device.type == "cpu":
        return pppf_sa_plain(new_xyz, xyz, feat, layers, nsample=nsample, radius=radius,
                             layout=layout)
    widths = _check(new_xyz, xyz, feat, layers, nsample, layout)
    P, S, _ = new_xyz.shape
    out = torch.empty((P, S, widths[-1]), dtype=torch.float32, device=new_xyz.device)
    ptrs = (ctypes.c_void_p * (5 * len(layers)))(
        *[t.data_ptr() for lay in layers for t in lay])
    cuda_lib.launch(
        "pppf_sa_stage", _ARGTYPES, new_xyz.data_ptr(), xyz.data_ptr(),
        None if feat is None else feat.data_ptr(), out.data_ptr(), P, S, xyz.shape[1],
        0 if feat is None else feat.shape[2], nsample, _radius2(radius),
        LAYOUTS.index(layout), len(layers), ptrs, (ctypes.c_int * len(widths))(*widths),
        cuda_lib.stream_ptr(new_xyz))
    return out
