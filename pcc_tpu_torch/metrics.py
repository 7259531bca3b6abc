"""Compression quality metrics (counterpart of pcc_tpu/metrics.py).

The reference's host loops (eval.py:43-98, 127-151, 199-205) as batched
tensor programs on the card, or on the CPU with device="cpu": D1/D2 PSNR
with the bounding-box diagonal as peak, the exact 1-NN
(ops/chamfer.py::nearest_neighbor, direct differences, never the chamfer
kernels' expansion search) and 30-NN PCA normals (ops/normals.py); the
uniformity coefficient; the chamfer distance after min-max normalization by
the input. Inputs and outputs are numpy arrays and Python floats, as in
pcc_tpu.
"""

from __future__ import annotations

import numpy as np
import torch

from pcc_tpu_torch.device import resolve_device
from pcc_tpu_torch.ops.chamfer import nearest_neighbor
from pcc_tpu_torch.ops.knn import knn_points
from pcc_tpu_torch.ops.normals import estimate_normals

_EVAL_CHUNK = 16
# cap on points per batch so that S3DIS-scale clouds (50k-100k points) do
# not scale device memory by the whole 16-pair chunk; 16 * 8192 keeps the
# reference-scale (N = 8192) batch at 16 pairs
_EVAL_POINT_BUDGET = 16 * 8192


def _gather(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[B, N, C] at [B, M] -> [B, M, C]."""
    return torch.gather(points, 1, idx[..., None].expand(-1, -1, points.shape[-1]))


def _d1_d2_mse(orig: torch.Tensor, recon: torch.Tensor, normals: torch.Tensor):
    """(p2point MSE [B], p2plane MSE [B], squared bbox diagonal [B]) of
    recon [B, M, 3] against orig [B, N, 3] with its normals [B, N, 3]."""
    _, idx = nearest_neighbor(recon, orig)                   # exact 1-NN
    diff = recon - _gather(orig, idx)
    p2point = (diff ** 2).sum(-1).mean(-1)
    p2plane = ((diff * _gather(normals, idx)).sum(-1) ** 2).mean(-1)
    diag_sq = ((orig.amax(dim=1) - orig.amin(dim=1)) ** 2).sum(-1)
    return p2point, p2plane, diag_sq


def _psnr(diag_sq: float, mse: float) -> float:
    return float(10 * np.log10(diag_sq / mse)) if mse > 0 else float("inf")


def compute_p2point_p2plane_psnr(orig: np.ndarray, recon: np.ndarray,
                                 normals: np.ndarray | None = None,
                                 device: str = "cuda") -> dict:
    """D1/D2 PSNR with the bounding-box diagonal as peak (eval.py:43-98).
    `normals` overrides the 30-NN PCA estimate when the input file carries
    normals (the reference's eval.py:59-60)."""
    dev = resolve_device(device)
    o = torch.from_numpy(np.asarray(orig, np.float32)).to(dev)[None]
    r = torch.from_numpy(np.asarray(recon, np.float32)).to(dev)[None]
    n = (estimate_normals(o) if normals is None
         else torch.from_numpy(np.asarray(normals, np.float32)).to(dev)[None])
    p2point, p2plane, diag_sq = (float(t[0]) for t in _d1_d2_mse(o, r, n))
    return {"p2point_psnr": _psnr(diag_sq, p2point), "p2plane_psnr": _psnr(diag_sq, p2plane)}


def _uc_region_var(pc: torch.Tensor, K: int) -> torch.Tensor:
    """Variance [B] of the nearest-other-point distances in the K-NN region
    around each cloud's first point (eval.py:129-149)."""
    _, _, nn = knn_points(pc[:, :1], pc, K=K, return_nn=True)
    region = nn[:, 0] - pc[:, :1]                            # [B, K, 3]
    d = torch.sqrt(torch.clamp_min(
        ((region[:, :, None] - region[:, None]) ** 2).sum(-1), 0.0))
    # the distance to the nearest other point: each row's second smallest
    second = torch.topk(d, 2, dim=-1, largest=False).values[..., 1]
    return second.var(dim=-1, correction=0)


def calc_uc(input_pc: np.ndarray, decomp_pc: np.ndarray, device: str = "cuda") -> float:
    """Uniformity coefficient: the ratio of the decompressed to the input
    cloud's nearest-neighbour distance variance (eval.py:127-151). K is
    capped at the smaller cloud's size: beyond it knn_points pads with
    index 0, whose zero distances would skew the variance."""
    dev = resolve_device(device)
    K = min(1024, int(input_pc.shape[0]), int(decomp_pc.shape[0]))
    vi, vd = (float(_uc_region_var(torch.from_numpy(np.asarray(pc, np.float32)).to(dev)[None],
                                   K)[0]) for pc in (input_pc, decomp_pc))
    return vd / vi if vi > 0 else float("inf")


def _chamfer_pairs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Symmetric chamfer [B] of each pair, the exact search both ways
    (ops/chamfer.py::chamfer_distance(fast_search=False) of one pair)."""
    return nearest_neighbor(b, a)[0].mean(-1) + nearest_neighbor(a, b)[0].mean(-1)


def normalized_chamfer(input_pc: np.ndarray, decomp_pc: np.ndarray,
                       device: str = "cuda") -> float:
    """Chamfer after min-max normalizing both clouds by the input's global
    scalar min and max (eval.py:199-205)."""
    dev = resolve_device(device)
    lo, hi = float(input_pc.min()), float(input_pc.max())
    a = (np.asarray(input_pc) - lo) / (hi - lo)
    b = (np.asarray(decomp_pc) - lo) / (hi - lo)
    return float(_chamfer_pairs(torch.from_numpy(a).to(dev)[None],
                                torch.from_numpy(b).to(dev)[None])[0])


def compute_bitrate(num_bytes: int, num_points: int) -> float:
    """bpp = 8 * bytes / points (eval.py:122-125)."""
    return 8.0 * num_bytes / num_points


def eval_batch_device(origs: torch.Tensor, recons: torch.Tensor, normal_knn: int = 30,
                      uc_k: int = 1024):
    """Every geometry metric of a batch of pairs, origs [B, N, 3] against
    recons [B, M, 3], on their device: (p2point MSE, p2plane MSE, squared
    bbox diagonal, uniformity variances of the input and of the recon,
    normalized chamfer), each [B]."""
    normals = estimate_normals(origs, knn=normal_knn)
    p2point, p2plane, diag_sq = _d1_d2_mse(origs, recons, normals)
    var_in, var_out = _uc_region_var(origs, uc_k), _uc_region_var(recons, uc_k)
    lo = origs.amin(dim=(1, 2))[:, None, None]
    hi = origs.amax(dim=(1, 2))[:, None, None]
    ch = _chamfer_pairs((origs - lo) / (hi - lo), (recons - lo) / (hi - lo))
    return p2point, p2plane, diag_sq, var_in, var_out, ch


def eval_batch(origs: np.ndarray, recons: np.ndarray, chunk: int = _EVAL_CHUNK,
               device: str = "cuda") -> list[dict]:
    """[B, N, 3] originals and [B, M, 3] recons -> per-pair dicts with the
    semantics of compute_p2point_p2plane_psnr, calc_uc and
    normalized_chamfer (estimated normals; for file normals use the
    per-file functions). Pairs go in chunks of a fixed size, the last padded
    by repetition, so that the batch shape and memory stay the same
    whatever the number of clouds, as in pcc_tpu."""
    dev = resolve_device(device)
    B = origs.shape[0]
    biggest = max(int(origs.shape[1]), int(recons.shape[1]))
    chunk = max(1, min(chunk, _EVAL_POINT_BUDGET // biggest))
    uc_k = min(1024, int(origs.shape[1]), int(recons.shape[1]))
    cols = [np.empty(B) for _ in range(6)]
    with torch.no_grad():
        for lo in range(0, B, chunk):
            sel = list(range(lo, min(lo + chunk, B)))
            idx = sel + [sel[-1]] * (chunk - len(sel))
            parts = eval_batch_device(
                torch.from_numpy(np.asarray(origs[idx], np.float32)).to(dev),
                torch.from_numpy(np.asarray(recons[idx], np.float32)).to(dev), uc_k=uc_k)
            for col, part in zip(cols, parts):
                col[sel] = part.cpu().numpy()[:len(sel)]
    p2pt, p2pl, diag, vin, vout, ch = cols
    return [{"p2point_psnr": _psnr(diag[i], p2pt[i]),
             "p2plane_psnr": _psnr(diag[i], p2pl[i]),
             "uc": float(vout[i] / vin[i]) if vin[i] > 0 else float("inf"),
             "chamfer": float(ch[i])} for i in range(B)]


def compute_color_psnr(input_pc: np.ndarray, input_rgb: np.ndarray, decomp_pc: np.ndarray,
                       decomp_rgb: np.ndarray, device: str = "cuda") -> float:
    """RGB PSNR (peak 255) of each decompressed point's colour against the
    colour of its nearest input point (pcc_tpu's extension metric)."""
    dev = resolve_device(device)

    def t(a, scale=1.0):
        return (torch.from_numpy(np.asarray(a, np.float32)).to(dev) / scale)[None]

    _, idx = nearest_neighbor(t(decomp_pc), t(input_pc))
    in_rgb = t(input_rgb, 255.0)
    mse = float(((t(decomp_rgb, 255.0) - _gather(in_rgb, idx)) ** 2).mean())
    if mse <= 0:
        return float("inf")
    return 10.0 * float(np.log10(1.0 / mse))
