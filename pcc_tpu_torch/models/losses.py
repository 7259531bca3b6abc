"""Rate-distortion training loss (counterpart of pcc_tpu/models/losses.py;
reference AE.py:57-70)."""

from __future__ import annotations

import torch

from pcc_tpu_torch.ops.chamfer import chamfer_distance


def rate_distortion_loss(pc_pred: torch.Tensor, pc_target: torch.Tensor,
                         fbpp: torch.Tensor, lam: float):
    """chamfer(pred, target) + lam * fbpp. Returns (loss, aux dict) so
    callers can log the distortion / rate split. The chamfer neighbour
    search runs in the fast expansion form; the loss is the exactly
    recomputed gathered distance."""
    d, _ = chamfer_distance(pc_pred, pc_target, fast_search=True)
    rate = torch.mean(fbpp)
    loss = d + lam * rate
    return loss, {"chamfer": d, "fbpp": rate}
