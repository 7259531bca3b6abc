"""The rate-distortion training step of the patch pipeline (counterpart of
pcc_tpu/train/steps.py; reference train.py:156-223).

One step for a batch of clouds: normalize -> FPS (CUDA kernel) -> octree
analysis -> KNN patches -> the autoencoder (IPDAE: the encoder and its
backward as CUDA kernels, the decoder as plain products; PPPF-AE through
train/steps_pppf.py) -> probability model -> chamfer + rate -> gradients ->
Adam. The chamfer compares the whole decoded cloud [B, S*k, 3] (S*d*d for
PPPF-AE) with the input [B, N, 3]: through the chamfer kernels and their
backward (ops/chamfer_cuda.py), which take whole clouds of any size of the
paths (N = 512 and N = 8192 alike). On CPU tensors every kernel runs its
plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from pcc_tpu_torch.codec import encode_geometry
from pcc_tpu_torch.coding.pmf import estimate_bits_from_pmf
from pcc_tpu_torch.config import CodecConfig
from pcc_tpu_torch.models.losses import rate_distortion_loss

RATE_MODES = ("reference", "fixed")


def rd_forward(ae, prob, batch: torch.Tensor, starts: torch.Tensor, lam: float,
               cfg: CodecConfig, rate_mode: str = "reference"):
    """Rate-distortion loss of clouds [B, N, 3] with FPS start indices [B].

    rate_mode "reference" divides the bit count by B*N twice, as the
    reference does (train.py:201-205), so the rate term barely trains;
    "fixed" divides once, a true bits per point. Returns (loss, aux) with
    aux keys chamfer, fbpp, bpp, true_fbpp.
    """
    if rate_mode not in RATE_MODES:
        raise ValueError(f"rate_mode {rate_mode!r} not in {RATE_MODES}")
    B, N, _ = batch.shape
    # patch selection carries no gradient: patches are data-derived
    with torch.no_grad():
        geo = encode_geometry(batch, starts, cfg)
    rec_xyz = geo.octree.rec_xyz                                        # [B, S, 3]
    skeleton_bits = geo.octree.total_bits.sum()

    patches_pred, _, latent_q = ae(geo.patches)
    # / patch_scale as XLA compiles it: a product with the f32 reciprocal
    patches_pred = patches_pred * float(np.float32(1.0) / np.float32(cfg.patch_scale))

    pmf = prob(rec_xyz)                                                 # [B, S, d, L]
    sym = torch.clamp(latent_q.detach().reshape(B, cfg.S, cfg.d) + cfg.L // 2,
                      0, cfg.L - 1).long()
    feature_bits = estimate_bits_from_pmf(pmf, sym)

    if rate_mode == "reference":
        fbpp = feature_bits / (B * N) / (B * N)
        bpp = (skeleton_bits + feature_bits / (B * N)) / (B * N)
    else:
        fbpp = feature_bits / (B * N)
        bpp = (skeleton_bits + feature_bits) / (B * N)

    # k points per patch for IPDAE, d * d for PPPF-AE (steps_pppf.py:123-128)
    per_patch = patches_pred.shape[1]
    pc_pred = (patches_pred.reshape(B, cfg.S, per_patch, 3)
               + rec_xyz[:, :, None, :]).reshape(B, cfg.S * per_patch, 3)
    loss, aux = rate_distortion_loss(pc_pred, geo.pc01, fbpp, lam)
    aux["bpp"] = bpp
    aux["true_fbpp"] = feature_bits / (B * N)
    return loss, aux


def build_train_step(cfg: CodecConfig, tx, rate_mode: str = "reference"):
    """Returns train_step(state, batch [B, N, 3], starts [B], lam) ->
    (state, aux): one forward, backward and Adam update of `state` (in
    place) at the learning rate of the schedule `tx` (train/state.py). aux
    holds loss, chamfer, fbpp, bpp, true_fbpp as 0-d tensors on the device,
    detached."""
    if rate_mode not in RATE_MODES:
        raise ValueError(f"rate_mode {rate_mode!r} not in {RATE_MODES}")

    def train_step(state, batch: torch.Tensor, starts: torch.Tensor, lam: float):
        state.optimizer.zero_grad(set_to_none=False)
        loss, aux = rd_forward(state.ae, state.prob, batch, starts, lam, cfg, rate_mode)
        loss.backward()
        state.apply_gradients(tx)
        aux["loss"] = loss
        return state, {k: v.detach() for k, v in aux.items()}

    return train_step
