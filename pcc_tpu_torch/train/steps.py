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

In a process group (parallel/mesh.py) each rank runs this on its shard of
the global batch and the step computes the single-device function of the
global batch, as pcc_tpu's sharded step does: the bit counts are summed over
the ranks before the rate's divisions by the global B (quadratic in 1 / B in
rate_mode "reference"), each rank's loss is its share of the global loss,
and the gradients are summed over the ranks before Adam.
"""

from __future__ import annotations

import numpy as np
import torch

from pcc_tpu_torch.codec import encode_geometry
from pcc_tpu_torch.coding.pmf import estimate_bits_from_pmf
from pcc_tpu_torch.config import CodecConfig
from pcc_tpu_torch.models.losses import rate_distortion_loss
from pcc_tpu_torch.parallel.mesh import (all_reduce_grads, all_reduce_sum, global_mean,
                                         global_sum, is_distributed, world_size)

RATE_MODES = ("reference", "fixed")


def rd_forward(ae, prob, batch: torch.Tensor, starts: torch.Tensor, lam: float,
               cfg: CodecConfig, rate_mode: str = "reference"):
    """Rate-distortion loss of clouds [B, N, 3] with FPS start indices [B].

    rate_mode "reference" divides the bit count by B*N twice, as the
    reference does (train.py:201-205), so the rate term barely trains;
    "fixed" divides once, a true bits per point. Returns (loss, aux) with
    aux keys chamfer, fbpp, bpp, true_fbpp. In a process group `batch` is
    this rank's shard, aux holds the global batch's values (equal on every
    rank), and the loss is this rank's share: the ranks' losses sum to the
    global loss, and so do their gradients.
    """
    if rate_mode not in RATE_MODES:
        raise ValueError(f"rate_mode {rate_mode!r} not in {RATE_MODES}")
    b, N, _ = batch.shape
    B = b * world_size()                                                # the global batch
    # patch selection carries no gradient: patches are data-derived
    with torch.no_grad():
        geo = encode_geometry(batch, starts, cfg)
    rec_xyz = geo.octree.rec_xyz                                        # [b, S, 3]
    skeleton_bits = global_sum(geo.octree.total_bits.sum())

    patches_pred, _, latent_q = ae(geo.patches)
    # / patch_scale as XLA compiles it: a product with the f32 reciprocal
    patches_pred = patches_pred * float(np.float32(1.0) / np.float32(cfg.patch_scale))

    pmf = prob(rec_xyz)                                                 # [b, S, d, L]
    sym = torch.clamp(latent_q.detach().reshape(b, cfg.S, cfg.d) + cfg.L // 2,
                      0, cfg.L - 1).long()
    feature_bits = all_reduce_sum(estimate_bits_from_pmf(pmf, sym))

    if rate_mode == "reference":
        fbpp = feature_bits / (B * N) / (B * N)
        bpp = (skeleton_bits + feature_bits / (B * N)) / (B * N)
    else:
        fbpp = feature_bits / (B * N)
        bpp = (skeleton_bits + feature_bits) / (B * N)

    # k points per patch for IPDAE, d * d for PPPF-AE (steps_pppf.py:123-128)
    per_patch = patches_pred.shape[1]
    pc_pred = (patches_pred.reshape(b, cfg.S, per_patch, 3)
               + rec_xyz[:, :, None, :]).reshape(b, cfg.S * per_patch, 3)
    loss, aux = rate_distortion_loss(pc_pred, geo.pc01, fbpp, lam)
    aux["bpp"] = bpp
    aux["true_fbpp"] = feature_bits / (B * N)
    if is_distributed():
        aux["chamfer"] = global_mean(aux["chamfer"].detach())
        loss = loss / world_size()
    return loss, aux


def build_train_step(cfg: CodecConfig, tx, rate_mode: str = "reference"):
    """Returns train_step(state, batch [B, N, 3], starts [B], lam) ->
    (state, aux): one forward, backward and Adam update of `state` (in
    place) at the learning rate of the schedule `tx` (train/state.py). aux
    holds loss, chamfer, fbpp, bpp, true_fbpp as 0-d tensors on the device,
    detached. In a process group: the step of the global batch whose shard
    `batch` is (rd_forward), with the gradients summed over the ranks by one
    all-reduce; every rank's state moves alike."""
    if rate_mode not in RATE_MODES:
        raise ValueError(f"rate_mode {rate_mode!r} not in {RATE_MODES}")

    def train_step(state, batch: torch.Tensor, starts: torch.Tensor, lam: float):
        state.optimizer.zero_grad(set_to_none=False)
        loss, aux = rd_forward(state.ae, state.prob, batch, starts, lam, cfg, rate_mode)
        loss.backward()
        all_reduce_grads(p for _, p in state.named_parameters())
        state.apply_gradients(tx)
        aux["loss"] = global_sum(loss.detach())
        return state, {k: v.detach() for k, v in aux.items()}

    return train_step
