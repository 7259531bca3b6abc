"""The PPPE whole-cloud train step (counterpart of pcc_tpu/train/steps_pppe.py;
reference train_pppe_pcd_ae.py:171-251).

One step for a batch of raw clouds [B, N, 3]: the PointCloudAE in training
mode (every PN++ stack and global_conv's BatchNorm on batch statistics, the
stages' FPS on the FPS kernel; with PPPEConfig(compute_dtype="bfloat16")
on flax's bf16 rules, models/pppe.py), the float32 chamfer distortion of
the fine cloud against the input through the chamfer kernels
(ops/chamfer.py::chamfer_distance(fast_search=True)), plus lam_eff times the
detached, clamped rate estimate; then optax's clip_by_global_norm(1.0) and
Adam, with the learning rate a float32 hyperparameter that the caller sets
once per epoch (`set_lr`, `cosine_epoch_lr`).

A step whose loss is not finite leaves the whole state as it was:
parameters, Adam moments and count, BatchNorm running statistics and step,
as pcc_tpu's jnp.where over its state does. The choice is made on the
device (torch.where), with no host sync. So that it costs a few kernels and
not one per tensor, the state keeps the parameters, the running statistics
and the Adam moments each in one flat buffer: every parameter and
statistic of the model is a view into it (`_flatten`). The prob model is a
submodule of the AE and shares its optimizer (train_pppe:274-276); the
rate carries no gradient, so its gradients are zeros, and Adam leaves it
where it is, as in pcc_tpu.

In a process group (parallel/mesh.py) the step is the single-device step of
the global batch, as pcc_tpu's sharded step is: batch statistics over the
global batch (models/layers.py::batch_norm_train), the rate's global mean
before its clip, the skip decided on the global loss, and the flat gradient
summed over the ranks before the clip and Adam, so that every rank keeps
the same state bit for bit, skipped steps included.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from pcc_tpu_torch.config import PPPEConfig
from pcc_tpu_torch.device import resolve_device
from pcc_tpu_torch.models.pppe import (PointCloudAE, estimate_bits_per_point_conditional,
                                       make_pppe_model)
from pcc_tpu_torch.ops.chamfer import chamfer_distance
from pcc_tpu_torch.parallel.mesh import global_mean, global_sum, is_distributed, world_size

MAX_RATE = 100.0      # the rate term's clip (pcc_tpu's pppe_forward max_rate)
B1, B2, EPS = 0.9, 0.999, 1e-8   # optax.adam's defaults (eps_root 0)


@dataclasses.dataclass(frozen=True)
class ClippedAdam:
    """optax.chain(clip_by_global_norm(grad_clip), adam(lr)) under
    inject_hyperparams (pcc_tpu's make_pppe_optimizer), in optax's
    arithmetic and order; lr is the initial learning rate (`set_lr`)."""

    lr: float
    grad_clip: float = 1.0


def make_pppe_optimizer(lr: float, grad_clip: float = 1.0) -> ClippedAdam:
    """Adam after a global-norm clip (train_pppe:172,278)."""
    return ClippedAdam(lr, grad_clip)


def cosine_epoch_lr(base_lr: float, epoch: int, t_max: int = 100,
                    eta_min: float = 0.0) -> float:
    """CosineAnnealingLR stepped once per epoch (train_pppe:249,278)."""
    return eta_min + (base_lr - eta_min) * (
        1 + math.cos(math.pi * (epoch % (2 * t_max)) / t_max)) / 2


def _flatten(tensors) -> torch.Tensor:
    """One flat buffer holding `tensors`, each re-pointed to its view of it
    (nothing else changes: modules, names and state_dicts stay as they
    were, and load_state_dict copies into the views)."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    off = 0
    for t in tensors:
        n = t.numel()
        t.data = flat[off:off + n].view_as(t)
        off += n
    return flat


@dataclasses.dataclass
class PPPETrainState:
    """The AE with its prob submodule, and the optimizer's state: the Adam
    moments (flat, in the parameters' order), the update count, the
    learning rate (float32, as optax's injected hyperparameter) and the
    step, each on the model's device."""

    model: PointCloudAE
    params: torch.Tensor        # flat; every parameter of `model` is a view
    stats: torch.Tensor         # flat; every running mean and variance is a view
    mu: torch.Tensor
    nu: torch.Tensor
    count: torch.Tensor         # int32, Adam's update count
    lr: torch.Tensor            # float32
    step: torch.Tensor          # int64

    def named_parameters(self):
        return list(self.model.named_parameters())

    def stat_buffers(self):
        return [b for n, b in self.model.named_buffers() if n.endswith(("running_mean",
                                                                        "running_var"))]

    def views(self, flat: torch.Tensor) -> dict:
        """{parameter name: its part of a flat buffer of the parameters'
        layout (mu, nu), shaped as the parameter}."""
        out, off = {}, 0
        for name, p in self.named_parameters():
            out[name] = flat[off:off + p.numel()].view_as(p)
            off += p.numel()
        return out


def create_pppe_state(seed: int, cfg: PPPEConfig, tx: ClippedAdam,
                      device: str | torch.device = "cuda",
                      dtype: torch.dtype = torch.float32) -> PPPETrainState:
    """A PointCloudAE for `cfg` in training mode on `device` with seeded
    weights (models/pppe.py::init_pppe_weights), fresh Adam moments and
    count 0, the learning rate tx.lr. float64 is for tests."""
    dev = resolve_device(device)
    model = make_pppe_model(cfg, seed=seed).to(dev, dtype).train()
    params = _flatten([p for _, p in model.named_parameters()])
    state = PPPETrainState(
        model=model, params=params, stats=None,
        mu=torch.zeros_like(params), nu=torch.zeros_like(params),
        count=torch.zeros((), dtype=torch.int32, device=dev),
        lr=torch.zeros((), dtype=torch.float32, device=dev),
        step=torch.zeros((), dtype=torch.int64, device=dev))
    state.stats = _flatten(state.stat_buffers())
    return set_lr(state, tx.lr)


def set_lr(state: PPPETrainState, lr: float) -> PPPETrainState:
    """The learning rate of the next updates, rounded to float32 as
    pcc_tpu's set_lr stores it (jnp.asarray(lr, jnp.float32))."""
    state.lr.fill_(float(np.float32(lr)))
    return state


def pppe_forward(model: PointCloudAE, batch: torch.Tensor, lam_eff: float):
    """(loss, aux) of raw clouds [B, N, 3]: chamfer(fine, batch) + lam_eff *
    clip(rate, 0, MAX_RATE); aux holds dist and rate. In training mode the
    forward updates the running statistics. In a process group `batch` is
    this rank's shard: the rate is clipped after its global mean, aux holds
    the global values and the loss is this rank's share of the global
    loss."""
    _, fine, cond_feats, y_q = model(batch)
    fbpp = global_mean(estimate_bits_per_point_conditional(model, y_q, cond_feats))
    dist, _ = chamfer_distance(fine, batch, fast_search=True)
    rate = torch.clamp(fbpp, 0.0, MAX_RATE)
    loss = dist + lam_eff * rate
    if is_distributed():
        return loss / world_size(), {"dist": global_mean(dist.detach()), "rate": rate}
    return loss, {"dist": dist, "rate": rate}


def _adam_update(state: PPPETrainState, g: torch.Tensor, tx: ClippedAdam, ok: torch.Tensor):
    """optax's clip_by_global_norm, then scale_by_adam and the learning
    rate, on the flat gradient g; written to the state only where `ok`."""
    g_norm = torch.sqrt(torch.sum(g * g))
    clip = g_norm >= tx.grad_clip        # optax: select(g_norm < max, g, (g / g_norm) * max)
    one = torch.ones((), dtype=g.dtype, device=g.device)
    g = (g / torch.where(clip, g_norm, one)) * torch.where(clip, one * tx.grad_clip, one)
    mu = (1 - B1) * g + B1 * state.mu
    nu = (1 - B2) * (g * g) + B2 * state.nu
    count = state.count + 1
    c = count.to(g.dtype)
    mu_hat = mu / (1 - B1 ** c)
    nu_hat = nu / (1 - B2 ** c)
    update = (-state.lr.to(g.dtype)) * (mu_hat / (torch.sqrt(nu_hat) + EPS))
    state.params.copy_(torch.where(ok, state.params + update, state.params))
    state.mu.copy_(torch.where(ok, mu, state.mu))
    state.nu.copy_(torch.where(ok, nu, state.nu))
    state.count.copy_(torch.where(ok, count, state.count))
    state.step.add_(ok.to(state.step.dtype))


def build_pppe_train_step(tx: ClippedAdam):
    """Returns train_step(state, batch [B, N, 3], lam_eff) -> (state, aux):
    one forward, backward and clipped Adam update of `state` in place,
    skipped whole where the loss is not finite. aux holds loss, dist, rate
    and skipped as 0-d tensors on the device. In a process group: the step
    of the global batch whose shard `batch` is (module docstring)."""

    def train_step(state: PPPETrainState, batch: torch.Tensor, lam_eff: float):
        old_stats = state.stats.clone()
        state.model.zero_grad(set_to_none=True)
        loss, aux = pppe_forward(state.model, batch, lam_eff)
        loss.backward()
        # the prob model takes no part in the loss: its gradients are zeros
        g = global_sum(torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                                  .reshape(-1) for _, p in state.named_parameters()]))
        loss = global_sum(loss.detach())
        ok = torch.isfinite(loss)
        with torch.no_grad():
            _adam_update(state, g, tx, ok)
            state.stats.copy_(torch.where(ok, state.stats, old_stats))
        aux["loss"] = loss
        aux["skipped"] = ~ok
        return state, {k: v.detach() for k, v in aux.items()}

    return train_step
