"""The PPPF-AE training step (counterpart of pcc_tpu/train/steps_pppf.py):
the pipeline of train/steps.py with the PN++ autoencoder and its
conditional probability model, whose set-abstraction stages carry
BatchNorm running statistics (pointnet_sa_module.py:49-56), kept as the
modules' buffers. The decoded cloud has S * d * d points against the
N-point input (PPPF_AE.py:118-123), as in the reference: 2N at the
default K and d, so the chamfer kernels take the loss for N <= 512.

Two kinds of step, as pcc_tpu trains them (cli/train.py --bn_warmup_steps):
  * fused=False, the warm-up: every stage with batch statistics, running
    statistics updated, plain products;
  * fused=True: the autoencoder's encoder with BatchNorm frozen at its
    running statistics (its stages in eval mode: the stage kernel forward,
    the stage backward kernel), the probability model still with batch
    statistics, its running statistics still updated.
Adam updates parameters only, never running statistics.
"""

from __future__ import annotations

import torch

from pcc_tpu_torch.config import CodecConfig
from pcc_tpu_torch.train.steps import build_train_step, rd_forward


def set_bn_modes(ae: torch.nn.Module, prob: torch.nn.Module, fused: bool) -> None:
    """Both models in train mode, the encoder's BatchNorm frozen when
    `fused`."""
    ae.train()
    ae.encoder.train(not fused)
    prob.train()


def pppf_forward(ae, prob, batch: torch.Tensor, starts: torch.Tensor, lam: float,
                 cfg: CodecConfig, rate_mode: str = "reference", fused: bool = False):
    """Rate-distortion loss of clouds [B, N, 3] with FPS start indices [B]
    (pcc_tpu's pppf_forward with train=True): (loss, aux) as
    steps.rd_forward, updating the running statistics that train."""
    set_bn_modes(ae, prob, fused)
    return rd_forward(ae, prob, batch, starts, lam, cfg, rate_mode)


def build_pppf_train_step(cfg: CodecConfig, tx, rate_mode: str = "reference",
                          fused: bool = False):
    """Returns train_step(state, batch [B, N, 3], starts [B], lam) ->
    (state, aux), as steps.build_train_step, for a PPPF-AE state; `fused`
    selects the step kind (module docstring)."""
    step = build_train_step(cfg, tx, rate_mode=rate_mode)

    def train_step(state, batch: torch.Tensor, starts: torch.Tensor, lam: float):
        set_bn_modes(state.ae, state.prob, fused)
        return step(state, batch, starts, lam)

    return train_step
