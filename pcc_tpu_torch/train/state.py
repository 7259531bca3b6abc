"""Joint AE + probability-model training state (counterpart of
pcc_tpu/train/state.py and, for PPPF-AE, of train/steps_pppf.py's
PPPFTrainState): Adam over both models' parameters together, as the
reference optimizes them (train.py:132-135), with its step-decay schedule.
PPPF-AE's BatchNorm running statistics are the modules' buffers (pcc_tpu's
batch_stats), outside the optimizer.
"""

from __future__ import annotations

import dataclasses

import torch

from pcc_tpu_torch.codec import init_params, make_models
from pcc_tpu_torch.config import CodecConfig
from pcc_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class AdamSchedule:
    """Adam (beta 0.9 / 0.999, eps 1e-8, optax.adam's defaults) with the
    reference's step decay (train.py:241-245): lr *= lr_decay every
    lr_decay_steps, as optax.piecewise_constant_schedule applies it."""

    lr: float
    lr_decay: float
    lr_decay_steps: int
    max_steps: int

    def lr_at(self, count: int) -> float:
        """Learning rate of update `count` (0-based, counted before the
        update): lr * lr_decay ** #{b in range(lr_decay_steps, max_steps + 1,
        lr_decay_steps) : b <= count}."""
        n = sum(1 for b in range(self.lr_decay_steps, self.max_steps + 1,
                                 self.lr_decay_steps) if b <= count)
        return self.lr * self.lr_decay ** n

    def build(self, params) -> torch.optim.Adam:
        return torch.optim.Adam(params, lr=self.lr, betas=(0.9, 0.999), eps=1e-8)


def make_optimizer(lr: float, lr_decay: float, lr_decay_steps: int,
                   max_steps: int) -> AdamSchedule:
    return AdamSchedule(lr, lr_decay, lr_decay_steps, max_steps)


@dataclasses.dataclass
class TrainState:
    ae: torch.nn.Module             # PatchAE or PPPF_AE
    prob: torch.nn.Module           # ConditionalProbabilityModel or its PPPF twin
    optimizer: torch.optim.Adam     # over ae's then prob's parameters
    step: int = 0

    def named_parameters(self):
        """(name, parameter) of both models, names prefixed 'ae.' / 'prob.':
        the optimizer's parameter order."""
        return ([(f"ae.{n}", p) for n, p in self.ae.named_parameters()]
                + [(f"prob.{n}", p) for n, p in self.prob.named_parameters()])

    def update_count(self) -> int:
        """Adam updates applied so far (the schedule's count)."""
        st = self.optimizer.state.get(self.optimizer.param_groups[0]["params"][0])
        return int(st["step"]) if st else 0

    def apply_gradients(self, tx: AdamSchedule) -> None:
        """One Adam update from the parameters' .grad, at the learning rate
        that `tx` gives this update."""
        lr = tx.lr_at(self.update_count())
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1


def create_train_state(seed: int, cfg: CodecConfig, tx: AdamSchedule,
                       device: str | torch.device = "cuda") -> TrainState:
    """The models of cfg.model on `device` in train mode, with seeded random
    weights (BatchNorm at its defaults), and a fresh Adam over their
    parameters. PPPF-AE's models compute in float32 whatever
    cfg.compute_dtype says, as pcc_tpu's trainer builds them."""
    dev = resolve_device(device)
    if cfg.model == "PPPF-AE":
        # pcc_tpu's PPPF-AE trainer builds both models with no dtype, so its
        # step is float32 whatever compute_dtype says
        # (pcc_tpu/train/steps_pppf.py:50-54, make_pppf_models)
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
    ae_sd, prob_sd = init_params(seed, cfg)
    ae, prob = make_models(cfg)
    ae.load_state_dict(ae_sd)
    prob.load_state_dict(prob_sd)
    ae, prob = ae.to(dev).train(), prob.to(dev).train()
    optimizer = tx.build(list(ae.parameters()) + list(prob.parameters()))
    return TrainState(ae=ae, prob=prob, optimizer=optimizer)
