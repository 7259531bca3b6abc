"""Checkpoint save / resume with the reference's naming (counterpart of
pcc_tpu/train/checkpoint.py; reference train.py:70-108).

Every dump writes step-suffixed ae_step{N}.pkl, prob_step{N}.pkl,
optimizer_step{N}.pkl and global_step{N}.pkl, and exports the un-suffixed
ae.pkl / prob.pkl that compress loads. The model pickles are in pcc_tpu's
layout (nested dicts of numpy arrays, weights.to_jax_params; for PPPF-AE
{'params', 'batch_stats'}, the BatchNorm running statistics included), so
pcc_tpu's load_inference_params and compress read what the port trains,
and the port's own weights.load_inference_params reads it back; resuming
restores the running statistics with the weights. The optimizer pickle
holds the port's Adam state as numpy arrays keyed by parameter name
('ae.sa.conv0.weight', ...): {name: {"exp_avg", "exp_avg_sq", "step"}}.

PPPE training keeps pcc_tpu's fixed-name scheme,
{ae,prob,optimizer,global}_{latest,best}.pkl (train_pppe_pcd_ae.py:84-89):
`save_pppe_checkpoint` writes the AE's variables (its prob model inside,
so prob_*.pkl holds the same, as pcc_tpu writes it) in pcc_tpu's layout,
which pcc_tpu's load_pppe_checkpoint and the port's PPPE compress CLI
(`load_pppe_checkpoint`) read; optimizer_*.pkl holds the port's Adam state
in the format above (keyed by the AE's parameter names), which
`resume_pppe_checkpoint` reads back. An optax pickle written by pcc_tpu is
not read: resuming from one starts Adam afresh, with a warning.

In a process group (parallel/mesh.py) only rank 0 writes, the state being
the same on every rank; every rank resumes from the same files.
"""

from __future__ import annotations

import os
import pickle
import re

import torch

from pcc_tpu_torch.parallel.mesh import rank
from pcc_tpu_torch.weights import from_jax_params, to_jax_params


def _dump(obj, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def _load(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def _model_vars(state):
    """(ae, prob) as pcc_tpu flax variable trees of numpy arrays."""
    return to_jax_params(state.ae.state_dict(), state.prob.state_dict())


def optimizer_state(state) -> dict:
    """The Adam moments and step of every parameter, as numpy arrays."""
    out = {}
    for name, p in state.named_parameters():
        st = state.optimizer.state.get(p)
        if st:
            out[name] = {k: v.detach().cpu().numpy().copy() for k, v in st.items()}
    return out


def load_optimizer_state(state, saved: dict) -> None:
    """Put `optimizer_state`'s arrays back on the state's parameters."""
    for name, p in state.named_parameters():
        if name in saved:
            state.optimizer.state[p] = {
                k: torch.from_numpy(v).to(p.device if k != "step" else "cpu")
                for k, v in saved[name].items()}


def save_checkpoint(folder: str, state, global_step: int | str = "") -> None:
    """Step-suffixed dump (train.py:104-108) plus the inference export
    (rank 0 only)."""
    if rank() != 0:
        return
    os.makedirs(folder, exist_ok=True)
    ae_vars, prob_vars = _model_vars(state)
    _dump(ae_vars, os.path.join(folder, f"ae_step{global_step}.pkl"))
    _dump(prob_vars, os.path.join(folder, f"prob_step{global_step}.pkl"))
    _dump(optimizer_state(state), os.path.join(folder, f"optimizer_step{global_step}.pkl"))
    _dump(int(state.step), os.path.join(folder, f"global_step{global_step}.pkl"))
    export_inference_params(folder, state)


def export_inference_params(folder: str, state) -> None:
    """Write the un-suffixed names compress / decompress load (rank 0
    only)."""
    if rank() != 0:
        return
    os.makedirs(folder, exist_ok=True)
    ae_vars, prob_vars = _model_vars(state)
    _dump(ae_vars, os.path.join(folder, "ae.pkl"))
    _dump(prob_vars, os.path.join(folder, "prob.pkl"))


def find_latest_checkpoint(folder: str, prefix: str) -> str | None:
    """Highest-step `{prefix}_step{N}.pkl` in folder (train.py:71-80)."""
    if not os.path.isdir(folder):
        return None
    best, best_step = None, -1
    pat = re.compile(rf"^{re.escape(prefix)}_step(\d+)\.pkl$")
    for f in os.listdir(folder):
        m = pat.match(f)
        if m and int(m.group(1)) > best_step:
            best_step = int(m.group(1))
            best = os.path.join(folder, f)
    return best


def load_latest_checkpoint(folder: str, state):
    """Resume models, optimizer and step from the latest dump; returns
    (state, start_step), start_step = the saved step + 1 as the reference
    resumes. Missing files are skipped (train.py:83-101)."""
    paths = {p: find_latest_checkpoint(folder, p)
             for p in ("ae", "prob", "optimizer", "global")}
    if paths["ae"] and paths["prob"]:
        ae_sd, prob_sd = from_jax_params(_load(paths["ae"]), _load(paths["prob"]))
        state.ae.load_state_dict(ae_sd)
        state.prob.load_state_dict(prob_sd)
    if paths["optimizer"]:
        load_optimizer_state(state, _load(paths["optimizer"]))
    start_step = 0
    if paths["global"]:
        start_step = int(_load(paths["global"])) + 1
        state.step = start_step
    return state, start_step


def load_pppe_checkpoint(folder: str, model, best: bool = False) -> bool:
    """Load pcc_tpu's PPPE `ae_{latest,best}.pkl` (pcc_tpu/train/
    checkpoint.py::save_pppe_checkpoint; train_pppe_pcd_ae.py:84-89) into a
    port PointCloudAE, BatchNorm running statistics included. Returns False,
    the model untouched, when the folder holds no such file."""
    ae_p = os.path.join(folder, f"ae_{'best' if best else 'latest'}.pkl")
    if not os.path.exists(ae_p):
        return False
    sd, _ = from_jax_params(_load(ae_p), None)
    model.load_state_dict(sd)
    return True


def pppe_optimizer_state(state) -> dict:
    """A PPPE train state's Adam moments and update count, as numpy arrays
    keyed by parameter name (`optimizer_state`'s format)."""
    mu, nu = state.views(state.mu), state.views(state.nu)
    count = state.count.cpu().numpy().copy()
    return {name: {"exp_avg": mu[name].cpu().numpy().copy(),
                   "exp_avg_sq": nu[name].cpu().numpy().copy(), "step": count}
            for name, _ in state.named_parameters()}


def save_pppe_checkpoint(folder: str, state, global_step: int, best: bool = False) -> None:
    """{ae,prob,optimizer,global}_{latest,best}.pkl of a PPPE train state
    (pcc_tpu/train/checkpoint.py::save_pppe_checkpoint), rank 0 only."""
    if rank() != 0:
        return
    os.makedirs(folder, exist_ok=True)
    suffix = "best" if best else "latest"
    ae_vars, _ = to_jax_params(state.model.state_dict())
    _dump(ae_vars, os.path.join(folder, f"ae_{suffix}.pkl"))
    _dump(ae_vars, os.path.join(folder, f"prob_{suffix}.pkl"))
    _dump(pppe_optimizer_state(state), os.path.join(folder, f"optimizer_{suffix}.pkl"))
    _dump(int(global_step), os.path.join(folder, f"global_{suffix}.pkl"))


def resume_pppe_checkpoint(folder: str, state, best: bool = False):
    """Resume a PPPE train state from the fixed-name scheme: weights and
    running statistics, the port's Adam state, and the step; returns
    (state, start_step), start_step = the saved step + 1 as pcc_tpu
    resumes (train_pppe_pcd_ae.py:61-82). Missing files are skipped."""
    suffix = "best" if best else "latest"
    load_pppe_checkpoint(folder, state.model, best=best)
    opt_p = os.path.join(folder, f"optimizer_{suffix}.pkl")
    if os.path.exists(opt_p):
        try:
            saved = _load(opt_p)
        except (ImportError, AttributeError):      # an optax pickle
            saved = None
        names = [n for n, _ in state.named_parameters()]
        if isinstance(saved, dict) and set(saved) == set(names):
            mu, nu = state.views(state.mu), state.views(state.nu)
            with torch.no_grad():
                for n in names:
                    mu[n].copy_(torch.from_numpy(saved[n]["exp_avg"]))
                    nu[n].copy_(torch.from_numpy(saved[n]["exp_avg_sq"]))
                state.count.fill_(int(saved[names[0]]["step"]))
        else:
            print(f"WARNING: {opt_p} is not the port's Adam state; Adam starts afresh.")
    start_step = 0
    step_p = os.path.join(folder, f"global_{suffix}.pkl")
    if os.path.exists(step_p):
        start_step = int(_load(step_p)) + 1
        state.step.fill_(start_step)
    return state, start_step
