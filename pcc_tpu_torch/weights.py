"""Weight bridge between pcc_tpu's flax variable trees and the port's
state_dicts.

pcc_tpu saves inference weights as `ae.pkl` / `prob.pkl`: pickles of nested
dicts of numpy arrays (pcc_tpu/train/checkpoint.py), which load without
JAX. `from_jax_params` turns them into the port's state_dicts, which carry
the reference's torch names (the inverse of pcc_tpu's
cli/import_torch_checkpoint.py::convert_ae_state_dict /
convert_prob_state_dict); `to_jax_params` goes the other way, for the
integer probability model's converter (coding/iprob.py) and the tests.
Both are exact copies: a transpose, no arithmetic.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

_INV_POOL = (0, 2, 4)      # Linear indices in the reference's inv_pool Sequential
_MODEL_MLP = (0, 2, 4)     # Conv2d indices in the reference's model_mlp Sequential


def _params(variables):
    return variables["params"] if "params" in variables else variables


def _conv_w(kernel) -> torch.Tensor:
    """[in, out] Dense kernel -> [out, in, 1, 1] 1x1-Conv2d weight."""
    k = np.asarray(kernel, np.float32)
    return torch.from_numpy(np.ascontiguousarray(k.T)[:, :, None, None])


def _linear_w(kernel) -> torch.Tensor:
    """[in, out] Dense kernel -> [out, in] Linear weight."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(kernel, np.float32).T))


def _bias(b) -> torch.Tensor:
    return torch.from_numpy(np.array(b, dtype=np.float32))


def from_jax_params(ae_vars, prob_vars):
    """pcc_tpu flax variables (nested dicts of arrays) -> (PatchAE
    state_dict, ConditionalProbabilityModel state_dict) of the port."""
    p = _params(ae_vars)
    ae = {}
    for i in range(len(p["sa"]["mlp"])):
        lin = p["sa"]["mlp"][f"dense_{i}"]["linear"]
        ae[f"sa.conv{i}.weight"] = _conv_w(lin["kernel"])
        ae[f"sa.conv{i}.bias"] = _bias(lin["bias"])
    for i in range(len(p["pn"]["mlp"])):
        lin = p["pn"]["mlp"][f"dense_{i}"]["linear"]
        ae[f"pn.mlp_Modules.{i}.0.weight"] = _conv_w(lin["kernel"])
        ae[f"pn.mlp_Modules.{i}.0.bias"] = _bias(lin["bias"])
    for j, idx in enumerate(_INV_POOL):
        lin = p[f"inv_pool_{j}"]["linear"]
        ae[f"inv_pool.{idx}.weight"] = _linear_w(lin["kernel"])
        ae[f"inv_pool.{idx}.bias"] = _bias(lin["bias"])
    for i in range(len(p["inv_mlp"])):
        lin = p["inv_mlp"][f"dense_{i}"]["linear"]
        ae[f"inv_mlp.mlp_Modules.{i}.0.weight"] = _conv_w(lin["kernel"])
        ae[f"inv_mlp.mlp_Modules.{i}.0.bias"] = _bias(lin["bias"])

    q = _params(prob_vars)
    prob = {}
    for i in range(len(q["model_pn"]["mlp"])):
        lin = q["model_pn"]["mlp"][f"dense_{i}"]["linear"]
        prob[f"model_pn.mlp_Modules.{i}.0.weight"] = _conv_w(lin["kernel"])
        prob[f"model_pn.mlp_Modules.{i}.0.bias"] = _bias(lin["bias"])
    for j, idx in enumerate(_MODEL_MLP):
        lin = q["model_mlp"][f"dense_{j}"]["linear"]
        prob[f"model_mlp.{idx}.weight"] = _conv_w(lin["kernel"])
        prob[f"model_mlp.{idx}.bias"] = _bias(lin["bias"])
    return ae, prob


def _dense(weight, bias) -> dict:
    w = weight.detach().cpu().numpy()
    w = w.reshape(w.shape[0], w.shape[1])          # [out, in(, 1, 1)] -> [out, in]
    return {"linear": {"kernel": np.ascontiguousarray(w.T),
                       "bias": bias.detach().cpu().numpy().copy()}}


def _count(sd, prefix: str) -> int:
    return len({k[len(prefix):].split(".")[0] for k in sd if k.startswith(prefix)})


def to_jax_params(ae_sd=None, prob_sd=None):
    """Port state_dicts -> pcc_tpu flax variables ({'params': ...} nested
    dicts of numpy arrays); either may be None."""
    ae = prob = None
    if ae_sd is not None:
        p = {"sa": {"mlp": {
            f"dense_{i}": _dense(ae_sd[f"sa.conv{i}.weight"], ae_sd[f"sa.conv{i}.bias"])
            for i in range(_count(ae_sd, "sa.conv"))}}}
        p["pn"] = {"mlp": {
            f"dense_{i}": _dense(ae_sd[f"pn.mlp_Modules.{i}.0.weight"],
                                 ae_sd[f"pn.mlp_Modules.{i}.0.bias"])
            for i in range(_count(ae_sd, "pn.mlp_Modules."))}}
        for j, idx in enumerate(_INV_POOL):
            p[f"inv_pool_{j}"] = _dense(ae_sd[f"inv_pool.{idx}.weight"],
                                        ae_sd[f"inv_pool.{idx}.bias"])
        p["inv_mlp"] = {
            f"dense_{i}": _dense(ae_sd[f"inv_mlp.mlp_Modules.{i}.0.weight"],
                                 ae_sd[f"inv_mlp.mlp_Modules.{i}.0.bias"])
            for i in range(_count(ae_sd, "inv_mlp.mlp_Modules."))}
        ae = {"params": p}
    if prob_sd is not None:
        q = {"model_pn": {"mlp": {
            f"dense_{i}": _dense(prob_sd[f"model_pn.mlp_Modules.{i}.0.weight"],
                                 prob_sd[f"model_pn.mlp_Modules.{i}.0.bias"])
            for i in range(_count(prob_sd, "model_pn.mlp_Modules."))}}}
        q["model_mlp"] = {
            f"dense_{j}": _dense(prob_sd[f"model_mlp.{idx}.weight"],
                                 prob_sd[f"model_mlp.{idx}.bias"])
            for j, idx in enumerate(_MODEL_MLP)}
        prob = {"params": q}
    return ae, prob


def load_inference_params(folder: str):
    """pcc_tpu's `ae.pkl` / `prob.pkl` in `folder` -> the port's
    (ae_state_dict, prob_state_dict), or (None, None) when absent."""
    ae_p = os.path.join(folder, "ae.pkl")
    prob_p = os.path.join(folder, "prob.pkl")
    if not (os.path.exists(ae_p) and os.path.exists(prob_p)):
        return None, None
    with open(ae_p, "rb") as f:
        ae_vars = pickle.load(f)
    with open(prob_p, "rb") as f:
        prob_vars = pickle.load(f)
    return from_jax_params(ae_vars, prob_vars)
