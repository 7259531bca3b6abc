"""Weight bridge between pcc_tpu's flax variable trees and the port's
state_dicts.

pcc_tpu saves inference weights as `ae.pkl` / `prob.pkl`: pickles of nested
dicts of numpy arrays (pcc_tpu/train/checkpoint.py), which load without
JAX. `from_jax_params` turns them into the port's state_dicts, which carry
the reference's torch names (the inverse of pcc_tpu's
cli/import_torch_checkpoint.py::convert_ae_state_dict /
convert_prob_state_dict); `to_jax_params` goes the other way, for the
integer probability model's converter (coding/iprob.py,
coding/iprob_pppf.py) and the tests. Both model families are carried: IPDAE
("AE", `params` only) and PPPF-AE (`params` and the BatchNorm running
statistics in `batch_stats`; cli/import_torch_checkpoint.py::
convert_pppf_ae_state_dict / convert_pppf_prob_state_dict) and PPPE (one
PointCloudAE, `params` and `batch_stats`, whose prob model is a submodule;
convert_pppe_ae_state_dict, which writes the stages' conv biases as zeros,
where these functions carry pcc_tpu's), and the attribute extension's
attr.pkl / attr_prob.pkl (`attr_from_jax`, `attr_to_jax`: PatchAttrAE,
whose names mirror pcc_tpu's flax tree, as no reference state_dict exists
for it, and an IPDAE ConditionalProbabilityModel at d = d_a). Both ways are
exact copies: a transpose and a rename, no arithmetic.
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


def _conv_w(kernel, conv_dims: int = 2) -> torch.Tensor:
    """[in, out] Dense kernel -> [out, in, 1, 1] 1x1-Conv2d weight ([out,
    in, 1] for a Conv1d with conv_dims=1)."""
    k = np.ascontiguousarray(np.asarray(kernel, np.float32).T)
    return torch.from_numpy(k.reshape(k.shape + (1,) * conv_dims))


def _linear_w(kernel) -> torch.Tensor:
    """[in, out] Dense kernel -> [out, in] Linear weight."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(kernel, np.float32).T))


def _bias(b) -> torch.Tensor:
    return torch.from_numpy(np.array(b, dtype=np.float32))


def _is_pppf(ae_vars=None, prob_vars=None) -> bool:
    """Whether flax variables belong to the PPPF-AE family."""
    return ((ae_vars is not None and "encoder" in _params(ae_vars))
            or (prob_vars is not None and "model_pnpp" in _params(prob_vars)))


def _pnpp_from_jax(params, stats, prefix: str, sd: dict) -> None:
    """flax PointNetPP params + batch_stats -> `{prefix}sa{j}.mlp.{3i}` conv
    and `.{3i+1}` BatchNorm entries of `sd`."""
    for j in (1, 2, 3):
        mp, ms = params[f"sa{j}"]["mlp"], stats[f"sa{j}"]["mlp"]
        for i in range(len(ms)):
            lin = mp[f"dense_{i}"]["linear"]
            conv, bn = f"{prefix}sa{j}.mlp.{3 * i}", f"{prefix}sa{j}.mlp.{3 * i + 1}"
            sd[f"{conv}.weight"] = _conv_w(lin["kernel"])
            sd[f"{conv}.bias"] = _bias(lin["bias"])
            sd[f"{bn}.weight"] = _bias(mp[f"bn_{i}"]["scale"])
            sd[f"{bn}.bias"] = _bias(mp[f"bn_{i}"]["bias"])
            sd[f"{bn}.running_mean"] = _bias(ms[f"bn_{i}"]["mean"])
            sd[f"{bn}.running_var"] = _bias(ms[f"bn_{i}"]["var"])
            sd[f"{bn}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)


def _pppf_from_jax(ae_vars, prob_vars):
    ae = prob = None
    if ae_vars is not None:
        p, ae = _params(ae_vars), {}
        _pnpp_from_jax(p["encoder"], ae_vars["batch_stats"]["encoder"], "encoder.", ae)
        for mlp in ("mlp1", "mlp2"):
            for i, idx in enumerate(_MODEL_MLP):
                lin = p["decoder"][mlp][f"dense_{i}"]["linear"]
                ae[f"decoder.{mlp}.{idx}.weight"] = _conv_w(lin["kernel"], conv_dims=1)
                ae[f"decoder.{mlp}.{idx}.bias"] = _bias(lin["bias"])
        for proj in ("enc_proj", "dec_proj"):
            ae[f"{proj}.weight"] = _linear_w(p[proj]["linear"]["kernel"])
            ae[f"{proj}.bias"] = _bias(p[proj]["linear"]["bias"])
    if prob_vars is not None:
        q, prob = _params(prob_vars), {}
        _pnpp_from_jax(q["model_pnpp"], prob_vars["batch_stats"]["model_pnpp"],
                       "model_pnpp.", prob)
        for j, idx in enumerate(_MODEL_MLP):
            lin = q["model_mlp"][f"dense_{j}"]["linear"]
            prob[f"model_mlp.{idx}.weight"] = _conv_w(lin["kernel"])
            prob[f"model_mlp.{idx}.bias"] = _bias(lin["bias"])
    return ae, prob


# PPPE: (flax name, torch module, kernel layout) of the plain layers
_PPPE_DENSE = (
    (("decoder", "fc0"), "decoder.fc_coarse.0", "linear"),
    (("decoder", "fc1"), "decoder.fc_coarse.2", "linear"),
    (("decoder", "exp0"), "decoder.expansion_mlp.0", "linear"),
    (("decoder", "exp1"), "decoder.expansion_mlp.2", "linear"),
    (("encoder", "gc0"), "encoder.global_conv.0", "conv1d"),
    (("encoder", "gc1"), "encoder.global_conv.3", "conv1d"),
    (("prob", "cond0"), "prob.cond_proj.0", "linear"),
    (("prob", "cond1"), "prob.cond_proj.2", "linear"),
    (("prob", "comb0"), "prob.combine.0", "conv1d"),
    (("prob", "comb1"), "prob.combine.2", "conv1d"),
    (("prob", "mean"), "prob.mean_head", "conv1d"),
    (("prob", "scale"), "prob.scale_head", "conv1d"),
    (("prob", "pmf"), "prob.pmf_head", "conv1d"),
)


def _pppe_stages():
    """(flax path under encoder, torch prefix of the conv2d_bn_relu stack)
    of PPPE's four stacks."""
    return ([(("sa1", f"branch_{b}"), f"encoder.sa_modules.0.branches.{b}.mlp_stack")
             for b in range(2)]
            + [((f"sa{j}",), f"encoder.sa_modules.{j - 1}.mlp_stack") for j in (2, 3)])


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _bn_from_jax(p, s, prefix: str, sd: dict) -> None:
    sd[f"{prefix}.weight"] = _bias(p["scale"])
    sd[f"{prefix}.bias"] = _bias(p["bias"])
    sd[f"{prefix}.running_mean"] = _bias(s["mean"])
    sd[f"{prefix}.running_var"] = _bias(s["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)


def _is_pppe(variables) -> bool:
    """Whether flax variables are a PPPE PointCloudAE's."""
    p = _params(variables)
    return "encoder" in p and "gc0" in p["encoder"]


def pppe_from_jax(variables) -> dict:
    """pcc_tpu PPPE variables ({'params', 'batch_stats'}) -> the port's
    PointCloudAE state_dict."""
    p, st = variables["params"], variables["batch_stats"]
    sd = {}
    for path, prefix in _pppe_stages():
        mp = _get(p["encoder"], path)["mlp"]
        ms = _get(st["encoder"], path)["mlp"]
        for i in range(len(ms)):
            lin = mp[f"dense_{i}"]["linear"]
            sd[f"{prefix}.{i}.0.weight"] = _conv_w(lin["kernel"])
            sd[f"{prefix}.{i}.0.bias"] = _bias(lin["bias"])
            _bn_from_jax(mp[f"bn_{i}"], ms[f"bn_{i}"], f"{prefix}.{i}.1", sd)
    _bn_from_jax(p["encoder"]["gc_bn"], st["encoder"]["gc_bn"], "encoder.global_conv.1", sd)
    for path, prefix, kind in _PPPE_DENSE:
        lin = _get(p, path)["linear"]
        sd[f"{prefix}.weight"] = (_linear_w(lin["kernel"]) if kind == "linear"
                                  else _conv_w(lin["kernel"], conv_dims=1))
        if "bias" in lin:
            sd[f"{prefix}.bias"] = _bias(lin["bias"])
    return sd


def pppe_to_jax(sd) -> dict:
    """The port's PointCloudAE state_dict -> pcc_tpu PPPE variables."""
    params, stats = {"encoder": {}, "decoder": {}, "prob": {}}, {"encoder": {}}

    def put(tree, path, value):
        for k in path[:-1]:
            tree = tree.setdefault(k, {})
        tree[path[-1]] = value

    def bn(prefix):
        return ({"scale": _vec(sd[f"{prefix}.weight"]), "bias": _vec(sd[f"{prefix}.bias"])},
                {"mean": _vec(sd[f"{prefix}.running_mean"]),
                 "var": _vec(sd[f"{prefix}.running_var"])})

    for path, prefix in _pppe_stages():
        mp, ms = {}, {}
        for i in range(_count(sd, prefix + ".")):
            mp[f"dense_{i}"] = _dense(sd[f"{prefix}.{i}.0.weight"], sd[f"{prefix}.{i}.0.bias"])
            mp[f"bn_{i}"], ms[f"bn_{i}"] = bn(f"{prefix}.{i}.1")
        put(params["encoder"], path + ("mlp",), mp)
        put(stats["encoder"], path + ("mlp",), ms)
    params["encoder"]["gc_bn"], stats["encoder"]["gc_bn"] = bn("encoder.global_conv.1")
    for path, prefix, _ in _PPPE_DENSE:
        w = sd[f"{prefix}.weight"].detach().cpu().numpy()
        kernel = np.ascontiguousarray(w.reshape(w.shape[0], w.shape[1]).T)
        lin = {"kernel": kernel}
        if f"{prefix}.bias" in sd:
            lin["bias"] = _vec(sd[f"{prefix}.bias"])
        put(params, path, {"linear": lin})
    return {"params": params, "batch_stats": stats}


def from_jax_params(ae_vars, prob_vars):
    """pcc_tpu flax variables (nested dicts of arrays) -> (autoencoder
    state_dict, probability model state_dict) of the port, for the family
    the variables belong to (IPDAE: PatchAE / ConditionalProbabilityModel;
    PPPF-AE: PPPF_AE / PPPFConditionalProbabilityModel; for this family
    either argument may be None; PPPE: (PointCloudAE state_dict, None), its
    prob model inside, prob_vars ignored)."""
    if ae_vars is not None and _is_pppe(ae_vars):
        return pppe_from_jax(ae_vars), None
    if _is_pppf(ae_vars, prob_vars):
        return _pppf_from_jax(ae_vars, prob_vars)
    return (None if ae_vars is None else _ipdae_from_jax(ae_vars),
            None if prob_vars is None else _prob_from_jax(prob_vars))


def _ipdae_from_jax(ae_vars) -> dict:
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
    return ae


def _prob_from_jax(prob_vars) -> dict:
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
    return prob


def _mlp_from_jax(dense: dict, prefix: str, sd: dict) -> None:
    """flax PointwiseMLP dense_{i} -> `{prefix}.mlp_Modules.{i}.0` entries."""
    for i in range(len(dense)):
        lin = dense[f"dense_{i}"]["linear"]
        sd[f"{prefix}.mlp_Modules.{i}.0.weight"] = _conv_w(lin["kernel"])
        sd[f"{prefix}.mlp_Modules.{i}.0.bias"] = _bias(lin["bias"])


def attr_from_jax(attr_vars, attr_prob_vars):
    """pcc_tpu's attribute variables (attr.pkl, attr_prob.pkl) -> the port's
    (PatchAttrAE state_dict, attribute ConditionalProbabilityModel
    state_dict); either may be None."""
    attr = None
    if attr_vars is not None:
        p, attr = _params(attr_vars), {}
        _mlp_from_jax(p["enc"]["mlp"], "enc", attr)
        _mlp_from_jax(p["dec"], "dec", attr)
    return attr, None if attr_prob_vars is None else _prob_from_jax(attr_prob_vars)


def attr_to_jax(attr_sd=None, attr_prob_sd=None):
    """The port's attribute state_dicts -> pcc_tpu's attr / attr_prob
    variables ({'params': ...}); either may be None."""
    attr = None
    if attr_sd is not None:
        def mlp(prefix):
            return {f"dense_{i}": _dense(attr_sd[f"{prefix}.mlp_Modules.{i}.0.weight"],
                                         attr_sd[f"{prefix}.mlp_Modules.{i}.0.bias"])
                    for i in range(_count(attr_sd, f"{prefix}.mlp_Modules."))}
        attr = {"params": {"enc": {"mlp": mlp("enc")}, "dec": mlp("dec")}}
    return attr, to_jax_params(None, attr_prob_sd)[1]


def load_attr_params(folder: str):
    """pcc_tpu's `attr.pkl` / `attr_prob.pkl` in `folder` -> the port's
    (attr state_dict, attr_prob state_dict), or (None, None) when absent."""
    paths = [os.path.join(folder, f"{n}.pkl") for n in ("attr", "attr_prob")]
    if not all(os.path.exists(p) for p in paths):
        return None, None
    loaded = []
    for path in paths:
        with open(path, "rb") as f:
            loaded.append(pickle.load(f))
    return attr_from_jax(*loaded)


def _dense(weight, bias) -> dict:
    w = weight.detach().cpu().numpy()
    w = w.reshape(w.shape[0], w.shape[1])          # [out, in(, 1, 1)] -> [out, in]
    return {"linear": {"kernel": np.ascontiguousarray(w.T),
                       "bias": bias.detach().cpu().numpy().copy()}}


def _count(sd, prefix: str) -> int:
    return len({k[len(prefix):].split(".")[0] for k in sd if k.startswith(prefix)})


def _vec(t) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _pnpp_to_jax(sd, prefix: str):
    """`{prefix}sa{j}.mlp.*` entries -> flax PointNetPP (params, batch_stats)."""
    params, stats = {}, {}
    for j in (1, 2, 3):
        mp, ms = {}, {}
        stack = f"{prefix}sa{j}.mlp."
        for i in range(_count(sd, stack) // 2):      # a conv and a BatchNorm per layer
            conv, bn = f"{stack}{3 * i}", f"{stack}{3 * i + 1}"
            mp[f"dense_{i}"] = _dense(sd[f"{conv}.weight"], sd[f"{conv}.bias"])
            mp[f"bn_{i}"] = {"scale": _vec(sd[f"{bn}.weight"]), "bias": _vec(sd[f"{bn}.bias"])}
            ms[f"bn_{i}"] = {"mean": _vec(sd[f"{bn}.running_mean"]),
                             "var": _vec(sd[f"{bn}.running_var"])}
        params[f"sa{j}"], stats[f"sa{j}"] = {"mlp": mp}, {"mlp": ms}
    return params, stats


def _pppf_to_jax(ae_sd, prob_sd):
    ae = prob = None
    if ae_sd is not None:
        enc_p, enc_s = _pnpp_to_jax(ae_sd, "encoder.")
        p = {"encoder": enc_p, "decoder": {
            mlp: {f"dense_{i}": _dense(ae_sd[f"decoder.{mlp}.{idx}.weight"],
                                       ae_sd[f"decoder.{mlp}.{idx}.bias"])
                  for i, idx in enumerate(_MODEL_MLP)} for mlp in ("mlp1", "mlp2")}}
        for proj in ("enc_proj", "dec_proj"):
            p[proj] = _dense(ae_sd[f"{proj}.weight"], ae_sd[f"{proj}.bias"])
        ae = {"params": p, "batch_stats": {"encoder": enc_s}}
    if prob_sd is not None:
        pn_p, pn_s = _pnpp_to_jax(prob_sd, "model_pnpp.")
        q = {"model_pnpp": pn_p, "model_mlp": {
            f"dense_{j}": _dense(prob_sd[f"model_mlp.{idx}.weight"],
                                 prob_sd[f"model_mlp.{idx}.bias"])
            for j, idx in enumerate(_MODEL_MLP)}}
        prob = {"params": q, "batch_stats": {"model_pnpp": pn_s}}
    return ae, prob


def to_jax_params(ae_sd=None, prob_sd=None):
    """Port state_dicts -> pcc_tpu flax variables ({'params': ...}, and
    'batch_stats' for PPPF-AE: nested dicts of numpy arrays); either may be
    None. The family is read off the state_dicts' names; a PPPE
    PointCloudAE state_dict gives (its variables, None)."""
    if ae_sd is not None and "encoder.global_conv.0.weight" in ae_sd:
        return pppe_to_jax(ae_sd), None
    if ((ae_sd is not None and "enc_proj.weight" in ae_sd)
            or (prob_sd is not None and "model_pnpp.sa1.mlp.0.weight" in prob_sd)):
        return _pppf_to_jax(ae_sd, prob_sd)
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
    """pcc_tpu's `ae.pkl` / `prob.pkl` in `folder`, of either model family
    -> the port's (ae_state_dict, prob_state_dict), or (None, None) when
    absent."""
    ae_p = os.path.join(folder, "ae.pkl")
    prob_p = os.path.join(folder, "prob.pkl")
    if not (os.path.exists(ae_p) and os.path.exists(prob_p)):
        return None, None
    with open(ae_p, "rb") as f:
        ae_vars = pickle.load(f)
    with open(prob_p, "rb") as f:
        prob_vars = pickle.load(f)
    return from_jax_params(ae_vars, prob_vars)
