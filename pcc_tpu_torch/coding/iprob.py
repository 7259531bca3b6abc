"""Deterministic integer inference for the conditional probability model
(counterpart of pcc_tpu/coding/iprob.py; same fixed-point spec, so the same
weights and CDF rows, bit for bit, on the CPU, on the card and in pcc_tpu).

Why: the coding CDF must be BYTE-IDENTICAL on the encoder and decoder or
the range coder desyncs into plausible-looking garbage. A float network
only guarantees that within one compiled program, so coding-CDF inference
is defined over integers instead (Ballé et al., "Integer networks for data
compression with latent-variable models"): int8 weights, 14-bit
activations, int32 accumulation and requantization, an integer exp2 LUT for
the softmax.

Device mapping: every integer matmul runs as a float32 matmul of int7-valued
operands (wide activations split into hi/lo int7 halves). Each product is
exact and every partial sum is an integer below 2^24, so float32
accumulation is exact in any order. That holds only with TF32 off, which the
port's device setup (pcc_tpu_torch/device.py) sets explicitly: TF32 rounds
the operands to 10 mantissa bits and silently breaks the spec.

The conversion (float checkpoint -> integer bundle) is host numpy float64.
"""

from __future__ import annotations

import numpy as np
import torch

# fixed-point formats of the spec (changing any of these is a stream-format
# change):
Q_IN = 14                  # input xyz scale 2^Q_IN (unit-cube coords)
ACT_MAX = (1 << 14) - 1    # 14-bit activations (hi/lo int7 split keeps
                           # partial sums <= 512 * 127 * 127 < 2^24)
S_SM = 256                 # logit scale feeding the integer softmax
LOG2E_Q8 = 369             # round(log2(e) * S_SM): logit -> Q16 log2 domain
LUT_BITS = 8               # 2^-frac LUT resolution
# LUT[j] = round(2^16 * 2^-(j / 2^LUT_BITS)), j in [0, 255]
EXP2_LUT = np.minimum(
    np.round(65536.0 * np.exp2(-np.arange(1 << LUT_BITS) / (1 << LUT_BITS))),
    65535.0).astype(np.int32)


def _softmax_weights_np(logits_q):
    """Integer softmax weights: [..., L] int32 logits at scale S_SM ->
    [..., L] uint16-range Q16 weights w ~ 2^16 * exp(l/S_SM - max)."""
    t = logits_q - logits_q.max(axis=-1, keepdims=True)     # <= 0
    v = (-t).astype(np.int64) * LOG2E_Q8                    # Q16 log2, >= 0
    v = np.minimum(v, (31 << 16)).astype(np.int32)
    n = v >> 16
    f = (v >> (16 - LUT_BITS)) & ((1 << LUT_BITS) - 1)
    return EXP2_LUT[f] >> n


def weights_to_cdf_rows(w: np.ndarray) -> np.ndarray:
    """Integer staircase: [..., L] positive weights -> [..., L+1] int32 CDF
    rows totalling 2^16 - 1, via pure integer cumsum/floor-div."""
    L = w.shape[-1]
    cum = np.cumsum(w.astype(np.int64), axis=-1)
    cum = np.concatenate([np.zeros(w.shape[:-1] + (1,), np.int64), cum],
                         axis=-1)
    total = np.maximum(cum[..., -1:], 1)
    cdf = (cum * ((1 << 16) - (L + 1))) // total
    return (cdf + np.arange(L + 1)).astype(np.int32)


# ---------------------------------------------------------------------------
# Conversion (host, numpy): float checkpoint -> integer parameter bundle.
# ---------------------------------------------------------------------------


def _float_forward_acts(layers_pn, layers_mlp, xyz):
    """Float mirror of ConditionalProbabilityModel that records per-layer
    post-relu activations, for calibration."""
    acts = []
    x = xyz.reshape(-1, 3)
    for W, b in layers_pn:
        x = np.maximum(x @ W + b, 0.0)
        acts.append(x)
    feat = x.reshape(xyz.shape[0], xyz.shape[1], -1).max(axis=1)  # [B, 256]
    tiled = np.repeat(feat[:, None, :], xyz.shape[1], axis=1)
    y = np.concatenate([xyz, tiled], axis=-1).reshape(-1, 3 + feat.shape[-1])
    for i, (W, b) in enumerate(layers_mlp):
        y = y @ W + b
        if i < len(layers_mlp) - 1:
            y = np.maximum(y, 0.0)
        acts.append(y)
    return acts


def _quant_layer(W, b, s_in, s_next, in_max_int, colmax=None):
    """Quantize one dense layer and derive its requant constants (see
    pcc_tpu/coding/iprob.py::_quant_layer for the overflow proofs)."""
    W = np.asarray(W, np.float64)
    b = np.asarray(b, np.float64)
    if colmax is None:
        colmax = np.abs(W).max(axis=0)
    sw = np.where(colmax > 0, 127.0 / np.maximum(colmax, 1e-30), 1.0)
    Wq = np.clip(np.round(W * sw), -127, 127)
    bq = np.round(b * s_in * sw)
    zbound = (np.abs(Wq).T @ np.full(W.shape[0], float(in_max_int))).max() \
        + np.abs(bq).max()
    if not zbound < 2.0 ** 31:
        raise ValueError(f"int32 accumulator bound violated ({zbound:.3g}); "
                         "reduce activation bits or layer width")
    r1 = max(0, int(np.ceil(np.log2(max(zbound, 1.0)))) - 14)
    ratio = (s_next / (s_in * sw)) * (1 << r1)
    rq = np.clip(14 - np.floor(np.log2(np.maximum(ratio, 1e-30))), 1, 30)
    m = np.round(ratio * np.exp2(rq))
    if not ((m < (1 << 16)).all() and (m >= 0).all()):
        raise ValueError("requant multiplier out of range")
    return {
        "w": Wq.astype(np.float32),
        "b": bq.astype(np.int32),
        "r1": np.int32(r1),
        "m": m.astype(np.int32),
        "rq": rq.astype(np.int32),
    }, sw


def _as_f64(tree):
    """Nested dict of arrays -> the same dict of float64 numpy arrays."""
    if isinstance(tree, dict):
        return {k: _as_f64(v) for k, v in tree.items()}
    return np.asarray(tree, np.float64)


def convert_prob_params(prob_params, d: int, L: int, *, n_calib: int = 64,
                        S: int = 64, seed: int = 0):
    """Float ConditionalProbabilityModel params, as pcc_tpu's flax variable
    tree of numpy arrays (pcc_tpu_torch.weights.to_jax_params gives it for
    the port's modules) -> integer bundle: a flat dict of numpy arrays.

    Calibration runs the float model on seeded uniform skeletons; activation
    scales get a 1.25x headroom margin. Saturation beyond the calibrated
    range degrades rate only, never decodability.
    """
    p = prob_params["params"] if "params" in prob_params else prob_params
    p = _as_f64(p)
    pn = [(p["model_pn"]["mlp"][f"dense_{i}"]["linear"]["kernel"],
           p["model_pn"]["mlp"][f"dense_{i}"]["linear"]["bias"])
          for i in range(3)]
    mlp = [(p["model_mlp"][f"dense_{i}"]["linear"]["kernel"],
            p["model_mlp"][f"dense_{i}"]["linear"]["bias"])
           for i in range(3)]

    rng = np.random.default_rng(seed)
    acts = _float_forward_acts(pn, mlp, rng.random((n_calib, S, 3)))
    amax = [max(float(np.abs(a).max()) * 1.25, 1e-3) for a in acts]

    bundle = {"d": np.int32(d), "L": np.int32(L), "lut": EXP2_LUT}
    s_in = float(1 << Q_IN)                      # xyz at Q14
    in_max = 1 << Q_IN
    for i in range(3):                           # PN trunk
        s_next = float(ACT_MAX) / amax[i]
        layer, sw = _quant_layer(*pn[i], s_in, s_next, in_max)
        bundle[f"pn{i}"] = layer
        s_in, in_max = s_next, ACT_MAX
    s_feat = s_in                                # scale of the PN features
    # concat layer: xyz (Q14) and features (s_feat) share the first MLP
    # dense; the xyz part is computed separately at Q14 and rescaled to the
    # feature scale before the shared bias/requant
    W0, b0 = mlp[0]
    s_in = s_feat
    for i in range(3):
        if i == 0:
            Wx, Wf = W0[:3], W0[3:]
            s_next = float(ACT_MAX) / amax[3]
            # column scales from the FULL weight matrix (xyz + feature rows)
            layer, sw = _quant_layer(Wf, b0, s_feat, s_next, ACT_MAX,
                                     colmax=np.abs(W0).max(axis=0))
            Wxq = np.clip(np.round(Wx * sw), -127, 127)
            layer["wx"] = Wxq.astype(np.float32)
            ratio = s_feat / (1 << Q_IN)
            if not ratio < 8.0:
                raise ValueError("degenerate feature scale; retrain/recalib")
            rxa = 9                    # ceil(log2(3 * 2^14 * 127)) - 14
            ratio2 = ratio * (1 << rxa)
            rx = int(np.clip(14 - np.floor(np.log2(max(ratio2, 1e-30))),
                             1, 30))
            layer["mx"] = np.int32(round(ratio2 * (1 << rx)))
            layer["rxa"] = np.int32(rxa)
            layer["rx"] = np.int32(rx)
            if not 0 <= int(layer["mx"]) < (1 << 16):
                raise ValueError("xyz requant multiplier out of range")
            bundle["mlp0"] = layer
            s_in = s_next
        else:
            W, b = mlp[i]
            s_next = float(ACT_MAX) / amax[3 + i] if i < 2 else float(S_SM)
            layer, _ = _quant_layer(W, b, s_in, s_next, ACT_MAX)
            bundle[f"mlp{i}"] = layer
            s_in = s_next
    return bundle


# ---------------------------------------------------------------------------
# Inference: numpy spec + torch (CPU or card). Both give bit-identical
# weights.
# ---------------------------------------------------------------------------


def _requant_np(z, layer, relu):
    z = z + layer["b"]
    if relu:
        z = np.maximum(z, 0)
    r1 = int(layer["r1"])
    z = (z + ((1 << r1) >> 1)) >> r1
    a = (z * layer["m"] + ((1 << layer["rq"]) >> 1)) >> layer["rq"]
    if relu:
        return np.clip(a, 0, ACT_MAX)
    return np.clip(a, -32767, 32767)


def iprob_pmf_weights_np(bundle, rec_xyz) -> np.ndarray:
    """Numpy reference of the integer spec: [B, S, 3] f32 skeleton ->
    [B, S, d, L] int32 Q16 softmax weights."""
    B, S, _ = rec_xyz.shape
    d, L = int(bundle["d"]), int(bundle["L"])
    xq = np.round(np.asarray(rec_xyz, np.float32)
                  * float(1 << Q_IN)).astype(np.int32).reshape(-1, 3)
    a = xq
    for i in range(3):
        lw = bundle[f"pn{i}"]
        z = a @ lw["w"].astype(np.int64)
        a = _requant_np(z.astype(np.int32), lw, relu=True)
    feat = a.reshape(B, S, -1).max(axis=1)
    feat_t = np.repeat(feat[:, None, :], S, axis=1).reshape(B * S, -1)

    lw = bundle["mlp0"]
    zf = (feat_t @ lw["w"].astype(np.int64)).astype(np.int32)
    zx = (xq @ lw["wx"].astype(np.int64)).astype(np.int32)
    rxa, rx = int(lw["rxa"]), int(lw["rx"])
    zx = (zx + ((1 << rxa) >> 1)) >> rxa
    zx = (zx * int(lw["mx"]) + ((1 << rx) >> 1)) >> rx
    a = _requant_np(zf + zx, lw, relu=True)
    for i in (1, 2):
        lw = bundle[f"mlp{i}"]
        z = a @ lw["w"].astype(np.int64)
        a = _requant_np(z.astype(np.int32), lw, relu=(i < 2))
    logits = a.reshape(B, S, d, L)
    return _softmax_weights_np(logits)


def bundle_to_device(bundle, device) -> dict:
    """Numpy integer bundle -> dict of tensors on `device` for
    iprob_pmf_weights / iprob_pppf.pppf_pmf_weights: every entry that holds
    a layer dict becomes a layer of tensors, with the split-scale xyz part
    (wx, mx, rxa, rx) wherever the layer has one. Shift amounts stay Python
    ints; per-channel rounding offsets (1 << rq) >> 1 are precomputed on the
    host."""
    dev = {"d": int(bundle["d"]), "L": int(bundle["L"]),
           "lut": torch.as_tensor(bundle["lut"], dtype=torch.int32, device=device)}
    for name, lw in bundle.items():
        if not isinstance(lw, dict):
            continue
        out = {
            "w": torch.as_tensor(lw["w"], dtype=torch.float32, device=device),
            "b": torch.as_tensor(lw["b"], dtype=torch.int32, device=device),
            "r1": int(lw["r1"]),
            "m": torch.as_tensor(lw["m"], dtype=torch.int32, device=device),
            "rq": torch.as_tensor(lw["rq"], dtype=torch.int32, device=device),
            "rq_half": torch.as_tensor((1 << lw["rq"].astype(np.int64)) >> 1,
                                       dtype=torch.int32, device=device),
        }
        if "wx" in lw:
            out["wx"] = torch.as_tensor(lw["wx"], dtype=torch.float32, device=device)
            out["mx"], out["rxa"], out["rx"] = (int(lw["mx"]), int(lw["rxa"]),
                                                int(lw["rx"]))
        dev[name] = out
    return dev


def _exact_int_matmul(a_int: torch.Tensor, w_int8: torch.Tensor) -> torch.Tensor:
    """Bit-exact integer matmul as two float32 matmuls: a_int (int32, up to
    15 bits) splits into int7 halves, every product and partial sum is an
    exact float32 integer below 2^24 (TF32 must be off)."""
    hi = (a_int >> 7).to(torch.float32)
    lo = (a_int & 127).to(torch.float32)
    zhi = torch.matmul(hi, w_int8)
    zlo = torch.matmul(lo, w_int8)
    return (zhi.to(torch.int32) << 7) + zlo.to(torch.int32)


def _requant(z, layer, relu):
    z = z + layer["b"]
    if relu:
        z = torch.clamp_min(z, 0)
    r1 = layer["r1"]
    z = (z + ((1 << r1) >> 1)) >> r1
    a = (z * layer["m"] + layer["rq_half"]) >> layer["rq"]
    if relu:
        return torch.clamp(a, 0, ACT_MAX)
    return torch.clamp(a, -32767, 32767)


def _split_requant(zf, zx, layer, relu):
    """Requant of a concat-input layer: the xyz accumulation zx (scale
    2^Q_IN) is rescaled onto the feature accumulation zf, then the shared
    bias and requant."""
    rxa, rx = layer["rxa"], layer["rx"]
    zx = (zx + ((1 << rxa) >> 1)) >> rxa
    zx = (zx * layer["mx"] + ((1 << rx) >> 1)) >> rx
    return _requant(zf + zx, layer, relu=relu)


def softmax_weights(logits: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Torch twin of _softmax_weights_np: int32 logits at scale S_SM ->
    Q16 weights via the exp2 LUT."""
    t = logits - logits.amax(dim=-1, keepdim=True)
    v = torch.clamp_max((-t) * LOG2E_Q8, 31 << 16)
    n = v >> 16
    f = (v >> (16 - LUT_BITS)) & ((1 << LUT_BITS) - 1)
    return lut[f.long()] >> n


def iprob_pmf_weights(dev_bundle, rec_xyz: torch.Tensor) -> torch.Tensor:
    """Torch twin of iprob_pmf_weights_np on the bundle's device:
    [B, S, 3] f32 -> [B, S, d, L] int32 Q16 weights, bit-equal to the numpy
    spec and to pcc_tpu on any device."""
    B, S, _ = rec_xyz.shape
    d, L = dev_bundle["d"], dev_bundle["L"]
    xq = torch.round(rec_xyz.to(torch.float32)
                     * float(1 << Q_IN)).to(torch.int32).reshape(-1, 3)
    a = xq
    for i in range(3):
        lw = dev_bundle[f"pn{i}"]
        a = _requant(_exact_int_matmul(a, lw["w"]), lw, relu=True)
    feat = a.reshape(B, S, -1).amax(dim=1)
    feat_t = feat[:, None, :].expand(B, S, feat.shape[-1]).reshape(B * S, -1)

    lw = dev_bundle["mlp0"]
    a = _split_requant(_exact_int_matmul(feat_t, lw["w"]),
                       _exact_int_matmul(xq, lw["wx"]), lw, relu=True)
    for i in (1, 2):
        lw = dev_bundle[f"mlp{i}"]
        a = _requant(_exact_int_matmul(a, lw["w"]), lw, relu=(i < 2))
    return softmax_weights(a.reshape(B, S, d, L), dev_bundle["lut"])
