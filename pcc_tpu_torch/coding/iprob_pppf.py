"""Deterministic integer inference for the PPPF conditional probability
model (counterpart of pcc_tpu/coding/iprob_pppf.py; same fixed-point spec,
so the same bundle, weights and CDF rows, bit for bit, on the CPU, on the
card and in pcc_tpu).

Extends the spec of coding/iprob.py, which covers the IPDAE model's plain
PointNet trunk, to the PN++ backbone of
models/pppf.py::PPPFConditionalProbabilityModel (reference
PPPF_AE.py:181-228): three set-abstraction stages (FPS -> ball query ->
grouped MLP -> max), a global max, then the shared xyz + feature MLP trunk.

Two ingredients beyond iprob.py:

1. Integer-deterministic selection. FPS and ball query are pure index
   computations over coordinates. Both run on coordinates quantized to a
   per-stage selection grid of q bits (q chosen so that every squared
   distance and every composite sort key stays below 2^31 in int32, see
   _qsel). FPS is a masked argmax loop (ties to the lowest index); ball
   query orders the composite key d2 * n_src + idx, strictly increasing in
   distance with the index breaking ties, so the selected indices are the
   same on every backend by construction. Selection on the q-bit grid may
   differ from the float model's float32 choice; that shifts the PMF
   slightly (rate), never decodability.
2. BatchNorm folding. The float model's BatchNorm layers (inference =
   running statistics) fold into each dense layer's (W, b) at conversion
   time, after which every layer is the int8-weight / int32-requant
   machinery of iprob.py, including the split-scale handling of feature +
   xyz concat inputs (sa2 / sa3 layer 0 and the trunk's mlp0).

The numpy spec (pppf_pmf_weights_np) and the torch program
(pppf_pmf_weights) give bit-identical int32 Q16 weights. The conversion is
host numpy float64.
"""

from __future__ import annotations

import numpy as np
import torch

from pcc_tpu_torch.coding.iprob import (
    ACT_MAX,
    EXP2_LUT,
    Q_IN,
    S_SM,
    _as_f64,
    _exact_int_matmul,
    _quant_layer,
    _requant,
    _requant_np,
    _softmax_weights_np,
    _split_requant,
    softmax_weights,
)
from pcc_tpu_torch.ops.fps import fps_int_batch
from pcc_tpu_torch.ops.knn import knn_gather

# The backbone (fixed by PPPFConditionalProbabilityModel: PointNetPP(
# sa1_mlp=(64,64,128), sa2_mlp=(128,128,256), sa3_mlp=(256,512,1024),
# feature_dim=1024) with the reference stage geometry, PPPF_AE.py:29-37,
# 187-192). "width" lists each stage's dense layer OUTPUT widths; stage 0's
# input is raw grouped xyz, later stages concat(previous features, grouped
# xyz).
_STAGES = (
    {"npoint": 512, "K": 32, "radius": 0.2, "width": (3, 64, 64, 128)},
    {"npoint": 128, "K": 64, "radius": 0.4, "width": (128, 128, 256)},
    {"npoint": 32, "K": 128, "radius": 0.8, "width": (256, 512, 1024, 1024)},
)


def _qsel(n_src: int) -> int:
    """Selection-grid bits for a stage with n_src source points: the widest
    q <= 10 such that the ball-query composite key d2 * n_src + idx (with
    d2 <= 3 * 4^q) stays below 2^31, so that every selection intermediate
    is exact in int32 on any backend."""
    q = 10
    while 3 * (4 ** q) * n_src + n_src >= (1 << 31):
        q -= 1
    if q < 4:
        raise ValueError(f"n_src={n_src} leaves no usable selection grid")
    return q


# ---------------------------------------------------------------------------
# Integer selection: numpy spec + torch twins (bit for bit the same).
# ---------------------------------------------------------------------------


def _int_fps_np(xs: np.ndarray, npoint: int, inf: int) -> np.ndarray:
    """Deterministic integer FPS: [B, n, 3] int32 grid coords -> [B, npoint]
    indices. Start index 0; argmax ties resolve to the lowest index.
    npoint > n is allowed (selection saturates and repeats index 0, as the
    float model's FPS does)."""
    B, n, _ = xs.shape
    out = np.zeros((B, npoint), np.int32)
    dist = np.full((B, n), inf, np.int32)
    far = np.zeros((B,), np.int32)
    rows = np.arange(B)
    for i in range(npoint):
        out[:, i] = far
        c = xs[rows, far]                                  # [B, 3]
        d = ((xs - c[:, None, :]) ** 2).sum(-1).astype(np.int32)
        dist = np.minimum(dist, d)
        far = dist.argmax(axis=1).astype(np.int32)
    return out


def _int_fps(xs: torch.Tensor, npoint: int, inf: int) -> torch.Tensor:
    """Torch twin of _int_fps_np: [B, n, 3] int32 -> [B, npoint] int64.
    One launch of the FPS kernel's int32 instance on the card, its plain
    version on the CPU (ops/fps.py::fps_int_batch)."""
    return fps_int_batch(xs.contiguous(), npoint, inf).long()


def _int_ball_np(centers, src, K: int, r2: int, n_src: int) -> np.ndarray:
    """Deterministic integer ball query: nearest K within the radius, with
    out-of-radius slots set to index 0 (the ops/knn.py::ball_query
    contract). centers [B, S, 3] / src [B, n, 3] int32 grid coords. The
    composite key d2 * n_src + idx gives a total order, so the selection is
    backend-independent. K > n_src pads with index 0 (whose own distance
    decides its mask slot)."""
    d2 = ((centers[:, :, None, :] - src[:, None, :, :]) ** 2).sum(-1)
    d2 = d2.astype(np.int32)                               # [B, S, n]
    key = d2 * np.int32(n_src) + np.arange(n_src, dtype=np.int32)
    if K > n_src:
        order = np.argsort(key, axis=-1).astype(np.int32)
        pad = np.zeros(order.shape[:-1] + (K - n_src,), np.int32)
        order = np.concatenate([order, pad], axis=-1)
    else:
        order = np.argsort(key, axis=-1)[..., :K].astype(np.int32)
    d2s = np.take_along_axis(d2, order, axis=-1)
    return np.where(d2s <= r2, order, 0).astype(np.int32)


def _int_ball(centers: torch.Tensor, src: torch.Tensor, K: int, r2: int,
              n_src: int) -> torch.Tensor:
    """Torch twin of _int_ball_np, all int32; returns [B, S, K] int64. The
    keys are distinct, so the K smallest are the same whatever sorts them."""
    d2 = ((centers[:, :, None, :] - src[:, None, :, :]) ** 2).sum(-1, dtype=torch.int32)
    key = d2 * n_src + torch.arange(n_src, dtype=torch.int32, device=src.device)
    keys = torch.topk(key, min(K, n_src), dim=-1, largest=False, sorted=True).values
    order = (keys % n_src).long()
    if K > n_src:
        order = torch.cat([order, order.new_zeros(order.shape[:-1] + (K - n_src,))], dim=-1)
    return torch.where(torch.gather(d2, 2, order) <= r2, order, 0)


def _gather_np(points, idx):
    """[B, n, C] at [B, S, K] -> [B, S, K, C]."""
    B = points.shape[0]
    return points[np.arange(B)[:, None, None], idx]


# ---------------------------------------------------------------------------
# Conversion: float checkpoint (params + batch_stats) -> integer bundle.
# ---------------------------------------------------------------------------


def _fold_layers(prob_variables):
    """(W, b) float64 pairs per layer with BatchNorm folded into the dense
    layer (inference uses running statistics, so BatchNorm is a per-channel
    affine: W' = W * g, b' = (b - mean) * g + beta, g = scale / sqrt(var +
    eps) with eps = 1e-5)."""
    params = _as_f64(prob_variables["params"])
    stats = _as_f64(prob_variables.get("batch_stats", {}))
    stages_wb = []
    for j, st in enumerate(_STAGES, start=1):
        mp = params["model_pnpp"][f"sa{j}"]["mlp"]
        ms = stats["model_pnpp"][f"sa{j}"]["mlp"]
        layers = []
        for i in range(len(st["width"])):
            W = mp[f"dense_{i}"]["linear"]["kernel"]
            b = mp[f"dense_{i}"]["linear"]["bias"]
            g = mp[f"bn_{i}"]["scale"] / np.sqrt(ms[f"bn_{i}"]["var"] + 1e-5)
            layers.append((W * g,
                           (b - ms[f"bn_{i}"]["mean"]) * g
                           + mp[f"bn_{i}"]["bias"]))
        stages_wb.append(layers)
    mlp_wb = [(params["model_mlp"][f"dense_{i}"]["linear"]["kernel"],
               params["model_mlp"][f"dense_{i}"]["linear"]["bias"])
              for i in range(3)]
    return stages_wb, mlp_wb


def _selection_np(xq):
    """All selection indices from quantized coords alone (FPS and ball
    query never read features): [(fps_idx or None, group_idx), ...] per
    stage. Shared by the float calibration mirror and the integer numpy
    forward so both see the same grouping."""
    sel = []
    cur = xq
    for st in _STAGES:
        n_src = cur.shape[1]
        q = _qsel(n_src)
        xs = cur >> (Q_IN - q)
        if st["npoint"] == n_src:
            fidx, cs = None, xs
        else:
            fidx = _int_fps_np(xs, st["npoint"], 3 * (4 ** q) + 1)
            cs = np.take_along_axis(xs, fidx[..., None], axis=1)
        r = int(round(st["radius"] * (1 << q)))
        gidx = _int_ball_np(cs, xs, st["K"], r * r, n_src)
        sel.append((fidx, gidx))
        cur = cur if fidx is None else np.take_along_axis(
            cur, fidx[..., None], axis=1)
    return sel


def _mirror_forward(stages_wb, mlp_wb, rec_xyz):
    """Float64 mirror of the model with INTEGER selection (the structure the
    integer net runs), recording post-activation tensors per layer for
    calibration. Returns (logits [B, S, dL], acts list)."""
    B, S, _ = rec_xyz.shape
    xq = np.round(np.asarray(rec_xyz, np.float32)
                  * float(1 << Q_IN)).astype(np.int32)
    xyz0 = xq.astype(np.float64) / float(1 << Q_IN)
    sel = _selection_np(xq)
    acts = []
    cur, feat = xyz0, None
    for (fidx, gidx), layers in zip(sel, stages_wb):
        gx = _gather_np(cur, gidx)                         # [B, np, K, 3]
        a = gx if feat is None else np.concatenate(
            [_gather_np(feat, gidx), gx], axis=-1)
        for W, b in layers:
            a = np.maximum(a @ W + b, 0.0)
            acts.append(a)
        feat = a.max(axis=2)                               # [B, np, C]
        cur = cur if fidx is None else np.take_along_axis(
            cur, fidx[..., None], axis=1)
    g = feat.max(axis=1)                                   # [B, C]
    y = np.concatenate(
        [xyz0, np.repeat(g[:, None, :], S, axis=1)],
        axis=-1).reshape(B * S, -1)
    for i, (W, b) in enumerate(mlp_wb):
        y = y @ W + b
        if i < len(mlp_wb) - 1:
            y = np.maximum(y, 0.0)
        acts.append(y)
    return y.reshape(B, S, -1), acts


def _quant_split(Wmain, Wx, b, s_main, s_next, colmax):
    """Quantize a concat-input layer whose rows split into a feature part
    (scale s_main) and a 3-row xyz part (scale 2^Q_IN): the xyz accumulation
    is computed separately and rescaled onto the feature accumulation scale
    with one scalar two-stage requant (the column scales cancel), the scheme
    of iprob.py's mlp0."""
    layer, sw = _quant_layer(Wmain, b, s_main, s_next, ACT_MAX,
                             colmax=colmax)
    Wxq = np.clip(np.round(np.asarray(Wx, np.float64) * sw), -127, 127)
    layer["wx"] = Wxq.astype(np.float32)
    ratio = s_main / float(1 << Q_IN)
    # guarded by the 0.25 activation floor on every concat-feeding layer
    # (convert_pppf_prob_params): s_main <= 4 * ACT_MAX => ratio < 4
    if not ratio < 8.0:
        raise ValueError("degenerate feature scale; recalibrate")
    rxa = 9                     # ceil(log2(3 * 2^Q_IN * 127)) - 14
    ratio2 = ratio * (1 << rxa)
    rx = int(np.clip(14 - np.floor(np.log2(max(ratio2, 1e-30))), 1, 30))
    layer["mx"] = np.int32(round(ratio2 * (1 << rx)))
    layer["rxa"] = np.int32(rxa)
    layer["rx"] = np.int32(rx)
    if not 0 <= int(layer["mx"]) < (1 << 16):
        raise ValueError("xyz requant multiplier out of range")
    return layer


def convert_pppf_prob_params(prob_variables, d: int, L: int, *,
                             n_calib: int = 32, S: int = 64, seed: int = 0):
    """Float PPPFConditionalProbabilityModel variables (params +
    batch_stats, as pcc_tpu's flax variable tree of numpy arrays;
    pcc_tpu_torch.weights.to_jax_params gives it for the port's module) ->
    integer parameter bundle (flat dict of numpy arrays).

    Calibration runs the BatchNorm-folded float mirror (integer selection)
    on seeded uniform skeletons; activation scales get 1.25x headroom.
    Stage-final and trunk-feeding layers additionally floor their calibrated
    range at 0.25 so the concat rescale stays inside the proven int32 bounds
    (see _quant_split). Saturation beyond the calibrated range costs rate
    only, never decodability."""
    stages_wb, mlp_wb = _fold_layers(prob_variables)
    rng = np.random.default_rng(seed)
    rec = rng.random((n_calib, S, 3)).astype(np.float32)
    # one calibration cloud at a time: the mirror materializes per-layer
    # [1, npoint, K, C] float64 grouped activations
    amax = None
    for b in range(n_calib):
        _, acts = _mirror_forward(stages_wb, mlp_wb, rec[b:b + 1])
        m = [float(np.abs(a).max()) for a in acts]
        amax = m if amax is None else [max(x, y) for x, y in zip(amax, m)]
    amax = [max(a * 1.25, 1e-3) for a in amax]

    bundle = {"d": np.int32(d), "L": np.int32(L), "lut": EXP2_LUT}
    ai = 0
    s_feat = None               # scale of the previous stage's features
    for j, (st, layers) in enumerate(zip(_STAGES, stages_wb), start=1):
        s_in, in_max = float(1 << Q_IN), 1 << Q_IN
        nl = len(layers)
        for i in range(nl):
            a_val = amax[ai]
            ai += 1
            if i == nl - 1:
                a_val = max(a_val, 0.25)   # concat-rescale safety floor
            s_next = float(ACT_MAX) / a_val
            if i == 0 and s_feat is not None:
                W, b = layers[0]
                # the SA concat puts features FIRST, xyz LAST
                # (models/pppf.py::PointnetSAModule)
                Wf, Wx = W[:-3], W[-3:]
                bundle[f"sa{j}_{i}"] = _quant_split(
                    Wf, Wx, b, s_feat, s_next,
                    colmax=np.abs(W).max(axis=0))
            else:
                layer, _ = _quant_layer(*layers[i], s_in, s_next, in_max)
                bundle[f"sa{j}_{i}"] = layer
            s_in, in_max = s_next, ACT_MAX
        s_feat = s_in
    # trunk: mlp0's concat puts xyz FIRST (models/pppf.py, the model's forward)
    for i in range(3):
        a_val = amax[ai]
        ai += 1
        if i == 0:
            W0, b0 = mlp_wb[0]
            bundle["mlp0"] = _quant_split(
                W0[3:], W0[:3], b0, s_feat, float(ACT_MAX) / a_val,
                colmax=np.abs(W0).max(axis=0))
            s_in = float(ACT_MAX) / a_val
        else:
            s_next = float(ACT_MAX) / a_val if i < 2 else float(S_SM)
            layer, _ = _quant_layer(*mlp_wb[i], s_in, s_next, ACT_MAX)
            bundle[f"mlp{i}"] = layer
            s_in = s_next
    assert ai == len(amax)
    return bundle


# ---------------------------------------------------------------------------
# Inference: numpy spec + torch twin (bit-identical int32 Q16 weights).
# ---------------------------------------------------------------------------


def _imm_np(a, W):
    """Exact integer matmul for the numpy spec, via float64 BLAS: every
    product (<= 2^14 * 127) and every partial sum (<= 1024 terms < 2^31) is
    an integer below 2^53, so float64 accumulation is exact in any order."""
    return (a.astype(np.float64) @ W.astype(np.float64)).astype(np.int32)


def _split_requant_np(zf, zx, lw, relu):
    rxa, rx = int(lw["rxa"]), int(lw["rx"])
    zx = (zx + ((1 << rxa) >> 1)) >> rxa
    zx = (zx * int(lw["mx"]) + ((1 << rx) >> 1)) >> rx
    return _requant_np(zf + zx, lw, relu=relu)


def pppf_pmf_weights_np(bundle, rec_xyz) -> np.ndarray:
    """Numpy reference of the PPPF integer spec: [B, S, 3] f32 skeleton ->
    [B, S, d, L] int32 Q16 softmax weights."""
    B, S, _ = rec_xyz.shape
    d, L = int(bundle["d"]), int(bundle["L"])
    xq = np.round(np.asarray(rec_xyz, np.float32)
                  * float(1 << Q_IN)).astype(np.int32)
    sel = _selection_np(xq)
    cur, feat = xq, None
    for j, ((fidx, gidx), st) in enumerate(zip(sel, _STAGES), start=1):
        gx = _gather_np(cur, gidx)                         # [B, np, K, 3]
        if feat is None:
            a, i0 = gx, 0
        else:
            gf = _gather_np(feat, gidx)
            lw = bundle[f"sa{j}_0"]
            zf = _imm_np(gf, lw["w"])
            zx = _imm_np(gx, lw["wx"])
            a, i0 = _split_requant_np(zf, zx, lw, relu=True), 1
        for i in range(i0, len(st["width"])):
            lw = bundle[f"sa{j}_{i}"]
            a = _requant_np(_imm_np(a, lw["w"]), lw, relu=True)
        feat = a.max(axis=2)
        cur = cur if fidx is None else np.take_along_axis(
            cur, fidx[..., None], axis=1)
    g = feat.max(axis=1)                                   # [B, 1024]
    feat_t = np.repeat(g[:, None, :], S, axis=1).reshape(B * S, -1)
    lw = bundle["mlp0"]
    zf = _imm_np(feat_t, lw["w"])
    zx = _imm_np(xq.reshape(B * S, 3), lw["wx"])
    a = _split_requant_np(zf, zx, lw, relu=True)
    for i in (1, 2):
        lw = bundle[f"mlp{i}"]
        a = _requant_np(_imm_np(a, lw["w"]), lw, relu=(i < 2))
    return _softmax_weights_np(a.reshape(B, S, d, L))


def pppf_pmf_weights(dev_bundle, rec_xyz: torch.Tensor) -> torch.Tensor:
    """Torch twin of pppf_pmf_weights_np on the bundle's device
    (iprob.bundle_to_device): [B, S, 3] f32 -> [B, S, d, L] int32 Q16
    weights, bit-equal to the numpy spec and to pcc_tpu on any device.
    Dense layers are iprob.py's exact float32 products of int7 operands
    (sums of up to 1024 terms stay below 2^24; TF32 must be off)."""
    B, S, _ = rec_xyz.shape
    d, L = dev_bundle["d"], dev_bundle["L"]
    xq = torch.round(rec_xyz.to(torch.float32) * float(1 << Q_IN)).to(torch.int32)
    cur, feat = xq, None
    for j, st in enumerate(_STAGES, start=1):
        n_src = cur.shape[1]
        q = _qsel(n_src)
        xs = cur >> (Q_IN - q)
        if st["npoint"] == n_src:
            fidx, cs = None, xs
        else:
            fidx = _int_fps(xs, st["npoint"], 3 * (4 ** q) + 1)[..., None].expand(-1, -1, 3)
            cs = torch.gather(xs, 1, fidx)
        r = int(round(st["radius"] * (1 << q)))
        gidx = _int_ball(cs, xs, st["K"], r * r, n_src)
        gx = knn_gather(cur, gidx)                         # [B, np, K, 3]
        if feat is None:
            a, i0 = gx, 0
        else:
            lw = dev_bundle[f"sa{j}_0"]
            a, i0 = _split_requant(_exact_int_matmul(knn_gather(feat, gidx), lw["w"]),
                                   _exact_int_matmul(gx, lw["wx"]), lw, relu=True), 1
        for i in range(i0, len(st["width"])):
            lw = dev_bundle[f"sa{j}_{i}"]
            a = _requant(_exact_int_matmul(a, lw["w"]), lw, relu=True)
        feat = a.amax(dim=2)
        cur = cur if fidx is None else torch.gather(cur, 1, fidx)
    g = feat.amax(dim=1)                                   # [B, 1024]
    feat_t = g[:, None, :].expand(B, S, g.shape[-1]).reshape(B * S, -1)
    lw = dev_bundle["mlp0"]
    a = _split_requant(_exact_int_matmul(feat_t, lw["w"]),
                       _exact_int_matmul(xq.reshape(B * S, 3), lw["wx"]), lw, relu=True)
    for i in (1, 2):
        lw = dev_bundle[f"mlp{i}"]
        a = _requant(_exact_int_matmul(a, lw["w"]), lw, relu=(i < 2))
    return softmax_weights(a.reshape(B, S, d, L), dev_bundle["lut"])
