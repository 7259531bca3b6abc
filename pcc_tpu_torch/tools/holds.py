"""Holds for bf16 results that a right port cannot match bit for bit.

A bf16 step rounds where float32 would not, so a float32 sum taken in
another order flips a bf16 rounding now and then, and what follows carries
the flip. Two places make that large enough that a bound on the largest
entry either fails a right port or passes a wrong one:

  * spread_hold: the gradients of a train step on batch statistics in
    bf16. The BatchNorm backward adds two cotangents that are each rounded
    to bf16 and nearly cancel (flax's bf16 BatchNorm), so one flipped
    rounding upstream moves a gradient by a large part of itself. The
    reference is then noisy against itself: the same step on the same
    clouds in another batch order (the same function, other summation
    orders) moves it as far. Each gradient is held to the reference by the
    reference's own spread over such reorderings, and by its scale and
    direction. shaped_clouds and steady_symbols make inputs on which that
    spread is small.
  * row_hold: a bf16 stage backward's row gradients (dxyz, dfeat) against
    its plain version on the same stored forward. Each slot's cotangent is
    rounded before its product (pppf_sa_bwd_plain_bf16), and a
    float32 sum of the layer above taken in another order flips one of
    those roundings now and then, moving that slot's share of its point's
    row by one bf16 step. Each row is held to its own largest entry; most
    rows must agree to float32 rounding. `regrouped_rows` is the control
    that such a hold must fail: the cotangent summed per point before each
    rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from pcc_tpu_torch.ops.bf16 import round_bf16
from pcc_tpu_torch.ops.knn import ball_query, knn_gather
from pcc_tpu_torch.ops.pppf_sa_cuda import (PLAIN_ELEMS, _scatter_points, bf16_points_forward,
                                            first_winners, saved_views)

# spread_hold: a gradient's distance from the reference (l2, over the
# reference's norm) at most LEAF_X times the reference's own largest
# distance under a reordering, plus FLOOR; the median of those distances at
# most SPREAD_X times the median of the reference's own; each norm within
# RATIO of the reference's (leaves that are 0 in exact arithmetic, as a
# bias before batch statistics, excepted) and their median within
# MEDIAN_RATIO; the mean cosine with the reference at most COS_SLACK below
# the reference's own lowest against its reorderings.
LEAF_X = 4.0
SPREAD_X = 2.0
FLOOR = 2.0 ** -6
RATIO = 2.0
MEDIAN_RATIO = 1.25
COS_SLACK = 0.1
# row_hold: a row within ROW_F32 of its largest |entry| agrees to float32
# rounding; at least ROW_SHARE of the rows must, and every row within
# ROW_TOL (a few flipped roundings of a slot's cotangent, 2^-8 of that
# slot's share each); rows the plain version leaves at 0 stay within
# ROW_F32 of the tensor's largest entry.
ROW_F32 = 1e-4
ROW_SHARE = 0.9
ROW_TOL = 2.0 ** -5


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().double().numpy()
    return np.asarray(a, np.float64).ravel()


def _cos(a: np.ndarray, b: np.ndarray) -> float:
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    return float(a @ b / (na * nb)) if na and nb else float(na == nb)


def spread_hold(ours: dict, ref: dict, others: list, noise=()) -> tuple:
    """Gradients `ours` {name: array} held to the reference's `ref` by the
    spread of `others`, the reference's gradients of the same step in other
    batch orders (module docstring). `noise`: names of leaves that are 0 in
    exact arithmetic, whose norm is not held. Returns (failures, figures):
    a list of what failed, empty when the hold passes, and per-leaf and
    median figures."""
    fails, leaves = [], {}
    for k, r in ref.items():
        r, p = _np(r), _np(ours[k])
        n = np.linalg.norm(r)
        if not n:
            if np.linalg.norm(p):
                fails.append(f"{k}: 0 in the reference, |ours| {np.linalg.norm(p):.3g}")
            continue
        os_ = [_np(o[k]) for o in others]
        leaves[k] = dict(e=np.linalg.norm(p - r) / n,
                         s=max(np.linalg.norm(o - r) for o in os_) / n,
                         rho=np.linalg.norm(p) / n, cos=_cos(p, r),
                         cos_self=min(_cos(o, r) for o in os_))
    for k, f in leaves.items():
        if f["e"] > LEAF_X * f["s"] + FLOOR:
            fails.append(f"{k}: {f['e']:.3g} from the reference, its own spread {f['s']:.3g}")
        if k not in noise and not 1 / RATIO <= f["rho"] <= RATIO:
            fails.append(f"{k}: norm {f['rho']:.3g} of the reference's")
    med = {key: float(np.median([f[key] for f in leaves.values()])) for key in ("e", "s")}
    med["rho"] = float(np.median([f["rho"] for k, f in leaves.items() if k not in noise]))
    mean_cos = float(np.mean([f["cos"] for f in leaves.values()]))
    mean_cos_self = float(np.mean([f["cos_self"] for f in leaves.values()]))
    if med["e"] > SPREAD_X * med["s"] + FLOOR:
        fails.append(f"median distance {med['e']:.3g}, the reference's own {med['s']:.3g}")
    if not 1 / MEDIAN_RATIO <= med["rho"] <= MEDIAN_RATIO:
        fails.append(f"median norm {med['rho']:.3g} of the reference's")
    if mean_cos < mean_cos_self - COS_SLACK:
        fails.append(f"mean cosine {mean_cos:.3g}, the reference's own {mean_cos_self:.3g}")
    return fails, dict(median=med, mean_cos=mean_cos, mean_cos_self=mean_cos_self,
                       leaves=leaves)


def shaped_clouds(n: int, N: int, seed: int) -> np.ndarray:
    """n clouds of N points in [0, 1]^3 from a numpy seed, four shapes in
    turn: the cube, a slab 0.05 thick, a cube of side 0.25 and a sphere.
    Clouds that differ in shape keep the cotangents that reach PPPE's
    global_conv BatchNorm over the batch apart, so that its backward
    carries more than rounding noise."""
    rng = np.random.default_rng(seed)
    u = rng.random((n, N, 3))
    shell = rng.standard_normal((n, N, 3))
    shell = 0.5 + 0.45 * shell / np.linalg.norm(shell, axis=2, keepdims=True)
    shapes = (lambda i: u[i], lambda i: u[i] * [1.0, 1.0, 0.05],
              lambda i: 0.6 + 0.25 * u[i], lambda i: shell[i])
    return np.stack([shapes[i % 4](i) for i in range(n)]).astype(np.float32)


def steady_symbols(model, seed: int) -> None:
    """PPPE's latent head (encoder.global_conv.3) at its weights / 8 with
    integer biases from a seed, in place: every latent near the middle of a
    bin, so that no rounding noise between two runs moves a symbol (a moved
    symbol moves the decoder's input by a whole bin)."""
    head = model.encoder.global_conv[3]
    bins = np.random.default_rng(seed).integers(1, model.latent_bins - 1, head.bias.shape[0])
    with torch.no_grad():
        head.weight.mul_(0.125)
        head.bias.copy_(torch.from_numpy(bins.astype(np.float32)))


def row_hold(ours: torch.Tensor, plain: torch.Tensor) -> tuple:
    """Row gradients [..., C] held to the plain version's row by row
    (module docstring). Returns (failures, figures)."""
    a = ours.detach().reshape(-1, ours.shape[-1]).double()
    b = plain.detach().reshape(-1, plain.shape[-1]).double()
    scale, err = b.abs().amax(1), (a - b).abs().amax(1)
    zero = scale == 0
    rel = err[~zero] / scale[~zero]
    fig = dict(rows=int((~zero).sum()), zero_rows=int(zero.sum()),
               share_f32=float((rel <= ROW_F32).double().mean()) if len(rel) else 1.0,
               worst=float(rel.max()) if len(rel) else 0.0)
    fails = []
    stray = err[zero] > ROW_F32 * float(scale.max())
    if bool(stray.any()):
        fails.append(f"{int(stray.sum())} rows 0 in the plain version are not")
    if fig["share_f32"] < ROW_SHARE:
        fails.append(f"{fig['share_f32']:.4f} of the rows within {ROW_F32} of their largest "
                     f"entry, want {ROW_SHARE}")
    if fig["worst"] > ROW_TOL:
        fails.append(f"a row {fig['worst']:.3g} of its largest entry apart, limit {ROW_TOL}")
    return fails, fig


def regrouped_rows(new_xyz: torch.Tensor, xyz: torch.Tensor, feat, gout: torch.Tensor,
                   layers, *, nsample: int, radius: float, saved=None):
    """The control of row_hold: ops/pppf_sa_cuda.py::pppf_sa_bwd_plain_bf16's
    row gradients (dxyz, dfeat or None) with the cotangent carried per
    point, each point's slots summed before every rounding: round(sum dz) @
    W^T where the bf16 backward takes sum round(dz) @ W^T. Exact in real
    arithmetic, not pcc_tpu's function in bf16. The forward as the plain
    version takes it: the store mode's `saved`, or recomputed."""
    P, S, _ = new_xyz.shape
    N = xyz.shape[1]
    widths = [3 + (0 if feat is None else feat.shape[-1])] + [w.shape[1] for w, *_ in layers]
    if saved is None:
        idx = ball_query(new_xyz, xyz, nsample, radius)
        xs, _ = bf16_points_forward(xyz, feat, layers)
    else:
        idx, xs, _ = saved_views(saved, P, S, N, nsample, widths)
    idx = idx.long()
    out = gout.new_zeros((P, N, widths[0]))
    chunk = max(1, PLAIN_ELEMS // (S * nsample * max(widths)))
    for s0 in range(0, P, chunk):
        sl, ids = slice(s0, s0 + chunk), idx[s0:s0 + chunk]
        vals = knn_gather(xs[-1][sl], ids)
        first, live = first_winners(vals)
        g = torch.zeros_like(vals).scatter_(2, first[:, :, None],
                                            torch.where(live, gout[sl], 0.0)[:, :, None])
        g = _scatter_points(g, ids, N)                                    # per point
        for l in range(len(layers) - 1, -1, -1):
            w, _, _, mul, _ = layers[l]
            if l < len(layers) - 1:
                g = g * (xs[l + 1][sl] > 0)
            g = round_bf16(g * mul) @ w.t()
        out[sl] = g
    g = out
    C = widths[0] - 3
    return g[..., C:].contiguous(), (g[..., :C].contiguous() if feat is not None else None)
