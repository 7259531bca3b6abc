"""PyTorch port (pcc_tpu_torch) vs pcc_tpu: the PPPF-AE train step on the
CPU, at the tiny config CodecConfig(N=64, N0=64, K=32, d=4,
model="PPPF-AE") (full model widths, S = 4 patches of 32 points), with the
port's seeded weights and live BatchNorm statistics carried to pcc_tpu by
weights.to_jax_params and the same numpy clouds.

  * the stage backward (pppf_sa_trainable on CPU tensors, i.e.
    pppf_sa_bwd_plain) against jax.vjp through pcc_tpu's
    pppf_sa_trainable, whose backward is the Pallas kernel under the
    interpreter: every gradient within 1e-4 * max(|ref|, 1), the bar of
    tests/test_pppf_sa_pallas.py;
  * max-pool ties, port only: every max routed to the first winning slot,
    as a brute-force per-slot reference routes it;
  * train-mode BatchNorm (flax's semantics) in both models' PN++ backbones,
    in float64: outputs, gradients and the updated running statistics
    against pcc_tpu's apply(train=True, mutable=["batch_stats"]);
  * one warm-up step against pcc_tpu's jitted pppf_forward + Adam update
    (what its build_pppf_train_step runs), in float32;
  * the fused step at lam = 0: the AE's loss and gradients against
    pcc_tpu's pppf_forward with train=False (frozen BatchNorm, the fused
    encoder's semantics), and the probability model's running statistics
    still updating;
  * the forward's chamfer through the chamfer kernels' plain versions;
  * the train CLI with --model PPPF-AE: both step kinds, checkpoints with
    batch_stats that pcc_tpu reads, resume.
Every JAX call is jitted; two interpret-mode kernel runs. Each test states
its tolerance and why.
"""

import copy
import functools
import glob
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcc_tpu.config import CodecConfig as JCodecConfig
from pcc_tpu.models.pppf import PointNetPP as JPointNetPP
from pcc_tpu.ops.pppf_sa_pallas import pppf_sa_trainable as j_pppf_sa_trainable
from pcc_tpu.train.state import make_optimizer as j_make_optimizer
from pcc_tpu.train.steps_pppf import PPPFTrainState
from pcc_tpu.train.steps_pppf import pppf_forward as j_pppf_forward
from pcc_tpu_torch.config import CodecConfig
from pcc_tpu_torch.io import save_point_cloud
from pcc_tpu_torch.models.layers import torch_dense_init_
from pcc_tpu_torch.models.pppf import PointNetPP
from pcc_tpu_torch.ops.knn import ball_query, knn_gather
from pcc_tpu_torch.ops.pppf_sa_cuda import (pppf_sa_bwd_plain, pppf_sa_plain,
                                            pppf_sa_trainable, stack_replay)
from pcc_tpu_torch.train import build_pppf_train_step, create_train_state
from pcc_tpu_torch.train.state import make_optimizer
from pcc_tpu_torch.train.steps_pppf import pppf_forward
from pcc_tpu_torch.weights import _pnpp_to_jax, to_jax_params
from test_torch_port_pppf import _live_stats, one_thread_per_worker  # noqa: F401

KW = dict(N=64, N0=64, ALPHA=2, K=32, d=4, L=7, model="PPPF-AE")
TINY, JTINY = CodecConfig(**KW), JCodecConfig(**KW)
B = 1


def _stage_layers(rng, widths):
    """(W, b, mean, mul, beta) per layer, numpy float32: live statistics,
    about a quarter of the multipliers negative."""
    out = []
    for cin, cout in zip(widths[:-1], widths[1:]):
        bound = cin ** -0.5
        sign = np.where(rng.random(cout) < 0.25, -1.0, 1.0)
        out.append(tuple(a.astype(np.float32) for a in (
            (rng.random((cin, cout)) * 2 - 1) * bound,
            (rng.random(cout) * 2 - 1) * bound,
            rng.standard_normal(cout) * 0.1,
            (rng.random(cout) + 0.5) * sign,
            (rng.random(cout) - 0.3) * 0.2)))
    return out


# --------------------------------------------------------- stage backward --


@pytest.mark.parametrize("npoint,radius,nsample,mlp,N,C", [
    (64, 0.2, 8, (3, 16, 16, 32), 64, 0),      # sa1 shape (npoint == N)
    (32, 0.4, 16, (24, 16, 32), 64, 21),       # sa2 shape (FPS + features)
])
def test_stage_backward_matches_pallas_interpret(npoint, radius, nsample, mlp, N, C):
    rng = np.random.default_rng(7)
    P = 4
    xyz = rng.random((P, N, 3)).astype(np.float32)
    new_xyz = xyz if npoint == N else np.ascontiguousarray(xyz[:, rng.permutation(N)[:npoint]])
    feat = rng.random((P, N, C)).astype(np.float32) if C else None
    layers = _stage_layers(rng, (C + 3,) + mlp)
    g = rng.standard_normal((P, npoint, mlp[-1])).astype(np.float32)

    def stage(nx, x, f, lays):
        return j_pppf_sa_trainable(nx, x, f, lays, nsample=nsample, radius=radius,
                                   interpret=True)

    jl = tuple(tuple(jnp.asarray(a) for a in lay) for lay in layers)
    args = (jnp.asarray(new_xyz), jnp.asarray(xyz), None if feat is None else jnp.asarray(feat))
    out_ref, vjp = jax.vjp(stage, *args, jl)
    d_new, d_xyz, d_feat, d_lay = jax.jit(vjp)(jnp.asarray(g))

    t = torch.from_numpy
    x = t(xyz.copy()).requires_grad_(True)
    nx = x if npoint == N else t(new_xyz)
    f = None if feat is None else t(feat).requires_grad_(True)
    lays = [tuple(t(a).requires_grad_(True) for a in lay) for lay in layers]
    out = pppf_sa_trainable(nx, x, f, lays, nsample=nsample, radius=radius)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref), atol=1e-5, rtol=0)
    out.backward(t(g))

    def close(a, b):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, atol=1e-4 * max(np.abs(b).max(), 1.0), rtol=0)

    assert float(np.abs(np.asarray(d_xyz)).max()) > 1e-3
    close(x.grad.numpy(), d_xyz)
    assert not np.asarray(d_new).any()
    if feat is not None:
        close(f.grad.numpy(), d_feat)
    for lay, ref in zip(lays, d_lay):
        assert lay[2].grad is None and not np.asarray(ref[2]).any()     # mean
        for i in (0, 1, 3, 4):                                          # W, b, mul, beta
            close(lay[i].grad.numpy(), ref[i])


def test_stage_backward_routes_ties_to_first_slot():
    """Every point of a patch has an exact duplicate and many slots lie
    beyond the radius (copies of point 0): most maxima are exact ties
    between distinct points. The plain backward routes each to the first
    slot in selection order; a brute-force reference builds the same
    routing slot by slot, while amax-based autograd would split it."""
    rng = np.random.default_rng(3)
    P, N, S, C, nsample, radius = 3, 32, 12, 5, 12, 0.3
    half = rng.random((P, N // 2, 3 + C)).astype(np.float32)
    rows = np.concatenate([half, half], axis=1)
    xyz, feat = torch.from_numpy(rows[..., C:].copy()), torch.from_numpy(rows[..., :C].copy())
    new_xyz = xyz[:, :S].clone()
    layers = [tuple(torch.from_numpy(a) for a in lay)
              for lay in _stage_layers(rng, (C + 3, 16, 24))]
    g = torch.from_numpy(rng.standard_normal((P, S, 24)).astype(np.float32))
    dxyz, dfeat, dl = pppf_sa_bwd_plain(new_xyz, xyz, feat, g, layers, nsample=nsample,
                                        radius=radius)

    idx = ball_query(new_xyz, xyz, nsample, radius)                   # [P, S, ns]
    grouped = knn_gather(torch.cat([feat, xyz], dim=-1), idx)         # [P, S, ns, C + 3]
    vals = stack_replay(grouped, layers)[-1]
    win = torch.zeros(vals.shape, dtype=torch.bool)                   # brute force
    ties = 0
    for p in range(P):
        for s in range(S):
            for c in range(24):
                col = vals[p, s, :, c]
                top = col.max()
                first = int(np.flatnonzero((col == top).numpy())[0])
                win[p, s, first, c] = bool(top > 0)
                ties += int(len(set(idx[p, s, col == top].tolist())) > 1)
    assert ties > 50
    leaves = [t.clone().requires_grad_(True) for lay in layers for t in lay]
    xf = torch.cat([feat, xyz], dim=-1).requires_grad_(True)
    h = knn_gather(xf, idx)
    for i in range(len(layers)):
        w, b, mean, mul, beta = leaves[5 * i:5 * i + 5]
        h = torch.relu(((h @ w + b) - mean) * mul + beta)
    (h * win * g[:, :, None, :]).sum().backward()
    torch.testing.assert_close(dxyz, xf.grad[..., C:], atol=1e-5, rtol=0)
    torch.testing.assert_close(dfeat, xf.grad[..., :C], atol=1e-5, rtol=0)
    for i, (dw, db, dmul, dbeta) in enumerate(dl):
        for got, leaf in zip((dw, db, dmul, dbeta), (leaves[5 * i], leaves[5 * i + 1],
                                                     leaves[5 * i + 3], leaves[5 * i + 4])):
            torch.testing.assert_close(got, leaf.grad, atol=1e-5, rtol=0)
    # amax-based autograd splits the tied gradients, so it differs
    x2 = xyz.clone().requires_grad_(True)
    pppf_sa_plain(new_xyz, x2, feat, layers, nsample=nsample, radius=radius).backward(g)
    assert float((x2.grad - dxyz).abs().max()) > 1e-3


# ---------------------------------------------------- train-mode BatchNorm --


def _f64_close(a, b, what):
    # max(., 1): a conv bias before batch statistics has a zero gradient
    assert np.abs(a - b).max() <= 1e-6 * max(np.abs(b).max(), 1.0), what


@pytest.mark.parametrize("model", ["encoder", "probability_model"])
def test_train_mode_batchnorm_matches_flax(model):
    """Both models' PN++ backbones in train mode (batch statistics) against
    pcc_tpu's apply(train=True, mutable=["batch_stats"]), in float64: the
    global feature, the gradients of a loss on it and the updated running
    statistics (flax's momentum 0.99, biased variance), to 1e-6 of each
    tensor's largest entry. A small encoder; the probability model's at full
    width on an 8-point skeleton, whose 512 FPS queries are mostly copies of
    one point (its batch variances cancel so far that even float64 keeps
    only about 9 digits: 3e-9 measured). float64, because the fast variance mean(h^2) - mean^2 of such
    batches cancels: at the step tests' config pcc_tpu's own float32 encoder
    feature is about 1e-2 (relative) off its float64 value, the port's about
    2e-5, so a float32 comparison would measure pcc_tpu's rounding."""
    rng = np.random.default_rng(4)
    if model == "encoder":
        kw = dict(points=64, sa1_mlp=(16, 16, 32), sa2_mlp=(32, 32, 64), sa3_mlp=(64, 64),
                  feature_dim=32)
        xyz = rng.random((2, 64, 3)) * 0.6 - 0.3
    else:   # PPPFConditionalProbabilityModel.model_pnpp
        kw = dict(sa1_mlp=(64, 64, 128), sa2_mlp=(128, 128, 256), sa3_mlp=(256, 512, 1024),
                  feature_dim=1024)
        xyz = rng.random((1, 8, 3))
    net, jnet = PointNetPP(**kw), JPointNetPP(**kw)
    torch_dense_init_(net, torch.Generator().manual_seed(1))
    net.load_state_dict(_live_stats(net.state_dict(), 2))
    net.double().train()
    params, stats = _pnpp_to_jax(net.state_dict(), "")
    g = rng.standard_normal((xyz.shape[0], kw["feature_dim"]))

    def loss(p, x):
        (_, feature), mut = jnet.apply({"params": p, "batch_stats": stats}, x, True,
                                       mutable=["batch_stats"])
        return jnp.sum(feature * g), (feature, mut["batch_stats"])

    with jax.enable_x64(True):
        (_, (ref, new_stats)), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(xyz))
        ref, new_stats, gp, gx = jax.tree.map(np.asarray, (ref, new_stats, gp, gx))
    assert ref.dtype == np.float64

    x = torch.from_numpy(xyz).requires_grad_(True)
    _, feature = net(x)
    _f64_close(feature.detach().numpy(), ref, "feature")
    (feature * torch.from_numpy(g)).sum().backward()
    _f64_close(x.grad.numpy(), gx, "input")
    ours_s = _pnpp_to_jax(net.state_dict(), "")[1]
    grads = _pnpp_to_jax(dict(net.state_dict()) | {k: p.grad for k, p in
                                                   net.named_parameters()}, "")[0]
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(grads),
                                 jax.tree_util.tree_leaves_with_path(gp)):
        _f64_close(a, b, jax.tree_util.keystr(path))
    for (path, a), (_, b), (_, old) in zip(jax.tree_util.tree_leaves_with_path(ours_s),
                                           jax.tree_util.tree_leaves_with_path(new_stats),
                                           jax.tree_util.tree_leaves_with_path(stats)):
        _f64_close(a, b, jax.tree_util.keystr(path))
        assert not np.array_equal(a, old)


# --------------------------------------------------------------- the steps --


@pytest.fixture(scope="module")
def setup():
    """A CPU train state with seeded weights and live BatchNorm statistics,
    the same numbers as pcc_tpu trees, a cloud, and the FPS starts
    jax.random.randint draws inside pcc_tpu's pppf_forward. The decoder's
    last layer is scaled up 30 times so that a patch's decoded points do not
    crowd together: chamfer's nearest neighbours then near-tie among them,
    and its gradients, summed over a patch, cancel to a few bits in either
    package."""
    tx = make_optimizer(1e-3, 0.1, 100, 100)
    state = create_train_state(0, TINY, tx, device="cpu")
    state.ae.load_state_dict(_live_stats(state.ae.state_dict(), 3))
    state.prob.load_state_dict(_live_stats(state.prob.state_dict(), 4))
    with torch.no_grad():
        state.ae.decoder.mlp2[4].weight.mul_(30.0)
        state.ae.decoder.mlp2[4].bias.mul_(30.0)
    ae_vars, prob_vars = to_jax_params(state.ae.state_dict(), state.prob.state_dict())
    batch = (np.random.default_rng(11).random((B, TINY.N, 3)) * 4 - 1).astype(np.float32)
    key = jax.random.key(7)
    starts = np.array(jax.random.randint(key, (B,), 0, TINY.N, dtype=jnp.int32))
    return tx, state, ae_vars, prob_vars, batch, key, starts


def _port_trees(state, grads: bool):
    """(ae, prob) pcc_tpu trees of the state's parameters (or their
    gradients) and running statistics."""
    def sd(model):
        out = dict(model.state_dict())
        if grads:
            out.update({k: p.grad for k, p in model.named_parameters()})
        return out
    return to_jax_params(sd(state.ae), sd(state.prob))


def _assert_close(ours, ref, rel, keep=lambda path: True):
    """Every leaf (whose path `keep` accepts) within rel of the largest
    entry of pcc_tpu's; returns how many were compared."""
    n = 0
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(ours),
                                 jax.tree_util.tree_leaves_with_path(ref)):
        name = jax.tree_util.keystr(path)
        if keep(name):
            b = np.asarray(b)
            assert np.abs(a - b).max() <= rel * np.abs(b).max(), name
            n += 1
    return n


def test_warmup_step_matches_pcc_tpu(setup):
    """One warm-up step against pcc_tpu's jitted pppf_forward (train=True)
    and optax Adam update, which is its build_pppf_train_step. lam = 0 and
    rate_mode "fixed": the loss to 1e-5 relative; the gradients of the
    decoder and dec_proj, which no batch statistic reaches, within 1e-5 of
    each tensor's largest entry, their updated parameters to 2e-6; every running
    statistic of both models updated on both sides. The encoder's,
    enc_proj's and the probability model's float32 gradients and statistics
    run through batch statistics whose float32 values pcc_tpu itself gets
    only to about 1e-2 here (test_train_mode_batchnorm_matches_flax holds
    them in float64)."""
    tx, state, ae_vars, prob_vars, batch, key, starts = setup
    state = copy.deepcopy(state)
    params = {"ae": ae_vars["params"], "prob": prob_vars["params"]}
    stats = {"ae": ae_vars["batch_stats"], "prob": prob_vars["batch_stats"]}
    (j_loss, (j_aux, j_stats)), j_grads = jax.jit(jax.value_and_grad(
        functools.partial(j_pppf_forward, cfg=JTINY, rate_mode="fixed"), has_aux=True))(
        params, stats, jnp.asarray(batch), key, 0.0)
    j_tx = j_make_optimizer(1e-3, 0.1, 100, 100)
    j_state = jax.jit(lambda p, g: PPPFTrainState(p, stats, j_tx.init(p), 0).apply_gradients(
        g, j_tx))(params, j_grads)

    step = build_pppf_train_step(TINY, tx, rate_mode="fixed")
    _, aux = step(state, torch.from_numpy(batch), torch.from_numpy(starts), 0.0)
    np.testing.assert_allclose(float(aux["loss"]), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(float(aux["chamfer"]), float(j_aux["chamfer"]), rtol=1e-5)
    g_ae, _ = _port_trees(state, grads=True)
    ae_now, prob_now = _port_trees(state, grads=False)

    def decoder(name):
        return name.startswith(("['dec_proj']", "['decoder']"))

    assert _assert_close(g_ae["params"], j_grads["ae"], 1e-5, decoder) == 14
    # Adam's first update is about lr * sign(g); where |g| is near its eps
    # (1e-8) the update follows g's last bits: atol 2e-6 = 2e-3 * lr
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(ae_now["params"]),
                                 jax.tree_util.tree_leaves_with_path(j_state.params["ae"])):
        if decoder(jax.tree_util.keystr(path)):
            np.testing.assert_allclose(a, np.asarray(b), atol=2e-6, rtol=0)
    for ours, ref, old in ((ae_now["batch_stats"], j_stats["ae"], stats["ae"]),
                           (prob_now["batch_stats"], j_stats["prob"], stats["prob"])):
        for a, b, c in zip(jax.tree.leaves(ours), jax.tree.leaves(ref), jax.tree.leaves(old)):
            assert not np.array_equal(a, c) and not np.array_equal(np.asarray(b), c)


@pytest.fixture(scope="module")
def j_frozen(setup):
    """pcc_tpu's jitted pppf_forward with train=False (frozen BatchNorm) at
    lam 0 on setup's cloud: ((loss, aux), grads), computed once for the
    tests that read it."""
    _, _, ae_vars, prob_vars, batch, key, _ = setup
    params = {"ae": ae_vars["params"], "prob": prob_vars["params"]}
    stats = {"ae": ae_vars["batch_stats"], "prob": prob_vars["batch_stats"]}
    return jax.jit(jax.value_and_grad(
        functools.partial(j_pppf_forward, cfg=JTINY, train=False), has_aux=True))(
        params, stats, jnp.asarray(batch), key, 0.0)


def test_fused_step_matches_frozen_batchnorm(setup, j_frozen):
    """lam = 0, so the loss does not depend on the probability model: the
    fused step's loss to 1e-5 relative and every AE gradient within 1e-4 of
    its tensor's largest entry, against pcc_tpu's pppf_forward with
    train=False (BatchNorm on the running statistics, which is what the
    fused encoder differentiates). 1e-4, not 1e-5: the port routes each
    max over slots by the kernel's float32 arithmetic, XLA by its own, and
    near-ties resolve differently (5e-5 measured). The encoder's running
    statistics stay, the probability model's move."""
    tx, state, ae_vars, prob_vars, batch, _, starts = setup
    state = copy.deepcopy(state)
    stats = {"ae": ae_vars["batch_stats"], "prob": prob_vars["batch_stats"]}
    (j_loss, _), j_grads = j_frozen

    step = build_pppf_train_step(TINY, tx, fused=True)
    _, aux = step(state, torch.from_numpy(batch), torch.from_numpy(starts), 0.0)
    np.testing.assert_allclose(float(aux["loss"]), float(j_loss), rtol=1e-5)
    g_ae, g_prob = _port_trees(state, grads=True)
    assert _assert_close(g_ae["params"], j_grads["ae"], 1e-4) == 64
    assert not any(np.asarray(x).any() for x in jax.tree.leaves(g_prob["params"]))
    ae_now, prob_now = _port_trees(state, grads=False)
    for a, b in zip(jax.tree.leaves(ae_now["batch_stats"]), jax.tree.leaves(stats["ae"])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(prob_now["batch_stats"]), jax.tree.leaves(stats["prob"])):
        assert not np.array_equal(a, b)
    # pppf_forward is the step's forward
    loss, _ = pppf_forward(state.ae, state.prob, torch.from_numpy(batch),
                           torch.from_numpy(starts), 0.0, TINY, fused=True)
    assert torch.isfinite(loss)


def test_pppf_forward_takes_the_chamfer_kernels(setup, j_frozen, monkeypatch):
    """At this config the loss compares [1, 64, 3] decoded points (4 patches
    of d * d = 16) with the [1, 64, 3] input, inside the chamfer kernels'
    domain: pppf_forward calls chamfer_min_dists once (on the CPU their
    plain versions), and its loss equals pcc_tpu's frozen-BatchNorm forward
    to 1e-5 relative, the bar of test_fused_step_matches_frozen_batchnorm."""
    from pcc_tpu_torch.ops import chamfer

    _, state, _, _, batch, _, starts = setup
    (j_loss, _), _ = j_frozen
    shapes = []
    routed = chamfer.chamfer_min_dists
    monkeypatch.setattr(chamfer, "chamfer_min_dists",
                        lambda x, y: shapes.append((x.shape, y.shape)) or routed(x, y))
    state = copy.deepcopy(state)
    loss, _ = pppf_forward(state.ae, state.prob, torch.from_numpy(batch),
                           torch.from_numpy(starts), 0.0, TINY, fused=True)
    assert shapes == [((B, TINY.S * TINY.d * TINY.d, 3), (B, TINY.N, 3))]
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-5)


# ------------------------------------------------------------------ the CLI --


def test_train_cli_pppf(tmp_path):
    """One warm-up step and one fused step; the checkpoints carry
    batch_stats, pcc_tpu's load_inference_params reads them, and a resumed
    run restores the running statistics."""
    from pcc_tpu.train.checkpoint import load_inference_params
    from pcc_tpu_torch.cli import train

    rng = np.random.default_rng(3)
    inp, model = tmp_path / "in", tmp_path / "model"
    save_point_cloud((rng.random((TINY.N, 3)) * 2 - 1).astype(np.float32), "c0.ply",
                     path=str(inp))
    flags = ["--train_glob", str(inp / "*.ply"), "--model_save_folder", str(model),
             "--N", "64", "--N0", "64", "--K", "32", "--d", "4", "--batch_size", "1",
             "--step_window", "1", "--model", "PPPF-AE", "--bn_warmup_steps", "1",
             "--device", "cpu"]
    train.main(flags + ["--max_steps", "2"])
    names = sorted(os.path.basename(f) for f in glob.glob(str(model / "*.pkl")))
    assert names == sorted(
        [f"{m}_step{s}.pkl" for m in ("ae", "prob", "optimizer", "global")
         for s in ("1", "2", "")] + ["ae.pkl", "prob.pkl"])
    ae, prob = load_inference_params(str(model))
    assert set(ae) == set(prob) == {"params", "batch_stats"}
    # the warm-up step moved the running statistics off BatchNorm's defaults
    var = ae["batch_stats"]["encoder"]["sa1"]["mlp"]["bn_0"]["var"]
    assert not np.array_equal(var, np.ones_like(var))

    with open(model / "ae_step2.pkl", "rb") as f:
        saved = pickle.load(f)
    train.main(flags + ["--max_steps", "3"])   # resumes at step 3: no step, saves what it loaded
    resumed, _ = load_inference_params(str(model))
    for a, b in zip(jax.tree.leaves(saved), jax.tree.leaves(resumed)):
        np.testing.assert_array_equal(a, b)
