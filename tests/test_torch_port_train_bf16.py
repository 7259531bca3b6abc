"""PyTorch port (pcc_tpu_torch) vs pcc_tpu: the IPDAE train step in bf16
mixed precision (train --bf16, CodecConfig(compute_dtype="bfloat16")) on the
CPU, at the TINY config of tests/test_torch_port_train.py, pcc_tpu's random
weights carried across by weights.from_jax_params, the same numpy clouds.

pcc_tpu trains its encoder through the fused Pallas kernels (fused_sa,
here under the interpreter: PCC_PALLAS_INTERPRET=1 while its programs are
traced), the decoder and the probability model on flax's bf16 Dense:
  * flax_dense's gradient rules (ops/bf16.py) against jax.grad of flax's
    Dense(dtype=bfloat16), jitted;
  * the encoder's bf16 backward alone (patch_encoder_bwd_plain(bf16=True),
    on the winners of patch_encoder_plain(bf16=True, return_winners=True))
    against jax.vjp through pcc_tpu's patch_encoder_trainable(compute_dtype=
    bfloat16) on seeded patches and a seeded cotangent, also on patches
    built so that the rounded values tie in the SetAbstraction pool and in
    the global max; there the winners are held bit for bit to the arg-max
    of pcc_tpu's backward kernel's own replay of the forward
    (sa_pallas.py:297-392, written out with jnp below);
  * one step of rd_forward (loss, aux, every gradient) and one Adam update
    against pcc_tpu's jitted bf16 step, computed once for the file;
  * train --bf16 end to end into compress --bf16 / decompress --bf16, and
    the refusal that remains (--model AE on several devices).

Bounds, stated before the first run, each of a tensor's largest |entry|:
  * TOL_ENC: the encoder backward alone. Products of bf16 values are exact
    in float32, so the two differ in the order of float32 sums only, and
    where such a sum sits on a bf16 rounding boundary, in one rounding of a
    cotangent (at most about 2^-12 downstream); a rounding point left out
    moves the gradients by 2^-9 to 2^-7.
  * TOL_ENC_STEP: the encoder's gradients in the step, whose cotangent
    comes through the decoder's rounded chain.
  * TOL_GRAD: the gradients of flax's Dense weights, each one bf16 rounding
    of a float32 sum: a sum on a rounding boundary moves one entry by a
    bf16 ulp, 2^-8 of itself.
  * TOL_BIAS: the flax Dense biases' gradients. XLA's CPU backend sums a
    bf16 reduction in windows of 32 rows with a rounding after each add;
    the port sums in float32 and rounds once (ops/bf16.py).
  * LOSS_RTOL: the loss and aux (the forward is flax's rule bit for bit).
  * Adam's first update is lr * g / (|g| + eps): the sign of each gradient
    entry, so an entry whose sign differs moves by 2 lr; every parameter
    within 2 LR (+ 1e-6) of pcc_tpu's, at least PARAM_SHARE of them within
    1e-6.
"""

import functools
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from pcc_tpu.codec import init_params as j_init_params
from pcc_tpu.config import CodecConfig as JCodecConfig
from pcc_tpu.ops.sa_pallas import patch_encoder_trainable as j_encoder_trainable
from pcc_tpu.train.state import make_optimizer as j_make_optimizer
from pcc_tpu.train.steps import rd_forward as j_rd_forward
from pcc_tpu_torch.config import CodecConfig
from pcc_tpu_torch.io import read_point_cloud, save_point_cloud
from pcc_tpu_torch.ops.bf16 import flax_dense, round_bf16
from pcc_tpu_torch.ops.knn import select_nearest, sq_dists
from pcc_tpu_torch.ops.sa_cuda import (patch_encoder_bwd_plain, patch_encoder_plain,
                                       patch_encoder_trainable)
from pcc_tpu_torch.train import build_train_step, create_train_state
from pcc_tpu_torch.train.state import make_optimizer
from pcc_tpu_torch.train.steps import rd_forward
from pcc_tpu_torch.weights import from_jax_params, to_jax_params
from test_torch_port_pppf import one_thread_per_worker  # noqa: F401

BF16 = jnp.bfloat16
TOL_ENC = 2.0 ** -11
TOL_ENC_STEP = 2.0 ** -10
TOL_GRAD = 2.0 ** -7
TOL_BIAS = 2.0 ** -4
LOSS_RTOL = 1e-5
PARAM_SHARE = 0.99
LR, LAM = 1e-3, 1e-2
KW = dict(N=256, N0=64, ALPHA=2, K=32, d=4, L=7, sa_knn=8)
TINY = CodecConfig(**KW, compute_dtype="bfloat16")
JTINY = JCodecConfig(**KW, compute_dtype="bfloat16", fused_sa=True)
B = 2


@pytest.fixture(scope="module")
def setup():
    """pcc_tpu weights (its float32 parameters), a batch of clouds, a JAX
    key and the FPS starts jax.random.randint draws from it inside
    pcc_tpu's rd_forward."""
    ae_vars, prob_vars = j_init_params(jax.random.key(5), JTINY)
    rng = np.random.default_rng(11)
    batch = (rng.random((B, TINY.N, 3)) * 4 - 1).astype(np.float32)
    key = jax.random.key(7)
    starts = np.array(jax.random.randint(key, (B,), 0, TINY.N, dtype=jnp.int32))
    return ae_vars, prob_vars, batch, key, starts


@pytest.fixture(scope="module")
def j_step(setup):
    """pcc_tpu's bf16 train step, jitted once, with its Pallas encoder and
    backward under the interpreter: (loss, aux, gradients, the parameters
    after one Adam update at LR), rate_mode "fixed" so that the probability
    model trains too."""
    ae_vars, prob_vars, batch, key, _ = setup
    tx = j_make_optimizer(LR, 0.1, 10, 10)
    params = {"ae": ae_vars, "prob": prob_vars}

    def step(params, batch, key):
        (loss, aux), grads = jax.value_and_grad(
            functools.partial(j_rd_forward, cfg=JTINY, rate_mode="fixed"), has_aux=True)(
            params, batch, key, LAM)
        updates, _ = tx.update(grads, tx.init(params), params)
        return loss, aux, grads, optax.apply_updates(params, updates)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PCC_PALLAS_INTERPRET", "1")
        return jax.jit(step)(params, jnp.asarray(batch), key)


def _port_state(ae_vars, prob_vars):
    """A CPU bf16 train state holding pcc_tpu's weights."""
    state = create_train_state(0, TINY, make_optimizer(LR, 0.1, 10, 10), device="cpu")
    ae_sd, prob_sd = from_jax_params(ae_vars, prob_vars)
    state.ae.load_state_dict(ae_sd)
    state.prob.load_state_dict(prob_sd)
    return state


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    big = np.abs(b).max()
    return float(np.abs(a - b).max() / big) if big else float(np.abs(a).max())


# ---------------------------------------------------------------- flax Dense --


def test_flax_dense_gradients_follow_xla():
    """Two flax Dense(dtype=bfloat16) layers, relu between, the second cast
    to float32, on a float32 input (the decoder's inv_pool on its latent):
    the forward bit for bit, both weight gradients bit for bit (every
    rounding of ops/bf16.py's rules where XLA has it), the input's
    gradient float32 and unrounded as XLA leaves it (float32 sums in
    another order), the biases within TOL_BIAS."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((48, 16)).astype(np.float32)
    w1 = (rng.standard_normal((16, 64)) * 0.3).astype(np.float32)
    b1 = (rng.standard_normal(64) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((64, 8)) * 0.2).astype(np.float32)
    b2 = (rng.standard_normal(8) * 0.1).astype(np.float32)
    ct = rng.standard_normal((48, 8)).astype(np.float32)

    def jf(x, w1, b1, w2, b2, ct):
        h = nn.relu(nn.Dense(64, dtype=BF16).apply({"params": {"kernel": w1, "bias": b1}}, x))
        y = nn.Dense(8, dtype=BF16).apply({"params": {"kernel": w2, "bias": b2}}, h)
        y = y.astype(jnp.float32)
        return jnp.sum(y * ct), y

    (_, jy), jg = jax.jit(jax.value_and_grad(jf, argnums=(0, 1, 2, 3, 4), has_aux=True))(
        x, w1, b1, w2, b2, ct)
    t = [torch.from_numpy(a.copy()).requires_grad_(True) for a in (x, w1, b1, w2, b2)]
    y = flax_dense(torch.relu(flax_dense(t[0], t[1], t[2], x_bf16=False)), t[3], t[4],
                   round_out=False)
    (y * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jy))
    for i in (1, 3):
        np.testing.assert_array_equal(t[i].grad.numpy(), np.asarray(jg[i]))
    assert not torch.equal(round_bf16(t[0].grad), t[0].grad)       # unrounded, as XLA's
    assert _rel(t[0].grad, jg[0]) <= 1e-6
    for i in (2, 4):
        assert torch.equal(round_bf16(t[i].grad), t[i].grad)
        assert _rel(t[i].grad, jg[i]) <= TOL_BIAS


# -------------------------------------------------------- the encoder alone --


def _encoder_case(kind: str):
    """(patches [6, 32, 3], sa_wb, pn_wb, cotangent [6, 8]) from a numpy
    seed. "ties": the same patches shrunk by 2^-6, so that the biases
    dominate every layer and the activations, distinct in float32, round to
    the same bf16 value across the slots of a pool and across the points
    of a channel (the distances, and so the slots' order, stay far from
    ties; near-tied distances order differently in another summation,
    ROADMAP.md §3)."""
    rng = np.random.default_rng(21)
    P, N = 6, 32
    dims_sa, dims_pn = [3, 32, 64, 128], [3 + 128, 128, 256, 512, 8]

    def wb(dims):
        return [(rng.uniform(-a ** -0.5, a ** -0.5, (a, b)).astype(np.float32),
                 rng.uniform(-a ** -0.5, a ** -0.5, b).astype(np.float32))
                for a, b in zip(dims[:-1], dims[1:])]

    patches = ((rng.random((P, N, 3)) * 2 - 1) * 0.4).astype(np.float32)
    if kind == "ties":
        patches *= np.float32(2.0 ** -6)
    return patches, wb(dims_sa), wb(dims_pn), rng.standard_normal((P, 8)).astype(np.float32)


def _replay_argmax(patches, sa, pn, knn):
    """The winners of pcc_tpu's bf16 backward kernel and how often its
    rounded values tie, from its own replay of the forward written with jnp
    as sa_pallas.py:297-392 writes it (bf16 operands, float32 products and
    float32 biases, every output cast to bf16; the first slot of the
    rounded SetAbstraction max, jnp.argmax over points). Returns (winners
    [P, D], tied (point, channel) pools, tied channels' maxima)."""
    pts = jnp.asarray(patches)
    P, N, _ = pts.shape
    sq = jnp.sum(pts * pts, axis=-1)
    cross = jnp.einsum("pnc,pmc->pnm", pts, pts)
    d2 = jnp.maximum(sq[:, :, None] - 2.0 * cross + sq[:, None, :], 0.0)
    idx = jnp.argsort(d2, axis=-1, stable=True)[..., :knn]             # [P, N, knn]
    nb = jnp.take_along_axis(pts[:, None, :, :], idx[..., None], axis=2)

    def dense(x, w, b, relu=True):
        h = jnp.dot(x.astype(BF16), jnp.asarray(w).astype(BF16),
                    preferred_element_type=jnp.float32) + jnp.asarray(b)
        return (jax.nn.relu(h) if relu else h).astype(BF16)

    h = nb - pts[:, :, None, :]
    for w, b in sa:
        h = dense(h, w, b)
    h = h.astype(jnp.float32)                                           # [P, N, knn, 128]
    feats = h.max(axis=2)
    sa_ties = int(((h == feats[:, :, None, :]).sum(axis=2) > 1)[feats > 0].sum())
    x = jnp.concatenate([pts, feats.astype(BF16).astype(jnp.float32)], axis=-1)
    for i, (w, b) in enumerate(pn):
        x = dense(x, w, b, relu=i < len(pn) - 1)
    z4 = x.astype(jnp.float32)                                          # [P, N, D]
    top = z4.max(axis=1)
    ties = int(((z4 == top[:, None, :]).sum(axis=1) > 1).sum())
    return np.asarray(jnp.argmax(z4, axis=1)), sa_ties, ties


@pytest.mark.parametrize("kind", ["seeded", "ties"])
def test_encoder_bf16_backward_matches_pallas(kind):
    patches, sa, pn, g = _encoder_case(kind)
    knn = 8

    def f(p, s, q):
        return j_encoder_trainable(p, s, q, knn=knn, compute_dtype=BF16, block_p=2,
                                   block_p_bwd=2, interpret=True)

    lat, vjp = jax.vjp(f, jnp.asarray(patches), [tuple(map(jnp.asarray, x)) for x in sa],
                       [tuple(map(jnp.asarray, x)) for x in pn])
    dp, dsa, dpn = vjp(jnp.asarray(g))
    tt = lambda wbs: [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in wbs]  # noqa: E731
    t = torch.from_numpy(patches)
    ours_lat, win = patch_encoder_plain(t, tt(sa), tt(pn), knn, return_winners=True,
                                        bf16=True)
    np.testing.assert_array_equal(ours_lat.numpy(), np.asarray(lat))
    want, sa_ties, ties = _replay_argmax(patches, sa, pn, knn)
    np.testing.assert_array_equal(win.numpy(), want)
    if kind == "ties":
        assert sa_ties > 0 and ties > 0, (sa_ties, ties)
    out = patch_encoder_bwd_plain(t, torch.from_numpy(g), tt(sa), tt(pn), knn, winners=win,
                                  bf16=True)
    ours = [out[0]] + [x for pair in list(out[1]) + list(out[2]) for x in pair]
    theirs = [dp] + [x for pair in list(dsa) + list(dpn) for x in pair]
    assert len(ours) == len(theirs) == 15
    for a, b in zip(ours, theirs):
        assert _rel(a.numpy(), b) <= TOL_ENC
    # the autograd Function: the same latents and gradients
    leaves = [x.clone().requires_grad_(True) for pair in tt(sa) + tt(pn) for x in pair]
    pp = t.clone().requires_grad_(True)
    lat2 = patch_encoder_trainable(pp, [leaves[2 * i:2 * i + 2] for i in range(3)],
                                   [leaves[6 + 2 * i:8 + 2 * i] for i in range(4)], knn,
                                   bf16=True)
    lat2.backward(torch.from_numpy(g))
    assert torch.equal(lat2.detach(), ours_lat)
    assert torch.equal(pp.grad, ours[0])
    assert all(torch.equal(a.grad, b) for a, b in zip(leaves, ours[1:]))


def test_bf16_winners_are_not_the_forward_arg_max():
    """The winners are those of the backward's replay (float32 biases), not
    of the forward's rounded-bias values: on the ties case at least one
    channel's arg-max differs between the two, and the winners follow the
    replay (the test above) -- the reason the bf16 forward kernel computes
    them in a second half of its grid."""
    patches, sa, pn, _ = _encoder_case("ties")
    t = torch.from_numpy(patches)
    tt = lambda wbs: [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in wbs]  # noqa: E731
    sa16 = [(round_bf16(w), round_bf16(b)) for w, b in tt(sa)]
    pn16 = [(round_bf16(w), round_bf16(b)) for w, b in tt(pn)]
    from pcc_tpu_torch.ops.sa_cuda import pointwise_plain

    with torch.no_grad():
        idx = select_nearest(sq_dists(t, t), 8)
        fwd = pointwise_plain(t, idx, sa16, pn16, bf16=True).argmax(dim=1)
        _, win = patch_encoder_plain(t, tt(sa), tt(pn), 8, return_winners=True, bf16=True)
    assert int((fwd != win.long()).sum()) > 0


# ------------------------------------------------------------- the bf16 step --


def test_bf16_step_matches_pcc_tpu(setup, j_step):
    """rd_forward's loss, aux and every gradient, then one Adam update,
    against pcc_tpu's jitted bf16 step on the same weights, clouds and FPS
    starts; the forward through patch_encoder_trainable(bf16=True) and the
    chamfer's plain versions."""
    ae_vars, prob_vars, batch, _, starts = setup
    j_loss, j_aux, j_grads, j_params = j_step
    state = _port_state(ae_vars, prob_vars)
    loss, aux = rd_forward(state.ae, state.prob, torch.from_numpy(batch),
                           torch.from_numpy(starts), LAM, TINY, "fixed")
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=LOSS_RTOL)
    for k in ("chamfer", "fbpp", "bpp", "true_fbpp"):
        np.testing.assert_allclose(float(aux[k].detach()), float(j_aux[k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    ga, gp = to_jax_params({n: p.grad for n, p in state.ae.named_parameters()},
                           {n: p.grad for n, p in state.prob.named_parameters()})
    ours, theirs = _leaves({"ae": ga, "prob": gp}), _leaves(j_grads)
    assert [p for p, _ in ours] == [p for p, _ in theirs]
    for (path, a), (_, b) in zip(ours, theirs):
        name = jax.tree_util.keystr(path)
        encoder = "['sa']" in name or "['pn']" in name
        tol = TOL_ENC_STEP if encoder else TOL_BIAS if name.endswith("['bias']") else TOL_GRAD
        err = _rel(a, b)
        assert err <= tol, (name, err, tol)

    # one Adam update, by build_train_step on a fresh state
    state = _port_state(ae_vars, prob_vars)
    state, _ = build_train_step(TINY, make_optimizer(LR, 0.1, 10, 10), "fixed")(
        state, torch.from_numpy(batch), torch.from_numpy(starts), LAM)
    new = to_jax_params(state.ae.state_dict(), state.prob.state_dict())
    diffs = np.concatenate([
        np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).ravel()
        for (_, a), (_, b) in zip(_leaves({"ae": new[0], "prob": new[1]}),
                                  _leaves(j_params))])
    assert diffs.max() <= 2 * LR + 1e-6
    assert float((diffs <= 1e-6).mean()) >= PARAM_SHARE


# ---------------------------------------------------------------- the CLIs --


def test_bf16_train_cli_into_bf16_codec(tmp_path):
    """train --bf16 (--model AE, one device) writes the float32 pickles of
    pcc_tpu's layout; compress --bf16 and decompress --bf16 run on them;
    --model AE --bf16 with --devices 2 is refused, naming what is left
    (--model PPPF-AE --bf16 trains its float32 step:
    tests/test_torch_port_pn_bf16.py)."""
    from pcc_tpu.train.checkpoint import load_inference_params
    from pcc_tpu_torch.cli import compress, decompress, train

    rng = np.random.default_rng(3)
    inp, model = tmp_path / "in", tmp_path / "model"
    for i in range(2):
        save_point_cloud((rng.random((TINY.N, 3)) * 2 - 1).astype(np.float32),
                         f"c{i}.ply", path=str(inp))
    size = ["--N0", "64", "--K", "32", "--d", "4", "--device", "cpu"]
    flags = ["--train_glob", str(inp / "*.ply"), "--model_save_folder", str(model),
             "--N", "256", "--batch_size", "2", "--step_window", "1", "--bf16"] + size
    train.main(flags + ["--max_steps", "2"])
    ae, prob = load_inference_params(str(model))
    assert all(a.dtype == np.float32 for a in jax.tree.leaves((ae, prob)))
    compress.main([str(inp / "*.ply"), str(tmp_path / "comp"), str(model), "--bf16"] + size)
    assert len(glob.glob(str(tmp_path / "comp" / "*.bin"))) == 6
    decompress.main([str(tmp_path / "comp"), str(tmp_path / "dec"), str(model), "--bf16"]
                    + size)
    outs = sorted(glob.glob(str(tmp_path / "dec" / "*.ply")))
    assert len(outs) == 2
    assert all(np.isfinite(read_point_cloud(o)).all() for o in outs)
    with pytest.raises(SystemExit, match="--devices"):
        train.main(flags + ["--devices", "2", "--max_steps", "1"])
    assert not os.path.exists(tmp_path / "model" / "ae_step3.pkl")
