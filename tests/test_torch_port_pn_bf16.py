"""PyTorch port (pcc_tpu_torch) vs pcc_tpu: bf16 training of the PN++
families on the CPU, same numpy-seeded inputs and weights.

  * the bf16 "pppf" stage backward alone (pppf_sa_bwd_plain_bf16, through
    pppf_sa_trainable(bf16=True)) against jax.vjp through pcc_tpu's
    pppf_sa_trainable(compute_dtype=bfloat16), its Pallas backward under
    the interpreter; also on a case built to tie in bf16, where the max
    routing is held bit for bit to the first winning slot of pcc_tpu's own
    replay of the forward (written out with jnp below);
  * the shared rules alone: flax's BatchNorm(dtype=bfloat16) in training
    after flax's bf16 Dense (output, running statistics, gradients) and
    jnp.max's tie split on bf16 values, against bare flax modules under
    jitted jax.grad;
  * PPPF_AE(compute_dtype="bfloat16") in train mode, both encoder forms
    (frozen: the stage kernels' bf16 instances; batch statistics: the XLA
    stage's rules), against pcc_tpu's PPPF_AE(dtype=bfloat16,
    fused_train=True / False).apply(train=True, mutable=["batch_stats"])
    with PCC_PALLAS_INTERPRET=1, narrow PN++ stages (SMALL_PNPP, both
    packages; the stages' nsample and radii stay);
  * one PPPE bf16 step against jax.value_and_grad of pcc_tpu's
    pppe_forward at a small PPPEConfig(compute_dtype="bfloat16"), the
    gradients before the clip and Adam, and the update as optax's on the
    port's own gradient;
  * gather_bf16's backward against jax.grad of pcc_tpu's knn_gather on a
    bf16 array;
  * the repair: pcc_tpu's PPPF-AE trainer builds float32 models under
    --bf16, and the port's train --model PPPF-AE --bf16 writes the same
    checkpoint bytes as the run without it.

Bounds, stated before the first run, each of a tensor's largest |entry|:
  * TOL_STAGE: the stage backward alone. Products of bf16 values are exact
    in float32, so the two differ in the order of float32 sums, and where
    such a sum sits on a bf16 rounding boundary, in one rounding of a
    per-slot cotangent (about 2^-12 downstream).
  * TOL_RULES: a Dense + BatchNorm + max stack against flax: every rounding
    is flax's, so only a float32 sum's order can flip a bf16 rounding.
  * TOL_GRAD: gradients through a whole bf16 network, each a bf16 rounding
    of float32 sums downstream of many others: a rounding flipped upstream
    moves an entry by a bf16 ulp, 2^-8 of itself, and spreads.
  * TOL_BIAS: gradients that XLA reduces in bf16 (flax's Dense biases, the
    tiled latent; ops/bf16.py::bf16_reduce), where one flipped addend moves
    the partial sums.
  * The encoder on batch statistics in bf16 (PPPF_AE's unfrozen form, and
    the PPPE step) is ill-conditioned against another summation order: a
    float32 batch mean one ulp away flips the bf16 rounding of a few
    BatchNorm outputs, every later layer carries the flips, and the
    gradients through batch statistics cancel. pcc_tpu is as far from
    itself when the same step runs on the same batch in another order. So
    there the forward, the running statistics' step and every gradient are
    held by tools/holds.py::spread_hold to pcc_tpu's own spread over such
    reorderings (PERMS, REORDERS): each leaf no farther from pcc_tpu than
    LEAF_X times pcc_tpu's farthest reordering plus FLOOR, the median
    within SPREAD_X of pcc_tpu's own, each norm within RATIO of pcc_tpu's
    (the Dense biases before a BatchNorm, 0 in exact arithmetic, excepted),
    the median within MEDIAN_RATIO, the mean cosine at most COS_SLACK below
    pcc_tpu's own. With the BatchNorm gradient doubled, the batch statistics detached or the max's tie split
    left out, in a copy of the port, the holds fail; the rules' own test
    above is what catches a BatchNorm cotangent left unrounded.
"""

import copy
import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcc_tpu.models import pppf as j_pppf
from pcc_tpu.models.layers import PointwiseMLP as JPointwiseMLP
from pcc_tpu.ops.pppf_sa_pallas import pppf_sa_trainable as j_pppf_sa_trainable
from pcc_tpu_torch.io import save_point_cloud
from pcc_tpu_torch.models import pppf as p_pppf
from pcc_tpu_torch.models.layers import batch_norm_train, dense, torch_dense_init_
from pcc_tpu_torch.ops.bf16 import max_bf16
from pcc_tpu_torch.ops.knn import ball_query, knn_gather
from pcc_tpu_torch.ops.pppf_sa_cuda import bf16_points_forward, first_winners, pppf_sa_trainable
from pcc_tpu_torch.tools.holds import shaped_clouds, spread_hold, steady_symbols
from pcc_tpu_torch.weights import to_jax_params
from test_torch_port_pppf import _live_stats, one_thread_per_worker  # noqa: F401

BF16 = jnp.bfloat16
TOL_STAGE = 1e-5
TOL_RULES = 2.0 ** -10
TOL_GRAD = 2.0 ** -6
TOL_BIAS = 2.0 ** -4
SMALL_PNPP = dict(sa1_mlp=(16, 16, 32), sa2_mlp=(32, 32, 32, 64), sa3_mlp=(64, 64, 128))
SMALL_DIM = 64


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    big = np.abs(b).max()
    return float(np.abs(a - b).max() / big) if big else float(np.abs(a).max())


def _bf16(a: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32).astype(BF16).astype(jnp.float32))


# ------------------------------------------------------ the stage backward --


def _stage_case(kind: str):
    """(new_xyz, xyz, feat, layers, cotangent, nsample, radius), numpy.
    "ties": coordinates in [0, 2^-6), the features constant per patch and
    every weight small against its bias, so that the rounded activations
    of distinct points tie across a query's slots; radius 2^-6 * 0.6, so
    that balls overlap and some slots are masked."""
    rng = np.random.default_rng(31 if kind == "ties" else 32)
    P, N, S, nsample = 3, 32, 16, 8
    C = 0 if kind == "xyz" else 13
    widths = (C + 3, 16, 24, 32)
    xyz = rng.random((P, N, 3)).astype(np.float32)
    radius = 0.45
    if kind == "ties":
        xyz *= np.float32(2.0 ** -6)
        radius = 0.6 * 2.0 ** -6
    new_xyz = np.ascontiguousarray(xyz[:, rng.permutation(N)[:S]])
    feat = None
    if C:
        feat = _bf16(rng.random((P, N, C)))
        if kind == "ties":
            feat = np.repeat(feat[:, :1], N, axis=1)
    layers = []
    for a, b in zip(widths[:-1], widths[1:]):
        sign = np.where(rng.random(b) < 0.25, -1.0, 1.0)
        w = rng.uniform(-1, 1, (a, b)) * a ** -0.5 * (2.0 ** -6 if kind == "ties" else 1.0)
        layers.append(tuple(x.astype(np.float32) for x in (
            w, rng.uniform(-0.3, 0.3, b), rng.standard_normal(b) * 0.1,
            (rng.random(b) + 0.5) * sign, (rng.random(b) - 0.3) * 0.2)))
    g = _bf16(rng.standard_normal((P, S, widths[-1])))
    return new_xyz, xyz, feat, layers, g, nsample, radius


def _replay_winners(new_xyz, xyz, feat, layers, nsample, radius):
    """The first winning slot of each (patch, query, channel) and the count
    of maxima reached by more than one distinct point, from pcc_tpu's bf16
    stage written out with jnp as pppf_sa_pallas.py:91-102 computes it (the
    gathered rows cast to bf16, float32 products + b, the affine and relu,
    cast to bf16), on the slots of ball_query (its selection and mask are
    the kernel's, bit for bit: tests/test_torch_port_pppf.py)."""
    idx = ball_query(torch.from_numpy(new_xyz), torch.from_numpy(xyz), nsample, radius).numpy()
    rows = xyz if feat is None else np.concatenate([feat, xyz], axis=-1)
    nb = jnp.asarray(np.take_along_axis(rows[:, None], idx[..., None], axis=2))
    h = nb
    for w, b, mean, mul, beta in layers:
        z = jnp.dot(h.astype(BF16), jnp.asarray(w).astype(BF16),
                    preferred_element_type=jnp.float32) + b
        h = jax.nn.relu((z - mean) * mul + beta).astype(BF16)
    h = np.asarray(h.astype(jnp.float32))                                 # [P, S, ns, C]
    top = h.max(axis=2, keepdims=True)
    pts = np.broadcast_to(idx[..., None], h.shape)
    hit = h == top
    ties = int(((np.where(hit, pts, -1).max(axis=2) != np.where(hit, pts, 1 << 30).min(axis=2))
                & (top[:, :, 0] > 0)).sum())
    return np.argmax(hit, axis=2), top[:, :, 0] > 0, ties


@pytest.mark.parametrize("kind", ["xyz", "feat", "ties"])
def test_stage_bwd_bf16_matches_pallas(kind):
    new_xyz, xyz, feat, layers, g, nsample, radius = _stage_case(kind)

    def stage(nx, x, f, lays):
        return j_pppf_sa_trainable(nx, x, f, lays, nsample=nsample, radius=radius,
                                   compute_dtype=BF16, interpret=True)

    jl = tuple(tuple(jnp.asarray(a) for a in lay) for lay in layers)
    out_ref, vjp = jax.vjp(stage, jnp.asarray(new_xyz), jnp.asarray(xyz),
                           None if feat is None else jnp.asarray(feat), jl)
    d_new, d_xyz, d_feat, d_lay = jax.jit(vjp)(jnp.asarray(g))

    t = torch.from_numpy
    x = t(xyz.copy()).requires_grad_(True)
    f = None if feat is None else t(feat.copy()).requires_grad_(True)
    lays = [tuple(t(a.copy()).requires_grad_(True) for a in lay) for lay in layers]
    out = pppf_sa_trainable(t(new_xyz), x, f, lays, nsample=nsample, radius=radius, bf16=True)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(out_ref))
    out.backward(t(g))
    assert not np.asarray(d_new).any()
    pairs = [(x.grad, d_xyz)] + ([(f.grad, d_feat)] if feat is not None else [])
    for lay, ref in zip(lays, d_lay):
        assert lay[2].grad is None and not np.asarray(ref[2]).any()       # mean
        pairs += [(lay[i].grad, ref[i]) for i in (0, 1, 3, 4)]
    assert float(np.abs(np.asarray(d_xyz)).max()) > 0
    for a, b in pairs:
        assert _rel(a.numpy(), b) <= TOL_STAGE
    if kind == "ties":
        # the routing: the port's first winning slots are those of
        # pcc_tpu's replay; the last layer's dbeta is the sum of the
        # cotangents its live maxima route
        win, live, ties = _replay_winners(new_xyz, xyz, feat, layers, nsample, radius)
        assert ties > 20, ties
        routed = np.where(live, g, 0.0).sum(axis=(0, 1))
        np.testing.assert_allclose(lays[-1][4].grad.numpy(), routed, rtol=0, atol=1e-5)
        rows = [(t(_bf16(w)),) + tuple(t(a) for a in rest) for w, *rest in layers]
        xs, _ = bf16_points_forward(t(xyz), None if feat is None else t(feat), rows)
        idx = ball_query(t(new_xyz), t(xyz), nsample, radius)
        first, ours_live = first_winners(knn_gather(xs[-1], idx))
        np.testing.assert_array_equal(ours_live.numpy(), live)
        np.testing.assert_array_equal(first.numpy()[live], win[live])


# ------------------------------------------------------------ shared rules --


def test_bf16_dense_batchnorm_max_rules_follow_flax():
    """pcc_tpu's PointwiseMLP(use_bn=True, dtype=bfloat16) in training on a
    grouped [B, S, ns, C] input, then jnp.max over the samples, jitted:
    the port's dense(to_float32=True) -> batch_norm_train(bf16=True) -> relu
    -> max_bf16 gives the same maxima bit for bit (ties among them), the
    same running statistics to float32 rounding, and every gradient within
    TOL_RULES."""
    rng = np.random.default_rng(1)
    B, S, K, C0 = 2, 8, 6, 5
    x = rng.standard_normal((B, S, K, C0)).astype(np.float32)
    mlp = JPointwiseMLP((16, 8), use_bn=True, dtype=BF16)
    v = mlp.init(jax.random.key(0), jnp.asarray(x), True)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
        v["params"])
    w = rng.standard_normal((B, S, 8)).astype(np.float32)

    def loss(p, x):
        out, mut = mlp.apply({"params": p, "batch_stats": v["batch_stats"]}, x, True,
                             mutable=["batch_stats"])
        m = jnp.max(out, axis=2)
        return jnp.sum(m.astype(jnp.float32) * w), (m, mut["batch_stats"])

    (_, (jm, jstats)), jg = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    t = torch.from_numpy
    h = t(x).requires_grad_(True)
    xs, mods = h, []
    for i in range(2):
        d, b = params[f"dense_{i}"]["linear"], params[f"bn_{i}"]
        conv = p_pppf.PointConv(d["kernel"].shape[0], d["kernel"].shape[1])
        bn = torch.nn.BatchNorm2d(d["kernel"].shape[1])
        with torch.no_grad():
            conv.weight.copy_(t(np.ascontiguousarray(d["kernel"].T))[..., None, None])
            conv.bias.copy_(t(d["bias"]))
            bn.weight.copy_(t(b["scale"]))
            bn.bias.copy_(t(b["bias"]))
        mods.append((conv, bn))
        h = torch.relu(batch_norm_train(dense(conv, h, True, to_float32=True), bn, bf16=True))
    m = max_bf16(h, 2)
    np.testing.assert_array_equal(m.detach().numpy(), np.asarray(jm.astype(jnp.float32)))
    ties = ((h == m[:, :, None]).sum(dim=2) > 1).sum()
    assert int(ties) > 0
    (m * t(w)).sum().backward()
    for i, (conv, bn) in enumerate(mods):
        s = jstats[f"bn_{i}"]
        assert _rel(bn.running_mean.numpy(), s["mean"]) <= 1e-6
        assert _rel(bn.running_var.numpy(), s["var"]) <= 1e-6
        gd, gb = jg[0][f"dense_{i}"]["linear"], jg[0][f"bn_{i}"]
        assert _rel(conv.weight.grad[:, :, 0, 0].numpy().T, gd["kernel"]) <= TOL_RULES
        assert _rel(conv.bias.grad.numpy(), gd["bias"]) <= TOL_RULES
        assert _rel(bn.weight.grad.numpy(), gb["scale"]) <= TOL_RULES
        assert _rel(bn.bias.grad.numpy(), gb["bias"]) <= TOL_RULES
    assert _rel(xs.grad.numpy(), jg[1]) <= TOL_RULES


def test_bf16_max_splits_ties_as_jnp_max():
    """jnp.max's gradient on bf16 values, jitted: each element reaching the
    maximum gets round(round(g) / count), bit for bit."""
    rng = np.random.default_rng(5)
    x = _bf16(np.round(rng.standard_normal((6, 5, 7)) * 2) / 2)
    w = rng.standard_normal((6, 7)).astype(np.float32)

    def f(x):
        return jnp.sum(jnp.max(x.astype(BF16), axis=1).astype(jnp.float32) * w)

    ref = np.asarray(jax.jit(jax.grad(f))(jnp.asarray(x)))
    t = torch.from_numpy(x.copy()).requires_grad_(True)
    (max_bf16(t, 1) * torch.from_numpy(w)).sum().backward()
    assert int(((x == x.max(axis=1, keepdims=True)).sum(axis=1) > 1).sum()) > 5
    np.testing.assert_array_equal(t.grad.numpy(), ref)


def test_bf16_gather_backward_is_xla_scatter_add():
    """pcc_tpu's knn_gather on a bf16 array, jitted jax.grad: the port's
    gather_bf16 gives the same cotangent bit for bit, on indices that read
    some rows many times over (a ball's masked slots all read point 0), as
    bf16_scatter_add sums them: update by update in index order, each add
    rounded to bf16. The float32 sum rounded once differs, so the test
    tells the two apart."""
    from pcc_tpu.ops.knn import knn_gather as j_knn_gather
    from pcc_tpu_torch.ops.bf16 import gather_bf16

    rng = np.random.default_rng(9)
    B, n, S, K, C = 2, 12, 6, 16, 5
    rows = _bf16(rng.standard_normal((B, n, C)))
    idx = rng.integers(0, n, (B, S, K)).astype(np.int32)
    idx[:, :, K // 2:] = 0
    w = rng.standard_normal((B, S, K, C)).astype(np.float32)

    def f(x):
        return jnp.sum(j_knn_gather(x.astype(BF16), jnp.asarray(idx)).astype(jnp.float32) * w)

    ref = np.asarray(jax.jit(jax.grad(f))(jnp.asarray(rows)))
    t = torch.from_numpy(rows.copy()).requires_grad_(True)
    (gather_bf16(t, torch.from_numpy(idx)) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), ref)
    once = np.zeros((B, n, C), np.float32)
    for b in range(B):
        np.add.at(once[b], idx[b].ravel(), _bf16(w[b]).reshape(-1, C))
    assert not np.array_equal(_bf16(once), ref)


# ------------------------------------------------------- PPPF_AE in bf16 --

PK = dict(K=32, d=4, L=7)
PERMS = (np.array([2, 0, 3, 1]), np.array([3, 2, 1, 0]))


@pytest.fixture(scope="module")
def pppf_case():
    """Seeded port weights with live BatchNorm statistics, the same
    variables for pcc_tpu, 4 patches of K points and cotangents, numpy."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(p_pppf, "PointNetPP", functools.partial(p_pppf.PointNetPP, **SMALL_PNPP))
        ae = p_pppf.PPPF_AE(**PK, dim=SMALL_DIM, compute_dtype="bfloat16")
    torch_dense_init_(ae, torch.Generator().manual_seed(3))
    ae.load_state_dict(_live_stats(ae.state_dict(), 4))
    rng = np.random.default_rng(6)
    patches = ((rng.random((4, PK["K"], 3)) * 2 - 1) * 0.5).astype(np.float32)
    g_out = rng.standard_normal((4, PK["d"] ** 2, 3)).astype(np.float32)
    g_z = rng.standard_normal((4, PK["d"])).astype(np.float32)
    return ae, to_jax_params(ae.state_dict(), None)[0], patches, g_out, g_z


def _j_pppf_grads(variables, cases, fused_train):
    """pcc_tpu's PPPF_AE(dtype=bfloat16, fused_train) in train mode, one
    jitted value_and_grad of the seeded loss, on each (patches, g_out, g_z)
    of `cases`: [((loss, (out, z, batch_stats)), grads)]."""
    class JSmall(j_pppf.PPPF_AE):
        dim: int = SMALL_DIM

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PCC_PALLAS_INTERPRET", "1")
        mp.setattr(j_pppf, "PointNetPP", functools.partial(j_pppf.PointNetPP, **SMALL_PNPP))
        model = JSmall(**PK, dtype=BF16, fused_train=fused_train)

        def loss(params, x, g_out, g_z):
            (out, z, _), mut = model.apply(
                {"params": params, "batch_stats": variables["batch_stats"]}, x, True,
                mutable=["batch_stats"])
            return jnp.sum(out * g_out) + jnp.sum(z * g_z), (out, z, mut["batch_stats"])

        fn = jax.jit(jax.value_and_grad(loss, has_aux=True))
        return [fn(variables["params"], *map(jnp.asarray, c)) for c in cases]


def _paths(tree) -> dict:
    return {jax.tree_util.keystr(p): np.array(a)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def _noise_leaves(names) -> set:
    """The encoder's Dense biases, each before a BatchNorm on batch
    statistics: 0 in exact arithmetic, rounding noise in bf16."""
    return {k for k in names if "['encoder']" in k and "['dense_" in k and k.endswith("['bias']")}


def _hold(ours, ref, others, noise=()):
    fails, fig = spread_hold(ours, ref, others, noise)
    assert not fails, (fails, fig["median"], fig["mean_cos"], fig["mean_cos_self"])


@pytest.mark.parametrize("form", ["frozen", "batch_stats"])
def test_pppf_ae_bf16_train_matches_pcc_tpu(pppf_case, form):
    """PPPF_AE(compute_dtype="bfloat16") in train mode: with its encoder
    frozen (eval mode: the stages through pppf_sa_trainable(bf16=True)) or
    on batch statistics, against pcc_tpu's fused_train=True / False: the
    decoded patches and latents, the updated running statistics and every
    gradient of a seeded loss. Frozen: TOL_GRAD / TOL_BIAS. On batch
    statistics: spread_hold against pcc_tpu's own spread, the same step on
    the patches in PERMS' orders (module docstring)."""
    ae0, variables, patches, g_out, g_z = pppf_case
    frozen = form == "frozen"
    perms = [] if frozen else PERMS
    runs = _j_pppf_grads(variables, [(patches, g_out, g_z)]
                         + [(patches[q], g_out[q], g_z[q]) for q in perms], frozen)
    (_, (j_out, j_z, j_stats)), j_grads = runs[0]
    ae = copy.deepcopy(ae0).train()
    if frozen:
        ae.encoder.train(False)
    out, z, _ = ae(torch.from_numpy(patches))
    ((out * torch.from_numpy(g_out)).sum() + (z * torch.from_numpy(g_z)).sum()).backward()
    ours_p = _paths(to_jax_params(dict(ae.state_dict())
                                  | {k: p.grad for k, p in ae.named_parameters()},
                                  None)[0]["params"])
    stats = _paths(to_jax_params(ae.state_dict(), None)[0]["batch_stats"])
    old = _paths(variables["batch_stats"])
    ref_p, ref_stats = _paths(j_grads), _paths(j_stats)
    assert ours_p.keys() == ref_p.keys() and stats.keys() == ref_stats.keys()
    for k in stats:
        assert np.array_equal(stats[k], old[k]) == frozen, k
    if frozen:
        assert _rel(out.detach().numpy(), j_out) <= TOL_GRAD
        assert _rel(z.detach().numpy(), j_z) <= TOL_GRAD
        for k in stats:
            assert _rel(stats[k], ref_stats[k]) <= 1e-6, k
        for k, a in ours_p.items():
            bias = k.endswith("['bias']") and "['encoder']" not in k
            assert _rel(a, ref_p[k]) <= (TOL_BIAS if bias else TOL_GRAD), (k, _rel(a, ref_p[k]))
        return
    # the other orders' results, put back in the first order
    back = [np.argsort(q) for q in perms]
    others = [(np.asarray(o)[b], np.asarray(zz)[b], _paths(st), _paths(gr))
              for ((_, (o, zz, st)), gr), b in zip(runs[1:], back)]
    _hold({"out": out.detach(), "z": z.detach()}, {"out": j_out, "z": j_z},
          [{"out": o, "z": zz} for o, zz, _, _ in others])
    # the running statistics' step, (new - old), holds the batch statistics
    step = lambda st: {k: np.asarray(st[k], np.float64) - old[k] for k in old}  # noqa: E731
    _hold(step(stats), step(ref_stats), [step(st) for _, _, st, _ in others])
    _hold(ours_p, ref_p, [gr for _, _, _, gr in others], _noise_leaves(ref_p))


# ------------------------------------------------------- one PPPE bf16 step --

PCFG_KW = dict(N=256, latent_dim=16, L=7, compute_dtype="bfloat16")
PLR, PLAM = 5e-4, 0.5
PB = 4
REORDERS = (np.array([3, 2, 1, 0]), np.array([1, 3, 0, 2]))


def _pppe_bf16_state(cfg, tx):
    """A port PPPE train state for the bf16 step: tests/test_torch_port_pppe.py's
    seeded weights with the latent head's x60 undone, then
    tools/holds.py::steady_symbols (every latent near the middle of a bin)."""
    from test_torch_port_pppe import _test_state
    from pcc_tpu_torch.train.steps_pppe import create_pppe_state

    sd = _test_state(5)
    sd["encoder.global_conv.3.weight"] = sd["encoder.global_conv.3.weight"] / 60.0
    state = create_pppe_state(0, cfg, tx, device="cpu")
    state.model.load_state_dict(sd)
    steady_symbols(state.model, 13)
    return state


def test_pppe_bf16_step_matches_pcc_tpu():
    """One PPPE train step at PPPEConfig(compute_dtype="bfloat16") against
    jax.value_and_grad of pcc_tpu's pppe_forward, jitted, on the same
    weights (live BatchNorm statistics, _pppe_bf16_state) and clouds
    (tools/holds.py::shaped_clouds, four shapes): the skip flag; loss, dist and rate, the running statistics' step and every
    gradient before the clip and Adam, each held by spread_hold to
    pcc_tpu's own spread over the same step with the clouds in REORDERS'
    orders (the encoder on batch statistics in bf16: module docstring);
    the global norm that the clip divides by, likewise; and the parameters
    after the step equal to optax's clip and Adam on the port's own
    gradient, computed here in float64."""
    from pcc_tpu.config import PPPEConfig as JPPPEConfig
    from pcc_tpu.train.steps_pppe import pppe_forward as j_pppe_forward
    from pcc_tpu_torch.config import PPPEConfig
    from pcc_tpu_torch.train.steps_pppe import build_pppe_train_step, make_pppe_optimizer

    cfg, jcfg = PPPEConfig(**PCFG_KW), JPPPEConfig(**PCFG_KW)
    ptx = make_pppe_optimizer(PLR)
    state = _pppe_bf16_state(cfg, ptx)
    batch = shaped_clouds(PB, cfg.N, 13)
    variables = to_jax_params(dict(state.model.state_dict()))[0]
    params, stats = {"ae": variables["params"]}, {"ae": variables["batch_stats"]}
    grad = jax.jit(jax.value_and_grad(functools.partial(j_pppe_forward, cfg=jcfg),
                                      has_aux=True))
    old = _paths(variables["batch_stats"])

    def j_run(order):
        (loss, (aux, new_stats)), g = grad(params, stats, jnp.asarray(batch[order]), PLAM)
        new = _paths(new_stats["ae"])
        return ({"loss": loss, "dist": aux["dist"], "rate": aux["rate"]},
                {k: np.asarray(new[k], np.float64) - old[k] for k in old}, _paths(g["ae"]))

    ref, *others = [j_run(o) for o in (np.arange(PB),) + REORDERS]
    assert np.isfinite(float(ref[0]["loss"]))

    assert state.model.bf16
    with torch.no_grad():
        latent = copy.deepcopy(state.model).encoder(torch.from_numpy(batch))[0].numpy()
    assert np.abs(latent - np.round(latent)).max() < 0.25
    p0 = state.params.detach().double().numpy().copy()
    state, aux = build_pppe_train_step(ptx)(state, torch.from_numpy(batch), PLAM)
    assert not bool(aux["skipped"])
    _hold({k: aux[k] for k in ("loss", "dist", "rate")}, ref[0], [o[0] for o in others])
    new = _paths(to_jax_params(state.model.state_dict())[0]["batch_stats"])
    _hold({k: np.asarray(new[k], np.float64) - old[k] for k in old}, ref[1],
          [o[1] for o in others])
    named = state.named_parameters()
    grads = _paths(to_jax_params(dict(state.model.state_dict())
                                 | {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                                    for k, p in named})[0]["params"])
    assert grads.keys() == ref[2].keys()
    _hold(grads, ref[2], [o[2] for o in others], _noise_leaves(ref[2]))
    norm = lambda g: float(np.sqrt(sum(np.sum(np.asarray(x, np.float64) ** 2)  # noqa: E731
                                       for x in g.values())))
    _hold({"norm": norm(grads)}, {"norm": norm(ref[2])}, [{"norm": norm(o[2])} for o in others])
    # optax's clip_by_global_norm(1.0) and Adam's first step on the port's
    # own gradient, in float64
    g = np.concatenate([(p.grad if p.grad is not None else torch.zeros_like(p))
                        .detach().double().numpy().ravel() for _, p in named])
    n = np.sqrt(np.sum(g * g))
    g = g / n if n >= 1.0 else g
    want = p0 - PLR * g / (np.abs(g) + 1e-8)
    got = state.params.detach().double().numpy()
    assert np.abs(got - want).max() <= 1e-6
    assert (got != p0).mean() > 0.5


def test_pppe_bf16_decoder_matches_flax():
    """PCNDecoderSmall in bf16 on a quantized latent against pcc_tpu's
    PCNDecoderSmall(dtype=bfloat16), jitted: both outputs bit for bit, every
    gradient of a seeded loss within TOL_GRAD (the expansion layers' bit for
    bit), the latent's float32 cotangent within TOL_GRAD."""
    from pcc_tpu.models.pppe import PCNDecoderSmall as JDecoder
    from pcc_tpu_torch.models.pppe import PCNDecoderSmall
    from test_torch_port_pppe import _test_state

    sd = _test_state(5)
    params = to_jax_params(dict(sd))[0]["params"]["decoder"]
    rng = np.random.default_rng(12)
    lat = rng.integers(0, 7, (2, 16)).astype(np.float32)
    gc = rng.standard_normal((2, 512, 3)).astype(np.float32)
    gf = rng.standard_normal((2, 256, 3)).astype(np.float32)
    jd = JDecoder(latent_dim=16, coarse_points=512, final_points=256, dtype=BF16)

    def loss(p, z):
        c, f = jd.apply({"params": p}, z)
        return jnp.sum(c * gc) + jnp.sum(f * gf), (c, f)

    (_, (jc, jf)), (jgp, jgz) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                                           has_aux=True))(params, jnp.asarray(lat))
    dec = PCNDecoderSmall(16, 512, 256, bf16=True)
    dec.load_state_dict({k[len("decoder."):]: v for k, v in sd.items()
                         if k.startswith("decoder.")})
    z = torch.from_numpy(lat).requires_grad_(True)
    c, f = dec(z)
    np.testing.assert_array_equal(c.detach().numpy(), np.asarray(jc))
    np.testing.assert_array_equal(f.detach().numpy(), np.asarray(jf))
    ((c * torch.from_numpy(gc)).sum() + (f * torch.from_numpy(gf)).sum()).backward()
    assert _rel(z.grad.numpy(), jgz) <= TOL_GRAD
    mods = {"fc0": dec.fc_coarse[0], "fc1": dec.fc_coarse[2], "exp0": dec.expansion_mlp[0],
            "exp1": dec.expansion_mlp[2]}
    for name, m in mods.items():
        ref = jgp[name]["linear"]
        exact = name.startswith("exp")
        for a, b in ((m.weight.grad.numpy().T, ref["kernel"]), (m.bias.grad.numpy(), ref["bias"])):
            if exact:
                np.testing.assert_array_equal(a, np.asarray(b))
            assert _rel(a, b) <= TOL_GRAD, name


# -------------------------------------------------------------- the repair --


def test_pppf_ae_trainer_is_float32_under_bf16(tmp_path):
    """pcc_tpu's make_pppf_models builds float32 models whatever
    compute_dtype says; the port's train --model PPPF-AE --bf16 computes
    the float32 step: ae.pkl and prob.pkl equal byte for byte to the run
    without --bf16."""
    from pcc_tpu.config import CodecConfig as JCodecConfig
    from pcc_tpu.train.steps_pppf import make_pppf_models
    from pcc_tpu_torch.cli import train

    ae, prob = make_pppf_models(JCodecConfig(model="PPPF-AE", compute_dtype="bfloat16"))
    assert ae.dtype is None and prob.dtype is None
    rng = np.random.default_rng(8)
    inp = tmp_path / "in"
    for i in range(2):
        save_point_cloud((rng.random((64, 3)) * 2 - 1).astype(np.float32), f"c{i}.ply",
                         path=str(inp))
    flags = ["--train_glob", str(inp / "*.ply"), "--model", "PPPF-AE", "--N", "64", "--N0",
             "64", "--K", "32", "--d", "4", "--batch_size", "1", "--bn_warmup_steps", "1",
             "--max_steps", "2", "--step_window", "1", "--device", "cpu"]
    outs = {}
    for bf16 in (False, True):
        folder = tmp_path / f"m{int(bf16)}"
        train.main(flags + ["--model_save_folder", str(folder)] + (["--bf16"] if bf16 else []))
        outs[bf16] = [(folder / name).read_bytes() for name in ("ae.pkl", "prob.pkl")]
    assert outs[True] == outs[False]
    assert pickle.loads(outs[True][0])
