"""PyTorch port (pcc_tpu_torch) vs pcc_tpu: the IPDAE train step on the CPU,
at the TINY config of tests/test_parallel.py, with pcc_tpu's random weights
carried across by weights.from_jax_params and the same numpy clouds.

  * the encoder backward's plain version against jax.grad through
    pcc_tpu's fused encoder, whose backward is the Pallas kernel in
    interpret mode: patches and all 14 leaves, atol 1e-4 (the bar of
    tests/test_sa_pallas.py), also where every max is an exact tie;
  * rd_forward's loss and aux equal to rtol 1e-6, every parameter gradient
    within 1e-5 of the largest entry of its tensor, in both rate modes,
    with JAX's FPS starts fed to the port and the patches bit-equal first;
    its chamfer goes through the chamfer kernels' plain versions;
  * the encoder's forward hands its winners to its backward: they equal
    the plain rule's, and a step is bitwise unchanged by the hand-over;
  * three Adam steps across a learning-rate boundary against
    build_train_step + make_optimizer: parameters within atol 2e-6 (float32
    rounding of Adam's update, of the order of lr * 1e-3);
  * the train CLI end to end: pcc_tpu loads its checkpoints, the port's
    compress CLI runs with them, and it resumes from the latest step.
"""

import functools
import glob
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcc_tpu.codec import init_params as j_init_params
from pcc_tpu.config import CodecConfig as JCodecConfig
from pcc_tpu.coding.octree import octree_analyze as j_octree_analyze
from pcc_tpu.ops.fps import fps_batch as j_fps_batch
from pcc_tpu.ops.knn_pruned import grouped_neighbors
from pcc_tpu.ops.normalize import normalize as j_normalize
from pcc_tpu.ops.sa_pallas import patch_encoder_trainable as j_encoder_trainable
from pcc_tpu.train.state import create_train_state as j_create_train_state
from pcc_tpu.train.state import make_optimizer as j_make_optimizer
from pcc_tpu.train.steps import build_train_step as j_build_train_step
from pcc_tpu.train.steps import rd_forward as j_rd_forward
from pcc_tpu_torch.codec import encode_geometry
from pcc_tpu_torch.config import CodecConfig
from pcc_tpu_torch.io import save_point_cloud
from pcc_tpu_torch.ops.sa_cuda import patch_encoder_bwd_plain
from pcc_tpu_torch.train import build_train_step, create_train_state
from pcc_tpu_torch.train.state import make_optimizer
from pcc_tpu_torch.train.steps import rd_forward
from pcc_tpu_torch.weights import from_jax_params, to_jax_params
from test_torch_port_pppf import one_thread_per_worker  # noqa: F401

KW = dict(N=256, N0=64, ALPHA=2, K=32, d=4, L=7, sa_knn=8)
TINY, JTINY = CodecConfig(**KW), JCodecConfig(**KW)
B = 2


@pytest.fixture(scope="module")
def setup():
    """pcc_tpu weights, a batch of clouds, a JAX key and the FPS starts
    jax.random.randint draws from it inside pcc_tpu's rd_forward."""
    ae_vars, prob_vars = jax.jit(j_init_params, static_argnums=1)(jax.random.key(5), JTINY)
    rng = np.random.default_rng(11)
    batch = (rng.random((B, TINY.N, 3)) * 4 - 1).astype(np.float32)
    key = jax.random.key(7)
    starts = np.array(jax.random.randint(key, (B,), 0, TINY.N, dtype=jnp.int32))
    return ae_vars, prob_vars, batch, key, starts


def _port_state(ae_vars, prob_vars, tx):
    """A CPU train state holding pcc_tpu's weights."""
    state = create_train_state(0, TINY, tx, device="cpu")
    ae_sd, prob_sd = from_jax_params(ae_vars, prob_vars)
    state.ae.load_state_dict(ae_sd)
    state.prob.load_state_dict(prob_sd)
    return state


def _grad_trees(state):
    return to_jax_params({n: p.grad for n, p in state.ae.named_parameters()},
                         {n: p.grad for n, p in state.prob.named_parameters()})


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


@pytest.mark.parametrize("twins", [False, True])
def test_encoder_bwd_plain_matches_pallas_backward(rng, twins):
    """tests/test_sa_pallas.py:123-147's shapes and widths. With twins every
    point has an exact duplicate, so every max over points and slots is an
    exact tie, which both route to the first winner (amax-based autograd
    would split it)."""
    P, N, knn = 6, 32, 8
    dims_sa, dims_pn = [3, 32, 64, 128], [3 + 128, 64, 96, 128, 8]

    def wb(dims, scale_w=0.2, scale_b=0.1):
        return [(rng.standard_normal((a, b)).astype(np.float32) * scale_w,
                 rng.standard_normal(b).astype(np.float32) * scale_b)
                for a, b in zip(dims[:-1], dims[1:])]

    patches = rng.random((P, N, 3)).astype(np.float32)
    if twins:
        patches[:, N // 2:] = patches[:, :N // 2]
    sa, pn = wb(dims_sa), wb(dims_pn)
    g = rng.standard_normal((P, 8)).astype(np.float32)

    def loss(p, s, q):
        out = j_encoder_trainable(p, s, q, knn=knn, block_p=4, block_p_bwd=2,
                                  interpret=True)
        return jnp.sum(out * g)

    jx = jax.tree.map(jnp.asarray, (patches, sa, pn))
    ref = jax.grad(loss, argnums=(0, 1, 2))(*jx)
    tt = lambda wbs: [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in wbs]
    dp, dsa, dpn = patch_encoder_bwd_plain(torch.from_numpy(patches), torch.from_numpy(g),
                                           tt(sa), tt(pn), knn)
    ours = [dp] + [t for pair in dsa + dpn for t in pair]
    theirs = jax.tree.leaves(ref)
    assert len(ours) == len(theirs) == 15
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


def test_patches_bit_equal(setup):
    """The step's patches: pcc_tpu's normalize -> FPS -> octree -> pruned
    KNN against the port's encode_geometry, same starts."""
    _, _, batch, _, starts = setup
    pc01, _, _ = jax.vmap(j_normalize)(jnp.asarray(batch))
    idx = j_fps_batch(pc01, JTINY.S, jnp.asarray(starts))
    sampled = jnp.take_along_axis(pc01, idx[..., None], axis=1)
    octree = jax.vmap(functools.partial(j_octree_analyze, N=JTINY.N, min_bpp=JTINY.min_bpp,
                                        max_depth=JTINY.max_depth))(sampled)
    grouped = grouped_neighbors(octree.rec_xyz, pc01, JTINY.K, JTINY.pruned_knn)
    ref = ((grouped - octree.rec_xyz[:, :, None, :]) * JTINY.patch_scale).reshape(
        B * JTINY.S, JTINY.K, 3)
    geo = encode_geometry(torch.from_numpy(batch), torch.from_numpy(starts), TINY)
    np.testing.assert_array_equal(geo.patches.numpy(), np.asarray(ref))


@pytest.fixture(scope="module")
def j_rd(setup):
    """rate_mode -> pcc_tpu's jitted rd_forward ((loss, aux), grads) at lam
    1e-2 on setup's cloud, each computed once for the tests that read it."""
    ae_vars, prob_vars, batch, key, _ = setup

    @functools.cache
    def run(rate_mode):
        return jax.jit(jax.value_and_grad(
            functools.partial(j_rd_forward, cfg=JTINY, rate_mode=rate_mode), has_aux=True))(
            {"ae": ae_vars, "prob": prob_vars}, jnp.asarray(batch), key, 1e-2)
    return run


@pytest.mark.parametrize("rate_mode", ["reference", "fixed"])
def test_rd_forward_loss_aux_and_grads(setup, j_rd, rate_mode):
    ae_vars, prob_vars, batch, key, starts = setup
    lam = 1e-2
    (j_loss, j_aux), j_grads = j_rd(rate_mode)
    state = _port_state(ae_vars, prob_vars, make_optimizer(1e-3, 0.1, 10, 10))
    loss, aux = rd_forward(state.ae, state.prob, torch.from_numpy(batch),
                           torch.from_numpy(starts), lam, TINY, rate_mode)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-6)
    assert set(aux) == set(j_aux) == {"chamfer", "fbpp", "bpp", "true_fbpp"}
    for k in aux:
        np.testing.assert_allclose(float(aux[k].detach()), float(j_aux[k]), rtol=1e-6,
                                   err_msg=k)
    ga, gp = _grad_trees(state)
    ours, theirs = _leaves({"ae": ga, "prob": gp}), _leaves(j_grads)
    assert [p for p, _ in ours] == [p for p, _ in theirs]
    for (path, a), (_, b) in zip(ours, theirs):
        b = np.asarray(b)
        bound = 1e-5 * np.abs(b).max()
        assert np.abs(a - b).max() <= bound, jax.tree_util.keystr(path)


def test_rd_forward_takes_the_chamfer_kernels(setup, j_rd, monkeypatch):
    """At TINY the loss compares [2, 256, 3] decoded points with [2, 256, 3]
    input points, inside the chamfer kernels' domain: rd_forward calls
    chamfer_min_dists once (on the CPU its plain versions), and its loss
    and chamfer still equal pcc_tpu's to rtol 1e-6 (pcc_tpu's CPU path
    searches in XLA with the same semantics)."""
    from pcc_tpu_torch.ops import chamfer

    ae_vars, prob_vars, batch, _, starts = setup
    (j_loss, j_aux), _ = j_rd("reference")
    shapes = []
    routed = chamfer.chamfer_min_dists
    monkeypatch.setattr(chamfer, "chamfer_min_dists",
                        lambda x, y: shapes.append((x.shape, y.shape)) or routed(x, y))
    state = _port_state(ae_vars, prob_vars, make_optimizer(1e-3, 0.1, 10, 10))
    loss, aux = rd_forward(state.ae, state.prob, torch.from_numpy(batch),
                           torch.from_numpy(starts), 1e-2, TINY, "reference")
    assert shapes == [((B, TINY.S * TINY.k, 3), (B, TINY.N, 3))]
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-6)
    np.testing.assert_allclose(float(aux["chamfer"].detach()), float(j_aux["chamfer"]),
                               rtol=1e-6)


def test_encoder_hands_its_winners_to_the_backward(setup, monkeypatch):
    """PatchEncoderFn's forward saves each latent channel's winning point and
    its backward hands them to patch_encoder_bwd_plain: they equal the
    winners the plain backward finds on its own (winners_plain), and one
    rd_forward step's loss and every gradient are bitwise those of the
    backward that finds them itself. One torch thread: a small test."""
    from pcc_tpu_torch.ops import sa_cuda
    from pcc_tpu_torch.ops.knn import select_nearest, sq_dists

    ae_vars, prob_vars, batch, _, starts = setup
    bwd, calls = sa_cuda.patch_encoder_bwd, []

    def handed(patches, g, sa_wb, pn_wb, knn, winners=None, bf16=False):
        calls.append((patches, winners, sa_wb, pn_wb))
        return bwd(patches, g, sa_wb, pn_wb, knn, winners=winners, bf16=bf16)

    def found(patches, g, sa_wb, pn_wb, knn, winners=None, bf16=False):
        return bwd(patches, g, sa_wb, pn_wb, knn, bf16=bf16)

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runs = []
        for fn in (handed, found):
            monkeypatch.setattr(sa_cuda, "patch_encoder_bwd", fn)
            state = _port_state(ae_vars, prob_vars, make_optimizer(1e-3, 0.1, 10, 10))
            loss, _ = rd_forward(state.ae, state.prob, torch.from_numpy(batch),
                                 torch.from_numpy(starts), 1e-2, TINY, "reference")
            loss.backward()
            runs.append([loss.detach()] + [p.grad for _, p in state.named_parameters()
                                           if p.grad is not None])
        (patches, winners, sa_wb, pn_wb), = calls
        assert winners.dtype == torch.int32 and winners.shape == (B * TINY.S, TINY.d)
        with torch.no_grad():
            idx = select_nearest(sq_dists(patches, patches), TINY.sa_knn)
            z4 = sa_cuda.pointwise_plain(patches, idx, sa_wb, pn_wb)
            want = sa_cuda.winners_plain(patches, idx, z4, sa_wb, pn_wb)
        assert torch.equal(winners.long(), want)
    finally:
        torch.set_num_threads(threads)
    assert len(runs[0]) == len(runs[1]) > 1
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_three_adam_steps_across_a_decay_boundary(setup):
    """max_steps 3, decay every 2 steps: updates 0 and 1 at lr, update 2
    at lr * 0.1; rate term on ("fixed", lam 1e-2) so both models train."""
    ae_vars, prob_vars, batch, key, _ = setup
    args = (1e-3, 0.1, 2, 3)
    j_tx = j_make_optimizer(*args)
    j_state = j_create_train_state(jax.random.key(0), JTINY, j_tx)
    j_state = j_state.replace(params={"ae": ae_vars, "prob": prob_vars},
                              opt_state=j_tx.init({"ae": ae_vars, "prob": prob_vars}))
    j_step = j_build_train_step(JTINY, j_tx, rate_mode="fixed")
    tx = make_optimizer(*args)
    assert [tx.lr_at(s) for s in range(4)] == pytest.approx([1e-3, 1e-3, 1e-4, 1e-4])
    state = _port_state(ae_vars, prob_vars, tx)
    step = build_train_step(TINY, tx, rate_mode="fixed")
    keys = jax.random.split(jax.random.key(9), 3)
    for k in keys:
        starts = np.array(jax.random.randint(k, (B,), 0, TINY.N, dtype=jnp.int32))
        j_state, j_aux = j_step(j_state, jnp.asarray(batch), k, 1e-2)
        state, aux = step(state, torch.from_numpy(batch), torch.from_numpy(starts), 1e-2)
        np.testing.assert_allclose(float(aux["loss"]), float(j_aux["loss"]), rtol=1e-5)
    assert state.step == int(j_state.step) == 3
    ours = to_jax_params(state.ae.state_dict(), state.prob.state_dict())
    for (path, a), (_, b) in zip(_leaves({"ae": ours[0], "prob": ours[1]}),
                                 _leaves(j_state.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-6,
                                   err_msg=jax.tree_util.keystr(path))


def test_train_cli_round_trip(tmp_path):
    from pcc_tpu.train.checkpoint import load_inference_params
    from pcc_tpu_torch.cli import compress, train

    rng = np.random.default_rng(3)
    inp, model, comp = tmp_path / "in", tmp_path / "model", tmp_path / "comp"
    for i in range(2):
        save_point_cloud((rng.random((TINY.N, 3)) * 2 - 1).astype(np.float32),
                         f"c{i}.ply", path=str(inp))
    flags = ["--train_glob", str(inp / "*.ply"), "--model_save_folder", str(model),
             "--N", "256", "--N0", "64", "--K", "32", "--d", "4", "--batch_size", "2",
             "--step_window", "1", "--device", "cpu"]
    train.main(flags + ["--max_steps", "2"])
    names = sorted(os.path.basename(f) for f in glob.glob(str(model / "*.pkl")))
    assert names == sorted(
        [f"{m}_step{s}.pkl" for m in ("ae", "prob", "optimizer", "global")
         for s in ("1", "2", "")] + ["ae.pkl", "prob.pkl"])

    ae, prob = load_inference_params(str(model))
    ref_ae, ref_prob = jax.jit(j_init_params, static_argnums=1)(jax.random.key(0), JTINY)
    for got, ref in ((ae, ref_ae), (prob, ref_prob)):
        assert jax.tree.structure(got) == jax.tree.structure(ref)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
            assert a.shape == b.shape and a.dtype == np.float32
    compress.main([str(inp / "*.ply"), str(comp), str(model), "--N0", "64", "--K", "32",
                   "--d", "4", "--device", "cpu"])
    assert len(glob.glob(str(comp / "*.bin"))) == 6

    with open(model / "global_step2.pkl", "rb") as f:
        assert pickle.load(f) == 2
    train.main(flags + ["--max_steps", "4"])
    with open(model / "global_step.pkl", "rb") as f:
        assert pickle.load(f) == 4          # resumed at step 3, then one step
    assert os.path.exists(model / "global_step4.pkl")
    assert not os.path.exists(model / "global_step3.pkl")
