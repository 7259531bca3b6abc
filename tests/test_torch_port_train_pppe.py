"""PyTorch port (pcc_tpu_torch) vs pcc_tpu: PPPE whole-cloud training on the
CPU, at tests/test_torch_port_pppe.py's config (N = 256, latent_dim 16,
L = 7, full encoder widths), with that file's seeded weights (live
BatchNorm statistics, a quarter of the scales negative, the latent head
spread over the L bins) carried to pcc_tpu by weights.to_jax_params, and
the same numpy clouds.

  * quantize_st's gradient against jax.grad of pcc_tpu's, on latents on
    both bounds, inside and outside the range: equal (jnp.clip's 0.5 on a
    bound);
  * three train steps in float64 against pcc_tpu's pppe_forward, optax's
    clip_by_global_norm(1.0) + Adam update and its NaN select, all jitted:
    the train-mode forward (coarse, fine, global feature, y_q) and the
    detached rate, loss and aux, every gradient, the updated parameters,
    Adam moments and running statistics, the third step after a change of
    the learning rate (cosine_epoch_lr's next epoch), the clip active
    (float64: pcc_tpu's float32 batch statistics are ill-conditioned at
    this size, ROADMAP §3; its own float32 casts set the tolerances, stated
    in the test);
  * a step on a batch with a NaN leaves the whole state bit for bit;
  * cosine_epoch_lr equal to pcc_tpu's;
  * a port checkpoint read by pcc_tpu's load_pppe_checkpoint, and resumed
    by the port;
  * the train CLI for 2 steps, whose ae_latest.pkl the port's PPPE compress
    and decompress CLIs load, and for one --bf16 step, whose float32
    checkpoint the compress CLI serves.
One jitted pcc_tpu function serves every float64 step.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pcc_tpu.config import PPPEConfig as JPPPEConfig
from pcc_tpu.models.pppe import quantize_st as j_quantize_st
from pcc_tpu.train.checkpoint import load_pppe_checkpoint as j_load_pppe_checkpoint
from pcc_tpu.train.steps_pppe import PPPETrainState as JPPPETrainState
from pcc_tpu.train.steps_pppe import cosine_epoch_lr as j_cosine_epoch_lr
from pcc_tpu.train.steps_pppe import make_pppe_model as j_make_pppe_model
from pcc_tpu.train.steps_pppe import make_pppe_optimizer as j_make_pppe_optimizer
from pcc_tpu.train.steps_pppe import pppe_forward as j_pppe_forward
from pcc_tpu.train.steps_pppe import set_lr as j_set_lr
from pcc_tpu_torch.config import PPPEConfig
from pcc_tpu_torch.io import save_point_cloud
from pcc_tpu_torch.models.pppe import quantize_st
from pcc_tpu_torch.train.checkpoint import resume_pppe_checkpoint, save_pppe_checkpoint
from pcc_tpu_torch.train.steps_pppe import (build_pppe_train_step, cosine_epoch_lr,
                                            create_pppe_state, make_pppe_optimizer, set_lr)
from pcc_tpu_torch.weights import to_jax_params
from test_torch_port_pppe import _test_state
from test_torch_port_pppf import one_thread_per_worker  # noqa: F401

CFG = PPPEConfig(N=256, latent_dim=16, L=7)
JCFG = JPPPEConfig(N=256, latent_dim=16, L=7)
B = 2
LR = 5e-4
LAM = 0.5


def test_quantize_st_gradient_matches_jax():
    """Latents on both bounds (0, 6), rounding onto them (0.2, 5.7), inside
    (2.3, 3.5) and outside (-1, 7.5): jax.grad through pcc_tpu's jnp.clip
    gives 0.5 where an input or a rounded symbol sits on a bound, which
    torch.clamp would give as 1."""
    x = np.array([-1.0, 0.0, 0.2, 2.3, 3.5, 5.7, 6.0, 7.5], np.float32)
    w = np.arange(1, 9, dtype=np.float32)
    want = np.asarray(jax.grad(lambda v: jnp.sum(j_quantize_st(v, 0.0, 6.0, 7) * w))(
        jnp.asarray(x)))
    t = torch.from_numpy(x.copy()).requires_grad_(True)
    (quantize_st(t, 0.0, 6.0, 7) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), want)
    assert want[1] == 0.25 * w[1] and want[2] == 0.5 * w[2] and want[6] == 0.25 * w[6]


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _nn_expansion_one_chunk(x, y, chunk=None):
    """pcc_tpu.ops.chamfer._nn_expansion for clouds of one chunk (N <=
    2048), without its scan: the expansion's argmin, lowest index on ties,
    which is what its scan computes over one chunk. The scan's int32 carry
    meets jnp.arange's int64 under x64 and fails to trace."""
    x2 = jnp.sum(x * x, axis=-1)
    d = x2[:, None] - 2.0 * (x @ y.T) + jnp.sum(y * y, axis=-1)[None, :]
    return jnp.argmin(d, axis=-1)


@pytest.fixture(scope="module")
def setup():
    """The weights as port state_dict and pcc_tpu float64 trees, the clouds,
    and pcc_tpu's jitted float64 forward with its gradients and a jitted
    optimizer step (clip, Adam, the NaN select of build_pppe_train_step).
    pcc_tpu's chamfer search is _nn_expansion_one_chunk while the module
    runs (the clouds have N = 256 points, one chunk)."""
    import pcc_tpu.ops.chamfer as j_chamfer

    mp = pytest.MonkeyPatch()
    mp.setattr(j_chamfer, "_nn_expansion", _nn_expansion_one_chunk)
    sd = _test_state(5)
    ae_vars = _f64(to_jax_params({k: v for k, v in sd.items()})[0])
    batch = np.random.default_rng(11).random((B, CFG.N, 3))
    jmodel = j_make_pppe_model(JCFG)
    tx = j_make_pppe_optimizer(LR)

    def fwd(params, stats, x, lam):
        (loss, (aux, new_stats)), grads = jax.value_and_grad(
            lambda p: j_pppe_forward(p, stats, x, lam, cfg=JCFG), has_aux=True)(params)
        outs, _ = jmodel.apply({"params": params["ae"], "batch_stats": stats["ae"]}, x,
                               train=True, mutable=["batch_stats"])
        return loss, aux, new_stats, grads, outs

    def update(state, grads, new_stats, loss):
        ok = jnp.isfinite(loss)
        new = state.apply_gradients(grads, tx).replace(batch_stats=new_stats)
        return jax.tree.map(lambda a, b: jnp.where(ok, a, b), new, state), optax.global_norm(grads)

    with jax.enable_x64(True):
        j_fwd, j_update = jax.jit(fwd), jax.jit(update)
        params = {"ae": ae_vars["params"]}
        state0 = JPPPETrainState(params=params, batch_stats={"ae": ae_vars["batch_stats"]},
                                 opt_state=tx.init(params), step=0)
        state0 = j_set_lr(state0, LR)
    yield sd, batch, j_fwd, j_update, state0
    mp.undo()


def _port_state(sd, dtype=torch.float64):
    tx = make_pppe_optimizer(LR)
    state = create_pppe_state(0, CFG, tx, device="cpu", dtype=dtype)
    state.model.load_state_dict(sd)
    return tx, state


def _trees(state, grads: bool = False):
    sd = dict(state.model.state_dict())
    if grads:
        sd.update({k: p.grad if p.grad is not None else torch.zeros_like(p)
                   for k, p in state.model.named_parameters()})
    return to_jax_params(sd)[0]


def _close(ours, ref, rel, what):
    """Every leaf within rel of its reference's largest entry, or of 1e-6
    where that is smaller (the gradient of a conv bias before batch
    statistics is 0 up to rounding, about 1e-17)."""
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(ours),
                                 jax.tree_util.tree_leaves_with_path(ref)):
        b = np.asarray(b)
        assert a.shape == b.shape
        err = np.abs(a - b).max()
        assert err <= rel * max(np.abs(b).max(), 1e-6), (what, jax.tree_util.keystr(path), err)


def test_train_step_matches_pcc_tpu_float64(setup):
    """Three steps in float64 against pcc_tpu's, the third after set_lr to
    the next epoch's learning rate; the clip is active in all three. Even
    under x64 pcc_tpu rounds the latent, the global feature, the coarse and
    the fine cloud to float32 (pcc_tpu/models/pppe.py:179-181, 199-204), and
    with them their cotangents, so the bars are those roundings', not
    float64's (measured in brackets): the forward's outputs within 2^-23 of
    their largest entry (5.7e-8); loss, dist and rate to 1e-7 relative
    (1.3e-8); every gradient within 1e-6 of its tensor's largest entry
    (2.3e-7); Adam's first moments within 1e-5 of theirs (2.7e-6); the
    running statistics within 1e-7 (3.7e-9); the parameters within 2e-3 *
    lr (9.5e-4 * lr: Adam moves an entry by lr * g / (|g| + eps), which
    follows the last bits of g where |g| is near eps, as for a conv bias
    before batch statistics, whose gradient is 0 up to rounding)."""
    sd, batch, j_fwd, j_update, jstate = setup
    tx, state = _port_state(sd)
    step = build_pppe_train_step(tx)
    x = torch.from_numpy(batch)
    for i in range(3):
        if i == 2:
            lr = cosine_epoch_lr(LR, 1)
            assert lr != LR and lr == j_cosine_epoch_lr(LR, 1)
            set_lr(state, lr)
            jstate = j_set_lr(jstate, lr)
        with jax.enable_x64(True):
            loss, aux, new_stats, grads, outs = jax.tree.map(
                np.asarray, j_fwd(jstate.params, jstate.batch_stats, jnp.asarray(batch), LAM))
            jstate, g_norm = j_update(jstate, grads, new_stats, loss)
        assert float(g_norm) >= 1.0
        if i == 0:
            with torch.no_grad():
                got = copy.deepcopy(state.model)(x)
            for g, w, name in zip(got, outs, ("coarse", "fine", "cond_feats", "y_q")):
                assert g.dtype == torch.float64, name
                np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                           atol=2.0 ** -23 * np.abs(w).max(), err_msg=name)
        _, got = step(state, x, LAM)
        assert not bool(got["skipped"])
        for k in ("dist", "rate"):
            np.testing.assert_allclose(float(got[k]), float(aux[k]), rtol=1e-7, err_msg=k)
        np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=1e-7)
        if i == 0:
            assert 0.0 < float(aux["rate"]) < 100.0
            _close(_trees(state, grads=True)["params"], grads["ae"], 1e-6, "grad")
        now = _trees(state)
        for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(now["params"]),
                                     jax.tree_util.tree_leaves_with_path(jstate.params["ae"])):
            assert np.abs(a - np.asarray(b)).max() <= 2e-3 * LR, (i, jax.tree_util.keystr(path))
        _close(now["batch_stats"], jstate.batch_stats["ae"], 1e-7, f"stats {i}")
        adam = jstate.opt_state.inner_state[1][0]
        mu = dict(state.model.state_dict()) | state.views(state.mu)
        _close(to_jax_params(mu)[0]["params"], adam.mu["ae"], 1e-5, f"mu {i}")
        assert int(state.count) == int(adam.count) == i + 1 == int(state.step)


def test_nan_batch_leaves_the_state_unchanged(setup):
    """A NaN in the batch: loss not finite, the step skipped on the device;
    parameters, Adam moments and count, running statistics and step bit for
    bit as they were (float32, as the CLI trains)."""
    sd, batch, _, _, _ = setup
    tx, state = _port_state(sd, torch.float32)
    step = build_pppe_train_step(tx)
    x = torch.from_numpy(batch.astype(np.float32))
    step(state, x, LAM)
    before = [t.clone() for t in (state.params, state.stats, state.mu, state.nu,
                                  state.count, state.step)]
    bad = x.clone()
    bad[1, 17, 2] = float("nan")
    _, aux = step(state, bad, LAM)
    assert bool(aux["skipped"]) and not np.isfinite(float(aux["loss"]))
    for a, b in zip(before, (state.params, state.stats, state.mu, state.nu,
                             state.count, state.step)):
        assert torch.equal(a, b)
    _, aux = step(state, x, LAM)
    assert not bool(aux["skipped"]) and int(state.count) == 2


def test_cosine_epoch_lr_matches_pcc_tpu():
    for epoch in (0, 1, 37, 99, 100, 150, 199, 200, 345):
        assert cosine_epoch_lr(5e-4, epoch) == j_cosine_epoch_lr(5e-4, epoch)
        assert cosine_epoch_lr(1e-3, epoch, 10, 1e-5) == j_cosine_epoch_lr(1e-3, epoch, 10, 1e-5)


def test_checkpoint_read_by_pcc_tpu_and_resumed(setup, tmp_path):
    """save_pppe_checkpoint after a step: pcc_tpu's load_pppe_checkpoint
    reads the weights and running statistics exactly and the step number;
    the port resumes weights, statistics, Adam moments, count and step."""
    sd, batch, _, _, jstate = setup
    tx, state = _port_state(sd, torch.float32)
    build_pppe_train_step(tx)(state, torch.from_numpy(batch.astype(np.float32)), LAM)
    save_pppe_checkpoint(str(tmp_path), state, 7)
    names = sorted(os.listdir(tmp_path))
    assert names == sorted(f"{m}_latest.pkl" for m in ("ae", "prob", "optimizer", "global"))

    loaded, start = j_load_pppe_checkpoint(str(tmp_path), jstate)
    assert start == 8
    want = _trees(state)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(
            {"params": loaded.params["ae"], "batch_stats": loaded.batch_stats["ae"]})):
        np.testing.assert_array_equal(a, np.asarray(b))

    _, fresh = _port_state(_test_state(6), torch.float32)
    fresh, start = resume_pppe_checkpoint(str(tmp_path), fresh)
    assert start == 8 and int(fresh.step) == 8
    for a, b in ((fresh.params, state.params), (fresh.stats, state.stats),
                 (fresh.mu, state.mu), (fresh.nu, state.nu), (fresh.count, state.count)):
        assert torch.equal(a, b)


def test_train_cli_then_compress(tmp_path):
    """cli/train_pppe_pcd_ae.py for 2 steps at --step_window 1: the best and
    latest checkpoints and dataset_norm.pkl; ae_latest.pkl loads in the
    port's PPPE compress CLI, whose .bin decompresses."""
    from pcc_tpu_torch.cli import pppe_pcd_compress, pppe_pcd_decompress, train_pppe_pcd_ae

    rng = np.random.default_rng(4)
    inp, model = tmp_path / "in", tmp_path / "model"
    for i in range(2):
        save_point_cloud(rng.random((CFG.N, 3)).astype(np.float32), f"c{i}.ply", path=str(inp))
    flags = ["--N", str(CFG.N), "--K", str(CFG.latent_dim), "--L", str(CFG.L), "--device", "cpu"]
    train_pppe_pcd_ae.main(["--train_glob", str(inp / "*.ply"), "--model_save_folder",
                            str(model), "--batch_size", "2", "--step_window", "1",
                            "--max_steps", "2", "--warmup_steps", "1"] + flags)
    assert sorted(os.listdir(model)) == sorted(
        [f"{m}_{s}.pkl" for m in ("ae", "prob", "optimizer", "global")
         for s in ("latest", "best")] + ["dataset_norm.pkl"])
    pppe_pcd_compress.main([str(inp / "*.ply"), str(tmp_path / "comp"), str(model)] + flags)
    pppe_pcd_decompress.main([str(tmp_path / "comp" / "*.bin"), str(tmp_path / "dec"),
                              str(model)] + flags)
    assert len(os.listdir(tmp_path / "dec")) == 2
    # --bf16: one bf16 step, a float32 checkpoint the float32 CLIs serve
    model16 = tmp_path / "model16"
    train_pppe_pcd_ae.main(["--train_glob", str(inp / "*.ply"), "--model_save_folder",
                            str(model16), "--batch_size", "2", "--step_window", "1",
                            "--max_steps", "1", "--warmup_steps", "1", "--bf16"] + flags)
    pppe_pcd_compress.main([str(inp / "*.ply"), str(tmp_path / "comp16"), str(model16)]
                           + flags)
    assert len(os.listdir(tmp_path / "comp16")) == 2
