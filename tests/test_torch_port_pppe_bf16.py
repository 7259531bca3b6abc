"""PyTorch port (pcc_tpu_torch) vs pcc_tpu: PPPE's bf16 eval mode on the
CPU, at tests/test_torch_port_pppe.py's config (N = 256, latent_dim 16,
L = 7) in bf16, same numpy-seeded inputs and weights.

  * the bf16 "pppe" stage's plain version (pppf_sa_plain(layout="pppe",
    bf16=True), what pppf_sa_fused runs on CPU tensors) against pcc_tpu's
    _stage_kernel with compute_dtype bfloat16 under the interpreter at
    PPPE's sa2 and sa3 shapes, live BatchNorm statistics; the stage kernel
    adds the float32 bias unrounded, unlike _sa_kernel, and the plain
    version with the biases rounded fails the hold;
  * flax's BatchNorm(dtype=bfloat16) after flax's bf16 Dense, at the
    running statistics (layers.batch_norm_eval) and in training
    (layers.batch_norm_train), bit for bit against the jitted flax
    modules, with a bias (sa1's stacks) and without one (global_conv's
    gc0, whose product XLA keeps unrounded into the BatchNorm);
  * make_pppe_model(PPPEConfig(compute_dtype="bfloat16")) in eval mode
    against pcc_tpu's make_pppe_model(cfg, fused=True) with
    PCC_PALLAS_INTERPRET=1; the running statistics unchanged.

The hold (`_held`, tests/test_torch_port_sa_fused.py's) is the bf16
kernels' of PERF.md: at least 0.95 of the entries bit-equal (a float32 sum
in another order flips a bf16 rounding now and then) and every entry within
BF16_TOL = 2^-7 of the largest |entry|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from pcc_tpu.cli.import_torch_checkpoint import convert_pppe_ae_state_dict
from pcc_tpu.config import PPPEConfig as JPPPEConfig
from pcc_tpu.ops.pppf_sa_pallas import pppf_sa_fused as j_pppf_sa_fused
from pcc_tpu.train.steps_pppe import make_pppe_model as j_make_pppe_model
from pcc_tpu_torch.config import PPPEConfig
from pcc_tpu_torch.models.layers import PointConv, batch_norm_eval, batch_norm_train, dense
from pcc_tpu_torch.models.pppe import make_pppe_model
from pcc_tpu_torch.ops.bf16 import max_bf16, round_bf16
from pcc_tpu_torch.ops.pppf_sa_cuda import bf16_layers, pppf_sa_plain
from pcc_tpu_torch.tools.holds import steady_symbols
from test_torch_port_pppe import _clouds, _test_state
from test_torch_port_pppf import one_thread_per_worker  # noqa: F401
from test_torch_port_sa_fused import BF16, BF16_TOL, _held

KW = dict(N=256, latent_dim=16, L=7, compute_dtype="bfloat16")
CFG, JCFG = PPPEConfig(**KW), JPPPEConfig(**KW)


def _bf16_exact(t: torch.Tensor) -> bool:
    return torch.equal(round_bf16(t), t)


@pytest.mark.parametrize("stage", ["sa2", "sa3"])
def test_pppe_stage_plain_bf16_matches_pallas(stage):
    """PPPE's sa2 (128 of 512 points, 192 features, widths 195-128-128-256)
    and sa3 (32 of 128, 256 features, 259-256-256-512), nsample 32, the
    features bf16 values as sa1 and sa2 hand them over."""
    N, S, C, j = {"sa2": (512, 128, 192, 1), "sa3": (128, 32, 256, 2)}[stage]
    sa = make_pppe_model(CFG).encoder.sa_modules[j]
    prefix = f"encoder.sa_modules.{j}."
    sa.load_state_dict({k[len(prefix):]: v for k, v in _test_state(7).items()
                        if k.startswith(prefix)})
    rng = np.random.default_rng(N + 1)
    xyz = rng.random((1, N, 3)).astype(np.float32)
    new_xyz = np.ascontiguousarray(xyz[:, rng.permutation(N)[:S]])
    feat = round_bf16(torch.from_numpy(np.abs(rng.standard_normal((1, N, C)))
                                       .astype(np.float32))).numpy()
    # live conv biases (seeded weights keep the reference's zeros)
    with torch.no_grad():
        for m in sa.mlp_stack:
            m[0].bias.copy_(torch.from_numpy(
                ((rng.random(m[0].bias.shape[0]) * 2 - 1) * 0.1).astype(np.float32)))
    layers = [tuple(t.detach() for t in lay) for lay in sa.layers()]
    kw = dict(nsample=32, radius=0.0, layout="pppe")
    want = np.asarray(j_pppf_sa_fused(
        jnp.asarray(new_xyz), jnp.asarray(xyz), jnp.asarray(feat),
        [tuple(jnp.asarray(t.numpy()) for t in lay) for lay in layers],
        compute_dtype=BF16, interpret=True, **kw))
    args = (torch.from_numpy(new_xyz), torch.from_numpy(xyz), torch.from_numpy(feat))
    got = pppf_sa_plain(*args, bf16_layers(layers), bf16=True, **kw)
    assert got.shape == (1, S, layers[-1][0].shape[1]) and _bf16_exact(got)
    assert np.abs(want).max() > 0.1
    assert _held(got, want)
    # the bias trap: _stage_kernel adds b as float32
    b_rounded = [(round_bf16(w), round_bf16(b), *rest) for w, b, *rest in layers]
    assert not _held(pppf_sa_plain(*args, b_rounded, bf16=True, **kw), want)


class _DenseBN(nn.Module):
    """flax's bf16 Dense into its bf16 BatchNorm, as pcc_tpu's PN++ stacks
    (bias) and PPPE's gc0 / gc_bn (no bias) run them."""

    bias: bool
    train: bool

    @nn.compact
    def __call__(self, x):
        h = nn.Dense(64, use_bias=self.bias, dtype=BF16)(x)
        return nn.BatchNorm(use_running_average=not self.train, dtype=BF16)(h)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_dense_batch_norm_bf16_bit_equal_to_flax(bias, train):
    """The port's dense(..., to_float32=True) into batch_norm_eval /
    batch_norm_train with bf16=True: the output bit for bit flax's, and in
    training the running statistics' update too (to a float32 ulp: the
    means sum in another order). With a bias, on rows as sa1's stacks take
    them [B, S, K, C]; without one, on [B, C] rows as PPPE's gc0 takes
    them, where XLA keeps the Dense's product unrounded as well: rounding
    it (as the port did before, also in bf16 training) moves about a
    quarter of the outputs."""
    rng = np.random.default_rng(3 + bias + 2 * train)
    x = rng.standard_normal((2, 4, 8, 48) if bias else (6, 48)).astype(np.float32)
    m = _DenseBN(bias, train)
    v = jax.tree.map(np.asarray, m.init(jax.random.key(0), jnp.asarray(x)))
    stats = {"mean": (rng.standard_normal(64) * 0.1).astype(np.float32),
             "var": (rng.random(64) + 0.5).astype(np.float32)}
    scale = ((rng.random(64) + 0.5) * np.where(rng.random(64) < 0.25, -1, 1)).astype(np.float32)
    v = {"params": {**v["params"], "BatchNorm_0": {
        "scale": scale, "bias": ((rng.random(64) - 0.3) * 0.2).astype(np.float32)}},
         "batch_stats": {"BatchNorm_0": stats}}
    if train:
        want, upd = jax.jit(lambda v, a: m.apply(v, a, mutable=["batch_stats"]))(v, x)
        upd = jax.tree.map(np.asarray, upd["batch_stats"]["BatchNorm_0"])
    else:
        want = jax.jit(m.apply)(v, x)
    want = np.asarray(want).astype(np.float32)

    conv = PointConv(48, 64, bias=bias)
    norm = torch.nn.BatchNorm2d(64)
    t = torch.from_numpy
    with torch.no_grad():
        conv.weight.copy_(t(np.asarray(v["params"]["Dense_0"]["kernel"]).T[..., None, None]))
        if bias:
            conv.bias.copy_(t(np.asarray(v["params"]["Dense_0"]["bias"])))
        norm.weight.copy_(t(scale))
        norm.bias.copy_(t(v["params"]["BatchNorm_0"]["bias"]))
        norm.running_mean.copy_(t(stats["mean"]))
        norm.running_var.copy_(t(stats["var"]))
        h = dense(conv, t(x), True, to_float32=True)
        got = (batch_norm_train if train else batch_norm_eval)(h, norm, bf16=True)
    assert _bf16_exact(got)
    np.testing.assert_array_equal(got.numpy(), want)
    if train:
        for name, ref in (("running_mean", upd["mean"]), ("running_var", upd["var"])):
            np.testing.assert_allclose(getattr(norm, name).numpy(), ref, rtol=2e-7, atol=1e-8)
    else:
        assert torch.equal(norm.running_mean, t(stats["mean"]))
    if not bias:
        with torch.no_grad():
            rounded = (batch_norm_train if train else batch_norm_eval)(
                round_bf16(h), norm, bf16=True)
        assert float((rounded.numpy() != want).mean()) > 0.1


@pytest.fixture(scope="module")
def bf16_models():
    """(port model in bf16 eval mode, pcc_tpu's variables): the seeded test
    state with its latent head back at the seeded weights (not spread over
    the bins) and made steady (tools/holds.py::steady_symbols: every latent
    near the middle of its bin)."""
    port = make_pppe_model(CFG)
    port.load_state_dict(_test_state(5))
    with torch.no_grad():
        port.encoder.global_conv[3].weight.div_(60.0)
    steady_symbols(port, 3)
    variables = convert_pppe_ae_state_dict({k: v.numpy() for k, v in port.state_dict().items()})
    return port, variables


def _pcc_tpu_run(variables, x, fused: bool):
    """pcc_tpu's make_pppe_model(cfg, fused) in eval mode, jitted: the
    model's outputs and the encoder's intermediates."""
    jm = j_make_pppe_model(JCFG, fused=fused)
    out, inter = jax.jit(lambda v, a: (
        jm.apply(v, a),
        jm.apply(v, a, method=lambda m, pc: m.encoder(pc), capture_intermediates=True)[1]))(
        variables, jnp.asarray(x))
    return jax.tree.map(lambda a: np.asarray(a).astype(np.float32), (out, inter))


def test_bf16_eval_model_matches_pcc_tpu_fused(bf16_models, monkeypatch):
    """The bf16 eval model against pcc_tpu's fused=True model (its sa2 and
    sa3 on the Pallas stage under the interpreter):
      * the global feature (cond_feats) under the bf16 hold, sa1's output bit
        for bit, sa2's and sa3's under the hold;
      * the head (max, gc0, gc_bn, relu, gc1) on pcc_tpu's own sa3 output
        bit for bit;
      * the latents within BF16_TOL of their largest entry and the symbols
        equal, mid-bin; the coarse and fine clouds equal.
    The latents themselves are not held to a share: a bf16 rounding that the
    stages' float32 sums flip (sa3: about 0.3% of its entries) moves gc0's
    512-long unrounded product and so most latents of its cloud by an ulp.
    The control: pcc_tpu's fused=False model (its stages on flax's bf16
    Dense and BatchNorm, other rounding points) fails the global feature's
    hold."""
    port, variables = bf16_models
    x = _clouds(1, 2)
    monkeypatch.setenv("PCC_PALLAS_INTERPRET", "1")
    (want, inter) = _pcc_tpu_run(variables, x, fused=True)
    monkeypatch.delenv("PCC_PALLAS_INTERPRET")
    (unfused, _) = _pcc_tpu_run(variables, x, fused=False)
    inter = inter["intermediates"]["encoder"]
    enc = port.encoder
    with torch.no_grad():
        got = port(torch.from_numpy(x))
        xyz, feat = torch.from_numpy(x), None
        for i, sa in enumerate(enc.sa_modules):
            xyz, feat = sa(xyz, feat)
            w = inter[f"sa{i + 1}"]["__call__"][0]
            assert np.array_equal(xyz.numpy(), w[0])
            assert _bf16_exact(feat)
            if i == 0:
                np.testing.assert_array_equal(feat.numpy(), w[1])
            else:
                assert _held(feat, w[1]), i
        # the head on pcc_tpu's sa3 output
        g = max_bf16(torch.from_numpy(inter["sa3"]["__call__"][0][1]), 1)
        h = dense(enc.global_conv[0], g, True, to_float32=True)
        h = torch.relu(batch_norm_eval(h, enc.global_conv[1], bf16=True))
        lat = dense(enc.global_conv[3], h, True, to_float32=True)
    lat_want = inter["__call__"][0][0]
    np.testing.assert_array_equal(lat.numpy(), lat_want)
    coarse, fine, cond, y_q = (t.numpy() for t in got)
    assert _held(cond, want[2]) and not _held(cond, unfused[2])
    lat_got = port.encoder(torch.from_numpy(x))[0].detach().numpy()
    assert np.abs(lat_got - lat_want).max() <= BF16_TOL * np.abs(lat_want).max()
    frac = np.clip(lat_want, 0, CFG.L - 1) % 1.0
    assert np.all(np.minimum(frac, 1 - frac) < 0.25)     # mid-bin: far from a .5 boundary
    np.testing.assert_array_equal(y_q, want[3])
    assert np.ptp(y_q) >= 3
    np.testing.assert_array_equal(coarse, want[0])
    np.testing.assert_array_equal(fine, want[1])


def test_bf16_eval_keeps_running_statistics():
    """A bf16 eval forward reads the running statistics and updates none
    (sa1's stacks and gc_bn run batch_norm_eval, sa2 and sa3 the stage on
    the folded statistics); a bf16 train forward moves every one."""
    model = make_pppe_model(CFG, seed=0)
    model.load_state_dict(_test_state(9))
    x = torch.from_numpy(_clouds(4, 2))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        lat, cond = model.encoder(x)
        assert torch.isfinite(lat).all() and _bf16_exact(cond)
        assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
        model.train()(x)
    moved = [k for k, v in model.state_dict().items()
             if k.endswith("running_var") and not torch.equal(v, before[k])]
    assert len(moved) == 4 * 3 + 1
