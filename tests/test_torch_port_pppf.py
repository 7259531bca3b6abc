"""PyTorch port (pcc_tpu_torch) vs pcc_tpu: the PPPF-AE models and the plain
version of the fused PN++ set-abstraction stage, on the CPU.

The plain stage is held against pcc_tpu's Pallas kernel under the
interpreter at the three stage shapes of tests/test_pppf_sa_pallas.py, in
both layouts, with non-trivial BatchNorm statistics and negative scales, at
atol 1e-5 (float32 sums in another order). The models run on pcc_tpu's XLA
path on the port's seeded weights moved through pcc_tpu_torch.weights, at
atol 2e-5.
FoldingNet's grid is held bit-equal to pcc_tpu's jitted one. The per-point
form of the "pppf" stage (the stack on each point once, then each query's
max over its points) is held equal to the per-slot plain version in
float64. The weight bridge is checked bitwise. Last, one
in-process CLI round trip with --model PPPF-AE from an ae.pkl / prob.pkl
that pcc_tpu wrote.
"""

import functools
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcc_tpu.cli.import_torch_checkpoint import (convert_pppf_ae_state_dict,
                                                 convert_pppf_prob_state_dict)
from pcc_tpu.models.pppf import FoldingNet as JFoldingNet
from pcc_tpu.models.pppf import PPPF_AE as JPPPF_AE
from pcc_tpu.models.pppf import PPPFConditionalProbabilityModel as JPPPFProb
from pcc_tpu.ops.knn import ball_query as j_ball_query
from pcc_tpu.ops.pppf_sa_pallas import pppf_sa_fused as j_pppf_sa_fused
from pcc_tpu.train.checkpoint import _dump as j_dump
from pcc_tpu_torch.codec import init_params
from pcc_tpu_torch.config import CodecConfig
from pcc_tpu_torch.io import read_point_cloud, save_point_cloud
from pcc_tpu_torch.models.layers import torch_dense_init_
from pcc_tpu_torch.models.pppf import FoldingNet, PPPF_AE, PPPFConditionalProbabilityModel
from pcc_tpu_torch.ops.knn import ball_query
from pcc_tpu_torch.ops.pppf_sa_cuda import (fold_bn, pppe_plan, pppe_sa_points, pppf_sa_fused,
                                            pppf_sa_plain, pppf_sa_points)
from pcc_tpu_torch.weights import from_jax_params, load_inference_params, to_jax_params


@pytest.fixture(scope="module", autouse=True)
def one_thread_per_worker():
    """numpy's BLAS and torch on one thread each for this module: several
    test workers share the cores, and their thread pools, each as wide as
    the machine, slow one another down many times over."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:                 # torch alone is limited then
        threadpool_limits = None
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        if threadpool_limits is None:
            yield
        else:
            with threadpool_limits(limits=1, user_api="blas"):
                yield
    finally:
        torch.set_num_threads(n)


def _tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _tree_equal(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


def _live_stats(state, seed):
    """A copy of a state_dict with non-trivial BatchNorm entries from a numpy
    seed: running means around 0, variances in [0.5, 1.5], scales in
    [0.5, 1.5] with about a quarter negative, small biases."""
    rng = np.random.default_rng(seed)
    out = dict(state)
    for key in state:
        if not key.endswith(".running_mean"):
            continue
        stem, n = key[:-len("running_mean")], state[key].shape[0]
        sign = np.where(rng.random(n) < 0.25, -1.0, 1.0)
        for name, val in (("running_mean", rng.standard_normal(n) * 0.1),
                          ("running_var", rng.random(n) + 0.5),
                          ("weight", (rng.random(n) + 0.5) * sign),
                          ("bias", (rng.random(n) - 0.3) * 0.2)):
            out[stem + name] = torch.from_numpy(val.astype(np.float32))
    return out


def _seeded(module, seed):
    """`module` in eval mode with seeded random weights and live BatchNorm
    statistics."""
    torch_dense_init_(module, torch.Generator().manual_seed(seed))
    module.load_state_dict(_live_stats(module.state_dict(), seed + 1))
    return module.eval()


# --------------------------------------------------------------- the stage --

_SHAPES = [
    (64, 0.2, 8, (3, 16, 16, 32), 64, 0),      # sa1 shape (npoint == N)
    (32, 0.4, 16, (24, 16, 32), 64, 21),       # sa2 shape (FPS + features)
    (8, 0.8, 32, (40, 32, 48), 32, 37),        # sa3 shape (nsample == N)
]


@pytest.mark.parametrize("layout", ["pppf", "pppe"])
@pytest.mark.parametrize("npoint,radius,nsample,mlp,N,C", _SHAPES)
def test_stage_plain_matches_pallas_interpret(npoint, radius, nsample, mlp, N, C, layout):
    rng = np.random.default_rng(11)
    P = 4
    xyz = rng.random((P, N, 3)).astype(np.float32)
    new_xyz = xyz if npoint == N else np.ascontiguousarray(
        xyz[:, rng.permutation(N)[:npoint]])
    feat = rng.random((P, N, C)).astype(np.float32) if C else None
    layers = []
    cin = C + 3
    for cout in mlp:
        bound = cin ** -0.5
        sign = np.where(rng.random(cout) < 0.25, -1.0, 1.0)
        layers.append(tuple(a.astype(np.float32) for a in (
            (rng.random((cin, cout)) * 2 - 1) * bound,         # W
            (rng.random(cout) * 2 - 1) * bound,                # b
            rng.standard_normal(cout) * 0.1,                   # running mean
            (rng.random(cout) + 0.5) * sign,                   # rsqrt(var + eps) * scale
            (rng.random(cout) - 0.3) * 0.2)))                  # BatchNorm bias
        cin = cout
    ref = np.asarray(j_pppf_sa_fused(
        jnp.asarray(new_xyz), jnp.asarray(xyz), None if feat is None else jnp.asarray(feat),
        [tuple(jnp.asarray(a) for a in lay) for lay in layers], nsample=nsample,
        radius=radius, layout=layout, interpret=True))
    t = torch.from_numpy
    args = (t(new_xyz), t(xyz), None if feat is None else t(feat),
            [tuple(t(a) for a in lay) for lay in layers])
    out = pppf_sa_plain(*args, nsample=nsample, radius=radius, layout=layout)
    assert out.shape == ref.shape == (P, npoint, mlp[-1])
    assert float(np.abs(ref).max()) > 0.05
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    # on CPU tensors the wrapper is the plain version
    assert torch.equal(pppf_sa_fused(*args, nsample=nsample, radius=radius, layout=layout),
                       out)


def test_fold_bn_matches_pcc_tpu():
    from pcc_tpu.ops.pppf_sa_pallas import fold_bn as j_fold_bn

    rng = np.random.default_rng(3)
    bn = torch.nn.BatchNorm2d(40)
    vals = {k: (rng.random(40) + 0.1).astype(np.float32) for k in
            ("scale", "bias", "mean", "var")}
    vals["scale"] *= np.where(rng.random(40) < 0.5, -1, 1).astype(np.float32)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(vals["scale"]))
        bn.bias.copy_(torch.from_numpy(vals["bias"]))
        bn.running_mean.copy_(torch.from_numpy(vals["mean"]))
        bn.running_var.copy_(torch.from_numpy(vals["var"]))
    ref = j_fold_bn({"scale": jnp.asarray(vals["scale"]), "bias": jnp.asarray(vals["bias"])},
                    {"mean": jnp.asarray(vals["mean"]), "var": jnp.asarray(vals["var"])})
    for a, b in zip(fold_bn(bn), ref):
        # rsqrt may round its last place differently in the two libraries
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=3e-7, atol=0)


# (S, N, nsample, radius, query offset, widths after the input): patches of
# K = 32 points; a stage at nsample > N; one whose queries lie outside every
# point's radius (each slot reads point 0)
_POINT_CASES = [
    (16, 32, 8, 0.3, 0.0, (16, 16, 32)),
    (8, 32, 64, 0.5, 0.0, (16, 24)),
    (8, 32, 16, 0.2, 5.0, (16, 16, 32)),
]


@pytest.mark.parametrize("S,N,nsample,radius,offset,widths", _POINT_CASES)
def test_stage_per_point_equals_plain_in_float64(S, N, nsample, radius, offset, widths):
    """The "pppf" stage's per-point form (the stack once on each point's
    row, then each query's max over the points its slots read, point 0 for
    a masked slot or one beyond N), which the stage kernel computes, equals
    the per-slot plain version: in float64 no sum or tie rounds differently."""
    rng = np.random.default_rng(17)
    P, C = 3, 5
    xyz = rng.random((P, N, 3))
    new_xyz = xyz[:, rng.permutation(N)[:S]] + offset
    feat = rng.random((P, N, C))
    layers, cin = [], C + 3
    for cout in widths:
        sign = np.where(rng.random(cout) < 0.25, -1.0, 1.0)
        layers.append(tuple(torch.from_numpy(a) for a in (
            (rng.random((cin, cout)) * 2 - 1) * cin ** -0.5, rng.random(cout) * 0.2 - 0.1,
            rng.standard_normal(cout) * 0.1, (rng.random(cout) + 0.5) * sign,
            (rng.random(cout) - 0.3) * 0.2)))
        cin = cout
    args = (torch.from_numpy(new_xyz), torch.from_numpy(xyz), torch.from_numpy(feat), layers)
    ref = pppf_sa_plain(*args, nsample=nsample, radius=radius)
    out = pppf_sa_points(*args, nsample=nsample, radius=radius)
    assert out.dtype == torch.float64 and out.shape == (P, S, widths[-1])
    assert torch.equal(out, ref)
    if offset:
        # every slot reads point 0: each query gives point 0's activation
        assert torch.equal(out, out[:, :1].expand_as(out))
    else:
        assert 0 < float((out > 0).double().mean()) < 1


# (case, S, N, C, nsample, offset, widths after the input) for the "pppe"
# stage's per-point form: PPPE's sa2 widths at a small size, clouds 100 away
# from the origin, no features, nsample > N (slots read point 0)
_PPPE_POINT_CASES = [
    ("sa2_like", 16, 64, 192, 32, 0.0, (128, 128, 256)),
    ("offset", 8, 32, 24, 8, 100.0, (32, 48)),
    ("no_features", 8, 32, 0, 8, 0.0, (16, 32)),
    ("ns_gt_n", 4, 16, 6, 24, 0.0, (16,)),
]


@pytest.mark.parametrize("case,S,N,C,nsample,offset,widths", _PPPE_POINT_CASES)
def test_pppe_per_point_equals_plain_in_float64(case, S, N, C, nsample, offset, widths):
    """The "pppe" stage's per-point form (the first layer's feature block
    once per point, the centred xyz part per slot), which the stage kernel
    computes, equals the per-slot plain version in float64 to 1e-12 of the
    output's largest entry (the two sum the first layer in another order),
    on clouds far from the origin too."""
    rng = np.random.default_rng(19)
    P = 3
    xyz = rng.random((P, N, 3)) + offset
    new_xyz = xyz[:, rng.permutation(N)[:S]]
    feat = rng.standard_normal((P, N, C)) if C else None
    layers, cin = [], C + 3
    for cout in widths:
        sign = np.where(rng.random(cout) < 0.25, -1.0, 1.0)
        layers.append(tuple(torch.from_numpy(a) for a in (
            (rng.random((cin, cout)) * 2 - 1) * cin ** -0.5, rng.random(cout) * 0.2 - 0.1,
            rng.standard_normal(cout) * 0.1, (rng.random(cout) + 0.5) * sign,
            (rng.random(cout) - 0.3) * 0.2)))
        cin = cout
    args = (torch.from_numpy(new_xyz), torch.from_numpy(xyz),
            None if feat is None else torch.from_numpy(feat), layers)
    ref = pppf_sa_plain(*args, nsample=nsample, radius=0.0, layout="pppe")
    out = pppe_sa_points(*args, nsample=nsample)
    assert out.dtype == torch.float64 and out.shape == (P, S, widths[-1])
    assert float((out - ref).abs().max()) <= 1e-12 * float(ref.abs().max())
    assert bool((out > 0).any())


@pytest.mark.parametrize("widths,N,S,nsample,plan", [
    ((195, 128, 128, 256), 512, 128, 32, dict(wm=4, nt=8, ks=32, qb=4)),
    ((259, 256, 256, 512), 128, 32, 32, dict(wm=4, nt=16, ks=32, qb=4)),
    ((1027, 1027), 1024, 256, 32, dict(wm=4, nt=8, ks=32, qb=4)),
    ((8, 16, 1032, 8), 32, 8, 8, None),
])
def test_pppe_plan(widths, N, S, nsample, plan):
    """The "pppe" kernel's tile as the wrapper predicts the launcher picks
    it: PPPE's sa2 two blocks an SM of 128 rows with passes of 128 columns,
    sa3 one block with passes of 256; the selection read-through's single
    identity layer at N = 1024; none where a middle layer is wider than the
    widest pass (the card tests hold the launcher to it)."""
    got = pppe_plan(list(widths), N, S, nsample)
    if plan is None:
        assert got is None
    else:
        assert {k: got[k] for k in plan} == plan
        assert got["smem_bytes"] <= (227 * 1024 if plan["nt"] == 16 else 113 * 1024)


@pytest.mark.parametrize("d", [8, 16, 45])
def test_folding_grid_bit_equal_to_jitted_pcc_tpu(d):
    """FoldingNet on both sides, pcc_tpu's jitted, with weights that carry
    the grid through exactly (products with 0 and +-1, sums with zeros): the
    decoded points are the grid [gx, gy, 0], bit-equal."""
    F = 4

    def carry(cin, width):
        # relu(+-gx), relu(+-gy) in the first layer, identity, then
        # gx = relu(gx) - relu(-gx) and gy alike
        first = np.zeros((cin, width), np.float32)
        first[0, 0], first[0, 1], first[1, 2], first[1, 3] = 1, -1, 1, -1
        last = np.zeros((width, 3), np.float32)
        last[0, 0], last[1, 0], last[2, 1], last[3, 1] = 1, -1, 1, -1
        return first, np.eye(width, dtype=np.float32), last

    kernels = {"mlp1": carry(2 + F, 8), "mlp2": carry(3 + F, 128)}
    params = {"params": {mlp: {f"dense_{i}": {"linear": {
        "kernel": jnp.asarray(k), "bias": jnp.zeros(k.shape[1], jnp.float32)}}
        for i, k in enumerate(ks)} for mlp, ks in kernels.items()}}
    latent = np.zeros((2, F), np.float32)
    ref = np.asarray(jax.jit(JFoldingNet(points=8, grid_size=d, feature_dim=F).apply)(
        params, jnp.asarray(latent)))
    tm = FoldingNet(points=8, grid_size=d, feature_dim=F)
    with torch.no_grad():
        for mlp, ks in kernels.items():
            convs = [m for m in getattr(tm, mlp) if hasattr(m, "kernel")]
            for conv, k in zip(convs, ks):
                conv.weight.copy_(torch.from_numpy(k.T.copy()).view(conv.weight.shape))
                conv.bias.zero_()
        out = tm(torch.from_numpy(latent)).numpy()
    assert out.shape == ref.shape == (2, d * d, 3)
    line = out[0, ::d, 0]
    assert line[0] == -1.0 and line[-1] == 1.0 and np.all(np.diff(line) > 0)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("S,N,K,radius", [(16, 64, 8, 0.2), (8, 32, 32, 0.4), (8, 16, 24, 0.8)])
def test_ball_query_indices_equal_in_float64(S, N, K, radius):
    """In float64 no near-tie resolves differently, so the indices are
    equal; K > N pads with index 0."""
    rng = np.random.default_rng(5)
    pts = rng.random((3, N, 3))
    q = pts[:, :S] + rng.standard_normal((3, S, 3)) * 0.01
    with jax.enable_x64(True):
        ref = np.asarray(j_ball_query(jnp.asarray(q, jnp.float64),
                                      jnp.asarray(pts, jnp.float64), K, radius))
    out = ball_query(torch.from_numpy(q), torch.from_numpy(pts), K, radius).numpy()
    assert 0 < (out == 0).mean() < 1
    np.testing.assert_array_equal(out, ref)


# -------------------------------------------------------------- the models --


@pytest.fixture(scope="module")
def ae_pair():
    """The port's PPPF_AE at K=64, d=4, dim=32 with seeded weights and live
    BatchNorm statistics, and pcc_tpu's module with its variables: the same
    numbers, moved by to_jax_params."""
    ae = _seeded(PPPF_AE(K=64, d=4, L=7, dim=32), 1)
    variables, _ = to_jax_params(ae.state_dict(), None)
    return JPPPF_AE(K=64, d=4, L=7, dim=32), variables, ae


def test_pppf_ae_encode(ae_pair):
    jae, variables, ae = ae_pair
    xyz = np.random.default_rng(2).random((3, 64, 3)).astype(np.float32)
    # jitted: one program in place of an eager dispatch of every op
    ref = np.asarray(jax.jit(functools.partial(jae.apply, method=JPPPF_AE.encode))(
        variables, jnp.asarray(xyz)))
    with torch.no_grad():
        out = ae.encode(torch.from_numpy(xyz)).numpy()
    assert out.shape == ref.shape == (3, 4)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=0)


def test_pppf_ae_decode(ae_pair):
    jae, variables, ae = ae_pair
    latent_q = np.random.default_rng(4).integers(-3, 4, (3, 4)).astype(np.float32)
    ref = np.asarray(jax.jit(functools.partial(jae.apply, method=JPPPF_AE.decode))(
        variables, jnp.asarray(latent_q)))
    with torch.no_grad():
        out = ae.decode(torch.from_numpy(latent_q)).numpy()
    assert out.shape == ref.shape == (3, 16, 3)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=0)


@pytest.fixture(scope="module")
def prob_pair():
    prob = _seeded(PPPFConditionalProbabilityModel(d=4, L=7), 2)
    _, variables = to_jax_params(None, prob.state_dict())
    return JPPPFProb(d=4, L=7), variables, prob


def test_float_probability_model(prob_pair):
    jprob, variables, prob = prob_pair
    rec = np.random.default_rng(6).random((2, 16, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jprob.apply)(variables, jnp.asarray(rec)))
    with torch.no_grad():
        out = prob(torch.from_numpy(rec)).numpy()
    assert out.shape == ref.shape == (2, 16, 4, 7)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=0)


def test_weight_bridge_round_trip_exact(ae_pair, prob_pair):
    """to_jax_params then from_jax_params gives the state_dicts back, every
    parameter and running statistic, and pcc_tpu's importer reads the port's
    state_dicts to the trees to_jax_params gives."""
    _, ae_vars, ae = ae_pair
    _, prob_vars, prob = prob_pair
    assert set(ae_vars) == set(prob_vars) == {"params", "batch_stats"}
    for sd, back in zip((ae.state_dict(), prob.state_dict()),
                        from_jax_params(ae_vars, prob_vars)):
        assert set(back) == set(sd)
        for k in sd:
            assert back[k].dtype == sd[k].dtype and torch.equal(back[k], sd[k]), k
    _tree_equal(convert_pppf_ae_state_dict(ae.state_dict()), ae_vars)
    _tree_equal(convert_pppf_prob_state_dict(prob.state_dict()), prob_vars)
    # either half alone
    assert from_jax_params(ae_vars, None)[1] is None
    assert set(from_jax_params(None, prob_vars)[1]) == set(prob.state_dict())


# ---------------------------------------------------------------- the CLIs --


def test_cli_round_trip_from_pcc_tpu_pickles(tmp_path, monkeypatch):
    """compress and decompress with --model PPPF-AE --device cpu, from an
    ae.pkl / prob.pkl written by pcc_tpu. Both runs calibrate the integer
    model on 2 skeletons instead of 32 (a quarter of a second each)."""
    from pcc_tpu_torch import codec as p_codec
    from pcc_tpu_torch.cli import compress, decompress
    from pcc_tpu_torch.coding.iprob_pppf import convert_pppf_prob_params

    monkeypatch.setattr(p_codec, "convert_pppf_prob_params",
                        functools.partial(convert_pppf_prob_params, n_calib=2))

    cfg = CodecConfig(N=256, K=32, d=4, L=7, model="PPPF-AE")
    ae_sd, prob_sd = init_params(0, cfg)
    ae_vars, prob_vars = to_jax_params(ae_sd, _live_stats(prob_sd, 5))
    inp, comp, dec, model = (tmp_path / n for n in ("in", "comp", "dec", "model"))
    model.mkdir()
    j_dump(ae_vars, str(model / "ae.pkl"))
    j_dump(prob_vars, str(model / "prob.pkl"))
    loaded_ae, loaded_prob = load_inference_params(str(model))
    assert "model_pnpp.sa1.mlp.1.running_var" in loaded_prob
    assert all(torch.equal(loaded_ae[k], ae_sd[k]) for k in ae_sd)

    rng = np.random.default_rng(11)
    for i, c in enumerate((rng.random((2, cfg.N, 3)) * 2 - 1).astype(np.float32)):
        save_point_cloud(c, f"c{i}.ply", path=str(inp))
    flags = ["--K", "32", "--d", "4", "--L", "7", "--model", "PPPF-AE", "--device", "cpu"]
    compress.main([str(inp / "*.ply"), str(comp), str(model), *flags])
    decompress.main([str(comp), str(dec), str(model), *flags])
    outs = sorted(glob.glob(os.path.join(dec, "*.bin.ply")))
    assert [os.path.basename(o) for o in outs] == ["c0.ply.bin.ply", "c1.ply.bin.ply"]
    for o in outs:
        pts = read_point_cloud(o)
        assert pts.shape == (cfg.S * cfg.d * cfg.d, 3) and np.isfinite(pts).all()


def test_cli_batch_default_and_train_refusal():
    """The PPPF-AE batch default is 16, as pcc_tpu's CLIs; the train CLI
    refuses what it does not port for the family (bf16)."""
    from pcc_tpu_torch.cli import compress, train
    from pcc_tpu_torch.cli._common import batch_size_from_args

    parse = compress.build_parser().parse_args
    assert batch_size_from_args(parse(["i", "c", "m", "--model", "PPPF-AE"])) == 16
    assert batch_size_from_args(parse(["i", "c", "m"])) == 64
    assert batch_size_from_args(parse(["i", "c", "m", "--model", "PPPF-AE",
                                       "--batch_size", "4"])) == 4
    with pytest.raises(SystemExit):
        train.main(["--train_glob", "none/*.ply", "--model", "PPPF-AE", "--bf16",
                    "--device", "cpu"])
    with pytest.raises(ValueError):
        CodecConfig(model="PPPE")
