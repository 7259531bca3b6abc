"""PyTorch port (pcc_tpu_torch) vs pcc_tpu: the PPPE whole-cloud codec's
serving path, on the CPU, at tests/test_pppe.py's config (N = 256,
latent_dim 16, L = 7).

The port's PointCloudAE with seeded weights (BatchNorm statistics live, a
quarter of the scales negative, the latent head spread over the L bins)
is carried into pcc_tpu by its importer
(cli/import_torch_checkpoint.py::convert_pppe_ae_state_dict). Latents,
coarse and fine clouds and the probability model's outputs agree within
1e-5 (the port's sa2 / sa3 run pppf_sa_fused's plain version in the
"pppe" layout here; pcc_tpu runs its XLA path). The "pppe" stage at PPPE's
own widths (195 and 259 input channels, nsample 32) is held to pcc_tpu's
Pallas kernel under the interpreter. The weight bridge round-trips
bitwise; a pcc_tpu PPPE checkpoint folder (latest and best) loads into
the port's CLIs. The CLIs run side by side: raw .bin files within 1e-5
with equal headers, entropy streams byte-equal from equal latents and
cross-decoding both ways (the .bin is pinned to 1e-5, not bytes: a latent
within 1e-5 of a .5 boundary may round to another symbol), all three
decode transforms within 1e-5, and eval_pppe's CSV held as the eval CSV
(tests/test_torch_port_eval.py).
"""

import functools
import glob
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcc_tpu.cli.import_torch_checkpoint import convert_pppe_ae_state_dict
from pcc_tpu.models.pppe import PointCloudAE as JPointCloudAE
from pcc_tpu.models.pppe import quantize_st as j_quantize_st
from pcc_tpu.train.checkpoint import _dump as j_dump
from pcc_tpu_torch.config import PPPEConfig
from pcc_tpu_torch.io import read_point_cloud, save_point_cloud
from pcc_tpu_torch.models.pppe import make_pppe_model, quantize_st
from pcc_tpu_torch.weights import from_jax_params, to_jax_params
from test_torch_port_eval import compare_averages, compare_eval_csv, one_thread_per_worker  # noqa: F401

CFG = PPPEConfig(N=256, latent_dim=16, L=7)
FLAGS = ["--N", str(CFG.N), "--K", str(CFG.latent_dim), "--L", str(CFG.L)]
ATOL = 1e-5


def _test_state(seed: int) -> dict:
    """Seeded port weights with live BatchNorm statistics (numpy seed: means
    around 0, variances in [0.5, 1.5], scales in [0.5, 1.5] with about a
    quarter negative) and the latent head scaled so that the latents spread
    over the L bins."""
    model = make_pppe_model(CFG, seed=seed)
    rng = np.random.default_rng(seed)
    sd = dict(model.state_dict())
    for key in list(sd):
        if not key.endswith(".running_mean"):
            continue
        stem, n = key[:-len("running_mean")], sd[key].shape[0]
        sign = np.where(rng.random(n) < 0.25, -1.0, 1.0)
        for name, val in (("running_mean", rng.standard_normal(n) * 0.1),
                          ("running_var", rng.random(n) + 0.5),
                          ("weight", (rng.random(n) + 0.5) * sign),
                          ("bias", (rng.random(n) - 0.3) * 0.2)):
            sd[stem + name] = torch.from_numpy(val.astype(np.float32))
    sd["encoder.global_conv.3.weight"] = sd["encoder.global_conv.3.weight"] * 60.0
    sd["encoder.global_conv.3.bias"] = torch.full((CFG.latent_dim,), 3.0)
    return sd


@pytest.fixture(scope="module")
def j_init():
    """pcc_tpu's PPPE variables from a key ({'params', 'batch_stats'}, numpy),
    the init jitted once for the module."""
    jmodel = JPointCloudAE(latent_dim=CFG.latent_dim, latent_bins=CFG.L, npoints=CFG.N)
    init = jax.jit(lambda key: jmodel.init(key, jnp.zeros((1, CFG.N, 3)),
                                           method=JPointCloudAE.init_all))

    def make(seed):
        key = jax.random.key(seed) if isinstance(seed, int) else seed
        v = init(key)
        return jax.tree.map(np.asarray, {"params": v["params"],
                                         "batch_stats": v["batch_stats"]})
    return make


@pytest.fixture(scope="module")
def models():
    """(port model, pcc_tpu model, pcc_tpu variables) on the same weights."""
    sd = _test_state(5)
    port = make_pppe_model(CFG)
    port.load_state_dict(sd)
    variables = convert_pppe_ae_state_dict({k: v.numpy() for k, v in sd.items()})
    return port, JPointCloudAE(latent_dim=CFG.latent_dim, latent_bins=CFG.L,
                               npoints=CFG.N), variables


def _clouds(seed, n=3):
    rng = np.random.default_rng(seed)
    return (rng.random((n, CFG.N, 3)) * 3 - 1).astype(np.float32)


def test_model_matches_pcc_tpu(models):
    """Encoder latent and global feature, coarse and fine clouds, the
    quantized latent, and the probability model's mean, scale and PMF."""
    port, jmodel, variables = models
    x = _clouds(1, 2)
    want, (lat_want, _) = jax.jit(lambda v, a: (
        jmodel.apply(v, a), jmodel.apply(v, a, method=lambda m, pc: m.encoder(pc))))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
        lat_got, _ = port.encoder(torch.from_numpy(x))
    lat_want = np.asarray(lat_want)
    assert np.ptp(np.clip(np.round(lat_want), 0, CFG.L - 1)) >= 3   # the bins are used
    np.testing.assert_allclose(lat_got.numpy(), lat_want, atol=ATOL)
    for g, w, name in zip(got, want, ("coarse", "fine", "cond_feats", "y_q")):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, err_msg=name)
    y_q, cond = got[3], got[2]
    prob_want = jax.jit(functools.partial(jmodel.apply, method=lambda m, a, b: m.prob(a, b)))(
        variables, jnp.asarray(y_q.numpy()), jnp.asarray(cond.numpy()))
    with torch.no_grad():
        prob_got = port.prob(y_q, cond)
    for g, w, name in zip(prob_got, prob_want, ("mean", "scale", "pmf")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, err_msg=name)


def test_quantize_st_bit_equal_to_pcc_tpu():
    x = np.concatenate([np.linspace(-5, 20, 1001), np.arange(-1, 8) + 0.5,
                        np.arange(-1, 8) + 0.49999997]).astype(np.float32)
    want = np.asarray(j_quantize_st(jnp.asarray(x), 0.0, 6.0, 7))
    got = quantize_st(torch.from_numpy(x), 0.0, 6.0, 7).numpy()
    np.testing.assert_array_equal(got, want)


def test_training_mode_raises():
    """Training mode no longer raises: PPPE training is ported
    (tests/test_torch_port_train_pppe.py holds it to pcc_tpu). A train-mode
    forward runs every stack on batch statistics and moves the running
    statistics; an eval-mode forward leaves them."""
    model = make_pppe_model(CFG, seed=0)
    x = torch.from_numpy(_clouds(2, 2))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        model(x)
        assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
        model.train()(x)
    moved = [k for k, v in model.state_dict().items()
             if k.endswith("running_var") and not torch.equal(v, before[k])]
    assert len(moved) == 4 * 3 + 1      # every stage layer and global_conv's BatchNorm


@pytest.mark.parametrize("stage", ["sa2", "sa3"])
def test_pppe_stage_at_pppe_widths_matches_pallas_interpret(stage):
    """pppf_sa_plain in the "pppe" layout against pcc_tpu's Pallas stage
    kernel under the interpreter at PPPE's own stage shapes: sa2 128 of 512
    points with 192 features (widths 195-128-128-256), sa3 32 of 128 with
    256 (259-256-256-512), nsample 32, radius 0, live BatchNorm."""
    from pcc_tpu.ops.pppf_sa_pallas import pppf_sa_fused as j_pppf_sa_fused

    from pcc_tpu_torch.ops.pppf_sa_cuda import pppf_sa_plain

    N, S, C, j = {"sa2": (512, 128, 192, 1), "sa3": (128, 32, 256, 2)}[stage]
    sa = make_pppe_model(CFG).encoder.sa_modules[j]
    prefix = f"encoder.sa_modules.{j}."
    sa.load_state_dict({k[len(prefix):]: v for k, v in _test_state(7).items()
                        if k.startswith(prefix)})
    rng = np.random.default_rng(N)
    xyz = rng.random((1, N, 3)).astype(np.float32)
    new_xyz = np.ascontiguousarray(xyz[:, rng.permutation(N)[:S]])
    feat = rng.standard_normal((1, N, C)).astype(np.float32)
    layers = [tuple(t.detach() for t in lay) for lay in sa.layers()]
    got = pppf_sa_plain(torch.from_numpy(new_xyz), torch.from_numpy(xyz),
                        torch.from_numpy(feat), layers, nsample=32, radius=0.0,
                        layout="pppe").numpy()
    want = np.asarray(j_pppf_sa_fused(
        jnp.asarray(new_xyz), jnp.asarray(xyz), jnp.asarray(feat),
        [tuple(jnp.asarray(t.numpy()) for t in lay) for lay in layers],
        nsample=32, radius=0.0, layout="pppe", interpret=True))
    assert got.shape == (1, S, layers[-1][0].shape[1])
    np.testing.assert_allclose(got, want, atol=ATOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("L", [2, 7, 16])
def test_float_cdf_coding_bytes_equal_pcc_tpu(L):
    """quantize_cdf, encode_float_cdf and decode_float_cdf on the port's own
    coder: per-slot CDFs, some symbols of probability 0 (the staircase keeps
    them codable), bytes and integer rows equal to pcc_tpu's, each package
    decoding the other's stream."""
    from pcc_tpu.coding import rangecoder as jrc

    from pcc_tpu_torch.coding import rangecoder as trc

    rng = np.random.default_rng(L)
    pmf = rng.random((300, L)) * (rng.random((300, L)) < 0.7)
    pmf[:, 0] += 1e-3
    pmf /= pmf.sum(-1, keepdims=True)
    cdf = np.concatenate([np.zeros((300, 1)), np.cumsum(pmf, -1)], -1)
    sym = rng.integers(0, L, 300)
    np.testing.assert_array_equal(trc.quantize_cdf(cdf), jrc.quantize_cdf(cdf))
    got = trc.encode_float_cdf(cdf, sym)
    assert got == jrc.encode_float_cdf(cdf, sym)
    np.testing.assert_array_equal(jrc.decode_float_cdf(cdf, got), sym)
    np.testing.assert_array_equal(trc.decode_float_cdf(cdf, got), sym)


# ------------------------------------------------------------------ weights --

def test_weights_round_trip(models, j_init):
    """pcc_tpu's own PPPE variables -> port state_dict -> pcc_tpu variables,
    bitwise; and the port's state_dict the other way."""
    port, _, _ = models
    v = j_init(0)
    sd, none = from_jax_params(v, v)
    assert none is None
    fresh = make_pppe_model(CFG)
    fresh.load_state_dict(sd)
    back, _ = to_jax_params(fresh.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(v)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(v)):
        np.testing.assert_array_equal(a, b)
    sd2, _ = from_jax_params(to_jax_params(port.state_dict())[0], None)
    for k, t in port.state_dict().items():
        assert torch.equal(sd2[k], t), k


@pytest.mark.parametrize("best", [False, True])
def test_pcc_tpu_checkpoint_folder_loads(tmp_path, models, j_init, best):
    """A folder pcc_tpu's save_pppe_checkpoint wrote (pcc_tpu's own
    initialized weights, conv biases included; latest and best differ)
    loads into the port's CLIs, --best choosing ae_best.pkl; the port's
    latents are pcc_tpu's on it."""
    from types import SimpleNamespace

    from pcc_tpu.train.checkpoint import save_pppe_checkpoint

    from pcc_tpu_torch.cli.pppe_pcd_compress import build_parser, encode_clouds, load_pppe_model

    _, jmodel, _ = models
    states = {}
    for b in (False, True):
        v = j_init(3 + b)
        states[b] = SimpleNamespace(params={"ae": v["params"]},
                                    batch_stats={"ae": v["batch_stats"]}, opt_state={})
        save_pppe_checkpoint(str(tmp_path), states[b], 7, best=b)
    args = build_parser().parse_args(["x", "y", str(tmp_path), *FLAGS, "--device", "cpu"]
                                     + (["--best"] if best else []))
    port = load_pppe_model(args, CFG)
    x = _clouds(2, 2)
    st = states[best]
    v = {"params": st.params["ae"], "batch_stats": st.batch_stats["ae"]}
    want = np.asarray(jax.jit(lambda v, a: jmodel.apply(v, a, method=lambda m, pc: m.encoder(pc)))(
        v, jnp.asarray(x))[0])
    with torch.no_grad():
        np.testing.assert_allclose(port.encoder(torch.from_numpy(x))[0].numpy(), want,
                                   atol=ATOL)
    # the CLI's encode normalizes each cloud first
    from pcc_tpu_torch.ops.normalize import normalize

    pc01 = normalize(torch.from_numpy(x))[0]
    with torch.no_grad():
        np.testing.assert_array_equal(encode_clouds(port, x, CFG).numpy(),
                                      port.encoder(pc01)[0].numpy())


# --------------------------------------------------------------------- CLIs --

@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory, models, j_init):
    """Both packages' compress CLIs (raw and --entropy_coding, --batch_size
    2 over 3 clouds in a nested tree, so the tail batch is padded) and
    decompress CLIs (the three transforms) on a model folder holding the
    test weights as pcc_tpu's ae_latest.pkl. pcc_tpu's CLIs build a fresh
    train state from --seed before the checkpoint replaces its variables;
    here that state comes from j_init's jitted init (the same values)
    instead of create_pppe_state's op-by-op init, which takes about 20 s
    the first time in a process."""
    from pcc_tpu.cli import pppe_pcd_compress as jc
    from pcc_tpu.cli import pppe_pcd_decompress as jd
    from pcc_tpu.train import steps_pppe

    def create_pppe_state(key, cfg, tx):
        assert (cfg.N, cfg.latent_dim, cfg.L) == (CFG.N, CFG.latent_dim, CFG.L)
        v = j_init(key)
        params = {"ae": v["params"]}
        return steps_pppe.PPPETrainState(params=params, batch_stats={"ae": v["batch_stats"]},
                                         opt_state=tx.init(params), step=0)

    from pcc_tpu_torch.cli import pppe_pcd_compress as tc
    from pcc_tpu_torch.cli import pppe_pcd_decompress as td

    port, _, _ = models
    root = tmp_path_factory.mktemp("pppe")
    variables, _ = to_jax_params(port.state_dict())
    os.makedirs(root / "model")
    j_dump(variables, str(root / "model" / "ae_latest.pkl"))
    j_dump(variables, str(root / "model" / "prob_latest.pkl"))
    for i, pc in enumerate(_clouds(3)):
        save_point_cloud(pc, f"c{i}.ply", path=str(root / "in" / ("sub" if i else "")))
    common = [*FLAGS, "--batch_size", "2"]
    src = str(root / "in" / "**" / "*.ply")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(steps_pppe, "create_pppe_state", create_pppe_state)
        _run_clis(root, src, common, ((jc, jd, "j", []), (tc, td, "t", ["--device", "cpu"])))
    return root


def _run_clis(root, src, common, packages):
    for comp, dec, pkg, extra in packages:
        comp.main([src, str(root / f"{pkg}_raw"), str(root / "model"), *common, *extra])
        comp.main([src, str(root / f"{pkg}_ent"), str(root / "model"), "--entropy_coding",
                   *common, *extra])
        for name, stream, flags in (("sigmoid", "raw", []), ("round", "raw", ["--use_quantized"]),
                                    ("quantized", "ent", [])):
            dec.main([str(root / f"j_{stream}" / "**" / "*.bin"),
                      str(root / f"{pkg}_dec_{name}"), str(root / "model"), *flags, *common,
                      *extra])


def _bins(root, kind):
    files = sorted(glob.glob(str(root / f"j_{kind}" / "**" / "*.bin"), recursive=True))
    assert len(files) == 3 and any(os.sep + "sub" + os.sep in f for f in files)
    return [(f, f.replace(f"{os.sep}j_{kind}{os.sep}", f"{os.sep}t_{kind}{os.sep}")) for f in files]


def test_raw_bins_match_pcc_tpu(cli_runs):
    """The raw contract: the same count header, float32 latents within 1e-5."""
    for jf, tf in _bins(cli_runs, "raw"):
        with open(jf, "rb") as a, open(tf, "rb") as b:
            ja, tb = a.read(), b.read()
        assert ja[:4] == tb[:4] == struct.pack("<I", CFG.latent_dim)
        assert len(ja) == len(tb) == 4 + 4 * CFG.latent_dim
        np.testing.assert_allclose(np.frombuffer(tb[4:], "<f4"), np.frombuffer(ja[4:], "<f4"),
                                   atol=ATOL)


def test_entropy_streams_byte_equal_and_cross_decode(cli_runs, tmp_path):
    """save_binary_entropy's bytes are pcc_tpu's for the same latent; each
    package decodes the other's CLI streams to the symbols they coded."""
    from pcc_tpu.cli.pppe_pcd_compress import save_binary_entropy as j_save_entropy
    from pcc_tpu.cli.pppe_pcd_decompress import load_binary_any as j_load_any

    from pcc_tpu_torch.cli.pppe_pcd_compress import save_binary_entropy
    from pcc_tpu_torch.cli.pppe_pcd_decompress import load_binary, load_binary_any

    for jf, tf in _bins(cli_runs, "raw"):
        lat = load_binary(jf)[0]
        j_save_entropy(lat, CFG.L, str(tmp_path / "j.bin"))
        save_binary_entropy(lat, CFG.L, str(tmp_path / "t.bin"))
        assert (tmp_path / "j.bin").read_bytes() == (tmp_path / "t.bin").read_bytes()
    for jf, tf in _bins(cli_runs, "ent"):
        sym_j, q_j = j_load_any(jf)
        sym_t, q_t = load_binary_any(tf)
        assert q_j and q_t
        np.testing.assert_array_equal(load_binary_any(jf)[0], sym_j)
        np.testing.assert_array_equal(j_load_any(tf)[0], sym_t)
        raw = load_binary(tf.replace(f"{os.sep}t_ent{os.sep}", f"{os.sep}t_raw{os.sep}"))
        np.testing.assert_array_equal(sym_t, np.clip(np.round(raw), 0, CFG.L - 1))


@pytest.mark.parametrize("mode", ["sigmoid", "round", "quantized"])
def test_decode_modes_match_pcc_tpu(cli_runs, mode):
    """The reference's sigmoid spread, --use_quantized and entropy streams,
    each decoded by both packages from pcc_tpu's streams."""
    files = sorted(glob.glob(str(cli_runs / f"j_dec_{mode}" / "**" / "*.bin.ply"),
                             recursive=True))
    assert len(files) == 3
    for f in files:
        want = read_point_cloud(f)
        got = read_point_cloud(f.replace(f"{os.sep}j_dec_", f"{os.sep}t_dec_"))
        assert got.shape == want.shape == (CFG.N, 3)
        np.testing.assert_allclose(got, want, atol=ATOL)


def test_eval_pppe_csv_matches_pcc_tpu(cli_runs, capsys):
    from pcc_tpu.cli import eval_pppe as je

    from pcc_tpu_torch.cli import eval_pppe as te

    lines = {}
    for pkg, mod, extra in (("j", je, []), ("t", te, ["--device", "cpu"])):
        mod.main(["--input_glob", str(cli_runs / "in" / "**" / "*.ply"), "--compressed_path",
                  str(cli_runs / "j_raw"), "--decompressed_path", str(cli_runs / "j_dec_round"),
                  "--output_file", str(cli_runs / f"{pkg}_eval.csv"), *extra])
        lines[pkg] = next(ln for ln in capsys.readouterr().out.splitlines()
                          if ln.startswith("Done!"))
    compare_eval_csv(cli_runs / "t_eval.csv", cli_runs / "j_eval.csv")
    compare_averages(lines["t"], lines["j"])
    with open(cli_runs / "t_eval.csv") as f:
        header = f.readline().rstrip("\n").split(",")
    assert header[-1] == "bpp" and "uniformity coefficient" not in header
