"""PyTorch port (pcc_tpu_torch) vs pcc_tpu: the PPPF-AE integer probability
model and the whole PPPF-AE compress -> decompress path on the CPU, same
weights, same clouds.

  * integer FPS and ball query equal to the numpy spec, also with more
    samples than points;
  * the converted integer bundle leaf for leaf equal to pcc_tpu's;
  * the torch integer weights bit-equal to the numpy spec and to pcc_tpu's
    JAX program;
  * .s.bin and .c.bin byte-equal to pcc_tpu's, streams cross-decode both
    ways, decoded clouds within one int8 step of each patch's scale;
pcc_tpu's codec runs on its XLA path (no Pallas interpreter). The CLI round
trip is in tests/test_torch_port_pppf.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcc_tpu import codec as j_codec
from pcc_tpu.coding import iprob as j_iprob
from pcc_tpu.coding import iprob_pppf as j_ipppf
from pcc_tpu.coding import rangecoder as j_rc
from pcc_tpu.coding.octree_host import codes_to_points, parse_octree_bits, unpack_bits
from pcc_tpu.config import CodecConfig as JCodecConfig
from pcc_tpu_torch import codec as p_codec
from pcc_tpu_torch.codec import Codec, decode_clouds_packed, init_params
from pcc_tpu_torch.coding import iprob_pppf as ipppf
from pcc_tpu_torch.coding.iprob import bundle_to_device
from pcc_tpu_torch.config import CodecConfig
from pcc_tpu_torch.weights import to_jax_params

KW = dict(N=256, K=32, d=4, L=7, model="PPPF-AE")       # S = 16
CFG, JCFG = CodecConfig(**KW), JCodecConfig(**KW)
N_CALIB = 2


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
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)


def _live_stats(state, seed):
    """A copy of a state_dict with non-trivial BatchNorm entries from a numpy
    seed (running means, variances, scales with about a quarter negative,
    biases)."""
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


@pytest.fixture(scope="module")
def params():
    """The port's seeded PPPF-AE state_dicts with live BatchNorm statistics,
    and pcc_tpu's variables of the same numbers (to_jax_params)."""
    ae_sd, prob_sd = init_params(0, CFG)
    ae_sd, prob_sd = _live_stats(ae_sd, 1), _live_stats(prob_sd, 2)
    ae_vars, prob_vars = to_jax_params(ae_sd, prob_sd)
    return ae_vars, prob_vars, (ae_sd, prob_sd)


@pytest.fixture(scope="module")
def bundles(params):
    """Both converters on the same float weights, one calibration cloud."""
    _, prob_vars, (_, prob_sd) = params
    j_bundle = j_ipppf.convert_pppf_prob_params(prob_vars, CFG.d, CFG.L, n_calib=1, S=CFG.S)
    _, tree = to_jax_params(None, prob_sd)
    bundle = ipppf.convert_pppf_prob_params(tree, CFG.d, CFG.L, n_calib=1, S=CFG.S)
    return j_bundle, bundle


def _skeletons(rng, B, S=CFG.S, depth=6):
    """Voxel-centre-like inputs: exact (i + 0.5) / 2^depth grid points."""
    return ((rng.integers(0, 1 << depth, (B, S, 3)) + 0.5) / (1 << depth)).astype(np.float32)


@pytest.mark.parametrize("npoint", [8, 16, 24])
def test_integer_fps_equals_numpy_spec(npoint):
    """Duplicated points force distance ties that only the lowest-index rule
    resolves; npoint beyond n saturates."""
    rng = np.random.default_rng(11)
    pts = rng.integers(0, 64, (2, 16, 3)).astype(np.int32)
    pts[0, 8:] = pts[0, :8]
    inf = 3 * 64 * 64 + 1
    ref = j_ipppf._int_fps_np(pts, npoint, inf)
    np.testing.assert_array_equal(ipppf._int_fps_np(pts, npoint, inf), ref)
    np.testing.assert_array_equal(ipppf._int_fps(torch.from_numpy(pts), npoint, inf).numpy(), ref)


@pytest.mark.parametrize("K,r", [(4, 10), (16, 10), (32, 200)])
def test_integer_ball_query_equals_numpy_spec(K, r):
    """K > n pads with index 0."""
    rng = np.random.default_rng(11)
    pts = rng.integers(0, 64, (2, 16, 3)).astype(np.int32)
    pts[0, 8:] = pts[0, :8]
    centers = pts[:, :4]
    ref = j_ipppf._int_ball_np(centers, pts, K, r * r, 16)
    np.testing.assert_array_equal(ipppf._int_ball_np(centers, pts, K, r * r, 16), ref)
    out = ipppf._int_ball(torch.from_numpy(centers), torch.from_numpy(pts), K, r * r, 16)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_selection_grid_bits():
    for n in (16, 64, 128, 512, 8192):
        assert ipppf._qsel(n) == j_ipppf._qsel(n)


def test_bundle_leaf_for_leaf_equal(bundles):
    j_bundle, bundle = bundles
    assert "sa3_3" in bundle and "wx" in bundle["sa2_0"] and "wx" in bundle["mlp0"]
    _tree_equal(bundle, j_bundle)


def test_integer_weights_bit_equal(bundles):
    """The torch program vs the port's numpy spec, pcc_tpu's numpy spec and
    pcc_tpu's JAX program."""
    j_bundle, bundle = bundles
    rec = _skeletons(np.random.default_rng(11), 2)
    w = ipppf.pppf_pmf_weights(bundle_to_device(bundle, "cpu"), torch.from_numpy(rec))
    assert w.dtype == torch.int32 and tuple(w.shape) == (2, CFG.S, CFG.d, CFG.L)
    np.testing.assert_array_equal(w.numpy(), ipppf.pppf_pmf_weights_np(bundle, rec))
    np.testing.assert_array_equal(w.numpy(), j_ipppf.pppf_pmf_weights_np(j_bundle, rec))
    # jitted over the concrete bundle: one program, the integer spec's bits
    w_jax = jax.jit(lambda r: j_ipppf.pppf_pmf_weights(j_bundle, r))(jnp.asarray(rec))
    np.testing.assert_array_equal(w.numpy(), np.asarray(w_jax))


# ---------------------------------------------------------------- the codec --


@pytest.fixture(scope="module")
def run(params):
    """Both codecs on the same 3 clouds; encodes computed once."""
    ae_vars, prob_vars, (ae_sd, prob_sd) = params
    # both codecs calibrate their integer model on N_CALIB skeletons instead
    # of 32: the host conversion costs a quarter of a second per skeleton
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_ipppf, "convert_pppf_prob_params", functools.partial(
            j_ipppf.convert_pppf_prob_params, n_calib=N_CALIB))
        mp.setattr(p_codec, "convert_pppf_prob_params", functools.partial(
            ipppf.convert_pppf_prob_params, n_calib=N_CALIB))
        jc = j_codec.Codec(JCFG, ae_vars, prob_vars, batch_size=3)
        pc = Codec(CFG, ae_sd, prob_sd, batch_size=3, device="cpu")
    rng = np.random.default_rng(11)
    clouds = [(rng.random((CFG.N, 3)) * 2 - 1).astype(np.float32) for _ in range(3)]
    starts = np.array([0, 17, 200], np.int32)
    j_streams = jc.compress_many(clouds, list(starts))
    p_streams = pc.compress_many(clouds, list(starts))
    p_sym = pc.encode_batch(np.stack(clouds), starts).sym.numpy()
    # pcc_tpu's integer bundle as numpy, for its numpy spec
    j_bundle = {k: ({n: np.asarray(a) for n, a in v.items()} if isinstance(v, dict)
                    else np.asarray(v)) for k, v in jc._iprob.items()}
    j_bundle.update(d=np.int32(CFG.d), L=np.int32(CFG.L))
    return dict(jc=jc, pc=pc, clouds=clouds, j_streams=j_streams, p_streams=p_streams,
                p_sym=p_sym, j_bundle=j_bundle)


def _j_decode(j_bundle, streams):
    """pcc_tpu's integer model (its numpy spec) and host range decoder on
    (p, s, c) streams -> symbols [B, S, d]."""
    recs = np.stack([_skeleton(s) for _, s, _ in streams])
    cdfs = j_iprob.weights_to_cdf_rows(j_ipppf.pppf_pmf_weights_np(j_bundle, recs))
    return recs, np.stack([j_rc.decode_quantized_cdf(cdfs[j], p)
                           for j, (p, _, _) in enumerate(streams)])


def _skeleton(s_bytes):
    codes, depth = parse_octree_bits(unpack_bits(s_bytes))
    return codes_to_points(codes, depth)


def test_skeleton_and_header_streams_byte_equal(run):
    for (_, js, jc_), (_, ps, pc_) in zip(run["j_streams"], run["p_streams"]):
        assert ps == js
        assert pc_ == jc_


def test_codec_bundle_equals_pcc_tpu(run):
    """The bundle the port's Codec converted (N_CALIB calibration clouds, S
    of the config) against pcc_tpu's Codec's."""
    ours = run["pc"].bundle
    for name, lw in run["j_bundle"].items():
        if not isinstance(lw, dict):
            continue
        for key, val in lw.items():
            got = ours[name][key]
            got = got.numpy() if isinstance(got, torch.Tensor) else got
            np.testing.assert_array_equal(np.asarray(got), val, err_msg=f"{name}/{key}")


def test_streams_cross_decode_both_ways(run):
    """pcc_tpu's integer model and host coder read the port's .p.bin back to
    the port encoder's symbols, and the port reads pcc_tpu's .p.bin to the
    symbols pcc_tpu reads from it."""
    _, theirs_of_ours = _j_decode(run["j_bundle"], run["p_streams"])
    np.testing.assert_array_equal(theirs_of_ours, run["p_sym"])
    recs, j_sym = _j_decode(run["j_bundle"], run["j_streams"])
    ours = run["pc"].decode_symbols(recs, [p for p, _, _ in run["j_streams"]])
    np.testing.assert_array_equal(ours, j_sym)


def test_decoded_clouds_within_one_int8_step(run):
    """Both full decompresses on both sets of streams: the port's decode of
    pcc_tpu's streams against pcc_tpu's own, and pcc_tpu's decode of the
    port's streams against the port's own."""
    pc = run["pc"]
    ours = pc.decompress_many(run["p_streams"])
    ours_of_theirs = pc.decompress_many(run["j_streams"])
    ref = run["jc"].decompress_many(run["j_streams"])
    ref_of_ours = run["jc"].decompress_many(run["p_streams"])
    with torch.no_grad():
        _, scale = decode_clouds_packed(pc.ae, torch.from_numpy(run["p_sym"]), CFG)
    per_patch = CFG.d * CFG.d
    for j, (_, _, c_bytes) in enumerate(run["p_streams"]):
        longest = np.frombuffer(c_bytes, np.float32)[3]
        step = scale[j].numpy() / 127.0 * longest / (1.0 - CFG.margin)    # [S, 3]
        tol = np.repeat(step, per_patch, axis=0) + 1e-6
        assert ours[j].shape == (CFG.S * per_patch, 3) and np.isfinite(ours[j]).all()
        assert np.all(np.abs(ours_of_theirs[j] - ref[j]) <= tol)
        assert np.all(np.abs(ours[j] - ref_of_ours[j]) <= tol)
