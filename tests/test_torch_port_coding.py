"""PyTorch port (pcc_tpu_torch) vs pcc_tpu: the integer probability model
and the range coder, on the CPU. Exact by design, so every comparison is
bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcc_tpu.codec import init_params as j_init_params
from pcc_tpu.coding import iprob as j_iprob
from pcc_tpu.coding import rangecoder as j_rc
from pcc_tpu.config import CodecConfig as JCodecConfig
from pcc_tpu.models.ipdae import ConditionalProbabilityModel as JProb
from pcc_tpu_torch.codec import make_models
from pcc_tpu_torch.coding import iprob, rangecoder
from pcc_tpu_torch.config import CodecConfig
from pcc_tpu_torch.weights import from_jax_params, to_jax_params
from test_torch_port_pppf import one_thread_per_worker  # noqa: F401

KW = dict(N=256, N0=64, ALPHA=2, K=32, d=4, L=7, sa_knn=8)
CFG, JCFG = CodecConfig(**KW), JCodecConfig(**KW)


@pytest.fixture(scope="module")
def bundles():
    """The same float prob weights converted by both packages; the port
    converts from its own state_dict."""
    ae_vars, prob_vars = jax.jit(j_init_params, static_argnums=1)(jax.random.key(5), JCFG)
    _, prob_sd = from_jax_params(ae_vars, prob_vars)
    _, tree = to_jax_params(None, prob_sd)
    ours = iprob.convert_prob_params(tree, CFG.d, CFG.L)
    ref = j_iprob.convert_prob_params(prob_vars, JCFG.d, JCFG.L)
    return prob_vars, prob_sd, ours, ref


def _skeleton(rng, B=3, S=16):
    # voxel centres, as the decoder sees them
    return ((rng.integers(0, 32, (B, S, 3)) + 0.5) / 32).astype(np.float32)


def test_bundle_equal(bundles):
    _, _, ours, ref = bundles
    assert set(ours) == set(ref)
    for name in ref:
        if isinstance(ref[name], dict):
            assert set(ours[name]) == set(ref[name]), name
            for k in ref[name]:
                np.testing.assert_array_equal(ours[name][k], ref[name][k],
                                              err_msg=f"{name}.{k}")
        else:
            np.testing.assert_array_equal(ours[name], ref[name], err_msg=name)


def test_integer_weights_and_cdf_rows_bit_equal(bundles, rng):
    _, _, ours, ref = bundles
    rec = _skeleton(rng)
    w_torch = iprob.iprob_pmf_weights(iprob.bundle_to_device(ours, "cpu"),
                                      torch.from_numpy(rec)).numpy()
    w_np = iprob.iprob_pmf_weights_np(ours, rec)
    # jitted over the concrete bundle: one program, the integer spec's bits
    w_jax = np.asarray(jax.jit(lambda r: j_iprob.iprob_pmf_weights(ref, r))(jnp.asarray(rec)))
    w_jnp = j_iprob.iprob_pmf_weights_np(ref, rec)
    np.testing.assert_array_equal(w_torch, w_jax)
    np.testing.assert_array_equal(w_np, w_jnp)
    np.testing.assert_array_equal(w_torch, w_np)
    np.testing.assert_array_equal(iprob.weights_to_cdf_rows(w_torch),
                                  j_iprob.weights_to_cdf_rows(w_jax))


def test_float_prob_model_matches(bundles, rng):
    prob_vars, prob_sd, _, _ = bundles
    _, prob = make_models(CFG)
    prob.load_state_dict(prob_sd)
    xyz = rng.random((2, 16, 3)).astype(np.float32)
    with torch.no_grad():
        ours = prob(torch.from_numpy(xyz)).numpy()
    ref = np.asarray(jax.jit(JProb(d=CFG.d, L=CFG.L).apply)(prob_vars, jnp.asarray(xyz)))
    np.testing.assert_allclose(ours, ref, atol=1e-6)


def test_range_coder_bytes_equal(bundles, rng):
    """Same CDF rows and symbols -> the same bytes as pcc_tpu's coder and
    the Python mirror; each coder reads the other's stream back."""
    _, _, ours, _ = bundles
    rec = _skeleton(rng, B=1)
    cdf = iprob.weights_to_cdf_rows(iprob.iprob_pmf_weights_np(ours, rec))[0]
    sym = rng.integers(0, CFG.L, cdf.shape[:-1]).astype(np.int16)
    ours_b = rangecoder.encode_quantized_cdf(cdf, sym)
    assert ours_b == j_rc.encode_quantized_cdf(cdf, sym)
    assert ours_b == rangecoder.py_encode(cdf, sym)
    np.testing.assert_array_equal(rangecoder.decode_quantized_cdf(cdf, ours_b), sym)
    np.testing.assert_array_equal(j_rc.decode_quantized_cdf(cdf, ours_b), sym)
    np.testing.assert_array_equal(rangecoder.py_decode(cdf, ours_b), sym)


def test_range_coder_rejects_bad_symbol():
    cdf = np.array([[0, 10, 65535]], np.int32)
    with pytest.raises(ValueError):
        rangecoder.encode_quantized_cdf(cdf, np.array([2], np.int16))
