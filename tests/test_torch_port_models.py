"""PyTorch port (pcc_tpu_torch) vs pcc_tpu: IPDAE models and the plain
versions of the fused encoder / decoder kernels, on the CPU.

Weights move JAX -> port through pcc_tpu_torch.weights. The plain encoder
and decoder are held against pcc_tpu's Pallas kernels (interpret mode) and
its XLA module path at atol 1e-5 (float32 sums in another order; the bar of
tests/test_sa_pallas.py). The weight bridge is checked bitwise against
pcc_tpu's own importer.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcc_tpu.cli.import_torch_checkpoint import (convert_ae_state_dict,
                                                 convert_prob_state_dict)
from pcc_tpu.codec import init_params as j_init_params
from pcc_tpu.config import CodecConfig as JCodecConfig
from pcc_tpu.models.ipdae import PatchAE as JPatchAE
from pcc_tpu.ops.decoder_pallas import patch_decoder_fused
from pcc_tpu.ops.decoder_pallas import permute_expansion as j_permute_expansion
from pcc_tpu.ops.sa_pallas import patch_encoder_fused
from pcc_tpu_torch.codec import make_models
from pcc_tpu_torch.config import CodecConfig
from pcc_tpu_torch.models.layers import sigmoid_spread, ste_round
from pcc_tpu_torch.ops.decoder_cuda import (GROUP_ORDER, expansion_kmajor, mlp_kmajor,
                                            pack_decoder, patch_decoder_plain,
                                            permute_expansion, split_tf32)
from pcc_tpu_torch.ops.bf16 import round_bf16
from pcc_tpu_torch.ops.sa_cuda import patch_encoder_plain
from pcc_tpu_torch.weights import from_jax_params, to_jax_params
from test_torch_port_pppf import one_thread_per_worker  # noqa: F401

KW = dict(N=256, N0=64, ALPHA=2, K=32, d=4, L=7, sa_knn=8)
CFG, JCFG = CodecConfig(**KW), JCodecConfig(**KW)


@pytest.fixture(scope="module")
def models():
    """pcc_tpu random weights, and the port's modules loaded with them."""
    ae_vars, prob_vars = jax.jit(j_init_params, static_argnums=1)(jax.random.key(3), JCFG)
    ae_sd, prob_sd = from_jax_params(ae_vars, prob_vars)
    ae, prob = make_models(CFG)
    ae.load_state_dict(ae_sd)
    prob.load_state_dict(prob_sd)
    return ae_vars, prob_vars, ae.eval(), prob.eval()


def _wb(tree, names):
    return [(tree[n]["linear"]["kernel"], tree[n]["linear"]["bias"]) for n in names]


def _tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _tree_equal(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


def test_weight_bridge_bitwise(models):
    """pcc_tpu's importer reads the port's state_dicts back into exactly
    the flax trees they came from; to_jax_params is the same inverse."""
    ae_vars, prob_vars, ae, prob = models
    _tree_equal(convert_ae_state_dict(ae.state_dict()), ae_vars)
    _tree_equal(convert_prob_state_dict(prob.state_dict()), prob_vars)
    ae_back, prob_back = to_jax_params(ae.state_dict(), prob.state_dict())
    _tree_equal(ae_back, ae_vars)
    _tree_equal(prob_back, prob_vars)


@pytest.mark.parametrize("P", [4, 9])
def test_encoder_plain_matches_pallas_and_xla(models, rng, P):
    ae_vars, _, ae, _ = models
    patches = (rng.random((P, CFG.K, 3)).astype(np.float32) * 2 - 1) * 0.4
    p = ae_vars["params"]
    sa_wb = _wb(p["sa"]["mlp"], [f"dense_{i}" for i in range(3)])
    pn_wb = _wb(p["pn"]["mlp"], [f"dense_{i}" for i in range(4)])
    kern = np.asarray(patch_encoder_fused(jnp.asarray(patches), sa_wb, pn_wb,
                                          knn=CFG.sa_knn, interpret=True))
    t = torch.from_numpy(patches)
    with torch.no_grad():
        ours = patch_encoder_plain(t, ae.sa.layers(), ae.pn.layers(), CFG.sa_knn)
        spread = ae.encode(t)
    np.testing.assert_allclose(ours.numpy(), kern, atol=1e-5)
    xla = jax.jit(functools.partial(
        JPatchAE(K=CFG.K, k=CFG.k, d=CFG.d, L=CFG.L, sa_knn=CFG.sa_knn).apply,
        method="encode"))(ae_vars, jnp.asarray(patches))
    np.testing.assert_allclose(spread.numpy(), np.asarray(xla), atol=1e-5)


@pytest.mark.parametrize("P", [5, 8])
def test_decoder_plain_matches_pallas_and_xla(models, rng, P):
    ae_vars, _, ae, _ = models
    lat = rng.integers(-3, 4, (P, CFG.d)).astype(np.float32)
    p = ae_vars["params"]
    pool_wb = _wb(p, [f"inv_pool_{i}" for i in range(3)])
    mlp_wb = _wb(p["inv_mlp"], [f"dense_{i}" for i in range(4)])
    kern = np.asarray(patch_decoder_fused(jnp.asarray(lat), pool_wb, mlp_wb,
                                          k=CFG.k, block_p=4, block_k=4,
                                          interpret=True))
    xla = np.asarray(jax.jit(functools.partial(
        JPatchAE(K=CFG.K, k=CFG.k, d=CFG.d, L=CFG.L, sa_knn=CFG.sa_knn).apply,
        method="decode"))(ae_vars, jnp.asarray(lat)))
    with torch.no_grad():
        ours = ae.decode(torch.from_numpy(lat)).numpy()
    assert ours.shape == (P, CFG.k, 3)
    np.testing.assert_allclose(ours, kern, atol=1e-5)
    np.testing.assert_allclose(ours, xla, atol=1e-5)


def test_permute_expansion_matches_reference(rng):
    w3 = rng.standard_normal((16, 128 * 8)).astype(np.float32)
    b3 = rng.standard_normal(128 * 8).astype(np.float32)
    ours = permute_expansion(torch.from_numpy(w3), torch.from_numpy(b3), 8)
    ref = j_permute_expansion(jnp.asarray(w3), jnp.asarray(b3), 8)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_decoder_plain_is_the_fold(rng):
    """patch_decoder_plain over permuted columns == the reference's
    [B, 128, k] view + transpose of the unpermuted expansion (AE.py:49)."""
    k, d, P = 8, 4, 3
    h2 = torch.from_numpy(rng.random((P, 32)).astype(np.float32))
    lat = torch.from_numpy(rng.standard_normal((P, d)).astype(np.float32))
    w3 = torch.from_numpy(rng.standard_normal((32, 128 * k)).astype(np.float32))
    b3 = torch.from_numpy(rng.standard_normal(128 * k).astype(np.float32))
    mlp = [(torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.1),
            torch.zeros(s[1])) for s in [(128 + d, 128), (128, 64), (64, 32), (32, 3)]]
    ours = patch_decoder_plain(h2, lat, *permute_expansion(w3, b3, k), mlp, k)
    fold = torch.relu(h2 @ w3 + b3).reshape(P, 128, k).transpose(1, 2)
    x = torch.cat([fold, lat[:, None, :].expand(P, k, d)], -1)
    for i, (w, b) in enumerate(mlp):
        x = x @ w + b
        x = torch.relu(x) if i < 3 else x
    np.testing.assert_allclose(ours.numpy(), x.numpy(), atol=1e-6)


@pytest.mark.parametrize("k", [1, 8])
def test_expansion_kmajor_is_permuted_expansion_transposed(rng, k):
    """The kernel's expansion layout from nn.Linear's weight equals the
    plain path's point-major w3r, transposed, bit for bit."""
    w = torch.from_numpy(rng.standard_normal((128 * k, 32)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(128 * k).astype(np.float32))
    assert torch.equal(expansion_kmajor(w, k), permute_expansion(w.t(), b, k)[0].t())


def test_split_tf32_exact(rng):
    """hi + lo == x exactly, hi's 13 low mantissa bits zero, |lo| below one
    TF32 step of x where x is normal: the 3xTF32 operands lose nothing of x
    but lo's own low bits."""
    x = np.concatenate([rng.standard_normal(4000) * s for s in (1e-30, 1e-3, 1.0, 1e6)]
                       + [[0.0, -0.0, 1.0, -2.5, 1e-40, 3e38]]).astype(np.float32)
    t = torch.from_numpy(x)
    hi, lo = split_tf32(t)
    assert torch.equal(hi + lo, t)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    normal = t.abs() >= torch.finfo(torch.float32).tiny
    assert bool((lo.abs() <= t.abs() * 2.0 ** -10)[normal].all())


@pytest.mark.parametrize("cin,cout", [(144, 128), (128, 64), (20, 32)])
def test_mlp_kmajor_layout(rng, cin, cout):
    """[out, round8(in)]: column 8i + q holds input row 8i + GROUP_ORDER[q],
    zero past the input's width."""
    w = torch.from_numpy(rng.standard_normal((cin, cout)).astype(np.float32))
    m = mlp_kmajor(w)
    kp = -(-cin // 8) * 8
    assert tuple(m.shape) == (cout, kp) and m.is_contiguous()
    for c in range(kp):
        src = c // 8 * 8 + GROUP_ORDER[c % 8]
        want = w[src] if src < cin else torch.zeros(cout)
        assert torch.equal(m[:, c], want)


@pytest.mark.parametrize("d", [4, 13])
def test_packed_decoder_layout_is_the_decoder(rng, d):
    """The kernel's data flow on pack_decoder's weights, emulated in float64
    (hi + lo is the float32 weight exactly): the expansion from the K-major
    rows, each layer's input read in GROUP_ORDER per 8 columns against the
    permuted weight columns, gives patch_decoder_plain's output."""
    k, P, C = 4, 5, 64
    h2 = torch.from_numpy(rng.random((P, C)).astype(np.float32))
    lat = torch.from_numpy(rng.integers(-3, 4, (P, d)).astype(np.float32))
    w3 = torch.from_numpy((rng.standard_normal((128 * k, C)) * C ** -0.5).astype(np.float32))
    b3 = torch.from_numpy(rng.standard_normal(128 * k).astype(np.float32) * 0.1)
    mlp = [(torch.from_numpy((rng.standard_normal(s) * s[0] ** -0.5).astype(np.float32)),
            torch.from_numpy(rng.standard_normal(s[1]).astype(np.float32) * 0.1))
           for s in [(128 + d, 128), (128, 64), (64, 32), (32, 3)]]
    w3r, b3r = permute_expansion(w3.t(), b3, k)
    packed = pack_decoder(expansion_kmajor(w3, k), b3r, mlp)
    f64 = [t.double() for t in (packed.w_hi, packed.w_lo)]
    fold = torch.relu(h2.double() @ (f64[0] + f64[1]).t() + packed.b3r.double())
    x = torch.cat([fold.reshape(P, k, 128), lat.double()[:, None, :].expand(P, k, d)], -1)
    for i in range(3):
        m = packed.m_hi[i].double() + packed.m_lo[i].double()
        kp = m.shape[1]
        x = torch.nn.functional.pad(x, (0, kp - x.shape[-1]))
        col = torch.arange(kp)
        x = torch.relu(x[..., col // 8 * 8 + torch.tensor(GROUP_ORDER)[col % 8]] @ m.t()
                       + packed.mb[i].double())
    x = x @ packed.w4.double() + packed.b4.double()
    ours = patch_decoder_plain(h2, lat, w3r, b3r, mlp, k)
    np.testing.assert_allclose(x.numpy(), ours.numpy(), atol=1e-5)


@pytest.mark.parametrize("d", [4, 13])
def test_packed_decoder_bf16_layout_is_the_decoder(rng, d):
    """The bf16 kernel's weights (pack_decoder(..., bf16=True)) read back in
    plain PyTorch: the expansion [k*128, C] is w3r transposed, each inv_mlp
    layer [out, round16(in)] its weight transposed with zero columns past
    `in`; the plain bf16 decoder on what was read back is the plain bf16
    decoder bit for bit. The kernel takes h2 as the bf16 tensor the wrapper
    makes (h2.to(bfloat16)), which is round_bf16 of it."""
    k, P, C = 4, 5, 64
    h2 = torch.from_numpy(rng.random((P, C)).astype(np.float32))
    lat = torch.from_numpy(rng.integers(-3, 4, (P, d)).astype(np.float32))
    w3 = torch.from_numpy((rng.standard_normal((128 * k, C)) * C ** -0.5).astype(np.float32))
    b3 = torch.from_numpy(rng.standard_normal(128 * k).astype(np.float32) * 0.1)
    mlp = [(torch.from_numpy((rng.standard_normal(s) * s[0] ** -0.5).astype(np.float32)),
            torch.from_numpy(rng.standard_normal(s[1]).astype(np.float32) * 0.1))
           for s in [(128 + d, 128), (128, 64), (64, 32), (32, 3)]]
    w3r, b3r = permute_expansion(w3.t(), b3, k)
    packed = pack_decoder(expansion_kmajor(w3, k), b3r, mlp, bf16=True)
    assert packed.w_hi.dtype == torch.bfloat16 and packed.w_hi.shape == (128 * k, C)
    back = []
    for i, (w, _) in enumerate(mlp[:3]):
        m = packed.m_hi[i].float()
        assert m.shape == (w.shape[1], -(-w.shape[0] // 16) * 16)
        assert not m[:, w.shape[0]:].any()
        back.append((m[:, :w.shape[0]].t(), packed.mb[i]))
    back.append((packed.w4, packed.b4))
    want = patch_decoder_plain(h2, lat, w3r, b3r, mlp, k, bf16=True)
    got = patch_decoder_plain(h2, lat, packed.w_hi.float().t(), packed.b3r, back, k, bf16=True)
    assert torch.equal(got, want)
    assert torch.equal(h2.to(torch.bfloat16).float(), round_bf16(h2))


def test_decoder_weights_prepared_once_in_eval():
    """PatchAE.decoder_weights: made on every call in train mode, once per
    weights in eval mode; dropped by train() and load_state_dict, and made
    again when a weight changes in place."""
    ae, _ = make_models(CFG)
    a = ae.decoder_weights()
    assert a[3] is None                        # no kernel layout on the CPU
    assert ae.decoder_weights() is not a       # train mode: no cache
    ae.eval()
    a = ae.decoder_weights()
    assert ae.decoder_weights() is a
    with torch.no_grad():
        ae.inv_mlp.parameters().__next__().mul_(2.0)
    b = ae.decoder_weights()
    assert b is not a and ae.decoder_weights() is b
    ae.load_state_dict(ae.state_dict())
    assert ae._decoder_cache is None
    ae.decoder_weights()
    ae.train()
    assert ae._decoder_cache is None
    with torch.inference_mode():               # weights without version counters
        ae, _ = make_models(CFG)
        ae.eval()
        a = ae.decoder_weights()
        assert ae.decoder_weights() is a


def test_quantizer_helpers():
    from pcc_tpu.models.layers import sigmoid_spread as j_spread

    x = np.linspace(-8, 8, 101).astype(np.float32)
    np.testing.assert_allclose(sigmoid_spread(torch.from_numpy(x), 7).numpy(),
                               np.asarray(j_spread(jnp.asarray(x), 7)), atol=1e-6)
    v = torch.tensor([0.2, 0.6, -1.4, 2.5], requires_grad=True)
    out = ste_round(v)
    np.testing.assert_array_equal(out.detach().numpy(), np.round(v.detach().numpy()))
    (out * 3.0).sum().backward()
    np.testing.assert_allclose(v.grad.numpy(), 3.0)


def test_set_abstraction_and_pointnet_modules(models, rng):
    """The plain module paths (SetAbstraction's KNN grouping, PointNetFeat's
    max over points) against pcc_tpu's XLA modules."""
    ae_vars, _, ae, _ = models
    jae = JPatchAE(K=CFG.K, k=CFG.k, d=CFG.d, L=CFG.L, sa_knn=CFG.sa_knn)
    xyz = (rng.random((3, CFG.K, 3)).astype(np.float32) * 2 - 1) * 0.4
    feats = rng.random((3, CFG.K, 131)).astype(np.float32)
    with torch.no_grad():
        sa = ae.sa(torch.from_numpy(xyz)).numpy()
        pn = ae.pn(torch.from_numpy(feats)).numpy()
    ref_sa = jax.jit(functools.partial(jae.apply, method=lambda m, x: m.sa(x)))(
        ae_vars, jnp.asarray(xyz))
    ref_pn = jax.jit(functools.partial(jae.apply, method=lambda m, x: m.pn(x)))(
        ae_vars, jnp.asarray(feats))
    np.testing.assert_allclose(sa, np.asarray(ref_sa), atol=1e-5)
    np.testing.assert_allclose(pn, np.asarray(ref_pn), atol=1e-5)
