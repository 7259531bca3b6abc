"""PyTorch port (pcc_tpu_torch) vs pcc_tpu in bf16 mixed precision
(compute_dtype "bfloat16"), on the CPU, same inputs (numpy-seeded) and
weights.

Each module rounds where pcc_tpu rounds, and the points differ by module:
  * the bf16 plain versions of the patch encoder, the patch decoder and the
    "pppf" stage against pcc_tpu's Pallas kernels under the interpreter
    with compute_dtype=bfloat16;
  * PPPF-AE's sigmoid_spread (bit-equal), enc_proj, dec_proj and FoldingNet
    (flax's bf16 Dense) against pcc_tpu's jitted modules;
  * the whole codec round trip of both families against pcc_tpu's
    Codec(compute_dtype="bfloat16") with PCC_PALLAS_INTERPRET=1 (without
    it pcc_tpu's CPU Codec takes its XLA path, whose rounding points are
    flax's, not those of the kernels the TPU runs): .s.bin / .c.bin
    byte-equal, latents bit-equal but for a few, streams cross-decoding
    both ways, decoded clouds within bf16's tolerance.
A kernel's output is held by `_hold`: at least EXACT_SHARE of its entries
bit-equal (the sums run in another order, which moves a bf16 rounding now
and then) and every entry within TOL of the output's largest |entry|; a
rounding point missing or added would make most entries differ.
"""

import functools
import glob
import os

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
from pcc_tpu.models.layers import TorchDense as JTorchDense
from pcc_tpu.models.layers import sigmoid_spread as j_sigmoid_spread
from pcc_tpu.models import pppf as j_pppf
from pcc_tpu.models.pppf import FoldingNet as JFoldingNet
from pcc_tpu.ops.decoder_pallas import patch_decoder_fused
from pcc_tpu.ops.pppf_sa_pallas import pppf_sa_fused as j_pppf_sa_fused
from pcc_tpu.ops import sa_pallas as j_sa_pallas
from pcc_tpu.ops.sa_pallas import patch_encoder_fused
from pcc_tpu_torch import codec as p_codec
from pcc_tpu_torch.codec import (Codec, encode_geometry, init_params, pack_encode_upload,
                                 unpack_encode_upload)
from pcc_tpu_torch.coding import iprob_pppf as ipppf
from pcc_tpu_torch.config import CodecConfig
from pcc_tpu_torch.io import read_point_cloud, save_point_cloud
from pcc_tpu_torch.models.layers import dense, sigmoid_spread
from pcc_tpu_torch.models import pppf as p_pppf
from pcc_tpu_torch.models.pppf import PPPF_AE
from pcc_tpu_torch.ops.bf16 import round_bf16
from pcc_tpu_torch.ops.decoder_cuda import (expansion_kmajor, pack_decoder, patch_decoder_plain,
                                            permute_expansion)
from pcc_tpu_torch.ops.knn import select_nearest, sq_dists
from pcc_tpu_torch.ops.pppf_sa_cuda import bf16_layers, pppf_sa_fused, pppf_sa_plain
from pcc_tpu_torch.ops.sa_cuda import (_kernel_choices, bf16_wb, patch_encoder,
                                       patch_encoder_plain)
from pcc_tpu_torch.weights import to_jax_params
from test_torch_port_pppf import _seeded, one_thread_per_worker  # noqa: F401

BF16 = jnp.bfloat16
EXACT_SHARE = 0.99
TOL = 2.0 ** -7
KW = dict(N=256, N0=64, ALPHA=2, K=32, d=4, L=7, sa_knn=8, compute_dtype="bfloat16")
CFG, JCFG = CodecConfig(**KW), JCodecConfig(**KW)
# PPPF-AE: S = 8 patches of 32 points a cloud, narrow PN++ stages and
# feature (SMALL_PNPP, SMALL_DIM: the stages' nsample and the integer model
# stay), the integer model calibrated on N_CALIB skeletons instead of 32 (a
# quarter of a second each)
PKW = dict(N=128, K=32, d=4, L=7, model="PPPF-AE", compute_dtype="bfloat16")
PCFG, JPCFG = CodecConfig(**PKW), JCodecConfig(**PKW)
N_CALIB = 2
SMALL_PNPP = dict(sa1_mlp=(16, 16, 32), sa2_mlp=(32, 32, 32, 64), sa3_mlp=(64, 64, 128))
SMALL_DIM = 64


def _hold(out, ref) -> float:
    """At least EXACT_SHARE of the entries bit-equal, every entry within TOL
    of the largest |ref|; returns the share."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    share = float((out == ref).mean())
    assert share >= EXACT_SHARE, share
    assert float(np.abs(out - ref).max()) <= TOL * float(np.abs(ref).max())
    return share


def _bf16_exact(t) -> bool:
    t = torch.as_tensor(t)
    return torch.equal(round_bf16(t), t)


def _wb(tree, names):
    return [(tree[n]["linear"]["kernel"], tree[n]["linear"]["bias"]) for n in names]


@pytest.fixture(scope="module")
def ipdae():
    """The port's seeded IPDAE weights as pcc_tpu's variables, and the port's
    bf16 PatchAE on them."""
    ae_sd, prob_sd = init_params(3, CFG)
    ae_vars, prob_vars = to_jax_params(ae_sd, prob_sd)
    ae, _ = p_codec.make_models(CFG)
    ae.load_state_dict(ae_sd)
    return ae_vars, prob_vars, ae.eval()


# ------------------------------------------------------------- the kernels --


def test_encoder_plain_bf16_matches_pallas(ipdae):
    ae_vars, _, ae = ipdae
    patches = ((np.random.default_rng(5).random((64, CFG.K, 3)) * 2 - 1) * 0.4).astype(
        np.float32)
    p = ae_vars["params"]
    sa_wb = _wb(p["sa"]["mlp"], [f"dense_{i}" for i in range(3)])
    pn_wb = _wb(p["pn"]["mlp"], [f"dense_{i}" for i in range(4)])
    ref = np.asarray(patch_encoder_fused(jnp.asarray(patches), sa_wb, pn_wb, knn=CFG.sa_knn,
                                         compute_dtype=BF16, interpret=True))
    t = torch.from_numpy(patches)
    sa, pn = ae.sa.layers(), ae.pn.layers()
    with torch.no_grad():
        sa16, pn16 = ae.encoder_weights()
        assert all(torch.equal(a, b) for x, y in ((sa16, bf16_wb(sa)), (pn16, bf16_wb(pn)))
                   for wx, wy in zip(x, y) for a, b in zip(wx, wy))
        ours = patch_encoder_plain(t, sa16, pn16, CFG.sa_knn, bf16=True)
        f32 = patch_encoder_plain(t, sa, pn, CFG.sa_knn)
        # the kernel's own arithmetic (k-order sums), replayed
        rows = torch.arange(CFG.K).expand(64, CFG.K).contiguous()
        replay = _kernel_choices(t, select_nearest(sq_dists(t, t), CFG.sa_knn), rows, sa16, pn16,
                                 bf16=True)[-1].amax(dim=1)
        assert torch.equal(patch_encoder(t, sa16, pn16, CFG.sa_knn, bf16=True), ours)
    assert _bf16_exact(ours) and _bf16_exact(replay)
    _hold(ours, ref)
    _hold(replay, ref)
    # float32 is another function: most entries differ
    assert float((f32.numpy() == ref).mean()) < 0.5


def test_decoder_plain_bf16_matches_pallas(ipdae):
    ae_vars, _, ae = ipdae
    lat = np.random.default_rng(6).integers(-3, 4, (16, CFG.d)).astype(np.float32)
    p = ae_vars["params"]
    ref = np.asarray(patch_decoder_fused(
        jnp.asarray(lat), _wb(p, [f"inv_pool_{i}" for i in range(3)]),
        _wb(p["inv_mlp"], [f"dense_{i}" for i in range(4)]), k=CFG.k, compute_dtype=BF16,
        block_p=8, block_k=4, interpret=True))
    with torch.no_grad():
        ours = ae.decode(torch.from_numpy(lat)).numpy()
    assert ours.shape == (16, CFG.k, 3) and _bf16_exact(ours)
    _hold(ours, ref)


def test_bf16_decoder_layout_is_the_decoder():
    """The bf16 decoder kernel's data flow on pack_decoder's bf16 layout,
    emulated in float64 (bf16 products are exact; the expansion K-major and
    point-major, each layer's bf16 weight [out, round16(in)] in its natural
    column order, h2 and every output rounded, the biases float32), gives
    the bf16 plain decoder's output."""
    rng = np.random.default_rng(10)
    k, P, C, d = 4, 5, 64, 13
    t = torch.from_numpy
    h2 = t(rng.random((P, C)).astype(np.float32))
    lat = t(rng.integers(-3, 4, (P, d)).astype(np.float32))
    w3 = t((rng.standard_normal((128 * k, C)) * C ** -0.5).astype(np.float32))
    b3 = t(rng.standard_normal(128 * k).astype(np.float32) * 0.1)
    mlp = [(t((rng.standard_normal(sh) * sh[0] ** -0.5).astype(np.float32)),
            t(rng.standard_normal(sh[1]).astype(np.float32) * 0.1))
           for sh in [(128 + d, 128), (128, 64), (64, 32), (32, 3)]]
    w3r, b3r = permute_expansion(w3.t(), b3, k)
    packed = pack_decoder(expansion_kmajor(w3, k), b3r, mlp, bf16=True)
    assert packed.bf16 and packed.w_hi.dtype == torch.bfloat16
    assert [tuple(m.shape) for m in packed.m_hi] == [(128, 144), (64, 128), (32, 64)]

    def rnd(x):
        return round_bf16(x.float()).double()

    fold = rnd(torch.relu(rnd(h2) @ packed.w_hi.double().t() + packed.b3r.double()))
    x = torch.cat([fold.reshape(P, k, 128), lat.double()[:, None, :].expand(P, k, d)], -1)
    for m, b in zip(packed.m_hi, packed.mb):
        x = torch.nn.functional.pad(x, (0, m.shape[1] - x.shape[-1]))
        x = rnd(torch.relu(x @ m.double().t() + b.double()))
    x = rnd(x @ packed.w4.double() + packed.b4.double())
    _hold(x, patch_decoder_plain(h2, lat, w3r, b3r, mlp, k, bf16=True))


# (npoint, radius, nsample, widths, N, C): the three stage shapes of
# tests/test_torch_port_pppf.py (sa1 npoint == N, sa2 FPS + features, sa3
# nsample == N)
_SHAPES = [
    (64, 0.2, 8, (3, 16, 16, 32), 64, 0),
    (32, 0.4, 16, (24, 16, 32), 64, 21),
    (8, 0.8, 32, (40, 32, 48), 32, 37),
]


@pytest.mark.parametrize("npoint,radius,nsample,mlp,N,C", _SHAPES)
def test_stage_plain_bf16_matches_pallas(npoint, radius, nsample, mlp, N, C):
    """Live BatchNorm terms, a quarter of the scales negative; the features
    are bf16 values, as the stage before hands them over."""
    rng = np.random.default_rng(11)
    P = 4
    xyz = rng.random((P, N, 3)).astype(np.float32)
    new_xyz = xyz if npoint == N else np.ascontiguousarray(xyz[:, rng.permutation(N)[:npoint]])
    feat = (round_bf16(torch.from_numpy(rng.random((P, N, C)).astype(np.float32))).numpy()
            if C else None)
    layers, cin = [], C + 3
    for cout in mlp:
        bound = cin ** -0.5
        sign = np.where(rng.random(cout) < 0.25, -1.0, 1.0)
        layers.append(tuple(a.astype(np.float32) for a in (
            (rng.random((cin, cout)) * 2 - 1) * bound, (rng.random(cout) * 2 - 1) * bound,
            rng.standard_normal(cout) * 0.1, (rng.random(cout) + 0.5) * sign,
            (rng.random(cout) - 0.3) * 0.2)))
        cin = cout
    kw = dict(nsample=nsample, radius=radius)
    ref = np.asarray(j_pppf_sa_fused(
        jnp.asarray(new_xyz), jnp.asarray(xyz), None if feat is None else jnp.asarray(feat),
        [tuple(jnp.asarray(a) for a in lay) for lay in layers], compute_dtype=BF16,
        interpret=True, **kw))
    t = torch.from_numpy
    args = (t(new_xyz), t(xyz), None if feat is None else t(feat),
            [tuple(t(a) for a in lay) for lay in layers])
    args16 = args[:3] + (bf16_layers(args[3]),)
    ours = pppf_sa_plain(*args16, bf16=True, **kw)
    assert ours.shape == (P, npoint, mlp[-1]) and _bf16_exact(ours)
    assert float(np.abs(ref).max()) > 0.05
    _hold(ours, ref)
    assert torch.equal(pppf_sa_fused(*args16, bf16=True, **kw), ours)
    # the "pppe" layout in bf16 too: its plain version on CPU tensors
    assert torch.equal(pppf_sa_fused(*args16, bf16=True, layout="pppe", **kw),
                       pppf_sa_plain(*args16, bf16=True, layout="pppe", **kw))


# ------------------------------------------------------ PPPF-AE's modules --


def test_sigmoid_spread_bf16_bit_equal_to_jitted_pcc_tpu():
    """On a bf16 array pcc_tpu's constants round first (6.8 -> 6.8125, 3.4
    -> 3.40625) and jax.nn.sigmoid rounds after each of its operations."""
    x = round_bf16(torch.from_numpy(
        (np.random.default_rng(7).standard_normal(8192) * 4).astype(np.float32)))
    ref = np.asarray(jax.jit(lambda v: j_sigmoid_spread(v.astype(BF16), 7))(
        jnp.asarray(x.numpy()))).astype(np.float32)
    np.testing.assert_array_equal(sigmoid_spread(x, 7, bf16=True).numpy(), ref)
    # torch's own bf16 sigmoid is another function
    naive = (torch.sigmoid(x.to(torch.bfloat16)) * 6.8 - 3.4).float().numpy()
    assert float((naive == ref).mean()) < 0.9


@pytest.fixture(scope="module")
def pppf_pair():
    """The port's bf16 PPPF_AE at K=64, d=4, dim=32 with seeded weights and
    live BatchNorm statistics, and pcc_tpu's variables of the same numbers."""
    ae = _seeded(PPPF_AE(K=64, d=4, L=7, dim=32, compute_dtype="bfloat16"), 1)
    variables, _ = to_jax_params(ae.state_dict(), None)
    return variables["params"], ae


def _flax_dense(params, features, x):
    return np.asarray(jax.jit(lambda v: JTorchDense(features, dtype=BF16).apply(
        {"params": params}, v))(jnp.asarray(x))).astype(np.float32)


def test_enc_proj_dec_proj_flax_rule(pppf_pair):
    """flax's Dense(dtype=bfloat16): the product rounded to bf16, then the
    bias added in bf16."""
    params, ae = pppf_pair
    rng = np.random.default_rng(8)
    spread = sigmoid_spread(round_bf16(torch.from_numpy(
        rng.standard_normal((64, 32)).astype(np.float32))), 7, bf16=True)
    lat = rng.integers(-3, 4, (64, 4)).astype(np.float32)
    with torch.no_grad():
        enc = dense(ae.enc_proj, spread, bf16=True)
        dec = dense(ae.dec_proj, torch.from_numpy(lat), bf16=True)
    _hold(enc, _flax_dense(params["enc_proj"], 4, spread.numpy()))
    _hold(dec, _flax_dense(params["dec_proj"], 32, lat))


def test_folding_net_bf16_matches_jitted_pcc_tpu(pppf_pair):
    """The grid and the tiled latent rounded before mlp1, every layer on
    flax's rule, the last one's bias add not rounded (pcc_tpu casts it to
    float32 in the same program)."""
    params, ae = pppf_pair
    lat = round_bf16(torch.from_numpy(
        np.random.default_rng(9).standard_normal((4, 32)).astype(np.float32)))
    ref = np.asarray(jax.jit(lambda v: JFoldingNet(points=64, grid_size=4, feature_dim=32,
                                                   dtype=BF16).apply(
        {"params": params["decoder"]}, v.astype(BF16)))(jnp.asarray(lat.numpy())))
    with torch.no_grad():
        ours = ae.decoder(lat)
    assert ours.shape == (4, 16, 3)
    _hold(ours, ref)


def test_params_stay_float32():
    for cfg in (CFG, PCFG):
        for sd in init_params(0, cfg):
            assert all(v.dtype == torch.float32 for v in sd.values()
                       if v.is_floating_point())
    ae, _ = p_codec.make_models(PCFG)
    ae.load_state_dict(init_params(0, PCFG)[0])
    ae.train()
    z = ae.encode(torch.rand((2, PCFG.K, 3)) - 0.5)     # bf16 training runs
    assert z.shape == (2, PCFG.d) and bool(torch.isfinite(z).all())


# --------------------------------------------------------------- the codecs --


def _small_pppf(mp) -> None:
    """Both packages' codecs build PPPF-AE with SMALL_PNPP stages and a
    SMALL_DIM feature, and calibrate their integer models on N_CALIB
    skeletons."""
    class JSmall(j_pppf.PPPF_AE):
        dim: int = SMALL_DIM

    mp.setattr(j_pppf, "PointNetPP", functools.partial(j_pppf.PointNetPP, **SMALL_PNPP))
    mp.setattr(j_pppf, "PPPF_AE", JSmall)
    mp.setattr(p_pppf, "PointNetPP", functools.partial(p_pppf.PointNetPP, **SMALL_PNPP))
    mp.setattr(p_codec, "PPPF_AE", functools.partial(p_pppf.PPPF_AE, dim=SMALL_DIM))
    mp.setattr(j_ipppf, "convert_pppf_prob_params", functools.partial(
        j_ipppf.convert_pppf_prob_params, n_calib=N_CALIB))
    mp.setattr(p_codec, "convert_pppf_prob_params", functools.partial(
        ipppf.convert_pppf_prob_params, n_calib=N_CALIB))


def _capture_latents(mp, captured: list) -> None:
    """Make pcc_tpu's encode program hand its latents [B*S, d] to `captured`
    as it runs (jax.debug.callback): IPDAE's encoder kernel output before
    its float32 spread (the port's float32 sigmoid is not XLA's bit for
    bit), PPPF-AE's enc_proj output, which its symbols round."""
    def keep(v):
        captured.append(np.asarray(v))

    encoder = j_sa_pallas.patch_encoder_trainable

    def encoder_kept(*args, **kw):
        out = encoder(*args, **kw)
        jax.debug.callback(keep, out)
        return out

    class PPPFKept(j_pppf.PPPF_AE):
        def encode(self, xyz, train: bool = False):
            out = super().encode(xyz, train)
            jax.debug.callback(keep, out)
            return out

    mp.setattr(j_sa_pallas, "patch_encoder_trainable", encoder_kept)
    mp.setattr(j_pppf, "PPPF_AE", PPPFKept)    # after _small_pppf's


def _codec_run(cfg, jcfg, ae_vars, prob_vars, ae_sd, prob_sd, clouds, starts, batch):
    """Both bf16 codecs on the same clouds (pcc_tpu's kernels under the
    interpreter), and a float32 port codec on the same weights; PPPF-AE
    small (_small_pppf)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PCC_PALLAS_INTERPRET", "1")
        _small_pppf(mp)
        captured = []
        _capture_latents(mp, captured)
        jc = j_codec.Codec(jcfg, ae_vars, prob_vars, batch_size=batch)
        pc = Codec(cfg, ae_sd, prob_sd, batch_size=batch, device="cpu")
        pc32 = Codec(CodecConfig(**{**{f: getattr(cfg, f) for f in (
            "N", "N0", "ALPHA", "K", "d", "L", "sa_knn", "model")}, "compute_dtype": "float32"}),
            ae_sd, prob_sd, batch_size=batch, device="cpu")
        j_streams = jc.compress_many(clouds, list(starts))
        p_streams = pc.compress_many(clouds, list(starts))
        f32_streams = pc32.compress_many(clouds, list(starts))
        (j_lat,) = captured
        with torch.no_grad():
            geo = encode_geometry(*unpack_encode_upload(torch.from_numpy(
                pack_encode_upload(np.stack(clouds), starts).view(np.int32)), cfg.N),
                cfg)
            if cfg.model == "PPPF-AE":
                p_lat = pc.ae.encode(geo.patches).numpy()
            else:
                p_lat = patch_encoder(geo.patches, *pc.ae.encoder_weights(), cfg.sa_knn,
                                      bf16=True).numpy()
        p_sym = pc.encode_batch(np.stack(clouds), starts).sym.numpy()
        ours = pc.decompress_many(p_streams)
        ref_of_ours = jc.decompress_many(p_streams)
        ours_of_theirs = pc.decompress_many(j_streams)
        ref = jc.decompress_many(j_streams)
    return dict(jc=jc, pc=pc, pc32=pc32, j_streams=j_streams, p_streams=p_streams,
                f32_streams=f32_streams, j_lat=j_lat, p_lat=p_lat, p_sym=p_sym, ours=ours,
                ref_of_ours=ref_of_ours, ours_of_theirs=ours_of_theirs, ref=ref)


@pytest.fixture(scope="module")
def ipdae_run(ipdae):
    ae_vars, prob_vars, _ = ipdae
    rng = np.random.default_rng(11)
    clouds = [(rng.random((CFG.N, 3)) * 4 - 1).astype(np.float32) for _ in range(2)]
    return _codec_run(CFG, JCFG, ae_vars, prob_vars, *init_params(3, CFG),
                      clouds, np.array([0, 17], np.int32), batch=2)


@pytest.fixture(scope="module")
def pppf_run():
    with pytest.MonkeyPatch.context() as mp:
        _small_pppf(mp)
        ae_sd, prob_sd = init_params(0, PCFG)
    ae_vars, prob_vars = to_jax_params(ae_sd, prob_sd)
    rng = np.random.default_rng(12)
    clouds = [(rng.random((PCFG.N, 3)) * 2 - 1).astype(np.float32)]
    return _codec_run(PCFG, JPCFG, ae_vars, prob_vars, ae_sd, prob_sd, clouds,
                      np.array([33], np.int32), batch=1)


def _skeleton(s_bytes):
    codes, depth = parse_octree_bits(unpack_bits(s_bytes))
    return codes_to_points(codes, depth)


def _j_decode_symbols(jc, streams):
    """pcc_tpu's integer model and host range decoder on (p, s, c) streams."""
    recs = np.stack([_skeleton(s) for _, s, _ in streams])
    if jc.cfg.model == "PPPF-AE":
        bundle = {k: ({n: np.asarray(a) for n, a in v.items()} if isinstance(v, dict)
                      else np.asarray(v)) for k, v in jc._iprob.items()}
        bundle.update(d=np.int32(jc.cfg.d), L=np.int32(jc.cfg.L))
        weights = j_ipppf.pppf_pmf_weights_np(bundle, recs)
    else:
        weights = np.asarray(j_iprob.iprob_pmf_weights(jc._iprob, jnp.asarray(recs),
                                                       d=jc.cfg.d, L=jc.cfg.L))
    cdfs = j_iprob.weights_to_cdf_rows(weights)
    return recs, np.stack([j_rc.decode_quantized_cdf(cdfs[j], p)
                           for j, (p, _, _) in enumerate(streams)])


@pytest.mark.parametrize("family", ["ipdae_run", "pppf_run"])
def test_bf16_codec_matches_pcc_tpu(family, request):
    run = request.getfixturevalue(family)
    # the skeleton and header streams do not depend on the dtype
    for (_, js, jc_), (_, ps, pc_), (_, fs, fc) in zip(run["j_streams"], run["p_streams"],
                                                       run["f32_streams"]):
        assert ps == js == fs and pc_ == jc_ == fc
    # latents: bf16-exact through enc_proj / the spread's float32, bit-equal
    # but for a few; symbols equal wherever the latents are
    p_lat, j_lat = run["p_lat"], run["j_lat"]
    same = p_lat == j_lat
    assert float(same.mean()) >= EXACT_SHARE, float(same.mean())
    if run["pc"].cfg.model == "PPPF-AE":
        sym = run["p_sym"].reshape(p_lat.shape)
        assert np.array_equal(sym[same], np.clip(np.round(j_lat) + 3, 0, 6)[same])
    # streams cross-decode both ways to the encoder's symbols
    _, theirs_of_ours = _j_decode_symbols(run["jc"], run["p_streams"])
    np.testing.assert_array_equal(theirs_of_ours, run["p_sym"])
    recs, j_syms = _j_decode_symbols(run["jc"], run["j_streams"])
    np.testing.assert_array_equal(
        run["pc"].decode_symbols(recs, [p for p, _, _ in run["j_streams"]]), j_syms)
    # a bf16 stream decodes under a float32 config to the same symbols
    np.testing.assert_array_equal(
        run["pc32"].decode_symbols(recs, [p for p, _, _ in run["p_streams"]]), run["p_sym"])
    # decoded clouds: the same symbols through both bf16 decoders agree to
    # bf16 precision of each cloud's extent, after one int8 step
    for a, b, c in zip(run["ours"], run["ref_of_ours"], run["p_streams"]):
        longest = np.frombuffer(c[2], np.float32)[3]
        assert a.shape == b.shape and np.isfinite(a).all()
        assert float(np.abs(a - b).max()) <= 2.0 ** -6 * longest
        assert float((a == b).mean()) >= 0.9
    for a, b, c in zip(run["ours_of_theirs"], run["ref"], run["j_streams"]):
        longest = np.frombuffer(c[2], np.float32)[3]
        assert float(np.abs(a - b).max()) <= 2.0 ** -6 * longest


def test_cli_bf16_round_trip(tmp_path):
    """compress --bf16 -> decompress --bf16 in-process on the CPU, for both
    families (PPPF-AE small) and for --attributes (the geometry in bf16, the
    colours in float32): decoded clouds finite, and IPDAE's .s.bin / .c.bin
    the float32 run's bytes."""
    from pcc_tpu_torch.cli import compress, decompress

    rng = np.random.default_rng(13)
    for i in range(2):
        save_point_cloud((rng.random((256, 3)) * 2 - 1).astype(np.float32), f"c{i}.ply",
                         path=str(tmp_path / "in"),
                         rgb=rng.integers(0, 256, (256, 3)).astype(np.uint8))
    small = ["--N0", "64", "--K", "32", "--d", "4", "--device", "cpu"]
    mp = pytest.MonkeyPatch()
    _small_pppf(mp)
    for model, extra in (("AE", []), ("PPPF-AE", []), ("AE", ["--attributes", "--d_a", "4"])):
        runs = {}
        for dt in ("f32", "bf16") if model == "AE" and not extra else ("bf16",):
            flags = small + ["--model", model] + extra + (["--bf16"] if dt == "bf16" else [])
            stem = f"{model}{len(extra)}{dt}"
            comp, dec = tmp_path / f"{stem}c", tmp_path / f"{stem}d"
            compress.main([str(tmp_path / "in" / "*.ply"), str(comp), str(tmp_path / "m")]
                          + flags)
            decompress.main([str(comp), str(dec), str(tmp_path / "m")] + flags)
            runs[dt] = comp
            outs = sorted(glob.glob(str(dec / "*.ply")))
            assert len(outs) == 2 and all(np.isfinite(read_point_cloud(f)).all() for f in outs)
        for name in ("c0.ply.s.bin", "c1.ply.c.bin") if "f32" in runs else ():
            assert (runs["f32"] / name).read_bytes() == (runs["bf16"] / name).read_bytes()
    mp.undo()
