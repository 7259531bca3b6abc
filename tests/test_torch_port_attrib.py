"""PyTorch port (pcc_tpu_torch) vs pcc_tpu: the RGB attribute extension on
the CPU, at tests/test_attrib.py's config (N = 512, K = 64, d = 8, d_a = 8,
L = 7, sa_knn 8), with the port's seeded weights carried to pcc_tpu by
weights.to_jax_params / attr_to_jax and the same numpy clouds, whose
colours are a smooth function of position plus noise.

  * PatchAttrAE's encode, decode and training call against flax's apply,
    within 1e-5; the weight bridge round-trips bitwise;
  * AttrCodec against pcc_tpu's AttrCodec (integer CDF mode): .s.bin and
    .c.bin byte-equal; .p.bin and .a.bin cross-decode both ways, each
    package's integer coder reading the other's streams to the symbols that
    were encoded; decoded clouds within 1e-5 and colours within one level
    (u8) of pcc_tpu's decode of the same streams;
  * attr_rd_forward's loss and aux to 1e-6 relative and every gradient
    within 1e-5 of its tensor's largest entry, against pcc_tpu's jitted
    value_and_grad on the same FPS starts (the patch decoder spread out,
    as the step tests do, against float32 chamfer near-ties);
  * cli/train_attributes.py for 2 steps, its four pickles read by pcc_tpu,
    and compress --attributes -> decompress --attributes through the port's
    CLIs with them.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcc_tpu import attrib as j_attrib
from pcc_tpu.coding import iprob as j_iprob
from pcc_tpu.coding import rangecoder as j_rc
from pcc_tpu.coding.octree_host import codes_to_points, parse_octree_bits, unpack_bits
from pcc_tpu.config import CodecConfig as JCodecConfig
from pcc_tpu_torch.attrib import (AttrCodec, attr_rd_forward, create_attr_train_state,
                                  init_attr_params, make_attr_models)
from pcc_tpu_torch.codec import init_params
from pcc_tpu_torch.config import CodecConfig
from pcc_tpu_torch.io import read_point_cloud_attr, save_point_cloud
from pcc_tpu_torch.train.state import make_optimizer
from pcc_tpu_torch.weights import attr_from_jax, attr_to_jax, to_jax_params
from test_torch_port_pppf import one_thread_per_worker  # noqa: F401

KW = dict(N=512, N0=64, ALPHA=2, K=64, d=8, L=7, sa_knn=8)
CFG, JCFG = CodecConfig(**KW), JCodecConfig(**KW)
D_A = 8


def coloured_clouds(seed: int, n: int, N: int = CFG.N):
    """Clouds in [-1, 1]^3 and u8 colours: a smooth function of position
    plus noise."""
    rng = np.random.default_rng(seed)
    pcs = (rng.random((n, N, 3)) * 2 - 1).astype(np.float32)
    smooth = 0.5 + 0.4 * np.sin(2.5 * pcs + np.array([0.0, 1.0, 2.0]))
    rgb = np.clip((smooth + rng.normal(0, 0.03, pcs.shape)) * 255, 0, 255).astype(np.uint8)
    return list(pcs), list(rgb)


@pytest.fixture(scope="module")
def run():
    """Both codecs on the same weights and 2 coloured clouds; each
    encoder's own symbols."""
    ae_sd, prob_sd = init_params(3, CFG)
    attr_sd, attr_prob_sd = init_attr_params(4, CFG, D_A)
    ae_v, prob_v = to_jax_params(ae_sd, prob_sd)
    attr_v, attr_prob_v = attr_to_jax(attr_sd, attr_prob_sd)
    jparams = {"ae": ae_v, "prob": prob_v, "attr": attr_v, "attr_prob": attr_prob_v}
    jc = j_attrib.AttrCodec(JCFG, jparams, batch_size=2, d_a=D_A)
    pc = AttrCodec(CFG, {"ae": ae_sd, "prob": prob_sd, "attr": attr_sd,
                         "attr_prob": attr_prob_sd}, batch_size=2, d_a=D_A, device="cpu")
    clouds, rgbs = coloured_clouds(11, 2)
    starts = np.array([0, 101], np.int32)
    j_streams = jc.compress_many(clouds, rgbs, list(starts))
    p_streams = pc.compress_many(clouds, rgbs, list(starts))
    res = pc.encode_batch(np.stack(clouds), np.stack(rgbs), starts)
    jres = jc._enc(CFG.N)(jparams, jnp.asarray(
        j_attrib.pack_attr_upload(np.stack(clouds), np.stack(rgbs), starts)))
    return dict(jc=jc, pc=pc, jparams=jparams, clouds=clouds, rgbs=rgbs,
                j_streams=j_streams, p_streams=p_streams,
                p_sym=(res.sym.numpy(), res.asym.numpy()),
                j_sym=(np.asarray(jres.sym), np.asarray(jres.asym)))


def test_patch_attr_ae_matches_flax():
    """encode, decode and the training call (straight-through round) on
    random patches; the bridge back gives the same state_dict bitwise."""
    attr_sd, _ = init_attr_params(4, CFG, D_A)
    attr, _ = make_attr_models(CFG, D_A)
    attr.load_state_dict(attr_sd)
    variables, _ = attr_to_jax(attr_sd)
    rng = np.random.default_rng(2)
    xyz, rgb = (rng.random((3, CFG.K, 3)).astype(np.float32) for _ in range(2))
    dec_xyz = (rng.random((3, CFG.k, 3)) * 2 - 1).astype(np.float32)
    jm = j_attrib.PatchAttrAE(d_a=D_A, L=CFG.L)
    want = jax.jit(lambda v, a, b, c: jm.apply(v, a, b, c))(
        variables, jnp.asarray(xyz), jnp.asarray(rgb), jnp.asarray(dec_xyz))
    with torch.no_grad():
        got = attr(torch.from_numpy(xyz), torch.from_numpy(rgb), torch.from_numpy(dec_xyz))
    for g, w, name in zip(got, want, ("rgb", "z", "z_q")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, err_msg=name)
    back, _ = attr_from_jax(variables, None)
    assert set(back) == set(attr_sd)
    for k, v in attr_sd.items():
        assert torch.equal(back[k], v), k


def _skeletons(streams):
    return np.stack([codes_to_points(*parse_octree_bits(unpack_bits(s)))
                     for _, s, _, _ in streams])


def test_streams_match_pcc_tpu(run):
    """.s.bin and .c.bin byte-equal; pcc_tpu's integer coder (its bundles,
    weights and rows, its range decoder) reads the port's .p.bin and .a.bin
    back to the port encoder's symbols, and the port reads pcc_tpu's to
    pcc_tpu's."""
    for (_, js, jc_, _), (_, ps, pc_, _) in zip(run["j_streams"], run["p_streams"]):
        assert ps == js and pc_ == jc_
    recs = _skeletons(run["p_streams"])
    jp = run["jparams"]
    for k, (prob, d) in enumerate(((jp["prob"], CFG.d), (jp["attr_prob"], D_A))):
        bundle = j_iprob.convert_prob_params(prob, d, CFG.L)
        rows = j_iprob.weights_to_cdf_rows(
            np.asarray(j_iprob.iprob_pmf_weights(bundle, jnp.asarray(recs))))
        for j, streams in enumerate(run["p_streams"]):
            blob = streams[0 if k == 0 else 3]
            np.testing.assert_array_equal(j_rc.decode_quantized_cdf(rows[j], blob),
                                          run["p_sym"][k][j])
    got = run["pc"].decode_symbols(recs, [p for p, _, _, _ in run["j_streams"]],
                                   [a for _, _, _, a in run["j_streams"]])
    for k in range(2):
        np.testing.assert_array_equal(got[k], run["j_sym"][k])


def test_decoded_clouds_and_colours(run):
    """The port and pcc_tpu decoding the port's streams: clouds within 1e-5
    of their extent, every colour within one level, at least 99% equal."""
    ours = run["pc"].decompress_many(run["p_streams"])
    ref = run["jc"].decompress_many(run["p_streams"])
    for (pc, rgb), (jpc, jrgb) in zip(ours, ref):
        assert pc.shape == jpc.shape == (CFG.S * CFG.k, 3) and rgb.dtype == np.uint8
        np.testing.assert_allclose(pc, jpc, rtol=0, atol=1e-5 * np.abs(jpc).max())
        diff = np.abs(rgb.astype(int) - jrgb.astype(int))
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.99


def test_attr_rd_forward_matches_pcc_tpu():
    """Loss, chamfer, colour MSE and bpp at lam 1e-2 to 1e-6 relative, and
    every gradient of the four models within 1e-5 of its tensor's largest
    entry (1.7e-6 measured), against pcc_tpu's jitted value_and_grad of its
    attr_rd_forward on the same FPS starts; float32. The patch decoder's
    last layer is scaled up 30 times, as the PPPF-AE step tests scale
    FoldingNet's: at init a patch's decoded points crowd together, the
    chamfer's nearest neighbours near-tie among them in float32, and its
    gradients then differ by 4e-3 of the largest between the packages."""
    tx = make_optimizer(5e-4, 0.1, 100, 100)
    state = create_attr_train_state(5, CFG, tx, D_A, device="cpu")
    with torch.no_grad():
        last = state.ae.inv_mlp.mlp_Modules[3][0]
        last.weight.mul_(30.0)
        last.bias.mul_(30.0)
    clouds, rgbs = coloured_clouds(12, 2)
    batch = np.stack(clouds)
    colors = np.stack(rgbs).astype(np.float32) / 255.0
    key = jax.random.key(9)
    starts = np.asarray(jax.random.randint(key, (2,), 0, CFG.N, dtype=jnp.int32))
    ae_v, prob_v = to_jax_params(state.ae.state_dict(), state.prob.state_dict())
    attr_v, attr_prob_v = attr_to_jax(state.attr.state_dict(), state.attr_prob.state_dict())
    params = {"ae": ae_v, "prob": prob_v, "attr": attr_v, "attr_prob": attr_prob_v}
    (j_loss, j_aux), j_grads = jax.jit(jax.value_and_grad(
        functools.partial(j_attrib.attr_rd_forward, cfg=JCFG, d_a=D_A), has_aux=True))(
        params, jnp.asarray(batch), jnp.asarray(colors), key, 1e-2)

    loss, aux = attr_rd_forward(state, torch.from_numpy(batch), torch.from_numpy(colors),
                                torch.from_numpy(starts), 1e-2, CFG)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-6)
    for k in ("chamfer", "color_mse", "bpp"):
        np.testing.assert_allclose(float(aux[k]), float(j_aux[k]), rtol=1e-6, err_msg=k)

    def grads(model):
        return {k: p.grad for k, p in model.named_parameters()}
    ours = (*to_jax_params(grads(state.ae), grads(state.prob)),
            *attr_to_jax(grads(state.attr), grads(state.attr_prob)))
    for name, tree in zip(("ae", "prob", "attr", "attr_prob"), ours):
        for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(tree),
                                     jax.tree_util.tree_leaves_with_path(j_grads[name])):
            b = np.asarray(b)
            assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), (
                name, jax.tree_util.keystr(path))


def test_train_attributes_then_compress_decompress(tmp_path):
    """cli/train_attributes.py for 2 steps writes the four pickles in
    pcc_tpu's layout (pcc_tpu's init trees, same shapes); the port's
    compress --attributes and decompress --attributes run with them and
    write coloured PLYs."""
    from pcc_tpu_torch.cli import compress, decompress, train_attributes

    inp, model = tmp_path / "in", tmp_path / "model"
    clouds, rgbs = coloured_clouds(13, 2)
    for i, (pc, rgb) in enumerate(zip(clouds, rgbs)):
        save_point_cloud(pc, f"c{i}.ply", path=str(inp), rgb=rgb)
    geo = ["--N0", "64", "--K", "64", "--d", "8", "--d_a", str(D_A), "--device", "cpu"]
    train_attributes.main(["--train_glob", str(inp / "*.ply"), "--model_save_folder",
                           str(model), "--N", str(CFG.N), "--batch_size", "2",
                           "--max_steps", "2", "--step_window", "1"] + geo)
    want = jax.tree.map(np.shape, j_attrib.init_attr_params(jax.random.key(0), JCFG, D_A))
    import pickle
    for name, tree in zip(("attr", "attr_prob"), want):
        with open(model / f"{name}.pkl", "rb") as f:
            assert jax.tree.map(np.shape, pickle.load(f)) == tree
    assert sorted(os.listdir(model)) == ["ae.pkl", "attr.pkl", "attr_prob.pkl", "prob.pkl"]

    compress.main([str(inp / "*.ply"), str(tmp_path / "comp"), str(model), "--attributes"]
                  + geo)
    assert len(os.listdir(tmp_path / "comp")) == 8
    decompress.main([str(tmp_path / "comp"), str(tmp_path / "dec"), str(model),
                     "--attributes"] + geo)
    for i in range(2):
        pc, rgb = read_point_cloud_attr(str(tmp_path / "dec" / f"c{i}.ply.bin.ply"))
        assert pc.shape == (CFG.S * CFG.k, 3) and rgb is not None and rgb.shape == pc.shape


# bf16 geometry: a symbol may differ from pcc_tpu's only where pcc_tpu's
# latent lies within NEAR_TIE of a rounding boundary (float32 sums in
# another order move a bf16 rounding now and then, which the calibrated
# last layer amplifies); stated before the first run
NEAR_TIE = 2.0 ** -4


def test_bf16_geometry_matches_pcc_tpu_attr_codec():
    """compress --attributes --bf16's geometry: pcc_tpu's AttrCodec builds
    its PatchAE with make_models(cfg), fused kernels off, so in bf16 it
    rounds by flax's Dense rule (pcc_tpu/attrib.py:116, 222). The port's
    AttrCodec in bf16 against it, on weights whose last encoder layer is
    calibrated (as chip_smoke.py's spread_symbols does) so that the symbols
    spread over the bins: the geometry symbols equal but for near-ties
    (NEAR_TIE); the same symbols decoded by both packages' PatchAE
    decoders (AttrCodec's decode_clouds_attr takes decode_unfused) within
    bf16's tolerance (at least 0.99 of the points' coordinates bit-equal,
    every one within 2^-7 of the largest)."""
    kw = dict(KW, compute_dtype="bfloat16")
    cfg, jcfg = CodecConfig(**kw), JCodecConfig(**kw)
    ae_sd, prob_sd = init_params(3, cfg)
    attr_sd, attr_prob_sd = init_attr_params(4, cfg, D_A)
    clouds, rgbs = coloured_clouds(11, 2)
    starts = np.array([0, 101], np.int32)
    from pcc_tpu.codec import make_models as j_make_models
    from pcc_tpu.models.ipdae import PatchAE as JPatchAE
    from pcc_tpu_torch.codec import encode_geometry as p_geometry
    from pcc_tpu_torch.codec import make_models as p_make_models
    from pcc_tpu_torch.codec import pack_encode_upload as p_pack
    from pcc_tpu_torch.codec import unpack_encode_upload as p_unpack
    from pcc_tpu_torch.ops.sa_cuda import patch_encoder

    # the last PointNet layer scaled and shifted per channel: the float32
    # latent over these patches to mean 0, standard deviation 1.5
    pcs, st = p_unpack(torch.from_numpy(p_pack(np.stack(clouds), starts).view(np.int32)), CFG.N)
    ae32, _ = p_make_models(CFG)
    ae32.load_state_dict(ae_sd)
    with torch.no_grad():
        patches = p_geometry(pcs, st, CFG).patches
        z = patch_encoder(patches, ae32.sa.layers(), ae32.pn.layers(), CFG.sa_knn)
    scale = 1.5 / z.std(dim=0)
    key = "pn.mlp_Modules.3.0"
    ae_sd = dict(ae_sd)
    ae_sd[key + ".bias"] = (ae_sd[key + ".bias"] - z.mean(dim=0)) * scale
    w = ae_sd[key + ".weight"]
    ae_sd[key + ".weight"] = w * scale.view(-1, *[1] * (w.dim() - 1))

    ae_v, prob_v = to_jax_params(ae_sd, prob_sd)
    attr_v, attr_prob_v = attr_to_jax(attr_sd, attr_prob_sd)
    jparams = {"ae": ae_v, "prob": prob_v, "attr": attr_v, "attr_prob": attr_prob_v}
    jc = j_attrib.AttrCodec(jcfg, jparams, batch_size=2, d_a=D_A)
    pc = AttrCodec(cfg, {"ae": ae_sd, "prob": prob_sd, "attr": attr_sd,
                         "attr_prob": attr_prob_sd}, batch_size=2, d_a=D_A, device="cpu")
    res = pc.encode_batch(np.stack(clouds), np.stack(rgbs), starts)
    jres = jc._enc(cfg.N)(jparams, jnp.asarray(
        j_attrib.pack_attr_upload(np.stack(clouds), np.stack(rgbs), starts)))
    sym, jsym = res.sym.numpy().astype(np.int32), np.asarray(jres.sym)
    assert len(np.unique(jsym)) >= 5                  # spread over the bins
    # pcc_tpu's latent for the differing symbols: near a rounding boundary
    jae, _ = j_make_models(jcfg)
    jlat = np.asarray(jax.jit(lambda v, p: jae.apply(v, p, method=JPatchAE.encode))(
        ae_v, jnp.asarray(patches.numpy()))).reshape(jsym.shape)
    differ = sym != jsym
    frac = np.abs(jlat - np.floor(jlat) - 0.5)
    assert np.all(frac[differ] <= NEAR_TIE), (int(differ.sum()), frac[differ].max())
    # the same symbols through both decoders
    latent_q = (jsym - cfg.L // 2).astype(np.float32).reshape(-1, cfg.d)
    want = np.asarray(jax.jit(lambda v, q: jae.apply(v, q, method=JPatchAE.decode))(
        ae_v, jnp.asarray(latent_q)))
    with torch.no_grad():
        got = pc.ae.decode_unfused(torch.from_numpy(latent_q)).numpy()
    assert float((got == want).mean()) >= 0.99
    assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max()
