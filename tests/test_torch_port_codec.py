"""PyTorch port (pcc_tpu_torch) vs pcc_tpu: the whole compress -> decompress
slice on the CPU, same weights, same clouds.

  * .s.bin and .c.bin byte-equal: the port dequantizes the 10-bit upload
    as pcc_tpu's XLA CPU program does, per axis for the bounding box (x and
    y as one fused multiply-add, z unfused) and fused on every axis for the
    normalized coordinates; also on eval/gen_rooms.py's 100,000-point room,
    all three streams;
  * streams cross-decode both ways to the encoder's own symbols;
  * decoded clouds agree to one int8 step of each patch's scale;
  * one in-process CLI round trip.
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
from pcc_tpu.coding import rangecoder as j_rc
from pcc_tpu.coding.octree_host import codes_to_points, parse_octree_bits, unpack_bits
from pcc_tpu.config import CodecConfig as JCodecConfig
from pcc_tpu_torch.codec import Codec, decode_clouds_packed
from pcc_tpu_torch.config import CodecConfig
from pcc_tpu_torch.io import read_point_cloud, save_point_cloud
from pcc_tpu_torch.weights import from_jax_params
from test_torch_port_pppf import one_thread_per_worker  # noqa: F401

KW = dict(N=256, N0=64, ALPHA=2, K=32, d=4, L=7, sa_knn=8)
CFG, JCFG = CodecConfig(**KW), JCodecConfig(**KW)


@pytest.fixture(scope="module")
def run():
    """Both codecs on the same 3 clouds; encodes computed once."""
    ae_vars, prob_vars = jax.jit(j_codec.init_params, static_argnums=1)(jax.random.key(1), JCFG)
    jc = j_codec.Codec(JCFG, ae_vars, prob_vars, batch_size=4)
    pc = Codec(CFG, *from_jax_params(ae_vars, prob_vars), batch_size=4,
               device="cpu")
    rng = np.random.default_rng(11)
    clouds = [(rng.random((CFG.N, 3)) * 4 - 1).astype(np.float32) for _ in range(3)]
    starts = np.array([0, 17, 200], np.int32)
    j_streams = jc.compress_many(clouds, list(starts))
    p_streams = pc.compress_many(clouds, list(starts))
    # each encoder's own symbols
    p_sym = pc.encode_batch(np.stack(clouds), starts).sym.numpy()
    q, lo, scale = j_codec.pack_clouds_u10(np.stack(clouds))
    enc = jax.jit(functools.partial(j_codec.encode_clouds_packed_input, cfg=jc.cfg))
    j_sym = np.asarray(enc(ae_vars, prob_vars, jnp.asarray(q), jnp.asarray(lo),
                           jnp.asarray(scale), jnp.asarray(starts)).sym)
    j_bundle = j_iprob.convert_prob_params(prob_vars, JCFG.d, JCFG.L)
    return dict(jc=jc, pc=pc, clouds=clouds, j_streams=j_streams,
                p_streams=p_streams, p_sym=p_sym, j_sym=j_sym, j_bundle=j_bundle)


def _skeleton(s_bytes):
    codes, depth = parse_octree_bits(unpack_bits(s_bytes))
    return codes_to_points(codes, depth)


def _clouds(seed, n):
    rng = np.random.default_rng(seed)
    return [(rng.random((CFG.N, 3)) * 4 - 1).astype(np.float32) for _ in range(n)]


def test_skeleton_and_header_streams(run):
    """.s.bin and .c.bin byte-equal, over the fixture's clouds (seed 11)
    and two more seeds."""
    pairs = list(zip(run["j_streams"], run["p_streams"]))
    for seed in (12, 13):
        clouds = _clouds(seed, 3)
        pairs += list(zip(run["jc"].compress_many(clouds), run["pc"].compress_many(clouds)))
    assert len(pairs) == 9
    for (_, js, jc_), (_, ps, pc_) in pairs:
        assert ps == js
        assert pc_ == jc_


def test_header_dequantization_per_axis(run):
    """Clouds (seeds 2, 3, 7) whose .c.bin differs when all three axes are
    dequantized as a fused multiply-add: pcc_tpu's header is the per-axis
    one, and the port's equals it."""
    from pcc_tpu_torch.codec import _INV_1023, pack_encode_upload, unpack_encode_upload
    from pcc_tpu_torch.ops.normalize import normalize

    for seed in (2, 3, 7):
        clouds = _clouds(seed, 1)
        (_, _, j_c), = run["jc"].compress_many(clouds)
        (_, _, p_c), = run["pc"].compress_many(clouds)
        assert p_c == j_c
        packed = torch.from_numpy(pack_encode_upload(np.stack(clouds),
                                                      np.zeros(1, np.int32)).view(np.int32))
        N = CFG.N
        q = packed[:, :N]
        lo = packed[:, N:N + 3].contiguous().view(torch.float32)
        step = packed[:, N + 3:N + 6].contiguous().view(torch.float32) * _INV_1023
        v = torch.stack([q & 1023, (q >> 10) & 1023, (q >> 20) & 1023], dim=-1)
        all_fused = (v.double() * step[:, None].double() + lo[:, None].double()).float()
        _, center, longest = normalize(all_fused)
        header = np.concatenate([center[0].numpy(), longest.numpy()]).astype(np.float32)
        assert header.tobytes() != j_c
        _, center, longest = normalize(unpack_encode_upload(packed, N)[0])
        header = np.concatenate([center[0].numpy(), longest.numpy()]).astype(np.float32)
        assert header.tobytes() == j_c


def test_streams_cross_decode_both_ways(run):
    """pcc_tpu's host coder reads the port's .p.bin back to the port
    encoder's symbols, and the port reads pcc_tpu's to pcc_tpu's."""
    recs = np.stack([_skeleton(s) for _, s, _ in run["p_streams"]])
    w = np.asarray(j_iprob.iprob_pmf_weights(run["j_bundle"], jnp.asarray(recs)))
    cdfs = j_iprob.weights_to_cdf_rows(w)
    for j, (p_bytes, _, _) in enumerate(run["p_streams"]):
        np.testing.assert_array_equal(
            j_rc.decode_quantized_cdf(cdfs[j], p_bytes), run["p_sym"][j])
    ours = run["pc"].decode_symbols(recs, [p for p, _, _ in run["j_streams"]])
    np.testing.assert_array_equal(ours, run["j_sym"])


def test_decoded_clouds_within_one_int8_step(run):
    """The port decoding its streams vs pcc_tpu decoding its own, and
    pcc_tpu's full decompress of the port's streams."""
    pc = run["pc"]
    ours = pc.decompress_many(run["p_streams"])
    ref = run["jc"].decompress_many(run["j_streams"])
    ref_of_ours = run["jc"].decompress_many(run["p_streams"])
    with torch.no_grad():
        _, scale = decode_clouds_packed(pc.ae, torch.from_numpy(run["p_sym"]), CFG)
    for j, (_, _, c_bytes) in enumerate(run["p_streams"]):
        longest = np.frombuffer(c_bytes, np.float32)[3]
        step = scale[j].numpy() / 127.0 * longest / (1.0 - CFG.margin)   # [S, 3]
        tol = np.repeat(step, CFG.k, axis=0) + 1e-6                        # [S*k, 3]
        assert ours[j].shape == (CFG.S * CFG.k, 3)
        assert np.all(np.abs(ours[j] - ref[j]) <= tol)
        assert np.all(np.abs(ours[j] - ref_of_ours[j]) <= tol)


def test_cli_round_trip(tmp_path, run):
    from pcc_tpu_torch.cli import compress, decompress

    inp, comp, dec, model = (tmp_path / n for n in ("in", "comp", "dec", "model"))
    model.mkdir()
    for i, c in enumerate(run["clouds"][:2]):
        save_point_cloud(c, f"c{i}.ply", path=str(inp))
    flags = ["--N0", "64", "--K", "32", "--d", "4", "--L", "7",
             "--batch_size", "2", "--device", "cpu"]
    compress.main([str(inp / "*.ply"), str(comp), str(model), *flags])
    decompress.main([str(comp), str(dec), str(model), *flags])
    outs = sorted(glob.glob(os.path.join(dec, "*.bin.ply")))
    assert [os.path.basename(o) for o in outs] == ["c0.ply.bin.ply", "c1.ply.bin.ply"]
    for o in outs:
        pts = read_point_cloud(o)
        assert pts.shape == (CFG.S * CFG.k, 3) and np.isfinite(pts).all()


def test_large_scene_room_streams_match_pcc_tpu():
    """eval/gen_rooms.py's 100,000-point room (its seed, after a 65,536-point
    one; S = 781): .s.bin, .c.bin and .p.bin byte-equal to pcc_tpu's CPU
    codec. Its skeleton is the one of the repo's rooms that tells the two
    dequantizations of pcc_tpu's upload apart: with the normalized
    coordinates taken from codec.py::unpack_encode_upload's values instead
    of upload_values', the skeleton and its .s.bin differ."""
    import chip_smoke
    import pcc_tpu_torch.codec as p_codec

    room = chip_smoke.rooms([65536, 100000], 7)[1]   # eval/gen_rooms.py's generator
    ae_vars, prob_vars = jax.jit(j_codec.init_params, static_argnums=1)(
        jax.random.key(2), JCodecConfig())
    (j_streams,) = j_codec.Codec(JCodecConfig(), ae_vars, prob_vars,
                                 batch_size=1).compress_many([room])
    pc = Codec(CodecConfig(), *from_jax_params(ae_vars, prob_vars), batch_size=1,
               device="cpu")
    (p_streams,) = pc.compress_many([room])
    assert p_streams == j_streams
    # the other dequantization: only .s.bin and .c.bin are read, and neither
    # depends on the latents, so the encoder's MLP gives way to zeros there
    values = p_codec.upload_values
    p_codec.upload_values = lambda packed, N: p_codec.unpack_encode_upload(packed, N)[0]
    pc.ae.encode = lambda patches: patches.new_zeros(patches.shape[0], pc.cfg.d)
    try:
        (old,) = pc.compress_many([room])
    finally:
        p_codec.upload_values = values
        del pc.ae.encode
    assert old[1] != j_streams[1] and old[2] == j_streams[2]
