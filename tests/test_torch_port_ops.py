"""PyTorch port (pcc_tpu_torch) vs pcc_tpu: geometry ops on the CPU.

The same numpy inputs go through both packages. FPS indices, octree fields
and octree bytes must be bit-equal; KNN indices bit-equal in float64 (in
float32 the expanded distance's rounding may order near-ties differently,
tests/test_knn_pruned.py). Also holds the package guards: no JAX import in
the port, and no silent CPU fallback when CUDA is asked for; and
ops/bf16.py's bf16_reduce on the cotangent views the bf16 steps hand it.
"""

import ast
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcc_tpu.coding import octree_host as j_host
from pcc_tpu.coding.octree import octree_analyze as j_octree_analyze
from pcc_tpu.config import CodecConfig as JCodecConfig
from pcc_tpu.ops.fps import fps_batch as j_fps_batch
from pcc_tpu.ops.fps_pallas import fps_pallas
from pcc_tpu.ops.knn import knn_points as j_knn_points
from pcc_tpu.ops.normalize import denormalize as j_denormalize
from pcc_tpu.ops.normalize import normalize as j_normalize
from pcc_tpu_torch.coding import octree_host
from pcc_tpu_torch.coding.octree import octree_analyze
from pcc_tpu_torch.config import CodecConfig
from pcc_tpu_torch.ops.bf16 import bf16_reduce, bf16_reduce_plain, round_bf16
from pcc_tpu_torch.ops.fps import fps_batch
from pcc_tpu_torch.ops.knn import knn_points
from pcc_tpu_torch.ops.normalize import denormalize, normalize
from test_torch_port_pppf import one_thread_per_worker  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_config_matches_reference():
    """Every field the port keeps has pcc_tpu's default, and the derived
    shapes agree."""
    ours = {f.name: f.default for f in dataclasses.fields(CodecConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JCodecConfig)}
    assert {k: ref[k] for k in ours} == ours
    kw = dict(N=256, N0=64, ALPHA=2, K=32, d=4, L=7, sa_knn=8)
    a, b = CodecConfig(**kw), JCodecConfig(**kw)
    assert (a.S, a.k, a.min_bpp, a.patch_scale) == (b.S, b.k, b.min_bpp, b.patch_scale)


def test_normalize_bit_equal(rng):
    pcs = (rng.random((3, 300, 3)) * 4 - 1).astype(np.float32)
    pc01, center, longest = normalize(torch.from_numpy(pcs))
    ref = jax.vmap(j_normalize)(jnp.asarray(pcs))
    for ours, theirs in zip((pc01, center, longest), ref):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    back = denormalize(pc01[0], center[0], longest[0])
    np.testing.assert_allclose(
        back.numpy(), np.asarray(j_denormalize(ref[0][0], ref[1][0], ref[2][0])),
        atol=1e-6)
    np.testing.assert_allclose(back.numpy(), pcs[0], atol=1e-5)


@pytest.mark.parametrize("random_starts,twins", [(False, False), (True, False),
                                                  (True, True)])
def test_fps_bit_equal(rng, random_starts, twins):
    """Indices equal pcc_tpu's XLA FPS and its Pallas kernel (interpret).
    With twins every point has a duplicate, so every pick is a tie that the
    lowest index must win."""
    B, N, S = 4, 256, 16
    xyz = rng.random((B, N, 3)).astype(np.float32)
    if twins:
        xyz[:, N // 2:] = xyz[:, :N // 2]
    starts = (rng.integers(0, N, B) if random_starts
              else np.zeros(B)).astype(np.int32)
    ours = fps_batch(torch.from_numpy(xyz), S, torch.from_numpy(starts)).numpy()
    ref = np.asarray(j_fps_batch(jnp.asarray(xyz), S, jnp.asarray(starts), impl="xla"))
    kern = np.asarray(fps_pallas(jnp.asarray(xyz), S, jnp.asarray(starts),
                                 block_b=2, interpret=True))
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, kern)


def _skeletons(rng, B=3, S=16):
    xyz = rng.random((B, 256, 3)).astype(np.float32)
    idx = fps_batch(torch.from_numpy(xyz), S, torch.zeros(B, dtype=torch.int32))
    return np.take_along_axis(xyz, idx.long().numpy()[..., None], 1)


@pytest.mark.parametrize("N,min_bpp", [(256, 0.25), (4096, 0.07), (256, None)])
def test_octree_analyze_bit_equal(rng, N, min_bpp):
    sk = _skeletons(rng)
    ours = octree_analyze(torch.from_numpy(sk), N, min_bpp)
    ref = jax.vmap(lambda s: j_octree_analyze(s, N, min_bpp))(jnp.asarray(sk))
    for name in ("rec_xyz", "depth", "total_bits", "sorted_codes"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)


def test_octree_host_bytes_equal(rng):
    sk = _skeletons(rng, B=1)
    res = octree_analyze(torch.from_numpy(sk), 256, 0.25)
    depth = int(res.depth[0])
    codes = res.sorted_codes[0].numpy().astype(np.int64) >> (3 * (10 - depth))
    ours = octree_host.pack_bits(octree_host.emit_octree_bits(codes, depth))
    assert ours == j_host.pack_bits(j_host.emit_octree_bits(codes, depth))
    parsed, pdepth = octree_host.parse_octree_bits(octree_host.unpack_bits(ours))
    assert pdepth == depth
    np.testing.assert_array_equal(octree_host.codes_to_points(parsed, depth),
                                  res.rec_xyz[0].numpy())


@pytest.mark.parametrize("duplicates", [False, True])
def test_knn_points_bit_equal_f64(rng, duplicates):
    """Same neighbours in the same (distance, index) order as lax.top_k, in
    float64; duplicated points make exact distance ties."""
    p = rng.random((2, 200, 3))
    if duplicates:
        p[:, 100:150] = p[:, :50]
    q = p[:, rng.integers(0, 200, 24)]
    d, idx, nn = knn_points(torch.from_numpy(q), torch.from_numpy(p), 32,
                            return_nn=True)
    with jax.enable_x64(True):
        rd, ridx, rnn = j_knn_points(jnp.asarray(q), jnp.asarray(p), 32,
                                     return_nn=True)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
        np.testing.assert_array_equal(nn.numpy(), np.asarray(rnn))
        np.testing.assert_allclose(d.numpy(), np.asarray(rd), rtol=1e-12)


def _port_python_files():
    root = os.path.join(REPO, "pcc_tpu_torch")
    files = [os.path.join(dp, f) for dp, _, fs in os.walk(root)
             for f in fs if f.endswith(".py")]
    return files + [os.path.join(REPO, "chip_smoke.py")]


def test_port_imports_no_jax():
    """No module of the port, nor chip_smoke.py, imports jax, flax or
    pcc_tpu (the module name is matched exactly: pcc_tpu_torch is fine)."""
    banned = {"jax", "flax", "pcc_tpu"}
    bad = []
    for path in _port_python_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [(path, n) for n in names if n.split(".")[0] in banned]
    assert not bad, bad


def test_cuda_requested_without_card_raises():
    from pcc_tpu_torch.codec import Codec, init_params
    from pcc_tpu_torch.device import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a card is present; the CPU-only refusal cannot be shown")
    cfg = CodecConfig(N=256, N0=64, ALPHA=2, K=32, d=4, L=7, sa_knn=8)
    ae, prob = init_params(0, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        Codec(cfg, ae, prob, device="cuda")


@pytest.mark.parametrize("shape,perm,cols", [((64, 40, 8), (1, 0, 2), 1),
                                             ((3, 40, 6, 5), (0, 2, 1, 3), 1),
                                             ((8, 70, 6), (1, 0, 2), 2)])
def test_bf16_reduce_takes_unrounded_views(shape, perm, cols):
    """bf16_reduce on an unrounded, non-contiguous (permuted) view, as the
    bias and tiled-feature gradients hand it their cotangents, is bit for
    bit bf16_reduce_plain of the rounded, contiguous rows."""
    g = torch.Generator().manual_seed(31)
    x = torch.randn(shape, generator=g).permute(*perm)
    assert not x.is_contiguous()
    want = bf16_reduce_plain(round_bf16(x.contiguous()), cols)
    assert torch.equal(bf16_reduce(x, cols), want)
