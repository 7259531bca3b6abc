"""PyTorch port (pcc_tpu_torch) vs pcc_tpu: SetAbstraction alone, the
function of pcc_tpu's _sa_kernel (ops/sa_pallas.py::sa_fused), on the CPU.

sa_fused_plain (what ops/sa_cuda.py::sa_fused runs on CPU tensors) and the
port's SetAbstraction(fused=True) are held to pcc_tpu's Pallas kernel under
the interpreter at atol 1e-5 (float32 sums in another order; the bar of
tests/test_sa_pallas.py), with the port's seeded IPDAE weights carried
across by weights.to_jax_params, at knn 8 and 16. The module keeps its
state_dict names with the flag set and refuses to run where autograd would
need a backward, as pcc_tpu's kernel has none.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcc_tpu.ops.sa_pallas import sa_fused as j_sa_fused
from pcc_tpu_torch.codec import init_params
from pcc_tpu_torch.config import CodecConfig
from pcc_tpu_torch.models.layers import SetAbstraction
from pcc_tpu_torch.ops import cuda_lib
from pcc_tpu_torch.ops.sa_cuda import sa_fused, sa_fused_plain
from pcc_tpu_torch.weights import to_jax_params
from test_torch_port_pppf import one_thread_per_worker  # noqa: F401

P, N = 3, 32


@pytest.fixture(scope="module")
def weights():
    """The port's seeded IPDAE SetAbstraction weights, as the `sa.`
    state_dict entries and, through weights.to_jax_params, as pcc_tpu's
    flax (kernel, bias) pairs."""
    ae_sd, _ = init_params(3, CodecConfig(N=256, N0=64, ALPHA=2, K=N, d=4, L=7))
    mlp = to_jax_params(ae_sd)[0]["params"]["sa"]["mlp"]
    j_wb = [(mlp[f"dense_{i}"]["linear"]["kernel"], mlp[f"dense_{i}"]["linear"]["bias"])
            for i in range(3)]
    sd = {k[len("sa."):]: v for k, v in ae_sd.items() if k.startswith("sa.")}
    return j_wb, sd


def _patches(seed):
    rng = np.random.default_rng(seed)
    return ((rng.random((P, N, 3)) * 2 - 1) * 0.4).astype(np.float32)


@pytest.mark.parametrize("knn", [8, 16])
def test_sa_fused_plain_and_module_match_pallas(weights, knn):
    j_wb, sd = weights
    patches = _patches(knn)
    ref = np.asarray(j_sa_fused(jnp.asarray(patches), [w for w, _ in j_wb],
                                [b for _, b in j_wb], knn=knn, interpret=True))
    module = SetAbstraction(knn=knn, fused=True)
    module.load_state_dict(sd)
    before = dict(cuda_lib.launches)
    with torch.no_grad():
        plain = sa_fused_plain(torch.from_numpy(patches), module.layers(), knn)
        fused = module(torch.from_numpy(patches))
    assert fused.shape == (P, N, 128)
    np.testing.assert_allclose(plain.numpy(), ref, atol=1e-5)
    np.testing.assert_allclose(fused.numpy(), ref, atol=1e-5)
    assert cuda_lib.launches == before            # CPU tensors: the plain version


def test_sa_module_flag_keeps_names_and_routes(weights, monkeypatch):
    """fused=True leaves the state_dict as it is and routes through
    sa_fused; with autograd wanting a gradient it raises."""
    _, sd = weights
    fused, plain = SetAbstraction(knn=8, fused=True), SetAbstraction(knn=8)
    assert list(fused.state_dict()) == list(plain.state_dict()) == list(sd)
    fused.load_state_dict(sd)
    plain.load_state_dict(sd)
    calls = []
    monkeypatch.setattr("pcc_tpu_torch.models.layers.sa_fused",
                        lambda *a: calls.append(a) or sa_fused(*a))
    x = torch.from_numpy(_patches(1))
    with torch.no_grad():
        torch.testing.assert_close(fused(x), plain(x), atol=1e-6, rtol=0)
        assert len(calls) == 1
    with pytest.raises(RuntimeError, match="no backward"):
        fused(x)


@pytest.mark.parametrize("tool", ["stage_breakdown", "decoder_breakdown", "fps_breakdown",
                                  "bwd_breakdown"])
def test_breakdown_variants_apply_to_the_sources(tool):
    """Every variant of the breakdown tools that time today's kernels edits
    text that its kernel source holds, so that the tools build on the card
    (bwd_breakdown, whose CURRENT names them, and chamfer_breakdown also
    list texts of older designs)."""
    import importlib

    from pcc_tpu_torch.tools.variants import edited

    mod = importlib.import_module(f"pcc_tpu_torch.tools.{tool}")
    specs = {"stage_breakdown": lambda: mod.VARIANTS,
             "decoder_breakdown": lambda: {
                 **{k: ("patch_decoder", v) for k, v in mod.VARIANTS.items()},
                 **{f"bf16 {k}": ("patch_decoder_bf16", v)
                    for k, v in mod.BF16_VARIANTS.items()}},
             "fps_breakdown": lambda: {"butterfly": ("fps", [[mod.BUTTERFLY]])},
             "bwd_breakdown": lambda: {k: ("patch_encoder_bwd", mod.ENC_VARIANTS[k])
                                       for k in mod.CURRENT}}[tool]()
    for label, (kernel, alternatives) in specs.items():
        assert edited(kernel, alternatives) is not None, (tool, label)


def test_variant_edits_take_the_first_alternative_that_applies():
    """tools/variants.py::edited applies the first alternative whose old
    texts all occur in the source, and gives None where none does."""
    from pcc_tpu_torch.tools.variants import edited

    with open(os.path.join(cuda_lib.CSRC_DIR, "sa_fused.cu")) as f:
        text = f.read()
    head = text.splitlines()[0]
    assert edited("sa_fused", [[]]) == text
    assert edited("sa_fused", [[("no such text", "x")], [(head, "// edited")]]) == \
        text.replace(head, "// edited")
    assert edited("sa_fused", [[(head, "a"), ("no such text", "b")]]) is None


# ------------------------------------------------------------------ bf16 --

BF16 = jnp.bfloat16
BF16_SHARE = 0.95          # entries bit-equal at least (float32 sums in another order)
BF16_TOL = 2.0 ** -7       # of the largest |entry|, every entry


def _held(got, want) -> bool:
    """The bf16 hold: at least BF16_SHARE of the entries bit-equal and every
    entry within BF16_TOL of the largest |entry|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return bool(got.shape == want.shape and (got == want).mean() >= BF16_SHARE
                and np.abs(got - want).max() <= BF16_TOL * np.abs(want).max())


@pytest.mark.parametrize("knn", [8, 16])
def test_sa_fused_plain_bf16_matches_pallas(weights, knn):
    """sa_fused_plain(bf16=True) against pcc_tpu's _sa_kernel with
    compute_dtype bfloat16 under the interpreter: the bf16 hold, bf16
    values out. The bias trap: _sa_kernel rounds the biases too (its
    `load`), unlike the stage kernel, and the plain version with the
    biases unrounded (ops/sa_cuda.py::replay_wb) fails the hold."""
    from pcc_tpu_torch.ops.knn import select_nearest, sq_dists
    from pcc_tpu_torch.ops.sa_cuda import replay_wb, sa_features

    j_wb, sd = weights
    patches = _patches(knn + 1)
    ref = np.asarray(j_sa_fused(jnp.asarray(patches), [w for w, _ in j_wb],
                                [b for _, b in j_wb], knn=knn, compute_dtype=BF16,
                                interpret=True))
    module = SetAbstraction(knn=knn)
    module.load_state_dict(sd)
    p = torch.from_numpy(patches)
    with torch.no_grad():
        got = sa_fused_plain(p, module.layers(), knn, bf16=True)
        unrounded_b = sa_features(p, select_nearest(sq_dists(p, p), knn),
                                  replay_wb(module.layers()), bf16=True)
    assert torch.equal(got.to(torch.bfloat16).float(), got)
    assert _held(got, ref)
    assert not _held(unrounded_b, ref)


def test_sa_module_bf16_fused_and_unfused_match_pcc_tpu(weights, monkeypatch):
    """SetAbstraction(compute_dtype="bfloat16") against pcc_tpu's
    SetAbstraction(dtype=bfloat16), fused=True under PCC_PALLAS_INTERPRET=1
    (its Pallas kernel) and fused=False under plain jit (flax's bf16 Dense
    layer by layer): each under the bf16 hold, and each failing it against
    the other flag's reference, since the flag changes bf16 results (the
    kernel rounds each layer once after a float32 bias add, flax rounds the
    product and again after the bias add)."""
    from pcc_tpu.models.layers import SetAbstraction as JSetAbstraction

    j_wb, sd = weights
    variables = {"params": {"mlp": {f"dense_{i}": {"linear": {"kernel": w, "bias": b}}
                                    for i, (w, b) in enumerate(j_wb)}}}
    x = _patches(3)
    refs = {}
    for fused in (True, False):
        if fused:
            monkeypatch.setenv("PCC_PALLAS_INTERPRET", "1")
        else:
            monkeypatch.delenv("PCC_PALLAS_INTERPRET", raising=False)
        jm = JSetAbstraction(knn=8, dtype=BF16, fused=fused)
        refs[fused] = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x))).astype(np.float32)
    for fused in (True, False):
        module = SetAbstraction(knn=8, fused=fused, compute_dtype="bfloat16").eval()
        module.load_state_dict(sd)
        with torch.no_grad():
            got = module(torch.from_numpy(x))
        assert got.shape == (P, N, 128) and torch.equal(got.to(torch.bfloat16).float(), got)
        assert _held(got, refs[fused]), fused
        assert not _held(got, refs[not fused]), fused
