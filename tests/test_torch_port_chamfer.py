"""PyTorch port (pcc_tpu_torch) vs pcc_tpu: the training loss's chamfer
distance and rate estimate, on the CPU, same numpy inputs.

The chamfer value and its gradients in both clouds are held to
pcc_tpu.ops.chamfer at rtol 1e-5 / atol 1e-7 (float32 sums of three squared
differences in another order), with the exact and the expansion-form search
and with a key side that spans two 2048-point chunks, the second padded.
Nearest-neighbour indices and the rate estimate are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcc_tpu.coding.pmf import estimate_bits_from_pmf as j_bits
from pcc_tpu.ops import chamfer as j_chamfer
from pcc_tpu_torch.coding.pmf import estimate_bits_from_pmf
from pcc_tpu_torch.ops import chamfer


def _clouds(rng, S, N, B=2):
    x = rng.random((B, S, 3)).astype(np.float32)
    y = rng.random((B, N, 3)).astype(np.float32)
    return x, y


@pytest.mark.parametrize("fast_search", [False, True])
@pytest.mark.parametrize("S,N", [(300, 2500), (64, 96)])
def test_chamfer_value_and_grads(rng, fast_search, S, N):
    x, y = _clouds(rng, S, N)

    def j_loss(a, b):
        return j_chamfer.chamfer_distance(a, b, fast_search=fast_search)[0]

    j_val, (j_gx, j_gy) = jax.value_and_grad(j_loss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(y))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = torch.from_numpy(y).requires_grad_(True)
    val, none = chamfer.chamfer_distance(tx, ty, fast_search=fast_search)
    assert none is None
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(j_val), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(j_gx), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(j_gy), rtol=1e-5, atol=1e-7)


def test_nearest_neighbor_chunked_both_sides(rng):
    """Queries and keys both past one chunk (the last one padded): the
    exact search's indices equal pcc_tpu's, including the first index
    among duplicated keys."""
    x, y = _clouds(rng, 2100, 2300, B=1)
    y[0, 2200:] = y[0, :100]                       # duplicates in the padded chunk
    x[0, :50] = y[0, 2200:2250]
    d, i = chamfer.nearest_neighbor(torch.from_numpy(x[0]), torch.from_numpy(y[0]))
    jd, ji = j_chamfer.nearest_neighbor(jnp.asarray(x[0]), jnp.asarray(y[0]))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6)
    np.testing.assert_array_equal(i.numpy()[:50], np.arange(50))
    m = chamfer.min_sq_dists(torch.from_numpy(x[0]), torch.from_numpy(y[0]))
    np.testing.assert_allclose(m.numpy(), np.asarray(
        j_chamfer.min_sq_dists(jnp.asarray(x[0]), jnp.asarray(y[0]))), rtol=1e-6)


def test_estimate_bits_from_pmf(rng):
    """Value and pmf gradient, with probabilities under the 1e-3 clamp."""
    logits = rng.standard_normal((2, 8, 4, 7)).astype(np.float32) * 4
    sym = rng.integers(0, 7, (2, 8, 4))

    def j_f(lg):
        return j_bits(jax.nn.softmax(lg, axis=-1), jnp.asarray(sym))

    j_val, j_g = jax.value_and_grad(j_f)(jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_(True)
    val = estimate_bits_from_pmf(torch.softmax(t, -1), torch.from_numpy(sym))
    val.backward()
    assert (torch.softmax(t, -1).detach().numpy() < 1e-3).any()
    np.testing.assert_allclose(float(val.detach()), float(j_val), rtol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(j_g), rtol=1e-5, atol=1e-6)
