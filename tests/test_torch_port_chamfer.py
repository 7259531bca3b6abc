"""PyTorch port (pcc_tpu_torch) vs pcc_tpu: the training loss's chamfer
distance and rate estimate, on the CPU, same numpy inputs.

The chamfer value and its gradients in both clouds are held to
pcc_tpu.ops.chamfer at rtol 1e-5 / atol 1e-7 (float32 sums of three squared
differences in another order), with the exact and the expansion-form search
and with a key side that spans two 2048-point chunks, the second padded.
Nearest-neighbour indices and the rate estimate are compared exactly.

The chamfer kernels' plain versions (ops/chamfer_cuda.py, what the wrappers
run on CPU tensors) are held to pcc_tpu's Pallas chamfer kernels under the
interpreter: distances to rtol 1e-6, indices equal to a numpy expansion-form
argmin (one float32 rounding per operation, first index among equal
minima), gradients through jax.vjp within 1e-6 of each one's largest entry;
with duplicated keys, an identical cloud whose expansions go negative, and
a cloud count past the Pallas block of 32. fits_kernel keeps pcc_tpu's
lower bound of 8 points but not its k * K <= 2^19 (the CUDA kernels stream
the other side), so chamfer_distance(fast_search=True) takes the kernels on
clouds that pcc_tpu sends down its chunked XLA path, with the same value
and gradients; the plain forward's query-side chunking changes nothing.
The module runs torch on one thread.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcc_tpu.coding.pmf import estimate_bits_from_pmf as j_bits
from pcc_tpu.ops import chamfer as j_chamfer
from pcc_tpu.ops import chamfer_pallas as j_chamfer_pallas
from pcc_tpu_torch.coding.pmf import estimate_bits_from_pmf
from pcc_tpu_torch.ops import chamfer, chamfer_cuda
from pcc_tpu_torch.ops.knn import expanded_sq_dists, sq_dists, sq_norms


@pytest.fixture(scope="module", autouse=True)
def one_thread_per_worker():
    """torch on one thread for this module: several test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clouds(rng, S, N, B=2):
    x = rng.random((B, S, 3)).astype(np.float32)
    y = rng.random((B, N, 3)).astype(np.float32)
    return x, y


@pytest.mark.parametrize("fast_search", [False, True])
@pytest.mark.parametrize("S,N", [(300, 2500), (64, 96)])
def test_chamfer_value_and_grads(rng, fast_search, S, N):
    """With fast_search both cases go through the chamfer kernels' plain
    versions (chamfer_min_dists), (300, 2500) beyond pcc_tpu's k * K <=
    2^19, where pcc_tpu itself takes its chunked XLA search: the value and
    both gradients still agree with it at rtol 1e-5."""
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


def _pairs(rng, P, k, K, case):
    """Clouds x [P, k, 3], y [P, K, 3] in [-1, 1): random; "duplicates":
    y's second half repeats its first and some x sit on the repeated keys;
    "self": y is x moved to [2, 4), each odd point one float32 step from
    the even one before it, so that the expansion of such a pair rounds to
    either side of 0 (a point against itself gives exactly 0)."""
    x = (rng.random((P, k, 3)) * 2 - 1).astype(np.float32)
    y = (rng.random((P, K, 3)) * 2 - 1).astype(np.float32)
    if case == "duplicates":
        y[:, K // 2:] = y[:, :K // 2]
        x[:, :4] = y[:, K // 2:K // 2 + 4]
    elif case == "self":
        x = x + np.float32(3.0)
        x[:, 1::2] = np.nextafter(x[:, 0::2], np.float32(np.inf))
        y = x.copy()
    return x, y


def _np_argmin(a, b):
    """The expansion (a2 - 2 a.b) + b2 in float32, one rounding per
    operation, and its first argmin: [P, n] int32."""
    a2 = (a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1]) + a[..., 2] * a[..., 2]
    b2 = (b[..., 0] * b[..., 0] + b[..., 1] * b[..., 1]) + b[..., 2] * b[..., 2]
    cross = (a[:, :, None, 0] * b[:, None, :, 0] + a[:, :, None, 1] * b[:, None, :, 1]) \
        + a[:, :, None, 2] * b[:, None, :, 2]
    d = (a2[:, :, None] - np.float32(2.0) * cross) + b2[:, None, :]
    assert d.dtype == np.float32
    return d.argmin(-1).astype(np.int32)


_FWD_CASES = [(3, 16, 128, "random"), (2, 64, 8, "random"), (33, 8, 16, "random"),
              (4, 16, 64, "duplicates"), (3, 32, 32, "self")]


@functools.lru_cache(maxsize=None)
def _pallas_case(P, k, K, case):
    """One case's clouds and random cotangents (seed 11), pcc_tpu's kernels'
    forward under the interpreter and the jax.vjp that holds its backward:
    the forward and the gradient test of a case share one interpreter run
    of the forward kernel."""
    rng = np.random.default_rng(11)
    x, y = _pairs(rng, P, k, K, case)
    gx = rng.standard_normal((P, k)).astype(np.float32)
    gy = rng.standard_normal((P, K)).astype(np.float32)
    (j_dxy, j_dyx), vjp = jax.vjp(
        lambda a, b: j_chamfer_pallas.chamfer_min_dists(a, b, interpret=True),
        jnp.asarray(x), jnp.asarray(y))
    return x, y, gx, gy, np.asarray(j_dxy), np.asarray(j_dyx), vjp


@pytest.mark.parametrize("P,k,K,case", _FWD_CASES)
def test_chamfer_fwd_plain_matches_pallas(P, k, K, case):
    x, y, _, _, j_dxy, j_dyx, _ = _pallas_case(P, k, K, case)
    dxy, dyx, ixy, iyx = chamfer_cuda.chamfer_fwd_plain(torch.from_numpy(x),
                                                        torch.from_numpy(y))
    assert ixy.dtype == iyx.dtype == torch.int32
    # on twins one float32 step apart pcc_tpu's cross term, one dot product
    # rounded its own way, picks the other twin of a pair about a third of
    # the time: the two distances then differ by the twins' own, 1.7e-13
    atol = float(sq_norms(torch.from_numpy(x[:, 1::2] - x[:, 0::2])).max()) \
        if case == "self" else 0.0
    np.testing.assert_allclose(dxy.numpy(), j_dxy, rtol=1e-6, atol=atol)
    np.testing.assert_allclose(dyx.numpy(), j_dyx, rtol=1e-6, atol=atol)
    np.testing.assert_array_equal(ixy.numpy(), _np_argmin(x, y))
    np.testing.assert_array_equal(iyx.numpy(), _np_argmin(y, x))
    if case == "duplicates":
        assert (ixy.numpy()[:, :4] == np.arange(4)).all()       # the first copy
        assert (iyx.numpy()[:, K // 2:] == iyx.numpy()[:, :K // 2]).all()
    if case == "self":
        # negative expansions pick the twin over the point itself, where a
        # clamp at 0 (ops/knn.py::sq_dists) would tie them and pick the first
        e = expanded_sq_dists(torch.from_numpy(x), torch.from_numpy(x))
        assert (e < 0).any()
        assert (ixy != sq_dists(torch.from_numpy(x), torch.from_numpy(x)).argmin(-1)).any()
        assert float(dxy.max()) < 1e-6


@pytest.mark.parametrize("P,k,K,case", [(3, 16, 128, "random"), (33, 8, 16, "random"),
                                        (4, 16, 64, "duplicates")])
def test_chamfer_grads_match_pallas_vjp(P, k, K, case):
    """ChamferFn's backward (chamfer_bwd_plain on CPU tensors) against
    jax.vjp through pcc_tpu's kernels, with random cotangents; each
    gradient within 1e-6 of its largest entry."""
    x, y, gx, gy, _, _, vjp = _pallas_case(P, k, K, case)
    j_dx, j_dy = vjp((jnp.asarray(gx), jnp.asarray(gy)))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = torch.from_numpy(y).requires_grad_(True)
    dxy, dyx = chamfer_cuda.chamfer_min_dists(tx, ty)
    torch.autograd.backward([dxy, dyx], [torch.from_numpy(gx), torch.from_numpy(gy)])
    for ours, ref in ((tx.grad, j_dx), (ty.grad, j_dy)):
        ref = np.asarray(ref)
        assert np.abs(ours.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("k,K", [(512, 1024), (8, 65536), (8, 65537), (7, 64), (8, 64),
                                 (64, 7)])
def test_fits_kernel_matches_pcc_tpu(k, K):
    """pcc_tpu's predicate: k * K = 2^19 fits, one more key does not; k and
    K at least 8. The port's domain in the same cases: at least 8 points a
    side and no bound on k * K (the CUDA kernels stream the other side);
    2-D clouds do not fit either."""
    x, y = np.empty((1, k, 3), np.float32), np.empty((1, K, 3), np.float32)
    want = j_chamfer_pallas.fits_kernel(x, y)
    assert want == (k * K <= 2 ** 19 and min(k, K) >= 8)
    assert chamfer_cuda.fits_kernel(torch.from_numpy(x), torch.from_numpy(y)) == (
        min(k, K) >= 8)
    assert not chamfer_cuda.fits_kernel(torch.from_numpy(x[0]), torch.from_numpy(y[0]))


@pytest.mark.parametrize("k,K,fast_search,routed", [(64, 96, True, True),
                                                    (7, 64, True, False),
                                                    (8, 65537, True, True),
                                                    (64, 96, False, False)])
def test_chamfer_distance_routes_through_kernels(rng, monkeypatch, k, K, fast_search, routed):
    """chamfer_distance takes chamfer_min_dists exactly when fast_search is
    set and the clouds fit the kernels, k * K past pcc_tpu's 2^19 included;
    the value matches pcc_tpu's XLA path either way (rtol 1e-6)."""
    calls = []

    def counted(x, y):
        calls.append((tuple(x.shape), tuple(y.shape)))
        return chamfer_cuda.chamfer_min_dists(x, y)

    monkeypatch.setattr(chamfer, "chamfer_min_dists", counted)
    x, y = _pairs(rng, 1, k, K, "random")
    val, _ = chamfer.chamfer_distance(torch.from_numpy(x), torch.from_numpy(y),
                                      fast_search=fast_search)
    assert len(calls) == int(routed)
    want, _ = j_chamfer.chamfer_distance(jnp.asarray(x), jnp.asarray(y),
                                         fast_search=fast_search)
    np.testing.assert_allclose(float(val), float(want), rtol=1e-6)


def test_plain_forward_chunks_the_query_side(rng, monkeypatch):
    """With PLAIN_PAIRS below one cloud pair's k * K, _nearest takes rows of
    query points a pass (here x's 40 points 3 at a time, the last pass
    ragged, and y's 24 one at a time): the same indices and distances as
    one pass over whole pairs."""
    x, y = _pairs(rng, 2, 40, 24, "duplicates")
    a, b = torch.from_numpy(x), torch.from_numpy(y)
    want = chamfer_cuda.chamfer_fwd_plain(a, b)
    monkeypatch.setattr(chamfer_cuda, "PLAIN_PAIRS", 3 * 24)
    got = chamfer_cuda.chamfer_fwd_plain(a, b)
    for u, v in zip(got, want):
        assert u.dtype == v.dtype and torch.equal(u, v)
