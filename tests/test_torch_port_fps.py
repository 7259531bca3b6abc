"""PyTorch port (pcc_tpu_torch) vs pcc_tpu: farthest point sampling on the CPU.

The plain versions beside the CUDA kernel csrc/fps.cu (ops/fps.py) against
pcc_tpu on the same numpy inputs, bit for bit:
  * fps_int_plain (the integer CPM's FPS) against pcc_tpu's
    coding/iprob_pppf.py::_int_fps_jnp (JAX on the CPU) and its numpy spec
    _int_fps_np, at the CPM's stage forms reduced in size: a saturating
    stage (more picks than points), a stage that samples, duplicated points
    that force ties; inf as the CPM computes it from _qsel;
  * fps_plain against pcc_tpu's Pallas kernel (fps_pallas, interpret mode)
    and its XLA FPS at the small-cloud forms: a saturating one and one
    with twins;
  * fps_plain against pcc_tpu's XLA FPS at the large-scene rooms' sizes
    (65,536 and 100,000 points, a few picks);
  * the launcher's rule (ops/fps.py::plan) picks only plans the kernel
    takes, at every shape of the users' paths, up to MAX_POINTS.
The kernel itself is held to these plain versions on the card
(tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcc_tpu.coding import iprob_pppf as j_ipppf
from pcc_tpu.ops.fps import fps_batch as j_fps_batch
from pcc_tpu.ops.fps_pallas import fps_pallas
from pcc_tpu_torch.coding import iprob_pppf as ipppf
from pcc_tpu_torch.ops import fps as fps_ops

# (B, N, npoint) of every FPS call on the users' paths (ops/fps.py's docstring
# names them): skeletons, the PN++ encoder's sa2 / sa3, the float CPM's stages
# in the N = 8192 and N = 512 train steps, the integer CPM's stages, the PPPE
# encoder's sa1 / sa2 / sa3 at a 32-cloud batch, and the skeletons of
# eval/gen_rooms.py's large-scene rooms at --batch_size 4 (six of 65,536
# points: a batch of 4 and one of 2; one each of 50,000 and 100,000)
PATH_SHAPES = [(64, 8192, 64), (16, 8192, 64), (8, 8192, 64), (1024, 256, 128),
               (1024, 128, 32), (512, 256, 128), (512, 128, 32), (8, 64, 512), (8, 512, 128),
               (8, 128, 32), (128, 4, 512), (128, 512, 128), (128, 128, 32), (16, 64, 512),
               (16, 512, 128), (128, 512, 4), (32, 8192, 512), (32, 512, 128), (32, 128, 32),
               (4, 65536, 512), (2, 65536, 512), (1, 50000, 390), (1, 100000, 781)]


@pytest.fixture(scope="module", autouse=True)
def one_thread_per_worker():
    """torch on one thread for this module: several test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _int_points(rng, B, n, q, twins):
    """Grid coordinates in [0, 2^q); with twins the second half repeats the
    first, so every pick after the first half is a tie."""
    xs = rng.integers(0, 1 << q, (B, n, 3)).astype(np.int32)
    if twins:
        xs[:, n // 2:] = xs[:, :n // 2]
    return xs


@pytest.mark.parametrize("n,npoint,twins", [(8, 40, False), (64, 16, False), (64, 16, True),
                                            (12, 12, True)])
def test_int_fps_plain_matches_pcc_tpu(n, npoint, twins):
    """fps_int_plain == pcc_tpu's _int_fps_jnp == _int_fps_np; (8, 40)
    saturates, as the CPM's sa1 does (512 picks from 64 or 4 points)."""
    rng = np.random.default_rng(n + npoint)
    q = ipppf._qsel(n)
    assert q == j_ipppf._qsel(n)
    inf = 3 * (4 ** q) + 1
    xs = _int_points(rng, 3, n, q, twins)
    ours = fps_ops.fps_int_plain(torch.from_numpy(xs), npoint, inf)
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), j_ipppf._int_fps_np(xs, npoint, inf))
    np.testing.assert_array_equal(
        ours.numpy(), np.asarray(j_ipppf._int_fps_jnp(jnp.asarray(xs), npoint, inf)))


def test_int_fps_routes_through_the_wrapper():
    """The CPM's _int_fps keeps its int64 result; on a CPU tensor it is
    fps_int_batch's plain version, which fps_int_batch runs without a
    launch."""
    rng = np.random.default_rng(3)
    xs = torch.from_numpy(_int_points(rng, 2, 64, 10, True))
    inf = 3 * 4 ** 10 + 1
    got = ipppf._int_fps(xs, 16, inf)
    assert got.dtype == torch.int64
    assert torch.equal(got, fps_ops.fps_int_batch(xs, 16, inf).long())
    assert torch.equal(got, fps_ops.fps_int_plain(xs, 16, inf).long())


@pytest.mark.parametrize("N,npoint,twins", [(4, 20, False), (128, 32, True)])
def test_fps_plain_matches_pallas_and_xla(N, npoint, twins):
    """fps_plain == pcc_tpu's Pallas kernel (interpret) == its XLA FPS, at
    the small-cloud forms: N = 4 -> 20 saturates (the CPM's sa1 at N = 512),
    N = 128 -> 32 with twins ties every pick after the first half."""
    rng = np.random.default_rng(N)
    B = 3
    xyz = rng.random((B, N, 3)).astype(np.float32)
    if twins:
        xyz[:, N // 2:] = xyz[:, :N // 2]
    starts = rng.integers(0, N, B).astype(np.int32)
    ours = fps_ops.fps_plain(torch.from_numpy(xyz), npoint, torch.from_numpy(starts)).numpy()
    xla = np.asarray(j_fps_batch(jnp.asarray(xyz), npoint, jnp.asarray(starts), impl="xla"))
    kern = np.asarray(fps_pallas(jnp.asarray(xyz), npoint, jnp.asarray(starts), block_b=2,
                                 interpret=True))
    np.testing.assert_array_equal(ours, xla)
    np.testing.assert_array_equal(ours, kern)


@pytest.mark.parametrize("B,N,npoint", PATH_SHAPES)
def test_plan_is_one_the_kernel_takes(B, N, npoint):
    """At every shape of the paths the launcher's plan is among the plans
    the kernel takes (csrc/fps.cu checks the same limits): a warp per cloud
    up to 512 points, else 1-8 CTAs of up to 1024 threads and up to 8
    points a thread (16 or 32 where a CTA holds only its slice)."""
    c, t = fps_ops.plan(B, N)
    assert (c, t) in fps_ops.candidate_plans(N)
    assert fps_ops.kernel_takes(N, c, t)
    if c == 0:
        assert N <= fps_ops.WARP_MAX_POINTS and t % 32 == 0 and t <= 256
    else:
        assert c in (1, 2, 4, 8) and t % 32 == 0 and t <= 1024
        assert t * (8 if N <= fps_ops.WHOLE_CLOUD_POINTS else 32) * c >= N


def test_candidate_plans_cover_every_point():
    """Every candidate plan gives each point of the cloud a slot, up to
    MAX_POINTS, and past it the kernel takes no plan."""
    for N in (1, 4, 31, 33, 256, 512, 513, 1000, 8192, 16384, 16385, 50000, 65536, 100000,
              fps_ops.MAX_POINTS):
        plans = fps_ops.candidate_plans(N)
        assert plans, N
        for c, t in plans:
            # 16 points a lane, 32 a thread at most (8 where a CTA holds the
            # whole cloud and its points in registers)
            assert (32 if c == 0 else t * c) * 32 >= N, (N, c, t)
            assert fps_ops.kernel_takes(N, c, t)
    assert fps_ops.MAX_POINTS >= 131072
    assert not fps_ops.candidate_plans(fps_ops.MAX_POINTS + 1)


@pytest.mark.parametrize("N", [65536, 100000])
def test_fps_plain_matches_xla_on_rooms(N):
    """fps_plain == pcc_tpu's XLA FPS on a large-scene room's size (the
    kernel's slice design runs there on the card), at a small npoint: the
    plain version has no size limit, as pcc_tpu's FPS has none."""
    rng = np.random.default_rng(N)
    xyz = rng.random((1, N, 3)).astype(np.float32)
    starts = np.array([N - 1], np.int32)
    ours = fps_ops.fps_plain(torch.from_numpy(xyz), 8, torch.from_numpy(starts)).numpy()
    xla = np.asarray(j_fps_batch(jnp.asarray(xyz), 8, jnp.asarray(starts), impl="xla"))
    np.testing.assert_array_equal(ours, xla)
