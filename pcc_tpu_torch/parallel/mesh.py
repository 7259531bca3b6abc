"""Data parallelism over devices on torch.distributed (counterpart of
pcc_tpu/parallel/mesh.py).

pcc_tpu makes the cloud batch a mesh axis: parameters replicated, batches
sharded, and jit's SPMD partitioner computes every reduction of the step
over the global batch. Here one process drives one device (NCCL on the
card, gloo on the CPU), every rank holds the same replicated state, and
each runs the single-device program on its contiguous shard of every batch,
as P("data") splits it. So that the sharded step computes the
single-device function, the steps reduce across the ranks before any
nonlinearity in a global quantity: BatchNorm's batch statistics
(models/layers.py::batch_norm_train), the IPDAE rate's bit counts
(train/steps.py), PPPE's rate before its clip and its loss before the NaN
skip (train/steps_pppe.py). Each rank's loss is then its share of the
global loss, and the parameter gradients are summed over the ranks with one
all-reduce of a flat buffer (`all_reduce_grads`), never averaged.

Without a process group (--devices 1) every helper here is the identity:
the steps and the codec run the single-device code, unchanged.

pcc_tpu's builders and their counterparts:
  * make_mesh / replicate: `launch` and `init_worker` (every rank builds
    the same seeded state; a rank that resumes reads the same checkpoint);
  * shard_batch: `shard_batch`;
  * build_sharded_{,pppf_,pppe_}train_step: the builders below, which take
    the global batch and shard it;
  * build_sharded_encode / build_sharded_decode / build_sharded_pmf_weights:
    Codec.compress_many / decompress_many in a process group (codec.py):
    each rank codes its shard of every dispatch batch and `merge_shards`
    hands every rank the whole result in input order.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from pcc_tpu_torch.device import resolve_device

COLLECTIVE_TIMEOUT_S = 1800.0   # the longest a collective may wait for the other ranks
EXIT_GRACE_S = 60.0             # for a worker to exit after its result


def is_distributed() -> bool:
    """Whether this process is a rank of a process group."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def shard_batch(batch):
    """This rank's contiguous slice of `batch` (a tensor, array or list,
    along its first axis): len / world items each where the world size
    divides the length, else one more for each of the first len % world
    ranks. The whole batch without a process group."""
    r, (q, extra) = rank(), divmod(len(batch), world_size())
    lo = r * q + min(r, extra)
    return batch[lo:lo + q + (r < extra)]


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of each rank's t, equal on every rank, and
    differentiable: its backward sums the cotangents over the ranks. t
    itself without a process group."""
    if not is_distributed():
        return t
    return _AllReduceSum.apply(t)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g)
        return g


def global_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean over the global batch of a mean `t` over this rank's shard,
    the shards equal in size: all_reduce_sum(t) / world_size(),
    differentiable (bit for bit t at one rank)."""
    if not is_distributed():
        return t
    return all_reduce_sum(t) / world_size()


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """all_reduce_sum of a value no gradient flows through (a copy; t is
    left as it is)."""
    if not is_distributed():
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out


def all_reduce_grads(params) -> None:
    """Sum every parameter's .grad over the ranks, in place, with one
    all-reduce of a flat buffer. Parameters without a gradient stay without
    one (the graph, and so the set, is the same on every rank)."""
    if not is_distributed():
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


def merge_shards(items: list) -> list:
    """A per-item list of which this rank filled its shares (None where
    another rank holds the item) -> the whole list, on every rank
    (all_gather_object, which NCCL and gloo both carry). The list itself
    without a process group."""
    if not is_distributed():
        return items
    parts = [None] * world_size()
    dist.all_gather_object(parts, [(i, x) for i, x in enumerate(items) if x is not None])
    out = list(items)
    for part in parts:
        for i, x in part:
            out[i] = x
    return out


def init_worker(r: int, world: int, device: str | torch.device = "cuda",
                init_method: str | None = None, backend: str | None = None,
                timeout: float = COLLECTIVE_TIMEOUT_S) -> torch.device:
    """Join the process group as rank r of `world`: NCCL on CUDA, gloo on
    the CPU (`backend` overrides). A CUDA rank takes cuda:r as
    its current device, or the device's own index where `device` names one
    (ranks sharing a card); "cuda" then means that device to every entry
    point. A CPU rank runs torch and the BLAS on one thread. A collective
    that waits longer than `timeout` seconds raises. Returns the rank's
    device."""
    dev = resolve_device(device)          # raises where there is no card
    if dev.type == "cuda":
        dev = torch.device("cuda", r if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
        try:
            from threadpoolctl import threadpool_limits

            threadpool_limits(limits=1, user_api="blas")
        except ImportError:
            pass
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method=init_method, rank=r, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))
    return dev


def _worker(r, world, init_method, device, backend, timeout, fn, args, results):
    """One spawned rank: join the group, run fn(*args), report (rank, kind,
    value): "ok" with fn's result, "exit" with a SystemExit's code, "error"
    with a traceback."""
    try:
        init_worker(r, world, device, init_method, backend, timeout)
        results.put((r, "ok", fn(*args)))
    except SystemExit as e:
        results.put((r, "exit", e.code))
    except BaseException:
        results.put((r, "error", traceback.format_exc()))
    finally:
        if is_distributed():
            dist.destroy_process_group()


def launch(n: int, fn, *args, device: str | torch.device = "cuda",
           backend: str | None = None, timeout: float | None = None) -> list:
    """Run fn(*args) on n spawned ranks of one process group (`init_worker`:
    rank r on cuda:r, or on the one card `device` names, or on the CPU) and
    return their results in rank order. fn must be importable by the
    workers (a module-level function).

    Rendezvous through a file store in a fresh temporary directory, so
    concurrent launches never meet. The CUDA kernels are built here, once,
    before the spawn. A worker that raises makes this raise (SystemExit
    with its code for a SystemExit, RuntimeError with its traceback
    otherwise), after every worker is killed; so does a worker that dies
    without a result, and the run outlasting `timeout` seconds where one is
    given (TimeoutError). A collective that waits for another rank longer
    than COLLECTIVE_TIMEOUT_S, or `timeout`, raises in its worker: a rank
    that dies or hangs stops the others."""
    import multiprocessing as mp

    dev = torch.device(device)
    if dev.type == "cuda":
        avail = torch.cuda.device_count()
        if (dev.index is None and avail < n) or (dev.index is not None and dev.index >= avail):
            raise RuntimeError(f"launch: {n} ranks on {dev} but {avail} CUDA device(s) visible")
        from pcc_tpu_torch.ops import cuda_lib

        cuda_lib.build()
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="pcc_launch_")
    init_method = "file://" + os.path.join(tmp, "store")
    results = ctx.Queue()
    wait = COLLECTIVE_TIMEOUT_S if timeout is None else min(timeout, COLLECTIVE_TIMEOUT_S)
    procs = [ctx.Process(target=_worker, args=(r, n, init_method, str(dev), backend,
                                               wait, fn, args, results))
             for r in range(n)]
    out, done = [None] * n, set()
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(done) < n:
            left = 1.0 if deadline is None else deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"launch: {n - len(done)} of {n} workers gave no result "
                                   f"within {timeout:.0f} s")
            try:
                r, kind, value = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if r not in done and p.exitcode is not None]
                if dead:
                    try:      # a result may still be on its way through the pipe
                        r, kind, value = results.get(timeout=5.0)
                    except queue_mod.Empty:
                        raise RuntimeError(
                            f"launch: worker {dead[0]} of {n} exited with code "
                            f"{procs[dead[0]].exitcode} and gave no result") from None
                else:
                    continue
            if kind == "exit":
                raise SystemExit(value)
            if kind == "error":
                raise RuntimeError(f"launch: worker {r} of {n} failed:\n{value}")
            out[r] = value
            done.add(r)
        for p in procs:      # every result is in: a clean exit takes seconds
            p.join(EXIT_GRACE_S if deadline is None else max(deadline - time.monotonic(), 0.0))
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"launch: workers (rank, exit code) {bad} did not exit cleanly")
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)


def build_sharded_train_step(cfg, tx, rate_mode: str = "reference"):
    """Data-parallel train_step(state, batch [B, N, 3], starts [B], lam) ->
    (state, aux) over the global batch and its FPS starts, both the same on
    every rank (drawn once for the global batch): build_train_step on this
    rank's shard; aux holds the global values, equal on every rank."""
    from pcc_tpu_torch.train.steps import build_train_step

    step = build_train_step(cfg, tx, rate_mode=rate_mode)

    def train_step(state, batch, starts, lam: float):
        return step(state, shard_batch(batch), shard_batch(starts), lam)

    return train_step


def build_sharded_pppf_train_step(cfg, tx, rate_mode: str = "reference", fused: bool = False):
    """Data-parallel PPPF-AE step, as build_sharded_train_step: BatchNorm's
    batch statistics are the global batch's, as under pcc_tpu's SPMD
    partitioner, and the running statistics move alike on every rank."""
    from pcc_tpu_torch.train.steps_pppf import build_pppf_train_step

    step = build_pppf_train_step(cfg, tx, rate_mode=rate_mode, fused=fused)

    def train_step(state, batch, starts, lam: float):
        return step(state, shard_batch(batch), shard_batch(starts), lam)

    return train_step


def build_sharded_pppe_train_step(tx):
    """Data-parallel PPPE train_step(state, batch [B, N, 3], lam_eff) ->
    (state, aux) over the global batch: the rate's global mean before the
    clip, the NaN skip decided on the global loss, the flat gradient summed
    before the clip and Adam, so that every rank keeps the same state bit
    for bit, skipped steps included."""
    from pcc_tpu_torch.train.steps_pppe import build_pppe_train_step

    step = build_pppe_train_step(tx)

    def train_step(state, batch, lam_eff: float):
        return step(state, shard_batch(batch), lam_eff)

    return train_step
