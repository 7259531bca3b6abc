"""Multi-host data-parallel worker (counterpart of pcc_tpu/parallel/dcn.py).

pcc_tpu scales past one host with jax.distributed.initialize and a global
mesh, one process per host driving its local devices. In torch a process
drives one device, so a host with 4 cards runs 4 of these workers; the
process group spans every worker of every host, reached through one
coordinator address (tcp://, rank 0's host). Each worker runs ONE
data-parallel IPDAE train step on its shard of the global batch, one cloud
per worker, and prints the global loss, which is the same on every worker
(the sum over the ranks is computed once and handed to all).

Run one worker per device:
  python -m pcc_tpu_torch.parallel.dcn --process_id I --num_processes P \\
      --coordinator HOST:PORT [--device cuda|cpu]
(with --device cuda, worker I of a host takes cuda:(I mod the host's card
count); --device cpu runs on gloo).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from pcc_tpu_torch.config import CodecConfig
from pcc_tpu_torch.parallel.mesh import build_sharded_train_step, init_worker

CFG = CodecConfig(N=256, N0=64, ALPHA=2, K=32, d=4, L=7, sa_knn=8)


def run_worker(process_id: int, num_processes: int, coordinator: str,
               device: str = "cuda") -> float:
    """Join the process group, run one data-parallel train step over the
    global batch and return the (global) loss."""
    import torch.distributed as dist

    from pcc_tpu_torch.train.state import create_train_state, make_optimizer

    if device == "cuda" and torch.cuda.is_available():
        device = f"cuda:{process_id % torch.cuda.device_count()}"
    dev = init_worker(process_id, num_processes, device, init_method=f"tcp://{coordinator}")
    try:
        tx = make_optimizer(lr=1e-3, lr_decay=0.1, lr_decay_steps=100, max_steps=100)
        # the same seed on every worker -> the same replicated state; the
        # global batch and its FPS starts are made alike on every worker,
        # and each trains on its own cloud of it
        state = create_train_state(0, CFG, tx, device=dev)
        full = np.random.default_rng(0).random((num_processes, CFG.N, 3)).astype(np.float32)
        starts = torch.randint(0, CFG.N, (num_processes,), dtype=torch.int32,
                               generator=torch.Generator().manual_seed(1))
        step = build_sharded_train_step(CFG, tx)
        _, aux = step(state, torch.from_numpy(full).to(dev), starts.to(dev), 1e-6)
        loss = float(aux["loss"])
    finally:
        dist.destroy_process_group()
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    return loss


def main(argv=None):
    p = argparse.ArgumentParser(prog="dcn.py")
    p.add_argument("--process_id", type=int, required=True)
    p.add_argument("--num_processes", type=int, required=True)
    p.add_argument("--coordinator", default="127.0.0.1:29400")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    loss = run_worker(args.process_id, args.num_processes, args.coordinator, args.device)
    print(f"dcn worker {args.process_id}/{args.num_processes}: loss={loss:.6f}")


if __name__ == "__main__":
    main()
