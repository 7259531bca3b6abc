"""Data parallelism over devices on torch.distributed (counterpart of
pcc_tpu/parallel/): one process per device, the cloud batch sharded across
them (mesh.py), and the multi-host worker (dcn.py)."""

from pcc_tpu_torch.parallel.mesh import (
    all_reduce_grads,
    all_reduce_sum,
    build_sharded_pppe_train_step,
    build_sharded_pppf_train_step,
    build_sharded_train_step,
    global_mean,
    global_sum,
    init_worker,
    is_distributed,
    launch,
    merge_shards,
    rank,
    shard_batch,
    world_size,
)

__all__ = [
    "all_reduce_grads",
    "all_reduce_sum",
    "build_sharded_pppe_train_step",
    "build_sharded_pppf_train_step",
    "build_sharded_train_step",
    "global_mean",
    "global_sum",
    "init_worker",
    "is_distributed",
    "launch",
    "merge_shards",
    "rank",
    "shard_batch",
    "world_size",
]
