"""Data and model parallelism of the PyTorch port: one process per GPU over torch.distributed."""

from tpu_slu_torch.parallel.dist import (
    all_hosts_sum,
    all_reduce_grads,
    barrier,
    broadcast_module,
    destroy,
    dp_infer,
    host_all_reduce,
    init_from_env,
    rank,
    world,
)
from tpu_slu_torch.parallel.mesh import grid_for, make_grid, shard_vocab_heads

__all__ = ["all_hosts_sum", "all_reduce_grads", "barrier", "broadcast_module", "destroy", "dp_infer", "grid_for",
           "host_all_reduce", "init_from_env", "make_grid", "rank", "shard_vocab_heads", "world"]
