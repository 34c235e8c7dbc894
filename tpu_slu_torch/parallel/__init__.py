"""Data parallelism of the PyTorch port: one process per GPU over torch.distributed."""

from tpu_slu_torch.parallel.dist import (
    all_hosts_sum,
    all_reduce_grads,
    barrier,
    broadcast_module,
    check_model_parallel,
    destroy,
    dp_infer,
    host_all_reduce,
    init_from_env,
    rank,
    world,
)

__all__ = ["all_hosts_sum", "all_reduce_grads", "barrier", "broadcast_module", "check_model_parallel",
           "destroy", "dp_infer", "host_all_reduce", "init_from_env", "rank", "world"]
