"""Data parallelism over processes: one process (a rank) per GPU.

The counterpart of ``tpu_slu/parallel/mesh.py`` in PyTorch's idiom. The JAX
package shards a batch over a device mesh inside one process, or over hosts,
a process each. The port runs one process a GPU, started by ``torchrun``:

    torchrun --nproc_per_node=N -m tpu_slu_torch.cli --train --config_path exp.cfg

A rank is what the JAX package calls a process (a host): it reads the
strided shard ``rank::world`` of every epoch (``data/loader.py``) at the
config's batch size, so the global batch is ``world`` times it, and the
Trainer makes each step the single-device step on the union of the ranks'
batches (``training/trainer.py``). JAX's single-process mesh, one process
splitting one batch over its chips, has no counterpart here. With
``model_parallel`` > 1 the ranks form a (data, model) grid
(``parallel/mesh.py``): the shard and the sums are then those of the data
index and the data group, and the collectives below take the group.

The collectives between GPUs run over NCCL, between CPU processes over gloo.
Host numbers (a step's denominators, an epoch's metric sums, decoded
strings) go over a gloo group beside NCCL's, so reading them puts no
synchronisation on the card. Nothing here falls back: a group that cannot
form, or a collective that times out, raises.
"""

from __future__ import annotations

import datetime
import functools
import os

import numpy as np
import torch
import torch.distributed as dist

from tpu_slu_torch.device import entry_device

# How long a rank waits for the others to join the group or a collective.
TIMEOUT = datetime.timedelta(minutes=10)

_host_group = None  # gloo group for host numbers; the default group where that is gloo already


def world() -> int:
    """The number of ranks; 1 without a process group."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def init_from_env(device=None, *, backend: str | None = None, init_method: str | None = None,
                  timeout: datetime.timedelta = TIMEOUT) -> torch.device:
    """Join the process group that ``torchrun`` describes and return this
    rank's device.

    ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` are read as ``torchrun`` sets
    them. Without ``WORLD_SIZE`` this does nothing: the world is 1 and the
    device is :func:`~tpu_slu_torch.device.entry_device`'s (the GPU unless
    ``device`` says otherwise). With it, the device is ``cuda:LOCAL_RANK``
    (a CUDA ``device`` with an index keeps it) and the backend NCCL, or, for
    ``device="cpu"``, the CPU and gloo; ``backend`` overrides the choice
    (gloo on CUDA tensors puts several ranks on one card, which NCCL
    refuses). ``init_method`` defaults to ``env://`` (``MASTER_ADDR``,
    ``MASTER_PORT``); a ``file://`` path also works."""
    global _host_group
    if "WORLD_SIZE" not in os.environ:
        return entry_device(device)
    if dist.is_initialized():
        raise RuntimeError("a torch.distributed process group is up already")
    world_size, rank_ = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("WORLD_SIZE is set but no CUDA device is available; pass device='cpu' "
                               "(--device cpu) to run the ranks on the CPU over gloo")
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank_)))
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world_size,
                            rank=rank_, timeout=timeout)
    _host_group = dist.group.WORLD if backend == "gloo" else dist.new_group(backend="gloo", timeout=timeout)
    return dev


def destroy() -> None:
    """Leave the process group, if one is up, and forget its grid."""
    global _host_group
    from tpu_slu_torch.parallel import mesh

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _host_group = None
    mesh.forget()


def host_group() -> dist.ProcessGroup:
    """The gloo group of the whole world, for host numbers."""
    if _host_group is None:
        raise RuntimeError("no process group: call init_from_env first")
    return _host_group


def barrier() -> None:
    """Wait for every rank (over the host group)."""
    dist.barrier(group=host_group())


def host_all_reduce(values, group=None) -> np.ndarray:
    """The sum over the ranks of ``group`` (a gloo group; default the host
    group) of a few host numbers, in float64 (``values`` is left as it was)."""
    t = torch.tensor(np.asarray(values, np.float64))
    dist.all_reduce(t, group=host_group() if group is None else group)
    return t.numpy()


def _host_allgather(values: np.ndarray, group=None) -> np.ndarray:
    t = torch.as_tensor(values)
    group = host_group() if group is None else group
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.stack(parts).numpy()


def all_hosts_sum(scalars, process_count: int | None = None, allgather=None, group=None) -> list:
    """Sum metric scalars over the ranks of ``group`` (a gloo group; default
    the host group, every rank); with one rank, ``scalars`` itself.

    The port of the JAX Trainer's ``_all_hosts_sum``: every rank accumulates
    its shard's totals, and a ``log.csv`` row aggregates the global batch.
    ``process_count`` (default the group's size) and ``allgather`` (a (K,)
    array -> the (ranks, K) stack of every rank's; default over the group)
    are injectable, as in JAX. The scalars (floats, or 0-d tensors on
    any device) are gathered and summed in float64."""
    if process_count is not None:
        pcount = process_count
    else:
        pcount = world() if group is None else dist.get_world_size(group)
    if pcount == 1:
        return scalars
    if allgather is None:
        allgather = functools.partial(_host_allgather, group=group)
    stacked = np.asarray(allgather(np.asarray([float(v) for v in scalars], np.float64)), np.float64)
    if stacked.shape != (pcount, len(scalars)):
        raise ValueError(f"allgather returned {stacked.shape}, expected ({pcount}, {len(scalars)})")
    return list(stacked.sum(axis=0))


def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Give every rank rank ``src``'s parameters and buffers, in place."""
    for t in module.state_dict().values():
        dist.broadcast(t, src)


def all_reduce_grads(params, group=None) -> None:
    """Sum every parameter's gradient over the ranks of ``group`` (default
    every rank), in one flat all-reduce on the gradients' device and stream.
    Parameters without a gradient are left without one (every rank runs the
    same graph, so the set agrees)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    torch._foreach_copy_(grads, [v.view_as(g) for v, g in zip(flat.split([g.numel() for g in grads]), grads)])


def dp_infer(fn, *inputs):
    """Run ``fn`` data-parallel over the ranks: the port of ``make_dp_infer``.

    Every input's leading (batch) dimension must divide by the world, as
    JAX requires of the mesh's data axis; rank r runs ``fn`` on its
    contiguous block of rows, and the results come back on every rank in
    row order: a tensor (batch-major) all-gathered, a list (decoded strings,
    slot values) all-gathered as objects. With one rank this is ``fn(*inputs)``."""
    W, r = world(), rank()
    n = len(inputs[0])
    if any(len(x) != n for x in inputs) or n % W:
        raise ValueError(f"dp_infer: batch dimensions {[len(x) for x in inputs]} must agree and divide "
                         f"by the {W} ranks")
    k = n // W
    out = fn(*(x[r * k:(r + 1) * k] for x in inputs))
    if W == 1:
        return out
    if torch.is_tensor(out):
        parts = [torch.empty_like(out) for _ in range(W)]
        dist.all_gather(parts, out.contiguous())
        return torch.cat(parts)
    parts = [None] * W
    dist.all_gather_object(parts, list(out), group=host_group())
    return [o for part in parts for o in part]
