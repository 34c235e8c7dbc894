"""The (data, model) grid of ranks: the port of ``tpu_slu/parallel/mesh.py``'s 2-D mesh.

JAX's ``make_mesh`` reshapes the devices to ``(n // mp, mp)`` with axes
``("data", "model")``: device d sits at data index ``d // mp`` and model
index ``d % mp``. Here a device is a rank (one process a GPU, as in
``parallel/dist.py``), and :func:`make_grid` lays the world out the same way.
Each rank belongs to two groups:

* its **model group**, the mp ranks of its data index, which hold the
  column shards of the vocab heads (:func:`shard_vocab_heads`, JAX's
  ``param_shardings`` rule) and read the same batches;
* its **data group**, the ``world // mp`` ranks of its model index, over
  which gradients and a step's host numbers are summed.

At ``model_parallel`` 1 the grid is the data-parallel world of
``parallel/dist.py``: its data group is the whole world (``None``, the
default group) and it makes no group. A group's collectives run on the
world's backend (NCCL on GPUs, gloo on the CPU); host numbers go over gloo
subgroups of the same ranks where the world is NCCL. Nothing falls back: a
group that cannot form raises.

The grid is process-wide, like the process group it splits: the
:class:`~tpu_slu_torch.data.loader.BatchLoader` reads this rank's data index
and the data size from :func:`current` to pick its shard, so the mp ranks of
a data index read the same batches.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from tpu_slu_torch.parallel import dist as pdist
from tpu_slu_torch.parallel.vocab import ColumnParallelLinear

HEADS = ("phoneme_linear", "word_linear")  # the vocab heads JAX may shard, mesh.py:69

_grid = None  # the grid of the last make_grid; cleared by dist.destroy


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place in a (data_size, model_parallel) grid, and its groups.

    ``model_group`` is None at ``model_parallel`` 1; ``data_group`` and
    ``host_data_group`` are None where the data group is the whole world
    (the default group and the host group of ``parallel/dist.py``)."""

    model_parallel: int
    data_index: int
    model_index: int
    data_size: int
    model_group: object = None
    data_group: object = None
    host_data_group: object = None


def current() -> Grid:
    """The grid of the last :func:`make_grid`; without one, the data-parallel
    world (each rank its own data index)."""
    return _grid if _grid is not None else Grid(1, pdist.rank(), 0, pdist.world())


def forget() -> None:
    global _grid
    _grid = None


def make_grid(model_parallel: int = 1) -> Grid:
    """Lay the world out as a (world // model_parallel, model_parallel) grid
    and make it :func:`current`. Collective: every rank calls it, with the
    same ``model_parallel``, in the same order as its other group calls
    (``dist.new_group`` is called by every rank for every group, its own or
    not). A grid of the current one's ``model_parallel`` is that grid: its
    groups are made once."""
    global _grid
    W, r, mp = pdist.world(), pdist.rank(), model_parallel
    if mp < 1 or W % mp:
        raise ValueError(f"model_parallel={mp} does not divide the {W} ranks")
    if _grid is not None and _grid.model_parallel == mp:
        return _grid
    if mp == 1:
        _grid = Grid(1, r, 0, W)
        return _grid
    host_is_world = pdist.host_group() is dist.group.WORLD
    mine = {}
    for kind, lists in (("model", [[d * mp + m for m in range(mp)] for d in range(W // mp)]),
                        ("data", [[d * mp + m for d in range(W // mp)] for m in range(mp)])):
        for ranks in lists:
            group = dist.new_group(ranks, timeout=pdist.TIMEOUT)
            host = group if host_is_world else dist.new_group(ranks, backend="gloo", timeout=pdist.TIMEOUT)
            if r in ranks:
                mine[kind] = (group, host)
    _grid = Grid(mp, r // mp, r % mp, W // mp, model_group=mine["model"][0], data_group=mine["data"][0],
                 host_data_group=mine["data"][1])
    return _grid


def grid_for(config) -> Grid:
    """The grid a Trainer trains on, decided as JAX's Trainer decides its mesh
    (``trainer.py:104-127``): ``model_parallel`` (default 1) where it divides
    the ranks; where it does not, rank 0 prints ``model_parallel={mp}
    disabled: {n} devices not divisible`` and the grid is pure data
    parallelism; on one rank it prints ``model_parallel={mp} ignored: single
    device``. Collective at ``model_parallel`` > 1 (:func:`make_grid`)."""
    mp = max(1, int(getattr(config, "model_parallel", 1) or 1))
    W = pdist.world()
    if mp > 1 and W == 1:
        print(f"model_parallel={mp} ignored: single device")
        mp = 1
    elif mp > 1 and W % mp:
        if pdist.rank() == 0:
            print(f"model_parallel={mp} disabled: {W} devices not divisible")
        mp = 1
    return make_grid(mp)


def shard_vocab_heads(model: torch.nn.Module, grid: Grid) -> set[str]:
    """Put a :class:`ColumnParallelLinear` in place of each vocab head whose
    width divides ``grid.model_parallel``, as JAX's ``param_shardings`` shards
    ``w`` (in, out) on ``out`` and ``b`` with it: the heads of a
    ``PretrainedModel``, or of a ``Model``'s ``pretrained_model``. Returns the
    names of the sharded parameters (none at ``model_parallel`` 1)."""
    if grid.model_parallel == 1:
        return set()
    encoder, prefix = ((model.pretrained_model, "pretrained_model.") if hasattr(model, "pretrained_model")
                       else (model, ""))
    names = set()
    for head in HEADS:
        lin = getattr(encoder, head)
        if isinstance(lin, ColumnParallelLinear):
            raise ValueError(f"{prefix}{head} is sharded already: give the Trainer a model with whole heads")
        if lin.out_features % grid.model_parallel == 0:
            setattr(encoder, head, ColumnParallelLinear(lin, grid.model_parallel, grid.model_index,
                                                        grid.model_group))
            names |= {f"{prefix}{head}.weight", f"{prefix}{head}.bias"}
    return names


def gather_rows(t: torch.Tensor, grid: Grid) -> torch.Tensor:
    """The full tensor of a shard's rows: the model group's shards stacked in
    model-index order along dim 0. Collective over the model group."""
    parts = [torch.empty_like(t) for _ in range(grid.model_parallel)]
    dist.all_gather(parts, t.detach().contiguous(), group=grid.model_group)
    return torch.cat(parts)


def take_rows(full: torch.Tensor, grid: Grid) -> torch.Tensor:
    """This rank's rows of a full tensor (the inverse of :func:`gather_rows`)."""
    n, mp = full.shape[0], grid.model_parallel
    if n % mp:
        raise ValueError(f"{n} rows do not split over model_parallel={mp}")
    k = n // mp
    return full[grid.model_index * k:(grid.model_index + 1) * k].contiguous()
