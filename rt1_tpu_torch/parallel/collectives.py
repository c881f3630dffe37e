"""The train step's collectives over the rank grid (`parallel/mesh.py`).

JAX's GSPMD inserts the reductions of a sharded program itself; the port's
step issues them by hand (`trainer/train.py`), and the modules that see
the batch read this rank's place in it from `batch_shard`:

* `batch_shard(group, index, ways, model=...)` — the context the step
  runs its forward in: BatchNorm syncs its statistics over `group`, and
  dropout and stochastic depth draw the GLOBAL batch's randoms and keep
  rows [index * n, (index + 1) * n), so a rank draws what the world of one
  draws for its rows (`rows_of_global_draw`). `model` is the rank's
  (group, index, ways) on the grid's `model` axis, which the
  tensor-parallel layers read (`parallel/tensor_parallel.py`); ranks that
  differ only on `model` (or `stage`, or `seq`) hold the same rows.
* `StepComms` — the step's reductions over the batch axes (data x fsdp),
  the ZeRO-3 gather and reduce-scatter over `fsdp`, and the sums of squares
  of leaves split over `model` and `stage` (`reduce_classes`).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class Shard:
    """The forward's place on the grid: its block of the global batch and
    its place on the `model` axis."""
    group: object = None
    index: int = 0
    ways: int = 1
    model_group: object = None
    model_index: int = 0
    model_ways: int = 1


_SHARD = Shard()


@contextlib.contextmanager
def shard_context(shard: Shard):
    """Run the enclosed forward at `shard` (a remat recompute re-enters the
    first run's)."""
    global _SHARD
    saved = _SHARD
    _SHARD = shard
    try:
        yield
    finally:
        _SHARD = saved


def batch_shard(group, index: int, ways: int, model=None):
    """Run the enclosed forward as block `index` of `ways` of the global
    batch, `group` its batch-axes process group, and with `model` =
    (group, index, ways) on the `model` axis (see the module docstring)."""
    model = model or (None, 0, 1)
    return shard_context(Shard(group, index, ways, *model))


def current_shard() -> Shard:
    return _SHARD


def current_batch_shard():
    """(group, index, ways) of the enclosing `batch_shard`; (None, 0, 1)
    outside one."""
    return _SHARD.group, _SHARD.index, _SHARD.ways


def current_model_shard():
    """(group, index, ways) on the `model` axis of the enclosing
    `batch_shard`; (None, 0, 1) outside one."""
    return _SHARD.model_group, _SHARD.model_index, _SHARD.model_ways


def rows_of_global_draw(shape, draw: Callable[[tuple], torch.Tensor]) -> torch.Tensor:
    """`draw(shape)`, or inside a `batch_shard` of `ways` > 1 this rank's
    rows of `draw((ways * shape[0],) + shape[1:])` (dim 0 is the batch,
    batch-major)."""
    _, index, ways = current_batch_shard()
    if ways == 1:
        return draw(tuple(shape))
    n = shape[0]
    return draw((ways * n,) + tuple(shape[1:]))[index * n:(index + 1) * n]


class StepComms:
    """The reductions of one train step on `grid`.

    `W` = data x fsdp ranks share the batch; `F` = fsdp ranks share the
    masters. With F > 1 the flat masters are chunks of `shard`
    (`trainer/state.py::FlatShard`). Ranks along `model` and `stage` hold
    the same rows and each its own slices and layers
    (`parallel/partition.py`)."""

    def __init__(self, grid):
        from rt1_tpu_torch.parallel.mesh import BATCH_AXES

        self.grid = grid
        self.ways = grid.batch_ways
        self.index = grid.batch_index
        self.fsdp = grid.size("fsdp")
        self.batch_group = grid.group(*BATCH_AXES)
        self.data_group = grid.group("data")
        self.fsdp_group = grid.group("fsdp")
        self.model = (grid.group("model"), grid.coords["model"], grid.size("model"))
        self.stage = (grid.group("stage"), grid.coords["stage"], grid.size("stage"))

    def forward_context(self):
        return batch_shard(self.batch_group, self.index, self.ways, model=self.model)

    def reduce_classes(self, sums: torch.Tensor) -> torch.Tensor:
        """The global sum of per-class partial sums `sums` (4, ...): row 0
        of the leaves every `model` and `stage` rank holds whole (counted
        once), row 1 of the leaves split over `model`, row 2 of the layers
        a `stage` owns, row 3 of both; each row summed over the fsdp chunks
        and over the axes its leaves split along (not differentiable)."""
        import torch.distributed as dist

        sums = self.sum_shards(sums)
        for (group, _, ways), rows in ((self.model, (1, 3)), (self.stage, (2, 3))):
            if ways > 1:
                part = sums[list(rows)].contiguous()
                dist.all_reduce(part, op=dist.ReduceOp.SUM, group=group)
                sums = sums.index_copy(0, torch.tensor(rows, device=sums.device), part)
        return sums.sum(dim=0)

    def sum_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks that split the batch (not differentiable)."""
        import torch.distributed as dist

        t = t.detach().clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.batch_group)
        return t

    def mean_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over the batch's blocks (equal blocks: the global mean)."""
        return self.sum_rows(t) / self.ways

    def sum_shards(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of per-chunk partial sums over the fsdp ranks (identity for
        full vectors, F = 1)."""
        import torch.distributed as dist

        if self.fsdp == 1:
            return t
        t = t.detach().clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.fsdp_group)
        return t

    def gather_flat(self, chunk: torch.Tensor, size: int) -> torch.Tensor:
        """The full flat vector (length `size` = F x chunk) from every fsdp
        rank's chunk, in `chunk`'s dtype."""
        import torch.distributed as dist

        out = torch.empty(size, dtype=chunk.dtype, device=chunk.device)
        dist.all_gather_into_tensor(out, chunk.contiguous(), group=self.fsdp_group)
        return out

    def reduce_grad(self, grad: torch.Tensor, shard: Optional[object]) -> torch.Tensor:
        """Sum `grad` (this rank's full flat float32 gradient) over the
        batch ranks: with `shard`, reduce-scattered over fsdp into this
        rank's chunk, then all-reduced over data; else all-reduced."""
        import torch.distributed as dist

        if shard is None:
            grad = grad.contiguous()
            dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=self.batch_group)
            return grad
        padded = torch.nn.functional.pad(grad, (0, shard.size - grad.numel()))
        out = torch.empty(shard.chunk, dtype=grad.dtype, device=grad.device)
        dist.reduce_scatter_tensor(out, padded, op=dist.ReduceOp.SUM, group=self.fsdp_group)
        if self.grid.size("data") > 1:
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.data_group)
        return out
