"""The train step's collectives over the rank grid (`parallel/mesh.py`).

JAX's GSPMD inserts the reductions of a sharded program itself; the port's
step issues them by hand (`trainer/train.py`), and the modules that see
the batch read this rank's place in it from `batch_shard`:

* `batch_shard(group, index, ways)` — the context the step runs its
  forward in: BatchNorm syncs its statistics over `group`, and dropout and
  stochastic depth draw the GLOBAL batch's randoms and keep rows
  [index * n, (index + 1) * n), so a rank draws what the world of one draws
  for its rows (`rows_of_global_draw`).
* `StepComms` — the step's reductions over the batch axes (data x fsdp)
  and the ZeRO-3 gather and reduce-scatter over `fsdp`.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import torch


@dataclasses.dataclass
class _Shard:
    group: object = None
    index: int = 0
    ways: int = 1


_SHARD = _Shard()


@contextlib.contextmanager
def batch_shard(group, index: int, ways: int):
    """Run the enclosed forward as block `index` of `ways` of the global
    batch, `group` its batch-axes process group (see the module docstring)."""
    global _SHARD
    saved = _SHARD
    _SHARD = _Shard(group, index, ways)
    try:
        yield
    finally:
        _SHARD = saved


def current_batch_shard():
    """(group, index, ways) of the enclosing `batch_shard`; (None, 0, 1)
    outside one."""
    return _SHARD.group, _SHARD.index, _SHARD.ways


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
    (`trainer/state.py::FlatShard`)."""

    def __init__(self, grid):
        from rt1_tpu_torch.parallel.mesh import BATCH_AXES

        self.grid = grid
        self.ways = grid.batch_ways
        self.index = grid.batch_index
        self.fsdp = grid.size("fsdp")
        self.batch_group = grid.group(*BATCH_AXES)
        self.data_group = grid.group("data")
        self.fsdp_group = grid.group("fsdp")

    def forward_context(self):
        return batch_shard(self.batch_group, self.index, self.ways)

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
