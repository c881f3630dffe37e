"""The `model`-axis operators: tensor parallelism by hand.

JAX names a leaf's `model` dimension in its `PartitionSpec`
(`parallel/plan.py::rt1_sharding_plan`) and GSPMD inserts the
collectives. The port splits those leaves over the grid's `model` ranks
(`parallel/partition.py`), and the layers that hold split weights
(`models/transformer.py`, `models/moe.py`) move their activations with
three differentiable collectives over the `model` group of the enclosing
`parallel.collectives.batch_shard`:

* `copy_in(x)`      — identity forward, all-reduce backward: `x` is whole
  on every model rank and feeds a split computation, whose partial input
  gradients sum to the whole one;
* `reduce_out(y)`   — all-reduce forward, identity backward: the partial
  sums of a row-parallel product (or of the rank's experts) made whole;
* `gather_out(y)`   — all-gather on the last dimension forward, the rank's
  slice backward: a column-parallel product's blocks made whole.

Outside a `batch_shard` with a `model` axis (a world of one, tp 1,
serving) each is the identity: no collective, the tensor untouched.
A layer whose weights are whole computes whole on every model rank, with
no collective: the plan keeps a leaf whole where the tp size does not
divide its dimension.

Rank i of `ways` holds the i-th contiguous block of a split dimension.
"""

from __future__ import annotations

import torch

from rt1_tpu_torch.parallel.collectives import current_model_shard


def model_ways() -> int:
    """Ranks on the `model` axis of the enclosing forward (1 outside one)."""
    return current_model_shard()[2]


def model_index() -> int:
    return current_model_shard()[1]


def split_ways(local: int, whole: int) -> int:
    """How many ways a dimension of `whole` is split when this rank holds
    `local` of it (1: whole). Raises unless the enclosing forward has that
    many `model` ranks: split weights outside their grid would compute a
    part as if it were the whole."""
    if local == whole:
        return 1
    ways = model_ways()
    if ways < 2 or local * ways != whole:
        raise ValueError(f"a layer holds {local} of {whole} along its model dimension, but the "
                         f"forward runs on {ways} model rank(s): run it inside the train "
                         "step's batch_shard of its grid")
    return ways


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group):
        import torch.distributed as dist

        y = y.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group, index, ways):
        import torch.distributed as dist

        ctx.index, ctx.ways = index, ways
        y = y.contiguous()
        out = torch.empty((ways,) + tuple(y.shape), dtype=y.dtype, device=y.device)
        dist.all_gather_into_tensor(out.view(-1), y.view(-1), group=group)
        return torch.cat(out.unbind(0), dim=-1)

    @staticmethod
    def backward(ctx, grad):
        n = grad.shape[-1] // ctx.ways
        return grad[..., ctx.index * n:(ctx.index + 1) * n].contiguous(), None, None, None


def copy_in(x: torch.Tensor) -> torch.Tensor:
    group, _, ways = current_model_shard()
    return x if ways == 1 else _CopyIn.apply(x, group)


def reduce_out(y: torch.Tensor) -> torch.Tensor:
    group, _, ways = current_model_shard()
    return y if ways == 1 else _ReduceOut.apply(y, group)


def gather_out(y: torch.Tensor) -> torch.Tensor:
    group, index, ways = current_model_shard()
    return y if ways == 1 else _GatherOut.apply(y, group, index, ways)


def column_parallel(linear, x: torch.Tensor, whole: int) -> torch.Tensor:
    """`linear(x)` whole on every model rank: with `linear` holding this
    rank's block of its `whole` output columns, the block's product on
    `copy_in(x)`, gathered; with whole weights, `linear(x)` itself."""
    if split_ways(linear.weight.shape[0], whole) == 1:
        return linear(x)
    return gather_out(linear(copy_in(x)))
