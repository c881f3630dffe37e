"""The train state (counterpart of `rt1_tpu/trainer/state.py`).

JAX keeps `step`, `params`, `batch_stats` and `opt_state` in one pytree.
Here the float32 master parameters live in one flat tensor, `flat`, laid
out by `FlatLayout` in the order of `policy.named_parameters()`, and every
parameter of the policy is a view of it; the BatchNorm statistics live the
same way in `flat_buffers`. The optimizer's moments are flat tensors of
the same layout. A step therefore updates the masters and the statistics
with one copy each, and the policy sees the result with no per-parameter
work. `step` counts the updates applied (a step the guard skipped does not
count), on the policy's device; `guard_skips` counts the skipped ones.

Under `parallel.fsdp` > 1 (ZeRO-3, `shard_train_state`) the state keeps
only its chunk of the masters and of both moments: `flat`, `mu` and `nu`
are elements [lo, hi) of the layout's vector padded to `shard.size`, a
multiple of the fsdp ranks (`FlatShard`). The policy's parameters then
hold no values of their own: each is a NaN expanded to its shape (one
element of storage), so a read that bypasses the step's gathered compute
copy shows at once. The BatchNorm statistics, the counters and `layout`
stay whole on every rank.

Under `parallel.tp` or `parallel.pp` the policy is the rank's part of the
logical one (`parallel/partition.py`): its parameters are its `model`
slices and, under pp, its stage's layers with every whole leaf, and
`flat` lays out that part (ZeRO-3 then chunks it over `fsdp`).
`partition` records the logical names and shapes the checkpoints write.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import torch
from torch import nn

from rt1_tpu_torch.trainer.optim import Adam, AdamState


class FlatLayout:
    """Lays a fixed list of tensors out in one 1-D tensor and back. Each
    tensor starts at a multiple of `ALIGN` elements (256 bytes in float32),
    so its view is as aligned as a tensor of its own: CUDA kernels (cuDNN's
    among them) may assume that of their operands, and fault on a view at
    an odd offset. The padding stays zero."""

    ALIGN = 64

    def __init__(self, tensors: Sequence[torch.Tensor]):
        self.shapes = [tuple(t.shape) for t in tensors]
        self.numels = [t.numel() for t in tensors]
        self.padded = [-(-n // self.ALIGN) * self.ALIGN for n in self.numels]
        self.size = sum(self.padded)

    @classmethod
    def of_shapes(cls, shapes: Sequence[Sequence[int]]) -> "FlatLayout":
        """The layout of tensors of `shapes` (none allocated)."""
        return cls([torch.empty(tuple(s), device="meta") for s in shapes])

    def flatten(self, tensors: Sequence[torch.Tensor], dtype: Optional[torch.dtype] = None,
                device=None) -> torch.Tensor:
        """A new 1-D tensor holding `tensors` (detached, cast to `dtype`);
        `device` places it when `tensors` is empty."""
        if tensors:
            dtype, device = dtype or tensors[0].dtype, tensors[0].device
        flat = torch.zeros(self.size, dtype=dtype, device=device)
        if tensors:
            with torch.no_grad():
                torch._foreach_copy_(self.views(flat), [t.detach() for t in tensors])
        return flat

    def views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """Views of `flat` in the layout's shapes. A gradient through them
        reaches `flat` through one split, not one full-size scatter each."""
        chunks = flat.split(self.padded)
        return [c[:n].view(s) for c, n, s in zip(chunks, self.numels, self.shapes)]

    def adopt(self, tensors: Sequence[torch.Tensor], device=None) -> torch.Tensor:
        """A new 1-D tensor holding `tensors`, each of which becomes a view
        of it in place (the same tensor objects, now sharing its storage)."""
        flat = self.flatten(tensors, device=device)
        with torch.no_grad():
            for t, v in zip(tensors, self.views(flat)):
                t.data = v
        return flat


def floating_buffers(policy: nn.Module) -> List[torch.Tensor]:
    """The policy's float buffers: the BatchNorm running statistics (the
    masks and index tables it registers are integer)."""
    return [b for b in policy.buffers() if b.is_floating_point()]


@dataclasses.dataclass(frozen=True)
class FlatShard:
    """Chunk `index` of `count` of a flat vector padded to `size`."""
    index: int
    count: int
    size: int

    @property
    def chunk(self) -> int:
        return self.size // self.count

    @property
    def lo(self) -> int:
        return self.index * self.chunk

    @property
    def hi(self) -> int:
        return self.lo + self.chunk

    @classmethod
    def of(cls, length: int, index: int, count: int) -> "FlatShard":
        """Chunk `index` of `count` of a vector of `length` elements."""
        return cls(index, count, -(-length // count) * count)

    def take(self, full: torch.Tensor) -> torch.Tensor:
        """This chunk of the logical vector `full` (zero-padded to `size`),
        as a tensor of its own."""
        padded = torch.nn.functional.pad(full.detach(), (0, self.size - full.numel()))
        return padded[self.lo:self.hi].clone()


@dataclasses.dataclass
class TrainState:
    step: torch.Tensor          # int64 scalar: updates applied
    policy: nn.Module           # its parameters view `flat`, its statistics `flat_buffers`
    opt_state: AdamState
    guard_skips: torch.Tensor   # int64 scalar: updates the guard dropped
    layout: FlatLayout          # of the parameters, in `names` order
    names: List[str]
    flat: torch.Tensor          # the float32 masters (this rank's chunk under `shard`)
    flat_buffers: torch.Tensor  # the BatchNorm statistics
    shard: Optional[FlatShard] = None   # ZeRO-3: which chunk `flat` and the moments are
    partition: Optional[Any] = None     # `parallel.partition.Partition` under tp or pp

    @property
    def logical_names(self) -> List[str]:
        """The world of one's parameter names (the checkpoints' layout)."""
        return self.partition.names if self.partition is not None else self.names

    @property
    def logical_shapes(self) -> List[tuple]:
        return list(self.partition.shapes) if self.partition is not None \
            else list(self.layout.shapes)


def shard_train_state(state: TrainState, index: int, count: int,
                      optimizer=None) -> TrainState:
    """Keep only chunk `index` of `count` of the masters and moments
    (`FlatShard`), in place; the policy's parameters become NaN
    placeholders of their shapes. An `optimizer` with per-parameter rules
    (`bc.FrozenAdam`) keeps its rules' chunk. Returns `state`."""
    if state.shard is not None:
        raise ValueError("the train state is already sharded")
    shard = FlatShard.of(state.layout.size, index, count)
    opt = state.opt_state
    state.flat = shard.take(state.flat)
    state.opt_state = AdamState(count=opt.count, mu=shard.take(opt.mu), nu=shard.take(opt.nu))
    state.shard = shard
    take = getattr(optimizer, "take_shard", None)
    if take is not None:
        take(shard)
    nan = torch.full((), float("nan"), dtype=torch.float32, device=state.flat.device)
    with torch.no_grad():
        for p in state.policy.parameters():
            p.data = nan.expand(p.shape)
    return state


def create_train_state(policy: nn.Module, optimizer: Adam,
                       partition: Optional[Any] = None) -> TrainState:
    """A fresh state over `policy` (already initialised, in float32, on its
    device; it must stay there), which under tp or pp is the rank's part
    that `partition` describes. The masters take no part in autograd: the
    train step differentiates a compute copy of them."""
    policy.requires_grad_(False)
    names, params = zip(*policy.named_parameters())
    if any(p.dtype != torch.float32 for p in params):
        raise ValueError("the train state keeps float32 masters; build the policy in float32")
    device = params[0].device
    layout = FlatLayout(params)
    flat = layout.adopt(params)
    bind = getattr(optimizer, "bind", None)
    if bind is not None:  # an optimizer with per-parameter rules (`bc.FrozenAdam`)
        bind(names, layout, device)
    buffers = floating_buffers(policy)
    return TrainState(
        step=torch.zeros((), dtype=torch.int64, device=device),
        policy=policy,
        opt_state=optimizer.init(flat),
        guard_skips=torch.zeros((), dtype=torch.int64, device=device),
        layout=layout,
        names=list(names),
        flat=flat,
        flat_buffers=FlatLayout(buffers).adopt(buffers, device=device),
        partition=partition,
    )
