"""The rank grid (counterpart of `rt1_tpu/parallel/mesh.py`).

JAX lays a `jax.sharding.Mesh` over the devices of a slice. The port lays
the ranks of a `torch.distributed` world, one process and one device each,
over the same five axes, in JAX's order (`model` innermost):

* ``data``  — data parallelism: the batch is split, gradients all-reduced;
* ``stage`` — pipeline stages: each holds its block of the decoder's
  layers, and microbatches pass between them point to point
  (`parallel/pipeline.py`); stage ranks hold the same rows;
* ``fsdp``  — ZeRO-3: the batch is split as over ``data``, and the float32
  masters and Adam moments live in 1/fsdp chunks (`trainer/train.py`);
* ``seq``   — sequence parallelism: ring attention over the window
  (`parallel/ring_attention.py`); ranks that differ only here hold the
  same rows;
* ``model`` — tensor parallelism: heads, FFN columns, the embeddings,
  the head and the MoE experts split by the plan's rules
  (`parallel/tensor_parallel.py`); model ranks hold the same rows.

`RankGrid` is this rank's place in the grid and one process group per
line of ranks along each axis combination the train step reduces over.
A world without a process group (one process, no rendezvous) has no
groups and emits no collective; an initialized world of one runs the
collectives on one-rank groups, which change nothing.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Sequence, Tuple

AXES = ("data", "stage", "fsdp", "seq", "model")
BATCH_AXES = ("data", "fsdp")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical grid shape. -1 for `data` means "all remaining ranks"."""

    data: int = -1
    fsdp: int = 1
    model: int = 1
    seq: int = 1
    stage: int = 1

    def resolve(self, n_devices: int) -> "MeshConfig":
        fixed = self.fsdp * self.model * self.seq * self.stage
        if n_devices % fixed != 0:
            raise ValueError(
                f"{n_devices} devices not divisible by "
                f"fsdp*model*seq*stage={fixed}"
            )
        data = self.data if self.data != -1 else n_devices // fixed
        if data * fixed != n_devices:
            raise ValueError(
                f"mesh {data}x{self.stage}x{self.fsdp}x{self.seq}x"
                f"{self.model} != {n_devices} devices"
            )
        return MeshConfig(data=data, fsdp=self.fsdp, model=self.model, seq=self.seq,
                          stage=self.stage)

    @property
    def shape(self) -> Dict[str, int]:
        """{axis: size} in grid order (resolve first: `data` may be -1)."""
        return {a: getattr(self, a) for a in AXES}

    @property
    def size(self) -> int:
        n = 1
        for a in AXES:
            n *= getattr(self, a)
        return n


def coords_of(rank: int, mesh: MeshConfig) -> Dict[str, int]:
    """{axis: coordinate} of `rank` on the resolved grid `mesh`, `model`
    innermost (row-major over AXES)."""
    out = {}
    for axis in reversed(AXES):
        size = getattr(mesh, axis)
        out[axis] = rank % size
        rank //= size
    return {a: out[a] for a in AXES}


def rank_of(coords: Dict[str, int], mesh: MeshConfig) -> int:
    rank = 0
    for axis in AXES:
        rank = rank * getattr(mesh, axis) + coords.get(axis, 0)
    return rank


def lines(mesh: MeshConfig, axes: Sequence[str]):
    """Every line of ranks along `axes` (the ranks that share all other
    coordinates), each in grid order; the lines ordered by their fixed
    coordinates, so every rank enumerates the same list."""
    others = [a for a in AXES if a not in axes]
    out = []
    for fixed in itertools.product(*(range(getattr(mesh, a)) for a in others)):
        base = dict(zip(others, fixed))
        members = []
        for moving in itertools.product(*(range(getattr(mesh, a)) for a in axes)):
            members.append(rank_of({**base, **dict(zip(axes, moving))}, mesh))
        out.append(sorted(members))
    return out


class RankGrid:
    """This rank on the resolved grid `mesh`, with a process group for its
    line along each of `group_axes` (created on every rank, in the same
    order, as `torch.distributed.new_group` requires). `rank` and `world`
    default to the initialized world's; without one the grid is the world
    of one and holds no group."""

    GROUP_AXES: Tuple[Tuple[str, ...], ...] = (BATCH_AXES, ("data",), ("fsdp",), ("seq",),
                                                ("model",), ("stage",))

    def __init__(self, mesh: MeshConfig, rank: Optional[int] = None,
                 world: Optional[int] = None):
        import torch.distributed as dist

        initialized = dist.is_available() and dist.is_initialized()
        if world is None:
            world = dist.get_world_size() if initialized else 1
        if rank is None:
            rank = dist.get_rank() if initialized else 0
        self.mesh = mesh.resolve(world)
        self.rank, self.world = rank, world
        self.coords = coords_of(rank, self.mesh)
        self.distributed = initialized
        self._groups: Dict[Tuple[str, ...], object] = {}
        if initialized:
            for axes in self.GROUP_AXES:
                for members in lines(self.mesh, axes):
                    group = dist.new_group(members)
                    if rank in members:
                        self._groups[axes] = group

    def size(self, *axes: str) -> int:
        n = 1
        for a in axes:
            n *= getattr(self.mesh, a)
        return n

    def index(self, *axes: str) -> int:
        """This rank's position along `axes` (row-major in the given order)."""
        i = 0
        for a in axes:
            i = i * getattr(self.mesh, a) + self.coords[a]
        return i

    def group(self, *axes: str):
        """The process group of this rank's line along `axes` (None without
        a process group)."""
        return self._groups.get(tuple(axes))

    @property
    def batch_ways(self) -> int:
        """Ways the batch is split: data x fsdp."""
        return self.size(*BATCH_AXES)

    @property
    def batch_index(self) -> int:
        """This rank's block of the global batch (ranks along `seq` share it)."""
        return self.index(*BATCH_AXES)

    def __repr__(self):
        shape = "x".join(f"{a}{getattr(self.mesh, a)}" for a in AXES)
        return f"RankGrid({shape}, rank {self.rank} of {self.world}, {self.coords})"


_CURRENT: Optional[RankGrid] = None


def set_current(grid: Optional[RankGrid]) -> None:
    """Make `grid` the process's grid (the train entry does, after the
    rendezvous); the decoder's ring attention reads its `seq` group."""
    global _CURRENT
    _CURRENT = grid


def current() -> Optional[RankGrid]:
    return _CURRENT
