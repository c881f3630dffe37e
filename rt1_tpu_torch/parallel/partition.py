"""A rank's part of the policy under tensor and pipeline parallelism.

JAX keeps every array global and lets a `PartitionSpec` place it; the
port's rank holds only its part, in its own `nn.Module`:

* over `model` (`parallel.tp`), each leaf whose plan spec names `model`
  (`parallel/plan.py::rt1_sharding_plan`) keeps its rank's contiguous
  block of that dimension: the attention's heads (`query`, `key`,
  `value` column blocks and `out`'s row block), the FFN's columns, the
  token embedding's and the head's columns and the MoE's experts. A
  layer's weights split together or not at all: a leaf whose dimension the
  tp size does not divide (`sharding.spec_for_shape`), or attention whose
  heads it does not divide, leaves its whole layer whole, computed on
  every model rank;
* over `stage` (`parallel.pp`), stage s keeps decoder layers [s L/S,
  (s + 1) L/S) and drops the others; the vision tower, the embeddings and
  the head stay on every stage rank (`parallel/pipeline.py`).

Every rank builds the whole policy from the same seed first, so its part
holds exactly the world of one's numbers. `Partition` records the logical
(world-of-one) parameter names and shapes and where each part lives; the
train state (`trainer/state.py`) lays out the rank's part, the step reads
each leaf's class for its global norms (`leaf_class`), and the sharded
checkpoint (`trainer/checkpoints.py`) records it, so a migration
(`parallel/reshard.py`) rebuilds the logical tensors from any plan's
parts (`assemble`) and cuts them for any other (`local`).

Torch's `Linear` keeps its weight as (out, in), the transpose of flax's
kernel: a spec's dimension d of a 2-D kernel is the weight's 1 - d.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from rt1_tpu_torch.parallel.sharding import spec_for_shape

# Leaf classes for the global norms (`parallel.collectives.StepComms.
# reduce_classes`): whole on every model and stage rank, split over
# `model`, owned by a `stage`, both.
WHOLE, MODEL, STAGE, BOTH = range(4)
_LAYER = re.compile(r"^transformer\.layer_(\d+)\.")


@dataclasses.dataclass
class Partition:
    """The logical policy and this rank's part of it."""

    names: List[str]                    # logical parameter names, layout order
    shapes: List[Tuple[int, ...]]       # logical shapes
    keys: List[str]                     # logical state_dict keys (parameters and buffers)
    slices: Dict[str, int]              # name -> the torch dim split over `model`
    model_ways: int = 1
    stage_ways: int = 1
    stage_of: Dict[str, int] = dataclasses.field(default_factory=dict)  # layer leaves
    model_index: int = 0
    stage_index: int = 0
    paths: List[str] = dataclasses.field(default_factory=list)   # logical flax paths

    def holds(self, name: str, stage: int) -> bool:
        return self.stage_of.get(name, stage) == stage

    def local_shape(self, name: str, shape: Sequence[int]) -> Tuple[int, ...]:
        shape = list(shape)
        if name in self.slices:
            shape[self.slices[name]] //= self.model_ways
        return tuple(shape)

    def part(self, stage: int) -> Tuple[List[str], List[Tuple[int, ...]]]:
        """(names, shapes) a rank of `stage` holds (every model rank the
        same shapes), in layout order."""
        names, shapes = [], []
        for name, shape in zip(self.names, self.shapes):
            if self.holds(name, stage):
                names.append(name)
                shapes.append(self.local_shape(name, shape))
        return names, shapes

    def local(self, name: str, full: torch.Tensor, model_index: Optional[int] = None
              ) -> torch.Tensor:
        """Model rank `model_index`'s (default: this rank's) block of the
        logical tensor `full`."""
        if name not in self.slices:
            return full
        dim = self.slices[name]
        n = full.shape[dim] // self.model_ways
        index = self.model_index if model_index is None else model_index
        return full.narrow(dim, index * n, n)

    def leaf_class(self, name: str) -> int:
        return (MODEL if name in self.slices else WHOLE) + \
            (STAGE if name in self.stage_of else 0)

    def to_manifest(self) -> Dict:
        return {"names": list(self.names), "shapes": [list(s) for s in self.shapes],
                "keys": list(self.keys), "slices": dict(self.slices),
                "model_ways": self.model_ways, "stage_ways": self.stage_ways,
                "stage_of": dict(self.stage_of)}

    @classmethod
    def from_manifest(cls, record: Mapping) -> "Partition":
        return cls(names=list(record["names"]), shapes=[tuple(s) for s in record["shapes"]],
                   keys=list(record["keys"]), slices=dict(record["slices"]),
                   model_ways=int(record["model_ways"]), stage_ways=int(record["stage_ways"]),
                   stage_of={k: int(v) for k, v in record["stage_of"].items()})

    def logical_flat(self, parts: Mapping[Tuple[int, int], torch.Tensor]) -> torch.Tensor:
        """The world of one's flat vector (its `FlatLayout`) from each
        part's flat vector (the part's layout, or longer: padding),
        keyed (stage, model index)."""
        from rt1_tpu_torch.trainer.state import FlatLayout

        tensors = {}
        for (stage, model), flat in parts.items():
            names, shapes = self.part(stage)
            local = FlatLayout.of_shapes(shapes)
            tensors[(stage, model)] = dict(zip(names, local.views(flat[:local.size])))
        whole = self.assemble(tensors)
        return FlatLayout.of_shapes(self.shapes).flatten([whole[n] for n in self.names])

    def assemble(self, parts: Mapping[Tuple[int, int], Mapping[str, torch.Tensor]]
                 ) -> Dict[str, torch.Tensor]:
        """{logical name: tensor} from every part's {name: tensor}, keyed
        (stage, model index): a split leaf concatenated over the model
        ranks, every other leaf from the first part that holds it."""
        out = {}
        for name in self.names:
            holders = sorted(key for key, tensors in parts.items() if name in tensors)
            if not holders:
                raise ValueError(f"no part holds {name!r}")
            if name in self.slices:
                stage = holders[0][0]
                blocks = [parts[(stage, m)][name] for m in range(self.model_ways)]
                out[name] = torch.cat(blocks, dim=self.slices[name])
            else:
                out[name] = parts[holders[0]][name]
        return out


def _torch_dim(path: str, flax_dim: int, ndim: int) -> int:
    """The torch dimension of a flax leaf's dimension `flax_dim`."""
    if path.endswith("kernel"):
        if ndim != 2:
            raise ValueError(f"a model split of the {ndim}-D kernel {path} is not supported")
        return 1 - flax_dim
    return flax_dim


def _unit(name: str) -> str:
    """The layer a leaf belongs to: its weights split together. Attention
    is one unit (its heads), every other layer its own module."""
    parts = name.split(".")
    if "attn" in parts:
        return ".".join(parts[:parts.index("attn") + 1])
    return ".".join(parts[:-1])


def model_slices(policy: nn.Module, plan, ways: int) -> Dict[str, int]:
    """{parameter name: torch dim} of the leaves `plan` splits over
    `ways` model ranks (see the module docstring)."""
    from rt1_tpu_torch.convert import flax_paths

    if ways == 1:
        return {}
    paths = flax_paths(policy)
    wanted, refused = {}, set()
    for name, p in policy.named_parameters():
        path = paths[name].split("/", 1)[1]
        spec = plan.spec_for(path)
        if not spec or not any(e == "model" or (isinstance(e, tuple) and "model" in e)
                               for e in spec):
            continue
        flax_shape = tuple(p.shape[::-1]) if path.endswith("kernel") and p.dim() == 2 \
            else tuple(p.shape)
        kept = spec_for_shape(spec, flax_shape, {"model": ways})
        dims = [i for i, e in enumerate(kept) if e == "model"]
        if len(dims) != 1:
            refused.add(_unit(name))
            continue
        wanted[name] = _torch_dim(path, dims[0], p.dim())
    for name, module in policy.named_modules():
        heads = getattr(module, "num_heads", None)
        if name.endswith("attn") and heads is not None and heads % ways:
            refused.add(name)
    return {n: d for n, d in wanted.items() if _unit(n) not in refused}


def partition_policy(policy: nn.Module, grid, plan, microbatches: int = 4
                     ) -> Optional[Partition]:
    """Cut `policy` (whole, from the run's seed) down to this rank's part
    of `grid`, in place, and return the `Partition`; None (the policy
    untouched) without a `model` or `stage` axis above 1."""
    from rt1_tpu_torch.obs.health import param_paths

    tp_ways, pp_ways = grid.size("model"), grid.size("stage")
    if tp_ways == 1 and pp_ways == 1:
        return None
    named = list(policy.named_parameters())
    partition = Partition(names=[n for n, _ in named],
                          shapes=[tuple(p.shape) for _, p in named],
                          keys=list(policy.state_dict()),
                          slices=model_slices(policy, plan, tp_ways),
                          model_ways=tp_ways, stage_ways=pp_ways,
                          model_index=grid.coords["model"], stage_index=grid.coords["stage"],
                          paths=param_paths(policy))
    with torch.no_grad():
        for name, p in named:
            if name in partition.slices:
                p.data = partition.local(name, p.data).clone()
    if pp_ways > 1:
        from rt1_tpu_torch.parallel.pipeline import StagePlan

        transformer = getattr(policy, "transformer", None)
        if transformer is None:
            raise ValueError("pipeline parallelism needs the RT-1 decoder (a policy with "
                             "`transformer`)")
        layers = transformer.num_layers
        if layers % pp_ways:
            raise ValueError(f"{layers} stacked layers not divisible by {pp_ways} stages")
        per = layers // pp_ways
        for name, _ in named:
            match = _LAYER.match(name)
            if match:
                partition.stage_of[name] = int(match.group(1)) // per
        stage = partition.stage_index
        for i in range(layers):
            if i // per != stage:
                delattr(transformer, f"layer_{i}")
        group = grid.group("stage")
        if group is not None:
            # NCCL wants a group's first call collective, not one a tick's
            # point to point leaves some stages out of.
            import torch.distributed as dist

            dist.barrier(group=group)
        transformer.stages = StagePlan(group=group, index=stage, ways=pp_ways,
                                       layers=range(stage * per, (stage + 1) * per),
                                       microbatches=microbatches)
    return partition
