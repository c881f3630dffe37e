"""The sharding plan (counterpart of `rt1_tpu/parallel/plan.py`), resolved
once from `config.parallel` and read by the train entry, the train step,
the checkpoints and the serving restore.

`rt1_sharding_plan()` is JAX's rule list, path for path, with specs as
tuples (`parallel/sharding.py`). `ShardingPlan` holds the resolved grid
(`MeshConfig`), the rules and `strict`; its `coverage` lists the weight
matrices (rank >= 2) that no rule decides, and `check_coverage` warns or,
strict, raises `PlanCoverageError`, as JAX's does.

**Layout (a difference by design).** JAX's `fsdp` shards each weight
matrix along the dimension its rule names, and GSPMD gathers the weights
once a step. The port's train state keeps every float32
master in one flat vector (`trainer/state.py::FlatLayout`), and `fsdp`
splits that vector, padded to a multiple of the fsdp size, in equal
contiguous chunks: rank f of an fsdp line holds elements [f*n, (f+1)*n) of
the masters and of both Adam moments. Once a step the chunks are cast to
the compute dtype and all-gathered into the flat compute copy, and the
flat gradient is reduce-scattered back into chunks. The numbers are JAX's;
so is the memory a rank holds for the masters and moments (1/fsdp). The
rules decide coverage and tensor parallelism: a leaf whose spec names
`model` (and whose dimension the tp size divides, `sharding.
spec_for_shape`) is split over the `model` ranks, the rest stay whole
(`parallel/partition.py`). Under `pp` each stage keeps its block of the
decoder's layers. JAX's `PIPELINE_STACK_RULES` is not ported: it works
around an XLA:CPU partitioner fault that torch does not have.

The quantization rules stay where the port keeps them
(`models/quant.py::rt1_quant_rules`).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, List, Optional, Sequence, Tuple

from rt1_tpu_torch.parallel import sharding as shardlib
from rt1_tpu_torch.parallel.mesh import BATCH_AXES, MeshConfig
from rt1_tpu_torch.parallel.sharding import Rule, Spec

# n ranks -> (dp, fsdp, tp) under `parallel.auto` (JAX's table).
AUTO_MESH_SHAPES = {
    1: (1, 1, 1),
    2: (2, 1, 1),
    4: (2, 2, 1),
    8: (2, 2, 2),
    16: (1, 4, 4),
    32: (4, 4, 2),
    64: (8, 4, 2),
}


def auto_mesh_shape(n_devices: int, local_device_count: Optional[int] = None
                    ) -> Tuple[int, int, int]:
    """(dp, fsdp, tp) for `n_devices` ranks, per AUTO_MESH_SHAPES (pure
    fsdp for an unlisted count). With `local_device_count` below
    `n_devices` (several hosts), factors of 2 move from fsdp to dp until
    fsdp x tp fits on one host, so only the data-parallel reduction
    crosses hosts."""
    dp, fsdp, tp = AUTO_MESH_SHAPES.get(n_devices, (1, n_devices, 1))
    if local_device_count is not None and 0 < local_device_count < n_devices:
        while fsdp > 1 and fsdp % 2 == 0 and fsdp * tp > local_device_count:
            fsdp //= 2
            dp *= 2
    return dp, fsdp, tp


def rt1_sharding_plan() -> List[Rule]:
    """JAX's plan: ordered (path-regex, spec) over every RT-1 parameter
    group, first match wins."""
    return [
        # transformer decoder: attention
        (r"transformer/layer_\d+/attn/(query|key|value)/kernel$", ("fsdp", "model")),
        (r"transformer/layer_\d+/attn/(query|key|value)/bias$", ("model",)),
        (r"transformer/layer_\d+/attn/out/kernel$", ("model", "fsdp")),
        (r"transformer/layer_\d+/attn/out/bias$", ()),
        # transformer decoder: the single square FFN Dense
        (r"transformer/layer_\d+/ff/kernel$", ("fsdp", "model")),
        (r"transformer/layer_\d+/ff/bias$", ("model",)),
        (r"transformer/layer_\d+/norm_\d+/(scale|bias)$", ()),
        # Switch MoE FFN: the float32 router replicated, experts over model
        (r"moe/gate/kernel$", ()),
        (r"moe/wi$", ("model", "fsdp", None)),
        (r"moe/wo$", ("model", None, "fsdp")),
        # embeddings and the action head
        (r"transformer/token_emb/kernel$", ("fsdp", "model")),
        (r"transformer/token_emb/bias$", ("model",)),
        (r"transformer/position_emb/embedding$", (None, "fsdp")),
        (r"transformer/output_tokens/kernel$", ("fsdp", "model")),
        (r"transformer/output_tokens/bias$", ("model",)),
        # FiLM-EfficientNet tokenizer
        (r"projection_(add|mult)/kernel$", ("fsdp", None)),
        (r"projection_(add|mult)/bias$", ()),
        (r"(conv|conv1|conv2|conv1x1|fc1|fc2)/kernel$", (None, None, None, "fsdp")),
        (r"(conv|conv1|conv2|conv1x1|fc1|fc2)/bias$", ()),
        (r"bn/(scale|bias|mean|var)$", ()),
        (r"token_learner/norm/(scale|bias)$", ()),
        # the vision-pretrain classifier head
        (r"classifier/kernel$", (None, "fsdp")),
        (r"classifier/bias$", ()),
        # tiny tokenizer
        (r"image_tokenizer_def/ctx_proj/kernel$", ("fsdp", None)),
        (r"image_tokenizer_def/ctx_proj/bias$", ()),
        (r"image_tokenizer_def/tok/kernel$", (None, "fsdp")),
        (r"image_tokenizer_def/tok/bias$", ()),
    ]


class PlanCoverageError(ValueError):
    """Strict mode: a weight matrix matched no plan rule."""


@dataclasses.dataclass
class ShardingPlan:
    """A resolved plan: the grid, the rules, `strict`."""

    mesh: MeshConfig
    rules: Sequence[Rule] = dataclasses.field(default_factory=rt1_sharding_plan)
    strict: bool = False

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        """Grid axes the batch splits over (fsdp is data parallelism for
        activations)."""
        return BATCH_AXES

    @property
    def data_parallel_size(self) -> int:
        size = 1
        for a in self.batch_axes:
            size *= getattr(self.mesh, a)
        return size

    def spec_for(self, path_str: str) -> Optional[Spec]:
        """The first matching rule's spec, or None (not `()`) unmatched."""
        import re

        for pattern, spec in self.rules:
            if re.search(pattern, path_str):
                return spec
        return None

    def coverage(self, tree: Any) -> List[str]:
        """Paths of the rank >= 2 leaves (a policy's parameters, or a
        nested mapping) that no rule matched."""
        return [p for p, _ in shardlib.ranked_paths(tree) if self.spec_for(p) is None]

    def check_coverage(self, tree: Any, what: str = "params") -> List[str]:
        """Warn (strict: raise) on unmatched weight matrices."""
        unmatched = self.coverage(tree)
        if unmatched:
            msg = (f"sharding plan: {len(unmatched)} {what} weight matrices matched NO rule "
                   f"and would silently replicate: {unmatched[:8]}"
                   f"{'...' if len(unmatched) > 8 else ''} — add rules to "
                   f"rt1_tpu_torch/parallel/plan.py")
            if self.strict:
                raise PlanCoverageError(msg)
            logging.getLogger("rt1_tpu_torch.parallel.plan").warning(msg)
        return unmatched

    @classmethod
    def from_config(cls, config: Any = None, n_devices: Optional[int] = None,
                    collapse_data: bool = False,
                    local_device_count: Optional[int] = None) -> "ShardingPlan":
        """Resolve `config.parallel` (dp / fsdp / tp / pp / sp, `auto` by
        the rank count, `strict`) over `n_devices` ranks (default: the
        initialized world's, else 1). `collapse_data` is the serving
        resolution: dp 1 and a grid of exactly fsdp x tp x pp x sp ranks,
        raising when `n_devices` is fewer."""
        dp, fsdp, tp, pp, sp = -1, 1, 1, 1, 1
        strict = False
        par = _get(config, "parallel")
        if n_devices is None:
            from rt1_tpu_torch.parallel.distributed import world_size

            n_devices = world_size()
        if par is not None:
            if _get(par, "auto", False):
                pp = int(_get(par, "pp", 1))
                sp = int(_get(par, "sp", 1))
                dp, fsdp, tp = auto_mesh_shape(max(n_devices // max(pp * sp, 1), 1),
                                               local_device_count)
            else:
                dp = int(_get(par, "dp", -1))
                fsdp = int(_get(par, "fsdp", 1))
                tp = int(_get(par, "tp", 1))
                pp = int(_get(par, "pp", 1))
                sp = int(_get(par, "sp", 1))
            strict = bool(_get(par, "strict", False))
        if collapse_data:
            dp = 1
            n = fsdp * tp * pp * sp
            if n_devices < n:
                raise ValueError(f"config.parallel asks for fsdp*tp*pp*sp={n} devices "
                                 f"but this serving host has {n_devices}")
            n_devices = n
        mesh = MeshConfig(data=dp, fsdp=fsdp, model=tp, seq=sp, stage=pp).resolve(n_devices)
        return cls(mesh=mesh, strict=strict)


def _get(obj: Any, key: str, default: Any = None) -> Any:
    """Attribute or key lookup tolerating dataclasses, dicts and None."""
    if obj is None:
        return default
    if isinstance(obj, dict):
        v = obj.get(key, default)
    else:
        v = getattr(obj, key, default)
    return default if v is None else v
