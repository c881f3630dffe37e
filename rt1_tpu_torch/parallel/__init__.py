"""Parallelism over a `torch.distributed` world (counterpart of
`rt1_tpu/parallel/`).

JAX lays one `jax.sharding.Mesh` over a slice and lets GSPMD insert the
collectives. The port lays the world's ranks, one process and one device
each, over the same ('data', 'stage', 'fsdp', 'seq', 'model') grid
(`mesh.py`), resolves the same declarative plan from `config.parallel`
(`plan.py`, `sharding.py`), rendezvouses before any device access
(`distributed.py`), and issues the step's collectives by hand
(`collectives.py`, `trainer/train.py`): data parallelism, ZeRO-3 over
`fsdp`, ring attention over `seq` (`ring_attention.py`), tensor
parallelism over `model` (`tensor_parallel.py`: the layers' collectives;
`partition.py`: a rank's part of the policy), GPipe over `stage`
(`pipeline.py`) and checkpoint plan migration (`reshard.py`).
`flash_attention.py` is the hand-written fused attention kernel.

JAX's exports, folded: `RankGrid` takes `make_mesh`'s place; JAX's
placement helpers (`batch_sharding`, `replicated`, `shard_pytree`,
`sharding_for_path` and the rule views) place arrays on a mesh, which the
port's flat layout does not do (the plan decides coverage; the train step
chunks the flat vector); `mixed_precision_from_config` is
`config.parallel.mixed_precision`.
"""

from rt1_tpu_torch.parallel.distributed import (
    DistributedOptions,
    free_local_port,
    initialize_from_config,
    is_primary,
)
from rt1_tpu_torch.parallel.mesh import MeshConfig, RankGrid
from rt1_tpu_torch.parallel.partition import Partition, partition_policy
from rt1_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    pp_causal_transformer_apply,
    stack_layer_params,
    unstack_layer_params,
)
from rt1_tpu_torch.parallel.plan import (
    AUTO_MESH_SHAPES,
    PlanCoverageError,
    ShardingPlan,
    auto_mesh_shape,
    rt1_sharding_plan,
)
from rt1_tpu_torch.parallel.reshard import gathered_equal
from rt1_tpu_torch.parallel.sharding import spec_for_shape

__all__ = [
    "AUTO_MESH_SHAPES",
    "DistributedOptions",
    "MeshConfig",
    "Partition",
    "PlanCoverageError",
    "RankGrid",
    "ShardingPlan",
    "auto_mesh_shape",
    "free_local_port",
    "gathered_equal",
    "initialize_from_config",
    "is_primary",
    "partition_policy",
    "pipeline_apply",
    "pp_causal_transformer_apply",
    "rt1_sharding_plan",
    "spec_for_shape",
    "stack_layer_params",
    "unstack_layer_params",
]
