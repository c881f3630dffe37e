"""Sharding mechanics (counterpart of `rt1_tpu/parallel/sharding.py`):
the paths of a tree's leaves, and a spec's degradation on small shapes.

A spec is a tuple with one entry a dimension: an axis name of the rank
grid (`parallel/mesh.py`), a tuple of them, or None (that dimension whole);
`()` replicates, as JAX's `PartitionSpec()` does. The rules are in
`parallel/plan.py`; paths are '/'-joined flax paths without the
collection (`transformer/layer_0/ff/kernel`), the names `convert.flax_paths`
gives the port's parameters.

In the port the specs decide coverage (`ShardingPlan.coverage`) and tensor
parallelism, which follows the rules' `model` entries
(`parallel/partition.py`); `fsdp` shards the train state's flat vector in
equal chunks, not each matrix along the dimension its rule names
(`trainer/train.py`).
"""

from __future__ import annotations

import re
from typing import Any, Iterable, List, Mapping, Sequence, Tuple, Union

Spec = Tuple[Any, ...]
Rule = Tuple[str, Spec]


def spec_for_shape(spec: Spec, shape: Sequence[int], mesh_shape: Mapping[str, int]) -> Spec:
    """`spec` with each entry whose axes' product does not divide its
    dimension dropped (that dimension replicated), trailing Nones trimmed:
    JAX's degradation for the small shapes of small configs."""
    if not spec:
        return spec
    dims = []
    changed = False
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            dims.append(entry)
            continue
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        ways = 1
        for a in axes:
            ways *= mesh_shape.get(a, 1)
        if ways > 1 and shape[i] % ways != 0:
            dims.append(None)
            changed = True
        else:
            dims.append(entry)
    if not changed:
        return spec
    while dims and dims[-1] is None:
        dims.pop()
    return tuple(dims)


# flax `MultiHeadDotProductAttention`'s query/key/value biases are (heads,
# head_dim) in JAX's tree; the port flattens them (`convert.py`).
_HEAD_BIAS = re.compile(r"MultiHeadDotProductAttention_\d+/(query|key|value)/bias$")


def _rank(path: str, leaf: Any) -> int:
    """The rank of the leaf in JAX's tree (coverage counts rank >= 2)."""
    if _HEAD_BIAS.search(path):
        return 2
    if hasattr(leaf, "ndim"):
        return int(leaf.ndim)
    if hasattr(leaf, "dim"):
        return int(leaf.dim())
    return len(getattr(leaf, "shape", ()))


def flat_paths(tree: Union[Mapping[str, Any], Any]) -> List[Tuple[str, Any]]:
    """(flax path, leaf) of every leaf: of a policy (`nn.Module`), its
    parameters under their flax paths without the "params/" collection;
    of a nested mapping, its '/'-joined keys."""
    from torch import nn

    if isinstance(tree, nn.Module):
        from rt1_tpu_torch.convert import flax_paths

        paths = flax_paths(tree)
        out = []
        for key, value in tree.named_parameters():
            path = paths[key]
            out.append((path.split("/", 1)[1] if path.startswith("params/") else path, value))
        return out
    out: List[Tuple[str, Any]] = []

    def walk(node, prefix):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, prefix + (str(k),))
        else:
            out.append(("/".join(prefix), node))

    walk(tree, ())
    return out


def ranked_paths(tree) -> Iterable[Tuple[str, Any]]:
    """(path, leaf) of the rank >= 2 leaves (weight matrices)."""
    return [(p, leaf) for p, leaf in flat_paths(tree) if _rank(p, leaf) >= 2]
