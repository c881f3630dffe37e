"""Checkpoint plan migration (counterpart of `rt1_tpu/parallel/reshard.py`):
a checkpoint written under one plan restores under another.

JAX's Orbax stores global arrays, and a restore that presents the target
plan's shardings is the whole migration. The port's sharded checkpoint
(`trainer/checkpoints.py`) stores each fsdp rank's chunk of the flat
masters and moments beside a manifest of the layout; a restore assembles
the LOGICAL flat vector (the layout's `size` elements, alignment padding
included) from every chunk, whatever the writer's fsdp size, and slices
it for the target state: the whole vector for a world of one or a
data-parallel rank, chunk f of F under fsdp (`FlatShard.take`). So fsdp=2
-> dp=4 -> fsdp=4 -> world 1 hands back the same bytes, and `eval/restore.py`
loads any of them into the one-device serving engine.

`gathered_equal` is JAX's round-trip assertion: byte identity of two
trees (NaN and -0.0 included) after gathering to the host.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence

import numpy as np
import torch


def assemble_flat(chunks: Sequence[torch.Tensor], size: int) -> torch.Tensor:
    """The logical flat vector of `size` elements from the chunks of an
    fsdp line, in rank order (their concatenation is padded past `size`)."""
    flat = torch.cat([c.reshape(-1) for c in chunks]) if len(chunks) > 1 else \
        chunks[0].reshape(-1)
    if flat.numel() < size:
        raise ValueError(f"the chunks hold {flat.numel()} elements, the layout {size}")
    return flat[:size].clone()


def place_flat(logical: torch.Tensor, shard, device=None) -> torch.Tensor:
    """`logical` laid out for the target state: whole without a shard,
    else its chunk (`trainer/state.py::FlatShard`)."""
    out = logical if shard is None else shard.take(logical)
    return out.to(device) if device is not None else out


def unflatten(flat: torch.Tensor, names: Sequence[str], shapes: Sequence[Sequence[int]],
              align: int) -> Dict[str, torch.Tensor]:
    """{name: tensor} of a logical flat vector laid out like `FlatLayout`
    (each tensor at a multiple of `align` elements)."""
    out, offset = {}, 0
    for name, shape in zip(names, shapes):
        n = int(np.prod(shape)) if len(shape) else 1
        out[name] = flat[offset:offset + n].view(tuple(shape)).clone()
        offset += -(-n // align) * align
    return out


def _leaves(tree: Any, prefix: str = "") -> List[tuple]:
    if isinstance(tree, Mapping):
        out = []
        for k in sorted(tree, key=str):
            out += _leaves(tree[k], f"{prefix}/{k}")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _leaves(v, f"{prefix}/{i}")
        return out
    return [(prefix, tree)]


def _host(leaf: Any):
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:  # numpy has no bfloat16: its raw words
            return leaf.view(torch.int16).numpy(), "bfloat16"
        return leaf.numpy(), str(leaf.dtype)
    if isinstance(leaf, np.ndarray):
        return leaf, str(leaf.dtype)
    return leaf, type(leaf).__name__


def gathered_equal(a: Any, b: Any) -> bool:
    """Byte identity of two trees (mappings, sequences, tensors, arrays,
    scalars) after gathering to the host: the same structure, and every
    array leaf of the same dtype and shape with the same bytes (NaN and
    -0.0 must round-trip too)."""
    la, lb = _leaves(a), _leaves(b)
    if [p for p, _ in la] != [p for p, _ in lb]:
        return False
    for (_, xa), (_, xb) in zip(la, lb):
        (ha, ta), (hb, tb) = _host(xa), _host(xb)
        if isinstance(ha, np.ndarray) or isinstance(hb, np.ndarray):
            if not (isinstance(ha, np.ndarray) and isinstance(hb, np.ndarray)):
                return False
            if ta != tb or ha.shape != hb.shape or ha.tobytes() != hb.tobytes():
                return False
        elif ta != tb or ha != hb:
            return False
    return True
