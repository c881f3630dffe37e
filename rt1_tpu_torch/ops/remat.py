"""Rematerialisation that keeps the port's explicit random streams exact
(the counterpart of `jax.checkpoint` / `nn.remat` in the JAX modules).

`checkpoint(fn, *args, rngs=...)` runs `fn` through
`torch.utils.checkpoint.checkpoint(use_reentrant=False)`: its activations
are not stored, and the backward pass runs `fn` again to get them. Two
things would make the recompute differ from the first run, and both are
handled here:

* the dropout and stochastic-depth masks are drawn from the step's
  `torch.Generator`s (`rngs`), which torch's checkpoint does not restore
  (it restores only the global generator). Each generator's state is
  recorded before the first run; the recompute starts from it and puts
  back afterwards whatever state the generators had reached, so the masks
  are the same ones and nothing after the recompute sees a different
  stream;
* BatchNorm in train mode writes its running statistics as a side effect.
  `recomputing()` is true during the recompute, and `BatchNorm` then
  leaves the statistics alone (the first run already wrote them);
* the train step of several ranks runs its forward inside
  `parallel.collectives.batch_shard`, which the backward pass has left by
  the time it recomputes. The recompute re-enters the block the first run
  saw, so BatchNorm syncs, the masks keep the rank's rows, the MoE
  routes the global batch and the tensor-parallel layers reduce over
  `model` again.

A module is recomputed with the tensors it had at the first run (the
train step's `functional_call` has put its own back by then). So a loss
and its gradients are the same with and without remat.
"""

from __future__ import annotations

import threading
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint as _torch_checkpoint

from rt1_tpu_torch.ops.dropout import Rngs
from rt1_tpu_torch.parallel.collectives import current_shard, shard_context

_STATE = threading.local()


def recomputing() -> bool:
    """True while a checkpointed function runs again in the backward pass."""
    return getattr(_STATE, "depth", 0) > 0


def checkpoint(fn: Callable, *args, rngs: Rngs = None):
    """`fn(*args)` with its activations recomputed in the backward pass.
    A module `fn` is recomputed with the parameters and buffers it has
    now: the train step calls the policy through
    `torch.func.functional_call`, whose swapped-in tensors are gone by
    the time the backward pass runs."""
    if isinstance(fn, torch.nn.Module):
        module = fn
        tensors = {**dict(module.named_parameters()), **dict(module.named_buffers())}

        def fn(*inner):
            return torch.func.functional_call(module, tensors, inner)
    gens = [g for g in (rngs or {}).values() if g is not None]
    start = [g.get_state() for g in gens]
    shard = current_shard()
    calls = [0]

    def body(*inner):
        calls[0] += 1
        if calls[0] == 1:
            return fn(*inner)
        reached = [g.get_state() for g in gens]
        for g, state in zip(gens, start):
            g.set_state(state)
        _STATE.depth = getattr(_STATE, "depth", 0) + 1
        try:
            with shard_context(shard):
                return fn(*inner)
        finally:
            _STATE.depth -= 1
            for g, state in zip(gens, reached):
                g.set_state(state)

    # The global generator is never drawn from in the port's modules.
    return _torch_checkpoint(body, *args, use_reentrant=False, preserve_rng_state=False)
