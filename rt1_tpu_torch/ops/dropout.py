"""Dropout drawn from an explicit generator (flax `nn.Dropout` semantics).

`nn.Dropout` and `F.dropout` draw from PyTorch's global generator; the
port's train step seeds one generator per stream from `(seed, step)`, so
a resumed run draws what an unbroken run would have. Train mode with a
positive rate and no generator raises instead of falling back.

Inside the train step's `parallel.collectives.batch_shard` (a rank's block
of a global batch) the mask is this rank's rows of the global batch's
mask, so a world of several ranks drops what the world of one drops. A
tensor split over the `model` ranks (`model_dim`, the attention
probabilities' heads under tensor parallelism) takes this rank's block of
the whole tensor's mask; a tensor every model rank holds whole draws the
same mask on each (their generators advance alike).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from rt1_tpu_torch.parallel.collectives import current_model_shard, rows_of_global_draw

# The generators of a train step by stream: "crop", "dropout",
# "stochastic_depth".
Rngs = Optional[Dict[str, torch.Generator]]


def dropout(x: torch.Tensor, rate: float, train: bool, rngs: Rngs,
            model_dim: Optional[int] = None) -> torch.Tensor:
    """Keep each element with probability `1 - rate` and scale it by
    `1 / (1 - rate)`, else zero it; the identity unless `train` and
    `rate > 0`. Draws from `rngs["dropout"]` on `x`'s device. `model_dim`:
    the dimension `x` holds this model rank's block of."""
    if not train or rate == 0.0:
        return x
    if not rngs or "dropout" not in rngs:
        raise ValueError("dropout in train mode needs rngs['dropout']")
    keep = 1.0 - rate
    shape, ways = list(x.shape), 1
    if model_dim is not None:
        _, index, ways = current_model_shard()
        shape[model_dim] *= ways
    draw = rows_of_global_draw(
        shape, lambda shape: torch.rand(shape, generator=rngs["dropout"], device=x.device))
    if ways > 1:
        n = x.shape[model_dim]
        draw = draw.narrow(model_dim, index * n, n)
    return torch.where(draw < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
