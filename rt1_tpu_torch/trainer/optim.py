"""Adam with a step-indexed MultiStepLR (counterpart of
`rt1_tpu/trainer/optim.py`, which chains optax transforms).

The reference trains with `torch.optim.Adam(lr=5e-4)` and `MultiStepLR(
milestones=[50, 75, 90], gamma=0.1)` stepped per epoch; the JAX package
expresses both in optimizer steps with optax. This module follows optax's
update rule to the letter rather than `torch.optim.Adam`'s, because the
reference loss scale (`/(b*t*(I+A))`, 480 at the flagship) makes the
gradients small enough that Adam's eps = 1e-8 is not negligible, and any
other placement of eps drifts the parameters within a few steps:

    mu = (1 - b1) g + b1 mu;   nu = (1 - b2) g^2 + b2 nu;   t = count + 1
    update = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)
    params = params - lr(count) * update

(eps outside the bias-corrected square root; the bias corrections divide
the moments.) Optional extras, in optax's chain order: clip by global norm,
then weight decay added to the gradient, then Adam.

Everything works on flat float32 tensors (`trainer/state.py` lays the
parameters out) and stays on the device: the learning rate and the bias
corrections are computed there from the step count, so a step needs no
host sync. `update` is pure: it returns new tensors and leaves its inputs
as they were, which lets the train step's guard keep or drop the result.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch


def global_norm(x: torch.Tensor) -> torch.Tensor:
    """sqrt(sum(x^2)), as optax's `global_norm`. Not `linalg.vector_norm`:
    on the CPU it accumulates a float32 vector of millions of elements with
    errors near 1 %."""
    return torch.sqrt(torch.sum(torch.square(x)))


def multistep_lr(base_lr: float, milestones: Sequence[int], gamma: float = 0.1,
                 steps_per_epoch: int = 1):
    """torch's `MultiStepLR` over optimizer steps (milestones in epochs):
    `count -> base_lr * gamma^(number of boundaries <= count)`, computed as
    `optax.piecewise_constant_schedule` does, in float32 on `count`'s
    device."""
    boundaries = sorted(int(m) * steps_per_epoch for m in milestones)

    def schedule(count: torch.Tensor) -> torch.Tensor:
        c = count.to(torch.float32)
        v = torch.full((), base_lr, dtype=torch.float32, device=count.device)
        for threshold in boundaries:
            indicator = torch.clamp(torch.sign(threshold - c), min=0.0)
            v = v * indicator + (1 - indicator) * gamma * v
        return v

    return schedule


@dataclasses.dataclass
class AdamState:
    count: torch.Tensor  # int64 scalar: updates applied
    mu: torch.Tensor     # flat float32 first moment
    nu: torch.Tensor     # flat float32 second moment


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8) with MultiStepLR, optional clip by
    global norm and weight decay."""

    def __init__(self, learning_rate: float = 5e-4, milestones: Sequence[int] = (50, 75, 90),
                 gamma: float = 0.1, steps_per_epoch: int = 1,
                 grad_clip_norm: Optional[float] = None, weight_decay: float = 0.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.schedule = multistep_lr(learning_rate, milestones, gamma, steps_per_epoch)
        self.grad_clip_norm = grad_clip_norm
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, flat_params: torch.Tensor) -> AdamState:
        return AdamState(
            count=torch.zeros((), dtype=torch.int64, device=flat_params.device),
            mu=torch.zeros_like(flat_params),
            nu=torch.zeros_like(flat_params),
        )

    def update(self, grads: torch.Tensor, state: AdamState, params: torch.Tensor,
               grad_norm: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, AdamState]:
        """(new params, new state) for flat float32 `grads` and `params`.
        `grad_norm`, when given, is the global norm clipping reads (a chunk
        of a ZeRO-3 gradient does not know it)."""
        g = grads
        if self.grad_clip_norm:
            g_norm = global_norm(g) if grad_norm is None else grad_norm
            g = torch.where(g_norm < self.grad_clip_norm, g, (g / g_norm) * self.grad_clip_norm)
        if self.weight_decay:
            g = g + self.weight_decay * params
        b1, b2 = self.b1, self.b2
        mu = (1 - b1) * g + b1 * state.mu
        nu = (1 - b2) * torch.square(g) + b2 * state.nu
        count_inc = state.count + 1
        t = count_inc.to(torch.float32)
        mu_hat = mu / (1 - torch.pow(torch.full_like(t, b1), t))
        nu_hat = nu / (1 - torch.pow(torch.full_like(t, b2), t))
        update = mu_hat / (torch.sqrt(nu_hat) + self.eps)
        step_size = -1 * self.schedule(state.count)
        return params + step_size * update, AdamState(count=count_inc, mu=mu, nu=nu)
