"""rt1_tpu_torch.resilience — self-healing training for long preemptible
runs: the port's copy of `rt1_tpu/resilience/` (the port imports nothing of
the JAX package; every option keeps the JAX name, default and meaning).

Four pieces, all config-gated and all cheap (or free) when off:

* :mod:`rt1_tpu_torch.resilience.guard`   — NaN/spike step guard with a
  bounded escalation ladder: device-side update skip -> checkpoint rollback
  with a fresh data-stream seed -> abort. (`rt1_train_guard_*` counters.)
* :mod:`rt1_tpu_torch.resilience.retry`   — exponential-backoff-with-jitter
  retry wrapped around the I/O seams (checkpoint save/restore, packed-cache
  open, feeder construction). (`rt1_train_retry_*` counters.)
* :mod:`rt1_tpu_torch.resilience.preempt` — SIGTERM/SIGINT coordinator
  turning preemption into "force-save at the current step, drain the
  feeder, exit 0" — `restore_or_initialize` then resumes exactly.
* :mod:`rt1_tpu_torch.resilience.faults`  — deterministic fault injection
  ("NaN loss at batch 7", "OSError on the 2nd checkpoint save") so every
  recovery path above is provable in tests and chip runs; the serve fleet
  consults it too.

Stdlib only at module scope: the router and the stub replica import this
package and must not import torch.
"""

from __future__ import annotations

import dataclasses

from rt1_tpu_torch.resilience import faults, guard, preempt, retry
from rt1_tpu_torch.resilience.guard import (
    GuardAbortError,
    GuardOptions,
    GuardVerdict,
    StepGuard,
)
from rt1_tpu_torch.resilience.preempt import PreemptionCoordinator
from rt1_tpu_torch.resilience.retry import RetryOptions, retry_call

__all__ = [
    "GuardAbortError",
    "GuardOptions",
    "GuardVerdict",
    "PreemptionCoordinator",
    "ResilienceOptions",
    "RetryOptions",
    "StepGuard",
    "faults",
    "guard",
    "preempt",
    "retry",
    "retry_call",
]


@dataclasses.dataclass
class ResilienceOptions:
    """Resolved `config.resilience` with defaults for configs that predate it.

    Mirrors `obs.ObsOptions`: the train loop consumes this instead of poking
    `config.resilience.*`, so pre-resilience configs (pinned proof configs,
    sweep artifacts) keep running with the exact old loop semantics —
    every default below is "off"/parity.
    """

    # Step guard (guard.py + the guarded train step in trainer/train.py).
    guard: bool = False
    guard_grad_norm_max: float = 0.0
    guard_loss_spike_factor: float = 0.0
    guard_spike_ema_beta: float = 0.9
    guard_warmup_checks: int = 3
    guard_skip_budget: int = 3
    guard_rollback_budget: int = 2
    # Retry on the I/O seams (checkpoint save/restore, packed-cache open,
    # feeder construction).
    io_retry: bool = False
    retry_attempts: int = 3
    retry_backoff_s: float = 0.5
    retry_max_backoff_s: float = 8.0
    retry_deadline_s: float = 120.0
    # SIGTERM/SIGINT -> save-and-exit-0 instead of die-with-dump.
    preempt_save: bool = False
    # Deterministic fault schedule (faults.py grammar); RT1_FAULTS appends.
    faults: str = ""

    @classmethod
    def from_config(cls, config) -> "ResilienceOptions":
        """Read `config.resilience` if present (ml_collections or mapping);
        absent keys fall back to the dataclass defaults."""
        node = None
        if config is not None:
            get = getattr(config, "get", None)
            node = (
                get("resilience")
                if callable(get)
                else getattr(config, "resilience", None)
            )
        kwargs = {}
        if node is not None:
            for field in dataclasses.fields(cls):
                getter = getattr(node, "get", None)
                value = (
                    getter(field.name)
                    if callable(getter)
                    else getattr(node, field.name, None)
                )
                if value is not None:
                    kwargs[field.name] = value
        return cls(**kwargs)

    def guard_options(self) -> GuardOptions:
        return GuardOptions(
            enabled=self.guard,
            grad_norm_max=self.guard_grad_norm_max,
            loss_spike_factor=self.guard_loss_spike_factor,
            spike_ema_beta=self.guard_spike_ema_beta,
            warmup_checks=self.guard_warmup_checks,
            skip_budget=self.guard_skip_budget,
            rollback_budget=self.guard_rollback_budget,
        )

    def retry_options(self) -> "RetryOptions | None":
        if not self.io_retry:
            return None
        return RetryOptions(
            attempts=self.retry_attempts,
            backoff_s=self.retry_backoff_s,
            max_backoff_s=self.retry_max_backoff_s,
            deadline_s=self.retry_deadline_s,
        )
