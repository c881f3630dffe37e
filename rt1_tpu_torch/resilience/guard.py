"""Step guard: divergence detection with a bounded escalation ladder.

The port's copy of `rt1_tpu/resilience/guard.py` (the port imports nothing
of the JAX package). The device-side half lives in
`rt1_tpu_torch/trainer/train.py` (the ``guard_nonfinite`` train step drops
any update whose loss or grad-norm is non-finite — a per-step
`torch.where` select, no host sync, with a cumulative skip counter kept as
a device scalar). This module is the host-side
half: `StepGuard.observe` inspects the scalars the loop *already* fetched
at log steps and walks a configurable escalation ladder:

    OK ──bad──▶ SKIP (tolerate; the device already dropped the update)
         │
         └─ `skip_budget` consecutive bad checks ──▶ ROLLBACK
               (restore the last good checkpoint + a fresh data-stream
                seed, performed by the train loop)
         │
         └─ `rollback_budget` rollbacks spent ──▶ ABORT (GuardAbortError)

"Bad" means: non-finite loss or grad-norm; grad-norm above
``grad_norm_max`` (when set); or loss above ``loss_spike_factor`` × a
rolling EMA of recent healthy losses (when set, after ``warmup_checks``
healthy observations arm the detector). A rollback resets the EMA — the
restored stream starts a fresh baseline.

Everything the guard does is visible: `counters()` feeds the loop's scalar
stream, so `rt1_train_guard_*` series land in TensorBoard, the Prometheus
listener, and the flight recorder.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Dict, Optional


class GuardVerdict(enum.Enum):
    OK = "ok"
    SKIP = "skip"
    ROLLBACK = "rollback"
    ABORT = "abort"


class GuardAbortError(RuntimeError):
    """Raised by the train loop when the rollback budget is exhausted."""


@dataclasses.dataclass(frozen=True)
class GuardOptions:
    enabled: bool = False
    # 0 disables the threshold; finiteness is always checked when enabled.
    grad_norm_max: float = 0.0
    # 0 disables spike detection; > 0 flags loss > factor * EMA(healthy).
    loss_spike_factor: float = 0.0
    spike_ema_beta: float = 0.9
    warmup_checks: int = 3
    # Consecutive bad host checks tolerated before proposing a rollback.
    skip_budget: int = 3
    # Rollbacks allowed before the run aborts (bounded self-healing).
    rollback_budget: int = 2


class StepGuard:
    """Host-side escalation ladder over per-log-step scalars."""

    def __init__(self, options: GuardOptions):
        self.options = options
        self._ema: Optional[float] = None
        self._healthy_checks = 0
        self._consecutive_bad = 0
        self._last_good_step: Optional[int] = None
        self._checks = 0
        self._bad_checks = 0
        self._nonfinite = 0
        self._spikes = 0
        self._grad_norm_trips = 0
        self._rollbacks = 0
        self._device_skips = 0.0
        self._last_reason = ""

    # ------------------------------------------------------------- checking

    def _classify(self, loss: Optional[float], grad_norm: Optional[float]) -> str:
        """'' when healthy, else a short reason string."""
        for name, v in (("loss", loss), ("grad_norm", grad_norm)):
            if v is not None and not math.isfinite(v):
                self._nonfinite += 1
                return f"non-finite {name} ({v})"
        gmax = self.options.grad_norm_max
        if gmax > 0 and grad_norm is not None and grad_norm > gmax:
            self._grad_norm_trips += 1
            return f"grad_norm {grad_norm:.4g} > max {gmax:.4g}"
        factor = self.options.loss_spike_factor
        if (
            factor > 0
            and loss is not None
            and self._ema is not None
            and self._healthy_checks >= self.options.warmup_checks
            and loss > factor * self._ema
        ):
            self._spikes += 1
            return f"loss spike {loss:.4g} > {factor:g} x EMA {self._ema:.4g}"
        return ""

    def observe(self, step: int, scalars: Dict[str, float]) -> GuardVerdict:
        """Judge one log step's already-fetched scalars; never raises —
        the loop acts on the verdict (ABORT -> raise GuardAbortError)."""
        if not self.options.enabled:
            return GuardVerdict.OK
        self._checks += 1
        loss = scalars.get("loss")
        grad_norm = scalars.get("grad_norm")
        # The device-side cumulative skip counter rides in as a metric.
        if "guard_skips_cum" in scalars:
            self._device_skips = float(scalars["guard_skips_cum"])
        reason = self._classify(loss, grad_norm)
        if not reason:
            self._consecutive_bad = 0
            self._healthy_checks += 1
            self._last_good_step = step
            if loss is not None and math.isfinite(loss):
                beta = self.options.spike_ema_beta
                self._ema = (
                    loss
                    if self._ema is None
                    else beta * self._ema + (1.0 - beta) * loss
                )
            return GuardVerdict.OK
        self._bad_checks += 1
        self._consecutive_bad += 1
        self._last_reason = reason
        if self._consecutive_bad <= self.options.skip_budget:
            return GuardVerdict.SKIP
        if self._rollbacks >= self.options.rollback_budget:
            return GuardVerdict.ABORT
        return GuardVerdict.ROLLBACK

    def notify_rollback(self, restored_step: int) -> None:
        """The loop performed a rollback: reset the ladder for the fresh
        stream (the EMA baseline no longer describes the restored regime)."""
        self._rollbacks += 1
        self._consecutive_bad = 0
        self._healthy_checks = 0
        self._ema = None
        self._last_good_step = restored_step

    # ------------------------------------------------------------ reporting

    @property
    def rollbacks(self) -> int:
        return self._rollbacks

    @property
    def last_reason(self) -> str:
        return self._last_reason

    @property
    def last_good_step(self) -> Optional[int]:
        return self._last_good_step

    def counters(self, prefix: str = "guard/") -> Dict[str, float]:
        """Flat scalars for the metric writer / Prometheus / recorder —
        rendered as ``rt1_train_guard_*`` by the train scrape listener."""
        return {
            f"{prefix}checks_total": float(self._checks),
            f"{prefix}bad_checks_total": float(self._bad_checks),
            f"{prefix}nonfinite_total": float(self._nonfinite),
            f"{prefix}spikes_total": float(self._spikes),
            f"{prefix}grad_norm_trips_total": float(self._grad_norm_trips),
            f"{prefix}rollbacks_total": float(self._rollbacks),
            f"{prefix}device_skips_total": float(self._device_skips),
            f"{prefix}consecutive_bad": float(self._consecutive_bad),
        }
