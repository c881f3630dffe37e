"""Canary judgement: per-replica burn signals in, hold/promote/rollback out.

The port's copy of `rt1_tpu/deploy/decision.py` (the port imports nothing of
the JAX package); it keeps the JAX module's names and behaviour.

The deploy controller must answer one question every watch tick: is the
canary replica burning error budget faster than the incumbent fleet, or
has it served cleanly long enough to trust fleet-wide? This module is
that answer as a pure, clock-free decision function — the same shape as
`serve/autoscale.py`'s policy brain, for the same reason: the mechanics
(reload, demote, re-home) live in the controller, the *judgement* is
unit-testable with fabricated signals and stays importable in the
torch-free supervisor process.

Hysteresis, both directions:

* **rollback** needs `breach_ticks` CONSECUTIVE breach ticks — one bad
  scrape (a p99 blip, a single failed request in a tiny window) must
  not demote a healthy candidate.
* **promote** needs `clean_window_ticks` CONSECUTIVE clean ticks with
  real evidence (`min_canary_requests` served) — a canary that nobody
  talked to has proven nothing, so low-traffic ticks hold without
  advancing the clean streak.

A breach is *relative*: the canary's rolling burn must clear the
absolute threshold AND strictly exceed the incumbent fleet's — a
fleet-wide incident (dependency down, host thrash) burns every replica
alike and must not scapegoat the candidate that happened to be canary.
A canary that stops being routable (died, wedged) is a breach outright:
whatever killed it, the candidate failed to serve.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class CanaryPolicy:
    """The burn-window contract a canary is judged against.

    ``burn_threshold`` is in rolling error-budget-burn units (1.0 =
    spending budget exactly at the objective rate; the autoscaler's
    pressure default is 2.0). ``breach_ticks`` / ``clean_window_ticks``
    are consecutive watch ticks (hysteresis); ``min_canary_requests`` is
    the evidence floor below which a clean tick proves nothing.
    """

    burn_threshold: float = 2.0
    breach_ticks: int = 2
    clean_window_ticks: int = 5
    min_canary_requests: int = 8
    canary_weight: float = 0.25

    def __post_init__(self):
        if self.burn_threshold <= 0:
            raise ValueError(
                f"burn_threshold must be > 0, got {self.burn_threshold}"
            )
        if self.breach_ticks < 1 or self.clean_window_ticks < 1:
            raise ValueError(
                f"breach_ticks/clean_window_ticks must be >= 1, got "
                f"{self.breach_ticks}/{self.clean_window_ticks}"
            )
        if self.min_canary_requests < 0:
            raise ValueError(
                f"min_canary_requests must be >= 0, got "
                f"{self.min_canary_requests}"
            )
        if not 0.0 < self.canary_weight <= 1.0:
            raise ValueError(
                f"canary_weight must be in (0, 1], got {self.canary_weight}"
            )

    def as_dict(self):
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class CanarySignals:
    """One watch tick's router-observed canary state (no clocks).

    ``canary_burn`` / ``fleet_burn`` are rolling error-budget burns from
    the router's per-replica SLO attribution: the canary's own ledger vs.
    the worst incumbent replica's (the relative-breach reference).
    ``canary_requests`` is the canary ledger's total since it was loaded;
    ``canary_ready`` is the router's view of the replica state.
    """

    canary_requests: int
    canary_burn: float
    fleet_burn: float = 0.0
    canary_ready: bool = True


class CanaryJudge:
    """Streak accumulator over per-tick signals -> hold/promote/rollback.

    One judge per canary episode: the controller constructs a fresh one
    (or calls `reset()`) when a candidate lands on the canary replica,
    then feeds it every watch tick. Decisions are sticky only through
    the streak counters — the judge never remembers a verdict."""

    def __init__(self, policy: Optional[CanaryPolicy] = None):
        self.policy = policy or CanaryPolicy()
        self.breach_streak = 0
        self.clean_streak = 0

    def reset(self) -> None:
        self.breach_streak = 0
        self.clean_streak = 0

    def is_breach(self, signals: CanarySignals) -> bool:
        """One tick's breach predicate: canary unroutable, or its burn
        clears the threshold while STRICTLY exceeding the incumbent
        fleet's (a fleet-wide incident never scapegoats the canary)."""
        if not signals.canary_ready:
            return True
        return (
            signals.canary_burn >= self.policy.burn_threshold
            and signals.canary_burn > signals.fleet_burn
        )

    def decide(self, signals: CanarySignals) -> str:
        """Advance the streaks with one tick's signals and judge.

        Returns ``"rollback"`` | ``"promote"`` | ``"hold"``. Breach is
        checked before the evidence floor — a canary that is already
        burning needs no more requests to be condemned — while a clean
        low-traffic tick holds WITHOUT advancing either streak (no
        evidence, no verdict movement)."""
        if self.is_breach(signals):
            self.breach_streak += 1
            self.clean_streak = 0
            if self.breach_streak >= self.policy.breach_ticks:
                return "rollback"
            return "hold"
        if signals.canary_requests < self.policy.min_canary_requests:
            return "hold"
        self.clean_streak += 1
        self.breach_streak = 0
        if self.clean_streak >= self.policy.clean_window_ticks:
            return "promote"
        return "hold"
