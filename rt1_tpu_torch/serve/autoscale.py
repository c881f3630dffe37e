"""Elastic-fleet autoscaling policy: signals in, scale decisions out.

The port's copy of `rt1_tpu/serve/autoscale.py` (the port imports nothing of the JAX
package); it keeps the JAX module's names, wire format and behaviour.

The FleetSupervisor (`serve/fleet.py`) runs a fixed N replicas; production
traffic is diurnal and bursty, so a fixed fleet either wastes
replica-seconds at trough or blows p99 at peak. This module is the control
brain the supervisor consults once per autoscale tick: a pure, clock-free
decision function over router-observed signals —

* **occupancy** — sessions active in the recent window over the ready
  fleet's session slots (the router tracks last-act times; a session that
  stopped talking stops counting, unlike the raw affinity-map size);
* **queue pressure** — requests currently in flight through the router
  per slot (the router-side analogue of replica queue depth);
* **shed pressure** — admission-control rejections since the last tick
  (a router that is 429ing is a router that wants more capacity);
* **SLO burn** — the ledger's TIME-windowed error-budget burn
  (`SLOLedger.windowed_burn`, `rt1_tpu/obs/slo.py`): availability
  degradation is a scale-up signal even before occupancy saturates. The
  window is `burn_window_s` of wall clock, not a request count, so a
  post-incident quiet period decays the signal by itself — the old
  request-indexed rolling burn froze at its peak with no follow-on
  traffic, which is why pressure used to be activity-gated.

Decisions are hysteretic and asymmetric by design: scale **up fast**
(`up_sustain_ticks` consecutive pressure ticks, short cooldown — a spike
costs p99 every second it is under-served) and **down slow**
(`down_sustain_ticks` consecutive idle ticks — reclaiming capacity
during a lull that turns out to be a breather between bursts is how
autoscalers oscillate). One boot at a time: while a spawned replica is
still warming (STARTING), neither direction acts, so a slow AOT compile
cannot cause a thundering herd of boots. The gate is deliberately keyed
on booting replicas only — a lingering NOTREADY replica (alive HTTP,
/readyz 503 forever) must not wedge the autoscaler, so decisions, both
directions, proceed around it.

The actual spawn/drain/reap mechanics stay in `serve/fleet.py`; this
module is deliberately mechanism-free (stdlib only, no HTTP, no
subprocess) so the decision logic is unit-testable with fabricated
signals and stays importable in the clu/TF-free router process
(`tests/test_obs_imports.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """The elastic-fleet contract: bounds, thresholds, hysteresis.

    ``min_replicas`` is the pinned base tier (never reclaimed — it serves
    as the full-precision parity canary in a dtype-tiered fleet);
    ``max_replicas`` caps surge capacity. Occupancy thresholds are in
    sessions-per-slot (1.0 = every ready slot holds an active session).
    Sustain tick counts implement the fast-up/slow-down asymmetry;
    cooldowns keep consecutive events apart so a boot (or a drain) can
    land before the next decision.
    """

    min_replicas: int = 1
    max_replicas: int = 1
    scale_up_occupancy: float = 0.75
    scale_down_occupancy: float = 0.30
    up_sustain_ticks: int = 2
    down_sustain_ticks: int = 6
    up_cooldown_ticks: int = 2
    down_cooldown_ticks: int = 4
    # Time-windowed error-budget burn at/above this is scale-up pressure
    # even at low occupancy (slow replicas, not just full ones). 0
    # disables.
    burn_pressure: float = 2.0
    # Wall-clock window (seconds) the burn signal is computed over — the
    # supervisor passes this to `SLOLedger.windowed_burn` each tick.
    burn_window_s: float = 60.0
    # Window (seconds) a session counts as active after its last act —
    # consumed by the router's occupancy signal, carried here so the
    # whole policy travels as one object.
    active_window_s: float = 5.0

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {self.min_replicas}"
            )
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"max_replicas ({self.max_replicas}) < min_replicas "
                f"({self.min_replicas})"
            )
        if self.scale_down_occupancy >= self.scale_up_occupancy:
            raise ValueError(
                "scale_down_occupancy must be strictly below "
                f"scale_up_occupancy, got {self.scale_down_occupancy} >= "
                f"{self.scale_up_occupancy} (no hysteresis band)"
            )
        if self.up_sustain_ticks < 1 or self.down_sustain_ticks < 1:
            raise ValueError("sustain tick counts must be >= 1")


@dataclasses.dataclass(frozen=True)
class FleetSignals:
    """One tick's router-observed state (all counts, no clocks)."""

    replicas_total: int  # live replicas incl. still-warming boots
    replicas_ready: int  # replicas currently routable
    active_sessions: int  # sessions that acted inside the active window
    session_slots: int  # replicas_ready * per-replica max_sessions
    inflight: int = 0  # requests mid-route through the router right now
    shed_delta: int = 0  # OVERLOAD admission sheds since the previous tick
    # SLO error-budget burn over the policy's `burn_window_s` of wall
    # clock (`SLOLedger.windowed_burn`) — decays on its own when traffic
    # stops, unlike the request-indexed rolling gauge.
    rolling_burn: float = 0.0
    # Replicas spawned but never yet ready (state STARTING) — the
    # one-boot-at-a-time gate keys on THIS, not on total != ready: a
    # replica that is alive but persistently 503 (wedged warmup, failed
    # reload) is NOTREADY, and gating on it would disable autoscaling —
    # including scale-up under overload — for as long as it lingers.
    replicas_booting: int = 0

    @property
    def occupancy(self) -> float:
        """Active sessions per ready slot; saturated (inf) when traffic
        exists but no slot does — maximal pressure, not a crash."""
        if self.session_slots > 0:
            return self.active_sessions / self.session_slots
        return float("inf") if self.active_sessions > 0 else 0.0

    @property
    def inflight_per_slot(self) -> float:
        if self.session_slots > 0:
            return self.inflight / self.session_slots
        return float("inf") if self.inflight > 0 else 0.0


@dataclasses.dataclass(frozen=True)
class ScaleDecision:
    direction: str  # "up" | "down"
    reason: str  # human-readable, recorded in the scale-event log


class Autoscaler:
    """Hysteretic decision state over a stream of `FleetSignals`.

    ``decide(signals)`` once per tick; returns a `ScaleDecision` or None.
    The caller owns the mechanism (spawn / drain+reap) and the tick clock.
    """

    def __init__(self, policy: AutoscalePolicy):
        self.policy = policy
        self._up_streak = 0
        self._down_streak = 0
        self._cooldown = 0

    # ------------------------------------------------------------- signals

    def _pressure_reason(self, s: FleetSignals) -> Optional[str]:
        p = self.policy
        if s.occupancy >= p.scale_up_occupancy:
            return (
                f"occupancy {s.occupancy:.2f} >= {p.scale_up_occupancy:.2f}"
            )
        if s.inflight_per_slot >= p.scale_up_occupancy:
            return (
                f"inflight/slot {s.inflight_per_slot:.2f} >= "
                f"{p.scale_up_occupancy:.2f}"
            )
        if s.shed_delta > 0:
            return f"admission shed {s.shed_delta} request(s) last tick"
        if p.burn_pressure > 0 and s.rolling_burn >= p.burn_pressure:
            # No activity gate: the burn signal is time-windowed
            # (`SLOLedger.windowed_burn`), so a shed/restart burst with no
            # follow-on traffic ages out of the window by itself — the
            # frozen-at-peak pathology the old request-indexed gauge had
            # (and the `active_sessions > 0` guard existed to patch) is
            # gone at the source.
            return (
                f"windowed SLO burn {s.rolling_burn:.2f} >= "
                f"{p.burn_pressure:.2f}"
            )
        return None

    def _is_idle(self, s: FleetSignals) -> bool:
        # Deliberately NOT gated on rolling burn: burn is a trailing
        # window over past requests, and a spike's shed residue would
        # otherwise pin the fleet at peak long after traffic left.
        return (
            s.occupancy <= self.policy.scale_down_occupancy
            and s.shed_delta == 0
            and s.inflight_per_slot <= self.policy.scale_down_occupancy
        )

    # ------------------------------------------------------------ decision

    def decide(self, signals: FleetSignals) -> Optional[ScaleDecision]:
        """One tick: update streaks, emit at most one decision."""
        p = self.policy
        pressure = self._pressure_reason(signals)
        idle = self._is_idle(signals)
        if pressure is not None:
            self._up_streak += 1
            self._down_streak = 0
        elif idle:
            self._down_streak += 1
            self._up_streak = 0
        else:
            # The hysteresis band between the thresholds: hold, and make
            # both sides re-earn their sustain window.
            self._up_streak = 0
            self._down_streak = 0
        if self._cooldown > 0:
            self._cooldown -= 1
            return None
        # One boot in flight at a time: while a spawned replica is still
        # warming, neither direction acts — pressure cannot stack spawns
        # faster than they become routable, and a lull cannot reclaim a
        # replica that never served. Keyed on STARTING boots only (not
        # total != ready), so a lingering NOTREADY replica — alive HTTP,
        # /readyz 503 forever — cannot wedge the autoscaler.
        if signals.replicas_booting > 0:
            return None
        if (
            pressure is not None
            and self._up_streak >= p.up_sustain_ticks
            and signals.replicas_total < p.max_replicas
        ):
            self._up_streak = 0
            self._cooldown = p.up_cooldown_ticks
            return ScaleDecision("up", pressure)
        if (
            idle
            and self._down_streak >= p.down_sustain_ticks
            and signals.replicas_total > p.min_replicas
        ):
            self._down_streak = 0
            self._cooldown = p.down_cooldown_ticks
            return ScaleDecision(
                "down",
                f"occupancy {signals.occupancy:.2f} <= "
                f"{p.scale_down_occupancy:.2f} for "
                f"{p.down_sustain_ticks} ticks",
            )
        return None
