"""Declarative alerting over TSDB windows: pending -> firing -> resolved.

The port's copy of `rt1_tpu/obs/alerts.py` (the port imports nothing of the
JAX package); it keeps the JAX module's names, wire format and behaviour.

The TSDB (`obs/tsdb.py`) remembers; this module judges. An `AlertRule`
is a named condition evaluated against the store each collector cycle —
the condition returns the *violating instances* (label-set, value pairs),
and the `AlertManager` runs the standard alerting state machine over
them:

* **pending** — the condition is true but has not yet held for
  ``for_duration_s``. A blip that clears while pending is dropped
  silently (no event, the instance re-arms) — exactly the debounce
  `for:` provides in Prometheus Alertmanager rules.
* **firing** — the condition held for the full duration. One ``firing``
  event is recorded into history and ``on_fire`` is called (the fleet
  wires this into the flight-recorder/exemplar stream).
* **resolved** — a firing instance whose condition cleared. One
  ``resolved`` event, ``on_resolve`` fires, and the instance re-arms
  from scratch (a relapse must re-earn its ``for_duration_s``).

``default_ruleset()`` ships the signals this repo already knows matter,
headlined by **multi-window multi-burn-rate** SLO alerting (the
Google-SRE-workbook shape): burn is recomputed from TSDB *counter
deltas* of ``rt1_serve_slo_requests_total`` / ``_ok`` over two window
pairs — a fast pair that pages on a cliff within seconds and a slow
pair that warns on a simmer — so the signal is time-indexed end to end
and decays by itself when traffic stops (the request-indexed rolling
gauge froze at its peak, which is why the autoscaler needed an activity
gate until `SLOLedger.windowed_burn` landed).

A rule whose condition raises is *skipped for that pass* — its
instances keep their state (a broken rule must not mass-resolve real
incidents) and ``rule_errors_total`` counts the failure.

Stdlib-only, same import-light contract as the rest of ``obs/`` (the
torch-free router and fleet supervisor import it).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import (
    Any,
    Callable,
    Dict,
    List,
    Optional,
    Sequence,
    Tuple,
)

from rt1_tpu_torch.obs.prometheus import TextExposition
from rt1_tpu_torch.obs.tsdb import TSDB

SEVERITIES = ("page", "warn", "info")

#: A condition inspects the TSDB at `now` and returns the violating
#: instances as (labels, observed_value) pairs — empty list = healthy.
Condition = Callable[[TSDB, float], List[Tuple[Dict[str, str], float]]]


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One named judgement over TSDB history.

    ``labels`` are attached to every instance this rule raises (routing
    metadata: team, layer); ``annotations`` carry the human story
    (summary, runbook hint) and ride into history events verbatim.
    """

    name: str
    condition: Condition
    severity: str = "warn"
    for_duration_s: float = 0.0
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    annotations: Dict[str, str] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not self.name:
            raise ValueError("alert rule needs a name")
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"severity {self.severity!r} not in {SEVERITIES}"
            )
        if self.for_duration_s < 0:
            raise ValueError(
                f"for_duration_s must be >= 0, got {self.for_duration_s}"
            )


def _instance_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class AlertManager:
    """The state machine: `evaluate()` once per collector cycle.

    Thread-safe (the router's `/alerts` handler reads while the
    collector thread evaluates). History is a bounded deque of
    firing/resolved events, oldest first on read — the post-mortem
    timeline a post-mortem reads.
    """

    def __init__(
        self,
        tsdb: TSDB,
        rules: Sequence[AlertRule],
        clock=time.time,
        on_fire: Optional[Callable[[Dict[str, Any]], None]] = None,
        on_resolve: Optional[Callable[[Dict[str, Any]], None]] = None,
        history_capacity: int = 512,
    ):
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names in {names}")
        self.tsdb = tsdb
        self.rules = list(rules)
        self._clock = clock
        self._on_fire = on_fire
        self._on_resolve = on_resolve
        self._lock = threading.Lock()
        # (rule_name, instance_key) -> {"state", "since", "fired_at",
        # "value", "labels"}
        self._instances: Dict[Tuple[str, Tuple], Dict[str, Any]] = {}
        self._history: collections.deque = collections.deque(
            maxlen=int(history_capacity)
        )
        self.evaluations_total = 0
        self.fired_total = 0
        self.resolved_total = 0
        self.rule_errors_total = 0
        self.callback_errors_total = 0

    # ----------------------------------------------------------- evaluation

    def evaluate(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """One pass over every rule; returns the transition events
        (firing/resolved) this pass produced, oldest first."""
        if now is None:
            now = self._clock()
        events: List[Dict[str, Any]] = []
        for rule in self.rules:
            try:
                violations = rule.condition(self.tsdb, now)
            except Exception:  # noqa: BLE001 - a broken rule must not
                # resolve (or fire) anything: freeze its instances.
                with self._lock:
                    self.rule_errors_total += 1
                continue
            events.extend(self._advance(rule, violations, now))
        with self._lock:
            self.evaluations_total += 1
        for event in events:
            cb = (
                self._on_fire
                if event["event"] == "firing"
                else self._on_resolve
            )
            if cb is None:
                continue
            try:
                cb(event)
            except Exception:  # noqa: BLE001 - observability callbacks
                # must never kill the evaluation loop.
                with self._lock:
                    self.callback_errors_total += 1
        return events

    def _advance(
        self,
        rule: AlertRule,
        violations: List[Tuple[Dict[str, str], float]],
        now: float,
    ) -> List[Dict[str, Any]]:
        events: List[Dict[str, Any]] = []
        with self._lock:
            seen = set()
            for labels, value in violations:
                merged = dict(rule.labels)
                merged.update({str(k): str(v) for k, v in labels.items()})
                key = (rule.name, _instance_key(merged))
                seen.add(key)
                inst = self._instances.get(key)
                if inst is None:
                    inst = {
                        "state": "pending",
                        "since": now,
                        "fired_at": None,
                        "labels": merged,
                    }
                    self._instances[key] = inst
                inst["value"] = float(value)
                if (
                    inst["state"] == "pending"
                    and now - inst["since"] >= rule.for_duration_s
                ):
                    inst["state"] = "firing"
                    inst["fired_at"] = now
                    self.fired_total += 1
                    events.append(
                        self._event_locked(rule, inst, "firing", now)
                    )
            # Cleared instances: firing -> resolved (event), pending ->
            # dropped silently (re-arm).
            for key in [
                k
                for k in self._instances
                if k[0] == rule.name and k not in seen
            ]:
                inst = self._instances.pop(key)
                if inst["state"] == "firing":
                    self.resolved_total += 1
                    events.append(
                        self._event_locked(rule, inst, "resolved", now)
                    )
            for event in events:
                self._history.append(event)
        return events

    def _event_locked(
        self, rule: AlertRule, inst: Dict[str, Any], kind: str, now: float
    ) -> Dict[str, Any]:
        event = {
            "t": now,
            "event": kind,
            "alert": rule.name,
            "severity": rule.severity,
            "labels": dict(inst["labels"]),
            "value": inst["value"],
            "annotations": dict(rule.annotations),
        }
        if kind == "resolved" and inst["fired_at"] is not None:
            event["fired_at"] = inst["fired_at"]
            event["duration_s"] = max(0.0, now - inst["fired_at"])
        return event

    # ------------------------------------------------------------ reporting

    def active(self) -> List[Dict[str, Any]]:
        """Every pending/firing instance, firing first, then by name."""
        by_rule = {r.name: r for r in self.rules}
        with self._lock:
            out = [
                {
                    "alert": name,
                    "severity": by_rule[name].severity,
                    "state": inst["state"],
                    "since": inst["since"],
                    "fired_at": inst["fired_at"],
                    "value": inst["value"],
                    "labels": dict(inst["labels"]),
                    "annotations": dict(by_rule[name].annotations),
                }
                for (name, _), inst in self._instances.items()
                if name in by_rule
            ]
        out.sort(
            key=lambda a: (
                a["state"] != "firing",
                a["alert"],
                sorted(a["labels"].items()),
            )
        )
        return out

    def history(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(e) for e in self._history]

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return {
                "evaluations_total": self.evaluations_total,
                "fired_total": self.fired_total,
                "resolved_total": self.resolved_total,
                "rule_errors_total": self.rule_errors_total,
                "callback_errors_total": self.callback_errors_total,
            }

    def status(self) -> Dict[str, Any]:
        """The `/alerts` endpoint payload."""
        return {
            "rules": [
                {
                    "name": r.name,
                    "severity": r.severity,
                    "for_duration_s": r.for_duration_s,
                }
                for r in self.rules
            ],
            "active": self.active(),
            "history": self.history(),
            "counters": self.counters(),
        }

    def prometheus_text(self, prefix: str = "rt1_alert_") -> str:
        """``rt1_alert_*`` families: one labeled sample per active
        instance plus the manager's own lifecycle counters. Appended to
        the fleet exposition when the collector arm is on."""
        active = self.active()
        counters = self.counters()
        exp = TextExposition()
        for state in ("firing", "pending"):
            samples = [
                (
                    dict(
                        {"alert": a["alert"], "severity": a["severity"]},
                        **a["labels"],
                    ),
                    1.0,
                )
                for a in active
                if a["state"] == state
            ]
            if samples:
                exp.family(
                    prefix + state,
                    "gauge",
                    samples,
                    f"Alert instances currently {state}.",
                )
            exp.gauge(
                f"{prefix}{state}_count",
                float(len(samples)),
                f"Number of alert instances currently {state}.",
            )
        exp.gauge(
            prefix + "rules",
            float(len(self.rules)),
            "Alert rules loaded.",
        )
        for key, help_text in (
            ("evaluations_total", "Alert evaluation passes."),
            ("fired_total", "pending->firing transitions."),
            ("resolved_total", "firing->resolved transitions."),
            ("rule_errors_total", "Rule conditions that raised (skipped)."),
            (
                "callback_errors_total",
                "on_fire/on_resolve callbacks that raised.",
            ),
        ):
            exp.counter(prefix + key, float(counters[key]), help_text)
        return exp.render()


# -------------------------------------------------------------- conditions

_OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
    "==": lambda v, t: v == t,
    "!=": lambda v, t: v != t,
}


def threshold_condition(
    family: str,
    agg: str,
    window_s: float,
    op: str,
    threshold: float,
    q: Optional[float] = None,
) -> Condition:
    """Per-instance windowed threshold: every label set stored under
    `family` is judged independently (`replica_up{replica_id="2"}` can
    fire while replica 0 stays green). A series with no data in the
    window is healthy — absence is the collector's problem
    (`rt1_obs_collector_scrape_errors_total`), not a threshold breach."""
    if op not in _OPS:
        raise ValueError(f"unknown op {op!r}; known: {tuple(_OPS)}")
    cmp = _OPS[op]

    def cond(tsdb: TSDB, now: float) -> List[Tuple[Dict[str, str], float]]:
        out = []
        for labels in tsdb.instances(family):
            value = tsdb.query(
                family, agg, window_s, labels=labels, q=q, now=now
            )
            if value is not None and cmp(value, threshold):
                out.append((labels, value))
        return out

    return cond


def _counter_burn(
    tsdb: TSDB,
    window_s: float,
    now: float,
    total_family: str,
    ok_family: str,
    objective_family: str,
    default_objective: float,
) -> Optional[float]:
    """Error-budget burn over `window_s` from TSDB counter deltas:
    ((total_delta - ok_delta) / total_delta) / budget. None when the
    counters have no history yet; 0.0 when the window saw no traffic
    (no requests spend no budget — the time-indexed decay property)."""
    total = tsdb.query(total_family, "increase", window_s, now=now)
    ok = tsdb.query(ok_family, "increase", window_s, now=now)
    if total is None or ok is None:
        return None
    if total <= 0:
        return 0.0
    latest = tsdb.latest(objective_family)
    objective = latest[1] if latest else default_objective
    budget = 1.0 - objective
    if budget <= 0:
        return None
    bad = max(0.0, total - ok)
    return (bad / total) / budget


def slo_burn_condition(
    short_window_s: float,
    long_window_s: float,
    threshold: float,
    total_family: str = "rt1_serve_slo_requests_total",
    ok_family: str = "rt1_serve_slo_requests_ok",
    objective_family: str = "rt1_serve_slo_objective_availability",
    default_objective: float = 0.99,
) -> Condition:
    """Multi-window burn: fires only when the burn computed over BOTH the
    short and the long window is at/above `threshold`. The short window
    gives detection latency (a cliff shows up within one scrape); the
    long window gives persistence (a single bad scrape inside an
    otherwise-healthy hour does not page). The reported value is the
    short-window burn — the current severity."""

    def cond(tsdb: TSDB, now: float) -> List[Tuple[Dict[str, str], float]]:
        burns = [
            _counter_burn(
                tsdb, w, now, total_family, ok_family,
                objective_family, default_objective,
            )
            for w in (short_window_s, long_window_s)
        ]
        if any(b is None or b < threshold for b in burns):
            return []
        return [
            (
                {
                    "window": (
                        f"{short_window_s:g}s/{long_window_s:g}s"
                    )
                },
                burns[0],
            )
        ]

    return cond


def compile_drift_condition(
    compile_family: str = "rt1_serve_replica_compile_count",
    bucket_family: str = "rt1_serve_replica_bucket_count",
) -> Condition:
    """Any replica whose lifetime compile count exceeds its configured
    AOT bucket count — the one-compile-per-bucket pin every serve test
    asserts; a recompile in production means a shape leak."""

    def cond(tsdb: TSDB, now: float) -> List[Tuple[Dict[str, str], float]]:
        out = []
        for labels in tsdb.instances(compile_family):
            compiled = tsdb.latest(compile_family, labels)
            buckets = tsdb.latest(bucket_family, labels)
            if compiled is None or buckets is None or buckets[1] <= 0:
                continue
            if compiled[1] > buckets[1]:
                out.append((labels, compiled[1]))
        return out

    return cond


def flapping_condition(
    window_s: float,
    min_events: float,
    family: str = "rt1_serve_autoscale_scale_events_total",
) -> Condition:
    """Autoscaler thrash: BOTH an up and a down scale event inside the
    window, and at least `min_events` total — one direction alone is the
    autoscaler doing its job; alternation is oscillation."""

    def cond(tsdb: TSDB, now: float) -> List[Tuple[Dict[str, str], float]]:
        per_direction: Dict[str, float] = {}
        for labels in tsdb.instances(family):
            rise = tsdb.query(
                family, "increase", window_s, labels=labels, now=now
            )
            if rise:
                direction = labels.get("direction", "?")
                per_direction[direction] = (
                    per_direction.get(direction, 0.0) + rise
                )
        total = sum(per_direction.values())
        if (
            per_direction.get("up", 0.0) > 0
            and per_direction.get("down", 0.0) > 0
            and total >= min_events
        ):
            return [({}, total)]
        return []

    return cond


def capture_pressure_condition(
    window_s: float,
    pruned_threshold: float,
    errors_family: str = "rt1_serve_replica_capture_write_errors_total",
    pruned_family: str = "rt1_serve_replica_capture_pruned_total",
) -> Condition:
    """Flywheel capture sink distress, per replica: any episode write
    error in the window (disk full / permission loss), or the disk ring
    pruning faster than `pruned_threshold` episodes per window (capture
    outrunning its budget — history is being eaten as fast as it is
    written)."""

    def cond(tsdb: TSDB, now: float) -> List[Tuple[Dict[str, str], float]]:
        out = []
        for labels in tsdb.instances(errors_family):
            rise = tsdb.query(
                errors_family, "increase", window_s, labels=labels, now=now
            )
            if rise:
                out.append((labels, rise))
        flagged = {_instance_key(lb) for lb, _ in out}
        for labels in tsdb.instances(pruned_family):
            if _instance_key(labels) in flagged:
                continue
            rise = tsdb.query(
                pruned_family, "increase", window_s, labels=labels, now=now
            )
            if rise is not None and rise >= pruned_threshold:
                out.append((labels, rise))
        return out

    return cond


# ---------------------------------------------------------- default rules


def default_ruleset(
    burn_fast_windows: Tuple[float, float] = (60.0, 300.0),
    burn_fast_threshold: float = 8.0,
    burn_slow_windows: Tuple[float, float] = (300.0, 900.0),
    burn_slow_threshold: float = 2.0,
    stall_pct_threshold: float = 50.0,
    stall_window_s: float = 300.0,
    flap_window_s: float = 600.0,
    flap_events: float = 4.0,
    rebuild_window_s: float = 120.0,
    rebuild_steps: float = 50.0,
    capture_window_s: float = 300.0,
    capture_pruned_threshold: float = 20.0,
    canary_burn_threshold: float = 1.0,
    migration_window_s: float = 300.0,
    migration_failures: float = 3.0,
    for_duration_s: float = 0.0,
) -> List[AlertRule]:
    """The signals this repo already knows matter, as rules.

    Window/threshold defaults are production-shaped (minutes); the chaos
    proof and the stub-fleet tests pass seconds-scale values instead —
    the state machine is identical, only the clock arithmetic scales.
    ``for_duration_s`` applies to the non-burn rules (the burn pair's
    long window already provides persistence).
    """
    return [
        AlertRule(
            name="SLOBurnRateFast",
            severity="page",
            condition=slo_burn_condition(
                burn_fast_windows[0],
                burn_fast_windows[1],
                burn_fast_threshold,
            ),
            annotations={
                "summary": (
                    "Error budget burning at >= "
                    f"{burn_fast_threshold:g}x over both fast windows "
                    "— at this rate the budget is gone within hours."
                ),
            },
        ),
        AlertRule(
            name="SLOBurnRateSlow",
            severity="warn",
            condition=slo_burn_condition(
                burn_slow_windows[0],
                burn_slow_windows[1],
                burn_slow_threshold,
            ),
            annotations={
                "summary": (
                    "Sustained error-budget burn >= "
                    f"{burn_slow_threshold:g}x over both slow windows."
                ),
            },
        ),
        AlertRule(
            name="ReplicaDown",
            severity="page",
            for_duration_s=for_duration_s,
            condition=threshold_condition(
                "rt1_serve_replica_up", "latest", 60.0, "==", 0.0
            ),
            annotations={
                "summary": (
                    "Replica /metrics stopped answering the router "
                    "fan-out probe."
                ),
            },
        ),
        AlertRule(
            name="CompileCountDrift",
            severity="page",
            condition=compile_drift_condition(),
            annotations={
                "summary": (
                    "Replica recompiled past its AOT bucket pin — a "
                    "shape leaked through the bucketing contract."
                ),
            },
        ),
        AlertRule(
            name="FeederStall",
            severity="warn",
            for_duration_s=for_duration_s,
            condition=threshold_condition(
                "rt1_train_stall_pct",
                "avg",
                stall_window_s,
                ">=",
                stall_pct_threshold,
            ),
            annotations={
                "summary": (
                    "Train step input-stall share over "
                    f"{stall_pct_threshold:g}% — the feeder is not "
                    "keeping the device fed."
                ),
            },
        ),
        AlertRule(
            name="AutoscalerFlapping",
            severity="warn",
            condition=flapping_condition(flap_window_s, flap_events),
            annotations={
                "summary": (
                    "Fleet scaled both up and down inside the window — "
                    "hysteresis band too narrow for this traffic."
                ),
            },
        ),
        AlertRule(
            name="CacheRebuildStorm",
            severity="warn",
            condition=threshold_condition(
                "rt1_serve_replica_cache_rebuild_steps_total",
                "increase",
                rebuild_window_s,
                ">=",
                rebuild_steps,
            ),
            annotations={
                "summary": (
                    "KV-cache full-window rebuilds spiking — sessions "
                    "are paying recompute instead of incremental decode."
                ),
            },
        ),
        AlertRule(
            name="CaptureDiskPressure",
            severity="warn",
            condition=capture_pressure_condition(
                capture_window_s, capture_pruned_threshold
            ),
            annotations={
                "summary": (
                    "Flywheel capture sink under disk pressure: write "
                    "errors or runaway ring pruning."
                ),
            },
        ),
        AlertRule(
            name="MigrationFailureStorm",
            severity="warn",
            condition=threshold_condition(
                "rt1_serve_replica_migration_import_failures_total",
                "increase",
                migration_window_s,
                ">=",
                migration_failures,
            ),
            annotations={
                "summary": (
                    "Session-snapshot imports repeatedly refused or "
                    "failing — live migration is degrading to window "
                    "resets (check checkpoint-generation / engine-mode "
                    "skew across the fleet)."
                ),
            },
        ),
        AlertRule(
            name="CanarySLOBreach",
            severity="page",
            condition=threshold_condition(
                "rt1_deploy_canary_burn",
                "latest",
                60.0,
                ">=",
                canary_burn_threshold,
            ),
            annotations={
                "summary": (
                    "Canary replica burning error budget past the "
                    "rollback threshold — expect the promotion "
                    "controller to demote it."
                ),
            },
        ),
    ]
