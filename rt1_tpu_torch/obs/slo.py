"""Serving SLO ledger: outcome buckets, availability, error-budget burn.

The port's copy of `rt1_tpu/obs/slo.py` (the port imports nothing of the JAX
package); it keeps the JAX module's names, wire format and behaviour.

The serving fleet already *measures* (latency histograms, restart
counters) but nothing *judges*: after a chaos run, "was the fleet within
its SLO" took a human squinting at four counters. This module is the
serve-side analogue of the train-side `GoodputLedger` — every request
lands in exactly one outcome class, and the ledger turns the stream into
an availability / latency / error-budget story:

* ``ok``         — answered 200, full-fidelity.
* ``migrated``   — answered 200 after the session's window was *live-
                   migrated* to another replica (scale-down drain,
                   rolling reload, rebalance, or a snapshot-ring crash
                   restore). The context window survived intact — the
                   client got token-identical continuity — so this class
                   counts as *good* for the availability SLO and burns
                   no error budget. It stays a separate class (not
                   folded into ``ok``) so post-mortems can see how much
                   traffic rode the durability layer.
* ``restarted``  — answered 200 but the session's context window was
                   reset by a replica death. Honest degradation: the
                   client got an action, not the one a surviving replica
                   would have produced — it burns error budget without
                   counting as an outage.
* ``rejected``   — shed with a retryable 503 (backpressure or a
                   no-ready-replicas window).
* ``failed``     — transport death or any unexpected 4xx/5xx; the class
                   a fleet run's acceptance bar pins at zero.

Definitions (classic SRE error-budget arithmetic):

* availability            = ok / total          (cumulative)
* error budget            = 1 - objective availability (e.g. 0.99 -> 1%)
* error-budget burn       = (1 - availability) / budget; 1.0 means the
  run spent its budget exactly, >1 means burning faster than allowed.
* rolling variants over the last ``window`` requests, so a long healthy
  run does not hide a current incident.
* time-windowed variants (``windowed_burn`` / ``windowed_availability``)
  over the last ``window_s`` SECONDS. The request-indexed rolling view
  freezes at its peak when traffic stops — after a shed burst with no
  follow-on requests, nothing ages the bad outcomes out of the deque,
  which is exactly the pathology the autoscaler had to patch with
  an activity gate. The time-windowed view decays on the wall clock
  instead: a quiet minute after an incident reads as burn -> 0, not
  burn-frozen-at-peak. The clock is injectable for tests.

Latency objectives are judged on *answered* requests (ok + migrated +
restarted):
a shed request has no meaningful latency, and a fleet must not be able
to "fix" its p99 by rejecting slow traffic into the rejected bucket.

Consumed by the fleet router (live ``rt1_serve_slo_*`` gauges on
`/metrics`) and by `scripts/serve_loadgen.py` (client-side ledger +
``slo_summary.json`` artifact merged into the post-mortem by
`scripts/run_report.py`). Stdlib-only — the router process stays
clu/TF-free (`tests/test_obs_imports.py`).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import threading
from typing import Any, Deque, Dict, Optional

from rt1_tpu_torch.obs.quantiles import percentile

OUTCOMES = ("ok", "migrated", "restarted", "rejected", "failed")

#: Classes that count as *good* for the availability SLO: a migrated
#: session answered with its window intact — nothing was lost, so it
#: spends no error budget (unlike ``restarted``, which did lose context).
GOOD_OUTCOMES = ("ok", "migrated")

#: Classes with a meaningful latency sample (answered 200s) — the set
#: latency objectives are judged on.
ANSWERED_OUTCOMES = ("ok", "migrated", "restarted")

SUMMARY_BASENAME = "slo_summary.json"


@dataclasses.dataclass(frozen=True)
class SLOObjectives:
    """The contract a serving fleet is judged against.

    ``availability`` is the fraction of requests that must be ``ok``;
    everything else (restarted/rejected/failed) spends the complementary
    error budget. Latency objectives bound the answered-request p50/p99.
    ``window`` sizes the rolling availability/burn view (requests, not
    seconds — request-indexed windows stay meaningful across load
    levels).
    """

    availability: float = 0.99
    latency_p50_ms: float = 250.0
    latency_p99_ms: float = 2500.0
    window: int = 1024

    def __post_init__(self):
        # 1.0 ("every request must be ok") is a legal, if brutal,
        # objective: the budget is zero and any non-ok burns it
        # infinitely-fast — `_burn` reports 0.0 on a clean run and the
        # availability verdict still judges correctly.
        if not 0.0 < self.availability <= 1.0:
            raise ValueError(
                f"availability objective must be in (0, 1], got "
                f"{self.availability}"
            )
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")

    @property
    def error_budget(self) -> float:
        return 1.0 - self.availability

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class SLOLedger:
    """Thread-safe request-outcome ledger with rolling burn-rate view.

    ``observe(outcome, latency_s)`` from any handler thread; ``gauges()``
    for the flat `/metrics` merge; ``summary()`` / ``write_summary()``
    for the post-mortem artifact.
    """

    #: Retention cap for the timestamped outcome deque: the widest window
    #: `windowed_burn` can be asked about. 15 minutes covers every
    #: fast/slow multi-burn-rate pair the alert plane ships by default.
    MAX_WINDOW_S = 900.0

    def __init__(
        self,
        objectives: Optional[SLOObjectives] = None,
        clock=None,
        max_window_s: Optional[float] = None,
    ):
        import time as _time

        self.objectives = objectives or SLOObjectives()
        self._clock = clock if clock is not None else _time.monotonic
        self.max_window_s = float(
            max_window_s if max_window_s is not None else self.MAX_WINDOW_S
        )
        if self.max_window_s <= 0:
            raise ValueError(
                f"max_window_s must be positive, got {self.max_window_s}"
            )
        self._lock = threading.Lock()
        self._counts = {k: 0 for k in OUTCOMES}
        # Rolling good/bad flags (1 = ok) for the burn-rate window.
        self._rolling_good: Deque[int] = collections.deque(
            maxlen=self.objectives.window
        )
        # Timestamped (t, good) outcomes for the TIME-windowed burn view.
        # Evicted by age (> max_window_s) on observe and on read, and by
        # point count as a backstop, so a traffic spike cannot grow the
        # deque without bound.
        self._timed_good: Deque[tuple] = collections.deque(
            maxlen=max(self.objectives.window * 8, 4096)
        )
        # Bounded per-class latency reservoirs (most recent `window`
        # samples): percentiles over the recent past, not a week-old mix.
        self._latencies: Dict[str, Deque[float]] = {
            k: collections.deque(maxlen=self.objectives.window)
            for k in OUTCOMES
        }

    # ------------------------------------------------------------ recording

    def observe(self, outcome: str, latency_s: float = 0.0) -> None:
        if outcome not in self._counts:
            raise ValueError(
                f"unknown outcome {outcome!r}; expected one of {OUTCOMES}"
            )
        now = self._clock()
        with self._lock:
            good = 1 if outcome in GOOD_OUTCOMES else 0
            self._counts[outcome] += 1
            self._rolling_good.append(good)
            self._timed_good.append((now, good))
            self._evict_timed_locked(now)
            self._latencies[outcome].append(float(latency_s))

    def _evict_timed_locked(self, now: float) -> None:
        cutoff = now - self.max_window_s
        while self._timed_good and self._timed_good[0][0] < cutoff:
            self._timed_good.popleft()

    # ------------------------------------------------------------ reporting

    @staticmethod
    def _burn(availability: float, budget: float) -> float:
        return (1.0 - availability) / budget if budget > 0 else 0.0

    def _answered_sorted(self) -> list:
        return sorted(
            sample
            for klass in ANSWERED_OUTCOMES
            for sample in self._latencies[klass]
        )

    # ------------------------------------------------- time-windowed view

    def windowed_counts(
        self, window_s: float, now: Optional[float] = None
    ) -> Dict[str, int]:
        """{"total": n, "good": n} over the trailing `window_s` seconds."""
        if window_s <= 0:
            raise ValueError(f"window_s must be positive, got {window_s}")
        if now is None:
            now = self._clock()
        cutoff = now - min(window_s, self.max_window_s)
        with self._lock:
            self._evict_timed_locked(now)
            total = good = 0
            for t, g in reversed(self._timed_good):
                if t < cutoff:
                    break
                total += 1
                good += g
        return {"total": total, "good": good}

    def windowed_availability(
        self, window_s: float, now: Optional[float] = None
    ) -> float:
        """good-fraction (ok + migrated) over the trailing `window_s`
        seconds; 1.0 when the window holds no requests (no traffic
        spends no budget)."""
        counts = self.windowed_counts(window_s, now=now)
        if not counts["total"]:
            return 1.0
        return counts["good"] / counts["total"]

    def windowed_burn(
        self, window_s: float, now: Optional[float] = None
    ) -> float:
        """Error-budget burn over the trailing `window_s` SECONDS — the
        signal the autoscaler and the multi-window burn alerts consume.
        Unlike ``slo_error_budget_burn_rolling`` (request-indexed), this
        decays on the wall clock: a post-incident quiet period ages the
        bad outcomes out of the window and the burn falls back to 0
        instead of freezing at its peak."""
        return self._burn(
            self.windowed_availability(window_s, now=now),
            self.objectives.error_budget,
        )

    def gauges(self) -> Dict[str, float]:
        """Flat ``slo_*`` gauges for the `/metrics` merge (the serve
        snapshot prefixes them to ``rt1_serve_slo_*`` in exposition)."""
        with self._lock:
            return self._gauges_locked()

    def _gauges_locked(self) -> Dict[str, float]:
        """Gauge computation proper; caller holds ``self._lock``."""
        obj = self.objectives
        total = sum(self._counts.values())
        ok = self._counts["ok"]
        good = sum(self._counts[k] for k in GOOD_OUTCOMES)
        availability = good / total if total else 1.0
        rolling = (
            sum(self._rolling_good) / len(self._rolling_good)
            if self._rolling_good
            else 1.0
        )
        answered = self._answered_sorted()
        p50_ms = percentile(answered, 0.50) * 1e3
        p99_ms = percentile(answered, 0.99) * 1e3
        return {
            "slo_requests_total": float(total),
            "slo_requests_ok": float(ok),
            "slo_requests_migrated": float(self._counts["migrated"]),
            "slo_requests_restarted": float(self._counts["restarted"]),
            "slo_requests_rejected": float(self._counts["rejected"]),
            "slo_requests_failed": float(self._counts["failed"]),
            "slo_availability": availability,
            "slo_availability_rolling": rolling,
            "slo_error_budget_burn": self._burn(
                availability, obj.error_budget
            ),
            "slo_error_budget_burn_rolling": self._burn(
                rolling, obj.error_budget
            ),
            "slo_latency_p50_ms": p50_ms,
            "slo_latency_p99_ms": p99_ms,
            "slo_objective_availability": obj.availability,
            "slo_objective_latency_p99_ms": obj.latency_p99_ms,
            "slo_availability_ok": float(availability >= obj.availability),
            "slo_latency_ok": float(
                p50_ms <= obj.latency_p50_ms
                and p99_ms <= obj.latency_p99_ms
            ),
        }

    def summary(self) -> Dict[str, Any]:
        """The full judgement: objectives, per-class counts + latency
        percentiles, availability, burn, and the met/violated verdicts —
        the ``slo_summary.json`` payload. One lock hold end to end, so
        the gauge half and the by-class half are cut from the same
        request count (the per-class burns must sum to the total burn
        even while traffic races this call)."""
        obj = self.objectives
        with self._lock:
            gauges = self._gauges_locked()
            total = sum(self._counts.values())
            by_class = {}
            for klass in OUTCOMES:
                lats = sorted(self._latencies[klass])
                entry = {
                    "count": self._counts[klass],
                    "p50_ms": round(percentile(lats, 0.50) * 1e3, 3),
                    "p99_ms": round(percentile(lats, 0.99) * 1e3, 3),
                }
                if klass not in GOOD_OUTCOMES:
                    # This class's share of the error budget: its bad
                    # fraction over the budget. The non-good entries sum
                    # to the total burn, so "who spent the budget" is
                    # read straight off the summary. Good classes (ok,
                    # migrated) carry no burn key at all.
                    entry["error_budget_burn"] = self._burn(
                        1.0 - (self._counts[klass] / total if total else 0.0),
                        obj.error_budget,
                    )
                by_class[klass] = entry
        availability_ok = bool(gauges["slo_availability_ok"])
        latency_ok = bool(gauges["slo_latency_ok"])
        return {
            "objectives": self.objectives.as_dict(),
            "requests_total": int(gauges["slo_requests_total"]),
            "by_class": by_class,
            "availability": gauges["slo_availability"],
            "availability_rolling": gauges["slo_availability_rolling"],
            "error_budget_burn": gauges["slo_error_budget_burn"],
            "error_budget_burn_rolling": gauges[
                "slo_error_budget_burn_rolling"
            ],
            "latency_p50_ms": round(gauges["slo_latency_p50_ms"], 3),
            "latency_p99_ms": round(gauges["slo_latency_p99_ms"], 3),
            "availability_within_objective": availability_ok,
            "latency_within_objective": latency_ok,
            "slo_met": availability_ok and latency_ok,
        }

    def write_summary(self, path: str) -> str:
        """Write ``summary()`` as JSON (atomic rename); returns the path."""
        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.summary(), f, indent=2)
        os.replace(tmp, path)
        return path


def read_summary(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)
