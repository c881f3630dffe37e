"""Serving-side metrics: latency histograms, batch occupancy, throughput,
and the router's fleet counters (the port's copy of
`rt1_tpu/serve/metrics.py`, which it does not import).

A JSON `snapshot()` backs `GET /metrics`; `prometheus_text()` renders the
same numbers as Prometheus text (`obs/prometheus.py`); `write_to`
publishes them through a writer with `write_scalars(step, scalars)`.

Counters are lock-guarded: requests land from many HTTP handler threads
while batches complete on the batcher's executor threads.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Any, Dict, Optional

from rt1_tpu_torch.obs.quantiles import bucket_quantile

#: Task label for served requests whose client declared no `task` tag —
#: keeps the per-task request counters summing to the served total.
TASK_UNLABELED = "unlabeled"

# Geometric-ish bucket upper bounds in seconds, 0.1 ms .. 30 s. Wide enough
# for a tiny-CPU smoke model (sub-ms) and a cold remote-TPU dispatch alike.
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


class LatencyHistogram:
    """Fixed-bucket histogram with conservative (upper-bound) quantiles."""

    def __init__(self, buckets=DEFAULT_BUCKETS):
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)  # +1: overflow bucket
        self.count = 0
        self.total = 0.0
        self.max = 0.0

    def observe(self, seconds: float) -> None:
        self.counts[bisect.bisect_left(self.buckets, seconds)] += 1
        self.count += 1
        self.total += seconds
        if seconds > self.max:
            self.max = seconds

    def quantile(self, q: float) -> float:
        """Upper bound of the bucket containing the q-quantile (0 if empty).
        The overflow bucket reports the observed max. Shared estimator:
        `rt1_tpu/obs/quantiles.py` (loadgen and the SLO ledger use the
        exact-sample twin from the same module)."""
        return bucket_quantile(
            self.buckets, self.counts, self.count, self.max, q
        )

    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def cumulative_counts(self):
        """Prometheus-style cumulative buckets: ascending (upper_bound,
        cumulative_count) pairs ending with (inf, count). The per-bucket
        `counts` stay as-is; this is the exposition view of them."""
        out = []
        cumulative = 0
        for upper, c in zip(self.buckets, self.counts):
            cumulative += c
            out.append((upper, cumulative))
        out.append((float("inf"), self.count))
        return out


class ServeMetrics:
    """Aggregates the serving process's request/batch/session counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self._started = time.monotonic()
        self.requests_total = 0
        self.errors_total = 0
        self.rejected_total = 0
        self.resets_total = 0
        self.reloads_total = 0            # checkpoint hot-swaps served
        self.sessions_restarted_total = 0  # sessions re-homed after a
        #                                    replica death (router-side)
        self.sessions_migrated_total = 0   # sessions whose window was
        #                                    live-migrated intact (drain,
        #                                    rolling reload, rebalance,
        #                                    snapshot restore; router-side)
        self.batches_total = 0
        self.occupancy_sum = 0
        self.occupancy_max = 0
        self.queue_depth = 0
        # Continuous-batching / double-buffer path: batches
        # currently dispatched-but-uncollected, requests that joined a
        # batch formed while another was already in flight, and the
        # per-bucket occupancy histogram (bucket size -> batch count +
        # summed occupancy, so mean fill per bucket is derivable).
        self.batches_in_flight = 0
        self.max_batches_in_flight = 0
        self.joined_mid_cycle_total = 0
        self.bucket_batches: Dict[int, int] = {}
        self.bucket_occupancy_sum: Dict[int, int] = {}
        # Per-task quality-observability labels: served /act
        # requests and new sessions bucketed by the client-declared `task`
        # tag (the same tag the flywheel capture stamps into episodes).
        # Requests without one land in TASK_UNLABELED so the per-task
        # counters always sum to the served-request total.
        self.task_requests_total: Dict[str, int] = {}
        self.task_sessions_total: Dict[str, int] = {}
        # Elastic fleet: scale events by direction, admission
        # sheds by reason, live replicas per dtype capacity tier, and the
        # current fleet size. Router-level state — replicas never set
        # these, so their snapshots (and every pre-elastic dashboard)
        # are byte-identical. `autoscale_replicas` None = autoscaler off,
        # the key is absent from the snapshot.
        self.autoscale_scale_events: Dict[str, int] = {}
        self.autoscale_shed: Dict[str, int] = {}
        self.autoscale_tier_replicas: Dict[str, int] = {}
        self.autoscale_replicas: Optional[int] = None
        self.latency = LatencyHistogram()      # full request wall time
        self.step_latency = LatencyHistogram()  # batched device step only

    # ------------------------------------------------------------ recording

    def observe_request(self, seconds: float, ok: bool = True) -> None:
        with self._lock:
            self.requests_total += 1
            if not ok:
                self.errors_total += 1
            self.latency.observe(seconds)

    def observe_rejected(self) -> None:
        with self._lock:
            self.rejected_total += 1

    def observe_reset(self) -> None:
        with self._lock:
            self.resets_total += 1

    def observe_reload(self) -> None:
        """One successful zero-downtime checkpoint hot-swap."""
        with self._lock:
            self.reloads_total += 1

    def observe_session_restart(self) -> None:
        """One session re-homed (and reset) after its replica died."""
        with self._lock:
            self.sessions_restarted_total += 1

    def observe_session_migration(self) -> None:
        """One session's window carried intact to another replica (live
        migration or snapshot-ring restore) — continuity, not a reset."""
        with self._lock:
            self.sessions_migrated_total += 1

    def observe_batch(
        self,
        size: int,
        queued: int = 0,
        in_flight: int = 0,
        joined_mid_cycle: int = 0,
    ) -> None:
        with self._lock:
            self.batches_total += 1
            self.occupancy_sum += size
            self.occupancy_max = max(self.occupancy_max, size)
            self.queue_depth = queued
            self.batches_in_flight = in_flight
            self.max_batches_in_flight = max(
                self.max_batches_in_flight, in_flight
            )
            self.joined_mid_cycle_total += joined_mid_cycle

    def observe_inflight(self, in_flight: int) -> None:
        """A batch completed (or launched outside observe_batch): refresh
        the in-flight gauge."""
        with self._lock:
            self.batches_in_flight = in_flight
            self.max_batches_in_flight = max(
                self.max_batches_in_flight, in_flight
            )

    def observe_task_request(
        self, task: Optional[str], new_session: bool = False
    ) -> None:
        """One successfully served /act under workload tag `task` (None ->
        TASK_UNLABELED); `new_session` marks the step that started a fresh
        session window, so `task_sessions_total` counts sessions, not
        steps. Rendered as the labeled `rt1_serve_task_*{task=...}`
        families and aggregated fleet-wide as
        `rt1_serve_replica_task_*{replica_id=,task=}`."""
        key = task if isinstance(task, str) and task else TASK_UNLABELED
        with self._lock:
            self.task_requests_total[key] = (
                self.task_requests_total.get(key, 0) + 1
            )
            if new_session:
                self.task_sessions_total[key] = (
                    self.task_sessions_total.get(key, 0) + 1
                )

    def observe_scale_event(self, direction: str) -> None:
        """One fleet scale event ('up' | 'down'), rendered as the labeled
        `rt1_serve_autoscale_scale_events_total{direction=}` family."""
        with self._lock:
            self.autoscale_scale_events[direction] = (
                self.autoscale_scale_events.get(direction, 0) + 1
            )

    def observe_shed(self, reason: str) -> None:
        """One request shed by router admission control ('client_rate' |
        'overload'), rendered as `rt1_serve_autoscale_shed_total{reason=}`.
        Counted in addition to `rejected_total` (the outcome class): the
        reason label tells WHY load was dropped, the class tells the SLO
        ledger it was."""
        with self._lock:
            self.autoscale_shed[reason] = (
                self.autoscale_shed.get(reason, 0) + 1
            )

    def shed_total(self, reason: Optional[str] = None) -> int:
        """Total admission sheds, optionally for one reason. The
        autoscaler reads `shed_total("overload")` only: per-client
        token-bucket sheds ('client_rate') are a policy verdict on one
        client, not a capacity shortfall — extra replicas cannot fix a
        rate limit, and counting them as pressure would let a single hot
        client pin the fleet at max."""
        with self._lock:
            if reason is not None:
                return self.autoscale_shed.get(reason, 0)
            return sum(self.autoscale_shed.values())

    def set_autoscale_state(
        self,
        replicas: Optional[int] = None,
        tier_replicas: Optional[Dict[str, int]] = None,
    ) -> None:
        """Refresh the autoscaler's fleet-shape gauges (set wholesale each
        tick: `rt1_serve_autoscale_replicas` and the per-dtype
        `rt1_serve_autoscale_tier_replicas{dtype=}` family)."""
        with self._lock:
            if replicas is not None:
                self.autoscale_replicas = int(replicas)
            if tier_replicas is not None:
                self.autoscale_tier_replicas = {
                    str(k): int(v) for k, v in tier_replicas.items()
                }

    def observe_bucket(self, bucket: int, occupancy: int) -> None:
        """One batch rode the AOT bucket of size `bucket` carrying
        `occupancy` active requests (the per-bucket occupancy histogram)."""
        with self._lock:
            self.bucket_batches[int(bucket)] = (
                self.bucket_batches.get(int(bucket), 0) + 1
            )
            self.bucket_occupancy_sum[int(bucket)] = (
                self.bucket_occupancy_sum.get(int(bucket), 0)
                + int(occupancy)
            )

    def observe_step(self, seconds: float) -> None:
        with self._lock:
            self.step_latency.observe(seconds)

    # ------------------------------------------------------------ reporting

    # Snapshot keys allowed to carry a string instead of a number — the
    # engine's dtype mode rides the snapshot verbatim so the Prometheus
    # renderer can emit it as an info-style labeled family
    # (`rt1_serve_inference_dtype{dtype="int8"} 1`); the port's replica
    # also reports its torch device and compute dtype (JSON only: the
    # renderer skips other strings). Everything else stays strictly
    # numeric (typo'd gauges must fail loudly, not vanish).
    TEXT_GAUGES = frozenset({"inference_dtype", "device", "dtype"})
    # Snapshot keys allowed to carry a {label: count} dict — the engine's
    # KV-cache invalidation counters ride the snapshot as a table so the
    # Prometheus renderer can emit one labeled family
    # (`rt1_serve_cache_invalidations_total{reason="swap"}`), matching the
    # internal labeled families (bucket_batches, task_requests_total).
    DICT_GAUGES = frozenset({"cache_invalidations"})

    @classmethod
    def _coerce_gauge(cls, name: str, value: Any):
        """Validate a caller-supplied gauge: numeric (including numpy/jax
        scalars) coerces to float; anything else raises, naming the gauge —
        a typo'd gauge must fail the caller, not vanish from /metrics."""
        if name in cls.TEXT_GAUGES and isinstance(value, str):
            return value
        if name in cls.DICT_GAUGES and isinstance(value, dict):
            return {str(k): float(v) for k, v in value.items()}
        if isinstance(value, bool):
            return float(value)
        try:
            out = float(value)
        except (TypeError, ValueError) as exc:
            raise ValueError(
                f"gauge {name!r} is not numeric: {value!r} "
                f"({type(value).__name__})"
            ) from exc
        return out

    @staticmethod
    def _bucket_json(hist: LatencyHistogram):
        """JSON encoding of `cumulative_counts`: inf -> '+Inf' (strict JSON
        has no Infinity literal; the Prometheus renderer understands both)."""
        return [
            ["+Inf" if le == float("inf") else le, c]
            for le, c in hist.cumulative_counts()
        ]

    def snapshot(self, **gauges: Any) -> Dict[str, Any]:
        """One flat JSON-serializable dict; extra `gauges` (active_sessions,
        compile_count, ...) are merged in by the caller that owns them —
        validated/coerced and merged under the lock, so a snapshot is one
        consistent cut even while handler threads record.

        Includes the cumulative histogram bucket counts
        (`latency_buckets`/`step_buckets` + `*_count`/`*_sum_s`), so the
        JSON view and the Prometheus exposition — which renders FROM this
        snapshot — cannot disagree.
        """
        coerced = {k: self._coerce_gauge(k, v) for k, v in gauges.items()}
        with self._lock:
            uptime = time.monotonic() - self._started
            out = {
                "uptime_s": uptime,
                "requests_total": self.requests_total,
                "errors_total": self.errors_total,
                "rejected_total": self.rejected_total,
                "resets_total": self.resets_total,
                "reloads_total": self.reloads_total,
                "sessions_restarted_total": self.sessions_restarted_total,
                "sessions_migrated_total": self.sessions_migrated_total,
                "requests_per_sec": (
                    self.requests_total / uptime if uptime > 0 else 0.0
                ),
                "latency_p50_ms": self.latency.quantile(0.5) * 1e3,
                "latency_p99_ms": self.latency.quantile(0.99) * 1e3,
                "latency_mean_ms": self.latency.mean() * 1e3,
                "latency_max_ms": self.latency.max * 1e3,
                "latency_buckets": self._bucket_json(self.latency),
                "latency_count": self.latency.count,
                "latency_sum_s": self.latency.total,
                "step_p50_ms": self.step_latency.quantile(0.5) * 1e3,
                "step_p99_ms": self.step_latency.quantile(0.99) * 1e3,
                "step_buckets": self._bucket_json(self.step_latency),
                "step_count": self.step_latency.count,
                "step_sum_s": self.step_latency.total,
                "batches_total": self.batches_total,
                "mean_batch_occupancy": (
                    self.occupancy_sum / self.batches_total
                    if self.batches_total
                    else 0.0
                ),
                "max_batch_occupancy": self.occupancy_max,
                "queue_depth": self.queue_depth,
                "batches_in_flight": self.batches_in_flight,
                "max_batches_in_flight": self.max_batches_in_flight,
                "joined_mid_cycle_total": self.joined_mid_cycle_total,
                # Per-bucket occupancy histogram, string-keyed for JSON;
                # the Prometheus renderer turns these into labeled
                # `rt1_serve_bucket_*{bucket="N"}` families.
                "bucket_batches": {
                    str(k): v for k, v in sorted(self.bucket_batches.items())
                },
                "bucket_occupancy_sum": {
                    str(k): v
                    for k, v in sorted(self.bucket_occupancy_sum.items())
                },
                # Per-task serve labels, string-keyed for JSON; the
                # Prometheus renderer emits them as labeled
                # `rt1_serve_task_*{task="..."}` families.
                "task_requests_total": dict(
                    sorted(self.task_requests_total.items())
                ),
                "task_sessions_total": dict(
                    sorted(self.task_sessions_total.items())
                ),
            }
            # Elastic-fleet families (router-level): present only once the
            # autoscaler / admission controller has touched them, so a
            # plain replica snapshot stays byte-identical to pre-elastic.
            if self.autoscale_replicas is not None:
                out["autoscale_replicas"] = self.autoscale_replicas
            if self.autoscale_scale_events:
                out["autoscale_scale_events_total"] = dict(
                    sorted(self.autoscale_scale_events.items())
                )
            if self.autoscale_shed:
                out["autoscale_shed_total"] = dict(
                    sorted(self.autoscale_shed.items())
                )
            if self.autoscale_tier_replicas:
                out["autoscale_tier_replicas"] = dict(
                    sorted(self.autoscale_tier_replicas.items())
                )
            out.update(coerced)
        return out

    def prometheus_text(self, **gauges: Any) -> str:
        """The snapshot in Prometheus exposition format (content-negotiated
        `/metrics` path; see obs/prometheus.py)."""
        from rt1_tpu_torch.obs.prometheus import render_serve_snapshot

        return render_serve_snapshot(self.snapshot(**gauges))

    def write_to(self, writer, step: int, **gauges: Any) -> None:
        """Publish the snapshot through a metric writer (any object with
        `write_scalars(step, scalars)`), `serve/`-prefixed.

        Gauges are validated by `snapshot` (non-numeric raises there); the
        only keys excluded here are the structural bucket arrays, which
        have no scalar representation.
        """
        scalars = {
            f"serve/{k}": float(v)
            for k, v in self.snapshot(**gauges).items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)
        }
        writer.write_scalars(step, scalars)
