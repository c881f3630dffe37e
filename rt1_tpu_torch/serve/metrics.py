"""Serving-side metrics (a copy of `rt1_tpu/serve/metrics.py`, trimmed to
what the port's server records): latency histograms, batch occupancy,
per-bucket counts, and a JSON `snapshot()` for `GET /metrics`.

Counters are lock-guarded: requests land from many HTTP handler threads
while batches complete on the batcher's executor threads.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Any, Dict, Sequence

# Bucket upper bounds in seconds, 0.1 ms .. 30 s.
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


def bucket_quantile(
    buckets: Sequence[float],
    counts: Sequence[int],
    total_count: int,
    observed_max: float,
    q: float,
) -> float:
    """Conservative (upper-bound) quantile from fixed histogram buckets:
    the upper bound of the bucket holding the q-rank; the overflow bucket
    reports `observed_max`; 0.0 when empty."""
    if total_count <= 0:
        return 0.0
    rank = q * total_count
    cumulative = 0
    for upper, c in zip(buckets, counts):
        cumulative += c
        if cumulative >= rank:
            return upper
    return observed_max


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
        return bucket_quantile(self.buckets, self.counts, self.count, self.max, q)

    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


class ServeMetrics:
    """Aggregates the serving process's request/batch/session counters."""

    # Snapshot keys allowed to carry a string, or a {label: count} dict,
    # instead of a number.
    TEXT_GAUGES = frozenset({"dtype", "device", "inference_dtype"})
    DICT_GAUGES = frozenset({"cache_invalidations"})

    def __init__(self):
        self._lock = threading.Lock()
        self._started = time.monotonic()
        self.requests_total = 0
        self.errors_total = 0
        self.rejected_total = 0
        self.resets_total = 0
        self.reloads_total = 0
        self.batches_total = 0
        self.occupancy_sum = 0
        self.occupancy_max = 0
        self.queue_depth = 0
        self.batches_in_flight = 0
        self.max_batches_in_flight = 0
        self.joined_mid_cycle_total = 0
        self.bucket_batches: Dict[int, int] = {}
        self.bucket_occupancy_sum: Dict[int, int] = {}
        self.latency = LatencyHistogram()       # full request wall time
        self.step_latency = LatencyHistogram()  # batched device step only

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
        with self._lock:
            self.reloads_total += 1

    def observe_batch(self, size: int, queued: int = 0, in_flight: int = 0,
                      joined_mid_cycle: int = 0) -> None:
        with self._lock:
            self.batches_total += 1
            self.occupancy_sum += size
            self.occupancy_max = max(self.occupancy_max, size)
            self.queue_depth = queued
            self.batches_in_flight = in_flight
            self.max_batches_in_flight = max(self.max_batches_in_flight, in_flight)
            self.joined_mid_cycle_total += joined_mid_cycle

    def observe_inflight(self, in_flight: int) -> None:
        with self._lock:
            self.batches_in_flight = in_flight
            self.max_batches_in_flight = max(self.max_batches_in_flight, in_flight)

    def observe_bucket(self, bucket: int, occupancy: int) -> None:
        with self._lock:
            self.bucket_batches[int(bucket)] = self.bucket_batches.get(int(bucket), 0) + 1
            self.bucket_occupancy_sum[int(bucket)] = (
                self.bucket_occupancy_sum.get(int(bucket), 0) + int(occupancy)
            )

    def observe_step(self, seconds: float) -> None:
        with self._lock:
            self.step_latency.observe(seconds)

    @classmethod
    def _coerce_gauge(cls, name: str, value: Any):
        """Numeric gauges coerce to float; anything else raises, naming the
        gauge — a typo'd gauge must fail the caller, not vanish."""
        if name in cls.TEXT_GAUGES and isinstance(value, str):
            return value
        if name in cls.DICT_GAUGES and isinstance(value, dict):
            return {str(k): float(v) for k, v in value.items()}
        try:
            return float(value)
        except (TypeError, ValueError) as exc:
            raise ValueError(f"gauge {name!r} is not numeric: {value!r}") from exc

    def snapshot(self, **gauges: Any) -> Dict[str, Any]:
        """One flat JSON-serializable dict; `gauges` are merged in by the
        caller that owns them, under the lock, as one consistent cut."""
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
                "requests_per_sec": self.requests_total / uptime if uptime > 0 else 0.0,
                "latency_p50_ms": self.latency.quantile(0.5) * 1e3,
                "latency_p99_ms": self.latency.quantile(0.99) * 1e3,
                "latency_mean_ms": self.latency.mean() * 1e3,
                "latency_max_ms": self.latency.max * 1e3,
                "latency_count": self.latency.count,
                "step_p50_ms": self.step_latency.quantile(0.5) * 1e3,
                "step_p99_ms": self.step_latency.quantile(0.99) * 1e3,
                "step_count": self.step_latency.count,
                "batches_total": self.batches_total,
                "mean_batch_occupancy": (
                    self.occupancy_sum / self.batches_total if self.batches_total else 0.0
                ),
                "max_batch_occupancy": self.occupancy_max,
                "queue_depth": self.queue_depth,
                "batches_in_flight": self.batches_in_flight,
                "max_batches_in_flight": self.max_batches_in_flight,
                "joined_mid_cycle_total": self.joined_mid_cycle_total,
                "bucket_batches": {str(k): v for k, v in sorted(self.bucket_batches.items())},
                "bucket_occupancy_sum": {
                    str(k): v for k, v in sorted(self.bucket_occupancy_sum.items())
                },
            }
            out.update(coerced)
        return out
