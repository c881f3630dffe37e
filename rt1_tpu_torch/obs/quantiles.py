"""Shared percentile math for every latency reporter.

The port's copy of `rt1_tpu/obs/quantiles.py` (the port imports nothing of the JAX
package); it keeps the JAX module's names, wire format and behaviour.

Before this module, three places computed p50/p99 independently:
`scripts/serve_loadgen.py` had an index-into-sorted-list `_pct`, the
serve `LatencyHistogram` had its own cumulative-bucket walk, and the SLO
ledger would have added a third. Two different estimators for "p99" in
one report is how dashboards end up disagreeing with benches, so both
estimators live here — exact from samples, conservative upper bound from
histogram buckets — and everything (loadgen, `serve/metrics.py`,
`obs/slo.py`) calls these.

Stdlib-only (pinned by `tests/test_obs_imports.py`).
"""

from __future__ import annotations

from typing import Sequence, Tuple


def percentile(sorted_values: Sequence[float], q: float) -> float:
    """Exact sample percentile: the value at rank ``q`` of an ascending
    sorted sequence (nearest-rank, the loadgen convention). Returns 0.0
    on an empty sequence — latency reports treat "no samples" as zero
    rather than raising mid-summary.
    """
    if not sorted_values:
        return 0.0
    index = min(int(q * len(sorted_values)), len(sorted_values) - 1)
    return sorted_values[index]


def bucket_quantile(
    buckets: Sequence[float],
    counts: Sequence[int],
    total_count: int,
    observed_max: float,
    q: float,
) -> float:
    """Conservative (upper-bound) quantile from fixed histogram buckets.

    ``buckets`` are ascending upper bounds; ``counts[i]`` is the number
    of observations at or below ``buckets[i]`` (non-cumulative,
    per-bucket). The quantile is the upper bound of the bucket containing
    the q-rank; the overflow bucket reports ``observed_max``. 0.0 when
    empty. This is the `LatencyHistogram.quantile` semantics, hoisted so
    the histogram and the SLO ledger agree by construction.
    """
    if total_count <= 0:
        return 0.0
    rank = q * total_count
    cumulative = 0
    for upper, c in zip(buckets, counts):
        cumulative += c
        if cumulative >= rank:
            return upper
    return observed_max


def percentiles_ms(
    sorted_seconds: Sequence[float], qs: Sequence[float] = (0.50, 0.99)
) -> Tuple[float, ...]:
    """Convenience: exact percentiles of sorted second-latencies, in ms."""
    return tuple(percentile(sorted_seconds, q) * 1e3 for q in qs)
