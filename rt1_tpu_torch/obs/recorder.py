"""Slow-request exemplar ring: the serve-side flight recorder.

A copy of `ExemplarRing` from `rt1_tpu/obs/recorder.py` for the port, which
imports nothing of the JAX package. The trainer's `FlightRecorder` waits
for the trainer's obs (ROADMAP A10).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Dict, List


def _jsonable(value: Any) -> Any:
    """Coerce numpy/torch scalars so records never poison the dump."""
    if isinstance(value, (str, bool, int, float)) or value is None:
        return value
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    try:
        return float(value)
    except (TypeError, ValueError):
        return repr(value)


class ExemplarRing:
    """Bounded ring of slow-request exemplars — the serve-side flight
    recorder.

    The serving latency histogram says *that* p99 spiked; it cannot say
    *which* requests and *where inside the server* their time went. The
    ring keeps the most recent N requests whose total latency crossed
    ``threshold_ms`` (0 = keep everything, still bounded), each with its
    request id and per-phase breakdown, so a post-mortem names offenders
    instead of quantiles. Dumped as JSONL next to the flight record on
    replica drain/crash, served live on ``GET /slow_requests``, and
    aggregated fleet-wide by the router.
    """

    def __init__(self, capacity: int = 128, threshold_ms: float = 0.0):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = capacity
        self.threshold_ms = float(threshold_ms)
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._offered = 0
        self._kept = 0

    def offer(self, total_ms: float, **fields: Any) -> bool:
        """Record one finished request; kept past the threshold, and
        ALWAYS kept when ``outcome`` is present and not ``"ok"`` — a 1 ms
        503 storm is exactly the exemplar a post-mortem wants, and the
        threshold must not filter it. Returns whether it was kept (the
        caller's cost when not: one float compare)."""
        degraded = fields.get("outcome") not in (None, "ok")
        with self._lock:
            self._offered += 1
            if total_ms < self.threshold_ms and not degraded:
                return False
            self._kept += 1
            rec = {"total_ms": round(float(total_ms), 3), "t": time.time()}
            for k, v in fields.items():
                rec[k] = _jsonable(v)
            self._ring.append(rec)
            return True

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "capacity": self.capacity,
                "threshold_ms": self.threshold_ms,
                "offered": self._offered,
                "kept": self._kept,
                "retained": len(self._ring),
            }

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def dump(self, path: str, reason: str = "manual") -> str:
        """Header + exemplars as JSONL, one record per line, so a truncated
        dump still parses line by line."""
        records = self.snapshot()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            f.write(
                json.dumps(
                    {
                        "slow_requests": {
                            "reason": reason,
                            "dumped_at": time.time(),
                            **self.stats(),
                        }
                    }
                )
                + "\n"
            )
            for rec in records:
                f.write(json.dumps(rec) + "\n")
        return path
