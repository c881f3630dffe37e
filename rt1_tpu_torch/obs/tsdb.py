"""Bounded ring time-series store: scrape history with memory.

The port's copy of `rt1_tpu/obs/tsdb.py` (the port imports nothing of the
JAX package); it keeps the JAX module's names, wire format and behaviour.

Every ``rt1_*`` family in the repo is scrape-time-only — ``/metrics``
answers "what is the value NOW" and forgets it. The TSDB is the missing
memory: the collector (``obs/collector.py``) appends each scraped sample
here, keyed by ``(family, labels)``, and the alert engine
(``obs/alerts.py``), the ``/history`` + ``/dashboard`` ops surface, and
the post-mortem snapshot all read windows back out.

Deliberately small and stdlib-only (the same import-light contract as
``serve/router.py``): one lock, one ``deque`` ring per series, bounded
two ways — ``max_points`` per series AND ``retention_s`` by sample age —
plus a ``max_series`` cap so an unbounded label set (a buggy exporter
minting a fresh label per request) evicts least-recently-written series
instead of eating the host. Windowed queries reuse the one shared
quantile estimator (``obs/quantiles.py``); ``rate``/``increase`` are
counter-reset tolerant (negative steps contribute zero, the Prometheus
convention).

Snapshots are JSONL — header line first, one series per line — written
atomically (tmp + ``os.replace``, the ``SLOLedger.write_summary``
pattern) so a post-mortem reader never sees a half-written file, and
``read_snapshot``/``restore`` tolerate a torn final line (disk full,
SIGKILL mid-write) exactly like the flight recorder's ``read_dump``.

The clock is injectable (``clock=``) so retention and window math are
unit-testable without sleeping.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from rt1_tpu_torch.obs.quantiles import percentile

#: Default snapshot filename inside a workdir — what the fleet writes on
#: stop and what a post-mortem reads.
SNAPSHOT_BASENAME = "tsdb_snapshot.jsonl"

#: Canonical label identity: sorted (key, value) string pairs. Dict
#: ordering must never mint a second series for the same labels.
LabelKey = Tuple[Tuple[str, str], ...]

_AGGS = (
    "latest", "avg", "min", "max", "sum", "count",
    "delta", "increase", "rate", "quantile",
)


def _label_key(labels: Optional[Dict[str, Any]]) -> LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class TSDB:
    """Thread-safe bounded ring store of (family, labels) -> [(t, value)]."""

    def __init__(
        self,
        max_points: int = 2048,
        retention_s: float = 3600.0,
        max_series: int = 4096,
        clock=time.time,
    ):
        if max_points <= 0:
            raise ValueError(f"max_points must be positive, got {max_points}")
        if retention_s <= 0:
            raise ValueError(
                f"retention_s must be positive, got {retention_s}"
            )
        if max_series <= 0:
            raise ValueError(f"max_series must be positive, got {max_series}")
        self.max_points = int(max_points)
        self.retention_s = float(retention_s)
        self.max_series = int(max_series)
        self._clock = clock
        self._lock = threading.Lock()
        # OrderedDict in least-recently-APPENDED order: the max_series cap
        # evicts the series that has gone quietest, not the oldest-created.
        self._series: "collections.OrderedDict[Tuple[str, LabelKey], collections.deque]" = (  # noqa: E501
            collections.OrderedDict()
        )
        self._labels: Dict[Tuple[str, LabelKey], Dict[str, str]] = {}
        self.appends_total = 0
        self.points_evicted_total = 0
        self.series_dropped_total = 0

    # ------------------------------------------------------------- writing

    def append(
        self,
        family: str,
        value: float,
        labels: Optional[Dict[str, Any]] = None,
        t: Optional[float] = None,
    ) -> None:
        """Record one sample. `t` defaults to the injected clock — the
        collector passes one shared timestamp per scrape cycle so every
        family in a cycle windows identically."""
        if t is None:
            t = self._clock()
        key = (str(family), _label_key(labels))
        v = float(value)
        with self._lock:
            dq = self._series.get(key)
            if dq is None:
                if len(self._series) >= self.max_series:
                    dropped_key, dropped = self._series.popitem(last=False)
                    self._labels.pop(dropped_key, None)
                    self.series_dropped_total += 1
                    self.points_evicted_total += len(dropped)
                dq = collections.deque(maxlen=self.max_points)
                self._series[key] = dq
                self._labels[key] = dict(_label_key(labels))
            if len(dq) == dq.maxlen:
                self.points_evicted_total += 1  # ring overwrite
            dq.append((float(t), v))
            self._series.move_to_end(key)
            self._evict_old_locked(dq, float(t))
            self.appends_total += 1

    def append_many(
        self,
        samples: Iterable[Tuple[str, Optional[Dict[str, Any]], float]],
        t: Optional[float] = None,
    ) -> int:
        """Append (family, labels, value) triples under ONE timestamp
        (default: now). Returns the number appended."""
        if t is None:
            t = self._clock()
        n = 0
        for family, labels, value in samples:
            self.append(family, value, labels=labels, t=t)
            n += 1
        return n

    def _evict_old_locked(self, dq, now: float) -> None:
        cutoff = now - self.retention_s
        while dq and dq[0][0] < cutoff:
            dq.popleft()
            self.points_evicted_total += 1

    # ------------------------------------------------------------- reading

    def families(self) -> List[str]:
        with self._lock:
            return sorted({family for family, _ in self._series})

    def instances(self, family: str) -> List[Dict[str, str]]:
        """Every label set currently stored for `family` (the per-instance
        fan-out an alert rule iterates)."""
        with self._lock:
            return [
                dict(self._labels[key])
                for key in self._series
                if key[0] == family
            ]

    def series_index(self) -> List[Dict[str, Any]]:
        """[{family, labels, points}] — the /history listing payload."""
        with self._lock:
            return [
                {
                    "family": family,
                    "labels": dict(self._labels[(family, lk)]),
                    "points": len(dq),
                }
                for (family, lk), dq in self._series.items()
            ]

    def points(
        self,
        family: str,
        labels: Optional[Dict[str, Any]] = None,
        window_s: Optional[float] = None,
        now: Optional[float] = None,
    ) -> List[Tuple[float, float]]:
        """The stored (t, value) points for one series, oldest first,
        optionally restricted to the trailing `window_s`. Retention is
        enforced at read time too, so a quiet series cannot serve samples
        older than `retention_s`."""
        if now is None:
            now = self._clock()
        key = (str(family), _label_key(labels))
        with self._lock:
            dq = self._series.get(key)
            if dq is None:
                return []
            self._evict_old_locked(dq, float(now))
            pts = list(dq)
        if window_s is not None:
            cutoff = float(now) - float(window_s)
            pts = [p for p in pts if p[0] >= cutoff]
        return pts

    def latest(
        self, family: str, labels: Optional[Dict[str, Any]] = None
    ) -> Optional[Tuple[float, float]]:
        pts = self.points(family, labels=labels)
        return pts[-1] if pts else None

    def query(
        self,
        family: str,
        agg: str,
        window_s: float,
        labels: Optional[Dict[str, Any]] = None,
        q: Optional[float] = None,
        now: Optional[float] = None,
    ) -> Optional[float]:
        """One windowed aggregate over a series, or None when the window
        holds no data (rate/delta/increase need >= 2 points: a single
        sample carries no change information).

        * ``latest/avg/min/max/sum/count`` — over the values in window.
        * ``delta`` — last - first (signed).
        * ``increase`` — counter-reset-tolerant rise: sum of positive
          steps (a restart's drop to zero contributes nothing).
        * ``rate`` — increase / observed span, per second.
        * ``quantile`` — nearest-rank percentile at ``q`` via the shared
          estimator in ``obs/quantiles.py``.
        """
        if agg not in _AGGS:
            raise ValueError(f"unknown agg {agg!r}; known: {_AGGS}")
        pts = self.points(family, labels=labels, window_s=window_s, now=now)
        if not pts:
            return None
        values = [v for _, v in pts]
        if agg == "latest":
            return values[-1]
        if agg == "avg":
            return sum(values) / len(values)
        if agg == "min":
            return min(values)
        if agg == "max":
            return max(values)
        if agg == "sum":
            return sum(values)
        if agg == "count":
            return float(len(values))
        if agg == "quantile":
            if q is None:
                raise ValueError("agg='quantile' requires q=")
            return percentile(sorted(values), q)
        # Change aggregates: need two points to say anything.
        if len(pts) < 2:
            return None
        if agg == "delta":
            return values[-1] - values[0]
        rise = sum(
            max(0.0, b - a) for a, b in zip(values, values[1:])
        )
        if agg == "increase":
            return rise
        span = pts[-1][0] - pts[0][0]
        if span <= 0:
            return None
        return rise / span  # rate

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "series": len(self._series),
                "points": sum(len(dq) for dq in self._series.values()),
                "max_points": self.max_points,
                "retention_s": self.retention_s,
                "max_series": self.max_series,
                "appends_total": self.appends_total,
                "points_evicted_total": self.points_evicted_total,
                "series_dropped_total": self.series_dropped_total,
            }

    # ----------------------------------------------------------- snapshots

    def write_snapshot(self, path: str) -> str:
        """Atomic JSONL dump: header line + one line per series. tmp +
        os.replace so a reader never sees a partial file from US — the
        torn-file tolerance in `read_snapshot` covers everything else."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with self._lock:
            header = {
                "tsdb": {
                    "written_at": self._clock(),
                    "series": len(self._series),
                    "points": sum(len(dq) for dq in self._series.values()),
                    "max_points": self.max_points,
                    "retention_s": self.retention_s,
                    "appends_total": self.appends_total,
                }
            }
            rows = [
                {
                    "family": family,
                    "labels": dict(self._labels[(family, lk)]),
                    "points": [[t, v] for t, v in dq],
                }
                for (family, lk), dq in self._series.items()
            ]
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(json.dumps(header) + "\n")
            for row in rows:
                f.write(json.dumps(row) + "\n")
        os.replace(tmp, path)
        return path

    def restore(self, path: str) -> int:
        """Load a snapshot's points back in (bounds and retention apply as
        usual). Tolerates a torn final line; returns points restored."""
        loaded = read_snapshot(path)
        n = 0
        for row in loaded["series"]:
            family = row.get("family")
            labels = row.get("labels") or None
            for point in row.get("points", []):
                try:
                    t, v = float(point[0]), float(point[1])
                except (TypeError, ValueError, IndexError):
                    continue
                self.append(family, v, labels=labels, t=t)
                n += 1
        return n


def read_snapshot(path: str) -> Dict[str, Any]:
    """Parse a TSDB JSONL snapshot -> {"header": ..., "series": [...]}.
    A torn final line (hard kill mid-write of a foreign snapshot) ends the
    parse instead of raising — same contract as `recorder.read_dump`."""
    header: Dict[str, Any] = {}
    series: List[Dict[str, Any]] = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                break
            if i == 0 and "tsdb" in obj:
                header = obj["tsdb"]
            elif isinstance(obj, dict) and "family" in obj:
                series.append(obj)
    return {"header": header, "series": series}
