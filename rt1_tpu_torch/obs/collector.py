"""Scrape loop: poll exposition/status targets into the TSDB, evaluate.

The port's copy of `rt1_tpu/obs/collector.py` (the port imports nothing of the
JAX package); it keeps the JAX module's names, wire format and behaviour.

The one writer the metrics plane needs: every ``interval_s`` the
collector fetches each target — the train process's Prometheus listener,
the router's fleet fan-out ``/metrics``, the supervisor's
``/deploy/status`` JSON — parses it (`parse_exposition`, the provable
inverse of the renderers in ``obs/prometheus.py``), and appends every
sample into the TSDB under ONE shared timestamp per cycle, so windowed
queries across families line up. When an `AlertManager` is attached,
each cycle ends with one evaluation pass — scrape cadence IS alert
cadence, exactly like a Prometheus rule group.

Targets are declarative (`Target(name, url, kind)`): ``metrics`` targets
speak exposition text; ``json`` targets are flattened — numeric leaves
become families named ``<prefix><dotted_path>`` (bools as 0/1, strings
and lists skipped), which is how ``/deploy/status`` history lands
without a second renderer.

A target that fails to answer is a *counted* fact
(``rt1_obs_collector_scrape_errors_total{target=...}``), never an
exception out of the loop: the collector is the component that must
outlive the incident it is recording.

Runs as a daemon thread inside the fleet supervisor (``--collector``)
or standalone (`python -m rt1_tpu_torch.obs.collector_main`). Stdlib-only — urllib, no
requests — same import-light contract as the rest of ``obs/``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from rt1_tpu_torch.obs.alerts import AlertManager
from rt1_tpu_torch.obs.prometheus import TextExposition, parse_exposition
from rt1_tpu_torch.obs.tsdb import TSDB

KINDS = ("metrics", "json")


@dataclasses.dataclass(frozen=True)
class Target:
    """One thing to poll. ``prefix`` applies to json targets only: the
    family namespace flattened leaves land under."""

    name: str
    url: str
    kind: str = "metrics"
    prefix: str = ""

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"kind {self.kind!r} not in {KINDS}")


def _default_fetch(url: str, timeout_s: float) -> str:
    # The router's /metrics content-negotiates (JSON by default, text
    # when asked); a scraper without an Accept header would get JSON and
    # fail exposition parsing. The train listener always answers text,
    # so the header is harmless there.
    req = urllib.request.Request(url, headers={"Accept": "text/plain"})
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        return resp.read().decode("utf-8")


def flatten_json(
    obj: Any, prefix: str = ""
) -> List[Tuple[str, Optional[Dict[str, str]], float]]:
    """Numeric leaves of a JSON document as (family, labels, value)
    samples: nested keys join with ``_``, bools coerce to 0/1, strings
    and lists are skipped (history stores numbers; the info-style state
    strings already ride the exposition targets)."""
    out: List[Tuple[str, Optional[Dict[str, str]], float]] = []
    if isinstance(obj, dict):
        for key, value in obj.items():
            path = f"{prefix}_{key}" if prefix else str(key)
            out.extend(flatten_json(value, path))
    elif isinstance(obj, bool):
        out.append((prefix, None, 1.0 if obj else 0.0))
    elif isinstance(obj, (int, float)):
        out.append((prefix, None, float(obj)))
    return out


class Collector:
    """The scrape loop. `scrape_once()` is the unit of work (and the unit
    the tests drive with an injected clock + fetch_fn); `start()` runs it
    on a daemon thread every `interval_s`."""

    def __init__(
        self,
        tsdb: TSDB,
        targets: Sequence[Target],
        interval_s: float = 5.0,
        alert_manager: Optional[AlertManager] = None,
        clock=time.time,
        fetch_fn: Optional[Callable[[str, float], str]] = None,
        timeout_s: float = 2.0,
    ):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be positive, got {interval_s}")
        names = [t.name for t in targets]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate target names in {names}")
        self.tsdb = tsdb
        self.targets = list(targets)
        self.interval_s = float(interval_s)
        self.alert_manager = alert_manager
        self._clock = clock
        self._fetch = fetch_fn or _default_fetch
        self.timeout_s = float(timeout_s)
        self._lock = threading.Lock()
        self._per_target: Dict[str, Dict[str, float]] = {
            t.name: {
                "scrapes_total": 0.0,
                "scrape_errors_total": 0.0,
                "samples_ingested_total": 0.0,
                "last_scrape_duration_s": 0.0,
                "up": 0.0,
            }
            for t in self.targets
        }
        self.cycles_total = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -------------------------------------------------------------- scraping

    def scrape_once(self, now: Optional[float] = None) -> Dict[str, int]:
        """One full cycle: every target, one shared sample timestamp,
        then one alert evaluation. Returns {target: samples_ingested}
        (-1 marks a failed scrape)."""
        if now is None:
            now = self._clock()
        ingested: Dict[str, int] = {}
        for target in self.targets:
            t0 = time.perf_counter()
            try:
                body = self._fetch(target.url, self.timeout_s)
                samples = self._parse(target, body)
                self.tsdb.append_many(samples, t=now)
            except Exception:  # noqa: BLE001 - a dead target is a
                # counted fact, not a loop exit.
                with self._lock:
                    stats = self._per_target[target.name]
                    stats["scrapes_total"] += 1
                    stats["scrape_errors_total"] += 1
                    stats["last_scrape_duration_s"] = (
                        time.perf_counter() - t0
                    )
                    stats["up"] = 0.0
                ingested[target.name] = -1
                continue
            with self._lock:
                stats = self._per_target[target.name]
                stats["scrapes_total"] += 1
                stats["samples_ingested_total"] += len(samples)
                stats["last_scrape_duration_s"] = time.perf_counter() - t0
                stats["up"] = 1.0
            ingested[target.name] = len(samples)
        with self._lock:
            self.cycles_total += 1
        if self.alert_manager is not None:
            self.alert_manager.evaluate(now=now)
        return ingested

    @staticmethod
    def _parse(
        target: Target, body: str
    ) -> List[Tuple[str, Optional[Dict[str, str]], float]]:
        if target.kind == "json":
            import json

            return flatten_json(json.loads(body), target.prefix)
        parsed = parse_exposition(body)
        return [
            (name, labels or None, value)
            for name, labels, value in parsed.samples
        ]

    # ------------------------------------------------------------- lifecycle

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("collector already started")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="rt1-obs-collector", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            self.scrape_once()
            self._stop.wait(self.interval_s)

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
            self._thread = None

    # ------------------------------------------------------------- reporting

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "cycles_total": self.cycles_total,
                "interval_s": self.interval_s,
                "targets": {
                    name: dict(stats)
                    for name, stats in self._per_target.items()
                },
            }

    def prometheus_text(self, prefix: str = "rt1_obs_collector_") -> str:
        """``rt1_obs_collector_*``: per-target scrape bookkeeping as
        labeled families, appended to the ops scrape when armed."""
        stats = self.stats()
        exp = TextExposition()
        exp.counter(
            prefix + "cycles_total",
            float(stats["cycles_total"]),
            "Completed scrape cycles.",
        )
        per_target = stats["targets"]
        ordered = sorted(per_target)
        for key, mtype, help_text in (
            ("up", "gauge", "1 when the target's last scrape succeeded."),
            ("scrapes_total", "counter", "Scrape attempts per target."),
            (
                "scrape_errors_total",
                "counter",
                "Scrape attempts that failed per target.",
            ),
            (
                "samples_ingested_total",
                "counter",
                "Samples appended into the TSDB per target.",
            ),
            (
                "last_scrape_duration_s",
                "gauge",
                "Wall seconds the last scrape of this target took.",
            ),
        ):
            samples = [
                ({"target": name}, per_target[name][key])
                for name in ordered
            ]
            if samples:
                exp.family(prefix + key, mtype, samples, help_text)
        return exp.render()
