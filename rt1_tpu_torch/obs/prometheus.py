"""Prometheus text-format exposition (and a tiny scrape listener).

The port's copy of `rt1_tpu/obs/prometheus.py` (the port imports nothing of the JAX
package); it keeps the JAX module's names, wire format and behaviour.

The serve layer's `/metrics` spoke JSON only — fine for
`scripts/serve_loadgen.py`, invisible to every standard scraper. This
module renders the exposition format (version 0.0.4: `# HELP`/`# TYPE`
comments, cumulative `le` histogram buckets ending at `+Inf`, `_sum` and
`_count` series) from plain Python dicts, so:

* the serve `/metrics` endpoint can content-negotiate: JSON by default,
  text when the scraper asks (`Accept: text/plain` or openmetrics) —
  `rt1_tpu/serve/server.py`;
* the train loop can expose its own scrape target
  (`config.obs.prometheus_port`) without importing any serving code —
  `MetricsServer` below is a stdlib `ThreadingHTTPServer` on a daemon
  thread.

Everything renders FROM the JSON snapshot (`ServeMetrics.snapshot()` now
carries cumulative bucket counts), so the two formats cannot drift: same
numbers, two syntaxes.

No third-party dependencies — this module must stay importable in a
headless serve deployment with no clu/tensorboard installed (pinned by
`tests/test_obs_imports.py`).
"""

from __future__ import annotations

import math
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_name(name: str) -> str:
    """Coerce an arbitrary metric key into a legal Prometheus name."""
    name = _NAME_RE.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def format_value(v: float) -> str:
    v = float(v)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


class TextExposition:
    """Accumulates metric families and renders the text format."""

    def __init__(self):
        self._lines: List[str] = []
        self._seen: set = set()

    def _header(self, name: str, mtype: str, help_text: Optional[str]):
        if name in self._seen:
            raise ValueError(f"metric family {name!r} already rendered")
        self._seen.add(name)
        if help_text:
            # Escape per the exposition spec: backslash and newline.
            escaped = help_text.replace("\\", "\\\\").replace("\n", "\\n")
            self._lines.append(f"# HELP {name} {escaped}")
        self._lines.append(f"# TYPE {name} {mtype}")

    def counter(self, name: str, value: float, help_text: str = ""):
        name = sanitize_name(name)
        self._header(name, "counter", help_text)
        self._lines.append(f"{name} {format_value(value)}")

    def gauge(self, name: str, value: float, help_text: str = ""):
        name = sanitize_name(name)
        self._header(name, "gauge", help_text)
        self._lines.append(f"{name} {format_value(value)}")

    def histogram(
        self,
        name: str,
        cumulative: Sequence[Tuple[Any, int]],
        sum_value: float,
        count: int,
        help_text: str = "",
    ):
        """`cumulative`: (upper_bound, cumulative_count) pairs in ascending
        bound order; the final bound may be inf / "+Inf" — if absent, an
        `+Inf` bucket equal to `count` is appended (the spec requires it)."""
        name = sanitize_name(name)
        self._header(name, "histogram", help_text)
        has_inf = False
        for le, c in cumulative:
            if isinstance(le, str):
                le_str = le
                has_inf = has_inf or le == "+Inf"
            else:
                le_f = float(le)
                has_inf = has_inf or math.isinf(le_f)
                le_str = format_value(le_f)
            self._lines.append(f'{name}_bucket{{le="{le_str}"}} {int(c)}')
        if not has_inf:
            self._lines.append(f'{name}_bucket{{le="+Inf"}} {int(count)}')
        self._lines.append(f"{name}_sum {format_value(sum_value)}")
        self._lines.append(f"{name}_count {int(count)}")

    def family(
        self,
        name: str,
        mtype: str,
        samples: Sequence[Tuple[Dict[str, str], float]],
        help_text: str = "",
    ):
        """One metric family with LABELED samples — the fleet-aggregation
        shape: one `# TYPE` header, one sample per replica
        (``{replica_id="0"} 42``). Label values are escaped per the
        exposition spec (backslash, quote, newline)."""
        name = sanitize_name(name)
        self._header(name, mtype, help_text)
        for labels, value in samples:
            rendered = ",".join(
                f'{sanitize_name(str(k))}="{self._escape_label(str(v))}"'
                for k, v in labels.items()
            )
            self._lines.append(
                f"{name}{{{rendered}}} {format_value(value)}"
                if rendered
                else f"{name} {format_value(value)}"
            )

    @staticmethod
    def _escape_label(value: str) -> str:
        return (
            value.replace("\\", "\\\\")
            .replace('"', '\\"')
            .replace("\n", "\\n")
        )

    def render(self) -> str:
        return "\n".join(self._lines) + "\n"


# --------------------------------------------------------------- renderers

# snapshot() counter keys -> (family suffix, help). Everything else numeric
# in the snapshot becomes a gauge; *_buckets / *_count / *_sum_s triples
# become histograms.
_SERVE_COUNTERS = {
    "requests_total": "Requests accepted by /act (including failed).",
    "errors_total": "Requests answered with an error status.",
    "rejected_total": "Requests shed by queue backpressure (503 busy).",
    "resets_total": "Session resets via /reset.",
    "reloads_total": "Zero-downtime checkpoint hot-swaps served.",
    "sessions_restarted_total": (
        "Sessions re-homed to another replica after theirs died."
    ),
    "sessions_migrated_total": (
        "Sessions whose window was carried intact to another replica "
        "(live migration or snapshot-ring restore)."
    ),
    "batches_total": "Batched device steps executed.",
    "joined_mid_cycle_total": (
        "Requests that rode a batch formed while another batch was "
        "already in flight (continuous-batching occupancy signal)."
    ),
    # Data-flywheel capture sink (rt1_tpu/flywheel/capture.py) — present
    # only on replicas serving with --capture_dir.
    "capture_episodes_total": "Captured sessions written as episodes.",
    "capture_steps_total": "Steps written into captured episodes.",
    "capture_dropped_episodes_total": (
        "Sessions discarded (too short / no resolvable instruction)."
    ),
    "capture_dropped_steps_total": (
        "Steps dropped past the per-session capture bound."
    ),
    "capture_write_errors_total": "Episode writes that failed (kept serving).",
    "capture_pruned_total": "Old capture files pruned by the disk ring.",
    # KV-cached incremental decode (rt1_tpu/serve/engine.py
    # cached_inference=True): steps served from per-session caches vs
    # full-window recomputes (cache rebuilds after hot-swap).
    "cache_cached_steps_total": (
        "Session steps served through the incremental KV-cache decode "
        "path (one frame attended against cached keys)."
    ),
    "cache_rebuild_steps_total": (
        "Per-session full-window cache recomputes (rebuilds after "
        "checkpoint hot-swap invalidation)."
    ),
    # Durable sessions (rt1_tpu/serve/migrate.py): the replica-side
    # export/import/restore legs of live migration and snapshot-ring
    # crash recovery.
    "migration_exports_total": (
        "Session snapshots exported via POST /session/export."
    ),
    "migration_imports_total": (
        "Session snapshots imported via POST /session/import."
    ),
    "migration_import_failures_total": (
        "Session imports refused (compatibility) or failed (malformed)."
    ),
    "migration_restores_total": (
        "Sessions restored from the on-disk snapshot ring at /act time."
    ),
    "migration_restore_failures_total": (
        "Snapshot-ring restores that failed or were refused (stale, "
        "incompatible, injected fault) — the session restarted fresh."
    ),
}

_SERVE_HISTOGRAMS = {
    "latency": ("request_latency_seconds", "Full request wall time."),
    "step": ("step_latency_seconds", "Batched device step latency."),
}

def _numeric_label_key(kv):
    """Sort key for numeric label values (AOT bucket sizes)."""
    return int(kv[0])


def _lexical_label_key(kv):
    """Sort key for string label values (task slugs)."""
    return str(kv[0])


# snapshot dict keys -> (family, type, label, sort_key, help): snapshot
# entries that are {label_value: count} dicts, rendered as ONE labeled
# family each — the per-AOT-bucket occupancy histogram (`bucket` label,
# numeric order) and the per-task serve labels (`task` label, lexical
# order; task slugs like "unknown:<reward>" pass through label escaping).
_SERVE_LABELED_FAMILIES = (
    (
        "bucket_batches",
        "bucket_batches_total",
        "counter",
        "bucket",
        _numeric_label_key,
        "Batched steps executed per AOT batch-size bucket.",
    ),
    (
        "bucket_occupancy_sum",
        "bucket_occupancy_sum",
        "counter",
        "bucket",
        _numeric_label_key,
        "Summed active requests per AOT bucket (mean fill = sum/batches).",
    ),
    (
        "task_requests_total",
        "task_requests_total",
        "counter",
        "task",
        _lexical_label_key,
        "Served /act requests per client-declared task tag "
        "('unlabeled' = no tag).",
    ),
    (
        "task_sessions_total",
        "task_sessions_total",
        "counter",
        "task",
        _lexical_label_key,
        "Sessions started per client-declared task tag.",
    ),
    (
        "cache_invalidations",
        "cache_invalidations_total",
        "counter",
        "reason",
        _lexical_label_key,
        "KV-cache invalidations by cause ('swap' checkpoint hot-swap | "
        "'reset' session reset | 'evict' LRU slot reclaim).",
    ),
)


# Router-level labeled families: rendered from the
# router's own snapshot like _SERVE_LABELED_FAMILIES, but deliberately NOT
# fanned out per replica — scale events, admission sheds, and tier counts
# are fleet-shape facts that only the router/supervisor process owns.
_ROUTER_LABELED_FAMILIES = (
    (
        "autoscale_scale_events_total",
        "autoscale_scale_events_total",
        "counter",
        "direction",
        _lexical_label_key,
        "Fleet scale events by direction (elastic autoscaler).",
    ),
    (
        "autoscale_shed_total",
        "autoscale_shed_total",
        "counter",
        "reason",
        _lexical_label_key,
        "Requests shed by router admission control, by reason "
        "('client_rate' token bucket | 'overload' global threshold).",
    ),
    (
        "autoscale_tier_replicas",
        "autoscale_tier_replicas",
        "gauge",
        "dtype",
        _lexical_label_key,
        "Live replicas per dtype capacity tier (base + surge).",
    ),
)


def render_serve_snapshot(
    snapshot: Dict[str, Any], prefix: str = "rt1_serve_"
) -> str:
    """ServeMetrics JSON snapshot -> Prometheus text, one source of truth."""
    exp = TextExposition()
    _render_serve_into(exp, snapshot, prefix)
    return exp.render()


def _render_serve_into(
    exp: TextExposition, snapshot: Dict[str, Any], prefix: str
) -> None:
    consumed = set()
    for key, help_text in _SERVE_COUNTERS.items():
        if key in snapshot:
            exp.counter(prefix + key, snapshot[key], help_text)
            consumed.add(key)
    # The engine's low-precision mode is a string, exposed info-style
    # (`rt1_serve_inference_dtype{dtype="int8"} 1`) so dashboards can
    # group latency by dtype without an enum-code mapping.
    if isinstance(snapshot.get("inference_dtype"), str):
        exp.family(
            prefix + "inference_dtype",
            "gauge",
            [({"dtype": snapshot["inference_dtype"]}, 1.0)],
            "Engine inference dtype (f32 | bf16 | int8), info-style.",
        )
        consumed.add("inference_dtype")
    for key, (family, help_text) in _SERVE_HISTOGRAMS.items():
        buckets = snapshot.get(f"{key}_buckets")
        if buckets is None:
            continue
        exp.histogram(
            prefix + family,
            buckets,
            sum_value=snapshot.get(f"{key}_sum_s", 0.0),
            count=snapshot.get(f"{key}_count", 0),
            help_text=help_text,
        )
        consumed.update({f"{key}_buckets", f"{key}_sum_s", f"{key}_count"})
    # Labeled-dict families: the per-AOT-bucket occupancy histogram
    # (`rt1_serve_bucket_batches_total{bucket="4"} 17`), the
    # per-task serve labels (`rt1_serve_task_requests_total{task="play"}`),
    # and the router's elastic-fleet families —
    # each snapshot dict becomes one labeled family.
    for key, family, mtype, label, sort_key, help_text in (
        _SERVE_LABELED_FAMILIES + _ROUTER_LABELED_FAMILIES
    ):
        table = snapshot.get(key)
        if isinstance(table, dict):
            consumed.add(key)
            if table:
                exp.family(
                    prefix + family,
                    mtype,
                    [
                        ({label: str(b)}, v)
                        for b, v in sorted(table.items(), key=sort_key)
                    ],
                    help_text,
                )
    for key in sorted(snapshot.keys() - consumed):
        value = snapshot[key]
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            continue
        exp.gauge(prefix + _gauge_suffix(key), value)


def _gauge_suffix(key: str) -> str:
    """Snapshot key -> metric-name suffix (units spelled out per the
    Prometheus naming convention)."""
    return "uptime_seconds" if key == "uptime_s" else key


# Replica snapshot fields fanned into the router's aggregated /metrics,
# one labeled family each: rt1_serve_replica_<field>{replica_id="N"}.
# Curated (not "every numeric key") so the fleet scrape stays a stable
# contract — per-replica occupancy, compiles, reloads, queue depth, the
# request counters, and the latency quantiles.
_FLEET_REPLICA_FIELDS = {
    "requests_total": ("counter", "Requests served by this replica."),
    "errors_total": ("counter", "Error responses from this replica."),
    "rejected_total": ("counter", "Requests shed by this replica (503)."),
    "reloads_total": ("counter", "Checkpoint hot-swaps on this replica."),
    "batches_total": ("counter", "Batched device steps on this replica."),
    "active_sessions": ("gauge", "Live session slots in use."),
    "compile_count": (
        "gauge",
        "AOT compiles this replica lifetime (invariant: 1).",
    ),
    "queue_depth": ("gauge", "Micro-batcher queue depth at last batch."),
    "mean_batch_occupancy": ("gauge", "Mean batch fill."),
    "max_batch_occupancy": ("gauge", "Max batch fill."),
    "batches_in_flight": (
        "gauge",
        "Batches dispatched but not yet collected (double-buffer depth).",
    ),
    "max_batches_in_flight": (
        "gauge",
        "High-water mark of overlapping batches this lifetime.",
    ),
    "joined_mid_cycle_total": (
        "counter",
        "Requests that rode a batch formed while another was in flight.",
    ),
    "bucket_count": (
        "gauge",
        "Configured AOT batch-size buckets (compile_count invariant).",
    ),
    "latency_p50_ms": ("gauge", "Replica-local request p50 (ms)."),
    "latency_p99_ms": ("gauge", "Replica-local request p99 (ms)."),
    "requests_per_sec": ("gauge", "Replica-local request rate."),
    "ready": ("gauge", "1 when the replica reports ready."),
    "reloading": ("gauge", "1 while a hot-swap is in progress."),
    "draining": ("gauge", "1 while draining after SIGTERM."),
    "session_evictions": ("gauge", "LRU slot reclaims (oversubscription)."),
    "slow_exemplars": ("gauge", "Slow-request exemplars retained."),
    "uptime_s": ("gauge", "Replica process uptime (seconds)."),
    "param_bytes_device": (
        "gauge",
        "Device-resident serving-tree bytes (int8 quantized size counts).",
    ),
    "param_bytes_master": (
        "gauge",
        "f32 master checkpoint bytes this replica restores from.",
    ),
    "capture_enabled": ("gauge", "1 when the flywheel capture sink is on."),
    "capture_episodes_total": (
        "counter",
        "Captured sessions written as flywheel episodes.",
    ),
    "capture_open_sessions": (
        "gauge",
        "Capture buffers currently open on this replica.",
    ),
    "capture_write_errors_total": (
        "counter",
        "Episode writes that failed on this replica (kept serving).",
    ),
    "capture_pruned_total": (
        "counter",
        "Old capture files pruned by this replica's disk ring.",
    ),
    "cache_enabled": (
        "gauge",
        "1 when this replica serves with per-session KV caches.",
    ),
    "cache_bytes_per_slot": (
        "gauge",
        "Device bytes of transformer K/V cache per session slot.",
    ),
    "cache_cached_steps_total": (
        "counter",
        "Steps served through incremental KV-cache decode.",
    ),
    "cache_rebuild_steps_total": (
        "counter",
        "Per-session full-window cache recomputes after invalidation.",
    ),
    "migration_exports_total": (
        "counter",
        "Session snapshots this replica exported (live migration).",
    ),
    "migration_imports_total": (
        "counter",
        "Session snapshots this replica imported (live migration).",
    ),
    "migration_import_failures_total": (
        "counter",
        "Session imports this replica refused or failed.",
    ),
    "migration_restores_total": (
        "counter",
        "Sessions this replica restored from the snapshot ring.",
    ),
    "migration_restore_failures_total": (
        "counter",
        "Snapshot-ring restores that failed on this replica "
        "(session restarted fresh).",
    ),
}


# Router-attributed per-replica SLO families (deploy canary judgement):
# rendered from Router.replica_slo_snapshot(), NOT the replica /metrics
# fan-out — the router is the only process that sees every outcome,
# including the death that the dead replica itself could never report.
_REPLICA_SLO_FAMILIES = (
    (
        "outcome_total",
        "counter",
        "Router-attributed request outcomes per replica "
        "(ok | migrated | restarted | rejected | failed).",
    ),
    (
        "slo_availability_rolling",
        "gauge",
        "Rolling ok-fraction of requests this replica answered.",
    ),
    (
        "slo_error_budget_burn_rolling",
        "gauge",
        "Rolling error-budget burn attributed to this replica "
        "(the canary rollback signal).",
    ),
)


def fleet_metric_names(prefix: str = "rt1_serve_") -> List[str]:
    """Every family name the aggregated fleet exposition can emit (the
    naming-contract test iterates this)."""
    names = [prefix + "replica_up", prefix + "replica_inference_dtype"]
    for key in _FLEET_REPLICA_FIELDS:
        names.append(prefix + "replica_" + _gauge_suffix(key))
    for _, family, _, _, _, _ in _SERVE_LABELED_FAMILIES:
        names.append(prefix + "replica_" + family)
    for suffix, _, _ in _REPLICA_SLO_FAMILIES:
        names.append(prefix + "replica_" + suffix)
    return names


def render_fleet_snapshot(
    router_snapshot: Dict[str, Any],
    replicas: Dict[Any, Optional[Dict[str, Any]]],
    prefix: str = "rt1_serve_",
    replica_slo: Optional[Dict[Any, Dict[str, Any]]] = None,
) -> str:
    """Router snapshot + per-replica snapshots -> ONE exposition body.

    The router's own families render exactly as `render_serve_snapshot`
    (same names, so a single-replica dashboard keeps working against a
    fleet); each replica's curated fields follow as labeled families with
    a ``replica_id`` label. A replica whose `/metrics` probe failed
    (value None) appears only in ``replica_up`` as 0 — absence of data is
    itself a scraped fact, not a silent gap. ``replica_slo``
    (`Router.replica_slo_snapshot()`) adds the router-attributed
    per-replica outcome families — the canary burn signal.
    """
    exp = TextExposition()
    _render_serve_into(exp, router_snapshot, prefix)
    up = [
        ({"replica_id": str(rid)}, 0.0 if snap is None else 1.0)
        for rid, snap in sorted(replicas.items(), key=lambda kv: str(kv[0]))
    ]
    if up:
        exp.family(
            prefix + "replica_up",
            "gauge",
            up,
            "1 when the replica's /metrics answered the fan-out probe.",
        )
    # Mixed-dtype fleets: each replica's inference dtype as one labeled
    # info family — `{replica_id="1",dtype="int8"} 1` — so a per-dtype
    # latency dashboard needs no enum mapping.
    dtype_samples = [
        (
            {"replica_id": str(rid), "dtype": snap["inference_dtype"]},
            1.0,
        )
        for rid, snap in sorted(replicas.items(), key=lambda kv: str(kv[0]))
        if snap is not None and isinstance(snap.get("inference_dtype"), str)
    ]
    if dtype_samples:
        exp.family(
            prefix + "replica_inference_dtype",
            "gauge",
            dtype_samples,
            "Replica inference dtype (f32 | bf16 | int8), info-style.",
        )
    for key, (mtype, help_text) in _FLEET_REPLICA_FIELDS.items():
        samples = [
            ({"replica_id": str(rid)}, snap[key])
            for rid, snap in sorted(
                replicas.items(), key=lambda kv: str(kv[0])
            )
            if snap is not None and isinstance(snap.get(key), (int, float))
            and not isinstance(snap.get(key), bool)
        ]
        if not samples:
            continue
        exp.family(
            prefix + "replica_" + _gauge_suffix(key), mtype, samples,
            help_text,
        )
    # Per-replica labeled-dict families: AOT-bucket occupancy
    # ({replica_id, bucket}) and per-task serve labels ({replica_id,
    # task}) — a fleet dashboard reads each replica's fill profile and
    # task mix without scraping replicas individually.
    for key, family, mtype, label, sort_key, help_text in (
        _SERVE_LABELED_FAMILIES
    ):
        samples = [
            ({"replica_id": str(rid), label: str(b)}, v)
            for rid, snap in sorted(
                replicas.items(), key=lambda kv: str(kv[0])
            )
            if snap is not None and isinstance(snap.get(key), dict)
            for b, v in sorted(snap[key].items(), key=sort_key)
        ]
        if not samples:
            continue
        exp.family(
            prefix + "replica_" + family, mtype, samples, help_text
        )
    # Router-attributed per-replica SLO families (the canary judgement
    # view): outcome-class counters double-labeled {replica_id, outcome}
    # plus the rolling availability/burn gauge pair per replica.
    if replica_slo:
        ordered = sorted(replica_slo.items(), key=lambda kv: str(kv[0]))
        outcome_samples = [
            ({"replica_id": str(rid), "outcome": str(o)}, count)
            for rid, entry in ordered
            for o, count in entry.get("outcomes", {}).items()
        ]
        families = {
            key: [
                ({"replica_id": str(rid)}, entry[field])
                for rid, entry in ordered
                if isinstance(entry.get(field), (int, float))
            ]
            for key, field in (
                ("slo_availability_rolling", "availability_rolling"),
                (
                    "slo_error_budget_burn_rolling",
                    "error_budget_burn_rolling",
                ),
            )
        }
        for suffix, mtype, help_text in _REPLICA_SLO_FAMILIES:
            samples = (
                outcome_samples
                if suffix == "outcome_total"
                else families[suffix]
            )
            if samples:
                exp.family(
                    prefix + "replica_" + suffix, mtype, samples, help_text
                )
    return exp.render()


# ------------------------------------------------------------------ parsing


def render_scalar_gauges(
    scalars: Dict[str, Any], prefix: str = "rt1_train_"
) -> str:
    """Flat {name: number} -> all-gauge text (the train-side scrape body).

    Names pass through `sanitize_name` ('timing/wait_data_ms' ->
    'timing_wait_data_ms'); non-numeric values are skipped.
    """
    exp = TextExposition()
    for key in sorted(scalars):
        value = scalars[key]
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            continue
        exp.gauge(sanitize_name(prefix + key), value)
    return exp.render()


def deploy_metric_names(
    snapshot: Dict[str, Any], prefix: str = "rt1_deploy_"
) -> List[str]:
    """Family names `render_deploy_snapshot` emits for `snapshot` (the
    naming-contract test iterates this against a full gauges payload)."""
    return [
        sanitize_name(prefix + key)
        for key in sorted(snapshot)
        if isinstance(snapshot[key], str)
        or (
            isinstance(snapshot[key], (int, float))
            and not isinstance(snapshot[key], bool)
        )
    ]


def render_deploy_snapshot(
    snapshot: Dict[str, Any], prefix: str = "rt1_deploy_"
) -> str:
    """PromotionController.deploy_gauges() -> ``rt1_deploy_*`` text.

    Same typing convention as the serve families: ``*_total`` keys are
    counters, string values render info-style
    (``rt1_deploy_state{state="canary"} 1``), everything else numeric is
    a gauge. Concatenates cleanly after a fleet exposition body (distinct
    prefix, no family collisions) — the supervisor serves both from one
    scrape.
    """
    exp = TextExposition()
    for key in sorted(snapshot):
        value = snapshot[key]
        name = prefix + key
        if isinstance(value, str):
            exp.family(
                name,
                "gauge",
                [({key: value}, 1.0)],
                f"Deploy controller {key} (info-style).",
            )
        elif isinstance(value, bool) or not isinstance(value, (int, float)):
            continue
        elif key.endswith("_total"):
            exp.counter(name, value)
        else:
            exp.gauge(name, value)
    return exp.render()


def parse_value(text: str) -> float:
    """Inverse of `format_value`: the three special spellings, then float."""
    if text == "+Inf":
        return math.inf
    if text == "-Inf":
        return -math.inf
    if text == "NaN":
        return math.nan
    return float(text)


def _unescape(value: str) -> str:
    """Inverse of `TextExposition._escape_label` (and the HELP escaping):
    ``\\\\`` -> backslash, ``\\"`` -> quote, ``\\n`` -> newline. An unknown
    escape keeps its backslash verbatim, per the exposition spec."""
    out: List[str] = []
    i = 0
    while i < len(value):
        ch = value[i]
        if ch == "\\" and i + 1 < len(value):
            nxt = value[i + 1]
            if nxt == "\\":
                out.append("\\")
            elif nxt == '"':
                out.append('"')
            elif nxt == "n":
                out.append("\n")
            else:
                out.append(ch)
                out.append(nxt)
            i += 2
            continue
        out.append(ch)
        i += 1
    return "".join(out)


def _parse_labels(line: str, start: int) -> Tuple[Dict[str, str], int]:
    """Parse ``{k="v",...}`` starting at the ``{``; returns (labels, index
    just past the ``}``). Escapes inside quoted values are honoured — a
    label value may contain braces, commas, spaces, escaped quotes."""
    labels: Dict[str, str] = {}
    i = start + 1
    while i < len(line) and line[i] != "}":
        eq = line.find("=", i)
        if eq < 0 or eq + 1 >= len(line) or line[eq + 1] != '"':
            raise ValueError(f"malformed labels in sample line: {line!r}")
        key = line[i:eq].lstrip(",").strip()
        j = eq + 2  # first char inside the quotes
        raw: List[str] = []
        while j < len(line):
            ch = line[j]
            if ch == "\\" and j + 1 < len(line):
                raw.append(line[j : j + 2])
                j += 2
                continue
            if ch == '"':
                break
            raw.append(ch)
            j += 1
        if j >= len(line) or line[j] != '"':
            raise ValueError(f"unterminated label value: {line!r}")
        labels[key] = _unescape("".join(raw))
        i = j + 1
        if i < len(line) and line[i] == ",":
            i += 1
    if i >= len(line) or line[i] != "}":
        raise ValueError(f"unterminated label set: {line!r}")
    return labels, i + 1


class Exposition:
    """A parsed text exposition: {family: type}, {family: help}, and the
    flat (name, labels, value) sample list. What `parse_exposition`
    returns; the collector iterates `samples`, the round-trip tests
    compare values against the source snapshot."""

    def __init__(
        self,
        types: Dict[str, str],
        help_texts: Dict[str, str],
        samples: List[Tuple[str, Dict[str, str], float]],
    ):
        self.types = types
        self.help = help_texts
        self.samples = samples

    def value(self, name: str, **labels: str) -> float:
        """The single sample with exactly these labels; KeyError if absent
        (or ambiguous — duplicates indicate a renderer bug)."""
        hits = [
            v for n, lb, v in self.samples if n == name and lb == labels
        ]
        if len(hits) != 1:
            raise KeyError(
                f"{name}{labels}: {len(hits)} matching samples"
            )
        return hits[0]

    def labeled(self, name: str) -> List[Tuple[Dict[str, str], float]]:
        return [(lb, v) for n, lb, v in self.samples if n == name]

    def histogram(self, family: str) -> Dict[str, Any]:
        """Reassemble one histogram family back into the snapshot shape:
        cumulative ``buckets`` as (le, count) pairs with le in JSON form
        (float, or "+Inf" for the overflow — matching
        `ServeMetrics._bucket_json`), plus ``sum`` and ``count``."""
        if self.types.get(family) != "histogram":
            raise KeyError(f"{family!r} is not a parsed histogram family")
        buckets: List[Tuple[Any, int]] = []
        for labels, value in self.labeled(family + "_bucket"):
            le = labels.get("le", "")
            buckets.append(
                (le if le == "+Inf" else float(le), int(value))
            )
        return {
            "buckets": buckets,
            "sum": self.value(family + "_sum"),
            "count": int(self.value(family + "_count")),
        }


_HISTOGRAM_SUFFIXES = ("_bucket", "_sum", "_count")


def parse_exposition(text: str) -> Exposition:
    """Parse Prometheus text exposition 0.0.4 — the provable inverse of
    `TextExposition.render` (and so of every ``render_*`` in this module).

    Strict by design: a sample before its ``# TYPE`` header, a duplicate
    family header, an unknown comment, or an unparsable value raises
    ``ValueError``. If the renderer ever drifts from the format the
    collector ingests, the round-trip tests fail loudly instead of the
    history silently dropping families.
    """
    types: Dict[str, str] = {}
    help_texts: Dict[str, str] = {}
    samples: List[Tuple[str, Dict[str, str], float]] = []
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            rest = line[len("# HELP ") :]
            name, _, help_text = rest.partition(" ")
            help_texts[name] = _unescape(help_text)
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ")
            if len(parts) != 4:
                raise ValueError(f"malformed TYPE line: {line!r}")
            _, _, name, mtype = parts
            if name in types:
                raise ValueError(f"duplicate family header: {name!r}")
            types[name] = mtype
            continue
        if line.startswith("#"):
            raise ValueError(f"unknown comment line: {line!r}")
        # Sample: name[{labels}] value — label values may contain spaces.
        brace = line.find("{")
        space = line.find(" ")
        if brace >= 0 and (space < 0 or brace < space):
            name = line[:brace]
            labels, end = _parse_labels(line, brace)
            value_text = line[end:].strip()
        else:
            name, _, value_text = line.partition(" ")
            labels = {}
        base = name
        for suffix in _HISTOGRAM_SUFFIXES:
            stripped = name[: -len(suffix)] if name.endswith(suffix) else ""
            if stripped and types.get(stripped) == "histogram":
                base = stripped
        if base not in types:
            raise ValueError(f"sample {name!r} precedes its # TYPE header")
        samples.append((name, labels, parse_value(value_text.strip())))
    return Exposition(types, help_texts, samples)


CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def accepts_text(accept_header: Optional[str]) -> bool:
    """Content negotiation for a dual JSON/text /metrics endpoint: JSON
    stays the default (existing loadgen/automation), text is returned when
    the client asks the way Prometheus does.

    Listed order breaks ties (a full q-value parse is overkill here): a
    client sending ``application/json, text/plain, */*`` — the stock
    axios/fetch Accept — wants JSON first and gets JSON.
    """
    if not accept_header:
        return False
    for entry in accept_header.lower().split(","):
        media = entry.split(";", 1)[0].strip()
        if media == "application/json":
            return False
        if media == "text/plain" or "openmetrics" in media:
            return True
    return False


# ----------------------------------------------------------------- listener


class MetricsServer:
    """Opt-in scrape listener: GET /metrics -> `render_fn()` as text.

    Stdlib-only, daemon-threaded, ephemeral-port-friendly (port=0). The
    train loop hands it a closure over its StepTimeline / ThroughputMeter /
    feeder stats; rendering cost is paid by the scraper's request, never by
    the train step.
    """

    def __init__(
        self,
        render_fn: Callable[[], str],
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: D102 - stdlib hook
                pass

            def do_GET(self):  # noqa: N802 - stdlib casing
                if self.path == "/metrics":
                    try:
                        body = outer._render_fn().encode("utf-8")
                    except Exception as exc:  # noqa: BLE001 - scrape-safe
                        body = f"# render error: {exc}\n".encode("utf-8")
                        self._send(500, body)
                        return
                    self._send(200, body)
                elif self.path == "/healthz":
                    self._send(200, b"ok\n", content_type="text/plain")
                else:
                    self._send(404, b"not found\n", content_type="text/plain")

            def _send(self, code, body, content_type=CONTENT_TYPE):
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._render_fn = render_fn
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="rt1-obs-metrics",
            daemon=True,
        )
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}/metrics"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
