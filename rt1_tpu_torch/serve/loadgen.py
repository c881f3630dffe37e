"""Load generator for the port's serving path: `python -m
rt1_tpu_torch.serve.loadgen` (counterpart of `scripts/serve_loadgen.py`,
with the same flags, modes, outcome classes, record keys and exit code).

Drives N concurrent synthetic sessions and prints one BENCH-style JSON line
(metric / value / unit plus supporting fields):

  # single server (terminal 1 + 2):
  python -m rt1_tpu_torch.serve --config tiny --random_init --port 8321 --device cpu
  python -m rt1_tpu_torch.serve.loadgen --url http://127.0.0.1:8321 \
      --sessions 8 --steps 32

  # fleet + chaos, one command (spawns python -m rt1_tpu_torch.serve.fleet,
  # waits for all replicas ready, drives load THROUGH the router while
  # the supervisor kills and reloads replicas on the fault schedule):
  python -m rt1_tpu_torch.serve.loadgen --fleet 3 --config tiny --device cpu \
      --faults "replica_kill@1,serve_reload@2" --duration 30 --output /tmp/fleet.json

Seven modes: the plain run against `--url` (with `--traced`), the tracing
A/B `--overhead_ab N`, the scheduler A/B `--occupancy_sweep` (with
`--cached_ab` windowed against KV-cached), the dtype A/B `--quant_ab`,
fleet chaos `--fleet N`, the elastic A/B `--traffic_schedule` and the
durable-sessions A/B `--migration_ab`. The modes that start replicas or
fleets run `python -m rt1_tpu_torch.serve` / `rt1_tpu_torch.serve.fleet`
with `--device` (default cuda) and `--config`, a config name of the port
(`language_table`, `tiny`) or the JAX config file of that name.
`--replica_metrics FILE` (port only) appends, for every replica a mode
reached, one JSON line with its fused-attention launches by variant from
its `/metrics`; the record itself keeps the JAX keys.

The exit code is 0 when `requests_failed == 0`; a replica or fleet that
exits or times out before its ready-line fails the run, naming it.

Each session thread: /reset, then a loop of /act requests carrying a
random uint8 frame (base64-packed) and an instruction drawn from a small
pool. The loop is `--steps`-bounded or `--duration`-bounded (time-based,
with jittered think-time arrivals — `--think_time` mean seconds between a
session's requests — so a chaos window is sampled by a steady open-ish
load rather than a start-line burst).

Every request lands in exactly one outcome class, each with its own
latency percentiles in the output:

* ``ok``         — 200
* ``migrated``   — 200 carrying ``"migrated": true``: the session's
                   replica was drained/reloaded/killed but its window
                   moved intact (live migration or a snapshot-ring
                   restore) — continuity, not degradation; an SLO-good
                   class.
* ``restarted``  — 200 carrying ``"restarted": true``: the session's
                   replica died and the router re-homed it (fresh context
                   window). Bounded, honest degradation — not an error.
* ``rejected``   — 503 after the retry budget (busy backpressure or a
                   no-ready-replicas window): shed load, client-visible
                   but clean.
* ``failed``     — transport failure or any 4xx/5xx beyond the above; a
                   fleet run's acceptance bar is ``requests_failed == 0``.

503s with ``retry: true`` are retried with a short backoff and counted
(`requests_busy_retried`) — backpressure is a measured quantity here.

The outcome stream also feeds the serving SLO ledger
(`rt1_tpu_torch/obs/slo.py`): the BENCH JSON carries an ``slo`` section
(availability, p50/p99 vs objective, error-budget burn per outcome class)
and the same judgement is written as a ``slo_summary.json`` artifact next
to ``--output`` (or at ``--slo_summary``) for
`python -m rt1_tpu_torch.obs.run_report`.

``--traced`` sends a client request id (`X-RT1-Request-Id`) plus
``"debug": true`` on every /act and verifies the id round-trips
(`request_id_mismatches` must stay 0); ``--overhead_ab N`` measures the
tracing tax — N alternating traced/untraced passes, best-of per side —
as ``tracing_overhead_pct`` (budget: <2%).
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import select
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

from rt1_tpu_torch.obs.quantiles import percentile
from rt1_tpu_torch.obs.slo import SLOLedger, SLOObjectives
from rt1_tpu_torch.serve.reqtrace import REQUEST_ID_HEADER

#: The fused-attention launch gauges a replica's /metrics carries.
LAUNCH_KEYS = (
    "attention_launches_total",
    "attention_launches_tensor_core_total",
    "attention_launches_tf32x3_total",
    "attention_launches_simple_total",
)

INSTRUCTION_POOL = (
    "push the red moon to the blue cube",
    "move the blue cube to the green star",
    "slide the yellow pentagon towards the red moon",
    "separate the red moon from the blue cube",
)

OUTCOME_CLASSES = ("ok", "migrated", "restarted", "rejected", "failed")


class ReplicaStartError(RuntimeError):
    """A replica or fleet this loadgen started exited, or did not print its
    ready-line in time; the message names its command."""


def _post(
    url: str, payload: dict, timeout: float, headers: dict | None = None
) -> tuple[int, dict]:
    req = urllib.request.Request(
        url,
        data=json.dumps(payload).encode("utf-8"),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        try:
            body = json.loads(exc.read())
        except Exception:  # noqa: BLE001 - non-JSON error body
            body = {"error": str(exc)}
        return exc.code, body
    except (urllib.error.URLError, OSError, ValueError) as exc:
        # Connection refused/reset, socket timeout, bad body: report as a
        # transport failure (status 0) instead of killing the worker
        # thread — a dead worker would break the start barrier for every
        # other session.
        return 0, {"error": str(exc)}


def _get(url: str, timeout: float) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


def _note_replica_metrics(args, label: str, url: str) -> None:
    """`--replica_metrics FILE`: append one JSON line with `url`'s fused-
    attention launch gauges (its /metrics), or the error reading them."""
    path = getattr(args, "replica_metrics", "")
    if not path:
        return
    try:
        metrics = _get(url.rstrip("/") + "/metrics", args.timeout)
    except (urllib.error.URLError, OSError, ValueError) as exc:
        row = {"label": label, "url": url, "error": str(exc)}
    else:
        row = {
            "label": label,
            "url": url,
            "replica_id": metrics.get("replica_id"),
            "inference_dtype": metrics.get("inference_dtype"),
            "engine_steps_total": metrics.get("engine_steps_total"),
            **{key: metrics.get(key) for key in LAUNCH_KEYS},
        }
    with open(path, "a") as f:
        f.write(json.dumps(row) + "\n")


def _note_fleet_metrics(args, label: str, fleet_status: dict) -> None:
    """`_note_replica_metrics` for every live replica of a fleet."""
    for replica in fleet_status.get("replicas", []):
        if replica.get("url"):
            _note_replica_metrics(
                args, f"{label}/replica_{replica.get('id')}", replica["url"]
            )


def parse_task_mix(spec: str) -> list:
    """``"blocktoblock:3,separate:1"`` -> a deterministic assignment
    pattern ``[b, b, b, s]`` (sessions take tasks round-robin from it, so
    every named task appears once enough sessions run — no sampling
    luck). Weights are rounded to ints (min 1); task slugs may themselves
    contain ``:`` (``unknown:play:2`` weights the slug ``unknown:play``).
    """
    pattern = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        name, sep, weight = entry.rpartition(":")
        if not sep:
            name, weight = entry, "1"
        try:
            count = max(int(round(float(weight))), 1)
        except ValueError:
            # The trailing segment is part of the slug, not a weight
            # ("unknown:play" with no explicit weight).
            name, count = entry, 1
        if not name:
            raise ValueError(f"task mix entry {entry!r} has no task name")
        pattern.extend([name] * count)
    return pattern


def _session_worker(
    url: str,
    session_id: str,
    steps: int,
    duration_s: float,
    think_time_s: float,
    image_shape: tuple,
    instruction: str,
    timeout: float,
    max_retries: int,
    barrier: threading.Barrier,
    out: dict,
    rng: np.random.Generator,
    traced: bool = False,
    task: str | None = None,
    cycle_steps: int = 0,
):
    # latencies[class] = [seconds]; `events` is the same stream in
    # completion order (t_end, class, seconds) so the SLO ledger's
    # rolling window sees requests the way a router would. Record a
    # result no matter how this thread exits, and never skip the
    # barrier: a missing wait would deadlock every other session.
    latencies = {k: [] for k in OUTCOME_CLASSES}
    record = {
        "latencies": latencies,
        "events": [],
        "busy": 0,
        "rid_mismatches": 0,
    }
    out[session_id] = record  # in place from the start: a dying thread
    #                           still leaves a valid (partial) record
    retries = 0
    while True:
        status, body = _post(
            url + "/reset", {"session_id": session_id}, timeout
        )
        # A 503 retry:true reset (every slot mid-step under the
        # double-buffered scheduler) is backpressure, same as /act busy.
        if status == 503 and body.get("retry") and retries < max_retries:
            retries += 1
            record["busy"] += 1
            time.sleep(0.005)
            continue
        break
    _barrier_wait(barrier, timeout)  # start all act loops together
    if status != 200:
        # Reset failed; the whole session is lost — one failed marker
        # (not a per-step fabrication, which would poison the failed-class
        # percentiles and the duration-mode counts).
        latencies["failed"].append(0.0)
        record["events"].append((time.perf_counter(), "failed", 0.0))
        return
    deadline = time.perf_counter() + duration_s if duration_s > 0 else None
    step = 0
    base_sid = session_id
    steps_in_session = 0
    cycle = 0
    while True:
        if deadline is not None:
            if time.perf_counter() >= deadline:
                break
        elif step >= steps:
            break
        if cycle_steps > 0 and steps_in_session >= cycle_steps:
            # Bounded session lifetimes (elastic-bench traffic shape): a
            # closed-loop client population with session churn, so new
            # sessions keep arriving for the router to place — the only
            # way freshly-booted surge replicas ever receive work (an
            # affine session never migrates off a healthy replica).
            _post(url + "/release", {"session_id": session_id}, timeout)
            cycle += 1
            session_id = f"{base_sid}-r{cycle}"
            steps_in_session = 0
            _post(url + "/reset", {"session_id": session_id}, timeout)
        step += 1
        steps_in_session += 1
        frame = rng.integers(0, 256, size=image_shape, dtype=np.uint8)
        payload = {
            "session_id": session_id,
            "image_b64": base64.b64encode(frame.tobytes()).decode("ascii"),
            "instruction": instruction,
        }
        # One admission token bucket per WORKER across session churn (the
        # router falls back to the session id when absent).
        payload["client_id"] = base_sid
        if task:
            # Per-task serve labels exercised at load: the
            # same tag a real client declares.
            payload["task"] = task
        headers = None
        if traced:
            # Client-minted id + debug phases: proves the propagation
            # contract under load (the server must echo the id, and the
            # phase breakdown must carry the same one).
            rid = f"{session_id}-{step:06d}"
            headers = {REQUEST_ID_HEADER: rid}
            payload["debug"] = True
        retries = 0
        t0 = time.perf_counter()
        while True:
            status, body = _post(url + "/act", payload, timeout, headers)
            if (
                status == 503
                and body.get("retry")
                and retries < max_retries
            ):
                retries += 1
                record["busy"] += 1
                time.sleep(0.005)
                continue
            break
        elapsed = time.perf_counter() - t0
        if status == 200 and "action" in body:
            # Precedence mirrors the router's booking: a migrated flag
            # means the event happened AND the window survived it.
            if body.get("migrated"):
                klass = "migrated"
            elif body.get("restarted"):
                klass = "restarted"
            else:
                klass = "ok"
            if traced and (
                body.get("request_id") != rid
                or (body.get("phases") or {}).get("request_id") != rid
            ):
                record["rid_mismatches"] += 1
        elif status in (429, 503):
            # 503 = shed after the retry budget; 429 = admission-control
            # shed (never retried — the router said back off, and the
            # retry loop above only honors 503 retry:true). Both are
            # clean, client-visible load shedding: `rejected`.
            klass = "rejected"
        else:
            klass = "failed"  # transport death or unexpected 4xx/5xx
        latencies[klass].append(elapsed)
        record["events"].append((time.perf_counter(), klass, elapsed))
        if think_time_s > 0:
            # Jittered arrivals: uniform on [0, 2*mean] keeps the mean
            # think time while decorrelating sessions.
            time.sleep(rng.uniform(0.0, 2.0 * think_time_s))


def _barrier_wait(barrier: threading.Barrier, timeout: float) -> None:
    try:
        barrier.wait(timeout=timeout)
    except threading.BrokenBarrierError:
        pass  # a sibling died/timed out; run unsynchronized rather than hang


def run_loadgen(
    url: str,
    sessions: int = 8,
    steps: int = 32,
    duration_s: float = 0.0,
    think_time_s: float = 0.0,
    image_shape=None,
    timeout: float = 30.0,
    max_retries: int = 400,
    seed: int = 0,
    traced: bool = False,
    slo_objectives: SLOObjectives | None = None,
    task_mix: str = "",
    session_cycle_steps: int = 0,
    session_prefix: str = "loadgen",
) -> dict:
    """Run the synthetic load and return the BENCH-style result dict.

    `duration_s > 0` switches from step-bounded to time-bounded sessions
    (chaos runs want a fixed observation window, not a fixed request
    count). Latency percentiles are reported overall AND per outcome
    class, so "how slow was a restarted request" is a first-class number.
    The whole outcome stream is replayed (in completion order) into an
    `SLOLedger`, whose judgement rides the result as ``"slo"``.
    """
    url = url.rstrip("/")
    health = _get(url + "/healthz", timeout)
    if image_shape is None:
        image_shape = tuple(health["image_shape"])
    task_pattern = parse_task_mix(task_mix)
    barrier = threading.Barrier(sessions)
    out: dict = {}
    threads = []
    t_start = time.perf_counter()
    for i in range(sessions):
        rng = np.random.default_rng(seed + i)
        thread = threading.Thread(
            target=_session_worker,
            args=(
                url,
                f"{session_prefix}-{i}",
                steps,
                duration_s,
                think_time_s,
                image_shape,
                INSTRUCTION_POOL[i % len(INSTRUCTION_POOL)],
                timeout,
                max_retries,
                barrier,
                out,
                rng,
                traced,
                task_pattern[i % len(task_pattern)] if task_pattern else None,
                session_cycle_steps,
            ),
            name=f"{session_prefix}-{i}",
        )
        thread.start()
        threads.append(thread)
    for thread in threads:
        thread.join()
    wall = time.perf_counter() - t_start

    by_class = {
        klass: sorted(
            lat
            for result in out.values()
            for lat in result["latencies"][klass]
        )
        for klass in OUTCOME_CLASSES
    }
    answered = sorted(
        by_class["ok"] + by_class["migrated"] + by_class["restarted"]
    )
    busy = sum(result["busy"] for result in out.values())
    rid_mismatches = sum(
        result.get("rid_mismatches", 0) for result in out.values()
    )
    server_metrics = _get(url + "/metrics", timeout)

    # Client-side SLO ledger: the merged event stream in completion order,
    # so the rolling-window gauges mean what they would on the router.
    ledger = SLOLedger(slo_objectives or SLOObjectives())
    events = sorted(
        event for result in out.values() for event in result["events"]
    )
    for _, klass, seconds in events:
        ledger.observe(klass, seconds)

    result = {
        "metric": "serve_requests_per_sec",
        "value": round(len(answered) / wall, 3) if wall > 0 else 0.0,
        "unit": "req/s",
        "sessions": sessions,
        "steps_per_session": steps if duration_s <= 0 else None,
        "duration_s": round(duration_s, 3) if duration_s > 0 else None,
        "think_time_s": think_time_s,
        "requests_ok": len(by_class["ok"]),
        "requests_migrated": len(by_class["migrated"]),
        "requests_restarted": len(by_class["restarted"]),
        "requests_rejected": len(by_class["rejected"]),
        "requests_failed": len(by_class["failed"]),
        "requests_busy_retried": busy,
        "wall_s": round(wall, 4),
        # Shared estimator (obs/quantiles.py): the same
        # nearest-rank percentile the SLO ledger and serve metrics use.
        "latency_p50_ms": round(percentile(answered, 0.50) * 1e3, 3),
        "latency_p99_ms": round(percentile(answered, 0.99) * 1e3, 3),
        "latency_by_class": {
            klass: {
                "count": len(lats),
                "p50_ms": round(percentile(lats, 0.50) * 1e3, 3),
                "p99_ms": round(percentile(lats, 0.99) * 1e3, 3),
            }
            for klass, lats in by_class.items()
        },
        "traced": traced,
        "request_id_mismatches": rid_mismatches if traced else None,
        "task_mix": task_mix or None,
        "tasks_assigned": (
            {
                t: sum(
                    1
                    for i in range(sessions)
                    if task_pattern[i % len(task_pattern)] == t
                )
                for t in sorted(set(task_pattern))
            }
            if task_pattern
            else None
        ),
        "session_cycle_steps": session_cycle_steps or None,
        "slo": ledger.summary(),
        "mean_batch_occupancy": round(
            server_metrics.get("mean_batch_occupancy", 0.0), 3
        ),
        "max_batch_occupancy": server_metrics.get("max_batch_occupancy", 0),
        "server_compile_count": server_metrics.get("compile_count"),
        "image_shape": list(image_shape),
    }
    return result


# --------------------------------------------------------------- overhead


def run_overhead_ab(args) -> dict:
    """Traced-vs-untraced request-rate A/B against one server.

    "Traced" = client request id header + ``debug: true`` phases on every
    request — the full per-request tracing surface. Sides alternate
    (A/B then B/A per round) and each side reports its best pass, because
    on a co-tenant-loaded host a whole pass can be poisoned by CPU theft;
    the max over alternating passes is the honest throughput floor-free
    comparison (same methodology as bench.py --health A/B).
    """
    sides: dict = {"untraced": [], "traced": []}
    order = ("untraced", "traced")
    image_shape = None
    if args.height and args.width:
        image_shape = (args.height, args.width, 3)
    for round_i in range(args.overhead_ab):
        for side in order if round_i % 2 == 0 else order[::-1]:
            r = run_loadgen(
                args.url,
                sessions=args.sessions,
                steps=args.steps,
                duration_s=args.duration,
                think_time_s=args.think_time,
                image_shape=image_shape,
                timeout=args.timeout,
                max_retries=args.max_retries,
                seed=args.seed + round_i,
                traced=side == "traced",
            )
            sides[side].append(
                {
                    "req_per_sec": r["value"],
                    "p50_ms": r["latency_p50_ms"],
                    "failed": r["requests_failed"],
                    "rid_mismatches": r["request_id_mismatches"],
                }
            )
    best = {
        side: max(p["req_per_sec"] for p in passes)
        for side, passes in sides.items()
    }
    overhead_pct = (
        (best["untraced"] - best["traced"]) / best["untraced"] * 100.0
        if best["untraced"] > 0
        else 0.0
    )
    return {
        "metric": "serve_tracing_overhead_pct",
        "value": round(overhead_pct, 3),
        "unit": "%",
        "budget_pct": 2.0,
        # A side that answered nothing measures nothing: no verdict.
        "within_budget": overhead_pct < 2.0 and best["untraced"] > 0,
        "rounds": args.overhead_ab,
        "sessions": args.sessions,
        "steps_per_session": args.steps,
        "best_req_per_sec": {k: round(v, 3) for k, v in best.items()},
        "passes": sides,
        "request_id_mismatches": sum(
            p["rid_mismatches"] or 0 for p in sides["traced"]
        ),
        "requests_failed": sum(
            p["failed"] for passes in sides.values() for p in passes
        ),
        "timing_methodology": (
            "alternating traced/untraced passes (ABBA), best-of per side; "
            "single pass pairs are unreliable on a host with bursty "
            "co-tenant CPU theft"
        ),
    }


# -------------------------------------------------------------- occupancy


def run_occupancy_sweep(args) -> dict:
    """Old-vs-new scheduling A/B across fixed concurrency levels: boot
    one replica on the legacy cycle scheduler (wait-for-deadline-or-full,
    a single full-size bucket) and one on
    the continuous scheduler (rolling dispatch, double-buffered pipeline,
    auto bucket ladder), drive each at every `--sweep_levels` concurrency,
    and fold req/s + p50/p99 per level into one BENCH record
    (`BENCH_serve_batching.json`).

    The acceptance shape: the new path must match-or-beat req/s at full
    occupancy AND cut p50 at low occupancy (1-2 clients, where the cycle
    path pays the max_delay deadline and the full-batch step cost), with
    `compile_count` pinned at the bucket count on both sides.

    With ``--cached_ab`` the two sides become windowed vs
    KV-cached incremental decode on the SAME continuous scheduler — the
    occupancy-ceiling view of `BENCH_serve_kvcache.json`: a cached step
    does O(frame) device work instead of O(window), so the same slot
    batch sustains more req/s at full occupancy.
    """
    levels = [
        int(x) for x in args.sweep_levels.split(",") if x.strip()
    ]
    if getattr(args, "cached_ab", False):
        sides = {
            "windowed": [
                "--scheduler", "continuous",
                "--buckets", "auto",
            ],
            "kv_cached": [
                "--scheduler", "continuous",
                "--buckets", "auto",
                "--cached_inference",
            ],
        }
    else:
        sides = {
            "old_cycle": [
                "--scheduler", "cycle",
                "--buckets", str(args.max_sessions),
            ],
            "new_continuous": [
                "--scheduler", "continuous",
                "--buckets", "auto",
            ],
        }
    # Both servers stay up for the whole sweep; passes alternate side
    # order per round (ABBA) and each (side, level) keeps its best pass —
    # the same co-tenant-CPU-theft methodology as --overhead_ab and
    # bench.py --health A/Bs.
    servers: dict = {}
    per_side: dict = {}
    try:
        for side, extra in sides.items():
            servers[side] = _spawn_server(
                args, args.inference_dtype, extra
            )
            per_side[side] = {"levels": {}}
        order = tuple(sides)
        for round_i in range(max(args.sweep_rounds, 1)):
            for side in order if round_i % 2 == 0 else order[::-1]:
                _, url, _ = servers[side]
                for level in levels:
                    # Settle: the continuous scheduler's demand window
                    # (~1 s of session history) must decay between
                    # levels, or a 1-client pass right after a 16-client
                    # one coalesces against stale demand.
                    time.sleep(1.5)
                    before = _get(url + "/metrics", args.timeout)
                    run = run_loadgen(
                        url,
                        sessions=level,
                        steps=args.steps,
                        think_time_s=args.think_time,
                        timeout=args.timeout,
                        max_retries=args.max_retries,
                        seed=args.seed + level + 101 * round_i,
                    )
                    after = _get(url + "/metrics", args.timeout)
                    # Per-pass occupancy: the server gauge is lifetime-
                    # cumulative, so difference the sums across the pass.
                    d_batches = (
                        after["batches_total"] - before["batches_total"]
                    )
                    d_occ = (
                        after["mean_batch_occupancy"]
                        * after["batches_total"]
                        - before["mean_batch_occupancy"]
                        * before["batches_total"]
                    )
                    row = {
                        "req_per_sec": run["value"],
                        "latency_p50_ms": run["latency_p50_ms"],
                        "latency_p99_ms": run["latency_p99_ms"],
                        "mean_batch_occupancy": (
                            round(d_occ / d_batches, 3)
                            if d_batches
                            else 0.0
                        ),
                        "requests_ok": run["requests_ok"],
                        "requests_failed": run["requests_failed"],
                        "requests_busy_retried": run[
                            "requests_busy_retried"
                        ],
                        "passes": 1,
                    }
                    best = per_side[side]["levels"].get(str(level))
                    if best is None:
                        per_side[side]["levels"][str(level)] = row
                    else:
                        # Best pass wins the rate/latency columns; the
                        # failure counters accumulate (the bar is zero
                        # across EVERY pass, not just the best one).
                        row["requests_failed"] += best["requests_failed"]
                        row["requests_busy_retried"] += best[
                            "requests_busy_retried"
                        ]
                        row["passes"] = best["passes"] + 1
                        if row["req_per_sec"] < best["req_per_sec"]:
                            for key in (
                                "req_per_sec",
                                "latency_p50_ms",
                                "latency_p99_ms",
                                "mean_batch_occupancy",
                                "requests_ok",
                            ):
                                row[key] = best[key]
                        per_side[side]["levels"][str(level)] = row
        for side in sides:
            _, url, ready = servers[side]
            metrics = _get(url + "/metrics", args.timeout)
            _note_replica_metrics(args, f"occupancy_sweep/{side}", url)
            per_side[side].update(
                {
                    "scheduler": ready.get("scheduler"),
                    "buckets": ready.get("buckets"),
                    "compile_count": metrics.get("compile_count"),
                    "bucket_count": metrics.get("bucket_count"),
                    "bucket_batches": metrics.get("bucket_batches"),
                    "joined_mid_cycle_total": metrics.get(
                        "joined_mid_cycle_total"
                    ),
                    "max_batches_in_flight": metrics.get(
                        "max_batches_in_flight"
                    ),
                    "cached_inference": bool(
                        ready.get("cached_inference", False)
                    ),
                    "cache_cached_steps_total": metrics.get(
                        "cache_cached_steps_total", 0
                    ),
                    "cache_bytes_per_slot": metrics.get(
                        "cache_bytes_per_slot", 0
                    ),
                }
            )
    finally:
        for proc, _, _ in servers.values():
            proc.send_signal(signal.SIGTERM)
        for proc, _, _ in servers.values():
            try:
                proc.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()

    full = str(args.max_sessions)
    low = str(levels[0])
    baseline_name, test_name = list(sides)
    old = per_side[baseline_name]["levels"]
    new = per_side[test_name]["levels"]
    speedup_full = (
        new[full]["req_per_sec"] / old[full]["req_per_sec"]
        if full in new and old.get(full, {}).get("req_per_sec")
        else 0.0
    )
    return {
        "metric": (
            "serve_kvcache_speedup_full_occupancy"
            if getattr(args, "cached_ab", False)
            else "serve_continuous_batching_speedup_full_occupancy"
        ),
        "value": round(speedup_full, 3),
        "unit": "x",
        "levels": levels,
        "steps_per_session": args.steps,
        "max_sessions": args.max_sessions,
        "per_side": per_side,
        "p50_low_occupancy_ms": {
            baseline_name: old.get(low, {}).get("latency_p50_ms"),
            test_name: new.get(low, {}).get("latency_p50_ms"),
        },
        "p50_speedup_low_occupancy": (
            round(
                old[low]["latency_p50_ms"] / new[low]["latency_p50_ms"], 3
            )
            if new.get(low, {}).get("latency_p50_ms")
            else 0.0
        ),
        "requests_failed": sum(
            row["requests_failed"]
            for side in per_side.values()
            for row in side["levels"].values()
        ),
        "compile_count_pinned_at_bucket_count": all(
            side["compile_count"] == side["bucket_count"]
            for side in per_side.values()
        ),
        "sweep_rounds": args.sweep_rounds,
        "timing_methodology": (
            "one random-init replica per side (identical seeded "
            "weights), closed-loop clients per concurrency level, "
            "alternating ABBA passes with best-of per (side, level) — "
            "single passes are unreliable under bursty co-tenant CPU "
            "theft (same methodology as --overhead_ab); failure counts "
            "accumulate across ALL passes. "
            + (
                "windowed = full-window infer_step, kv_cached = "
                "per-session KV-cache incremental decode "
                "(--cached_inference), both on the continuous scheduler "
                "+ pow2 bucket ladder"
                if getattr(args, "cached_ab", False)
                else "old = cycle scheduler + single full-size bucket, "
                "new = continuous scheduler + pow2 bucket ladder + "
                "double-buffered dispatch"
            )
        ),
    }


# ------------------------------------------------------------------ quant


def _spawn_server(args, inference_dtype: str, extra_args=None):
    """Boot one `python -m rt1_tpu_torch.serve` replica at
    `inference_dtype` on `--device`; returns (proc, url, ready_line) once
    the ready-line lands."""
    cmd = [
        sys.executable, "-m", "rt1_tpu_torch.serve",
        "--config", args.config,
        "--random_init",
        "--port", "0",
        "--max_sessions", str(args.max_sessions),
        "--inference_dtype", inference_dtype,
        "--device", args.device,
        *(extra_args or []),
    ]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)
    deadline = time.time() + args.fleet_warmup_timeout_s
    while True:
        if proc.poll() is not None:
            raise ReplicaStartError(
                f"replica `{' '.join(cmd[1:])}` exited "
                f"rc={proc.returncode} before ready"
            )
        if time.time() > deadline:
            proc.kill()
            proc.wait()
            raise ReplicaStartError(
                f"replica `{' '.join(cmd[1:])}` not ready in "
                f"{args.fleet_warmup_timeout_s} s"
            )
        # select-gate the pipe read: a live replica that is still
        # compiling writes nothing, and a bare readline() would block past
        # the deadline forever.
        readable, _, _ = select.select([proc.stdout], [], [], 1.0)
        if not readable:
            continue
        line = proc.stdout.readline()
        if not line:
            time.sleep(0.1)
            continue
        try:
            ready = json.loads(line)
        except json.JSONDecodeError:
            continue
        if ready.get("status") == "serving":
            return proc, f"http://127.0.0.1:{ready['port']}", ready


def _parity_probe(url: str, image_shape, embed_dim: int, steps: int,
                  seed: int, timeout: float):
    """Drive one session through `steps` DETERMINISTIC frames (seeded rng,
    fixed embedding) and return the per-step action-token lists — the
    HTTP-level twin of serve/parity.py. Identical streams against
    two servers of different dtype make their token streams comparable."""
    rng = np.random.default_rng(seed)
    embedding = rng.standard_normal(embed_dim).astype(np.float32)
    sid = "quant-parity"
    status, _ = _post(url + "/reset", {"session_id": sid}, timeout)
    if status != 200:
        raise RuntimeError(f"parity probe /reset failed: {status}")
    tokens = []
    for _ in range(steps):
        frame = rng.integers(0, 256, size=image_shape, dtype=np.uint8)
        status, body = _post(
            url + "/act",
            {
                "session_id": sid,
                "image_b64": base64.b64encode(frame.tobytes()).decode(
                    "ascii"
                ),
                "embedding": [float(x) for x in embedding],
            },
            timeout,
        )
        if status != 200:
            raise RuntimeError(f"parity probe /act failed: {status} {body}")
        tokens.append(list(body["action_tokens"]))
    _post(url + "/release", {"session_id": sid}, timeout)
    return tokens


def run_quant_ab(args) -> dict:
    """Per-dtype serving A/B: boot one random-init replica per
    `--quant_ab` dtype (the same seeded weights), measure latency/req/s
    under identical load, probe action-token parity against the f32 side
    over HTTP, and record host+device param bytes.

    Two byte accountings ride the record: the MEASURED serving tree of
    the config under test (at `tiny` the 256-entry position table
    dominates and caps the reduction) and the flagship projection from
    shapes (`--byte_report_config`, `models/quant.py::quant_byte_report`)
    — the tree a production fleet actually holds. The int8 side
    dequantizes each weight at use, so its latency is the dequant-added
    path; bytes resident are the measured win.
    """
    dtypes = [d.strip() for d in args.quant_ab.split(",") if d.strip()]
    if "f32" not in dtypes:
        dtypes = ["f32"] + dtypes  # parity needs the reference side
    per_dtype: dict = {}
    parity_tokens: dict = {}
    for dtype in dtypes:
        proc, url, ready = _spawn_server(args, dtype)
        try:
            health = _get(url + "/healthz", args.timeout)
            image_shape = tuple(health["image_shape"])
            parity_tokens[dtype] = _parity_probe(
                url, image_shape, health.get("embed_dim", 512),
                args.parity_steps, args.seed + 7919, args.timeout,
            )
            run = run_loadgen(
                url,
                sessions=args.sessions,
                steps=args.steps,
                duration_s=args.duration,
                think_time_s=args.think_time,
                timeout=args.timeout,
                max_retries=args.max_retries,
                seed=args.seed,
                slo_objectives=_objectives(args),
            )
            metrics = _get(url + "/metrics", args.timeout)
            _note_replica_metrics(args, f"quant_ab/{dtype}", url)
            per_dtype[dtype] = {
                "req_per_sec": run["value"],
                "latency_p50_ms": run["latency_p50_ms"],
                "latency_p99_ms": run["latency_p99_ms"],
                "requests_ok": run["requests_ok"],
                "requests_failed": run["requests_failed"],
                "compile_count": metrics.get("compile_count"),
                "param_bytes_device": metrics.get("param_bytes_device"),
                "param_bytes_master": metrics.get("param_bytes_master"),
            }
        finally:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
    reference = np.asarray(parity_tokens["f32"])
    for dtype in dtypes:
        tokens = np.asarray(parity_tokens[dtype])
        total = int(reference.size)
        agree = int((tokens == reference).sum())
        per_dtype[dtype]["parity"] = {
            "tokens_total": total,
            "tokens_agree": agree,
            "agreement": round(agree / total, 4) if total else 1.0,
        }
    f32_bytes = per_dtype["f32"]["param_bytes_device"]
    for dtype in dtypes:
        dev = per_dtype[dtype]["param_bytes_device"]
        per_dtype[dtype]["byte_reduction_vs_f32"] = (
            round(f32_bytes / dev, 3) if dev else 0.0
        )

    flagship_report = None
    if args.byte_report_config:
        try:
            from rt1_tpu_torch.configs import get_config
            from rt1_tpu_torch.models.quant import quant_byte_report

            flagship_report = quant_byte_report(
                get_config(args.byte_report_config)
            )
        except Exception as exc:  # noqa: BLE001 - report, don't fail the run
            flagship_report = {"error": str(exc)}

    headline = (flagship_report or {}).get(
        "int8_reduction",
        per_dtype.get("int8", {}).get("byte_reduction_vs_f32", 0.0),
    )
    return {
        "metric": "serve_param_bytes_reduction_int8",
        "value": headline,
        "unit": "x",
        "dtypes": dtypes,
        "per_dtype": per_dtype,
        "requests_failed": sum(
            row["requests_failed"] for row in per_dtype.values()
        ),
        "parity_steps": args.parity_steps,
        "sessions": args.sessions,
        "steps_per_session": args.steps if args.duration <= 0 else None,
        "duration_s": args.duration if args.duration > 0 else None,
        "flagship_byte_report": flagship_report,
        "timing_methodology": (
            "one random-init replica per dtype (identical seeded weights), "
            "identical load per side; parity = HTTP action-token agreement "
            "vs the f32 side on one deterministic frame stream"
        ),
        "honesty_note": (
            "the int8 side dequantizes each weight to the compute dtype at "
            "use (no int8 matmul), so its req/s is not an int8 speed-up; "
            "the measured win is param bytes resident (device + master "
            "columns, flagship_byte_report for the production tree)"
        ),
    }


def build_parser() -> argparse.ArgumentParser:
    """The loadgen's flags (JAX's, plus `--device` and `--replica_metrics`)."""
    parser = argparse.ArgumentParser(
        prog="python -m rt1_tpu_torch.serve.loadgen",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("--url", default="http://127.0.0.1:8321")
    parser.add_argument("--sessions", type=int, default=8)
    parser.add_argument("--steps", type=int, default=32)
    parser.add_argument(
        "--duration", type=float, default=0.0,
        help="Run each session for this many seconds instead of --steps "
             "(chaos windows are time-shaped, not count-shaped).")
    parser.add_argument(
        "--think_time", type=float, default=0.0,
        help="Mean seconds between a session's requests, jittered "
             "uniform [0, 2x] (0 = closed loop, back-to-back).")
    parser.add_argument(
        "--max_retries", type=int, default=400,
        help="Busy-retry budget per request; past it the request counts "
             "as 'rejected'.")
    parser.add_argument(
        "--height", type=int, default=0,
        help="Frame height (0 = read from /healthz).")
    parser.add_argument(
        "--width", type=int, default=0,
        help="Frame width (0 = read from /healthz).")
    parser.add_argument("--timeout", type=float, default=30.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--output", default="",
        help="Also write the JSON to this path (stdout either way).")
    parser.add_argument(
        "--traced", action="store_true",
        help="Send a client request id (X-RT1-Request-Id) + debug:true "
             "phases on every /act and verify the id round-trips.")
    parser.add_argument(
        "--overhead_ab", type=int, default=0,
        help="Measure tracing overhead: N alternating traced/untraced "
             "rounds against --url, best-of per side (budget <2%%).")
    parser.add_argument(
        "--slo_availability", type=float, default=0.99,
        help="SLO objective: fraction of requests that must be ok.")
    parser.add_argument(
        "--slo_p50_ms", type=float, default=250.0,
        help="SLO objective: answered-request p50 (ms).")
    parser.add_argument(
        "--slo_p99_ms", type=float, default=2500.0,
        help="SLO objective: answered-request p99 (ms).")
    parser.add_argument(
        "--slo_summary", default="",
        help="Write the SLO ledger judgement here (default: "
             "slo_summary.json next to --output when --output is set).")
    # Fleet mode: spawn and chaos-drive python -m rt1_tpu_torch.serve.fleet.
    parser.add_argument(
        "--fleet", type=int, default=0,
        help="Spawn a fleet of N replicas behind the router and drive "
             "load through it (0 = plain --url mode).")
    parser.add_argument("--config", default="",
                        help="[fleet, A/Bs] config of real replicas: "
                             "language_table | tiny (or the JAX config "
                             "file of that name).")
    parser.add_argument("--device", default="cuda",
                        help="[fleet, A/Bs] device of real replicas: "
                             "cuda | cpu.")
    parser.add_argument(
        "--replica_metrics", default="",
        help="Append one JSON line per replica reached (its fused-"
             "attention launches by variant from /metrics) to this file.")
    parser.add_argument("--workdir", default="",
                        help="[fleet] checkpoint dir for real replicas.")
    parser.add_argument("--random_init", action="store_true",
                        help="[fleet] serve random init (implied when no "
                             "--workdir).")
    parser.add_argument("--stub", action="store_true",
                        help="[fleet] model-free stub replicas.")
    parser.add_argument("--embedder", default="hash")
    parser.add_argument("--max_sessions", type=int, default=8)
    parser.add_argument(
        "--faults", default="",
        help="[fleet] chaos plan, e.g. 'replica_kill@1,serve_reload@2'.")
    parser.add_argument("--chaos_interval_s", type=float, default=2.0)
    parser.add_argument("--replica_timeout_s", type=float, default=15.0)
    parser.add_argument("--fleet_warmup_timeout_s", type=float, default=600.0)
    parser.add_argument("--log_dir", default="",
                        help="[fleet] per-replica stderr log dir.")
    parser.add_argument(
        "--inference_dtype", default="f32",
        choices=["f32", "bf16", "int8"],
        help="[fleet] low-precision serving mode forwarded to every "
             "replica (models/quant.py).")
    parser.add_argument(
        "--replica_dtypes", default="",
        help="[fleet] per-replica dtype list (cycled), e.g. 'f32,int8' — "
             "a mixed-dtype fleet; overrides --inference_dtype.")
    parser.add_argument(
        "--occupancy_sweep", action="store_true",
        help="Old-vs-new scheduling A/B: boot one cycle-"
             "scheduler replica and one continuous-scheduler replica "
             "(--config required), drive each at every --sweep_levels "
             "concurrency, write req/s + p50/p99 per level "
             "(BENCH_serve_batching.json via --output).")
    parser.add_argument(
        "--cached_ab", action="store_true",
        help="[occupancy_sweep] A/B windowed vs KV-cached incremental "
             "decode (--cached_inference) instead of cycle-vs-continuous "
             "— the occupancy-ceiling row of BENCH_serve_kvcache.json "
             "Both sides run the continuous scheduler.")
    parser.add_argument(
        "--sweep_levels", default="1,2,4,8,16",
        help="[occupancy_sweep] comma-separated concurrency levels.")
    parser.add_argument(
        "--sweep_rounds", type=int, default=2,
        help="[occupancy_sweep] alternating ABBA passes per side; each "
             "(side, level) reports its best pass (co-tenant CPU theft "
             "poisons single passes; failures accumulate across all).")
    # Elastic fleet A/B: --traffic_schedule drives the
    # elastic-vs-fixed cost/latency record (BENCH_serve_elastic.json).
    parser.add_argument(
        "--traffic_schedule", default="",
        help="Comma list of ramp|spike|diurnal: boot an elastic fleet "
             "(--min_replicas..--max_replicas, --surge_dtype) and a "
             "fixed-max fleet per schedule, drive the identical "
             "time-varying client population through both, and write the "
             "cost-per-request A/B (--output BENCH_serve_elastic.json).")
    parser.add_argument(
        "--schedule_base_sessions", type=int, default=2,
        help="[traffic_schedule] trough client population.")
    parser.add_argument(
        "--schedule_peak_sessions", type=int, default=12,
        help="[traffic_schedule] peak client population.")
    parser.add_argument(
        "--phase_duration", type=float, default=6.0,
        help="[traffic_schedule] seconds per phase.")
    parser.add_argument(
        "--min_replicas", type=int, default=1,
        help="[traffic_schedule] elastic-side autoscaler floor.")
    parser.add_argument(
        "--max_replicas", type=int, default=3,
        help="[traffic_schedule] autoscaler ceiling AND the fixed side's "
             "always-on fleet size.")
    parser.add_argument("--autoscale_interval_s", type=float, default=0.5)
    parser.add_argument("--scale_up_ticks", type=int, default=2)
    parser.add_argument("--scale_down_ticks", type=int, default=4)
    parser.add_argument("--active_window_s", type=float, default=2.0)
    parser.add_argument("--reclaim_grace_s", type=float, default=0.5)
    parser.add_argument(
        "--surge_dtype", default="int8",
        choices=["", "f32", "bf16", "int8"],
        help="[traffic_schedule] dtype for surge-tier replicas ('' = "
             "base dtype).")
    parser.add_argument(
        "--task_mix", default="",
        help="Weighted task tags for the client population, e.g. "
             "'blocktoblock:3,separate:1' — requests carry task= so the "
             "per-task serve labels (rt1_serve_task_*) are exercised at "
             "scale (any loadgen mode).")
    parser.add_argument(
        "--session_cycle_steps", type=int, default=12,
        help="[traffic_schedule] steps per session before the worker "
             "releases it and starts a fresh one (session churn keeps "
             "new placements flowing to surge replicas; 0 = sticky "
             "sessions).")
    parser.add_argument(
        "--admission_rate", type=float, default=0.0,
        help="[fleet/traffic_schedule] router token-bucket refill per "
             "client (req/s); 0 = admission control off.")
    parser.add_argument("--admission_burst", type=float, default=8.0)
    parser.add_argument(
        "--max_inflight", type=int, default=0,
        help="[fleet/traffic_schedule] router global shed threshold.")
    parser.add_argument(
        "--stub_act_delay_s", type=float, default=0.01,
        help="[traffic_schedule --stub] simulated device-step seconds.")
    parser.add_argument(
        "--stub_act_concurrency", type=int, default=1,
        help="[traffic_schedule --stub] simulated device steps running "
             "at once per stub (1 = serialize, like one device).")
    parser.add_argument(
        "--p99_envelope", type=float, default=1.5,
        help="[traffic_schedule] elastic peak-phase p99 must stay within "
             "this factor of the fixed-max fleet's.")
    parser.add_argument(
        "--migration_ab", action="store_true",
        help="Durable-sessions A/B (stub fleets): the same disruption "
             "gauntlet (chaos kill, /scale_down drain, rolling /reload, "
             "/rebalance) with and without the session snapshot ring; "
             "writes BENCH_serve_migration.json via --output. Uses "
             "--fleet (default 3), --sessions, --steps warmup acts.")
    parser.add_argument(
        "--rebalance_count", type=int, default=2,
        help="[migration_ab] hottest sessions to move per /rebalance.")
    parser.add_argument(
        "--quant_ab", default="",
        help="Per-dtype serving A/B: comma dtypes (e.g. 'f32,bf16,int8'); "
             "boots one random-init replica per dtype with --config, "
             "measures latency/req-s/param-bytes + HTTP token parity vs "
             "f32, and writes the BENCH_serve_quant.json record "
             "(--output).")
    parser.add_argument(
        "--parity_steps", type=int, default=24,
        help="[quant_ab] deterministic frames in the parity probe.")
    parser.add_argument(
        "--byte_report_config",
        default="language_table",
        help="[quant_ab] config whose shape-only per-dtype byte report "
             "rides the record ('' disables; default: the flagship "
             "config — the production serving tree).")
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)

    if args.replica_dtypes or args.quant_ab:
        # Same guard the fleet entry point applies: fail at THIS parser
        # with the typo named, not as a replica crash-loop downstream.
        from rt1_tpu_torch.serve.fleet import VALID_REPLICA_DTYPES, replica_dtype_for

        try:
            replica_dtype_for(args, 0)
        except ValueError as exc:
            parser.error(str(exc))
        for dtype in args.quant_ab.split(","):
            if dtype.strip() and dtype.strip() not in VALID_REPLICA_DTYPES:
                parser.error(
                    f"--quant_ab entry {dtype.strip()!r} is not one of "
                    f"{VALID_REPLICA_DTYPES}"
                )

    try:
        result = _run_mode(parser, args)
    except ReplicaStartError as exc:
        print(f"loadgen: {exc}", file=sys.stderr)
        return 1
    line = json.dumps(result)
    print(line)
    if args.output:
        with open(args.output, "w") as f:
            f.write(line + "\n")
    slo_path = args.slo_summary
    if not slo_path and args.output and "slo" in result:
        slo_path = os.path.join(
            os.path.dirname(os.path.abspath(args.output)), "slo_summary.json"
        )
    if slo_path and "slo" in result:
        tmp = slo_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(result["slo"], f, indent=2)
        os.replace(tmp, slo_path)  # readers never see a half-written file
        print(f"slo summary written to {slo_path}", file=sys.stderr)
    return 0 if result["requests_failed"] == 0 else 1


def _run_mode(parser, args) -> dict:
    """The record of the mode `args` selects."""
    from rt1_tpu_torch.serve.loadgen_fleet import (
        run_elastic_bench,
        run_fleet_chaos,
        run_migration_ab,
    )

    if args.traffic_schedule:
        if not args.stub and not args.config:
            parser.error("--traffic_schedule needs --config (or --stub)")
        if args.max_replicas < args.min_replicas:
            parser.error("--max_replicas must be >= --min_replicas")
        try:
            result = run_elastic_bench(args)
        except ValueError as exc:
            parser.error(str(exc))
    elif args.migration_ab:
        result = run_migration_ab(args)
    elif args.occupancy_sweep:
        if not args.config:
            parser.error("--occupancy_sweep needs --config")
        result = run_occupancy_sweep(args)
    elif args.quant_ab:
        if not args.config:
            parser.error("--quant_ab needs --config")
        result = run_quant_ab(args)
    elif args.fleet > 0:
        if not args.stub and not args.config:
            parser.error("--fleet needs --config (or --stub)")
        result = run_fleet_chaos(args)
    elif args.overhead_ab > 0:
        result = run_overhead_ab(args)
        _note_replica_metrics(args, "overhead_ab", args.url)
    else:
        image_shape = None
        if args.height and args.width:
            image_shape = (args.height, args.width, 3)
        result = run_loadgen(
            args.url,
            sessions=args.sessions,
            steps=args.steps,
            duration_s=args.duration,
            think_time_s=args.think_time,
            image_shape=image_shape,
            timeout=args.timeout,
            max_retries=args.max_retries,
            seed=args.seed,
            traced=args.traced,
            slo_objectives=_objectives(args),
            task_mix=args.task_mix,
        )
        _note_replica_metrics(args, "url", args.url)
    return result


def _objectives(args) -> SLOObjectives:
    return SLOObjectives(
        availability=args.slo_availability,
        latency_p50_ms=args.slo_p50_ms,
        latency_p99_ms=args.slo_p99_ms,
    )


if __name__ == "__main__":
    sys.exit(main())
