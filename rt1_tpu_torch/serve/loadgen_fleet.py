"""The fleet modes of `python -m rt1_tpu_torch.serve.loadgen`: chaos
through the router (`--fleet N`), the elastic-vs-fixed A/B
(`--traffic_schedule`) and the durable-sessions A/B (`--migration_ab`).
Each spawns `python -m rt1_tpu_torch.serve.fleet` and drives it with
`loadgen.run_loadgen`'s sessions (counterpart of the fleet half of
`scripts/serve_loadgen.py`).
"""

from __future__ import annotations

import json
import select
import signal
import subprocess
import sys
import time
import urllib.error

from rt1_tpu_torch.serve.loadgen import (
    INSTRUCTION_POOL,
    OUTCOME_CLASSES,
    ReplicaStartError,
    _get,
    _note_fleet_metrics,
    _objectives,
    _post,
    run_loadgen,
)


# ------------------------------------------------------------------ fleet


def _spawn_fleet(cmd, warmup_timeout_s: float):
    """Spawn `python -m rt1_tpu_torch.serve.fleet` and wait for its ready-line
    (printed only after EVERY replica passed warm-up); returns
    (proc, router_url, ready_line). The pipe read is select-gated (same
    as _spawn_server): a live fleet wedged in warm-up prints nothing,
    and a bare readline() would block past the deadline forever."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)
    deadline = time.time() + warmup_timeout_s
    while True:
        if proc.poll() is not None:
            raise ReplicaStartError(
                f"fleet `{' '.join(cmd[1:])}` exited rc={proc.returncode} "
                f"before ready"
            )
        if time.time() > deadline:
            proc.kill()
            try:
                proc.wait(timeout=10)  # reap: no zombie on the error path
            except subprocess.TimeoutExpired:
                pass
            raise ReplicaStartError(
                f"fleet `{' '.join(cmd[1:])}` not ready in "
                f"{warmup_timeout_s} s"
            )
        readable, _, _ = select.select([proc.stdout], [], [], 1.0)
        if not readable:
            continue
        line = proc.stdout.readline()
        if not line:
            time.sleep(0.1)
            continue
        try:
            parsed = json.loads(line)
        except json.JSONDecodeError:
            continue
        if parsed.get("status") == "serving":
            return proc, f"http://127.0.0.1:{parsed['port']}", parsed


def _stop_fleet(proc, timeout: float = 120.0) -> dict:
    """SIGTERM the fleet and return its final ``status: stopped`` line
    (the server-side SLO/autoscale/chaos evidence), or {} on a mangled
    shutdown."""
    proc.send_signal(signal.SIGTERM)
    try:
        stdout, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        try:
            proc.communicate(timeout=10)  # reap + close the pipe
        except subprocess.TimeoutExpired:
            pass
        return {}
    for line in reversed(stdout.splitlines()):
        try:
            parsed = json.loads(line)
        except json.JSONDecodeError:
            continue
        if parsed.get("status") == "stopped":
            return parsed
    return {}


def run_fleet_chaos(args) -> dict:
    """Spawn `python -m rt1_tpu_torch.serve.fleet`, drive load through the
    router while the supervisor injects the fault schedule, and fold the
    fleet's own evidence (restarts, reloads, per-replica compile counts)
    into the BENCH record."""
    cmd = [
        sys.executable, "-m", "rt1_tpu_torch.serve.fleet",
        "--replicas", str(args.fleet),
        "--port", "0",
        "--max_sessions", str(args.max_sessions),
        "--chaos_interval_s", str(args.chaos_interval_s),
        "--replica_timeout_s", str(args.replica_timeout_s),
        "--slo_availability", str(args.slo_availability),
        "--slo_p50_ms", str(args.slo_p50_ms),
        "--slo_p99_ms", str(args.slo_p99_ms),
    ]
    if args.faults:
        cmd += ["--faults", args.faults]
    if args.log_dir:
        cmd += ["--log_dir", args.log_dir]
    if args.inference_dtype != "f32":
        cmd += ["--inference_dtype", args.inference_dtype]
    if args.replica_dtypes:
        cmd += ["--replica_dtypes", args.replica_dtypes]
    if args.stub:
        cmd += ["--stub"]
    else:
        cmd += ["--config", args.config, "--embedder", args.embedder,
                "--device", args.device]
        if args.workdir:
            cmd += ["--workdir", args.workdir]
        else:
            cmd += ["--random_init"]

    # The fleet prints its ready-line only after EVERY replica passed
    # warm-up, so the chaos clock and the load start together.
    proc, url, _ready = _spawn_fleet(cmd, args.fleet_warmup_timeout_s)
    final_line = {}
    try:
        result = run_loadgen(
            url,
            sessions=args.sessions,
            steps=args.steps,
            duration_s=args.duration,
            think_time_s=args.think_time,
            timeout=args.timeout,
            max_retries=args.max_retries,
            seed=args.seed,
            traced=args.traced,
            slo_objectives=_objectives(args),
            task_mix=args.task_mix,
        )
        # Let the fleet heal before sampling the final evidence: a
        # replica killed late in the window may still be respawning (torch
        # boot + bucket warm-up), and its compile_count/reloads can only be
        # probed once it serves again.
        heal_deadline = time.time() + args.fleet_warmup_timeout_s
        while time.time() < heal_deadline:
            fleet_status = _get(url + "/fleet/status", args.timeout)
            if fleet_status.get("replicas_ready") == args.fleet:
                break
            time.sleep(1.0)
        router_metrics = _get(url + "/metrics", args.timeout)
        if not args.stub:
            _note_fleet_metrics(args, "fleet", fleet_status)
    finally:
        final_line = _stop_fleet(proc, timeout=60)

    compile_counts = [
        (r.get("metrics") or {}).get("compile_count")
        for r in fleet_status.get("replicas", [])
    ]
    bucket_counts = [
        (r.get("metrics") or {}).get("bucket_count")
        for r in fleet_status.get("replicas", [])
    ]
    result.update(
        {
            "metric": "serve_fleet_requests_per_sec",
            "fleet_replicas": args.fleet,
            "faults": args.faults,
            "chaos_interval_s": args.chaos_interval_s,
            "sessions_migrated_total": router_metrics.get(
                "sessions_migrated_total"
            ),
            "sessions_restarted_total": router_metrics.get(
                "sessions_restarted_total"
            ),
            "replica_restarts_total": fleet_status.get(
                "replica_restarts_total"
            ),
            "replicas_ready_at_end": fleet_status.get("replicas_ready"),
            "fleet_reloads": [
                (r.get("metrics") or {}).get("reloads_total")
                for r in fleet_status.get("replicas", [])
            ],
            # The pinned-compile invariant, per replica LIFETIME: every
            # live replica (including post-kill respawns) compiled exactly
            # its bucket count — once per warmed batch-size bucket.
            "replica_compile_counts": compile_counts,
            "replica_bucket_counts": bucket_counts,
            "chaos": final_line.get("chaos"),
            # Server-side judgement + crash-surviving exemplars from the
            # fleet's final status line. The client-side ledger (result
            # "slo") sees retries/transport failures the router cannot;
            # both views belong in the record.
            "server_slo": final_line.get("slo"),
            "slow_requests": final_line.get("slow_requests"),
            "stub": bool(args.stub),
        }
    )
    # A fleet bench's occupancy/compile fields come from the router, which
    # has no engine (its ServeMetrics never observes a batch) — drop the
    # misleading single-server fields rather than report fabricated 0.0s;
    # per-replica evidence lives in replica_compile_counts/fleet_reloads.
    result.pop("server_compile_count", None)
    result.pop("mean_batch_occupancy", None)
    result.pop("max_batch_occupancy", None)
    return result


# ---------------------------------------------------------------- elastic


#: Phase shapes per traffic schedule; each phase runs --phase_duration
#: seconds with a fixed closed-loop client population (sessions churn via
#: --session_cycle_steps so the router keeps placing fresh sessions).
SCHEDULE_NAMES = ("ramp", "spike", "diurnal")


def build_schedule(name: str, base: int, peak: int, phase_s: float) -> list:
    """(label, clients, seconds) phases for one named traffic schedule."""
    mid = max(base, int(round((base + peak) / 2)))
    if name == "ramp":
        phases = [("low", base), ("mid", mid), ("high", peak),
                  ("cooldown", base)]
    elif name == "spike":
        # A production spike has a leading edge (seconds-to-minutes of
        # climbing traffic), and the edge is what a reactive autoscaler
        # reacts to — the half-length "edge" phase at mid population is
        # where surge boots happen, and its own p99 row prices that
        # reaction window honestly in the record.
        phases = [("pre", base), ("edge", mid), ("spike", peak),
                  ("post", base)]
    elif name == "diurnal":
        phases = [("night", base), ("morning", mid), ("midday", peak),
                  ("evening", mid), ("late_night", base)]
    else:
        raise ValueError(
            f"unknown traffic schedule {name!r}; expected one of "
            f"{SCHEDULE_NAMES}"
        )
    return [
        (label, clients, phase_s / 2 if label == "edge" else phase_s)
        for label, clients in phases
    ]


def _elastic_fleet_cmd(args, elastic: bool) -> list:
    """The fleet argv for one A/B side: elastic (autoscaler armed,
    min..max, surge dtype) or fixed-max (always --max_replicas, no
    autoscaler) — admission control and everything else identical."""
    cmd = [
        sys.executable, "-m", "rt1_tpu_torch.serve.fleet",
        "--port", "0",
        "--max_sessions", str(args.max_sessions),
        "--replica_timeout_s", str(args.replica_timeout_s),
        "--chaos_interval_s", "3600",  # no chaos inside the cost A/B
        "--slo_availability", str(args.slo_availability),
        "--slo_p50_ms", str(args.slo_p50_ms),
        "--slo_p99_ms", str(args.slo_p99_ms),
    ]
    if elastic:
        cmd += [
            "--min_replicas", str(args.min_replicas),
            "--max_replicas", str(args.max_replicas),
            "--autoscale_interval_s", str(args.autoscale_interval_s),
            "--scale_up_ticks", str(args.scale_up_ticks),
            "--scale_down_ticks", str(args.scale_down_ticks),
            "--active_window_s", str(args.active_window_s),
            "--reclaim_grace_s", str(args.reclaim_grace_s),
        ]
        if args.surge_dtype:
            cmd += ["--surge_dtype", args.surge_dtype]
    else:
        cmd += ["--replicas", str(args.max_replicas)]
    if args.admission_rate > 0:
        cmd += [
            "--admission_rate", str(args.admission_rate),
            "--admission_burst", str(args.admission_burst),
        ]
    if args.max_inflight > 0:
        cmd += ["--max_inflight", str(args.max_inflight)]
    if args.inference_dtype != "f32":
        cmd += ["--inference_dtype", args.inference_dtype]
    if args.replica_dtypes:
        cmd += ["--replica_dtypes", args.replica_dtypes]
    if args.log_dir:
        cmd += ["--log_dir", args.log_dir]
    if args.stub:
        cmd += [
            "--stub",
            "--stub_act_delay_s", str(args.stub_act_delay_s),
            "--stub_act_concurrency", str(args.stub_act_concurrency),
        ]
    else:
        cmd += ["--config", args.config, "--embedder", args.embedder,
                "--device", args.device]
        if args.workdir:
            cmd += ["--workdir", args.workdir]
        else:
            cmd += ["--random_init"]
    return cmd


def _run_schedule_phases(args, url: str, schedule: str) -> list:
    """Drive one traffic schedule through a running fleet; one row of
    per-phase evidence (latency per phase, replica count after) each."""
    rows = []
    phases = build_schedule(
        schedule,
        args.schedule_base_sessions,
        args.schedule_peak_sessions,
        args.phase_duration,
    )
    for idx, (label, clients, dur) in enumerate(phases):
        run = run_loadgen(
            url,
            sessions=clients,
            duration_s=dur,
            think_time_s=args.think_time,
            timeout=args.timeout,
            max_retries=args.max_retries,
            seed=args.seed + 1000 * idx,
            task_mix=args.task_mix,
            session_cycle_steps=args.session_cycle_steps,
            session_prefix=f"{schedule}-{label}",
            slo_objectives=_objectives(args),
        )
        status = _get(url + "/fleet/status", args.timeout)
        rows.append(
            {
                "phase": label,
                "clients": clients,
                "duration_s": dur,
                "req_per_sec": run["value"],
                "latency_p50_ms": run["latency_p50_ms"],
                "latency_p99_ms": run["latency_p99_ms"],
                "requests_ok": run["requests_ok"],
                "requests_migrated": run["requests_migrated"],
                "requests_restarted": run["requests_restarted"],
                "requests_rejected": run["requests_rejected"],
                "requests_failed": run["requests_failed"],
                "replicas_after": status.get("replicas_total"),
                "replicas_ready_after": status.get("replicas_ready"),
            }
        )
    return rows


def _peak_p99(rows: list) -> float | None:
    """p99 of the highest-population phase (the phase the envelope
    comparison is about)."""
    peak = max(rows, key=lambda r: r["clients"], default=None)
    return peak["latency_p99_ms"] if peak else None


def run_elastic_bench(args) -> dict:
    """Elastic-vs-fixed A/B under time-varying traffic.

    For every schedule in ``--traffic_schedule`` (comma list of
    ramp|spike|diurnal), boot the fleet twice — once elastic
    (autoscaler min..max, surge tier at ``--surge_dtype``) and once
    fixed at ``--max_replicas`` — drive the identical phase sequence
    through each, and fold per-phase latency, scale events, shed counts,
    and **cost-per-request** (replica-seconds weighted by device param
    bytes per dtype — `serve/fleet.py DTYPE_COST_WEIGHTS`, anchored on
    the measured 3.71x int8 reduction in BENCH_serve_quant.json) into
    one BENCH record (``BENCH_serve_elastic.json`` via ``--output``).

    The acceptance shape: under the spike schedule the elastic fleet
    holds peak-phase p99 within ``--p99_envelope`` of the fixed-max
    fleet, with strictly lower cost-per-request on the diurnal schedule,
    zero failed requests anywhere, and compile_count == bucket_count on
    every replica lifetime — surge boots and reclaim victims included
    (victims are probed for the evidence just before SIGTERM).
    """
    schedules = [
        s.strip() for s in args.traffic_schedule.split(",") if s.strip()
    ]
    for schedule in schedules:
        if schedule not in SCHEDULE_NAMES:
            raise ValueError(
                f"--traffic_schedule entry {schedule!r} not in "
                f"{SCHEDULE_NAMES}"
            )
    # Schedule-outer, side-inner: each compared A/B pair (elastic vs
    # fixed-max on the SAME schedule) runs back-to-back, so co-tenant
    # CPU theft / thermal drift lands on both sides of a comparison
    # rather than on one block of schedules (the same reasoning as
    # --occupancy_sweep's alternating passes).
    sides: dict = {"elastic": {}, "fixed_max": {}}
    for schedule in schedules:
        for side, elastic in (("elastic", True), ("fixed_max", False)):
            proc, url, _ready = _spawn_fleet(
                _elastic_fleet_cmd(args, elastic),
                args.fleet_warmup_timeout_s,
            )
            t0 = time.perf_counter()
            try:
                rows = _run_schedule_phases(args, url, schedule)
                metrics = _get(url + "/metrics", args.timeout)
                status = _get(url + "/fleet/status", args.timeout)
                if not args.stub:
                    _note_fleet_metrics(
                        args, f"traffic_schedule/{schedule}/{side}", status
                    )
            finally:
                final = _stop_fleet(proc)
            wall = time.perf_counter() - t0
            autoscale = final.get("autoscale") or {}
            answered = sum(
                r["requests_ok"]
                + r["requests_migrated"]
                + r["requests_restarted"]
                for r in rows
            )
            cost_units = autoscale.get("cost_units")
            # The pinned-compile invariant across every replica LIFETIME:
            # live replicas from the final /fleet/status probe, reclaimed
            # ones from the evidence the supervisor snapshotted just
            # before their SIGTERM.
            compile_pairs = [
                (
                    (r.get("metrics") or {}).get("compile_count"),
                    (r.get("metrics") or {}).get("bucket_count"),
                )
                for r in status.get("replicas", [])
            ] + [
                (e.get("compile_count"), e.get("bucket_count"))
                for e in autoscale.get("events", [])
                if e.get("direction") == "down"
            ]
            # At least one lifetime must carry evidence and every
            # evidenced lifetime must satisfy the invariant — all probes
            # failing reads as False, never as "held" (vacuous truth); a
            # lone unprobeable mid-drain victim (both fields None) does
            # not fail the run, a half-evidenced pair does.
            evidenced = [
                (c, b)
                for c, b in compile_pairs
                if c is not None or b is not None
            ]
            compile_ok = bool(evidenced) and all(
                c == b and (b or 0) >= 1 for c, b in evidenced
            )
            sides[side][schedule] = {
                "phases": rows,
                "wall_s": round(wall, 3),
                "requests_ok": sum(r["requests_ok"] for r in rows),
                "requests_migrated": sum(
                    r["requests_migrated"] for r in rows
                ),
                "requests_restarted": sum(
                    r["requests_restarted"] for r in rows
                ),
                "requests_rejected": sum(
                    r["requests_rejected"] for r in rows
                ),
                "requests_failed": sum(r["requests_failed"] for r in rows),
                "answered": answered,
                "peak_p99_ms": _peak_p99(rows),
                "scale_events": autoscale.get("events", []),
                "replica_seconds_by_dtype": autoscale.get(
                    "replica_seconds_by_dtype"
                ),
                "cost_units": cost_units,
                "cost_per_request": (
                    round(cost_units / answered, 6)
                    if cost_units is not None and answered
                    else None
                ),
                "shed_by_reason": metrics.get("autoscale_shed_total"),
                "tier_replicas_final": metrics.get(
                    "autoscale_tier_replicas"
                ),
                "task_requests_total": metrics.get("task_requests_total"),
                "replica_compile_counts": compile_pairs,
                "compile_pinned_at_bucket_count": compile_ok,
                "server_slo": final.get("slo"),
            }

    def _cost(side: str, schedule: str):
        return sides[side][schedule].get("cost_per_request")

    # Headline: fixed-max cost over elastic cost on the diurnal schedule
    # (>1 = the elastic fleet serves the same traffic cheaper). Falls
    # back to the first schedule when diurnal was not requested.
    headline_schedule = "diurnal" if "diurnal" in schedules else schedules[0]
    e_cost = _cost("elastic", headline_schedule)
    f_cost = _cost("fixed_max", headline_schedule)
    cost_ratio = round(f_cost / e_cost, 3) if e_cost and f_cost else 0.0
    p99_envelope = {}
    for schedule in schedules:
        e_p99 = sides["elastic"][schedule]["peak_p99_ms"]
        f_p99 = sides["fixed_max"][schedule]["peak_p99_ms"]
        p99_envelope[schedule] = {
            "elastic_ms": e_p99,
            "fixed_max_ms": f_p99,
            "envelope_factor": args.p99_envelope,
            "within_envelope": (
                e_p99 is not None
                and f_p99 is not None
                and e_p99 <= f_p99 * args.p99_envelope
            ),
        }
    return {
        "metric": "serve_elastic_cost_ratio_fixed_over_elastic",
        "value": cost_ratio,
        "unit": "x",
        "headline_schedule": headline_schedule,
        "schedules": schedules,
        "phase_duration_s": args.phase_duration,
        "base_sessions": args.schedule_base_sessions,
        "peak_sessions": args.schedule_peak_sessions,
        "min_replicas": args.min_replicas,
        "max_replicas": args.max_replicas,
        "surge_dtype": args.surge_dtype or None,
        "task_mix": args.task_mix or None,
        "session_cycle_steps": args.session_cycle_steps,
        "admission": {
            "rate_per_client": args.admission_rate,
            "burst": args.admission_burst,
            "max_inflight": args.max_inflight,
        },
        "p99_peak_phase": p99_envelope,
        "cost_per_request": {
            s: {
                "elastic": _cost("elastic", s),
                "fixed_max": _cost("fixed_max", s),
            }
            for s in schedules
        },
        "sides": sides,
        "requests_failed": sum(
            rec["requests_failed"]
            for side in sides.values()
            for rec in side.values()
        ),
        "compile_pinned_at_bucket_count": all(
            rec["compile_pinned_at_bucket_count"]
            for side in sides.values()
            for rec in side.values()
        ),
        "stub": bool(args.stub),
        "timing_methodology": (
            "identical phase sequences driven through two freshly-booted "
            "fleets per schedule (elastic min..max with int8-able surge "
            "tier vs fixed at max), the two sides of each schedule run "
            "back-to-back so co-tenant CPU drift lands on both; "
            "closed-loop clients with bounded "
            "session lifetimes so new sessions keep arriving for "
            "placement; cost = per-replica lifetime seconds weighted by "
            "device param bytes per dtype (DTYPE_COST_WEIGHTS, anchored "
            "on the measured 3.71x flagship int8 reduction in "
            "BENCH_serve_quant.json)"
            + (
                "; stub replicas — process/spawn/drain dynamics, router "
                "placement, and replica-second cost are real, per-request "
                "latency floors are model-free (act_delay simulates the "
                "device step, act_concurrency serializes it); real-"
                "replica p99s scale these floors, not the shape"
                if args.stub
                else ""
            )
        ),
    }


# -------------------------------------------------------------- migration


#: The four disruption events the migration A/B drives, in order. Each is
#: followed by one act on every session to classify the continuation.
MIGRATION_EVENTS = ("kill", "drain", "rolling_reload", "rebalance")


def _migration_fleet_cmd(args, snapshot_dir: str) -> list:
    """Fleet argv for one migration-A/B side: stub replicas, the kill
    fault armed on the chaos clock, durable sessions iff `snapshot_dir`
    is set (the only difference between the two sides)."""
    cmd = [
        sys.executable, "-m", "rt1_tpu_torch.serve.fleet",
        "--replicas", str(args.fleet or 3),
        "--port", "0",
        "--max_sessions", str(args.max_sessions),
        "--replica_timeout_s", str(args.replica_timeout_s),
        "--chaos_interval_s", str(args.chaos_interval_s),
        "--faults", args.faults or "replica_kill@1",
        "--slo_availability", str(args.slo_availability),
        "--slo_p50_ms", str(args.slo_p50_ms),
        "--slo_p99_ms", str(args.slo_p99_ms),
        "--stub",
    ]
    if snapshot_dir:
        cmd += ["--session_snapshot_dir", snapshot_dir]
    if args.log_dir:
        cmd += ["--log_dir", args.log_dir]
    return cmd


def _drive_migration_side(args, durable: bool) -> dict:
    """Boot one fleet, walk it through every MIGRATION_EVENTS disruption,
    and classify each session's continuation after each event.

    Continuity is judged by ``step_index``, not by flags: the stub serves
    step N iff the window survived N prior acts, so a response whose
    step_index fell below the client's own count is a window reset no
    matter what the body claims. In stub mode the action values are also
    checked against the stub's deterministic per-step function — the
    token-identical-continuation bar, over real HTTP."""
    import shutil
    import tempfile

    from rt1_tpu_torch.serve.stub import stub_action

    snapshot_dir = tempfile.mkdtemp(prefix="rt1-migration-ab-")
    timeout = args.timeout
    fleet_n = args.fleet or 3
    proc, url, _ready = _spawn_fleet(
        _migration_fleet_cmd(args, snapshot_dir if durable else ""),
        args.fleet_warmup_timeout_s,
    )
    sessions: dict = {}  # sid -> acts completed (== next expected step)
    homes: dict = {}
    events = []
    token_checks = token_matches = 0
    final_line: dict = {}

    def _act(sid: str) -> tuple:
        payload = {
            "session_id": sid,
            "image_b64": "AAAA",
            "instruction": INSTRUCTION_POOL[0],
        }
        retries = 0
        while True:
            status, body = _post(url + "/act", payload, timeout)
            if (
                status == 503
                and body.get("retry")
                and retries < args.max_retries
            ):
                retries += 1
                time.sleep(0.02)
                continue
            return status, body

    def _sweep(label: str) -> dict:
        nonlocal token_checks, token_matches
        row = {"event": label}
        row.update({k: 0 for k in OUTCOME_CLASSES})
        row["window_resets"] = 0
        row["continuity_ok"] = 0
        for sid in sorted(sessions):
            expected = sessions[sid]
            status, body = _act(sid)
            if status == 200 and "action" in body:
                if body.get("migrated"):
                    row["migrated"] += 1
                elif body.get("restarted"):
                    row["restarted"] += 1
                else:
                    row["ok"] += 1
                served = body.get("step_index")
                if served == expected:
                    row["continuity_ok"] += 1
                    token_checks += 1
                    if body.get("action") == stub_action(expected):
                        token_matches += 1
                elif isinstance(served, int) and served < expected:
                    # The window came back shorter than the client's own
                    # history: a reset, whatever the flags said.
                    row["window_resets"] += 1
                sessions[sid] = (
                    served + 1 if isinstance(served, int) else expected + 1
                )
                homes[sid] = body.get("replica_id")
            elif status in (429, 503):
                row["rejected"] += 1
            else:
                row["failed"] += 1
        events.append(row)
        return row

    def _fleet_status() -> dict:
        try:
            return _get(url + "/fleet/status", timeout)
        except (urllib.error.URLError, OSError, ValueError):
            return {}

    def _wait(predicate, timeout_s: float, what: str) -> bool:
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            if predicate():
                return True
            time.sleep(0.05)
        events.append({"event": f"timeout:{what}"})
        return False

    try:
        # Baseline: open the sessions and advance every window a few
        # steps, so each later continuation has history to preserve.
        for i in range(args.sessions):
            sid = f"mig-{i}"
            _post(url + "/reset", {"session_id": sid}, timeout)
            sessions[sid] = 0
        for _ in range(max(args.steps, 1)):
            _sweep("warmup")

        # Event 1 — SIGKILL (the chaos scheduler's replica_kill): act
        # through the dead window so the router notices the death and
        # re-homes; durable side restores from the shared snapshot ring.
        killed = _wait(
            lambda: _fleet_status().get("replica_restarts_total", 0) >= 1
            or _fleet_status().get("replicas_ready", fleet_n) < fleet_n,
            30.0,
            "replica_kill to fire",
        )
        kill_row = _sweep("kill")
        kill_row["kill_observed"] = killed
        _wait(
            lambda: _fleet_status().get("replicas_ready") == fleet_n,
            args.fleet_warmup_timeout_s,
            "fleet to heal after the kill",
        )

        # Event 2 — elastic drain: POST /scale_down reclaims one replica
        # through the supervisor's migrating drain.
        status, body = _post(url + "/scale_down", {}, timeout)
        drained_ok = status == 200 and body.get("ok")
        _wait(
            lambda: _fleet_status().get("replicas_total") == fleet_n - 1,
            30.0,
            "the drain to finish",
        )
        drain_row = _sweep("drain")
        drain_row["scale_down_ok"] = bool(drained_ok)

        # Event 3 — rolling checkpoint reload (a new generation: old
        # snapshots become import-refusable, in-place swaps preserve).
        status, body = _post(url + "/reload", {"step": 2}, timeout)
        reload_row = _sweep("rolling_reload")
        reload_row["reload_ok"] = status == 200 and bool(body.get("ok"))

        # Event 4 — rebalance: migrate the hottest sessions off the
        # most-loaded survivor.
        counts: dict = {}
        for rid in homes.values():
            counts[rid] = counts.get(rid, 0) + 1
        hot = max(counts, key=counts.get) if counts else 0
        status, body = _post(
            url + "/rebalance",
            {"replica_id": int(hot), "count": args.rebalance_count},
            timeout,
        )
        rebalance_row = _sweep("rebalance")
        rebalance_row["rebalance_ok"] = status == 200
        rebalance_row["rebalance_migrated"] = (body or {}).get("migrated")

        router_metrics = _get(url + "/metrics", timeout)
        fleet_status = _fleet_status()
    finally:
        final_line = _stop_fleet(proc, timeout=60)
        shutil.rmtree(snapshot_dir, ignore_errors=True)

    totals = {k: sum(r.get(k, 0) for r in events) for k in OUTCOME_CLASSES}
    compile_pairs = [
        (
            (r.get("metrics") or {}).get("compile_count"),
            (r.get("metrics") or {}).get("bucket_count"),
        )
        for r in fleet_status.get("replicas", [])
    ]
    migration_counters = {
        key: sum(
            (rep or {}).get(key) or 0
            for rep in (router_metrics.get("replicas") or {}).values()
        )
        for key in (
            "migration_exports_total",
            "migration_imports_total",
            "migration_import_failures_total",
            "migration_restores_total",
            "migration_restore_failures_total",
        )
    }
    return {
        "durable": durable,
        "events": events,
        "requests_ok": totals["ok"],
        "requests_migrated": totals["migrated"],
        "requests_restarted": totals["restarted"],
        "requests_rejected": totals["rejected"],
        "requests_failed": totals["failed"],
        "window_resets": sum(r.get("window_resets", 0) for r in events),
        "continuity_ok": sum(r.get("continuity_ok", 0) for r in events),
        "token_checks": token_checks,
        "token_matches": token_matches,
        "sessions_migrated_total": router_metrics.get(
            "sessions_migrated_total"
        ),
        "sessions_restarted_total": router_metrics.get(
            "sessions_restarted_total"
        ),
        "migration_counters": migration_counters,
        "replica_compile_counts": compile_pairs,
        "compile_pinned_at_bucket_count": bool(compile_pairs)
        and all(
            c == b and (b or 0) >= 1
            for c, b in compile_pairs
            if c is not None or b is not None
        ),
        "server_slo": final_line.get("slo"),
        "chaos": final_line.get("chaos"),
    }


def run_migration_ab(args) -> dict:
    """Durable-sessions A/B (the tentpole acceptance run): the identical
    disruption gauntlet — SIGKILL, elastic drain, rolling reload,
    rebalance — against a stub fleet with the snapshot ring armed vs the
    legacy (no crash durability) fleet.

    The acceptance shape: the durable side books every disruption-
    affected continuation ``migrated`` (0 restarted, 0 window resets, 0
    failed, token-identical continuations), while the legacy side's
    SIGKILL produces the old ``restarted`` window resets — the delta the
    feature erases. Writes ``BENCH_serve_migration.json`` via --output."""
    sides = {
        "durable": _drive_migration_side(args, durable=True),
        "legacy": _drive_migration_side(args, durable=False),
    }
    durable = sides["durable"]
    return {
        "metric": "serve_migration_window_resets",
        "value": durable["window_resets"],
        "unit": "resets",
        "fleet_replicas": args.fleet or 3,
        "sessions": args.sessions,
        "warmup_steps": max(args.steps, 1),
        "events": list(MIGRATION_EVENTS),
        "faults": args.faults or "replica_kill@1",
        "zero_window_resets": durable["window_resets"] == 0
        and durable["requests_restarted"] == 0,
        "legacy_window_resets": sides["legacy"]["window_resets"],
        "token_identical_continuations": (
            durable["token_checks"] > 0
            and durable["token_matches"] == durable["token_checks"]
        ),
        "requests_failed": sum(
            s["requests_failed"] for s in sides.values()
        ),
        "compile_pinned_at_bucket_count": all(
            s["compile_pinned_at_bucket_count"] for s in sides.values()
        ),
        "sides": sides,
        "stub": True,
        "timing_methodology": (
            "two freshly-booted stub fleets run the identical disruption "
            "sequence (chaos replica_kill, POST /scale_down drain, "
            "POST /reload rolling reload, POST /rebalance), one act per "
            "session after each event; the ONLY config delta is "
            "--session_snapshot_dir on the durable side. Continuity is "
            "judged by step_index (the stub serves step N iff the window "
            "survived N acts) and by per-step action equality against "
            "the stub's deterministic function — flags alone could lie"
        ),
    }
