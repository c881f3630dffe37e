"""One post-mortem report per run: goodput + flight recorder + the
trainer's scalars + the serving SLO story (counterpart of
`scripts/run_report.py`).

After a run ends (cleanly, by preemption, or face-down), the evidence is
scattered: ``goodput_summary.json`` says where the hours went,
``flight_record.jsonl`` has the last seconds at per-step resolution, and
``metrics.jsonl`` holds the scalar history the port's trainer logs (loss,
`health/*` model-health gauges, `timing/*` buckets). A serving/chaos run
adds its own artifacts — ``slo_summary.json`` (the SLO ledger's
judgement), ``BENCH_serve_fleet.json`` (the loadgen record, incl.
per-replica fleet metrics), ``slow_requests.jsonl`` (the slow-request
exemplar ring) — and those render as a serve post-mortem section. An
eval-matrix sweep leaves ``BENCH_eval_matrix.json``, rendered as a task ×
checkpoint success table. This module merges them into one
human-readable report::

    python -m rt1_tpu_torch.obs.run_report --workdir /tmp/run            # stdout
    python -m rt1_tpu_torch.obs.run_report --workdir /tmp/run --out report.md

Every source is optional: a missing file becomes a "not found" note, not
a crash — the report is most needed exactly when a run died early and
left only some of the artifacts. The one difference from the JAX report:
the scalar sections read the latest value of each scalar from
``<workdir>/metrics.jsonl``; the port writes no TensorBoard events.
"""

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

# Goodput bucket reporting order + one-line meanings for the table.
_BUCKET_NOTES = {
    "init": "model/dataset/state setup",
    "compile": "first step (XLA compilation)",
    "step": "productive train steps (GOODPUT)",
    "data_stall": "input pipeline wait inside steps",
    "ckpt_save": "checkpoint saves (retries included)",
    "ckpt_restore": "checkpoint restores",
    "rollback_replay": "steps re-run after guard rollback",
    "preempt_drain": "preemption save-and-drain",
    "unattributed": "logging/eval/Python between steps",
}


# ------------------------------------------------------------------ loading
#
# Section text matches the JAX report's line for line (the notes name the
# JAX package's scripts where its sources come from); only the two scalar
# sections read `metrics.jsonl`.


def load_goodput(workdir: str) -> Optional[Dict[str, Any]]:
    from rt1_tpu_torch.obs import goodput

    path = os.path.join(workdir, goodput.SUMMARY_BASENAME)
    if not os.path.exists(path):
        return None
    return goodput.read_summary(path)


def load_flight(workdir: str) -> Optional[Dict[str, Any]]:
    from rt1_tpu_torch.obs import recorder

    path = os.path.join(workdir, "flight_record.jsonl")
    if not os.path.exists(path):
        return None
    return recorder.read_dump(path)


def load_multichip(
    workdir: str, explicit: str = ""
) -> Optional[Dict[str, Any]]:
    """The newest MULTICHIP_*.json scale-out record in the workdir (or the
    explicitly named file) — rendered beside the single-host goodput
    section so 'where the hours went' and 'what scaling out buys' read
    together. Only `multihost_scaling` records render; older MULTICHIP
    rounds (dryrun leg matrices) have no throughput table to show."""
    import glob

    if explicit:
        # The operator NAMED this file — a typo'd path or a foreign
        # format must fail loudly, not render as "no record found".
        try:
            with open(explicit) as f:
                record = json.load(f)
        except (OSError, json.JSONDecodeError) as exc:
            raise ValueError(
                f"--multichip {explicit}: unreadable ({exc})"
            ) from exc
        if record.get("bench") != "multihost_scaling":
            raise ValueError(
                f"--multichip {explicit}: not a multihost_scaling record "
                f"(bench={record.get('bench')!r}) — produce one with "
                f"scripts/bench_multihost.py"
            )
        record["_path"] = explicit
        return record
    for path in sorted(
        glob.glob(os.path.join(workdir, "MULTICHIP_*.json")),
        reverse=True,  # newest round first; older rounds are fallback
    ):
        try:
            with open(path) as f:
                record = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue  # torn/missing file: try the next-older round
        if record.get("bench") != "multihost_scaling":
            continue  # older rounds (dryrun leg matrices)
        record["_path"] = path
        return record
    return None


def load_serve(workdir: str) -> Optional[Dict[str, Any]]:
    """Serving artifacts, any subset: SLO summary, loadgen BENCH record,
    slow-request exemplar dump. None when the workdir has none of them
    (a pure training run keeps its report serve-free)."""
    from rt1_tpu_torch.obs import recorder
    from rt1_tpu_torch.obs import slo as slo_mod

    out: Dict[str, Any] = {}
    path = os.path.join(workdir, slo_mod.SUMMARY_BASENAME)
    if os.path.exists(path):
        try:
            out["slo"] = slo_mod.read_summary(path)
        except (json.JSONDecodeError, OSError):
            pass  # half-written summary from a crashed run
    for name in ("BENCH_serve_fleet.json", "BENCH_serving.json"):
        path = os.path.join(workdir, name)
        if os.path.exists(path):
            try:
                with open(path) as f:
                    out["bench"] = json.load(f)
            except (json.JSONDecodeError, OSError):
                pass
            else:
                break
    path = os.path.join(workdir, "BENCH_serve_quant.json")
    if os.path.exists(path):
        try:
            with open(path) as f:
                out["quant_bench"] = json.load(f)
        except (json.JSONDecodeError, OSError):
            pass
    path = os.path.join(workdir, "BENCH_serve_elastic.json")
    if os.path.exists(path):
        try:
            with open(path) as f:
                out["elastic_bench"] = json.load(f)
        except (json.JSONDecodeError, OSError):
            pass  # half-written record from a killed A/B
    path = os.path.join(workdir, "BENCH_serve_migration.json")
    if os.path.exists(path):
        try:
            with open(path) as f:
                out["migration_bench"] = json.load(f)
        except (json.JSONDecodeError, OSError):
            pass  # half-written record from a killed A/B
    path = os.path.join(workdir, "slow_requests.jsonl")
    if os.path.exists(path):
        try:
            out["exemplars"] = recorder.read_exemplars(path)
        except OSError:
            pass
    return out or None


def load_deploy(workdir: str) -> Optional[Dict[str, Any]]:
    """The continuous-deployment record (scripts/deploy_loop.py), or None
    when the workdir has never run a deploy cycle."""
    path = os.path.join(workdir, "BENCH_deploy.json")
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (json.JSONDecodeError, OSError):
        return None  # half-written record from a killed cycle


def load_obs(workdir: str) -> Optional[Dict[str, Any]]:
    """The metrics plane's shutdown snapshot (``tsdb_snapshot.jsonl``,
    written by `fleet --collector` or `scripts/obs_collector.py`), or
    None for a training-only workdir. Torn final lines are tolerated by
    the snapshot reader — a SIGKILLed collector still reports."""
    from rt1_tpu_torch.obs import tsdb as tsdb_mod

    path = os.path.join(workdir, tsdb_mod.SNAPSHOT_BASENAME)
    if not os.path.exists(path):
        return None
    try:
        record = tsdb_mod.read_snapshot(path)
    except OSError:
        return None
    record["_path"] = path
    return record


def load_eval_matrix(workdir: str) -> Optional[Dict[str, Any]]:
    """The task × checkpoint eval-matrix record (scripts/eval_matrix.py),
    or None when the workdir has never run a sweep."""
    path = os.path.join(workdir, "BENCH_eval_matrix.json")
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (json.JSONDecodeError, OSError):
        return None  # half-written record from a killed sweep


def load_tb_scalars(workdir: str) -> Optional[Dict[str, Tuple[int, float]]]:
    """{tag: (last_step, last_value)} of every scalar in
    ``<workdir>/metrics.jsonl`` (the trainer's one JSON object a log step:
    ``{"step": s, tag: value, ...}``), each at its newest record; None when
    the file is missing or holds no scalar. A torn final line is skipped.
    The name is the JAX report's, whose scalars come from TensorBoard."""
    path = os.path.join(workdir, "metrics.jsonl")
    if not os.path.exists(path):
        return None
    out: Dict[str, Tuple[int, float]] = {}
    with open(path) as f:
        for line in f:
            try:
                record = json.loads(line)
            except json.JSONDecodeError:
                continue
            if not isinstance(record, dict) or "step" not in record:
                continue
            step = int(record["step"])
            for tag, value in record.items():
                if tag == "step" or isinstance(value, bool):
                    continue
                if isinstance(value, (int, float)):
                    out[tag] = (step, float(value))
    return out or None


# ---------------------------------------------------------------- rendering


def _bar(pct: float, width: int = 30) -> str:
    filled = int(round(max(0.0, min(pct, 100.0)) / 100.0 * width))
    return "#" * filled + "." * (width - filled)


def render_goodput(goodput: Optional[Dict[str, Any]]) -> List[str]:
    lines = ["## Where the hours went (goodput ledger)", ""]
    if goodput is None:
        lines.append(
            "goodput_summary.json not found — run predates the ledger, or "
            "died before the first summary write."
        )
        return lines
    wall = goodput.get("wall_s", 0.0)
    lines.append(f"Wall time: {wall:.1f} s")
    lines.append("")
    lines.append(f"{'bucket':<16}{'seconds':>10}  {'share':>6}  ")
    buckets = goodput.get("buckets_s", {})
    fractions = goodput.get("fractions", {})
    for b in _BUCKET_NOTES:
        if b not in buckets:
            continue
        pct = fractions.get(b, 0.0) * 100.0
        lines.append(
            f"{b:<16}{buckets[b]:>10.2f}  {pct:>5.1f}%  "
            f"|{_bar(pct)}|  {_BUCKET_NOTES[b]}"
        )
    lines.append("")
    lines.append(
        f"Goodput {goodput.get('goodput_pct', 0.0):.1f}% / badput "
        f"{goodput.get('badput_pct', 0.0):.1f}% of wall time."
    )
    if "mfu_pct" in goodput:
        lines.append(
            f"MFU {goodput['mfu_pct']:.3f}% "
            f"({goodput.get('flops_per_step', 0):.3g} FLOPs/step per XLA "
            f"cost analysis)."
        )
    extras = []
    if goodput.get("rollbacks"):
        extras.append(
            f"{goodput['rollbacks']} rollback(s), "
            f"{goodput.get('steps_replayed', 0)} step(s) replayed"
        )
    if goodput.get("preempted"):
        extras.append("run was PREEMPTED (saved and exited 0)")
    if extras:
        lines.append("Events: " + "; ".join(extras) + ".")
    return lines


def render_multichip(record: Optional[Dict[str, Any]]) -> List[str]:
    """Multi-host scaling beside the goodput story: per-topology steps/s,
    MFU, and per-host data-stall, plus the weak-scaling ratio and the
    record's own methodology caveats (an XLA:CPU number without its caveat
    line is a lie by omission)."""
    lines = ["## Multi-host scaling (MULTICHIP record)", ""]
    if record is None:
        return lines + [
            "No multihost_scaling MULTICHIP record found — run "
            "`python scripts/bench_multihost.py` (or `bench.py --mode "
            "multihost`)."
        ]
    lines.append(f"Record: {record.get('_path', '<inline>')}")
    lines.append("")
    header = (
        f"{'group':<8}{'procs':>6}{'devices':>9}{'gbatch':>8}"
        f"{'steps/s':>10}{'ex/s':>10}{'mfu%':>10}  host data-stall%"
    )
    lines.append(header)
    for name in sorted(record.get("groups", {})):
        g = record["groups"][name]
        mfu = g.get("mfu_pct")
        stalls = ", ".join(
            f"{s:.1f}" for s in g.get("per_host_data_stall_pct", [])
        )
        lines.append(
            f"{name:<8}{g.get('processes', 0):>6}"
            f"{g.get('devices_global', 0):>9}{g.get('global_batch', 0):>8}"
            f"{g.get('steps_per_sec', 0.0):>10.2f}"
            f"{g.get('examples_per_sec', 0.0):>10.1f}"
            f"{(f'{mfu:.4f}' if mfu is not None else 'n/a'):>10}"
            f"  [{stalls}]"
        )
    scaling = record.get("scaling", {})
    if scaling:
        lines.append("")
        lines.append(
            "Weak scaling 2p/1p: "
            f"steps/s x{scaling.get('steps_per_sec_ratio_2p_over_1p', 0.0)}"
            ", examples/s x"
            f"{scaling.get('examples_per_sec_ratio_2p_over_1p', 0.0)}"
        )
    caveats = record.get("methodology", {}).get("caveats")
    if caveats:
        lines.append("")
        lines.append(f"Methodology: {caveats}")
    return lines


def render_health(
    tb: Optional[Dict[str, Tuple[int, float]]]
) -> List[str]:
    lines = ["## Model health (last log step)", ""]
    if tb is None:
        lines.append(
            "No metrics.jsonl scalars readable (no log step written) — "
            "health gauges unavailable here; see the Prometheus listener "
            "or the flight recorder."
        )
        return lines
    health = {k: v for k, v in tb.items() if k.startswith("health/")}
    if not health:
        lines.append(
            "No health/* scalars in metrics.jsonl — the run had "
            "config.obs.model_health off."
        )
        return lines
    step = max(s for s, _ in health.values())
    lines.append(f"As of step {step}:")
    for tag in sorted(health):
        lines.append(f"  {tag:<48}{health[tag][1]:>12.5g}")
    return lines


def render_flight(
    flight: Optional[Dict[str, Any]], tail: int = 8
) -> List[str]:
    lines = ["## Flight recorder", ""]
    if flight is None:
        lines.append(
            "flight_record.jsonl not found — the run exited cleanly (the "
            "recorder only dumps on crash/SIGTERM/preempt)."
        )
        return lines
    header = flight.get("header", {})
    records = flight.get("records", [])
    lines.append(
        f"Dump reason: {header.get('reason', '?')} — {len(records)} of "
        f"{header.get('recorded_total', '?')} recorded steps retained."
    )
    if records:
        lines.append("")
        lines.append(
            f"{'step':>8}{'total_ms':>10}{'stall%':>8}{'loss':>12}"
        )
        for rec in records[-tail:]:
            loss = rec.get("loss")
            loss_s = f"{loss:>12.4g}" if loss is not None else f"{'-':>12}"
            lines.append(
                f"{rec.get('step', '?'):>8}"
                f"{rec.get('total_ms', float('nan')):>10.1f}"
                f"{rec.get('stall_pct', float('nan')):>8.1f}"
                + loss_s
            )
        last = records[-1]
        if "health" in last:
            lines.append("")
            lines.append("Health gauges in the final record:")
            for k in sorted(last["health"]):
                lines.append(f"  {k:<48}{last['health'][k]:>12.5g}")
        if "guard" in last:
            g = last["guard"]
            lines.append(
                f"Guard at the end: {g.get('guard/device_skips_total', 0):.0f} "
                f"device skips, {g.get('guard/rollbacks_total', 0):.0f} "
                f"rollbacks."
            )
    return lines


def render_scalars(
    tb: Optional[Dict[str, Tuple[int, float]]]
) -> List[str]:
    lines = ["## Last training scalars", ""]
    if tb is None:
        lines.append("No metrics.jsonl scalars readable.")
        return lines
    wanted = ("loss", "eval_loss", "grad_norm", "stall_pct",
              "steps_per_sec", "examples_per_sec")
    found = [(t, tb[t]) for t in wanted if t in tb]
    if not found:
        lines.append("None of the standard scalar tags present.")
        return lines
    for tag, (step, value) in found:
        lines.append(f"  {tag:<24}{value:>12.5g}   (step {step})")
    return lines


def render_eval_matrix(record: Optional[Dict[str, Any]]) -> List[str]:
    """The model-quality section: closed-loop success per task ×
    checkpoint cell as one table — the matrix the promotion gate reads."""
    lines = ["## Eval matrix (task × checkpoint success)", ""]
    if record is None:
        lines.append(
            "BENCH_eval_matrix.json not found — no eval-matrix sweep has "
            "run against this workdir (scripts/eval_matrix.py)."
        )
        return lines
    checkpoints = record.get("checkpoints", [])
    matrix = record.get("matrix", {})
    if not checkpoints or not matrix:
        lines.append("Record present but empty (sweep died before a cell).")
        return lines
    lines.append(
        f"{len(matrix)} task(s) × {len(checkpoints)} checkpoint(s), "
        f"{record.get('episodes_per_cell', '?')} episodes/cell, "
        f"max {record.get('max_episode_steps', '?')} steps, backend "
        f"{record.get('backend', '?')!r}; headline mean cell success "
        f"{record.get('value', 0.0):.3f}."
    )
    lines.append("")
    col_w = max(14, max(len(f"ckpt {c}") for c in checkpoints) + 2)
    header = f"{'task':<30}" + "".join(
        f"{('ckpt ' + str(c)):>{col_w}}" for c in checkpoints
    )
    lines.append(header)
    for task in sorted(matrix):
        row = matrix[task]
        cells = []
        for ckpt in checkpoints:
            cell = row.get(str(ckpt)) or row.get(ckpt)
            if not cell or not cell.get("episodes"):
                cells.append(f"{'-':>{col_w}}")
            else:
                cells.append(
                    f"{cell['successes']}/{cell['episodes']}"
                    f" ({cell['success_rate']:.2f})".rjust(col_w)
                )
        lines.append(f"{task:<30}" + "".join(cells))
    fill = record.get("oracle_fill")
    if fill:
        lines.append("")
        lines.append(
            f"Oracle corpus fill: {fill.get('episodes_appended', 0)} "
            f"episodes appended ({fill.get('episodes_per_task')}), pack "
            f"now {fill.get('shards_after', '?')} shard(s) at freshness "
            f"epoch {fill.get('freshness_epoch', '?')}."
        )
    return lines


_DEPLOY_EVENT_FIELDS = (
    "step", "incumbent", "replica", "weight", "reason",
    "previous_incumbent", "replicas", "error",
)


def render_deploy(record: Optional[Dict[str, Any]]) -> List[str]:
    """The deployment section: per-episode promotion timeline (candidate
    -> gate -> canary -> promote/rollback), traffic honesty counters,
    and the signed-verdict table the gate left behind."""
    lines = ["## Deployment (promotion controller)", ""]
    if record is None:
        lines.append(
            "BENCH_deploy.json not found — no deploy cycle has run "
            "against this workdir (scripts/deploy_loop.py)."
        )
        return lines
    episodes = [
        record[k] for k in ("promote", "rollback") if record.get(k)
    ]
    if not episodes:
        lines.append("Record present but empty (cycle died before a "
                     "fleet episode).")
        return lines
    lines.append(
        f"Verdict {record.get('verdict', '?')!r} in "
        f"{record.get('total_seconds', 0.0):.1f} s ({len(episodes)} fleet "
        f"episode(s), gate tasks "
        f"{record.get('config', {}).get('gate_tasks', '?')!r})."
    )
    verdict_rows = []
    for ep in episodes:
        deploy = ep.get("final_deploy") or {}
        traffic = ep.get("traffic") or {}
        lines.append("")
        lines.append(
            f"[{ep.get('episode', '?')}] faults={ep.get('faults') or 'none'}"
            f" — incumbent {deploy.get('incumbent_step', '?')}, "
            f"{deploy.get('promotions_total', 0)} promotion(s), "
            f"{deploy.get('rollbacks_total', 0)} rollback(s)."
        )
        for entry in ep.get("timeline", []):
            detail = " ".join(
                f"{k}={entry[k]}"
                for k in _DEPLOY_EVENT_FIELDS
                if k in entry
            )
            lines.append(
                f"  tick {entry.get('tick', '?'):>4}  "
                f"{entry.get('event', '?'):<18}{detail}"
            )
        rehomed = len(traffic.get("restarts", [])) + len(
            ep.get("post_sweep_restarted", [])
        )
        lines.append(
            f"  traffic: {traffic.get('requests_ok', 0)} ok, "
            f"{len(traffic.get('failures', []))} failed, "
            f"{rehomed} re-homed (restarted: true), "
            f"{traffic.get('sessions_created', 0)} session(s)."
        )
        verdict_rows.extend(ep.get("verdicts", []))
    if verdict_rows:
        lines.append("")
        lines.append(
            f"{'verdict artifact':<28}{'candidate':>10}{'incumbent':>10}"
            f"{'passed':>8}{'signature':>11}"
        )
        for row in verdict_rows:
            lines.append(
                f"{str(row.get('path', '?')):<28}"
                f"{str(row.get('candidate_step', '?')):>10}"
                f"{str(row.get('incumbent_step', '?')):>10}"
                f"{str(bool(row.get('passed'))):>8}"
                + (
                    f"{'ok':>11}" if row.get("signature_ok")
                    else f"{'INVALID':>11}"
                )
            )
    return lines


#: The families whose history earns a sparkline in the post-mortem — the
#: incident-shaped signals, in the order an on-call reads them.
_OBS_SPARK_FAMILIES = (
    "rt1_serve_slo_error_budget_burn_rolling",
    "rt1_serve_slo_requests_total",
    "rt1_serve_replica_up",
    "rt1_serve_active_sessions",
    "rt1_deploy_canary_burn",
    "rt1_deploy_status_rollbacks_total",
)


def render_obs(record: Optional[Dict[str, Any]]) -> List[str]:
    """The alerts-and-history section: what the metrics plane remembered.

    Reconstructed purely from the TSDB snapshot — the ``rt1_alert_*``
    families the collector scraped back off its own router are the alert
    timeline (an instance's series spans exactly the cycles it was
    active), and the key serve/deploy families render as sparklines."""
    from rt1_tpu_torch.obs.dashboard import spark_line

    lines = ["## Alerts & history (metrics plane)", ""]
    if record is None:
        lines.append(
            "tsdb_snapshot.jsonl not found — no collector was armed "
            "(fleet --collector / scripts/obs_collector.py)."
        )
        return lines
    header = record.get("header") or {}
    series = record.get("series") or []
    lines.append(
        f"Snapshot {record.get('_path', '?')}: "
        f"{header.get('series', len(series))} series, "
        f"{header.get('points', '?')} points "
        f"(retention {header.get('retention_s', '?')} s)."
    )

    # Alert timeline: every rt1_alert_firing/pending instance with the
    # span of scrape cycles it was active for.
    alert_rows = []
    for row in series:
        family = row.get("family", "")
        if family not in ("rt1_alert_firing", "rt1_alert_pending"):
            continue
        labels = row.get("labels") or {}
        points = row.get("points") or []
        if not points:
            continue
        alert_rows.append(
            (
                labels.get("alert", "?"),
                labels.get("severity", "?"),
                family.rsplit("_", 1)[-1],
                points[0][0],
                points[-1][0],
                {
                    k: v
                    for k, v in labels.items()
                    if k not in ("alert", "severity")
                },
            )
        )
    counters = {
        row["family"]: row["points"][-1][1]
        for row in series
        if row.get("family", "").startswith("rt1_alert_")
        and row.get("family", "").endswith("_total")
        and row.get("points")
    }
    lines.append("")
    if alert_rows:
        fired = counters.get("rt1_alert_fired_total")
        resolved = counters.get("rt1_alert_resolved_total")
        suffix = (
            f" (fired_total={fired:.0f}, resolved_total={resolved:.0f})"
            if fired is not None and resolved is not None
            else ""
        )
        lines.append(f"Alert timeline{suffix}:")
        for name, severity, state, t0, t1, extra in sorted(
            alert_rows, key=lambda r: (r[3], r[0])
        ):
            extra_text = (
                " " + " ".join(f"{k}={v}" for k, v in sorted(extra.items()))
                if extra
                else ""
            )
            lines.append(
                f"  [{severity:>4}] {name:<22} {state:<7} "
                f"seen {t1 - t0:6.1f}s{extra_text}"
            )
    elif counters:
        lines.append(
            "No alert instance was active at any scrape "
            f"(fired_total={counters.get('rt1_alert_fired_total', 0):.0f})."
        )
    else:
        lines.append(
            "No rt1_alert_* families in the snapshot — no scraped target "
            "exposed alert state (a fleet scrapes its own rt1_alert_* "
            "families back only when --collector is armed in-process)."
        )

    # Key-signal sparklines, newest right — the at-a-glance shape of the
    # incident (or of its absence).
    sparks = []
    for row in series:
        if row.get("family") not in _OBS_SPARK_FAMILIES:
            continue
        points = row.get("points") or []
        if not points:
            continue
        labels = row.get("labels") or {}
        label_text = (
            "{" + ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
            + "}"
            if labels
            else ""
        )
        sparks.append(
            (
                _OBS_SPARK_FAMILIES.index(row["family"]),
                f"  {row['family'] + label_text:<52} "
                f"{spark_line([v for _, v in points], width=32):<32} "
                f"{points[-1][1]:g}",
            )
        )
    if sparks:
        lines.append("")
        lines.append("Key signals (sparkline, newest right -> last value):")
        lines.extend(text for _, text in sorted(sparks))
    shown = {row["family"] for row in series} & set(_OBS_SPARK_FAMILIES)
    other = len(series) - sum(
        1 for row in series if row.get("family") in shown
    )
    if other > 0:
        lines.append("")
        lines.append(
            f"...plus {other} more stored series (scripts/obs_console.py "
            f"--snapshot {record.get('_path', '?')} browses them all)."
        )
    return lines


def render_serve(serve: Optional[Dict[str, Any]], tail: int = 8) -> List[str]:
    """The serve post-mortem: SLO verdict, per-class outcome table,
    fleet/chaos evidence from the BENCH record, slowest exemplars."""
    lines = ["## Serve post-mortem (SLO ledger)", ""]
    slo = serve.get("slo") if serve else None
    bench = serve.get("bench") if serve else None
    quant = serve.get("quant_bench") if serve else None
    elastic = serve.get("elastic_bench") if serve else None
    migration = serve.get("migration_bench") if serve else None
    exemplars = serve.get("exemplars") if serve else None
    if (
        slo is None
        and bench is None
        and exemplars is None
        and quant is None
        and elastic is None
        and migration is None
    ):
        lines.append(
            "No serving artifacts (slo_summary.json / BENCH_serve_*.json / "
            "slow_requests.jsonl) in the workdir."
        )
        return lines
    if slo is not None:
        obj = slo.get("objectives", {})
        lines.append(
            f"Objectives: availability >= {obj.get('availability', 0):.4g}, "
            f"p50 <= {obj.get('latency_p50_ms', 0):.4g} ms, "
            f"p99 <= {obj.get('latency_p99_ms', 0):.4g} ms "
            f"(rolling window {obj.get('window', '?')} requests)."
        )
        lines.append(
            f"Availability {slo.get('availability', 0) * 100:.3f}% "
            f"(rolling {slo.get('availability_rolling', 0) * 100:.3f}%) — "
            f"error budget burned "
            f"{slo.get('error_budget_burn', 0) * 100:.1f}% "
            f"(rolling {slo.get('error_budget_burn_rolling', 0) * 100:.1f}%)."
        )
        lines.append(
            f"Answered latency p50 {slo.get('latency_p50_ms', 0):.2f} ms / "
            f"p99 {slo.get('latency_p99_ms', 0):.2f} ms."
        )
        lines.append("")
        lines.append(
            f"{'class':<12}{'count':>8}{'p50 ms':>10}{'p99 ms':>10}"
            f"{'budget burn':>13}"
        )
        for klass, row in slo.get("by_class", {}).items():
            burn = row.get("error_budget_burn")
            burn_s = f"{burn * 100:>12.1f}%" if burn is not None else (
                f"{'-':>13}"
            )
            lines.append(
                f"{klass:<12}{row.get('count', 0):>8}"
                f"{row.get('p50_ms', 0):>10.2f}{row.get('p99_ms', 0):>10.2f}"
                + burn_s
            )
        lines.append("")
        lines.append(
            "SLO met." if slo.get("slo_met")
            else "SLO VIOLATED — "
            + ", ".join(
                name
                for name, ok in (
                    ("availability", slo.get("availability_within_objective")),
                    ("latency", slo.get("latency_within_objective")),
                )
                if not ok
            )
            + " outside objective."
        )
    if bench is not None:
        lines.append("")
        lines.append(
            f"Loadgen: {bench.get('value', 0)} {bench.get('unit', '')} — "
            f"{bench.get('requests_ok', 0)} ok, "
            f"{bench.get('requests_restarted', 0)} restarted, "
            f"{bench.get('requests_rejected', 0)} rejected, "
            f"{bench.get('requests_failed', 0)} FAILED."
        )
        if bench.get("fleet_replicas"):
            lines.append(
                f"Fleet: {bench['fleet_replicas']} replicas, faults "
                f"{bench.get('faults') or 'none'!r}, "
                f"{bench.get('replica_restarts_total', 0)} restart(s), "
                f"compile counts {bench.get('replica_compile_counts')}, "
                f"{bench.get('replicas_ready_at_end', '?')} ready at end."
            )
    if quant is not None:
        # The low-precision serving story next to the SLO verdict: a
        # mixed-dtype fleet's latency/parity/bytes read out of one table
        # (BENCH_serve_quant.json, scripts/serve_loadgen.py --quant_ab).
        lines.append("")
        lines.append(
            f"Low-precision serving (BENCH_serve_quant.json): int8 "
            f"param-byte reduction {quant.get('value', 0)}x "
            f"({quant.get('unit', 'x')} headline, flagship tree)."
        )
        lines.append(
            f"{'dtype':<8}{'p50 ms':>10}{'p99 ms':>10}{'req/s':>10}"
            f"{'device MB':>12}{'parity':>9}{'failed':>8}"
        )
        for dtype, row in (quant.get("per_dtype") or {}).items():
            parity = (row.get("parity") or {}).get("agreement")
            dev = row.get("param_bytes_device")
            lines.append(
                f"{dtype:<8}"
                f"{row.get('latency_p50_ms', 0):>10.2f}"
                f"{row.get('latency_p99_ms', 0):>10.2f}"
                f"{row.get('req_per_sec', 0):>10.2f}"
                + (
                    f"{dev / 1e6:>12.3f}" if dev is not None
                    else f"{'-':>12}"
                )
                + (
                    f"{parity * 100:>8.1f}%" if parity is not None
                    else f"{'-':>9}"
                )
                + f"{row.get('requests_failed', 0):>8}"
            )
        note = quant.get("honesty_note")
        if note:
            lines.append(f"Note: {note}")
    if elastic is not None:
        lines.extend(_render_elastic(elastic))
    if migration is not None:
        lines.extend(_render_migration(migration))
    records = (exemplars or {}).get("records", [])
    if exemplars is not None:
        header = exemplars.get("header", {})
        lines.append("")
        lines.append(
            f"Slow-request exemplars: {len(records)} retained "
            f"(threshold {header.get('threshold_ms', 0)} ms, "
            f"{header.get('offered', '?')} offered, dump reason "
            f"{header.get('reason', '?')})."
        )
        slowest = sorted(
            records, key=lambda r: r.get("total_ms", 0.0), reverse=True
        )[:tail]
        if slowest:
            lines.append(
                f"{'request_id':<20}{'total ms':>10}{'queue ms':>10}"
                f"{'device ms':>10}  outcome"
            )
            for rec in slowest:
                phases = rec.get("phases") or {}
                q = phases.get("queue_wait_ms")
                d = phases.get("device_ms")
                lines.append(
                    f"{str(rec.get('request_id', '?')):<20}"
                    f"{rec.get('total_ms', 0.0):>10.2f}"
                    + (f"{q:>10.2f}" if q is not None else f"{'-':>10}")
                    + (f"{d:>10.2f}" if d is not None else f"{'-':>10}")
                    + f"  {rec.get('outcome', '?')}"
                )
    return lines


def _render_elastic(elastic: Dict[str, Any]) -> List[str]:
    """The elastic-fleet A/B (BENCH_serve_elastic.json): per-phase
    latency/replica table per side, the scale-event timeline, and the
    cost-per-request comparison the autoscaler exists to win."""
    lines = [""]
    lines.append(
        f"Elastic fleet (BENCH_serve_elastic.json): cost-per-request "
        f"ratio fixed-max/elastic {elastic.get('value', 0)}x on the "
        f"{elastic.get('headline_schedule', '?')} schedule "
        f"({elastic.get('min_replicas', '?')}.."
        f"{elastic.get('max_replicas', '?')} replicas, surge dtype "
        f"{elastic.get('surge_dtype') or 'base'}, "
        f"{elastic.get('requests_failed', '?')} failed requests)."
    )
    sides = elastic.get("sides") or {}
    for schedule in elastic.get("schedules", []):
        lines.append("")
        lines.append(
            f"{'[' + schedule + ']':<12}{'side':<12}{'phase':<12}"
            f"{'clients':>8}{'req/s':>9}{'p50 ms':>9}{'p99 ms':>9}"
            f"{'shed':>6}{'fail':>6}{'repl':>6}"
        )
        for side in ("elastic", "fixed_max"):
            rec = (sides.get(side) or {}).get(schedule) or {}
            for row in rec.get("phases", []):
                lines.append(
                    f"{'':<12}{side:<12}{row.get('phase', '?'):<12}"
                    f"{row.get('clients', 0):>8}"
                    f"{row.get('req_per_sec', 0.0):>9.1f}"
                    f"{row.get('latency_p50_ms', 0.0):>9.2f}"
                    f"{row.get('latency_p99_ms', 0.0):>9.2f}"
                    f"{row.get('requests_rejected', 0):>6}"
                    f"{row.get('requests_failed', 0):>6}"
                    f"{row.get('replicas_after', '?'):>6}"
                )
        events = (
            (sides.get("elastic") or {}).get(schedule) or {}
        ).get("scale_events", [])
        if events:
            lines.append("  Scale events (elastic side):")
            for e in events:
                lines.append(
                    f"    t={e.get('t_s', 0.0):>7.1f}s "
                    f"{e.get('direction', '?'):<5} replica "
                    f"{e.get('replica_id', '?')} "
                    f"({e.get('dtype') or '?'}): "
                    f"{e.get('reason', '?')}"
                )
        cost = (elastic.get("cost_per_request") or {}).get(schedule) or {}
        seconds_e = (
            (sides.get("elastic") or {}).get(schedule) or {}
        ).get("replica_seconds_by_dtype") or {}
        seconds_f = (
            (sides.get("fixed_max") or {}).get(schedule) or {}
        ).get("replica_seconds_by_dtype") or {}
        lines.append(
            f"  Cost/request (byte-weighted replica-seconds): elastic "
            f"{cost.get('elastic')} vs fixed-max {cost.get('fixed_max')} "
            f"(replica-s by dtype: elastic {seconds_e or '?'}, "
            f"fixed {seconds_f or '?'})."
        )
        env = (elastic.get("p99_peak_phase") or {}).get(schedule)
        if env:
            verdict = (
                "within" if env.get("within_envelope") else "OUTSIDE"
            )
            lines.append(
                f"  Peak-phase p99: elastic {env.get('elastic_ms')} ms vs "
                f"fixed-max {env.get('fixed_max_ms')} ms — {verdict} the "
                f"{env.get('envelope_factor')}x envelope."
            )
    return lines


def _render_migration(migration: Dict[str, Any]) -> List[str]:
    """The durable-sessions A/B (BENCH_serve_migration.json): per-event
    outcome table per side and the window-reset verdict the snapshot
    ring exists to win."""
    lines = [""]
    resets = migration.get("value", 0)
    lines.append(
        f"Durable sessions (BENCH_serve_migration.json): "
        f"{resets} window reset(s) on the durable side vs "
        f"{migration.get('legacy_window_resets', '?')} legacy, across "
        f"{migration.get('fleet_replicas', '?')} stub replicas and the "
        f"{'/'.join(migration.get('events', []))} gauntlet "
        f"({migration.get('requests_failed', '?')} failed requests)."
    )
    lines.append(
        "Continuations token-identical: "
        + (
            "yes"
            if migration.get("token_identical_continuations")
            else "NO"
        )
        + "; compile pinned at bucket count: "
        + (
            "yes"
            if migration.get("compile_pinned_at_bucket_count")
            else "NO"
        )
        + "."
    )
    sides = migration.get("sides") or {}
    for side in ("durable", "legacy"):
        rec = sides.get(side) or {}
        rows = [
            r
            for r in rec.get("events", [])
            if r.get("event") in (migration.get("events") or [])
        ]
        if not rows:
            continue
        lines.append("")
        lines.append(
            f"{'[' + side + ']':<12}{'event':<16}{'ok':>6}{'migr':>6}"
            f"{'rest':>6}{'rej':>6}{'fail':>6}{'resets':>8}"
        )
        for row in rows:
            lines.append(
                f"{'':<12}{row.get('event', '?'):<16}"
                f"{row.get('ok', 0):>6}"
                f"{row.get('migrated', 0):>6}"
                f"{row.get('restarted', 0):>6}"
                f"{row.get('rejected', 0):>6}"
                f"{row.get('failed', 0):>6}"
                f"{row.get('window_resets', 0):>8}"
            )
        counters = rec.get("migration_counters") or {}
        if counters:
            lines.append(
                f"  exports {counters.get('migration_exports_total', 0)}, "
                f"imports {counters.get('migration_imports_total', 0)} "
                f"({counters.get('migration_import_failures_total', 0)} "
                f"failed), ring restores "
                f"{counters.get('migration_restores_total', 0)} "
                f"({counters.get('migration_restore_failures_total', 0)} "
                f"failed)."
            )
    return lines


def render_report(
    workdir: str,
    goodput: Optional[Dict[str, Any]],
    flight: Optional[Dict[str, Any]],
    tb: Optional[Dict[str, Tuple[int, float]]],
    tail: int = 8,
    serve: Optional[Dict[str, Any]] = None,
    eval_matrix: Optional[Dict[str, Any]] = None,
    multichip: Optional[Dict[str, Any]] = None,
    deploy: Optional[Dict[str, Any]] = None,
    obs: Optional[Dict[str, Any]] = None,
) -> str:
    sections = [
        [f"# RT-1 run report — {workdir}", ""],
        render_goodput(goodput),
        [""],
        render_health(tb),
        [""],
        render_flight(flight, tail=tail),
        [""],
        render_scalars(tb),
        [""],
    ]
    # Serve / eval-matrix / multichip sections only when their artifacts
    # exist: a training-only workdir keeps its report unchanged (and its
    # golden tests green).
    if multichip is not None:
        # Right after the goodput section — the single-host hours and the
        # scale-out measurements are one story.
        sections.insert(2, render_multichip(multichip))
        sections.insert(2, [""])
    if eval_matrix is not None:
        sections.insert(1, [""])
        sections.insert(1, render_eval_matrix(eval_matrix))
    if serve is not None:
        sections.insert(1, [""])
        sections.insert(1, render_serve(serve, tail=tail))
    if obs is not None:
        # Above the serve post-mortem: the alert timeline is the index
        # into the SLO story below it.
        sections.insert(1, [""])
        sections.insert(1, render_obs(obs))
    if deploy is not None:
        # Ahead of the serve post-mortem: what the fleet is serving (and
        # how it got there) frames the SLO story below it.
        sections.insert(1, [""])
        sections.insert(1, render_deploy(deploy))
    return "\n".join(line for sec in sections for line in sec)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workdir", required=True)
    p.add_argument("--out", default="",
                   help="Write the report here instead of stdout.")
    p.add_argument("--tail", type=int, default=8,
                   help="Flight-recorder records to show.")
    p.add_argument("--multichip", default="",
                   help="Path to a MULTICHIP_*.json scale-out record to "
                        "render beside the goodput section (default: the "
                        "newest one in --workdir, if any).")
    args = p.parse_args(argv)

    report = render_report(
        args.workdir,
        load_goodput(args.workdir),
        load_flight(args.workdir),
        load_tb_scalars(args.workdir),
        tail=args.tail,
        serve=load_serve(args.workdir),
        eval_matrix=load_eval_matrix(args.workdir),
        multichip=load_multichip(args.workdir, args.multichip),
        deploy=load_deploy(args.workdir),
        obs=load_obs(args.workdir),
    )
    if args.out:
        with open(args.out, "w") as f:
            f.write(report + "\n")
        print(f"run_report: written to {args.out}", file=sys.stderr)
    else:
        print(report)
    return report


if __name__ == "__main__":
    main()
