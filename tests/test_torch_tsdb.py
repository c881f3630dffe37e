"""The port's metrics plane (`rt1_tpu_torch/obs/{tsdb,alerts,collector,
dashboard}.py` and `prometheus.render_deploy_snapshot`) against the JAX
package's on the same ingest.

Every case of `tests/test_obs_tsdb.py` runs twice, once on each package's
modules, under the same injected fake clocks and fetchers; each run makes
that file's assertions and returns what it observed (query results, alert
transitions, exposition text, snapshot files). Tolerance: exact — the two
runs' records must be equal, the rendered text byte for byte. The stub
fleet case drives each package's own router and stub replicas.
"""

import json
import os
import threading
import types

import pytest

import rt1_tpu.obs.alerts as jax_alerts
import rt1_tpu.obs.collector as jax_collector
import rt1_tpu.obs.dashboard as jax_dashboard
import rt1_tpu.obs.prometheus as jax_prometheus
import rt1_tpu.obs.tsdb as jax_tsdb
import rt1_tpu_torch.obs.alerts as port_alerts
import rt1_tpu_torch.obs.collector as port_collector
import rt1_tpu_torch.obs.dashboard as port_dashboard
import rt1_tpu_torch.obs.prometheus as port_prometheus
import rt1_tpu_torch.obs.tsdb as port_tsdb


def _ns(tsdb, alerts, collector, dashboard, prometheus):
    return types.SimpleNamespace(
        TSDB=tsdb.TSDB, SNAPSHOT_BASENAME=tsdb.SNAPSHOT_BASENAME, read_snapshot=tsdb.read_snapshot,
        AlertManager=alerts.AlertManager, AlertRule=alerts.AlertRule,
        default_ruleset=alerts.default_ruleset, threshold_condition=alerts.threshold_condition,
        Collector=collector.Collector, Target=collector.Target, flatten_json=collector.flatten_json,
        parse_exposition=prometheus.parse_exposition, prometheus=prometheus,
        dashboard=dashboard,
    )


JAX = _ns(jax_tsdb, jax_alerts, jax_collector, jax_dashboard, jax_prometheus)
PORT = _ns(port_tsdb, port_alerts, port_collector, port_dashboard, port_prometheus)


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += float(dt)
        return self.t


def _both(case, tmp_path):
    """Run `case` on each package (own scratch dir); the records must match."""
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_dir.mkdir()
    port_dir.mkdir()
    port = case(PORT, port_dir)
    ref = case(JAX, jax_dir)
    assert port == ref
    return port


def _samples(m, text):
    return {(name, tuple(sorted(labels.items()))): value
            for name, labels, value in m.parse_exposition(text).samples}


# ------------------------------------------------------------------ TSDB


def case_point_cap_ring_overwrite(m, _):
    clock = FakeClock()
    db = m.TSDB(max_points=4, clock=clock)
    for i in range(10):
        db.append("f", float(i), t=clock.advance(1.0))
    pts = db.points("f")
    assert [v for _, v in pts] == [6.0, 7.0, 8.0, 9.0]
    assert db.points_evicted_total == 6
    return pts, db.stats()


def case_time_retention(m, _):
    clock = FakeClock()
    db = m.TSDB(retention_s=10.0, clock=clock)
    db.append("f", 1.0, t=clock.t)
    clock.advance(5.0)
    db.append("f", 2.0, t=clock.t)
    first = db.points("f")
    assert len(first) == 2
    clock.advance(20.0)
    assert db.points("f") == []
    assert db.latest("f") is None
    return first, db.stats()


def case_max_series_evicts_quietest(m, _):
    db = m.TSDB(max_series=2, clock=FakeClock())
    db.append("a", 1.0)
    db.append("b", 1.0)
    db.append("a", 2.0)
    db.append("c", 1.0)
    assert db.families() == ["a", "c"]
    assert db.series_dropped_total == 1
    return db.families(), db.stats()


def case_labels_key_series(m, _):
    db = m.TSDB(clock=FakeClock())
    db.append("up", 1.0, labels={"replica_id": "0"})
    db.append("up", 0.0, labels={"replica_id": "1"})
    assert db.instances("up") == [{"replica_id": "0"}, {"replica_id": "1"}]
    assert db.latest("up", labels={"replica_id": "1"})[1] == 0.0
    return db.instances("up"), db.series_index()


def case_query_aggregates(m, _):
    clock = FakeClock()
    db = m.TSDB(clock=clock)
    for i, v in enumerate([1.0, 3.0, 2.0, 10.0]):
        db.append("g", v, t=1000.0 + 10.0 * i)
    clock.t = 1030.0
    out = {agg: db.query("g", agg, 100.0)
           for agg in ("latest", "avg", "min", "max", "sum", "count", "delta")}
    assert out == {"latest": 10.0, "avg": 4.0, "min": 1.0, "max": 10.0, "sum": 16.0,
                   "count": 4.0, "delta": 9.0}
    out["quantile"] = db.query("g", "quantile", 100.0, q=0.5)
    assert out["quantile"] == 3.0
    out["avg15"] = db.query("g", "avg", 15.0)
    assert out["avg15"] == 6.0
    assert db.query("g", "avg", 10.0, now=1000.0 + 3600.0) is None
    with pytest.raises(ValueError):
        db.query("g", "p99", 100.0)
    return out


def case_increase_counter_reset(m, _):
    clock = FakeClock(t=1040.0)
    db = m.TSDB(clock=clock)
    for i, v in enumerate([10.0, 15.0, 2.0, 7.0]):
        db.append("c_total", v, t=1000.0 + 10.0 * i)
    out = [db.query("c_total", agg, 100.0) for agg in ("increase", "rate", "delta")]
    assert out[0] == 10.0 and out[1] == pytest.approx(10.0 / 30.0) and out[2] == -3.0
    db.append("single", 5.0, t=1040.0)
    assert db.query("single", "increase", 100.0) is None
    return out


def case_append_many_one_timestamp(m, _):
    db = m.TSDB(clock=FakeClock())
    n = db.append_many([("a", None, 1.0), ("b", {"x": "1"}, 2.0)], t=1234.0)
    assert n == 2
    assert db.points("a")[0][0] == 1234.0
    assert db.points("b", labels={"x": "1"})[0][0] == 1234.0
    return db.series_index()


def case_concurrent_append_and_query(m, _):
    db = m.TSDB(max_points=256)
    errors = []

    def writer(wid):
        try:
            for i in range(300):
                db.append("w", float(i), labels={"writer": str(wid)})
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    def reader():
        try:
            for _ in range(200):
                db.query("w", "latest", 3600.0, labels={"writer": "0"})
                db.series_index()
                db.stats()
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    threads = [threading.Thread(target=writer, args=(w,)) for w in range(4)]
    threads += [threading.Thread(target=reader) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    assert db.appends_total == 4 * 300
    # The wall clock stamps the points: compare what does not depend on it.
    return db.appends_total, sorted(len(db.points("w", labels={"writer": str(w)}))
                                    for w in range(4))


def case_snapshot_round_trip(m, tmp):
    db = m.TSDB(clock=FakeClock())
    db.append("a", 1.5, t=1000.0)
    db.append("a", 2.5, t=1001.0)
    db.append("b", 7.0, labels={"k": "v"}, t=1000.0)
    path = db.write_snapshot(str(tmp / m.SNAPSHOT_BASENAME))
    loaded = m.read_snapshot(path)
    assert loaded["header"]["series"] == 2
    assert loaded["header"]["points"] == 3
    db2 = m.TSDB(clock=FakeClock())
    assert db2.restore(path) == 3
    assert [v for _, v in db2.points("a")] == [1.5, 2.5]
    assert db2.latest("b", labels={"k": "v"}) == (1000.0, 7.0)
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    # The header's write time is the wall clock: drop it, keep the rest.
    for line in lines:
        line.pop("written_unix", None)
    return lines, loaded["series"]


def case_snapshot_torn_final_line(m, tmp):
    db = m.TSDB(clock=FakeClock())
    db.append("a", 1.0, t=1000.0)
    db.append("b", 2.0, t=1000.0)
    path = db.write_snapshot(str(tmp / m.SNAPSHOT_BASENAME))
    body = open(path).read().rstrip("\n")
    torn = str(tmp / "torn.jsonl")
    with open(torn, "w") as f:
        f.write(body[: len(body) - 10])
    loaded = m.read_snapshot(torn)
    assert [row["family"] for row in loaded["series"]] == ["a"]
    db2 = m.TSDB(clock=FakeClock())
    assert db2.restore(torn) == 1
    return loaded["series"]


def case_snapshot_write_is_atomic(m, tmp):
    db = m.TSDB(clock=FakeClock())
    db.append("a", 1.0, t=1000.0)
    path = str(tmp / "snap" / m.SNAPSHOT_BASENAME)
    db.write_snapshot(path)
    db.append("a", 2.0, t=1001.0)
    db.write_snapshot(path)
    assert not os.path.exists(path + ".tmp")
    assert m.read_snapshot(path)["header"]["points"] == 2
    return sorted(os.listdir(tmp / "snap"))


# ---------------------------------------------------------------- alerts


def _rule(m, for_duration_s=0.0, threshold=5.0, **kw):
    return m.AlertRule(
        name=kw.pop("name", "HighG"),
        condition=m.threshold_condition("g", op=">=", threshold=threshold, agg="latest",
                                        window_s=60.0),
        for_duration_s=for_duration_s,
        **kw,
    )


def case_for_duration_gates_pending(m, _):
    clock = FakeClock()
    db = m.TSDB(clock=clock)
    mgr = m.AlertManager(db, [_rule(m, for_duration_s=10.0)], clock=clock)
    db.append("g", 9.0, t=clock.t)
    assert mgr.evaluate() == []
    assert mgr.active()[0]["state"] == "pending"
    clock.advance(5.0)
    db.append("g", 9.0, t=clock.t)
    assert mgr.evaluate() == []
    clock.advance(5.0)
    db.append("g", 9.0, t=clock.t)
    events = mgr.evaluate()
    assert [e["event"] for e in events] == ["firing"]
    assert mgr.active()[0]["state"] == "firing"
    assert mgr.counters()["fired_total"] == 1
    return events, mgr.status(), mgr.prometheus_text()


def case_zero_for_duration_fires(m, _):
    clock = FakeClock()
    db = m.TSDB(clock=clock)
    mgr = m.AlertManager(db, [_rule(m)], clock=clock)
    db.append("g", 9.0, t=clock.t)
    events = mgr.evaluate()
    assert [e["event"] for e in events] == ["firing"]
    return events, mgr.prometheus_text()


def case_cleared_pending_rearms(m, _):
    clock = FakeClock()
    db = m.TSDB(clock=clock)
    mgr = m.AlertManager(db, [_rule(m, for_duration_s=10.0)], clock=clock)
    db.append("g", 9.0, t=clock.t)
    mgr.evaluate()
    db.append("g", 1.0, t=clock.advance(1.0))
    assert mgr.evaluate() == []
    assert mgr.active() == [] and mgr.history() == []
    db.append("g", 9.0, t=clock.advance(1.0))
    mgr.evaluate()
    clock.advance(9.0)
    db.append("g", 9.0, t=clock.t)
    assert mgr.evaluate() == []
    clock.advance(1.0)
    db.append("g", 9.0, t=clock.t)
    events = mgr.evaluate()
    assert [e["event"] for e in events] == ["firing"]
    return events, mgr.status()


def case_resolve_emits_duration(m, _):
    clock = FakeClock()
    db = m.TSDB(clock=clock)
    fired, resolved = [], []
    mgr = m.AlertManager(db, [_rule(m)], clock=clock, on_fire=fired.append,
                         on_resolve=resolved.append)
    db.append("g", 9.0, t=clock.t)
    mgr.evaluate()
    db.append("g", 1.0, t=clock.advance(30.0))
    events = mgr.evaluate()
    assert [e["event"] for e in events] == ["resolved"]
    assert events[0]["duration_s"] == 30.0
    assert len(fired) == 1 and len(resolved) == 1
    assert [e["event"] for e in mgr.history()] == ["firing", "resolved"]
    db.append("g", 9.0, t=clock.advance(1.0))
    assert [e["event"] for e in mgr.evaluate()] == ["firing"]
    assert mgr.counters()["fired_total"] == 2
    return fired, resolved, mgr.status()


def case_rule_error_freezes(m, _):
    clock = FakeClock()
    db = m.TSDB(clock=clock)
    blow_up = {"on": False}

    def cond(tsdb, now):
        if blow_up["on"]:
            raise RuntimeError("scrape database on fire")
        pts = tsdb.points("g", window_s=60.0, now=now)
        return [({}, pts[-1][1])] if pts and pts[-1][1] >= 5.0 else []

    mgr = m.AlertManager(db, [m.AlertRule("X", cond)], clock=clock)
    db.append("g", 9.0, t=clock.t)
    mgr.evaluate()
    assert mgr.active()[0]["state"] == "firing"
    blow_up["on"] = True
    assert mgr.evaluate() == []
    assert mgr.active()[0]["state"] == "firing"
    assert mgr.counters()["rule_errors_total"] == 1
    return mgr.status()


def case_callback_errors_swallowed(m, _):
    clock = FakeClock()
    db = m.TSDB(clock=clock)

    def bad_cb(event):
        raise RuntimeError("pager webhook down")

    mgr = m.AlertManager(db, [_rule(m)], clock=clock, on_fire=bad_cb)
    db.append("g", 9.0, t=clock.t)
    events = mgr.evaluate()
    assert [e["event"] for e in events] == ["firing"]
    assert mgr.counters()["callback_errors_total"] == 1
    return events, mgr.counters()


def case_per_instance_fanout_text(m, _):
    clock = FakeClock()
    db = m.TSDB(clock=clock)
    mgr = m.AlertManager(db, [_rule(m, severity="page")], clock=clock)
    db.append("g", 9.0, labels={"replica_id": "0"}, t=clock.t)
    db.append("g", 1.0, labels={"replica_id": "1"}, t=clock.t)
    mgr.evaluate()
    active = mgr.active()
    assert len(active) == 1 and active[0]["labels"] == {"replica_id": "0"}
    text = mgr.prometheus_text()
    samples = _samples(m, text)
    assert samples[("rt1_alert_firing", (("alert", "HighG"), ("replica_id", "0"),
                                         ("severity", "page")))] == 1.0
    assert samples[("rt1_alert_fired_total", ())] == 1.0
    return text


def case_duplicate_rule_names_rejected(m, _):
    db = m.TSDB(clock=FakeClock())
    errors = []
    for build in (lambda: m.AlertManager(db, [_rule(m), _rule(m)]),
                  lambda: m.AlertRule("bad", lambda tsdb, now: [], severity="sev1"),
                  lambda: m.AlertRule("bad", lambda tsdb, now: [], for_duration_s=-1.0)):
        with pytest.raises(ValueError) as info:
            build()
        errors.append(str(info.value))
    return errors


def case_default_ruleset_names(m, _):
    rules = m.default_ruleset()
    names = {r.name for r in rules}
    assert {"SLOBurnRateFast", "SLOBurnRateSlow", "ReplicaDown", "CanarySLOBreach",
            "CompileCountDrift", "FeederStall", "AutoscalerFlapping", "CacheRebuildStorm",
            "CaptureDiskPressure"} <= names
    return [(r.name, r.severity, r.for_duration_s, r.annotations) for r in rules]


def case_default_ruleset_quiet_on_empty(m, _):
    clock = FakeClock()
    db = m.TSDB(clock=clock)
    mgr = m.AlertManager(db, m.default_ruleset(), clock=clock)
    assert mgr.evaluate() == [] and mgr.active() == []
    assert mgr.counters()["rule_errors_total"] == 0
    return mgr.status(), mgr.prometheus_text()


def case_slo_burn_alerts(m, _):
    clock = FakeClock()
    db = m.TSDB(clock=clock)
    mgr = m.AlertManager(db, m.default_ruleset(), clock=clock)
    total, ok = 0, 0
    for _ in range(600):
        total, ok = total + 1, ok + 1
        db.append("rt1_serve_slo_requests_total", total, t=clock.t)
        db.append("rt1_serve_slo_requests_ok", ok, t=clock.advance(1.0))
    assert mgr.evaluate() == []
    for i in range(60):
        total += 1
        ok += i % 2
        db.append("rt1_serve_slo_requests_total", total, t=clock.t)
        db.append("rt1_serve_slo_requests_ok", ok, t=clock.advance(1.0))
    fired = {e["alert"] for e in mgr.evaluate() if e["event"] == "firing"}
    assert "SLOBurnRateFast" in fired
    for _ in range(300):
        total, ok = total + 1, ok + 1
        db.append("rt1_serve_slo_requests_total", total, t=clock.t)
        db.append("rt1_serve_slo_requests_ok", ok, t=clock.advance(1.0))
        mgr.evaluate()
    assert "SLOBurnRateFast" not in {a["alert"] for a in mgr.active()}
    return sorted(fired), mgr.history(), mgr.prometheus_text()


# -------------------------------------------------------------- collector


def case_collector_ingests_per_target(m, _):
    clock = FakeClock()
    db = m.TSDB(clock=clock)
    bodies = {
        "http://a/metrics": ("# TYPE rt1_serve_replica_up gauge\n"
                             'rt1_serve_replica_up{replica_id="0"} 1\n'),
        "http://b/deploy/status": json.dumps(
            {"phase": "idle", "rollbacks_total": 2, "canary": {"armed": True}}),
    }
    coll = m.Collector(
        db,
        [m.Target("fleet", "http://a/metrics"),
         m.Target("deploy", "http://b/deploy/status", kind="json", prefix="rt1_deploy_status")],
        clock=clock,
        fetch_fn=lambda url, timeout_s: bodies[url],
    )
    ingested = coll.scrape_once()
    assert ingested == {"fleet": 1, "deploy": 2}
    t_up = db.latest("rt1_serve_replica_up", {"replica_id": "0"})[0]
    assert db.latest("rt1_deploy_status_rollbacks_total")[0] == t_up
    assert db.latest("rt1_deploy_status_canary_armed")[1] == 1.0
    stats = coll.stats()["targets"]
    assert stats["fleet"]["up"] == 1.0
    assert stats["deploy"]["samples_ingested_total"] == 2.0
    for target in stats.values():
        target.pop("last_scrape_duration_s")  # wall time
    return ingested, db.series_index(), stats


def case_collector_failed_target(m, _):
    clock = FakeClock()
    db = m.TSDB(clock=clock)

    def fetch(url, timeout_s):
        if "dead" in url:
            raise OSError("connection refused")
        return "# TYPE g gauge\ng 1\n"

    coll = m.Collector(db, [m.Target("live", "http://live/metrics"),
                            m.Target("dead", "http://dead/metrics")],
                       clock=clock, fetch_fn=fetch)
    ingested = coll.scrape_once()
    assert ingested == {"live": 1, "dead": -1}
    stats = coll.stats()["targets"]
    assert stats["dead"]["up"] == 0.0 and stats["dead"]["scrape_errors_total"] == 1.0
    assert stats["live"]["up"] == 1.0
    assert db.latest("g")[1] == 1.0
    samples = _samples(m, coll.prometheus_text())
    assert samples[("rt1_obs_collector_up", (("target", "dead"),))] == 0.0
    assert samples[("rt1_obs_collector_cycles_total", ())] == 1.0
    return ingested, {k: v for k, v in samples.items() if "duration" not in k[0]}


def case_collector_cadence_is_alert_cadence(m, _):
    clock = FakeClock()
    db = m.TSDB(clock=clock)
    mgr = m.AlertManager(db, m.default_ruleset(), clock=clock)
    coll = m.Collector(
        db, [m.Target("fleet", "http://a/metrics")], clock=clock,
        fetch_fn=lambda url, timeout_s: ("# TYPE rt1_serve_replica_up gauge\n"
                                         'rt1_serve_replica_up{replica_id="1"} 0\n'),
        alert_manager=mgr,
    )
    coll.scrape_once()
    active = {a["alert"]: a for a in mgr.active()}
    assert active["ReplicaDown"]["state"] == "firing"
    assert active["ReplicaDown"]["labels"]["replica_id"] == "1"
    return mgr.active(), mgr.prometheus_text()


def case_collector_rejects_bad_config(m, _):
    db = m.TSDB(clock=FakeClock())
    errors = []
    for build in (lambda: m.Collector(db, [m.Target("a", "u"), m.Target("a", "u2")]),
                  lambda: m.Collector(db, [m.Target("a", "u")], interval_s=0.0),
                  lambda: m.Target("a", "u", kind="xml")):
        with pytest.raises(ValueError) as info:
            build()
        errors.append(str(info.value))
    return errors


def case_flatten_json(m, _):
    samples = m.flatten_json(
        {"a": {"b": 1, "c": True}, "d": 2.5, "skip_str": "READY", "skip_list": [1, 2]}, "p")
    assert sorted(samples) == [("p_a_b", None, 1.0), ("p_a_c", None, 1.0), ("p_d", None, 2.5)]
    return sorted(samples)


# ------------------------------------------------------ dashboard / deploy


def _populated(m):
    clock = FakeClock()
    db = m.TSDB(clock=clock)
    mgr = m.AlertManager(db, [_rule(m, severity="page")] + m.default_ruleset(), clock=clock)
    for i in range(30):
        db.append("g", float(i % 7), labels={"replica_id": str(i % 2)}, t=clock.advance(2.0))
        db.append("rt1_serve_requests_total", float(3 * i), t=clock.t)
        mgr.evaluate()
    coll = m.Collector(db, [m.Target("fleet", "http://a/metrics")], clock=clock,
                       fetch_fn=lambda url, timeout_s: "# TYPE h gauge\nh 2\n")
    coll.scrape_once()
    # The scrape's wall time renders in both pages: pin it.
    coll._per_target["fleet"]["last_scrape_duration_s"] = 0.001
    return db, mgr, coll


def case_dashboard_html(m, _):
    db, mgr, coll = _populated(m)
    html = m.dashboard.render_dashboard_html(
        db, alert_manager=mgr, collector=coll,
        fleet_status={"replicas": [{"id": 0, "state": "ready"}]},
        deploy_status={"state": "canary", "canary_burn": 0.5})
    assert "<html" in html.lower()
    return html


def case_dashboard_console(m, _):
    db, mgr, coll = _populated(m)
    return m.dashboard.render_console(db, alert_manager=mgr, collector=coll, window_s=600.0)


def case_deploy_snapshot_text(m, _):
    gauges = {"state": "canary", "ticks_total": 7, "canary_burn": 2.5, "incumbent_step": 4,
              "rollbacks_total": 1, "ignored_bool": True, "ignored_list": [1]}
    text = m.prometheus.render_deploy_snapshot(gauges)
    names = m.prometheus.deploy_metric_names(gauges)
    assert {n for n, _, _ in m.parse_exposition(text).samples} >= set(names) - {"rt1_deploy_state"}
    return text, names


CASES = [
    case_point_cap_ring_overwrite, case_time_retention, case_max_series_evicts_quietest,
    case_labels_key_series, case_query_aggregates, case_increase_counter_reset,
    case_append_many_one_timestamp, case_concurrent_append_and_query, case_snapshot_round_trip,
    case_snapshot_torn_final_line, case_snapshot_write_is_atomic,
    case_for_duration_gates_pending, case_zero_for_duration_fires, case_cleared_pending_rearms,
    case_resolve_emits_duration, case_rule_error_freezes, case_callback_errors_swallowed,
    case_per_instance_fanout_text, case_duplicate_rule_names_rejected, case_default_ruleset_names,
    case_default_ruleset_quiet_on_empty, case_slo_burn_alerts,
    case_collector_ingests_per_target, case_collector_failed_target,
    case_collector_cadence_is_alert_cadence, case_collector_rejects_bad_config, case_flatten_json,
    case_dashboard_html, case_dashboard_console, case_deploy_snapshot_text,
]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[len("case_"):] for c in CASES])
def test_metrics_plane_matches_jax(case, tmp_path):
    _both(case, tmp_path)


# ------------------------------------------- stub-fleet integration


def _stub_fleet_plane(pkg):
    """The whole plane against an in-process stub fleet of package `pkg`:
    capture-mimicking stubs, one aggregated scrape, ReplicaDown firing
    when a replica goes dark and resolving when it comes back."""
    import importlib

    router_mod = importlib.import_module(pkg + ".serve.router")
    stub_mod = importlib.import_module(pkg + ".serve.stub")
    m = PORT if pkg == "rt1_tpu_torch" else JAX
    router = router_mod.Router(replica_timeout_s=5.0)
    servers = []

    def boot(rid):
        httpd = stub_mod.make_stub_server(stub_mod.StubReplicaApp(replica_id=rid,
                                                                  mimic_capture=True))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        host, port = httpd.server_address[:2]
        replica = router.add_replica(router_mod.Replica(rid, url=f"http://{host}:{port}"))
        replica.state = router_mod.READY
        servers.append(httpd)

    try:
        for rid in range(2):
            boot(rid)
        router.route_act({"session_id": "s0", "image_b64": "AAAA"})
        clock = FakeClock()
        db = m.TSDB(clock=clock)
        mgr = m.AlertManager(db, m.default_ruleset(), clock=clock)
        coll = m.Collector(db, [m.Target("fleet", "ignored://in-process")], clock=clock,
                           fetch_fn=lambda url, t: router.fleet_metrics_prometheus(),
                           alert_manager=mgr)
        ingested = coll.scrape_once()["fleet"]
        assert ingested > 50
        capture = {}
        for rid in ("0", "1"):
            assert db.latest("rt1_serve_replica_capture_write_errors_total",
                             {"replica_id": rid}) is not None
            capture[rid] = db.latest("rt1_serve_replica_capture_enabled", {"replica_id": rid})[1]
            assert capture[rid] == 1.0
        assert mgr.active() == []
        servers[1].shutdown()
        servers[1].server_close()
        clock.advance(2.0)
        coll.scrape_once()
        active = {(a["alert"], a["labels"].get("replica_id")): a["state"] for a in mgr.active()}
        assert active == {("ReplicaDown", "1"): "firing"}
        router.remove_replica(1)
        boot(1)
        clock.advance(2.0)
        coll.scrape_once()
        assert [e["event"] for e in mgr.history()] == ["firing", "resolved"]
        assert mgr.active() == []
        return {"families": sorted({row["family"] for row in db.series_index()
                                    if "latency" not in row["family"]
                                    and "seconds" not in row["family"]
                                    and "_ms" not in row["family"]}),
                "capture": capture, "alerts": [(e["alert"], e["event"], e["labels"])
                                              for e in mgr.history()]}
    finally:
        for httpd in servers:
            try:
                httpd.shutdown()
                httpd.server_close()
            except OSError:
                pass


def test_collector_over_stub_fleet_matches_jax():
    assert _stub_fleet_plane("rt1_tpu_torch") == _stub_fleet_plane("rt1_tpu")
