"""The port's serving fleet on the port's stub replicas, and against the JAX
package's fleet on its own stubs.

The stub (`rt1_tpu_torch/serve/stub.py`) speaks the replica protocol with
no model behind it and imports neither torch nor JAX, so two replicas spawn
in about a second. On it run:

* the scenarios of the JAX package's `tests/test_serve_fleet.py`: warm-up
  gating and the proxied contract, session affinity and spread, the
  rolling reload, request-id propagation into both processes' spans, the
  JSON and Prometheus `/metrics` fan-out, a mixed-dtype fleet, `/slo` and
  `/fleet/slow_requests`, and a SIGKILLed replica's sessions re-homed with
  `"restarted": true` while the supervisor respawns it;
* the scenarios of `tests/test_serve_elastic.py`: the autoscaler's
  1 -> 3 -> 1 cycle with an int8 surge tier and live migration, and
  admission-control sheds as 429s;
* a cross-check: one scripted session sequence with a kill, through the
  JAX fleet on JAX stubs and the port's fleet on port stubs, gives the same
  session -> replica map, `restarted` flags, stub actions and steps, and
  the same Prometheus family names and label sets;
* the CLI: `python -m rt1_tpu_torch.serve.fleet --stub` with a
  `replica_kill` chaos tick; the operations loop's three flags, each
  arming on a stub fleet (`--collector`: `/alerts`, `/history`,
  `/dashboard`; `--capture_dir`: the replicas' capture dirs swept into
  `staging`; `--promote_from`: `/deploy/status` and a promotion) and
  absent on an unarmed one; the refusal of a CUDA fleet where there is no
  card; the cost weights from the port's own
  flagship bytes; and that the router, supervisor and stub import no torch.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from rt1_tpu.serve import fleet as jfleet
from rt1_tpu.serve import router as jrouter
from rt1_tpu_torch.obs import prometheus as prom
from rt1_tpu_torch.serve import fleet as pfleet
from rt1_tpu_torch.serve.autoscale import AutoscalePolicy
from rt1_tpu_torch.serve.fleet import DTYPE_COST_WEIGHTS, FleetSupervisor
from rt1_tpu_torch.serve.router import (
    DEAD,
    READY,
    TIER_SURGE,
    AdmissionController,
    Router,
    make_router_server,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_STUB_DTYPES = ("f32", "int8")


def _stub_argv(replica_id, dtype=None, module="rt1_tpu_torch.serve.stub"):
    return [sys.executable, "-m", module, "--port", "0", "--replica_id", str(replica_id),
            "--inference_dtype", dtype or _STUB_DTYPES[replica_id % len(_STUB_DTYPES)]]


def _post(url, payload, headers=None):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=15) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def _get(url, headers=None):
    req = urllib.request.Request(url, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=15) as resp:
            body = resp.read()
            try:
                return resp.status, json.loads(body)
            except json.JSONDecodeError:
                return resp.status, body.decode("utf-8")
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def _act(url, session_id, task=None):
    payload = {"session_id": session_id, "image_b64": "AAAA", "instruction": "x"}
    if task:
        payload["task"] = task
    return _post(url + "/act", payload)


def _wait_until(predicate, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


class _Fleet:
    """A supervisor over stub replicas behind a routed HTTP frontend."""

    def __init__(self, router_cls, supervisor_cls, server_fn, argv_fn, n, router_kw=None,
                 **supervisor_kw):
        self.router = router_cls(replica_timeout_s=10.0, **(router_kw or {}))
        kw = dict(poll_interval_s=0.1, chaos_interval_s=3600.0, warmup_timeout_s=60.0)
        kw.update(supervisor_kw)
        self.supervisor = supervisor_cls(self.router, argv_fn, n, **kw)
        self.supervisor.start(wait_ready=True)
        self.httpd = server_fn(self.router, host="127.0.0.1", port=0)
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=5)
        self.supervisor.stop()


def _port_fleet(n, argv_fn=lambda rid: _stub_argv(rid), router_kw=None, **kw):
    return _Fleet(Router, FleetSupervisor, make_router_server, argv_fn, n, router_kw, **kw)


@pytest.fixture(scope="module")
def fleet():
    """Two supervised stub replicas (f32 and int8). The kill test at the
    bottom relies on the supervisor healing back to 2 ready."""
    f = _port_fleet(2)
    yield f.router, f.supervisor, f.url
    f.close()


# -------------------------------------------- tests/test_serve_fleet.py


def test_fleet_ready_with_proxied_contract(fleet):
    router, _, url = fleet
    assert router.ready_count() == 2
    status, body = _get(url + "/readyz")
    assert status == 200 and body["ready"] is True
    status, health = _get(url + "/healthz")
    assert status == 200 and health["image_shape"] == [8, 14, 3]
    assert health["replicas_total"] == 2
    status, fs = _get(url + "/fleet/status")
    assert [r["state"] for r in fs["replicas"]] == [READY, READY]
    assert all(r["metrics"]["compile_count"] == 1 == r["metrics"]["bucket_count"]
               for r in fs["replicas"])


def test_session_affinity_and_spread(fleet):
    _, _, url = fleet
    homes = set()
    for expected_step in range(3):
        status, body = _act(url, "affine")
        assert status == 200 and body["step_index"] == expected_step
        homes.add(body["replica_id"])
    assert len(homes) == 1
    status, body = _act(url, "affine-2")
    assert status == 200 and body["replica_id"] != next(iter(homes))


def test_rolling_reload_hits_every_replica(fleet):
    router, _, url = fleet
    status, body = _post(url + "/reload", {"step": 11})
    assert status == 200 and body["ok"] is True, body
    assert [r["status"] for r in body["replicas"]] == [200, 200]
    assert all(r["checkpoint_step"] == 11 for r in body["replicas"])
    status, fs = _get(url + "/fleet/status")
    assert [r["metrics"]["reloads_total"] for r in fs["replicas"]] == [1, 1]
    assert router.ready_count() == 2
    assert _act(url, "post-reload")[0] == 200


def test_request_id_propagates_end_to_end(fleet):
    from rt1_tpu_torch.obs import trace as obs_trace

    router, _, url = fleet
    rid = "e2e-propagation-id"
    tracer = obs_trace.enable(max_events=256)
    try:
        status, body = _post(url + "/act", {"session_id": "traced-sess", "image_b64": "AAAA",
                                            "instruction": "x", "debug": True},
                             headers={"X-RT1-Request-Id": rid})
        assert status == 200 and body["request_id"] == rid
        assert body["phases"]["request_id"] == rid and body["phases"]["device_ms"] is not None
        route_spans = [e for e in tracer.to_dict()["traceEvents"]
                       if e.get("name") == "router_route"
                       and e.get("args", {}).get("request_id") == rid]
        assert len(route_spans) == 1 and route_spans[0]["args"]["session"] == "traced-sess"
    finally:
        obs_trace.disable()
    replica = next(r for r in router.replicas() if r.id == body["replica_id"])
    status, trace_body = _get(replica.url + "/trace")
    names = {e["name"] for e in trace_body["traceEvents"]
             if e.get("args", {}).get("request_id") == rid
             or rid in (e.get("args", {}).get("request_ids") or [])}
    assert {"replica_act", "device_step"} <= names


def test_fleet_metrics_aggregation_json_and_prometheus(fleet):
    _, _, url = fleet
    status, body = _get(url + "/metrics")
    assert status == 200 and set(body["replicas"]) == {"0", "1"}
    for rid, snap in body["replicas"].items():
        assert snap["compile_count"] == 1 and snap["replica_id"] == int(rid)
        assert "requests_total" in snap and "queue_depth" in snap
    assert body["slo_requests_total"] > 0 and 0.0 <= body["slo_availability"] <= 1.0
    assert body["slo_objective_availability"] == 0.99
    status, text = _get(url + "/metrics", headers={"Accept": "text/plain"})
    parsed = prom.parse_exposition(text)
    for rid in ("0", "1"):
        assert parsed.value("rt1_serve_replica_up", replica_id=rid) == 1.0
        assert parsed.value("rt1_serve_replica_compile_count", replica_id=rid) == 1.0
        assert parsed.labeled("rt1_serve_replica_requests_total")
    assert parsed.types["rt1_serve_replica_up"] == "gauge"
    assert parsed.types["rt1_serve_replica_requests_total"] == "counter"
    assert "rt1_serve_slo_availability" in parsed.types
    assert "rt1_serve_slo_error_budget_burn" in parsed.types


def test_mixed_dtype_fleet_advertises_per_replica_dtype(fleet):
    _, _, url = fleet
    status, fs = _get(url + "/fleet/status")
    by_id = {r["id"]: r for r in fs["replicas"]}
    assert (by_id[0]["metrics"]["inference_dtype"], by_id[1]["metrics"]["inference_dtype"]) == \
        ("f32", "int8")
    status, body = _get(url + "/metrics")
    for rid, snap in body["replicas"].items():
        assert snap["param_bytes_device"] == 1000 + int(rid)
        assert snap["param_bytes_master"] == 4000
    status, text = _get(url + "/metrics", headers={"Accept": "text/plain"})
    assert 'rt1_serve_replica_inference_dtype{replica_id="0",dtype="f32"} 1' in text
    assert 'rt1_serve_replica_inference_dtype{replica_id="1",dtype="int8"} 1' in text
    assert 'rt1_serve_replica_param_bytes_device{replica_id="1"} 1001' in text


def test_replica_argv_and_dtype_assignment():
    import argparse

    args = argparse.Namespace(stub=True, max_sessions=8, stub_act_delay_s=0.0,
                              slow_threshold_ms=0.0, inference_dtype="bf16",
                              replica_dtypes="f32,int8")
    assert [pfleet.replica_dtype_for(args, i) for i in range(3)] == ["f32", "int8", "f32"]
    argv = pfleet.replica_argv_builder(args)(1)
    assert argv[1:3] == ["-m", "rt1_tpu_torch.serve.stub"]
    assert argv[argv.index("--inference_dtype") + 1] == "int8"
    args.replica_dtypes = ""
    assert pfleet.replica_dtype_for(args, 5) == "bf16"
    args.replica_dtypes = "f32,fp8"
    with pytest.raises(ValueError):
        pfleet.replica_dtype_for(args, 0)
    real = argparse.Namespace(stub=False, config="language_table", max_sessions=8,
                              embedder="hash", slow_threshold_ms=50.0, inference_dtype="bf16",
                              replica_dtypes="", scheduler="continuous", buckets="auto",
                              session_snapshot_dir="/tmp/ring", snapshot_max_age_s=30.0,
                              random_init=True, workdir="", device="cuda")
    argv = pfleet.replica_argv_builder(real)(3, "int8")
    assert argv[1:3] == ["-m", "rt1_tpu_torch.serve"]
    flags = dict(zip(argv[3::2], argv[4::2]))
    assert flags["--device"] == "cuda" and flags["--inference_dtype"] == "int8"
    assert flags["--slow_threshold_ms"] == "50.0" and flags["--replica_id"] == "3"
    assert flags["--session_snapshot_dir"] == "/tmp/ring" and argv[-1] == "--random_init"
    # Every flag the fleet passes is one the port's serve CLI takes.
    from rt1_tpu_torch.serve.__main__ import parse_args

    parsed = parse_args(argv[3:])
    assert (parsed.device, parsed.slow_threshold_ms, parsed.replica_id) == ("cuda", 50.0, 3)


def test_slo_endpoint_and_fleet_slow_requests(fleet):
    _, _, url = fleet
    status, slo = _get(url + "/slo")
    assert status == 200 and slo["requests_total"] > 0
    assert set(slo["by_class"]) == {"ok", "migrated", "restarted", "rejected", "failed"}
    status, body = _get(url + "/fleet/slow_requests")
    assert set(body["replicas"]) == {"0", "1"}
    ids = {rec["request_id"] for scrape in body["replicas"].values() if scrape
           for rec in scrape.get("slow_requests", [])}
    assert "e2e-propagation-id" in ids


def test_replica_kill_rehomes_sessions_with_restarted_flag(fleet):
    router, _, url = fleet
    victims = {}
    for sid in ("kill-a", "kill-b", "kill-c", "kill-d"):
        for _ in range(3):
            status, body = _act(url, sid)
            assert status == 200
        victims[sid] = body["replica_id"]
    target_id = victims["kill-a"]
    on_target = [s for s, r in victims.items() if r == target_id]
    target = next(r for r in router.replicas() if r.id == target_id)
    restarts_before = target.restarts
    target.proc.kill()
    target.proc.wait(timeout=10)
    for sid in on_target:
        status, body = _act(url, sid)
        assert status == 200, body
        assert body["restarted"] is True and body["step_index"] == 0 and body["session_started"]
    for sid in (s for s, r in victims.items() if r != target_id):
        status, body = _act(url, sid)
        assert status == 200 and "restarted" not in body and body["step_index"] == 3
    assert router.metrics_snapshot()["sessions_restarted_total"] == len(on_target)
    gauges = router.slo.gauges()
    assert gauges["slo_requests_restarted"] == float(len(on_target))
    assert gauges["slo_requests_failed"] == 0.0
    assert gauges["slo_error_budget_burn"] > 0.0 and gauges["slo_availability"] < 1.0
    _wait_until(lambda: router.ready_count() == 2, 30.0, "the respawned replica")
    assert target.restarts == restarts_before + 1
    assert target.state == READY != DEAD


# ------------------------------------------ tests/test_serve_elastic.py


def test_elastic_scale_up_down_cycle():
    policy = AutoscalePolicy(min_replicas=1, max_replicas=3, scale_up_occupancy=0.75,
                             scale_down_occupancy=0.30, up_sustain_ticks=2, down_sustain_ticks=3,
                             up_cooldown_ticks=1, down_cooldown_ticks=1, active_window_s=1.0)
    f = _port_fleet(1, argv_fn=lambda rid, dtype=None: _stub_argv(rid, dtype or "f32"),
                    poll_interval_s=0.05, autoscale=policy, autoscale_interval_s=0.15,
                    max_sessions=2, surge_dtype="int8", base_dtype_fn=lambda _i: "f32",
                    reclaim_grace_s=0.2)
    router, supervisor, url = f.router, f.supervisor, f.url
    try:
        statuses, lock, stop = [], threading.Lock(), threading.Event()

        def client(i):
            while not stop.is_set():
                status, _ = _act(url, f"wave1-{i}")
                with lock:
                    statuses.append(status)
                time.sleep(0.01)

        threads = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(6)]
        for t in threads:
            t.start()
        try:
            _wait_until(lambda: router.ready_count() == 3, 25.0, "scale-up to 3 ready")
            assert supervisor.scale_ups >= 2
            surge = [r for r in router.replicas() if r.tier == TIER_SURGE]
            assert len(surge) == 2 and all(r.dtype == "int8" and r.id >= 1 for r in surge)
            wave2 = {}
            for i in range(4):
                status, body = _act(url, f"wave2-{i}")
                assert status == 200
                wave2[f"wave2-{i}"] = body["replica_id"]
            assert any(rid != 0 for rid in wave2.values())
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=10)
        assert statuses and set(statuses) == {200}
        _wait_until(lambda: len(router.replicas()) == 1 and router.ready_count() == 1, 30.0,
                    "drain back to 1 replica")
        assert supervisor.scale_downs >= 2 and router.replicas()[0].id == 0
        down = [e for e in supervisor.scale_events if e["direction"] == "down"]
        assert len(down) >= 2
        assert all(e["exit_code"] == 0 and e["compile_count"] == e["bucket_count"] == 1
                   for e in down)
        migrated = 0
        for sid, home in wave2.items():
            status, body = _act(url, sid)
            assert status == 200 and body["replica_id"] == 0, body
            if home != 0:
                assert body.get("migrated") is True and "restarted" not in body
                assert body["step_index"] == 1
                migrated += 1
        assert migrated >= 1
        assert [r["id"] for r in _get(url + "/fleet/status")[1]["replicas"]] == [0]
        _wait_until(lambda: _get(url + "/metrics")[1].get("autoscale_replicas") == 1, 10.0,
                    "the autoscale gauge to settle at 1")
        metrics = _get(url + "/metrics")[1]
        assert set(metrics["replicas"]) == {"0"}
        assert metrics["autoscale_scale_events_total"]["up"] >= 2
        assert metrics["autoscale_scale_events_total"]["down"] >= 2
        assert metrics["autoscale_tier_replicas"] == {"f32": 1}
        text = _get(url + "/metrics", headers={"Accept": "text/plain"})[1]
        assert 'rt1_serve_replica_up{replica_id="0"} 1' in text
        assert 'replica_id="1"' not in text and 'replica_id="2"' not in text
        assert 'rt1_serve_autoscale_tier_replicas{dtype="f32"} 1' in text
        assert "rt1_serve_autoscale_replicas 1" in text
        seconds = supervisor.replica_seconds_by_dtype()
        assert seconds["f32"] > 0 and seconds["int8"] > 0
        summary = supervisor.autoscale_summary()
        assert summary["enabled"] and 0 < summary["cost_units"] < sum(seconds.values())
    finally:
        f.close()


def test_a_reclaimed_or_stopping_replica_is_never_respawned():
    """The supervision loop checks a snapshot of the routing table. A
    reclaim that ends inside one pass (replica removed, its id no longer
    draining) must not get its exited process respawned: the new process
    would be in no router entry, so `stop()` would never end it (a stub
    replica left so held a CLI's stderr pipe open). A registered replica
    whose process died is still respawned, unless the fleet is stopping."""
    router = Router()
    supervisor = FleetSupervisor(router, lambda rid: [sys.executable, "-c", "pass"], 2)
    spawned = []
    supervisor._spawn = spawned.append

    def exited(rid):
        replica = pfleet.Replica(rid)
        replica.proc = subprocess.Popen([sys.executable, "-c", "pass"])
        replica.proc.wait()
        return router.add_replica(replica)

    drained, live = exited(1), exited(0)
    snapshot = router.replicas()  # the loop's pass begins
    supervisor._reclaiming.add(drained.id)
    router.remove_replica(drained.id)  # the reclaim ends inside the pass
    supervisor._reclaiming.discard(drained.id)
    for replica in snapshot:
        supervisor._check_replica(replica)
    assert spawned == [live] and supervisor.restarts_total == 1
    assert drained.restarts == 0 and live.restarts == 1
    supervisor._stop.set()
    supervisor._check_replica(live)
    assert spawned == [live] and supervisor.restarts_total == 1


def test_admission_spike_sheds_with_429():
    f = _port_fleet(1, router_kw=dict(admission=AdmissionController(rate_per_client=5.0,
                                                                    burst=3.0)))
    try:
        codes, bodies_429 = [], []
        for _ in range(40):
            status, body = _act(f.url, "blaster")
            codes.append(status)
            if status == 429:
                bodies_429.append(body)
        assert set(codes) <= {200, 429} and codes.count(429) > 0 and codes.count(200) >= 3
        for body in bodies_429:
            assert body["reason"] == "client_rate" and body["retry"] is False
            assert body["request_id"]
        assert _act(f.url, "bystander")[0] == 200
        gauges = f.router.slo.gauges()
        assert gauges["slo_requests_rejected"] == float(codes.count(429))
        assert gauges["slo_requests_failed"] == 0.0
        assert f.router.slo.summary()["by_class"]["rejected"]["error_budget_burn"] > 0.0
        snapshot = f.router.metrics_snapshot()
        assert snapshot["autoscale_shed_total"]["client_rate"] == codes.count(429)
        assert snapshot["rejected_total"] == codes.count(429)
        assert snapshot["admission_rate_per_client"] == 5.0
        text = f.router.metrics_prometheus()
        assert 'rt1_serve_autoscale_shed_total{reason="client_rate"}' in text
    finally:
        f.close()


# ------------------------------------------------ JAX fleet against the port's


def _scripted_run(fleet):
    """Four sessions x 3 acts, SIGKILL the replica that holds s0, then two
    acts each; returns what each act answered, and the Prometheus families
    with their label sets once the fleet has healed."""
    answers = []

    def act(sid):
        status, body = _act(fleet.url, sid)
        assert status == 200, body
        answers.append((sid, body["replica_id"], body["step_index"], body["action"],
                        body["action_tokens"], bool(body.get("restarted")),
                        bool(body["session_started"])))

    for _ in range(3):
        for sid in ("s0", "s1", "s2", "s3"):
            act(sid)
    victim = next(r for r in fleet.router.replicas() if r.id == answers[0][1])
    victim.proc.kill()
    victim.proc.wait(timeout=10)
    for _ in range(2):
        for sid in ("s0", "s1", "s2", "s3"):
            act(sid)
    _wait_until(lambda: fleet.router.ready_count() == 2, 30.0, "the respawned replica")
    text = _get(fleet.url + "/metrics", headers={"Accept": "text/plain"})[1]
    parsed = prom.parse_exposition(text)
    families = {}
    for name, labels, _ in parsed.samples:
        families.setdefault(name, set()).add(tuple(sorted(labels.items())))
    return answers, parsed.types, families


def test_port_fleet_matches_the_jax_fleet_on_a_scripted_kill():
    # A long poll keeps the respawn behind the post-kill acts in both
    # fleets, so placement after the kill is the same in both.
    kw = dict(poll_interval_s=1.0)
    jax = _Fleet(jrouter.Router, jfleet.FleetSupervisor, jrouter.make_router_server,
                 lambda rid: _stub_argv(rid, module="rt1_tpu.serve.stub"), 2, **kw)
    try:
        want = _scripted_run(jax)
    finally:
        jax.close()
    port = _port_fleet(2, **kw)
    try:
        got = _scripted_run(port)
    finally:
        port.close()
    assert got[0] == want[0]
    restarted = [a for a in got[0] if a[5]]
    assert restarted and all(a[2] == 0 and a[6] for a in restarted)
    assert got[1] == want[1]  # family names and types
    assert got[2] == want[2]  # label sets of every sample


# ------------------------------------------------------------------- the CLI


def _read_json_line(proc, timeout_s):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        try:
            return json.loads(line)
        except json.JSONDecodeError:
            continue
    raise AssertionError("no JSON line from the fleet")


def test_fleet_cli_with_stubs_and_a_chaos_kill():
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("RT1_FAULTS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "rt1_tpu_torch.serve.fleet", "--stub", "--replicas", "2",
         "--port", "0", "--faults", "replica_kill@1", "--chaos_interval_s", "1.0",
         "--poll_interval_s", "0.1"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, text=True, start_new_session=True)
    try:
        ready = _read_json_line(proc, 30)
        assert ready["status"] == "serving" and ready["role"] == "router" and ready["stub"]
        assert ready["faults"] == "replica_kill@1"
        url = f"http://127.0.0.1:{ready['port']}"
        assert _act(url, "cli")[0] == 200

        def healed_after_kill():
            fs = _get(url + "/fleet/status")[1]
            return (sum(r["restarts"] for r in fs["replicas"]) == 1
                    and all(r["state"] == READY for r in fs["replicas"]))

        _wait_until(healed_after_kill, 30.0, "the chaos kill and the respawn")
        proc.send_signal(signal.SIGTERM)
        final = _read_json_line(proc, 30)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=10)
    assert final["status"] == "stopped"
    assert final["chaos"]["kills_injected"] == 1 and final["chaos"]["replica_restarts"] == 1
    assert final["autoscale"]["cost_weights"] == DTYPE_COST_WEIGHTS


def _fleet_cli(extra, timeout_s=30):
    """`python -m rt1_tpu_torch.serve.fleet --stub --replicas 2` with
    `extra` flags: (process, its ready line, the router's url)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("RT1_FAULTS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "rt1_tpu_torch.serve.fleet", "--stub", "--replicas", "2",
         "--port", "0", "--poll_interval_s", "0.1", *extra],
        cwd=REPO, env=env, stdout=subprocess.PIPE, text=True, start_new_session=True)
    ready = _read_json_line(proc, timeout_s)
    assert ready["status"] == "serving", ready
    return proc, ready, f"http://127.0.0.1:{ready['port']}"


def _stop_fleet_cli(proc):
    try:
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0
        return json.loads(out.strip().splitlines()[-1])
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=10)


def _families(text, prefix):
    return {name for name, _, _ in prom.parse_exposition(text).samples if name.startswith(prefix)}


def test_unarmed_fleet_serves_no_ops_surfaces(fleet):
    """Without the three flags `/alerts`, `/history`, `/dashboard` and
    `/deploy/status` are 404s and the scrape carries none of their
    families, as on the JAX fleet."""
    _, _, url = fleet
    for path in ("/alerts", "/history", "/dashboard", "/deploy/status"):
        assert _get(url + path)[0] == 404, path
    code, text = _get(url + "/metrics", {"Accept": "text/plain"})
    assert code == 200
    for prefix in ("rt1_deploy_", "rt1_alert_", "rt1_obs_collector_"):
        assert not _families(text, prefix)


def test_fleet_collector_arms_alerts_history_dashboard(tmp_path):
    """`--collector` on a stub fleet: the collector scrapes the router's own
    `/metrics`, and `/alerts`, `/history` (a family's points), `/dashboard`
    answer; the scrape carries `rt1_alert_*` and `rt1_obs_collector_*`; the
    TSDB snapshot lands in `--obs_dir` at SIGTERM."""
    proc, ready, url = _fleet_cli(["--collector", "--collector_interval_s", "0.2",
                                   "--obs_dir", str(tmp_path)])
    try:
        assert ready["collector"] is True and ready["deploy"] is None
        assert _act(url, "c")[0] == 200

        def has_history():
            code, body = _get(url + "/history")
            return code == 200 and any(s["family"] == "rt1_serve_requests_total"
                                       for s in body["series"])

        _wait_until(has_history, 15.0, "the collector's first cycles")
        code, hist = _get(url + "/history?family=rt1_serve_requests_total&window_s=60")
        assert code == 200 and hist["series"][0]["points"]
        assert _get(url + "/history?family=no_such_family")[0] == 400
        code, alerts = _get(url + "/alerts")
        assert code == 200 and {"ReplicaDown", "CanarySLOBreach"} <= {
            r["name"] for r in alerts["rules"]}
        code, page = _get(url + "/dashboard")
        assert code == 200 and "<html" in page.lower()
        code, text = _get(url + "/metrics", {"Accept": "text/plain"})
        assert _families(text, "rt1_alert_") and _families(text, "rt1_obs_collector_")
    finally:
        final = _stop_fleet_cli(proc)
    assert final["obs"]["collector"]["cycles_total"] > 0
    assert os.path.exists(tmp_path / "tsdb_snapshot.jsonl")


def test_fleet_capture_dir_arms_replicas_and_sweeps_into_staging(tmp_path):
    """`--capture_dir`: each real replica gets `<dir>/replica_<id>` (a flag
    the serve CLI takes), and the supervisor sweeps completed episodes from
    those dirs into `<dir>/staging`. On stub replicas with
    `--mimic_capture` (which serve no observations, so the files are
    written here as a replica's sink would write them) the capture gauges
    ride the fan-out as `rt1_serve_replica_capture_*`."""
    import argparse

    import numpy as np

    from rt1_tpu_torch.flywheel import EpisodeCaptureSink
    from rt1_tpu_torch.serve.__main__ import parse_args

    root = str(tmp_path / "capture")
    real = argparse.Namespace(stub=False, config="tiny", max_sessions=8, embedder="hash",
                              slow_threshold_ms=0.0, inference_dtype="f32", replica_dtypes="",
                              scheduler="continuous", buckets="auto", session_snapshot_dir="",
                              snapshot_max_age_s=600.0, random_init=True, workdir="",
                              device="cpu", capture_dir=root, allow_embedder_mismatch=True)
    argv = pfleet.replica_argv_builder(real)(1)
    parsed = parse_args(argv[3:])
    assert parsed.capture_dir == os.path.join(root, "replica_1")
    assert parsed.allow_embedder_mismatch
    f = _port_fleet(2, argv_fn=lambda rid: _stub_argv(rid) + ["--mimic_capture"],
                    capture_root=root, exemplar_scrape_interval_s=0.1)
    try:
        for rid in (0, 1):
            sink = EpisodeCaptureSink(f.supervisor.replica_capture_dir(rid))
            for j in range(3):
                sink.record_step(f"s{rid}", image=np.full((8, 8, 3), j, np.uint8),
                                 action=[0.0, 0.0], embedding=np.ones(512, np.float32))
            assert sink.finalize(f"s{rid}", "released")
        staging = f.supervisor.capture_staging_dir()
        _wait_until(lambda: f.supervisor.captures_swept == 2, 10.0, "the capture sweep")
        assert len([n for n in os.listdir(staging) if n.endswith(".npz")]) == 2
        assert f.supervisor.summary()["captures_swept"] == 2
        _act(f.url, "m")
        code, text = _get(f.url + "/metrics", {"Accept": "text/plain"})
        assert {"rt1_serve_replica_capture_enabled",
                "rt1_serve_replica_capture_episodes_total"} <= _families(
                    text, "rt1_serve_replica_capture_")
    finally:
        f.close()


def test_fleet_promote_from_arms_the_deploy_controller(tmp_path):
    """`--promote_from` on a stub fleet: the incumbent is the newest step at
    arm time, `/deploy/status` answers, a later checkpoint is gated (the
    stub fleet's auto-pass), canaried and promoted, the scrape carries
    `rt1_deploy_*`, and the final line carries the deploy summary."""
    ckpts = tmp_path / "checkpoints"
    for step in (2, 3):
        (ckpts / str(step)).mkdir(parents=True)
    (ckpts / "2" / "state.pt").write_bytes(b"x")  # 3 is a save in flight
    proc, ready, url = _fleet_cli(["--promote_from", str(tmp_path), "--min_canary_requests",
                                   "0", "--clean_window_ticks", "1",
                                   "--deploy_poll_interval_s", "0.1"])
    try:
        assert ready["deploy"] == {"promote_from": str(tmp_path), "incumbent_step": 2,
                                   "canary_weight": 0.25}
        code, status = _get(url + "/deploy/status")
        assert code == 200 and status["state"] == "idle" and status["timeline"] == []
        (ckpts / "4").mkdir()
        (ckpts / "4" / "state.pt").write_bytes(b"x")

        def promoted():
            body = _get(url + "/deploy/status")[1]
            return [e["event"] for e in body["timeline"]][-1:] == ["promoted"]

        _wait_until(promoted, 20.0, "the promotion of step 4")
        events = [e["event"] for e in _get(url + "/deploy/status")[1]["timeline"]]
        assert events == ["candidate", "gate_passed", "canary_started", "promoted"]
        code, text = _get(url + "/metrics", {"Accept": "text/plain"})
        assert {"rt1_deploy_promotions_total", "rt1_deploy_state",
                "rt1_deploy_incumbent_step"} <= _families(text, "rt1_deploy_")
        assert prom.parse_exposition(text).value("rt1_deploy_incumbent_step") == 4.0
    finally:
        final = _stop_fleet_cli(proc)
    assert final["deploy"]["promotions_total"] == 1
    assert final["deploy"]["incumbent_step"] == 4
    assert os.path.exists(tmp_path / "deploy" / "verdict_4.json")


def test_cuda_fleet_refuses_without_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pfleet.main(["--config", "tiny", "--random_init", "--port", "0"])


def test_cost_weights_come_from_the_ports_flagship_bytes():
    """f32 and bf16 from `quant_byte_report`; int8 as the port holds it:
    int8 weights with a float32 scale per output channel, the rest bf16."""
    import torch

    from rt1_tpu_torch.configs import get_config
    from rt1_tpu_torch.convert import flax_paths
    from rt1_tpu_torch.eval.restore import build_policy
    from rt1_tpu_torch.models import quant

    config = get_config("language_table")
    report = quant.quant_byte_report(config)
    with torch.device("meta"):
        policy = build_policy(config)
    int8_paths, paths = set(quant.quantized_paths(policy)), flax_paths(policy)
    int8 = sum(v.numel() + 4 * v.shape[0] if paths[k] in int8_paths else 2 * v.numel()
               for k, v in policy.state_dict().items())
    assert pfleet.FLAGSHIP_PARAM_BYTES == {"f32": report["f32_bytes"],
                                           "bf16": report["bf16_bytes"], "int8": int8}
    assert DTYPE_COST_WEIGHTS == {d: b / report["f32_bytes"]
                                  for d, b in pfleet.FLAGSHIP_PARAM_BYTES.items()}


def test_router_supervisor_and_stub_import_no_torch():
    probe = ("import sys, rt1_tpu_torch.serve.fleet, rt1_tpu_torch.serve.stub, "
             "rt1_tpu_torch.serve.router; "
             "print(sorted(m for m in ('torch', 'numpy', 'jax') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True,
                         timeout=60, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
