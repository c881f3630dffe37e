"""The operations loop's `python -m` entries, run as a user runs them.

* `rt1_tpu_torch.obs.collector_main` and `rt1_tpu_torch.obs.console`
  against the JAX package's `scripts/obs_collector.py` and
  `scripts/obs_console.py`: the same flags, and on one fixed endpoint (an
  exposition `/metrics` and a JSON `/deploy/status`) the same output. The
  tolerance is exact: equal stdout, equal final lines, alert streams and
  TSDB snapshots, but for the fields that read the wall clock (scrape
  durations, sample, write and alert transition times). Against a port
  stub fleet both collectors ingest the same series.
* `rt1_tpu_torch.flywheel.loop` and `rt1_tpu_torch.deploy.loop` on `tiny`
  with `--device cpu`, each in its own process with its own timeout: the
  flywheel's four acts (seed pack, capture, torn append and retry, a live
  trainer's pickup) and the deploy loop's two fleet episodes (a candidate
  promoted, a breaching one rolled back) run to their end, and each record
  lands in `--workdir` when no `--bench_out` is given.
"""

import hashlib
import http.server
import json
import os
import re
import signal
import subprocess
import sys
import threading

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_TEXT = """# HELP rt1_serve_requests_total Requests answered.
# TYPE rt1_serve_requests_total counter
rt1_serve_requests_total 17
# HELP rt1_serve_slo_error_budget_burn_rolling Rolling error-budget burn.
# TYPE rt1_serve_slo_error_budget_burn_rolling gauge
rt1_serve_slo_error_budget_burn_rolling 0.5
# HELP rt1_serve_request_seconds Request latency.
# TYPE rt1_serve_request_seconds histogram
rt1_serve_request_seconds_bucket{le="0.1"} 3
rt1_serve_request_seconds_bucket{le="+Inf"} 4
rt1_serve_request_seconds_sum 0.7
rt1_serve_request_seconds_count 4
# HELP rt1_serve_replica_up Replica up.
# TYPE rt1_serve_replica_up gauge
rt1_serve_replica_up{replica_id="0"} 1
rt1_serve_replica_up{replica_id="1"} 0
"""
_STATUS = {"state": "idle", "promotions_total": 1, "rollbacks_total": 0,
           "canary": {"weight": 0.5}}

_PORT_COLLECTOR = [sys.executable, "-m", "rt1_tpu_torch.obs.collector_main"]
_JAX_COLLECTOR = [sys.executable, os.path.join(REPO, "scripts", "obs_collector.py")]
_PORT_CONSOLE = [sys.executable, "-m", "rt1_tpu_torch.obs.console"]
_JAX_CONSOLE = [sys.executable, os.path.join(REPO, "scripts", "obs_console.py")]


class _Fixed(http.server.BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 - http.server's name
        if self.path.startswith("/metrics"):
            body, kind = _TEXT.encode(), "text/plain; version=0.0.4"
        else:
            body, kind = json.dumps(_STATUS).encode(), "application/json"
        self.send_response(200)
        self.send_header("Content-Type", kind)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


@pytest.fixture(scope="module")
def fixed_url():
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Fixed)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()


def _run(argv, timeout=120):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    env.pop("RT1_FAULTS", None)
    proc = subprocess.run(argv, cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _final(stdout):
    """The collector's last line, its wall-clock fields dropped."""
    final = json.loads(stdout.strip().splitlines()[-1])
    for target in final["collector"]["targets"].values():
        target.pop("last_scrape_duration_s")
    final.pop("snapshot")
    return final


def _snapshot(path):
    """(header without its write time, rows with their sample times dropped)."""
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    header = lines[0]["tsdb"]
    header.pop("written_at")
    rows = [(r["family"], r["labels"], [v for _, v in r["points"]]) for r in lines[1:]]
    return header, rows


def _flags(argv):
    return sorted(set(re.findall(r"--[a-z_]+", _run(argv + ["--help"]))) - {"--help"})


@pytest.mark.parametrize("port,jax", [(_PORT_COLLECTOR, _JAX_COLLECTOR),
                                      (_PORT_CONSOLE, _JAX_CONSOLE)],
                         ids=["collector", "console"])
def test_entry_takes_the_jax_scripts_flags(port, jax):
    assert _flags(port) == _flags(jax)


def test_collector_main_matches_the_jax_script(fixed_url, tmp_path):
    outs = {}
    for name, argv in (("port", _PORT_COLLECTOR), ("jax", _JAX_COLLECTOR)):
        snap = str(tmp_path / f"{name}.jsonl")
        stdout = _run(argv + ["--target", f"fleet={fixed_url}/metrics",
                              "--json_target", f"deploy={fixed_url}/deploy/status",
                              "--max_cycles", "1", "--snapshot", snap])
        outs[name] = (_final(stdout), _snapshot(snap))
    port, jax = outs["port"], outs["jax"]
    assert port == jax
    final, (header, rows) = port
    assert final["collector"]["targets"]["fleet"]["up"] == 1.0
    assert final["collector"]["targets"]["deploy"]["up"] == 1.0
    assert header["series"] == len(rows) and rows
    families = {family for family, _, _ in rows}
    assert {"rt1_serve_requests_total", "rt1_deploy_promotions_total",
            "rt1_deploy_canary_weight"} <= families


def test_collector_main_alert_stream_matches_the_jax_script(fixed_url):
    """A replica reported down fires `ReplicaDown` on the first cycle's
    evaluation in both: the transition streams as a JSON line before the
    final one, equal but for its time `t`."""
    streams = {}
    for name, argv in (("port", _PORT_COLLECTOR), ("jax", _JAX_COLLECTOR)):
        lines = _run(argv + ["--target", f"fleet={fixed_url}/metrics", "--max_cycles", "1"])
        events = [json.loads(line) for line in lines.strip().splitlines()[:-1]]
        for event in events:
            event.pop("t")  # the transition's wall-clock time
        streams[name] = events
    assert streams["port"] == streams["jax"]
    assert [(e["event"], e["alert"], e["labels"]) for e in streams["port"]] == [
        ("firing", "ReplicaDown", {"replica_id": "1"})]


@pytest.mark.parametrize("mode", ["live", "snapshot"])
def test_console_matches_the_jax_script(fixed_url, tmp_path, mode):
    if mode == "live":
        args = ["--url", fixed_url, "--once"]
    else:
        snap = str(tmp_path / "tsdb_snapshot.jsonl")
        _run(_PORT_COLLECTOR + ["--target", f"fleet={fixed_url}/metrics",
                                "--json_target", f"deploy={fixed_url}/deploy/status",
                                "--max_cycles", "1", "--snapshot", snap, "--no_alerts"])
        args = ["--snapshot", snap]
    # A recent event's `t=` is the wall clock at its transition.
    port, jax = (re.sub(r"t=[0-9.]+", "t=", _run(argv + args))
                 for argv in (_PORT_CONSOLE, _JAX_CONSOLE))
    assert port == jax
    assert "HISTORY" in port and "rt1_serve_requests_total" in port


def test_collector_main_on_a_stub_fleet_ingests_the_jax_scripts_series(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("RT1_FAULTS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "rt1_tpu_torch.serve.fleet", "--stub", "--replicas", "2",
         "--port", "0", "--poll_interval_s", "0.1"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, text=True, start_new_session=True)
    try:
        ready = json.loads(proc.stdout.readline())
        url = f"http://127.0.0.1:{ready['port']}"
        series = {}
        for name, argv in (("port", _PORT_COLLECTOR), ("jax", _JAX_COLLECTOR)):
            snap = str(tmp_path / f"{name}.jsonl")
            _run(argv + ["--target", f"fleet={url}/metrics", "--max_cycles", "1",
                         "--snapshot", snap, "--no_alerts"])
            series[name] = sorted((f, sorted(labels.items())) for f, labels, _ in
                                  _snapshot(snap)[1])
        assert series["port"] == series["jax"]
        assert any(f.startswith("rt1_serve_replica_") for f, _ in series["port"])
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.communicate(timeout=60)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait(timeout=10)


def _digest(path):
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _phases(stdout):
    out = {}
    for line in stdout.splitlines():
        try:
            msg = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(msg, dict) and "phase" in msg:
            out[msg["phase"]] = msg
    return out


def test_flywheel_loop_runs_its_four_acts_on_tiny(tmp_path):
    committed = _digest(os.path.join(REPO, "BENCH_flywheel.json"))
    wd = str(tmp_path / "fly")
    phases = _phases(_run([sys.executable, "-m", "rt1_tpu_torch.flywheel.loop", "--config",
                           "tiny", "--device", "cpu", "--workdir", wd], timeout=600))
    assert phases["done"]["bench_out"] == os.path.join(wd, "BENCH_flywheel.json")
    assert _digest(os.path.join(REPO, "BENCH_flywheel.json")) == committed
    with open(os.path.join(wd, "BENCH_flywheel.json")) as f:
        record = json.load(f)
    assert phases["torn_append"]["injected"] and phases["torn_append"]["manifest_intact"]
    assert (phases["append"]["shards_before"], phases["append"]["shards_after"]) == (1, 2)
    assert phases["pickup"]["rt1_flywheel_corpus_windows"] > \
        phases["train_up"]["rt1_flywheel_corpus_windows"]
    assert phases["pickup"]["rt1_flywheel_freshness_epoch"] == 1.0
    assert record["total_seconds"] == phases["done"]["total_seconds"]


def test_deploy_loop_promotes_then_rolls_back_on_tiny(tmp_path):
    committed = _digest(os.path.join(REPO, "BENCH_deploy.json"))
    wd = str(tmp_path / "deploy")
    phases = _phases(_run([sys.executable, "-m", "rt1_tpu_torch.deploy.loop", "--config",
                           "tiny", "--device", "cpu", "--workdir", wd], timeout=900))
    assert phases["done"]["bench_out"] == os.path.join(wd, "BENCH_deploy.json")
    assert _digest(os.path.join(REPO, "BENCH_deploy.json")) == committed
    with open(os.path.join(wd, "BENCH_deploy.json")) as f:
        record = json.load(f)
    assert record["verdict"] == "deploy_cycle_proven"
    good, bad = record["promote"], record["rollback"]
    assert (good["terminal_event"]["event"], good["terminal_event"]["step"]) == ("promoted", 4)
    assert (bad["terminal_event"]["event"], bad["terminal_event"]["step"]) == ("rolled_back", 6)
    assert bad["terminal_event"]["restore"]["checkpoint_step"] == 4
    for episode in (good, bad):
        assert not episode["traffic"]["failures"]
        assert episode["fleet_exit_code"] == 0
        assert all(v["signature_ok"] for v in episode["verdicts"])
