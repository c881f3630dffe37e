"""The port's fleet in front of two real torch replicas (`tiny`, on the CPU).

The supervisor spawns `python -m rt1_tpu_torch.serve --config tiny
--random_init --device cpu` twice, exactly as `python -m
rt1_tpu_torch.serve.fleet` builds the argv, and routes to them:

* actions through the router equal those of a port engine built in this
  process at the same seed, within 1e-6, and the action tokens are equal;
* a replica's Prometheus `/metrics`, its `/slow_requests` and the
  `X-RT1-Request-Id` (echoed, with `phases` under `"debug": true`) work
  through the router and on the replica itself, and the router's fan-out
  carries each replica's attention counters;
* a SIGKILLed replica's session re-homes with `"restarted": true` and the
  supervisor brings the replica back.
"""

import argparse
import base64
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from rt1_tpu_torch.configs import get_config
from rt1_tpu_torch.eval.embedding import get_embedder
from rt1_tpu_torch.eval.restore import build_serve_engine
from rt1_tpu_torch.obs import prometheus as prom
from rt1_tpu_torch.serve.fleet import FleetSupervisor, replica_argv_builder
from rt1_tpu_torch.serve.router import READY, Router, make_router_server
from rt1_tpu_torch.serve.server import ServeApp, parse_observation
from test_torch_rt1 import H, W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RID = "replica-test-id"


def _args():
    return argparse.Namespace(
        stub=False, config="tiny", random_init=True, workdir="", device="cpu",
        max_sessions=2, buckets="1,2", embedder="hash", slow_threshold_ms=0.0,
        inference_dtype="f32", replica_dtypes="", scheduler="continuous",
        session_snapshot_dir="", snapshot_max_age_s=600.0)


def _post(url, payload, headers=None):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def _get(url, headers=None):
    req = urllib.request.Request(url, headers=headers or {})
    with urllib.request.urlopen(req, timeout=60) as resp:
        body = resp.read().decode("utf-8")
        return resp.headers["Content-Type"], body


def _bodies(sid, n, seed):
    rng = np.random.default_rng(seed)
    return [{"session_id": sid, "instruction": "push the red star to the blue cube",
             "image_b64": base64.b64encode(
                 rng.integers(0, 256, (H, W, 3), dtype=np.uint8).tobytes()).decode()}
            for _ in range(n)]


@pytest.fixture(scope="module")
def fleet():
    router = Router(replica_timeout_s=60.0)
    supervisor = FleetSupervisor(
        router, replica_argv_builder(_args()), 2, poll_interval_s=0.2, chaos_interval_s=3600.0,
        warmup_timeout_s=180.0, extra_env={"PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"})
    supervisor.start(wait_ready=True)
    httpd = make_router_server(router, host="127.0.0.1", port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield router, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=5)
    supervisor.stop()


def test_actions_through_the_router_equal_a_direct_engine(fleet):
    router, url = fleet
    torch.set_num_threads(2)
    engine, _ = build_serve_engine(get_config("tiny"), device="cpu", max_sessions=2,
                                   buckets=[1, 2], embedder=get_embedder("hash"))
    app = ServeApp(engine, image_shape=(H, W, 3))
    app.start(warmup=True)
    try:
        homes = {}
        for sid, seed in (("a", 1), ("b", 2)):
            for body in _bodies(sid, 4, seed):
                status, routed = _post(url + "/act", body)
                assert status == 200, routed
                homes.setdefault(sid, set()).add(router._sessions[sid])  # its affinity
                direct = app.act(sid, parse_observation(body, (H, W, 3)))
                np.testing.assert_allclose(routed["action"], np.asarray(direct["action"],
                                                                        np.float64), atol=1e-6)
                assert routed["action_tokens"] == [int(t) for t in direct["action_tokens"]]
        assert all(len(h) == 1 for h in homes.values())
        assert homes["a"] != homes["b"]  # one session on each replica
    finally:
        app.drain()


def test_replica_metrics_slow_requests_and_request_id(fleet):
    router, url = fleet
    body = dict(_bodies("traced", 1, 3)[0], debug=True)
    status, out = _post(url + "/act", body, headers={"X-RT1-Request-Id": RID})
    assert status == 200 and out["request_id"] == RID
    assert out["phases"]["request_id"] == RID and out["phases"]["device_ms"] > 0.0
    home = router._sessions["traced"]
    replica = next(r for r in router.replicas() if r.id == home)
    content_type, text = _get(replica.url + "/metrics", {"Accept": "text/plain"})
    assert content_type.startswith("text/plain")
    parsed = prom.parse_exposition(text)
    assert parsed.value("rt1_serve_requests_total") >= 1
    assert parsed.value("rt1_serve_attention_launches_total") == 0  # the plain path on the CPU
    assert parsed.value("rt1_serve_replica_id") == home
    assert parsed.histogram("rt1_serve_request_latency_seconds")["count"] >= 1
    _, slow = _get(replica.url + "/slow_requests")
    slow = json.loads(slow)
    assert RID in {rec["request_id"] for rec in slow["slow_requests"]}
    assert slow["threshold_ms"] == 0.0
    _, fanned = _get(url + "/metrics")
    fanned = json.loads(fanned)
    for rid, snap in fanned["replicas"].items():
        assert snap["engine_steps_total"] > 0
        assert snap["attention_launches_tensor_core_total"] == 0
    _, text = _get(url + "/metrics", {"Accept": "text/plain"})
    parsed = prom.parse_exposition(text)
    assert [parsed.value("rt1_serve_replica_up", replica_id=str(i)) for i in (0, 1)] == [1.0, 1.0]
    _, slow = _get(url + "/fleet/slow_requests")
    assert RID in {rec["request_id"] for scrape in json.loads(slow)["replicas"].values()
                   for rec in scrape["slow_requests"]}


def test_kill_rehomes_a_session_with_restarted(fleet):
    router, url = fleet
    bodies = _bodies("victim", 4, 4)
    for body in bodies[:3]:
        assert _post(url + "/act", body)[0] == 200
    target = next(r for r in router.replicas() if r.id == router._sessions["victim"])
    restarts = target.restarts
    target.proc.kill()
    target.proc.wait(timeout=10)
    status, out = _post(url + "/act", bodies[3])
    assert status == 200, out
    assert out["restarted"] is True and out["session_started"] is True
    assert router.metrics_snapshot()["sessions_restarted_total"] == 1
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline and router.ready_count() < 2:
        time.sleep(0.2)
    assert router.ready_count() == 2 and target.state == READY
    assert target.restarts == restarts + 1
