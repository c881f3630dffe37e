"""The port's serving modes end to end on the CPU, with the tiny config.

* Cross-package gate: the JAX package's own
  `rt1_tpu.serve.parity.action_token_agreement` steps a JAX engine and the
  port's engine over the same canned episodes: agreement 1.0 for f32,
  int8 and cached engines on the same converted weights.
* `POST /reload`: 409 while one runs and `/readyz` 503 `reloading`
  meanwhile; the swap keeps `compile_count` and, cached, rebuilds every
  live cache; the actions after reloading the same weights equal a replay.
* `POST /session/export` -> `/session/import` across two `ServeApp`s: the
  imported session's next action equals the original's; a mode or
  generation mismatch is refused with 409; the snapshot ring restores a
  session on `/act` in another app.
* `migrate_session` moves a session between two servers, and reports the
  failing stage; the checkpoint watcher reloads each newer step once.
* The CLI's new flags parse.
"""

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

from rt1_tpu.models import quant as jquant
from rt1_tpu.serve import parity as jparity
from rt1_tpu.serve.engine import PolicyEngine as JaxPolicyEngine
from rt1_tpu.train.configs import tiny as jax_tiny
from rt1_tpu.train.train import build_model as jax_build_model
from rt1_tpu_torch.configs import get_config
from rt1_tpu_torch.convert import load_flax_variables
from rt1_tpu_torch.eval.embedding import get_embedder
from rt1_tpu_torch.eval.restore import build_policy, build_serve_engine, load_standby_variables
from rt1_tpu_torch.eval.restore import serving_engine
from rt1_tpu_torch.serve import migrate
from rt1_tpu_torch.serve.__main__ import parse_args, parse_buckets, start_checkpoint_watcher
from rt1_tpu_torch.serve.server import ServeApp, make_server
from test_torch_rt1 import H, W, init_jax

torch.set_num_threads(2)


@pytest.mark.parametrize("mode", ["f32", "int8", "cached"])
def test_cross_package_token_agreement(mode):
    jm = jax_build_model(jax_tiny.get_config().model)
    variables = init_jax(jm, jm.time_sequence_length, seed=61)
    pm = build_policy(get_config("tiny"))
    load_flax_variables(pm, variables["params"])
    dtype = "int8" if mode == "int8" else "f32"
    cached = mode == "cached"
    port = serving_engine(pm, torch.float32, "cpu", inference_dtype=dtype, cached_inference=cached,
                          max_sessions=2, buckets=[1, 2])
    served = jquant.quantize_tree(variables) if dtype == "int8" else variables
    jax_engine = JaxPolicyEngine(jm, served, max_sessions=2, buckets=[1, 2], inference_dtype=dtype,
                                 master_variables=variables, cached_inference=cached)
    episodes = jparity.canned_episodes((H, W, 3), episodes=2, steps=jm.time_sequence_length + 3)
    stats = jparity.action_token_agreement(jax_engine, port, episodes)
    assert stats["agreement"] == 1.0 and stats["tokens_total"] == 2 * 6 * 3
    assert stats["max_abs_action_diff"] < 1e-6
    assert port.inference_dtype == dtype and port.cached_inference == cached
    if dtype == "int8":
        assert port.serving_param_bytes == 29208 < port.master_param_bytes == 50528


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


class _Served:
    """A ServeApp over HTTP on an ephemeral port."""

    def __init__(self, inference_dtype="f32", cached=False, reload_fn=None, **app_kwargs):
        config = get_config("tiny")
        engine, step = build_serve_engine(config, device="cpu", inference_dtype=inference_dtype,
                                          cached_inference=cached, max_sessions=2,
                                          buckets=[1, 2], embedder=get_embedder("hash"))
        self.app = ServeApp(engine, image_shape=(H, W, 3), checkpoint_step=step,
                            reload_fn=reload_fn or (lambda s: load_standby_variables(config)),
                            **app_kwargs)
        self.app.start(warmup=True)
        self.httpd = make_server(self.app, port=0)
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.app.drain()
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)


def _bodies(n, sid="s", seed=0):
    rng = np.random.default_rng(seed)
    return [{"session_id": sid, "instruction": "push the red star to the blue cube",
             "image_b64": base64.b64encode(
                 rng.integers(0, 256, (H, W, 3), dtype=np.uint8).tobytes()).decode()}
            for _ in range(n)]


def test_reload_refuses_a_second_and_keeps_actions():
    gate, entered = threading.Event(), threading.Event()
    config = get_config("tiny")

    def slow_reload(step):
        entered.set()
        gate.wait(30)
        return load_standby_variables(config)

    served = _Served(inference_dtype="int8", cached=True, reload_fn=slow_reload)
    try:
        bodies = _bodies(5)
        for body in bodies[:2]:
            assert _post(served.url + "/act", body)[0] == 200
        replay = _Served(inference_dtype="int8", cached=True)
        try:
            for body in bodies:
                expected = _post(replay.url + "/act", body)[1]["action_tokens"]
        finally:
            replay.close()
        first = {}
        worker = threading.Thread(target=lambda: first.update(
            zip(("code", "out"), _post(served.url + "/reload", {}))))
        worker.start()
        assert entered.wait(30)
        assert _post(served.url + "/reload", {})[0] == 409
        assert _get(served.url + "/readyz") == (503, {"ready": False, "reason": "reloading"})
        # /act still serves while the standby loads.
        assert _post(served.url + "/act", bodies[2])[0] == 200
        gate.set()
        worker.join(30)
        assert first["code"] == 200 and first["out"]["ok"]
        assert first["out"]["caches_rebuilt"] == 1 == served.app.engine.active_sessions
        assert first["out"]["inference_dtype"] == "int8" and first["out"]["checkpoint_step"] == -1
        assert _get(served.url + "/readyz")[0] == 200
        for body in bodies[3:]:
            out = _post(served.url + "/act", body)[1]
        assert out["action_tokens"] == expected
        code, metrics = _get(served.url + "/metrics")
        assert metrics["reloads_total"] == 1 and metrics["compile_count"] == 2
        assert metrics["cache_invalidations"] == {"swap": 1.0, "reset": 0.0, "evict": 0.0}
        assert metrics["inference_dtype"] == "int8" and metrics["cache_enabled"] == 1
        assert metrics["param_bytes_device"] == 29208 and metrics["param_bytes_master"] == 50528
        assert metrics["cache_bytes_per_slot"] == 2 * 2 * 15 * 2 * 8 * 4
    finally:
        gate.set()
        served.close()


def test_export_import_across_apps_and_refusals(tmp_path):
    a = _Served(cached=True, session_snapshot_dir=str(tmp_path))
    b = _Served(cached=True)
    windowed = _Served()
    try:
        bodies = _bodies(6, seed=1)
        for body in bodies[:4]:
            assert _post(a.url + "/act", body)[0] == 200
        code, out = _post(a.url + "/session/export", {"session_id": "s"})
        assert code == 200 and out["ok"]
        snapshot = out["snapshot"]
        assert snapshot["step_index"] == 4 and snapshot["cached_inference"]
        assert snapshot["state"]["kv_cache"]["dtype"] == "float32"
        assert "embedding" in snapshot  # the instruction's cached embedding rides along
        code, out = _post(b.url + "/session/import", {"snapshot": snapshot, "session_id": "moved"})
        assert code == 200 and out["session_id"] == "moved" and out["step_index"] == 4
        for body in bodies[4:]:
            want = _post(a.url + "/act", body)[1]
            got = _post(b.url + "/act", dict(body, session_id="moved"))[1]
            assert got["action_tokens"] == want["action_tokens"] and not got["session_started"]
        assert b.app.engine.embed_calls == 0  # the migrated embedding was seeded
        # A windowed engine refuses a cached snapshot, naming the field.
        code, out = _post(windowed.url + "/session/import", {"snapshot": snapshot})
        assert code == 409 and "cached_inference" in out["error"]
        code, out = _post(b.url + "/session/import",
                          {"snapshot": dict(snapshot, checkpoint_generation=7)})
        assert code == 409 and "checkpoint_generation" in out["error"]
        assert _post(b.url + "/session/export", {"session_id": "nobody"})[0] == 404
        # The ring: app `a` wrote a snapshot every step; releasing with
        # keep_snapshot keeps it, and a fresh app sharing the directory
        # restores the session on its first /act.
        assert _post(a.url + "/release", {"session_id": "s", "keep_snapshot": True})[0] == 200
        c = _Served(cached=True, session_snapshot_dir=str(tmp_path))
        try:
            out = _post(c.url + "/act", bodies[0])[1]
            assert out["session_restored"] and not out["session_started"]
            assert "snapshot_age_s" in out
            metrics = _get(c.url + "/metrics")[1]
            assert metrics["migration_restores_total"] == 1
        finally:
            c.close()
        metrics_a, metrics_b = _get(a.url + "/metrics")[1], _get(b.url + "/metrics")[1]
        assert metrics_a["migration_exports_total"] == 1
        assert metrics_b["migration_imports_total"] == 1
        assert metrics_b["migration_import_failures_total"] == 1
        health = _get(b.url + "/healthz")[1]
        assert health["cached_inference"] and health["checkpoint_generation"] == -1
    finally:
        for served in (a, b, windowed):
            served.close()


def test_cli_flags_parse():
    args = parse_args(["--config", "tiny", "--random_init", "--inference_dtype", "int8",
                       "--cached_inference", "--buckets", "1,4", "--replica_id", "3",
                       "--watch_checkpoints_s", "2.5", "--session_snapshot_dir", "/tmp/ring",
                       "--snapshot_max_age_s", "30", "--session_snapshot_every", "4"])
    assert (args.inference_dtype, args.cached_inference, args.replica_id) == ("int8", True, 3)
    assert (args.watch_checkpoints_s, args.session_snapshot_dir) == (2.5, "/tmp/ring")
    assert (args.snapshot_max_age_s, args.session_snapshot_every) == (30.0, 4)
    assert parse_buckets(args.buckets, 8) == [1, 4]
    assert parse_buckets("auto", 8) == [1, 2, 4, 8]
    defaults = parse_args(["--config", "tiny", "--random_init"])
    assert (defaults.inference_dtype, defaults.cached_inference, defaults.buckets) == \
        ("f32", False, "auto")
    with pytest.raises(SystemExit):
        parse_args(["--config", "tiny", "--random_init", "--inference_dtype", "fp8"])


def test_migrate_session_between_replicas():
    a, b = _Served(cached=True), _Served(cached=True)
    try:
        bodies = _bodies(4, seed=2)
        for body in bodies[:3]:
            _post(a.url + "/act", body)
        result = migrate.migrate_session(a.url, b.url, "s")
        assert result == {"ok": True, "session_id": "s", "step_index": 3}
        want = _post(a.url + "/act", bodies[3])[1]
        got = _post(b.url + "/act", bodies[3])[1]
        assert got["action_tokens"] == want["action_tokens"] and not got["session_started"]
        failed = migrate.migrate_session(a.url, b.url, "nobody")
        assert not failed["ok"] and failed["stage"] == "export"
        closed = migrate.migrate_session(a.url, "http://127.0.0.1:9", "s", timeout_s=2)
        assert not closed["ok"] and closed["stage"] == "transport"
    finally:
        a.close()
        b.close()


def test_checkpoint_watcher_reloads_each_newer_step(tmp_path, capsys):
    class App:
        def __init__(self):
            self.steps = []

        def reload(self, step):
            self.steps.append(step)
            return {"ok": True, "checkpoint_step": step}

    def save(step):
        os.makedirs(tmp_path / "checkpoints" / str(step))
        (tmp_path / "checkpoints" / str(step) / "state.pt").write_bytes(b"")

    save(2)
    app = App()
    start_checkpoint_watcher(app, str(tmp_path), 0.02, served_step=2)
    time.sleep(0.2)
    assert app.steps == []  # step 2 is the one served
    save(5)
    deadline = time.time() + 10
    while app.steps != [5] and time.time() < deadline:
        time.sleep(0.02)
    time.sleep(0.1)
    assert app.steps == [5]
    assert '"status": "reloaded"' in capsys.readouterr().out


@pytest.mark.parametrize("site", ["migrate_export", "migrate_import"])
def test_migration_fault_sites_fire_as_in_jax(site):
    """`RT1_FAULTS` `migrate_export@1` / `migrate_import@1` break the
    migration before that leg, as in the JAX package: a transport failure
    naming the site, the session left where it was."""
    from rt1_tpu_torch.resilience import faults

    a, b = _Served(), _Served()
    try:
        bodies = _bodies(3, seed=6)
        for body in bodies[:2]:
            assert _post(a.url + "/act", body)[0] == 200
        faults.install(faults.FaultPlan.parse(f"{site}@1"))
        result = migrate.migrate_session(a.url, b.url, "s")
        assert result == {"ok": False, "session_id": "s", "stage": "transport",
                          "error": f"injected fault [{site}]: s"}
        assert faults.active().fired_counts() == {f"{site}@1": 1}
        exported = _get(a.url + "/metrics")[1]["migration_exports_total"]
        assert exported == (1 if site == "migrate_import" else 0)
        assert _get(b.url + "/metrics")[1]["migration_imports_total"] == 0
        assert b.app.engine.active_sessions == 0
        out = _post(a.url + "/act", bodies[2])[1]
        assert not out["session_started"]  # still on a, its window intact
        assert migrate.migrate_session(a.url, b.url, "s")["ok"]  # the plan fired once
    finally:
        faults.clear()
        a.close()
        b.close()


def test_session_restore_fault_site_falls_back_to_a_fresh_window(tmp_path):
    """`session_restore@1` fails the first ring restore: the `/act` answers
    from a fresh window (no `session_restored`), the failure is counted and
    the ring's copy dropped, as in the JAX server."""
    from rt1_tpu_torch.resilience import faults

    a = _Served(session_snapshot_dir=str(tmp_path))
    try:
        bodies = _bodies(3, seed=7)
        for body in bodies[:2]:
            assert _post(a.url + "/act", body)[0] == 200
        assert _post(a.url + "/release", {"session_id": "s", "keep_snapshot": True})[0] == 200
    finally:
        a.close()
    c = _Served(session_snapshot_dir=str(tmp_path))
    try:
        faults.install(faults.FaultPlan.parse("session_restore@1"))
        out = _post(c.url + "/act", bodies[2])[1]
        assert out["session_started"] and "session_restored" not in out
        metrics = _get(c.url + "/metrics")[1]
        assert metrics["migration_restore_failures_total"] == 1
        assert metrics["migration_restores_total"] == 0
        assert faults.active().fired_counts() == {"session_restore@1": 1}
        assert c.app.snapshot_ring.load("s") is not None  # this step's own snapshot
    finally:
        faults.clear()
        c.close()
