"""Stub serving replica: the replica HTTP contract with no model behind it.

The port's copy of `rt1_tpu/serve/stub.py` (the port imports nothing of the JAX
package); it keeps the JAX module's names, wire format and behaviour.

`python -m rt1_tpu_torch.serve.stub` speaks exactly the protocol a real replica
(`python -m rt1_tpu_torch.serve`) speaks — the JSON ready-line on stdout, then
`/act /reset /release /reload /healthz /readyz /metrics` — but its "engine"
is a dict of per-session step counters and its "checkpoint reload" is a
sleep. That makes it the router/fleet test double: `serve/fleet.py` spawns
it with `--stub`, and the tier-1 fleet tests (spawn, kill, re-home,
rolling reload) run in seconds instead of paying a torch import, the
kernel build and the warm-up steps per replica. Chaos rehearsal against a laptop with no accelerator
uses the same path.

Deliberately model-free, torch-free and JAX-free (stdlib + the shared
`ServeMetrics`):
the stub must stay cheap enough that killing and respawning it in a loop
is free, and it doubles as the executable specification of the replica
protocol — if a field moves in `serve/server.py`, the fleet tests against
the stub catch the drift.

Actions are deterministic in (session, step): ``action[i] = ((step * 7 + i)
% 13 - 6) / 300`` — enough structure for a test to assert that a re-homed
session restarted from step 0.

Tracing parity: the stub resolves the same `X-RT1-Request-Id`, stamps the
same `serve/reqtrace.py` phase ledger, emits the same `replica_act` /
`batch_wait` / `device_step` spans, keeps the same slow-request exemplar
ring behind `GET /slow_requests`, and echoes `request_id` (+ `phases`
under `"debug": true`) — so the tier-1 fleet tests prove end-to-end id
propagation without booting a model. `GET /trace` returns the process's
Chrome-trace ring (test-double introspection hook; the real replica dumps
traces to disk instead).
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler
from typing import Any, Dict, Tuple

from rt1_tpu_torch.obs import prometheus as obs_prometheus
from rt1_tpu_torch.obs import trace as obs_trace
from rt1_tpu_torch.obs.recorder import ExemplarRing
from rt1_tpu_torch.resilience import faults
from rt1_tpu_torch.serve import migrate, reqtrace
from rt1_tpu_torch.serve.httpd import HTTPServer
from rt1_tpu_torch.serve.metrics import ServeMetrics

IMAGE_SHAPE = (8, 14, 3)  # tiny but nonzero: loadgen reads this contract
EMBED_DIM = 16
# Advertised rolling-window length (protocol double for the real
# engine's model.time_sequence_length): part of the snapshot
# compatibility surface, so fleet tests can prove window-mismatch
# refusal with no model.
STUB_WINDOW = 6
# The stub's one-leaf snapshot schema: its whole session state is the
# step counter, shipped as a plain JSON list (`data`) so migration
# round-trips with zero numpy.
STUB_SCHEMA = [("stub_step", (), "int64")]


def stub_action(step: int, dims: int = 2):
    return [((step * 7 + i) % 13 - 6) / 300.0 for i in range(dims)]


class StubReplicaApp:
    """Session counters + lifecycle flags behind the replica contract."""

    def __init__(
        self,
        replica_id: int = 0,
        max_sessions: int = 8,
        act_delay_s: float = 0.0,
        reload_delay_s: float = 0.05,
        slow_threshold_ms: float = 0.0,
        inference_dtype: str = "f32",
        buckets=None,
        scheduler: str = "continuous",
        act_concurrency: int = 0,
        cached_inference: bool = False,
        mimic_capture: bool = False,
        session_snapshot_dir=None,
        snapshot_max_age_s: float = 600.0,
    ):
        self.replica_id = replica_id
        self.max_sessions = max_sessions
        # The scheduling contract, mimicked model-free: the stub
        # advertises its bucket ladder and scheduler, pins
        # compile_count == len(buckets), and books every (batch-of-1)
        # act into the per-bucket occupancy families — so the tier-1
        # fleet tests prove the aggregation plumbing without a model.
        self.buckets = sorted({int(b) for b in (buckets or [1])})
        self.scheduler = scheduler
        self.compile_count = len(self.buckets)
        # Advertised low-precision mode (the real replica's engine gauge);
        # lets tier-1 prove mixed-dtype fleet aggregation with no model.
        self.inference_dtype = inference_dtype
        self.act_delay_s = act_delay_s
        # Elastic rehearsals: a real replica's device serializes
        # its batched steps, so replica count moves latency under load.
        # `act_concurrency > 0` mimics that — at most N simulated device
        # steps run at once per stub, the rest queue (and their queue wait
        # lands in the latency histogram, as it would on a real replica).
        # 0 = unlimited, the legacy fully-concurrent behavior.
        self._device_gate = (
            threading.BoundedSemaphore(act_concurrency)
            if act_concurrency > 0
            else None
        )
        self.reload_delay_s = reload_delay_s
        # KV-cached incremental decode, mimicked model-free (protocol
        # double for the real replica's --cached_inference): the flag is
        # advertised in /healthz + the ready-line and the cache counter
        # families move the way the real engine moves them — acts count
        # as cached steps, resets/reloads/slot reclaims invalidate, a
        # reload "rebuilds" every live session's cache.
        self.cached_inference = cached_inference
        # Flywheel-capture gauge mimicry (default off — the real stub
        # captures nothing, and an unarmed stub's /metrics must stay
        # byte-identical): episode boundaries (reset/release of a known
        # session) count as written episodes, open sessions mirror the
        # session table, and the error/prune counters exist at zero so
        # the fleet fan-out renders every rt1_serve_replica_capture_*
        # family the default alert rules watch.
        self.mimic_capture = mimic_capture
        self.capture_episodes = 0
        self.cache_invalidations = {"swap": 0, "reset": 0, "evict": 0}
        self.cache_cached_steps = 0
        self.cache_rebuild_steps = 0
        self.metrics = ServeMetrics()
        self.exemplars = ExemplarRing(threshold_ms=slow_threshold_ms)
        self.ready = True
        self.draining = False
        self.reloading = False
        self.reloads = 0
        self.checkpoint_step = -1
        # Durable sessions, mimicked exactly (protocol double for
        # rt1_tpu/serve/migrate.py on the real replica): the snapshot is
        # the session's step counter under the same versioned wire schema
        # — so the tier-1 fleet tests prove live migration, affinity
        # remap, crash restore, and the failed-import fallback with no model
        # boots. `checkpoint_generation` tracks /reload's step so a
        # test can manufacture cross-generation refusals.
        self.checkpoint_generation = -1
        self.snapshot_max_age_s = float(snapshot_max_age_s)
        self.snapshot_ring = (
            migrate.SnapshotRing(session_snapshot_dir)
            if session_snapshot_dir
            else None
        )
        self.migration_exports = 0
        self.migration_imports = 0
        self.migration_import_failures = 0
        self.migration_restores = 0
        self.migration_restore_failures = 0
        self._lock = threading.Lock()
        self._reload_lock = threading.Lock()  # one reload at a time (409)
        self._sessions: Dict[str, int] = {}  # session -> next step index

    # ------------------------------------------------------------- handlers

    def act(
        self, payload: Dict[str, Any], headers=None
    ) -> Tuple[int, Dict[str, Any]]:
        """Same request-tracing contract as the real `/act`: one resolved
        request id spanning a `replica_act` span, a phase ledger stamped
        through the (instantaneous) queue and the simulated device step,
        the exemplar ring, and the id echoed in every response."""
        phases = reqtrace.RequestPhases(
            reqtrace.request_id_from(headers, payload)
        )
        with obs_trace.span(
            "replica_act",
            request_id=phases.request_id,
            replica=self.replica_id,
        ):
            code, body = self._act_inner(payload, phases)
        body["request_id"] = phases.request_id
        phases.t_done = obs_trace.now_us()
        if code == 200:
            phases.emit_trace(payload.get("session_id"))
            outcome = "ok"
        else:
            outcome = "rejected" if code == 503 else "failed"
        breakdown = phases.phases_ms()
        self.exemplars.offer(
            breakdown["total_ms"] or 0.0,
            request_id=phases.request_id,
            session=payload.get("session_id"),
            outcome=outcome,
            error=body.get("error"),
            phases=breakdown,
        )
        if code == 200 and payload.get(reqtrace.DEBUG_KEY):
            body["phases"] = breakdown
        return code, body

    def _act_inner(
        self, payload: Dict[str, Any], phases: reqtrace.RequestPhases
    ) -> Tuple[int, Dict[str, Any]]:
        session_id = payload.get("session_id")
        if not isinstance(session_id, str) or not session_id:
            return 400, {"error": "'session_id' must be a non-empty string"}
        if "image" not in payload and "image_b64" not in payload:
            return 400, {"error": "payload needs 'image' or 'image_b64'"}
        if self.draining:
            return 503, {"error": "draining"}
        # Crash durability, mimicked: an unknown session with a ring
        # snapshot resumes mid-episode instead of restarting at step 0.
        restored = (
            self._maybe_restore(session_id)
            if self.snapshot_ring is not None
            else None
        )
        t0 = time.perf_counter()
        # The stub has no real batcher: admission, queue, and formation
        # collapse to back-to-back stamps (their deltas read ~0 ms, which
        # is the truthful value for a model-free replica).
        phases.t_enqueue = obs_trace.now_us()
        phases.t_formed = obs_trace.now_us()
        phases.t_device0 = obs_trace.now_us()
        if self._device_gate is not None:
            self._device_gate.acquire()  # simulated device: steps serialize
        try:
            with reqtrace.device_step_span(1, [phases.request_id]):
                if self.act_delay_s:
                    time.sleep(self.act_delay_s)  # inside the timer: the
                    #   latency histogram must reflect the simulated step
                    #   cost (and, gated, the queue wait for the device)
                with self._lock:
                    started = session_id not in self._sessions
                    if (
                        self.cached_inference
                        and started
                        and len(self._sessions) >= self.max_sessions
                    ):
                        # Mimic the engine's LRU slot reclaim: the oldest
                        # session's cache is invalidated for the newcomer.
                        self._sessions.pop(next(iter(self._sessions)))
                        self.cache_invalidations["evict"] += 1
                    step = self._sessions.get(session_id, 0)
                    self._sessions[session_id] = step + 1
                    if self.cached_inference:
                        self.cache_cached_steps += 1
        finally:
            if self._device_gate is not None:
                self._device_gate.release()
        phases.t_device1 = obs_trace.now_us()
        self.metrics.observe_request(time.perf_counter() - t0)
        self.metrics.observe_batch(1, queued=0)
        # Per-task serve labels, mimicked exactly (the real replica counts
        # in ServeApp.act): tier-1 fleet tests prove the task-label
        # aggregation plumbing with zero model boots.
        task = payload.get("task")
        self.metrics.observe_task_request(
            task if isinstance(task, str) else None, new_session=started
        )
        # Smallest advertised bucket that fits a batch of 1 — the same
        # selection rule PolicyEngine.bucket_for applies.
        self.metrics.observe_bucket(
            next((b for b in self.buckets if b >= 1), 1), 1
        )
        if self.snapshot_ring is not None:
            try:
                self.snapshot_ring.save(self._build_snapshot(session_id))
            except Exception:
                pass  # durability is advisory; the answer already shipped
        body = {
            "action": stub_action(step),
            "action_tokens": [0, step % 256, (step * 3) % 256],
            "session_started": started,
            # Test hook: which process+step actually served this act.
            "replica_id": self.replica_id,
            "step_index": step,
        }
        if restored:
            body.update(restored)
        return 200, body

    def reset(self, payload) -> Tuple[int, Dict[str, Any]]:
        session_id = payload.get("session_id")
        if not isinstance(session_id, str) or not session_id:
            return 400, {"error": "'session_id' must be a non-empty string"}
        with self._lock:
            if session_id in self._sessions:
                if self.cached_inference:
                    self.cache_invalidations["reset"] += 1
                if self.mimic_capture:
                    self.capture_episodes += 1  # episode boundary
            self._sessions[session_id] = 0
            slot = list(self._sessions).index(session_id)
        if self.snapshot_ring is not None:
            self.snapshot_ring.drop(session_id)
        self.metrics.observe_reset()
        return 200, {"ok": True, "slot": slot}

    def release(self, payload) -> Tuple[int, Dict[str, Any]]:
        session_id = payload.get("session_id")
        with self._lock:
            known = self._sessions.pop(session_id, None)
            if known is not None and self.mimic_capture:
                self.capture_episodes += 1  # episode boundary
        if known is None:
            return 404, {"error": f"unknown session {session_id!r}"}
        # keep_snapshot: migration cleanup releasing the source's stale
        # copy — the shared ring file now backs the importer's session.
        if self.snapshot_ring is not None and not payload.get(
            "keep_snapshot"
        ):
            self.snapshot_ring.drop(session_id)
        return 200, {"ok": True}

    # ------------------------------------------------- durable sessions

    def _build_snapshot(self, session_id: str) -> Dict[str, Any]:
        with self._lock:
            if session_id not in self._sessions:
                raise KeyError(f"unknown session {session_id!r}")
            next_step = self._sessions[session_id]
        return {
            "version": migrate.SNAPSHOT_VERSION,
            "session_id": session_id,
            "step_index": next_step,
            "checkpoint_generation": self.checkpoint_generation,
            "window": STUB_WINDOW,
            "cached_inference": self.cached_inference,
            "schema": [
                [name, list(shape), dtype]
                for name, shape, dtype in STUB_SCHEMA
            ],
            "state": {"stub_step": {"data": [next_step]}},
        }

    def session_export(self, payload) -> Tuple[int, Dict[str, Any]]:
        session_id = payload.get("session_id")
        if not isinstance(session_id, str) or not session_id:
            return 400, {"error": "'session_id' must be a non-empty string"}
        try:
            snapshot = self._build_snapshot(session_id)
        except KeyError as exc:
            return 404, {"error": str(exc)}
        with self._lock:
            self.migration_exports += 1
        return 200, {"ok": True, "snapshot": snapshot}

    def import_session(
        self,
        snapshot: Dict[str, Any],
        session_id=None,
        _count: bool = True,
    ) -> Dict[str, Any]:
        """Validate a wire snapshot against this stub's generation /
        window / mode / schema — the same refusal surface as the real
        replica — then resume the session's step counter. Raises
        SnapshotCompatibilityError on refusal (HTTP 409)."""
        try:
            migrate.check_compatibility(
                snapshot,
                checkpoint_generation=self.checkpoint_generation,
                window=STUB_WINDOW,
                cached_inference=self.cached_inference,
                schema=STUB_SCHEMA,
            )
            step_index = int(snapshot.get("step_index", 0))
        except Exception:
            if _count:
                with self._lock:
                    self.migration_import_failures += 1
            raise
        sid = session_id or str(snapshot["session_id"])
        with self._lock:
            self._sessions[sid] = step_index
            slot = list(self._sessions).index(sid)
            if _count:
                self.migration_imports += 1
        return {"session_id": sid, "slot": slot, "step_index": step_index}

    def session_import(self, payload) -> Tuple[int, Dict[str, Any]]:
        snapshot = payload.get("snapshot")
        if not isinstance(snapshot, dict):
            return 400, {"error": "'snapshot' must be a JSON object"}
        session_id = payload.get("session_id")
        if session_id is not None and (
            not isinstance(session_id, str) or not session_id
        ):
            return 400, {"error": "'session_id' must be a non-empty "
                                  "string when given"}
        try:
            result = self.import_session(snapshot, session_id=session_id)
        except migrate.SnapshotCompatibilityError as exc:
            return 409, {"error": str(exc)}
        except (ValueError, KeyError) as exc:
            return 400, {"error": str(exc)}
        return 200, {"ok": True, **result}

    def _maybe_restore(self, session_id: str):
        with self._lock:
            if session_id in self._sessions:
                return None
        loaded = self.snapshot_ring.load(session_id)
        if loaded is None:
            return None
        snapshot, age_s = loaded
        try:
            faults.maybe_fail("session_restore", what=session_id)
            if age_s is not None and age_s > self.snapshot_max_age_s:
                raise migrate.SnapshotCompatibilityError(
                    "session snapshot for %r is %.1fs old, past the "
                    "%.1fs staleness bound" % (
                        session_id, age_s, self.snapshot_max_age_s)
                )
            result = self.import_session(
                snapshot, session_id=session_id, _count=False
            )
        except Exception:
            with self._lock:
                self.migration_restore_failures += 1
            self.snapshot_ring.drop(session_id)
            return None
        with self._lock:
            self.migration_restores += 1
        out = {
            "session_restored": True,
            "step_index_restored": result["step_index"],
        }
        if age_s is not None:
            out["snapshot_age_s"] = round(float(age_s), 3)
        return out

    def reload(self, payload) -> Tuple[int, Dict[str, Any]]:
        # Same one-reload-at-a-time contract as ServeApp._reload_lock —
        # handlers run concurrently, a bare flag check would race.
        if not self._reload_lock.acquire(blocking=False):
            return 409, {"error": "a reload is already in progress",
                         "retry": True}
        self.reloading = True
        try:
            time.sleep(self.reload_delay_s)  # the restore-and-validate cost
            self.reloads += 1
            self.checkpoint_step = payload.get("step", -1)
            # New weights, new snapshot generation — same contract as the
            # real replica: imports of old-generation snapshots are
            # refused by name after a reload lands a different step.
            self.checkpoint_generation = self.checkpoint_step
            self.metrics.observe_reload()
            caches_rebuilt = 0
            if self.cached_inference:
                with self._lock:
                    caches_rebuilt = len(self._sessions)
                self.cache_invalidations["swap"] += 1
                self.cache_rebuild_steps += caches_rebuilt
            return 200, {
                "ok": True,
                "checkpoint_step": self.checkpoint_step,
                "reloads_total": self.reloads,
                "params_swapped": 0,
                **(
                    {"caches_rebuilt": caches_rebuilt}
                    if self.cached_inference
                    else {}
                ),
            }
        finally:
            self.reloading = False
            self._reload_lock.release()

    def healthz(self) -> Dict[str, Any]:
        with self._lock:
            active = len(self._sessions)
        return {
            "status": "draining" if self.draining else "ok",
            "stub": True,
            "replica_id": self.replica_id,
            "image_shape": list(IMAGE_SHAPE),
            "embed_dim": EMBED_DIM,
            "max_sessions": self.max_sessions,
            "active_sessions": active,
            # The contract field; nothing compiles here, but the invariant
            # (compile_count == bucket count) is mimicked exactly.
            "compile_count": self.compile_count,
            "buckets": list(self.buckets),
            "scheduler": self.scheduler,
            "reloads": self.reloads,
            "inference_dtype": self.inference_dtype,
            "cached_inference": self.cached_inference,
            # Migration compatibility surface (same keys as the real
            # replica): a router compares these before shipping a
            # session snapshot here.
            "checkpoint_generation": self.checkpoint_generation,
            "window": STUB_WINDOW,
            "session_snapshots": self.snapshot_ring is not None,
        }

    def readyz(self) -> Tuple[int, Dict[str, Any]]:
        if self.draining:
            return 503, {"ready": False, "reason": "draining"}
        if self.reloading:
            return 503, {"ready": False, "reason": "reloading"}
        if not self.ready:
            return 503, {"ready": False, "reason": "warming"}
        return 200, {"ready": True}

    def _gauges(self) -> Dict[str, Any]:
        with self._lock:
            active = len(self._sessions)
        return {
            "active_sessions": active,
            "compile_count": self.compile_count,
            "bucket_count": len(self.buckets),
            "draining": int(self.draining),
            "ready": int(self.ready),
            "reloading": int(self.reloading),
            "replica_id": self.replica_id,
            "slow_exemplars": len(self.exemplars),
            "inference_dtype": self.inference_dtype,
            # Deterministic stand-in bytes: a mixed-dtype fleet test can
            # assert the per-replica gauge plumbing end to end.
            "param_bytes_device": 1000 + self.replica_id,
            "param_bytes_master": 4000,
            # KV-cache gauge mimicry (deterministic stand-in bytes): the
            # fleet tests assert the rt1_serve_cache_* plumbing end to
            # end with zero model boots.
            "cache_enabled": int(self.cached_inference),
            "cache_bytes_per_slot": (
                2048 if self.cached_inference else 0
            ),
            "cache_cached_steps_total": self.cache_cached_steps,
            "cache_rebuild_steps_total": self.cache_rebuild_steps,
            "cache_invalidations": dict(self.cache_invalidations),
            # Durable-session counters ride only once migration is armed
            # or has happened:
            # an unarmed stub's /metrics stays byte-identical, while any
            # fleet that migrates/restores renders every
            # rt1_serve_replica_migration_* family the alert rules watch.
            **(
                {
                    "migration_exports_total": self.migration_exports,
                    "migration_imports_total": self.migration_imports,
                    "migration_import_failures_total": (
                        self.migration_import_failures
                    ),
                    "migration_restores_total": self.migration_restores,
                    "migration_restore_failures_total": (
                        self.migration_restore_failures
                    ),
                }
                if (
                    self.snapshot_ring is not None
                    or self.migration_exports
                    or self.migration_imports
                    or self.migration_import_failures
                    or self.migration_restores
                    or self.migration_restore_failures
                )
                else {}
            ),
            # Capture-family mimicry rides ONLY behind the flag: keys
            # absent by default keeps the unarmed stub's /metrics (and
            # the fleet fan-out built from it) byte-identical.
            **(
                {
                    "capture_enabled": 1,
                    "capture_episodes_total": self.capture_episodes,
                    "capture_open_sessions": active,
                    "capture_write_errors_total": 0,
                    "capture_pruned_total": 0,
                }
                if self.mimic_capture
                else {}
            ),
        }

    def metrics_snapshot(self) -> Dict[str, Any]:
        return self.metrics.snapshot(**self._gauges())

    def metrics_prometheus(self) -> str:
        return self.metrics.prometheus_text(**self._gauges())


class _StubHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    app: StubReplicaApp = None

    def log_message(self, fmt, *args):  # noqa: D102 - stdlib hook
        pass

    def _reply(self, code, payload):
        body = json.dumps(payload).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 - stdlib casing
        if self.path == "/healthz":
            self._reply(200, self.app.healthz())
        elif self.path == "/readyz":
            code, payload = self.app.readyz()
            self._reply(code, payload)
        elif self.path == "/metrics":
            if obs_prometheus.accepts_text(self.headers.get("Accept")):
                text = self.app.metrics_prometheus().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", obs_prometheus.CONTENT_TYPE)
                self.send_header("Content-Length", str(len(text)))
                self.end_headers()
                self.wfile.write(text)
            else:
                self._reply(200, self.app.metrics_snapshot())
        elif self.path == "/slow_requests":
            self._reply(
                200,
                {
                    **self.app.exemplars.stats(),
                    "slow_requests": self.app.exemplars.snapshot(),
                },
            )
        elif self.path == "/trace":
            # Test-double introspection: the process's Chrome-trace ring
            # (empty when no recorder is installed). Lets a fleet test
            # assert the replica-side spans carry the propagated request
            # id without reaching into a subprocess's memory.
            tracer = obs_trace.active()
            self._reply(
                200, tracer.to_dict() if tracer else {"traceEvents": []}
            )
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):  # noqa: N802 - stdlib casing
        length = int(self.headers.get("Content-Length", 0))
        try:
            payload = json.loads(self.rfile.read(length)) if length else {}
        except json.JSONDecodeError as exc:
            self._reply(400, {"error": f"invalid JSON body: {exc}"})
            return
        if self.path == "/act":
            code, body = self.app.act(payload, headers=self.headers)
            self._reply(code, body)
            return
        ops = {
            "/reset": self.app.reset,
            "/release": self.app.release,
            "/reload": self.app.reload,
            "/session/export": self.app.session_export,
            "/session/import": self.app.session_import,
        }
        op = ops.get(self.path)
        if op is None:
            self._reply(404, {"error": f"unknown path {self.path}"})
            return
        code, body = op(payload)
        self._reply(code, body)


def make_stub_server(
    app: StubReplicaApp, host: str = "127.0.0.1", port: int = 0
) -> HTTPServer:
    handler = type("BoundStubHandler", (_StubHandler,), {"app": app})
    httpd = HTTPServer((host, port), handler)
    return httpd


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--replica_id", type=int, default=0)
    parser.add_argument("--max_sessions", type=int, default=8)
    parser.add_argument(
        "--startup_delay_s", type=float, default=0.0,
        help="Simulated warm-up: /readyz says 'warming' this long.")
    parser.add_argument(
        "--act_delay_s", type=float, default=0.0,
        help="Simulated device-step latency per /act.")
    parser.add_argument(
        "--act_concurrency", type=int, default=0,
        help="Serialize at most N simulated device steps at once "
             "(elastic-fleet rehearsals; 0 = unlimited).")
    parser.add_argument("--reload_delay_s", type=float, default=0.05)
    parser.add_argument(
        "--slow_threshold_ms", type=float, default=0.0,
        help="Exemplar-ring threshold (0 keeps the most recent window).")
    parser.add_argument(
        "--inference_dtype", default="f32",
        choices=["f32", "bf16", "int8"],
        help="Advertised low-precision mode (protocol double for the "
             "real replica's --inference_dtype).")
    parser.add_argument(
        "--buckets", default="1",
        help="Advertised AOT batch-size buckets (comma ints; protocol "
             "double for the real replica's --buckets; compile_count is "
             "reported as the bucket count).")
    parser.add_argument(
        "--scheduler", default="continuous",
        choices=["continuous", "cycle"],
        help="Advertised batch scheduler (protocol double only).")
    parser.add_argument(
        "--mimic_capture", action="store_true",
        help="Advertise the flywheel-capture gauge families with "
             "deterministic values (protocol double for a capture-armed "
             "replica; lets fleet tests and ops rehearsals exercise the "
             "rt1_serve_replica_capture_* fan-out with no model).")
    parser.add_argument(
        "--cached_inference", action="store_true",
        help="Advertise KV-cached incremental decode and mimic its "
             "counter families (protocol double for the real replica's "
             "--cached_inference).")
    parser.add_argument(
        "--session_snapshot_dir", default="",
        help="Durable sessions: bounded on-disk snapshot ring (protocol "
             "double for the real replica's --session_snapshot_dir; "
             "SIGKILL'd sessions restore mid-episode at re-home time).")
    parser.add_argument(
        "--snapshot_max_age_s", type=float, default=600.0,
        help="Staleness bound for crash restores (snapshots older than "
             "this start a fresh window).")
    args = parser.parse_args(argv)

    # Arm chaos sites from the environment (RT1_FAULTS): the fleet
    # supervisor exports its combined fault spec before spawning so
    # replica-side sites (session_restore) fire inside this process.
    faults.install_from("")

    # Bounded in-process trace ring so GET /trace (and the fleet tests'
    # span-propagation assertions) see real replica-side spans.
    obs_trace.enable(max_events=4096)
    app = StubReplicaApp(
        replica_id=args.replica_id,
        max_sessions=args.max_sessions,
        act_delay_s=args.act_delay_s,
        reload_delay_s=args.reload_delay_s,
        slow_threshold_ms=args.slow_threshold_ms,
        inference_dtype=args.inference_dtype,
        buckets=[int(b) for b in args.buckets.split(",") if b.strip()],
        scheduler=args.scheduler,
        act_concurrency=args.act_concurrency,
        cached_inference=args.cached_inference,
        mimic_capture=args.mimic_capture,
        session_snapshot_dir=args.session_snapshot_dir or None,
        snapshot_max_age_s=args.snapshot_max_age_s,
    )
    httpd = make_stub_server(app, host=args.host, port=args.port)
    # Graceful drain on SIGTERM — the same contract the real replica's
    # install_signal_handlers provides, so a scale-down reclaim (router
    # de-placement -> SIGTERM -> reap) finishes in-flight acts and exits
    # 0 instead of dying rc=-15 mid-response. ThreadingHTTPServer's
    # block_on_close joins the in-flight handler threads in server_close.
    import signal as _signal

    def _drain(signum, frame):  # noqa: ARG001 - signal signature
        app.draining = True
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    _signal.signal(_signal.SIGTERM, _drain)
    if args.startup_delay_s:
        app.ready = False

        def _warm():
            time.sleep(args.startup_delay_s)
            app.ready = True

        threading.Thread(target=_warm, daemon=True).start()
    # The same ready-line contract as python -m rt1_tpu_torch.serve: the fleet
    # supervisor learns the ephemeral port from this one stdout line.
    print(
        json.dumps(
            {
                "status": "serving",
                "stub": True,
                "host": httpd.server_address[0],
                "port": httpd.server_address[1],
                "replica_id": args.replica_id,
                "checkpoint_step": -1,
                "max_sessions": args.max_sessions,
                "compile_count": app.compile_count,
                "buckets": list(app.buckets),
                "scheduler": app.scheduler,
                "inference_dtype": args.inference_dtype,
                "cached_inference": app.cached_inference,
            }
        ),
        flush=True,
    )
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
