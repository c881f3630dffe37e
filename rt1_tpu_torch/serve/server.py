"""Stdlib-only HTTP frontend for the batched policy engine (counterpart of
`rt1_tpu/serve/server.py`, with the same request and response fields).

Threading model: `ThreadingHTTPServer` gives every connection a handler
thread; one background thread runs an asyncio loop that owns the batcher;
the batcher's executor calls the engine. Handler threads bridge into the
loop with `run_coroutine_threadsafe` and block on the future.

Endpoints (all JSON):

* `POST /act`     {"session_id", "image" | "image_b64", "instruction" |
                   "embedding"} -> {"action", "action_tokens",
                   "session_started", "request_id", "terminate_episode"}
* `POST /reset`   {"session_id"} -> {"ok": true, "slot": i}
* `POST /release` {"session_id", "keep_snapshot"?} -> {"ok": true}
* `POST /reload`  {"step"?} -> zero-downtime weight swap from the standby
                  source (`reload_fn`): 409 while another reload runs,
                  `/readyz` 503 `reloading` meanwhile
* `POST /session/export` {"session_id"} -> {"ok": true, "snapshot"}: the
                  versioned wire snapshot (`serve/migrate.py`)
* `POST /session/import` {"snapshot", "session_id"?} -> {"ok": true,
                  "session_id", "slot", "step_index"}; 409 naming the field
                  on a generation, window, mode or schema mismatch
* `GET /healthz`  liveness + the input contract (image shape, embed dim)
                  and the migration contract (generation, window, mode)
* `GET /readyz`   503 before warm-up finishes, while draining and while
                  reloading, else 200
* `GET /metrics`  `ServeMetrics.snapshot()` plus engine gauges, among them
                  `attention_launches_total` (the fused kernels' launch
                  count; `attention_launches_{tensor_core,tf32x3,simple}_total`
                  per variant), `engine_steps_total` (batched steps,
                  warm-up included), the serving mode's `inference_dtype`,
                  `param_bytes_device` / `param_bytes_master`, the cache's
                  and the migration counters; with `Accept: text/plain`
                  (or openmetrics) the same numbers as Prometheus text
                  (`obs/prometheus.py`)
* `GET /slow_requests` the bounded slow-request exemplar ring: request ids
                  and per-phase breakdowns of every request past the slow
                  threshold (dumped to `exemplar_path` as JSONL on drain)

Request tracing (`serve/reqtrace.py`): every `/act` resolves a request id
(the client's or router's `X-RT1-Request-Id` header, else minted), echoes
it as `request_id`, stamps it through admission -> queue -> batch ->
device -> serialization, emits linked `replica_act` / `batch_wait` /
`device_step` spans on the obs timeline when tracing is on, and with
`"debug": true` in the payload returns the `phases` breakdown.

With `session_snapshot_dir`, every `snapshot_every`-th step of a session
writes its snapshot to an on-disk ring; an `/act` for a session this
replica does not hold restores it from there when the snapshot is younger
than `snapshot_max_age_s` (`session_restored` in the reply).

Queue full -> 503 `busy`; draining -> 503 `draining`.
`install_signal_handlers` turns SIGTERM/SIGINT into a drain: stop
admitting, flush every accepted request, stop serving.
"""

from __future__ import annotations

import asyncio
import base64
import binascii
import concurrent.futures
import json
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from rt1_tpu_torch.obs import prometheus as obs_prometheus
from rt1_tpu_torch.obs import trace as obs_trace
from rt1_tpu_torch.obs.recorder import ExemplarRing
from rt1_tpu_torch.parallel.flash_attention import fused_attention
from rt1_tpu_torch.resilience import faults
from rt1_tpu_torch.serve import migrate, reqtrace
from rt1_tpu_torch.serve.httpd import HTTPServer
from rt1_tpu_torch.serve.batcher import BusyError, ContinuousBatcher, DrainingError, MicroBatcher
from rt1_tpu_torch.serve.engine import (
    EMBEDDING_DIM,
    PolicyEngine,
    SessionError,
    SlotContentionError,
)
from rt1_tpu_torch.serve.metrics import ServeMetrics

class RequestError(ValueError):
    """Malformed client payload -> HTTP 400."""


class ReloadInProgressError(RuntimeError):
    """A weight hot swap is already running -> HTTP 409."""


def parse_observation(payload: Dict[str, Any], image_shape: Sequence[int],
                      embed_dim: Optional[int] = None) -> Dict[str, Any]:
    """Decode one /act payload into an engine observation. Images arrive as
    a nested float list in [0, 1] or as `image_b64`, base64 of raw uint8
    H*W*3 bytes."""
    if "image_b64" in payload:
        try:
            raw = base64.b64decode(payload["image_b64"], validate=True)
        except (binascii.Error, ValueError) as exc:
            raise RequestError(f"image_b64 is not valid base64: {exc}") from exc
        flat = np.frombuffer(raw, np.uint8)
        expected = int(np.prod(image_shape))
        if flat.size != expected:
            raise RequestError(
                f"image_b64 decodes to {flat.size} bytes, expected {expected} "
                f"for shape {tuple(image_shape)}"
            )
        image = flat.reshape(image_shape).astype(np.float32) / 255.0
    elif "image" in payload:
        image = np.asarray(payload["image"], np.float32)
        if image.shape != tuple(image_shape):
            raise RequestError(f"image shape {image.shape} != server shape {tuple(image_shape)}")
    else:
        raise RequestError("payload needs 'image' or 'image_b64'")
    obs: Dict[str, Any] = {"image": image}
    if "embedding" in payload:
        embedding = np.asarray(payload["embedding"], np.float32)
        if embed_dim is not None and embedding.shape != (embed_dim,):
            raise RequestError(f"embedding shape {embedding.shape} != ({embed_dim},)")
        obs["natural_language_embedding"] = embedding
    elif "instruction" in payload:
        if not isinstance(payload["instruction"], str):
            raise RequestError("'instruction' must be a string")
        obs["instruction"] = payload["instruction"]
    else:
        raise RequestError("payload needs 'instruction' or 'embedding'")
    return obs


class ServeApp:
    """Engine + batcher + metrics behind a thread-safe facade."""

    def __init__(
        self,
        engine: PolicyEngine,
        *,
        image_shape: Sequence[int],
        max_batch: Optional[int] = None,
        max_delay_s: float = 0.010,
        max_queue: int = 64,
        scheduler: str = "continuous",
        pipeline_depth: int = 2,
        request_timeout_s: float = 60.0,
        replica_id: int = 0,
        reload_fn=None,
        checkpoint_step: int = -1,
        session_snapshot_dir: Optional[str] = None,
        snapshot_max_age_s: float = 600.0,
        snapshot_every: int = 1,
        slow_threshold_ms: float = 0.0,
        slow_capacity: int = 128,
        exemplar_path: Optional[str] = None,
        capture=None,
    ):
        self.engine = engine
        # Opt-in flywheel episode capture (`flywheel/capture.py::
        # EpisodeCaptureSink`, wired from `--capture_dir`). None, the
        # default, leaves every serve path as it was: one `is None` check.
        self.capture = capture
        self.image_shape = tuple(image_shape)
        self.embed_dim = EMBEDDING_DIM
        self.metrics = ServeMetrics()
        self.request_timeout_s = request_timeout_s
        self.replica_id = replica_id
        # Slow-request exemplar ring: request id + phase breakdown for
        # every request past the threshold (0 = all, ring-bounded), served
        # on GET /slow_requests and dumped to `exemplar_path` on drain.
        self.exemplars = ExemplarRing(capacity=slow_capacity, threshold_ms=slow_threshold_ms)
        self.exemplar_path = exemplar_path
        # The checkpoint generation stamps exported snapshots and gates
        # imports; per-session metadata (step counter, last instruction)
        # rides the snapshot.
        self.checkpoint_generation = int(checkpoint_step)
        self.snapshot_max_age_s = float(snapshot_max_age_s)
        self.snapshot_every = max(1, int(snapshot_every))
        self.snapshot_ring = (
            migrate.SnapshotRing(session_snapshot_dir) if session_snapshot_dir else None
        )
        self._meta_lock = threading.Lock()
        self._session_meta: Dict[str, Dict[str, Any]] = {}
        self.migration_exports = 0
        self.migration_imports = 0
        self.migration_import_failures = 0
        self.migration_restores = 0
        self.migration_restore_failures = 0
        # reload_fn(step | None) -> (f32 master state_dict, checkpoint step).
        self._reload_fn = reload_fn
        self._reload_lock = threading.Lock()
        self.reloading = False
        self.draining = False
        self.ready = False
        # Makes the draining check and the batcher submit one step against
        # drain(): an admitted request is always flushed, never 503ed.
        self._admit_lock = threading.Lock()
        self._loop = asyncio.new_event_loop()
        self._loop_thread = threading.Thread(
            target=self._loop.run_forever, name="rt1-serve-loop", daemon=True
        )
        if scheduler not in ("continuous", "cycle"):
            raise ValueError(f"scheduler must be 'continuous' or 'cycle', got {scheduler!r}")
        self.scheduler = scheduler
        # A flush larger than the slot count would make the engine refuse
        # the whole batch: clamp, as JAX does (None or 0 = max_sessions).
        self.max_batch = min(max_batch or engine.max_sessions, engine.max_sessions)
        self.max_delay_s = max_delay_s
        self.max_queue = max_queue
        self.pipeline_depth = pipeline_depth
        # batch_key: one session's requests never share a batch. The
        # continuous scheduler takes `max_delay_s` as its demand-coalesce
        # cap (a lone client still dispatches at once), the cycle scheduler
        # as its deadline.
        if scheduler == "continuous":
            self.batcher = ContinuousBatcher(
                self._process,
                max_batch=self.max_batch,
                max_queue=max_queue,
                pipeline_depth=pipeline_depth,
                coalesce_delay_s=max_delay_s,
                batch_key=lambda item: item[0],
                metrics=self.metrics,
                on_batch=self._mark_batch_formed,
            )
        else:
            self.batcher = MicroBatcher(
                self._process,
                max_batch=self.max_batch,
                max_delay_s=max_delay_s,
                max_queue=max_queue,
                batch_key=lambda item: item[0],
                metrics=self.metrics,
                on_batch=self._mark_batch_formed,
            )

    @staticmethod
    def _mark_batch_formed(items) -> None:
        """Batcher-loop hook: these requests just left the queue."""
        now = obs_trace.now_us()
        for _, _, phases in items:
            phases.t_formed = now

    def _process(self, items):
        t0 = time.perf_counter()
        now = obs_trace.now_us()
        for _, _, phases in items:
            phases.t_device0 = now
        # The `device_step` span, tagged with every rider's request id.
        with reqtrace.device_step_span(len(items), (ph.request_id for _, _, ph in items)):
            # Dispatch (under the engine lock) then collect (outside it):
            # with the continuous batcher's second worker, batch N+1 is
            # enqueued while this collect waits. Nothing may sit between
            # the two.
            handle = self.engine.dispatch_batch([(sid, obs) for sid, obs, _ in items])
            results = self.engine.collect_batch(handle)
        now = obs_trace.now_us()
        for _, _, phases in items:
            phases.t_device1 = now
        if handle.bucket is not None:
            self.metrics.observe_bucket(handle.bucket, handle.active_count)
        self.metrics.observe_step(time.perf_counter() - t0)
        return results

    def start(self, warmup: bool = True) -> None:
        """Start the batcher loop and warm every bucket up front, on every
        batcher worker thread: PyTorch keeps cuDNN's execution plans and
        cuBLAS handles per thread."""
        self._loop_thread.start()
        asyncio.run_coroutine_threadsafe(self.batcher.start(), self._loop).result(timeout=10)
        if warmup:
            self.batcher.on_each_worker(
                lambda: self.engine.warmup(self.image_shape, self.embed_dim)
            )
        self.ready = True

    def act(self, session_id: str, obs: Dict[str, Any],
            phases: Optional[reqtrace.RequestPhases] = None,
            task: Optional[str] = None) -> Dict[str, Any]:
        """Blocking bridge used by HTTP handler threads. `phases` rides the
        batcher item so every boundary stamps one ledger; `task` is the
        client's workload tag for the per-task counters."""
        if phases is None:
            phases = reqtrace.RequestPhases()
        restored = self.maybe_restore_session(session_id) if self.snapshot_ring else None
        t_entry = time.perf_counter()
        while True:
            with self._admit_lock:
                if self.draining:
                    raise DrainingError("draining; not accepting requests")
                phases.t_enqueue = obs_trace.now_us()
                future = asyncio.run_coroutine_threadsafe(
                    self.batcher.submit((session_id, obs, phases)), self._loop
                )
            try:
                remaining = self.request_timeout_s - (time.perf_counter() - t_entry)
                result = future.result(timeout=max(remaining, 0.001))
            except concurrent.futures.TimeoutError:
                future.cancel()
                raise
            if (
                isinstance(result.get("error"), SlotContentionError)
                and time.perf_counter() - t_entry < self.request_timeout_s / 2
            ):
                # Every slot rides this batch or an in-flight step: re-ride
                # the next batch instead of bouncing a 503.
                time.sleep(0.002)
                continue
            break
        if "error" in result:
            raise result["error"]
        self.metrics.observe_task_request(task, new_session=result.get("session_started", False))
        if self.capture is not None:
            # After the engine answered: capture sees only served steps,
            # and a sink failure never fails the request (record_step
            # counts its own errors). The frame is the request's own
            # decoded buffer, which nothing else reuses.
            self.capture.record_step(
                session_id,
                image=obs["image"],
                action=result["action"],
                action_tokens=result.get("action_tokens"),
                embedding=obs.get("natural_language_embedding"),
                instruction=obs.get("instruction"),
                task=task,
                session_started=result.get("session_started", False),
                terminate=bool(result.get("terminate_episode", 0)),
            )
        self._note_act(session_id, obs, result)
        if restored:
            result.update(restored)
        return result

    def reset(self, session_id: str) -> int:
        """A fresh window: the step counter restarts and the ring's copy
        of the abandoned episode goes; a captured episode in flight ends."""
        slot = self.engine.reset(session_id)
        if self.capture is not None:
            self.capture.finalize(session_id, "reset")
        with self._meta_lock:
            meta = self._session_meta.get(session_id)
            if meta is not None:
                meta["step_index"] = 0
        if self.snapshot_ring is not None:
            self.snapshot_ring.drop(session_id)
        return slot

    def release(self, session_id: str, keep_snapshot: bool = False) -> None:
        """Forget a session; `keep_snapshot` keeps its ring file (the
        session continues on the replica that imported it, and its captured
        episode ends as "migrated", not "released")."""
        self.engine.release(session_id)
        if self.capture is not None:
            self.capture.finalize(session_id, "migrated" if keep_snapshot else "released")
        with self._meta_lock:
            self._session_meta.pop(session_id, None)
        if self.snapshot_ring is not None and not keep_snapshot:
            self.snapshot_ring.drop(session_id)

    # ------------------------------------------------------------ sessions

    def _note_act(self, session_id: str, obs: Dict[str, Any], result: Dict[str, Any]) -> None:
        """Advance the session's step counter and, every `snapshot_every`
        steps, write its ring snapshot. Best effort: a full disk never
        fails the served step."""
        with self._meta_lock:
            meta = self._session_meta.setdefault(session_id, {"step_index": 0})
            if result.get("session_started"):
                meta["step_index"] = 0
            meta["step_index"] = int(meta["step_index"]) + 1
            instruction = obs.get("instruction")
            if isinstance(instruction, str) and instruction:
                meta["instruction"] = instruction
            steps = meta["step_index"]
        if self.snapshot_ring is not None and steps % self.snapshot_every == 0:
            try:
                self.snapshot_ring.save(self._build_snapshot(session_id))
            except Exception:  # noqa: BLE001 - durability is advisory
                pass

    def _build_snapshot(self, session_id: str) -> Dict[str, Any]:
        """The wire snapshot: the engine's rolling state (and cache) with
        the schema, step counter, checkpoint generation, window length and
        the instruction with its cached embedding."""
        base = self.engine.export_session(session_id)
        with self._meta_lock:
            meta = dict(self._session_meta.get(session_id, {}))
        snapshot: Dict[str, Any] = {
            "version": migrate.SNAPSHOT_VERSION,
            "session_id": session_id,
            "step_index": int(meta.get("step_index", 0)),
            "checkpoint_generation": self.checkpoint_generation,
            "window": self.engine.window,
            "cached_inference": bool(base["cached_inference"]),
            "schema": [[name, list(shape), dtype] for name, shape, dtype in base["schema"]],
            "state": migrate.encode_state(base["state"]),
        }
        instruction = meta.get("instruction")
        if instruction:
            snapshot["instruction"] = instruction
            cached = self.engine.cached_embedding(instruction)
            if cached is not None:
                snapshot["embedding"] = [float(x) for x in cached]
        return snapshot

    def export_session(self, session_id: str) -> Dict[str, Any]:
        """POST /session/export: snapshot the session. Pure read; it keeps
        serving here."""
        snapshot = self._build_snapshot(session_id)
        with self._meta_lock:
            self.migration_exports += 1
        return snapshot

    def import_session(self, snapshot: Dict[str, Any], session_id: Optional[str] = None,
                       _count: bool = True) -> Dict[str, Any]:
        """POST /session/import: check a wire snapshot against this
        replica's generation, window, mode and schema, then write it into a
        slot. Refusals raise `SnapshotCompatibilityError` (HTTP 409).
        `_count=False` is the ring restore, counted as a restore."""
        try:
            migrate.check_compatibility(
                snapshot,
                checkpoint_generation=self.checkpoint_generation,
                window=self.engine.window,
                cached_inference=self.engine.cached_inference,
                schema=self.engine.state_schema(),
            )
            state = migrate.decode_state(snapshot["state"])
            slot = self.engine.import_session(
                {"session_id": snapshot["session_id"], "state": state}, session_id=session_id)
        except Exception:
            if _count:
                with self._meta_lock:
                    self.migration_import_failures += 1
            raise
        sid = session_id or str(snapshot["session_id"])
        instruction = snapshot.get("instruction")
        if instruction and snapshot.get("embedding") is not None:
            self.engine.seed_embedding(instruction, snapshot["embedding"])
        step_index = int(snapshot.get("step_index", 0))
        with self._meta_lock:
            meta = self._session_meta.setdefault(sid, {"step_index": 0})
            meta["step_index"] = step_index
            if instruction:
                meta["instruction"] = instruction
            if _count:
                self.migration_imports += 1
        return {"session_id": sid, "slot": int(slot), "step_index": step_index}

    def maybe_restore_session(self, session_id: str) -> Optional[Dict[str, Any]]:
        """On `/act` for a session this replica does not hold: restore its
        ring snapshot if one is there and young enough. Returns the reply
        fields to merge, or None for a fresh window."""
        ring = self.snapshot_ring
        if ring is None or session_id in self.engine.session_ids():
            return None
        loaded = ring.load(session_id)
        if loaded is None:
            return None
        snapshot, age_s = loaded
        try:
            faults.maybe_fail("session_restore", what=session_id)
            if age_s is not None and age_s > self.snapshot_max_age_s:
                raise migrate.SnapshotCompatibilityError(
                    f"session snapshot for {session_id!r} is {age_s:.1f}s old, past the "
                    f"{self.snapshot_max_age_s:.1f}s bound")
            result = self.import_session(snapshot, session_id=session_id, _count=False)
        except Exception:  # noqa: BLE001 - fall back to a fresh window
            with self._meta_lock:
                self.migration_restore_failures += 1
            ring.drop(session_id)
            return None
        with self._meta_lock:
            self.migration_restores += 1
        out: Dict[str, Any] = {"session_restored": True,
                               "step_index_restored": result["step_index"]}
        if age_s is not None:
            out["snapshot_age_s"] = round(float(age_s), 3)
        return out

    def reload(self, step: Optional[int] = None) -> Dict[str, Any]:
        """Zero-downtime weight swap: `reload_fn` restores the f32 masters
        on the host, the engine validates, prepares and swaps them between
        two batches. `/readyz` says `reloading` meanwhile; one at a time."""
        if self._reload_fn is None:
            raise RequestError("this replica has no reload source (pass reload_fn= to ServeApp)")
        if not self._reload_lock.acquire(blocking=False):
            raise ReloadInProgressError("a checkpoint reload is already in progress")
        try:
            self.reloading = True
            variables, restored_step = self._reload_fn(step)
            info = self.engine.swap_variables(variables)
            self.metrics.observe_reload()
            if restored_step is not None:
                # New weights, new generation: a snapshot exported under the
                # old one is refused by name.
                self.checkpoint_generation = int(restored_step)
            return {"ok": True, "checkpoint_step": restored_step,
                    "reloads_total": self.engine.reloads, **info}
        finally:
            self.reloading = False
            self._reload_lock.release()

    def drain(self, timeout: float = 30.0) -> None:
        """Reject new work and flush everything admitted."""
        with self._admit_lock:
            self.draining = True
            self.ready = False
        if self._loop_thread.is_alive():
            asyncio.run_coroutine_threadsafe(self.batcher.drain(), self._loop).result(timeout=timeout)
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._loop_thread.join(timeout=timeout)
        if self.capture is not None:
            # Sessions cut off by shutdown are still served data: write
            # them (outcome "drain") before the process exits.
            self.capture.drain()
        if self.exemplar_path and len(self.exemplars):
            try:
                self.exemplars.dump(self.exemplar_path, reason="drain")
            except OSError:
                pass  # exit path: a full disk must not block the drain

    def healthz(self) -> Dict[str, Any]:
        return {
            "status": "draining" if self.draining else "ok",
            "image_shape": list(self.image_shape),
            "embed_dim": self.embed_dim,
            "max_sessions": self.engine.max_sessions,
            "active_sessions": self.engine.active_sessions,
            "compile_count": self.engine.compile_count,
            "window": self.engine.window,
            "scheduler": self.scheduler,
            "buckets": [int(b) for b in self.engine.buckets],
            "device": str(self.engine.device),
            "dtype": self.engine.dtype,
            "replica_id": self.replica_id,
            "reloads": self.engine.reloads,
            "inference_dtype": self.engine.inference_dtype,
            "cached_inference": self.engine.cached_inference,
            "checkpoint_generation": self.checkpoint_generation,
            "session_snapshots": self.snapshot_ring is not None,
            # The batcher's settings (`--max_batch` ... `--request_timeout_s`).
            "batcher": {
                "max_batch": self.max_batch,
                "max_delay_s": self.max_delay_s,
                "max_queue": self.max_queue,
                "pipeline_depth": self.pipeline_depth,
                "request_timeout_s": self.request_timeout_s,
            },
        }

    def readyz(self) -> Tuple[int, Dict[str, Any]]:
        if self.draining:
            return 503, {"ready": False, "reason": "draining"}
        if self.reloading:
            return 503, {"ready": False, "reason": "reloading"}
        if not self.ready:
            return 503, {"ready": False, "reason": "warming"}
        return 200, {"ready": True}

    def _engine_gauges(self) -> Dict[str, Any]:
        return dict(
            active_sessions=self.engine.active_sessions,
            compile_count=self.engine.compile_count,
            bucket_count=len(self.engine.buckets),
            embed_cache_misses=self.engine.embed_calls,
            session_evictions=self.engine.evictions,
            slow_exemplars=len(self.exemplars),
            draining=int(self.draining),
            ready=int(self.ready),
            engine_steps_total=self.engine.steps_total,
            attention_launches_total=fused_attention.launches,
            attention_launches_tensor_core_total=fused_attention.launches_by_variant["tensor_core"],
            attention_launches_tf32x3_total=fused_attention.launches_by_variant["tf32x3"],
            attention_launches_simple_total=fused_attention.launches_by_variant["simple"],
            decoder_layers=self.engine.policy.num_layers,
            device=str(self.engine.device),
            dtype=self.engine.dtype,
            reloading=int(self.reloading),
            replica_id=self.replica_id,
            inference_dtype=self.engine.inference_dtype,
            param_bytes_device=self.engine.serving_param_bytes,
            param_bytes_master=self.engine.master_param_bytes,
            cache_enabled=int(self.engine.cached_inference),
            cache_bytes_per_slot=self.engine.cache_bytes_per_slot,
            cache_cached_steps_total=self.engine.cache_cached_steps,
            cache_rebuild_steps_total=self.engine.cache_rebuild_steps,
            cache_invalidations=dict(self.engine.cache_invalidations),
            migration_exports_total=self.migration_exports,
            migration_imports_total=self.migration_imports,
            migration_import_failures_total=self.migration_import_failures,
            migration_restores_total=self.migration_restores,
            migration_restore_failures_total=self.migration_restore_failures,
            # Flywheel capture gauges (rt1_serve_capture_*): the enabled
            # flag is always present so dashboards tell "off" from "zero".
            **(self.capture.stats() if self.capture is not None else {"capture_enabled": 0}),
        )

    def metrics_snapshot(self) -> Dict[str, Any]:
        return self.metrics.snapshot(**self._engine_gauges())

    def metrics_prometheus(self) -> str:
        """The same numbers as Prometheus exposition text."""
        return self.metrics.prometheus_text(**self._engine_gauges())


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    app: ServeApp = None  # bound by make_server

    quiet: bool = True

    def log_message(self, fmt, *args):  # noqa: D102 - stdlib hook
        if not self.quiet:
            super().log_message(fmt, *args)

    def _reply(self, code: int, payload: Dict[str, Any]) -> None:
        body = json.dumps(payload).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_text(self, code: int, text: str, content_type: str) -> None:
        body = text.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_json(self) -> Dict[str, Any]:
        length = int(self.headers.get("Content-Length", 0))
        if length <= 0:
            raise RequestError("missing request body")
        try:
            payload = json.loads(self.rfile.read(length))
        except json.JSONDecodeError as exc:
            raise RequestError(f"invalid JSON body: {exc}") from exc
        if not isinstance(payload, dict):
            raise RequestError("request body must be a JSON object")
        return payload

    def do_GET(self):  # noqa: N802 - stdlib casing
        if self.path == "/healthz":
            self._reply(200, self.app.healthz())
        elif self.path == "/readyz":
            self._reply(*self.app.readyz())
        elif self.path == "/metrics":
            # JSON by default; a Prometheus scraper's Accept header gets text.
            if obs_prometheus.accepts_text(self.headers.get("Accept")):
                self._reply_text(200, self.app.metrics_prometheus(), obs_prometheus.CONTENT_TYPE)
            else:
                self._reply(200, self.app.metrics_snapshot())
        elif self.path == "/slow_requests":
            self._reply(200, {**self.app.exemplars.stats(),
                              "slow_requests": self.app.exemplars.snapshot()})
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):  # noqa: N802 - stdlib casing
        try:
            payload = self._read_json()
        except RequestError as exc:
            self._reply(400, {"error": str(exc)})
            return
        if self.path == "/act":
            self._act(payload)
        elif self.path == "/reset":
            self._session_op(payload, self.app.reset, "slot", count_reset=True)
        elif self.path == "/release":
            keep = bool(payload.get("keep_snapshot"))
            self._session_op(payload, lambda sid: self.app.release(sid, keep_snapshot=keep), None)
        elif self.path == "/reload":
            self._reload(payload)
        elif self.path == "/session/export":
            self._session_export(payload)
        elif self.path == "/session/import":
            self._session_import(payload)
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def _reload(self, payload):
        step = payload.get("step")
        if step is not None and (not isinstance(step, int) or isinstance(step, bool)):
            self._reply(400, {"error": "'step' must be an integer"})
            return
        try:
            self._reply(200, self.app.reload(step))
        except RequestError as exc:
            self._reply(400, {"error": str(exc)})
        except ReloadInProgressError as exc:
            self._reply(409, {"error": str(exc), "retry": True})
        except Exception as exc:  # noqa: BLE001 - the old weights still serve
            self._reply(500, {"error": f"reload failed: {exc}"})

    def _session_export(self, payload):
        try:
            snapshot = self.app.export_session(self._session_id(payload))
        except RequestError as exc:
            self._reply(400, {"error": str(exc)})
            return
        except SessionError as exc:
            self._reply(404, {"error": str(exc)})
            return
        except Exception as exc:  # noqa: BLE001 - report, keep serving
            self._reply(500, {"error": f"export failed: {exc}"})
            return
        self._reply(200, {"ok": True, "snapshot": snapshot})

    def _session_import(self, payload):
        snapshot = payload.get("snapshot")
        session_id = payload.get("session_id")
        if not isinstance(snapshot, dict):
            self._reply(400, {"error": "'snapshot' must be a JSON object"})
            return
        if session_id is not None and (not isinstance(session_id, str) or not session_id):
            self._reply(400, {"error": "'session_id' must be a non-empty string when given"})
            return
        try:
            result = self.app.import_session(snapshot, session_id=session_id)
        except migrate.SnapshotCompatibilityError as exc:
            # A ValueError too, but a conflict with this replica, not a
            # malformed request.
            self._reply(409, {"error": str(exc)})
            return
        except SlotContentionError as exc:
            self._reply(503, {"error": str(exc), "retry": True})
            return
        except (RequestError, SessionError, ValueError) as exc:
            self._reply(400, {"error": str(exc)})
            return
        except Exception as exc:  # noqa: BLE001 - report, keep serving
            self._reply(500, {"error": f"import failed: {exc}"})
            return
        self._reply(200, {"ok": True, **result})

    @staticmethod
    def _session_id(payload) -> str:
        session_id = payload.get("session_id")
        if not isinstance(session_id, str) or not session_id:
            raise RequestError("'session_id' must be a non-empty string")
        return session_id

    def _session_op(self, payload, op, result_key, count_reset=False):
        try:
            value = op(self._session_id(payload))
        except RequestError as exc:
            self._reply(400, {"error": str(exc)})
            return
        except SlotContentionError as exc:
            self._reply(503, {"error": str(exc), "retry": True})
            return
        except SessionError as exc:
            self._reply(404, {"error": str(exc)})
            return
        out = {"ok": True}
        if result_key is not None:
            out[result_key] = value
        if count_reset:
            self.app.metrics.observe_reset()
        self._reply(200, out)

    def _fail_act(self, code, phases, session_id, t0, outcome, body):
        """One exit for every non-200 /act: metrics, the exemplar ring
        (failures are the exemplars a post-mortem wants) and the request
        id echoed so the client can quote it."""
        if outcome == "failed":
            self.app.metrics.observe_request(time.perf_counter() - t0, ok=False)
        body["request_id"] = phases.request_id
        self.app.exemplars.offer(
            (obs_trace.now_us() - phases.t_admit) / 1e3,
            request_id=phases.request_id, session=session_id, outcome=outcome,
            error=body.get("error"), phases=phases.phases_ms(),
        )
        self._reply(code, body)

    def _act(self, payload):
        phases = reqtrace.RequestPhases(reqtrace.request_id_from(self.headers, payload))
        t0 = time.perf_counter()
        if self.app.draining:
            self._fail_act(503, phases, payload.get("session_id"), t0, "rejected",
                           {"error": "draining"})
            return
        session_id = None
        with obs_trace.span("replica_act", request_id=phases.request_id,
                            replica=self.app.replica_id):
            try:
                session_id = self._session_id(payload)
                obs = parse_observation(payload, self.app.image_shape, self.app.embed_dim)
                task = payload.get("task")
                result = self.app.act(session_id, obs, phases,
                                      task=task if isinstance(task, str) else None)
            except RequestError as exc:
                self._fail_act(400, phases, session_id, t0, "failed", {"error": str(exc)})
                return
            except (BusyError, SlotContentionError):
                self._fail_act(503, phases, session_id, t0, "rejected",
                               {"error": "busy", "retry": True})
                return
            except DrainingError:
                self._fail_act(503, phases, session_id, t0, "rejected", {"error": "draining"})
                return
            except concurrent.futures.TimeoutError:
                self._fail_act(504, phases, session_id, t0, "failed",
                               {"error": "request timed out in the server"})
                return
            except (SessionError, ValueError, KeyError) as exc:
                self._fail_act(400, phases, session_id, t0, "failed", {"error": str(exc)})
                return
            except Exception as exc:  # noqa: BLE001 - last-resort HTTP 500
                self._fail_act(500, phases, session_id, t0, "failed",
                               {"error": f"internal error: {exc}"})
                return
        self.app.metrics.observe_request(time.perf_counter() - t0)
        phases.t_done = obs_trace.now_us()
        phases.emit_trace(session_id)
        breakdown = phases.phases_ms()
        self.app.exemplars.offer(breakdown["total_ms"], request_id=phases.request_id,
                                 session=session_id, outcome="ok", phases=breakdown)
        out = {
            "action": [float(x) for x in result["action"]],
            "action_tokens": [int(x) for x in result["action_tokens"]],
            "session_started": result.get("session_started", False),
            "request_id": phases.request_id,
        }
        if payload.get(reqtrace.DEBUG_KEY):
            out["phases"] = breakdown
        if "terminate_episode" in result:
            out["terminate_episode"] = result["terminate_episode"]
        if result.get("session_restored"):
            out["session_restored"] = True
            if "snapshot_age_s" in result:
                out["snapshot_age_s"] = result["snapshot_age_s"]
        self._reply(200, out)


def make_server(app: ServeApp, host: str = "127.0.0.1", port: int = 0,
                quiet: bool = True) -> HTTPServer:
    """Bind an `httpd.HTTPServer` to `app` (port 0 = ephemeral); `quiet`
    False logs a line per request to stderr."""
    handler = type("BoundHandler", (_Handler,), {"app": app, "quiet": quiet})
    httpd = HTTPServer((host, port), handler)
    return httpd


def install_signal_handlers(app: ServeApp, httpd: HTTPServer) -> None:
    """SIGTERM/SIGINT -> drain accepted requests, then stop the server."""

    def _shutdown(signum, frame):  # noqa: ARG001 - signal signature
        def _run():
            app.drain()
            httpd.shutdown()

        threading.Thread(target=_run, name="rt1-serve-drain").start()

    signal.signal(signal.SIGTERM, _shutdown)
    signal.signal(signal.SIGINT, _shutdown)
