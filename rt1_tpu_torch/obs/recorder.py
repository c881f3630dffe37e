"""Flight recorder and slow-request exemplar ring: the port's copy of
`rt1_tpu/obs/recorder.py` (the port imports nothing of the JAX package).

`FlightRecorder` keeps the last N per-step records of a training run (loss
at log steps, timing buckets from `StepTimeline`, feeder queue depths,
guard and retry counters) in a bounded deque and writes them as JSONL only
when something goes wrong (an unhandled exception in the guarded block, a
SIGTERM, a preemption), so the post-mortem has the seconds *before* the
failure at per-step resolution, for the cost of one dict append per step.
The dump's header carries `torch.cuda.memory_stats()` of the card.

The dump is JSONL (one record per line, header line first) rather than a
JSON array so a truncated dump — the disk was full, the kill was -9 after
all — still parses line by line.

Stdlib only at import: the serve fleet's router and stub replica import
`ExemplarRing` and must not import torch.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import signal
import sys
import threading
import time
from typing import Any, Dict, List, Optional


def device_memory_stats() -> Dict[str, Any]:
    """`torch.cuda.memory_stats()` of each card this process has touched,
    keyed ``cuda:<index>``, or {} where there is none (a CPU run, or a
    process that never imported torch). Never initialises CUDA."""
    torch = sys.modules.get("torch")
    try:
        if torch is None or not torch.cuda.is_initialized():
            return {}
        out = {}
        for index in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(index)
            if stats:
                out[f"cuda:{index}"] = {k: int(v) for k, v in stats.items()}
        return out
    except Exception:  # noqa: BLE001 - observability must not take down train
        return {}


def _jsonable(value: Any) -> Any:
    """Coerce numpy/torch scalars so records never poison the dump."""
    if isinstance(value, (str, bool, int, float)) or value is None:
        return value
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    try:
        return float(value)
    except (TypeError, ValueError):
        return repr(value)


class FlightRecorder:
    """Bounded ring of step records + crash/SIGTERM dump hooks."""

    def __init__(self, capacity: int = 256, path: Optional[str] = None):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = capacity
        self.path = path
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        # RLock, not Lock: the SIGTERM handler runs on the main thread
        # BETWEEN bytecodes — possibly inside record()'s critical section —
        # and dump() -> snapshot() re-acquires; a plain Lock self-deadlocks
        # exactly on the dump the handler exists to produce.
        self._lock = threading.RLock()
        self._recorded = 0
        self._dumped = False
        self._prev_sigterm = None

    # ------------------------------------------------------------ recording

    def record(self, step: int, **fields: Any) -> None:
        rec = {"step": int(step), "t": time.time()}
        for k, v in fields.items():
            rec[k] = _jsonable(v)
        with self._lock:
            self._recorded += 1
            self._ring.append(rec)

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # ------------------------------------------------------------- dumping

    def dump(self, path: Optional[str] = None, reason: str = "manual") -> str:
        """Write header + ring as JSONL; returns the path written."""
        path = path or self.path
        if not path:
            raise ValueError("no dump path: pass one or construct with path=")
        records = self.snapshot()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            f.write(
                json.dumps(
                    {
                        "flight_recorder": {
                            "reason": reason,
                            "dumped_at": time.time(),
                            "capacity": self.capacity,
                            "records": len(records),
                            "recorded_total": self._recorded,
                            "memory_stats": device_memory_stats(),
                        }
                    }
                )
                + "\n"
            )
            for rec in records:
                f.write(json.dumps(rec) + "\n")
        self._dumped = True
        return path

    @contextlib.contextmanager
    def dump_on_exception(self, path: Optional[str] = None):
        """Re-raises after dumping; KeyboardInterrupt/SystemExit included
        (they are exactly the post-mortems a long run cares about)."""
        try:
            yield self
        except BaseException as exc:
            try:
                self.dump(path, reason=f"exception:{type(exc).__name__}")
            except Exception:  # noqa: BLE001 - never mask the real failure
                pass
            raise

    # -------------------------------------------------------------- signals

    def install_sigterm(self, extra: Optional[Any] = None) -> bool:
        """Dump on SIGTERM, then chain to the previous handler (or re-raise
        the default so the exit code stays honest). Main-thread only —
        returns False (no-op) elsewhere, e.g. under pytest workers.

        `extra`: optional callable run (exception-guarded) after the dump
        and before chaining — the train loop passes the host tracer's dump
        here, because chaining to SIG_DFL kills the process before any
        normal-exit teardown could write the trace.
        """
        if threading.current_thread() is not threading.main_thread():
            return False

        def _handler(signum, frame):
            try:
                self.dump(reason="SIGTERM")
            except Exception:  # noqa: BLE001 - exit path
                pass
            if extra is not None:
                try:
                    extra()
                except Exception:  # noqa: BLE001 - exit path
                    pass
            prev = self._prev_sigterm
            if callable(prev):
                prev(signum, frame)
            elif prev is signal.SIG_IGN:
                # SIGTERM was deliberately ignored before we installed;
                # dumping must not turn an ignored signal into an exit.
                pass
            else:
                # SIG_DFL (or an unknown non-Python handler): keep the
                # default die-on-SIGTERM semantics and the honest exit code.
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                signal.raise_signal(signal.SIGTERM)

        self._prev_sigterm = signal.signal(signal.SIGTERM, _handler)
        return True

    def uninstall_sigterm(self) -> None:
        if self._prev_sigterm is not None:
            signal.signal(signal.SIGTERM, self._prev_sigterm)
            self._prev_sigterm = None


class ExemplarRing:
    """Bounded ring of slow-request exemplars — the serve-side flight
    recorder.

    The serving latency histogram says *that* p99 spiked; it cannot say
    *which* requests and *where inside the server* their time went. The
    ring keeps the most recent N requests whose total latency crossed
    ``threshold_ms`` (0 = keep everything, still bounded), each with its
    request id and per-phase breakdown, so a post-mortem names offenders
    instead of quantiles. Dumped as JSONL next to the flight record on
    replica drain/crash, served live on ``GET /slow_requests``, and
    aggregated fleet-wide by the router.
    """

    def __init__(self, capacity: int = 128, threshold_ms: float = 0.0):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = capacity
        self.threshold_ms = float(threshold_ms)
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._offered = 0
        self._kept = 0

    def offer(self, total_ms: float, **fields: Any) -> bool:
        """Record one finished request; kept past the threshold, and
        ALWAYS kept when ``outcome`` is present and not ``"ok"`` — a 1 ms
        503 storm is exactly the exemplar a post-mortem wants, and the
        threshold must not filter it. Returns whether it was kept (the
        caller's cost when not: one float compare)."""
        degraded = fields.get("outcome") not in (None, "ok")
        with self._lock:
            self._offered += 1
            if total_ms < self.threshold_ms and not degraded:
                return False
            self._kept += 1
            rec = {"total_ms": round(float(total_ms), 3), "t": time.time()}
            for k, v in fields.items():
                rec[k] = _jsonable(v)
            self._ring.append(rec)
            return True

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "capacity": self.capacity,
                "threshold_ms": self.threshold_ms,
                "offered": self._offered,
                "kept": self._kept,
                "retained": len(self._ring),
            }

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def dump(self, path: str, reason: str = "manual") -> str:
        """Header + exemplars as JSONL, one record per line, so a truncated
        dump still parses line by line."""
        records = self.snapshot()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            f.write(
                json.dumps(
                    {
                        "slow_requests": {
                            "reason": reason,
                            "dumped_at": time.time(),
                            **self.stats(),
                        }
                    }
                )
                + "\n"
            )
            for rec in records:
                f.write(json.dumps(rec) + "\n")
        return path


def _read_jsonl_dump(path: str, header_key: str) -> Dict[str, Any]:
    """{"header": ..., "records": [...]} of a JSONL dump whose first line
    holds `header_key`; a truncated final line (a write cut by a hard
    kill) ends the records."""
    header: Dict[str, Any] = {}
    records: List[Dict[str, Any]] = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                break
            if i == 0 and header_key in obj:
                header = obj[header_key]
            else:
                records.append(obj)
    return {"header": header, "records": records}


def read_exemplars(path: str) -> Dict[str, Any]:
    """An `ExemplarRing.dump` file -> {"header": ..., "records": [...]}."""
    return _read_jsonl_dump(path, "slow_requests")


def read_dump(path: str) -> Dict[str, Any]:
    """A `FlightRecorder.dump` file -> {"header": ..., "records": [...]}."""
    return _read_jsonl_dump(path, "flight_recorder")
