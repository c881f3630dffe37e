"""Chrome-trace-event span recorder: one host-side timeline across threads.

The port's copy of `rt1_tpu/obs/trace.py` (the port imports nothing of the JAX
package); it keeps the JAX module's names, wire format and behaviour.

A device profiler's trace shows device ops but are blind to the
host threads that feed them — the train loop, the `SampleAheadFeeder`
workers, the serve micro-batcher all spend wall time the device profiler
cannot attribute. This module records *host* spans from any thread into one
in-memory ring and serializes them as Chrome trace events (the
`{"traceEvents": [...]}` JSON that `chrome://tracing` and Perfetto load
directly), so a single file shows the feeder assembling batch N+2 while
the train loop blocks on batch N's H2D.

Design constraints, in order:

1. ~zero cost when disabled. Instrumented hot paths (`feeder._worker`
   assembles a batch in under a millisecond) call `span(...)` per
   iteration; when no recorder is installed that must be one global read
   and one shared no-op context manager — no allocation, no lock.
2. Thread-safe when enabled. Events land on a `collections.deque`, whose
   `append` is atomic under the GIL; the only lock guards the
   first-event-per-thread name registration.
3. Bounded. The deque is a ring (`max_events`): a week-long run with
   tracing left on keeps the most recent window instead of eating the
   host's RAM. Dropped-event count is reported in the dump's metadata.

Usage:

    from rt1_tpu_torch.obs import trace
    trace.enable("/tmp/run/trace.json")   # or enable(None) + dump(path)
    with trace.span("assemble", ticket=7):
        ...
    trace.counter("feeder_queue_depth", depth)
    trace.dump()                          # writes the JSON, keeps recording

`enable()` is idempotent and returns the live recorder; `disable()`
uninstalls (a final `dump()` happens automatically if a path was given).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

# Perf-counter origin shared by every event so spans from different threads
# line up on one clock. Chrome trace timestamps are microseconds.
_EPOCH = time.perf_counter()


def _now_us() -> float:
    return (time.perf_counter() - _EPOCH) * 1e6


def now_us() -> float:
    """Current time on the trace clock (µs since the process epoch) —
    capture one of these per phase boundary, then emit with `complete`.
    Valid whether or not a recorder is installed, so phase stamping can
    be unconditional while emission stays gated."""
    return _now_us()


class _NullSpan:
    """Shared no-op context manager: the disabled-tracer fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span; records a complete ("X") event on exit."""

    __slots__ = ("_recorder", "_name", "_args", "_t0")

    def __init__(self, recorder: "TraceRecorder", name: str, args):
        self._recorder = recorder
        self._name = name
        self._args = args
        self._t0 = _now_us()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._recorder._complete(self._name, self._t0, _now_us() - self._t0,
                                 self._args)
        return False


class TraceRecorder:
    """Thread-safe in-memory trace-event ring."""

    def __init__(self, path: Optional[str] = None, max_events: int = 200_000):
        self.path = path
        self._events: collections.deque = collections.deque(
            maxlen=max(int(max_events), 1)
        )
        self._pid = os.getpid()
        self._meta_lock = threading.Lock()
        self._named_tids: set = set()
        self._meta_events: List[Dict[str, Any]] = []
        self._appended = 0

    # ------------------------------------------------------------ recording

    def _tid(self) -> int:
        t = threading.current_thread()
        tid = t.ident or 0
        if tid not in self._named_tids:
            with self._meta_lock:
                if tid not in self._named_tids:
                    self._named_tids.add(tid)
                    # Thread-name metadata events make Perfetto label the
                    # track "rt1-feeder-0" instead of a bare ident.
                    self._meta_events.append(
                        {
                            "ph": "M",
                            "name": "thread_name",
                            "pid": self._pid,
                            "tid": tid,
                            "args": {"name": t.name},
                        }
                    )
        return tid

    def _append(self, event: Dict[str, Any]) -> None:
        self._appended += 1
        self._events.append(event)

    def _complete(self, name: str, ts_us: float, dur_us: float, args) -> None:
        event = {
            "ph": "X",
            "name": name,
            "pid": self._pid,
            "tid": self._tid(),
            "ts": ts_us,
            "dur": dur_us,
        }
        if args:
            event["args"] = args
        self._append(event)

    def span(self, name: str, **args) -> _Span:
        return _Span(self, name, args or None)

    def complete(self, name: str, ts_us: float, dur_us: float, **args) -> None:
        """Record a complete event from explicit timestamps (`now_us()`
        clock). This is how cross-thread phases become spans: `span()`
        times the current thread's with-block, but a request's queue wait
        starts on an HTTP handler thread and ends on the batcher loop —
        the waiter stamps both ends and emits the span after the fact."""
        self._complete(name, ts_us, max(dur_us, 0.0), args or None)

    def instant(self, name: str, **args) -> None:
        """Point-in-time marker (thread-scoped)."""
        event = {
            "ph": "i",
            "s": "t",
            "name": name,
            "pid": self._pid,
            "tid": self._tid(),
            "ts": _now_us(),
        }
        if args:
            event["args"] = args
        self._append(event)

    def counter(self, name: str, value: float, **series) -> None:
        """Counter track (queue depths, gauge time-series)."""
        self._append(
            {
                "ph": "C",
                "name": name,
                "pid": self._pid,
                "tid": 0,
                "ts": _now_us(),
                "args": series if series else {"value": value},
            }
        )

    # ------------------------------------------------------------ reporting

    @property
    def dropped(self) -> int:
        return self._appended - len(self._events)

    def to_dict(self) -> Dict[str, Any]:
        """Chrome trace JSON object (snapshot; recording may continue)."""
        with self._meta_lock:
            meta = list(self._meta_events)
        return {
            "traceEvents": meta + list(self._events),
            "displayTimeUnit": "ms",
            "otherData": {
                "producer": "rt1_tpu_torch.obs.trace",
                "dropped_events": self.dropped,
            },
        }

    def dump(self, path: Optional[str] = None) -> str:
        """Write the trace JSON; returns the path written."""
        path = path or self.path
        if not path:
            raise ValueError("no dump path: pass one or construct with path=")
        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f)
        os.replace(tmp, path)
        return path


# ---------------------------------------------------------------- module API
#
# One process-wide recorder keeps the call sites dependency-free: the feeder
# and batcher just call `trace.span(...)` and stay no-ops until something
# (train loop, bench --trace, a test) installs a recorder.

_tracer: Optional[TraceRecorder] = None


def enable(
    path: Optional[str] = None, max_events: Optional[int] = None
) -> TraceRecorder:
    """Install (or return the already-installed) process-wide recorder.

    Explicit arguments win even when a recorder already exists (a stale
    recorder from an aborted run must not silently hijack the new run's
    dump path or ring size); existing events are preserved across a
    resize. Omitted arguments keep whatever is installed (new recorders
    default to 200k events).
    """
    global _tracer
    if _tracer is None:
        _tracer = TraceRecorder(
            path=path,
            max_events=200_000 if max_events is None else max_events,
        )
        return _tracer
    if path:
        _tracer.path = path
    if max_events is not None and max_events != _tracer._events.maxlen:
        _tracer._events = collections.deque(
            _tracer._events, maxlen=max(int(max_events), 1)
        )
    return _tracer


def disable() -> None:
    """Uninstall; dumps first when the recorder was given a path."""
    global _tracer
    t, _tracer = _tracer, None
    if t is not None and t.path:
        t.dump()


def active() -> Optional[TraceRecorder]:
    return _tracer


def enabled() -> bool:
    return _tracer is not None


def span(name: str, **args):
    """Context manager timing one span on the current thread.

    The disabled path is one global load + returning a shared no-op object;
    keyword construction is the only per-call cost left to the caller.
    """
    t = _tracer
    if t is None:
        return _NULL_SPAN
    return t.span(name, **args)


def instant(name: str, **args) -> None:
    t = _tracer
    if t is not None:
        t.instant(name, **args)


def complete(name: str, ts_us: float, dur_us: float, **args) -> None:
    """Record a complete event from explicit `now_us()` timestamps
    (no-op when disabled) — the cross-thread span path; see
    `TraceRecorder.complete`."""
    t = _tracer
    if t is not None:
        t.complete(name, ts_us, dur_us, **args)


def counter(name: str, value: float = 0.0, **series) -> None:
    t = _tracer
    if t is not None:
        t.counter(name, value, **series)


def dump(path: Optional[str] = None) -> Optional[str]:
    """Dump the active recorder (no-op when disabled); returns the path."""
    t = _tracer
    if t is None:
        return None
    return t.dump(path)
