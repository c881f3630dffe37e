"""Per-step wall-time attribution for the train loop.

The port's copy of `rt1_tpu/obs/steps.py` (the port imports nothing of the
JAX package): the same buckets, records and scalars. `StepTimeline`
attributes the production loop's own wall time by bucketing each step:

* ``wait_data``   — blocked pulling the next host batch (feeder queue,
                    loader, or drawing a synthetic batch); accrued by
                    wrapping the host iterator with
                    :meth:`StepTimeline.timed`.
* ``h2d``         — staging the batch and enqueueing its copy to the card
                    (`device_feeder`), i.e. time in ``next(dev_iter)``
                    *minus* the inner ``wait_data``.
* ``device_step`` — the train step call. CUDA launches are asynchronous, so by
                    default this is host dispatch time and the device's
                    actual execution hides inside the *next* step's
                    ``wait_data``/``h2d`` (the queues only back up when the
                    device is the bottleneck). With ``sync=True`` the
                    timeline blocks on a step output and the bucket is the
                    true device latency (a synchronize of the loss
                    tensor's device) — exact attribution for one extra
                    sync per step (use for diagnosis, not for the headline
                    run).
* ``host``        — the residual: logging, checkpoint scheduling, Python.

The rolling window turns these into the production `stall_pct` gauge —
``(wait_data + h2d) / total`` over the last N steps — written through the
loop's metric writer (`scalars()`).

Single-consumer by design: all methods are called from the train loop's
thread (the timed iterator is pulled from inside ``next(dev_iter)`` on
that same thread). Feeder workers report through `obs.trace` spans and the
feeder's own stats, not through this object.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Any, Dict, Iterator, Optional

from rt1_tpu_torch.obs import trace

BUCKETS = ("wait_data", "h2d", "device_step", "host")


class StepTimeline:
    """Attributes each step's wall time into `BUCKETS` + rolling stall%."""

    def __init__(self, window: int = 50, sync: bool = False):
        if window <= 0:
            raise ValueError(f"window must be positive, got {window}")
        self.window = window
        self.sync = sync
        self._records: collections.deque = collections.deque(maxlen=window)
        # Recording is single-consumer, but the rolling window is READ from
        # other threads (the train-side Prometheus listener renders
        # scalars() on the scraper's thread) — guard the deque, or a scrape
        # landing mid-append raises "deque mutated during iteration".
        self._records_lock = threading.Lock()
        self._steps_seen = 0
        # Bucket time accrued while no step is open (prefetch warm-up pulls
        # before the loop's first start_step) is credited to the next step.
        self._orphan: Dict[str, float] = {}
        self._cur: Optional[Dict[str, float]] = None
        self._cur_step = -1
        self._t0 = 0.0
        self._step_span = None

    # ------------------------------------------------------------ recording

    def timed(self, iterator: Iterator, bucket: str = "wait_data") -> Iterator:
        """Wrap a host iterator so time blocked in ``next()`` accrues to
        `bucket` (of the step open at the moment of the pull)."""

        def _gen():
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(iterator)
                except StopIteration:
                    return
                self._add(bucket, time.perf_counter() - t0)
                yield item

        return _gen()

    def _add(self, bucket: str, seconds: float) -> None:
        target = self._cur if self._cur is not None else self._orphan
        target[bucket] = target.get(bucket, 0.0) + seconds

    def start_step(self, step: int) -> None:
        self._cur = dict(self._orphan)
        self._orphan = {}
        self._cur_step = step
        self._t0 = time.perf_counter()
        self._step_span = trace.span("train_step", step=step)
        self._step_span.__enter__()

    @contextlib.contextmanager
    def phase(self, bucket: str, exclusive_of: Optional[str] = None):
        """Time a block into `bucket`; with `exclusive_of`, time accrued to
        that other bucket during the block is subtracted (e.g. the `h2d`
        phase wraps ``next(dev_iter)``, whose inner host-iterator pull
        already accrued to ``wait_data``). Outside an open step (e.g. a
        checkpoint save between steps) the time folds into the next step's
        bucket via the orphan dict."""
        cur = self._cur if self._cur is not None else self._orphan
        inner0 = cur.get(exclusive_of, 0.0) if exclusive_of else 0.0
        t0 = time.perf_counter()
        with trace.span(bucket):
            yield
        dt = time.perf_counter() - t0
        if exclusive_of:
            dt -= cur.get(exclusive_of, 0.0) - inner0
        cur[bucket] = cur.get(bucket, 0.0) + max(dt, 0.0)

    def end_step(self, sync_on: Any = None) -> Dict[str, float]:
        """Close the open step; returns its record (ms buckets + stall).

        `sync_on`: a step output (e.g. the loss tensor) whose device is
        synchronized when `sync=True`, charging true device latency to
        ``device_step`` (a CPU tensor is ready already).
        """
        if self._cur is None:
            raise RuntimeError("end_step without start_step")
        if self.sync and sync_on is not None:
            t0 = time.perf_counter()
            with trace.span("device_sync"):
                if getattr(sync_on, "is_cuda", False):
                    import torch

                    torch.cuda.synchronize(sync_on.device)
            self._add("device_step", time.perf_counter() - t0)
        total = time.perf_counter() - self._t0
        cur, self._cur = self._cur, None
        if self._step_span is not None:
            self._step_span.__exit__(None, None, None)
            self._step_span = None
        buckets = {b: cur.get(b, 0.0) for b in BUCKETS}
        buckets["host"] += max(
            0.0, total - sum(cur.get(b, 0.0) for b in BUCKETS)
        )
        input_s = buckets["wait_data"] + buckets["h2d"]
        record = {
            "step": self._cur_step,
            "total_ms": total * 1e3,
            "stall_pct": (input_s / total * 100.0) if total > 0 else 0.0,
        }
        for b in BUCKETS:
            record[f"{b}_ms"] = buckets[b] * 1e3
        with self._records_lock:
            self._records.append(record)
            self._steps_seen += 1
        trace.counter("stall_pct", record["stall_pct"])
        return record

    # ------------------------------------------------------------ reporting

    @staticmethod
    def _stall(records) -> float:
        total = sum(r["total_ms"] for r in records)
        if total <= 0:
            return 0.0
        stalled = sum(r["wait_data_ms"] + r["h2d_ms"] for r in records)
        return stalled / total * 100.0

    @property
    def stall_pct(self) -> float:
        """Rolling input-stall%: input-bound time over total, last N steps."""
        with self._records_lock:
            return self._stall(list(self._records))

    def last(self) -> Optional[Dict[str, float]]:
        with self._records_lock:
            return self._records[-1] if self._records else None

    def scalars(self, prefix: str = "timing/") -> Dict[str, float]:
        """Rolling means for the metric writer.
        Thread-safe: also rendered by the scrape listener's handler."""
        with self._records_lock:
            records = list(self._records)
        n = len(records)
        if n == 0:
            return {}
        out = {"stall_pct": self._stall(records)}
        for key in ("total_ms", *(f"{b}_ms" for b in BUCKETS)):
            out[f"{prefix}{key}"] = sum(r[key] for r in records) / n
        return out
