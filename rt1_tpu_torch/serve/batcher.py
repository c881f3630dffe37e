"""Async batching queues for the serving frontend (a copy of
`rt1_tpu/serve/batcher.py`, which the port does not import).

The closed-loop eval policy is batch-size-1 by construction (one env, 10 Hz);
a serving process instead sees many concurrent sessions whose `act` requests
arrive independently. Two schedulers share the admission/backpressure/drain
contract:

* `MicroBatcher` — the original **cycle** scheduler: hold each request
  briefly (up to `max_batch` requests or a `max_delay_s` deadline), hand
  the whole batch to `process_fn`, block until it completes, repeat. The
  device idles during every host phase, and a request that misses a batch
  waits a full cycle.
* `ContinuousBatcher` — the **rolling** scheduler (the Orca/vLLM
  continuous-batching shape, scaled to a fixed-slot policy engine): a
  batch dispatches the moment requests and a pipeline slot are available,
  with up to `pipeline_depth` batches in flight. While device step N runs,
  the batcher keeps admitting; any request present when a slot frees rides
  step N+1 immediately — no deadline wait at low occupancy (p50 = step
  time), and occupancy emerges naturally at high load because requests
  accumulate exactly while the device is busy. Per-key exclusion extends
  across in-flight batches: a key riding step N cannot join step N+1 until
  N's results land, preserving per-session FIFO under overlap.

  One anti-fragmentation refinement: closed-loop clients re-arrive in a
  burst right after their batch completes, and dispatching at the first
  arrival would shatter that burst into 1-2-request steps. The scheduler
  therefore coalesces toward **observed demand**: it tracks the distinct
  keys (sessions) seen in the last `demand_window_s` and holds a dispatch
  while fewer requests are eligible than that demand suggests. The hold
  is bounded by `coalesce_delay_s` when the device is idle, and by the
  in-flight step's completion when one is running (its riders rearrive
  at that moment and re-form the herd — capping that wait would
  re-fragment it). A lone client's demand is 1, so low-occupancy
  dispatch stays immediate; under steady 8-client load the target is 8
  and each step re-forms the full batch within the arrival jitter, not
  the deadline. Demand decays with the window, so a ramp-down pays at
  most a few bounded waits before the target follows.

Design points:

* **Bounded queue + explicit backpressure.** `submit` raises `BusyError`
  the moment the queue holds `max_queue` requests; the HTTP layer maps it
  to 503 so load sheds at admission instead of growing unbounded latency.
* **Per-key exclusion.** `batch_key` (the session id in production) keeps
  two requests for the same key out of one batch: a session's rolling
  network state must see its observations in order, one step at a time.
  The second request stays queued for the next flush; requests for other
  sessions may overtake it, but per-key FIFO order is preserved.
* **Drain, not abort.** `drain()` rejects new submissions (`DrainingError`)
  but flushes everything already admitted before returning — SIGTERM never
  drops an accepted request.

`process_fn` runs in a thread-pool executor (one worker for the cycle
scheduler, `pipeline_depth` for the continuous one) so the (blocking,
device-bound) batched step never stalls the event loop; requests keep
accumulating for the next batch while the current one computes.
"""

from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence


class BusyError(RuntimeError):
    """Queue is at `max_queue`; the caller should shed load (HTTP 503)."""


class DrainingError(RuntimeError):
    """The batcher is shutting down and no longer admits requests."""


class _BatcherBase:
    """Admission/backpressure/drain scaffolding shared by both
    schedulers: the bounded pending queue, `submit` (BusyError /
    DrainingError / cancelled-future semantics), executor lifecycle, and
    batch formation routed through one `_excluded` eligibility rule."""

    _WORKERS = 1

    def __init__(
        self,
        process_fn: Callable[[List[Any]], Sequence[Any]],
        *,
        max_batch: int = 8,
        max_queue: int = 64,
        batch_key: Optional[Callable[[Any], Any]] = None,
        metrics: Optional[Any] = None,
        on_batch: Optional[Callable[[List[Any]], None]] = None,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self._process_fn = process_fn
        self._max_batch = max_batch
        self._max_queue = max_queue
        self._batch_key = batch_key
        self._metrics = metrics
        # Called on the loop thread with each formed batch's items before
        # dispatch — the serve app stamps per-request "popped into a
        # batch" timestamps here (queue wait ends, batch formation
        # begins). Exceptions are the caller's bug; keep it trivial.
        self._on_batch = on_batch
        self._pending: collections.deque = collections.deque()
        self._draining = False
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._event: Optional[asyncio.Event] = None
        self._task: Optional[asyncio.Task] = None
        self._executor: Optional[concurrent.futures.ThreadPoolExecutor] = None

    # ------------------------------------------------------------ lifecycle

    async def start(self) -> None:
        """Bind to the running loop and start the scheduler."""
        if self._task is not None:
            raise RuntimeError(f"{type(self).__name__} already started")
        self._loop = asyncio.get_running_loop()
        self._event = asyncio.Event()
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=self._WORKERS, thread_name_prefix="rt1-serve-step"
        )
        self._task = self._loop.create_task(self._run())

    async def drain(self) -> None:
        """Stop admitting; flush every queued request (and, under the
        continuous scheduler, every batch in flight), then stop."""
        self._draining = True
        if self._event is not None:
            self._event.set()
        if self._task is not None:
            await self._task
            self._task = None
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None

    @property
    def draining(self) -> bool:
        return self._draining

    def on_each_worker(self, fn: Callable[[], Any]) -> None:
        """Run `fn` once on every executor worker thread and wait for all
        of them (call from outside the loop, after `start`). A barrier
        holds each job until all are running, so no thread takes two. The
        serving app warms per-thread device state this way."""
        barrier = threading.Barrier(self._WORKERS)

        def job():
            barrier.wait()
            fn()

        for future in [self._executor.submit(job) for _ in range(self._WORKERS)]:
            future.result()

    def qsize(self) -> int:
        return len(self._pending)

    # ------------------------------------------------------------ admission

    async def submit(self, item: Any) -> Any:
        """Queue one request; resolves with its element of `process_fn`'s
        result list. Raises `BusyError`/`DrainingError` at admission."""
        if self._draining:
            raise DrainingError("batcher is draining; not accepting requests")
        if self._task is None:
            raise RuntimeError(
                f"{type(self).__name__} not started (call start())"
            )
        if len(self._pending) >= self._max_queue:
            if self._metrics is not None:
                self._metrics.observe_rejected()
            raise BusyError(
                f"queue full ({self._max_queue} pending requests)"
            )
        self._note_submit(item)
        future = self._loop.create_future()
        self._pending.append((item, future))
        self._event.set()
        try:
            return await future
        except asyncio.CancelledError:
            # Abandoned caller (e.g. the HTTP bridge timed out and
            # cancelled us): cancel the queued request so _take_batch
            # drops it instead of stepping state for a dead client.
            future.cancel()
            raise

    def _note_submit(self, item: Any) -> None:
        """Subclass hook: bookkeeping per admitted request."""

    # ------------------------------------------------------------ formation

    def _excluded(self, item: Any, batch_keys: set) -> bool:
        """THE eligibility rule: an item cannot board when its key is
        already in the forming batch (a session's rolling state steps one
        obs at a time). The continuous scheduler extends it to keys
        riding in-flight batches."""
        if self._batch_key is None:
            return False
        return self._batch_key(item) in batch_keys

    def _take_batch(self) -> List[Any]:
        """Pop up to `max_batch` requests, skipping (not reordering
        within) `_excluded` ones — they wait for a later flush."""
        taken = []
        keys = set()
        i = 0
        while i < len(self._pending) and len(taken) < self._max_batch:
            item, future = self._pending[i]
            if future.done():  # cancelled by an abandoned submitter
                del self._pending[i]
                continue
            if self._excluded(item, keys):
                i += 1
                continue
            del self._pending[i]
            if self._batch_key is not None:
                keys.add(self._batch_key(item))
            taken.append((item, future))
        return taken

    async def _run(self) -> None:
        raise NotImplementedError


class MicroBatcher(_BatcherBase):
    """Collects concurrent requests into deadline- or size-triggered
    batches (the legacy cycle scheduler; one batch in flight, ever).

    One executor worker: the device executes batches serially anyway, and
    a single thread keeps engine state access naturally ordered."""

    def __init__(
        self,
        process_fn: Callable[[List[Any]], Sequence[Any]],
        *,
        max_batch: int = 8,
        max_delay_s: float = 0.010,
        max_queue: int = 64,
        batch_key: Optional[Callable[[Any], Any]] = None,
        metrics: Optional[Any] = None,
        on_batch: Optional[Callable[[List[Any]], None]] = None,
    ):
        super().__init__(
            process_fn,
            max_batch=max_batch,
            max_queue=max_queue,
            batch_key=batch_key,
            metrics=metrics,
            on_batch=on_batch,
        )
        self._max_delay_s = max_delay_s

    async def _wait_for_deadline(self) -> None:
        deadline = self._loop.time() + self._max_delay_s
        while len(self._pending) < self._max_batch and not self._draining:
            remaining = deadline - self._loop.time()
            if remaining <= 0:
                return
            self._event.clear()
            if len(self._pending) >= self._max_batch or self._draining:
                return  # recheck after clear: a submit may have raced
            try:
                await asyncio.wait_for(self._event.wait(), remaining)
            except asyncio.TimeoutError:
                return

    async def _run(self) -> None:
        while True:
            if not self._pending:
                if self._draining:
                    return
                self._event.clear()
                if self._pending or self._draining:
                    continue
                await self._event.wait()
                continue
            if not self._draining and len(self._pending) < self._max_batch:
                await self._wait_for_deadline()
            batch = self._take_batch()
            if not batch:
                continue
            if self._on_batch is not None:
                self._on_batch([item for item, _ in batch])
            if self._metrics is not None:
                # Scheduler-metric parity with ContinuousBatcher: the
                # cycle scheduler runs exactly one batch in flight and
                # nothing ever joins mid-cycle — emit those facts (1 and
                # +0) explicitly so the joined_mid_cycle/in-flight
                # dashboard families read identically under
                # `--scheduler cycle` instead of going silent.
                self._metrics.observe_batch(
                    len(batch),
                    queued=len(self._pending),
                    in_flight=1,
                    joined_mid_cycle=0,
                )
            items = [item for item, _ in batch]
            try:
                results = await self._loop.run_in_executor(
                    self._executor, self._process_fn, items
                )
                if len(results) != len(items):
                    raise RuntimeError(
                        f"process_fn returned {len(results)} results for "
                        f"{len(items)} requests"
                    )
            except Exception as exc:  # noqa: BLE001 - forwarded per-request
                for _, future in batch:
                    if not future.done():
                        future.set_exception(exc)
                continue
            finally:
                if self._metrics is not None:
                    self._metrics.observe_inflight(0)
            for (_, future), result in zip(batch, results):
                if not future.done():
                    future.set_result(result)


class ContinuousBatcher(_BatcherBase):
    """Rolling scheduler: dispatch as soon as work and a pipeline slot
    exist, keep up to `pipeline_depth` batches in flight.

    Same `submit`/`drain` surface and backpressure semantics as
    `MicroBatcher` (the shared `_BatcherBase` scaffolding), but no fixed
    deadline: batching emerges from device busy time plus the
    demand-aware coalesce. `process_fn` should split its device work
    into async-dispatch + blocking-collect (PolicyEngine.dispatch_batch/
    collect_batch) so two executor workers actually overlap — the
    executor has `pipeline_depth` workers for exactly that reason.
    """

    def __init__(
        self,
        process_fn: Callable[[List[Any]], Sequence[Any]],
        *,
        max_batch: int = 8,
        max_queue: int = 64,
        pipeline_depth: int = 2,
        coalesce_delay_s: float = 0.010,
        demand_window_s: float = 1.0,
        batch_key: Optional[Callable[[Any], Any]] = None,
        metrics: Optional[Any] = None,
        on_batch: Optional[Callable[[List[Any]], None]] = None,
    ):
        if pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {pipeline_depth}"
            )
        super().__init__(
            process_fn,
            max_batch=max_batch,
            max_queue=max_queue,
            batch_key=batch_key,
            metrics=metrics,
            on_batch=on_batch,
        )
        self._pipeline_depth = pipeline_depth
        # pipeline_depth executor workers: while one blocks collecting
        # step N, another dispatches step N+1 under the engine lock.
        self._WORKERS = pipeline_depth
        self._coalesce_s = max(coalesce_delay_s, 0.0)
        self._inflight: set = set()          # asyncio.Tasks of live batches
        self._inflight_keys: collections.Counter = collections.Counter()
        # Demand estimator: distinct keys (sessions) with a request in
        # the last `demand_window_s` — the expected occupancy of the next
        # step. Below it, dispatch waits up to `coalesce_delay_s` for the
        # rearrival burst to re-form instead of shattering it. Keyless
        # traffic has no session identity to anticipate, so it dispatches
        # greedily (demand == what is already pending).
        self._demand_window_s = max(demand_window_s, 0.0)
        self._key_seen: Dict[Any, float] = {}
        self._coalesce_until: Optional[float] = None

    def inflight(self) -> int:
        return len(self._inflight)

    def _note_submit(self, item: Any) -> None:
        if self._batch_key is not None:
            self._key_seen[self._batch_key(item)] = self._loop.time()

    # ------------------------------------------------------------ scheduler

    def _demand(self) -> int:
        """Expected occupancy of the next step: distinct keys seen within
        the demand window. Always prunes the window state, so it stays
        bounded by live traffic. Keyless: just what is pending — no
        identity means no rearrival anticipation, so dispatch greedily
        and let the pipeline overlap."""
        if self._batch_key is None:
            return len(self._pending)
        horizon = self._loop.time() - self._demand_window_s
        stale = [k for k, t in self._key_seen.items() if t < horizon]
        for k in stale:
            del self._key_seen[k]
        return len(self._key_seen)

    def _excluded(self, item: Any, batch_keys: set) -> bool:
        """Extends the base rule across overlap: a key riding an
        in-flight batch cannot board the next one (per-key FIFO)."""
        if self._batch_key is None:
            return False
        key = self._batch_key(item)
        return key in batch_keys or key in self._inflight_keys

    def _eligible_count(self, limit: Optional[int] = None) -> int:
        """How many pending requests `_take_batch` could take right now
        (same `_excluded` rule, read-only). Bounded at `limit` (default
        `max_batch`) — beyond a full batch the exact count never changes
        a scheduling decision."""
        bound = self._max_batch if limit is None else limit
        n = 0
        keys = set()
        for item, future in self._pending:
            if future.done():
                continue
            if self._excluded(item, keys):
                continue
            if self._batch_key is not None:
                keys.add(self._batch_key(item))
            n += 1
            if n >= bound:
                return n
        return n

    def _coalescing(self) -> bool:
        """True while dispatch should hold for the rearrival burst: fewer
        eligible requests than observed demand suggests, and the bounded
        coalesce window has not expired. Draining never waits."""
        # Demand first, unconditionally: _demand() also prunes the key
        # window, so the estimator state stays bounded even when
        # coalescing is disabled (coalesce_delay_s=0) or draining.
        # Keyless traffic never coalesces — no session identity means no
        # rearrival burst to anticipate; dispatch greedily.
        target = max(1, min(self._demand(), self._max_batch))
        if (
            self._batch_key is None
            or self._draining
            or self._coalesce_s <= 0.0
        ):
            self._coalesce_until = None
            return False
        eligible = self._eligible_count()
        if eligible == 0:
            self._coalesce_until = None
            return False
        if eligible >= target:
            self._coalesce_until = None
            return False
        if self._inflight:
            # Below target with a batch still in flight: its riders
            # rearrive the moment it completes, so dispatching now would
            # shatter the herd into sub-target steps that perpetuate
            # themselves (each fragment's completion re-fragments the
            # next). Hold — completion sets the event and re-evaluates;
            # a genuinely oversubscribed queue reaches `target` eligible
            # and still boards mid-cycle above.
            self._coalesce_until = None
            return True
        now = self._loop.time()
        if self._coalesce_until is None:
            self._coalesce_until = now + self._coalesce_s
            # Wake the scheduler at the deadline even with no new events.
            self._loop.call_at(self._coalesce_until, self._event.set)
        return now < self._coalesce_until

    def _dispatch_ready(self) -> None:
        """Form and launch batches while work and pipeline slots exist."""
        while len(self._inflight) < self._pipeline_depth:
            if self._coalescing():
                return
            batch = self._take_batch()
            if not batch:
                return
            self._coalesce_until = None
            if self._on_batch is not None:
                self._on_batch([item for item, _ in batch])
            if self._batch_key is not None:
                for item, _ in batch:
                    self._inflight_keys[self._batch_key(item)] += 1
            overlapped = len(self._inflight) > 0
            task = self._loop.create_task(
                self._run_batch(batch, overlapped)
            )
            self._inflight.add(task)
            task.add_done_callback(self._on_batch_done)
            if self._metrics is not None:
                self._metrics.observe_batch(
                    len(batch),
                    queued=len(self._pending),
                    in_flight=len(self._inflight),
                    joined_mid_cycle=len(batch) if overlapped else 0,
                )

    def _on_batch_done(self, task: asyncio.Task) -> None:
        self._inflight.discard(task)
        if self._metrics is not None:
            self._metrics.observe_inflight(len(self._inflight))
        self._event.set()  # a slot freed; maybe dispatch the next batch

    async def _run_batch(self, batch, overlapped: bool) -> None:
        items = [item for item, _ in batch]
        try:
            results = await self._loop.run_in_executor(
                self._executor, self._process_fn, items
            )
            if len(results) != len(items):
                raise RuntimeError(
                    f"process_fn returned {len(results)} results for "
                    f"{len(items)} requests"
                )
        except Exception as exc:  # noqa: BLE001 - forwarded per-request
            for _, future in batch:
                if not future.done():
                    future.set_exception(exc)
            return
        finally:
            if self._batch_key is not None:
                for item, _ in batch:
                    key = self._batch_key(item)
                    self._inflight_keys[key] -= 1
                    if self._inflight_keys[key] <= 0:
                        del self._inflight_keys[key]
        for (_, future), result in zip(batch, results):
            if not future.done():
                future.set_result(result)

    def _has_eligible(self) -> bool:
        """True if `_take_batch` would take at least one request now."""
        return self._eligible_count(limit=1) > 0

    async def _run(self) -> None:
        while True:
            self._dispatch_ready()
            if (
                self._draining
                and not self._pending
                and not self._inflight
            ):
                return
            self._event.clear()
            # Recheck after clear: a submit/completion may have raced the
            # clear, and drain must not sleep past the last completion.
            # While coalescing, sleep — the call_at timer (or the next
            # submit) wakes the scheduler, never a hot spin.
            if (
                self._has_eligible()
                and len(self._inflight) < self._pipeline_depth
                and not self._coalescing()
            ):
                continue
            if (
                self._draining
                and not self._pending
                and not self._inflight
            ):
                return
            await self._event.wait()
