"""Sample-ahead feeder: background batch assembly over the packed cache
(counterpart of `rt1_tpu/data/feeder.py`, the same batch stream for the
same pack and seed).

Worker threads assemble batches against `PackedEpisodeCache`, where a
window is mmap slices and the native gather releases the GIL, and park
them in one bounded queue per worker; the consumer (the train loop,
through `pipeline.device_feeder`) pops ready uint8 batches.

Determinism: the epoch order is a pure function of (seed, epoch, corpus
size[, task weights]) and every crop draw of (seed, epoch, batch-in-epoch),
never of the thread count or of timing, so 1 and 8 threads give the same
bytes. With `process_count > 1` the order is drawn globally and process p
assembles rows [p*B, (p+1)*B) of each global batch of B * process_count
windows, so the processes' batches concatenate to the one-process batch.

`refresh_at_epoch=True` re-reads the pack's manifest at every epoch
boundary (single process only) and draws the next epoch over the grown
corpus; the crop generator is keyed on (epoch, batch-in-epoch), so a
feeder that picked a shard up mid-run gives the epochs of one built after
the append. `close()` stops the workers promptly from any state; a finite
`num_epochs` stream ends after exactly its batches; `stall_timeout_s`
turns a consumer wait with no batch into `FeederStalledError`.

`emit_task_ids=True` adds a (batch,) int32 `task_id` observation, the
index of each window's task in `health_task_names` (the corpus's tasks,
sorted, frozen at construction, plus an `other` bucket for tasks appended
later), for the model-health pack's per-task reduction. `stats()` gives
the queue and per-worker gauges the train loop scrapes. The `feeder_kill`
and `feeder_hang` fault sites (`resilience/faults.py`, indexed by ticket)
kill a worker loudly or silently.
"""

from __future__ import annotations

import bisect
import queue
import threading
import time
import zlib
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np

from rt1_tpu_torch.data.pack import UNKNOWN_TASK, PackedEpisodeCache
from rt1_tpu_torch.obs import trace as obs_trace
from rt1_tpu_torch.obs.health import TASK_ID_KEY
from rt1_tpu_torch.resilience import faults

#: The per-task telemetry bucket of tasks unseen at construction.
OTHER_TASK = "other"


def parse_task_weights(spec) -> Optional[Dict[str, float]]:
    """``"block2block:3,corner:1"`` -> ``{"block2block": 3.0, "corner": 1.0}``.

    None or an empty string gives None (no mixture: the uniform shuffle); a
    mapping passes through, validated. Weights are finite and >= 0, at
    least one positive; ``"*"`` weighs every task not named (default 0).
    """
    if spec is None:
        return None
    if isinstance(spec, Mapping):
        items = dict(spec)
    else:
        text = str(spec).strip()
        if not text:
            return None
        items = {}
        for part in text.split(","):
            part = part.strip()
            if not part:
                continue
            name, _, weight = part.rpartition(":")  # task ids may hold ':'
            if not name:
                raise ValueError(f"task_weights entry {part!r} is not '<task>:<weight>'")
            items[name] = weight
    out = {}
    for name, weight in items.items():
        try:
            w = float(weight)
        except (TypeError, ValueError) as exc:
            raise ValueError(f"task_weights[{name!r}] = {weight!r} is not a number") from exc
        if w < 0 or not np.isfinite(w):
            raise ValueError(f"task_weights[{name!r}] = {w} must be finite and >= 0")
        out[name] = w
    if not out:
        return None
    if not any(v > 0 for v in out.values()):
        raise ValueError(f"task_weights {out} has no positive weight")
    return out


class FeederStalledError(RuntimeError):
    """The consumer waited past `stall_timeout_s` with no batch and no
    error, or every worker died silently; the message names the live and
    dead workers and the queue depths."""


class SampleAheadFeeder:
    """Iterator of training batch dicts ({"observations": {"image" uint8,
    "natural_language_embedding"}, "actions": {"terminate_episode",
    "action"}}) assembled ahead of the consumer."""

    def __init__(
        self,
        cache: PackedEpisodeCache,
        batch_size: int,
        *,
        seed: int = 0,
        shuffle: bool = True,
        num_epochs: Optional[int] = None,
        num_threads: int = 2,
        depth: int = 2,
        process_index: int = 0,
        process_count: int = 1,
        start: bool = True,
        stall_timeout_s: Optional[float] = None,
        refresh_at_epoch: bool = False,
        task_weights: Optional[Mapping[str, float]] = None,
        emit_task_ids: bool = False,
    ):
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        if stall_timeout_s is not None and stall_timeout_s <= 0:
            raise ValueError(f"stall_timeout_s must be positive or None, got {stall_timeout_s}")
        if refresh_at_epoch and process_count > 1:
            # A refresh is a per-process read with no barrier: processes
            # could draw orders over different corpora.
            raise ValueError("refresh_at_epoch is single-process only: restart training to "
                             "absorb appended shards on a multi-process run")
        self.cache = cache
        self.batch_size = batch_size
        self.stall_timeout_s = stall_timeout_s
        self.seed = seed
        self.shuffle = shuffle
        self.num_epochs = num_epochs
        self.num_threads = max(1, num_threads)
        self.depth = max(1, depth)
        self.process_index = process_index
        self.process_count = process_count
        self.refresh_at_epoch = refresh_at_epoch
        self.task_weights = parse_task_weights(task_weights)
        if self.task_weights is not None and not shuffle:
            raise ValueError("task_weights requires shuffle=True (a weighted epoch is a "
                             "sampled mixture, not a corpus walk)")
        # The weights fold into the shuffle key: another mixture, another
        # (reproducible) stream.
        self._weights_key = (zlib.crc32(repr(sorted(self.task_weights.items())).encode("utf-8"))
                             if self.task_weights is not None else 0)
        # The task-id table is frozen here (sorted corpus tasks + the
        # OTHER_TASK bucket), so the pack's layout holds while the corpus
        # grows; a corpus with a literal "other" task shares that bucket.
        self.emit_task_ids = emit_task_ids
        self._task_index = {name: i for i, name in enumerate(sorted(set(cache.tasks)))}
        names = tuple(sorted(self._task_index))
        if OTHER_TASK not in self._task_index:
            names = names + (OTHER_TASK,)
        self.health_task_names: Tuple[str, ...] = names if emit_task_ids else ()
        # One snapshot per epoch (window count, order): an append changes
        # only epochs not drawn yet. `_firsts[e]` is epoch e's first ticket.
        self._order_lock = threading.Lock()
        self._epochs: List[Dict] = []
        self._firsts: List[int] = []
        self._materialize_next_epoch()
        self.batches_per_epoch = self._epochs[0]["batches"]
        if self.batches_per_epoch == 0:
            raise ValueError(f"global batch ({batch_size} per process x {self.process_count} "
                             f"processes) exceeds the corpus's "
                             f"{len(self._epochs[0]['order'])} windows")
        self.total_batches = (self.batches_per_epoch * num_epochs
                              if num_epochs is not None and not refresh_at_epoch else None)
        meta0 = cache.meta(0)
        self._embed_dim = int(meta0["instruction"].shape[1])
        self._action_dim = int(meta0["action"].shape[1])
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._queues = [queue.Queue(maxsize=self.depth) for _ in range(self.num_threads)]
        self._threads = [threading.Thread(target=self._worker, args=(k,), daemon=True,
                                          name=f"rt1-feeder-{k}")
                         for k in range(self.num_threads)]
        self._next_ticket = 0
        self._started = False
        # Per-worker counters for `stats()`: index-assigned list writes,
        # read lock-free.
        self._assembled = [0] * self.num_threads
        self._assembly_s = [0.0] * self.num_threads
        if start:
            self.start()

    # ------------------------------------------------------------ schedule

    def _compute_order(self, epoch: int, n_windows: int) -> np.ndarray:
        """The global window order of `epoch`: a permutation keyed on
        (seed, epoch) (arange without shuffle), or with task weights a draw
        with replacement keyed on (seed, epoch, weights)."""
        if self.task_weights is not None:
            w = self._window_weights(n_windows)
            total = w.sum()
            if total <= 0:
                raise ValueError(f"task_weights {self.task_weights} give zero total weight over "
                                 f"this corpus (tasks: {sorted(set(self.cache.tasks))})")
            rng = np.random.default_rng([self.seed, epoch, self._weights_key])
            return rng.choice(n_windows, size=n_windows, replace=True, p=w / total)
        order = np.arange(n_windows)
        if self.shuffle:
            np.random.default_rng([self.seed, epoch]).shuffle(order)
        return order

    @property
    def global_batch_size(self) -> int:
        return self.batch_size * self.process_count

    def _host_indices(self, order: np.ndarray, b: int) -> np.ndarray:
        """This process's rows of global batch `b`."""
        base = b * self.global_batch_size + self.process_index * self.batch_size
        return order[base:base + self.batch_size]

    def host_order(self, epoch: int) -> np.ndarray:
        """This process's window sequence for `epoch` (full batches only)."""
        order = self._order_for(epoch)
        nb = len(order) // self.global_batch_size
        if self.process_count == 1:
            return order[:nb * self.global_batch_size]
        return (order[:nb * self.global_batch_size]
                .reshape(nb, self.process_count, self.batch_size)[:, self.process_index]
                .reshape(-1))

    def _window_weights(self, n_windows: int) -> np.ndarray:
        """(n_windows,) weight per window: its episode's task in
        `task_weights`, else the "*" weight (default 0)."""
        default = self.task_weights.get("*", 0.0)
        ep_weights, ep_steps, covered = [], [], 0
        for entry in self.cache.episodes:
            if covered >= n_windows:
                break
            steps = min(int(entry["steps"]), n_windows - covered)
            ep_weights.append(self.task_weights.get(entry.get("task") or UNKNOWN_TASK, default))
            ep_steps.append(steps)
            covered += steps
        return np.repeat(np.asarray(ep_weights, np.float64), np.asarray(ep_steps, np.int64))

    def _materialize_next_epoch(self) -> None:
        """Append the next epoch's snapshot (the caller holds `_order_lock`,
        or is the constructor); the refresh happens here, once per epoch."""
        e = len(self._epochs)
        if e > 0 and self.refresh_at_epoch:
            try:
                self.cache.refresh()
            except (OSError, ValueError):  # keep feeding the old view
                pass
        n_windows = len(self.cache.index)
        order = self._compute_order(e, n_windows)
        first = 0 if e == 0 else self._firsts[-1] + self._epochs[-1]["batches"]
        self._epochs.append({"first": first, "batches": len(order) // self.global_batch_size,
                             "order": order, "windows": n_windows})
        self._firsts.append(first)
        # Workers straddle at most a couple of epochs: drop older orders
        # (recomputable from the pinned window count).
        for old in self._epochs[:max(0, e - 2)]:
            old["order"] = None

    def _locate(self, ticket: int) -> Tuple[int, int]:
        """Global ticket -> (epoch, batch-in-epoch)."""
        with self._order_lock:
            while ticket >= self._firsts[-1] + self._epochs[-1]["batches"]:
                self._materialize_next_epoch()
            e = bisect.bisect_right(self._firsts, ticket) - 1
            return e, ticket - self._firsts[e]

    def _order_for(self, epoch: int) -> np.ndarray:
        with self._order_lock:
            while len(self._epochs) <= epoch:
                self._materialize_next_epoch()
            entry = self._epochs[epoch]
            if entry["order"] is None:
                entry["order"] = self._compute_order(epoch, entry["windows"])
            return entry["order"]

    def _past_end(self, ticket: int) -> bool:
        if self.num_epochs is None:
            return False
        if self.total_batches is not None:
            return ticket >= self.total_batches
        return self._locate(ticket)[0] >= self.num_epochs

    def _batch_rng(self, epoch: int, b: int) -> np.random.Generator:
        # Philox keyed on (seed, epoch, batch-in-epoch); the 0x5EED word
        # keeps it apart from the shuffle's stream.
        key = (self.seed & 0xFFFFFFFFFFFFFFFF) ^ (0x5EED << 48)
        counter = (np.uint64(epoch) << np.uint64(32)) | np.uint64(b)
        return np.random.Generator(np.random.Philox(key=np.array([key, counter], np.uint64)))

    # ------------------------------------------------------------ workers

    def _assemble(self, ticket: int) -> Dict:
        epoch, b = self._locate(ticket)
        indices = self._host_indices(self._order_for(epoch), b)
        rng = self._batch_rng(epoch, b)
        n, w = len(indices), self.cache.window
        h, wd = self.cache.height, self.cache.width
        images = np.empty((n, w, h, wd, 3), np.uint8)
        embeds = np.empty((n, w, self._embed_dim), np.float32)
        terms = np.empty((n, w), np.int32)
        actions = np.empty((n, w, self._action_dim), np.float32)
        offsets = None
        if self.process_count > 1:
            # Every process draws the global batch's offsets and keeps its rows.
            all_offsets = self.cache.draw_packed_offsets(rng, self.global_batch_size * w)
            lo = self.process_index * self.batch_size * w
            offsets = all_offsets[lo:lo + n * w]
        self.cache.fill_batch(indices, rng, images, embeds, terms, actions, offsets=offsets)
        observations = {"image": images, "natural_language_embedding": embeds}
        if self.emit_task_ids:
            other = self._task_index.get(OTHER_TASK, len(self._task_index))
            tid = np.empty((n,), np.int32)
            for j, idx in enumerate(indices):
                entry = self.cache.episodes[self.cache.index[int(idx)][0]]
                tid[j] = self._task_index.get(entry.get("task") or UNKNOWN_TASK, other)
            observations[TASK_ID_KEY] = tid
        if self.cache._clip_tokenizer is not None:
            tokens = np.stack([self.cache.episode_clip_tokens(self.cache.index[int(i)][0])
                               for i in indices])
            observations["instruction_tokenized_clip"] = np.tile(tokens[:, None, :], (1, w, 1))
        return {"observations": observations,
                "actions": {"terminate_episode": terms, "action": actions}}

    def _worker(self, k: int) -> None:
        ticket = k
        q = self._queues[k]
        try:
            while not self._stop.is_set():
                if self._past_end(ticket):
                    return
                # feeder_hang dies silently (the deadlock the consumer's
                # stall timeout diagnoses); feeder_kill dies loudly.
                plan = faults.active()
                if plan is not None:
                    if plan.should_fire("feeder_hang", index=ticket):
                        return
                    if plan.should_fire("feeder_kill", index=ticket):
                        raise RuntimeError(
                            f"injected fault [feeder_kill]: worker {k} at ticket {ticket}")
                t0 = time.perf_counter()
                with obs_trace.span("feeder_assemble", ticket=ticket):
                    batch = self._assemble(ticket)
                self._assembly_s[k] += time.perf_counter() - t0
                self._assembled[k] += 1
                # A bounded put that still sees close().
                while not self._stop.is_set():
                    try:
                        q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if obs_trace.enabled():
                    obs_trace.counter("feeder_queue_depth",
                                      sum(qq.qsize() for qq in self._queues))
                ticket += self.num_threads
        except BaseException as e:  # noqa: BLE001 - re-raised on the consumer in __next__
            self._error = e
            self._stop.set()

    # ------------------------------------------------------------ observability

    def stats(self) -> Dict[str, float]:
        """Numeric gauges of the ready queues and the workers, for the
        train loop's scalars, scrape listener and flight recorder; lock-free
        reads, safe from any thread."""
        out = {
            "queue_depth": sum(q.qsize() for q in self._queues),
            "queue_capacity": self.num_threads * self.depth,
            "next_ticket": self._next_ticket,
            "workers_alive": sum(t.is_alive() for t in self._threads),
            "corpus_windows": len(self.cache.index),
            "epochs_started": len(self._epochs),
        }
        for k in range(self.num_threads):
            n = self._assembled[k]
            out[f"assembled_w{k}"] = n
            out[f"assembly_ms_mean_w{k}"] = self._assembly_s[k] / n * 1e3 if n else 0.0
        return out

    def flywheel_stats(self) -> Dict[str, float]:
        """Corpus-growth gauges for the train loop's `flywheel/*` scalars
        and the `rt1_flywheel_*` Prometheus families: shard count,
        freshness epoch, corpus size, appended-episode count, and how
        stale the feeder's view of the manifest is. Lock-free reads."""
        c = self.cache
        now = time.time()
        return {
            "shards": float(getattr(c, "num_shards", 1)),
            "freshness_epoch": float(getattr(c, "freshness_epoch", 0)),
            "corpus_windows": float(len(c.index)),
            "corpus_steps": float(getattr(c, "total_steps", 0)),
            "corpus_episodes": float(len(c.episodes)),
            "corpus_tasks": float(len(set(c.tasks))),
            "appended_episodes": float(getattr(c, "appended_episodes", 0)),
            "refreshes": float(getattr(c, "refreshes", 0)),
            "staleness_s": max(
                0.0, now - getattr(c, "last_refresh_unix", now)
            ),
            "epochs_started": float(len(self._epochs)),
        }

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "SampleAheadFeeder":
        if not self._started:
            self._started = True
            for t in self._threads:
                t.start()
        return self

    def close(self) -> None:
        """Stop the workers and join them; the iterator is exhausted after."""
        self._stop.set()
        for q in self._queues:
            try:  # drain, so a worker blocked in put() sees the stop
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
        for t in self._threads:
            if t.is_alive():
                t.join(timeout=5.0)

    def __enter__(self) -> "SampleAheadFeeder":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        stop = getattr(self, "_stop", None)
        if stop is not None:
            stop.set()

    # ------------------------------------------------------------ iteration

    def __iter__(self) -> Iterator[Dict]:
        return self

    def __next__(self) -> Dict:
        if not self._started:
            self.start()
        if self._stop.is_set():
            self._raise_or_stop()
        t = self._next_ticket
        if self._past_end(t):
            raise StopIteration
        q = self._queues[t % self.num_threads]
        waited = 0.0
        while True:
            try:
                batch = q.get(timeout=0.1)
                break
            except queue.Empty:
                if self._stop.is_set():
                    self._raise_or_stop()
                waited += 0.1
                if self.stall_timeout_s is not None and waited >= self.stall_timeout_s:
                    raise self._stalled_error(t, waited)
                if not any(th.is_alive() for th in self._threads) and q.empty():
                    raise self._stalled_error(t, waited)  # no batch can arrive
        self._next_ticket = t + 1
        return batch

    def _stalled_error(self, ticket: int, waited: float) -> FeederStalledError:
        alive = [th.name for th in self._threads if th.is_alive()]
        dead = [th.name for th in self._threads if not th.is_alive()]
        depths = [qq.qsize() for qq in self._queues]
        return FeederStalledError(
            f"feeder stalled: waited {waited:.1f}s for ticket {ticket} (queue "
            f"{ticket % self.num_threads}). Worker threads alive: {alive or 'NONE'}; dead: "
            f"{dead or 'none'}; queue depths: {depths} (capacity {self.depth} each). A dead "
            "worker with no stashed error deadlocked or was killed without unwinding.")

    def _raise_or_stop(self) -> None:
        """Re-raise a worker's error on the consumer, or end the stream after
        close()."""
        if self._error is not None:
            raise RuntimeError("sample-ahead feeder worker failed") from self._error
        raise StopIteration
