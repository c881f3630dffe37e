"""Sliding-window dataset, its loaders, and the upload to the card
(counterpart of `rt1_tpu/data/pipeline.py`).

The sample distribution is the JAX package's, draw for draw: each episode
is front-padded by repeating its first step `window - 1` times, every
length-`window` window is one sample (T windows per episode), each frame
is cropped at `crop_factor` at a uniform random offset (`_crop_box`) and
resized to (height, width) by the native sampler, and the labels are
`terminate_episode` (is_terminal as int32) and `action`.

Loaders:

* `numpy_batches` — one thread, one numpy generator for the shuffle and
  the crops: the same stream as the JAX package's `numpy_batches` for the
  same seed (under its native sampler).
* `as_torch_loader` — a `torch.utils.data.DataLoader` (the role tf.data
  plays in JAX): worker processes started by `forkserver`, a shuffle from a
  `torch.Generator` seeded by `seed` (or tf.data's bounded shuffle buffer),
  and each window's crops from a generator seeded by (seed, epoch, window
  index), whichever worker reads it.

`device_feeder` moves host batches to the card: staged into pinned memory,
copied on a stream of its own with up to `depth` batches in flight, and
handed over after the consumer's stream waits on the copy. Images stay
uint8; the model converts them on the card (`ops/image.py`).
"""

from __future__ import annotations

import collections
import itertools
import multiprocessing
import os
import threading
import time
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rt1_tpu_torch.data import episodes as ep_lib
from rt1_tpu_torch.data import native

Batch = Dict[str, Dict[str, np.ndarray]]
CACHE_EPISODES = 64  # episodes a dataset (each loader worker) keeps decoded


class WindowedEpisodeDataset:
    """Index of all (episode, start) windows over a set of episode files."""

    def __init__(
        self,
        paths: Sequence[str],
        window: int = 6,
        crop_factor: Optional[float] = 0.95,
        height: int = 256,
        width: int = 456,
        clip_tokenizer=None,
    ):
        self.paths = list(paths)
        # Optional `text.clip_bpe.ClipBPETokenizer`: windows gain an
        # "instruction_tokenized_clip" (window, context) int32 observation,
        # the episode's instruction text in every frame, for LAVA's CLIP
        # text tower.
        self._clip_tokenizer = clip_tokenizer
        self._clip_token_cache: Dict[int, np.ndarray] = {}
        self.window = window
        self.crop_factor = crop_factor
        self.height = height
        self.width = width
        # Episode files read (cache misses) and the seconds spent reading
        # them, in this process: a loader worker counts in its own copy.
        self.episode_reads = 0
        self.episode_read_s = 0.0
        self._cache: "collections.OrderedDict[int, ep_lib.Episode]" = collections.OrderedDict()
        # Loader threads call get_window concurrently; the LRU's mutations
        # must be atomic.
        self._cache_lock = threading.Lock()
        # Padded length T + window - 1 -> exactly T windows per episode.
        self.index: List[Tuple[int, int]] = []
        for i in range(len(self.paths)):
            self.index.extend((i, s) for s in range(self._episode_len(i)))

    def __getstate__(self):
        # What a loader worker receives: the index, not the cache.
        state = dict(self.__dict__)
        state["_cache"] = collections.OrderedDict()
        del state["_cache_lock"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._cache_lock = threading.Lock()

    def _episode_len(self, i: int) -> int:
        # An .npz member loads alone: read the flags, not the frames.
        path = self.paths[i]
        if path.endswith(".npz"):
            with np.load(path) as z:
                return int(z["is_first"].shape[0])
        return self._episode(i)["rgb"].shape[0]

    def _episode(self, i: int) -> ep_lib.Episode:
        with self._cache_lock:
            ep = self._cache.get(i)
            if ep is not None:
                self._cache.move_to_end(i)
                return ep
        t0 = time.perf_counter()
        ep = ep_lib.load_episode(self.paths[i])
        dt = time.perf_counter() - t0
        with self._cache_lock:
            self.episode_reads += 1
            self.episode_read_s += dt
            self._cache[i] = ep
            if len(self._cache) > CACHE_EPISODES:
                self._cache.popitem(last=False)
        return ep

    def __len__(self) -> int:
        return len(self.index)

    # ------------------------------------------------------------------ samples

    def _padded_step(self, ep: ep_lib.Episode, j: int, key: str):
        """Step j of the padded episode: j < window-1 reads the first step."""
        pad = self.window - 1
        return ep[key][0 if j < pad else j - pad]

    def get_window(self, idx: int, rng: Optional[np.random.Generator] = None) -> Batch:
        ep_i, start = self.index[idx]
        ep = self._episode(ep_i)
        rng = rng or np.random.default_rng()
        frames, boxes, embeds, actions, terms = [], [], [], [], []
        for j in range(start, start + self.window):
            rgb = self._padded_step(ep, j, "rgb")
            frames.append(rgb)
            boxes.append(_crop_box(rgb.shape[0], rgb.shape[1], self.crop_factor, rng))
            embeds.append(self._padded_step(ep, j, "instruction"))
            actions.append(self._padded_step(ep, j, "action"))
            terms.append(np.int32(bool(self._padded_step(ep, j, "is_terminal"))))
        observations = {
            "image": crop_resize_frames(frames, boxes, self.height, self.width),
            "natural_language_embedding": np.stack(embeds).astype(np.float32),
        }
        if self._clip_tokenizer is not None:
            observations["instruction_tokenized_clip"] = np.tile(
                self._episode_clip_tokens(ep_i), (self.window, 1))
        return {
            "observations": observations,
            "actions": {
                "terminate_episode": np.asarray(terms, np.int32),
                "action": np.stack(actions).astype(np.float32),
            },
        }

    def _episode_clip_tokens(self, ep_i: int) -> np.ndarray:
        """(context,) int32 CLIP BPE frame of the episode's instruction."""
        tokens = self._clip_token_cache.get(ep_i)
        if tokens is None:
            ep = self._episode(ep_i)
            if "instruction_text" not in ep:
                raise KeyError(f"{self.paths[ep_i]} has no 'instruction_text' member; "
                               "re-collect with rt1_tpu_torch.data.collect to use clip_tokenizer")
            text = ep_lib.decode_instruction_text(ep["instruction_text"])
            tokens = self._clip_tokenizer.tokenize_text(text)[0].astype(np.int32)
            self._clip_token_cache[ep_i] = tokens
        return tokens

    # ------------------------------------------------------------------ loaders

    def numpy_batches(
        self,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        num_epochs: Optional[int] = None,
        process_index: int = 0,
        process_count: int = 1,
        drop_remainder: bool = True,
    ) -> Iterator[Batch]:
        """Batches assembled in the caller's thread; one generator seeded by
        `seed` draws each epoch's shuffle, then the crops in window order."""
        rng = np.random.default_rng(seed)
        epoch = 0
        while num_epochs is None or epoch < num_epochs:
            order = np.arange(len(self.index))
            if shuffle:
                rng.shuffle(order)
            order = order[process_index::process_count]
            stop = len(order) - (batch_size - 1 if drop_remainder else 0)
            for i in range(0, stop, batch_size):
                yield _stack_tree([self.get_window(int(j), rng) for j in order[i:i + batch_size]])
            epoch += 1

    def as_torch_loader(
        self,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        num_workers: int = 2,
        prefetch_factor: Optional[int] = 2,
        pin_memory: bool = False,
        num_epochs: Optional[int] = None,
        shuffle_buffer: Optional[int] = None,
        process_index: int = 0,
        process_count: int = 1,
    ) -> torch.utils.data.DataLoader:
        """A DataLoader of batches of torch tensors (the nested dict of
        `numpy_batches`), `num_epochs` epochs (None: without end).

        Each epoch is a permutation from one `torch.Generator` seeded by
        `seed` (arange without `shuffle`), cut into full batches (an epoch's remainder is
        dropped, as `drop_last=True` does). With `shuffle_buffer` (the
        `data.loader="tf"` path) the order is instead tf.data's
        `repeat().shuffle(min(n, shuffle_buffer))` over the window indices:
        `buffered_shuffle` of the repeated stream, whose draws span epoch
        boundaries, cut into batches. Workers start by
        `forkserver`; the crops of window `idx` in epoch `e` come from a
        generator seeded by (seed, e, idx), so they depend neither on the
        worker count nor on the order the keys arrive in. `pin_memory`
        pins each batch for the upload (`device_feeder` copies pinned
        tensors directly). With `process_count > 1` the keys are cut into
        global batches of `batch_size * process_count` and this process
        takes rows [process_index * batch_size, (process_index + 1) *
        batch_size) of each (the packed feeder's rule)."""
        native.build()  # once, here, rather than racing in every worker
        if not os.environ.get("RT1_TPU_NO_NATIVE"):
            native.build_reader()
        batches = _EpochBatches(len(self.index), batch_size, shuffle, seed, num_epochs,
                                shuffle_buffer, process_index, process_count)
        kwargs = {}
        if num_workers > 0:
            # forkserver: each worker forks from a fresh single-threaded
            # server, not from this process and its threads; unlike spawn's
            # workers, which leave through the interpreter's finalisation
            # and abort inside torch when shut down mid-batch, they leave
            # with os._exit.
            kwargs = {"multiprocessing_context": multiprocessing.get_context("forkserver"),
                      "prefetch_factor": prefetch_factor}
        return torch.utils.data.DataLoader(
            _WindowView(self, seed), batch_sampler=batches, num_workers=num_workers,
            collate_fn=_collate, pin_memory=pin_memory, **kwargs)


def loader_batches(loader: torch.utils.data.DataLoader) -> Iterator:
    """Iterate `loader`; closing the generator shuts its worker processes
    down then and there, not whenever the iterator is collected (workers
    left to the interpreter's exit have been seen to abort)."""
    it = iter(loader)
    try:
        yield from it
    finally:
        shutdown = getattr(it, "_shutdown_workers", None)  # absent without workers
        if shutdown is not None:
            shutdown()


def buffered_shuffle(items: Iterable, buffer_size: int, seed: int) -> Iterator:
    """tf.data's `shuffle(buffer_size, seed)` over `items`: fill a buffer
    with the first `buffer_size` items, then each draw takes a uniformly
    chosen buffered item and refills its place with the stream's next one;
    when the stream ends, the buffer drains in random order. Draw t is an
    item from stream positions below t + buffer_size; buffer_size 1 keeps
    the stream's order."""
    if buffer_size < 1:
        raise ValueError(f"buffer_size must be >= 1, got {buffer_size}")
    rng = np.random.default_rng(seed)
    stream = iter(items)
    buffer = list(itertools.islice(stream, buffer_size))
    while buffer:
        j = int(rng.integers(len(buffer)))
        item = buffer[j]
        try:
            buffer[j] = next(stream)
        except StopIteration:
            buffer[j] = buffer[-1]
            buffer.pop()
        yield item


class _EpochBatches(torch.utils.data.Sampler):
    """Batches of (epoch, window index) keys; see `as_torch_loader`."""

    def __init__(self, n, batch_size, shuffle, seed, num_epochs, shuffle_buffer=None,
                 process_index=0, process_count=1):
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        self.n, self.batch_size, self.shuffle, self.seed = n, batch_size, shuffle, seed
        self.num_epochs = num_epochs
        self.shuffle_buffer = shuffle_buffer
        self.process_index, self.process_count = process_index, process_count

    def _global(self):
        """Global batches of `batch_size * process_count` keys."""
        if self.shuffle and self.shuffle_buffer:
            yield from self._buffered()
            return
        g = torch.Generator().manual_seed(self.seed)
        epoch = 0
        size = self.batch_size * self.process_count
        while self.num_epochs is None or epoch < self.num_epochs:
            order = torch.randperm(self.n, generator=g).numpy() if self.shuffle \
                else np.arange(self.n)
            for i in range(0, len(order) - size + 1, size):
                yield [(epoch, int(j)) for j in order[i:i + size]]
            epoch += 1

    def _buffered(self):
        """The repeated index stream through `buffered_shuffle`, keyed by
        each item's epoch in the stream, cut into full batches."""
        n = self.n
        positions = itertools.count() if self.num_epochs is None \
            else range(n * self.num_epochs)
        keys = buffered_shuffle(((p // n, p % n) for p in positions),
                                min(n, self.shuffle_buffer), self.seed)
        size = self.batch_size * self.process_count
        while True:
            batch = list(itertools.islice(keys, size))
            if len(batch) < size:
                return
            yield batch

    def __iter__(self):
        lo = self.process_index * self.batch_size
        for batch in self._global():
            yield batch[lo:lo + self.batch_size]


class _WindowView(torch.utils.data.Dataset):
    """Map-style view of a WindowedEpisodeDataset keyed by (epoch, index),
    each key's crops drawn from a generator seeded by (seed, epoch, index)."""

    def __init__(self, dataset: WindowedEpisodeDataset, seed: int):
        self.dataset = dataset
        self.seed = seed

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, key):
        epoch, idx = key
        return self.dataset.get_window(idx, np.random.default_rng([self.seed, epoch, idx]))


def _collate(samples: List[Batch]) -> Dict[str, Dict[str, torch.Tensor]]:
    return {group: {k: torch.from_numpy(v) for k, v in leaves.items()}
            for group, leaves in _stack_tree(samples).items()}


def _crop_box(h: int, w: int, crop_factor: Optional[float],
              rng: np.random.Generator) -> Tuple[int, int, int, int]:
    """(top, left, crop_h, crop_w): a `crop_factor` box at a uniform random
    offset, the top drawn before the left (the full frame, and no draw, when
    crop_factor is None)."""
    if crop_factor is None:
        return 0, 0, h, w
    ch, cw = int(h * crop_factor), int(w * crop_factor)
    top = int(rng.integers(0, h - ch + 1))
    left = int(rng.integers(0, w - cw + 1))
    return top, left, ch, cw


def crop_resize_frames(frames, boxes, height: int, width: int) -> np.ndarray:
    """Crop + bilinear-resize uint8 frames -> (n, height, width, 3) uint8,
    through the native sampler, one thread per call (the loaders spread
    windows over threads and processes)."""
    if frames[0].dtype != np.uint8:
        raise ValueError(f"the window sampler takes uint8 frames, got {frames[0].dtype}")
    return native.crop_resize_batch(frames, boxes, height, width, threads=1)


def _bilinear_coefs(src: int, out: int):
    """The sampler's per-output coefficients (`compute_coefs` in
    native/window_sampler.cc), in float32 with each operation rounded."""
    f32 = np.float32
    scale = f32(src) / f32(out)
    f = (np.arange(out, dtype=f32) + f32(0.5)) * scale - f32(0.5)
    i0 = np.floor(f).astype(np.int64)
    w = f - i0.astype(f32)
    i1 = np.minimum(i0 + 1, src - 1)
    i0 = np.maximum(i0, 0)
    w1 = (w * f32(2048) + f32(0.5)).astype(np.int64)  # w >= 0: truncation is floor
    return i0, i1, 2048 - w1, w1


def crop_resize_reference(frames, boxes, height: int, width: int) -> np.ndarray:
    """Plain numpy version of the native sampler's crop + resize, to the
    byte: src = (dst + 0.5) * (in / out) - 0.5 in float32, edge-clamped,
    11-bit weights, a horizontal then a vertical pass in integers, rounded
    half up by `>> 22`. Tests hold the sampler to it; no loader calls it."""
    out = np.empty((len(frames), height, width, 3), np.uint8)
    for n, (frame, (top, left, ch, cw)) in enumerate(zip(frames, boxes)):
        crop = np.asarray(frame, np.int64)[top:top + ch, left:left + cw]
        x0, x1, xw0, xw1 = _bilinear_coefs(cw, width)
        y0, y1, yw0, yw1 = _bilinear_coefs(ch, height)
        rows = crop[:, x0] * xw0[None, :, None] + crop[:, x1] * xw1[None, :, None]
        v = rows[y0] * yw0[:, None, None] + rows[y1] * yw1[:, None, None]
        out[n] = np.clip((v + (1 << 21)) >> 22, 0, 255)
    return out


def _stack_tree(samples: List[Dict]) -> Dict:
    """Stack a list of nested sample dicts leaf by leaf."""
    out = {}
    for k, v in samples[0].items():
        if isinstance(v, dict):
            out[k] = {kk: np.stack([s[k][kk] for s in samples]) for kk in v}
        else:
            out[k] = np.stack([s[k] for s in samples])
    return out


class DeviceFeeder:
    """Iterator of (observations, actions) dicts of tensors on `device`,
    from an iterator of host batches ({"observations": ..., "actions":
    ...} of numpy arrays or tensors).

    On a CUDA device each batch is staged into pinned host buffers (a
    tensor that is already pinned, as a DataLoader with `pin_memory` gives
    it, is copied as it is) and copied with `non_blocking=True` on a
    stream of its own, keeping `depth` batches in flight. A staging buffer
    is refilled only after the event of its last copy has completed (a
    buffer still being read would tear the batch in flight). At hand-over
    the consumer's current stream waits on the batch's copy event, and
    `record_stream` keeps the allocator from reusing its device memory
    before the consumer's work is done. On the CPU the batches pass through
    as tensors, unpinned.

    `wait_s` (time blocked on the host iterator), `upload_s` (staging and
    enqueueing the copies) and `batches` accumulate over the feeder's life.
    """

    def __init__(self, iterator, device, depth: int = 2):
        self.device = torch.device(device)
        self.depth = max(1, depth)
        self.wait_s = 0.0
        self.upload_s = 0.0
        self.batches = 0
        self._source = iter(iterator)
        self._queue = collections.deque()
        self._exhausted = False
        self._uploaded = 0
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self._stream = torch.cuda.Stream(self.device)
            self._slots = [None] * self.depth  # (copy event, {leaf: pinned buffer})

    def __iter__(self):
        return self

    def __next__(self):
        while not self._exhausted and len(self._queue) < self.depth:
            t0 = time.perf_counter()
            try:
                batch = next(self._source)
            except StopIteration:
                self._exhausted = True
                break
            finally:
                t1 = time.perf_counter()
                self.wait_s += t1 - t0
            self._queue.append(self._upload(batch))
            self.upload_s += time.perf_counter() - t1
        if not self._queue:
            raise StopIteration
        tree, event = self._queue.popleft()
        if self._cuda:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for leaves in tree.values():
                for t in leaves.values():
                    t.record_stream(consumer)
        self.batches += 1
        return tree["observations"], tree["actions"]

    def _upload(self, batch):
        if not self._cuda:
            return {group: {k: torch.as_tensor(v).to(self.device) for k, v in leaves.items()}
                    for group, leaves in batch.items()}, None
        slot = self._uploaded % self.depth
        self._uploaded += 1
        staged = {}
        if self._slots[slot] is not None:
            event, staged = self._slots[slot]
            event.synchronize()  # its last copy has finished reading the buffers
        tree = {}
        with torch.cuda.stream(self._stream):
            for group, leaves in batch.items():
                tree[group] = {}
                for k, value in leaves.items():
                    src = value if isinstance(value, torch.Tensor) and value.is_pinned() \
                        else self._stage(staged, (group, k), value)
                    tree[group][k] = src.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._slots[slot] = (event, staged)
        return tree, event

    def close(self) -> None:
        """Stop the host iterator (a feeder's threads, a DataLoader's
        workers) and drop the batches in flight."""
        close = getattr(self._source, "close", None)
        if close is not None:
            close()
        self._source = iter(())
        self._queue.clear()
        self._exhausted = True

    @staticmethod
    def _stage(staged, key, value) -> torch.Tensor:
        value = torch.as_tensor(value)
        buf = staged.get(key)
        if buf is None or buf.shape != value.shape or buf.dtype != value.dtype:
            buf = torch.empty(value.shape, dtype=value.dtype, pin_memory=True)
            staged[key] = buf
        buf.copy_(value)
        return buf


def device_feeder(iterator, device, depth: int = 2) -> DeviceFeeder:
    """Host batches -> (observations, actions) on `device`, `depth` batches
    in flight (see `DeviceFeeder`)."""
    return DeviceFeeder(iterator, device, depth)
