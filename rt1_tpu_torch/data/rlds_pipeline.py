"""The RLDS windowing pipeline in numpy and torch (counterpart of
`rt1_tpu/data/rlds_pipeline.py`, which is pure tf.data).

What JAX's graph computes, step for step, without TensorFlow:

* `pad_episode` / `episode_windows` — front-pad by repeating the first step
  `window - 1` times (`is_first` False on the copies); every length-`window`
  window is one sample, T windows an episode;
* `_augment_images` — `convert_image_dtype` (x * float32(1/255)), a
  `crop_factor` crop (an independent uniform offset a frame in training,
  the central crop in eval), a twin of `tf.image.resize(..., "bilinear")`
  (half-pixel centres, no antialias, TF's float32 lerp order), the optional
  photometric jitter (twins of `adjust_brightness`, `adjust_contrast` (TF's
  fold-in-half mean), `adjust_saturation` and `adjust_hue` (TF's CPU
  kernels' HSV arithmetic), factors drawn as the `random_*` ops draw them,
  then the clip), and the round half to even back to uint8;
* `windowed_rlds_dataset` — repeat (training), interleave of 4 episodes'
  windows in training and 1 in eval, the terminal filter, tf.data's
  shuffle buffer (`pipeline.buffered_shuffle`, seeded), the map, the
  batch / `multistep` / `num_devices` levels with `drop_remainder`, and a
  prefetch thread. The map runs on a pool of threads; each sample's crops
  and jitter come from a generator seeded by (seed, sample index), so the
  stream does not depend on the thread count.
* the episode sources (`make_episode_dataset_from_paths` / `_from_arrays`,
  `tfds_episode_source`), `TableEmbedder` (twin of `InGraphTableEmbedder`:
  unknown text gives the appended zero row), `decode_instruction_bytes_tf`,
  `rlds_episode_to_tensors` and `create_rlds_datasets` over a TFDS
  directory read by `data/tfds.py`.

With `data_service_address` set, `windowed_rlds_dataset` hands the whole
pipeline to the port's data service (`data/service.py`, the counterpart of
tf.data service, sharding OFF): worker processes run it and the consumer
only pulls batches. A worker rebuilds the episode source from its
description (`EpisodeSource.describe`): episode paths with a named reader,
in-memory episodes sent as arrays, or a TFDS split with a `TableEmbedder`
(or the hash embedder). A source built from a custom callable (a `reader=`
function, a host-callable embedder) runs only on a worker in the
consumer's own process, as a `from_generator` source limits JAX's to
colocated workers.

tf.data's training interleave is non-deterministic (`deterministic=False`);
this one is deterministic, and its shuffle draws come from numpy, not TF's
generator, so a training stream holds the same windows as JAX's, not the
same order.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import itertools
import os
import queue
import threading
import uuid
import weakref
from typing import Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from rt1_tpu_torch.data.pipeline import _stack_tree, buffered_shuffle
from rt1_tpu_torch.data.tfds import interleave

# Upper bound on steps an episode when densifying RLDS steps (JAX's constant).
MAX_EPISODE_STEPS = 4096
_INV_255 = np.float32(1.0) / np.float32(255.0)
MAP_THREADS = 4   # threads that run the map (tf.data's AUTOTUNE parallelism)
PREFETCH = 2      # batches the prefetch thread holds


@dataclasses.dataclass
class RldsPipelineConfig:
    window: int = 6
    crop_factor: Optional[float] = 0.95
    height: int = 256
    width: int = 456
    photometric: bool = False
    # Drop windows whose input frames (all but the last) hold a terminal.
    filter_terminal_windows: bool = False
    batch_size: int = 8
    # Extra leading batch levels; None disables a level.
    multistep: Optional[int] = None
    num_devices: Optional[int] = None
    shuffle_buffer: int = 2048
    seed: int = 0
    repeat: bool = True
    # The data service's dispatcher ("tcp://host:port" or "host:port",
    # `data/service.py`); None runs the pipeline in this process. Consumers
    # of one job name share its batches; None: a job of this stream alone.
    data_service_address: Optional[str] = None
    data_service_job_name: Optional[str] = "rt1_tpu_train"
    # "uint8" ships 4x fewer bytes to the card (the model converts there);
    # "float32" keeps the [0, 1] host representation.
    image_dtype: str = "uint8"

    def __post_init__(self):
        if self.image_dtype not in ("uint8", "float32"):
            raise ValueError(f"image_dtype must be uint8|float32, got {self.image_dtype!r}")
        if self.data_service_address:
            from rt1_tpu_torch.data import service

            service.parse_address(self.data_service_address)  # grpc:// and the like raise

    def pipeline_fields(self) -> Dict:
        """The fields that define the stream a worker makes (the service's
        address and job name left out)."""
        fields = dataclasses.asdict(self)
        fields.update(data_service_address=None, data_service_job_name=None)
        return fields


def pad_episode(steps: Dict, window: int) -> Dict:
    """Front-pad by repeating the first step `window - 1` times; `is_first`
    is False on the copies."""
    pad = window - 1
    out = {}
    for key, v in steps.items():
        v = np.asarray(v)
        first = np.repeat(v[:1], pad, axis=0)
        if key == "is_first":
            first = np.zeros_like(first)
        out[key] = np.concatenate([first, v], axis=0)
    return out


def episode_windows(steps: Dict, window: int) -> Dict:
    """All sliding windows of the padded episode, (T, window, ...) a key."""
    padded = pad_episode(steps, window)
    t = padded["is_first"].shape[0] - (window - 1)
    grid = np.arange(t)[:, None] + np.arange(window)[None, :]
    return {k: v[grid] for k, v in padded.items()}


def _window_views(steps: Dict, window: int) -> Iterator[Dict]:
    """The windows of `episode_windows`, one at a time, as views of the
    padded episode (no (T, window, h, w, 3) copy)."""
    padded = pad_episode(steps, window)
    t = padded["is_first"].shape[0] - (window - 1)
    for i in range(t):
        yield {k: v[i:i + window] for k, v in padded.items()}


# ------------------------------------------------------------------ images

def crop_size(h: int, w: int, crop_factor: Optional[float]):
    """(crop_h, crop_w): int(float32(size) * float32(crop_factor))."""
    if crop_factor is None:
        return h, w
    cf = np.float32(crop_factor)
    return int(np.float32(h) * cf), int(np.float32(w) * cf)


def resize_weights(in_size: int, out_size: int):
    """TF's half-pixel bilinear weights (`resize_bilinear_op.cc`):
    (lower index, upper index, float32 lerp) an output position."""
    scale = np.float32(in_size) / np.float32(out_size)
    src = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * scale - np.float32(0.5)
    floor = np.floor(src)
    lower = np.maximum(floor, 0).astype(np.int64)
    upper = np.minimum(np.ceil(src), in_size - 1).astype(np.int64)
    return lower, upper, (src - floor).astype(np.float32)


def crop_resize(frames: np.ndarray, boxes, out_h: int, out_w: int) -> torch.Tensor:
    """uint8 (n, h, w, c) frames, a (top, left, crop_h, crop_w) box each (one
    crop size) -> float32 (n, out_h, out_w, c) in [0, 1]: TF's
    `convert_image_dtype`, crop and `resize(..., "bilinear")`. The
    conversion is elementwise, so it is applied to the gathered samples."""
    src = torch.from_numpy(np.ascontiguousarray(frames))
    ch, cw = boxes[0][2], boxes[0][3]
    ylo, yhi, yl = resize_weights(ch, out_h)
    xlo, xhi, xl = resize_weights(cw, out_w)
    xl_t = torch.from_numpy(xl)[None, :, None]
    yl_t = torch.from_numpy(yl)[:, None, None]
    inv = torch.tensor(_INV_255)
    out = torch.empty((len(boxes), out_h, out_w, src.shape[-1]), dtype=torch.float32)
    for i, (top, left, _, _) in enumerate(boxes):
        frame = src[i]
        r0 = frame.index_select(0, torch.from_numpy(ylo + top))
        r1 = frame.index_select(0, torch.from_numpy(yhi + top))
        cl, cr = torch.from_numpy(xlo + left), torch.from_numpy(xhi + left)
        tl, tr = r0.index_select(1, cl).float() * inv, r0.index_select(1, cr).float() * inv
        bl, br = r1.index_select(1, cl).float() * inv, r1.index_select(1, cr).float() * inv
        top_row = tl + (tr - tl) * xl_t
        bottom = bl + (br - bl) * xl_t
        out[i] = top_row + (bottom - top_row) * yl_t
    return out


def adjust_brightness(image: np.ndarray, delta: float) -> np.ndarray:
    return (image + np.float32(delta)).astype(np.float32)


def _image_mean(image: np.ndarray) -> np.ndarray:
    """AdjustContrastv2's per-channel mean: the pixels folded in half until
    one remains (each round adds the upper half into the lower), times
    float32(1 / pixels)."""
    c = image.shape[-1]
    flat = image.reshape(-1, c)
    n = remaining = flat.shape[0]
    acc = np.empty_like(flat)
    first = True
    while True:
        right = remaining // 2
        left = remaining - right
        if first:
            acc[:right] = flat[left:left + right] + flat[:right]
            if left > right:
                acc[right] = flat[right]
            first = False
        else:
            acc[:right] += acc[left:left + right]
        remaining = left
        if remaining <= 1:
            break
    return acc[0] * (np.float32(1.0) / np.float32(n))


def adjust_contrast(image: np.ndarray, factor: float) -> np.ndarray:
    mean = _image_mean(image)
    return (mean + np.float32(factor) * (image - mean)).astype(np.float32)


def adjust_saturation(image: np.ndarray, factor: float) -> np.ndarray:
    """TF's AdjustSaturation CPU kernel: RGB -> HSV, s x factor clipped to
    [0, 1], HSV -> RGB, in its float32 (and two double) operations."""
    r, g, b = image[..., 0], image[..., 1], image[..., 2]
    v = np.maximum(r, np.maximum(g, b))
    rng = v - np.minimum(r, np.minimum(g, b))
    with np.errstate(divide="ignore", invalid="ignore"):
        s = np.where(v > 0, rng / v, np.float32(0)).astype(np.float32)
        norm = np.float32(1.0) / (np.float32(6.0) * rng)
        h_r = norm * (g - b)
        h_g = (((norm * (b - r)).astype(np.float64) + 2.0 / 6.0)).astype(np.float32)
        h_b = (((norm * (r - g)).astype(np.float64) + 4.0 / 6.0)).astype(np.float32)
    h = np.where(r == v, h_r, np.where(g == v, h_g, h_b))
    h = np.where(rng <= 0, np.float32(0), h)
    h = np.where(h < 0, h + np.float32(1), h).astype(np.float32)
    s = np.minimum(np.float32(1), np.maximum(np.float32(0), s * np.float32(factor)))
    c = s * v
    m = v - c
    dh = h * np.float32(6)
    cat = dh.astype(np.int32)
    fmodu = dh.copy()
    while (fmodu <= 0).any():
        fmodu = np.where(fmodu <= 0, fmodu + np.float32(2), fmodu)
    while (fmodu >= 2).any():
        fmodu = np.where(fmodu >= 2, fmodu - np.float32(2), fmodu)
    x = c * (np.float32(1) - np.abs(fmodu - np.float32(1)))
    zero = np.zeros_like(c)
    table = {0: (c, x, zero), 1: (x, c, zero), 2: (zero, c, x), 3: (zero, x, c),
             4: (x, zero, c), 5: (c, zero, x)}
    out = np.zeros_like(image)
    for ch in range(3):
        val = zero
        for k, rgb in table.items():
            val = np.where(cat == k, rgb[ch], val)
        out[..., ch] = val + m
    return out.astype(np.float32)


def adjust_hue(image: np.ndarray, delta: float) -> np.ndarray:
    """TF's AdjustHue CPU kernel: RGB -> (hue in [0, 6), v_min, v_max), hue
    + delta x 6 wrapped into [0, 6), back to RGB."""
    r, g, b = image[..., 0], image[..., 1], image[..., 2]
    rg = r < g
    c1, c3 = rg & (b < r), rg & ~(b < r) & (b > g)
    c2 = rg & ~(b < r) & ~(b > g)
    c0, c4 = ~rg & (b < g), ~rg & ~(b < g) & (b > r)
    c5 = ~rg & ~(b < g) & ~(b > r)
    v_max = np.select([c1, c3, c2, c0, c4, c5], [g, b, g, r, b, r])
    v_mid = np.select([c1, c3, c2, c0, c4, c5], [r, g, b, g, r, b])
    v_min = np.select([c1, c3, c2, c0, c4, c5], [b, r, r, b, g, g])
    cat = np.select([c0, c1, c2, c3, c4, c5], [0, 1, 2, 3, 4, 5]).astype(np.int32)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = ((v_mid - v_min) / (v_max - v_min)).astype(np.float32)
    h = (cat.astype(np.float32) + np.where(cat % 2 == 0, ratio, np.float32(1) - ratio))
    h = np.where(v_max == v_min, np.float32(0), h).astype(np.float32)
    h = h + np.float32(delta) * np.float32(6)
    while (h < 0).any():
        h = np.where(h < 0, h + np.float32(6), h)
    while (h >= 6).any():
        h = np.where(h >= 6, h - np.float32(6), h)
    cat = h.astype(np.int32)
    ratio = h - cat.astype(np.float32)
    ratio = np.where(cat % 2 == 1, np.float32(1) - ratio, ratio)
    mid = v_min + ratio * (v_max - v_min)
    table = {0: (v_max, mid, v_min), 1: (mid, v_max, v_min), 2: (v_min, v_max, mid),
             3: (v_min, mid, v_max), 4: (mid, v_min, v_max), 5: (v_max, v_min, mid)}
    out = np.empty_like(image)
    for ch in range(3):
        out[..., ch] = np.select([cat == k for k in range(6)], [table[k][ch] for k in range(6)],
                                 table[5][ch])
    return out.astype(np.float32)


def photometric_factors(rng: np.random.Generator):
    """(brightness delta, contrast, saturation, hue delta) for one frame, from
    the ranges of JAX's `random_brightness(0.1)`, `random_contrast(0.8,
    1.2)`, `random_saturation(0.8, 1.2)` and `random_hue(0.02)`."""
    return (float(np.float32(rng.uniform(-0.1, 0.1))), float(np.float32(rng.uniform(0.8, 1.2))),
            float(np.float32(rng.uniform(0.8, 1.2))), float(np.float32(rng.uniform(-0.02, 0.02))))


def photometric(frame: np.ndarray, factors) -> np.ndarray:
    brightness, contrast, saturation, hue = factors
    frame = adjust_brightness(frame, brightness)
    frame = adjust_contrast(frame, contrast)
    frame = adjust_saturation(frame, saturation)
    return adjust_hue(frame, hue)


def crop_boxes(n: int, h: int, w: int, cfg: RldsPipelineConfig, training: bool,
               rng: Optional[np.random.Generator]):
    """(top, left, crop_h, crop_w) for each of n frames: a uniform offset a
    frame in training (`tf.image.random_crop`), the central crop in eval."""
    ch, cw = crop_size(h, w, cfg.crop_factor)
    if cfg.crop_factor is None:
        return [(0, 0, h, w)] * n
    if not training:
        return [((h - ch) // 2, (w - cw) // 2, ch, cw)] * n
    return [(int(rng.integers(0, h - ch + 1)), int(rng.integers(0, w - cw + 1)), ch, cw)
            for _ in range(n)]


def _augment_images(rgb, cfg: RldsPipelineConfig, training: bool,
                    rng: Optional[np.random.Generator] = None, boxes=None) -> np.ndarray:
    """uint8 (window, h, w, 3) -> (window, H, W, 3) of cfg.image_dtype.
    `boxes` fixes the crops (else drawn from `rng`)."""
    rgb = np.asarray(rgb)
    n, h, w = rgb.shape[:3]
    if boxes is None:
        boxes = crop_boxes(n, h, w, cfg, training, rng)
    out = crop_resize(rgb, boxes, cfg.height, cfg.width)
    if training and cfg.photometric:
        frames = out.numpy()
        for i in range(n):
            frames[i] = photometric(frames[i], photometric_factors(rng))
        out = torch.from_numpy(np.clip(frames, np.float32(0), np.float32(1)))
    if cfg.image_dtype == "uint8":
        return torch.round(out * 255.0).to(torch.uint8).numpy()
    return out.numpy()


def window_to_sample(win: Dict, cfg: RldsPipelineConfig, training: bool,
                     rng: Optional[np.random.Generator] = None, boxes=None) -> Dict:
    """One window -> the model's (observations, actions) sample tree."""
    return {
        "observations": {
            "image": _augment_images(win["rgb"], cfg, training, rng, boxes),
            "natural_language_embedding": np.asarray(win["instruction"], np.float32),
        },
        "actions": {
            "terminate_episode": np.asarray(win["is_terminal"]).astype(np.int32),
            "action": np.asarray(win["action"], np.float32),
        },
    }


# ------------------------------------------------------------------ stream

def _repeat(source) -> Iterator:
    """`source` (re-iterable) forever; an empty pass ends the stream."""
    while True:
        empty = True
        for item in source:
            empty = False
            yield item
        if empty:
            return


def _batched(items: Iterator, size: Optional[int]) -> Iterator:
    if not size:
        yield from items
        return
    while True:
        group = list(itertools.islice(items, size))
        if len(group) < size:
            return
        yield _stack_tree(group) if isinstance(group[0], dict) else group


class RldsStream:
    """The batches of `windowed_rlds_dataset`, made ahead by a thread
    (PREFETCH batches) whose map runs on MAP_THREADS threads.
    `close()` stops both; a failure in the thread is raised here."""

    _END = object()

    def __init__(self, windows: Iterator, cfg: RldsPipelineConfig, training: bool):
        self.cfg, self.training = cfg, training
        self._windows = windows
        self._queue: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        self._stop = threading.Event()
        self._pool = concurrent.futures.ThreadPoolExecutor(MAP_THREADS,
                                                           thread_name_prefix="rt1-rlds-map")
        self._thread = threading.Thread(target=self._run, name="rt1-rlds-prefetch", daemon=True)
        self._done = False
        self._thread.start()

    def _samples(self) -> Iterator[Dict]:
        cfg, training = self.cfg, self.training
        pending = collections.deque()
        depth = 2 * MAP_THREADS
        for index, win in enumerate(self._windows):
            rng = np.random.default_rng([cfg.seed, index]) if training else None
            pending.append(self._pool.submit(window_to_sample, win, cfg, training, rng))
            if len(pending) >= depth:
                yield pending.popleft().result()
            if self._stop.is_set():
                return
        while pending:
            yield pending.popleft().result()

    def _run(self) -> None:
        cfg = self.cfg
        try:
            batches = _batched(_batched(_batched(self._samples(), cfg.batch_size),
                                        cfg.multistep), cfg.num_devices)
            for batch in batches:
                while not self._stop.is_set():
                    try:
                        self._queue.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
            self._put(self._END)
        except BaseException as exc:  # handed to the consumer, raised there
            self._put(exc)

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        item = self._queue.get()
        if item is self._END:
            self._done = True
            raise StopIteration
        if isinstance(item, BaseException):
            self._done = True
            raise item
        return item

    def close(self) -> None:
        self._stop.set()
        self._done = True
        self._thread.join(timeout=30)
        self._pool.shutdown(wait=True, cancel_futures=True)


def windowed_rlds_dataset(episode_ds, cfg: RldsPipelineConfig, training: bool = True):
    """Episodes -> shuffled (training), batched, prefetched samples: an
    `RldsStream`, or with `cfg.data_service_address` the data service's
    stream of the job `cfg.data_service_job_name` (`service.DataServiceStream`).

    `episode_ds`: a re-iterable source of dicts of per-episode arrays `rgb`
    (T, h, w, 3) uint8, `instruction` (T, D), `action` (T, A), `is_first`
    and `is_terminal` (T,) bool; an `EpisodeSource` that describes itself
    for a worker in another process."""
    if cfg.data_service_address:
        from rt1_tpu_torch.data import service

        if not isinstance(episode_ds, EpisodeSource):
            items = episode_ds
            episode_ds = EpisodeSource(lambda: iter(items))
        spec = {"source": episode_ds.describe(), "config": cfg.pipeline_fields(),
                "training": training}
        return service.DataServiceStream(cfg.data_service_address, cfg.data_service_job_name,
                                         spec, keep=episode_ds)
    source = _repeat(episode_ds) if cfg.repeat and training else iter(episode_ds)
    windows = interleave(source, lambda steps: _window_views(steps, cfg.window),
                         cycle=4 if training else 1)
    if cfg.filter_terminal_windows:
        windows = (w for w in windows if not np.asarray(w["is_terminal"])[:-1].any())
    if training:
        windows = buffered_shuffle(windows, cfg.shuffle_buffer, cfg.seed)
    return RldsStream(windows, cfg, training)


# Sources without a description, by the token of their "local"
# description: only a worker in this process finds them.
_LOCAL_SOURCES: "weakref.WeakValueDictionary[str, EpisodeSource]" = weakref.WeakValueDictionary()


class EpisodeSource:
    """A re-iterable episode source: each pass calls `make()` anew.
    `description` (data: `source_from_description` rebuilds the source
    from it in another process) or None for a custom callable."""

    def __init__(self, make: Callable[[], Iterator[Dict]], description: Optional[Dict] = None):
        self._make = make
        self.description = description
        self._token = None

    def __iter__(self) -> Iterator[Dict]:
        return iter(self._make())

    def describe(self) -> Dict:
        """The description a worker rebuilds this source from; without
        one, a "local" description that only a worker in this process
        resolves (while this source is alive)."""
        if self.description is not None:
            return self.description
        if self._token is None:
            self._token = uuid.uuid4().hex
            _LOCAL_SOURCES[self._token] = self
        return {"kind": "local", "pid": os.getpid(), "token": self._token}


def _episode_arrays(e: Dict) -> Dict:
    return {
        "rgb": np.asarray(e["rgb"], np.uint8),
        "instruction": np.asarray(e["instruction"], np.float32),
        "action": np.asarray(e["action"], np.float32),
        "is_first": np.asarray(e["is_first"], bool),
        "is_terminal": np.asarray(e["is_terminal"], bool),
    }


def _named_reader(name: str) -> Callable[[str], Dict]:
    if name == "npz":
        from rt1_tpu_torch.data.episodes import load_episode

        return load_episode
    if name == "native":
        from rt1_tpu_torch.data.native import load_episode_native

        return load_episode_native
    raise ValueError(f"unknown episode reader {name!r} (npz | native | a callable)")


def make_episode_dataset_from_paths(paths: Sequence[str], reader=None) -> EpisodeSource:
    """Lazy episodes over a stored dataset: one episode is read a pull, so
    host memory stays bounded by the shuffle buffer. `reader`: None or
    "npz" (the episode store's `load_episode`), "native" (the C++ reader),
    or a callable path -> episode, which a worker in another process
    cannot rebuild."""
    if not paths:
        raise ValueError("no episode paths")
    paths = list(paths)
    description = None
    if reader is None or isinstance(reader, str):
        name = reader or "npz"
        reader = _named_reader(name)
        description = {"kind": "paths", "paths": [os.path.abspath(p) for p in paths],
                       "reader": name}
    return EpisodeSource(lambda: (_episode_arrays(reader(p)) for p in paths), description)


def make_episode_dataset_from_arrays(episodes: Sequence[Dict]) -> EpisodeSource:
    """In-memory episodes (dicts of numpy arrays) -> an episode source; a
    worker receives them as arrays."""
    if not episodes:
        raise ValueError("no episodes")
    episodes = [_episode_arrays(e) for e in episodes]
    return EpisodeSource(lambda: iter(episodes), {"kind": "arrays", "episodes": episodes})


class TableEmbedder:
    """Instruction text -> a row of a precomputed embedding matrix (twin of
    JAX's `InGraphTableEmbedder`); unknown text gives the appended zero
    row."""

    def __init__(self, instructions: Sequence[str], embeddings):
        matrix = np.asarray(embeddings, np.float32)
        self.instructions = [str(s) for s in instructions]
        self.embeddings = np.concatenate([matrix, np.zeros_like(matrix[:1])], axis=0)
        self.table = {s: i for i, s in enumerate(self.instructions)}

    @classmethod
    def from_npz(cls, path: str) -> "TableEmbedder":
        with np.load(path, allow_pickle=False) as z:
            return cls([str(s) for s in z["instructions"]], z["embeddings"])

    def __call__(self, text) -> np.ndarray:
        if isinstance(text, bytes):
            text = text.decode("utf-8")
        return self.embeddings[self.table.get(text, len(self.embeddings) - 1)]

    def describe(self) -> Dict:
        return {"kind": "table", "instructions": self.instructions,
                "embeddings": self.embeddings[:-1]}


def decode_instruction_bytes_tf(instr) -> bytes:
    """(L,) zero-padded code points -> their UTF-8 bytes (twin of
    `tf.strings.unicode_encode` over the non-zero entries)."""
    instr = np.asarray(instr).astype(np.int32)
    return "".join(chr(int(c)) for c in instr[instr != 0]).encode("utf-8")


def rlds_episode_to_tensors(dense_steps: Dict, embedder) -> Dict:
    """Densified RLDS steps -> the per-episode arrays; the first step's
    instruction is embedded once and tiled over the episode."""
    obs = dense_steps["observation"]
    t = np.asarray(dense_steps["is_first"]).shape[0]
    emb = np.asarray(embedder(decode_instruction_bytes_tf(obs["instruction"][0])), np.float32)
    return {
        "rgb": np.asarray(obs["rgb"]).astype(np.uint8, copy=False),
        "instruction": np.tile(emb[None, :], (t, 1)),
        "action": np.asarray(dense_steps["action"], np.float32),
        "is_first": np.asarray(dense_steps["is_first"]).astype(bool),
        "is_terminal": np.asarray(dense_steps["is_terminal"]).astype(bool),
    }


def _host_embedder(embedder):
    """(str -> vector, its description or None): a TableEmbedder, a
    table's .npz path, a callable str -> vector (no description), or None
    (the hash embedder)."""
    if isinstance(embedder, str):
        embedder = TableEmbedder.from_npz(embedder)
    if isinstance(embedder, TableEmbedder):
        return embedder, embedder.describe()
    description = None
    if embedder is None:
        from rt1_tpu_torch.eval.embedding import get_embedder

        embedder, description = get_embedder("hash"), {"kind": "hash"}
    host_fn = embedder
    return (lambda text: host_fn(text.decode("utf-8") if isinstance(text, bytes) else text),
            description)


def tfds_episode_source(dataset_dir: str, split: str, embedder=None) -> EpisodeSource:
    """The episodes of `split` of the TFDS RLDS dataset at `dataset_dir`
    (read by `data/tfds.py`): steps densified, the byte instruction
    decoded and embedded (`embedder` as `create_rlds_datasets` takes it).
    An empty or unknown split raises here."""
    from rt1_tpu_torch.data import tfds

    embed, embed_description = _host_embedder(embedder)
    builder = tfds.TfdsDirectory(dataset_dir)
    builder.file_instructions(split)

    def episodes():
        for episode in builder.episodes(split):
            steps = episode["steps"]
            if len(steps) > MAX_EPISODE_STEPS:
                raise ValueError(f"an episode of {len(steps)} steps exceeds "
                                 f"MAX_EPISODE_STEPS={MAX_EPISODE_STEPS}")
            yield rlds_episode_to_tensors(steps.dense(), embed)

    description = None if embed_description is None else {
        "kind": "tfds", "dataset_dir": os.path.abspath(dataset_dir), "split": split,
        "embedder": embed_description}
    return EpisodeSource(episodes, description)


def source_from_description(description: Dict) -> EpisodeSource:
    """The episode source `EpisodeSource.describe` described (what a data
    service worker runs)."""
    kind = description.get("kind")
    if kind == "paths":
        return make_episode_dataset_from_paths(description["paths"], description["reader"])
    if kind == "arrays":
        return make_episode_dataset_from_arrays(description["episodes"])
    if kind == "tfds":
        embedder = description["embedder"]
        if embedder["kind"] == "table":
            embedder = TableEmbedder(embedder["instructions"], embedder["embeddings"])
        elif embedder["kind"] == "hash":
            embedder = None
        else:
            raise ValueError(f"unknown embedder description {embedder['kind']!r}")
        return tfds_episode_source(description["dataset_dir"], description["split"], embedder)
    if kind == "local":
        source = _LOCAL_SOURCES.get(description["token"]) \
            if description["pid"] == os.getpid() else None
        if source is None:
            raise ValueError(
                "a source built from a custom callable (a reader= function, a host-callable "
                "embedder) runs only on a data service worker in the consumer's own process "
                f"(process {description['pid']}; this worker runs in process {os.getpid()}), "
                "as a from_generator source limits tf.data service to colocated workers: "
                "describe it as data (episode paths with a named reader, in-memory episodes, "
                "a TFDS split with a TableEmbedder, its .npz or the hash embedder) or start a "
                "WorkerServer in the consumer's process")
        return source
    raise ValueError(f"unknown episode source description {kind!r}")


def create_rlds_datasets(dataset_dir: str, cfg: RldsPipelineConfig, embedder=None,
                         splits=("train[:7800]", "train[7800:7900]", "train[7900:8000]")):
    """A stream of `windowed_rlds_dataset` for each of `splits` of the TFDS
    RLDS dataset at `dataset_dir` (the first split trains, the others
    evaluate): steps densified, the byte instruction decoded and embedded,
    windowed, augmented and batched. `embedder`: a `TableEmbedder`, its
    .npz path, or a callable (str -> vector); None is the hash embedder.
    Through the data service each split after the first runs as the job
    `<data_service_job_name>/<split>` (one job name holds one stream)."""
    sources = [tfds_episode_source(dataset_dir, split, embedder) for split in splits]
    out = []
    for i, (split, source) in enumerate(zip(splits, sources)):
        split_cfg = cfg
        if i and cfg.data_service_job_name:
            split_cfg = dataclasses.replace(cfg, data_service_job_name=(
                f"{cfg.data_service_job_name}/{split}"))
        out.append(windowed_rlds_dataset(source, split_cfg, training=(i == 0)))
    return tuple(out)
