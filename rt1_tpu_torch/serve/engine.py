"""Multi-session RT-1 policy engine: one batched control step on the card
(counterpart of `rt1_tpu/serve/engine.py`).

The engine holds `max_sessions` **slots** of rolling network state on the
device, every leaf with a leading slot axis (`seq_idx` is `(max_sessions,)`).
Each session owns one slot, and sessions at different points of their
episode step together: a batch gathers its lanes' rows by slot index, runs
ONE batched `RT1Policy.infer_step` (which rolls and inserts per row — the
JAX engine gets the same effect by vmapping a batch-1 step), gates
padding lanes back to their old rows, and scatters the rows back in place.

Batches ride the smallest **bucket** (default: powers of two up to
`max_sessions`) that fits. PyTorch runs eagerly, so there is no compile:
`warmup` runs every bucket once on all-padding lanes (the kernel builds,
cuDNN picks its algorithms) and `compile_count` counts the buckets warmed,
pinned at `len(buckets)`. PyTorch keeps cuDNN's execution plans and cuBLAS
handles per thread, so a frontend warms every thread that will step the
engine. `steps_total` counts every batched step, warm-up
included — with the fused attention kernel each step launches it once per
decoder layer.

`dispatch_batch` does the host work and enqueues the device work under
the lock; `collect_batch` waits for the results outside it, so a
double-buffering frontend can enqueue batch N+1 while N runs. Sessions
riding an uncollected step are protected from LRU eviction.

The instruction-embedding cache is keyed on the instruction's CLIP BPE ids
(`_embed_key`, as in JAX), which folds case and spacing variants into one
entry.

Serving modes, as in the JAX engine:

* `inference_dtype` f32 | bf16 | int8 (`models/quant.py`): the policy
  holds the SERVING weights; `prepare_variables` derives them from an f32
  master state_dict, and `master_state` gives the spec a standby is held
  to. `swap_variables` validates a standby master against that spec
  (names, shapes, float32, finite), prepares it off the lock and copies it
  into the served tensors under the lock, between two batches: a step
  already enqueued runs on the old weights (the copies queue behind it on
  the stream), the next on the new. No bucket is warmed again, so
  `compile_count` stays at `len(buckets)`.
* `cached_inference`: every slot also holds its K/V cache (`kv_cache`,
  at the compute dtype) and a step is `infer_step_cached`; a swap
  rebuilds every slot's cache from its stored image tokens. Invalidations
  are counted by cause (`swap`, `reset`, `evict`).
* Session migration: `state_schema`, `export_session` and
  `import_session` move one slot's rolling state (and cache) between
  engines; a JAX engine's snapshot has the same schema.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rt1_tpu_torch.models import quant

EMBEDDING_DIM = 512
EMBED_CACHE_SIZE = 256
EPS = np.finfo(np.float32).eps


class SessionError(RuntimeError):
    """Invalid session usage (duplicate id in one batch, unknown release)."""


class SlotContentionError(SessionError):
    """No slot can be reclaimed right now — every slot belongs to this batch
    or to a step still in flight. Transient; the server answers 503 busy."""


def pow2_buckets(max_sessions: int) -> List[int]:
    """Powers of two up to (and always including) `max_sessions`."""
    out = []
    b = 1
    while b < max_sessions:
        out.append(b)
        b *= 2
    out.append(max_sessions)
    return out


def normalize_buckets(buckets, max_sessions: int) -> Tuple[int, ...]:
    """Sorted, unique, within [1, max_sessions], topped by `max_sessions`."""
    if buckets is None:
        return (max_sessions,)
    out = sorted({int(b) for b in buckets})
    if not out or out[0] < 1 or out[-1] > max_sessions:
        raise ValueError(f"buckets {list(buckets)} must be within [1, {max_sessions}]")
    if out[-1] != max_sessions:
        out.append(max_sessions)
    return tuple(out)


class StepHandle:
    """One dispatched batched step, handed from `dispatch_batch` to
    `collect_batch`; single-use."""

    __slots__ = (
        "items", "errors", "slots_by_sid", "lane_by_sid", "fresh",
        "bucket", "active_count", "out", "collected",
    )

    def __init__(self, items):
        self.items = list(items)
        self.errors: List[Optional[Exception]] = [None] * len(self.items)
        self.slots_by_sid: Dict[str, int] = {}
        self.lane_by_sid: Dict[str, int] = {}
        self.fresh: set = set()
        self.bucket: Optional[int] = None  # None: nothing was dispatched
        self.active_count = 0
        self.out = None
        self.collected = False


class PolicyEngine:
    """Holds N session slots of rolling network state in one device batch."""

    def __init__(
        self,
        policy,
        *,
        max_sessions: int = 8,
        embedder: Optional[Callable[[str], np.ndarray]] = None,
        buckets: Optional[Sequence[int]] = None,
        action_mean: float = 0.0,
        action_std: float = 1.0,
        action_minimum: float = -0.03,
        action_maximum: float = 0.03,
        inference_dtype: str = "f32",
        prepare_variables: Optional[Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]] = None,
        master_state: Optional[Dict[str, torch.Tensor]] = None,
        cached_inference: bool = False,
    ):
        if max_sessions < 1:
            raise ValueError(f"max_sessions must be >= 1, got {max_sessions}")
        self.buckets = normalize_buckets(buckets, max_sessions)
        self.policy = policy.eval().requires_grad_(False)
        self.device = policy.device
        self.dtype = str(policy.compute_dtype).replace("torch.", "")
        self.inference_dtype = inference_dtype
        self._prepare = prepare_variables
        spec = master_state if master_state is not None else policy.state_dict()
        self._master_spec = [(k, tuple(v.shape), v.dtype) for k, v in spec.items()]
        self.reloads = 0  # successful swap_variables hot-swaps
        self.cached_inference = bool(cached_inference)
        self.cache_invalidations = {"swap": 0, "reset": 0, "evict": 0}
        self.cache_cached_steps = 0   # lanes stepped through the cached step
        self.cache_rebuild_steps = 0  # per-slot cache rebuilds
        self.max_sessions = max_sessions
        # De-normalisation of the decoded action: `action * max(std, eps) +
        # mean`, clipped to [minimum, maximum]; the defaults keep the
        # decoded action and clip it to the env's per-step limit.
        self.action_mean = action_mean
        self.action_std = action_std
        self.action_minimum = action_minimum
        self.action_maximum = action_maximum
        self._embedder = embedder
        self._embed_cache: collections.OrderedDict = collections.OrderedDict()
        self._tokenizer = None  # the cache keys' CLIP BPE, built at first use
        self.embed_calls = 0  # embedder invocations (cache misses)

        self._state = policy.initial_state(max_sessions, cached=self.cached_inference)

        self._lock = threading.RLock()
        self._embed_lock = threading.Lock()
        # OrderedDict doubles as the LRU order.
        self._sessions: collections.OrderedDict = collections.OrderedDict()
        self._free: List[int] = list(range(max_sessions))
        self.evictions = 0
        self._inflight_sessions: collections.Counter = collections.Counter()
        self.batches_in_flight = 0

        self._obs_shapes: Optional[Dict[str, Tuple[int, ...]]] = None
        self._warm: set = set()
        self.steps_total = 0  # batched steps run, warm-up included

    @property
    def compile_count(self) -> int:
        """Buckets warmed (each has run once); pinned at len(buckets)."""
        return len(self._warm)

    @property
    def window(self) -> int:
        return int(self.policy.time_sequence_length)

    # ------------------------------------------------------------ embedding

    def _embed_key(self, text: str) -> bytes:
        """The embedding cache's key for `text`: its CLIP BPE ids (the
        byte-level `default_tokenizer`), so case and whitespace variants
        that tokenize alike share one entry; past the 77-token context, the
        raw bytes. Shared by the hit path and the migration helpers, so
        they never disagree (JAX's `_embed_key`)."""
        if self._tokenizer is None:
            from rt1_tpu_torch.text.clip_bpe import default_tokenizer

            self._tokenizer = default_tokenizer()
        try:
            return self._tokenizer.tokenize_text(text).tobytes()
        except ValueError:  # longer than the 77-token CLIP context
            return b"raw\x00" + text.encode("utf-8")

    def _embed_instruction(self, text: str) -> np.ndarray:
        """Instruction text -> embedding, LRU-cached on `_embed_key`."""
        if self._embedder is None:
            raise SessionError(
                "request carried an 'instruction' string but the engine has "
                "no embedder; pass embedder= (rt1_tpu_torch.eval.embedding."
                "get_embedder) or send 'natural_language_embedding' directly"
            )
        key = self._embed_key(text)
        with self._embed_lock:
            cached = self._embed_cache.get(key)
            if cached is not None:
                self._embed_cache.move_to_end(key)
                return cached
        vec = np.asarray(self._embedder(text), np.float32)
        with self._embed_lock:
            self.embed_calls += 1
            self._embed_cache[key] = vec
            while len(self._embed_cache) > EMBED_CACHE_SIZE:
                self._embed_cache.popitem(last=False)
        return vec

    def cached_embedding(self, text: str) -> Optional[np.ndarray]:
        """The cached embedding of `text`, or None: no embedder call, no
        LRU refresh (the session exporter reads it)."""
        if self._embedder is None:
            return None
        key = self._embed_key(text)
        with self._embed_lock:
            cached = self._embed_cache.get(key)
        return None if cached is None else np.asarray(cached, np.float32)

    def seed_embedding(self, text: str, vec) -> None:
        """Put a migrated (instruction, embedding) pair in the cache, so the
        imported session's next step skips the embedder; not counted in
        `embed_calls`."""
        if self._embedder is None:
            return
        key = self._embed_key(text)
        with self._embed_lock:
            if key not in self._embed_cache:
                self._embed_cache[key] = np.asarray(vec, np.float32)
                while len(self._embed_cache) > EMBED_CACHE_SIZE:
                    self._embed_cache.popitem(last=False)

    # ------------------------------------------------------------ buckets

    def bucket_for(self, active: int) -> int:
        """The smallest configured bucket that fits `active` items."""
        if active < 1 or active > self.max_sessions:
            raise ValueError(f"active={active} outside [1, {self.max_sessions}]")
        for b in self.buckets:
            if b >= active:
                return b
        return self.buckets[-1]

    def _step(self, obs: Dict[str, np.ndarray], slots: np.ndarray, active: np.ndarray):
        """Gather `slots`' rows, step them, gate padding lanes back, scatter.
        `slots` are distinct, so the scatter is race-free. Under the lock."""
        dev = self.device
        with torch.no_grad():
            obs_t = {k: torch.from_numpy(v).to(dev) for k, v in obs.items()}
            slots_t = torch.from_numpy(slots.astype(np.int64)).to(dev)
            active_t = torch.from_numpy(active).to(dev)
            lanes = {k: v.index_select(0, slots_t) for k, v in self._state.items()}
            step = self.policy.infer_step_cached if self.cached_inference else self.policy.infer_step
            # A MoE FFN routes each lane on its own: a session's capacity
            # and dropped tokens never depend on its bucket-mates or on the
            # padding lanes (the JAX engine vmaps a batch-1 step).
            out, stepped = step(obs_t, lanes, per_row=True)
            for k, full in self._state.items():
                new = stepped[k].to(full.dtype)
                gate = active_t.view((-1,) + (1,) * (new.dim() - 1))
                full.index_copy_(0, slots_t, torch.where(gate, new, lanes[k]))
        self.steps_total += 1
        return out

    def _set_obs_shapes(self, obs_shapes: Dict[str, Tuple[int, ...]]) -> None:
        if self._obs_shapes is None:
            self._obs_shapes = dict(obs_shapes)
        elif self._obs_shapes != obs_shapes:
            raise ValueError(
                f"observation shapes {obs_shapes} do not match the warmed step "
                f"{self._obs_shapes}; the engine serves one fixed shape per process"
            )

    def _warm_buckets(self) -> None:
        """Run every bucket once on all-padding lanes (no slot's state
        changes). Under the lock, after the shapes are set."""
        for b in self.buckets:
            obs = {k: np.zeros((b,) + s, np.float32) for k, s in self._obs_shapes.items()}
            self._step(obs, np.arange(b, dtype=np.int64), np.zeros((b,), np.bool_))
            self._warm.add(b)
        if self.cached_inference:
            with torch.no_grad():  # the rebuild's shapes, result discarded
                self.policy.rebuild_cache(self._state)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self, image_shape: Sequence[int], embed_dim: int = EMBEDDING_DIM) -> None:
        """Run every bucket once in the calling thread before traffic
        arrives, so no request pays the kernel build or cuDNN's first-call
        setup. Call it on each thread that will step the engine."""
        with self._lock:
            self._set_obs_shapes(
                {"image": tuple(image_shape), "natural_language_embedding": (embed_dim,)}
            )
            self._warm_buckets()

    # ------------------------------------------------------------ sessions

    def _slot_for(self, session_id: str, protected: frozenset = frozenset()) -> int:
        """The session's slot (refreshing its LRU place), or a new zeroed
        one: a free slot, else the least recently used session's slot that
        is not `protected` (this batch and every in-flight step)."""
        slot = self._sessions.get(session_id)
        if slot is not None:
            self._sessions.move_to_end(session_id)
            return slot
        if self._free:
            slot = self._free.pop()
        else:
            victim = next((s for s in self._sessions if s not in protected), None)
            if victim is None:
                raise SlotContentionError(
                    f"no reclaimable slot for session {session_id!r}: all "
                    f"{self.max_sessions} slots belong to this batch or an "
                    "in-flight step; retry after the step completes"
                )
            slot = self._sessions.pop(victim)
            self.evictions += 1
            if self.cached_inference:
                self.cache_invalidations["evict"] += 1
        self._sessions[session_id] = slot
        self._zero_slot(slot)
        return slot

    def _zero_slot(self, slot: int) -> None:
        with torch.no_grad():
            for v in self._state.values():
                v[slot] = 0

    def reset(self, session_id: str) -> int:
        """Zero a session's rolling window (allocating a slot if new)."""
        with self._lock:
            known = session_id in self._sessions
            slot = self._slot_for(session_id, protected=frozenset(self._inflight_sessions))
            self._zero_slot(slot)
            if self.cached_inference and known:
                self.cache_invalidations["reset"] += 1
            return slot

    def release(self, session_id: str) -> None:
        """Forget a session and return its slot to the free list."""
        with self._lock:
            slot = self._sessions.pop(session_id, None)
            if slot is None:
                raise SessionError(f"unknown session {session_id!r}")
            self._free.append(slot)

    @property
    def active_sessions(self) -> int:
        with self._lock:
            return len(self._sessions)

    def session_ids(self) -> List[str]:
        with self._lock:
            return list(self._sessions)

    def _session_tensors(self, session_id: str) -> Dict[str, torch.Tensor]:
        with self._lock:
            slot = self._sessions.get(session_id)
            if slot is None:
                raise SessionError(f"unknown session {session_id!r}")
            return {k: v[slot].cpu() for k, v in self._state.items()}

    def session_state(self, session_id: str) -> Dict[str, Any]:
        """One session's state rows on the host (no LRU refresh): numpy
        arrays, but a bfloat16 leaf (numpy has no such dtype) stays a CPU
        tensor."""
        return {
            k: v if v.dtype == torch.bfloat16 else v.numpy()
            for k, v in self._session_tensors(session_id).items()
        }

    # ------------------------------------------------------------ hot swap

    @property
    def serving_param_bytes(self) -> int:
        """Bytes of the served weights on the device (int8 weights and
        their scales at their own size)."""
        return quant.tree_bytes(self.policy.state_dict())

    @property
    def master_param_bytes(self) -> int:
        """Bytes of the f32 master tree a reload brings."""
        return int(sum(int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
                       for _, shape, dtype in self._master_spec))

    @property
    def cache_bytes_per_slot(self) -> int:
        """Device bytes of one session's K/V cache (0 without caching)."""
        kv = self._state.get("kv_cache")
        return 0 if kv is None else kv.numel() * kv.element_size() // self.max_sessions

    def swap_variables(self, new_state: Dict[str, Any]) -> Dict[str, Any]:
        """Zero-downtime weight swap from an f32 master state_dict: held to
        the master spec (same keys in order, shapes, dtypes; finite), turned
        into serving weights by `prepare_variables` off the lock, then copied
        into the served tensors under it. Raises ValueError, with the old
        weights still serving, on any mismatch: a standby already cast or
        quantized to a serving dtype is refused. With `cached_inference`,
        every slot's cache is rebuilt under the new weights."""
        standby = [(k, torch.as_tensor(v)) for k, v in new_state.items()]
        if [k for k, _ in standby] != [k for k, _, _ in self._master_spec]:
            raise ValueError(
                "swap_variables: the standby's leaves differ from the master tree "
                f"({len(standby)} vs {len(self._master_spec)}); a hot swap needs a "
                "checkpoint of the same model")
        for (key, new), (_, shape, dtype) in zip(standby, self._master_spec):
            if tuple(new.shape) != shape or new.dtype != dtype:
                raise ValueError(
                    f"swap_variables: leaf {key!r} is {tuple(new.shape)}/{new.dtype}, the master "
                    f"spec {shape}/{dtype}; a hot swap takes the f32 master checkpoint")
        bad = [k for k, v in standby if v.is_floating_point() and not torch.isfinite(v).all()]
        if bad:
            raise ValueError(f"swap_variables: non-finite values in {bad[:4]} ({len(bad)} "
                             "leaves); the old weights stay live")
        master = dict(standby)
        serving = self._prepare(master) if self._prepare is not None else {
            k: v.to(self.device) for k, v in master.items()}
        current = self.policy.state_dict()
        if sorted(serving) != sorted(current):
            raise ValueError("swap_variables: the prepared serving tree's leaves differ from "
                             "the served tree's")
        for key, old in current.items():
            new = serving[key]
            if tuple(new.shape) != tuple(old.shape) or new.dtype != old.dtype:
                raise ValueError(f"swap_variables: prepared leaf {key!r} is {tuple(new.shape)}/"
                                 f"{new.dtype}, served {tuple(old.shape)}/{old.dtype}")
        caches_rebuilt = 0
        with self._lock, torch.no_grad():
            for key, old in current.items():
                old.copy_(serving[key])
            self.reloads += 1
            if self.cached_inference:
                self._state = self.policy.rebuild_cache(self._state)
                self.cache_invalidations["swap"] += 1
                caches_rebuilt = len(self._sessions)
                self.cache_rebuild_steps += caches_rebuilt
        result = {"params_swapped": len(serving), "param_bytes": quant.tree_bytes(serving),
                  "inference_dtype": self.inference_dtype}
        if self.cached_inference:
            result["caches_rebuilt"] = caches_rebuilt
        return result

    # ------------------------------------------------------------ migration

    def state_schema(self) -> List[Tuple[str, Tuple[int, ...], str]]:
        """The per-slot state contract, (leaf, per-slot shape, dtype name)
        sorted by leaf: the JAX engine's, `kv_cache` included when cached."""
        return sorted(
            (k, tuple(v.shape[1:]), str(v.dtype).replace("torch.", ""))
            for k, v in self._state.items()
        )

    def export_session(self, session_id: str) -> Dict[str, Any]:
        """One slot's whole rolling state (CPU tensors) with the schema that
        `import_session` checks. Pure read: no LRU refresh."""
        return {
            "session_id": session_id,
            "cached_inference": self.cached_inference,
            "schema": self.state_schema(),
            "state": self._session_tensors(session_id),
        }

    def import_session(self, snapshot: Dict[str, Any], session_id: Optional[str] = None) -> int:
        """Write an exported session (numpy arrays or tensors, from this
        engine's `export_session` or a JAX engine's) into a slot: leaf names,
        per-slot shapes and dtypes must match this engine's schema and float
        leaves be finite, else ValueError with the engine untouched. Returns
        the slot."""
        sid = session_id or snapshot.get("session_id")
        if not sid:
            raise SessionError("import_session: no session id in snapshot or argument")
        state = snapshot.get("state")
        if not isinstance(state, dict):
            raise ValueError("import_session: snapshot has no 'state'")
        state = {k: torch.as_tensor(v) for k, v in state.items()}
        expected = self.state_schema()
        got = sorted((k, tuple(v.shape), str(v.dtype).replace("torch.", ""))
                     for k, v in state.items())
        if [k for k, _, _ in got] != [k for k, _, _ in expected]:
            raise ValueError(
                f"import_session: state leaves {[k for k, _, _ in got]} do not match this "
                f"engine's {[k for k, _, _ in expected]}: cached_inference or model mismatch")
        for (k, shape, dtype), (_, eshape, edtype) in zip(got, expected):
            if shape != eshape or dtype != edtype:
                raise ValueError(f"import_session: leaf {k!r} is {shape}/{dtype}, this engine "
                                 f"expects {eshape}/{edtype}")
        bad = [k for k, v in state.items() if v.is_floating_point() and not torch.isfinite(v).all()]
        if bad:
            raise ValueError(f"import_session: non-finite values in {bad}")
        with self._lock, torch.no_grad():
            slot = self._slot_for(sid, protected=frozenset(self._inflight_sessions))
            for k, v in state.items():
                self._state[k][slot] = v.to(self.device)
            return slot

    # ------------------------------------------------------------ stepping

    def _resolve_obs(self, obs: Dict[str, Any]) -> Dict[str, np.ndarray]:
        image = np.asarray(obs["image"], np.float32)
        if "natural_language_embedding" in obs:
            embedding = np.asarray(obs["natural_language_embedding"], np.float32)
        else:
            embedding = self._embed_instruction(obs["instruction"])
        return {"image": image, "natural_language_embedding": embedding}

    def dispatch_batch(self, items: Sequence[Tuple[str, Dict[str, Any]]]) -> StepHandle:
        """Phase 1: resolve observations, assign slots, enqueue the smallest
        bucket that fits. Per-item failures become per-item errors."""
        handle = StepHandle(items)
        if not handle.items:
            return handle
        if len(handle.items) > self.max_sessions:
            raise SessionError(
                f"batch of {len(handle.items)} exceeds max_sessions={self.max_sessions}"
            )
        ids = [sid for sid, _ in handle.items]
        if len(set(ids)) != len(ids):
            raise SessionError(f"duplicate session ids in one batch: {ids}")

        resolved: List[Optional[Dict[str, np.ndarray]]] = []
        for i, (_, obs) in enumerate(handle.items):
            try:
                resolved.append(self._resolve_obs(obs))
            except Exception as exc:  # noqa: BLE001 - isolated per item
                resolved.append(None)
                handle.errors[i] = exc
        good = [
            (i, sid, obs)
            for i, ((sid, _), obs) in enumerate(zip(handle.items, resolved))
            if obs is not None
        ]
        if not good:
            return handle
        with self._lock:
            if self._obs_shapes is None:
                # First use warms every bucket at the first item's shapes.
                self._set_obs_shapes({k: v.shape for k, v in good[0][2].items()})
            if not self._warm:
                self._warm_buckets()
            kept = []
            for i, sid, obs in good:
                bad = next((k for k, v in obs.items() if v.shape != self._obs_shapes[k]), None)
                if bad is not None:
                    handle.errors[i] = ValueError(
                        f"session {sid!r} obs {bad!r} shape {obs[bad].shape} != "
                        f"served {self._obs_shapes[bad]}"
                    )
                else:
                    kept.append((i, sid, obs))

            handle.fresh.update(sid for _, sid, _ in kept if sid not in self._sessions)
            protected = frozenset(sid for _, sid, _ in kept) | frozenset(self._inflight_sessions)
            for idx, sid, _ in list(kept):
                try:
                    if sid in self._sessions:
                        handle.slots_by_sid[sid] = self._slot_for(sid)
                    else:
                        handle.slots_by_sid[sid] = self._slot_for(sid, protected=protected)
                except SlotContentionError as exc:
                    handle.errors[idx] = exc
                    handle.fresh.discard(sid)
                    kept = [k for k in kept if k[1] != sid]
            if not kept:
                return handle

            bucket = self.bucket_for(len(kept))
            batch_obs = {
                k: np.zeros((bucket,) + tuple(shape), np.float32)
                for k, shape in self._obs_shapes.items()
            }
            active = np.zeros((bucket,), np.bool_)
            slots = np.zeros((bucket,), np.int64)
            for lane, (_, sid, obs) in enumerate(kept):
                handle.lane_by_sid[sid] = lane
                slots[lane] = handle.slots_by_sid[sid]
                for k, v in obs.items():
                    batch_obs[k][lane] = v
                active[lane] = True
            # Padding lanes ride distinct unused slots and write their old
            # rows back, so no batch composition touches a neighbour.
            used = set(int(s) for s in slots[: len(kept)])
            pads = [s for s in range(self.max_sessions) if s not in used]
            for lane in range(len(kept), bucket):
                slots[lane] = pads[lane - len(kept)]

            handle.out = self._step(batch_obs, slots, active)
            handle.bucket = bucket
            handle.active_count = len(kept)
            if self.cached_inference:
                self.cache_cached_steps += len(kept)
            for _, sid, _ in kept:
                self._inflight_sessions[sid] += 1
            self.batches_in_flight += 1
        return handle

    def collect_batch(self, handle: StepHandle) -> List[Dict[str, Any]]:
        """Phase 2: wait for the handle's step (outside the lock) and build
        one result per item: the de-normalised, clipped `action` and the
        raw `action_tokens`, or `{"error": ...}`."""
        if handle.collected:
            raise RuntimeError("StepHandle already collected")
        handle.collected = True
        actions = tokens = terminate = None
        if handle.out is not None:
            try:
                actions = handle.out["action"].float().cpu().numpy()
                tokens = handle.out["action_tokens"].cpu().numpy()
                if "terminate_episode" in handle.out:
                    terminate = handle.out["terminate_episode"].cpu().numpy()
            finally:
                # Always release the eviction protection, even if the fetch
                # fails: a leaked count would pin its sessions' slots.
                with self._lock:
                    for sid in handle.lane_by_sid:
                        self._inflight_sessions[sid] -= 1
                        if self._inflight_sessions[sid] <= 0:
                            del self._inflight_sessions[sid]
                    self.batches_in_flight -= 1

        results: List[Dict[str, Any]] = []
        for (sid, _), error in zip(handle.items, handle.errors):
            if error is not None:
                results.append({"error": error})
                continue
            lane = handle.lane_by_sid[sid]
            action = actions[lane] * max(self.action_std, EPS) + self.action_mean
            action = np.clip(action, self.action_minimum, self.action_maximum)
            result = {
                "action": action.astype(np.float32),
                "action_tokens": tokens[lane],
                "session_started": sid in handle.fresh,
            }
            if terminate is not None:
                result["terminate_episode"] = int(terminate[lane])
            results.append(result)
        return results

    def act_batch(self, items: Sequence[Tuple[str, Dict[str, Any]]]) -> List[Dict[str, Any]]:
        """One batched control step for `items` = [(session_id, obs)]. Each
        obs carries `image` (H, W, 3) float32 in [0, 1] plus either
        `natural_language_embedding` (D,) or `instruction` (str)."""
        return self.collect_batch(self.dispatch_batch(items))

    def act(self, session_id: str, obs: Dict[str, Any]) -> Dict[str, Any]:
        """Single-session wrapper over `act_batch`; re-raises the item's error."""
        result = self.act_batch([(session_id, obs)])[0]
        if "error" in result:
            raise result["error"]
        return result
