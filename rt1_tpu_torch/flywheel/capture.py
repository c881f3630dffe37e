"""Serve-side episode capture: sessions become training episodes.

The port's copy of `rt1_tpu/flywheel/capture.py` (the port imports nothing
of the JAX package): the same episode files, key for key.

`EpisodeCaptureSink` hangs off the serving app (`--capture_dir`, OFF by
default): every successful `/act` appends one step — the uint8 frame the
client sent, the de-normalized action the policy answered, its action
tokens, and the instruction (embedding, or text embedded once at finalize)
— to that session's buffer, and a session END writes the buffer as a
standard episode `.npz` (`data/episodes.py` schema: rgb / action /
is_first / is_terminal / instruction, plus `action_tokens`, the `task` id,
and the `outcome` that ended it). The files are exactly what
`data/pack.py::append_shard` packs and what `data/collect.py`
consumers already read — captured traffic re-enters
training with zero new formats.

A session ends when the client `/release`s or `/reset`s it, when the
policy emits `terminate_episode`, when the engine's LRU reclaim started it
a fresh window (`session_started` on an already-open buffer), when the
open-session bound evicts the oldest buffer, or at drain.

Bounded everywhere, opt-in everywhere: `max_steps` caps a runaway
session's buffer (further steps are counted and dropped), `max_episodes`
is a disk ring (oldest capture files pruned), `max_open_sessions` caps
buffer memory, and a `None` sink (the default) leaves the serve path
byte-identical — the hot path pays one `is None` check. Writes are
tmp+rename atomic so the packer/sweeper never reads a torn file, and a
failed write (full disk; chaos site `capture_write@N`) drops that episode
and keeps serving.

Privacy note: capture records client-sent observations.
It is OFF unless an operator passes `--capture_dir`, and the bounds above
are also retention bounds.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from rt1_tpu_torch.data import episodes as ep_lib
from rt1_tpu_torch.resilience import faults

EPISODE_PREFIX = "episode_"


class _SessionBuffer:
    __slots__ = (
        "images", "actions", "tokens", "embeddings", "texts", "task",
        "terminates", "dropped_steps", "opened_unix",
    )

    def __init__(self):
        self.images: List[np.ndarray] = []
        self.actions: List[np.ndarray] = []
        self.tokens: List[np.ndarray] = []
        self.embeddings: List[Optional[np.ndarray]] = []
        self.texts: List[Optional[str]] = []
        self.task: Optional[str] = None
        self.terminates: List[bool] = []
        self.dropped_steps = 0
        self.opened_unix = time.time()


class EpisodeCaptureSink:
    """Bounded, opt-in sink turning served sessions into episode files."""

    def __init__(
        self,
        capture_dir: str,
        *,
        max_episodes: int = 512,
        max_steps: int = 512,
        min_steps: int = 2,
        max_open_sessions: int = 64,
        embed_fn: Optional[Callable[[str], np.ndarray]] = None,
    ):
        if max_episodes < 1 or max_steps < 1 or max_open_sessions < 1:
            raise ValueError(
                "capture bounds must be >= 1 "
                f"(max_episodes={max_episodes}, max_steps={max_steps}, "
                f"max_open_sessions={max_open_sessions})"
            )
        self.capture_dir = capture_dir
        self.max_episodes = max_episodes
        self.max_steps = max_steps
        self.min_steps = min_steps
        self.max_open_sessions = max_open_sessions
        self._embed_fn = embed_fn
        self._embed_cache: Dict[str, np.ndarray] = {}
        os.makedirs(capture_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._buffers: Dict[str, _SessionBuffer] = {}
        # File names must be unique across replicas (whose captures meet
        # in one staging dir) and across sink generations: pid alone
        # collides for two sinks in one process, so add a random token.
        self._token = f"{os.getpid()}_{os.urandom(3).hex()}"
        self._seq = 0
        self._writes = 0  # write ATTEMPTS (the capture_write fault index)
        # Disk ring: adopt files from a previous sink generation (a
        # respawned replica) oldest-first so the bound covers them too.
        # The mtime key must tolerate a file vanishing between listdir and
        # stat — the fleet sweep moves completed files concurrently, and a
        # raced stat must not crash the replica at startup.
        def _mtime(path: str) -> float:
            try:
                return os.path.getmtime(path)
            except OSError:
                return 0.0

        self._ring: List[str] = sorted(
            (
                os.path.join(capture_dir, f)
                for f in os.listdir(capture_dir)
                if f.startswith(EPISODE_PREFIX) and f.endswith(".npz")
            ),
            key=_mtime,
        )
        # Counters (read lock-free by stats()).
        self.episodes_total = 0
        self.steps_total = 0
        self.dropped_steps_total = 0
        self.dropped_episodes_total = 0
        self.write_errors_total = 0
        self.pruned_total = 0

    # ------------------------------------------------------------ recording

    def record_step(
        self,
        session_id: str,
        *,
        image: np.ndarray,
        action: Sequence[float],
        action_tokens: Optional[Sequence[int]] = None,
        embedding: Optional[np.ndarray] = None,
        instruction: Optional[str] = None,
        task: Optional[str] = None,
        session_started: bool = False,
        terminate: bool = False,
    ) -> None:
        """Append one served step; never raises into the request path.

        `image` is the float [0, 1] (H, W, 3) frame the engine saw (or
        already uint8); `session_started` on an open buffer means the
        engine gave this session a fresh window (LRU eviction) — the old
        buffer is finalized as its own episode first.
        """
        try:
            self._record_step(
                session_id, image, action, action_tokens, embedding,
                instruction, task, session_started, terminate,
            )
        except Exception:  # noqa: BLE001 - capture must not fail serving
            with self._lock:
                self.write_errors_total += 1
                self._buffers.pop(session_id, None)

    def _record_step(
        self, session_id, image, action, action_tokens, embedding,
        instruction, task, session_started, terminate,
    ) -> None:
        image = np.asarray(image)
        if image.dtype != np.uint8:
            # Round-trips exactly for frames that arrived as raw uint8
            # (`image_b64`), quantizes float-list payloads once.
            image = np.clip(np.rint(image * 255.0), 0, 255).astype(np.uint8)
        flush = None
        expired = None
        with self._lock:
            buf = self._buffers.get(session_id)
            if buf is not None and session_started:
                # The engine reclaimed this session's slot and restarted
                # its window — what we buffered is a complete episode of
                # its own, not a prefix of the new one.
                flush = self._buffers.pop(session_id)
            buf = self._buffers.get(session_id)
            if buf is None:
                if len(self._buffers) >= self.max_open_sessions:
                    # Oldest open buffer pays for the bound; it still has
                    # real served steps, so it is written, not dropped.
                    oldest = min(
                        self._buffers,
                        key=lambda s: self._buffers[s].opened_unix,
                    )
                    expired = self._buffers.pop(oldest)
                buf = _SessionBuffer()
                self._buffers[session_id] = buf
            if buf.task is None and task:
                buf.task = task
            if len(buf.images) >= self.max_steps:
                buf.dropped_steps += 1
                self.dropped_steps_total += 1
            else:
                buf.images.append(image)
                buf.actions.append(
                    np.asarray(action, np.float32).reshape(-1)
                )
                buf.tokens.append(
                    np.asarray(action_tokens, np.int64).reshape(-1)
                    if action_tokens is not None
                    else np.zeros((0,), np.int64)
                )
                buf.embeddings.append(
                    np.asarray(embedding, np.float32).reshape(-1)
                    if embedding is not None
                    else None
                )
                buf.texts.append(instruction)
                buf.terminates.append(bool(terminate))
            done = None
            if terminate:
                done = self._buffers.pop(session_id, None)
        if expired is not None:
            self._write_episode(expired, "expired")
        if flush is not None:
            self._write_episode(flush, "evicted")
        if done is not None:
            self._write_episode(done, "terminated")

    def finalize(self, session_id: str, outcome: str) -> bool:
        """Close a session's buffer and write it (release/reset paths).
        Returns True when an episode file was written."""
        with self._lock:
            buf = self._buffers.pop(session_id, None)
        if buf is None:
            return False
        return self._write_episode(buf, outcome)

    def drain(self) -> int:
        """Finalize every open session (serve shutdown); returns writes."""
        with self._lock:
            buffers = list(self._buffers.values())
            self._buffers.clear()
        return sum(
            1 for buf in buffers if self._write_episode(buf, "drain")
        )

    @property
    def open_sessions(self) -> int:
        return len(self._buffers)

    # ------------------------------------------------------------ writing

    def _resolve_embeddings(
        self, buf: _SessionBuffer
    ) -> Optional[np.ndarray]:
        """(T, D) float32 instruction member, or None when unresolvable."""
        dim = next(
            (e.shape[0] for e in buf.embeddings if e is not None), None
        )
        rows: List[Optional[np.ndarray]] = []
        for emb, text in zip(buf.embeddings, buf.texts):
            if emb is None and text is not None and self._embed_fn is not None:
                cached = self._embed_cache.get(text)
                if cached is None:
                    cached = np.asarray(
                        self._embed_fn(text), np.float32
                    ).reshape(-1)
                    # Tiny per-process cache: capture traffic repeats a
                    # handful of instructions per workload.
                    if len(self._embed_cache) < 1024:
                        self._embed_cache[text] = cached
                emb = cached
            rows.append(emb)
            if emb is not None and dim is None:
                dim = emb.shape[0]
        if dim is None:
            return None
        # A step that carried neither embedding nor embeddable text rides
        # its neighbors' instruction (sessions serve one instruction).
        fallback = next((r for r in rows if r is not None), None)
        if fallback is None:
            return None
        return np.stack(
            [r if r is not None else fallback for r in rows]
        ).astype(np.float32)

    def _write_episode(self, buf: _SessionBuffer, outcome: str) -> bool:
        t = len(buf.images)
        if t < self.min_steps:
            with self._lock:
                self.dropped_episodes_total += 1
            return False
        instruction = self._resolve_embeddings(buf)
        if instruction is None:
            # No embedding and no way to derive one: the episode cannot
            # carry the task specification training needs.
            with self._lock:
                self.dropped_episodes_total += 1
            return False
        is_first = np.zeros((t,), bool)
        is_first[0] = True
        ep = {
            "rgb": np.stack(buf.images),
            "action": np.stack(buf.actions),
            "is_first": is_first,
            # Honest terminal labels: only a policy-emitted terminate (or
            # nothing) — an outcome like "released" is provenance, not a
            # terminate-token training label.
            "is_terminal": np.asarray(buf.terminates, bool),
            "instruction": instruction,
            "outcome": ep_lib.encode_instruction_text(outcome),
        }
        token_dims = {tok.shape[0] for tok in buf.tokens}
        if len(token_dims) == 1 and 0 not in token_dims:
            ep["action_tokens"] = np.stack(buf.tokens)
        if buf.task:
            ep["task"] = ep_lib.encode_instruction_text(buf.task)
        text = next((x for x in buf.texts if x), None)
        if text:
            ep["instruction_text"] = ep_lib.encode_instruction_text(text)
        with self._lock:
            self._writes += 1
            ordinal = self._writes
            self._seq += 1
            name = f"{EPISODE_PREFIX}{self._token}_{self._seq:06d}.npz"
        path = os.path.join(self.capture_dir, name)
        tmp = os.path.join(self.capture_dir, f".tmp_{name}")
        try:
            faults.maybe_fail("capture_write", index=ordinal, what=path)
            ep_lib.validate_episode(ep)
            with open(tmp, "wb") as f:
                np.savez(f, **ep)
            os.replace(tmp, path)
        except (OSError, ValueError, KeyError):
            with self._lock:
                self.write_errors_total += 1
            try:
                os.remove(tmp)
            except OSError:
                pass
            return False
        with self._lock:
            self.episodes_total += 1
            self.steps_total += t
            self._ring.append(path)
            pruned = []
            while len(self._ring) > self.max_episodes:
                pruned.append(self._ring.pop(0))
        for old in pruned:
            try:
                os.remove(old)
            except OSError:
                continue
            with self._lock:
                self.pruned_total += 1
        return True

    # --------------------------------------------------------------- gauges

    def stats(self) -> Dict[str, float]:
        """Serve-metrics gauges (`rt1_serve_capture_*` families)."""
        return {
            "capture_enabled": 1,
            "capture_episodes_total": self.episodes_total,
            "capture_steps_total": self.steps_total,
            "capture_dropped_episodes_total": self.dropped_episodes_total,
            "capture_dropped_steps_total": self.dropped_steps_total,
            "capture_write_errors_total": self.write_errors_total,
            "capture_pruned_total": self.pruned_total,
            "capture_open_sessions": self.open_sessions,
        }


def capture_files(capture_dir: str) -> List[str]:
    """Completed (atomically renamed) capture episode files, sorted."""
    try:
        names = os.listdir(capture_dir)
    except OSError:
        return []
    return sorted(
        os.path.join(capture_dir, f)
        for f in names
        if f.startswith(EPISODE_PREFIX) and f.endswith(".npz")
    )


def sweep_captures(src_dirs: Sequence[str], staging_dir: str) -> int:
    """Move completed capture files from per-replica dirs into one staging
    dir (the fleet supervisor's sweep; `append_shard` packs staging).

    Same-filesystem renames, so a file is either fully in staging or still
    in its replica dir; basenames are already unique per writer process
    (pid + sequence). Returns the number of files moved.
    """
    os.makedirs(staging_dir, exist_ok=True)
    moved = 0
    for src in src_dirs:
        for path in capture_files(src):
            dst = os.path.join(staging_dir, os.path.basename(path))
            try:
                os.replace(path, dst)
                moved += 1
            except OSError:
                continue  # vanished mid-sweep / cross-device: next pass
    return moved
