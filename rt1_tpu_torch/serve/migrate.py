"""Durable sessions: snapshot schema, on-disk ring and live migration
(counterpart of `rt1_tpu/serve/migrate.py`, on the same wire format).

* **Wire snapshot** — the versioned, self-describing JSON record that
  `POST /session/export` returns and `POST /session/import` takes.
  `check_compatibility` refuses, naming the field, a snapshot of another
  version, checkpoint generation, window length, cached-vs-windowed mode
  or state schema, before any device memory is touched.
* **SnapshotRing** — a bounded on-disk ring of per-session snapshots (one
  JSON file per session, atomic tmp + rename writes, oldest evicted past
  capacity); `load` gives the snapshot's age so the importer can refuse
  stale state.
* **migrate_session** — export from one replica, import into another,
  never raise.

State leaves travel as base64 of their raw little-endian bytes with a
shape and dtype header (`encode_state` / `decode_state`). A bfloat16 leaf
(a cached engine's K/V at bf16) is encoded from its raw 2-byte words and
labelled "bfloat16", as JAX labels it; numpy knows that dtype only through
`ml_dtypes`, which the card's machine lacks, so such a leaf is decoded by
torch. Decoded leaves are CPU tensors. numpy and torch are imported by
the functions that encode and decode leaves, so the model-free router and
stub replica import this module without them.

Chaos sites, as in the JAX package: `migrate_export` fires before the
export leg of `migrate_session` and `migrate_import` before its import
leg (`resilience/faults.py`); the ring restore's `session_restore` site is
in the server.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Tuple

from rt1_tpu_torch.resilience import faults

#: The snapshot wire schema's version; importers refuse any other.
SNAPSHOT_VERSION = 1


class SnapshotCompatibilityError(ValueError):
    """Snapshot refused: exporter and importer disagree on a contract field
    (version, checkpoint generation, window length, cached-vs-windowed
    mode, or state schema)."""


# ---------------------------------------------------------------- encoding


def _raw(value) -> Tuple[List[int], str, bytes]:
    """(shape, dtype name, raw bytes) of a tensor or array."""
    import numpy as np
    import torch

    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        if value.dtype == torch.bfloat16:
            return list(value.shape), "bfloat16", value.view(torch.int16).numpy().tobytes()
        value = value.numpy()
    arr = np.asarray(value)
    return [int(d) for d in arr.shape], str(arr.dtype), arr.tobytes()


def encode_state(state: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """State leaves (tensors or arrays) -> JSON-safe `{leaf: {shape, dtype,
    b64}}`, lossless for every dtype the engine slots hold."""
    encoded = {}
    for name, value in state.items():
        shape, dtype, raw = _raw(value)
        encoded[name] = {"shape": shape, "dtype": dtype,
                         "b64": base64.b64encode(raw).decode("ascii")}
    return encoded


def decode_state(encoded: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """Inverse of `encode_state`, to CPU tensors. Entries carrying plain
    `"data"` lists (a jax-free exporter such as the JAX fleet's stub) pass
    through untouched."""
    import numpy as np
    import torch

    decoded: Dict[str, Any] = {}
    for name, spec in encoded.items():
        if not isinstance(spec, dict):
            raise SnapshotCompatibilityError(f"state leaf {name!r} is not an encoded-array object")
        if "data" in spec:
            decoded[name] = spec["data"]
            continue
        try:
            raw = bytearray(base64.b64decode(spec["b64"]))
            shape = [int(d) for d in spec["shape"]]
            if spec["dtype"] == "bfloat16":
                leaf = torch.frombuffer(raw, dtype=torch.bfloat16) if raw else \
                    torch.empty((0,), dtype=torch.bfloat16)
            else:
                leaf = torch.from_numpy(np.frombuffer(raw, dtype=np.dtype(spec["dtype"])).copy())
            decoded[name] = leaf.reshape(shape)
        except (KeyError, ValueError, TypeError, RuntimeError) as exc:
            raise SnapshotCompatibilityError(f"state leaf {name!r} failed to decode: {exc}") from exc
    return decoded


def _norm_schema(schema) -> List[List[Any]]:
    """Schema triples -> `[[name, [dims], dtype]]`, so tuples compare equal
    to their JSON round trip."""
    return [[str(name), [int(d) for d in shape], str(dtype)] for name, shape, dtype in schema]


def check_compatibility(
    snapshot: Dict[str, Any],
    *,
    checkpoint_generation: Optional[int] = None,
    window: Optional[int] = None,
    cached_inference: Optional[bool] = None,
    schema: Optional[List] = None,
) -> None:
    """Refuse a snapshot this importer must not load, naming the field.
    Each keyword left None is skipped; each given one is compared with the
    snapshot's own value. Raises `SnapshotCompatibilityError` on the first
    mismatch."""
    if not isinstance(snapshot, dict):
        raise SnapshotCompatibilityError(
            f"snapshot must be a JSON object, got {type(snapshot).__name__}")
    version = snapshot.get("version")
    if version != SNAPSHOT_VERSION:
        raise SnapshotCompatibilityError(
            f"snapshot version {version!r} is not the supported version {SNAPSHOT_VERSION} "
            "— refusing a foreign schema")
    sid = snapshot.get("session_id")
    if not isinstance(sid, str) or not sid:
        raise SnapshotCompatibilityError("snapshot carries no 'session_id'")
    if not isinstance(snapshot.get("state"), dict):
        raise SnapshotCompatibilityError("snapshot carries no 'state' pytree")
    kinds = {"checkpoint_generation": "generation", "cached_inference": "mode", "window": "window"}
    for field, expected in (("checkpoint_generation", checkpoint_generation), ("window", window),
                            ("cached_inference", cached_inference)):
        if expected is None:
            continue
        got = snapshot.get(field)
        if got != expected:
            raise SnapshotCompatibilityError(
                f"snapshot {field}={got!r} does not match this importer's {field}={expected!r} "
                f"— refusing a cross-{kinds[field]} session snapshot")
    if schema is not None:
        try:
            normalized = _norm_schema(snapshot.get("schema"))
        except (TypeError, ValueError) as exc:
            raise SnapshotCompatibilityError(f"snapshot schema is malformed: {exc}") from exc
        if normalized != _norm_schema(schema):
            raise SnapshotCompatibilityError(
                f"snapshot state schema does not match this engine's schema — snapshot "
                f"{normalized} vs engine {_norm_schema(schema)}")


# ----------------------------------------------------------- durability


class SnapshotRing:
    """Bounded on-disk session-snapshot ring (one JSON file per session,
    named by a hash of the session id, so replicas sharing a directory
    converge on one file per session)."""

    def __init__(self, directory: str, capacity: int = 64):
        self.directory = directory
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self.saves = 0
        self.evictions = 0
        os.makedirs(directory, exist_ok=True)

    def _path(self, session_id: str) -> str:
        digest = hashlib.sha1(session_id.encode("utf-8", "surrogatepass")).hexdigest()[:20]
        return os.path.join(self.directory, f"session-{digest}.json")

    def save(self, snapshot: Dict[str, Any]) -> str:
        """Persist one snapshot (stamping `saved_at` if absent); returns the
        file path. Raises OSError on a failed write."""
        sid = snapshot.get("session_id")
        if not isinstance(sid, str) or not sid:
            raise ValueError("snapshot carries no 'session_id'")
        record = dict(snapshot)
        record.setdefault("saved_at", time.time())
        path = self._path(sid)
        tmp = f"{path}.tmp.{os.getpid()}"
        with self._lock:
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(record, fh)
            os.replace(tmp, path)
            self.saves += 1
            self._evict_locked(keep=path)
        return path

    def _evict_locked(self, keep: Optional[str] = None) -> None:
        try:
            files = [os.path.join(self.directory, n) for n in os.listdir(self.directory)
                     if n.endswith(".json")]
        except OSError:
            return
        if len(files) <= self.capacity:
            return
        files.sort(key=lambda p: (p == keep, _mtime(p)))
        for path in files[: len(files) - self.capacity]:
            try:
                os.remove(path)
                self.evictions += 1
            except OSError:
                pass

    def load(self, session_id: str) -> Optional[Tuple[Dict[str, Any], Optional[float]]]:
        """`(snapshot, age_s)` for a session, or None when the ring holds
        nothing usable; `age_s` is None when the record has no timestamp."""
        try:
            with open(self._path(session_id), encoding="utf-8") as fh:
                record = json.load(fh)
        except (OSError, ValueError):
            return None
        if not isinstance(record, dict):
            return None
        saved_at = record.get("saved_at")
        age_s = (max(0.0, time.time() - float(saved_at))
                 if isinstance(saved_at, (int, float)) else None)
        return record, age_s

    def drop(self, session_id: str) -> None:
        """Forget a session's snapshot (best effort)."""
        try:
            os.remove(self._path(session_id))
        except OSError:
            pass

    def __len__(self) -> int:
        try:
            return sum(1 for n in os.listdir(self.directory) if n.endswith(".json"))
        except OSError:
            return 0


def _mtime(path: str) -> float:
    try:
        return os.path.getmtime(path)
    except OSError:
        return 0.0


# ------------------------------------------------------------- migration


def _post_json(url: str, payload: Dict[str, Any], timeout_s: float) -> Tuple[int, Dict[str, Any]]:
    req = urllib.request.Request(url, data=json.dumps(payload).encode("utf-8"),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return resp.status, json.loads(resp.read().decode("utf-8"))
    except urllib.error.HTTPError as exc:
        try:
            body = json.loads(exc.read().decode("utf-8"))
        except ValueError:
            body = {"error": f"HTTP {exc.code}"}
        return exc.code, body


def migrate_session(source_url: str, target_url: str, session_id: str,
                    timeout_s: float = 10.0) -> Dict[str, Any]:
    """Move ONE session: export from `source_url`, import into
    `target_url`. Never raises: the result carries `ok` and, on failure,
    the `stage` that broke (export / import / transport) and the error.
    An injected `migrate_export` or `migrate_import` fault is a transport
    failure, so the caller falls back to the orphan + restart path."""
    try:
        faults.maybe_fail("migrate_export", what=session_id)
        status, body = _post_json(source_url.rstrip("/") + "/session/export",
                                  {"session_id": session_id}, timeout_s)
        if status != 200 or not body.get("ok"):
            return {"ok": False, "session_id": session_id, "stage": "export",
                    "error": str(body.get("error") or f"HTTP {status}")}
        faults.maybe_fail("migrate_import", what=session_id)
        status, body = _post_json(target_url.rstrip("/") + "/session/import",
                                  {"snapshot": body.get("snapshot")}, timeout_s)
        if status != 200 or not body.get("ok"):
            return {"ok": False, "session_id": session_id, "stage": "import",
                    "error": str(body.get("error") or f"HTTP {status}")}
        return {"ok": True, "session_id": session_id, "step_index": body.get("step_index")}
    except Exception as exc:  # noqa: BLE001 - migration must never raise
        return {"ok": False, "session_id": session_id, "stage": "transport", "error": str(exc)}
