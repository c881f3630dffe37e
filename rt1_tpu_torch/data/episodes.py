"""Episode record format and storage (counterpart of
`rt1_tpu/data/episodes.py`).

An episode is a dict of arrays stacked over time (T steps):

* ``rgb``          (T, H, W, 3) uint8 — raw simulator frames (180x320 for
  Language-Table)
* ``action``       (T, 2) float32 — 2-D effector deltas
* ``is_first``     (T,) bool
* ``is_terminal``  (T,) bool
* ``instruction``  (T, 512) float32 — the instruction's embedding

Optional: ``instruction_text`` (L,) uint8, the instruction as UTF-8 bytes,
and ``task`` (UTF-8 bytes of the task id), which the packer carries into
its manifest.

One uncompressed `.npz` per episode, written by `np.savez` and read by
the native reader (`data/native.py`; `np.load` with
`RT1_TPU_NO_NATIVE=1`): the same files the JAX package writes and reads.
`read_reference_episode` reads the reference's pickled list-of-step-dicts
`.npy`. `write_manifest` stamps a dataset's `manifest.json`,
`read_manifest` reads it and `check_embedder_compatibility` holds its
embedder to the one requested (counterparts of the functions of
`rt1_tpu/data/collect.py`).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

Episode = Dict[str, np.ndarray]

REQUIRED_KEYS = ("rgb", "action", "is_first", "is_terminal", "instruction")


def encode_instruction_text(text: str) -> np.ndarray:
    """Instruction string -> (L,) uint8 UTF-8 bytes."""
    return np.frombuffer(text.encode("utf-8"), np.uint8).copy()


def decode_instruction_text(arr: np.ndarray) -> str:
    return bytes(np.asarray(arr, np.uint8)).decode("utf-8")


def validate_episode(ep: Episode) -> None:
    for k in REQUIRED_KEYS:
        if k not in ep:
            raise KeyError(f"episode missing key {k!r}; has {sorted(ep)}")
    t = ep["rgb"].shape[0]
    for k in REQUIRED_KEYS:
        if ep[k].shape[0] != t:
            raise ValueError(f"{k} has {ep[k].shape[0]} steps, rgb has {t}")


def save_episode(path: str, ep: Episode) -> None:
    validate_episode(ep)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **ep)


def load_episode(path: str) -> Episode:
    """Every array of the episode file at `path`, read by the native
    reader (`native.load_episode_native`, built with g++ at first use; a
    failed build raises); `RT1_TPU_NO_NATIVE=1` reads it with `np.load`."""
    if not os.environ.get("RT1_TPU_NO_NATIVE"):
        from rt1_tpu_torch.data import native

        return native.load_episode_native(path)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def read_reference_episode(path: str) -> Episode:
    """Read the reference's pickled list-of-step-dicts `.npy` format. It
    unpickles, so read only files this project or the reference wrote."""
    steps = np.load(path, allow_pickle=True)
    ep = {
        "rgb": np.stack([s["rgb"] for s in steps]).astype(np.uint8),
        "action": np.stack([s["action"] for s in steps]).astype(np.float32),
        "is_first": np.array([bool(s["is_first"]) for s in steps]),
        "is_terminal": np.array([bool(s["is_terminal"]) for s in steps]),
        "instruction": np.stack([s["instruction"] for s in steps]).astype(np.float32),
    }
    validate_episode(ep)
    return ep


def generate_synthetic_episode(
    rng: np.random.Generator,
    num_steps: Optional[int] = None,
    height: int = 180,
    width: int = 320,
    instruction_dim: int = 512,
) -> Episode:
    """Random episode with the Language-Table schema, for tests and the
    on-card data phase. Draws from `rng` in the JAX package's order, so one
    seed gives the same episode in both packages."""
    t = int(num_steps if num_steps is not None else rng.integers(8, 40))
    instruction = rng.standard_normal(instruction_dim).astype(np.float32)
    is_terminal = np.zeros(t, bool)
    is_terminal[-1] = True
    is_first = np.zeros(t, bool)
    is_first[0] = True
    return {
        "rgb": rng.integers(0, 256, (t, height, width, 3), dtype=np.uint8),
        "action": rng.uniform(-0.1, 0.1, (t, 2)).astype(np.float32),
        "is_first": is_first,
        "is_terminal": is_terminal,
        "instruction": np.tile(instruction, (t, 1)),
    }


def write_manifest(data_dir: str, **fields):
    """Stamp collection provenance, above all the instruction embedder,
    into `<data_dir>/manifest.json` (sorted keys, indent 2: the JAX
    package's bytes); returns the fields. An embedder object is stamped by
    its `name`. The file is written under a pid-unique name and renamed
    into place, so a reader sees the old or the new manifest and an update
    never truncates an inode that a hard-linked copy of the corpus
    shares."""
    fields = dict(fields)
    emb = fields.get("embedder")
    if emb is not None and not isinstance(emb, str):
        fields["embedder"] = getattr(emb, "name", str(emb))
    path = os.path.join(data_dir, "manifest.json")
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(fields, f, indent=2, sort_keys=True)
    os.replace(tmp, path)
    return fields


def read_manifest(data_dir: str, manifest_name: str = "manifest.json"):
    """A dataset's manifest dict, or None for datasets written without one."""
    path = os.path.join(data_dir, manifest_name)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def check_embedder_compatibility(data_dir: str, embedder_spec, context: str = "",
                                 manifest_name: str = "manifest.json"):
    """Raise if the dataset manifest records a different instruction
    embedder (counterpart of `rt1_tpu/data/collect.py::
    check_embedder_compatibility`). The embedding is the task
    specification: a policy trained on one provider's embeddings decodes
    garbage from another's. No-op without a manifest; returns it (or None).
    """
    manifest = read_manifest(data_dir, manifest_name)
    if manifest is None:
        return None
    recorded = manifest.get("embedder")
    requested = embedder_spec if isinstance(embedder_spec, str) else \
        getattr(embedder_spec, "name", None)
    if recorded and requested and recorded != requested:
        raise ValueError(
            f"Embedder mismatch{' (' + context + ')' if context else ''}: "
            f"dataset {data_dir!r} was embedded with {recorded!r} but "
            f"{requested!r} was requested. Re-collect/convert the data or "
            f"pass the matching embedder."
        )
    return manifest
