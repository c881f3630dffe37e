"""Packed mmap frame cache (counterpart of `rt1_tpu/data/pack.py`, the
same on-disk format byte for byte, so a pack built by either package
feeds the other).

`pack_episodes` decodes each episode once and writes its frames resized to
the *packed* resolution, the smallest frame from which every random crop
of the training distribution is a pure slice, into one uint8 frames file
per shard (no headers), the step-aligned members (action, instruction,
is_first, is_terminal) concatenated into raw `meta_<member>.npy` files,
and a JSON manifest with the geometry, per-episode frame offsets and
source fingerprints. `PackedEpisodeCache` maps the files once and
assembles a training window from uint8 slices of the mmaps through the
native gather (`native.packed_gather`): no decode, no resize.

Format 3 is sharded: `frames.bin` plus `frames_<k>.bin` appended by
`append_shard`, each with its own sidecars, listed in the manifest with a
`freshness_epoch` bumped per append; shard files land before the
manifest's rename, so a reader sees the old corpus or the whole new shard.
`PackedEpisodeCache.refresh` opens appended shards in a live process.
Format-2 manifests (one `frames.bin`, no shard list) load as one shard.

Crop geometry: the random box is drawn by `pipeline._crop_box` in source
coordinates (the windowed loader's draws for the same generator), then
mapped into packed coordinates, where it is exactly (height, width):

    source (H0, W0) -- crop (ch0, cw0) = (int(H0*cf), int(W0*cf)) -> (h, w)
    packed (ph, pw) = (round(H0*h/ch0), round(W0*w/cw0))
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from rt1_tpu_torch.data import episodes as ep_lib
from rt1_tpu_torch.data import native
from rt1_tpu_torch.data.pipeline import _crop_box, crop_resize_frames
from rt1_tpu_torch.resilience import faults

MANIFEST_NAME = "pack_manifest.json"
FRAMES_NAME = "frames.bin"
FORMAT_VERSION = 3
LEGACY_FORMAT_VERSION = 2
# Step-aligned members in meta_<name><suffix>.npy, concatenated over
# episodes along axis 0.
META_MEMBERS = ("action", "instruction", "is_first", "is_terminal")
TEXT_MEMBER = "instruction_text"
#: Task id of episodes whose manifest entry carries no `task`.
UNKNOWN_TASK = "unknown"


def shard_suffix(k: int) -> str:
    """File-name suffix of shard `k`: "" for shard 0 (`frames.bin`), then
    `_00001`, ..."""
    return "" if k == 0 else f"_{k:05d}"


def shard_frames_name(suffix: str) -> str:
    return f"frames{suffix}.bin" if suffix else FRAMES_NAME


def shard_meta_name(member: str, suffix: str) -> str:
    return f"meta_{member}{suffix}.npy"


# --------------------------------------------------------------------- geometry


def crop_size(dim: int, crop_factor: Optional[float]) -> int:
    """Source-coordinate crop size along one dim (as `_crop_box`)."""
    return dim if crop_factor is None else int(dim * crop_factor)


def packed_dims(src_h: int, src_w: int, height: int, width: int,
                crop_factor: Optional[float]) -> Tuple[int, int]:
    """Packed (ph, pw): a `crop_factor` source crop spans exactly (h, w);
    (height, width) when crop_factor is None."""
    ph = int(round(src_h * height / crop_size(src_h, crop_factor)))
    pw = int(round(src_w * width / crop_size(src_w, crop_factor)))
    # Rounding can only undershoot at the .5 edge; clamp so the slice fits.
    return max(ph, height), max(pw, width)


def map_box_to_packed(box: Tuple[int, int, int, int], src_h: int, src_w: int, ph: int,
                      pw: int, height: int, width: int) -> Tuple[int, int]:
    """Source-coordinate crop box -> (top, left) of its (h, w) packed slice."""
    top, left, ch, cw = box
    top_p = int(round(top * height / max(ch, 1)))
    left_p = int(round(left * width / max(cw, 1)))
    return min(max(top_p, 0), ph - height), min(max(left_p, 0), pw - width)


# --------------------------------------------------------------------- packer


def _fingerprint(path: str) -> Dict[str, object]:
    st = os.stat(path)
    return {"name": os.path.basename(path), "bytes": st.st_size, "mtime": round(st.st_mtime, 3)}


def _fingerprint_key(fp: Dict[str, object]) -> Tuple:
    return (fp.get("name"), fp.get("bytes"), fp.get("mtime"))


def _resize_episode_frames(rgb: np.ndarray, ph: int, pw: int) -> np.ndarray:
    """(T, H0, W0, 3) uint8 -> (T, ph, pw, 3) uint8, full-frame resize."""
    t, h0, w0, _ = rgb.shape
    if (h0, w0) == (ph, pw):
        return np.ascontiguousarray(rgb)
    boxes = np.tile(np.array([[0, 0, h0, w0]], np.int32), (t, 1))
    return crop_resize_frames(list(rgb), boxes, ph, pw)


def _write_shard(out_dir, paths, suffix, src_h, src_w, ph, pw, height, width, crop_factor,
                 frame_base, shard_index):
    """Decode `paths` once into one shard's frames + meta files.

    Returns (episode_entries, shard_entry, steps, src_h, src_w). Frame
    offsets are global (frame_base + local), text offsets local to the
    shard. `src_h` None infers the geometry from the first episode (a fresh
    pack); a value enforces the corpus-wide geometry (an append).
    """
    os.makedirs(out_dir, exist_ok=True)
    episodes: List[Dict[str, object]] = []
    meta_parts: Dict[str, List[np.ndarray]] = {k: [] for k in META_MEMBERS}
    text_parts: List[np.ndarray] = []
    have_text = True
    frame_offset = frame_base
    text_offset = 0
    frames_name = shard_frames_name(suffix)
    frames_tmp = os.path.join(out_dir, frames_name + ".tmp")
    with open(frames_tmp, "wb") as frames_f:
        for path in paths:
            ep = ep_lib.load_episode(path)
            ep_lib.validate_episode(ep)
            rgb = np.asarray(ep["rgb"], np.uint8)
            t, h0, w0, _ = rgb.shape
            if src_h is None:
                src_h, src_w = h0, w0
                ph, pw = packed_dims(src_h, src_w, height, width, crop_factor)
            elif (h0, w0) != (src_h, src_w):
                raise ValueError(f"{path}: source frames {h0}x{w0} differ from corpus "
                                 f"{src_h}x{src_w}; the packed geometry is corpus-wide")
            _resize_episode_frames(rgb, ph, pw).tofile(frames_f)
            for k in META_MEMBERS:
                meta_parts[k].append(np.asarray(ep[k]))
            entry = {"steps": int(t), "frame_offset": int(frame_offset),
                     "shard": int(shard_index), "source": _fingerprint(path)}
            if "task" in ep:
                entry["task"] = ep_lib.decode_instruction_text(ep["task"])
            if have_text and TEXT_MEMBER in ep:
                text = np.asarray(ep[TEXT_MEMBER], np.uint8)
                text_parts.append(text)
                entry["text_offset"] = int(text_offset)
                entry["text_len"] = int(text.shape[0])
                text_offset += int(text.shape[0])
            else:
                have_text = False  # all or nothing per shard
            episodes.append(entry)
            frame_offset += t
    os.replace(frames_tmp, os.path.join(out_dir, frames_name))
    for k in META_MEMBERS:
        _atomic_save_npy(os.path.join(out_dir, shard_meta_name(k, suffix)),
                         np.concatenate(meta_parts[k], axis=0))
    has_text = bool(have_text and text_parts)
    if has_text:
        _atomic_save_npy(os.path.join(out_dir, shard_meta_name(TEXT_MEMBER, suffix)),
                         np.concatenate(text_parts))
    else:
        for e in episodes:
            e.pop("text_offset", None)
            e.pop("text_len", None)
    steps = frame_offset - frame_base
    shard_entry = {
        "suffix": suffix,
        "frames": frames_name,
        "steps": int(steps),
        "frame_base": int(frame_base),
        "episodes": len(episodes),
        "bytes": int(steps) * int(ph) * int(pw) * 3,
        "has_text": has_text,
    }
    return episodes, shard_entry, steps, int(src_h), int(src_w)


def _write_manifest(out_dir: str, manifest: Dict[str, object]) -> None:
    tmp = os.path.join(out_dir, MANIFEST_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    os.replace(tmp, os.path.join(out_dir, MANIFEST_NAME))


def pack_episodes(paths: Sequence[str], out_dir: str, height: int, width: int,
                  crop_factor: Optional[float], force: bool = False) -> Dict[str, object]:
    """Decode each episode once, write packed frames + sidecars + manifest;
    returns the manifest. Does nothing when `pack_is_fresh` holds (unless
    `force`). Source frames must share one (H0, W0) across the corpus."""
    paths = sorted(paths)
    if not paths:
        raise ValueError("pack_episodes: no episode paths given")
    if not force and pack_is_fresh(out_dir, paths, height, width, crop_factor):
        return load_manifest(out_dir)
    episodes, shard_entry, steps, src_h, src_w = _write_shard(
        out_dir, paths, shard_suffix(0), None, None, None, None, height, width, crop_factor,
        frame_base=0, shard_index=0)
    ph, pw = packed_dims(src_h, src_w, height, width, crop_factor)
    manifest = {
        "format_version": FORMAT_VERSION,
        "freshness_epoch": 0,
        "source": {"height": src_h, "width": src_w},
        "train": {"height": int(height), "width": int(width), "crop_factor": crop_factor},
        "packed": {"height": int(ph), "width": int(pw)},
        "total_steps": int(steps),
        "has_instruction_text": bool(shard_entry["has_text"]),
        "shards": [shard_entry],
        "episodes": episodes,
    }
    _write_manifest(out_dir, manifest)
    return manifest


def append_shard(pack_dir: str, paths: Sequence[str]) -> Dict[str, object]:
    """Append episodes to an existing pack as a new shard: episodes already
    packed (by source fingerprint) are skipped, the rest decoded once into
    `frames_<k>.bin` + sidecars, and the manifest rewritten by a rename
    with the new shard and `freshness_epoch` + 1. Shard files are fully on
    disk BEFORE the manifest rename, so a crash mid-append (fault site
    `pack_append@N`, N the freshness epoch the append would publish)
    leaves at worst orphaned shard files next to a valid old manifest:
    readers never see a torn corpus. Returns the (possibly unchanged)
    manifest."""
    manifest = load_manifest(pack_dir)
    known = {_fingerprint_key(e.get("source", {})) for e in manifest["episodes"]}
    new_paths = [p for p in sorted(paths) if _fingerprint_key(_fingerprint(p)) not in known]
    if not new_paths:
        return manifest
    k = len(manifest["shards"])
    train = manifest["train"]
    episodes, shard_entry, steps, _, _ = _write_shard(
        pack_dir, new_paths, shard_suffix(k),
        int(manifest["source"]["height"]), int(manifest["source"]["width"]),
        int(manifest["packed"]["height"]), int(manifest["packed"]["width"]),
        int(train["height"]), int(train["width"]), train["crop_factor"],
        frame_base=int(manifest["total_steps"]), shard_index=k)
    shard_entry["appended"] = True
    # Fault site: the shard files are written, the manifest rename has not
    # happened: the torn-append window readers must be immune to.
    faults.maybe_fail(
        "pack_append",
        index=int(manifest["freshness_epoch"]) + 1,
        what=f"shard {shard_entry['frames']} in {pack_dir}",
    )
    manifest["episodes"] = list(manifest["episodes"]) + episodes
    manifest["shards"] = list(manifest["shards"]) + [shard_entry]
    manifest["total_steps"] = int(manifest["total_steps"]) + int(steps)
    manifest["freshness_epoch"] = int(manifest["freshness_epoch"]) + 1
    manifest["has_instruction_text"] = bool(
        manifest["has_instruction_text"] and shard_entry["has_text"])
    manifest["format_version"] = FORMAT_VERSION
    _write_manifest(pack_dir, manifest)
    return manifest


def _atomic_save_npy(path: str, arr: np.ndarray) -> None:
    tmp = path + ".tmp.npy"  # the .npy suffix keeps np.save from appending one
    np.save(tmp, arr)
    os.replace(tmp, path)


# ----------------------------------------------------------------- manifests


def load_manifest(pack_dir: str) -> Dict[str, object]:
    """Read a pack manifest in the sharded (format 3) shape. A format-2
    manifest is presented as one shard, nothing rewritten on disk; other
    versions raise ValueError."""
    with open(os.path.join(pack_dir, MANIFEST_NAME)) as f:
        manifest = json.load(f)
    version = manifest.get("format_version")
    if version == FORMAT_VERSION:
        return manifest
    if version != LEGACY_FORMAT_VERSION:
        raise ValueError(f"{pack_dir}: pack format {version} is not {LEGACY_FORMAT_VERSION} "
                         f"or {FORMAT_VERSION}; re-pack with python -m "
                         "rt1_tpu_torch.data.pack_dataset")
    total = int(manifest.get("total_steps", 0))
    ph = int(manifest["packed"]["height"])
    pw = int(manifest["packed"]["width"])
    manifest["freshness_epoch"] = 0
    manifest["shards"] = [{
        "suffix": "",
        "frames": FRAMES_NAME,
        "steps": total,
        "frame_base": 0,
        "episodes": len(manifest.get("episodes", [])),
        "bytes": total * ph * pw * 3,
        "has_text": bool(manifest.get("has_instruction_text")),
    }]
    for e in manifest.get("episodes", []):
        e.setdefault("shard", 0)
    return manifest


def verify_shards(pack_dir: str, manifest: Dict[str, object]) -> List[str]:
    """Every shard's files checked; the problems found, each naming its
    shard (empty: intact)."""
    problems: List[str] = []
    for shard in manifest.get("shards", []):
        suffix = shard.get("suffix", "")
        name = shard_frames_name(suffix)
        expected = int(shard.get("bytes", 0))
        try:
            size = os.path.getsize(os.path.join(pack_dir, name))
        except OSError:
            problems.append(f"shard {name!r}: missing")
            continue
        if size != expected:
            problems.append(f"shard {name!r}: {size} bytes on disk, manifest expects {expected}")
        members = list(META_MEMBERS) + ([TEXT_MEMBER] if shard.get("has_text") else [])
        for member in members:
            if not os.path.exists(os.path.join(pack_dir, shard_meta_name(member, suffix))):
                problems.append(
                    f"shard {name!r}: sidecar {shard_meta_name(member, suffix)!r} missing")
    return problems


def pack_status(pack_dir: str, paths: Sequence[str], height: int, width: int,
                crop_factor: Optional[float]) -> Tuple[bool, str]:
    """(fresh, reason) for `pack_dir` against the base episode set `paths`:
    fresh when the train geometry matches, shard 0 was built from exactly
    `paths` (same names in order, same size and mtime), and every shard is
    intact on disk. The reason names what failed."""
    try:
        manifest = load_manifest(pack_dir)
    except (OSError, ValueError) as exc:
        return False, f"manifest unreadable: {exc}"
    train = manifest.get("train", {})
    if (train.get("height") != height or train.get("width") != width
            or train.get("crop_factor") != crop_factor):
        return False, (f"train geometry {train.get('height')}x{train.get('width')}"
                       f"@{train.get('crop_factor')} != requested {height}x{width}@{crop_factor}")
    base = [e for e in manifest.get("episodes", []) if e.get("shard") == 0]
    paths = sorted(paths)
    if len(base) != len(paths):
        return False, f"base shard has {len(base)} episodes, source dir has {len(paths)}"
    for entry, path in zip(base, paths):
        try:
            fp = _fingerprint(path)
        except OSError:
            return False, f"source episode {path!r} unreadable"
        if entry.get("source") != fp:
            return False, f"source episode {os.path.basename(path)!r} changed since packing"
    problems = verify_shards(pack_dir, manifest)
    if problems:
        return False, "; ".join(problems)
    return True, "fresh"


def pack_is_fresh(pack_dir: str, paths: Sequence[str], height: int, width: int,
                  crop_factor: Optional[float]) -> bool:
    """True when `pack_dir` holds a current pack of exactly `paths` (plus any
    intact appended shards); `pack_status` gives the reason."""
    return pack_status(pack_dir, paths, height, width, crop_factor)[0]


def default_pack_dir(data_dir: str, split: str) -> str:
    """A split's pack lives next to its episodes."""
    return os.path.join(data_dir, f"{split}_packed")


# --------------------------------------------------------------------- cache


class _OpenShard:
    """One shard's open mmaps: frames + step-aligned meta."""

    __slots__ = ("frames", "meta", "base", "steps", "text")

    def __init__(self, frames, meta, base, steps, text=None):
        self.frames = frames
        self.meta = meta
        self.base = base
        self.steps = steps
        self.text = text  # the shard's instruction-text bytes, or None


class PackedEpisodeCache:
    """Window sampler over a pack: the windowed loader's (episode, start)
    index, front-padding and `_crop_box` draws, with a window's frames cut
    out of the shard mmaps by the native gather. `get_window` returns the
    windowed loader's nested dict; `fill_batch` writes a whole batch into
    caller buffers (the feeder's). Open handles: one frames mmap and one
    per meta member per shard.

    `refresh()` re-reads the manifest and opens appended shards in place:
    episode indices, index entries and open mmaps never move, so readers
    mid-batch are safe.
    """

    def __init__(self, pack_dir: str, window: int = 6, clip_tokenizer=None):
        self.pack_dir = pack_dir
        # Optional `text.clip_bpe.ClipBPETokenizer`: the feeder's windows
        # gain "instruction_tokenized_clip" from the packed instruction text.
        self._clip_tokenizer = clip_tokenizer
        self._clip_token_cache: Dict[int, np.ndarray] = {}
        self.manifest = load_manifest(pack_dir)
        problems = verify_shards(pack_dir, self.manifest)
        if problems:
            raise ValueError(f"{pack_dir}: packed cache is torn: " + "; ".join(problems))
        self.window = window
        self.height = int(self.manifest["train"]["height"])
        self.width = int(self.manifest["train"]["width"])
        self.crop_factor = self.manifest["train"]["crop_factor"]
        self.src_h = int(self.manifest["source"]["height"])
        self.src_w = int(self.manifest["source"]["width"])
        self.packed_h = int(self.manifest["packed"]["height"])
        self.packed_w = int(self.manifest["packed"]["width"])
        self.episodes = list(self.manifest["episodes"])
        self.total_steps = int(self.manifest["total_steps"])
        self.freshness_epoch = int(self.manifest.get("freshness_epoch", 0))
        self.refreshes = 0  # successful mid-run shard pickups
        self.last_refresh_unix = time.time()
        self._lock = threading.Lock()
        self._shards: List[_OpenShard] = [self._open_shard(s) for s in self.manifest["shards"]]
        self._shard_bases = np.array([s.base for s in self._shards], np.int64)
        self._frame_offsets = np.array([int(e["frame_offset"]) for e in self.episodes], np.int64)
        self.index: List[Tuple[int, int]] = []
        for i, entry in enumerate(self.episodes):
            self.index.extend((i, s) for s in range(int(entry["steps"])))

    def _open_shard(self, shard: Dict[str, object]) -> _OpenShard:
        suffix = shard.get("suffix", "")
        steps = int(shard["steps"])
        frames = np.memmap(os.path.join(self.pack_dir, shard_frames_name(suffix)),
                           dtype=np.uint8, mode="r",
                           shape=(steps, self.packed_h, self.packed_w, 3))
        meta = {k: np.load(os.path.join(self.pack_dir, shard_meta_name(k, suffix)),
                           mmap_mode="r")
                for k in META_MEMBERS}
        text = None
        if shard.get("has_text"):
            text = np.load(os.path.join(self.pack_dir, shard_meta_name(TEXT_MEMBER, suffix)),
                           mmap_mode="r")
        return _OpenShard(frames, meta, base=int(shard["frame_base"]), steps=steps, text=text)

    def episode_clip_tokens(self, ep_i: int) -> np.ndarray:
        """(context,) int32 CLIP BPE frame of episode `ep_i`'s instruction."""
        with self._lock:
            tokens = self._clip_token_cache.get(ep_i)
        if tokens is None:
            entry = self.episodes[ep_i]
            shard = self._shards[int(entry.get("shard", 0))]
            if shard.text is None or "text_offset" not in entry:
                raise KeyError(f"episode {ep_i} in {self.pack_dir} has no 'instruction_text'; "
                               "re-pack from a corpus collected with rt1_tpu_torch.data.collect "
                               "to use clip_tokens")
            off, ln = int(entry["text_offset"]), int(entry["text_len"])
            text = ep_lib.decode_instruction_text(shard.text[off:off + ln])
            tokens = self._clip_tokenizer.tokenize_text(text)[0].astype(np.int32)
            with self._lock:
                self._clip_token_cache[ep_i] = tokens
        return tokens

    def __len__(self) -> int:
        return len(self.index)

    @property
    def num_shards(self) -> int:
        return len(self._shards)

    @property
    def appended_episodes(self) -> int:
        """Episodes living in flywheel-appended shards (shard > 0)."""
        return sum(
            int(s.get("episodes", 0))
            for s in self.manifest["shards"]
            if s.get("appended")
        )

    @property
    def tasks(self) -> List[str]:
        """Per-episode task ids (`UNKNOWN_TASK` for untagged episodes)."""
        return [e.get("task") or UNKNOWN_TASK for e in self.episodes]

    def refresh(self) -> bool:
        """Open shards appended since the last look; True when the corpus
        grew. A torn append is skipped with a warning (the old view keeps
        serving)."""
        with self._lock:
            try:
                manifest = load_manifest(self.pack_dir)
            except (OSError, ValueError):
                return False  # mid-rewrite or gone: keep the current view
            self.last_refresh_unix = time.time()
            fresh_epoch = int(manifest.get("freshness_epoch", 0))
            if (fresh_epoch <= self.freshness_epoch
                    or len(manifest["episodes"]) < len(self.episodes)
                    or len(manifest["shards"]) <= len(self._shards)):
                return False
            problems = verify_shards(self.pack_dir, manifest)
            if problems:
                logging.getLogger(__name__).warning(
                    "packed cache refresh skipped: %s", "; ".join(problems))
                return False
            self.manifest = manifest
            for shard in manifest["shards"][len(self._shards):]:
                self._shards.append(self._open_shard(shard))
            new_eps = manifest["episodes"][len(self.episodes):]
            base_i = len(self.episodes)
            self.episodes.extend(new_eps)
            self._shard_bases = np.array([s.base for s in self._shards], np.int64)
            self._frame_offsets = np.array([int(e["frame_offset"]) for e in self.episodes],
                                           np.int64)
            for i, entry in enumerate(new_eps, start=base_i):
                self.index.extend((i, s) for s in range(int(entry["steps"])))
            self.total_steps = int(manifest["total_steps"])
            self.freshness_epoch = fresh_epoch
            self.refreshes += 1
            return True

    # ------------------------------------------------------------ file access

    def _episode_shard(self, ep_i: int) -> Tuple[_OpenShard, int]:
        """(shard, local frame offset) of episode `ep_i`."""
        entry = self.episodes[ep_i]
        shard = self._shards[int(entry.get("shard", 0))]
        return shard, int(entry["frame_offset"]) - shard.base

    def frames(self, ep_i: int) -> np.ndarray:
        """(T, ph, pw, 3) uint8 view of episode `ep_i`'s packed frames."""
        shard, off = self._episode_shard(ep_i)
        return shard.frames[off:off + int(self.episodes[ep_i]["steps"])]

    def meta(self, ep_i: int) -> Dict[str, np.ndarray]:
        """Step-aligned member views of episode `ep_i`."""
        shard, off = self._episode_shard(ep_i)
        end = off + int(self.episodes[ep_i]["steps"])
        return {k: v[off:end] for k, v in shard.meta.items()}

    # ------------------------------------------------------------ sampling

    def draw_box(self, rng: np.random.Generator) -> Tuple[int, int, int, int]:
        """One source-coordinate crop box, drawn by `_crop_box`."""
        return _crop_box(self.src_h, self.src_w, self.crop_factor, rng)

    def draw_packed_offsets(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """(n, 2) packed (top, left) offsets, one draw per axis for all n:
        the distribution of `draw_box` mapped by `map_box_to_packed`, not
        its stream (the feeder's path)."""
        h, w = self.height, self.width
        if self.crop_factor is None:
            return np.zeros((n, 2), np.int32)
        ch0 = int(self.src_h * self.crop_factor)
        cw0 = int(self.src_w * self.crop_factor)
        tops = rng.integers(0, self.src_h - ch0 + 1, size=n)
        lefts = rng.integers(0, self.src_w - cw0 + 1, size=n)
        out = np.empty((n, 2), np.int32)
        # np.rint rounds half to even, as round() does on the scalar path.
        out[:, 0] = np.clip(np.rint(tops * (h / ch0)), 0, self.packed_h - h)
        out[:, 1] = np.clip(np.rint(lefts * (w / cw0)), 0, self.packed_w - w)
        return out

    def _padded_src(self, start: int, j: int) -> int:
        """Index into the unpadded episode of step j of the padded window."""
        k = start + j
        return max(k - (self.window - 1), 0)

    def _padded_src_indices(self, start: int) -> np.ndarray:
        k = np.arange(start, start + self.window, dtype=np.int64)
        return np.maximum(k - (self.window - 1), 0)

    def gather_frames(self, ep_i: int, start: int, rng: Optional[np.random.Generator] = None,
                      out: Optional[np.ndarray] = None) -> np.ndarray:
        """(window, h, w, 3) uint8 of window `start` of episode `ep_i`, each
        frame's box drawn in source coordinates in the windowed loader's
        order; `out` is filled in place when given."""
        h, w = self.height, self.width
        if out is None:
            out = np.empty((self.window, h, w, 3), np.uint8)
        rng = rng or np.random.default_rng()
        boxes = [self.draw_box(rng) for _ in range(self.window)]
        src = np.array([self._padded_src(start, j) for j in range(self.window)], np.int64)
        pboxes = np.empty((self.window, 4), np.int32)
        for j, box in enumerate(boxes):
            pboxes[j] = (*map_box_to_packed(box, self.src_h, self.src_w, self.packed_h,
                                            self.packed_w, h, w), h, w)
        native.packed_gather(self.frames(ep_i), src, pboxes, out, threads=1)
        return out

    def get_window(self, idx: int, rng: Optional[np.random.Generator] = None) -> Dict:
        """The nested sample dict of `WindowedEpisodeDataset.get_window`."""
        ep_i, start = self.index[idx]
        meta = self.meta(ep_i)
        images = self.gather_frames(ep_i, start, rng)
        src = self._padded_src_indices(start)
        return {
            "observations": {
                "image": images,
                "natural_language_embedding": np.asarray(meta["instruction"][src], np.float32),
            },
            "actions": {
                "terminate_episode": meta["is_terminal"][src].astype(bool).astype(np.int32),
                "action": np.asarray(meta["action"][src], np.float32),
            },
        }

    def _gather_meta(self, member: str, gidx: np.ndarray) -> np.ndarray:
        """A step-aligned member at global frame indices, across shards."""
        if len(self._shards) == 1:
            return self._shards[0].meta[member][gidx]
        flat = gidx.reshape(-1)
        shard_ids = np.searchsorted(self._shard_bases, flat, side="right") - 1
        first = self._shards[0].meta[member]
        out = np.empty((flat.shape[0],) + first.shape[1:], first.dtype)
        for k in np.unique(shard_ids):
            rows = np.nonzero(shard_ids == k)[0]
            shard = self._shards[int(k)]
            out[rows] = shard.meta[member][flat[rows] - shard.base]
        return out.reshape(gidx.shape + first.shape[1:])

    def fill_batch(self, indices: np.ndarray, rng: np.random.Generator, images: np.ndarray,
                   embeds: np.ndarray, terms: np.ndarray, actions: np.ndarray,
                   threads: int = 1, offsets: Optional[np.ndarray] = None) -> None:
        """Assemble a batch into preallocated buffers: one vectorised offset
        draw (`draw_packed_offsets`, or `offsets`, (n*window, 2), given), one
        native gather per shard touched, one fancy index per meta member."""
        n, w = len(indices), self.window
        h, wd = self.height, self.width
        if offsets is None:
            offsets = self.draw_packed_offsets(rng, n * w)
        gidx = np.empty((n, w), np.int64)
        for i, idx in enumerate(indices):
            ep_i, start = self.index[int(idx)]
            gidx[i] = self._frame_offsets[ep_i] + self._padded_src_indices(start)
        flat_idx = gidx.reshape(-1)
        boxes = np.empty((n * w, 4), np.int32)
        boxes[:, :2] = offsets
        boxes[:, 2] = h
        boxes[:, 3] = wd
        flat_img = images.reshape(n * w, h, wd, 3)
        if len(self._shards) == 1:
            native.packed_gather(self._shards[0].frames, flat_idx, boxes, flat_img, threads)
        else:
            shard_ids = np.searchsorted(self._shard_bases, flat_idx, side="right") - 1
            for k in np.unique(shard_ids):
                rows = np.nonzero(shard_ids == k)[0]
                shard = self._shards[int(k)]
                sub = np.empty((len(rows), h, wd, 3), np.uint8)
                native.packed_gather(shard.frames, flat_idx[rows] - shard.base, boxes[rows],
                                     sub, threads)
                flat_img[rows] = sub
        embeds[:] = self._gather_meta("instruction", gidx)
        actions[:] = self._gather_meta("action", gidx)
        terms[:] = self._gather_meta("is_terminal", gidx)
