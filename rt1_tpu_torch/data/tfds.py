"""A TFDS dataset directory read without `tensorflow_datasets`.

The port's stand-in for `tfds.builder_from_directory(dir).as_dataset(split)`
over an RLDS dataset such as Language-Table's. A prepared TFDS directory
holds (`tensorflow_datasets/core/dataset_info.py`, `core/features/`,
`core/example_serializer.py`):

* `dataset_info.json` — the `DatasetInfo` proto as JSON: the dataset's
  `name`, `fileFormat` (only `tfrecord` is read here), and each split's
  `name`, `shardLengths` and `filepathTemplate` (default
  `{DATASET}-{SPLIT}.{FILEFORMAT}-{SHARD_X_OF_Y}`);
* `features.json` — the feature tree: `featuresDict` nodes, `sequence`
  nodes (RLDS's `steps` is a `Dataset`, a sequence of unknown length),
  `tensor` leaves (`shape.dimensions`, `dtype`, `encoding` "none") and
  `image` leaves (`shape`, `dtype`, `encodingFormat` png | jpeg);
* the shards, one `tf.train.Example` per episode. The example's keys are
  the feature paths joined by "/" (`steps/observation/rgb`); a sequence's
  leaves are stacked over its steps and flattened (`steps/action` is one
  float list of T x 2 values), an image in a sequence is one encoded image
  a step, bools and integers are int64 lists, floats float lists.

`TfdsDirectory.episodes(split)` takes split strings as JAX passes them to
TFDS (`train`, `train[:7800]`, `train[7800:7900]`; ints, negative from the
end, clamped as Python slices), reads
the shards' examples in TFDS's default order (`as_dataset` with
`shuffle_files=False` interleaves the split's files 16 at a time in blocks
of 16 examples, `core/reader.py`; one file at a time when the dataset
sets `disableShuffling`) and yields each episode as a dict whose `steps`
is a `Steps`: its dense arrays (T, ...) and `as_numpy_iterator()` over the
steps, the two forms JAX's code reads. Images are decoded as
`tf.image.decode_image` decodes them (`data/codecs.py`), with the
channels of the feature's shape.
"""

from __future__ import annotations

import json
import os
import re
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from rt1_tpu_torch.data import codecs, tfrecord

DEFAULT_TEMPLATE = "{DATASET}-{SPLIT}.{FILEFORMAT}-{SHARD_X_OF_Y}"
# tfds.ReadConfig's defaults when files are read in order (core/reader.py).
INTERLEAVE_CYCLE = 16
INTERLEAVE_BLOCK = 16
_DTYPES = {"float32": np.float32, "float64": np.float64, "float16": np.float16,
           "int64": np.int64, "int32": np.int32, "int16": np.int16, "int8": np.int8,
           "uint8": np.uint8, "uint16": np.uint16, "uint32": np.uint32, "bool": np.bool_}


class Leaf:
    """One leaf of the feature tree: a tensor, an image or a text."""

    def __init__(self, kind: str, shape: Tuple[int, ...], dtype, encoding: str = "none"):
        self.kind, self.shape, self.dtype, self.encoding = kind, shape, dtype, encoding

    def __repr__(self):
        return f"Leaf({self.kind}, {self.shape}, {np.dtype(self.dtype).name}, {self.encoding})"


class SequenceNode:
    """A `Sequence` / `Dataset` feature: its inner tree, stacked a step."""

    def __init__(self, inner, length: Optional[int]):
        self.inner, self.length = inner, length


def _shape(node) -> Tuple[int, ...]:
    return tuple(int(d) for d in node.get("shape", {}).get("dimensions", []))


def parse_features(node):
    """features.json (a `Feature` proto as JSON) -> a tree of dicts,
    `SequenceNode`s and `Leaf`s."""
    if "featuresDict" in node:
        return {k: parse_features(v) for k, v in node["featuresDict"]["features"].items()}
    if "sequence" in node:
        seq = node["sequence"]
        length = int(seq.get("length", -1))
        return SequenceNode(parse_features(seq["feature"]), None if length < 0 else length)
    if "image" in node:
        img = node["image"]
        dtype = img.get("dtype", "uint8")
        if dtype != "uint8":
            raise NotImplementedError(f"image dtype {dtype} is not read (uint8 is)")
        return Leaf("image", _shape(img), np.uint8, img.get("encodingFormat") or "png")
    if "tensor" in node:
        t = node["tensor"]
        encoding = t.get("encoding", "none") or "none"
        if encoding.lower() != "none":
            raise NotImplementedError(f"tensor encoding {encoding!r} is not read ('none' is)")
        dtype = t["dtype"]
        if dtype == "string":
            return Leaf("text", _shape(t), object)
        return Leaf("tensor", _shape(t), _DTYPES[dtype])
    if "text" in node:
        return Leaf("text", (), object)
    raise NotImplementedError(f"feature {node.get('pythonClassName', sorted(node))} is not read")


def _flat_leaves(tree, prefix="", in_sequence=False):
    """(example key, leaf, inside a sequence) for every leaf of `tree`."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_leaves(v, f"{prefix}{k}/", in_sequence)
    elif isinstance(tree, SequenceNode):
        if in_sequence:
            raise NotImplementedError("a sequence inside a sequence is not read")
        yield from _flat_leaves(tree.inner, prefix, True)
    else:
        yield prefix[:-1], tree, in_sequence


def _decode_leaf(key: str, leaf: Leaf, raw, in_sequence: bool):
    """One leaf's example value -> its array ((T,) + shape in a sequence)."""
    if leaf.kind == "image":
        frames = list(raw) if isinstance(raw, list) else []
        channels = leaf.shape[-1] if leaf.shape else 0
        imgs = [codecs.decode_image(b, channels) for b in frames]
        if not in_sequence:
            return imgs[0]
        if not imgs:
            return np.zeros((0,) + tuple(max(d, 0) for d in leaf.shape), np.uint8)
        return np.stack(imgs)
    if leaf.kind == "text":
        values = [bytes(b) for b in raw] if isinstance(raw, list) else []
        return np.array(values, dtype=object) if in_sequence else (values[0] if values else b"")
    values = np.asarray(raw)
    if leaf.dtype == np.bool_:
        values = values != 0
    else:
        values = values.astype(leaf.dtype, copy=False)
    shape = tuple(-1 if d is None or d < 0 else d for d in leaf.shape)
    if in_sequence:
        per_step = int(np.prod([d for d in shape if d >= 0])) if shape else 1
        if -1 in shape:
            raise NotImplementedError(f"{key}: a step leaf of unknown shape {leaf.shape}")
        if per_step and values.size % per_step:
            raise ValueError(f"{key}: {values.size} values do not fill steps of {shape}")
        return values.reshape((values.size // per_step if per_step else 0,) + shape)
    return values.reshape(shape)


def _set_path(tree: Dict, key: str, value) -> None:
    parts = key.split("/")
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = value


class Steps:
    """An episode's `steps`: the dense arrays of its step features, nested
    as the feature tree nests them, each (T, ...)."""

    def __init__(self, dense: Dict):
        self._dense = dense

    def dense(self) -> Dict:
        return self._dense

    def __len__(self) -> int:
        def first(tree):
            for v in tree.values():
                return first(v) if isinstance(v, dict) else len(v)
            return 0

        return first(self._dense)

    def as_numpy_iterator(self) -> Iterator[Dict]:
        """One nested dict a step, as `episode["steps"].as_numpy_iterator()`
        yields them in TF."""
        def at(tree, t):
            return {k: at(v, t) if isinstance(v, dict) else v[t] for k, v in tree.items()}

        for t in range(len(self)):
            yield at(self._dense, t)


def _split_bounds(spec: str, n: int) -> Tuple[int, int]:
    """TFDS's `[from:to]` slice of `n` examples, as a Python slice clamps it."""
    m = re.fullmatch(r"\s*(-?\d+)?\s*:\s*(-?\d+)?\s*", spec)
    if m is None:
        raise ValueError(f"bad split slice [{spec}]")
    lo, hi = (None if g is None else int(g) for g in m.groups())
    return slice(lo, hi).indices(n)[:2]


def interleave(sources: Iterable, fn: Callable[[object], Iterable], cycle: int,
               block: int = 1) -> Iterator:
    """tf.data's deterministic `interleave(fn, cycle_length, block_length)`
    over `sources` (`interleave_dataset_op.cc`): `cycle` open inputs, `block`
    elements from each in turn, an exhausted input's slot refilled with the
    next source in place."""
    sources = iter(sources)
    slots: List[Optional[Iterator]] = [None] * cycle
    end_of_input, open_, cycle_i, block_i = False, 0, 0, 0
    while not end_of_input or open_ > 0:
        if slots[cycle_i] is not None:
            try:
                item = next(slots[cycle_i])
            except StopIteration:
                slots[cycle_i] = None
                open_ -= 1
                cycle_i, block_i = (cycle_i + 1) % cycle, 0
                continue
            block_i += 1
            if block_i == block:
                cycle_i, block_i = (cycle_i + 1) % cycle, 0
            yield item
        elif not end_of_input:
            try:
                slots[cycle_i] = iter(fn(next(sources)))
                open_ += 1
            except StopIteration:
                end_of_input = True
        else:
            cycle_i, block_i = (cycle_i + 1) % cycle, 0


class TfdsDirectory:
    """A prepared TFDS dataset directory (one version's folder)."""

    def __init__(self, path: str):
        self.path = path
        info_path = os.path.join(path, "dataset_info.json")
        if not os.path.exists(info_path):
            raise FileNotFoundError(f"{path} is not a TFDS dataset directory "
                                    "(no dataset_info.json)")
        with open(info_path) as f:
            self.info = json.load(f)
        with open(os.path.join(path, "features.json")) as f:
            self.features = parse_features(json.load(f))
        self.name = self.info["name"]
        self.file_format = self.info.get("fileFormat", "tfrecord") or "tfrecord"
        if self.file_format != "tfrecord":
            raise NotImplementedError(f"file format {self.file_format!r} is not read "
                                      "(tfrecord is)")
        self.splits = {s["name"]: s for s in self.info.get("splits", [])}
        self.disable_shuffling = bool(self.info.get("disableShuffling", False))
        self._leaves = list(_flat_leaves(self.features))

    def shard_lengths(self, split: str) -> List[int]:
        if split not in self.splits:
            raise ValueError(f"unknown split {split!r}; {self.name} has {sorted(self.splits)}")
        return [int(n) for n in self.splits[split].get("shardLengths", [])]

    def shard_paths(self, split: str) -> List[str]:
        n = len(self.shard_lengths(split))
        template = self.splits[split].get("filepathTemplate") or DEFAULT_TEMPLATE
        paths = []
        for i in range(n):
            name = (template.replace("{DATASET}", self.name).replace("{SPLIT}", split)
                    .replace("{FILEFORMAT}", self.file_format)
                    .replace("{SHARD_X_OF_Y}", f"{i:05d}-of-{n:05d}")
                    .replace("{SHARD_INDEX}", f"{i:05d}").replace("{NUM_SHARDS}", f"{n:05d}"))
            paths.append(os.path.join(self.path, name))
        return paths

    def num_examples(self, split: str) -> int:
        return sum(self.shard_lengths(split))

    def file_instructions(self, split: str) -> List[Tuple[str, int, int]]:
        """(shard path, skip, take) a shard that `split` reads, in shard order."""
        m = re.fullmatch(r"\s*(\w+)\s*(?:\[(.*)\])?\s*", split)
        if m is None:
            raise ValueError(f"bad split {split!r}")
        name, spec = m.group(1), m.group(2)
        lengths = self.shard_lengths(name)
        lo, hi = _split_bounds(spec, sum(lengths)) if spec is not None else (0, sum(lengths))
        if hi <= lo:
            raise ValueError(f"Instruction {split.strip()} corresponds to no data!")
        out, start = [], 0
        for path, n in zip(self.shard_paths(name), lengths):
            skip, stop = max(lo - start, 0), min(hi - start, n)
            if stop > skip:
                out.append((path, skip, stop - skip))
            start += n
        return out

    def read_order(self, split: str) -> List[Tuple[str, int]]:
        """(shard path, record index) of every example of `split`, in the
        order TFDS reads them without shuffling."""
        cycle = 1 if self.disable_shuffling else INTERLEAVE_CYCLE
        block = 1 if self.disable_shuffling else INTERLEAVE_BLOCK
        return list(interleave(self.file_instructions(split),
                               lambda ins: ((ins[0], ins[1] + i) for i in range(ins[2])),
                               cycle, block))

    def examples(self, split: str) -> Iterator[Dict]:
        """The parsed `tf.train.Example`s of `split`, in TFDS's order. Each
        shard is read once, as far as the split needs it."""
        order = self.read_order(split)
        needed: Dict[str, int] = {}
        for path, i in order:
            needed[path] = max(needed.get(path, 0), i + 1)
        readers = {path: tfrecord.read_records(path) for path in needed}
        cache: Dict[Tuple[str, int], bytes] = {}
        counts = {path: 0 for path in needed}
        try:
            for path, i in order:
                while (path, i) not in cache:
                    cache[(path, counts[path])] = next(readers[path])
                    counts[path] += 1
                yield tfrecord.parse_example(cache.pop((path, i)))
        finally:
            for r in readers.values():
                r.close()

    def decode(self, example: Dict) -> Dict:
        """One parsed example -> the episode: top-level features as arrays,
        each sequence as `Steps` over its dense arrays."""
        top: Dict = {}
        seqs: Dict[str, Dict] = {}
        for key, leaf, in_seq in self._leaves:
            raw = example.get(key, [] if leaf.kind in ("image", "text") else np.zeros(0))
            value = _decode_leaf(key, leaf, raw, in_seq)
            if in_seq:
                root, _, rest = key.partition("/")
                _set_path(seqs.setdefault(root, {}), rest, value)
            else:
                _set_path(top, key, value)
        for root, dense in seqs.items():
            _set_path(top, root, Steps(dense))
        return top

    def episodes(self, split: str) -> Iterator[Dict]:
        """The decoded episodes of `split`, in TFDS's order."""
        for example in self.examples(split):
            yield self.decode(example)
