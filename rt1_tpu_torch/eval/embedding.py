"""Instruction -> 512-d embedding providers (counterpart of
`rt1_tpu/eval/embedding.py`).

* `HashInstructionEmbedder` — a unit Gaussian seeded by the text's hash;
* `NgramInstructionEmbedder` — a feature-hashed bag of word n-grams, so
  instructions that share words share features;
* `TableInstructionEmbedder` — a lookup into a precomputed
  {instruction: vector} table saved as an `.npz` ("instructions",
  "embeddings"); `python -m rt1_tpu_torch.eval.embedding --output
  table.npz` builds one over every instruction the reward samplers can
  emit. Either package reads the other's tables.

Each gives the same vectors as its JAX-package twin. The Universal
Sentence Encoder needs TensorFlow and a tf-hub download; the port has none.
"""

import hashlib
import re
import threading

import numpy as np

EMBEDDING_DIM = 512


class _SeededGaussian:
    """`np.random.RandomState(seed).randn(dim)` for a seed from the text's
    hash, as the JAX package draws it, from one generator reseeded per
    draw (a tenth of the cost of a new generator; the same numbers)."""

    def __init__(self):
        self._rng = np.random.RandomState()
        self._lock = threading.Lock()

    def __call__(self, text: str, dim: int) -> np.ndarray:
        digest = hashlib.sha256(text.encode("utf-8")).digest()
        seed = int.from_bytes(digest[:8], "little") % (2**32)
        with self._lock:
            self._rng.seed(seed)
            vec = self._rng.randn(dim).astype(np.float32)
        vec /= np.linalg.norm(vec)
        return vec


class HashInstructionEmbedder:
    """Deterministic pseudo-embedding: unit Gaussian seeded by the text hash."""

    name = "hash"

    def __init__(self, dim=EMBEDDING_DIM):
        self.dim = dim
        self._cache = {}
        self._gaussian = _SeededGaussian()

    def __call__(self, text):
        vec = self._cache.get(text)
        if vec is None:
            vec = self._gaussian(text, self.dim)
            self._cache[text] = vec
        return vec


class NgramInstructionEmbedder:
    """Feature-hashed word n-gram embedding: each n-gram (n = 1..max_n) is a
    deterministic unit Gaussian; the embedding is their normalized sum."""

    name = "ngram"

    def __init__(self, dim=EMBEDDING_DIM, max_n=3):
        self.dim = dim
        self.max_n = max_n
        self._feature_cache = {}
        self._cache = {}
        self._gaussian = _SeededGaussian()

    def _feature_vec(self, feat):
        vec = self._feature_cache.get(feat)
        if vec is None:
            vec = self._gaussian(feat, self.dim)
            self._feature_cache[feat] = vec
        return vec

    def __call__(self, text):
        vec = self._cache.get(text)
        if vec is None:
            words = re.findall(r"[a-z0-9]+", text.lower())
            feats = [
                "_".join(words[i : i + n])
                for n in range(1, self.max_n + 1)
                for i in range(len(words) - n + 1)
            ]
            if not feats:
                feats = ["<empty>"]
            vec = np.sum([self._feature_vec(f) for f in feats], axis=0)
            vec = (vec / np.linalg.norm(vec)).astype(np.float32)
            self._cache[text] = vec
        return vec


class TableInstructionEmbedder:
    """Precomputed lookup table (npz with 'instructions' + 'embeddings')."""

    name = "table"

    def __init__(self, path_or_table):
        if isinstance(path_or_table, dict):
            self._table = dict(path_or_table)
        else:
            with np.load(path_or_table, allow_pickle=False) as z:
                instructions = [str(s) for s in z["instructions"]]
                embeddings = np.asarray(z["embeddings"], np.float32)
            self._table = dict(zip(instructions, embeddings))

    def __call__(self, text):
        try:
            return self._table[text]
        except KeyError as e:
            raise KeyError(
                f"Instruction not in embedding table: {text!r}. Rebuild the table over "
                "rewards.generate_runtime_instructions(...) — `python -m "
                "rt1_tpu_torch.eval.embedding --output table.npz` — which covers the "
                "samplers' full synonym/verb space.") from e

    @staticmethod
    def build(instructions, embed_fn, path=None):
        """A table over `instructions` embedded by `embed_fn`, saved to
        `path` (compressed npz) when given."""
        embeddings = np.stack([embed_fn(s) for s in instructions]).astype(np.float32)
        if path is not None:
            np.savez_compressed(path, instructions=np.array(instructions), embeddings=embeddings)
        return TableInstructionEmbedder(dict(zip(instructions, embeddings)))


def get_embedder(spec="hash"):
    """Resolve an embedder from a spec string (hash | ngram | a table's
    `.npz` path) or pass through a callable."""
    if callable(spec):
        return spec
    if spec == "hash":
        return HashInstructionEmbedder()
    if spec == "ngram":
        return NgramInstructionEmbedder()
    if spec.endswith(".npz"):
        return TableInstructionEmbedder(spec)
    raise ValueError(f"Unknown embedder spec: {spec} (the port has hash | ngram | <table>.npz)")


def build_table_cli(argv=None):
    """Precompute an embedding table over the full instruction grammar:
    every instruction the reward samplers can emit at runtime
    (`rewards.generate_runtime_instructions`), embedded with `--embedder`
    and saved as an `.npz` that any embedder spec accepts. The play
    family's BLOCK_8 generator is open-ended and not table-coverable, nor
    is N_CHOOSE_K's space: use a string-level embedder (ngram, hash) there.

      python -m rt1_tpu_torch.eval.embedding --output /tmp/table.npz \\
          --block_mode BLOCK_4 --embedder ngram
    """
    import argparse

    from rt1_tpu_torch.envs import blocks, rewards

    parser = argparse.ArgumentParser(description=build_table_cli.__doc__.splitlines()[0])
    parser.add_argument("--output", required=True, help="Output .npz path.")
    parser.add_argument("--block_mode", default="BLOCK_8")
    parser.add_argument("--embedder", default="ngram",
                        help="Provider to precompute with (hash | ngram).")
    args = parser.parse_args(argv)
    mode = blocks.BlockMode(args.block_mode)
    if mode == blocks.BlockMode.N_CHOOSE_K:
        raise SystemExit(
            "N_CHOOSE_K's runtime instruction space (16-block synonym avoid-lists) is too "
            "large to table; use a string-level embedder (ngram/hash) instead.")
    instructions = rewards.generate_runtime_instructions(mode)
    TableInstructionEmbedder.build(instructions, get_embedder(args.embedder), path=args.output)
    print(f"wrote {len(instructions)} instruction embeddings ({args.embedder}, "
          f"{args.block_mode}) to {args.output}")


if __name__ == "__main__":
    build_table_cli()
