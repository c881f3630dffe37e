"""Instruction -> 512-d embedding providers (counterpart of
`rt1_tpu/eval/embedding.py`).

* `HashInstructionEmbedder` — a unit Gaussian seeded by the text's hash;
* `NgramInstructionEmbedder` — a feature-hashed bag of word n-grams, so
  instructions that share words share features.

Both give the same vectors as their JAX-package twins. The Universal
Sentence Encoder needs TensorFlow and waits; so do precomputed tables.
"""

import hashlib
import re

import numpy as np

EMBEDDING_DIM = 512


def _seeded_unit_gaussian(text: str, dim: int) -> np.ndarray:
    digest = hashlib.sha256(text.encode("utf-8")).digest()
    seed = int.from_bytes(digest[:8], "little") % (2**32)
    vec = np.random.RandomState(seed).randn(dim).astype(np.float32)
    vec /= np.linalg.norm(vec)
    return vec


class HashInstructionEmbedder:
    """Deterministic pseudo-embedding: unit Gaussian seeded by the text hash."""

    name = "hash"

    def __init__(self, dim=EMBEDDING_DIM):
        self.dim = dim
        self._cache = {}

    def __call__(self, text):
        vec = self._cache.get(text)
        if vec is None:
            vec = _seeded_unit_gaussian(text, self.dim)
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

    def _feature_vec(self, feat):
        vec = self._feature_cache.get(feat)
        if vec is None:
            vec = _seeded_unit_gaussian(feat, self.dim)
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


def get_embedder(spec="hash"):
    """Resolve an embedder from a spec string or pass through a callable."""
    if callable(spec):
        return spec
    if spec == "hash":
        return HashInstructionEmbedder()
    if spec == "ngram":
        return NgramInstructionEmbedder()
    raise ValueError(f"Unknown embedder spec: {spec} (the port has hash | ngram)")
