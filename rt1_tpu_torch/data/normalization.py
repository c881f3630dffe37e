"""Dataset normalization statistics (Chan's parallel algorithm) + rendezvous
(a copy of `rt1_tpu/data/normalization.py`, numpy only).

Parity source: reference `language_table/train/normalization.py:28-105`
(ChanRunningStatistics over observation features, min/max + mean/std over
actions) and the multihost rendezvous in `input_pipeline_rlds.py:195-234`:
process 0 computes statistics and writes a JSON file; other processes
poll-wait for it. Pure numpy — no tf_agents dependency.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

EPS = np.finfo(np.float32).eps


def chan_merge(n_a, mean_a, m2_a, n_b, mean_b, m2_b):
    """Merge two (count, mean, M2) partials; returns the combined triple.

    Chan et al.'s parallel variance update (see the Wikipedia "Algorithms
    for calculating variance # Parallel algorithm" article the reference
    cites, `normalization.py:36-40`).
    """
    n = n_a + n_b
    if n == 0:
        return 0, mean_a, m2_a
    delta = mean_b - mean_a
    mean = mean_a + delta * (n_b / n)
    m2 = m2_a + m2_b + np.square(delta) * (n_a * n_b / n)
    return n, mean, m2


class ChanRunningStatistics:
    """Streaming per-feature mean/std over the LAST axis of samples."""

    def __init__(self, feature_dim: Optional[int] = None):
        self._n = 0
        self._mean = (
            np.zeros(feature_dim) if feature_dim is not None else None
        )
        self._m2 = 0.0

    def update(self, sample: np.ndarray):
        sample = np.asarray(sample, np.float64)
        if sample.ndim > 1:
            sample = sample.reshape(-1, sample.shape[-1])
            n_b = sample.shape[0]
            mean_b = sample.mean(axis=0)
            m2_b = sample.var(axis=0) * n_b
        else:
            n_b, mean_b, m2_b = 1, sample, 0.0
        if self._mean is None:
            self._mean = np.zeros_like(mean_b)
        self._n, self._mean, self._m2 = chan_merge(
            self._n, self._mean, self._m2, n_b, mean_b, m2_b
        )

    @property
    def n(self):
        return self._n

    @property
    def mean(self):
        return self._mean

    @property
    def variance(self):
        return self._m2 / self._n

    @property
    def std(self):
        return np.sqrt(self.variance)


def compute_dataset_statistics(
    batches: Iterable,
    num_samples: int,
    obs_keys: Tuple[str, ...] = ("natural_language_embedding",),
) -> Dict:
    """Streaming stats over our batch format ({'observations', 'actions'}).

    Returns {obs_statistics: {key: {mean, std}}, act_statistics:
    {mean, std, min, max}} with JSON-serializable lists.
    """
    obs_stats = {k: ChanRunningStatistics() for k in obs_keys}
    act_stats = ChanRunningStatistics()
    act_min, act_max = None, None

    seen = 0
    for batch in batches:
        actions = np.asarray(batch["actions"]["action"], np.float64)
        flat = actions.reshape(-1, actions.shape[-1])
        act_stats.update(flat)
        batch_min = flat.min(axis=0)
        batch_max = flat.max(axis=0)
        if act_min is None:
            act_min, act_max = batch_min, batch_max
        else:
            act_min = np.minimum(act_min, batch_min)
            act_max = np.maximum(act_max, batch_max)
        for k in obs_keys:
            obs_stats[k].update(np.asarray(batch["observations"][k]))
        seen += flat.shape[0]
        if seen >= num_samples:
            break

    return {
        "num_samples": int(seen),
        "obs_statistics": {
            k: {
                "mean": obs_stats[k].mean.tolist(),
                "std": (obs_stats[k].std + EPS).tolist(),
            }
            for k in obs_keys
        },
        "act_statistics": {
            "mean": act_stats.mean.tolist(),
            "std": (act_stats.std + EPS).tolist(),
            "min": act_min.tolist(),
            "max": act_max.tolist(),
        },
    }


def get_or_compute_statistics(
    path: str,
    compute_fn,
    is_lead_host: bool = True,
    timeout_s: float = 600.0,
    poll_s: float = 1.0,
) -> Dict:
    """Multihost stats rendezvous: lead host computes + writes, others wait.

    Mirrors the reference's cross-process file rendezvous
    (`input_pipeline_rlds.py:195-234`): a `.tmp` write + atomic rename so
    waiters never read a partial file.
    """
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    if is_lead_host:
        stats = compute_fn()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(stats, f)
        os.replace(tmp, path)
        return stats
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)
        time.sleep(poll_s)
    raise TimeoutError(
        f"Timed out waiting for dataset statistics at {path}"
    )
