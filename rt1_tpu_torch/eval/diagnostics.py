"""Corpus diagnostics (counterpart of `corpus_entropy` in
`scripts/policy_diagnostics.py`).

`corpus_entropy` is the marginal action-token entropy of a demo corpus,
the bar the learning curve is read against: a policy that fits only the
marginal action distribution, ignoring its observations, plateaus at this
cross-entropy; a token CE below it is the first evidence that the policy
reads its inputs.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from rt1_tpu_torch.data.episodes import load_episode, read_reference_episode
from rt1_tpu_torch.models.action_tokenizer import tokenize
from rt1_tpu_torch.specs import language_table_action_space

# Flagship tokens a step: 8 image + 3 action tokens.
TOKENS_PER_STEP = 11


def corpus_entropy(data_dir, n_episodes, vocab_size=256):
    """Marginal token entropy of the first `n_episodes` train episodes, in
    nats per action token, with the loss it shows as under the reference's
    scaling (the mean-per-token CE divided by b * t * (I + A)) at the
    repo's standard batch and window settings. Exact for a window of 1; for
    longer windows the bar is approximate (a window's first positions
    repeat step 0, which reweights the label marginal slightly)."""
    space = language_table_action_space()
    paths = sorted(glob.glob(os.path.join(data_dir, "train", "episode_*.np*")))
    if not paths:
        raise FileNotFoundError(f"no train episodes under {data_dir}")
    paths = paths[:n_episodes]
    counts = None
    for path in paths:
        ep = read_reference_episode(path) if path.endswith(".npy") else load_episode(path)
        tokens = tokenize(space, {
            "terminate_episode": torch.from_numpy(np.asarray(ep["is_terminal"], np.int32)),
            "action": torch.from_numpy(np.asarray(ep["action"], np.float32)),
        }, vocab_size).numpy()  # (T, A)
        if counts is None:
            counts = np.zeros((tokens.shape[-1], vocab_size), np.int64)
        for pos in range(tokens.shape[-1]):
            counts[pos] += np.bincount(tokens[:, pos], minlength=vocab_size)

    def entropy(c):
        p = c / c.sum()
        nz = p[p > 0]
        return float(-(nz * np.log(nz)).sum())

    per_token = [entropy(c) for c in counts]
    mean_nats = float(np.mean(per_token))
    return {
        "episodes_scanned": len(paths),
        "per_token_entropy_nats": per_token,
        "mean_entropy_nats": mean_nats,
        "displayed_loss_assumes": "8 image tokens (I+A=11); T>1 bars are "
                                  "approximate (first-frame window padding "
                                  "reweights the label marginal)",
        "displayed_loss_at": {
            f"b{b}_T{t}": mean_nats / (b * t * TOKENS_PER_STEP)
            for b, t in ((32, 1), (32, 6), (16, 1), (8, 6))
        },
    }
