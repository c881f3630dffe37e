"""Checkpoint identity stamping for training workdirs (counterpart of
`rt1_tpu/train/meta.py`, the same `train_meta.json`).

A checkpoint restores silently into a differently configured model when no
parameter shape depends on the knob that differs (`time_sequence_length`:
the position table has max(256, tokens) rows), and its eval then records
success rates under the wrong config. The training run stamps its identity
into `train_meta.json`, and every consumer checks it before restoring.
"""

from __future__ import annotations

import json
import os

META_NAME = "train_meta.json"


def stamp_train_meta(train_dir: str, values: dict) -> None:
    """Record the training run's identity. Called on fresh starts only: a
    resumed run treats the recorded file as the truth."""
    os.makedirs(train_dir, exist_ok=True)
    with open(os.path.join(train_dir, META_NAME), "w") as f:
        json.dump(values, f, indent=2)


def check_train_meta(train_dir: str, context: str, expected: dict, log=print) -> None:
    """Raise ValueError where `expected` disagrees with the recorded meta.
    Only keys present in both are compared; a workdir without the file
    passes with a notice."""
    path = os.path.join(train_dir, META_NAME)
    if not os.path.exists(path):
        log(f"{context}: no {META_NAME} (a workdir stamped before the check existed); skipping check")
        return
    with open(path) as f:
        recorded = json.load(f)
    mismatches = {k: (recorded[k], expected[k]) for k in expected
                  if k in recorded and recorded[k] != expected[k]}
    if mismatches:
        raise ValueError(
            f"{context}: flags disagree with the checkpoint's training config "
            f"{path}: {mismatches}. Pass the training-time flags (or retrain).")
