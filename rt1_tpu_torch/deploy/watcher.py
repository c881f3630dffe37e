"""Checkpoint discovery on a live train workdir, torn-write tolerant.

The port's copy of `rt1_tpu/deploy/watcher.py` (the port imports nothing
of the JAX package), on the port trainer's layout: a step is complete when
`<workdir>/checkpoints/<step>/state.pt` exists. A save writes
`state.pt.tmp` and renames it into place, so a step directory that holds
only the tmp file (or nothing yet) is not a candidate. The scan mirrors
`trainer/checkpoints.all_steps` EXACTLY but lives here because importing
`trainer.checkpoints` drags torch into the supervisor process, which
stays torch-free; `tests/test_torch_deploy.py` pins the two to identical
answers on the same directory.
"""

from __future__ import annotations

import os
from typing import List, Optional

#: The trainer's checkpoint file (`trainer/checkpoints.py::FILENAME`).
CHECKPOINT_FILENAME = "state.pt"


def _complete_steps(ckpt_dir: str) -> List[int]:
    """Steps whose directory holds the whole checkpoint file, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    try:
        names = os.listdir(ckpt_dir)
    except OSError:
        return []
    return sorted(
        int(d)
        for d in names
        if d.isdigit()
        and os.path.isfile(os.path.join(ckpt_dir, d, CHECKPOINT_FILENAME))
    )


def latest_checkpoint_step(ckpt_dir: str) -> Optional[int]:
    """Newest complete checkpoint step under `ckpt_dir`, or None.

    Import-light twin of `rt1_tpu_torch.trainer.checkpoints.latest_step`
    (same torn-write tolerance, no torch import)."""
    steps = _complete_steps(ckpt_dir)
    return steps[-1] if steps else None


class CheckpointWatcher:
    """Poll a train workdir for steps newer than any already seen.

    ``poll()`` returns a NEW candidate step exactly once (then remembers
    it), so the controller's tick loop can call it unconditionally. Steps
    at or below the high-water mark — including the incumbent the fleet
    booted from, and candidates already gated-and-rejected — are never
    re-surfaced; `dismiss(step)` raises the mark explicitly when a
    candidate is disposed of out of band."""

    def __init__(self, workdir: str, *, seen_through: Optional[int] = None):
        self.workdir = workdir
        self.ckpt_dir = os.path.join(workdir, "checkpoints")
        # High-water mark: poll() only surfaces steps strictly above it.
        self.seen_through = -1 if seen_through is None else seen_through
        self.polls = 0

    def poll(self) -> Optional[int]:
        self.polls += 1
        step = latest_checkpoint_step(self.ckpt_dir)
        if step is None or step <= self.seen_through:
            return None
        self.seen_through = step
        return step

    def pending_steps(self) -> List[int]:
        """Every complete step currently on disk (ascending) — the
        run-report provenance view, not the dedup path."""
        return _complete_steps(self.ckpt_dir)

    def dismiss(self, step: int) -> None:
        self.seen_through = max(self.seen_through, step)
