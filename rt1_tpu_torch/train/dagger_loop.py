"""Resumable DAgger outer loop: the two-phase crash-safe state machine (a
copy of `rt1_tpu/train/dagger_loop.py`; its state file is the same JSON,
so either package resumes the other's loop).

The loop alternates corrective collection with training extensions
(`data/dagger.py`), and every transition is durable:

* phase A (`aggregated_round = k`, written BEFORE training) makes round
  `k`'s rollout and aggregation idempotent: a crash during the longer
  training extension does not re-append round `k`'s episodes on resume;
* phase B (`completed_rounds = k + 1`, written after training) advances.

Round step targets derive from the base checkpoint recorded at first
entry (`base + (k + 1) * extra_steps`), so a mid-training crash cannot
inflate a round's budget through the mid-extension checkpoint. Callers
delete the state file (`clear_state`) once the history is archived.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable


@dataclasses.dataclass(frozen=True)
class DaggerLoopConfig:
    """Outer-loop shape. `rounds` corrective iterations, each extending
    training by `extra_steps` beyond the base checkpoint."""

    rounds: int
    extra_steps: int


def _load_state(state_path: str, base_step: int) -> dict:
    if os.path.exists(state_path):
        with open(state_path) as f:
            return json.load(f)
    return {
        "completed_rounds": 0,
        "rounds": [],
        "aggregated_round": None,
        "base_step": base_step,
    }


def _checkpoint_state(state_path: str, state: dict) -> None:
    with open(state_path + ".tmp", "w") as f:
        json.dump(state, f, indent=2)
    os.replace(state_path + ".tmp", state_path)


def round_target_step(base_step: int, rnd: int, extra_steps: int) -> int:
    """Training target for round `rnd` (0-based): base + (rnd+1)*extra."""
    return base_step + (rnd + 1) * extra_steps


def run_dagger_loop(
    state_path: str,
    base_step: int,
    config: DaggerLoopConfig,
    collect_round: Callable[[int], dict],
    train_to: Callable[[int], None],
    log: Callable[[str], None] = print,
) -> list[dict]:
    """Run (or resume) the DAgger loop; returns the per-round history.

    `collect_round(rnd)` rolls out the CURRENT policy, aggregates the
    relabeled episodes into the corpus, and returns the history entry for
    round `rnd` — it runs exactly once per round across any number of
    crashes/resumes (phase-A durability). `train_to(target_step)` extends
    training to an absolute step target; it may run more than once for the
    same target after a mid-training crash and must therefore resume from
    the latest checkpoint (the standard `restore_or_initialize` contract).

    `base_step` is only used on FIRST entry; a resumed run keeps the
    recorded one so step targets never drift.

    The state file is NOT deleted here: callers archive the returned
    history first and then call `clear_state` — so a crash between loop
    completion and the archive write resumes into an already-complete
    state (returning the recorded history instantly) instead of silently
    re-running every round and double-appending episodes to the corpus.
    """
    state = _load_state(state_path, base_step)
    if state["rounds"] or state["completed_rounds"]:
        log(
            f"dagger: resuming at round {state['completed_rounds']} "
            f"(aggregated_round={state['aggregated_round']}, "
            f"base_step={state['base_step']})"
        )
    history = state["rounds"]
    for rnd in range(state["completed_rounds"], config.rounds):
        if state["aggregated_round"] == rnd:
            log(f"dagger round {rnd}: already aggregated; resuming training")
        else:
            entry = dict(collect_round(rnd))
            entry["round"] = rnd
            history.append(entry)
            state["aggregated_round"] = rnd
            # Phase A durable BEFORE the long training extension.
            _checkpoint_state(state_path, state)
            log(f"dagger round {rnd}: {entry}")
        train_to(round_target_step(state["base_step"], rnd,
                                   config.extra_steps))
        state["completed_rounds"] = rnd + 1
        state["aggregated_round"] = None
        _checkpoint_state(state_path, state)
    return history


def clear_state(state_path: str) -> None:
    """Delete the crash-resume state. Callers do this only AFTER the
    returned history is durably archived: the state is resume bookkeeping,
    not run provenance, and a leftover file would make a later fresh run in
    the same workdir silently skip its rounds."""
    try:
        os.unlink(state_path)
    except FileNotFoundError:
        pass
