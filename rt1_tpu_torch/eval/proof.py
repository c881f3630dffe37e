"""Learning-proof summary: the eval stage's provenance record
(counterpart of `rt1_tpu/eval/proof.py`: the same keys, criterion and
headline rule, so either package's `learn_proof.json` reads the same).

The success criterion and the headline-powering rule were registered
before the data existed: the trained policy must reach half the oracle's
successes under the same protocol, and no success headline rests on fewer
than `MIN_EPISODES_FOR_SUCCESS_HEADLINE` formal-seed episodes.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping, Sequence

# Registered before the flagship arm's eval ran (RESULTS.md, "Round-5
# pre-registered success protocol"): a 1/20 is within noise of 0/20, so no
# "success" headline may rest on fewer than this many formal-seed
# episodes; diagnostics-seed results are reported alongside, never as
# the headline.
MIN_EPISODES_FOR_SUCCESS_HEADLINE = 50
SUCCESS_CRITERION = "trained_successes >= max(1, oracle_successes // 2)"


def criterion_met(trained_successes: int, oracle_successes: int) -> bool:
    """The pre-registered bar: half the measured expert ceiling.

    Success is defined against the same protocol's oracle rate, not an
    absolute number: the RRT push oracle itself solves
    only about half of oracle-validated inits within the 80-step budget.
    """
    return trained_successes >= max(1, oracle_successes // 2)


def build_proof_summary(
    *,
    reward: str,
    block_mode: str,
    manifest: Mapping[str, Any] | None,
    flag_embedder: str,
    flag_exec_noise_std: float,
    episodes_collected: int,
    split_counts: Mapping[str, int],
    num_steps_requested: int,
    evaluated_checkpoint_step: int | None,
    seq_len: int,
    focal_gamma: float,
    aux_mse_weight: float,
    image_tokenizer: str,
    resolution: Sequence[int],
    eval_episodes: int,
    eval_seed: int,
    trained: Mapping[str, Any],
    random_results: Mapping[str, Any],
    oracle_results: Mapping[str, Any],
    curves: Mapping[str, Sequence],
) -> dict:
    """Assemble the ``learn_proof.json`` record.

    Provenance comes from reality, not flags, wherever the two can
    diverge: corpus noise/embedder from the manifest (the
    eval stage never collects, so the flag could silently mis-record),
    and the evaluated step from the checkpoint directory (after DAgger
    the checkpoint sits at base + rounds*extra, which the requested
    num_steps knows nothing about).
    """
    # A manifest that exists but lacks exec_noise_std is a PRE-DART clean
    # corpus (noise 0.0) — never the flag, which the eval stage could
    # silently mis-record. Flags are the fallback only with no manifest.
    if manifest is None:
        manifest = {}
        corpus_noise = flag_exec_noise_std
    else:
        corpus_noise = manifest.get("exec_noise_std", 0.0)
    summary = {
        "reward": reward,
        "block_mode": block_mode,
        "embedder": manifest.get("embedder", flag_embedder),
        "episodes_collected": episodes_collected,
        "episodes_by_split": dict(split_counts),
        "exec_noise_std": corpus_noise,
        "train_steps_requested": num_steps_requested,
        "evaluated_checkpoint_step": evaluated_checkpoint_step,
        "seq_len": seq_len,
        "focal_gamma": focal_gamma,
        "aux_mse_weight": aux_mse_weight,
        "image_tokenizer": image_tokenizer,
        "resolution": list(resolution),
        "eval_episodes": eval_episodes,
        "trained_successes": trained["successes"][reward],
        "random_successes": random_results["successes"][reward],
        "oracle_successes": oracle_results["successes"][reward],
        "trained_mean_episode_length":
            trained["mean_episode_length"][reward],
        "random_mean_episode_length":
            random_results["mean_episode_length"][reward],
        "oracle_mean_episode_length":
            oracle_results["mean_episode_length"][reward],
        "final_train_loss": curves["loss"][-1][1] if curves["loss"] else None,
        "final_eval_loss":
            curves["eval_loss"][-1][1] if curves["eval_loss"] else None,
    }
    summary["success_criterion"] = SUCCESS_CRITERION
    summary["criterion_met"] = bool(
        criterion_met(
            summary["trained_successes"], summary["oracle_successes"]
        )
    )
    summary["headline_protocol"] = {
        "criterion": SUCCESS_CRITERION + " on the formal eval seeds",
        "formal_eval_seed": eval_seed,
        "min_episodes_for_success_headline":
            MIN_EPISODES_FOR_SUCCESS_HEADLINE,
        "headline_eligible": bool(
            summary["criterion_met"]
            and eval_episodes >= MIN_EPISODES_FOR_SUCCESS_HEADLINE
        ),
        "registered": "round 5, before the flagship arm's eval",
    }
    return summary


def write_proof_json(workdir: str, summary: Mapping[str, Any]) -> str:
    """Durably write ``learn_proof.json`` (tmp+rename).

    A mid-write kill must not leave a truncated file that a pipeline's
    completeness check could mistake for a finished arm.
    """
    proof_path = os.path.join(workdir, "learn_proof.json")
    with open(proof_path + ".tmp", "w") as f:
        json.dump(summary, f, indent=2)
    os.replace(proof_path + ".tmp", proof_path)
    return proof_path
