"""Policy and corpus diagnostics (counterpart of
`scripts/policy_diagnostics.py`): `python -m rt1_tpu_torch.eval.diagnostics`.

`closed_loop_diagnostics` rolls the trained policy while the scripted RRT
oracle is queried on the same states (a per-step reference action, not
the actor) and reports, per episode and overall:

* oracle agreement — the cosine between the policy's and the oracle's
  action each step (near 0 on average: the policy ignores the task);
* constancy — the spread of the policy's actions (a near-constant output
  is the copycat collapse);
* progress — the start block's distance to its target block at the start
  and the end of the episode.

`corpus_entropy` is the marginal action-token entropy of a demo corpus,
the bar the learning curve is read against: a policy that fits only the
marginal action distribution, ignoring its observations, plateaus at this
cross-entropy; a token CE below it is the first evidence that the policy
reads its inputs.

The CLI takes a learning-proof workdir and the learning proof's flags
(`train/learn_proof.py`), which name the checkpoint's model, plus its own;
the report, with the restored `checkpoint_step`, goes to `--out` (default
`<workdir>/diagnostics.json`, or
`<workdir>/corpus_entropy.json` with `--corpus_entropy`) and its summary
is the last line printed. The policy runs on `cuda` unless `--device cpu`
is given.

  python -m rt1_tpu_torch.eval.diagnostics --workdir /tmp/learn_proof --diag_episodes 20
  python -m rt1_tpu_torch.eval.diagnostics --workdir /tmp/learn_proof --corpus_entropy
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Optional

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


def block_target_distance(env) -> Optional[float]:
    """The start block's distance to the target block of the current
    block2block task (attribute access passes through the wrappers to the
    base env); None for a task without them."""
    try:
        reward = env._reward_calculator
        state = env.compute_state(request_task_update=False)
        start = np.asarray(state[f"block_{reward._start_block}_translation"], np.float64)
        target = np.asarray(state[f"block_{reward._target_block}_translation"], np.float64)
    except (AttributeError, KeyError):
        return None
    return float(np.linalg.norm(start - target))


def closed_loop_diagnostics(policy, env, episodes: int, max_steps: int = 80, log=None):
    """`episodes` oracle-validated episodes of `policy` in `env`, the RRT
    oracle queried on each state; returns the report: `episodes`,
    `successes`, `oracle_cosine_mean`, `action_std_mean`,
    `block_target_progress_mean` and `per_episode`."""
    from rt1_tpu_torch.envs.oracles import RRTPushOracle

    per_episode = []
    for ep in range(episodes):
        oracle = RRTPushOracle(env, use_ee_planner=True)
        while True:
            obs = env.reset()
            if oracle.get_plan(env.compute_state()):
                break
        policy.reset()
        d0 = block_target_distance(env)
        cos, acts = [], []
        done, steps = False, 0
        while not done and steps < max_steps:
            a_pi = np.asarray(policy.action(obs), np.float64)
            a_star = np.asarray(oracle.action(env.compute_state()), np.float64)[:2]
            na, nb = np.linalg.norm(a_pi), np.linalg.norm(a_star)
            if na > 1e-9 and nb > 1e-9:
                cos.append(float(a_pi @ a_star / (na * nb)))
            acts.append(a_pi)
            obs, _, done, _ = env.step(a_pi.astype(np.float32))
            steps += 1
        acts = np.asarray(acts)
        per_episode.append({
            "success": bool(env.succeeded),
            "steps": steps,
            "oracle_cosine_mean": float(np.mean(cos)) if cos else None,
            "action_std": float(np.mean(np.std(acts, axis=0))),
            "action_abs_p50": float(np.median(np.abs(acts))),
            "block_target_dist_start": d0,
            "block_target_dist_end": block_target_distance(env),
        })
        if log is not None:
            log({"episode": ep, **per_episode[-1]})
    cos_means = [e["oracle_cosine_mean"] for e in per_episode
                 if e["oracle_cosine_mean"] is not None]
    deltas = [e["block_target_dist_start"] - e["block_target_dist_end"] for e in per_episode
              if e["block_target_dist_start"] is not None
              and e["block_target_dist_end"] is not None]
    return {
        "episodes": episodes,
        "successes": sum(e["success"] for e in per_episode),
        "oracle_cosine_mean": float(np.mean(cos_means)) if cos_means else None,
        "action_std_mean": float(np.mean([e["action_std"] for e in per_episode])),
        "block_target_progress_mean": float(np.mean(deltas)) if deltas else None,
        "per_episode": per_episode,
    }


def parse_args(argv):
    """(the diagnostics' flags, the learning proof's flags)."""
    from rt1_tpu_torch.train import learn_proof

    p = argparse.ArgumentParser(prog="python -m rt1_tpu_torch.eval.diagnostics",
                                description=__doc__.splitlines()[0], add_help=False)
    p.add_argument("--diag_episodes", type=int, default=20, help="Diagnostic episodes.")
    p.add_argument("--max_steps", type=int, default=80, help="Step budget per episode.")
    p.add_argument("--diag_seed", type=int, default=20_000,
                   help="Env seed (disjoint from train and eval).")
    p.add_argument("--out", default="", help="Output JSON (default under --workdir).")
    p.add_argument("--corpus_entropy", action="store_true",
                   help="Report the corpus' marginal action-token entropy instead (needs "
                        "only <workdir>/data, no checkpoint).")
    p.add_argument("--entropy_episodes", type=int, default=200,
                   help="Train episodes scanned for --corpus_entropy.")
    ours, rest = p.parse_known_args(argv)
    return ours, learn_proof.parse_args(rest)


def main(argv=None) -> int:
    args, proof_args = parse_args(sys.argv[1:] if argv is None else argv)

    from rt1_tpu_torch.envs import blocks
    from rt1_tpu_torch.eval.evaluate import build_eval_env
    from rt1_tpu_torch.train import learn_proof

    def emit(record):
        print(json.dumps(record), flush=True)

    proof = learn_proof.LearnProof(proof_args)
    if args.corpus_entropy:
        report = corpus_entropy(proof.data_dir, args.entropy_episodes)
        out = args.out or os.path.join(proof_args.workdir, "corpus_entropy.json")
        summary = report
    else:
        from rt1_tpu_torch import resolve_device

        resolve_device(proof_args.device)  # no card and no --device cpu: refuse first
        proof.check_meta("diagnostics", learn_proof.EVAL_META_KEYS)
        policy, step = proof.restore_policy()
        config = proof.train_config(proof_args.num_steps)
        env = build_eval_env(reward_name=learn_proof.REWARD,
                             block_mode=blocks.BlockMode(proof_args.block_mode),
                             seed=args.diag_seed, embedder=proof_args.embedder,
                             target_height=config.data.height, target_width=config.data.width,
                             sequence_length=config.model.time_sequence_length)
        report = closed_loop_diagnostics(policy, env, args.diag_episodes, args.max_steps,
                                         log=emit)
        report["checkpoint_step"] = step  # which checkpoint the report is of
        out = args.out or os.path.join(proof_args.workdir, "diagnostics.json")
        summary = {k: v for k, v in report.items() if k != "per_episode"}
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    emit(summary)
    return 0


if __name__ == "__main__":
    sys.exit(main())
