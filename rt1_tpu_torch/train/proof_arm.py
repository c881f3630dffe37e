"""The learning proof's arm: the learning arm of `scripts/round5_pipeline.sh`
(its stage 2) as one process, `python -m rt1_tpu_torch.train.proof_arm`.

It drives `train/learn_proof.py`'s stages over one `--workdir` in the
pipeline's order, each resumed or skipped from what the workdir holds, so
running the arm again picks up where a run stopped:

1. collect — skipped when `data/manifest.json` exists;
2. train — resumes from the newest checkpoint, skipped at `--num_steps`;
3. eval at `--eval_episodes` (20) — skipped when `learn_proof.json` (or
   the candidate's copy) holds the newest checkpoint at that count;
4. powered_eval — the registered powering: a criterion met on fewer than
   50 episodes is only a candidate, so the 20-episode summary is copied to
   `learn_proof_candidate.json` and the eval re-runs at 50 episodes.
   `needs_powering` is the pipeline's rule as its shell step states it;
5. diagnostics — 20 closed-loop episodes (`eval/diagnostics.py`) into
   `<workdir>/diagnostics.json`, skipped when it holds the newest checkpoint;
6. dagger — when training reached `--num_steps`, `--dagger_rounds` is not
   0 and `dagger_rounds.json` (written when every round is done) is absent.

The headline is the eval before DAgger: once DAgger has begun, its
checkpoints are past the evaluated one, and stages 3-5 are skipped
(`after_dagger`). No stage starts `--deadline_s` seconds after the arm's
start (the pipeline's DEADLINE_EPOCH: 9 h). Nothing retries: a stage that
raises ends the arm with exit code 1 and no later stage runs.

Each stage prints one JSON line, `{"proof_arm": <stage>, "status": "ran" |
"skipped" | "past_deadline" | "failed", "seconds": ...}`, beside the
stages' own lines; the last line is the decision: `powered_met`,
`powered_not_met`, `candidate` (met, not yet powered), `not_met_at_<n>` or
`no_eval`, the trained / random / oracle successes at each episode count
and the evaluated checkpoint step. Runs on `cuda` unless `--device cpu`.

  python -m rt1_tpu_torch.train.proof_arm --workdir /tmp/proof --episodes 800 \\
      --num_steps 12000 --workers 8
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
import traceback

POWERED_EPISODES = 50     # the pipeline's re-run count; the protocol's headline minimum
DIAG_EPISODES = 20        # the pipeline's diagnostics episodes
DEFAULT_DEADLINE_S = 32_400.0  # the pipeline's DEADLINE_EPOCH default: 9 h after launch
ARMS = ("trained", "random", "oracle")


def _emit(record):
    print(json.dumps(record), flush=True)


def _read_json(path):
    """The parsed file, or None when it is missing or unreadable."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def needs_powering(path) -> bool:
    """The pipeline's powering rule on `learn_proof.json`: re-run the eval
    at 50 episodes when the criterion is met on fewer (a missing
    `eval_episodes` counts as 0; a file that is unreadable, or whose
    values the rule cannot compare, means no re-run)."""
    s = _read_json(path)
    try:
        return bool(s.get("criterion_met") and s.get("eval_episodes", 0) < POWERED_EPISODES)
    except (AttributeError, TypeError):
        return False


def _holds(summary, step, episodes) -> bool:
    return isinstance(summary, dict) and summary.get("evaluated_checkpoint_step") == step \
        and summary.get("eval_episodes") == episodes


def decide(workdir) -> dict:
    """The arm's decision from `learn_proof.json` (and the candidate's copy
    of the same checkpoint)."""
    summary = _read_json(os.path.join(workdir, "learn_proof.json"))
    if not isinstance(summary, dict):
        return {"proof_arm": "decision", "decision": "no_eval", "successes": {},
                "evaluated_checkpoint_step": None}
    candidate = _read_json(os.path.join(workdir, "learn_proof_candidate.json"))
    step = summary.get("evaluated_checkpoint_step")
    successes = {}
    for s in (candidate, summary):
        if isinstance(s, dict) and s.get("evaluated_checkpoint_step") == step:
            successes[str(s.get("eval_episodes"))] = {a: s.get(f"{a}_successes") for a in ARMS}
    episodes = summary.get("eval_episodes", 0)
    met = bool(summary.get("criterion_met"))
    if episodes >= POWERED_EPISODES:
        decision = "powered_met" if met else "powered_not_met"
    else:
        decision = "candidate" if met else f"not_met_at_{episodes}"
    return {"proof_arm": "decision", "decision": decision, "successes": successes,
            "evaluated_checkpoint_step": step}


def parse_args(argv):
    """(the arm's flags, the learning proof's flags and their argv)."""
    from rt1_tpu_torch.train import learn_proof

    p = argparse.ArgumentParser(prog="python -m rt1_tpu_torch.train.proof_arm",
                                description=__doc__.splitlines()[0], add_help=False)
    p.add_argument("--deadline_s", type=float, default=DEFAULT_DEADLINE_S,
                   help="No stage starts this many seconds after the arm's start.")
    ours, rest = p.parse_known_args(argv)
    proof_args = learn_proof.parse_args(rest)
    if proof_args.stage != "all":
        raise SystemExit("proof_arm: --stage is the arm's to choose; drop it")
    return ours, proof_args, rest


class ProofArm:
    """The pipeline's learning arm over one workdir."""

    def __init__(self, args, proof_args, proof_argv):
        from rt1_tpu_torch.train.learn_proof import LearnProof

        self.deadline_s = args.deadline_s
        self.args = proof_args
        self.argv = list(proof_argv)
        self.proof = LearnProof(proof_args)
        self.workdir = proof_args.workdir
        self.proof_json = os.path.join(self.workdir, "learn_proof.json")
        self.candidate_json = os.path.join(self.workdir, "learn_proof_candidate.json")
        self.diag_json = os.path.join(self.workdir, "diagnostics.json")
        self.dagger_json = os.path.join(self.workdir, "dagger_rounds.json")
        self.t0 = time.monotonic()

    def _dagger_begun(self):
        return os.path.exists(self.dagger_json) or \
            os.path.exists(os.path.join(self.workdir, "dagger_state.json"))

    # Each `_<stage>` runs its stage and returns None, or returns the
    # reason it is skipped.

    def _collect(self):
        from rt1_tpu_torch.data.episodes import read_manifest

        done = read_manifest(self.proof.data_dir) is not None
        self.proof.collect()  # with a corpus: checks its noise level, collects nothing
        return "done" if done else None

    def _train(self):
        latest = self.proof.latest_step()
        if latest is not None and latest >= self.args.num_steps:
            return "done"
        self.proof.train()
        return None

    def _eval(self):
        if self._dagger_begun():
            return "after_dagger"
        step, n = self.proof.latest_step(), self.args.eval_episodes
        if _holds(_read_json(self.proof_json), step, n) or \
                _holds(_read_json(self.candidate_json), step, n):
            return "done"
        self.proof.evaluate()
        return None

    def _powered_eval(self):
        from rt1_tpu_torch.train.learn_proof import LearnProof

        if self._dagger_begun():
            return "after_dagger"
        if not needs_powering(self.proof_json):
            return "not_needed"
        # Both results stay: the candidate's summary, then the powered one.
        shutil.copyfile(self.proof_json, self.candidate_json + ".tmp")
        os.replace(self.candidate_json + ".tmp", self.candidate_json)
        powered = argparse.Namespace(**{**vars(self.args), "eval_episodes": POWERED_EPISODES})
        LearnProof(powered).evaluate()
        return None

    def _diagnostics(self):
        from rt1_tpu_torch.eval import diagnostics

        if self._dagger_begun():
            return "after_dagger"
        report = _read_json(self.diag_json)
        if isinstance(report, dict) and \
                report.get("checkpoint_step") == self.proof.latest_step():
            return "done"
        diagnostics.main(self.argv + ["--diag_episodes", str(DIAG_EPISODES),
                                      "--out", self.diag_json])
        return None

    def _dagger(self):
        if self.args.dagger_rounds == 0:
            return "no_rounds"
        if os.path.exists(self.dagger_json):
            return "done"
        latest = self.proof.latest_step()
        if latest is None or latest < self.args.num_steps:
            return "undertrained"
        self.proof.dagger()
        return None

    STAGES = ("collect", "train", "eval", "powered_eval", "diagnostics", "dagger")

    def run(self) -> int:
        for stage in self.STAGES:
            t0 = time.monotonic()
            if t0 - self.t0 >= self.deadline_s:
                _emit({"proof_arm": stage, "status": "past_deadline", "seconds": 0.0})
                continue
            try:
                reason = getattr(self, f"_{stage}")()
            except Exception as exc:
                traceback.print_exc()
                _emit({"proof_arm": stage, "status": "failed", "error": repr(exc),
                       "seconds": time.monotonic() - t0})
                return 1
            record = {"proof_arm": stage, "status": "ran" if reason is None else "skipped"}
            if reason is not None:
                record["reason"] = reason
            _emit({**record, "seconds": time.monotonic() - t0})
        _emit(decide(self.workdir))
        return 0


def main(argv=None) -> int:
    args, proof_args, proof_argv = parse_args(sys.argv[1:] if argv is None else argv)

    from rt1_tpu_torch import resolve_device

    resolve_device(proof_args.device)  # no card and no --device cpu: refuse first
    return ProofArm(args, proof_args, proof_argv).run()


if __name__ == "__main__":
    sys.exit(main())
