"""The learning proof's arm (`python -m rt1_tpu_torch.train.proof_arm`)
against the learning arm of `scripts/round5_pipeline.sh`.

* The powering rule: the pipeline's own Python step (the heredoc after
  "Pre-registered headline powering"), run with this interpreter on the
  same `learn_proof.json`, re-runs the eval exactly when `needs_powering`
  says so: met at 20, met at 50, not met, `eval_episodes` missing, bad
  JSON, no file, and more.
* End to end on the CPU at `tests/test_torch_proof.py`'s `TINY` flags:
  collect, train, eval, diagnostics (1 episode), no DAgger; a second run
  skips every stage and changes no checkpoint and no `learn_proof.json`.
  DAgger after the headline, and a run after it that evaluates nothing.
* A forced candidate (criterion met, powering at 2 episodes): the powered
  eval runs and `learn_proof_candidate.json` keeps the first summary.
* A stage that raises ends the arm with 1 and no later stage runs; a
  deadline of 0 runs nothing; no card and no `--device cpu` refuses.
"""

import ast
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from rt1_tpu_torch.eval import proof as port_proof
from rt1_tpu_torch.train import learn_proof, proof_arm
from rt1_tpu_torch.trainer.checkpoints import all_steps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIPELINE = os.path.join(REPO, "scripts", "round5_pipeline.sh")

TINY = ["--config", "tiny", "--device", "cpu", "--episodes", "3", "--workers", "2",
        "--num_steps", "2", "--eval_episodes", "1", "--height", "32", "--width", "56",
        "--batch", "2", "--seq_len", "3", "--dtype", "float32",
        "--set", "model.image_tokenizer=tiny", "--set", "data.loader=numpy"]
NO_DAGGER = ["--dagger_rounds", "0"]
DAGGER = ["--dagger_rounds", "1", "--dagger_episodes", "1", "--dagger_extra_steps", "2"]


def test_tiny_flags_are_the_proof_tests():
    """`TINY` here is `tests/test_torch_proof.py`'s (read from its source,
    without importing its JAX side)."""
    with open(os.path.join(REPO, "tests", "test_torch_proof.py")) as f:
        tree = ast.parse(f.read())
    (node,) = [n for n in tree.body if isinstance(n, ast.Assign)
               and [t.id for t in n.targets if isinstance(t, ast.Name)] == ["TINY"]]
    assert ast.literal_eval(node.value) == TINY


# ------------------------------------------------------------ the powering rule


def _pipeline_powering_step():
    """The Python the pipeline runs on `learn_proof.json` to decide the
    powered re-run (exit 0 = re-run), from the script's text."""
    with open(PIPELINE) as f:
        lines = f.read().splitlines()
    (start,) = [i for i, line in enumerate(lines)
                if 'learn_proof.json" <<\'EOF\'' in line and "python -" in line]
    assert "Pre-registered headline powering" in "\n".join(lines[start - 4:start])
    end = lines.index("EOF", start)
    body = "\n".join(lines[start + 1:end]) + "\n"
    assert "criterion_met" in body and "eval_episodes" in body
    return body


POWERING_CASES = {
    "met_at_20": {"criterion_met": True, "eval_episodes": 20},
    "met_at_50": {"criterion_met": True, "eval_episodes": 50},
    "not_met_at_20": {"criterion_met": False, "eval_episodes": 20},
    "not_met_at_50": {"criterion_met": False, "eval_episodes": 50},
    "met_at_49": {"criterion_met": True, "eval_episodes": 49},
    "met_at_80": {"criterion_met": True, "eval_episodes": 80},
    "episodes_missing": {"criterion_met": True},
    "criterion_missing": {"eval_episodes": 20},
    "criterion_truthy": {"criterion_met": 1, "eval_episodes": 20},
    "not_an_object": [1, 2],
    "episodes_not_a_number": {"criterion_met": True, "eval_episodes": "20"},
    "bad_json": "{not json",
    "empty_file": "",
    "no_file": None,
}


@pytest.mark.parametrize("case", sorted(POWERING_CASES))
def test_powering_rule_is_the_pipelines(case, tmp_path):
    content = POWERING_CASES[case]
    path = tmp_path / "learn_proof.json"
    if isinstance(content, str):
        path.write_text(content)
    elif content is not None:
        path.write_text(json.dumps(content))
    proc = subprocess.run([sys.executable, "-", str(path)], input=_pipeline_powering_step(),
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode in (0, 1), proc.stderr
    assert proof_arm.needs_powering(str(path)) == (proc.returncode == 0)


def _summary(step, episodes, trained, oracle, random=0):
    return {"evaluated_checkpoint_step": step, "eval_episodes": episodes,
            "trained_successes": trained, "random_successes": random,
            "oracle_successes": oracle,
            "criterion_met": port_proof.criterion_met(trained, oracle)}


DECISION_CASES = {
    "powered_met": (_summary(12, 20, 6, 10), _summary(12, 50, 14, 26), "powered_met",
                    {"20": (6, 0, 10), "50": (14, 0, 26)}),
    "powered_not_met": (_summary(12, 20, 6, 10), _summary(12, 50, 9, 26), "powered_not_met",
                        {"20": (6, 0, 10), "50": (9, 0, 26)}),
    "not_met_at_20": (None, _summary(12, 20, 3, 10), "not_met_at_20", {"20": (3, 0, 10)}),
    "candidate": (None, _summary(12, 20, 5, 10), "candidate", {"20": (5, 0, 10)}),
    "other_checkpoints_candidate": (_summary(8, 20, 6, 10), _summary(12, 20, 1, 10),
                                    "not_met_at_20", {"20": (1, 0, 10)}),
    "no_eval": (None, None, "no_eval", {}),
}


@pytest.mark.parametrize("case", sorted(DECISION_CASES))
def test_decision(case, tmp_path):
    candidate, summary, decision, successes = DECISION_CASES[case]
    for name, record in (("learn_proof_candidate.json", candidate),
                         ("learn_proof.json", summary)):
        if record is not None:
            (tmp_path / name).write_text(json.dumps(record))
    got = proof_arm.decide(str(tmp_path))
    assert got["decision"] == decision
    assert got["successes"] == {n: dict(zip(("trained", "random", "oracle"), c))
                                for n, c in successes.items()}
    assert got["evaluated_checkpoint_step"] == (summary or {}).get("evaluated_checkpoint_step")


# ------------------------------------------------------------ the arm end to end


def _run_arm(argv):
    """(exit code, the JSON lines printed) of the arm's `main` in process."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = proof_arm.main(list(argv))
    return code, [json.loads(x) for x in out.getvalue().splitlines() if x.startswith("{")]


def _arm_lines(lines):
    return {r["proof_arm"]: r for r in lines if "proof_arm" in r}


def _state(workdir):
    """What a run that skips must leave as it was: the checkpoints and the
    summaries' bytes."""
    files = {}
    for name in ("learn_proof.json", "learn_proof_candidate.json", "diagnostics.json",
                 "dagger_rounds.json"):
        path = os.path.join(workdir, name)
        if os.path.exists(path):
            with open(path, "rb") as f:
                files[name] = f.read()
    return all_steps(os.path.join(workdir, "train", "checkpoints")), files


@pytest.fixture(scope="module")
def finished(tmp_path_factory):
    """A workdir the arm ran end to end (no DAgger), and its lines."""
    workdir = str(tmp_path_factory.mktemp("arm") / "proof")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(proof_arm, "DIAG_EPISODES", 1)
        code, lines = _run_arm(TINY + NO_DAGGER + ["--workdir", workdir])
    assert code == 0
    return workdir, lines


def _copy(finished, tmp_path):
    workdir = str(tmp_path / "proof")
    shutil.copytree(finished[0], workdir)
    return workdir


def test_arm_end_to_end_then_resumes_with_nothing_to_do(finished, tmp_path):
    workdir, lines = finished
    arm = _arm_lines(lines)
    assert list(arm) == list(proof_arm.ProofArm.STAGES) + ["decision"]
    assert [arm[s]["status"] for s in proof_arm.ProofArm.STAGES] == \
        ["ran", "ran", "ran", "skipped", "ran", "skipped"]
    assert (arm["powered_eval"]["reason"], arm["dagger"]["reason"]) == \
        ("not_needed", "no_rounds")
    assert all(r["seconds"] >= 0 for s, r in arm.items() if s != "decision")
    # The stages' own lines ran in between, in the pipeline's order.
    kinds = [r.get("stage") or r.get("proof_arm") for r in lines
             if r.get("stage") in ("collect", "train", "eval") or "proof_arm" in r]
    assert kinds.index("collect") < kinds.index("train") < kinds.index("eval") < \
        kinds.index("diagnostics")
    with open(os.path.join(workdir, "learn_proof.json")) as f:
        summary = json.load(f)
    with open(os.path.join(workdir, "diagnostics.json")) as f:
        report = json.load(f)
    assert summary["evaluated_checkpoint_step"] == report["checkpoint_step"] == 2
    assert summary["eval_episodes"] == 1 and report["episodes"] == 1
    assert not os.path.exists(os.path.join(workdir, "learn_proof_candidate.json"))
    decision = arm["decision"]
    assert decision["decision"] == ("candidate" if summary["criterion_met"] else "not_met_at_1")
    assert decision["evaluated_checkpoint_step"] == 2
    assert decision["successes"] == {"1": {a: summary[f"{a}_successes"]
                                           for a in ("trained", "random", "oracle")}}
    assert lines[-1] == decision
    # Again over the same workdir: every stage skipped, nothing changes.
    workdir = _copy(finished, tmp_path)
    before = _state(workdir)
    code, again = _run_arm(TINY + NO_DAGGER + ["--workdir", workdir])
    assert code == 0
    arm = _arm_lines(again)
    assert {s: arm[s].get("reason") for s in proof_arm.ProofArm.STAGES} == {
        "collect": "done", "train": "done", "eval": "done", "powered_eval": "not_needed",
        "diagnostics": "done", "dagger": "no_rounds"}
    assert not any("steps_per_sec" in r or r.get("arm") for r in again)
    assert _state(workdir) == before
    assert arm["decision"] == decision


def test_dagger_comes_after_the_headline_and_is_not_evaluated_again(finished, tmp_path):
    workdir = _copy(finished, tmp_path)
    with open(os.path.join(workdir, "learn_proof.json"), "rb") as f:
        headline = f.read()
    code, lines = _run_arm(TINY + DAGGER + ["--workdir", workdir])
    assert code == 0
    arm = _arm_lines(lines)
    assert arm["dagger"]["status"] == "ran"
    assert [arm[s]["status"] for s in proof_arm.ProofArm.STAGES[:-1]] == ["skipped"] * 5
    assert all_steps(os.path.join(workdir, "train", "checkpoints"))[-1] == 4
    before = _state(workdir)
    code, again = _run_arm(TINY + DAGGER + ["--workdir", workdir])
    assert code == 0
    arm = _arm_lines(again)
    assert {s: arm[s].get("reason") for s in proof_arm.ProofArm.STAGES} == {
        "collect": "done", "train": "done", "eval": "after_dagger",
        "powered_eval": "after_dagger", "diagnostics": "after_dagger", "dagger": "done"}
    assert _state(workdir) == before and before[1]["learn_proof.json"] == headline
    assert arm["decision"]["evaluated_checkpoint_step"] == 2


def test_forced_candidate_is_powered_and_both_summaries_stay(finished, tmp_path, monkeypatch):
    workdir = _copy(finished, tmp_path)
    os.remove(os.path.join(workdir, "learn_proof.json"))
    monkeypatch.setattr(port_proof, "criterion_met", lambda trained, oracle: True)
    monkeypatch.setattr(proof_arm, "POWERED_EPISODES", 2)
    code, lines = _run_arm(TINY + NO_DAGGER + ["--workdir", workdir])
    assert code == 0
    arm = _arm_lines(lines)
    assert (arm["eval"]["status"], arm["powered_eval"]["status"]) == ("ran", "ran")
    assert arm["diagnostics"]["reason"] == "done"
    evals = [r["summary"]["eval_episodes"] for r in lines if "summary" in r]
    assert evals == [1, 2]
    with open(os.path.join(workdir, "learn_proof_candidate.json")) as f:
        candidate = json.load(f)
    with open(os.path.join(workdir, "learn_proof.json")) as f:
        powered = json.load(f)
    assert (candidate["eval_episodes"], powered["eval_episodes"]) == (1, 2)
    assert candidate["evaluated_checkpoint_step"] == powered["evaluated_checkpoint_step"] == 2
    assert candidate["criterion_met"] and powered["criterion_met"]
    assert arm["decision"]["decision"] == "powered_met"
    assert sorted(arm["decision"]["successes"]) == ["1", "2"]
    # Resumed: the eval at 1 is the candidate's, the powered one is done.
    before = _state(workdir)
    code, again = _run_arm(TINY + NO_DAGGER + ["--workdir", workdir])
    arm = _arm_lines(again)
    assert code == 0 and (arm["eval"]["reason"], arm["powered_eval"]["reason"]) == \
        ("done", "not_needed")
    assert _state(workdir) == before


def test_a_failed_stage_ends_the_arm(finished, tmp_path, monkeypatch):
    workdir = _copy(finished, tmp_path)
    os.remove(os.path.join(workdir, "learn_proof.json"))

    def broken(self):
        raise RuntimeError("eval broke")

    monkeypatch.setattr(learn_proof.LearnProof, "evaluate", broken)
    code, lines = _run_arm(TINY + NO_DAGGER + ["--workdir", workdir])
    assert code == 1
    arm = _arm_lines(lines)
    assert list(arm) == ["collect", "train", "eval"]
    assert arm["eval"]["status"] == "failed" and "eval broke" in arm["eval"]["error"]
    assert not os.path.exists(os.path.join(workdir, "learn_proof.json"))


def test_a_past_deadline_runs_nothing(tmp_path):
    workdir = str(tmp_path / "proof")
    code, lines = _run_arm(TINY + ["--workdir", workdir, "--deadline_s", "0"])
    assert code == 0
    arm = _arm_lines(lines)
    assert {s: arm[s]["status"] for s in proof_arm.ProofArm.STAGES} == \
        {s: "past_deadline" for s in proof_arm.ProofArm.STAGES}
    assert arm["decision"]["decision"] == "no_eval" and lines[-1] == arm["decision"]
    assert not os.path.exists(workdir)


def test_refusals(tmp_path, monkeypatch):
    with pytest.raises(SystemExit, match="--stage"):
        proof_arm.main(TINY + ["--workdir", str(tmp_path), "--stage", "eval"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        proof_arm.main([a for a in TINY if a not in ("--device", "cpu")]
                       + ["--workdir", str(tmp_path)])
    assert os.listdir(tmp_path) == []


def test_defaults_are_the_pipelines():
    args, proof_args, _ = proof_arm.parse_args([])
    assert args.deadline_s == 9 * 3600 == proof_arm.DEFAULT_DEADLINE_S
    assert (proof_arm.POWERED_EPISODES, proof_arm.DIAG_EPISODES) == \
        (port_proof.MIN_EPISODES_FOR_SUCCESS_HEADLINE, 20)
    assert vars(proof_args) == vars(learn_proof.parse_args([]))
