"""The port's training loop, checkpoints and CLI, on the CPU.

* Resume is exact: 4 steps in one run equal 2 steps, a save, a restore and
  2 more, bit for bit (policy weights, BatchNorm statistics, optimizer
  moments, counters), with dropout, stochastic depth and the crop on —
  every draw is seeded from (seed, step). Held on the tiny config with the
  `efficientnet_small` tokenizer, which has BatchNorm and stochastic depth.
* Checkpoints: one file per step written through a rename, `latest_step`
  ignores an unfinished save, `max_to_keep` prunes the oldest.
* The CLI (`python -m rt1_tpu_torch.train --config tiny --device cpu`)
  runs twice in one workdir; the second run resumes from step 4, and the
  serving engine loads what it wrote. Without `--device cpu` and without a
  card it raises.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from rt1_tpu_torch.configs import apply_override, get_config
from rt1_tpu_torch.eval.restore import build_serve_engine
from rt1_tpu_torch.trainer.checkpoints import (
    CheckpointManager,
    all_steps,
    latest_step,
    load_checkpoint,
)
from rt1_tpu_torch.trainer.optim import Adam
from rt1_tpu_torch.trainer.state import create_train_state
from rt1_tpu_torch.train.train import build_model, train_and_evaluate

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def small_config(num_steps):
    cfg = get_config("tiny")
    for assignment in ("model.image_tokenizer=efficientnet_small", f"num_steps={num_steps}",
                       "eval_every_steps=2", "log_every_steps=2", "per_host_batch_size=4"):
        apply_override(cfg, assignment)
    return cfg


def final_state(workdir):
    return load_checkpoint(os.path.join(workdir, "checkpoints"))


def test_resume_equals_an_unbroken_run(tmp_path):
    quiet = lambda record: None  # noqa: E731
    unbroken = train_and_evaluate(small_config(4), str(tmp_path / "a"), device="cpu", log=quiet)
    train_and_evaluate(small_config(2), str(tmp_path / "b"), device="cpu", log=quiet)
    records = []
    resumed = train_and_evaluate(small_config(4), str(tmp_path / "b"), device="cpu",
                                 log=records.append)
    assert records[0]["restored_step"] == 2
    assert int(unbroken.step) == int(resumed.step) == 4
    a, b = final_state(tmp_path / "a"), final_state(tmp_path / "b")
    assert a["loop_step"] == b["loop_step"] == 4
    assert a["policy"].keys() == b["policy"].keys()
    assert any("running_var" in k for k in a["policy"])
    for key in a["policy"]:
        assert torch.equal(a["policy"][key], b["policy"][key]), key
    for key in ("mu", "nu"):
        assert torch.equal(a["optimizer"][key], b["optimizer"][key]), key
    assert (a["optimizer"]["count"], a["step"], a["guard_skips"]) == \
        (b["optimizer"]["count"], b["step"], b["guard_skips"]) == (4, 4, 0)
    # The statistics really moved, and the loop wrote its metrics.
    assert not torch.equal(a["policy"]["image_tokenizer.encoder.net.stem.bn.running_var"],
                           torch.ones_like(a["policy"]["image_tokenizer.encoder.net.stem.bn.running_var"]))
    lines = [json.loads(x) for x in open(tmp_path / "b" / "metrics.jsonl")]
    assert [r["step"] for r in lines if "loss" in r] == [2, 4]
    assert [r["step"] for r in lines if "eval_loss" in r] == [2, 4]
    assert all(r["frames_per_sec"] > 0 for r in lines if "loss" in r)


def test_checkpoint_manager(tmp_path):
    cfg = get_config("tiny")
    policy = build_model(cfg, "cpu")
    state = create_train_state(policy, Adam())
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2, seed=3)
    assert mgr.latest_step() is None and mgr.restore_or_initialize(state) == (state, 0)
    for step in (2, 4, 6, 8, 10):
        state.step.fill_(step)
        mgr.save(step, state)
    assert all_steps(str(tmp_path)) == [8, 10]
    # A save cut before its rename leaves no state.pt: not a checkpoint.
    os.makedirs(tmp_path / "12")
    (tmp_path / "12" / "state.pt.tmp").write_bytes(b"partial")
    assert latest_step(str(tmp_path)) == 10
    with torch.no_grad():
        for p in policy.parameters():
            p.zero_()
    assert mgr.restore(state, step=8) == 8 and int(state.step) == 8
    assert any(float(p.abs().sum()) > 0 for p in policy.parameters())
    ckpt = load_checkpoint(str(tmp_path))
    assert ckpt["rng"] == {"seed": 3, "step": 10} and ckpt["format"] == "rt1_tpu_torch.trainer/1"
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "none"))


def _cli(*args, device="cpu"):
    env = dict(os.environ, PYTHONPATH=REPO)
    cmd = [sys.executable, "-m", "rt1_tpu_torch.train", "--config", "tiny", *args]
    if device:
        cmd += ["--device", device]
    return subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


def test_cli_trains_resumes_and_serves(tmp_path):
    workdir = str(tmp_path / "run")
    first = _cli("--workdir", workdir)
    assert first.returncode == 0, first.stderr
    lines = [json.loads(x) for x in first.stdout.splitlines()]
    assert lines[0]["status"] == "start" and lines[0]["restored_step"] is None
    assert lines[-1] == {"status": "done", "step": 4, "updates": 4, "guard_skips": 0,
                         "checkpoint_step": 4}
    assert all_steps(os.path.join(workdir, "checkpoints")) == [2, 4]
    second = _cli("--workdir", workdir, "--set", "num_steps=6")
    assert second.returncode == 0, second.stderr
    lines = [json.loads(x) for x in second.stdout.splitlines()]
    assert lines[0]["restored_step"] == 4
    assert [r["step"] for r in lines if "loss" in r] == [5, 6]
    assert lines[-1]["checkpoint_step"] == 6
    engine, step = build_serve_engine(get_config("tiny"), workdir=workdir, device="cpu")
    assert step == 6
    saved = final_state(workdir)["policy"]
    for key, value in engine.policy.state_dict().items():
        if key in saved:
            assert torch.equal(value, saved[key]), key


def test_cli_defaults_to_cuda_and_raises_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device would train on it")
    proc = _cli("--workdir", str(tmp_path / "x"), device=None)
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr
    assert not os.path.exists(tmp_path / "x" / "checkpoints")
