"""The port's guarded step and resilient train loop against the JAX
package's, on the tiny config on the CPU.

* The guarded step: `guard_grad_norm_max` skips the updates JAX's guarded
  step skips (the same skip counts over the same batches); a healthy
  guarded step is the unguarded step, bit for bit.
* The loop, JAX's scenario (`tests/test_resilience_guard.py`): 8 steps,
  checkpoints every 2, a log every step, `guard_skip_budget=1`,
  `nan_batch@4x3`. Both packages skip the poisoned steps 5 and 6 on the
  device, roll back to the step-4 checkpoint with a fresh seed and reach
  step 8; every log step's loss finiteness, cumulative skip count and
  guard counters are equal. The ledger books the replayed steps.
* Port only: the run aborts when the rollback budget is exhausted, and
  clearly when there is no checkpoint to roll back to; a run preempted by
  `sigterm@3` and resumed ends with parameters, statistics and moments
  bit for bit those of an unbroken run; the CLI in a subprocess exits 0
  with a checkpoint after `RT1_FAULTS=sigterm@2`; `goodput_summary.json`
  is written on success and on a crash, `flight_record.jsonl` on the crash
  (not on success).
"""

import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt1_tpu.parallel import MeshConfig, make_mesh
from rt1_tpu.resilience import faults as jfaults
from rt1_tpu.train.configs import tiny as jax_tiny
from rt1_tpu.trainer import make_optimizer, make_train_step_fns
from rt1_tpu.trainer.state import TrainState as JaxTrainState
from rt1_tpu_torch.configs import apply_override, get_config
from rt1_tpu_torch.resilience import GuardAbortError
from rt1_tpu_torch.resilience import faults as pfaults
from rt1_tpu_torch.trainer.checkpoints import load_checkpoint
from rt1_tpu_torch.trainer.optim import Adam
from rt1_tpu_torch.trainer.state import create_train_state
from rt1_tpu_torch.trainer.train import TrainStepFns
from rt1_tpu_torch.train.train import train_and_evaluate
from test_torch_train_policy import batch, tiny_pair, to_torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3


@pytest.fixture(autouse=True)
def _clean_faults():
    jfaults.clear()
    pfaults.clear()
    yield
    jfaults.clear()
    pfaults.clear()


def quiet(record):
    del record


# ------------------------------------------------------------ guarded step


def test_guard_grad_norm_max_skips_what_jax_skips():
    jm, pm, variables = tiny_pair(31)
    batches = [batch(32 + i, b=8) for i in range(4)]
    # Scale one batch's actions so its gradient norm is the largest, and put
    # the threshold between it and the others.
    obs, actions = batches[2]
    batches[2] = (dict(obs, natural_language_embedding=obs["natural_language_embedding"] * 40),
                  actions)
    probe = TrainStepFns(Adam(learning_rate=LR), seed=0)
    probe_state = create_train_state(tiny_pair(31)[1], Adam(learning_rate=LR))
    norms = [float(torch.sqrt(torch.sum(probe.value_and_grad(
        probe_state, (to_torch(o), to_torch(a)), 0)[1] ** 2))) for o, a in batches]
    limit = (max(norms) + sorted(norms)[-2]) / 2
    tx = make_optimizer(learning_rate=LR)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats={}, opt_state=tx.init(variables["params"]), tx=tx)
    jfns = make_train_step_fns(jm, make_mesh(MeshConfig()), jstate, donate=False,
                               guard_nonfinite=True, guard_grad_norm_max=limit)
    jstate, skips = jfns.shard_state(jstate), jfns.init_guard_skips()
    optimizer = Adam(learning_rate=LR)
    state = create_train_state(pm, optimizer)
    fns = TrainStepFns(optimizer, seed=0, guard_nonfinite=True, guard_grad_norm_max=limit)
    j_seq, p_seq = [], []
    for i, (obs, actions) in enumerate(batches):
        jstate, skips, _ = jfns.train_step(jstate, skips, jfns.shard_batch((obs, actions)),
                                           jax.random.PRNGKey(i))
        metrics = fns.train_step(state, (to_torch(obs), to_torch(actions)), i)
        j_seq.append((int(skips), int(jstate.step)))
        p_seq.append((int(metrics["guard_skips_cum"]), int(state.step)))
    assert j_seq == p_seq
    assert p_seq[-1][0] >= 1 and p_seq[-1][1] >= 1  # some skipped, some applied


def test_healthy_guarded_step_is_the_unguarded_step():
    results = []
    for guard in (True, False):
        _, pm, _ = tiny_pair(41)
        obs, actions = batch(42, b=4)
        optimizer = Adam(learning_rate=LR)
        state = create_train_state(pm, optimizer)
        fns = TrainStepFns(optimizer, seed=0, guard_nonfinite=guard, guard_grad_norm_max=1e9)
        metrics = fns.train_step(state, (to_torch(obs), to_torch(actions)), 0)
        results.append((state, metrics))
    (g, mg), (u, mu) = results
    assert torch.equal(mg["loss"], mu["loss"]) and int(mg["guard_skips_cum"]) == 0
    for a, b in ((g.flat, u.flat), (g.opt_state.mu, u.opt_state.mu),
                 (g.opt_state.nu, u.opt_state.nu), (g.step, u.step)):
        assert torch.equal(a, b)


# ------------------------------------------------------------------- loop


class _Writer:
    """Stands in for JAX's clu writer: keeps the scalars it is given."""

    def __init__(self):
        self.rows = []

    def write_scalars(self, step, scalars):
        self.rows.append(dict(scalars, step=step))

    def write_hparams(self, hparams):
        del hparams

    def flush(self):
        pass


def _log_steps(rows):
    """Each log step's (step, loss finite, cumulative skips, guard counters)."""
    return [(r["step"], math.isfinite(r["loss"]), r["guard_skips_cum"],
             {k: v for k, v in r.items() if k.startswith("guard/")})
            for r in rows if "loss" in r]


def _port_config(num_steps, checkpoint_every, **resilience):
    cfg = get_config("tiny")
    for assignment in (f"num_steps={num_steps}", f"checkpoint_every_steps={checkpoint_every}",
                       "log_every_steps=1"):
        apply_override(cfg, assignment)
    for key, value in resilience.items():
        setattr(cfg.resilience, key, value)
    return cfg


def test_nan_rollback_equals_jax(tmp_path, monkeypatch):
    import rt1_tpu.train.train as jax_train

    writer = _Writer()
    monkeypatch.setattr(jax_train, "create_writer", lambda workdir: writer)
    monkeypatch.setattr(jax_train, "log_parameter_overview", lambda *a, **k: None)
    jcfg = jax_tiny.get_config()
    jcfg.num_steps, jcfg.checkpoint_every_steps, jcfg.log_every_steps = 8, 2, 1
    jcfg.resilience.guard_skip_budget = 1
    jcfg.resilience.faults = "nan_batch@4x3"
    jstate = jax_train.train_and_evaluate(jcfg, str(tmp_path / "jax"))

    records = []
    cfg = _port_config(8, 2, guard_skip_budget=1, faults="nan_batch@4x3")
    state = train_and_evaluate(cfg, str(tmp_path / "port"), device="cpu", log=records.append)
    expected = _log_steps(writer.rows)
    assert _log_steps(records) == expected
    # Steps 5 and 6 skipped on the device, then the rollback to step 4.
    assert [(s, ok, skips) for s, ok, skips, _ in expected] == [
        (1, True, 0), (2, True, 0), (3, True, 0), (4, True, 0), (5, False, 1), (6, False, 2),
        (5, True, 2), (6, True, 2), (7, True, 2), (8, True, 2)]
    rollbacks = [r for r in records if r.get("status") == "guard_rollback"]
    assert [(r["step"], r["restored_step"], r["seed"]) for r in rollbacks] == [(6, 4, 42 + 7919)]
    assert int(state.step) == int(jstate.step) == 8
    assert os.path.isdir(tmp_path / "port" / "checkpoints" / "8")
    summary = json.load(open(tmp_path / "port" / "goodput_summary.json"))
    assert summary["rollbacks"] == 1 and summary["steps_replayed"] == 2
    assert summary["buckets_s"]["rollback_replay"] > 0


def test_loop_aborts_when_the_rollback_budget_is_spent(tmp_path):
    cfg = _port_config(6, 2, guard_skip_budget=0, guard_rollback_budget=0,
                       faults="nan_batch@0x50")
    with pytest.raises(GuardAbortError, match="rollback budget"):
        train_and_evaluate(cfg, str(tmp_path / "run"), device="cpu", log=quiet)


def test_loop_aborts_clearly_with_no_checkpoint_to_roll_back_to(tmp_path):
    cfg = _port_config(6, 100, guard_skip_budget=0, faults="nan_batch@0x50")
    with pytest.raises(GuardAbortError, match="no checkpoint"):
        train_and_evaluate(cfg, str(tmp_path / "run"), device="cpu", log=quiet)
    # The crash path leaves both post-mortem files.
    header = json.loads(open(tmp_path / "run" / "flight_record.jsonl").readline())
    assert header["flight_recorder"]["reason"] == "exception:GuardAbortError"
    assert json.load(open(tmp_path / "run" / "goodput_summary.json"))["steps_productive"] >= 0


def test_preempted_and_resumed_run_equals_an_unbroken_run(tmp_path):
    unbroken = train_and_evaluate(_port_config(6, 2), str(tmp_path / "a"), device="cpu",
                                  log=quiet)
    records = []
    preempted = train_and_evaluate(_port_config(6, 2, faults="sigterm@3"), str(tmp_path / "b"),
                                   device="cpu", log=records.append)
    assert int(preempted.step) == 4 and records[-1]["preempted"] is True
    assert records[-1]["checkpoint_step"] == 4
    header = json.loads(open(tmp_path / "b" / "flight_record.jsonl").readline())
    assert header["flight_recorder"]["reason"] == "preempt"
    summary = json.load(open(tmp_path / "b" / "goodput_summary.json"))
    assert summary["preempted"] is True
    resumed = train_and_evaluate(_port_config(6, 2), str(tmp_path / "b"), device="cpu",
                                 log=records.append)
    assert int(resumed.step) == int(unbroken.step) == 6
    a, b = (load_checkpoint(os.path.join(tmp_path, run, "checkpoints"), 6) for run in "ab")
    for key in a["policy"]:
        assert torch.equal(a["policy"][key], b["policy"][key]), key
    for key in ("mu", "nu"):
        assert torch.equal(a["optimizer"][key], b["optimizer"][key]), key


def test_success_writes_goodput_and_no_flight_record(tmp_path):
    train_and_evaluate(_port_config(2, 2), str(tmp_path / "run"), device="cpu", log=quiet)
    summary = json.load(open(tmp_path / "run" / "goodput_summary.json"))
    assert sum(summary["fractions"].values()) == pytest.approx(1.0, abs=1e-9)
    assert summary["steps_productive"] == 1  # step 0 went to compile
    assert not os.path.exists(tmp_path / "run" / "flight_record.jsonl")


def test_crash_on_a_failed_save_writes_both_files(tmp_path):
    cfg = _port_config(4, 2, io_retry=False, faults="ckpt_save@1")
    with pytest.raises(OSError, match="injected fault"):
        train_and_evaluate(cfg, str(tmp_path / "run"), device="cpu", log=quiet)
    header = json.loads(open(tmp_path / "run" / "flight_record.jsonl").readline())
    assert header["flight_recorder"]["reason"] == "exception:OSError"
    assert header["flight_recorder"]["records"] == 2
    assert json.load(open(tmp_path / "run" / "goodput_summary.json"))["buckets_s"]["ckpt_save"] > 0


def test_cli_exits_zero_with_a_checkpoint_after_sigterm(tmp_path):
    workdir = str(tmp_path / "cli")
    env = dict(os.environ, RT1_FAULTS="sigterm@2",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "rt1_tpu_torch.train", "--config", "tiny", "--workdir", workdir,
         "--device", "cpu", "--set", "num_steps=50", "--set", "checkpoint_every_steps=10"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    done = json.loads(proc.stdout.splitlines()[-1])
    assert done == {"status": "done", "step": 3, "updates": 3, "guard_skips": 0,
                    "checkpoint_step": 3, "preempted": True}
    assert sorted(os.listdir(os.path.join(workdir, "checkpoints"))) == ["3"]
