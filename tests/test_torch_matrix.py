"""The port's eval matrix (`rt1_tpu_torch/eval/matrix.py`, the CLI
`python -m rt1_tpu_torch.eval.matrix_main`) against the JAX package's.

Tolerance: exact. `EvalMatrixState.render_prometheus` is byte-equal to
JAX's on the same cells (the sweep-uptime gauge reads the wall clock and
is compared by name only), `matrix_record` equal; `run_matrix` with the
seeded oracle and random baselines on the `tiny` geometry gives JAX's
success counts and mean episode lengths (the two packages' environments
are bitwise the same, `tests/test_torch_envs.py`). `policy_for_checkpoint`
restores the step it is asked for, so two steps give two policies; the
LAVA family raises, naming ROADMAP A12.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import rt1_tpu.eval.evaluate as jax_evaluate
import rt1_tpu.eval.matrix as jax_matrix
import rt1_tpu_torch.eval.evaluate as port_evaluate
import rt1_tpu_torch.eval.matrix as port_matrix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_ENV = dict(target_height=32, target_width=56, random_crop_factor=0.95, sequence_length=3)


def _fill(state):
    """One seeded sweep's worth of cells, partial cells included."""
    rng = np.random.default_rng(5)
    for ckpt in ("2", "4", "oracle"):
        for task in ("block2block", "block1_to_corner", "unknown:x:y"):
            state.note_cell_start(task, ckpt)
            for _ in range(int(rng.integers(1, 3))):
                n = int(rng.integers(1, 4))
                state.note_cell(task, ckpt, int(rng.integers(0, n + 1)), n,
                                float(rng.uniform(5, 80)))
    state.note_cell_start("separate", "6")  # running now: 0 episodes


def _scrub_uptime(text):
    return "\n".join(line for line in text.splitlines()
                     if not line.startswith("rt1_eval_sweep_uptime_seconds "))


def test_matrix_state_gauges_and_record_equal_jax():
    port, ref = port_matrix.EvalMatrixState(), jax_matrix.EvalMatrixState()
    _fill(port)
    _fill(ref)
    assert port.matrix() == ref.matrix()
    assert port.checkpoints() == ref.checkpoints()
    assert _scrub_uptime(port.render_prometheus()) == _scrub_uptime(ref.render_prometheus())
    assert "rt1_eval_sweep_uptime_seconds" in port.render_prometheus()
    kwargs = dict(episodes_per_cell=3, max_episode_steps=80, seed=0, embedder="hash",
                  backend="kinematic", block_mode="BLOCK_8", wall_seconds=12.34,
                  workdir="/w", extra={"oracle_fill": {"episodes_appended": 2}})
    assert port_matrix.matrix_record(port, **kwargs) == jax_matrix.matrix_record(ref, **kwargs)
    assert port_matrix.BENCH_BASENAME == jax_matrix.BENCH_BASENAME
    assert port_matrix.default_task_names() == jax_matrix.default_task_names()


def test_write_record_bytes_equal_jax(tmp_path):
    state = port_matrix.EvalMatrixState()
    _fill(state)
    record = port_matrix.matrix_record(
        state, episodes_per_cell=1, max_episode_steps=10, seed=0, embedder="hash",
        backend="kinematic", block_mode="BLOCK_8", wall_seconds=1.0)
    a, b = str(tmp_path / "a" / "r.json"), str(tmp_path / "b" / "r.json")
    assert port_matrix.write_record(record, a, "") == [a]
    jax_matrix.write_record(record, b)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("baseline", ["oracle", "random"])
def test_run_matrix_baselines_equal_jax(baseline):
    """Two tasks x 2 episodes of each baseline through both packages'
    `run_matrix`: the same success counts and mean lengths, cell by cell."""
    tasks = ("block2block", "block1_to_corner")
    results = []
    for matrix, evaluate in ((port_matrix, port_evaluate), (jax_matrix, jax_evaluate)):
        policy = (evaluate.OracleEvalPolicy(seed=3) if baseline == "oracle"
                  else evaluate.RandomEvalPolicy(seed=3))
        progress = []
        state = matrix.run_matrix(
            [(baseline, policy)], tasks, episodes_per_cell=2, max_episode_steps=12,
            block_mode="BLOCK_4", seed=1, env_kwargs=TINY_ENV,
            progress=lambda t, label, cell: progress.append((t, label, cell)))
        results.append((state.matrix(), progress))
    assert results[0] == results[1]
    assert sum(c["episodes"] for row in results[0][0].values() for c in row.values()) == 4


@pytest.fixture(scope="module")
def tiny_workdir(tmp_path_factory):
    """The port trainer's `tiny` run: checkpoints at steps 2 and 4."""
    wd = str(tmp_path_factory.mktemp("tiny_train"))
    subprocess.run([sys.executable, "-m", "rt1_tpu_torch.train", "--config", "tiny",
                    "--workdir", wd, "--device", "cpu", "--set", "eval_every_steps=0"],
                   cwd=REPO, check=True, capture_output=True, timeout=300)
    return wd


def test_policy_for_checkpoint_restores_the_step_asked(tiny_workdir):
    from rt1_tpu_torch.configs import get_config

    config = get_config("tiny")
    assert port_matrix.checkpoint_steps(tiny_workdir) == [2, 4]
    assert port_matrix.checkpoint_steps(tiny_workdir, "latest:1") == [4]
    with pytest.raises(ValueError, match="not found"):
        port_matrix.checkpoint_steps(tiny_workdir, "3")
    restored = {}
    for step in (2, 4):
        policy, got, history_keys = port_matrix.policy_for_checkpoint(
            config, tiny_workdir, step, device="cpu")
        assert got == step and history_keys is None
        restored[step] = {k: v.clone() for k, v in policy.engine.policy.state_dict().items()}
    newest, got, _ = port_matrix.policy_for_checkpoint(config, tiny_workdir, None, device="cpu")
    assert got == 4
    differ = [k for k in restored[2]
              if restored[2][k].is_floating_point()
              and not torch.equal(restored[2][k], restored[4][k])]
    assert differ, "steps 2 and 4 restored the same weights"
    for k, v in newest.engine.policy.state_dict().items():
        assert torch.equal(v, restored[4][k]), k


def test_run_gate_compares_the_two_steps(tiny_workdir):
    """The gate's two columns are the two steps it names, swept on the CPU."""
    from rt1_tpu_torch.configs import get_config

    verdict = port_matrix.run_gate(
        get_config("tiny"), tiny_workdir, 4, 2, tasks=("block2block",), episodes_per_cell=1,
        max_episode_steps=3, env_kwargs=TINY_ENV, device="cpu")
    assert (verdict["candidate_step"], verdict["incumbent_step"]) == (4, 2)
    assert set(verdict["matrix"]["block2block"]) == {"2", "4"}
    assert verdict["passed"] == (verdict["candidate_mean_success"]
                                 >= verdict["incumbent_mean_success"])
    assert set(verdict) == {"gate", "candidate_step", "incumbent_step", "tasks",
                            "episodes_per_cell", "candidate_mean_success",
                            "incumbent_mean_success", "margin", "passed", "matrix",
                            "wall_seconds"}


def test_matrix_cli_on_the_cpu(tiny_workdir, tmp_path):
    out = str(tmp_path / "BENCH_eval_matrix.json")
    proc = subprocess.run(
        [sys.executable, "-m", "rt1_tpu_torch.eval.matrix_main", "--config", "tiny",
         "--workdir", tiny_workdir, "--device", "cpu", "--tasks", "block2block",
         "--episodes", "1", "--max_steps", "3", "--checkpoints", "latest:1",
         "--baselines", "random", "--out", out],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    record = json.loads(proc.stdout.strip().splitlines()[-1])
    assert record["bench"] == "eval_matrix" and record["checkpoints"] == ["4", "random"]
    with open(out) as f:
        assert json.load(f) == record
    assert os.path.exists(os.path.join(tiny_workdir, port_matrix.BENCH_BASENAME))


def test_lava_family_raises_naming_a12(tiny_workdir):
    """ROADMAP A12 (the LAVA family) is ported: a LAVA config no longer
    raises for want of a port, only for a checkpoint that is not LAVA's
    (here RT-1's); `tests/test_torch_lava.py` runs a LAVA cell."""
    from rt1_tpu_torch.configs import get_config

    config = get_config("tiny")
    config.model.family = "lava"
    with pytest.raises(RuntimeError, match="state_dict"):
        port_matrix.policy_for_checkpoint(config, tiny_workdir, 2, device="cpu")
