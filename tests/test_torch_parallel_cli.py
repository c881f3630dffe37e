"""The train CLI under `python -m torch.distributed.run` on the CPU (gloo).

Two ranks train `tiny` for 2 steps under fsdp=2 (dropout and the crop on)
and save a sharded checkpoint; the same global batch (16 rows) in one
process gives the same losses, within rtol 1e-5; the world of one then
resumes the sharded step and trains on to step 4. Rank 0 alone logs and
writes `metrics.jsonl` (one record a step), and the start line reports the
world, the grid and the global batch. The same under tp=2 (dropout and the
crop on: the same losses as one process on the same 8 rows) and pp=2 (2
microbatches a step, dropout 0: the same losses too), each resumed by the
world of one. A SIGTERM that reaches rank 1 alone stops both ranks at the
same step, with one preemption save.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import torch_parallel_worker as worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "MASTER_ADDR", "MASTER_PORT", "RANK",
                        "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _train(workdir, *overrides, nproc=None):
    cmd = [sys.executable]
    if nproc is not None:
        cmd += ["-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(nproc)]
    cmd += ["-m", "rt1_tpu_torch.train", "--config", "tiny", "--workdir", str(workdir),
            "--device", "cpu"]
    for o in overrides:
        cmd += ["--set", o]
    proc = subprocess.run(cmd, cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]


def _metrics(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_two_rank_cli_trains_saves_and_resumes_at_world_one(tmp_path):
    sharded, single = tmp_path / "sharded", tmp_path / "single"
    lines = _train(sharded, "num_steps=2", "parallel.distributed.enabled=true",
                   "parallel.fsdp=2", nproc=2)
    starts = [r for r in lines if r.get("status") == "start"]
    assert len(starts) == 1   # rank 0 logs for the run
    assert starts[0]["world"] == 2 and starts[0]["mesh"]["fsdp"] == 2
    assert starts[0]["global_batch"] == 16
    assert lines[-1]["status"] == "done" and lines[-1]["checkpoint_step"] == 2
    records = _metrics(sharded)
    assert [r["step"] for r in records] == [1, 2, 2]   # two train records, one eval, once each
    manifest = json.load(open(sharded / "checkpoints" / "2" / "manifest.json"))
    assert manifest["world"] == 2 and len(manifest["shards"]) == 2
    assert os.path.isfile(sharded / "goodput_summary.json")

    _train(single, "num_steps=2", "per_host_batch_size=16")
    for got, ref in zip(records, _metrics(single)):
        for key in ("loss", "grad_norm", "action_loss_mean", "eval_loss"):
            if key in ref:
                np.testing.assert_allclose(got[key], ref[key], rtol=1e-5, err_msg=key)

    resumed = _train(sharded, "num_steps=4")
    assert resumed[0]["status"] == "start" and resumed[0]["restored_step"] == 2
    assert resumed[0]["world"] == 1
    assert resumed[-1]["status"] == "done" and resumed[-1]["step"] == 4
    assert resumed[-1]["updates"] == 4


@pytest.mark.parametrize("plan", [["parallel.tp=2"],
                                  ["parallel.pp=2", "model.pipeline_microbatches=2",
                                   "model.dropout_rate=0"]])
def test_two_rank_cli_under_tp_and_pp_trains_saves_and_resumes_at_world_one(tmp_path, plan):
    parted, single = tmp_path / "parted", tmp_path / "single"
    lines = _train(parted, "num_steps=2", "parallel.distributed.enabled=true", *plan, nproc=2)
    start = next(r for r in lines if r.get("status") == "start")
    axis = "model" if "parallel.tp=2" in plan else "stage"
    assert start["world"] == 2 and start["mesh"][axis] == 2 and start["global_batch"] == 8
    assert lines[-1]["status"] == "done" and lines[-1]["checkpoint_step"] == 2
    manifest = json.load(open(parted / "checkpoints" / "2" / "manifest.json"))
    assert len(manifest["parts"]) == 2
    _train(single, "num_steps=2", *plan[1:])
    for got, ref in zip(_metrics(parted), _metrics(single)):
        for key in ("loss", "grad_norm", "action_loss_mean", "eval_loss"):
            if key in ref:
                np.testing.assert_allclose(got[key], ref[key], rtol=1e-5, err_msg=key)
    resumed = _train(parted, "num_steps=3", *plan[1:])
    assert resumed[0]["restored_step"] == 2 and resumed[0]["world"] == 1
    assert resumed[-1]["status"] == "done" and resumed[-1]["updates"] == 3


def test_a_signal_on_one_rank_stops_every_rank_at_the_same_step(tmp_path):
    """The flag is shared over a gloo group each step: without it rank 0
    would step on alone and wait in the next step's collectives."""
    workdir = str(tmp_path / "preempt")
    results = worker.spawn(2, "preempt_one_rank", dict(
        signalled=1, at=1, workdir=workdir,
        overrides=["num_steps=6", "checkpoint_every_steps=100", "log_every_steps=1",
                   "eval_every_steps=100", "parallel.dp=2"]), tmp_path, timeout=150)
    assert [r["step"] for r in results] == [2, 2]
    records = results[0]["records"]
    preempted = [r for r in records if r.get("status") == "preempted"]
    assert len(preempted) == 1 and preempted[0]["step"] == 2
    assert records[-1]["status"] == "done" and records[-1]["preempted"]
    assert records[-1]["checkpoint_step"] == 2
    assert results[1]["records"] == []   # rank 0 logs for the run
    assert os.path.isfile(os.path.join(workdir, "checkpoints", "2", "manifest.json"))
