"""The train loop's step marks and the train-step profiler against the JAX
package's (`rt1_tpu/trainer/metrics.py::step_trace`,
`scripts/profile_train.py`), on the CPU.

* Step marks: `tiny`'s loop (3 steps, float32, dropout and the crop on)
  logs bit-identical losses with the marks in and with them replaced by a
  null context; under `torch.profiler` the loop shows one
  `train#step_num=<i>#` mark a step.
* `python -m rt1_tpu_torch.train.profile_train --model tiny --device cpu
  --steps 2 --warmup 1` (plain and `--packed`): 2 step marks in the Chrome
  trace, a JSON summary with 2 step walls, and `host_trace.json` with the
  same (phase, name) set of events as the JAX script's own host trace for
  the same arguments (its `jax.profiler` trace is not compared: the two
  profilers' formats differ). The CPU trace has no device activity, so
  the summary carries no device numbers.
* `obs/profile.py`'s busy time is the union of overlapping intervals, and
  a step mark's span on the device timeline counts neither as busy time
  nor as a launch.
"""

import contextlib
import json
import os
import subprocess
import sys
import types

import pytest
import torch

from rt1_tpu_torch.configs import get_config
from rt1_tpu_torch.obs import profile as obs_profile
from rt1_tpu_torch.train import profile_train
from rt1_tpu_torch.train import train as train_module
from rt1_tpu_torch.train.train import train_and_evaluate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--model", "tiny", "--steps", "2", "--warmup", "1", "--batch", "2"]

torch.set_num_threads(2)


def _losses(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [(r["step"], r["loss"]) for r in map(json.loads, f) if "loss" in r]


def _tiny_config():
    config = get_config("tiny")
    config.num_steps = 3
    config.log_every_steps = 1
    config.eval_every_steps = 0
    config.per_host_batch_size = 2
    return config


def test_step_marks_leave_tiny_losses_bit_identical(tmp_path, monkeypatch):
    marked = str(tmp_path / "marked")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        train_and_evaluate(_tiny_config(), marked, device="cpu", log=lambda _: None)
    marks = sorted(e.name for e in prof.events() if e.name.startswith("train#step_num="))
    assert marks == [f"train#step_num={i}#" for i in range(3)]
    monkeypatch.setattr(train_module, "step_trace", lambda *_: contextlib.nullcontext())
    plain = str(tmp_path / "plain")
    train_and_evaluate(_tiny_config(), plain, device="cpu", log=lambda _: None)
    got, want = _losses(marked), _losses(plain)
    assert len(got) == 3 and got == want


def _jax_host_trace(logdir, extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)  # one CPU device, not the tests' 8: batch 2 is unsharded
    return subprocess.Popen(
        [sys.executable, os.path.join(REPO, "scripts", "profile_train.py"), *ARGS,
         "--logdir", logdir, *extra], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _event_names(path):
    with open(path) as f:
        return sorted({(e["ph"], e["name"]) for e in json.load(f)["traceEvents"]})


@pytest.mark.parametrize("packed", [False, True], ids=["resident", "packed"])
def test_profile_train_matches_jax_host_trace(tmp_path, capsys, packed):
    extra = ["--packed", "--data_dir", str(tmp_path / "episodes"), "--episodes", "4"] \
        if packed else []
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    # The JAX script writes its corpus first; the port's run reuses it.
    jax_proc = _jax_host_trace(jax_dir, extra)
    out, _ = jax_proc.communicate(timeout=600)
    assert jax_proc.returncode == 0, out[-3000:]
    assert profile_train.main([*ARGS, "--logdir", port_dir, "--device", "cpu", *extra]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["step_marks"] == 2 and len(summary["step_wall_ms"]) == 2
    assert summary["packed"] == packed and "device_busy_ms_per_step" not in summary
    marks = profile_train.step_marks(os.path.join(port_dir, profile_train.TRACE_NAME))
    assert [m["name"] for m in marks] == ["train#step_num=0#", "train#step_num=1#"]
    got = _event_names(os.path.join(port_dir, profile_train.HOST_TRACE_NAME))
    want = _event_names(os.path.join(jax_dir, "host_trace.json"))
    assert got == want
    names = {name for _, name in got}
    assert ({"device_step", "wait_batch", "feeder_assemble", "feeder_queue_depth"} <= names) \
        == packed


def test_profile_train_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile_train.main([*ARGS, "--logdir", str(tmp_path)])


def test_busy_time_is_the_union_of_intervals():
    spans = [(0.0, 10.0, "a"), (5.0, 12.0, "b"), (20.0, 25.0, "c"), (21.0, 22.0, "d")]
    assert obs_profile.busy_us(spans) == 17.0
    # A step mark's span on the device timeline is an annotation, not work.
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def event(name, start, end, device, mark=False):
        return types.SimpleNamespace(name=name, device_type=device, is_user_annotation=mark,
                                     time_range=types.SimpleNamespace(start=start, end=end))

    prof = types.SimpleNamespace(events=lambda: [
        event("train#step_num=0#", 0.0, 100.0, cuda, mark=True), event("k1", 10.0, 20.0, cuda),
        event("k2", 15.0, 30.0, cuda), event("aten::add", 0.0, 5.0, cpu)])
    summary = obs_profile.device_summary(prof, calls=1, wall_s=1e-3)
    assert summary["busy_ms"] == 0.02 and summary["launches"] == 2
    assert sorted(summary["kernels"]) == ["k1", "k2"]
    assert obs_profile.busy_us([]) == 0.0
    assert obs_profile.top_kernels({"a": 1.0, "b": 3.0, "c": 2.0}, n=2) == [["b", 3.0],
                                                                           ["c", 2.0]]
