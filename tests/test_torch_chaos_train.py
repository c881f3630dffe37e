"""The port's chaos drill (`python -m rt1_tpu_torch.resilience.chaos_train`)
end to end at `tiny` on the CPU: a packed synthetic corpus; a fault-free
reference; phase A through one NaN batch, one transient checkpoint-save
IOError and a self-SIGTERM (exit 0, the checkpoint at the SIGTERM step +
1, the flight recorder's `preempt` dump with the guard's skip and the
retry counter, the `resilience: ckpt_save attempt` warning through stdlib
logging, goodput badput in `preempt_drain` and checkpoint I/O with
fractions summing to 1); phase B's relaunch reaching the reference's final
step. Every assertion of JAX's `scripts/chaos_train.py` runs inside
`main`; the schedule is the JAX drill's draw for the same seed.
"""

import importlib.util
import os

from rt1_tpu_torch.resilience import chaos_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_drill():
    path = os.path.join(REPO, "scripts", "chaos_train.py")
    spec = importlib.util.spec_from_file_location("chaos_train", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_schedule_draw_matches_jax():
    jax_drill = _jax_drill()
    for seed in range(6):
        for steps in (10, 12, 17):
            assert chaos_train._draw_schedule(seed, steps) == jax_drill._draw_schedule(seed, steps)


def test_chaos_drill_end_to_end(tmp_path):
    summary = chaos_train.main(["--workdir", str(tmp_path / "chaos"), "--seed", "1",
                                "--device", "cpu"])
    assert summary["ok"] and summary["packed"]
    assert summary["faults"] == chaos_train._draw_schedule(1, 12)[0]
    assert summary["final_step"] == summary["reference_final_step"] == 12
    assert summary["guard_device_skips"] >= 1
    assert summary["ckpt_save_retries"] >= 1
    assert summary["preempt_badput_s"] > 0 and summary["ckpt_badput_s"] > 0
