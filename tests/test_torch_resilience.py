"""The port's resilience package against the JAX package's.

Stdlib counterparts fed the same inputs give the same outputs:
* `StepGuard`: verdict sequences and counters over seeded scalar streams
  (NaNs, grad-norm trips, loss spikes, rollbacks) under several options.
* `retry_call`: the sleep schedule (injected sleep, clock and jitter rng),
  counters and exhaustion, the deadline, and non-transient errors.
* `PreemptionCoordinator`: the flag, callbacks, a second signal chained to
  the previous handler, uninstall, and the off-main-thread no-op.
* `ResilienceOptions` resolved from `language_table`, `tiny` and the
  learning proof's config, and their guard and retry options.
* `poison_batch`: NaN in the same places as JAX's on the same batch, also
  for torch tensors.
* The checkpoint manager: an injected transient error on a save and on a
  restore is retried (`retry/*` counters, `on_io` seconds), fault ordinals
  count logical operations, not attempts, and `restore_or_initialize`
  falls back past a corrupt newest step and raises when all are corrupt.
"""

import dataclasses
import os
import random
import signal
import threading

import numpy as np
import pytest
import torch

from rt1_tpu import resilience as jres
from rt1_tpu.resilience import faults as jfaults
from rt1_tpu.resilience import retry as jretry
from rt1_tpu.train.configs import language_table as jax_language_table
from rt1_tpu.train.configs import tiny as jax_tiny
from rt1_tpu.train.proof_config import proof_train_config as jax_proof_config
from rt1_tpu_torch import resilience as pres
from rt1_tpu_torch.configs import get_config
from rt1_tpu_torch.resilience import faults as pfaults
from rt1_tpu_torch.resilience import retry as pretry
from rt1_tpu_torch.train.proof_config import proof_train_config
from rt1_tpu_torch.trainer.checkpoints import CheckpointManager, checkpoint_path
from rt1_tpu_torch.trainer.optim import Adam
from rt1_tpu_torch.trainer.state import create_train_state
from rt1_tpu_torch.train.train import build_model

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _clean_process_state():
    for mod in (jfaults, pfaults):
        mod.clear()
    for mod in (jretry, pretry):
        mod.reset_counters()
    yield
    for mod in (jfaults, pfaults):
        mod.clear()
    for mod in (jretry, pretry):
        mod.reset_counters()


# ------------------------------------------------------------------- guard


def _stream(seed, n=60):
    """Log-step scalars: healthy losses around 1 with NaN stretches,
    grad-norm spikes and loss spikes at seeded places."""
    rng = np.random.default_rng(seed)
    out = []
    skips = 0
    for _ in range(n):
        loss = float(1.0 + 0.05 * rng.standard_normal())
        grad = float(abs(0.5 + 0.1 * rng.standard_normal()))
        u = rng.random()
        if u < 0.12:
            loss = float("nan")
            skips += 1
        elif u < 0.2:
            grad = float(20 * (1 + rng.random()))
        elif u < 0.28:
            loss = float(10 * (1 + rng.random()))
        elif u < 0.3:
            grad = float("inf")
        out.append({"loss": loss, "grad_norm": grad, "guard_skips_cum": float(skips)})
    return out


GUARD_OPTIONS = [
    dict(enabled=True),
    dict(enabled=True, skip_budget=1, rollback_budget=3),
    dict(enabled=True, grad_norm_max=5.0, skip_budget=2),
    dict(enabled=True, loss_spike_factor=3.0, warmup_checks=2, spike_ema_beta=0.8),
    dict(enabled=True, grad_norm_max=5.0, loss_spike_factor=2.0, skip_budget=0,
         rollback_budget=10),
    dict(enabled=False),
]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("options", GUARD_OPTIONS,
                         ids=lambda o: ",".join(f"{k}={v}" for k, v in o.items()))
def test_step_guard_verdicts_and_counters_equal_jax(seed, options):
    jg = jres.StepGuard(jres.GuardOptions(**options))
    pg = pres.StepGuard(pres.GuardOptions(**options))
    for step, scalars in enumerate(_stream(seed), start=1):
        jv, pv = jg.observe(step, dict(scalars)), pg.observe(step, dict(scalars))
        assert jv.value == pv.value, step
        if jv is jres.GuardVerdict.ROLLBACK:
            jg.notify_rollback(step - 2)
            pg.notify_rollback(step - 2)
        assert jg.counters() == pg.counters()
        assert (jg.last_reason, jg.last_good_step, jg.rollbacks) == \
            (pg.last_reason, pg.last_good_step, pg.rollbacks)
    assert issubclass(pres.GuardAbortError, RuntimeError)


# ------------------------------------------------------------------- retry


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += s


def _retry_run(mod, options, failures, seed, exc=OSError):
    clock = _Clock()
    sleeps = []
    calls = []

    def fn():
        calls.append(clock.t)
        if len(calls) <= failures:
            raise exc(f"attempt {len(calls)}")
        return "ok"

    def sleep(s):
        sleeps.append(s)
        clock.sleep(s)

    try:
        result = mod.retry_call(fn, options=options, name="io", sleep=sleep, clock=clock,
                                rng=random.Random(seed))
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        result = f"{type(e).__name__}: {e}"
    return result, sleeps, calls, mod.counters()


RETRY_CASES = [
    (dict(attempts=5, backoff_s=0.1, jitter=0.0, max_backoff_s=0.25), 3),
    (dict(attempts=3, backoff_s=0.5, jitter=0.25), 5),
    (dict(attempts=6, backoff_s=1.0, jitter=0.5, deadline_s=4.0), 10),
    (dict(attempts=4, backoff_s=0.5, multiplier=3.0, deadline_s=None), 2),
    (dict(attempts=1), 1),
]


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("case", RETRY_CASES, ids=[str(i) for i in range(len(RETRY_CASES))])
def test_retry_schedule_counters_and_exhaustion_equal_jax(case, seed):
    kwargs, failures = case
    j = _retry_run(jretry, jretry.RetryOptions(**kwargs), failures, seed)
    p = _retry_run(pretry, pretry.RetryOptions(**kwargs), failures, seed)
    assert j == p
    assert dataclasses.asdict(jretry.RetryOptions(**kwargs)) == \
        dataclasses.asdict(pretry.RetryOptions(**kwargs))


def test_retry_passes_non_transient_errors_and_bad_attempts_like_jax():
    for mod in (jretry, pretry):
        assert _retry_run(mod, mod.RetryOptions(attempts=5), 3, 0, exc=ValueError)[1:3] == \
            ([], [100.0])
        with pytest.raises(ValueError, match="attempts"):
            mod.retry_call(lambda: None, options=mod.RetryOptions(attempts=0))
    assert jretry.counters() == pretry.counters() == {}


def test_retriable_decorator_equals_jax():
    out = []
    for mod in (jretry, pretry):
        calls = []

        @mod.retriable(mod.RetryOptions(attempts=3, backoff_s=0.0, jitter=0.0), name="deco")
        def flaky(x):
            """doc"""
            calls.append(x)
            if len(calls) < 2:
                raise OSError("once")
            return x * 2

        out.append((flaky(21), flaky.__name__, flaky.__doc__, mod.counters()))
    assert out[0] == out[1] == (42, "flaky", "doc", {"retry/deco_retries_total": 1.0})


# ------------------------------------------------------------- preemption


def _coordinator_story(mod):
    """Install over a recording handler, signal twice, uninstall: the flag,
    callbacks, counters, and which handler saw which signal."""
    seen = []
    prev = signal.signal(signal.SIGUSR1, lambda s, f: seen.append(("previous", s)))
    try:
        c = mod.PreemptionCoordinator(callbacks=[lambda: seen.append("dump"),
                                                 lambda: 1 / 0],
                                      signals=(signal.SIGUSR1,))
        before = (c.triggered, c.signum, c.counters())
        assert c.install() and c.install()
        os.kill(os.getpid(), signal.SIGUSR1)
        first = (c.triggered, c.signum, c.counters(), list(seen), c.wait(0))
        # A second signal restores the previous handler and re-delivers.
        os.kill(os.getpid(), signal.SIGUSR1)
        second = list(seen)
        restored = signal.getsignal(signal.SIGUSR1) is not c._handler
        c.uninstall()
        return before, first, second, restored, c.triggered_at is not None
    finally:
        signal.signal(signal.SIGUSR1, prev)


def test_preemption_coordinator_flag_callbacks_chaining_equal_jax():
    assert _coordinator_story(jres) == _coordinator_story(pres)


def test_preemption_coordinator_uninstall_and_thread_rule_equal_jax():
    out = []
    for mod in (jres, pres):
        original = signal.getsignal(signal.SIGUSR2)
        c = mod.PreemptionCoordinator(signals=(signal.SIGUSR2,))
        c.install()
        c.uninstall()
        restored = signal.getsignal(signal.SIGUSR2) == original
        result = {}
        t = threading.Thread(target=lambda: result.setdefault(
            "off_main", mod.PreemptionCoordinator(signals=(signal.SIGUSR2,)).install()))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        out.append((restored, result["off_main"]))
    assert out[0] == out[1] == (True, False)


# ---------------------------------------------------------------- options


def _configs():
    return {
        "language_table": (jax_language_table.get_config(), get_config("language_table")),
        "tiny": (jax_tiny.get_config(), get_config("tiny")),
        "proof": (jax_proof_config("/data", 2000), proof_train_config("/data", 2000)),
    }


@pytest.mark.parametrize("name", ["language_table", "tiny", "proof"])
def test_resilience_options_equal_jax(name):
    jcfg, pcfg = _configs()[name]
    j = jres.ResilienceOptions.from_config(jcfg)
    p = pres.ResilienceOptions.from_config(pcfg)
    assert dataclasses.asdict(j) == dataclasses.asdict(p)
    assert dataclasses.asdict(j.guard_options()) == dataclasses.asdict(p.guard_options())
    assert dataclasses.asdict(j.retry_options()) == dataclasses.asdict(p.retry_options())
    # Every field of the JAX config's block is a field of the port's.
    assert sorted(jcfg.resilience.to_dict()) == sorted(vars(pcfg.resilience))
    assert dataclasses.asdict(jres.ResilienceOptions.from_config(None)) == \
        dataclasses.asdict(pres.ResilienceOptions.from_config(None))


# ---------------------------------------------------------------- injectors


def test_poison_batch_marks_the_places_jax_marks():
    rng = np.random.default_rng(3)
    batch = {"observations": {"image": rng.integers(0, 255, (2, 3, 4, 5, 3), dtype=np.uint8),
                              "natural_language_embedding": rng.standard_normal((2, 3, 8)),
                              "task_id": np.arange(2, dtype=np.int32)},
             "actions": {"terminate_episode": rng.integers(0, 2, (2, 3), dtype=np.int32),
                         "action": rng.uniform(-1, 1, (2, 3, 2)).astype(np.float32)}}
    ref = jfaults.poison_batch(batch)
    out = pfaults.poison_batch(batch)
    as_torch = pfaults.poison_batch(
        ({k: torch.from_numpy(v) for k, v in batch["observations"].items()},
         {k: torch.from_numpy(v) for k, v in batch["actions"].items()}))
    for group, index in (("observations", 0), ("actions", 1)):
        for key, value in ref[group].items():
            np.testing.assert_array_equal(np.isnan(out[group][key].astype(np.float64)),
                                          np.isnan(np.asarray(value, np.float64)))
            np.testing.assert_array_equal(out[group][key], value)
            tensor = as_torch[index][key]
            assert tensor.dtype == torch.from_numpy(np.asarray(batch[group][key])).dtype
            np.testing.assert_array_equal(tensor.numpy(), value)
    # The input is left as it was.
    assert not np.isnan(batch["actions"]["action"]).any()


def test_fault_plans_fire_alike_including_maybe_signal():
    spec = "nan_batch@3x2,ckpt_save@1,sigterm@2"
    jplan, pplan = jfaults.FaultPlan.parse(spec), pfaults.FaultPlan.parse(spec)
    for i in range(6):
        assert jplan.should_fire("nan_batch", index=i) == pplan.should_fire("nan_batch", index=i)
    assert jplan.fired_counts() == pplan.fired_counts()
    pfaults.install(pplan)
    prev = signal.signal(signal.SIGTERM, signal.SIG_IGN)
    try:
        assert not pfaults.maybe_signal("sigterm", index=1)
        assert pfaults.maybe_signal("sigterm", index=2)
        assert not pfaults.maybe_signal("sigterm", index=2)
    finally:
        signal.signal(signal.SIGTERM, prev)
    assert pplan.counters()["faults/sigterm_fired"] == 1.0


# -------------------------------------------------------------- checkpoints


def _state(seed=0):
    cfg = get_config("tiny")
    return create_train_state(build_model(cfg, "cpu"), Adam())


NO_SLEEP = dict(backoff_s=0.0, jitter=0.0)


def test_checkpoint_save_and_restore_retry_an_injected_transient_error(tmp_path):
    io = []
    mgr = CheckpointManager(str(tmp_path / "ckpt"), retry=pretry.RetryOptions(**NO_SLEEP),
                            on_io=lambda name, s: io.append(name))
    state = _state()
    pfaults.install(pfaults.FaultPlan.parse("ckpt_save@1,ckpt_restore@1"))
    mgr.save(2, state)
    assert mgr.latest_step() == 2 and not os.path.exists(checkpoint_path(mgr.directory, 2) + ".tmp")
    assert mgr.restore(state) == 2
    assert pretry.counters() == {"retry/ckpt_save_retries_total": 1.0,
                                 "retry/ckpt_restore_retries_total": 1.0}
    assert io == ["ckpt_save", "ckpt_restore"]


def test_checkpoint_fault_ordinals_count_operations_not_attempts(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"),
                            retry=pretry.RetryOptions(attempts=3, **NO_SLEEP))
    state = _state()
    # The 2nd save fails twice (x2) and succeeds on its third attempt; the
    # 3rd save is untouched.
    pfaults.install(pfaults.FaultPlan.parse("ckpt_save@2x2"))
    for step in (1, 2, 3):
        mgr.save(step, state)
    assert mgr.all_steps() == [1, 2, 3]
    assert pretry.counters() == {"retry/ckpt_save_retries_total": 2.0}
    # Without retry, the injected error ends the save and leaves no step.
    bare = CheckpointManager(str(tmp_path / "bare"))
    pfaults.install(pfaults.FaultPlan.parse("ckpt_save@1"))
    with pytest.raises(OSError, match="injected fault"):
        bare.save(5, state)
    assert bare.latest_step() is None


def test_restore_or_initialize_falls_back_past_a_corrupt_newest_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    state = _state()
    mgr.save(2, state)
    before = state.flat.clone()
    with torch.no_grad():
        state.flat.add_(1.0)
    mgr.save(4, state)
    with open(checkpoint_path(mgr.directory, 4), "wb") as f:
        f.write(b"truncated")
    fresh = _state()
    _, step = mgr.restore_or_initialize(fresh)
    assert step == 2
    assert torch.equal(fresh.flat, before)
    with open(checkpoint_path(mgr.directory, 2), "wb") as f:
        f.write(b"also truncated")
    with pytest.raises(Exception):
        mgr.restore_or_initialize(_state())
