"""The port's autoscaler, admission control and fault plan against the JAX
package's, exactly.

* The JAX package's autoscaler and admission scenarios
  (`tests/test_serve_elastic.py`) run on the port's copies.
* A seeded stream of `FleetSignals` gives the same `ScaleDecision` sequence
  (direction and reason) from both packages' `Autoscaler`s, for several
  policies.
* The same `RT1_FAULTS` plan parses to the same specs and fires at the
  same indices, index-based and count-based, and `maybe_fail` raises the
  same error at the same call.
"""

import numpy as np
import pytest

from rt1_tpu.resilience import faults as jfaults
from rt1_tpu.serve import autoscale as jautoscale
from rt1_tpu.serve.router import AdmissionController as JaxAdmissionController
from rt1_tpu_torch.resilience import faults
from rt1_tpu_torch.serve.autoscale import Autoscaler, AutoscalePolicy, FleetSignals
from rt1_tpu_torch.serve.router import AdmissionController


def _sig(total, ready, active, slots, **kw):
    return FleetSignals(replicas_total=total, replicas_ready=ready, active_sessions=active,
                        session_slots=slots, **kw)


# ------------------------------------------------- the JAX package's scenarios


def test_policy_validation():
    with pytest.raises(ValueError):
        AutoscalePolicy(min_replicas=2, max_replicas=1)
    with pytest.raises(ValueError):
        AutoscalePolicy(min_replicas=1, max_replicas=2, scale_up_occupancy=0.5,
                        scale_down_occupancy=0.5)  # no hysteresis band
    with pytest.raises(ValueError):
        AutoscalePolicy(min_replicas=0, max_replicas=2)


def test_autoscaler_scales_up_only_after_sustained_pressure():
    p = AutoscalePolicy(min_replicas=1, max_replicas=3, up_sustain_ticks=2,
                        down_sustain_ticks=3, up_cooldown_ticks=0, down_cooldown_ticks=0)
    a = Autoscaler(p)
    hot = _sig(1, 1, 4, 2)  # occupancy 2.0
    assert a.decide(hot) is None
    decision = a.decide(hot)
    assert decision is not None and decision.direction == "up"
    assert "occupancy" in decision.reason
    b = Autoscaler(p)  # a one-tick blip never scales
    assert b.decide(hot) is None
    assert b.decide(_sig(1, 1, 1, 2)) is None
    assert b.decide(hot) is None


def test_autoscaler_down_is_slower_and_clamped():
    p = AutoscalePolicy(min_replicas=1, max_replicas=3, up_sustain_ticks=2,
                        down_sustain_ticks=3, up_cooldown_ticks=0, down_cooldown_ticks=0)
    a = Autoscaler(p)
    cold = _sig(2, 2, 0, 4)
    assert a.decide(cold) is None
    assert a.decide(cold) is None
    decision = a.decide(cold)
    assert decision is not None and decision.direction == "down"
    b = Autoscaler(p)
    for _ in range(6):
        assert b.decide(_sig(1, 1, 0, 2)) is None  # at the floor
    c = Autoscaler(p)
    for _ in range(6):
        assert c.decide(_sig(3, 3, 12, 6)) is None  # at the ceiling


def test_autoscaler_one_boot_at_a_time_and_cooldown():
    p = AutoscalePolicy(min_replicas=1, max_replicas=4, up_sustain_ticks=1,
                        down_sustain_ticks=2, up_cooldown_ticks=2, down_cooldown_ticks=0)
    a = Autoscaler(p)
    for _ in range(4):
        assert a.decide(_sig(2, 1, 8, 2, replicas_booting=1)) is None
    stuck = Autoscaler(p)  # a NOTREADY replica with no boot in flight
    assert stuck.decide(_sig(2, 1, 8, 2)).direction == "up"
    hot = _sig(2, 2, 8, 4)
    assert a.decide(hot).direction == "up"
    assert a.decide(hot) is None
    assert a.decide(hot) is None
    assert a.decide(hot).direction == "up"


def test_autoscaler_shed_and_burn_are_pressure():
    p = AutoscalePolicy(min_replicas=1, max_replicas=3, up_sustain_ticks=1,
                        down_sustain_ticks=2, up_cooldown_ticks=0, burn_pressure=2.0)
    decision = Autoscaler(p).decide(_sig(1, 1, 0, 2, shed_delta=3))
    assert decision is not None and "shed" in decision.reason
    decision = Autoscaler(p).decide(_sig(1, 1, 1, 4, rolling_burn=5.0))
    assert decision is not None and "burn" in decision.reason
    decision = Autoscaler(p).decide(_sig(2, 2, 0, 4, rolling_burn=15.0))
    assert decision is not None and decision.direction == "up" and "burn" in decision.reason
    d = Autoscaler(p)
    decayed = _sig(2, 2, 0, 4, rolling_burn=0.0)
    assert d.decide(decayed) is None
    decision = d.decide(decayed)
    assert decision is not None and decision.direction == "down"
    assert _sig(1, 0, 3, 0).occupancy == float("inf")


def test_admission_token_bucket_per_client():
    clock = {"t": 0.0}
    adm = AdmissionController(rate_per_client=1.0, burst=2.0, clock=lambda: clock["t"])
    assert adm.reject_reason("alice", 0) is None
    assert adm.reject_reason("alice", 0) is None
    assert adm.reject_reason("alice", 0) == "client_rate"
    assert adm.reject_reason("bob", 0) is None
    clock["t"] = 1.0
    assert adm.reject_reason("alice", 0) is None
    assert adm.reject_reason("alice", 0) == "client_rate"
    gauges = adm.gauges()
    assert gauges["admission_clients_tracked"] == 2.0
    assert gauges["admission_rate_per_client"] == 1.0 and gauges["admission_burst"] == 2.0


def test_admission_global_overload_threshold_and_bound():
    adm = AdmissionController(max_inflight=2)
    assert adm.reject_reason("c", 2) is None
    assert adm.reject_reason("c", 3) == "overload"
    for _ in range(50):
        assert adm.reject_reason("c", 0) is None
    with pytest.raises(ValueError):
        AdmissionController(rate_per_client=-1.0)
    with pytest.raises(ValueError):
        AdmissionController(rate_per_client=1.0, burst=0.5)
    bounded = AdmissionController(rate_per_client=1.0, burst=1.0, max_clients=4)
    for i in range(10):
        bounded.reject_reason(f"client-{i}", 0)
    assert bounded.gauges()["admission_clients_tracked"] <= 4


# ----------------------------------------------------- seeded cross-checks


POLICIES = [
    dict(min_replicas=1, max_replicas=3),
    dict(min_replicas=1, max_replicas=4, up_sustain_ticks=1, down_sustain_ticks=2,
         up_cooldown_ticks=0, down_cooldown_ticks=1, burn_pressure=0.0),
    dict(min_replicas=2, max_replicas=6, scale_up_occupancy=0.9, scale_down_occupancy=0.1,
         up_sustain_ticks=3, down_sustain_ticks=4, up_cooldown_ticks=1, down_cooldown_ticks=3,
         burn_pressure=1.5),
]


def _signal_stream(seed, n=400):
    """Hot and idle phases of 10-30 ticks, so both directions fire."""
    rng = np.random.default_rng(seed)
    total, hot, left = 2, True, 0
    for _ in range(n):
        if left == 0:
            hot, left = not hot, int(rng.integers(10, 31))
        left -= 1
        total = int(np.clip(total + rng.integers(-1, 2), 1, 7))
        booting = int(rng.random() < 0.1)
        ready = max(total - booting - int(rng.random() < 0.05), 0)
        slots = ready * 2
        active = int(rng.integers(slots, 2 * slots + 3)) if hot else int(rng.random() < 0.1)
        yield dict(replicas_total=total, replicas_ready=ready, active_sessions=active,
                   session_slots=slots, inflight=int(rng.integers(0, 5)) * hot,
                   shed_delta=int(hot and rng.random() < 0.1) * int(rng.integers(1, 4)),
                   rolling_burn=float(rng.choice([0.0, 3.0, 20.0], p=[0.8, 0.1, 0.1]) * hot),
                   replicas_booting=booting)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("policy", range(len(POLICIES)))
def test_seeded_signal_stream_gives_the_same_decisions(policy, seed):
    port = Autoscaler(AutoscalePolicy(**POLICIES[policy]))
    jax = jautoscale.Autoscaler(jautoscale.AutoscalePolicy(**POLICIES[policy]))
    got, want = [], []
    for fields in _signal_stream(seed):
        signals, jsignals = FleetSignals(**fields), jautoscale.FleetSignals(**fields)
        assert signals.occupancy == jsignals.occupancy
        assert signals.inflight_per_slot == jsignals.inflight_per_slot
        d, jd = port.decide(signals), jax.decide(jsignals)
        got.append(None if d is None else (d.direction, d.reason))
        want.append(None if jd is None else (jd.direction, jd.reason))
    assert got == want
    assert {g[0] for g in got if g} == {"up", "down"}  # the stream exercises both


@pytest.mark.parametrize("seed", [0, 1])
def test_admission_decisions_equal_jax(seed):
    rng = np.random.default_rng(seed)
    clock = {"t": 0.0}
    kw = dict(rate_per_client=3.0, burst=2.0, max_inflight=5, max_clients=6,
              clock=lambda: clock["t"])
    port, jax = AdmissionController(**kw), JaxAdmissionController(**kw)
    for _ in range(500):
        clock["t"] += float(rng.exponential(0.05))
        client, inflight = f"c{int(rng.integers(0, 9))}", int(rng.integers(0, 8))
        assert port.reject_reason(client, inflight) == jax.reject_reason(client, inflight)
    assert port.gauges() == jax.gauges()


# -------------------------------------------------------------- fault plan


PLANS = [
    "replica_kill@1,serve_reload@2",
    "replica_hang@3x2,migrate_import@1,session_restore@2x3",
    "migrate_export@2,nan_batch@3x4,ckpt_save@2,sigterm@5,canary_slo_breach@1",
]
SITES = ("replica_kill", "replica_hang", "serve_reload", "migrate_export", "migrate_import",
         "session_restore", "nan_batch", "ckpt_save", "sigterm", "canary_slo_breach")


@pytest.mark.parametrize("text", PLANS)
def test_fault_plan_parses_and_fires_as_jax(text):
    assert faults.KNOWN_SITES == jfaults.KNOWN_SITES and faults.ENV_VAR == jfaults.ENV_VAR
    port, jax = faults.FaultPlan.parse(text), jfaults.FaultPlan.parse(text)
    assert len(port) == len(jax)
    assert list(port.fired_counts()) == list(jax.fired_counts())
    rng = np.random.default_rng(len(text))
    fired, jfired = [], []
    for step in range(60):
        site = SITES[int(rng.integers(0, len(SITES)))]
        index = None if rng.random() < 0.5 else int(rng.integers(0, 8))
        fired.append(port.should_fire(site, index=index))
        jfired.append(jax.should_fire(site, index=index))
    assert fired == jfired and any(fired)
    assert port.fired_counts() == jax.fired_counts()
    assert port.counters() == jax.counters()


@pytest.mark.parametrize("text", ["nosuch@1", "replica_kill", "replica_kill@x", "a@1,,b"])
def test_bad_plans_are_refused_by_both(text):
    with pytest.raises(ValueError) as err:
        faults.FaultPlan.parse(text)
    with pytest.raises(ValueError) as jerr:
        jfaults.FaultPlan.parse(text)
    assert str(err.value) == str(jerr.value)


def test_install_from_env_and_maybe_fail(monkeypatch):
    monkeypatch.setenv("RT1_FAULTS", "session_restore@2,migrate_import@1")
    try:
        plan, jplan = faults.install_from("replica_kill@1"), jfaults.install_from("replica_kill@1")
        assert plan.fired_counts() == jplan.fired_counts()
        assert faults.active() is plan
        raised = []
        for call in range(1, 4):
            outcome = []
            for module in (faults, jfaults):
                try:
                    module.maybe_fail("session_restore", what=f"s{call}")
                    outcome.append(None)
                except OSError as exc:
                    outcome.append(str(exc))
            assert outcome[0] == outcome[1]
            raised.append(outcome[0])
        assert raised == [None, "injected fault [session_restore]: s2", None]
        monkeypatch.delenv("RT1_FAULTS")
        assert faults.install_from("") is None and faults.active() is None
    finally:
        faults.clear()
        jfaults.clear()
