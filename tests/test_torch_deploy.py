"""The port's continuous deployment (`rt1_tpu_torch/deploy/`: decision,
watcher, verdict, controller; the router's canary seam and the fleet's
`--promote_from`) against the JAX package's.

Every scenario of `tests/test_deploy.py` runs on each package — its
controller, router and stub replicas, with stub gates — and returns what
it observed: decisions, streaks, placements, timelines (wall times
dropped), verdict files and replica steps. Tolerance: exact — equal
records. Verdicts are signed under one key (`RT1_DEPLOY_KEY`), so their
signatures must be the same bytes. A seeded stream of `CanarySignals`
gets JAX's decision at every tick. The checkpoint watcher is held to each
package's own trainer (`latest_step`) on its own layout: Orbax's step
directories for JAX, `<step>/state.pt` for the port.
"""

import contextlib
import json
import os
import threading
import types

import numpy as np
import pytest

import rt1_tpu.deploy.controller as jax_controller
import rt1_tpu.deploy.decision as jax_decision
import rt1_tpu.deploy.verdict as jax_verdict
import rt1_tpu.deploy.watcher as jax_watcher
import rt1_tpu.resilience.faults as jax_faults
import rt1_tpu.serve.router as jax_router
import rt1_tpu.serve.stub as jax_stub
import rt1_tpu_torch.deploy.controller as port_controller
import rt1_tpu_torch.deploy.decision as port_decision
import rt1_tpu_torch.deploy.verdict as port_verdict
import rt1_tpu_torch.deploy.watcher as port_watcher
import rt1_tpu_torch.resilience.faults as port_faults
import rt1_tpu_torch.serve.router as port_router
import rt1_tpu_torch.serve.stub as port_stub


def _ns(controller, decision, verdict, watcher, faults, router, stub, ckpt_file, trainer):
    return types.SimpleNamespace(
        Controller=controller.PromotionController, Policy=decision.CanaryPolicy,
        Judge=decision.CanaryJudge, Signals=decision.CanarySignals, verdict=verdict,
        watcher=watcher, faults=faults, router=router, stub=stub, ckpt_file=ckpt_file,
        trainer=trainer)


JAX = _ns(jax_controller, jax_decision, jax_verdict, jax_watcher, jax_faults, jax_router,
          jax_stub, "checkpoint", "rt1_tpu.trainer.checkpoints")
PORT = _ns(port_controller, port_decision, port_verdict, port_watcher, port_faults, port_router,
           port_stub, "state.pt", "rt1_tpu_torch.trainer.checkpoints")


@pytest.fixture(autouse=True)
def _one_key(monkeypatch):
    monkeypatch.setenv(port_verdict.ENV_KEY, "test-deploy-key")


def _both(case, tmp_path):
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_dir.mkdir()
    port_dir.mkdir()
    try:
        port = case(PORT, port_dir)
    finally:
        PORT.faults.clear()
    try:
        ref = case(JAX, jax_dir)
    finally:
        JAX.faults.clear()
    assert port == ref
    return port


# ------------------------------------------------------------------ decision


def case_policy_validation(m, _):
    errors = []
    for kw in (dict(burn_threshold=0.0), dict(breach_ticks=0), dict(clean_window_ticks=0),
               dict(min_canary_requests=-1), dict(canary_weight=0.0), dict(canary_weight=1.5)):
        with pytest.raises(ValueError) as info:
            m.Policy(**kw)
        errors.append(str(info.value))
    return errors, m.Policy().as_dict()


def _sig(m, requests=100, burn=0.0, fleet=0.0, ready=True):
    return m.Signals(canary_requests=requests, canary_burn=burn, fleet_burn=fleet,
                     canary_ready=ready)


def case_judge_promotes_after_clean_window(m, _):
    judge = m.Judge(m.Policy(clean_window_ticks=3))
    got = [judge.decide(_sig(m)) for _ in range(3)]
    assert got == ["hold", "hold", "promote"] and judge.clean_streak == 3
    return got


def case_judge_rolls_back_after_breaches(m, _):
    judge = m.Judge(m.Policy(breach_ticks=2, burn_threshold=2.0))
    got = [judge.decide(_sig(m, burn=5.0)) for _ in range(2)]
    assert got == ["hold", "rollback"]
    return got


def case_judge_breach_streak_resets(m, _):
    judge = m.Judge(m.Policy(breach_ticks=2, clean_window_ticks=99))
    got = [judge.decide(_sig(m, burn=5.0)), judge.decide(_sig(m, burn=0.0))]
    assert judge.breach_streak == 0
    got.append(judge.decide(_sig(m, burn=5.0)))
    assert got == ["hold"] * 3
    return got


def case_judge_evidence_floor(m, _):
    judge = m.Judge(m.Policy(clean_window_ticks=1, min_canary_requests=8))
    got = [judge.decide(_sig(m, requests=3)) for _ in range(5)]
    assert got == ["hold"] * 5 and judge.clean_streak == 0
    judge2 = m.Judge(m.Policy(breach_ticks=1, min_canary_requests=8))
    got.append(judge2.decide(_sig(m, requests=0, burn=9.0)))
    assert got[-1] == "rollback"
    return got


def case_judge_fleet_incident_no_scapegoat(m, _):
    judge = m.Judge(m.Policy(breach_ticks=1, burn_threshold=2.0))
    got = [judge.decide(_sig(m, burn=5.0, fleet=5.0))]
    assert got == ["hold"] and judge.breach_streak == 0
    got.append(judge.decide(_sig(m, burn=5.0, fleet=4.0)))
    assert got[-1] == "rollback"
    return got


def case_judge_unroutable_is_breach(m, _):
    judge = m.Judge(m.Policy(breach_ticks=1))
    got = judge.decide(_sig(m, ready=False))
    assert got == "rollback"
    return got


def case_judge_seeded_signal_stream(m, _):
    """A seeded stream of signals under a few policies: every decision and
    streak equal to JAX's, tick for tick."""
    rng = np.random.default_rng(2024)
    out = []
    for policy in (m.Policy(), m.Policy(breach_ticks=1, clean_window_ticks=2,
                                        min_canary_requests=0),
                   m.Policy(burn_threshold=0.5, breach_ticks=3, clean_window_ticks=4,
                            min_canary_requests=20, canary_weight=0.75)):
        judge = m.Judge(policy)
        for _ in range(300):
            sig = m.Signals(canary_requests=int(rng.integers(0, 40)),
                            canary_burn=float(rng.choice([0.0, rng.uniform(0, 6)])),
                            fleet_burn=float(rng.choice([0.0, rng.uniform(0, 4)])),
                            canary_ready=bool(rng.random() > 0.05))
            decision = judge.decide(sig)
            out.append((decision, judge.breach_streak, judge.clean_streak))
            if decision != "hold":
                judge.reset()
    return out


# ------------------------------------------------------------------- watcher


def _make_ckpt(m, root, step, complete=True):
    d = os.path.join(root, str(step))
    os.makedirs(d, exist_ok=True)
    if complete:
        with open(os.path.join(d, m.ckpt_file), "w") as f:
            f.write("x")
    return d


def case_latest_step_matches_trainer(m, tmp):
    import importlib

    trainer_latest = importlib.import_module(m.trainer).latest_step
    root = str(tmp / "checkpoints")
    answers = []

    def check(label):
        got = m.watcher.latest_checkpoint_step(root)
        assert got == trainer_latest(root), label
        answers.append((label, got))

    check("missing dir")
    os.makedirs(root)
    check("empty dir")
    _make_ckpt(m, root, 2)
    check("one step")
    _make_ckpt(m, root, 10)
    _make_ckpt(m, root, 5)
    check("several steps")
    os.makedirs(os.path.join(root, "20.orbax-checkpoint-tmp-1234"))
    check("orbax tmp dir")
    _make_ckpt(m, root, 30, complete=False)
    check("empty step dir")
    with open(os.path.join(root, "40"), "w") as f:
        f.write("not a dir")
    with open(os.path.join(root, "ckpt_metadata"), "w") as f:
        f.write("{}")
    check("digit-named file")
    assert m.watcher.latest_checkpoint_step(root) == 10
    return answers


def test_port_watcher_skips_a_save_in_flight(tmp_path):
    """The port's own torn write: a step directory holding only the
    trainer's `state.pt.tmp` is not a checkpoint, for the watcher as for
    `trainer.checkpoints.latest_step`."""
    from rt1_tpu_torch.trainer.checkpoints import latest_step

    root = str(tmp_path / "checkpoints")
    _make_ckpt(PORT, root, 4)
    os.makedirs(os.path.join(root, "6"))
    open(os.path.join(root, "6", "state.pt.tmp"), "w").close()
    assert port_watcher.latest_checkpoint_step(root) == latest_step(root) == 4
    watcher = port_watcher.CheckpointWatcher(str(tmp_path))
    assert watcher.poll() == 4 and watcher.poll() is None
    os.replace(os.path.join(root, "6", "state.pt.tmp"), os.path.join(root, "6", "state.pt"))
    assert watcher.poll() == 6 and watcher.pending_steps() == [4, 6]


def case_watcher_surfaces_once(m, tmp):
    root = str(tmp / "checkpoints")
    watcher = m.watcher.CheckpointWatcher(str(tmp))
    got = [watcher.poll()]
    os.makedirs(root)
    _make_ckpt(m, root, 2)
    got += [watcher.poll(), watcher.poll()]
    _make_ckpt(m, root, 4)
    got.append(watcher.poll())
    assert got == [None, 2, None, 4] and watcher.pending_steps() == [2, 4]
    return got, watcher.polls


def case_watcher_high_water(m, tmp):
    root = str(tmp / "checkpoints")
    os.makedirs(root)
    _make_ckpt(m, root, 2)
    watcher = m.watcher.CheckpointWatcher(str(tmp), seen_through=2)
    got = [watcher.poll()]
    _make_ckpt(m, root, 4)
    got.append(watcher.poll())
    watcher.dismiss(6)
    _make_ckpt(m, root, 6)
    got.append(watcher.poll())
    assert got == [None, 4, None]
    return got


# ------------------------------------------------------------------- verdict


def case_verdict_roundtrip(m, tmp):
    path = str(tmp / "deploy" / "verdict_4.json")
    key = "k-" + "x" * 16
    signed = m.verdict.write_verdict(
        path, {"passed": True, "candidate_step": 4, "matrix": {"b": [1, 2.5]}}, key)
    payload, ok = m.verdict.verify_verdict(path, key)
    assert ok and payload["passed"] is True
    with open(path, "rb") as f:
        written = f.read()
    payload["passed"] = False
    with open(path, "w") as f:
        json.dump(payload, f)
    _, tampered_ok = m.verdict.verify_verdict(path, key)
    assert not tampered_ok
    assert m.verdict.verify_verdict(str(tmp / "nope.json"), key) == (None, False)
    with open(path, "w") as f:
        f.write("{torn")
    assert m.verdict.verify_verdict(path, key) == (None, False)
    return signed, written, m.verdict.canonical_bytes({"b": 1, "a": [1.5, "x"]})


def test_verdict_keyfile_generated_once(tmp_path, monkeypatch):
    """The per-workdir key file (mode 0600, stable), and the env key
    overriding it, as JAX's `test_verdict_sign_write_verify_roundtrip` /
    `test_verdict_env_key_overrides_keyfile` pin them."""
    monkeypatch.delenv(port_verdict.ENV_KEY)
    key = port_verdict.signing_key(str(tmp_path / "deploy"))
    keyfile = tmp_path / "deploy" / "deploy_key"
    assert keyfile.exists() and (keyfile.stat().st_mode & 0o777) == 0o600
    assert port_verdict.signing_key(str(tmp_path / "deploy")) == key
    # A key file written by one package is read by the other.
    assert jax_verdict.signing_key(str(tmp_path / "deploy")) == key
    monkeypatch.setenv(port_verdict.ENV_KEY, "fleet-secret")
    assert port_verdict.ENV_KEY == jax_verdict.ENV_KEY
    assert port_verdict.signing_key(str(tmp_path / "other")) == "fleet-secret"
    assert not (tmp_path / "other" / "deploy_key").exists()


def test_verdict_signatures_byte_equal_to_jax():
    """Same key, same payload: the same signature bytes, over seeded
    payloads of the gate's shapes (nested dicts, floats, lists, None)."""
    rng = np.random.default_rng(7)
    for i in range(50):
        payload = {
            "passed": bool(rng.random() > 0.5), "candidate_step": int(rng.integers(0, 1e6)),
            "incumbent_step": None if i % 7 == 0 else int(rng.integers(0, 1e6)),
            "matrix": {f"task{j}": {"2": {"success_rate": float(rng.random()),
                                          "episodes": int(rng.integers(1, 9))}}
                       for j in range(int(rng.integers(0, 4)))},
            "wall_seconds": float(rng.uniform(0, 100)), "note": "gate ✓ " + str(i),
        }
        key = f"key-{i}"
        assert port_verdict.canonical_bytes(payload) == jax_verdict.canonical_bytes(payload)
        assert port_verdict.sign_payload(payload, key) == jax_verdict.sign_payload(payload, key)


# ------------------------------------------------------- router canary seam


@contextlib.contextmanager
def _fleet(m):
    apps, servers = [], []
    router = m.router.Router(replica_timeout_s=5.0)
    for rid in range(2):
        app = m.stub.StubReplicaApp(replica_id=rid)
        httpd = m.stub.make_stub_server(app)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        host, port = httpd.server_address[:2]
        replica = router.add_replica(m.router.Replica(rid, url=f"http://{host}:{port}"))
        replica.state = m.router.READY
        apps.append(app)
        servers.append(httpd)
    try:
        yield router, apps
    finally:
        m.faults.clear()
        for httpd in servers:
            try:
                httpd.shutdown()
                httpd.server_close()
            except OSError:
                pass


def _act(router, session_id):
    status, body = router.route_act({"session_id": session_id, "image_b64": "AAAA"})
    return status, {k: body.get(k) for k in ("replica_id", "restarted")}


def case_weighted_placement(m, _):
    with _fleet(m) as (router, _):
        router.set_canary(1, 0.25)
        placements = [_act(router, f"w{i}")[1]["replica_id"] for i in range(8)]
        assert placements == [0, 0, 0, 1, 0, 0, 0, 1]
        assert router.canary_status()["fresh_placements"] == 8
        again = [_act(router, f"w{i}")[1]["replica_id"] for i in range(8)]
        assert again == placements and router.canary_status()["fresh_placements"] == 8
        return placements, router.canary_status()


def case_clear_keeps_demote_evicts(m, _):
    with _fleet(m) as (router, _):
        router.set_canary(1, 1.0)
        got = [_act(router, "keep")]
        assert router.clear_canary() == 1
        got.append(_act(router, "keep"))
        assert got[-1][1]["replica_id"] == 1 and not got[-1][1]["restarted"]
        router.set_canary(1, 1.0)
        got.append(_act(router, "evict"))
        assert router.demote_canary() == 1
        got.append(_act(router, "evict"))
        assert got[-1][0] == 200 and got[-1][1]["restarted"] is True
        return got


def case_not_ready_canary_drops_out(m, _):
    with _fleet(m) as (router, _):
        router.set_canary(1, 1.0)
        router.set_state(1, m.router.NOTREADY)
        got = [_act(router, f"n{i}") for i in range(3)]
        assert all(s == 200 and b["replica_id"] == 0 for s, b in got)
        return got


def case_reload_one_single_replica(m, _):
    with _fleet(m) as (router, apps):
        entry = router.reload_one(1, 7)
        assert entry["status"] == 200 and entry["recovered"] is True
        assert apps[1].checkpoint_step == 7 and apps[0].checkpoint_step == -1
        skipped = router.reload_one(99, 7)
        assert skipped["skipped"] == "unknown"
        return {k: entry[k] for k in ("status", "recovered", "checkpoint_step")}, skipped


# --------------------------------------------------- controller deploy cycle


def _auto_pass(candidate_step, incumbent_step):
    return {"gate": "auto", "passed": True, "candidate_step": candidate_step,
            "incumbent_step": incumbent_step}


def _controller(m, router, workdir, **overrides):
    policy = m.Policy(breach_ticks=2, clean_window_ticks=2, min_canary_requests=2,
                      canary_weight=0.5)
    kwargs = dict(gate_fn=_auto_pass, policy=policy, incumbent_step=2)
    kwargs.update(overrides)
    return m.Controller(router, workdir, **kwargs)


def _record(controller, workdir):
    """The controller's evidence without wall times or scratch paths: the
    timeline, watch log, gauges and the signed verdict files' bytes."""
    timeline = []
    for entry in controller.timeline:
        entry = {k: v for k, v in entry.items() if k not in ("unix_time", "verdict_path")}
        if isinstance(entry.get("restore"), dict):
            entry["restore"] = {k: v for k, v in entry["restore"].items()
                                if k in ("replica", "status", "checkpoint_step", "recovered")}
        timeline.append(entry)
    verdicts = []
    for path in controller.verdict_paths:
        with open(path, "rb") as f:
            verdicts.append((os.path.relpath(path, workdir), f.read()))
    return timeline, controller.watch_log, controller.deploy_gauges(), verdicts


def case_good_candidate_promoted(m, tmp):
    root = str(tmp / "checkpoints")
    with _fleet(m) as (router, apps):
        _make_ckpt(m, root, 2)
        controller = _controller(m, router, str(tmp))
        controller.tick()
        assert controller.state == "idle" and controller.candidates_seen == 0
        _make_ckpt(m, root, 4)
        controller.tick()
        assert [e["event"] for e in controller.timeline] == [
            "candidate", "gate_passed", "canary_started"]
        assert apps[1].checkpoint_step == 4 and apps[0].checkpoint_step == -1
        assert router.canary_status() == {"replica_id": 1, "weight": 0.5,
                                          "fresh_placements": 0}
        payload, ok = m.verdict.verify_verdict(controller.verdict_paths[0],
                                               controller.signing_key)
        assert ok and payload["passed"] and payload["candidate_step"] == 4
        placed = [_act(router, f"s{i}") for i in range(6)]
        assert router.replica_slo_snapshot()[1]["requests_total"] == 3
        controller.tick()
        assert controller.state == "canary"
        controller.tick()
        assert controller.state == "idle" and controller.promotions == 1
        assert controller.incumbent_step == 4
        assert [a.checkpoint_step for a in apps] == [4, 4]
        assert router.canary_status()["replica_id"] is None
        again = [_act(router, f"s{i}") for i in range(6)]
        assert all(s == 200 and not b["restarted"] for s, b in again)
        assert router.slo.gauges()["slo_requests_failed"] == 0
        assert all(a.compile_count == len(a.buckets) for a in apps)
        return placed, again, _record(controller, str(tmp))


def case_bad_candidate_rolled_back(m, tmp):
    root = str(tmp / "checkpoints")
    with _fleet(m) as (router, apps):
        _make_ckpt(m, root, 2)
        _make_ckpt(m, root, 4)
        controller = _controller(m, router, str(tmp), incumbent_step=4)
        apps[0].checkpoint_step = apps[1].checkpoint_step = 4
        m.faults.install_from("canary_slo_breach@1")
        _make_ckpt(m, root, 6)
        controller.tick()
        assert controller.state == "canary" and apps[1].checkpoint_step == 6
        got = [_act(router, "victim"), _act(router, "canary-bound")]
        assert got[1][1]["replica_id"] == 1
        controller.tick()
        assert controller.state == "canary" and controller.watch_log[-1]["synthetic_breach"]
        controller.tick()
        assert controller.state == "idle" and controller.rollbacks == 1
        assert controller.promotions == 0 and controller.incumbent_step == 4
        rolled = controller.timeline[-1]
        assert rolled["event"] == "rolled_back" and rolled["reason"] == "slo_breach_injected"
        assert [a.checkpoint_step for a in apps] == [4, 4]
        got += [_act(router, "canary-bound"), _act(router, "victim")]
        assert got[2][1]["restarted"] is True and not got[3][1]["restarted"]
        assert router.slo.gauges()["slo_requests_failed"] == 0
        return got, _record(controller, str(tmp))


def case_failed_promote_rolls_back(m, tmp):
    root = str(tmp / "checkpoints")
    with _fleet(m) as (router, apps):
        _make_ckpt(m, root, 2)
        controller = _controller(m, router, str(tmp))
        apps[0].checkpoint_step = apps[1].checkpoint_step = 2
        m.faults.install_from("promote@1")
        _make_ckpt(m, root, 4)
        controller.tick()
        assert controller.state == "canary"
        for i in range(4):
            _act(router, f"p{i}")
        controller.tick()
        controller.tick()
        assert controller.state == "idle" and controller.promotions == 0
        assert controller.rollbacks == 1 and controller.incumbent_step == 2
        assert "promote_failed" in [e["event"] for e in controller.timeline]
        assert [a.checkpoint_step for a in apps] == [2, 2]
        assert router.slo.gauges()["slo_requests_failed"] == 0
        timeline, log, gauges, verdicts = _record(controller, str(tmp))
        for entry in timeline:  # the fleet-wide restore lists each reload
            if isinstance(entry.get("restore"), list):
                entry["restore"] = [r.get("checkpoint_step") for r in entry["restore"]]
        return timeline, log, gauges, verdicts


def case_gate_rejection(m, tmp):
    root = str(tmp / "checkpoints")
    with _fleet(m) as (router, apps):
        _make_ckpt(m, root, 2)
        controller = _controller(m, router, str(tmp), gate_fn=lambda c, i: {
            "passed": False, "candidate_mean_success": 0.0})
        _make_ckpt(m, root, 4)
        controller.tick()
        assert controller.state == "idle" and controller.gates_failed == 1
        assert [e["event"] for e in controller.timeline] == ["candidate", "gate_rejected"]
        assert apps[1].checkpoint_step == -1
        payload, ok = m.verdict.verify_verdict(controller.verdict_paths[0],
                                               controller.signing_key)
        assert ok and payload["passed"] is False
        return _record(controller, str(tmp))


def case_crashing_gate(m, tmp):
    with _fleet(m) as (router, _):
        def explode(candidate_step, incumbent_step):
            raise RuntimeError("gate OOM")

        controller = _controller(m, router, str(tmp), gate_fn=explode)
        _make_ckpt(m, str(tmp / "checkpoints"), 4)
        controller.tick()
        assert controller.state == "idle" and controller.gates_failed == 1
        payload, ok = m.verdict.verify_verdict(controller.verdict_paths[0],
                                               controller.signing_key)
        assert ok and payload["passed"] is False and "gate OOM" in payload["error"]
        return _record(controller, str(tmp))


def case_no_canary_capacity(m, tmp):
    with _fleet(m) as (router, apps):
        router.set_state(1, m.router.NOTREADY)
        controller = _controller(m, router, str(tmp))
        _make_ckpt(m, str(tmp / "checkpoints"), 4)
        controller.tick()
        assert controller.state == "idle"
        assert "canary_unplaceable" in [e["event"] for e in controller.timeline]
        assert apps[1].checkpoint_step == -1
        return _record(controller, str(tmp))


def case_deploy_gauges_shape(m, tmp):
    with _fleet(m) as (router, _):
        controller = _controller(m, router, str(tmp))
        gauges = controller.deploy_gauges()
        assert gauges["state"] == "idle" and gauges["incumbent_step"] == 2
        assert gauges["candidate_step"] == -1 and gauges["canary_replica_id"] == -1
        for key, value in gauges.items():
            if key != "state":
                assert isinstance(value, (int, float)), key
        summary = controller.summary()
        assert summary["policy"]["canary_weight"] == 0.5
        assert summary["timeline"] == [] and summary["verdicts"] == []
        summary.pop("workdir")
        return summary


CASES = [
    case_policy_validation, case_judge_promotes_after_clean_window,
    case_judge_rolls_back_after_breaches, case_judge_breach_streak_resets,
    case_judge_evidence_floor, case_judge_fleet_incident_no_scapegoat,
    case_judge_unroutable_is_breach, case_judge_seeded_signal_stream,
    case_latest_step_matches_trainer, case_watcher_surfaces_once, case_watcher_high_water,
    case_verdict_roundtrip, case_weighted_placement, case_clear_keeps_demote_evicts,
    case_not_ready_canary_drops_out, case_reload_one_single_replica,
    case_good_candidate_promoted, case_bad_candidate_rolled_back,
    case_failed_promote_rolls_back, case_gate_rejection, case_crashing_gate,
    case_no_canary_capacity, case_deploy_gauges_shape,
]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[len("case_"):] for c in CASES])
def test_deploy_matches_jax(case, tmp_path):
    _both(case, tmp_path)
