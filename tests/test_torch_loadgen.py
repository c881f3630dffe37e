"""The port's load generator (`python -m rt1_tpu_torch.serve.loadgen`)
against the JAX package's (`scripts/serve_loadgen.py`, loaded by file
path), on the CPU.

* Pure helpers equal JAX's: `parse_task_mix`, `build_schedule` for every
  schedule (and its refusal), `_peak_p99`, and the `slo` section the SLO
  ledger makes of one outcome stream.
* One port `tiny` replica, two loadgens: 8 sessions x 6 steps `--traced`
  from each give records with identical key sets, 48 ok, occupancy > 1
  and no request-id mismatch.
* Stub fleets, short runs, each mode through both loadgens (the JAX one
  drives the JAX stub fleet): `--fleet 2 --faults replica_kill@1`, a
  `--traffic_schedule spike` and `--migration_ab` give the same keys, no
  failed request, and the mode's own evidence.
* `--quant_ab bf16,int8` at `tiny` on `--device cpu`: the JAX loadgen's
  record over the same port replicas has the same keys; agreement and
  bytes are the port's.
* A replica that dies before its ready-line makes `main` return 1 and
  name its command.
"""

import importlib.util
import json
import os
import threading

import numpy as np
import pytest
import torch

from rt1_tpu.obs.slo import SLOLedger as JaxSLOLedger
from rt1_tpu.obs.slo import SLOObjectives as JaxSLOObjectives
from rt1_tpu_torch.configs import get_config
from rt1_tpu_torch.eval.embedding import get_embedder
from rt1_tpu_torch.eval.restore import build_serve_engine
from rt1_tpu_torch.obs.slo import SLOLedger, SLOObjectives
from rt1_tpu_torch.serve import loadgen, loadgen_fleet
from rt1_tpu_torch.serve.engine import pow2_buckets
from rt1_tpu_torch.serve.server import ServeApp, make_server

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 32, 56


@pytest.fixture(scope="module")
def jax_loadgen():
    path = os.path.join(REPO, "scripts", "serve_loadgen.py")
    spec = importlib.util.spec_from_file_location("serve_loadgen", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _args(*argv):
    return loadgen.build_parser().parse_args(list(argv))


def _same_keys(ours, theirs, nested=()):
    assert set(ours) == set(theirs), set(ours) ^ set(theirs)
    for key in nested:
        assert set(ours[key]) == set(theirs[key]), (key, set(ours[key]) ^ set(theirs[key]))


@pytest.mark.parametrize("spec", ["", "blocktoblock:3,separate:1", "a,b:2", "unknown:play:2",
                                  "unknown:play", " x : 1.6 , y"])
def test_parse_task_mix_matches_jax(jax_loadgen, spec):
    assert loadgen.parse_task_mix(spec) == jax_loadgen.parse_task_mix(spec)


def test_parse_task_mix_refusal_matches_jax(jax_loadgen):
    for module in (loadgen, jax_loadgen):
        with pytest.raises(ValueError, match="has no task name"):
            module.parse_task_mix(":3")


@pytest.mark.parametrize("name", ["ramp", "spike", "diurnal"])
def test_build_schedule_matches_jax(jax_loadgen, name):
    assert loadgen_fleet.SCHEDULE_NAMES == jax_loadgen.SCHEDULE_NAMES
    for base, peak, phase_s in ((2, 12, 6.0), (1, 2, 0.5), (3, 3, 1.0)):
        assert loadgen_fleet.build_schedule(name, base, peak, phase_s) == \
            jax_loadgen.build_schedule(name, base, peak, phase_s)


def test_build_schedule_refusal_and_peak_p99_match_jax(jax_loadgen):
    messages = []
    for module in (loadgen_fleet, jax_loadgen):
        with pytest.raises(ValueError) as info:
            module.build_schedule("weekly", 1, 2, 1.0)
        messages.append(str(info.value))
    assert messages[0] == messages[1]
    rows = [{"clients": 2, "latency_p99_ms": 10.0}, {"clients": 8, "latency_p99_ms": 31.5},
            {"clients": 8, "latency_p99_ms": 40.0}, {"clients": 4, "latency_p99_ms": 12.0}]
    for case in (rows, rows[:1], []):
        assert loadgen_fleet._peak_p99(case) == jax_loadgen._peak_p99(case)


def test_slo_section_from_one_outcome_stream_matches_jax():
    rng = np.random.default_rng(4)
    classes = ("ok", "migrated", "restarted", "rejected", "failed")
    stream = [(str(rng.choice(classes, p=[0.85, 0.05, 0.04, 0.04, 0.02])),
               float(rng.exponential(0.05))) for _ in range(500)]
    ours = SLOLedger(SLOObjectives(availability=0.95, latency_p50_ms=40.0, latency_p99_ms=200.0))
    theirs = JaxSLOLedger(JaxSLOObjectives(availability=0.95, latency_p50_ms=40.0,
                                           latency_p99_ms=200.0))
    for klass, seconds in stream:
        ours.observe(klass, seconds)
        theirs.observe(klass, seconds)
    assert json.loads(json.dumps(ours.summary())) == json.loads(json.dumps(theirs.summary()))


@pytest.fixture(scope="module")
def replica():
    engine, _ = build_serve_engine(get_config("tiny"), device="cpu", max_sessions=8,
                                   buckets=pow2_buckets(8), embedder=get_embedder("hash"))
    app = ServeApp(engine, image_shape=(H, W, 3))
    app.start(warmup=True)
    httpd = make_server(app, port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    app.drain()


def test_one_replica_two_loadgens(replica, jax_loadgen):
    ours = loadgen.run_loadgen(replica, sessions=8, steps=6, seed=3, traced=True)
    theirs = jax_loadgen.run_loadgen(replica, sessions=8, steps=6, seed=3, traced=True)
    _same_keys(ours, theirs, nested=("latency_by_class", "slo"))
    for record in (ours, theirs):
        assert record["requests_ok"] == 48 and record["requests_failed"] == 0
        assert record["mean_batch_occupancy"] > 1
        assert record["request_id_mismatches"] == 0
        assert record["image_shape"] == [H, W, 3]
        assert record["latency_p99_ms"] >= record["latency_p50_ms"] > 0


def test_overhead_ab_record_matches_jax(replica, jax_loadgen):
    args = _args("--url", replica, "--sessions", "4", "--steps", "2", "--overhead_ab", "2")
    ours, theirs = loadgen.run_overhead_ab(args), jax_loadgen.run_overhead_ab(args)
    _same_keys(ours, theirs, nested=("passes", "best_req_per_sec"))
    assert ours["requests_failed"] == 0 and ours["request_id_mismatches"] == 0
    assert [len(ours["passes"][side]) for side in ("untraced", "traced")] == [2, 2]


def test_stub_fleet_chaos_matches_jax(jax_loadgen):
    args = _args("--fleet", "2", "--stub", "--faults", "replica_kill@1", "--sessions", "3",
                 "--duration", "3", "--chaos_interval_s", "1", "--fleet_warmup_timeout_s", "120")
    ours = loadgen_fleet.run_fleet_chaos(args)
    theirs = jax_loadgen.run_fleet_chaos(args)
    _same_keys(ours, theirs, nested=("latency_by_class",))
    assert ours["requests_failed"] == 0
    assert ours["replica_restarts_total"] == 1 and ours["replicas_ready_at_end"] == 2
    assert ours["chaos"]["kills_injected"] == 1


def test_stub_traffic_schedule_matches_jax(jax_loadgen):
    args = _args("--traffic_schedule", "spike", "--stub", "--phase_duration", "0.8",
                 "--schedule_base_sessions", "1", "--schedule_peak_sessions", "3",
                 "--max_replicas", "2", "--fleet_warmup_timeout_s", "120")
    ours = loadgen_fleet.run_elastic_bench(args)
    theirs = jax_loadgen.run_elastic_bench(args)
    _same_keys(ours, theirs, nested=("sides", "p99_peak_phase", "cost_per_request"))
    _same_keys(ours["sides"]["elastic"]["spike"], theirs["sides"]["elastic"]["spike"])
    assert ours["requests_failed"] == 0
    assert [row["phase"] for row in ours["sides"]["fixed_max"]["spike"]["phases"]] == \
        ["pre", "edge", "spike", "post"]


def test_migration_ab_matches_jax(jax_loadgen):
    args = _args("--migration_ab", "--sessions", "3", "--steps", "1",
                 "--fleet_warmup_timeout_s", "120")
    ours = loadgen_fleet.run_migration_ab(args)
    theirs = jax_loadgen.run_migration_ab(args)
    _same_keys(ours, theirs, nested=("sides",))
    _same_keys(ours["sides"]["durable"], theirs["sides"]["durable"])
    assert ours["requests_failed"] == 0
    assert ours["zero_window_resets"] and ours["token_identical_continuations"]
    assert ours["legacy_window_resets"] >= 1


def test_quant_ab_at_tiny_on_the_cpu(jax_loadgen, monkeypatch, tmp_path):
    metrics = tmp_path / "replicas.jsonl"
    args = _args("--quant_ab", "bf16,int8", "--config", "tiny", "--device", "cpu",
                 "--sessions", "2", "--steps", "2", "--parity_steps", "6",
                 "--replica_metrics", str(metrics))
    ours = loadgen.run_quant_ab(args)
    assert ours["dtypes"] == ["f32", "bf16", "int8"] and ours["requests_failed"] == 0
    devices = {d: row["param_bytes_device"] for d, row in ours["per_dtype"].items()}
    assert devices["f32"] == 2 * devices["bf16"] > devices["int8"]
    for row in ours["per_dtype"].values():
        assert row["parity"]["tokens_total"] == 6 * 3 and row["requests_ok"] == 4
    # The flagship's byte report counts as JAX's does (3.71x int8).
    assert ours["flagship_byte_report"]["int8_reduction"] == ours["value"] == 3.71
    labels = [json.loads(line)["label"] for line in metrics.read_text().splitlines()]
    assert labels == ["quant_ab/f32", "quant_ab/bf16", "quant_ab/int8"]
    # The JAX loadgen over the same port replicas: the same record keys.
    monkeypatch.setattr(jax_loadgen, "_spawn_server", loadgen._spawn_server)
    jax_args = _args("--quant_ab", "int8", "--config", "tiny", "--device", "cpu",
                     "--sessions", "1", "--steps", "1", "--parity_steps", "2",
                     "--byte_report_config", "")
    theirs = jax_loadgen.run_quant_ab(jax_args)
    _same_keys(ours, theirs)
    assert theirs["dtypes"] == ["f32", "int8"]
    _same_keys(ours["per_dtype"]["int8"], theirs["per_dtype"]["int8"])


def test_a_replica_that_dies_before_ready_fails_the_run(capsys):
    code = loadgen.main(["--quant_ab", "int8", "--config", "tiny", "--device", "nonsense",
                         "--byte_report_config", "", "--fleet_warmup_timeout_s", "60"])
    assert code == 1
    err = capsys.readouterr().err
    assert "rt1_tpu_torch.serve" in err and "--device nonsense" in err
    assert "before ready" in err
