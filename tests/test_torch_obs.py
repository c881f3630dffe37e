"""The port's serving observability against the JAX package's, exactly.

`rt1_tpu_torch/obs/` and `serve/{metrics,reqtrace}.py` are copies of the JAX
package's stdlib modules (the port imports nothing of `rt1_tpu`). The same
seeded inputs go through both:

* `ServeMetrics` fed one seeded stream of requests, batches, buckets, tasks
  and fleet events gives the same snapshot (but the uptime);
* `render_serve_snapshot` / `render_fleet_snapshot` give byte-equal text for
  the same snapshot dicts (a replica that did not answer included), and
  `parse_exposition` / `accepts_text` agree on it;
* `SLOLedger` with an injected clock gives equal gauges, windowed views and
  summaries over a seeded outcome stream;
* `ExemplarRing` keeps the same records in the same order, `percentile` and
  `bucket_quantile` agree, `RequestPhases` gives the same breakdown and
  `request_id_from` resolves the same id from the same headers and payload.
"""

import numpy as np
import pytest

from rt1_tpu.obs import prometheus as jprom
from rt1_tpu.obs import quantiles as jquant
from rt1_tpu.obs.recorder import ExemplarRing as JaxExemplarRing
from rt1_tpu.obs.slo import OUTCOMES as JAX_OUTCOMES
from rt1_tpu.obs.slo import SLOLedger as JaxSLOLedger
from rt1_tpu.obs.slo import SLOObjectives as JaxSLOObjectives
from rt1_tpu.serve import reqtrace as jreqtrace
from rt1_tpu.serve.metrics import ServeMetrics as JaxServeMetrics
from rt1_tpu_torch.obs import prometheus as prom
from rt1_tpu_torch.obs import quantiles
from rt1_tpu_torch.obs.recorder import ExemplarRing
from rt1_tpu_torch.obs.slo import OUTCOMES, SLOLedger, SLOObjectives
from rt1_tpu_torch.serve import reqtrace
from rt1_tpu_torch.serve.metrics import ServeMetrics

TASKS = ("block2block", "separate", None, "")


def _feed(metrics, seed):
    """One seeded stream of everything a replica and a router record."""
    rng = np.random.default_rng(seed)
    for i in range(200):
        metrics.observe_request(float(rng.lognormal(-4.0, 1.5)), ok=bool(rng.random() > 0.05))
        if i % 3 == 0:
            size = int(rng.integers(1, 9))
            bucket = 1 << int(np.ceil(np.log2(size)))
            metrics.observe_batch(size, queued=int(rng.integers(0, 4)),
                                  in_flight=int(rng.integers(0, 3)),
                                  joined_mid_cycle=int(rng.integers(0, 2)))
            metrics.observe_bucket(bucket, size)
            metrics.observe_step(float(rng.lognormal(-5.0, 1.0)))
        if i % 7 == 0:
            metrics.observe_task_request(TASKS[i % len(TASKS)], new_session=bool(i % 2))
        if i % 11 == 0:
            metrics.observe_rejected()
            metrics.observe_shed(("client_rate", "overload")[i % 2])
        if i % 17 == 0:
            metrics.observe_reset()
            metrics.observe_session_restart()
            metrics.observe_session_migration()
            metrics.observe_scale_event(("up", "down")[i % 2])
    metrics.observe_reload()
    metrics.set_autoscale_state(replicas=3, tier_replicas={"f32": 1, "int8": 2})


def _gauges(replica_id):
    return dict(active_sessions=3, compile_count=4, bucket_count=4, ready=1, draining=0,
                reloading=0, replica_id=replica_id, inference_dtype=("f32", "int8")[replica_id % 2],
                param_bytes_device=1000 + replica_id, param_bytes_master=4000,
                cache_invalidations={"swap": 1, "reset": 2, "evict": 0}, slow_exemplars=5,
                migration_exports_total=2, migration_restores_total=1)


def _snapshot_pair(seed, replica_id=0):
    port, jax = ServeMetrics(), JaxServeMetrics()
    _feed(port, seed)
    _feed(jax, seed)
    a, b = port.snapshot(**_gauges(replica_id)), jax.snapshot(**_gauges(replica_id))
    return a, b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_serve_metrics_snapshot_equals_jax(seed):
    port, jax = _snapshot_pair(seed)
    for snap in (port, jax):
        snap.pop("uptime_s")
        snap.pop("requests_per_sec")
    assert port == jax
    assert port["autoscale_shed_total"]["client_rate"] > 0
    assert port["task_requests_total"]["unlabeled"] > 0


@pytest.mark.parametrize("seed", [0, 3])
def test_render_serve_snapshot_byte_equal(seed):
    snapshot, _ = _snapshot_pair(seed)
    text = prom.render_serve_snapshot(snapshot)
    assert text == jprom.render_serve_snapshot(snapshot)
    parsed, jparsed = prom.parse_exposition(text), jprom.parse_exposition(text)
    assert parsed.types == jparsed.types and parsed.help == jparsed.help
    assert parsed.samples == jparsed.samples
    assert parsed.value("rt1_serve_inference_dtype", dtype="f32") == 1.0
    assert parsed.histogram("rt1_serve_request_latency_seconds") == \
        jparsed.histogram("rt1_serve_request_latency_seconds")


def _replica_slo():
    out = {}
    for rid in (0, 1):
        ledger = JaxSLOLedger(JaxSLOObjectives(), clock=lambda: 0.0)
        for k, outcome in enumerate(JAX_OUTCOMES):
            for _ in range(k + rid):
                ledger.observe(outcome, 0.01 * k)
        gauges = ledger.gauges()
        out[rid] = {  # the shape of `Router.replica_slo_snapshot`
            "outcomes": {o: int(gauges[f"slo_requests_{o}"]) for o in JAX_OUTCOMES},
            "requests_total": int(gauges["slo_requests_total"]),
            "availability_rolling": gauges["slo_availability_rolling"],
            "error_budget_burn_rolling": gauges["slo_error_budget_burn_rolling"],
        }
    return out


@pytest.mark.parametrize("seed", [4, 5])
def test_render_fleet_snapshot_byte_equal(seed):
    router, _ = _snapshot_pair(seed)
    replicas = {0: _snapshot_pair(seed + 10, 0)[0], 1: _snapshot_pair(seed + 20, 1)[0], 2: None}
    slo = _replica_slo()
    text = prom.render_fleet_snapshot(router, replicas, replica_slo=slo)
    assert text == jprom.render_fleet_snapshot(router, replicas, replica_slo=slo)
    parsed = prom.parse_exposition(text)
    assert parsed.samples == jprom.parse_exposition(text).samples
    assert parsed.value("rt1_serve_replica_up", replica_id="0") == 1.0
    assert parsed.value("rt1_serve_replica_up", replica_id="2") == 0.0
    assert prom.fleet_metric_names() == jprom.fleet_metric_names()


@pytest.mark.parametrize("header", [
    None, "", "text/plain", "application/json", "application/json, text/plain, */*",
    "application/openmetrics-text; version=1.0.0", "TEXT/PLAIN;q=0.9", "*/*", "text/html",
])
def test_accepts_text_agrees(header):
    assert prom.accepts_text(header) == jprom.accepts_text(header)


def test_parse_exposition_refuses_what_jax_refuses():
    for bad in ("x 1\n", "# TYPE a gauge\n# TYPE a gauge\n", "# NOTE hi\n",
                "# TYPE a gauge\na{b=\"c\"} notanumber\n"):
        with pytest.raises(ValueError):
            jprom.parse_exposition(bad)
        with pytest.raises(ValueError):
            prom.parse_exposition(bad)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("seed", [0, 1])
def test_slo_ledger_equals_jax_with_injected_clock(seed):
    assert OUTCOMES == JAX_OUTCOMES
    rng = np.random.default_rng(seed)
    clock, jclock = _Clock(), _Clock()
    objectives = dict(availability=0.95, latency_p50_ms=20.0, latency_p99_ms=200.0, window=64)
    port = SLOLedger(SLOObjectives(**objectives), clock=clock, max_window_s=30.0)
    jax = JaxSLOLedger(JaxSLOObjectives(**objectives), clock=jclock, max_window_s=30.0)
    for _ in range(500):
        dt = float(rng.exponential(0.2))
        clock.t += dt
        jclock.t += dt
        outcome = str(rng.choice(OUTCOMES, p=[0.85, 0.05, 0.04, 0.04, 0.02]))
        latency = float(rng.lognormal(-4.0, 1.0))
        port.observe(outcome, latency)
        jax.observe(outcome, latency)
    assert port.gauges() == jax.gauges()
    assert port.summary() == jax.summary()
    for window in (1.0, 10.0, 60.0):
        assert port.windowed_counts(window) == jax.windowed_counts(window)
        assert port.windowed_burn(window) == jax.windowed_burn(window)
        assert port.windowed_availability(window) == jax.windowed_availability(window)
    with pytest.raises(ValueError):
        port.observe("unknown")


def test_exemplar_ring_order_and_stats_equal_jax(tmp_path):
    rng = np.random.default_rng(7)
    port, jax = ExemplarRing(capacity=16, threshold_ms=5.0), JaxExemplarRing(capacity=16,
                                                                            threshold_ms=5.0)
    for i in range(100):
        total = float(rng.exponential(5.0))
        outcome = ("ok", "ok", "ok", "rejected", "failed")[i % 5]
        fields = dict(request_id=f"r{i}", session=f"s{i % 3}", outcome=outcome,
                      phases={"total_ms": total, "device_ms": np.float32(total / 2)})
        assert port.offer(total, **fields) == jax.offer(total, **fields)
    strip = lambda recs: [{k: v for k, v in r.items() if k != "t"} for r in recs]  # noqa: E731
    assert strip(port.snapshot()) == strip(jax.snapshot())
    assert port.stats() == jax.stats() and len(port) == len(jax) == 16
    path = port.dump(str(tmp_path / "ring.jsonl"), reason="drain")
    from rt1_tpu.obs.recorder import read_exemplars

    read = read_exemplars(path)
    assert read["header"]["reason"] == "drain" and len(read["records"]) == 16


def test_percentile_and_bucket_quantile_equal_jax():
    rng = np.random.default_rng(3)
    for n in (0, 1, 2, 7, 100):
        values = sorted(rng.exponential(1.0, n).tolist())
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            assert quantiles.percentile(values, q) == jquant.percentile(values, q)
        assert quantiles.percentiles_ms(values) == jquant.percentiles_ms(values)
    buckets = (0.001, 0.01, 0.1, 1.0)
    counts = [int(c) for c in rng.integers(0, 10, 5)]
    for q in (0.1, 0.5, 0.99):
        assert quantiles.bucket_quantile(buckets, counts, sum(counts), 3.5, q) == \
            jquant.bucket_quantile(buckets, counts, sum(counts), 3.5, q)


def test_request_phases_equal_jax():
    rng = np.random.default_rng(11)
    stamps = np.cumsum(rng.exponential(400.0, 6)).tolist()
    names = ("t_admit", "t_enqueue", "t_formed", "t_device0", "t_device1", "t_done")
    for cut in range(2, 7):  # a request that stopped after `cut` boundaries
        port, jax = reqtrace.RequestPhases("rid-1"), jreqtrace.RequestPhases("rid-1")
        for name, value in zip(names[:cut], stamps[:cut]):
            setattr(port, name, value)
            setattr(jax, name, value)
        if cut < 6:
            port.t_done = jax.t_done = stamps[-1]
        assert port.phases_ms() == jax.phases_ms()
    assert reqtrace.REQUEST_ID_HEADER == jreqtrace.REQUEST_ID_HEADER
    assert reqtrace.DEBUG_KEY == jreqtrace.DEBUG_KEY


@pytest.mark.parametrize("headers,payload", [
    ({"X-RT1-Request-Id": "client-7"}, {"request_id": "body"}),
    ({}, {"request_id": "from-body"}),
    ({"X-RT1-Request-Id": "bad id\r\nInjected: 1"}, None),
    ({"X-RT1-Request-Id": "x" * 100}, None),
    ({"X-RT1-Request-Id": "ünïcode:ok.1-2_3"}, None),
    (None, {"request_id": 42}),
])
def test_request_id_from_agrees(headers, payload):
    got, want = reqtrace.request_id_from(headers, payload), jreqtrace.request_id_from(headers,
                                                                                    payload)
    if (headers or {}).get("X-RT1-Request-Id") or (payload or {}).get("request_id") not in (None, 42):
        assert got == want
    else:  # minted: both 16 hex characters
        assert len(got) == len(want) == 16 and int(got, 16) >= 0
