"""The trainer's observability in the port against the JAX package's.

* `GoodputLedger`: the same scripted run (phases, steps, replays,
  checkpoint I/O, a rollback, a preemption, the MFU gauge) on an injected
  clock gives the same summary and scalars, dict for dict.
* `StepTimeline`: the same steps under one fake clock give the same
  records and rolling scalars.
* `FlightRecorder`: the port's dump reads back through JAX's `read_dump`
  with the records and header JAX's own dump has; `dump_on_exception`.
* `render_scalar_gauges`: byte for byte.
* `ObsOptions` from `language_table`, `tiny` and the learning proof's
  config, with and without a workdir.
* The health pack on the tiny RT-1 (same weights through
  `load_flax_variables`, same batch, float32, dropout and the crop off):
  one JAX step with `model_health=True` and one port step give the same
  names in the same order; every value within 1e-5 relative (gradient
  norms, update ratios, global norms, entropy), token accuracy exactly
  (the predictions agree). With the pack off the port's step is the
  pack-on step without the pack, bit for bit.
* Per-task telemetry: the feeder's `emit_task_ids` stream and task names
  equal JAX's, and the pack's per-task block equals JAX's `compute_pack`
  on the same step outputs.
* FLOPs: `obs/flops.py`'s count of the tiny train step equals an analytic
  count of its matmuls and convolutions (printed beside JAX's lowered
  cost-analysis figure, which also counts elementwise work).
"""

import dataclasses
import json
import math
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt1_tpu import obs as jobs
from rt1_tpu.data import feeder as jax_feeder
from rt1_tpu.data import pack as jax_pack
from rt1_tpu.obs import goodput as jgoodput
from rt1_tpu.obs import health as jhealth
from rt1_tpu.obs import prometheus as jprom
from rt1_tpu.obs import recorder as jrecorder
from rt1_tpu.obs import steps as jsteps
from rt1_tpu.parallel import MeshConfig, make_mesh
from rt1_tpu.train.configs import language_table as jax_language_table
from rt1_tpu.train.configs import tiny as jax_tiny
from rt1_tpu.train.proof_config import proof_train_config as jax_proof_config
from rt1_tpu.trainer import make_optimizer, make_train_step_fns
from rt1_tpu.trainer.state import TrainState as JaxTrainState
from rt1_tpu_torch import obs as pobs
from rt1_tpu_torch.configs import get_config
from rt1_tpu_torch.data import pack
from rt1_tpu_torch.data.feeder import SampleAheadFeeder
from rt1_tpu_torch.obs import flops as pflops
from rt1_tpu_torch.obs import goodput as pgoodput
from rt1_tpu_torch.obs import health as phealth
from rt1_tpu_torch.obs import prometheus as pprom
from rt1_tpu_torch.obs import recorder as precorder
from rt1_tpu_torch.obs import steps as psteps
from rt1_tpu_torch.train.proof_config import proof_train_config
from rt1_tpu_torch.trainer.optim import Adam
from rt1_tpu_torch.trainer.state import create_train_state
from rt1_tpu_torch.trainer.train import TrainStepFns
from test_torch_data_feeder import WINDOW, packed  # noqa: F401 - the corpus fixture
from test_torch_train_policy import batch, tiny_pair, to_torch

torch.set_num_threads(2)

LR = 1e-3


# ------------------------------------------------------------------ goodput


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t

    def tick(self, s):
        self.t += s


def _ledger_story(mod, seed, peak):
    rng = np.random.default_rng(seed)
    clock = _Clock()
    ledger = mod.GoodputLedger(clock=clock)
    out = []
    ledger.open_phase("init")
    clock.tick(rng.uniform(1, 5))
    ledger.note_io("ckpt_restore", rng.uniform(0.1, 1))
    ledger.note_io("weird_kind", 0.05)
    out.append(ledger.summary())
    ledger.close_phase()
    ledger.set_flops_per_step(rng.uniform(1e11, 1e12), peak_flops=peak)
    for i in range(12):
        total = rng.uniform(50, 200)
        record = {"total_ms": total, "wait_data_ms": rng.uniform(0, 10),
                  "h2d_ms": rng.uniform(0, 5)}
        clock.tick(total / 1e3 + rng.uniform(0, 0.01))
        ledger.note_step(record, replay=4 <= i < 6)
        if i == 5:
            ledger.mark_rollback()
        if i == 8:
            with ledger.phase("preempt_drain"):
                clock.tick(0.3)
                ledger.note_io("ckpt_save", 0.2)
            ledger.mark_preempted()
        out.append(ledger.scalars())
    out.append((ledger.summary(), ledger.mfu_pct(), ledger.wall_s()))
    with pytest.raises(ValueError):
        ledger.open_phase("nope")
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_goodput_ledger_summaries_equal_jax(seed):
    assert _ledger_story(jgoodput, seed, 2e14) == _ledger_story(pgoodput, seed, 2e14)
    assert jgoodput.BUCKETS == pgoodput.BUCKETS
    assert jgoodput.SUMMARY_BASENAME == pgoodput.SUMMARY_BASENAME


def test_goodput_summary_file_reads_back_through_jax(tmp_path):
    clock = _Clock()
    ledger = pgoodput.GoodputLedger(clock=clock)
    ledger.note_step({"total_ms": 900.0})
    clock.tick(1.0)
    ledger.note_step({"total_ms": 100.0, "wait_data_ms": 10.0})
    ledger.set_flops_per_step(1e12)
    clock.tick(0.2)
    path = ledger.write_summary(str(tmp_path / pgoodput.SUMMARY_BASENAME))
    summary = jgoodput.read_summary(path)
    assert summary == json.loads(json.dumps(ledger.summary()))
    assert sum(summary["fractions"].values()) == pytest.approx(1.0, abs=1e-12)
    # The port's MFU peak is the H100's bf16 989 TFLOP/s.
    assert summary["mfu_pct"] == pytest.approx(1e12 / 0.09 / 989e12 * 100)


# ----------------------------------------------------------------- timeline


def _timeline_story(mod, monkeypatch, window, sync):
    ticks = iter(np.random.default_rng(5).uniform(1e-4, 3e-3, 10_000).cumsum())
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))
    tl = mod.StepTimeline(window=window, sync=sync)
    source = tl.timed(iter(range(100)))
    next(source)  # a pull before the first step: credited to step 0
    records = []
    for step in range(9):
        tl.start_step(step)
        with tl.phase("h2d", exclusive_of="wait_data"):
            next(source)
        with tl.phase("device_step"):
            pass
        records.append(tl.end_step(sync_on=None))
        if step == 4:
            with tl.phase("host"):  # between steps: folds into the next
                pass
    out = records, tl.scalars(), tl.stall_pct, tl.last()
    monkeypatch.undo()
    return out


@pytest.mark.parametrize("window", [1, 4, 50])
def test_step_timeline_records_and_scalars_equal_jax(monkeypatch, window):
    assert _timeline_story(jsteps, monkeypatch, window, False) == \
        _timeline_story(psteps, monkeypatch, window, False)
    assert jsteps.BUCKETS == psteps.BUCKETS
    with pytest.raises(RuntimeError):
        psteps.StepTimeline().end_step()


# ----------------------------------------------------------------- recorder


def _dump(mod, path):
    rec = mod.FlightRecorder(capacity=3, path=path)
    for step in range(5):
        rec.record(step, loss=np.float32(step / 2), feeder={"queue_depth": np.int64(step)},
                   health=None, tag=("a", 1))
    with pytest.raises(KeyError):
        with rec.dump_on_exception():
            raise KeyError("boom")
    return jrecorder.read_dump(path)


def test_flight_recorder_dump_reads_back_like_jax(tmp_path):
    j = _dump(jrecorder, str(tmp_path / "jax.jsonl"))
    p = _dump(precorder, str(tmp_path / "port.jsonl"))
    assert [r["step"] for r in p["records"]] == [2, 3, 4]
    strip = lambda recs: [{k: v for k, v in r.items() if k != "t"} for r in recs]  # noqa: E731
    assert strip(p["records"]) == strip(j["records"])
    ignore = ("dumped_at", "memory_stats")
    assert {k: v for k, v in p["header"].items() if k not in ignore} == \
        {k: v for k, v in j["header"].items() if k not in ignore} | {"reason": "exception:KeyError"}
    assert p["header"]["memory_stats"] == {}  # no card touched


def test_flight_recorder_sigterm_dump_chains_to_previous_handler(tmp_path):
    import os
    import signal

    seen = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    try:
        rec = precorder.FlightRecorder(path=str(tmp_path / "fr.jsonl"))
        rec.record(1, loss=0.5)
        assert rec.install_sigterm(extra=lambda: seen.append("extra"))
        os.kill(os.getpid(), signal.SIGTERM)
        rec.uninstall_sigterm()
        assert seen == ["extra", signal.SIGTERM]
        assert jrecorder.read_dump(str(tmp_path / "fr.jsonl"))["header"]["reason"] == "SIGTERM"
    finally:
        signal.signal(signal.SIGTERM, prev)


# ---------------------------------------------------------------- prometheus


def test_render_scalar_gauges_byte_equal_jax():
    rng = np.random.default_rng(0)
    scalars = {"loss": 0.25, "timing/wait_data_ms": 1.5, "step": 7, "flag": True,
               "name": "text", "health/grad_norm/transformer/layer_0": float(rng.random()),
               "goodput/mfu_pct": 1e-7, "bad": float("nan"), "big": float("inf"),
               "feeder/assembled_w0": 12, "guard/checks_total": 3.0}
    for prefix in ("rt1_train_", "rt1_flywheel_"):
        text = pprom.render_scalar_gauges(scalars, prefix=prefix)
        assert text == jprom.render_scalar_gauges(scalars, prefix=prefix)
    parsed = pprom.parse_exposition(pprom.render_scalar_gauges(scalars))
    assert parsed.types["rt1_train_health_grad_norm_transformer_layer_0"] == "gauge"
    assert "rt1_train_flag" not in parsed.types and "rt1_train_name" not in parsed.types


# ------------------------------------------------------------------ options


@pytest.mark.parametrize("workdir", [None, "/tmp/run"])
@pytest.mark.parametrize("name", ["language_table", "tiny", "proof"])
def test_obs_options_equal_jax(name, workdir):
    jcfg, pcfg = {
        "language_table": (jax_language_table.get_config(), get_config("language_table")),
        "tiny": (jax_tiny.get_config(), get_config("tiny")),
        "proof": (jax_proof_config("/data", 2000), proof_train_config("/data", 2000)),
    }[name]
    assert dataclasses.asdict(jobs.ObsOptions.from_config(jcfg, workdir)) == \
        dataclasses.asdict(pobs.ObsOptions.from_config(pcfg, workdir))
    assert sorted(jcfg.obs.to_dict()) == sorted(vars(pcfg.obs))


# -------------------------------------------------------------- health pack


def _jax_health_step(jm, variables, jbatch, task_names=()):
    tx = make_optimizer(learning_rate=LR)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                          batch_stats={}, opt_state=tx.init(variables["params"]), tx=tx)
    fns = make_train_step_fns(jm, make_mesh(MeshConfig()), state, model_health=True,
                              donate=False, health_task_names=task_names)
    state = fns.shard_state(state)
    new_state, metrics = fns.train_step(state, fns.shard_batch(jbatch), jax.random.PRNGKey(0))
    return fns.health_names, metrics, new_state


def _port_step(pm, tbatch, **kwargs):
    optimizer = Adam(learning_rate=LR)
    state = create_train_state(pm, optimizer)
    fns = TrainStepFns(optimizer, seed=0, **kwargs)
    metrics = fns.train_step(state, tbatch, 0)
    return fns, state, metrics


def test_health_pack_matches_jax_step():
    jm, pm, variables = tiny_pair(61)
    obs, actions = batch(62, b=8)
    names, jmetrics, _ = _jax_health_step(jm, variables, (obs, actions))
    fns, state, metrics = _port_step(pm, (to_torch(obs), to_torch(actions)), model_health=True)
    assert fns.health_names(state) == tuple(names)
    assert any(n.startswith("health/grad_norm/transformer/layer_") for n in names)
    ref = jhealth.unpack(names, np.asarray(jmetrics[jhealth.PACK_KEY]))
    got = phealth.unpack(names, metrics[phealth.PACK_KEY])
    for name in names:
        if name.startswith("health/token_acc/"):
            assert got[name] == ref[name], name
        else:
            np.testing.assert_allclose(got[name], ref[name], rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]), rtol=1e-5)


def test_health_off_step_is_the_pack_on_step_without_the_pack():
    results = []
    for health in (True, False):
        _, pm, _ = tiny_pair(71)
        obs, actions = batch(72, b=4)
        fns, state, metrics = _port_step(pm, (to_torch(obs), to_torch(actions)),
                                         model_health=health, guard_nonfinite=True)
        results.append((state, metrics))
    (on, m_on), (off, m_off) = results
    assert set(m_on) - set(m_off) == {phealth.PACK_KEY}
    assert sorted(m_off) == ["action_loss_mean", "grad_norm", "guard_skips_cum", "loss"]
    for key in m_off:
        assert torch.equal(m_on[key], m_off[key]), key
    for a, b in ((on.flat, off.flat), (on.flat_buffers, off.flat_buffers),
                 (on.opt_state.mu, off.opt_state.mu), (on.opt_state.nu, off.opt_state.nu),
                 (on.step, off.step)):
        assert torch.equal(a, b)


def test_task_ids_stream_and_per_task_pack_equal_jax(packed):  # noqa: F811
    ours = pack.PackedEpisodeCache(packed, window=WINDOW)
    theirs = jax_pack.PackedEpisodeCache(packed, window=WINDOW)
    with SampleAheadFeeder(ours, 4, seed=3, emit_task_ids=True, num_threads=2) as a, \
            jax_feeder.SampleAheadFeeder(theirs, 4, seed=3, emit_task_ids=True) as b:
        assert a.health_task_names == b.health_task_names == ("block2block", "separate",
                                                               "other")
        pairs = [(next(a), next(b)) for _ in range(4)]
        assert sorted(a.stats()) == sorted(b.stats())
    for x, y in pairs:
        np.testing.assert_array_equal(x["observations"][phealth.TASK_ID_KEY],
                                      y["observations"][jhealth.TASK_ID_KEY])
        assert x["observations"][phealth.TASK_ID_KEY].dtype == np.int32
    task_ids = np.concatenate([x["observations"]["task_id"] for x, _ in pairs[:2]])
    # The per-task block of one step: the port's step (task ids stripped
    # before the model) against JAX's compute_pack on the same outputs.
    names = a.health_task_names
    _, pm, _ = tiny_pair(81)
    obs, actions = batch(82, b=8)
    tobs = dict(to_torch(obs), task_id=torch.from_numpy(task_ids))
    fns, state, metrics = _port_step(pm, (tobs, to_torch(actions)), model_health=True,
                                     health_task_names=names)
    got = phealth.unpack(fns.health_names(state), metrics[phealth.PACK_KEY])
    _, _, out = TrainStepFns(Adam(), seed=0).value_and_grad(
        create_train_state(tiny_pair(81)[1], Adam()), (to_torch(obs), to_torch(actions)), 0)
    jout = {k: np.asarray(out[k].detach()) for k in ("action_logits", "action_predictions",
                                                     "action_labels", "action_loss")}
    jout["task_ids"] = task_ids
    tree = {"a": np.ones(3, np.float32)}
    ref_vec = jhealth.compute_pack(tree, tree, tree, jout, depth=1, action_dims=3,
                                   task_names=names)
    ref = jhealth.unpack(jhealth.pack_names(tree, 1, 3, task_names=names), ref_vec)
    for name, value in ref.items():
        if "/task_" in name:
            np.testing.assert_allclose(got[name], value, rtol=1e-6, atol=1e-7, err_msg=name)
    fracs = [got[f"health/task_frac/{t}"] for t in names]
    assert sum(fracs) == pytest.approx(1.0)


# -------------------------------------------------------------------- flops


def _analytic_flops(pm, tbatch, config):
    """Multiply-adds x 2 of every Linear and Conv2d call (from forward hooks)
    and of the two attention products a layer, forward and backward: a
    weight's gradient repeats the forward's work, and so does the input's
    gradient where the input needs one (the image and the instruction do
    not); both operands of an attention product need theirs."""
    total = [0]

    def hook(module, args, output):
        x = args[0]
        if isinstance(module, torch.nn.Conv2d):
            n, c_out, h, w = output.shape
            fwd = 2 * n * h * w * c_out * (module.in_channels // module.groups) * \
                math.prod(module.kernel_size)
        else:
            fwd = 2 * (x.numel() // module.in_features) * module.in_features * module.out_features
        total[0] += fwd * (2 + int(x.requires_grad))

    handles = [m.register_forward_hook(hook) for m in pm.modules()
               if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d))]
    try:
        fns = TrainStepFns(Adam(), seed=0)
        fns.value_and_grad(create_train_state(pm, Adam()), tbatch, 0)
    finally:
        for h in handles:
            h.remove()
    m = config.model
    b = tbatch[0]["image"].shape[0]
    s = m.time_sequence_length * (m.num_image_tokens + pm.tokens_per_action)
    attention = 2 * b * m.num_heads * s * s * m.layer_size
    return total[0] + m.num_layers * 2 * attention * 3


def test_step_flops_equal_an_analytic_count(capsys):
    jm, pm, variables = tiny_pair(91)
    obs, actions = batch(92, b=8)
    tbatch = (to_torch(obs), to_torch(actions))
    config = get_config("tiny")
    optimizer = Adam()
    fns = TrainStepFns(optimizer, seed=0, guard_nonfinite=True)
    state = create_train_state(pm, optimizer)
    counted, raw = pflops.step_flops(lambda: fns.train_step(state, tbatch, 0))
    _, pm2, _ = tiny_pair(91)
    assert counted == _analytic_flops(pm2, tbatch, config)
    # No grouped convolution in tiny: FlopCounterMode's own formula agrees.
    assert raw == counted
    assert pflops.train_step_flops(lambda: fns.value_and_grad(state, tbatch, 1)) == counted
    # JAX's lowered cost analysis of the same step, for the record: it also
    # counts elementwise work, so it is larger, not equal.
    tx = make_optimizer(learning_rate=LR)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats={}, opt_state=tx.init(variables["params"]), tx=tx)
    jfns = make_train_step_fns(jm, make_mesh(MeshConfig()), jstate, donate=False)
    xla = jobs.flops.train_step_flops(jfns.train_step, jfns.shard_state(jstate),
                                      jfns.shard_batch((obs, actions)), jax.random.PRNGKey(0))
    assert xla > counted
    with capsys.disabled():
        print(f"\ntiny train step (batch 8): port FlopCounterMode {counted:.0f} FLOPs, "
              f"JAX lowered cost analysis {xla:.0f}")
    assert pflops.mfu_pct(counted, 0.5, peak_flops=1e12) == \
        jobs.flops.mfu_pct(counted, 0.5, peak_flops=1e12)
    assert pflops.mfu_detail(counted, 0.5) == {
        "flops_per_step": float(counted), "sec_per_step": 0.5, "peak_flops_assumed": 989e12,
        "mfu_pct": round(counted / 0.5 / 989e12 * 100, 3)}
