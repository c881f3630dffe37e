"""The metrics plane's chaos proof against the JAX package's
(`scripts/obs_alerts_proof.py`), on the CPU with stub replicas.

* `python -m rt1_tpu_torch.obs.alerts_proof --stub`: `replica_kill@2`
  fires and resolves exactly the JAX script's `KILL_EXPECTED`,
  `canary_slo_breach@1` exactly its `CANARY_EXPECTED` with one rollback and
  a rolling burn that never crosses; an unarmed fleet exposes no ops
  surface; the record has the keys of the JAX script's committed record
  (`BENCH_obs_alerts.json`), which the run leaves untouched; the exit code
  is 0.
* `event_summary` equals the JAX script's `_event_summary` on one event
  list.
* Without `--stub` the proof boots real replicas on the card, and refuses
  on a machine without one.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from rt1_tpu_torch.obs import alerts_proof

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_obs_alerts_proof", os.path.join(REPO, "scripts", "obs_alerts_proof.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _keys(tree, prefix=""):
    """Dotted key paths of a record, one level into the phase records."""
    out = set()
    for key, value in tree.items():
        out.add(prefix + key)
        if isinstance(value, dict) and not prefix and key != "description":
            out |= {f"{key}.{k}" for k in value}
    return out


def test_stub_proof_reaches_the_jax_alert_sets(tmp_path):
    jax = _jax_script()
    out = str(tmp_path / "obs_alerts.json")
    bench = os.path.join(REPO, "BENCH_obs_alerts.json")
    with open(bench, "rb") as f:
        committed = f.read()
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "rt1_tpu_torch.obs.alerts_proof", "--stub", "--overhead_acts",
         "60", "--out", out], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with open(out) as f:
        record = json.load(f)
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == record
    kill, canary = record["replica_kill"], record["canary_breach"]
    assert set(kill["fired_alerts"]) == jax.KILL_EXPECTED and kill["passed"]
    assert all(e["resolved"] >= e["fired"] == 1 for e in kill["events"].values())
    assert kill["restarted_responses"] > 0 and kill["all_resolved"]
    assert set(kill["detection_latency_s"]) == jax.KILL_EXPECTED
    assert set(canary["fired_alerts"]) == jax.CANARY_EXPECTED and canary["passed"]
    assert canary["rollbacks_total"] == 1 and not canary["rolling_view_ever_crossed_threshold"]
    assert record["byte_identity"]["passed"]
    assert record["overhead"]["off"]["acts"] == record["overhead"]["on"]["acts"] == 60
    assert record["passed"]
    with open(bench) as f:
        assert _keys(record) == _keys(json.load(f))
    with open(bench, "rb") as f:
        assert f.read() == committed


def test_event_summary_matches_jax():
    jax = _jax_script()
    rng = np.random.default_rng(0)
    names = ["ReplicaDown", "SLOBurnRateFast", "CanarySLOBreach"]
    events = [{"alert": names[int(rng.integers(3))],
               "event": "firing" if rng.uniform() < 0.6 else "resolved",
               "t": float(1.7e9 + i * 0.25)} for i in range(40)]
    assert alerts_proof.event_summary(events) == jax._event_summary(events)
    assert alerts_proof.event_summary([]) == jax._event_summary([]) == {}


def test_real_replicas_default_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        alerts_proof.main(["--config", "tiny"])
