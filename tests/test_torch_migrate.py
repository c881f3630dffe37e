"""Session migration across the two packages (`rt1_tpu_torch/serve/migrate.py`
against `rt1_tpu/serve/migrate.py`), on `tiny`.

* `encode_state` / `decode_state` round trip every engine dtype, bf16 in a
  fresh interpreter where `ml_dtypes` (and with it numpy's "bfloat16") is
  blocked, as on the card's machine;
* a JAX engine's session, encoded by JAX, imports into the port's engine
  and the next actions match; the port's snapshot decodes with JAX's
  `decode_state`, into a JAX engine whose next actions match; bf16 leaves
  cross bit for bit;
* `check_compatibility` refuses each contract field, as JAX's does;
* `SnapshotRing` evicts the oldest past capacity and reports its age.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from rt1_tpu.serve import migrate as jmigrate
from rt1_tpu.serve.engine import PolicyEngine as JaxPolicyEngine
from rt1_tpu.train.configs import tiny as jax_tiny
from rt1_tpu.train.train import build_model as jax_build_model
from rt1_tpu_torch.configs import get_config
from rt1_tpu_torch.convert import load_flax_variables
from rt1_tpu_torch.eval.restore import build_policy, serving_engine
from rt1_tpu_torch.serve import migrate
from test_torch_rt1 import H, W, init_jax

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_round_trip_of_every_leaf_dtype():
    state = {
        "kv_cache": torch.randn(2, 2, 3, 4).to(torch.bfloat16),
        "context_image_tokens": torch.randn(3, 2, 16),
        "action_tokens": torch.arange(9, dtype=torch.int32).reshape(3, 3),
        "seq_idx": torch.tensor(2, dtype=torch.int32),
        "empty": torch.zeros((0, 4), dtype=torch.bfloat16),
    }
    encoded = migrate.encode_state(state)
    assert encoded["kv_cache"]["dtype"] == "bfloat16" and encoded["seq_idx"]["shape"] == []
    decoded = migrate.decode_state(encoded)
    for key, value in state.items():
        assert decoded[key].dtype == value.dtype and torch.equal(decoded[key], value), key
    # numpy arrays encode as JAX's encoder does.
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    assert migrate.encode_state({"a": arr}) == jmigrate.encode_state({"a": arr})
    with pytest.raises(migrate.SnapshotCompatibilityError, match="failed to decode"):
        migrate.decode_state({"a": {"shape": [4], "dtype": "float32", "b64": "AAAA"}})


_NO_ML_DTYPES = r"""
import sys


class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("ml_dtypes", "jax", "jaxlib"):
            raise ImportError("blocked: " + name)


sys.meta_path.insert(0, Blocker())
import numpy as np
import torch

from rt1_tpu_torch.serve import migrate

try:
    np.dtype("bfloat16")
    raise SystemExit("numpy knows bfloat16 without ml_dtypes")
except TypeError:
    pass
kv = torch.randn(2, 3, 4).to(torch.bfloat16)
back = migrate.decode_state(migrate.encode_state({"kv": kv}))["kv"]
assert back.dtype == torch.bfloat16 and torch.equal(back, kv)
assert "ml_dtypes" not in sys.modules
print("BF16 OK")
"""


def test_bf16_round_trip_without_ml_dtypes():
    proc = subprocess.run([sys.executable, "-c", _NO_ML_DTYPES], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0 and "BF16 OK" in proc.stdout, proc.stdout + proc.stderr


def _engines(cached, seed=51):
    jm = jax_build_model(jax_tiny.get_config().model)
    variables = init_jax(jm, jm.time_sequence_length, seed)
    pm = build_policy(get_config("tiny"))
    load_flax_variables(pm, variables["params"])
    port = serving_engine(pm, torch.float32, "cpu", cached_inference=cached, max_sessions=2,
                          buckets=[1, 2])
    jax_engine = JaxPolicyEngine(jm, variables, max_sessions=2, buckets=[1, 2],
                                 cached_inference=cached)
    return jax_engine, port


def _frames(n, seed=5):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal(512).astype(np.float32)
    return [{"image": rng.uniform(0, 1, (H, W, 3)).astype(np.float32),
             "natural_language_embedding": emb} for _ in range(n)]


@pytest.mark.parametrize("cached", [False, True])
def test_jax_snapshot_imports_into_the_port(cached):
    jax_engine, port = _engines(cached)
    frames = _frames(6)
    for frame in frames[:4]:  # past the window of 3: the window has rolled
        jax_engine.act("s", frame)
    snap = jax_engine.export_session("s")
    assert migrate._norm_schema(snap["schema"]) == migrate._norm_schema(port.state_schema())
    encoded = jmigrate.encode_state(snap["state"])
    port.import_session({"session_id": "s", "state": migrate.decode_state(encoded)}, "moved")
    for frame in frames[4:]:
        want = jax_engine.act("s", frame)
        got = port.act("moved", frame)
        np.testing.assert_array_equal(got["action_tokens"], want["action_tokens"])
        np.testing.assert_allclose(got["action"], want["action"], atol=1e-6, rtol=0)
        assert not got["session_started"]


@pytest.mark.parametrize("cached", [False, True])
def test_port_snapshot_decodes_with_jax(cached):
    jax_engine, port = _engines(cached, seed=52)
    frames = _frames(5, seed=6)
    for frame in frames[:3]:
        port.act("s", frame)
    encoded = migrate.encode_state(port.export_session("s")["state"])
    state = jmigrate.decode_state(encoded)
    assert sorted(state) == [k for k, _, _ in port.state_schema()]
    jax_engine.import_session({"session_id": "s", "state": state})
    for frame in frames[3:]:
        np.testing.assert_array_equal(port.act("s", frame)["action_tokens"],
                                      jax_engine.act("s", frame)["action_tokens"])


def test_bf16_cache_crosses_bit_for_bit():
    kv = torch.randn(2, 2, 15, 2, 8).to(torch.bfloat16)
    jax_kv = jmigrate.decode_state(migrate.encode_state({"kv_cache": kv}))["kv_cache"]
    assert str(jax_kv.dtype) == "bfloat16"
    np.testing.assert_array_equal(jax_kv.view(np.uint16), kv.view(torch.int16).numpy().view(np.uint16))
    back = migrate.decode_state(jmigrate.encode_state({"kv_cache": jax_kv}))["kv_cache"]
    assert torch.equal(back, kv)


def _snapshot(**overrides):
    snap = {"version": migrate.SNAPSHOT_VERSION, "session_id": "s", "checkpoint_generation": 4,
            "window": 3, "cached_inference": True, "schema": [["seq_idx", [], "int32"]],
            "state": {}}
    snap.update(overrides)
    return snap


@pytest.mark.parametrize("field,value", [
    ("version", 2), ("checkpoint_generation", 5), ("window", 6), ("cached_inference", False),
    ("schema", [["seq_idx", [1], "int32"]]), ("session_id", ""), ("state", None),
])
def test_check_compatibility_refuses_each_field(field, value):
    contract = dict(checkpoint_generation=4, window=3, cached_inference=True,
                    schema=[("seq_idx", (), "int32")])
    migrate.check_compatibility(_snapshot(), **contract)
    snap = _snapshot(**{field: value})
    with pytest.raises(migrate.SnapshotCompatibilityError) as port_err:
        migrate.check_compatibility(snap, **contract)
    with pytest.raises(jmigrate.SnapshotCompatibilityError) as jax_err:
        jmigrate.check_compatibility(snap, **contract)
    assert str(port_err.value) == str(jax_err.value)
    # A field the importer does not care about is not checked.
    if field in ("checkpoint_generation", "window", "cached_inference"):
        migrate.check_compatibility(snap, **dict(contract, **{field: None}))


def test_snapshot_ring_evicts_the_oldest_and_ages(tmp_path):
    ring = migrate.SnapshotRing(str(tmp_path), capacity=2)
    for i, sid in enumerate(("a", "b", "c")):
        path = ring.save(_snapshot(session_id=sid, saved_at=time.time() - 100 + i))
        os.utime(path, (1000 + i, 1000 + i))
    assert len(ring) == 2 and ring.evictions == 1 and ring.saves == 3
    assert ring.load("a") is None
    snap, age = ring.load("b")
    assert snap["session_id"] == "b" and 98 < age < 200
    ring.save(_snapshot(session_id="b"))  # a fresh write stamps saved_at now
    assert ring.load("b")[1] < 5
    ring.drop("b")
    assert ring.load("b") is None and len(ring) == 1
    # The JAX ring reads the port's files.
    assert jmigrate.SnapshotRing(str(tmp_path)).load("c")[0]["session_id"] == "c"
