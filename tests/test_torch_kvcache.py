"""Cached incremental decode: the port's `RT1Policy.infer_step_cached`,
`rebuild_cache` and the cached engine, on `tiny` at float32.

* `infer_step_cached` against JAX's through window + 3 steps (the cache
  rolls three times): step logits within 1e-5 x max|logit|, tokens and the
  cache equal within the same bound; `rebuild_cache` likewise, and the
  cached step after it;
* one batch whose rows are at different phases (the port's per-row
  `seq_idx`) against per-row JAX runs;
* `infer_step_autoregressive` equals `infer_step`;
* the cached engine: fill agreement 1.0 with the windowed engine
  (`serve/parity.py`), a hot swap that rebuilds every live cache as JAX's
  engine does and keeps the next steps exact, `compile_count` pinned at
  the bucket count, and reset / LRU reuse starting exact windows again.
"""

import jax
import numpy as np
import pytest
import torch

from rt1_tpu.serve.engine import PolicyEngine as JaxPolicyEngine
from rt1_tpu.train.configs import tiny as jax_tiny
from rt1_tpu.train.train import build_model as jax_build_model
from rt1_tpu_torch.configs import get_config
from rt1_tpu_torch.convert import load_flax_variables, state_dict_from_flax
from rt1_tpu_torch.eval.restore import build_policy, serving_engine
from rt1_tpu_torch.serve.parity import PARITY_THRESHOLD, check_cached_parity
from test_torch_rt1 import H, W, init_jax

torch.set_num_threads(2)

TOL = 1e-5


def _pair(seed):
    jm = jax_build_model(jax_tiny.get_config().model)
    variables = init_jax(jm, jm.time_sequence_length, seed)
    pm = build_policy(get_config("tiny"))
    load_flax_variables(pm, variables["params"])
    return jm, variables, pm.eval()


def _obs(rng, b):
    return {"image": rng.uniform(0, 1, (b, H, W, 3)).astype(np.float32),
            "natural_language_embedding": rng.standard_normal((b, 512)).astype(np.float32)}


def _close(got, ref, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=TOL * max(np.abs(ref).max(), 1e-30),
                               err_msg=what)


def test_infer_step_cached_matches_jax_through_the_roll():
    jm, variables, pm = _pair(seed=41)
    b, rng = 2, np.random.default_rng(0)
    jstep = jax.jit(lambda v, o, s: jm.apply(v, o, s, method=jm.infer_step_cached))
    jstate, pstate = jm.initial_state(b, cached=True), pm.initial_state(b, cached=True)
    assert pstate["kv_cache"].shape == jstate["kv_cache"].shape
    for step in range(jm.time_sequence_length + 3):
        obs = _obs(rng, b)
        jout, jstate = jstep(variables, obs, jstate)
        with torch.no_grad():
            pout, pstate = pm.infer_step_cached({k: torch.from_numpy(v) for k, v in obs.items()},
                                                pstate)
        _close(pout["action_logits"], jout["action_logits"], f"logits, step {step}")
        np.testing.assert_array_equal(pout["action_tokens"], np.asarray(jout["action_tokens"]))
        _close(pstate["kv_cache"], jstate["kv_cache"], f"cache, step {step}")
        np.testing.assert_array_equal(pstate["seq_idx"], np.full((b,), int(jstate["seq_idx"])))
    # Rebuild, then one more cached step on the rebuilt cache.
    jstate = jm.apply(variables, jstate, method=jm.rebuild_cache)
    with torch.no_grad():
        pstate = pm.rebuild_cache(pstate)
    _close(pstate["kv_cache"], jstate["kv_cache"], "rebuilt cache")
    obs = _obs(rng, b)
    jout, _ = jstep(variables, obs, jstate)
    with torch.no_grad():
        pout, _ = pm.infer_step_cached({k: torch.from_numpy(v) for k, v in obs.items()}, pstate)
    _close(pout["action_logits"], jout["action_logits"], "logits after the rebuild")


def test_staggered_rows_match_per_row_jax():
    """Row 0 starts two steps before row 1, so the batch mixes phases, and
    row 0's window rolls while row 1's still fills."""
    jm, variables, pm = _pair(seed=42)
    rng = np.random.default_rng(1)
    jstep = jax.jit(lambda v, o, s: jm.apply(v, o, s, method=jm.infer_step_cached))
    jstates = [jm.initial_state(1, cached=True) for _ in range(2)]
    pstate = pm.initial_state(2, cached=True)
    for step in range(jm.time_sequence_length + 3):
        obs = _obs(rng, 2)
        with torch.no_grad():
            pout, new = pm.infer_step_cached({k: torch.from_numpy(v) for k, v in obs.items()},
                                             pstate)
        active = [0] if step < 2 else [0, 1]
        for row in active:
            jout, jstates[row] = jstep(variables, {k: v[row:row + 1] for k, v in obs.items()},
                                       jstates[row])
            _close(pout["action_logits"][row:row + 1], jout["action_logits"], f"row {row} step {step}")
            np.testing.assert_array_equal(pout["action_tokens"][row:row + 1],
                                          np.asarray(jout["action_tokens"]))
        # Row 1 waits: its old state is kept, as the engine's padding gate does.
        keep = torch.tensor([True, step >= 2])
        pstate = {k: torch.where(keep.view((-1,) + (1,) * (v.dim() - 1)), v, pstate[k])
                  for k, v in new.items()}
    for row in range(2):
        _close(pstate["kv_cache"][row:row + 1], jstates[row]["kv_cache"], f"row {row} cache")


def test_autoregressive_equals_single_pass():
    _, _, pm = _pair(seed=43)
    rng = np.random.default_rng(2)
    a = b = pm.initial_state(2)
    for _ in range(pm.time_sequence_length + 2):
        obs = {k: torch.from_numpy(v) for k, v in _obs(rng, 2).items()}
        with torch.no_grad():
            out_a, a = pm.infer_step(obs, a)
            out_b, b = pm.infer_step_autoregressive(obs, b)
        assert torch.equal(out_a["action_tokens"], out_b["action_tokens"])
        torch.testing.assert_close(out_b["action_logits"], out_a["action_logits"], rtol=0, atol=1e-6)
        assert all(torch.equal(a[k], b[k]) for k in a)


def _engines(seed, max_sessions=4):
    jm, variables, pm = _pair(seed)
    state = pm.state_dict()
    engines = {}
    for cached in (False, True):
        pm = build_policy(get_config("tiny"))
        pm.load_state_dict(state)
        engines[cached] = serving_engine(pm, torch.float32, "cpu", cached_inference=cached,
                                         max_sessions=max_sessions, buckets=[1, 2, max_sessions])
    return jm, variables, engines


def test_engine_fill_agreement_is_exact():
    _, _, engines = _engines(seed=44)
    stats = check_cached_parity(engines[False], engines[True], (H, W, 3), steady_steps=3)
    assert stats["passed"] and stats["agreement"] == 1.0 >= PARITY_THRESHOLD
    assert 0.0 <= stats["steady_agreement"] <= 1.0 and stats["steady_steps"] > 0
    assert engines[True].cache_cached_steps > 0 and engines[False].cache_cached_steps == 0


def test_hot_swap_rebuilds_every_cache_as_jax_does():
    jm, variables, engines = _engines(seed=45)
    engine = engines[True]
    jax_engine = JaxPolicyEngine(jm, variables, max_sessions=4, buckets=[1, 2, 4],
                                 cached_inference=True)
    new_vars = init_jax(jm, jm.time_sequence_length, seed=46)
    new_state = state_dict_from_flax(new_vars["params"])
    rng = np.random.default_rng(3)
    frames = [{k: v[0] for k, v in _obs(rng, 1).items()} for _ in range(8)]
    # Session a fills its window, b is one step in: one full, one filling.
    for i in range(jm.time_sequence_length):
        for e in (engine, engines[False], jax_engine):
            e.act("a", frames[i])
    for e in (engine, engines[False], jax_engine):
        e.act("b", frames[3])
    info = engine.swap_variables({k: new_state[k] for k in engine.policy.state_dict()})
    jinfo = jax_engine.swap_variables(new_vars)
    engines[False].swap_variables({k: new_state[k] for k in engines[False].policy.state_dict()})
    assert info["caches_rebuilt"] == jinfo["caches_rebuilt"] == 2 == engine.active_sessions
    assert engine.cache_invalidations == {"swap": 1, "reset": 0, "evict": 0}
    assert engine.cache_rebuild_steps == 2 and engine.reloads == 1
    for sid in ("a", "b"):
        _close(engine.session_state(sid)["kv_cache"], jax_engine.session_state(sid)["kv_cache"],
               f"{sid} rebuilt cache")
    # b's window still fills: its cached steps stay exact under the new weights.
    for i in (4, 5):
        ref = engines[False].act("b", frames[i])
        got = engine.act("b", frames[i])
        np.testing.assert_array_equal(got["action_tokens"], ref["action_tokens"])
        np.testing.assert_array_equal(got["action_tokens"], jax_engine.act("b", frames[i])["action_tokens"])
    assert engine.compile_count == len(engine.buckets) == 3
    assert engine.steps_total == len(engine.buckets) + jm.time_sequence_length + 3


def test_swap_refuses_a_precast_or_corrupt_standby():
    _, _, engines = _engines(seed=47)
    engine = engines[True]
    engine.warmup((H, W, 3))
    master = {k: v.clone() for k, v in engine.policy.state_dict().items()}
    with pytest.raises(ValueError, match="f32 master"):
        engine.swap_variables({k: v.to(torch.bfloat16) for k, v in master.items()})
    master["transformer.output_tokens.bias"][0] = float("nan")
    with pytest.raises(ValueError, match="non-finite"):
        engine.swap_variables(master)
    assert engine.reloads == 0 and engine.compile_count == 3


def test_reset_and_lru_reuse_restart_exact_windows():
    _, _, engines = _engines(seed=48, max_sessions=2)
    cached, windowed = engines[True], engines[False]
    rng = np.random.default_rng(4)
    frames = [{k: v[0] for k, v in _obs(rng, 1).items()} for _ in range(12)]
    for sid, frame in (("a", 0), ("a", 1), ("b", 2), ("c", 3)):  # c evicts a
        for e in (cached, windowed):
            e.act(sid, frames[frame])
    assert cached.cache_invalidations["evict"] == 1 and cached.evictions == 1
    cached.reset("b")
    windowed.reset("b")
    assert cached.cache_invalidations["reset"] == 1
    for sid, frame in (("a", 4), ("b", 5), ("a", 6), ("b", 7), ("a", 8), ("b", 9)):
        got, ref = cached.act(sid, frames[frame]), windowed.act(sid, frames[frame])
        np.testing.assert_array_equal(got["action_tokens"], ref["action_tokens"], err_msg=sid)
        assert got["session_started"] == ref["session_started"]
