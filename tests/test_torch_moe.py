"""The Switch-MoE decoder FFN and remat of the port against the JAX package.

* `MoEFeedForward` in float32 at (2, 15, 32), E = 4, capacity factors 2.0
  and 0.5 (tokens drop at 0.5): outputs within 1e-5, the aux loss within
  1e-6, each token's expert equal and the dropped tokens the same ones.
* `tiny` with `ffn_impl=moe` (dropout and the crop off): the train loss
  with the weighted aux loss and every gradient against JAX's `_loss_fn`
  (loss rtol 1e-5, gradients atol 1e-5 of the largest), `moe_aux_loss`
  within 1e-6; `infer_step` and `infer_step_cached` over the window and
  two rolls (logits within 1e-5 x max|logit|, tokens equal); the int8
  serving tree of `quantize_tree` equal to JAX's bit for bit, and the
  int8 `infer_step` within 1e-5 x max|logit| of JAX's int8 step.
* Each MoE serving mode (int8, cached) of the port against JAX's engine of
  that mode: token agreement 1.0; and the JAX gate's pair (int8 against
  f32, cached against windowed) reads the same agreement on both packages.
* The routers (`moe.Router`) stay float32: a float cast of the policy
  leaves them exact; the f32 and int8 serving trees keep them exact and
  the bf16 one rounds them to bfloat16 (as JAX's cast tree), all held at
  float32, and a bf16 engine takes a hot swap of the master.
* The serving engine routes each session on its own: at capacity factor
  1.0 (so that tokens drop) three sessions in a bucket of four (one padding
  lane) give each session JAX's batch-1 step (the JAX engine vmaps one),
  and the same as each session alone.
* Remat (`ops/remat.py`): the decoder and the EfficientNet tower with
  dropout, stochastic depth and the crop on give the same loss, the same
  gradients and the same BatchNorm statistics with and without it, bit for
  bit on the CPU; the `tiny` MoE loss with remat equals JAX's remat run
  (dropout off; rtol 1e-5).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt1_tpu.models.moe import MoEFeedForward as JaxMoE
from rt1_tpu.models import quant as jquant
from rt1_tpu.models.quant import quantize_tree as jax_quantize_tree
from rt1_tpu.serve import parity as jparity
from rt1_tpu.serve.engine import PolicyEngine as JaxPolicyEngine
from rt1_tpu.trainer.train import _loss_fn
from rt1_tpu_torch.configs import apply_override, get_config
from rt1_tpu_torch.convert import flax_paths, load_flax_variables, state_dict_from_flax
from rt1_tpu_torch.eval.restore import build_policy, master_policy, serving_engine
from rt1_tpu_torch.models.moe import MoEFeedForward, router_names
from rt1_tpu_torch.models.quant import quantize_tree
from rt1_tpu_torch.serve.engine import PolicyEngine
from rt1_tpu_torch.trainer.optim import Adam
from rt1_tpu_torch.trainer.state import create_train_state
from rt1_tpu_torch.trainer.train import TrainStepFns, step_rngs
from rt1_tpu_torch.train.train import build_model
from test_torch_rt1 import H, W
from test_torch_train_policy import batch, tiny_pair, to_torch

torch.set_num_threads(2)

TOL = 1e-5


def _port_moe(jvars, cf):
    p = jvars["params"]
    m = MoEFeedForward(32, num_experts=4, capacity_factor=cf)
    with torch.no_grad():
        m.gate.weight.copy_(torch.tensor(np.asarray(p["gate"]["kernel"]).T))
        m.wi.copy_(torch.tensor(np.asarray(p["wi"])))
        m.wo.copy_(torch.tensor(np.asarray(p["wo"])))
    return m


@pytest.mark.parametrize("cf", [2.0, 0.5])
def test_moe_ffn_matches_jax(cf):
    x = np.random.default_rng(0).standard_normal((2, 15, 32)).astype(np.float32)
    jm = JaxMoE(d_model=32, num_experts=4, capacity_factor=cf)
    jvars = jm.init(jax.random.PRNGKey(3), x)
    jout, jaux = jm.apply(jvars, x)
    m = _port_moe(jvars, cf)
    with torch.no_grad():
        out, aux = m(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL, rtol=0)
    np.testing.assert_allclose(aux.item(), float(jaux), atol=1e-6, rtol=0)
    tokens = x.reshape(-1, 32)
    jexpert = np.argmax(tokens @ np.asarray(jvars["params"]["gate"]["kernel"]), axis=-1)
    pexpert = torch.argmax(m.gate(torch.from_numpy(tokens)), dim=-1).numpy()
    np.testing.assert_array_equal(pexpert, jexpert)
    dropped = np.abs(out.numpy().reshape(-1, 32)).sum(-1) == 0
    np.testing.assert_array_equal(dropped, np.abs(np.asarray(jout).reshape(-1, 32)).sum(-1) == 0)
    capacity = int(cf * 30 / 4) or 1
    assert dropped.sum() == sum(max(0, int((pexpert == e).sum()) - capacity) for e in range(4))
    assert dropped.any() == (cf == 0.5)


def _moe_pair(seed, **overrides):
    return tiny_pair(seed, ffn_impl="moe", **overrides)


def test_moe_train_loss_and_grads_match_jax():
    jm, pm, variables = _moe_pair(61)
    obs, actions = batch(62)
    params = variables["params"]

    def loss(p):
        return _loss_fn(jm, p, {}, (obs, actions), jax.random.PRNGKey(0), True)

    (jloss, (jout, _)), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    state = create_train_state(pm, Adam())
    fns = TrainStepFns(Adam(), seed=0)
    ploss, grad, out = fns.value_and_grad(state, (to_torch(obs), to_torch(actions)), 0)
    np.testing.assert_allclose(ploss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(out["moe_aux_loss"].item(), float(jout["moe_aux_loss"]), atol=1e-6)
    ref = state_dict_from_flax(jax.device_get(jgrads))
    scale = max(float(g.abs().max()) for g in ref.values())
    grads = fns.grads_by_name(state, grad)
    assert set(grads) == set(ref)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), atol=1e-5 * scale, rtol=0,
                                   err_msg=name)
    assert float(grads["transformer.layer_0.moe.gate.weight"].abs().max()) > 0
    # The eval loss is the task loss alone.
    jeval, _ = _loss_fn(jm, params, {}, (obs, actions), jax.random.PRNGKey(0), False)
    np.testing.assert_allclose(fns.eval_step(state, (to_torch(obs), to_torch(actions)))["loss"]
                               .item(), float(jeval), rtol=1e-5)


def _close(got, ref, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=TOL * max(np.abs(ref).max(), 1e-30), err_msg=what)


def _obs(rng, b):
    return {"image": rng.uniform(0, 1, (b, H, W, 3)).astype(np.float32),
            "natural_language_embedding": rng.standard_normal((b, 512)).astype(np.float32)}


@pytest.mark.parametrize("cached", [False, True], ids=["infer_step", "infer_step_cached"])
def test_moe_infer_steps_match_jax(cached):
    jm, pm, variables = _moe_pair(63)
    pm.eval()
    method = jm.infer_step_cached if cached else jm.infer_step
    jstep = jax.jit(lambda v, o, s: jm.apply(v, o, s, method=method))
    pstep = pm.infer_step_cached if cached else pm.infer_step
    b, rng = 2, np.random.default_rng(4)
    jstate, pstate = jm.initial_state(b, cached=cached), pm.initial_state(b, cached=cached)
    for step in range(jm.time_sequence_length + 2):
        obs = _obs(rng, b)
        jout, jstate = jstep(variables, obs, jstate)
        with torch.no_grad():
            pout, pstate = pstep(to_torch(obs), pstate)
        _close(pout["action_logits"], jout["action_logits"], f"step {step}")
        np.testing.assert_array_equal(pout["action_tokens"], np.asarray(jout["action_tokens"]))


def test_moe_int8_tree_and_step_match_jax():
    jm, pm, variables = _moe_pair(64)
    jtree = jax_quantize_tree({"params": variables["params"]})
    want = state_dict_from_flax(jtree["params"], None, jtree["quant"])
    got = quantize_tree(pm.state_dict(), flax_paths(pm))
    assert set(got) == set(want)
    for key in got:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key
    assert got["transformer.layer_1.moe.wi"].dtype == torch.int8
    assert got["transformer.layer_1.moe.wi_scale"].shape == (16,)
    assert got["transformer.layer_1.moe.gate.weight"].dtype == torch.float32
    port = build_policy(_moe_config())
    load_flax_variables(port, jtree["params"], None, jtree["quant"])
    port.eval()
    jstep = jax.jit(lambda v, o, s: jm.apply(v, o, s, method=jm.infer_step))
    rng = np.random.default_rng(5)
    jstate, pstate = jm.initial_state(2), port.initial_state(2)
    for step in range(jm.time_sequence_length + 1):
        obs = _obs(rng, 2)
        jout, jstate = jstep(jtree, obs, jstate)
        with torch.no_grad():
            pout, pstate = port.infer_step(to_torch(obs), pstate)
        _close(pout["action_logits"], jout["action_logits"], f"int8 step {step}")


def _moe_config(**overrides):
    cfg = get_config("tiny")
    apply_override(cfg, "model.ffn_impl=moe")
    for key, value in overrides.items():
        apply_override(cfg, f"model.{key}={value}")
    return cfg


def test_routers_stay_float32_under_casts_and_in_every_serving_mode():
    cfg = _moe_config()
    master, _ = master_policy(cfg, None, None)
    names = router_names(master)
    assert names == [f"transformer.layer_{i}.moe.gate.weight"
                     for i in range(cfg.model.num_layers)]
    state = {k: v.detach().clone() for k, v in master.state_dict().items()}
    cast = copy.deepcopy(master).to(torch.bfloat16)
    params = dict(cast.named_parameters())
    assert params["transformer.layer_0.moe.wi"].dtype == torch.bfloat16
    for name in names:
        assert params[name].dtype == torch.float32, name
        assert torch.equal(params[name], state[name]), name
    for mode in ("f32", "bf16", "int8"):
        engine = serving_engine(copy.deepcopy(master), torch.bfloat16, "cpu",
                                inference_dtype=mode)
        served = engine.policy.state_dict()
        for name in names:
            want = state[name].to(torch.bfloat16).float() if mode == "bf16" else state[name]
            assert served[name].dtype == torch.float32, (mode, name)
            assert torch.equal(served[name], want), (mode, name)
        assert engine.swap_variables(copy.deepcopy(state))["params_swapped"] == len(served)


def test_engine_routes_each_session_alone():
    jm, pm, variables = _moe_pair(65, moe_capacity_factor=1.0)
    pm.eval()
    engine = PolicyEngine(pm, max_sessions=4, buckets=(4,))
    alone = PolicyEngine(build_policy(_moe_config(moe_capacity_factor=1.0)), max_sessions=1)
    alone.policy.load_state_dict(pm.state_dict())
    alone.policy.eval()
    jstep = jax.jit(lambda v, o, s: jm.apply(v, o, s, method=jm.infer_step))
    rng = np.random.default_rng(6)
    sessions = ["a", "b", "c"]
    jstates = {sid: jm.initial_state(1) for sid in sessions}
    whole_batch_differs = False
    for step in range(jm.time_sequence_length + 2):
        obs = _obs(rng, 3)
        items = [(sid, {k: v[i] for k, v in obs.items()}) for i, sid in enumerate(sessions)]
        results = engine.act_batch(items)
        for i, sid in enumerate(sessions):
            jout, jstates[sid] = jstep(variables, {k: v[i:i + 1] for k, v in obs.items()},
                                       jstates[sid])
            np.testing.assert_array_equal(results[i]["action_tokens"],
                                          np.asarray(jout["action_tokens"])[0])
            if sid == "b":
                solo = alone.act(sid, items[i][1])
                np.testing.assert_array_equal(solo["action_tokens"], results[i]["action_tokens"])
        if step == 0:
            # The first step of three fresh windows: routing the three rows
            # together (capacity over 45 tokens) drops other tokens.
            with torch.no_grad():
                whole, _ = pm.infer_step(to_torch(obs), pm.initial_state(3))
            jfirst = jstep(variables, obs, jm.initial_state(3))[0]
            _close(whole["action_logits"], jfirst["action_logits"], "whole-batch routing")
            whole_batch_differs = not np.array_equal(
                np.asarray(jfirst["action_logits"]),
                np.stack([np.asarray(jstep(variables, {k: v[i:i + 1] for k, v in obs.items()},
                                           jm.initial_state(1))[0]["action_logits"])[0]
                          for i in range(3)]))
    assert whole_batch_differs, "capacity 1.0 should make per-session routing matter"


def _train_step_out(cfg, seed, remat, b=2):
    apply_override(cfg, f"model.remat={remat}")
    policy = build_model(cfg, "cpu")
    state = create_train_state(policy, Adam())
    before = state.flat_buffers.clone()
    fns = TrainStepFns(Adam(), seed=seed)
    obs, actions = batch(70, b=b, t=cfg.model.time_sequence_length)
    loss, grad, out = fns.value_and_grad(state, (to_torch(obs), to_torch(actions)), 3)
    return loss, grad, out, before, state.flat_buffers.clone()


@pytest.mark.parametrize("tokenizer", ["tiny", "efficientnet_small"])
def test_remat_is_bit_exact_with_dropout_and_stochastic_depth(tokenizer):
    runs = []
    for remat in (False, True):
        cfg = _moe_config(image_tokenizer=tokenizer)
        assert cfg.model.dropout_rate > 0 and cfg.regularization.drop_connect_rate > 0
        runs.append(_train_step_out(cfg, seed=7, remat=remat))
    (l0, g0, o0, init0, bn0), (l1, g1, o1, init1, bn1) = runs
    assert torch.equal(l0, l1)
    assert torch.equal(g0, g1)
    assert torch.equal(o0["moe_aux_loss"], o1["moe_aux_loss"])
    assert torch.equal(init0, init1) and torch.equal(bn0, bn1)
    if tokenizer == "efficientnet_small":  # the statistics moved, once
        assert not torch.equal(bn0, init0)


def test_remat_generators_end_where_an_unremat_step_leaves_them():
    ends = []
    for remat in (False, True):
        cfg = _moe_config()
        apply_override(cfg, f"model.remat={remat}")
        policy = build_model(cfg, "cpu")
        state = create_train_state(policy, Adam())
        rngs = step_rngs(7, 3, "cpu")
        obs, actions = batch(71, b=2, t=3)
        fns = TrainStepFns(Adam(), seed=7)
        copy, params, _ = fns._compute_copy(state, requires_grad=True)
        out = fns.forward(state.policy, params, to_torch(obs), to_torch(actions), rngs)
        torch.autograd.grad(out["loss"], copy)  # the recompute runs here
        ends.append({k: g.get_state() for k, g in rngs.items()})
    for k in ends[0]:
        assert torch.equal(ends[0][k], ends[1][k]), k


def test_moe_remat_loss_matches_jax_remat():
    jm, pm, variables = _moe_pair(66, remat=True)
    assert jm.remat and pm.transformer.remat
    obs, actions = batch(67)
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda p: _loss_fn(jm, p, {}, (obs, actions), jax.random.PRNGKey(0), True)[0]))(
            variables["params"])
    state = create_train_state(pm, Adam())
    loss, grad, _ = TrainStepFns(Adam(), seed=0).value_and_grad(
        state, (to_torch(obs), to_torch(actions)), 0)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    ref = state_dict_from_flax(jax.device_get(jgrad))
    scale = max(float(g.abs().max()) for g in ref.values())
    for name, g in TrainStepFns.grads_by_name(state, grad).items():
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), atol=1e-5 * scale, rtol=0,
                                   err_msg=name)
    assert jnp.isfinite(jloss)


@pytest.mark.parametrize("mode", ["int8", "cached"])
def test_moe_engines_and_their_gates_read_as_jax(mode):
    """Each MoE serving mode's port engine against JAX's engine of the same
    mode on the same weights: agreement 1.0. And the JAX gate's pair (int8
    against f32, cached against windowed) reads the same on both packages,
    so a gate's reading on an MoE policy is the model's, not the port's."""
    jm, pm, variables = _moe_pair(68)
    cached = mode == "cached"
    dtype = "int8" if mode == "int8" else "f32"

    def port(d, c):
        return serving_engine(copy.deepcopy(pm), torch.float32, "cpu", inference_dtype=d,
                              cached_inference=c, max_sessions=2, buckets=[1, 2])

    def jax_engine(d, c):
        served = jquant.quantize_tree(variables) if d == "int8" else variables
        return JaxPolicyEngine(jm, served, max_sessions=2, buckets=[1, 2], inference_dtype=d,
                               master_variables=variables, cached_inference=c)

    episodes = jparity.canned_episodes((H, W, 3), episodes=2, steps=jm.time_sequence_length + 3)
    ours, theirs = port(dtype, cached), jax_engine(dtype, cached)
    assert jparity.action_token_agreement(theirs, ours, episodes)["agreement"] == 1.0
    want = jparity.action_token_agreement(jax_engine("f32", False), theirs, episodes)
    got = jparity.action_token_agreement(port("f32", False), ours, episodes)
    assert got["agreement"] == want["agreement"]
    assert got["tokens_total"] == want["tokens_total"] == 2 * 6 * 3
