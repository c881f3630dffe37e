"""The train and eval steps against the JAX package's.

JAX side: `rt1_tpu.trainer.train._loss_fn` under `jax.value_and_grad`,
then `TrainState.apply_gradients` with `make_optimizer` (optax Adam +
MultiStepLR, optionally clip by global norm). Port side: `TrainStepFns`.
The tiny config on the same variables and batches, float32, dropout and
the crop off. Milestone 1 with one step per epoch puts a learning-rate
drop between the two steps. Compared after each of two steps: the loss
(rtol 1e-5), every gradient leaf (atol 1e-5 of the largest gradient's
magnitude), the gradient norm (rtol 1e-4), and every parameter after Adam:
atol 1e-6 (an update moves a parameter by about the learning rate, 5e-4)
wherever the gradient is at least 100 x Adam's eps. Where it is smaller,
Adam's `g / (|g| + eps)` turns rounding noise into any update in
[-lr, lr] — the attention key bias, for one, has a true gradient of 0
(softmax ignores a constant per row) — so there the two sides are held
within 2 lr. `test_adam_matches_optax` holds the config's optimizer (plain,
with weight decay, and clipped with weight decay) against optax: the
update rule itself on identical gradients down to 1e-12, where the place
of eps decides the update.

Also: accumulation over 2 micro-batches against 1 (the extra `/accum` of
the reference loss scale; loss rtol 1e-5, gradients and parameters as
above), the
guard (a NaN batch leaves parameters, optimizer state, BatchNorm
statistics and `step` bit for bit and counts one skip), `eval_step`'s
token accuracy against JAX's, and one bf16 step on the CPU (float32
masters, loss within 5e-2 relative of the float32 step's;
`test_torch_train_precision.py` holds the bf16 step against JAX's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt1_tpu.trainer.optim import make_optimizer
from rt1_tpu.trainer.state import TrainState as JaxTrainState
from rt1_tpu.trainer.train import _loss_fn
from rt1_tpu_torch.configs import apply_override, get_config
from rt1_tpu_torch.convert import state_dict_from_flax
from rt1_tpu_torch.eval.restore import build_policy
from rt1_tpu_torch.trainer.optim import Adam
from rt1_tpu_torch.trainer.state import FlatLayout, create_train_state
from rt1_tpu_torch.trainer.train import TrainStepFns, optimizer_from_config
from rt1_tpu_torch.train.train import build_model, synthetic_batch
from test_torch_train_policy import batch, tiny_pair, to_torch

torch.set_num_threads(2)

OPT = dict(learning_rate=5e-4, milestones=(1,), gamma=0.1, steps_per_epoch=1)
EPS = 1e-8


def assert_params_close(port, ref, grad, lr, what):
    """Parameters after an Adam step: atol 1e-6 where |grad| >= 100 eps,
    within 2 `lr` elsewhere (see the module docstring)."""
    port, ref, grad = (np.asarray(x, np.float64) for x in (port, ref, grad))
    diff = np.abs(port - ref)
    solid = np.abs(grad) >= 100 * EPS
    assert (diff[solid] <= 1e-6).all(), (what, diff[solid].max())
    assert (diff <= 2 * lr * (1 + 1e-3)).all(), (what, diff.max())


def _jax_step(jm, state, jbatch):
    def loss(params):
        return _loss_fn(jm, params, state.batch_stats, jbatch, jax.random.PRNGKey(0), True)

    (value, (out, new_bs)), grads = jax.value_and_grad(loss, has_aux=True)(state.params)
    return value, grads, state.apply_gradients(grads, new_batch_stats=new_bs)


@pytest.mark.parametrize("clip", [None, 1e-3], ids=["adam", "adam_clipped"])
def test_two_train_steps_match_jax(clip):
    jm, pm, variables = tiny_pair(51)
    tx = make_optimizer(grad_clip_norm=clip, **OPT)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats={}, opt_state=tx.init(variables["params"]), tx=tx)
    optimizer = Adam(grad_clip_norm=clip, **OPT)
    state = create_train_state(pm, optimizer)
    fns = TrainStepFns(optimizer, seed=0)
    jstep = jax.jit(lambda s, b: _jax_step(jm, s, b))
    for step in range(2):
        obs, actions = batch(52 + step)
        jloss, jgrads, jstate = jstep(jstate, (obs, actions))
        tbatch = (to_torch(obs), to_torch(actions))
        loss, grad, _ = fns.value_and_grad(state, tbatch, step)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        ref = state_dict_from_flax(jax.device_get(jgrads))
        scale = max(float(g.abs().max()) for g in ref.values())
        grads = fns.grads_by_name(state, grad)
        assert set(grads) == set(ref)
        for name, g in grads.items():
            np.testing.assert_allclose(g.numpy(), ref[name].numpy(), atol=1e-5 * scale, rtol=0,
                                       err_msg=f"step {step} grad {name}")
        metrics = fns.train_step(state, tbatch, step)
        ref_norm = float(jnp.sqrt(sum(jnp.sum(g * g) for g in jax.tree.leaves(jgrads))))
        np.testing.assert_allclose(metrics["grad_norm"].item(), ref_norm, rtol=1e-4)
        params = state_dict_from_flax(jax.device_get(jstate.params))
        for name, p in pm.named_parameters():
            assert_params_close(p, params[name], ref[name], OPT["learning_rate"],
                                f"step {step} param {name}")
        assert int(state.step) == int(jstate.step) == step + 1
        assert int(state.opt_state.count) == step + 1


def test_accumulation_over_two_micro_batches_equals_one_batch():
    cfg = get_config("tiny")
    apply_override(cfg, "model.dropout_rate=0")
    apply_override(cfg, "regularization.crop_ratio=0")
    tbatch = synthetic_batch(cfg, 5, 0, "cpu")
    results = []
    for accum in (1, 2):
        policy = build_model(cfg, "cpu")
        optimizer = Adam(**OPT)
        state = create_train_state(policy, optimizer)
        fns = TrainStepFns(optimizer, seed=0, accum_steps=accum)
        _, grad, _ = fns.value_and_grad(state, tbatch, 0)
        grads = fns.grads_by_name(state, grad)
        metrics = fns.train_step(state, tbatch, 0)
        results.append((metrics, dict(policy.named_parameters()), grads))
    (m1, p1, g1), (m2, p2, g2) = results
    assert "action_loss_mean" in m1 and "action_loss_mean" not in m2
    np.testing.assert_allclose(m2["loss"].item(), m1["loss"].item(), rtol=1e-5)
    np.testing.assert_allclose(m2["grad_norm"].item(), m1["grad_norm"].item(), rtol=1e-4)
    scale = max(float(g.abs().max()) for g in g1.values())
    for name in p1:
        np.testing.assert_allclose(g2[name].numpy(), g1[name].numpy(), atol=1e-5 * scale, rtol=0)
        assert_params_close(p2[name].detach(), p1[name].detach(), g1[name], OPT["learning_rate"],
                            name)


@pytest.mark.parametrize("clip,weight_decay", [(None, 0.0), (None, 1e-2), (1e-6, 1e-2)],
                         ids=["adam", "weight_decay", "clip_weight_decay"])
def test_adam_matches_optax(clip, weight_decay):
    """The update rule on identical flat gradients spanning 1e-12 .. 1e-1
    (Adam's eps is 1e-8), over 5 steps with a milestone: rtol 1e-6 on the
    parameters' displacement. The port's optimizer comes from the config
    (`optimizer_from_config`), JAX's from `make_optimizer` (optax's clip by
    global norm, then `add_decayed_weights`, then Adam)."""
    import optax

    rng = np.random.default_rng(57)
    n = 4096
    params = rng.standard_normal(n).astype(np.float32)
    tx = make_optimizer(grad_clip_norm=clip, weight_decay=weight_decay, **OPT)
    jparams, jopt = jnp.asarray(params), tx.init(jnp.asarray(params))
    cfg = get_config("tiny")
    for assignment in (f"learning_rate={OPT['learning_rate']}", "lr_milestones=1",
                       f"lr_gamma={OPT['gamma']}", "steps_per_epoch=1",
                       f"grad_clip_norm={clip or 0.0}", f"weight_decay={weight_decay}"):
        apply_override(cfg, assignment)
    optimizer = optimizer_from_config(cfg)
    flat = torch.from_numpy(params.copy())
    opt_state = optimizer.init(flat)
    for step in range(5):
        grads = (rng.standard_normal(n) * 10.0 ** rng.uniform(-12, -1, n)).astype(np.float32)
        updates, jopt = tx.update(jnp.asarray(grads), jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        flat, opt_state = optimizer.update(torch.from_numpy(grads), opt_state, flat)
        moved = np.asarray(jparams, np.float64) - params
        np.testing.assert_allclose(flat.numpy() - params, moved, rtol=1e-6, atol=1e-12,
                                   err_msg=f"step {step}")
        assert int(opt_state.count) == step + 1


def _bn_policy_state():
    """A small policy with BatchNorm (the 0.35/0.35 tower at 32x56)."""
    cfg = get_config("tiny")
    apply_override(cfg, "model.image_tokenizer=efficientnet_small")
    policy = build_model(cfg, "cpu")
    optimizer = Adam(**OPT)
    return cfg, create_train_state(policy, optimizer), optimizer


def _snapshot(state):
    return ({k: v.clone() for k, v in state.policy.state_dict().items()},
            state.opt_state.mu.clone(), state.opt_state.nu.clone(),
            int(state.opt_state.count), int(state.step))


def test_guard_drops_a_non_finite_step_whole():
    cfg, state, optimizer = _bn_policy_state()
    fns = TrainStepFns(optimizer, seed=0, guard_nonfinite=True)
    good = synthetic_batch(cfg, 1, 0, "cpu")
    fns.train_step(state, good, 0)  # moments and statistics away from their init
    before = _snapshot(state)
    obs, actions = synthetic_batch(cfg, 1, 1, "cpu")
    obs = dict(obs, image=obs["image"].clone())
    obs["image"][0, 0, 0, 0, 0] = float("nan")
    metrics = fns.train_step(state, (obs, actions), 1)
    assert not np.isfinite(metrics["loss"].item())
    assert int(metrics["guard_skips_cum"]) == 1 == int(state.guard_skips)
    after = _snapshot(state)
    for key, value in before[0].items():
        assert torch.equal(value, after[0][key]), key
    assert torch.equal(before[1], after[1]) and torch.equal(before[2], after[2])
    assert before[3:] == after[3:] == (1, 1)
    # A healthy step after the skip updates as usual.
    metrics = fns.train_step(state, synthetic_batch(cfg, 1, 2, "cpu"), 2)
    assert np.isfinite(metrics["loss"].item()) and int(state.step) == 2
    assert int(state.guard_skips) == 1
    assert not torch.equal(state.policy.state_dict()["image_tokenizer.encoder.net.stem.bn.running_mean"],
                           after[0]["image_tokenizer.encoder.net.stem.bn.running_mean"])


def test_eval_step_token_accuracy_matches_jax():
    jm, pm, variables = tiny_pair(55)
    obs, actions = batch(56, b=8)
    out = jax.jit(lambda v: jm.apply(v, obs, actions, train=False))(variables)
    ref_acc = float(jnp.mean((out["action_predictions"] == out["action_labels"]).astype(jnp.float32)))
    state = create_train_state(pm, Adam())
    metrics = TrainStepFns(Adam(), seed=0).eval_step(state, (to_torch(obs), to_torch(actions)))
    assert metrics["token_accuracy"].item() == pytest.approx(ref_acc, abs=1e-7)
    np.testing.assert_allclose(metrics["loss"].item(), float(out["loss"]), rtol=1e-5)
    assert 0.0 < ref_acc < 1.0


def test_bf16_compute_copy_on_the_cpu():
    cfg = get_config("tiny")
    apply_override(cfg, "model.dropout_rate=0")
    apply_override(cfg, "regularization.crop_ratio=0")
    tbatch = synthetic_batch(cfg, 9, 0, "cpu")
    losses = {}
    for dtype in (torch.float32, torch.bfloat16):
        policy = build_model(cfg, "cpu")
        state = create_train_state(policy, Adam())
        before = [p.clone() for p in policy.parameters()]
        fns = TrainStepFns(Adam(), seed=0, compute_dtype=dtype)
        losses[dtype] = fns.train_step(state, tbatch, 0)["loss"].item()
        assert all(p.dtype == torch.float32 for p in policy.parameters())
        assert any(not torch.equal(a, b) for a, b in zip(before, policy.parameters()))
    assert np.isfinite(losses[torch.bfloat16])
    assert losses[torch.bfloat16] == pytest.approx(losses[torch.float32], rel=5e-2)


def test_train_state_needs_float32_masters():
    policy = build_policy(get_config("tiny")).to(torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        create_train_state(policy, Adam())


def test_flat_layout_aligns_every_view_and_round_trips():
    rng = np.random.default_rng(58)
    tensors = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((3,), (5, 7), (1,), (2, 3, 3, 3), (64,), (65,))]
    layout = FlatLayout(tensors)
    flat = layout.flatten(tensors, torch.bfloat16)
    assert flat.dtype == torch.bfloat16 and flat.numel() == layout.size == 64 * 7
    views = layout.views(flat)
    for t, v in zip(tensors, views):
        assert v.storage_offset() % FlatLayout.ALIGN == 0 and v.shape == t.shape
        assert torch.equal(v, t.to(torch.bfloat16))
    # `adopt` makes the same tensor objects views of a new flat tensor.
    copies = [t.clone() for t in tensors]
    adopted = layout.adopt(copies)
    assert all(torch.equal(a, b) for a, b in zip(copies, tensors))
    adopted.mul_(2.0)
    assert all(torch.equal(a, 2.0 * b) for a, b in zip(copies, tensors))
    assert adopted[layout.numels[0]:layout.padded[0]].abs().sum() == 0  # padding
    assert FlatLayout([]).adopt([], device="cpu").numel() == 0
    # A gradient through the views reaches the flat tensor, padding zero.
    leaf = layout.flatten(tensors).requires_grad_(True)
    sum(v.sum() * (i + 1) for i, v in enumerate(layout.views(leaf))).backward()
    assert leaf.grad.sum().item() == sum((i + 1) * t.numel() for i, t in enumerate(tensors))


def test_the_policy_views_the_state_across_steps_and_restores(tmp_path):
    """The policy's parameters and BatchNorm statistics stay views of the
    state's flat masters and statistics through a train step and a
    checkpoint restore: the step writes one flat tensor each, and the
    policy sees it."""
    from rt1_tpu_torch.trainer.checkpoints import CheckpointManager
    from rt1_tpu_torch.trainer.state import floating_buffers

    cfg, state, optimizer = _bn_policy_state()
    policy = state.policy

    def viewed():
        flat_ptr = state.flat.untyped_storage().data_ptr()
        buf_ptr = state.flat_buffers.untyped_storage().data_ptr()
        assert all(p.untyped_storage().data_ptr() == flat_ptr for p in policy.parameters())
        buffers = floating_buffers(policy)
        assert buffers and all(b.untyped_storage().data_ptr() == buf_ptr for b in buffers)
        for p, v in zip(policy.parameters(), state.layout.views(state.flat)):
            assert p.data_ptr() == v.data_ptr() and torch.equal(p, v)

    viewed()
    fns = TrainStepFns(optimizer, seed=0, guard_nonfinite=True)
    before = state.flat.clone()
    fns.train_step(state, synthetic_batch(cfg, 1, 0, "cpu"), 0)
    viewed()
    assert not torch.equal(state.flat, before)
    saved = {k: v.clone() for k, v in policy.state_dict().items()}
    CheckpointManager(str(tmp_path)).save(1, state)
    fns.train_step(state, synthetic_batch(cfg, 1, 1, "cpu"), 1)
    CheckpointManager(str(tmp_path)).restore(state)
    viewed()
    for key, value in policy.state_dict().items():
        assert torch.equal(value, saved[key]), key
