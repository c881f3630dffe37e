"""The port's FiLM-EfficientNet in train mode against the JAX module.

Train-mode BatchNorm normalises with the batch statistics and updates the
running ones with flax's momentum 0.9 on the biased batch variance; the
port's `F.batch_norm` updates with the unbiased one and corrects it. Held
on the 0.35/0.35 tower (the `efficientnet_small` scaling, 16 blocks) at a
small image, float32, with stochastic depth off on both sides
(`drop_connect_rate=0`, a JAX module built in the test): the output within
1e-4 (a conv tower sums in another order than XLA's), the running
statistics after the step within 1e-5, and the gradients of a fixed random
projection of the output within 1e-4 of the largest gradient's magnitude
(train-mode BatchNorm cancels whole gradients: a FiLM bias feeding the next
block's conv and BatchNorm has a true gradient of 0, which both packages
compute as noise of ~1e-5 against gradients of ~1e3).

Stochastic depth cannot be matched draw for draw across packages: its
per-block rates are held to JAX's `block_configs()` exactly, and its law
(keep rate, scaling, one draw per row) on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt1_tpu.models.efficientnet import EfficientNet as JaxEfficientNet
from rt1_tpu_torch.convert import load_flax_variables, state_dict_from_flax
from rt1_tpu_torch.models.efficientnet import BatchNorm, EfficientNet, stochastic_depth
from test_torch_modules import CTX, H, W, init, randomized

torch.set_num_threads(2)

TOL = 1e-4
STATS_TOL = 1e-5


def _jax_train(jm, variables, x, ctx, cot):
    """(output, new batch_stats, d<out, cot>/d params) of one JAX train step."""

    def f(params, batch_stats):
        out, mutated = jm.apply({"params": params, "batch_stats": batch_stats}, x, ctx,
                                train=True, mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, mutated["batch_stats"])

    (_, (out, stats)), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        variables["params"], variables["batch_stats"])
    return out, stats, grads


@pytest.fixture(scope="module")
def tower():
    rng = np.random.default_rng(21)
    x = rng.uniform(0, 1, (4, H, W, 3)).astype(np.float32)
    ctx = rng.standard_normal((4, CTX), dtype=np.float32)
    jm = JaxEfficientNet(width_coefficient=0.35, depth_coefficient=0.35, drop_connect_rate=0.0,
                         include_top=False, include_film=True)
    variables = randomized(init(jm, x, ctx, train=False), 22)
    pm = EfficientNet(0.35, 0.35, include_film=True, drop_connect_rate=0.0)
    load_flax_variables(pm, variables["params"], variables["batch_stats"])
    out_shape = jax.eval_shape(lambda: jm.apply(variables, x, ctx, train=False)).shape
    cot = rng.standard_normal(out_shape).astype(np.float32)
    return jm, variables, pm, x, ctx, cot


def test_efficientnet_train_mode_matches_jax(tower):
    jm, variables, pm, x, ctx, cot = tower
    ref, ref_stats, ref_grads = _jax_train(jm, variables, x, ctx, cot)
    out = pm(torch.from_numpy(x), torch.from_numpy(ctx), train=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=TOL, rtol=0)
    (out * torch.from_numpy(cot)).sum().backward()
    grads = state_dict_from_flax(jax.device_get(ref_grads))
    scale = max(float(g.abs().max()) for g in grads.values())
    assert set(grads) == {name for name, _ in pm.named_parameters()}
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(), atol=TOL * scale,
                                   rtol=0, err_msg=name)
    stats = state_dict_from_flax({}, jax.device_get(ref_stats))
    own = pm.state_dict()
    assert stats and set(stats) <= set(own)
    for name, value in stats.items():
        np.testing.assert_allclose(own[name].numpy(), value.numpy(), atol=STATS_TOL, rtol=0,
                                   err_msg=name)


def test_batch_norm_running_update_is_flax_biased_momentum():
    """Two steps of one BatchNorm on known data: r <- 0.9 r + 0.1 batch,
    with the biased variance, and the batch statistics normalise."""
    rng = np.random.default_rng(23)
    bn = BatchNorm(3)
    bn.running_mean.copy_(torch.tensor([0.5, -1.0, 2.0]))
    bn.running_var.copy_(torch.tensor([1.5, 0.7, 2.0]))
    mean, var = bn.running_mean.double().clone(), bn.running_var.double().clone()
    for _ in range(2):
        x = torch.from_numpy(rng.standard_normal((4, 3, 2, 5)).astype(np.float32) * 3 + 1)
        y = bn(x, train=True)
        xd = x.double()
        batch_mean = xd.mean(dim=(0, 2, 3))
        batch_var = xd.var(dim=(0, 2, 3), unbiased=False)
        mean, var = 0.9 * mean + 0.1 * batch_mean, 0.9 * var + 0.1 * batch_var
        np.testing.assert_allclose(bn.running_mean.numpy(), mean.numpy(), atol=STATS_TOL, rtol=0)
        np.testing.assert_allclose(bn.running_var.numpy(), var.numpy(), atol=STATS_TOL, rtol=0)
        expect = (xd - batch_mean[None, :, None, None]) / torch.sqrt(
            batch_var[None, :, None, None] + 1e-5)
        np.testing.assert_allclose(y.detach().numpy(), expect.numpy(), atol=STATS_TOL, rtol=0)
    # Eval mode reads the running statistics and changes nothing.
    before = bn.running_var.clone()
    bn(x, train=False)
    assert torch.equal(bn.running_var, before)


@pytest.mark.parametrize("width,depth", [(0.35, 0.35), (1.2, 1.4)])
def test_stochastic_depth_rates_match_block_configs(width, depth):
    jm = JaxEfficientNet(width_coefficient=width, depth_coefficient=depth, include_top=False)
    pm = EfficientNet(width, depth)
    ref = [dict(c) for c in jm.block_configs()]
    assert [b["drop_rate"] for b in pm.block_configs()] == [c["drop_rate"] for c in ref]
    for i, cfg in enumerate(ref):
        assert getattr(pm, f"block_{i}").drop_rate == cfg["drop_rate"]
    # 0.2 * b / total over the blocks: the last block of B3 (26) drops 0.2 * 25 / 26.
    if (width, depth) == (1.2, 1.4):
        assert len(ref) == 26 and ref[-1]["drop_rate"] == pytest.approx(0.2 * 25 / 26)


def test_stochastic_depth_law():
    """Rows are kept with probability 1 - rate and scaled by 1 / (1 - rate),
    whole rows at a time; the same generator seed draws the same rows."""
    rate, rows = 0.3, 20000
    x = torch.ones(rows, 2, 3, 3)
    out = stochastic_depth(x, rate, torch.Generator().manual_seed(0))
    flat = out.reshape(rows, -1)
    kept = flat[:, 0] != 0
    assert torch.allclose(flat[kept], torch.full_like(flat[kept], 1.0 / (1 - rate)))
    assert torch.all(flat[~kept] == 0)
    assert abs(kept.float().mean().item() - (1 - rate)) < 0.015  # > 4 sigma at 20000 rows
    again = stochastic_depth(x, rate, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    assert not torch.equal(out, stochastic_depth(x, rate, torch.Generator().manual_seed(1)))


def test_stochastic_depth_needs_a_generator_in_train_mode():
    pm = EfficientNet(0.35, 0.35)
    x = torch.zeros(2, H, W, 3)
    with pytest.raises(ValueError, match="stochastic_depth"):
        pm(x, train=True)
    pm(x, train=True, rngs={"stochastic_depth": torch.Generator().manual_seed(0)})
    pm(x, train=False)
