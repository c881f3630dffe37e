"""The policy's training forward against JAX `RT1Policy.__call__`.

The tiny config's policy on variables drawn from a seeded numpy generator,
the same numpy observations and actions, dropout and the crop off on both
sides (JAX: `dropout_rate=0`, `crop_ratio=0`), float32. Compared: the loss
(rtol 1e-5), `action_loss` (rtol 1e-5), `cross_entropy` and
`action_logits` (atol 1e-4, as the inference parity tests), labels and
predictions (exact), at focal gamma 0, and at gamma 2 with the soft-argmax
MSE auxiliary on (`aux_mse` rtol 1e-5); also in eval mode.
"""

import jax
import numpy as np
import pytest
import torch

from rt1_tpu.train.configs import tiny as jax_tiny
from rt1_tpu.train.train import build_model as jax_build_model
from rt1_tpu_torch.configs import apply_override, get_config
from rt1_tpu_torch.convert import load_flax_variables
from rt1_tpu_torch.eval.restore import build_policy
from test_torch_rt1 import H, W, init_jax

torch.set_num_threads(2)

RTOL = 1e-5
ATOL = 1e-4


def tiny_pair(seed, **overrides):
    """(JAX policy, port policy, variables) of the tiny config, with
    dropout and the crop off and `overrides` set on both."""
    jcfg = jax_tiny.get_config()
    cfg = get_config("tiny")
    for key, value in overrides.items():
        jcfg.model[key] = value
        apply_override(cfg, f"model.{key}={value}")
    jm = jax_build_model(jcfg.model).clone(dropout_rate=0.0, crop_ratio=0.0)
    apply_override(cfg, "model.dropout_rate=0")
    apply_override(cfg, "regularization.crop_ratio=0")
    pm = build_policy(cfg)
    variables = init_jax(jm, jcfg.model.time_sequence_length, seed)
    load_flax_variables(pm, variables["params"], variables.get("batch_stats"))
    return jm, pm, variables


def batch(seed, b=4, t=3):
    rng = np.random.default_rng(seed)
    obs = {"image": rng.uniform(0, 1, (b, t, H, W, 3)).astype(np.float32),
           "natural_language_embedding": rng.standard_normal((b, t, 512)).astype(np.float32)}
    actions = {"terminate_episode": rng.integers(0, 2, (b, t)).astype(np.int32),
               "action": rng.uniform(-0.1, 0.1, (b, t, 2)).astype(np.float32)}
    return obs, actions


def to_torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def compare(out, ref):
    assert set(out) == set(ref), (sorted(out), sorted(ref))
    np.testing.assert_allclose(out["loss"].item(), float(ref["loss"]), rtol=RTOL)
    np.testing.assert_allclose(out["action_loss"].detach().numpy(), np.asarray(ref["action_loss"]),
                               rtol=RTOL)
    for key in ("cross_entropy", "action_logits"):
        np.testing.assert_allclose(out[key].detach().numpy(), np.asarray(ref[key]), atol=ATOL,
                                   rtol=0, err_msg=key)
    for key in ("action_labels", "action_predictions"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]), err_msg=key)
    if "aux_mse" in ref:
        np.testing.assert_allclose(out["aux_mse"].item(), float(ref["aux_mse"]), rtol=RTOL)


@pytest.mark.parametrize("overrides", [{}, {"focal_gamma": 2.0, "aux_mse_weight": 0.5}],
                         ids=["reference_ce", "focal_and_aux_mse"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_tiny_policy_forward_matches_jax(overrides, train):
    jm, pm, variables = tiny_pair(41, **overrides)
    obs, actions = batch(42)
    ref = jax.jit(lambda v: jm.apply(v, obs, actions, train=train))(variables)
    out = pm(to_torch(obs), to_torch(actions), train=train)
    compare(out, ref)
    assert out["action_loss"].shape == (4, 3) and out["action_logits"].shape == (4, 3, 3, 32)


def test_focal_and_aux_change_the_loss_only():
    """Same weights: gamma 2 + aux MSE changes `loss` but not the raw CE."""
    _, plain, _ = tiny_pair(43)
    _, focal, _ = tiny_pair(43, focal_gamma=2.0, aux_mse_weight=0.5)
    obs, actions = batch(44)
    a = plain(to_torch(obs), to_torch(actions), train=True)
    b = focal(to_torch(obs), to_torch(actions), train=True)
    assert torch.equal(a["cross_entropy"], b["cross_entropy"])
    assert a["loss"].item() != b["loss"].item() and "aux_mse" in b and "aux_mse" not in a


def test_train_mode_draws_from_the_given_generators():
    """With dropout and the crop on, train mode needs generators, draws the
    same for the same seeds, and eval mode ignores them."""
    cfg = get_config("tiny")
    pm = build_policy(cfg)
    obs, actions = (to_torch(t) for t in batch(45))
    with pytest.raises(ValueError):
        pm(obs, actions, train=True)

    def rngs(seed):
        return {k: torch.Generator().manual_seed(seed + i)
                for i, k in enumerate(("crop", "dropout", "stochastic_depth"))}

    a = pm(obs, actions, train=True, rngs=rngs(0))["loss"]
    b = pm(obs, actions, train=True, rngs=rngs(0))["loss"]
    c = pm(obs, actions, train=True, rngs=rngs(7))["loss"]
    assert a.item() == b.item() != c.item()
    assert pm(obs, actions, train=False)["loss"].item() == pm(obs, actions, train=False)["loss"].item()
