"""The whole policy: the port's `RT1Policy.infer_step` against the JAX one.

Same variables (drawn from a seeded numpy generator for the shapes of the
JAX init, and carried across by `convert`), same numpy frames and instruction
embeddings, T+2 control steps so the window fills and then rolls twice.
The JAX side runs the Pallas attention kernel in interpret mode; the port
runs its fused path, which on the CPU is the kernel's plain version.
Action tokens must be equal and step logits within atol 1e-4 (float32;
the conv tower sums in another order than XLA's).
"""

import jax
import numpy as np
import pytest
import torch

from rt1_tpu.models.image_tokenizer import RT1ImageTokenizer as JaxImageTokenizer
from rt1_tpu.models.rt1 import RT1Policy as JaxRT1Policy
from rt1_tpu.specs import language_table_action_space as jax_action_space
from rt1_tpu.specs import sample_space
from rt1_tpu.train.configs import language_table as jax_language_table
from rt1_tpu.train.configs import tiny as jax_tiny
from rt1_tpu.train.train import build_model as jax_build_model
from rt1_tpu_torch.configs import get_config
from rt1_tpu_torch.convert import load_flax_variables
from rt1_tpu_torch.eval.restore import build_policy
from rt1_tpu_torch.models.image_tokenizer import RT1ImageTokenizer
from rt1_tpu_torch.models.rt1 import RT1Policy
from rt1_tpu_torch.specs import language_table_action_space
from test_torch_modules import randomized

torch.set_num_threads(2)

H, W = 32, 56


def init_jax(jm, t, seed):
    obs = {"image": np.zeros((1, t, H, W, 3), np.float32),
           "natural_language_embedding": np.zeros((1, t, 512), np.float32)}
    key = jax.random.PRNGKey(0)
    actions = sample_space(jax_action_space(), key, (1, t))
    shapes = jax.eval_shape(lambda k: jm.init({"params": k, "crop": k}, obs, actions), key)
    return randomized(shapes, seed)


def run_both(jm, pm, variables, steps, b=2, seed=0):
    """Step both policies `steps` times on the same frames; compare."""
    load_flax_variables(pm, variables["params"], variables.get("batch_stats"))
    pm.eval()
    jax_step = jax.jit(lambda v, o, s: jm.apply(v, o, s, method=jm.infer_step))
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((b, 512)).astype(np.float32)
    jstate = jm.initial_state(b)
    pstate = pm.initial_state(b)
    for step in range(steps):
        frame = rng.uniform(0, 1, (b, H, W, 3)).astype(np.float32)
        jout, jstate = jax_step(variables, {"image": frame, "natural_language_embedding": emb}, jstate)
        with torch.no_grad():
            pout, pstate = pm.infer_step(
                {"image": torch.from_numpy(frame), "natural_language_embedding": torch.from_numpy(emb)},
                pstate,
            )
        np.testing.assert_array_equal(pout["action_tokens"].numpy(), np.asarray(jout["action_tokens"]),
                                      err_msg=f"step {step}")
        np.testing.assert_allclose(pout["action_logits"].numpy(), np.asarray(jout["action_logits"]),
                                   atol=1e-4, rtol=0, err_msg=f"step {step}")
        np.testing.assert_allclose(pout["action"].numpy(), np.asarray(jout["action"]), atol=1e-6)
        np.testing.assert_array_equal(pout["terminate_episode"].numpy(),
                                      np.asarray(jout["terminate_episode"]))
        np.testing.assert_array_equal(pstate["seq_idx"].numpy(),
                                      np.full((b,), int(jstate["seq_idx"]), np.int32))
        np.testing.assert_array_equal(pstate["action_tokens"].numpy(), np.asarray(jstate["action_tokens"]))
        np.testing.assert_allclose(pstate["context_image_tokens"].numpy(),
                                   np.asarray(jstate["context_image_tokens"]), atol=1e-4, rtol=0)


def test_policy_narrow_b3_pallas_over_window_roll():
    t = 3
    common = dict(vocab_size=32, token_embedding_size=32, num_layers=2, layer_size=8,
                  num_heads=2, feed_forward_size=32, time_sequence_length=t, num_image_tokens=4)
    jm = JaxRT1Policy(
        action_space=jax_action_space(), dropout_rate=0.0, attention_impl="pallas",
        pallas_interpret=True,
        image_tokenizer_def=JaxImageTokenizer(embedding_output_dim=32, num_tokens=4,
                                              width_coefficient=0.35, depth_coefficient=0.35),
        **common,
    )
    pm = RT1Policy(
        language_table_action_space(), attention_impl="fused",
        image_tokenizer=RT1ImageTokenizer(32, num_tokens=4, width_coefficient=0.35,
                                          depth_coefficient=0.35),
        **common,
    )
    run_both(jm, pm, init_jax(jm, t, seed=11), steps=t + 2)


def test_policy_tiny_config_over_window_roll():
    jcfg = jax_tiny.get_config()
    jm = jax_build_model(jcfg.model).clone(attention_impl="pallas", pallas_interpret=True)
    pm = build_policy(get_config("tiny"), attention_impl="pallas")
    t = jcfg.model.time_sequence_length
    run_both(jm, pm, init_jax(jm, t, seed=12), steps=t + 2, b=3)


@pytest.mark.parametrize("name,jax_module", [("tiny", jax_tiny), ("language_table", jax_language_table)])
def test_configs_match_jax(name, jax_module):
    jcfg = jax_module.get_config()
    cfg = get_config(f"rt1_tpu/train/configs/{name}.py")
    for field in cfg.model.__dataclass_fields__:
        if field == "lava":  # a nested config: field by field
            for sub in cfg.model.lava.__dataclass_fields__:
                assert getattr(cfg.model.lava, sub) == jcfg.model.lava[sub], f"lava.{sub}"
            continue
        assert getattr(cfg.model, field) == jcfg.model[field], field
    assert (cfg.data.height, cfg.data.width) == (jcfg.data.height, jcfg.data.width)
