"""Each module of the port's serving path against its JAX counterpart.

The JAX module's variable shapes come from `jax.eval_shape` of its init,
every leaf is drawn from a seeded numpy generator (so FiLM's zero init and BatchNorm's identity statistics
do not hide a wrong layout), the same variables go through
`convert.load_flax_variables` into the port, and both run on the same
numpy inputs in float32. Tolerances: 1e-5 for matmul-sized work, 1e-4
where a conv tower sums over many more terms in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt1_tpu.models import action_tokenizer as jax_tokenizer
from rt1_tpu.models.efficientnet import EfficientNet as JaxEfficientNet
from rt1_tpu.models.film import FilmConditioning as JaxFilm
from rt1_tpu.models.image_tokenizer import RT1ImageTokenizer as JaxImageTokenizer
from rt1_tpu.models.token_learner import TokenLearner as JaxTokenLearner
from rt1_tpu.models.transformer import CausalTransformer as JaxCausalTransformer
from rt1_tpu.models.transformer import TransformerLayer as JaxTransformerLayer
from rt1_tpu.specs import language_table_action_space as jax_action_space
from rt1_tpu_torch.convert import load_flax_variables
from rt1_tpu_torch.models import action_tokenizer
from rt1_tpu_torch.models.efficientnet import EfficientNet
from rt1_tpu_torch.models.film import FilmConditioning
from rt1_tpu_torch.models.image_tokenizer import RT1ImageTokenizer
from rt1_tpu_torch.models.rt1 import rt1_attention_mask
from rt1_tpu_torch.models.token_learner import TokenLearner
from rt1_tpu_torch.models.transformer import CausalTransformer, TransformerLayer
from rt1_tpu_torch.specs import language_table_action_space

torch.set_num_threads(2)

H, W = 32, 56  # small Language-Table frames, the tiny config's size
CTX = 512


def randomized(variables, seed):
    """Every leaf redrawn: kernels ~ N(0, 1/fan_in), biases and FiLM
    projections small, norm scales near 1, BN variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        names = [getattr(p, "key", str(p)) for p in path]
        leaf, shape = names[-1], np.shape(x)
        if leaf == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            scale = 0.05 if any(n.startswith(("film", "projection")) for n in names) else 1.0
            return (rng.standard_normal(shape) * scale / np.sqrt(fan_in)).astype(np.float32)
        if leaf == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if leaf == "scale":
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, variables)


def init(module, *args, **kwargs):
    """The shapes of `module.init`'s variables (the values are redrawn)."""
    return jax.eval_shape(lambda key: module.init(key, *args, **kwargs), jax.random.PRNGKey(0))


def apply(module, variables, *args, **kwargs):
    """`module.apply` under jit: eager flax apply runs op by op, ~10x slower."""
    return jax.jit(lambda v: module.apply(v, *args, **kwargs))(variables)


def to_port(module, variables):
    load_flax_variables(module, variables["params"], variables.get("batch_stats"))
    return module.eval()


def close(port_out, jax_out, atol):
    np.testing.assert_allclose(
        port_out.detach().numpy(), np.asarray(jax_out), atol=atol, rtol=0
    )


def test_film():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 7, 24), dtype=np.float32)
    ctx = rng.standard_normal((2, CTX), dtype=np.float32)
    jm = JaxFilm(num_channels=24)
    variables = randomized(init(jm, x, ctx), 1)
    ref = apply(jm, variables, x, ctx)
    out = to_port(FilmConditioning(CTX, 24), variables)(torch.from_numpy(x), torch.from_numpy(ctx))
    close(out, ref, 1e-5)


def test_efficientnet_with_film():
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (2, H, W, 3)).astype(np.float32)
    ctx = rng.standard_normal((2, CTX), dtype=np.float32)
    jm = JaxEfficientNet(width_coefficient=0.35, depth_coefficient=0.35,
                         include_top=False, include_film=True)
    variables = randomized(init(jm, x, ctx, train=False), 2)
    ref = apply(jm, variables, x, ctx, train=False)
    pm = to_port(EfficientNet(0.35, 0.35, include_film=True), variables)
    assert [c for c in pm.block_configs()] == [dict(c) for c in jm.block_configs()]
    out = pm(torch.from_numpy(x), torch.from_numpy(ctx))
    assert tuple(out.shape) == ref.shape
    close(out, ref, 1e-4)


def test_token_learner():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 4, 7, 32), dtype=np.float32)
    jm = JaxTokenLearner(num_tokens=4)
    variables = randomized(init(jm, x), 3)
    ref = apply(jm, variables, x)
    out = to_port(TokenLearner(32, num_tokens=4), variables)(torch.from_numpy(x))
    close(out, ref, 1e-5)


def test_image_tokenizer():
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (2, 2, H, W, 3)).astype(np.float32)
    ctx = rng.standard_normal((2, 2, CTX), dtype=np.float32)
    jm = JaxImageTokenizer(embedding_output_dim=32, num_tokens=4,
                           width_coefficient=0.35, depth_coefficient=0.35)
    variables = randomized(init(jm, x, ctx), 4)
    ref = apply(jm, variables, x, ctx)
    pm = to_port(RT1ImageTokenizer(32, num_tokens=4, width_coefficient=0.35,
                                   depth_coefficient=0.35), variables)
    out = pm(torch.from_numpy(x), torch.from_numpy(ctx))
    assert tuple(out.shape) == (2, 2, 4, 32)
    close(out, ref, 1e-4)


@pytest.mark.parametrize("impl", ["dense", "pallas"])
def test_transformer_layer(impl):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 21, 32), dtype=np.float32)
    mask = rt1_attention_mask(3, 4, 3)
    jm = JaxTransformerLayer(key_dim=8, num_heads=2, d_model=32, dropout_rate=0.0,
                             attention_impl=impl, pallas_interpret=True)
    variables = randomized(init(jm, x, jnp.asarray(mask)), 5)
    ref, _ = apply(jm, variables, x, jnp.asarray(mask))
    pm = to_port(TransformerLayer(8, 2, 32, attention_impl=impl), variables)
    out, aux = pm(torch.from_numpy(x), torch.from_numpy(mask))
    assert aux is None  # the dense FFN has no load-balancing loss
    close(out, ref, 1e-5)


@pytest.mark.parametrize("impl", ["dense", "pallas"])
def test_causal_transformer(impl):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 21, 32), dtype=np.float32)
    mask = rt1_attention_mask(3, 4, 3)
    jm = JaxCausalTransformer(num_layers=2, key_dim=8, num_heads=2, d_model=32,
                              dropout_rate=0.0, vocab_size=32, attention_impl=impl,
                              pallas_interpret=True)
    variables = randomized(init(jm, x, jnp.asarray(mask)), 6)
    ref = apply(jm, variables, x, jnp.asarray(mask))
    pm = to_port(CausalTransformer(32, num_layers=2, key_dim=8, num_heads=2, d_model=32,
                                   vocab_size=32, attention_impl=impl), variables)
    close(pm(torch.from_numpy(x), torch.from_numpy(mask)), ref, 1e-5)


def test_detokenize_matches_jax():
    rng = np.random.default_rng(6)
    # Terminate tokens 0..3 cover the `tok > n` quirk (n = 2: 2 passes, 3 -> 0).
    tokens = rng.integers(0, 32, (5, 3)).astype(np.int32)
    tokens[:4, 0] = [0, 1, 2, 3]
    ref = jax_tokenizer.detokenize(jax_action_space(), jnp.asarray(tokens), 32)
    out = action_tokenizer.detokenize(language_table_action_space(), torch.from_numpy(tokens), 32)
    assert set(out) == set(ref)
    for key in ref:
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=1e-7, rtol=0)
    logits = rng.standard_normal((5, 3, 32)).astype(np.float32)
    ref = jax_tokenizer.detokenize_expected(jax_action_space(), jnp.asarray(logits), 32)
    out = action_tokenizer.detokenize_expected(language_table_action_space(),
                                               torch.from_numpy(logits), 32)
    for key in ref:
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=1e-6, rtol=0)
    assert action_tokenizer.tokens_per_action(language_table_action_space()) == 3
    for port_arr, jax_arr in zip(
        action_tokenizer.box_bin_values(language_table_action_space(), 32),
        jax_tokenizer.box_bin_values(jax_action_space(), 32),
    ):
        np.testing.assert_array_equal(port_arr, jax_arr)
