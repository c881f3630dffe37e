"""The port's quant plan and quantizer (`rt1_tpu_torch/models/quant.py`)
against the JAX package's (`rt1_tpu/models/quant.py`, `parallel/plan.py`).

* `quantize_per_channel` bitwise against JAX after transposition, for
  Dense, Conv and depthwise layouts, with an all-zero output channel;
* the int8 leaf set, `quant_coverage` and the byte report equal JAX's on
  `tiny` and on the flagship (JAX from `jax.eval_shape`, the port from a
  policy on the meta device; the flagship's report is 227 leaves and
  141,120,128 / 70,560,064 / 38,035,960 bytes);
* a quantized tree equals JAX's `quantize_tree` after `convert.py`,
  bitwise, and JAX's int8 tree loads into the port;
* int8 `infer_step` logits within 1e-5 x max|logit| of JAX's int8 apply,
  on `tiny` and on a narrow FiLM-EfficientNet (every conv site);
* `cast_tree` to bf16 bitwise; a float weight applies as the stock layer,
  bitwise; an int8 weight without its scale raises.
"""

import jax
import numpy as np
import pytest
import torch

from rt1_tpu.models import quant as jquant
from rt1_tpu.models.image_tokenizer import RT1ImageTokenizer as JaxImageTokenizer
from rt1_tpu.models.rt1 import RT1Policy as JaxRT1Policy
from rt1_tpu.parallel.plan import quant_coverage as jax_quant_coverage
from rt1_tpu.specs import language_table_action_space as jax_action_space
from rt1_tpu.train.configs import language_table as jax_language_table
from rt1_tpu.train.configs import tiny as jax_tiny
from rt1_tpu.train.train import build_model as jax_build_model
from rt1_tpu_torch.configs import get_config
from rt1_tpu_torch.convert import flax_paths, load_flax_variables, state_dict_from_flax
from rt1_tpu_torch.eval.restore import build_policy
from rt1_tpu_torch.models import quant
from rt1_tpu_torch.models.image_tokenizer import RT1ImageTokenizer
from rt1_tpu_torch.models.rt1 import RT1Policy
from rt1_tpu_torch.specs import language_table_action_space
from test_torch_rt1 import H, W, init_jax

torch.set_num_threads(2)

JAX_CONFIGS = {"tiny": jax_tiny, "language_table": jax_language_table}
LOGIT_TOL = 1e-5


@pytest.mark.parametrize("layout", ["dense", "conv", "depthwise"])
def test_quantize_per_channel_bitwise_against_jax(layout):
    rng = np.random.default_rng(7)
    shape = {"dense": (24, 10), "conv": (3, 3, 5, 10), "depthwise": (5, 5, 1, 10)}[layout]
    w = rng.standard_normal(shape).astype(np.float32) * rng.uniform(0.01, 3, shape[-1]).astype(np.float32)
    w[..., 3] = 0.0  # an all-zero channel: scale 1.0
    # Values exactly half way between two steps round to even in both.
    w[(0,) * (w.ndim - 1) + (5,)] = 127.0
    w[(-1,) * (w.ndim - 1) + (5,)] = 2.5
    jq, jscale = jquant.quantize_per_channel(w)
    to_torch = (1, 0) if w.ndim == 2 else (3, 2, 0, 1)
    q, scale = quant.quantize_per_channel(torch.from_numpy(np.ascontiguousarray(w.transpose(to_torch))))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), jq.transpose(to_torch))
    np.testing.assert_array_equal(scale.numpy().view(np.uint32), jscale.view(np.uint32))
    assert scale[3] == 1.0 and (q[3] == 0).all()
    np.testing.assert_array_equal(
        quant.dequantize(q, scale).numpy(), jquant.dequantize(jq, jscale).transpose(to_torch))


def _meta_policy(name):
    with torch.device("meta"):
        return build_policy(get_config(name))


@pytest.mark.parametrize("name", ["tiny", "language_table"])
def test_int8_leaf_set_and_coverage_equal_jax(name):
    shapes = jquant.abstract_serving_variables(JAX_CONFIGS[name].get_config())
    policy = _meta_policy(name)
    assert sorted(quant.quantized_paths(policy)) == sorted(jquant.quantized_paths(shapes))
    assert quant.quant_coverage(policy) == [] == jax_quant_coverage(shapes)
    # Every leaf of the port is a leaf of the JAX tree, and no more.
    jax_leaves = {
        "/".join(str(p.key) for p in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]
    }
    assert set(flax_paths(policy).values()) == jax_leaves


@pytest.mark.parametrize("name", ["tiny", "language_table"])
def test_byte_report_equals_jax(name):
    report = quant.quant_byte_report(get_config(name))
    assert report == jquant.quant_byte_report(JAX_CONFIGS[name].get_config())
    if name == "language_table":
        assert (report["quantized_leaves"], report["f32_bytes"], report["bf16_bytes"],
                report["int8_bytes"]) == (227, 141_120_128, 70_560_064, 38_035_960)


def _tiny_pair(seed):
    jm = jax_build_model(jax_tiny.get_config().model)
    variables = init_jax(jm, jm.time_sequence_length, seed)
    pm = build_policy(get_config("tiny"))
    load_flax_variables(pm, variables["params"])
    return jm, variables, pm.eval()


def test_quantized_tree_equals_jax_quantize_tree_bitwise():
    _, variables, pm = _tiny_pair(seed=31)
    jtree = jquant.quantize_tree(variables)
    expected = state_dict_from_flax(jtree["params"], jtree.get("batch_stats"), jtree["quant"])
    got = quant.quantize_tree(pm.state_dict(), flax_paths(pm))
    assert sorted(got) == sorted(expected)
    n_int8 = 0
    for key, value in got.items():
        assert value.dtype == expected[key].dtype, key
        np.testing.assert_array_equal(value.numpy(), expected[key].numpy(), err_msg=key)
        n_int8 += value.dtype == torch.int8
    assert n_int8 == len(jquant.quantized_paths(variables)) == 13


def _int8_logits_match(jm, variables, pm, b=2, steps=None, seed=0):
    """Step JAX's int8 apply and the port loaded with JAX's int8 tree."""
    jtree = jquant.quantize_tree(variables)
    load_flax_variables(pm, jtree["params"], jtree.get("batch_stats"), jtree["quant"])
    pm.eval()
    assert pm.transformer.layer_0.attn.query.weight.dtype == torch.int8
    jax_step = jax.jit(lambda v, o, s: jm.apply(v, o, s, method=jm.infer_step))
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((b, 512)).astype(np.float32)
    jstate, pstate = jm.initial_state(b), pm.initial_state(b)
    for step in range(steps or jm.time_sequence_length + 2):
        frame = rng.uniform(0, 1, (b, H, W, 3)).astype(np.float32)
        jout, jstate = jax_step(jtree, {"image": frame, "natural_language_embedding": emb}, jstate)
        with torch.no_grad():
            pout, pstate = pm.infer_step(
                {"image": torch.from_numpy(frame), "natural_language_embedding": torch.from_numpy(emb)},
                pstate)
        ref = np.asarray(jout["action_logits"])
        np.testing.assert_allclose(pout["action_logits"].numpy(), ref, rtol=0,
                                   atol=LOGIT_TOL * np.abs(ref).max(), err_msg=f"step {step}")
        np.testing.assert_array_equal(pout["action_tokens"].numpy(), np.asarray(jout["action_tokens"]))


def test_tiny_int8_infer_step_matches_jax_int8_apply():
    jm, variables, pm = _tiny_pair(seed=32)
    _int8_logits_match(jm, variables, pm, b=3)


def test_narrow_efficientnet_int8_infer_step_matches_jax():
    """Every conv site (stem, expand, depthwise, project, SE, top, encoder
    1x1, TokenLearner) and the FiLM projections, int8."""
    t = 2
    common = dict(vocab_size=32, token_embedding_size=32, num_layers=1, layer_size=8,
                  num_heads=2, feed_forward_size=32, time_sequence_length=t, num_image_tokens=4)
    jm = JaxRT1Policy(
        action_space=jax_action_space(), dropout_rate=0.0,
        image_tokenizer_def=JaxImageTokenizer(embedding_output_dim=32, num_tokens=4,
                                              width_coefficient=0.35, depth_coefficient=0.35),
        **common)
    pm = RT1Policy(language_table_action_space(),
                   image_tokenizer=RT1ImageTokenizer(32, num_tokens=4, width_coefficient=0.35,
                                                     depth_coefficient=0.35),
                   **common)
    _int8_logits_match(jm, init_jax(jm, t, seed=33), pm, b=1, steps=t + 1)


def test_cast_tree_bf16_bitwise_against_jax():
    _, variables, pm = _tiny_pair(seed=34)
    jcast = jquant.cast_tree(variables)
    expected = state_dict_from_flax(
        jax.tree.map(lambda x: np.asarray(x, np.float32), jcast["params"]))
    got = quant.cast_tree(pm.state_dict())
    assert sorted(got) == sorted(expected)
    for key, value in got.items():
        # bf16 -> f32 is exact, so equal float32 bits are equal bf16 bits.
        assert value.dtype == torch.bfloat16
        np.testing.assert_array_equal(value.float().numpy().view(np.uint32),
                                      expected[key].numpy().view(np.uint32), err_msg=key)


def test_float_weight_is_the_stock_layer_and_int8_needs_its_scale():
    torch.manual_seed(0)
    layer = quant.QuantLinear(6, 4)
    stock = torch.nn.Linear(6, 4)
    stock.load_state_dict(layer.state_dict())
    x = torch.randn(3, 6)
    assert torch.equal(layer(x), stock(x)) and layer.kernel() is layer.weight
    conv = quant.QuantConv2d(3, 5, 3, padding=1, bias=False)
    q, scale = quant.quantize_per_channel(conv.weight.detach())
    conv.set_int8_(q, scale)
    assert conv.compute_dtype == torch.float32 and "weight_scale" in conv.state_dict()
    img = torch.randn(1, 3, 8, 8)
    ref = torch.nn.functional.conv2d(img, quant.dequantize(q, scale), padding=1)
    assert torch.equal(conv(img), ref)
    conv.weight_scale = None
    with pytest.raises(ValueError, match="quantize_tree"):
        conv(img)
    with pytest.raises(ValueError, match="no leaf matched"):
        quant.quantize_tree(layer.state_dict(), {"weight": "params/x/kernel", "bias": "params/x/bias"},
                            rules=[])
