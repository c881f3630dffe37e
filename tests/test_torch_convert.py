"""The weights bridge: every flax leaf lands on exactly one port tensor.

For the tiny config (`TinyImageTokenizer`) and for the narrow B3
(`RT1ImageTokenizer` at width/depth 0.35, the flagship's architecture
family), the JAX package's `RT1Policy.init` tree (its shapes, filled from
a seeded generator) converts to a state_dict
whose keys are exactly the port policy's, leaf for leaf and shape for
shape; values keep their layout transforms (HWIO -> OIHW, (in, out) ->
(out, in)); and the .npz form of the tree reads back to the same tree.
"""

import jax
import numpy as np
import pytest
import torch

from rt1_tpu.models.image_tokenizer import RT1ImageTokenizer as JaxImageTokenizer
from rt1_tpu.models.rt1 import RT1Policy as JaxRT1Policy
from rt1_tpu.models.tiny_tokenizer import TinyImageTokenizer as JaxTinyTokenizer
from rt1_tpu.specs import language_table_action_space as jax_action_space
from rt1_tpu.specs import sample_space
from rt1_tpu_torch import convert
from rt1_tpu_torch.models.image_tokenizer import RT1ImageTokenizer
from rt1_tpu_torch.models.rt1 import RT1Policy
from rt1_tpu_torch.models.tiny_tokenizer import TinyImageTokenizer
from rt1_tpu_torch.specs import language_table_action_space

torch.set_num_threads(2)

T, EMB, TOK = 2, 32, 4


def _pair(kind):
    if kind == "tiny":
        jtok = JaxTinyTokenizer(num_tokens=TOK, emb=EMB)
        ptok = TinyImageTokenizer(num_tokens=TOK, emb=EMB)
    else:
        jtok = JaxImageTokenizer(embedding_output_dim=EMB, num_tokens=TOK,
                                 width_coefficient=0.35, depth_coefficient=0.35)
        ptok = RT1ImageTokenizer(EMB, num_tokens=TOK, width_coefficient=0.35,
                                 depth_coefficient=0.35)
    common = dict(vocab_size=32, token_embedding_size=EMB, num_layers=2, layer_size=8,
                  num_heads=2, feed_forward_size=EMB, time_sequence_length=T,
                  num_image_tokens=TOK)
    jm = JaxRT1Policy(action_space=jax_action_space(), dropout_rate=0.0,
                      image_tokenizer_def=jtok, **common)
    pm = RT1Policy(language_table_action_space(), image_tokenizer=ptok, **common)
    obs = {"image": np.zeros((1, T, 32, 56, 3), np.float32),
           "natural_language_embedding": np.zeros((1, T, 512), np.float32)}
    key = jax.random.PRNGKey(0)
    actions = sample_space(jax_action_space(), key, (1, T))
    shapes = jax.eval_shape(lambda k: jm.init({"params": k, "crop": k}, obs, actions), key)
    rng = np.random.default_rng(0)
    variables = jax.tree_util.tree_map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), shapes
    )
    return variables, pm


@pytest.mark.parametrize("kind", ["tiny", "narrow_b3"])
def test_every_flax_leaf_maps_once(kind):
    variables, pm = _pair(kind)
    leaves = jax.tree_util.tree_leaves_with_path(
        {k: variables[k] for k in ("params", "batch_stats") if k in variables}
    )
    state = convert.state_dict_from_flax(variables["params"], variables.get("batch_stats"))
    own = pm.state_dict()
    assert len(state) == len(leaves)
    assert set(state) == set(own)
    for key, value in state.items():
        assert tuple(value.shape) == tuple(own[key].shape), key
    convert.load_flax_variables(pm, variables["params"], variables.get("batch_stats"))
    if kind == "narrow_b3":
        assert len(variables["batch_stats"]) > 0


def test_layouts_and_npz_round_trip(tmp_path):
    variables, pm = _pair("narrow_b3")
    params, stats = variables["params"], variables["batch_stats"]
    state = convert.state_dict_from_flax(params, stats)
    net = params["image_tokenizer_def"]["encoder"]["EfficientNet_0"]
    dw = np.asarray(net["block_0"]["depthwise"]["conv"]["kernel"])  # (kh, kw, 1, C)
    got = state["image_tokenizer.encoder.net.block_0.depthwise.conv.weight"].numpy()
    assert got.shape == (dw.shape[3], 1, dw.shape[0], dw.shape[1])
    np.testing.assert_array_equal(got[5, 0, 1, 2], dw[1, 2, 0, 5])
    q = np.asarray(params["transformer"]["layer_0"]["attn"]["query"]["kernel"])
    np.testing.assert_array_equal(
        state["transformer.layer_0.attn.query.weight"].numpy(), q.T
    )
    np.testing.assert_array_equal(
        state["image_tokenizer.encoder.net.stem.bn.running_var"].numpy(),
        np.asarray(stats["image_tokenizer_def"]["encoder"]["EfficientNet_0"]["stem"]["bn"]["var"]),
    )
    flat = {
        "/".join([col] + [p.key for p in path]): np.asarray(leaf)
        for col in ("params", "batch_stats")
        for path, leaf in jax.tree_util.tree_leaves_with_path(variables[col])
    }
    np.savez(tmp_path / "w.npz", **flat)
    p2, s2 = convert.load_npz(str(tmp_path / "w.npz"))
    again = convert.state_dict_from_flax(p2, s2)
    assert set(again) == set(state)
    for key in state:
        assert torch.equal(again[key], state[key]), key


def test_leftover_or_missing_leaves_raise():
    variables, pm = _pair("tiny")
    params = jax.tree_util.tree_map(lambda x: x, variables["params"])
    params["transformer"]["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError):
        convert.load_flax_variables(pm, params)
    del params["transformer"]["extra"]
    del params["transformer"]["output_tokens"]
    with pytest.raises(KeyError):
        convert.load_flax_variables(pm, params)
