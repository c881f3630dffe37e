"""The port's torchvision EfficientNet-B3 porter against the JAX package's.

`rt1_tpu_torch/models/load_pretrained.py::port_torch_efficientnet` and
`rt1_tpu/models/load_pretrained.py::port_torch_efficientnet` take the same
seeded torch state dict; the JAX result, carried across by
`convert.state_dict_from_flax`, must equal the port's bit for bit, every
parameter and statistic:

* the full B3 with its classifier (`EfficientNetB3(include_top=True)`),
  FiLM off and on, from a dict with torchvision's exact key names, order
  and shapes. The manifest below is this file's own copy of torchvision's
  constructor rule (`_efficientnet_conf`'s table, `_make_divisible`, the
  `features.{stage}.{i}.block.{j}` naming), anchored to torchvision's
  published 12,233,232 learnable parameters, which the port's B3 holds
  too. The JAX side's variables are `jax.eval_shape` plus zeros, so no
  full-size B3 is compiled;
* a narrow net (width and depth 0.1, 10 classes, FiLM on), whose ported
  forward also agrees with JAX's within 1e-4 (FiLM's weights drawn, so
  the context acts);
* a `tiny` policy's 0.35/0.35 tower, ported at `submodule_path`
  (`image_tokenizer.encoder.net`; JAX's `image_tokenizer_def/encoder/
  EfficientNet_0`).

Then the porter's purity, JAX's refusals (count, conv / linear /
BatchNorm shape, a dropped SE `fc1`, a full torchvision dict into a tower
without the head), a string-sorted target, an int8 target, a ported tower
saved and grafted as the train CLI's `model.pretrained_encoder`, and
`load_torch_checkpoint`.
"""

import collections
import functools
import math

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt1_tpu.models.efficientnet import EfficientNet as JaxEfficientNet
from rt1_tpu.models.efficientnet import EfficientNetB3 as JaxEfficientNetB3
from rt1_tpu.models.load_pretrained import port_torch_efficientnet as jax_port
from rt1_tpu.train.configs import tiny as jax_tiny
from rt1_tpu.train.train import build_model as jax_build_model
from rt1_tpu_torch.configs import get_config
from rt1_tpu_torch.convert import load_flax_variables, state_dict_from_flax
from rt1_tpu_torch.eval.restore import build_policy
from rt1_tpu_torch.models.efficientnet import EfficientNet, EfficientNetB3
from rt1_tpu_torch.models.load_pretrained import load_torch_checkpoint, port_torch_efficientnet
from rt1_tpu_torch.models.quant import quantize_per_channel
from rt1_tpu_torch.train import pretrain_vision as pv
from test_torch_modules import randomized
from test_torch_rt1 import init_jax

torch.set_num_threads(2)

TORCHVISION_B3_PARAMS = 12_233_232  # torchvision's published efficientnet_b3 total
TOWER = "image_tokenizer.encoder.net"
JAX_TOWER = ("image_tokenizer_def", "encoder", "EfficientNet_0")


def _divisible(v, divisor=8):
    """torchvision's `_make_divisible` (min_value None)."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    return new_v + divisor if new_v < 0.9 * v else new_v


def torchvision_b3_manifest():
    """[(key, shape)] of torchvision's `efficientnet_b3().state_dict()`, in
    order: width 1.2 and depth 1.4 over the B0 MBConv table (expand,
    kernel, stride, in, out, repeats), SE squeeze max(1, block input // 4),
    head 4 x the last stage's width, classifier `Linear(head, 1000)`."""
    table = [(1, 3, 1, 32, 16, 1), (6, 3, 2, 16, 24, 2), (6, 5, 2, 24, 40, 2),
             (6, 3, 2, 40, 80, 3), (6, 5, 1, 80, 112, 3), (6, 5, 2, 112, 192, 4),
             (6, 3, 1, 192, 320, 1)]
    keys = []

    def conv_bn(prefix, cin, cout, k, groups=1):
        keys.append((f"{prefix}.0.weight", (cout, cin // groups, k, k)))
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            keys.append((f"{prefix}.1.{leaf}", (cout,)))
        keys.append((f"{prefix}.1.num_batches_tracked", ()))

    def squeeze(prefix, expanded, squeezed):
        keys.append((f"{prefix}.fc1.weight", (squeezed, expanded, 1, 1)))
        keys.append((f"{prefix}.fc1.bias", (squeezed,)))
        keys.append((f"{prefix}.fc2.weight", (expanded, squeezed, 1, 1)))
        keys.append((f"{prefix}.fc2.bias", (expanded,)))

    cin = _divisible(32 * 1.2)
    conv_bn("features.0", 3, cin, 3)
    for stage, (expand, k, _stride, _in, out, repeats) in enumerate(table, start=1):
        cout = _divisible(out * 1.2)
        for i in range(int(math.ceil(repeats * 1.4))):
            p = f"features.{stage}.{i}.block"
            block_in = cin if i == 0 else cout
            expanded, j = block_in * expand, 0
            if expand != 1:
                conv_bn(f"{p}.0", block_in, expanded, 1)
                j = 1
            conv_bn(f"{p}.{j}", expanded, expanded, k, groups=expanded)
            squeeze(f"{p}.{j + 1}", expanded, max(1, block_in // 4))
            conv_bn(f"{p}.{j + 2}", expanded, cout, 1)
        cin = cout
    head = 4 * _divisible(320 * 1.2)
    conv_bn("features.8", cin, head, 1)
    keys.append(("classifier.1.weight", (1000, head)))
    keys.append(("classifier.1.bias", (1000,)))
    return keys


def _draw(rng, key, shape):
    if key.endswith("num_batches_tracked"):
        return np.asarray(7, np.int64)
    if key.endswith("running_var"):
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    return (rng.standard_normal(shape) * 0.05).astype(np.float32)


def torchvision_state_dict(seed=0):
    rng = np.random.default_rng(seed)
    return collections.OrderedDict(
        (key, _draw(rng, key, shape)) for key, shape in torchvision_b3_manifest())


def module_order_state_dict(tower, seed):
    """A torch-layout dict (`m<n>.<leaf>`) of `tower`'s conv, BatchNorm and
    linear modules in construction order (FiLM skipped): the order a
    torchvision model of that architecture registers its modules in. Conv
    and linear weights ~ N(0, 1/fan_in), BatchNorm scales near 1, so a
    forward through the ported weights stays O(1)."""
    rng = np.random.default_rng(seed)
    sd = collections.OrderedDict()
    n = 0
    for name, module in tower.named_modules():
        if "film" in name:
            continue
        if hasattr(module, "running_mean"):
            c = module.running_mean.shape[0]
            sd[f"m{n}.weight"] = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
            sd[f"m{n}.bias"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
            sd[f"m{n}.running_mean"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
            sd[f"m{n}.running_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            sd[f"m{n}.num_batches_tracked"] = np.asarray(1, np.int64)
        elif isinstance(module, (torch.nn.Conv2d, torch.nn.Linear)):
            shape = tuple(module.weight.shape)
            fan_in = math.prod(shape[1:])
            sd[f"m{n}.weight"] = (rng.standard_normal(shape) / math.sqrt(fan_in)).astype(
                np.float32)
            if module.bias is not None:
                sd[f"m{n}.bias"] = (0.1 * rng.standard_normal(shape[0])).astype(np.float32)
        else:
            continue
        n += 1
    return sd


@functools.lru_cache(maxsize=None)
def _jax_b3_variables(include_top, include_film):
    model = JaxEfficientNetB3(include_top=include_top, include_film=include_film)
    kwargs = {"context": jnp.zeros((1, 512))} if include_film else {}
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False,
                           **kwargs))
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), flax.core.unfreeze(shapes))


def _converted(variables):
    return state_dict_from_flax(variables["params"], variables.get("batch_stats"))


def assert_states_equal(got, want):
    assert list(got) == list(want) or sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        assert torch.equal(got[key], value), key


def test_port_b3_holds_torchvision_param_count():
    manifest = torchvision_b3_manifest()
    learnable = sum(math.prod(shape) for key, shape in manifest
                    if "running_" not in key and "num_batches" not in key)
    assert learnable == TORCHVISION_B3_PARAMS
    net = EfficientNetB3(include_top=True)
    assert sum(p.numel() for p in net.parameters()) == TORCHVISION_B3_PARAMS
    assert net.num_blocks == 26 and net.top_ch == 1536
    assert tuple(net.stem.conv.weight.shape) == (40, 3, 3, 3)
    # The port's B3 without its head is the RT-1 tower: no classifier key.
    assert not any(k.startswith("classifier") for k in EfficientNetB3(include_top=False)
                   .state_dict())


@pytest.mark.parametrize("include_film", [False, True])
def test_full_b3_port_equals_jax_port_bit_for_bit(include_film):
    sd = torchvision_state_dict()
    want = _converted(jax_port(sd, _jax_b3_variables(True, include_film)))
    net = EfficientNetB3(include_top=True, include_film=include_film)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    got = port_torch_efficientnet(sd, net)
    film = [k for k in got if k.startswith("film_")]
    assert bool(film) == include_film
    assert sorted(got) == sorted(want)
    for key in got:
        if key in film:  # untouched on both sides
            assert torch.equal(got[key], before[key]), key
            assert not want[key].any(), key
        else:
            assert torch.equal(got[key], want[key]), key
    # Ordered zip: torchvision's first conv is the stem, its linear the head.
    assert torch.equal(got["stem.conv.weight"], torch.from_numpy(sd["features.0.0.weight"]))
    assert torch.equal(got["classifier.weight"], torch.from_numpy(sd["classifier.1.weight"]))
    assert torch.equal(got["stem.bn.running_mean"],
                       torch.from_numpy(sd["features.0.1.running_mean"]))


@functools.lru_cache(maxsize=None)
def _narrow_pair():
    """The narrow classifier in both packages on one set of drawn
    variables (FiLM's included), and a torch-layout dict in its order."""
    jm = JaxEfficientNet(width_coefficient=0.1, depth_coefficient=0.1, include_top=True,
                         classes=10, include_film=True)
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 8)),
                                              train=False), jax.random.PRNGKey(0))
    variables = jax.device_get(randomized(flax.core.unfreeze(shapes), 3))
    return jm, variables


def _narrow_port(variables):
    pm = EfficientNet(0.1, 0.1, include_film=True, context_dim=8, include_top=True, classes=10)
    load_flax_variables(pm, variables["params"], variables["batch_stats"])
    return pm.eval()


def test_narrow_net_port_and_forward_match_jax():
    jm, variables = _narrow_pair()
    pm = _narrow_port(variables)
    sd = module_order_state_dict(pm, seed=4)
    ported = jax_port(sd, variables)
    got = port_torch_efficientnet(sd, pm)
    assert_states_equal(got, _converted(ported))
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    ctx = rng.standard_normal((2, 8)).astype(np.float32)
    ref = jax.jit(lambda v: jm.apply(v, x, ctx, train=False))(ported)
    pm.load_state_dict(got)
    with torch.no_grad():
        out = pm(torch.from_numpy(x), torch.from_numpy(ctx))
    assert tuple(out.shape) == (2, 10) and float(out.abs().max()) > 0.1
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def test_policy_tower_port_at_submodule_path_matches_jax():
    jcfg = jax_tiny.get_config()
    jcfg.model.image_tokenizer = "efficientnet_small"
    jm = jax_build_model(jcfg.model)
    variables = jax.device_get(flax.core.unfreeze(init_jax(jm, jcfg.model.time_sequence_length, 6)))
    config = get_config("tiny")
    config.model.image_tokenizer = "efficientnet_small"
    pm = build_policy(config)
    load_flax_variables(pm, variables["params"], variables["batch_stats"])
    sd = module_order_state_dict(pm.get_submodule(TOWER), seed=7)
    want = _converted(jax_port(sd, variables, submodule_path=JAX_TOWER))
    got = port_torch_efficientnet(sd, pm, submodule_path=TOWER)
    assert_states_equal(got, want)
    own = pm.state_dict()
    moved = [k for k in got if not torch.equal(got[k], own[k])]
    assert moved and all(k.startswith(TOWER + ".") and "film" not in k for k in moved)
    assert torch.equal(got[TOWER + ".stem.conv.weight"], torch.from_numpy(sd["m0.weight"]))


@pytest.mark.parametrize("source", ["numpy", "torch"])
def test_port_is_pure(source):
    _, variables = _narrow_pair()
    pm = _narrow_port(variables)
    sd = module_order_state_dict(pm, seed=1)
    if source == "torch":
        sd = collections.OrderedDict((k, torch.from_numpy(v)) for k, v in sd.items())
    sd_before = {k: np.array(v) for k, v in sd.items()}
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    as_dict = pm.state_dict()
    for target in (pm, as_dict):
        out = port_torch_efficientnet(sd, target)
        for value in out.values():  # a write to the result reaches no input
            value.add_(1)
    assert_states_equal(pm.state_dict(), before)
    assert_states_equal(as_dict, before)
    assert list(sd) == list(sd_before)
    for key, value in sd_before.items():
        np.testing.assert_array_equal(np.asarray(sd[key]), value)


def _drop_se_fc1(sd):
    return collections.OrderedDict(
        (k, v) for k, v in sd.items() if not k.startswith("features.3.1.block.2.fc1"))


def _first_to_wrong_shape(sd):
    sd = collections.OrderedDict(sd)
    sd[next(iter(sd))] = np.zeros((1, 2, 3, 4), np.float32)
    return sd


def _transpose_last_linear(sd):
    """The classifier's weight in JAX's (in, out) layout."""
    sd = collections.OrderedDict(sd)
    key = [k for k, v in sd.items() if k.endswith(".weight") and v.ndim == 2][-1]
    sd[key] = np.ascontiguousarray(sd[key].T)
    return sd


def _narrow_bn_shape(sd):
    sd = collections.OrderedDict(sd)
    key = next(k for k in sd if k.endswith("running_var"))
    sd[key] = np.ones(sd[key].shape[0] + 1, np.float32)
    return sd


def _narrow_refusal(edit):
    _, variables = _narrow_pair()
    pm = _narrow_port(variables)
    return edit(module_order_state_dict(pm, seed=0)), variables, pm


def _b3_refusal(edit, include_top):
    return (edit(torchvision_state_dict()), _jax_b3_variables(include_top, False),
            EfficientNetB3(include_top=include_top))


REFUSALS = {
    # the classifier's bias and weight dropped: one linear short
    "count": (lambda: _narrow_refusal(lambda sd: collections.OrderedDict(list(sd.items())[:-2])),
              "count mismatch"),
    "shape": (lambda: _narrow_refusal(_first_to_wrong_shape), "mismatch"),
    "linear_shape": (lambda: _narrow_refusal(_transpose_last_linear), "shape mismatch"),
    "bn_shape": (lambda: _narrow_refusal(_narrow_bn_shape), "shape mismatch"),
    "layout_drift": (lambda: _b3_refusal(_drop_se_fc1, True), "count mismatch"),
    "full_dict_into_headless_tower": (lambda: _b3_refusal(lambda sd: sd, False),
                                      "linear count mismatch"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_match_jax(case):
    make, match = REFUSALS[case]
    sd, variables, pm = make()
    with pytest.raises(ValueError, match=match):
        jax_port(sd, variables)
    with pytest.raises(ValueError, match=match):
        port_torch_efficientnet(sd, pm)


def test_headless_tower_takes_the_dict_without_its_classifier():
    sd = torchvision_state_dict(seed=2)
    body = collections.OrderedDict((k, v) for k, v in sd.items()
                                   if not k.startswith("classifier."))
    want = _converted(jax_port(body, _jax_b3_variables(False, False)))
    got = port_torch_efficientnet(body, EfficientNetB3(include_top=False))
    assert_states_equal(got, want)


def test_string_sorted_target_ports_the_same():
    net = EfficientNetB3(include_top=True)
    sd = torchvision_state_dict(seed=3)
    state = net.state_dict()
    shuffled = collections.OrderedDict(sorted(state.items()))
    assert list(shuffled).index("block_2.depthwise.conv.weight") > \
        list(shuffled).index("block_10.depthwise.conv.weight")
    got = port_torch_efficientnet(sd, shuffled)
    assert list(got) == list(shuffled)
    assert_states_equal(got, port_torch_efficientnet(sd, net))


def test_int8_target_is_refused():
    _, variables = _narrow_pair()
    pm = _narrow_port(variables)
    sd = module_order_state_dict(pm, seed=9)
    conv = pm.get_submodule("block_0.depthwise.conv")
    conv.set_int8_(*quantize_per_channel(conv.weight.detach()))
    with pytest.raises(ValueError, match="int8"):
        port_torch_efficientnet(sd, pm)


def test_ported_tower_starts_training_as_a_pretrained_encoder(tmp_path):
    """The README's flow: a torchvision dict without `classifier.*` ported
    into a B3 policy's tower, saved in `pretrain_vision`'s encoder format,
    grafts into a fresh policy (the train CLI's `model.pretrained_encoder`)
    with the tower equal to the source."""
    config = get_config("tiny")
    config.model.image_tokenizer = "efficientnet_b3"
    sd = torchvision_state_dict(seed=5)
    body = collections.OrderedDict((k, v) for k, v in sd.items()
                                   if not k.startswith("classifier."))
    policy = build_policy(config)
    policy.load_state_dict(port_torch_efficientnet(body, policy, submodule_path=TOWER))
    path = str(tmp_path / "b3_imagenet.pt")
    torch.save({"format": pv.ENCODER_FORMAT, "width_coefficient": 1.2, "depth_coefficient": 1.4,
                "token_embedding_size": config.model.token_embedding_size,
                "state_dict": policy.image_tokenizer.encoder.state_dict()}, path)
    fresh = pv.graft_encoder_into_policy(build_policy(config), pv.load_encoder(path))
    tower = fresh.get_submodule(TOWER).state_dict()
    assert torch.equal(tower["stem.conv.weight"], torch.from_numpy(sd["features.0.0.weight"]))
    assert torch.equal(tower["top.bn.running_var"],
                       torch.from_numpy(sd["features.8.1.running_var"]))


def test_load_torch_checkpoint_round_trips(tmp_path):
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.BatchNorm2d(4))
    with torch.no_grad():
        for p in net.parameters():
            p.normal_(generator=torch.Generator().manual_seed(0))
    state = net.state_dict()
    torch.save(state, tmp_path / "state.pth")
    loaded = load_torch_checkpoint(str(tmp_path / "state.pth"))
    assert_states_equal(loaded, state)
    torch.save(net, tmp_path / "module.pth")
    with torch.serialization.safe_globals([torch.nn.Sequential, torch.nn.Conv2d,
                                           torch.nn.BatchNorm2d]):
        loaded = load_torch_checkpoint(str(tmp_path / "module.pth"))
    assert_states_equal(loaded, state)
    with pytest.raises(Exception):  # weights_only: an unlisted class is refused
        load_torch_checkpoint(str(tmp_path / "module.pth"))
