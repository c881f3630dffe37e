"""Weights across the two packages, and the port's random init.

`state_dict_from_flax(params, batch_stats)` turns the JAX package's
variables (nested dicts of numpy arrays, as `RT1Policy.init` returns them)
into the port's `state_dict`. It is the inverse of
`rt1_tpu/models/load_pretrained.py`:

* conv kernels HWIO -> OIHW, the depthwise `(kh, kw, 1, C)` included
  (-> `(C, 1, kh, kw)`);
* Dense kernels `(in, out)` -> Linear weights `(out, in)` (the
  EfficientNet classifier's `classifier/kernel` -> `classifier.weight`);
* BatchNorm `scale, bias` and statistics `mean, var` -> `weight, bias,
  running_mean, running_var`; LayerNorm `scale` -> `weight`;
* the position `Embed` table -> `Embedding.weight`;
* the MoE expert stacks `moe/wi`, `moe/wo` keep their layout and name
  (and an int8 tree's `wi_scale`, `wo_scale` theirs); the router
  `moe/gate/kernel` is a Dense kernel;
* LAVA's attention (flax `MultiHeadDotProductAttention`): the
  DenseGeneral kernels `(d, h, k)` of query/key/value and `(h, k, d)` of
  `out` become Linear weights `(h*k, d)` / `(d, h*k)`, their `(h, k)`
  biases flatten; CLIP's `positional_embedding` and `text_projection`
  keep their layout and name.

The port names its submodules after the flax ones, so a flax path maps to
a torch key by two renames: the tokenizer passed as `image_tokenizer_def`
is the port's `image_tokenizer`, and flax's auto-named `EfficientNet_0`
is the encoder's `net`. `load_flax_variables` then insists that every
leaf lands on exactly one parameter: leftover or missing keys raise.

An int8 serving tree (JAX's `quantize_tree`: int8 kernels plus the
`quant` collection of `<module>/kernel_scale` leaves) converts the same
way: int8 kernels keep their dtype through the transposes, and each scale
becomes the `<module>.weight_scale` buffer of a quantizable layer
(`models/quant.py`).

`flax_paths(model)` is the inverse map, each state_dict key to its flax
path, checked against `_convert_leaf`: each path is converted forward
and must land on its key.

`load_npz(path)` reads the same tree flattened to `/`-joined flax paths
(`params/transformer/layer_0/ff/kernel`, `batch_stats/...`).

`init_weights` is the port's random init, in flax's initializer families:
lecun-normal kernels and zero biases, zero FiLM projections, LayerNorm
and BatchNorm at identity (scale 1, bias 0, mean 0, var 1), from a seeded
`torch.Generator`; LAVA's dense layers normal(0.05) (`init_std`), a
ResNet block's last BatchNorm scale 0 (`init_scale`), CLIP's raw
parameters normal (`normal_init`). The numbers differ from JAX's.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from rt1_tpu_torch.models.efficientnet import BatchNorm
from rt1_tpu_torch.models.film import FilmConditioning
from rt1_tpu_torch.models.moe import MoEFeedForward

_MODULE_RENAMES = {"image_tokenizer_def": "image_tokenizer", "EfficientNet_0": "net"}
_FLAX_NAMES = {v: k for k, v in _MODULE_RENAMES.items()}
# The flax leaf of each torch leaf but `weight` (which `_flax_leaf` decides).
_FLAX_LEAVES = {
    "bias": ("params", "bias"),
    "running_mean": ("batch_stats", "mean"),
    "running_var": ("batch_stats", "var"),
    "weight_scale": ("quant", "kernel_scale"),
}
# Parameters that keep JAX's layout and name: the MoE expert stacks and
# CLIP's two raw parameters; and the experts' int8 scales.
_RAW_PARAMS = ("wi", "wo", "positional_embedding", "text_projection")
_MOE_SCALES = ("wi_scale", "wo_scale")
# flax's truncated_normal keeps [-2, 2] and rescales so the variance is 1.
_TRUNC_STD = 0.87962566103423978


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, np.asarray(value)


def _convert_leaf(collection: str, path: Tuple[str, ...], value: np.ndarray):
    *modules, leaf = path
    modules = [_MODULE_RENAMES.get(m, m) for m in modules]
    if collection == "quant":
        if leaf in _MOE_SCALES:
            return ".".join(modules + [leaf]), value
        if leaf != "kernel_scale":
            raise ValueError(f"unknown quant leaf {'/'.join(path)}")
        return ".".join(modules + ["weight_scale"]), value
    if collection == "batch_stats":
        names = {"mean": "running_mean", "var": "running_var"}
        if leaf not in names:
            raise ValueError(f"unknown batch_stats leaf {'/'.join(path)}")
        return ".".join(modules + [names[leaf]]), value
    if leaf == "kernel":
        if value.ndim == 4:  # HWIO -> OIHW (depthwise (kh,kw,1,C) -> (C,1,kh,kw))
            value = np.transpose(value, (3, 2, 0, 1))
        elif value.ndim == 2:  # (in, out) -> (out, in)
            value = value.T
        elif value.ndim == 3 and modules[-1] == "out":  # DenseGeneral (h, k, out)
            value = value.reshape(-1, value.shape[-1]).T
        elif value.ndim == 3:  # DenseGeneral (in, h, k)
            value = value.reshape(value.shape[0], -1).T
        else:
            raise ValueError(f"kernel {'/'.join(path)} has rank {value.ndim}")
        return ".".join(modules + ["weight"]), value
    if leaf in ("scale", "embedding"):
        return ".".join(modules + ["weight"]), value
    if leaf in _RAW_PARAMS:  # parameters kept in JAX's layout and name
        return ".".join(modules + [leaf]), value
    if leaf == "bias":  # a DenseGeneral's (h, k) bias flattens
        return ".".join(modules + ["bias"]), value.reshape(-1) if value.ndim == 2 else value
    raise ValueError(f"unknown parameter leaf {'/'.join(path)}")


def state_dict_from_flax(
    params: Mapping[str, Any], batch_stats: Optional[Mapping[str, Any]] = None,
    quant: Optional[Mapping[str, Any]] = None,
) -> Dict[str, torch.Tensor]:
    """Flax `params` (+ `batch_stats`, + an int8 tree's `quant` scales) ->
    the port's state_dict: float32, but int8 kernels stay int8."""
    out: Dict[str, torch.Tensor] = {}
    trees = [("params", params)]
    if batch_stats:
        trees.append(("batch_stats", batch_stats))
    if quant:
        trees.append(("quant", quant))
    for collection, tree in trees:
        for path, value in _flatten(tree):
            key, converted = _convert_leaf(collection, path, value)
            if key in out:
                raise ValueError(f"two flax leaves map to {key!r} (second: {'/'.join(path)})")
            dtype = np.int8 if converted.dtype == np.int8 else np.float32
            out[key] = torch.tensor(np.asarray(converted, dtype=dtype))
    return out


def _flax_leaf(owner: nn.Module, leaf: str) -> Tuple[str, str]:
    """(collection, flax leaf name) of a torch leaf of `owner`."""
    if leaf in _RAW_PARAMS:
        return "params", leaf
    if leaf in _MOE_SCALES:
        return "quant", leaf
    if leaf == "weight":
        if isinstance(owner, nn.Embedding):
            return "params", "embedding"
        return "params", "kernel" if isinstance(owner, (nn.Linear, nn.Conv2d)) else "scale"
    return _FLAX_LEAVES[leaf]


def flax_paths(model: nn.Module) -> Dict[str, str]:
    """Each state_dict key of `model` -> its flax path
    (`params/transformer/layer_0/ff/kernel`, `batch_stats/.../mean`,
    `quant/.../kernel_scale`), checked by converting the path forward with
    `_convert_leaf`, which must give back the key."""
    # Both flax names of the tokenizer convert to `image_tokenizer`; the
    # policy records which one its JAX counterpart uses.
    names = dict(_FLAX_NAMES, image_tokenizer=getattr(model, "tokenizer_flax_name",
                                                      "image_tokenizer_def"))
    out = {}
    for key, value in model.state_dict().items():
        *modules, leaf = key.split(".")
        collection, flax_leaf = _flax_leaf(model.get_submodule(".".join(modules)), leaf)
        path = tuple(names.get(m, m) for m in modules) + (flax_leaf,)
        dummy = np.broadcast_to(np.float32(0), tuple(value.shape))
        if _convert_leaf(collection, path, dummy)[0] != key:
            raise ValueError(f"flax path {'/'.join(path)} does not convert to {key!r}")
        out[key] = "/".join((collection,) + path)
    return out


def load_flax_variables(model: nn.Module, params, batch_stats=None, quant=None) -> None:
    """Copy flax variables into `model`; every leaf must map to exactly one
    parameter or buffer of the same shape, and none may be left over. With
    an int8 tree's `quant` scales, the layers whose kernels are int8 take
    them as int8 weights (`quant.quantize_layers_`)."""
    from rt1_tpu_torch.models.quant import quantize_layers_

    state = state_dict_from_flax(params, batch_stats, quant)
    if quant:
        quantize_layers_(model, state)
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    leftover = sorted(set(state) - set(own))
    if missing or leftover:
        raise KeyError(f"flax tree does not match the model: missing {missing}, leftover {leftover}")
    for key, value in state.items():
        if tuple(own[key].shape) != tuple(value.shape):
            raise ValueError(f"{key}: flax {tuple(value.shape)} vs model {tuple(own[key].shape)}")
    model.load_state_dict(state, strict=True)


def load_npz(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Read `/`-joined flax paths from an .npz into (params, batch_stats)."""
    trees: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    with np.load(path, allow_pickle=False) as z:
        for name in z.files:
            collection, *path = name.split("/")
            if collection not in trees or not path:
                raise ValueError(f"npz key {name!r} is not params/... or batch_stats/...")
            node = trees[collection]
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = np.asarray(z[name])
    return trees["params"], trees["batch_stats"]


def _lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=generator)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random init in flax's families (see the module docstring)."""
    for module in model.modules():
        if isinstance(module, nn.Linear) and getattr(module, "init_std", None):
            # LAVA's dense layers: normal(init_std) kernels and biases.
            nn.init.normal_(module.weight, std=module.init_std, generator=generator)
            nn.init.normal_(module.bias, std=module.init_std, generator=generator)
        elif isinstance(module, nn.Linear):
            _lecun_normal_(module.weight, module.in_features, generator)
            if module.bias is not None:
                nn.init.zeros_(module.bias)
        elif isinstance(module, nn.Conv2d):
            kh, kw = module.kernel_size
            _lecun_normal_(module.weight, kh * kw * module.in_channels // module.groups, generator)
            if module.bias is not None:
                nn.init.zeros_(module.bias)
        elif isinstance(module, MoEFeedForward):
            # variance_scaling(1, fan_in, truncated_normal, batch_axis=0):
            # each expert's fan-in is its own input width.
            for w in (module.wi, module.wo):
                _lecun_normal_(w, w.shape[-2], generator)
        elif isinstance(module, nn.Embedding):
            nn.init.normal_(module.weight, std=1.0 / math.sqrt(module.num_embeddings),
                            generator=generator)
        elif isinstance(module, (nn.LayerNorm, BatchNorm)):
            nn.init.ones_(module.weight)
            nn.init.zeros_(module.bias)
            if isinstance(module, BatchNorm):
                module.running_mean.zero_()
                module.running_var.fill_(1.0)
                if getattr(module, "init_scale", None) == 0.0:
                    nn.init.zeros_(module.weight)
        for name, std in getattr(module, "normal_init", {}).items():
            nn.init.normal_(getattr(module, name), std=std, generator=generator)
    # FiLM starts as the identity: both projections at zero.
    for module in model.modules():
        if isinstance(module, FilmConditioning):
            for proj in (module.projection_add, module.projection_mult):
                nn.init.zeros_(proj.weight)
                nn.init.zeros_(proj.bias)
