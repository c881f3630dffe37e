"""Torchvision EfficientNet-B3 weights into the port's EfficientNet
(counterpart of `rt1_tpu/models/load_pretrained.py`).

The reference loads torchvision's `efficientnet_b3` checkpoint by a blind
ordered zip of state-dict keys, then copies the non-FiLM subset into the
FiLM variant (FiLM layers stay zero-initialised, so the pretrained
behaviour is kept). The JAX package does the same alignment, made explicit
and checked, and so does this module, by the same algorithm:

1. group the source state dict into per-module bundles (conv / batchnorm /
   linear) in key order, `num_batches_tracked` dropped;
2. group the target's state dict into bundles in ARCHITECTURAL order
   (`_structural_key`: a numeric block index, then expand / depthwise / se /
   project, fc1 / fc2, conv / bn), FiLM layers skipped;
3. zip per kind; a count or a shape that differs raises `ValueError`.

Torch to torch, the JAX package's layout conversions are identities: a
conv is OIHW on both sides (depthwise `(C, 1, kh, kw)` included), a linear
`(out, in)`. Their shape checks stay. Values take the target's dtype and
device.

The port's BatchNorm keeps `weight`, `bias`, `running_mean`,
`running_var` as torchvision's does, and is recognised by its running
mean. SE's `fc1` and `fc2` are 1x1 convs with bias on both sides. A target
that holds int8 weights (a quantised serving policy) is refused: port into
the float master, then quantise. torchvision's classifier is one linear,
so a full torchvision state dict does not fit a tower built without the
head (`include_top=False`, the RT-1 encoder's): drop `classifier.*` first.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Mapping, Tuple, Union

import numpy as np
import torch
from torch import nn

KINDS = ("conv", "bn", "linear")


def _as_tensor(value: Any) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach()
    return torch.as_tensor(np.array(value))


def _group_torch(state_dict: Mapping[str, Any]) -> List[Tuple[str, str, Dict[str, torch.Tensor]]]:
    """[(kind, module, tensors)] in state-dict order; tensors keyed by
    their torch leaf (weight, bias, running_mean, running_var)."""
    by_module: Dict[str, Dict[str, torch.Tensor]] = OrderedDict()
    for key, value in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        module, leaf = key.rsplit(".", 1)
        by_module.setdefault(module, {})[leaf] = _as_tensor(value)

    groups = []
    for module, tensors in by_module.items():
        if "running_mean" in tensors:
            kind = "bn"
        elif tensors["weight"].dim() == 4:
            kind = "conv"
        elif tensors["weight"].dim() == 2:
            kind = "linear"
        else:
            raise ValueError(f"Unrecognized torch module {module!r} with "
                             f"weight shape {tuple(tensors['weight'].shape)}")
        groups.append((kind, module, tensors))
    return groups


def _structural_key(path: Tuple[str, ...]) -> Tuple:
    """Sort key putting EfficientNet modules in architectural order.

    A state dict's order is not trusted: one that went through a string
    sort puts `block_10` before `block_2`. The ordered-zip alignment is
    therefore derived from the module names.
    """
    order_top = {"stem": 0, "top": 2, "classifier": 3}
    order_in_block = {"expand": 0, "depthwise": 1, "se": 2, "project": 3}
    order_se = {"fc1": 0, "fc2": 1}
    order_cna = {"conv": 0, "bn": 1}  # within a ConvNormAct
    key: List = []
    for name in path:
        if name.startswith("block_") and name[6:].isdigit():
            key.append((1, int(name[6:]), ""))
        elif name in order_top:
            key.append((order_top[name], -1, ""))
        elif name in order_in_block:
            key.append((order_in_block[name], -1, ""))
        elif name in order_se:
            key.append((order_se[name], -1, ""))
        elif name in order_cna:
            key.append((order_cna[name], -1, ""))
        else:
            key.append((9, -1, name))  # unknown: stable alphabetical tail
    return tuple(key)


def _group_target(state: Mapping[str, torch.Tensor]) -> List[Tuple[str, str, Dict[str, torch.Tensor]]]:
    """[(kind, module, leaves)] of the target in architectural order, FiLM
    layers skipped."""
    by_module: Dict[str, Dict[str, torch.Tensor]] = OrderedDict()
    for key, value in state.items():
        module, leaf = key.rsplit(".", 1)
        by_module.setdefault(module, {})[leaf] = value

    groups = []
    for module, leaves in by_module.items():
        if "film" in module.lower():
            continue
        weight = leaves.get("weight")
        if "weight_scale" in leaves or (weight is not None and weight.dtype == torch.int8):
            raise ValueError(f"target module {module!r} holds int8 weights: port into the "
                             "float master, then quantize")
        if "running_mean" in leaves:
            kind = "bn"
        elif weight is not None and weight.dim() == 4:
            kind = "conv"
        elif weight is not None and weight.dim() == 2:
            kind = "linear"
        else:
            raise ValueError(f"Unrecognized target module {module!r}")
        groups.append((kind, module, leaves))
    groups.sort(key=lambda g: _structural_key(tuple(g[1].split("."))))
    return groups


def port_torch_efficientnet(state_dict: Mapping[str, Any],
                            target: Union[nn.Module, Mapping[str, torch.Tensor]],
                            submodule_path: str = "") -> "OrderedDict[str, torch.Tensor]":
    """Copy a torch EfficientNet state dict into the port's EfficientNet.

    Args:
      state_dict: torch state dict (torchvision efficientnet_b3 layout, or
        any renamed equivalent: only the order of its modules matters), of
        tensors or numpy arrays.
      target: a port module or its state dict.
      submodule_path: dotted prefix of the EfficientNet inside `target`
        (the RT-1 policy's tower is `image_tokenizer.encoder.net`); empty
        for the whole of it.
    Returns:
      A new state dict of all of `target`, the tower's weights ported, each
      at its target tensor's dtype and device. The inputs are unchanged.
    """
    state = target.state_dict() if isinstance(target, nn.Module) else target
    prefix = submodule_path + "." if submodule_path else ""
    sub = OrderedDict((k[len(prefix):], v) for k, v in state.items() if k.startswith(prefix))
    if not sub:
        raise KeyError(f"the target has no key under {submodule_path!r}")

    by_kind_torch: Dict[str, list] = {kind: [] for kind in KINDS}
    for kind, module, tensors in _group_torch(state_dict):
        by_kind_torch[kind].append(tensors)
    by_kind_target: Dict[str, list] = {kind: [] for kind in KINDS}
    for kind, module, leaves in _group_target(sub):
        by_kind_target[kind].append((module, leaves))
    for kind in KINDS:
        n_torch, n_target = len(by_kind_torch[kind]), len(by_kind_target[kind])
        if n_torch != n_target:
            raise ValueError(f"{kind} count mismatch: torch has {n_torch}, "
                             f"target (non-FiLM) has {n_target}")

    out = OrderedDict((k, v.detach().clone()) for k, v in state.items())

    def assign(module: str, leaf: str, value: torch.Tensor) -> None:
        key = prefix + module + "." + leaf
        current = out[key]
        if tuple(current.shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch at {key}: "
                             f"{tuple(current.shape)} vs {tuple(value.shape)}")
        out[key] = value.to(device=current.device, dtype=current.dtype, copy=True)

    for tensors, (module, leaves) in zip(by_kind_torch["conv"], by_kind_target["conv"]):
        # OIHW on both sides: depthwise (C, 1, kh, kw) is the port's layout too.
        if tuple(tensors["weight"].shape) != tuple(leaves["weight"].shape):
            raise ValueError(f"conv shape mismatch: torch {tuple(tensors['weight'].shape)}, "
                             f"target {tuple(leaves['weight'].shape)} at {prefix + module}")
        assign(module, "weight", tensors["weight"])
        if "bias" in tensors and "bias" in leaves:
            assign(module, "bias", tensors["bias"])

    for tensors, (module, leaves) in zip(by_kind_torch["bn"], by_kind_target["bn"]):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            assign(module, leaf, tensors[leaf])

    for tensors, (module, leaves) in zip(by_kind_torch["linear"], by_kind_target["linear"]):
        # (out, in) on both sides: JAX's transpose to (in, out) has no counterpart.
        assign(module, "weight", tensors["weight"])
        if "bias" in tensors and "bias" in leaves:
            assign(module, "bias", tensors["bias"])
    return out


def load_torch_checkpoint(path: str):
    """A .pth state dict, or the `state_dict()` of a saved module, on the
    CPU. Loads with `weights_only=True`: a pickled module's classes must be
    allowed by the caller (`torch.serialization.safe_globals`)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return obj
