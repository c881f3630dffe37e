"""Low-precision serving: quantizable layers and quantize-at-restore
(counterpart of `rt1_tpu/models/quant.py`, with its own copy of the quant
plan of `rt1_tpu/parallel/plan.py`).

* **Quantizable layers.** `QuantLinear` / `QuantConv2d` are `nn.Linear` /
  `nn.Conv2d` with one change: the weight they apply is `kernel()`. With a
  float weight that is the weight itself, so the train path and every
  float serving path compute exactly as the stock layers. With an int8
  weight (a non-grad int8 tensor, so resident bytes really drop) it is
  `(w_int8.float() * scale)` cast to the compute dtype: JAX's
  `maybe_dequantize` (in float32, the scale's dtype) followed by flax's
  promotion to `dtype`. The dequant is plain torch ops, as the XLA code it
  replaces is; an int8 weight with no scale raises.
* **Quantize-at-restore.** `quantize_tree` turns an f32 master
  `state_dict` into the serving one: per-output-channel scales
  `max|w| / 127` (1.0 for an all-zero channel), weights rounded half to
  even and clipped to int8, scales as `<module>.weight_scale` buffers (the
  JAX `quant` collection's `<module>/kernel_scale`). Torch layouts put the
  output channel at dim 0 (Linear (out, in), Conv2d (cout, cin/g, kh, kw)),
  where flax puts it last, so the max runs over every other dim; the int8
  values and scales equal JAX's bit for bit after transposition. The MoE
  expert stacks keep JAX's layout (`wi` (E, d, ff), `wo` (E, ff, d)), so
  theirs is the last dim: one scale per output column, shared by the
  experts, as `<moe>.wi_scale` / `wo_scale` (JAX's `quant/.../moe/wi_scale`).
* **Which leaves.** The rules below decide each leaf by the same regexes
  over its FLAX path, which `convert.flax_paths` derives from the
  converter's own mapping.

Quantize a policy only after it is cast to its compute dtype: `nn.Module.to`
casts every floating buffer, the float32 scales included.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

INFERENCE_DTYPES = ("f32", "bf16", "int8")
INT8_MAX = 127
SCALE_SUFFIX = "_scale"

# Quantization groups: first matching rule wins; an unmatched path serves
# at the master dtype.
QUANT_INT8 = "int8"   # per-output-channel int8 weights + f32 scale sidecar
QUANT_F32 = "f32"     # never quantized (master/compute dtype)


def check_inference_dtype(mode: str) -> str:
    if mode not in INFERENCE_DTYPES:
        raise ValueError(f"inference_dtype must be one of {INFERENCE_DTYPES}, got {mode!r}")
    return mode


# ------------------------------------------------------------- quant plan


def rt1_quant_rules() -> List[Tuple[str, str]]:
    """The quant plan, a copy of `rt1_tpu/parallel/plan.py::rt1_quant_rules`:
    ordered (flax-path regex, group). int8 covers the matmul/conv weights;
    embeddings, the action head, norms, biases, BatchNorm statistics and
    the MoE router are listed full precision explicitly."""
    return [
        (r"transformer/(token_emb|position_emb|output_tokens)/", QUANT_F32),
        (r"moe/gate/kernel$", QUANT_F32),
        (r"classifier/", QUANT_F32),
        (r"(norm_\d+|norm|bn)/(scale|bias|mean|var)$", QUANT_F32),
        (r"transformer/layer_\d+/attn/(query|key|value|out)/kernel$", QUANT_INT8),
        (r"transformer/layer_\d+/ff/kernel$", QUANT_INT8),
        (r"moe/(wi|wo)$", QUANT_INT8),
        (r"projection_(add|mult)/kernel$", QUANT_INT8),
        (r"(conv|conv1|conv2|conv1x1|fc1|fc2)/kernel$", QUANT_INT8),
        (r"image_tokenizer_def/(ctx_proj|tok)/kernel$", QUANT_INT8),
    ]


def quant_group_for_path(path: str, rules: Optional[Sequence[Tuple[str, str]]] = None) -> str:
    """The first matching rule's group; QUANT_F32 when none matches."""
    for pattern, group in rules if rules is not None else rt1_quant_rules():
        if re.search(pattern, path):
            return group
    return QUANT_F32


def _ranked_paths(model: nn.Module):
    """(state_dict key, flax path, tensor) for every leaf of `model`."""
    from rt1_tpu_torch.convert import flax_paths

    state = model.state_dict()
    paths = flax_paths(model)
    return [(key, paths[key], value) for key, value in state.items()]


def quant_coverage(model: nn.Module, rules: Optional[Sequence[Tuple[str, str]]] = None) -> List[str]:
    """Flax paths of rank >= 2 leaves that no rule decided."""
    rules = rules if rules is not None else rt1_quant_rules()
    return [
        path for _, path, value in _ranked_paths(model)
        if value.dim() >= 2 and not any(re.search(p, path) for p, _ in rules)
    ]


def _is_int8_leaf(path: str, value, rules) -> bool:
    return (path.startswith("params/") and len(value.shape) >= 2
            and quant_group_for_path(path, rules) == QUANT_INT8)


def quantized_paths(model: nn.Module, rules: Optional[Sequence[Tuple[str, str]]] = None) -> List[str]:
    """Flax paths (`params/...`) an int8 restore quantizes."""
    rules = rules if rules is not None else rt1_quant_rules()
    return [path for _, path, value in _ranked_paths(model) if _is_int8_leaf(path, value, rules)]


# ------------------------------------------------------------------ layers


class _Quantizable:
    """What `QuantLinear` and `QuantConv2d` share: the applied weight."""

    weight: torch.Tensor
    weight_scale: Optional[torch.Tensor]

    @property
    def compute_dtype(self) -> torch.dtype:
        if self.weight.is_floating_point():
            return self.weight.dtype
        return self._compute_dtype

    def kernel(self) -> torch.Tensor:
        """The weight to apply: the float weight itself, or the int8 one
        dequantized in float32 and cast to the compute dtype."""
        w = self.weight
        if w.dtype != torch.int8:
            return w
        if self.weight_scale is None:
            raise ValueError(
                f"{type(self).__name__}: weight is int8 but no weight_scale is set; quantized "
                "serving weights must be built by rt1_tpu_torch.models.quant.quantize_tree"
            )
        scale = self.weight_scale.view((-1,) + (1,) * (w.dim() - 1))
        return (w.to(scale.dtype) * scale).to(self._compute_dtype)

    def set_int8_(self, q: torch.Tensor, scale: torch.Tensor) -> None:
        """Hold `q` (int8, this weight's shape) and its per-output-channel
        `scale` in place of the float weight, whose dtype stays the compute
        dtype."""
        if q.dtype != torch.int8 or tuple(q.shape) != tuple(self.weight.shape):
            raise ValueError(f"int8 weight {tuple(q.shape)}/{q.dtype} does not fit "
                             f"{tuple(self.weight.shape)}")
        self._compute_dtype = self.compute_dtype
        self.weight = nn.Parameter(q, requires_grad=False)
        self.weight_scale = scale


class QuantLinear(_Quantizable, nn.Linear):
    """`nn.Linear` that applies `kernel()` (flax's `QuantDense`)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.register_buffer("weight_scale", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.kernel(), self.bias)


class QuantConv2d(_Quantizable, nn.Conv2d):
    """`nn.Conv2d` that applies `kernel()` (flax's `QuantConv`)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.register_buffer("weight_scale", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.kernel(), self.bias)


# ------------------------------------------------------------ quantization


def quantize_per_channel(w: torch.Tensor, channel_dim: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of `w`, output
    channel at `channel_dim` (0 for torch's Linear/Conv2d layouts, -1 for
    the MoE experts' JAX layout): (w_int8, scale (cout,) float32),
    `w ~ w_int8 * scale`."""
    w = torch.as_tensor(w).float()
    if w.dim() < 2:
        raise ValueError(f"per-channel quantization needs rank >= 2, got shape {tuple(w.shape)}")
    channel_dim %= w.dim()
    amax = w.abs().amax(dim=tuple(d for d in range(w.dim()) if d != channel_dim))
    # A tensor divisor, not the Python int: CUDA divides by a host scalar
    # as a multiply by its reciprocal, which is not numpy's rounding.
    scale = torch.where(amax > 0, amax / torch.full_like(amax, INT8_MAX), torch.ones_like(amax))
    shape = [1] * w.dim()
    shape[channel_dim] = -1
    q = torch.clamp(torch.round(w / scale.view(shape)), -INT8_MAX, INT8_MAX).to(torch.int8)
    return q, scale


def channel_dim(key: str) -> int:
    """The output-channel dim of a state_dict leaf: 0 for a layer's
    `weight` (torch layouts), -1 for a parameter kept in JAX's layout (the
    MoE experts `wi`, `wo`)."""
    return 0 if key.endswith(".weight") else -1


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of `quantize_per_channel` (tests, error bounds)."""
    return q.float() * scale.view((-1,) + (1,) * (q.dim() - 1))


def scale_key(key: str) -> str:
    """`a.b.weight` -> `a.b.weight_scale`."""
    return key + SCALE_SUFFIX


def quantize_tree(state: Mapping[str, torch.Tensor], paths: Mapping[str, str],
                  rules: Optional[Sequence[Tuple[str, str]]] = None) -> Dict[str, torch.Tensor]:
    """f32 master state_dict -> int8 serving state_dict. `paths` maps each
    key to its flax path (`convert.flax_paths`); the rank >= 2 `params`
    leaves in the int8 group become int8, each followed by its
    `<key>_scale`; everything else passes through. Deterministic, so a
    standby checkpoint requantizes onto the served dtypes exactly."""
    rules = rules if rules is not None else rt1_quant_rules()
    out: Dict[str, torch.Tensor] = {}
    n = 0
    for key, value in state.items():
        value = torch.as_tensor(value)
        if _is_int8_leaf(paths[key], value, rules):
            out[key], out[scale_key(key)] = quantize_per_channel(value, channel_dim(key))
            n += 1
        else:
            out[key] = value
    if n == 0:
        raise ValueError("quantize_tree: no leaf matched an int8 quant rule; check "
                         "rt1_quant_rules against this model's flax paths")
    return out


def cast_tree(state: Mapping[str, torch.Tensor], dtype: torch.dtype = torch.bfloat16,
              skip: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
    """Every floating leaf (but those in `skip`) cast to `dtype`."""
    skip = set(skip)
    return {
        k: v.to(dtype) if v.is_floating_point() and k not in skip else v
        for k, v in ((k, torch.as_tensor(v)) for k, v in state.items())
    }


def serving_preparer(inference_dtype: str, paths: Mapping[str, str], compute_dtype: torch.dtype,
                     device, rules: Optional[Sequence[Tuple[str, str]]] = None,
                     routers: Sequence[str] = ()
                     ) -> Callable[[Mapping[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """The f32-master -> serving state_dict transform of an engine mode, on
    `device`. f32 casts to the compute dtype (the port holds its weights
    there; JAX keeps f32 masters and casts at use: same outputs, other
    bytes); bf16 casts every float leaf to bfloat16; int8 quantizes on the
    device and casts the rest to the compute dtype, scales staying f32.
    The MoE `routers` (`moe.router_names`) stay float32, as the model holds
    them: exact in f32 and int8, as a `dtype=float32` Dense computes on
    JAX's f32 masters; rounded to bfloat16 in bf16, as JAX's `cast_tree`
    casts them too."""
    check_inference_dtype(inference_dtype)
    routers = list(routers)

    def prepare(master: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        on_device = {k: torch.as_tensor(v).to(device) for k, v in master.items()}
        if inference_dtype == "bf16":
            served = cast_tree(on_device, torch.bfloat16)
            served.update({k: served[k].float() for k in routers})
            return served
        if inference_dtype == "int8":
            served = quantize_tree(on_device, paths, rules)
            scales = [k for k in served if k not in on_device]
            return cast_tree(served, compute_dtype, skip=scales + routers)
        return cast_tree(on_device, compute_dtype, skip=routers)

    return prepare


def quantize_layers_(model: nn.Module, serving: Mapping[str, torch.Tensor]) -> int:
    """Give every quantizable layer whose weight is int8 in `serving`, and
    every MoE expert stack, the int8 weight and scale it holds; returns the
    number of leaves."""
    from rt1_tpu_torch.models.moe import QUANT_PARAMS, MoEFeedForward

    n = 0
    for name, module in model.named_modules():
        if isinstance(module, MoEFeedForward):
            for leaf in QUANT_PARAMS:
                key = f"{name}.{leaf}" if name else leaf
                value = serving.get(key)
                if value is not None and value.dtype == torch.int8:
                    scale = serving.get(scale_key(key))
                    if scale is None:
                        raise ValueError(f"{key} is int8 but {scale_key(key)} is missing")
                    module.set_int8_(leaf, value, scale)
                    n += 1
            continue
        if not isinstance(module, _Quantizable):
            continue
        key = f"{name}.weight" if name else "weight"
        value = serving.get(key)
        if value is not None and value.dtype == torch.int8:
            scale = serving.get(scale_key(key))
            if scale is None:
                raise ValueError(f"{key} is int8 but {scale_key(key)} is missing")
            module.set_int8_(value, scale)
            n += 1
    return n


# ---------------------------------------------------------- byte accounting


def tree_bytes(state: Mapping[str, torch.Tensor]) -> int:
    """Total bytes of a state_dict's leaves."""
    return int(sum(v.numel() * v.element_size() for v in state.values()))


def quant_byte_report(config, rules: Optional[Sequence[Tuple[str, str]]] = None) -> Dict[str, Any]:
    """Per-dtype serving param bytes of a config, from shapes (the policy
    is built on the meta device), counted as JAX's `quant_byte_report`
    counts them: f32 = 4 bytes a value, bf16 = 2, int8 = 1 a quantized
    value plus a float32 scale per output channel and 4 bytes elsewhere."""
    from rt1_tpu_torch.eval.restore import build_policy

    rules = rules if rules is not None else rt1_quant_rules()
    with torch.device("meta"):
        policy = build_policy(config)
    f32 = bf16 = int8 = quantized = 0
    for key, path, value in _ranked_paths(policy):
        n = int(np.prod(value.shape))
        f32 += 4 * n
        bf16 += 2 * n
        if _is_int8_leaf(path, value, rules):
            int8 += n + 4 * int(value.shape[channel_dim(key)])
            quantized += 1
        else:
            int8 += 4 * n
    return {
        "config": str(config.model.image_tokenizer),
        "quantized_leaves": quantized,
        "f32_bytes": f32,
        "bf16_bytes": bf16,
        "int8_bytes": int8,
        "bf16_reduction": round(f32 / bf16, 3),
        "int8_reduction": round(f32 / int8, 3) if int8 else 0.0,
    }
