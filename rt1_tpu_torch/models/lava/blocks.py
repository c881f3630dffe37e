"""Shared LAVA building blocks (counterpart of `rt1_tpu/models/lava/blocks.py`).

Parity sources: reference `networks/dense_resnet.py` (residual MLP),
`networks/lava.py:101-218` (sinusoidal 1-D/2-D position encodings),
`:268-371` (prenorm cross/self attention layers + temporal transformer).

Submodules carry the names flax gives them (`Dense_0`, `LayerNorm_1`,
`MultiHeadDotProductAttention_0`, ...), so `convert.py` maps a JAX tree
onto the port by name. The dense layers use the reference's normal(0.05)
init for kernel and bias (`LavaDense`, which `convert.init_weights`
reads); LayerNorm has flax's epsilon, 1e-6. Attention is plain torch ops,
as it is XLA code (flax's `MultiHeadDotProductAttention`) in JAX. Modules
compute in float32: LAVA has no dtype field.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rt1_tpu_torch.ops.dropout import Rngs, dropout

LN_EPS = 1e-6


class LavaDense(nn.Linear):
    """`nn.Dense(kernel_init=normal(0.05), bias_init=normal(0.05))`."""

    init_std = 0.05


def layer_norm(features: int, eps: float = LN_EPS) -> nn.LayerNorm:
    return nn.LayerNorm(features, eps=eps)


class MultiHeadDotProductAttention(nn.Module):
    """flax's `MultiHeadDotProductAttention` at its default widths: q from
    `inputs_q`, k and v from `inputs_kv`, the query's width split into
    `num_heads` heads and projected back to it; q is scaled by
    1/sqrt(head_dim) before the product, the softmax is float32, masked
    logits take the dtype's minimum. The DenseGeneral kernels `(in, h, k)`
    / `(h, k, out)` are Linear weights here (`convert.py` reshapes them)."""

    def __init__(self, q_features: int, kv_features: int, num_heads: int):
        super().__init__()
        if q_features % num_heads:
            raise ValueError(f"width {q_features} is not divisible by num_heads {num_heads}")
        self.num_heads = num_heads
        self.head_dim = q_features // num_heads
        self.query = nn.Linear(q_features, q_features)
        self.key = nn.Linear(kv_features, q_features)
        self.value = nn.Linear(kv_features, q_features)
        self.out = nn.Linear(q_features, q_features)

    def forward(self, inputs_q: torch.Tensor, inputs_kv: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """inputs_q (b, q, d_q), inputs_kv (b, k, d_kv); mask broadcastable
        to (b, h, q, k), True = attend."""
        b, lq, _ = inputs_q.shape
        lk = inputs_kv.shape[1]
        h, d = self.num_heads, self.head_dim
        q = self.query(inputs_q).view(b, lq, h, d) / math.sqrt(d)
        k = self.key(inputs_kv).view(b, lk, h, d)
        v = self.value(inputs_kv).view(b, lk, h, d)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        probs = torch.softmax(logits.float(), dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, lq, h * d)
        return self.out(out)


class ResnetDenseBlock(nn.Module):
    """relu -> Dense(w/4) -> relu -> Dense(w/4) -> relu -> Dense(w) + skip."""

    def __init__(self, width: int):
        super().__init__()
        self.Dense_0 = LavaDense(width, width // 4)
        self.Dense_1 = LavaDense(width // 4, width // 4)
        self.Dense_2 = LavaDense(width // 4, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.Dense_0(F.relu(x))
        y = self.Dense_1(F.relu(y))
        y = self.Dense_2(F.relu(y))
        return x + y


class DenseResnet(nn.Module):
    """Dense projection + N residual MLP blocks (JAX's `value_net=False`,
    the only way the LAVA heads build it)."""

    def __init__(self, in_features: int, width: int, num_blocks: int):
        super().__init__()
        self.num_blocks = num_blocks
        self.Dense_0 = LavaDense(in_features, width)
        for i in range(num_blocks):
            self.add_module(f"ResnetDenseBlock_{i}", ResnetDenseBlock(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Dense_0(x)
        for i in range(self.num_blocks):
            x = getattr(self, f"ResnetDenseBlock_{i}")(x)
        return x


def sinusoidal_position_encoding(max_len: int, d_feature: int,
                                 max_timescale: float = 1.0e4) -> np.ndarray:
    """(1, max_len, d_feature) fixed sin/cos table."""
    pe = np.zeros((max_len, d_feature), dtype=np.float32)
    position = np.arange(0, max_len)[:, None]
    div_term = np.exp(np.arange(0, d_feature, 2) * -(np.log(max_timescale) / d_feature))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe[None]


def positional_encoding_2d(d_model: int, height: int, width: int,
                           flatten: bool = True) -> np.ndarray:
    """(1, h*w, d) fixed 2-D sin/cos table: half the channels encode width
    position, half encode height (reference `positional_encoding2d:189-218`)."""
    if d_model % 4 != 0:
        raise ValueError(f"2d sincos needs d_model % 4 == 0, got {d_model}")
    pe = np.zeros([d_model, height, width], dtype=np.float32)
    half = d_model // 2
    div_term = np.exp(np.arange(0.0, half, 2) * -(np.log(10000.0) / half))
    pos_w = np.arange(0.0, width)[:, None]
    pos_h = np.arange(0.0, height)[:, None]
    pe[0:half:2] = np.tile(np.transpose(np.sin(pos_w * div_term))[:, None, :], [1, height, 1])
    pe[1:half:2] = np.tile(np.transpose(np.cos(pos_w * div_term))[:, None, :], [1, height, 1])
    pe[half::2] = np.tile(np.transpose(np.sin(pos_h * div_term))[:, :, None], [1, 1, width])
    pe[half + 1::2] = np.tile(np.transpose(np.cos(pos_h * div_term))[:, :, None], [1, 1, width])
    if flatten:
        pe = np.reshape(pe, [height * width, d_model])
    else:
        pe = np.reshape(pe, [height, width, d_model])
    return pe[None]


class PrenormPixelLangEncoder(nn.Module):
    """Cross-attention: language queries attend over the visual sentence;
    the residual is on the language path only."""

    def __init__(self, d_lang: int, d_pixel: int, num_heads: int, dff: int,
                 dropout_rate: float = 0.1):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.LayerNorm_0 = layer_norm(d_pixel)
        self.LayerNorm_1 = layer_norm(d_lang)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(d_lang, d_pixel,
                                                                          num_heads)
        self.LayerNorm_2 = layer_norm(d_lang)
        self.Dense_0 = LavaDense(d_lang, dff)
        self.Dense_1 = LavaDense(dff, dff)

    def forward(self, pixel_x: torch.Tensor, lang_x: torch.Tensor, train: bool = False,
                rngs: Rngs = None) -> torch.Tensor:
        attended = self.MultiHeadDotProductAttention_0(self.LayerNorm_1(lang_x),
                                                       self.LayerNorm_0(pixel_x))
        x = lang_x + dropout(attended, self.dropout_rate, train, rngs)
        y = self.Dense_1(F.relu(self.Dense_0(self.LayerNorm_2(x))))
        return x + dropout(y, self.dropout_rate, train, rngs)


class PrenormEncoderLayer(nn.Module):
    """Standard prenorm self-attention block."""

    def __init__(self, d_model: int, num_heads: int, dff: int, dropout_rate: float = 0.1):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.LayerNorm_0 = layer_norm(d_model)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(d_model, d_model,
                                                                          num_heads)
        self.LayerNorm_1 = layer_norm(d_model)
        self.Dense_0 = LavaDense(d_model, dff)
        self.Dense_1 = LavaDense(dff, dff)

    def forward(self, x: torch.Tensor, train: bool = False, rngs: Rngs = None) -> torch.Tensor:
        y = self.LayerNorm_0(x)
        y = self.MultiHeadDotProductAttention_0(y, y)
        x = x + dropout(y, self.dropout_rate, train, rngs)
        y = self.Dense_1(F.relu(self.Dense_0(self.LayerNorm_1(x))))
        return x + dropout(y, self.dropout_rate, train, rngs)


class TemporalTransformer(nn.Module):
    """Self-attention over frames, mean-pooled (reference `:336-371`)."""

    def __init__(self, in_features: int, num_layers: int, d_model: int, num_heads: int,
                 dff: int, sequence_length: int):
        super().__init__()
        self.num_layers = num_layers
        self.d_model = d_model
        self.Dense_0 = LavaDense(in_features, d_model)
        for i in range(num_layers):
            self.add_module(f"PrenormEncoderLayer_{i}",
                            PrenormEncoderLayer(d_model, num_heads, dff, dropout_rate=0.1))
        self.LayerNorm_0 = layer_norm(d_model)
        self.register_buffer(
            "position_table",
            torch.from_numpy(sinusoidal_position_encoding(sequence_length, d_model)),
            persistent=False)

    def forward(self, x: torch.Tensor, train: bool = False, rngs: Rngs = None) -> torch.Tensor:
        x = self.Dense_0(x) * math.sqrt(self.d_model)
        x = x + self.position_table[:, :x.shape[1]]
        x = dropout(x, 0.1, train, rngs)
        for i in range(self.num_layers):
            x = getattr(self, f"PrenormEncoderLayer_{i}")(x, train, rngs)
        return self.LayerNorm_0(x.mean(dim=1))
