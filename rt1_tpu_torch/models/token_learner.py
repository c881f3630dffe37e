"""TokenLearner (counterpart of `rt1_tpu/models/token_learner.py`).

LayerNorm over channels (eps 1e-6, flax's default) -> 1x1 conv to a
64-wide bottleneck -> tanh-approximate GELU -> 1x1 conv to `num_tokens`
maps -> softmax over h*w -> weighted pooling of the UN-normalised inputs.
NHWC in (B, H, W, C), out (B, num_tokens, C). With `dropout_rate > 0`
(0 in every config, as in JAX) train mode drops after each 1x1 conv,
drawing from `rngs["dropout"]`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from rt1_tpu_torch.models.quant import QuantConv2d
from rt1_tpu_torch.ops.dropout import Rngs, dropout


class TokenLearner(nn.Module):
    def __init__(self, in_channels: int, num_tokens: int = 8, bottleneck_dim: int = 64,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.num_tokens = num_tokens
        self.dropout_rate = dropout_rate
        self.norm = nn.LayerNorm(in_channels, eps=1e-6)
        # Stored as 1x1 convs (the JAX parameter layout); applied as matmuls
        # over the channel axis of the NHWC input.
        self.conv1 = QuantConv2d(in_channels, bottleneck_dim, 1)
        self.conv2 = QuantConv2d(bottleneck_dim, num_tokens, 1)

    def forward(self, inputs: torch.Tensor, train: bool = False, rngs: Rngs = None) -> torch.Tensor:
        b, h, w, c = inputs.shape
        x = self.norm(inputs)
        x = F.linear(x, self.conv1.kernel().flatten(1), self.conv1.bias)
        x = F.gelu(x, approximate="tanh")
        x = dropout(x, self.dropout_rate, train, rngs)
        x = F.linear(x, self.conv2.kernel().flatten(1), self.conv2.bias)
        x = dropout(x, self.dropout_rate, train, rngs)
        maps = x.reshape(b, h * w, self.num_tokens).transpose(1, 2)
        maps = torch.softmax(maps, dim=-1)
        feats = inputs.reshape(b, h * w, c).to(maps.dtype)
        return torch.bmm(maps, feats)
