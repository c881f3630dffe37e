"""TokenLearner (counterpart of `rt1_tpu/models/token_learner.py`).

LayerNorm over channels (eps 1e-6, flax's default) -> 1x1 conv to a
64-wide bottleneck -> tanh-approximate GELU -> 1x1 conv to `num_tokens`
maps -> softmax over h*w -> weighted pooling of the UN-normalised inputs.
NHWC in (B, H, W, C), out (B, num_tokens, C).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class TokenLearner(nn.Module):
    def __init__(self, in_channels: int, num_tokens: int = 8, bottleneck_dim: int = 64):
        super().__init__()
        self.num_tokens = num_tokens
        self.norm = nn.LayerNorm(in_channels, eps=1e-6)
        # Stored as 1x1 convs (the JAX parameter layout); applied as matmuls
        # over the channel axis of the NHWC input.
        self.conv1 = nn.Conv2d(in_channels, bottleneck_dim, 1)
        self.conv2 = nn.Conv2d(bottleneck_dim, num_tokens, 1)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        b, h, w, c = inputs.shape
        x = self.norm(inputs)
        x = F.linear(x, self.conv1.weight.flatten(1), self.conv1.bias)
        x = F.gelu(x, approximate="tanh")
        x = F.linear(x, self.conv2.weight.flatten(1), self.conv2.bias)
        maps = x.reshape(b, h * w, self.num_tokens).transpose(1, 2)
        maps = torch.softmax(maps, dim=-1)
        feats = inputs.reshape(b, h * w, c).to(maps.dtype)
        return torch.bmm(maps, feats)
