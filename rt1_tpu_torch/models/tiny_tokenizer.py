"""Tiny image tokenizer for the smoke config (counterpart of
`rt1_tpu/models/tiny_tokenizer.py`): a 3x3 stride-2 conv with flax's SAME
padding, ReLU, spatial mean, an optional projected language context, and
one Dense to `num_tokens * emb`. Nothing in it depends on train mode.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from rt1_tpu_torch.models.quant import QuantConv2d, QuantLinear


def same_padding(size: int, kernel: int, stride: int):
    """(low, high) padding of XLA's SAME convention along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class TinyImageTokenizer(nn.Module):
    def __init__(self, num_tokens: int = 2, emb: int = 16, context_dim: int = 512):
        super().__init__()
        self.num_tokens = num_tokens
        self.emb = emb
        self.conv = QuantConv2d(3, 8, 3, stride=2)
        self.ctx_proj = QuantLinear(context_dim, 8)
        self.tok = QuantLinear(16, num_tokens * emb)

    def forward(self, image: torch.Tensor, context: Optional[torch.Tensor] = None,
                train: bool = False, rngs=None) -> torch.Tensor:
        del train, rngs
        b, t, h, w, c = image.shape
        x = image.reshape(b * t, h, w, c).to(self.conv.compute_dtype).permute(0, 3, 1, 2)
        ph, pw = same_padding(h, 3, 2), same_padding(w, 3, 2)
        x = F.relu(self.conv(F.pad(x, (pw[0], pw[1], ph[0], ph[1]))))
        x = x.mean(dim=(2, 3))  # (b*t, 8)
        if context is None:
            raise ValueError("TinyImageTokenizer without context changes its input width")
        ctx = context.reshape(b * t, -1).to(x.dtype)
        x = torch.cat([x, self.ctx_proj(ctx)], dim=-1)
        return self.tok(x).reshape(b, t, self.num_tokens, self.emb)
