"""EfficientNet image encoder with late FiLM (counterpart of
`rt1_tpu/models/encoder.py`), on the tokenizer's `pooling=False` path:
FiLM-EfficientNet (no top) -> 1x1 conv to the token width (no bias) ->
FiLM -> the spatial feature map, NHWC.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from rt1_tpu_torch.models.efficientnet import EfficientNet
from rt1_tpu_torch.models.film import FilmConditioning
from rt1_tpu_torch.models.quant import QuantConv2d
from rt1_tpu_torch.ops.dropout import Rngs


class EfficientNetEncoder(nn.Module):
    def __init__(self, token_embedding_size: int = 512, early_film: bool = True,
                 width_coefficient: float = 1.2, depth_coefficient: float = 1.4,
                 context_dim: int = 512, drop_connect_rate: float = 0.2, remat: bool = False):
        super().__init__()
        self.early_film = early_film
        self.net = EfficientNet(width_coefficient, depth_coefficient,
                                include_film=early_film, context_dim=context_dim,
                                drop_connect_rate=drop_connect_rate, remat=remat)
        self.conv1x1 = QuantConv2d(self.net.top_ch, token_embedding_size, 1, bias=False)
        self.film = FilmConditioning(context_dim, token_embedding_size)

    def forward(self, image: torch.Tensor, context: Optional[torch.Tensor] = None,
                train: bool = False, rngs: Rngs = None) -> torch.Tensor:
        """image: (B, H, W, 3); context: (B, D). Returns (B, h, w, E)."""
        x = image.to(self.conv1x1.compute_dtype).permute(0, 3, 1, 2)
        x = self.net.forward_nchw(x, context if self.early_film else None, train, rngs)
        x = self.film(self.conv1x1(x), context, channel_dim=1)
        return x.permute(0, 2, 3, 1)
