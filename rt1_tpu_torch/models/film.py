"""FiLM conditioning layer (counterpart of `rt1_tpu/models/film.py`).

Two zero-initialised projections of the conditioning vector give
per-channel (gamma, beta); the output is `(1 + gamma) * F + beta`.
"""

from __future__ import annotations

import torch
from torch import nn

from rt1_tpu_torch.models.quant import QuantLinear


class FilmConditioning(nn.Module):
    def __init__(self, context_dim: int, num_channels: int):
        super().__init__()
        self.projection_add = QuantLinear(context_dim, num_channels)
        self.projection_mult = QuantLinear(context_dim, num_channels)

    def forward(
        self, conv_filters: torch.Tensor, conditioning: torch.Tensor, channel_dim: int = -1
    ) -> torch.Tensor:
        """`conv_filters` is NHWC by default (the JAX layout); the conv tower
        passes `channel_dim=1` for its NCHW activations."""
        conditioning = conditioning.to(self.projection_add.compute_dtype)
        add = self.projection_add(conditioning)
        mult = self.projection_mult(conditioning)
        shape = [conv_filters.shape[0]] + [1] * (conv_filters.dim() - 1)
        shape[channel_dim] = conv_filters.shape[channel_dim]
        return (1.0 + mult.view(shape)) * conv_filters + add.view(shape)
