"""RT-1 contextual image tokenizer (counterpart of
`rt1_tpu/models/image_tokenizer.py`): fold time into batch, run the
FiLM-EfficientNet encoder to a spatial map, then TokenLearner down to
`num_tokens` tokens per frame (or the flattened map without it).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from rt1_tpu_torch.models.encoder import EfficientNetEncoder
from rt1_tpu_torch.models.token_learner import TokenLearner
from rt1_tpu_torch.ops.dropout import Rngs


class RT1ImageTokenizer(nn.Module):
    def __init__(self, embedding_output_dim: int = 512, use_token_learner: bool = True,
                 num_tokens: int = 8, width_coefficient: float = 1.2,
                 depth_coefficient: float = 1.4, context_dim: int = 512,
                 drop_connect_rate: float = 0.2, remat: bool = False):
        super().__init__()
        self.embedding_output_dim = embedding_output_dim
        self.use_token_learner = use_token_learner
        self.num_tokens = num_tokens
        self.encoder = EfficientNetEncoder(
            token_embedding_size=embedding_output_dim,
            early_film=True,
            width_coefficient=width_coefficient,
            depth_coefficient=depth_coefficient,
            context_dim=context_dim,
            drop_connect_rate=drop_connect_rate,
            remat=remat,
        )
        if use_token_learner:
            self.token_learner = TokenLearner(embedding_output_dim, num_tokens=num_tokens)

    def forward(self, image: torch.Tensor, context: Optional[torch.Tensor] = None,
                train: bool = False, rngs: Rngs = None) -> torch.Tensor:
        """image: (B, T, H, W, 3); context: (B, T, D). Returns (B, T, N, E)."""
        b, t, h, w, c = image.shape
        image = image.reshape(b * t, h, w, c)
        if context is not None:
            context = context.reshape(b * t, -1)
        feats = self.encoder(image, context=context, train=train, rngs=rngs)  # (B*T, h', w', E)
        if self.use_token_learner:
            tokens = self.token_learner(feats, train, rngs)
            return tokens.reshape(b, t, self.num_tokens, self.embedding_output_dim)
        fh, fw = feats.shape[1], feats.shape[2]
        return feats.reshape(b, t, fh * fw, self.embedding_output_dim)
