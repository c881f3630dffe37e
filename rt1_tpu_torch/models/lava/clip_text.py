"""In-graph CLIP text tower for the LAVA "clip" language encoder
(counterpart of `rt1_tpu/models/lava/clip_text.py`).

The OpenAI CLIP text transformer: token embedding + learned positional
embedding, pre-LN causal transformer blocks (LayerNorm epsilon 1e-5,
QuickGELU MLP), a final LayerNorm, pooling at the EOT token (the position
of the largest token id) and a linear text projection. The mask is causal
over the whole context (no padding mask: the pooling ignores the padded
tail). Names follow the JAX module's (`token_embedding`,
`positional_embedding`, `resblocks_<i>/{ln_1, attn, ln_2, c_fc, c_proj}`,
`ln_final`, `text_projection`), so `convert.py` carries a JAX tree across.

`convert_clip_text_state_dict` maps a public OpenAI-CLIP torch state dict
(text side) onto this module's state_dict: the packed `in_proj` splits
into the query, key and value Linears, `mlp.c_fc` / `mlp.c_proj` lose their
scope. Token ids come from `text/clip_bpe.py` under the observation key
`instruction_tokenized_clip`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from rt1_tpu_torch.models.lava.blocks import MultiHeadDotProductAttention

# OpenAI CLIP text-encoder constants (ViT-B checkpoints).
VOCAB_SIZE = 49408
CONTEXT_LENGTH = 77
WIDTH = 512
NUM_LAYERS = 12
NUM_HEADS = 8
EMBED_DIM = 512

# The state_dict prefix of the tower inside SequenceLAVMSE, to freeze it
# (`trainer/bc.py::make_bc_optimizer(frozen_prefixes=...)`); JAX's
# `encoder/text_encoder`.
FROZEN_PREFIX = "encoder.text_encoder"
CLIP_LN_EPS = 1e-5


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's GELU approximation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN block: LN -> causal MHA -> +res; LN -> QuickGELU MLP -> +res."""

    def __init__(self, width: int, num_heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=CLIP_LN_EPS)
        self.attn = MultiHeadDotProductAttention(width, width, num_heads)
        self.ln_2 = nn.LayerNorm(width, eps=CLIP_LN_EPS)
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        y = self.ln_1(x)
        x = x + self.attn(y, y, mask)
        return x + self.c_proj(quick_gelu(self.c_fc(self.ln_2(x))))


class CLIPTextEncoder(nn.Module):
    """tokens (B, context) int -> pooled text features (B, embed_dim)."""

    def __init__(self, vocab_size: int = VOCAB_SIZE, context_length: int = CONTEXT_LENGTH,
                 width: int = WIDTH, num_layers: int = NUM_LAYERS, num_heads: int = NUM_HEADS,
                 embed_dim: int = EMBED_DIM):
        super().__init__()
        self.num_layers = num_layers
        self.embed_dim = embed_dim
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.zeros(context_length, width))
        for i in range(num_layers):
            self.add_module(f"resblocks_{i}", ResidualAttentionBlock(width, num_heads))
        self.ln_final = nn.LayerNorm(width, eps=CLIP_LN_EPS)
        self.text_projection = nn.Parameter(torch.zeros(width, embed_dim))
        # `convert.init_weights`: flax's normal initializers of the two
        # raw parameters.
        self.normal_init = {"positional_embedding": 0.01, "text_projection": width ** -0.5}

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        if tokens.dim() != 2:
            raise ValueError(f"tokens must be (batch, context), got {tuple(tokens.shape)}")
        tokens = tokens.to(torch.long)
        length = tokens.shape[1]
        x = self.token_embedding(tokens) + self.positional_embedding[:length]
        mask = torch.ones((length, length), dtype=torch.bool, device=x.device).tril()
        for i in range(self.num_layers):
            x = getattr(self, f"resblocks_{i}")(x, mask)
        x = self.ln_final(x)
        eot = torch.argmax(tokens, dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return pooled @ self.text_projection


def convert_clip_text_state_dict(state_dict: Dict[str, np.ndarray],
                                 prefix: str = "") -> Dict[str, torch.Tensor]:
    """Public OpenAI-CLIP torch state dict (text side) -> `CLIPTextEncoder`'s
    state_dict, each key under `prefix` (e.g. `FROZEN_PREFIX + "."`).

    Expected keys: token_embedding.weight, positional_embedding,
    transformer.resblocks.N.ln_1.{weight,bias},
    transformer.resblocks.N.attn.{in_proj_weight,in_proj_bias},
    transformer.resblocks.N.attn.out_proj.{weight,bias},
    transformer.resblocks.N.mlp.c_fc.{weight,bias},
    transformer.resblocks.N.mlp.c_proj.{weight,bias},
    ln_final.{weight,bias}, text_projection. The packed `in_proj_weight`
    (3W, W) splits into the query, key and value weights (torch layouts on
    both sides, so nothing transposes)."""
    sd = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32) for k, v in state_dict.items()}
    out = {
        "token_embedding.weight": sd["token_embedding.weight"],
        "positional_embedding": sd["positional_embedding"],
        "ln_final.weight": sd["ln_final.weight"],
        "ln_final.bias": sd["ln_final.bias"],
        "text_projection": sd["text_projection"],
    }
    n_layers = 0
    while f"transformer.resblocks.{n_layers}.ln_1.weight" in sd:
        n_layers += 1
    if n_layers == 0:
        raise KeyError("No transformer.resblocks.* keys in state dict")
    for i in range(n_layers):
        src, dst = f"transformer.resblocks.{i}", f"resblocks_{i}"
        for name in ("query", "key", "value"):
            index = ("query", "key", "value").index(name)
            out[f"{dst}.attn.{name}.weight"] = sd[f"{src}.attn.in_proj_weight"].chunk(3)[index]
            out[f"{dst}.attn.{name}.bias"] = sd[f"{src}.attn.in_proj_bias"].chunk(3)[index]
        out[f"{dst}.attn.out.weight"] = sd[f"{src}.attn.out_proj.weight"]
        out[f"{dst}.attn.out.bias"] = sd[f"{src}.attn.out_proj.bias"]
        for ln in ("ln_1", "ln_2"):
            out[f"{dst}.{ln}.weight"] = sd[f"{src}.{ln}.weight"]
            out[f"{dst}.{ln}.bias"] = sd[f"{src}.{ln}.bias"]
        for fc in ("c_fc", "c_proj"):
            out[f"{dst}.{fc}.weight"] = sd[f"{src}.mlp.{fc}.weight"]
            out[f"{dst}.{fc}.bias"] = sd[f"{src}.mlp.{fc}.bias"]
    return {prefix + k: v for k, v in out.items()}
