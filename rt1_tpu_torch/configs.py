"""Serving configs as plain dataclasses (counterparts of
`rt1_tpu/train/configs/language_table.py` and `tiny.py`).

Only the `model.*` and `data.height/width` fields that the serving path
reads are carried; ml_collections is not a dependency of the port.
`get_config` takes a config name, or the path of the JAX config file
(`rt1_tpu/train/configs/language_table.py`), whose file stem names it —
so one command line drives both packages.
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass
class ModelConfig:
    vocab_size: int = 256
    token_embedding_size: int = 512
    num_layers: int = 8
    layer_size: int = 128          # per-head attention width (key_dim)
    num_heads: int = 8
    feed_forward_size: int = 512   # d_model
    time_sequence_length: int = 6
    use_token_learner: bool = True
    num_image_tokens: int = 8
    # "efficientnet_b3" | "efficientnet_small" (0.35/0.35 scaling) | "tiny"
    image_tokenizer: str = "efficientnet_b3"
    dtype: str = "bfloat16"        # compute dtype: "bfloat16" | "float32"
    action_decode: str = "argmax"  # "argmax" | "expected"
    # "dense" | "fused" ("pallas", the JAX package's name for the fused
    # kernel, maps to "fused").
    attention_impl: str = "dense"


@dataclasses.dataclass
class DataConfig:
    height: int = 256
    width: int = 456


@dataclasses.dataclass
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)


def language_table() -> Config:
    """The flagship: FiLM-EfficientNet-B3 at 256x456, TokenLearner 8 tokens,
    window 6, 8 decoder layers of 8 heads x 128, d_model 512, vocab 256, bf16."""
    return Config()


def tiny() -> Config:
    """The CPU smoke config (`rt1_tpu/train/configs/tiny.py`)."""
    return Config(
        model=ModelConfig(
            vocab_size=32,
            token_embedding_size=16,
            num_layers=2,
            layer_size=8,
            num_heads=2,
            feed_forward_size=16,
            time_sequence_length=3,
            num_image_tokens=2,
            image_tokenizer="tiny",
            dtype="float32",
        ),
        data=DataConfig(height=32, width=56),
    )


CONFIGS = {"language_table": language_table, "tiny": tiny}


def get_config(name: str) -> Config:
    """A config by name ("language_table" | "tiny") or by the path of the
    JAX package's config file of that name."""
    key = os.path.splitext(os.path.basename(name))[0]
    if key not in CONFIGS:
        raise ValueError(f"unknown config {name!r}; choose from {sorted(CONFIGS)}")
    return CONFIGS[key]()
