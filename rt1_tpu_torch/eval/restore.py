"""Build the serving engine from a config and weights (counterpart of
`rt1_tpu/eval/restore.py::build_serve_engine`).

Weights are f32 masters — from the port's seeded random init, from the
JAX package's variables saved as an .npz of `/`-joined flax paths
(`convert.load_npz`), or from the newest checkpoint the port's trainer
wrote under `<workdir>/checkpoints` — cast ONCE to `config.model.dtype`
when the policy moves to its device. The JAX package's restore notes that
this cast at build equals flax's cast at use.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from rt1_tpu_torch import resolve_device
from rt1_tpu_torch.configs import Config
from rt1_tpu_torch.convert import init_weights, load_flax_variables, load_npz
from rt1_tpu_torch.models.image_tokenizer import RT1ImageTokenizer
from rt1_tpu_torch.models.rt1 import RT1Policy
from rt1_tpu_torch.models.tiny_tokenizer import TinyImageTokenizer
from rt1_tpu_torch.models.transformer import normalize_attention_impl
from rt1_tpu_torch.serve.engine import PolicyEngine
from rt1_tpu_torch.specs import language_table_action_space
from rt1_tpu_torch.trainer.checkpoints import load_checkpoint

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
RANDOM_INIT_SEED = 0


def build_policy(config: Config, attention_impl: Optional[str] = None) -> RT1Policy:
    """The policy `config.model` (with `config.regularization`) describes,
    on the CPU in float32, with default (not yet initialised) weights.
    `attention_impl` overrides the config's ("dense" | "fused" | "pallas")."""
    m = config.model
    reg = config.regularization
    if not m.use_token_learner:
        raise ValueError("use_token_learner=False is not servable: the token count "
                         "per frame would depend on the input resolution")
    if m.image_tokenizer == "tiny":
        tokenizer = TinyImageTokenizer(num_tokens=m.num_image_tokens, emb=m.token_embedding_size)
    elif m.image_tokenizer in ("efficientnet_b3", "efficientnet_small"):
        coeff = (0.35, 0.35) if m.image_tokenizer == "efficientnet_small" else (1.2, 1.4)
        tokenizer = RT1ImageTokenizer(
            embedding_output_dim=m.token_embedding_size,
            use_token_learner=m.use_token_learner,
            num_tokens=m.num_image_tokens,
            width_coefficient=coeff[0],
            depth_coefficient=coeff[1],
            drop_connect_rate=reg.drop_connect_rate,
        )
    else:
        raise ValueError(f"unknown image_tokenizer {m.image_tokenizer!r}")
    return RT1Policy(
        action_space=language_table_action_space(),
        vocab_size=m.vocab_size,
        token_embedding_size=m.token_embedding_size,
        num_layers=m.num_layers,
        layer_size=m.layer_size,
        num_heads=m.num_heads,
        feed_forward_size=m.feed_forward_size,
        time_sequence_length=m.time_sequence_length,
        num_image_tokens=m.num_image_tokens,
        image_tokenizer=tokenizer,
        action_decode=m.action_decode,
        attention_impl=normalize_attention_impl(attention_impl or m.attention_impl),
        dropout_rate=m.dropout_rate,
        crop_ratio=reg.crop_ratio,
        focal_gamma=m.focal_gamma,
        aux_mse_weight=m.aux_mse_weight,
    )


def load_policy(config: Config, weights: Optional[str] = None, device=None,
                attention_impl: Optional[str] = None, workdir: Optional[str] = None) -> RT1Policy:
    """Build, fill (random init from `RANDOM_INIT_SEED`, an .npz of the
    JAX package's variables, or the newest checkpoint of the port's trainer
    in `workdir`), cast to the compute dtype and place on `device` (default
    cuda), in eval mode."""
    policy, _ = load_policy_and_step(config, weights, device, attention_impl, workdir)
    return policy


def load_policy_and_step(config: Config, weights: Optional[str] = None, device=None,
                         attention_impl: Optional[str] = None, workdir: Optional[str] = None):
    """`load_policy` and the checkpoint step it restored: -1 for random
    init, None for an .npz, the trainer's step for a workdir (whose lack
    of a checkpoint raises FileNotFoundError)."""
    if weights is not None and workdir is not None:
        raise ValueError("pass weights or workdir, not both")
    dev = resolve_device(device)
    policy = build_policy(config, attention_impl)
    step = -1
    if workdir is not None:
        ckpt = load_checkpoint(os.path.join(workdir, "checkpoints"))
        policy.load_state_dict(ckpt["policy"])
        step = int(ckpt["loop_step"])
    elif weights is None:
        init_weights(policy, torch.Generator().manual_seed(RANDOM_INIT_SEED))
    else:
        params, batch_stats = load_npz(weights)
        load_flax_variables(policy, params, batch_stats)
        step = None
    dtype = DTYPES[config.model.dtype]
    return policy.to(device=dev, dtype=dtype).eval().requires_grad_(False), step


def build_serve_engine(config: Config, weights: Optional[str] = None, device=None,
                       attention_impl: Optional[str] = None, workdir: Optional[str] = None,
                       **engine_kwargs):
    """A multi-session serving engine over `load_policy(...)`. Returns
    (engine, checkpoint_step): -1 for random init, None for an .npz, the
    trainer's step for a workdir."""
    policy, step = load_policy_and_step(config, weights, device, attention_impl, workdir)
    return PolicyEngine(policy, **engine_kwargs), step
