"""Build the serving engine from a config and weights (counterpart of
`rt1_tpu/eval/restore.py::build_serve_engine` and
`load_standby_variables`).

Weights are f32 masters — from the port's seeded random init, from the
JAX package's variables saved as an .npz of `/`-joined flax paths
(`convert.load_npz`), or from the newest checkpoint the port's trainer
wrote under `<workdir>/checkpoints`. The serving weights are derived from
them once, on the device (`models/quant.py::serving_preparer`):

* `inference_dtype="f32"`: every float leaf cast to `config.model.dtype`.
  The port holds its weights at the compute dtype, where JAX holds f32
  masters and casts at use: the outputs are the same, the bytes differ.
* `"bf16"`: the policy is rebuilt at bfloat16 compute and every float
  leaf cast to bfloat16.
* `"int8"`: the quant plan's int8 leaves quantized per output channel on
  the device (scales float32), the rest cast to the compute dtype.

The MoE routers (`moe.Router`) stay float32 in every mode; bf16 rounds
their values.

The engine keeps the master spec and the preparer, so `/reload` takes an
f32 master (`load_standby_variables`) and prepares it the same way.

A checkpoint written under any plan — data-parallel, ZeRO-3 over any
fsdp size, the world of one — loads into the one-device engine
(`trainer/checkpoints.py::load_checkpoint` assembles the logical masters,
`parallel/reshard.py`). `serving_plan(config)` resolves the train config's
`parallel` block as JAX's does (`collapse_data`: dp 1, fsdp x sp devices);
the port serves every plan on one device, so a plan that needs more
devices than the host has is logged and restored with plain placement,
as JAX's restore does.
"""

from __future__ import annotations

import copy
import logging
import os
from typing import Dict, Optional

import torch

from rt1_tpu_torch import resolve_device
from rt1_tpu_torch.configs import Config
from rt1_tpu_torch.convert import flax_paths, init_weights, load_flax_variables, load_npz
from rt1_tpu_torch.models import quant
from rt1_tpu_torch.models.image_tokenizer import RT1ImageTokenizer
from rt1_tpu_torch.models.moe import router_names
from rt1_tpu_torch.models.rt1 import RT1Policy
from rt1_tpu_torch.models.tiny_tokenizer import TinyImageTokenizer
from rt1_tpu_torch.models.transformer import normalize_attention_impl
from rt1_tpu_torch.serve.engine import PolicyEngine
from rt1_tpu_torch.specs import language_table_action_space
from rt1_tpu_torch.trainer.checkpoints import load_checkpoint

_log = logging.getLogger(__name__)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
RANDOM_INIT_SEED = 0


FAMILIES = ("rt1", "lava")


def build_lava_policy(config: Config):
    """`SequenceLAVMSE` of `config.model.lava` (JAX's `build_family`), its
    window `model.time_sequence_length`, with the CLIP text tower of the
    `text_*` fields when `lang_encoder` is "clip"."""
    from rt1_tpu_torch.models.lava import SequenceLAVMSE
    from rt1_tpu_torch.models.lava.clip_text import CLIPTextEncoder

    lv = config.model.lava
    text_encoder = None
    if lv.lang_encoder == "clip":
        text_encoder = CLIPTextEncoder(vocab_size=lv.text_vocab, context_length=lv.text_context,
                                       width=lv.text_width, num_layers=lv.text_layers,
                                       num_heads=lv.text_heads, embed_dim=lv.text_embed_dim)
    return SequenceLAVMSE(
        action_size=lv.action_size,
        dense_resnet_width=lv.dense_resnet_width,
        dense_resnet_num_blocks=lv.dense_resnet_num_blocks,
        lava_num_layers=lv.num_layers,
        lava_sequence_length=config.model.time_sequence_length,
        lava_temporal_transformer_num_layers=lv.temporal_num_layers,
        lava_d_model=lv.d_model,
        lava_num_heads=lv.num_heads,
        lava_pyramid_fuse_layers=tuple(lv.pyramid_fuse_layers),
        lava_image_encoder=lv.image_encoder,
        lava_lang_encoder=lv.lang_encoder,
        text_encoder=text_encoder,
    )


def is_lava(config: Config) -> bool:
    if config.model.family not in FAMILIES:
        raise ValueError(f"Unknown model family: {config.model.family!r}")
    return config.model.family == "lava"


def compute_dtype(config: Config) -> torch.dtype:
    """The dtype the family computes in: `model.dtype` for RT-1; float32
    for LAVA, which has no dtype field (JAX's modules default to it)."""
    return torch.float32 if is_lava(config) else DTYPES[config.model.dtype]


def build_policy(config: Config, attention_impl: Optional[str] = None):
    """The policy `config.model` (with `config.regularization`) describes,
    on the CPU in float32, with default (not yet initialised) weights:
    `RT1Policy`, or `SequenceLAVMSE` for `model.family="lava"`.
    `attention_impl` overrides the config's ("dense" | "fused" | "pallas")."""
    if is_lava(config):
        return build_lava_policy(config)
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
            remat=m.remat,
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
        photometric_augmentation=m.photometric_augmentation,
        focal_gamma=m.focal_gamma,
        aux_mse_weight=m.aux_mse_weight,
        # JAX's build_model passes every tokenizer but B3's as a def.
        tokenizer_flax_name="image_tokenizer" if m.image_tokenizer == "efficientnet_b3" else None,
        ffn_impl=m.ffn_impl,
        num_experts=m.num_experts,
        moe_capacity_factor=m.moe_capacity_factor,
        moe_ff_dim=m.moe_ff_dim,
        remat=m.remat,
    )


def serving_plan(config: Config, n_devices: Optional[int] = None):
    """The sharding plan of a serving process from the SAME
    `config.parallel` training resolves (`ShardingPlan.from_config(
    collapse_data=True)`): dp collapses to 1, the grid covers fsdp x tp x
    pp x sp devices. `n_devices`: this host's devices (the CUDA count, 1
    without a card). Raises ValueError when the host has fewer."""
    from rt1_tpu_torch.parallel.plan import ShardingPlan

    if n_devices is None:
        n_devices = max(torch.cuda.device_count(), 1) if torch.cuda.is_available() else 1
    return ShardingPlan.from_config(config, n_devices=n_devices, collapse_data=True)


def _checked_serving_plan(config: Config):
    """`serving_plan`, or None with a warning when this host cannot hold
    it: the restore then places the whole model on one device."""
    try:
        return serving_plan(config)
    except ValueError as exc:
        _log.warning("eval/restore: serving plan unsatisfiable on this host (%s) — "
                     "restoring with plain placement", exc)
        return None


def master_policy(config: Config, weights: Optional[str], workdir: Optional[str],
                   attention_impl: Optional[str] = None, step: Optional[int] = None):
    """(the policy in float32 on the CPU filled with its masters, the
    checkpoint step): -1 for random init, None for an .npz, the trainer's
    step for a workdir (`step` picks one; default the newest)."""
    if weights is not None and workdir is not None:
        raise ValueError("pass weights or workdir, not both")
    policy = build_policy(config, attention_impl)
    restored = -1
    if workdir is not None:
        _checked_serving_plan(config)
        ckpt = load_checkpoint(os.path.join(workdir, "checkpoints"), step)
        policy.load_state_dict(ckpt["policy"])
        restored = int(ckpt["loop_step"])
    elif weights is None:
        init_weights(policy, torch.Generator().manual_seed(RANDOM_INIT_SEED))
    else:
        params, batch_stats = load_npz(weights)
        load_flax_variables(policy, params, batch_stats)
        restored = None
    return policy, restored


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
    dev = resolve_device(device)
    policy, step = master_policy(config, weights, workdir, attention_impl)
    policy = policy.to(device=dev, dtype=compute_dtype(config))
    return policy.eval().requires_grad_(False), step


def config_with_model_dtype(config: Config, dtype: str) -> Config:
    """A copy of `config` whose model computes in `dtype` (bf16 serving
    rebuilds the model at bfloat16; the masters stay float32)."""
    config = copy.deepcopy(config)
    config.model.dtype = dtype
    return config


def serving_policy(master: RT1Policy, compute_dtype: torch.dtype, device=None,
                   inference_dtype: str = "f32"):
    """`master` (a float32 policy on the CPU, which this moves to `device`)
    made to serve `inference_dtype` at `compute_dtype`, in eval mode.
    Returns (policy, its serving state_dict, the preparer that made it from
    float32 masters, the masters' state_dict)."""
    quant.check_inference_dtype(inference_dtype)
    dev = resolve_device(device)
    master_state = {k: v.detach().clone() for k, v in master.state_dict().items()}
    prepare = quant.serving_preparer(inference_dtype, flax_paths(master), compute_dtype, dev,
                                     routers=router_names(master))
    serving = prepare(master_state)
    policy = master.to(device=dev, dtype=compute_dtype)
    quant.quantize_layers_(policy, serving)
    policy.load_state_dict(serving)
    return policy.eval().requires_grad_(False), serving, prepare, master_state


def serving_engine(master: RT1Policy, compute_dtype: torch.dtype, device=None,
                   inference_dtype: str = "f32", cached_inference: bool = False,
                   **engine_kwargs) -> PolicyEngine:
    """An engine serving `master` (a float32 policy on the CPU, which this
    moves to `device`) in `inference_dtype` at `compute_dtype`."""
    policy, _, prepare, master_state = serving_policy(master, compute_dtype, device,
                                                      inference_dtype)
    return PolicyEngine(policy, inference_dtype=inference_dtype, prepare_variables=prepare,
                        master_state=master_state, cached_inference=cached_inference,
                        **engine_kwargs)


def build_serve_engine(config: Config, weights: Optional[str] = None, device=None,
                       attention_impl: Optional[str] = None, workdir: Optional[str] = None,
                       inference_dtype: str = "f32", cached_inference: bool = False,
                       step: Optional[int] = None, **engine_kwargs):
    """A multi-session serving engine in one of the serving modes (see the
    module docstring). Returns (engine, checkpoint_step): -1 for random
    init, None for an .npz, the trainer's step for a workdir (`step` picks
    one; default the newest)."""
    quant.check_inference_dtype(inference_dtype)
    if is_lava(config):
        raise ValueError("model.family='lava' is evaluated (`python -m rt1_tpu_torch.eval`), "
                         "not served: the serving engine steps RT-1's rolling window, and the "
                         "JAX package serves no LAVA policy either")
    if inference_dtype == "bf16":
        config = config_with_model_dtype(config, "bfloat16")
    master, step = master_policy(config, weights, workdir, attention_impl, step=step)
    engine = serving_engine(master, DTYPES[config.model.dtype], device, inference_dtype,
                            cached_inference, **engine_kwargs)
    return engine, step


def load_standby_variables(config: Config, weights: Optional[str] = None,
                           workdir: Optional[str] = None, step: Optional[int] = None):
    """The f32 master state_dict of a hot swap, on the host, and its step:
    from `workdir`'s checkpoint (`step`, default the newest), from an .npz,
    or the seeded random init (bit-identical to `build_serve_engine`'s).
    Returns (state_dict, checkpoint_step)."""
    policy, restored = master_policy(config, weights, workdir, step=step)
    state: Dict[str, torch.Tensor] = {k: v.detach() for k, v in policy.state_dict().items()}
    return state, restored
