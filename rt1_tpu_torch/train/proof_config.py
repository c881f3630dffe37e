"""The learning proof's training config (counterpart of
`rt1_tpu/train/proof_config.py`).

`proof_train_config` starts from a base config (`language_table` by
default, as in JAX) and sets the proof's fields to the JAX function's
values: the tokenizer, window, losses, dtype, resolution, batch, schedule
placement and cadences.
"""

from __future__ import annotations

from rt1_tpu_torch.configs import Config, get_config


def proof_train_config(
    data_dir: str,
    num_steps: int,
    *,
    image_tokenizer: str = "efficientnet_b3",
    seq_len: int = 6,
    focal_gamma: float = 0.0,
    aux_mse_weight: float = 0.0,
    dtype: str = "bfloat16",
    pretrained_encoder: str = "",
    height: int = 128,
    width: int = 224,
    batch: int = 32,
    checkpoint_every: int = 2500,
    constant_lr: bool = False,
    base_config: str = "language_table",
) -> Config:
    """The learning-proof config on top of `base_config`.

    MultiStepLR milestones (50, 75, 90) "epochs" decay at 50/75/90 % of the
    run: `steps_per_epoch = max(1, num_steps // 100)` (0 would put every
    boundary at step 0). `constant_lr` pushes every boundary past the
    horizon instead (`num_steps * 100` steps an epoch).
    """
    config = get_config(base_config)
    config.model.image_tokenizer = image_tokenizer
    config.model.time_sequence_length = seq_len
    config.model.focal_gamma = focal_gamma
    config.model.aux_mse_weight = aux_mse_weight
    config.model.dtype = dtype
    if pretrained_encoder:
        config.model.pretrained_encoder = pretrained_encoder
    config.data.data_dir = data_dir
    config.data.height = height
    config.data.width = width
    config.per_host_batch_size = batch
    config.num_steps = num_steps
    config.steps_per_epoch = num_steps * 100 if constant_lr else max(1, num_steps // 100)
    config.checkpoint_every_steps = checkpoint_every
    config.keep_period = 10000
    config.log_every_steps = 50
    config.eval_every_steps = 1000
    config.eval_batches = 4
    return config
