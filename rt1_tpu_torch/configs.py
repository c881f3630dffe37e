"""Configs as plain dataclasses (counterparts of
`rt1_tpu/train/configs/language_table.py`, `tiny.py` and `lava_tiny.py`).

The `model.*` fields, `data.height/width`, the training schedule,
`resilience.*`, `obs.*` and `parallel.*` (field for field) carry the JAX
config's names and values; ml_collections is not a
dependency of the port.
`get_config` takes a config name, or the path of the JAX config file
(`rt1_tpu/train/configs/language_table.py`), whose file stem names it —
so one command line drives both packages. `apply_override` takes the
dotted `key=value` form of the CLI's `--set` (`model.dropout_rate=0`).

`regularization` holds what the JAX package fixes as module defaults and
the port makes settable, so a run can turn it off: the train-time crop
ratio (`RT1Policy.crop_ratio`) and the tower's stochastic-depth rate
(`EfficientNet.drop_connect_rate`). Dropout is `model.dropout_rate`, as in
JAX.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import typing
from typing import Optional, Tuple


@dataclasses.dataclass
class ModelConfig:
    vocab_size: int = 256
    token_embedding_size: int = 512
    num_layers: int = 8
    layer_size: int = 128          # per-head attention width (key_dim)
    num_heads: int = 8
    feed_forward_size: int = 512   # d_model
    dropout_rate: float = 0.1
    time_sequence_length: int = 6
    use_token_learner: bool = True
    num_image_tokens: int = 8
    # "efficientnet_b3" | "efficientnet_small" (0.35/0.35 scaling) | "tiny"
    image_tokenizer: str = "efficientnet_b3"
    dtype: str = "bfloat16"        # compute dtype: "bfloat16" | "float32"
    # Focal modulation of the action-token CE; 0 = reference parity.
    focal_gamma: float = 0.0
    # Soft-argmax MSE auxiliary; 0 = reference parity.
    aux_mse_weight: float = 0.0
    action_decode: str = "argmax"  # "argmax" | "expected"
    # "dense" | "fused" ("pallas", the JAX package's name for the fused
    # kernel, maps to "fused") | "ring" (sequence-parallel over the
    # `parallel.sp` ranks, `parallel/ring_attention.py`; dense at sp 1).
    # Training takes the dense path unless it is "ring".
    attention_impl: str = "dense"
    # GPipe micro-batches a step when parallel.pp > 1
    # (`parallel/pipeline.py`, JAX's).
    pipeline_microbatches: int = 4
    # Per-video colour jitter in the train forward, after the crop
    # (`ops/augment.py`).
    photometric_augmentation: bool = False
    # A state-regression-pretrained encoder (`train/pretrain_vision.py::
    # save_encoder`) grafted into the tokenizer on a fresh start; None
    # trains the tower from its random init.
    pretrained_encoder: Optional[str] = None
    # "rt1" | "lava" (`build_family`).
    family: str = "rt1"
    # Decoder FFN: "dense" (the reference's single square Dense) | "moe"
    # (the Switch-routed expert FFN, `models/moe.py`), whose load-balancing
    # loss enters the train loss at `moe_aux_weight`.
    ffn_impl: str = "dense"
    num_experts: int = 4
    moe_aux_weight: float = 0.01
    moe_capacity_factor: float = 2.0
    moe_ff_dim: Optional[int] = None   # expert hidden width; None: d_model
    # Recompute each decoder layer and each MBConv block in the backward
    # pass instead of storing its activations.
    remat: bool = False
    lava: "LavaConfig" = dataclasses.field(default_factory=lambda: LavaConfig())


@dataclasses.dataclass
class LavaConfig:
    """`config.model.lava` (used when `model.family == "lava"`): the
    reference's SequenceLAVMSE widths, and the in-graph CLIP text tower's
    (`lang_encoder == "clip"`), whose defaults fit the byte-level
    `text.clip_bpe.default_tokenizer` (vocab 514)."""
    action_size: int = 2
    d_model: int = 128
    num_layers: int = 2
    temporal_num_layers: int = 2
    num_heads: int = 2
    pyramid_fuse_layers: Tuple[int, ...] = (2, 3, 4)
    image_encoder: str = "conv_maxpool"      # "conv_maxpool" | "resnet"
    lang_encoder: str = "embedding_in_obs"   # "embedding_in_obs" | "clip"
    dense_resnet_width: int = 256
    dense_resnet_num_blocks: int = 8
    text_vocab: int = 514
    text_context: int = 77
    text_width: int = 512
    text_layers: int = 12
    text_heads: int = 8
    text_embed_dim: int = 512


@dataclasses.dataclass
class DataConfig:
    # Empty: synthetic batches drawn on the device. Else the episode root,
    # <data_dir>/{train,val}/episode_*.npz (`rt1_tpu_torch/data/`).
    data_dir: str = ""
    height: int = 256
    width: int = 456
    crop_factor: Optional[float] = 0.95   # None: the full frame
    # "torch" (a DataLoader of `num_workers` worker processes) | "numpy"
    # (the loop's own thread) | "rlds_tf" (the RLDS windowing pipeline,
    # `data/rlds_pipeline.py`: lazy episode reads, a shuffle buffer, a
    # prefetch thread); "tf", the JAX package's default, maps to "torch".
    loader: str = "tf"
    # loader="tf": tf.data's shuffle buffer, min(windows, shuffle_buffer),
    # over the repeated index stream (`pipeline.buffered_shuffle`); the
    # torch and numpy loaders draw a full permutation per epoch.
    shuffle_buffer: int = 2048
    num_workers: int = 4                  # port only: the torch loader's processes
    # loader="rlds_tf": the data service's dispatcher (tcp://host:port,
    # `data/service.py`) whose workers run the RLDS pipeline; None runs it
    # in this process.
    data_service_address: Optional[str] = None
    prefetch_factor: int = 2              # port only: batches in flight per worker
    # Emit `instruction_tokenized_clip` (CLIP BPE of each episode's
    # instruction text) for the LAVA "clip" language encoder.
    clip_tokens: bool = False
    # CLIP's merges file (bpe_simple_vocab_16e6.txt[.gz]); None: the
    # byte-level tokenizer (model.lava.text_vocab must then be 514).
    clip_bpe_path: Optional[str] = None
    # The packed mmap frame cache and the sample-ahead feeder: build the
    # pack with `python -m rt1_tpu_torch.data.pack_dataset`; a missing or
    # stale pack falls back to `loader` (logged as a JSON line).
    packed_cache: bool = False
    packed_cache_dir: Optional[str] = None  # default <data_dir>/<split>_packed
    feeder_threads: int = 2
    feeder_depth: int = 2
    feeder_stall_timeout_s: Optional[float] = None
    # Re-read the pack's manifest at each epoch boundary (appended shards).
    packed_refresh: bool = True
    task_weights: str = ""                # "task:weight,..." per-task sampling weights


@dataclasses.dataclass
class RegularizationConfig:
    crop_ratio: float = 0.07        # pad-and-random-shift ratio, train only
    # Stochastic depth: block b of the tower drops at this x b / blocks.
    drop_connect_rate: float = 0.2


@dataclasses.dataclass
class ResilienceConfig:
    """`config.resilience` of the flagship (`resilience/__init__.py::
    ResilienceOptions` resolves it)."""
    # Step guard: device-side skip of a step whose loss or gradient norm is
    # not finite, and the host-side escalation (skip -> checkpoint rollback
    # with a fresh data seed -> abort).
    guard: bool = True
    # > 0: also skip updates whose global grad-norm exceeds this.
    guard_grad_norm_max: float = 0.0
    # > 0: flag loss > factor * EMA(healthy losses) at log steps.
    guard_loss_spike_factor: float = 0.0
    guard_spike_ema_beta: float = 0.9
    guard_warmup_checks: int = 3
    # Consecutive bad log-step checks tolerated before rolling back.
    guard_skip_budget: int = 3
    # Rollbacks allowed before the run aborts (GuardAbortError).
    guard_rollback_budget: int = 2
    # Exponential-backoff retry on checkpoint save/restore, packed-cache
    # open and feeder construction.
    io_retry: bool = True
    retry_attempts: int = 3
    retry_backoff_s: float = 0.5
    retry_max_backoff_s: float = 8.0
    retry_deadline_s: float = 120.0
    # SIGTERM/SIGINT -> force-save at the current step, drain the feeder,
    # exit 0; a second signal escalates to the previous handler.
    preempt_save: bool = True
    # Deterministic fault schedule (`resilience/faults.py` grammar, e.g.
    # "nan_batch@7,ckpt_save@2"); the RT1_FAULTS environment variable appends.
    faults: str = ""


@dataclasses.dataclass
class ObsConfig:
    """`config.obs` of the flagship (`obs/__init__.py::ObsOptions` resolves
    it; the paths default to files in the workdir)."""
    # Host-side Chrome trace of the loop (and the feeder's workers), dumped
    # to `trace_path` (default <workdir>/trace.json) at exit.
    trace: bool = False
    trace_path: Optional[str] = None
    trace_max_events: int = 200_000
    # Rolling window (steps) of the stall_pct gauge and the timing buckets.
    stall_window: int = 50
    # Synchronize on each step's loss, so `device_step` is the card's time.
    sync_timing: bool = False
    # >= 0: serve Prometheus text at http://<host>:<port>/metrics from the
    # train process (0 = an ephemeral port, logged at start). < 0: off.
    prometheus_port: int = -1
    prometheus_host: str = "127.0.0.1"
    # Ring of the last N step records, dumped to JSONL on an exception, a
    # SIGTERM or a preemption.
    flight_recorder: bool = True
    flight_recorder_size: int = 256
    flight_recorder_path: Optional[str] = None
    # Model-health pack (`obs/health.py`): per-group gradient norms and
    # update ratios, logit entropy, token accuracy, fetched at log steps.
    model_health: bool = True
    health_group_depth: int = 2
    # Goodput ledger (`obs/goodput.py`): the run's wall time by bucket,
    # <workdir>/goodput_summary.json.
    goodput: bool = True
    goodput_summary_path: Optional[str] = None
    # Live MFU gauge: FLOPs of one step counted once at start.
    goodput_mfu: bool = True


@dataclasses.dataclass
class DistributedConfig:
    """`config.parallel.distributed` (`parallel/distributed.py::
    DistributedOptions` resolves it, with the environment's fallbacks)."""
    enabled: bool = False
    coordinator_address: Optional[str] = None   # "host:port" of rank 0
    process_id: int = -1                         # -1: from the environment
    num_processes: int = -1                      # -1: from the environment


@dataclasses.dataclass
class ParallelConfig:
    """`config.parallel` (`parallel/plan.py::ShardingPlan.from_config`):
    the rank grid ('data', 'stage', 'fsdp', 'seq', 'model') over the
    processes of a `torch.distributed` world, one device each."""
    dp: int = -1        # data parallelism; -1: the ranks the other axes leave
    fsdp: int = 1       # ZeRO-3: masters and Adam moments in 1/fsdp chunks
    tp: int = 1         # tensor parallelism over the plan's `model` axis
    pp: int = 1         # pipeline stages (GPipe over the decoder's layers)
    sp: int = 1         # sequence parallelism (ring attention)
    auto: bool = False  # (dp, fsdp, tp) from the world size (AUTO_MESH_SHAPES)
    strict: bool = False  # a weight matrix no plan rule decides raises
    # f32 master weights, one bf16 compute copy per step (forces the model
    # compute dtype to bfloat16).
    mixed_precision: bool = False
    distributed: DistributedConfig = dataclasses.field(default_factory=DistributedConfig)


def check_parallel_config(config: "Config") -> None:
    """Refuse axis sizes below 1 at the config seam."""
    par = config.parallel
    for name in ("dp", "fsdp", "tp", "pp", "sp"):
        value = getattr(par, name)
        if value < 1 and not (name == "dp" and value == -1):
            raise ValueError(f"parallel.{name}={value} must be >= 1"
                             + (" or -1 (the ranks left)" if name == "dp" else ""))


@dataclasses.dataclass
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    regularization: RegularizationConfig = dataclasses.field(
        default_factory=RegularizationConfig)
    resilience: ResilienceConfig = dataclasses.field(default_factory=ResilienceConfig)
    obs: ObsConfig = dataclasses.field(default_factory=ObsConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)
    # Training schedule (reference: 100 epochs x 975 steps at batch 8).
    per_host_batch_size: int = 8
    num_steps: int = 97_500
    steps_per_epoch: int = 975
    learning_rate: float = 5e-4
    lr_milestones: Tuple[int, ...] = (50, 75, 90)  # epochs
    lr_gamma: float = 0.1
    grad_clip_norm: float = 0.0  # 0 disables
    # Added to the gradient before Adam (the JAX `make_optimizer`'s
    # `weight_decay`; 0 disables, as in the reference).
    weight_decay: float = 0.0
    accum_steps: int = 1
    seed: int = 42
    checkpoint_every_steps: int = 975
    max_to_keep: Optional[int] = None  # None (or 0, as in JAX) keeps every checkpoint
    keep_period: Optional[int] = None  # also keep every step divisible by this
    log_every_steps: int = 50
    eval_every_steps: int = 975
    eval_batches: int = 6


def language_table() -> Config:
    """The flagship: FiLM-EfficientNet-B3 at 256x456, TokenLearner 8 tokens,
    window 6, 8 decoder layers of 8 heads x 128, d_model 512, vocab 256, bf16;
    Adam 5e-4 with MultiStepLR [50, 75, 90] x 0.1 per epoch of 975 steps;
    every 9750th checkpoint kept."""
    return Config(keep_period=9750)


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
        # As JAX's tiny config: the pack and the MFU count are off (tests
        # turn them on).
        obs=ObsConfig(model_health=False, goodput_mfu=False),
        num_steps=4,
        steps_per_epoch=2,
        checkpoint_every_steps=2,
        log_every_steps=1,
        eval_every_steps=2,
        eval_batches=1,
        keep_period=9750,  # JAX's tiny config inherits the flagship's
    )


def language_table_sweep():
    """The flagship's hyperparameter sweep (`sweep()` of the JAX config
    file): {dotted-config-key: value} overrides, one dict a trial."""
    return [
        {"learning_rate": lr, "seed": seed}
        for lr in (1e-3, 5e-4, 1e-4)
        for seed in (42,)
    ]


def lava_tiny() -> Config:
    """The CPU smoke config of the LAVA family
    (`rt1_tpu/train/configs/lava_tiny.py`): `tiny` with a 16-wide LAVA at
    64x64, which divides through the five-level conv-maxpool pyramid."""
    config = tiny()
    config.model.family = "lava"
    lv = config.model.lava
    lv.d_model = 16
    lv.dense_resnet_width = 32
    lv.dense_resnet_num_blocks = 1
    lv.num_heads = 2
    lv.text_width = 16
    lv.text_layers = 2
    lv.text_heads = 2
    lv.text_embed_dim = 16
    config.data.height = 64
    config.data.width = 64
    return config


CONFIGS = {"language_table": language_table, "tiny": tiny, "lava_tiny": lava_tiny}
SWEEPS = {"language_table": language_table_sweep}


def _config_key(name: str) -> str:
    key = os.path.splitext(os.path.basename(name))[0]
    if key not in CONFIGS:
        raise ValueError(f"unknown config {name!r}; choose from {sorted(CONFIGS)}")
    return key


def get_config(name: str) -> Config:
    """A config by name ("language_table" | "tiny" | "lava_tiny") or by the path of the
    JAX package's config file of that name."""
    return CONFIGS[_config_key(name)]()


def sweep(name: str):
    """The sweep of the config `name` names (a list of override dicts);
    raises ValueError for a config that defines none, as JAX's trainer
    does."""
    key = _config_key(name)
    if key not in SWEEPS:
        raise ValueError(f"{name} defines no sweep()")
    return SWEEPS[key]()


def _parse_value(text: str, current, key: str, hint):
    """`text` as a value of the field's type: that of `current`, or, for an
    `Optional[X]` field (`hint`, the resolved annotation) now None, X's.
    "none" sets an Optional field to None."""
    args = typing.get_args(hint)
    if typing.get_origin(hint) is typing.Union and type(None) in args:
        if text.strip().lower() in ("none", "null"):
            return None
        if current is None:
            (inner,) = [a for a in args if a is not type(None)]
            current = inner()
    if isinstance(current, bool):
        lowered = text.strip().lower()
        if lowered not in ("true", "false", "1", "0"):
            raise ValueError(f"{key}: expected a bool, got {text!r}")
        return lowered in ("true", "1")
    if isinstance(current, str):
        return text
    try:
        value = ast.literal_eval(text.strip())
    except (ValueError, SyntaxError) as exc:
        raise ValueError(f"{key}: cannot parse {text!r}") from exc
    if isinstance(current, tuple):
        value = tuple(value) if isinstance(value, (tuple, list)) else (value,)
        if not all(isinstance(v, int) for v in value):
            raise ValueError(f"{key}: expected ints, got {text!r}")
        return value
    if isinstance(current, float) and isinstance(value, (int, float)) and not isinstance(value, bool):
        return float(value)
    if isinstance(current, int) and isinstance(value, int) and not isinstance(value, bool):
        return value
    raise ValueError(f"{key}: expected {type(current).__name__}, got {text!r}")


def apply_override(config: Config, assignment: str) -> None:
    """Set one field from a dotted `key=value` (`model.dropout_rate=0`,
    `num_steps=4`, `lr_milestones=50,75`), in place."""
    if "=" not in assignment:
        raise ValueError(f"override {assignment!r} is not key=value")
    key, text = assignment.split("=", 1)
    *parents, leaf = key.strip().split(".")
    node = config
    for part in parents:
        if not dataclasses.is_dataclass(node) or not hasattr(node, part):
            raise ValueError(f"unknown config key {key!r}")
        node = getattr(node, part)
    hints = typing.get_type_hints(type(node)) if dataclasses.is_dataclass(node) else {}
    if leaf not in hints or dataclasses.is_dataclass(getattr(node, leaf)):
        raise ValueError(f"unknown config key {key!r}")
    old = getattr(node, leaf)
    setattr(node, leaf, _parse_value(text, old, key, hints[leaf]))
    if key.strip().startswith("parallel."):
        try:
            check_parallel_config(config)
        except ValueError:
            setattr(node, leaf, old)
            raise
