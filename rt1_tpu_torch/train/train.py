"""The training loop (counterpart of `rt1_tpu/train/train.py`).

`train_and_evaluate(config, workdir)` builds the policy the config
describes (`build_model`: RT-1 with the `efficientnet_b3`,
`efficientnet_small` and `tiny` tokenizers, the dense or MoE decoder FFN
and optional remat; or, with `model.family="lava"`, `SequenceLAVMSE` on
`trainer/bc.py`'s MSE loss), initialises it from `config.seed` or restores the
newest checkpoint under `<workdir>/checkpoints`, then steps: a metrics
line every `log_every_steps` (to `<workdir>/metrics.jsonl` and the
caller's `log`), an eval every `eval_every_steps`, a checkpoint every
`checkpoint_every_steps` and at the last step.

Data, with `config.data.data_dir` set: episode files under
`<data_dir>/train` (`dataset_batches`) through the packed cache and the
sample-ahead feeder (`data.packed_cache=True` and a fresh pack), else the
windowed loader; with `data.clip_tokens` each window carries its
episode's instruction as CLIP BPE ids (`instruction_tokenized_clip`,
`make_clip_tokenizer`) for LAVA's "clip" encoder (`data.loader`: "torch", the DataLoader, or "numpy"),
moved to the device by `device_feeder` with two batches in flight. The
dataset's `manifest.json`, where it has one, is copied to
`<workdir>/data_manifest.json`. Eval draws `eval_batches` batches from the
running `<data_dir>/val` stream at each eval, and there is no eval without
that split. A resumed run restarts the data stream from its beginning, as
the JAX loop does.

`config.model.pretrained_encoder`, the path of a `save_encoder` file,
is grafted into the tokenizer on a fresh start only (logged as a JSON
line); a run that resumes a checkpoint restores the checkpoint's encoder.

Without `data_dir` the loop trains on synthetic batches, as the JAX loop
does. Batch `i` is drawn on the device from a generator seeded with
`(seed, i)`, so a resumed run sees the batches an unbroken run would have
(the JAX loop restarts its one synthetic stream instead). After a guard
rollback to step `r`, batch `i >= r` is drawn from `(fresh_seed, i)`, and
episode-file feeds reopen with the fresh seed, so the batches that
diverged are not replayed. Eval uses the fixed batches `0 ..
eval_batches - 1` of seed `seed + 1`.

Several processes (`config.parallel`, `parallel.distributed.enabled`;
`python -m torch.distributed.run --nproc_per_node N -m rt1_tpu_torch.train
... --set parallel.distributed.enabled=true`): the ranks rendezvous before
any device is touched (`parallel/distributed.py`; NCCL on `cuda:LOCAL_RANK`,
gloo with `--device cpu`), the plan is resolved once
(`parallel/plan.py::ShardingPlan.from_config`) into the rank grid, each
rank keeps its part of the policy under `tp` and `pp`
(`parallel/partition.py`), and the step reduces over the grid
(`trainer/train.py`). One process is one JAX host of
one device: the global batch is `per_host_batch_size` x the batch ranks
(data x fsdp), and a rank's batch is its block of it: its rows of the
synthetic batch, or the rank's share of the episode stream (the loaders'
`process_index` / `process_count` are the rank's block and the number of
blocks; ranks along `seq` share a block). Rank 0 alone writes
`metrics.jsonl`, `data_manifest.json`, the goodput summary, the flight
record and the trace, serves the scrape and logs; every rank steps, evals
and saves its part of each checkpoint (`trainer/checkpoints.py`).

Resilience and observability follow `config.resilience` and `config.obs`
as the JAX loop does (`train_and_evaluate`'s docstring): the guard's
escalation and rollback, preemption save, I/O retry, the fault plan
(`resilience.faults` and `RT1_FAULTS`), the health pack, the goodput
ledger and its MFU gauge, the step timeline, the flight recorder, the host
trace and the Prometheus listener. Their scalars go into each log step's
metrics line (`guard/*`, `retry/*`, `goodput/*`, `health/*`, `timing/*`,
`feeder/*`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import itertools
import json
import os
from typing import Callable, Dict, Iterator, NamedTuple, Optional

import numpy as np
import torch

from rt1_tpu_torch import obs, resilience, resolve_device
from rt1_tpu_torch.configs import Config, apply_override, check_parallel_config, sweep
from rt1_tpu_torch.convert import init_weights
from rt1_tpu_torch.data import pack as pack_lib
from rt1_tpu_torch.data.episodes import read_manifest
from rt1_tpu_torch.data.feeder import SampleAheadFeeder, parse_task_weights
from rt1_tpu_torch.data.pipeline import WindowedEpisodeDataset, device_feeder, loader_batches
from rt1_tpu_torch.eval.restore import build_policy
from rt1_tpu_torch.parallel import distributed as dist_lib
from rt1_tpu_torch.parallel import mesh as mesh_lib
from rt1_tpu_torch.parallel.flash_attention import fused_attention
from rt1_tpu_torch.parallel.partition import partition_policy
from rt1_tpu_torch.parallel.plan import ShardingPlan
from rt1_tpu_torch.resilience import faults
from rt1_tpu_torch.train.pretrain_vision import graft_encoder_into_policy, load_encoder
from rt1_tpu_torch.trainer.checkpoints import CheckpointManager
from rt1_tpu_torch.trainer.metrics import (MetricsWriter, ThroughputMeter, scalars_from_metrics,
                                         step_trace)
from rt1_tpu_torch.trainer.state import TrainState, create_train_state, shard_train_state
from rt1_tpu_torch.trainer.train import optimizer_from_config, train_step_fns_from_config

EMBEDDING_DIM = 512


def apply_sweep_trial(config: Config, config_name: str, trial: int) -> Dict:
    """Apply trial `trial` of the config's sweep (`configs.sweep`) onto
    `config` in place; returns its overrides."""
    trials = sweep(config_name)
    if not 0 <= trial < len(trials):
        raise ValueError(f"--sweep_trial {trial} out of range [0, {len(trials)})")
    overrides = trials[trial]
    for key, value in overrides.items():
        apply_override(config, f"{key}={value}")
    return overrides


def build_model(config: Config, device=None):
    """The policy of `config.model` in float32 on `device`, initialised
    from `config.seed` (flax's initializer families, `convert.init_weights`):
    `RT1Policy`, or `SequenceLAVMSE` for `model.family="lava"` (JAX's
    `build_family`)."""
    policy = build_policy(config)
    init_weights(policy, torch.Generator().manual_seed(config.seed))
    return policy.to(resolve_device(device))


def synthetic_batch(config: Config, seed: int, index: int, device, block: int = 0,
                    blocks: int = 1) -> tuple:
    """Batch `index` of the synthetic stream `seed` on `device`: images
    uniform in [0, 1), instruction embeddings N(0, 1), terminate flags in
    {0, 1}, 2-d actions uniform in [-0.1, 0.1) — the distributions of the
    JAX package's `synthetic_batches`. With `blocks` > 1, block `block` of
    the global batch of `per_host_batch_size * blocks` rows (a rank's
    rows)."""
    device = torch.device(device)
    b, t = config.per_host_batch_size * blocks, config.model.time_sequence_length
    h, w = config.data.height, config.data.width
    words = np.random.SeedSequence([seed, index]).generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed((int(words[0]) << 31) ^ int(words[1]))
    obs = {
        "image": torch.rand((b, t, h, w, 3), generator=g, device=device),
        "natural_language_embedding": torch.randn((b, t, EMBEDDING_DIM), generator=g,
                                                  device=device),
    }
    actions = {
        "terminate_episode": torch.randint(0, 2, (b, t), generator=g, device=device,
                                           dtype=torch.int32),
        "action": torch.rand((b, t, 2), generator=g, device=device) * 0.2 - 0.1,
    }
    if blocks > 1:
        n = config.per_host_batch_size
        rows = slice(block * n, (block + 1) * n)
        obs = {k: v[rows] for k, v in obs.items()}
        actions = {k: v[rows] for k, v in actions.items()}
    return obs, actions


def batch_blocks(grid) -> tuple:
    """(this rank's block of the global batch, the number of blocks): the
    data x fsdp coordinate and size; ranks along `seq` share a block."""
    if grid is None:
        return 0, 1
    return grid.batch_index, grid.batch_ways


def check_batch_plan(config: Config, plan: ShardingPlan) -> None:
    """The batch against the plan, at the config seam. JAX's two checks
    (`rt1_tpu/train/train.py`: the batch ways must divide across the
    processes, and each process's rows over its share of them) hold by
    construction with one device a process: the world is the grid, and a
    process's share is one way. What is left: a rank's rows must split
    into its micro-batches, `sp` needs the ring attention, and the
    pipeline (`pp`) runs the RT-1 decoder only, on a rank's accumulation
    micro-batch of a positive multiple of `model.pipeline_microbatches`
    rows (JAX's `rt1_tpu/train/train.py` checks the per-data-shard batch;
    a rank's rows are its data shard's here)."""
    if config.per_host_batch_size % max(config.accum_steps, 1) != 0:
        raise ValueError(f"per_host_batch_size={config.per_host_batch_size} is not divisible "
                         f"by accum_steps={config.accum_steps}")
    if plan.mesh.stage > 1:
        family = config.model.family
        if family != "rt1":
            raise ValueError(
                f"mesh.stage > 1 (pipeline parallelism) is only supported for the 'rt1' "
                f"family; family={family!r} would silently replicate all compute across the "
                "stage axis")
        shard_batch = config.per_host_batch_size // max(config.accum_steps, 1)
        micro = config.model.pipeline_microbatches
        if shard_batch == 0 or shard_batch % micro != 0:
            raise ValueError(
                f"pipeline parallelism: per-data-shard per-accum-step batch {shard_batch} "
                f"(= per_host_batch_size {config.per_host_batch_size} / {config.accum_steps} "
                f"accum steps) must be a positive multiple of pipeline_microbatches={micro}")
    sp = plan.mesh.seq
    if sp > 1 and (config.model.family != "rt1" or config.model.attention_impl != "ring"):
        raise ValueError(f"parallel.sp={sp} needs model.attention_impl='ring' (the RT-1 "
                         "decoder's sequence-parallel attention)")


def check_window_plan(policy, plan: ShardingPlan) -> None:
    """Under `sp` the decoder's window must split over the seq ranks."""
    sp = plan.mesh.seq
    if sp > 1:
        tokens = policy.time_sequence_length * policy.single_step_tokens
        if tokens % sp != 0:
            raise ValueError(f"parallel.sp={sp}: the window of {tokens} tokens is not "
                             f"divisible by the seq ranks")


def make_clip_tokenizer(config: Config):
    """The CLIP BPE tokenizer matching the text tower (JAX's
    `_make_clip_tokenizer`): `data.clip_bpe_path`'s merges (vocab 49408),
    else the byte-level tokenizer (vocab 514). Its vocab must equal
    `model.lava.text_vocab`, checked here rather than deep in a step."""
    from rt1_tpu_torch.text.clip_bpe import ClipBPETokenizer, default_tokenizer

    lv = config.model.lava
    path = config.data.clip_bpe_path
    if path:
        tokenizer = ClipBPETokenizer.from_bpe_file(path, context_length=lv.text_context)
    else:
        tokenizer = default_tokenizer(context_length=lv.text_context)
    vocab = len(tokenizer.encoder)
    if vocab != lv.text_vocab:
        raise ValueError(
            f"model.lava.text_vocab={lv.text_vocab} but the tokenizer "
            f"({'merges file' if path else 'byte-level default'}) has vocab {vocab}; "
            f"set text_vocab={vocab}")
    return tokenizer


def check_clip_token_config(config: Config) -> None:
    """The LAVA "clip" encoder consumes `instruction_tokenized_clip`, which
    only `data.clip_tokens=True` produces, and only from episode files (the
    synthetic batches have no instruction text); producing it for any other
    model ships a dead tensor every step (JAX's `_check_clip_token_config`)."""
    lava_clip = config.model.family == "lava" and config.model.lava.lang_encoder == "clip"
    if lava_clip and not config.data.clip_tokens:
        raise ValueError("model.lava.lang_encoder='clip' requires data.clip_tokens=True "
                         "(the pipeline must emit instruction_tokenized_clip)")
    if config.data.clip_tokens and not lava_clip:
        raise ValueError("data.clip_tokens=True but no model consumes "
                         "instruction_tokenized_clip (set model.lava.lang_encoder='clip')")
    if lava_clip and not config.data.data_dir:
        raise ValueError("model.lava.lang_encoder='clip' needs data.data_dir: the tokens come "
                         "from the episodes' instruction text")


def _print_json(record: Dict) -> None:
    print(json.dumps(record), flush=True)


class DataStream(NamedTuple):
    """Host batches of one split and the loader that makes them
    ("numpy" | "torch" | "packed" | "rlds_tf")."""
    batches: Iterator
    loader: str


def loader_name(config: Config) -> str:
    """The loader `config.data.loader` names ("tf" -> "torch"; "rlds_tf",
    the RLDS windowing pipeline of `data/rlds_pipeline.py`)."""
    loader = {"tf": "torch"}.get(config.data.loader, config.data.loader)
    if loader not in ("numpy", "torch", "rlds_tf"):
        raise ValueError(f"data.loader must be tf | torch | numpy | rlds_tf, "
                         f"got {config.data.loader!r}")
    return loader


def service_job_name(split: str, block: int, blocks: int) -> str:
    """The data-service job of a rank's split: JAX's one job name
    (`rlds_pipeline.py`'s default) for the training split of a single
    rank, `<name>/<split>` for another split and `.../<block>` for a batch
    rank of several. JAX gives every split and rank that one name, so its
    val stream and each rank's `paths[block::blocks]` would join the train
    job, where TF reads nothing (and the port refuses)."""
    from rt1_tpu_torch.data.rlds_pipeline import RldsPipelineConfig

    name = RldsPipelineConfig.data_service_job_name
    if split != "train":
        name += f"/{split}"
    if blocks > 1:
        name += f"/{block}"
    return name


def _rlds_batches(config: Config, split: str, paths, seed: int, block: int,
                  blocks: int) -> DataStream:
    """`data.loader="rlds_tf"` (JAX's `dataset_batches` branch): the episode
    files stream lazily, a rank reading `paths[block::blocks]`, through the
    RLDS windowing pipeline; training shuffles and repeats, the other
    splits are read once, in order. With `data.data_service_address` the
    pipeline runs on the data service's workers (`service_job_name`).
    JAX's refusals come first."""
    d = config.data
    if d.clip_tokens:
        raise ValueError("clip_tokens requires the windowed loaders ('tf' or 'numpy'); "
                         "the rlds_tf graph pipeline does not tokenize instructions")
    if d.packed_cache:
        raise ValueError("data.packed_cache=True is incompatible with loader='rlds_tf' (the "
                         "pure-TF graph cannot read the packed mmap store); use loader='tf' "
                         "or 'numpy'")
    from rt1_tpu_torch.data import rlds_pipeline

    cfg = rlds_pipeline.RldsPipelineConfig(
        window=config.model.time_sequence_length, crop_factor=d.crop_factor, height=d.height,
        width=d.width, batch_size=config.per_host_batch_size, shuffle_buffer=d.shuffle_buffer,
        seed=seed, data_service_address=d.data_service_address,
        data_service_job_name=service_job_name(split, block, blocks))
    episodes = rlds_pipeline.make_episode_dataset_from_paths(paths[block::blocks])
    return DataStream(rlds_pipeline.windowed_rlds_dataset(episodes, cfg,
                                                          training=split == "train"), "rlds_tf")


def _retrying(config: Config):
    """`fn(*args, name=..., **kwargs)` called through `retry_call` with the
    config's I/O retry (once without it)."""
    retry_opts = resilience.ResilienceOptions.from_config(config).retry_options()

    def build(fn, *args, name, **kwargs):
        if retry_opts is None:
            return fn(*args, **kwargs)
        return resilience.retry_call(fn, *args, options=retry_opts, name=name, **kwargs)

    return build


def _packed_batches(config: Config, split: str, paths, seed: int,
                    log: Callable[[Dict], None], block: int = 0,
                    blocks: int = 1) -> Optional[SampleAheadFeeder]:
    """The packed-cache feed of `split`, or None (logged) when its pack is
    missing or stale, so that training falls back to the windowed loader
    rather than train on stale pixels. With `resilience.io_retry` the
    pack's open and the feeder's construction retry with backoff."""
    d = config.data
    pack_dir = d.packed_cache_dir or pack_lib.default_pack_dir(d.data_dir, split)
    fresh, reason = pack_lib.pack_status(pack_dir, paths, d.height, d.width, d.crop_factor)
    if not fresh:
        log({"status": "packed_cache_stale", "split": split, "pack_dir": pack_dir,
             "reason": reason, "fallback": loader_name(config),
             "build": f"python -m rt1_tpu_torch.data.pack_dataset --data_dir {d.data_dir} "
                      f"--split {split} --height {d.height} --width {d.width} "
                      f"--crop_factor {d.crop_factor}"})
        return None
    build = _retrying(config)
    cache = build(pack_lib.PackedEpisodeCache, pack_dir, window=config.model.time_sequence_length,
                  clip_tokenizer=make_clip_tokenizer(config) if d.clip_tokens else None,
                  name="packed_cache_open")
    # Task weights, the mid-run pickup of appended shards and the per-task
    # ids of the health pack: train only; eval streams stay the unweighted
    # walk of one corpus.
    train = split == "train"
    return build(
        SampleAheadFeeder, cache, config.per_host_batch_size, seed=seed, shuffle=train,
        num_threads=d.feeder_threads, depth=d.feeder_depth,
        stall_timeout_s=d.feeder_stall_timeout_s,
        # Single-process only, as in JAX: a per-rank refresh has no barrier.
        refresh_at_epoch=train and d.packed_refresh and dist_lib.world_size() == 1,
        task_weights=parse_task_weights(d.task_weights) if train else None,
        # The per-task ids feed the RT-1 health pack's token statistics.
        emit_task_ids=train and config.obs.model_health and config.model.family == "rt1",
        process_index=block, process_count=blocks,
        name="feeder_construct")


def dataset_batches(config: Config, split: str = "train", seed: Optional[int] = None,
                    log: Callable[[Dict], None] = _print_json,
                    pin_memory: bool = False, block: int = 0, blocks: int = 1) -> DataStream:
    """The endless host-batch stream of `<data_dir>/<split>/episode_*.np*`
    (counterpart of the JAX loop's `dataset_batches`): the packed cache's
    feeder when `data.packed_cache` and the pack is fresh, else the
    windowed loader. `seed` overrides `config.seed` (a guard rollback
    reopens the stream with a fresh one); `pin_memory` pins the torch
    loader's batches for the upload; `block` of `blocks` is a rank's share
    of the stream (each loader's `process_index` / `process_count`).
    Raises FileNotFoundError when the split has no episodes."""
    d = config.data
    loader = loader_name(config)
    stream_seed = config.seed if seed is None else seed
    paths = sorted(glob.glob(os.path.join(d.data_dir, split, "episode_*.np*")))
    if not paths:
        raise FileNotFoundError(f"No episodes under {d.data_dir}/{split}")
    if loader == "rlds_tf":
        return _rlds_batches(config, split, paths, stream_seed, block, blocks)
    if d.packed_cache:
        feeder = _packed_batches(config, split, paths, stream_seed, log, block, blocks)
        if feeder is not None:
            return DataStream(feeder, "packed")
    ds = WindowedEpisodeDataset(paths, window=config.model.time_sequence_length,
                                crop_factor=d.crop_factor, height=d.height, width=d.width,
                                clip_tokenizer=make_clip_tokenizer(config) if d.clip_tokens
                                else None)
    if loader == "torch":
        return DataStream(loader_batches(ds.as_torch_loader(
            config.per_host_batch_size, seed=stream_seed, num_workers=d.num_workers,
            prefetch_factor=d.prefetch_factor, pin_memory=pin_memory,
            # JAX's tf.data loader shuffles through a bounded buffer; the
            # torch and numpy loaders keep a full permutation an epoch.
            shuffle_buffer=d.shuffle_buffer if d.loader == "tf" else None,
            process_index=block, process_count=blocks)), "torch")
    return DataStream(ds.numpy_batches(config.per_host_batch_size, seed=stream_seed,
                                       process_index=block, process_count=blocks), "numpy")


class TrainFeed:
    """The train batches on the device, one stream of them: host batches
    (episode files through `dataset_batches`, or the synthetic batches of
    `seed` from `start_step` on) -> the `nan_batch` fault site, indexed by
    the batch's ordinal in this stream -> the timeline's `wait_data`
    bucket -> `device_feeder` (two batches in flight) for file batches.
    `peek()` pulls the first batch ahead and hands it out again."""

    def __init__(self, config: Config, dev: torch.device, timeline, seed: int, start_step: int,
                 log: Callable[[Dict], None], grid=None):
        self.host = None
        block, blocks = batch_blocks(grid)
        if config.data.data_dir:
            stream = dataset_batches(config, "train", seed=seed, log=log,
                                     pin_memory=dev.type == "cuda", block=block, blocks=blocks)
            self.host, self.loader = stream.batches, stream.loader
            source = self.host
        else:
            self.loader = "synthetic"
            source = (synthetic_batch(config, seed, start_step + i, dev, block, blocks)
                      for i in itertools.count())
        plan = faults.active()
        if plan is not None:
            source = self._with_faults(source, plan, log)
        source = timeline.timed(source)
        self._batches = device_feeder(source, dev, depth=2) if self.host is not None else source
        self._ahead = []

    @staticmethod
    def _with_faults(source, plan, log):
        for i, batch in enumerate(source):
            if plan.should_fire("nan_batch", index=i):
                log({"status": "injected_fault", "site": "nan_batch", "host_batch": i})
                batch = faults.poison_batch(batch)
            yield batch

    def stats(self):
        """The feeder's gauges, or None for a source without them."""
        return getattr(self.host, "stats", None)

    def flywheel_stats(self):
        """The feeder's corpus-growth gauges callable (shards, freshness
        epoch, corpus size, staleness), or None when the feed is not the
        packed feeder."""
        return getattr(self.host, "flywheel_stats", None)

    def peek(self):
        if not self._ahead:
            self._ahead.append(next(self._batches))
        return self._ahead[0]

    def __iter__(self):
        return self

    def __next__(self):
        return self._ahead.pop() if self._ahead else next(self._batches)

    def close(self) -> None:
        """Drop the batches in flight and stop the host stream (a feeder's
        threads, a DataLoader's workers)."""
        closer = getattr(self._batches, "close", None)
        if closer is not None:
            closer()
        closer = getattr(self.host, "close", None)
        if closer is not None:
            closer()


def checkpoint_manager(config: Config, workdir: str, on_io=None, grid=None) -> CheckpointManager:
    """The run's checkpoints under `<workdir>/checkpoints`, retained as the
    JAX trainer retains them (`rt1_tpu/train/train.py:680-689`):
    `max_to_keep or None`, so 0 keeps every step, and `keep_period`; with
    `resilience.io_retry` each save and restore retries with backoff, and
    `on_io` receives each one's seconds; with the `grid` of a
    multi-process run the saves are sharded."""
    return CheckpointManager(os.path.join(workdir, "checkpoints"),
                             max_to_keep=config.max_to_keep or None,
                             keep_period=config.keep_period, seed=config.seed,
                             retry=resilience.ResilienceOptions.from_config(config).retry_options(),
                             on_io=on_io, grid=grid)


class _ReopeningFeed:
    """The val batches of `open_feed()`, opened again from the split's
    start when a one-pass stream ends: loader "rlds_tf" reads val once and
    in order, as JAX's does, and JAX's loop raises StopIteration at the
    eval that finds the stream spent."""

    def __init__(self, open_feed: Callable[[], Iterator]):
        self._open = open_feed
        self._feed = open_feed()

    def __next__(self):
        try:
            return next(self._feed)
        except StopIteration:
            self._feed.close()
            self._feed = self._open()
        try:
            return next(self._feed)
        except StopIteration:
            raise RuntimeError("the val split yields no batch (fewer windows than the "
                               "batch)") from None

    def close(self) -> None:
        self._feed.close()


def _eval_feed(config: Config, dev: torch.device, log, grid=None):
    """(the eval batches' callable or None, the device feeder to close or
    None): `eval_batches` batches from the running `<data_dir>/val` stream
    (no eval without that split), or the fixed synthetic batches of seed
    `seed + 1`."""
    if not config.eval_every_steps:
        return None, None
    block, blocks = batch_blocks(grid)
    if config.data.data_dir:
        def open_feed():
            return device_feeder(dataset_batches(config, "val", log=log,
                                                 pin_memory=dev.type == "cuda", block=block,
                                                 blocks=blocks).batches, dev, depth=1)

        try:
            feed = _ReopeningFeed(open_feed)
        except FileNotFoundError:
            return None, None  # no val split: no eval, as in JAX
        return (lambda: [next(feed) for _ in range(config.eval_batches)]), feed
    fixed = [synthetic_batch(config, config.seed + 1, i, dev, block, blocks)
             for i in range(config.eval_batches)]
    return (lambda: fixed), None


def _stamp_manifest(config: Config, workdir: str) -> None:
    """`<workdir>/data_manifest.json` from the dataset's manifest."""
    manifest = read_manifest(config.data.data_dir)
    if manifest is not None:
        os.makedirs(workdir, exist_ok=True)
        with open(os.path.join(workdir, "data_manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True)


def _flag_group(grid):
    """The group the loop shares the preemption flag over, None for one
    process: a gloo group of every rank, so that the per-step poll is a
    host all-reduce and never waits for the card (on an NCCL world a
    device all-reduce read back with `.item()` would sync every step)."""
    if not grid.distributed:
        return None
    import torch.distributed as dist

    return dist.new_group(backend="gloo")


def _any_rank(flag: bool, group) -> bool:
    """`flag` on any rank of `group` (a signal may reach one rank only; the
    ranks must save and stop together); `flag` itself without a group."""
    if group is None:
        return flag
    import torch.distributed as dist

    t = torch.tensor([1 if flag else 0], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


def train_and_evaluate(config: Config, workdir: str, device=None,
                       log: Callable[[Dict], None] = _print_json) -> TrainState:
    """Train per `config` in `workdir`; returns the final TrainState.
    Runs on `cuda` unless `device` says otherwise (and raises without a
    card).

    The resilience and observability of the JAX loop (`rt1_tpu/train/
    train.py::train_and_evaluate`), in its order: with `resilience.guard`,
    non-finite updates are skipped on the device and persistent divergence
    escalates to a checkpoint rollback with a fresh data seed (`seed +
    7919 * rollbacks`), bounded by `guard_rollback_budget`, then
    `GuardAbortError`; with `preempt_save`, SIGTERM/SIGINT force-saves a
    checkpoint at the current step, drains the feeds and returns normally
    (the CLI exits 0); with `io_retry`, checkpoint and packed-cache I/O
    retry with backoff. `obs.*` adds the step timeline, the goodput ledger
    (`goodput_summary.json`, written on success, crash and preemption),
    its MFU gauge, the health pack at log steps, the flight recorder
    (`flight_record.jsonl` on a crash, SIGTERM or preemption), the host
    trace and the Prometheus listener (`obs.prometheus_port`); all of them
    are torn down on every exit.
    """
    check_parallel_config(config)
    dev = resolve_device(device)
    # The rendezvous first, before any device access (a no-op unless
    # parallel.distributed is on), then ONE plan resolution into the grid.
    dist_lib.initialize_from_config(config, dev)
    dev = dist_lib.rank_device(dev)
    plan = ShardingPlan.from_config(config)
    check_batch_plan(config, plan)
    grid = mesh_lib.RankGrid(plan.mesh)
    primary = dist_lib.is_primary()
    obs_opts = obs.ObsOptions.from_config(config, workdir)
    if not primary:  # rank 0 logs; one writer of each side file, one scrape listener
        log = lambda record: None  # noqa: E731
        obs_opts = dataclasses.replace(obs_opts, trace=False, flight_recorder=False,
                                       goodput_summary_path=None, prometheus_port=-1)
    res_opts = resilience.ResilienceOptions.from_config(config)
    # Released on every exit, in reverse order: a bound scrape port, a
    # signal handler or a process-wide tracer left behind poisons the next
    # run in this process.
    cleanup = contextlib.ExitStack()
    with cleanup:
        mesh_lib.set_current(grid)
        cleanup.callback(mesh_lib.set_current, None)
        if obs_opts.trace:
            # Before the feeds exist, or their workers' spans are lost.
            obs.trace.enable(obs_opts.trace_path, obs_opts.trace_max_events)
            cleanup.callback(obs.trace.disable)
        # Everything from here to the first step accrues to "init"; the
        # checkpoint restore is carved out into "ckpt_restore" (on_io).
        ledger = None
        if obs_opts.goodput:
            ledger = obs.GoodputLedger()
            ledger.open_phase("init")
        fault_plan = faults.install_from(res_opts.faults)
        if fault_plan is not None:
            log({"status": "fault_plan", "specs": sorted(fault_plan.fired_counts())})
        step_guard = resilience.StepGuard(res_opts.guard_options()) if res_opts.guard else None

        check_clip_token_config(config)
        policy = build_model(config, dev)
        check_window_plan(policy, plan)
        if config.model.family == "rt1":  # the rules describe RT-1's paths only, as in JAX
            plan.check_coverage(policy)
        # Under tp or pp the rank keeps its part of the policy.
        partition = partition_policy(policy, grid, plan, config.model.pipeline_microbatches)
        ckpt = checkpoint_manager(config, workdir,
                                  on_io=ledger.note_io if ledger is not None else None,
                                  grid=grid)
        pretrained = config.model.pretrained_encoder
        if pretrained and ckpt.latest_step() is None:
            # The JAX loop's graft (`rt1_tpu/train/train.py:642-670`): a
            # resumed run's checkpoint wins, and grafting first would log a
            # false line.
            graft_encoder_into_policy(policy, load_encoder(pretrained))
            log({"status": "grafted_pretrained_encoder", "path": pretrained})
        optimizer = optimizer_from_config(config)
        state = create_train_state(policy, optimizer, partition)
        if grid.size("fsdp") > 1:  # ZeRO-3: this rank's chunk of the masters and moments
            shard_train_state(state, grid.index("fsdp"), grid.size("fsdp"), optimizer)
        state, initial_step = ckpt.restore_or_initialize(state)

        timeline = obs.StepTimeline(window=obs_opts.stall_window, sync=obs_opts.sync_timing)
        if config.data.data_dir and primary:
            _stamp_manifest(config, workdir)
        live = {"train": TrainFeed(config, dev, timeline, config.seed, initial_step, log, grid)}
        cleanup.callback(lambda: live["train"].close())
        feeder_stats = live["train"].stats()
        # Flywheel corpus gauges (shards / freshness epoch / corpus size /
        # staleness) when the packed feeder feeds: rt1_flywheel_* on the
        # scrape and flywheel/* in metrics.jsonl.
        flywheel_stats = live["train"].flywheel_stats()
        fns = train_step_fns_from_config(
            config, optimizer,
            health_task_names=getattr(live["train"].host, "health_task_names", ()) or (),
            grid=grid)
        health_names = fns.health_names(state)

        if ledger is not None and obs_opts.goodput_mfu:
            # FLOPs of the forward and backward of the first batch (the
            # optimizer, guard and pack add no counted FLOPs). The
            # BatchNorm statistics this pass advances are put back, so
            # the run's state is untouched; a failed count disarms the
            # gauge.
            first = live["train"].peek()

            def _forward_backward():
                saved = state.flat_buffers.clone()
                try:
                    fns.value_and_grad(state, first, initial_step)
                finally:
                    state.flat_buffers.copy_(saved)

            with obs.trace.span("goodput_flops_estimate"):
                ledger.set_flops_per_step(obs.flops.train_step_flops(_forward_backward))

        eval_next, eval_feed = _eval_feed(config, dev, log, grid)
        if eval_feed is not None:
            cleanup.callback(eval_feed.close)
        writer = MetricsWriter(workdir, enabled=primary)
        # The run's throughput: the global batch, every rank's rows.
        meter = ThroughputMeter(config.per_host_batch_size * grid.batch_ways,
                                config.model.time_sequence_length, initial_step=initial_step)

        recorder = None
        if obs_opts.flight_recorder:
            recorder = obs.FlightRecorder(obs_opts.flight_recorder_size,
                                          path=obs_opts.flight_recorder_path)
        coordinator = None
        if res_opts.preempt_save:
            # The first SIGTERM/SIGINT dumps the flight record and sets a
            # flag the loop polls: the loop force-saves, drains and
            # returns. A second signal restores the previous handlers and
            # re-raises it.
            callbacks = [lambda: recorder.dump(reason="preempt")] if recorder is not None else []
            coordinator = resilience.PreemptionCoordinator(callbacks=callbacks)
            coordinator.install()
            cleanup.callback(coordinator.uninstall)
            flag_group = _flag_group(grid)
        elif recorder is not None:
            # SIGTERM chains to SIG_DFL and the process dies there: the host
            # trace must dump inside the handler.
            recorder.install_sigterm(extra=obs.trace.dump if obs_opts.trace else None)
            cleanup.callback(recorder.uninstall_sigterm)

        # The scrape listener renders the latest written scalars and the
        # live gauges on the scraper's thread, never the step's.
        latest_scalars: Dict[str, float] = {}
        metrics_server = None
        if obs_opts.prometheus_port >= 0:
            def _render_prometheus():
                scalars = dict(latest_scalars)
                scalars.update(timeline.scalars())
                if feeder_stats is not None:
                    scalars.update({f"feeder/{k}": v for k, v in feeder_stats().items()})
                if step_guard is not None:
                    scalars.update(step_guard.counters())
                scalars.update(resilience.retry.counters())
                if coordinator is not None:
                    scalars.update(coordinator.counters())
                if fault_plan is not None:
                    scalars.update(fault_plan.counters())
                if ledger is not None:
                    scalars.update(ledger.scalars())
                body = obs.prometheus.render_scalar_gauges(scalars)
                # rt1_flywheel_*: live on every scrape, so a shard pickup
                # shows the moment the feeder takes it.
                if flywheel_stats is not None:
                    body += obs.prometheus.render_scalar_gauges(
                        flywheel_stats(), prefix="rt1_flywheel_")
                return body

            metrics_server = obs.MetricsServer(_render_prometheus, host=obs_opts.prometheus_host,
                                               port=obs_opts.prometheus_port)
            cleanup.callback(metrics_server.close)

        def _write_goodput():
            # Success, crash and preemption all leave a summary on disk.
            if ledger is None or not obs_opts.goodput_summary_path:
                return
            try:
                ledger.write_summary(obs_opts.goodput_summary_path)
            except OSError as exc:  # accounting must not mask the exit
                log({"status": "goodput_summary_failed", "error": repr(exc)})

        cleanup.callback(_write_goodput)
        log({"status": "start", "device": str(dev), "restored_step": initial_step or None,
             "num_steps": config.num_steps, "learning_rate": config.learning_rate,
             "seed": config.seed,
             "compute_dtype": str(fns.compute_dtype).split(".")[-1],
             "parameters": sum(state.layout.numels),
             "world": grid.world, "mesh": grid.mesh.shape,
             "global_batch": config.per_host_batch_size * grid.batch_ways,
             "data_loader": live["train"].loader,
             "metrics_url": metrics_server.url if metrics_server is not None else None})
        crash_guard = recorder.dump_on_exception() if recorder is not None \
            else contextlib.nullcontext()
        # Steps before this mark are re-runs after a rollback: the ledger
        # books them as rollback_replay, not productive time.
        replay_until = initial_step
        saved_step = None
        preempted = False
        if ledger is not None:
            ledger.close_phase()  # init ends where the step loop begins
        with crash_guard:
            step = initial_step
            while step < config.num_steps:
                if fault_plan is not None:
                    # The chaos stand-in for a scheduler's preemption,
                    # handled exactly as the real one.
                    faults.maybe_signal("sigterm", index=step)
                timeline.start_step(step)
                # The profiler's step mark spans the batch pull and the
                # step, as JAX's does, so a step's view keeps its input
                # wait and upload.
                with step_trace("train", step):
                    with timeline.phase("h2d", exclusive_of="wait_data"):
                        batch = next(live["train"])
                    with timeline.phase("device_step"):
                        metrics = fns.train_step(state, batch, step)
                step_record = timeline.end_step(sync_on=metrics["loss"])
                if ledger is not None:
                    ledger.note_step(step_record, replay=step < replay_until)

                log_now = (step + 1) % config.log_every_steps == 0
                verdict = resilience.GuardVerdict.OK
                health_scalars = None
                scalars: Dict[str, float] = {}
                if log_now:
                    # The pack is a vector: unpacked by name, not averaged.
                    health_vec = metrics.pop(obs.health.PACK_KEY, None)
                    scalars = scalars_from_metrics(metrics)
                    if health_vec is not None:
                        health_scalars = obs.health.unpack(health_names, health_vec)
                        scalars.update(health_scalars)
                    if step_guard is not None:
                        verdict = step_guard.observe(step + 1, scalars)
                        scalars.update(step_guard.counters())
                    scalars.update(meter.update(step + 1))
                    scalars.update(timeline.scalars())
                    if ledger is not None:
                        scalars.update(ledger.scalars())
                    if feeder_stats is not None:
                        scalars.update({f"feeder/{k}": v for k, v in feeder_stats().items()})
                    if flywheel_stats is not None:
                        scalars.update({f"flywheel/{k}": v for k, v in flywheel_stats().items()})
                    scalars.update(resilience.retry.counters())
                    if coordinator is not None:
                        scalars.update(coordinator.counters())
                    if fault_plan is not None:
                        scalars.update(fault_plan.counters())
                    log(writer.write(step + 1, scalars))
                    latest_scalars.update(scalars)
                    latest_scalars["step"] = step + 1

                if recorder is not None:
                    rec = {k: v for k, v in step_record.items() if k != "step"}
                    if log_now:
                        rec["loss"] = scalars.get("loss")
                        if health_scalars is not None:
                            rec["health"] = health_scalars
                        if step_guard is not None:
                            rec["guard"] = step_guard.counters()
                        retry_counters = resilience.retry.counters()
                        if retry_counters:
                            rec["retry"] = retry_counters
                    if feeder_stats is not None:
                        rec["feeder"] = feeder_stats()
                    recorder.record(step + 1, **rec)

                if verdict is resilience.GuardVerdict.ABORT:
                    raise resilience.GuardAbortError(
                        f"guard: rollback budget ({res_opts.guard_rollback_budget}) exhausted "
                        f"and training is still unhealthy at step {step + 1}: "
                        f"{step_guard.last_reason}")
                if verdict is resilience.GuardVerdict.ROLLBACK:
                    target = ckpt.latest_step()
                    if target is None:
                        raise resilience.GuardAbortError(
                            f"guard: training unhealthy at step {step + 1} "
                            f"({step_guard.last_reason}) with no checkpoint to roll back to "
                            f"(first save at step {config.checkpoint_every_steps})")
                    # The skip count is the run's, not the checkpoint's: it
                    # keeps counting across the rollback, as JAX's does.
                    skips = state.guard_skips.clone()
                    ckpt.restore(state, step=target)
                    state.guard_skips.copy_(skips)
                    step_guard.notify_rollback(target)
                    # A fresh stream: re-walking the batches that diverged
                    # would diverge again.
                    fresh_seed = config.seed + 7919 * step_guard.rollbacks
                    log({"status": "guard_rollback", "step": step + 1,
                         "reason": step_guard.last_reason, "restored_step": target,
                         "seed": fresh_seed})
                    live["train"].close()
                    live["train"] = TrainFeed(config, dev, timeline, fresh_seed, target, log,
                                              grid)
                    feeder_stats = live["train"].stats()
                    flywheel_stats = live["train"].flywheel_stats()
                    obs.trace.counter("guard_rollbacks", step_guard.rollbacks)
                    if ledger is not None:
                        ledger.mark_rollback()
                    replay_until = max(replay_until, step + 1)
                    step = target
                    continue

                if eval_next is not None and (step + 1) % config.eval_every_steps == 0:
                    before = dict(fused_attention.launches_by_variant)
                    results = [scalars_from_metrics(fns.eval_step(state, b)) for b in eval_next()]
                    accuracy = {}
                    if "token_accuracy" in results[0]:  # RT-1's token heads
                        accuracy["eval_token_accuracy"] = float(
                            np.mean([r["token_accuracy"] for r in results]))
                    log(writer.write(step + 1, {
                        "eval_loss": float(np.mean([r["loss"] for r in results])),
                        **accuracy,
                        "eval_batches": len(results),
                        # Fused-attention kernel launches in this eval, by variant.
                        **{f"eval_attention_launches_{v}": n - before[v]
                           for v, n in fused_attention.launches_by_variant.items()},
                    }))

                saved = False
                if step + 1 == config.num_steps or (step + 1) % config.checkpoint_every_steps == 0:
                    # Between steps: a trace span, not a timeline bucket.
                    with obs.trace.span("checkpoint_save", step=step + 1):
                        ckpt.save(step + 1, state)
                    saved, saved_step = True, step + 1

                if coordinator is not None and _any_rank(coordinator.triggered, flag_group):
                    log({"status": "preempted", "signal": coordinator.signum, "step": step + 1})
                    if ledger is not None:
                        ledger.mark_preempted()
                    drain = ledger.phase("preempt_drain") if ledger is not None \
                        else contextlib.nullcontext()
                    # The force-save inside the drain lands in ckpt_save
                    # (note_io steals it from the phase).
                    with drain:
                        if not saved:
                            with obs.trace.span("preempt_save", step=step + 1):
                                ckpt.save(step + 1, state)
                            saved_step = step + 1
                        live["train"].close()
                        if eval_feed is not None:
                            eval_feed.close()
                    preempted = True
                    step += 1
                    break

                step += 1
    done = {"status": "done", "step": step, "updates": int(state.step),
            "guard_skips": int(state.guard_skips),
            "checkpoint_step": saved_step or ckpt.latest_step()}
    if preempted:
        done["preempted"] = True
    log(done)
    return state
