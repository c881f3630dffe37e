"""The training loop (counterpart of `rt1_tpu/train/train.py`).

`train_and_evaluate(config, workdir)` builds the policy the config
describes (`build_model`: the `efficientnet_b3`, `efficientnet_small` and
`tiny` tokenizers), initialises it from `config.seed` or restores the
newest checkpoint under `<workdir>/checkpoints`, then steps: a metrics
line every `log_every_steps` (to `<workdir>/metrics.jsonl` and the
caller's `log`), an eval every `eval_every_steps`, a checkpoint every
`checkpoint_every_steps` and at the last step.

Data, with `config.data.data_dir` set: episode files under
`<data_dir>/train` (`dataset_batches`) through the packed cache and the
sample-ahead feeder (`data.packed_cache=True` and a fresh pack), else the
windowed loader (`data.loader`: "torch", the DataLoader, or "numpy"),
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
(the JAX loop restarts its one synthetic stream instead). Eval uses the
fixed batches `0 .. eval_batches - 1` of seed `seed + 1`.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Callable, Dict, Iterator, NamedTuple, Optional

import numpy as np
import torch

from rt1_tpu_torch import resolve_device
from rt1_tpu_torch.configs import Config, DataConfig
from rt1_tpu_torch.convert import init_weights
from rt1_tpu_torch.data import pack as pack_lib
from rt1_tpu_torch.data.episodes import read_manifest
from rt1_tpu_torch.data.feeder import SampleAheadFeeder, parse_task_weights
from rt1_tpu_torch.data.pipeline import WindowedEpisodeDataset, device_feeder, loader_batches
from rt1_tpu_torch.eval.restore import build_policy
from rt1_tpu_torch.parallel.flash_attention import fused_attention
from rt1_tpu_torch.train.pretrain_vision import graft_encoder_into_policy, load_encoder
from rt1_tpu_torch.trainer.checkpoints import CheckpointManager
from rt1_tpu_torch.trainer.metrics import MetricsWriter, ThroughputMeter, scalars_from_metrics
from rt1_tpu_torch.trainer.state import TrainState, create_train_state
from rt1_tpu_torch.trainer.train import optimizer_from_config, train_step_fns_from_config

EMBEDDING_DIM = 512


def build_model(config: Config, device=None):
    """The policy of `config.model` in float32 on `device`, initialised
    from `config.seed` (flax's initializer families, `convert.init_weights`)."""
    policy = build_policy(config)
    init_weights(policy, torch.Generator().manual_seed(config.seed))
    return policy.to(resolve_device(device))


def synthetic_batch(config: Config, seed: int, index: int, device) -> tuple:
    """Batch `index` of the synthetic stream `seed` on `device`: images
    uniform in [0, 1), instruction embeddings N(0, 1), terminate flags in
    {0, 1}, 2-d actions uniform in [-0.1, 0.1) — the distributions of the
    JAX package's `synthetic_batches`."""
    device = torch.device(device)
    b, t = config.per_host_batch_size, config.model.time_sequence_length
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
    return obs, actions


def _print_json(record: Dict) -> None:
    print(json.dumps(record), flush=True)


class DataStream(NamedTuple):
    """Host batches of one split and the loader that makes them
    ("numpy" | "torch" | "packed")."""
    batches: Iterator
    loader: str


def loader_name(config: Config) -> str:
    """The windowed loader `config.data.loader` names ("tf" -> "torch")."""
    loader = {"tf": "torch"}.get(config.data.loader, config.data.loader)
    if loader == "rlds_tf":
        raise ValueError("data.loader='rlds_tf' (the pure-TF graph pipeline) needs TensorFlow, "
                         "which the port does not use; it is not ported yet")
    if loader not in ("numpy", "torch"):
        raise ValueError(f"data.loader must be tf | torch | numpy, got {config.data.loader!r}")
    return loader


def _packed_batches(config: Config, split: str, paths, seed: int,
                    log: Callable[[Dict], None]) -> Optional[SampleAheadFeeder]:
    """The packed-cache feed of `split`, or None (logged) when its pack is
    missing or stale, so that training falls back to the windowed loader
    rather than train on stale pixels."""
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
    cache = pack_lib.PackedEpisodeCache(pack_dir, window=config.model.time_sequence_length)
    # Task weights and the mid-run pickup of appended shards: train only;
    # eval streams stay the unweighted walk of one corpus.
    train = split == "train"
    return SampleAheadFeeder(
        cache, config.per_host_batch_size, seed=seed, shuffle=train,
        num_threads=d.feeder_threads, depth=d.feeder_depth,
        stall_timeout_s=d.feeder_stall_timeout_s,
        refresh_at_epoch=train and d.packed_refresh,
        task_weights=parse_task_weights(d.task_weights) if train else None)


def dataset_batches(config: Config, split: str = "train", seed: Optional[int] = None,
                    log: Callable[[Dict], None] = _print_json,
                    pin_memory: bool = False) -> DataStream:
    """The endless host-batch stream of `<data_dir>/<split>/episode_*.np*`
    (counterpart of the JAX loop's `dataset_batches`): the packed cache's
    feeder when `data.packed_cache` and the pack is fresh, else the
    windowed loader. `seed` overrides `config.seed`; `pin_memory` pins the
    torch loader's batches for the upload. Raises FileNotFoundError when
    the split has no episodes."""
    d = config.data
    if d.clip_tokens:
        raise ValueError("data.clip_tokens (CLIP BPE instruction tokens for LAVA) is not ported "
                         "yet")
    if d.shuffle_buffer != DataConfig.shuffle_buffer:
        raise ValueError(f"data.shuffle_buffer={d.shuffle_buffer}: tf.data's shuffle buffer has no "
                         "counterpart in the port, whose loaders draw a full permutation per "
                         f"epoch; leave it at {DataConfig.shuffle_buffer}")
    loader = loader_name(config)
    stream_seed = config.seed if seed is None else seed
    paths = sorted(glob.glob(os.path.join(d.data_dir, split, "episode_*.np*")))
    if not paths:
        raise FileNotFoundError(f"No episodes under {d.data_dir}/{split}")
    if d.packed_cache:
        feeder = _packed_batches(config, split, paths, stream_seed, log)
        if feeder is not None:
            return DataStream(feeder, "packed")
    ds = WindowedEpisodeDataset(paths, window=config.model.time_sequence_length,
                                crop_factor=d.crop_factor, height=d.height, width=d.width)
    if loader == "torch":
        return DataStream(loader_batches(ds.as_torch_loader(
            config.per_host_batch_size, seed=stream_seed, num_workers=d.num_workers,
            prefetch_factor=d.prefetch_factor, pin_memory=pin_memory)), "torch")
    return DataStream(ds.numpy_batches(config.per_host_batch_size, seed=stream_seed), "numpy")


def _data_feeds(config: Config, dev: torch.device, workdir: str, log):
    """(train feed, eval feed or None, loader name) of a run on episode
    files; stamps `<workdir>/data_manifest.json` from the dataset's."""
    pin = dev.type == "cuda"
    train = dataset_batches(config, "train", log=log, pin_memory=pin)
    manifest = read_manifest(config.data.data_dir)
    if manifest is not None:
        os.makedirs(workdir, exist_ok=True)
        with open(os.path.join(workdir, "data_manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True)
    evals = None
    if config.eval_every_steps:
        try:
            evals = device_feeder(dataset_batches(config, "val", log=log, pin_memory=pin).batches,
                                  dev, depth=1)
        except FileNotFoundError:
            evals = None  # no val split: no eval, as in JAX
    return device_feeder(train.batches, dev, depth=2), evals, train.loader


def checkpoint_manager(config: Config, workdir: str) -> CheckpointManager:
    """The run's checkpoints under `<workdir>/checkpoints`, retained as the
    JAX trainer retains them (`rt1_tpu/train/train.py:680-689`):
    `max_to_keep or None`, so 0 keeps every step, and `keep_period`."""
    return CheckpointManager(os.path.join(workdir, "checkpoints"),
                             max_to_keep=config.max_to_keep or None,
                             keep_period=config.keep_period, seed=config.seed)


def train_and_evaluate(config: Config, workdir: str, device=None,
                       log: Callable[[Dict], None] = _print_json) -> TrainState:
    """Train per `config` in `workdir`; returns the final TrainState.
    Runs on `cuda` unless `device` says otherwise (and raises without a
    card)."""
    dev = resolve_device(device)
    policy = build_model(config, dev)
    ckpt = checkpoint_manager(config, workdir)
    pretrained = config.model.pretrained_encoder
    if pretrained and ckpt.latest_step() is None:
        # The JAX loop's graft (`rt1_tpu/train/train.py:642-670`): a resumed
        # run's checkpoint wins, and grafting first would log a false line.
        graft_encoder_into_policy(policy, load_encoder(pretrained))
        log({"status": "grafted_pretrained_encoder", "path": pretrained})
    optimizer = optimizer_from_config(config)
    state = create_train_state(policy, optimizer)
    state, initial_step = ckpt.restore_or_initialize(state)
    fns = train_step_fns_from_config(config, optimizer)
    train_feed = eval_feed = None
    if config.data.data_dir:
        train_feed, eval_feed, data_loader = _data_feeds(config, dev, workdir, log)
        eval_next = None if eval_feed is None else (
            lambda: [next(eval_feed) for _ in range(config.eval_batches)])
    else:
        data_loader = "synthetic"
        fixed = [synthetic_batch(config, config.seed + 1, i, dev)
                 for i in range(config.eval_batches)] if config.eval_every_steps else []
        eval_next = (lambda: fixed) if fixed else None
    log({"status": "start", "device": str(dev), "restored_step": initial_step or None,
         "num_steps": config.num_steps, "compute_dtype": str(fns.compute_dtype).split(".")[-1],
         "parameters": sum(p.numel() for p in policy.parameters()), "data_loader": data_loader})
    writer = MetricsWriter(workdir)
    meter = ThroughputMeter(config.per_host_batch_size, config.model.time_sequence_length,
                            initial_step=initial_step)
    saved = None
    step = initial_step
    try:
        while step < config.num_steps:
            batch = next(train_feed) if train_feed is not None else \
                synthetic_batch(config, config.seed, step, dev)
            metrics = fns.train_step(state, batch, step)
            if (step + 1) % config.log_every_steps == 0:
                scalars = scalars_from_metrics(metrics)
                scalars.update(meter.update(step + 1))
                log(writer.write(step + 1, scalars))
            if eval_next is not None and (step + 1) % config.eval_every_steps == 0:
                before = dict(fused_attention.launches_by_variant)
                results = [scalars_from_metrics(fns.eval_step(state, b)) for b in eval_next()]
                log(writer.write(step + 1, {
                    "eval_loss": float(np.mean([r["loss"] for r in results])),
                    "eval_token_accuracy": float(np.mean([r["token_accuracy"] for r in results])),
                    "eval_batches": len(results),
                    # Fused-attention kernel launches in this eval, by variant.
                    **{f"eval_attention_launches_{v}": n - before[v]
                       for v, n in fused_attention.launches_by_variant.items()},
                }))
            if step + 1 == config.num_steps or (step + 1) % config.checkpoint_every_steps == 0:
                ckpt.save(step + 1, state)
                saved = step + 1
            step += 1
    finally:
        for feed in (train_feed, eval_feed):
            if feed is not None:
                feed.close()
    log({"status": "done", "step": step, "updates": int(state.step),
         "guard_skips": int(state.guard_skips), "checkpoint_step": saved or ckpt.latest_step()})
    return state
