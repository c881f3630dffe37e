"""The training loop (counterpart of `rt1_tpu/train/train.py`).

`train_and_evaluate(config, workdir)` builds the policy the config
describes (`build_model`: the `efficientnet_b3`, `efficientnet_small` and
`tiny` tokenizers), initialises it from `config.seed` or restores the
newest checkpoint under `<workdir>/checkpoints`, then steps: a metrics
line every `log_every_steps` (to `<workdir>/metrics.jsonl` and the
caller's `log`), an eval every `eval_every_steps`, a checkpoint every
`checkpoint_every_steps` and at the last step.

Data: the port has no dataset loaders yet, so the loop trains on
synthetic batches, as the JAX loop does without a dataset. Batch `i` is
drawn on the device from a generator seeded with `(seed, i)`, so a
resumed run sees the batches an unbroken run would have (the JAX loop
restarts its one synthetic stream instead). Eval uses the fixed batches
`0 .. eval_batches - 1` of seed `seed + 1`.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict

import numpy as np
import torch

from rt1_tpu_torch import resolve_device
from rt1_tpu_torch.configs import Config
from rt1_tpu_torch.convert import init_weights
from rt1_tpu_torch.eval.restore import build_policy
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


def train_and_evaluate(config: Config, workdir: str, device=None,
                       log: Callable[[Dict], None] = _print_json) -> TrainState:
    """Train per `config` in `workdir`; returns the final TrainState.
    Runs on `cuda` unless `device` says otherwise (and raises without a
    card)."""
    dev = resolve_device(device)
    policy = build_model(config, dev)
    optimizer = optimizer_from_config(config)
    state = create_train_state(policy, optimizer)
    ckpt = CheckpointManager(os.path.join(workdir, "checkpoints"), max_to_keep=config.max_to_keep,
                             seed=config.seed)
    state, initial_step = ckpt.restore_or_initialize(state)
    fns = train_step_fns_from_config(config, optimizer)
    log({"status": "start", "device": str(dev), "restored_step": initial_step or None,
         "num_steps": config.num_steps, "compute_dtype": str(fns.compute_dtype).split(".")[-1],
         "parameters": sum(p.numel() for p in policy.parameters())})
    writer = MetricsWriter(workdir)
    meter = ThroughputMeter(config.per_host_batch_size, config.model.time_sequence_length,
                            initial_step=initial_step)
    eval_batches = [synthetic_batch(config, config.seed + 1, i, dev)
                    for i in range(config.eval_batches)] if config.eval_every_steps else []
    saved = None
    step = initial_step
    while step < config.num_steps:
        metrics = fns.train_step(state, synthetic_batch(config, config.seed, step, dev), step)
        if (step + 1) % config.log_every_steps == 0:
            scalars = scalars_from_metrics(metrics)
            scalars.update(meter.update(step + 1))
            log(writer.write(step + 1, scalars))
        if eval_batches and (step + 1) % config.eval_every_steps == 0:
            results = [scalars_from_metrics(fns.eval_step(state, b)) for b in eval_batches]
            log(writer.write(step + 1, {
                "eval_loss": float(np.mean([r["loss"] for r in results])),
                "eval_token_accuracy": float(np.mean([r["token_accuracy"] for r in results])),
            }))
        if step + 1 == config.num_steps or (step + 1) % config.checkpoint_every_steps == 0:
            ckpt.save(step + 1, state)
            saved = step + 1
        step += 1
    log({"status": "done", "step": step, "updates": int(state.step),
         "guard_skips": int(state.guard_skips), "checkpoint_step": saved or ckpt.latest_step()})
    return state
