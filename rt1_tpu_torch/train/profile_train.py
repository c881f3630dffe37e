"""Profile N real train steps (counterpart of `scripts/profile_train.py`).

Traces `--steps` steps of the config's own train step, built through the
port's trainer (`train.build_model`, `optimizer_from_config`,
`train_step_fns_from_config`), with `torch.profiler` (CPU activity, and
CUDA activity on the card) and writes, into `--logdir`:

* `profiler_trace.json` — the profiler's Chrome trace, each step marked
  `train#step_num=<i>#` by `trainer.metrics.step_trace` (as the train
  loop marks its steps);
* `host_trace.json` — the host timeline of the same steps
  (`obs/trace.py`): `device_step` a step and, with `--packed`, the
  `wait_batch` of each pull and the feeder workers' `feeder_assemble`
  spans and `feeder_queue_depth` counter.

`--model tiny` profiles `configs.tiny`, `flagship` the flagship
(`configs.language_table`), both at the window 6 of the bench geometry,
without the model-health pack (the step JAX's script profiles). Batches
are one resident synthetic batch, or with `--packed` the packed cache
(`data/pack.py`) read by the sample-ahead feeder (`data/feeder.py`) and
uploaded by `device_feeder`, over a corpus of `--episodes` synthetic
`--src_height` x `--src_width` episodes in `--data_dir` (written on first
use, as the JAX bench writes it).

Prints one JSON line: each step's wall ms, and from the profiler the card's
busy ms and launches a step, its idle share and the kernels of most device
time. On the card a trace without CUDA kernel events is an error (exit 1),
as is a profiler that fails. Runs on `cuda` unless `--device cpu` is given.

  python -m rt1_tpu_torch.train.profile_train --logdir /tmp/rt1_trace --steps 5
  python -m rt1_tpu_torch.train.profile_train --model tiny --packed --device cpu
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time

TRACE_NAME = "profiler_trace.json"
HOST_TRACE_NAME = "host_trace.json"
STEP_MARK = "train#step_num="


def parse_args(argv):
    tmp = tempfile.gettempdir()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--logdir", default=os.path.join(tmp, "rt1_trace"))
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--model", default="flagship", choices=["flagship", "tiny"],
                   help="'flagship' = configs.language_table, 'tiny' = configs.tiny.")
    p.add_argument("--height", type=int, default=0,
                   help="Image height (0 = the config's data.height).")
    p.add_argument("--width", type=int, default=0,
                   help="Image width (0 = the config's data.width).")
    p.add_argument("--packed", action="store_true",
                   help="Feed the steps from the packed cache through the sample-ahead "
                        "feeder instead of a resident synthetic batch.")
    p.add_argument("--data_dir", default=os.path.join(tmp, "rt1_bench_episodes"),
                   help="--packed: the synthetic corpus (written on first use).")
    p.add_argument("--episodes", type=int, default=24, help="--packed: corpus size.")
    p.add_argument("--src_height", type=int, default=180)
    p.add_argument("--src_width", type=int, default=320,
                   help="--packed: the corpus's source frame size.")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu.")
    return p.parse_args(argv)


BENCH_EPISODE_STEPS = 40


def bench_episodes(data_dir, n_episodes, height, width):
    """The JAX bench's synthetic corpus: `n_episodes` episodes of
    `height` x `width` frames from `default_rng(0)`, cached in `data_dir`
    (`<data_dir>_src<h>x<w>` for a source size other than 180x320)."""
    import numpy as np

    from rt1_tpu_torch.data.episodes import generate_synthetic_episode, save_episode

    if (height, width) != (180, 320):
        data_dir = data_dir.rstrip("/") + f"_src{height}x{width}"
    paths = sorted(glob.glob(os.path.join(data_dir, "episode_*.npz")))
    if len(paths) >= n_episodes:
        return paths[:n_episodes]
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(n_episodes):
        save_episode(os.path.join(data_dir, f"episode_{i}.npz"),
                     generate_synthetic_episode(rng, num_steps=BENCH_EPISODE_STEPS,
                                                height=height, width=width))
    return sorted(glob.glob(os.path.join(data_dir, "episode_*.npz")))


def packed_feed(args, height, width, window, dev):
    """Device batches from the pack of the bench corpus at `height` x
    `width`: the feeder (2 threads, 2 ahead) and `device_feeder` (2 in
    flight). Returns (the device feeder, the sample-ahead feeder)."""
    from rt1_tpu_torch.data import pack as pack_lib
    from rt1_tpu_torch.data.feeder import SampleAheadFeeder
    from rt1_tpu_torch.data.pipeline import device_feeder

    paths = bench_episodes(args.data_dir, args.episodes, args.src_height, args.src_width)
    pack_dir = os.path.dirname(paths[0]).rstrip("/") + f"_packed_{height}x{width}_n{len(paths)}"
    pack_lib.pack_episodes(paths, pack_dir, height, width, 0.95)
    cache = pack_lib.PackedEpisodeCache(pack_dir, window=window)
    feeder = SampleAheadFeeder(cache, args.batch, seed=0, num_threads=2, depth=2)
    return device_feeder(feeder, dev, depth=2), feeder


def step_marks(trace_path: str) -> list:
    """The host-side step marks of a Chrome trace written by this module,
    in order."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e for e in events if e.get("ph") == "X" and
                   str(e.get("name", "")).startswith(STEP_MARK) and
                   e.get("cat") == "user_annotation"), key=lambda e: e["ts"])


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from rt1_tpu_torch import resolve_device
    from rt1_tpu_torch.configs import get_config
    from rt1_tpu_torch.obs import profile as obs_profile
    from rt1_tpu_torch.obs import trace as obs_trace
    from rt1_tpu_torch.train.train import build_model, synthetic_batch
    from rt1_tpu_torch.trainer.metrics import step_trace
    from rt1_tpu_torch.trainer.state import create_train_state
    from rt1_tpu_torch.trainer.train import optimizer_from_config, train_step_fns_from_config

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    os.makedirs(args.logdir, exist_ok=True)
    # The host tracer first: with --packed the feeder threads start below,
    # and their spans belong in this trace.
    host_trace_path = os.path.join(args.logdir, HOST_TRACE_NAME)
    obs_trace.enable(host_trace_path)
    feeder = None
    try:
        config = get_config("tiny" if args.model == "tiny" else "language_table")
        config.model.time_sequence_length = 6  # the bench geometry's window
        config.per_host_batch_size = args.batch
        config.data.height = args.height or config.data.height
        config.data.width = args.width or config.data.width
        config.obs.model_health = False
        policy = build_model(config, dev)
        optimizer = optimizer_from_config(config)
        state = create_train_state(policy, optimizer)
        fns = train_step_fns_from_config(config, optimizer)
        if args.packed:
            batches, feeder = packed_feed(args, config.data.height, config.data.width,
                                          config.model.time_sequence_length, dev)

            def next_batch():
                with obs_trace.span("wait_batch"):
                    return next(batches)
        else:
            resident = synthetic_batch(config, config.seed, 0, dev)

            def next_batch():
                return resident

        def sync(metrics):
            float(metrics["loss"])  # waits for the step

        step = 0
        for _ in range(args.warmup):
            sync(fns.train_step(state, next_batch(), step))
            step += 1
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        walls = []
        with profile(activities=activities) as prof:
            t_all = time.perf_counter()
            for i in range(args.steps):
                with step_trace("train", i):
                    t0 = time.perf_counter()
                    batch = next_batch()
                    with obs_trace.span("device_step", step=i):
                        sync(fns.train_step(state, batch, step))
                    walls.append((time.perf_counter() - t0) * 1e3)
                step += 1
            wall_s = time.perf_counter() - t_all
    finally:
        if feeder is not None:
            feeder.close()
        obs_trace.disable()  # writes host_trace.json
    trace_path = os.path.join(args.logdir, TRACE_NAME)
    prof.export_chrome_trace(trace_path)
    marks = len(step_marks(trace_path))
    summary = obs_profile.device_summary(prof, args.steps, wall_s)
    record = {"model": args.model, "device": str(dev), "batch": args.batch,
              "window": config.model.time_sequence_length,
              "image": [config.data.height, config.data.width], "packed": args.packed,
              "compute_dtype": str(fns.compute_dtype).split(".")[-1],
              "steps": args.steps, "warmup": args.warmup, "step_wall_ms": walls,
              "step_marks": marks, "trace": trace_path, "host_trace": host_trace_path}
    if on_card:
        record["device_name"] = torch.cuda.get_device_name(0)
    if summary is not None:
        record.update({"device_busy_ms_per_step": summary["busy_ms"],
                       "launches_per_step": summary["launches"],
                       "idle_share": 1.0 - summary["busy_ms"] / summary["wall_ms"],
                       "top_kernels_ms": obs_profile.top_kernels(summary["kernels"])})
    print(json.dumps(record), flush=True)
    if marks != args.steps:
        print(f"profile_train: {marks} step marks in the trace, expected {args.steps}",
              file=sys.stderr)
        return 1
    if on_card and summary is None:
        print("profile_train: the trace holds no CUDA kernel events", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
