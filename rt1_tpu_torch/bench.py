"""The port's benchmark CLI (counterpart of the JAX package's `bench.py`).

    python -m rt1_tpu_torch.bench [--mode train|infer|e2e|mfu|env|multihost] [--device cpu]

Prints ONE headline JSON line on stdout, ``{"metric", "value", "unit",
"vs_baseline", "device"}``, with JAX's metric name and unit for the same
flags, then JAX's ``*_detail`` lines on stderr. `device` is the card's name,
count and `nvidia-smi --query-gpu=name,power.limit` line, or "cpu". Runs on
the card unless `--device cpu` is given; without a card it raises (no
headline). Every flag of JAX's `bench.py` is here with its default and
choices; `--attention_impl pallas` selects the port's fused attention
kernel (`parallel/flash_attention.py`), `dense` the dense path.

Modes (geometry of JAX's bench: batch 8, window 6, 256x456):

* **train** — resident-batch train steps through `trainer/train.py`'s
  `TrainStepFns` on `configs.language_table` (FiLM-EfficientNet-B3, 8
  layers; bf16 on float32 masters) or `configs.tiny` (`--model tiny`);
  the best of `--windows` windows of `--steps` steps.
* **infer** — `RT1Policy.infer_step` at batch 1 with a rolling state, p50
  over `--steps`; `infer_detail` carries the fused kernel's launches by
  variant over the timed steps (the counts themselves run on, the warm-up
  included) (8 a step in the flagship under `pallas`:
  `tensor_core` in bf16, `tf32x3` in float32). `--inference_dtype` A/Bs the
  serving dtypes through `models/quant.py`, `--window_sweep` the windowed
  step against `infer_step_cached`, both in interleaved windows as JAX.
* **e2e** — steps fed from a synthetic episode corpus under `--data_dir`
  (`data/episodes.py`) by the windowed torch loader and `device_feeder`
  (`data/pipeline.py`), or with `--packed` by the packed cache and the
  sample-ahead feeder (`data/pack.py`, `data/feeder.py`); the stall share
  against the resident floor. `--guard`, `--health` and
  `--mixed_precision` A/B the guarded step, the health pack and the bf16
  compute copy of float32 masters in interleaved windows.
* **mfu** — FLOPs of one step by `obs/flops.py` (FlopCounterMode, the
  grouped-convolution backward counted per group) over its time and the
  H100's dense bf16 989 TFLOP/s (`RT1_TPU_PEAK_FLOPS` overrides).
* **env** — the port's Language-Table simulator on the host, `--steps` x
  20 control steps.
* **multihost** — `rt1_tpu_torch/bench_multihost.py`: 1 vs 2 "hosts" of
  gloo ranks sharing the card (on the host's CPU under `--device cpu`).

`--trace_dir` writes the first measured window's `torch.profiler` Chrome
trace (`profiler_trace.json`), where JAX writes an XPlane; `--trace` the
host span trace of `obs/trace.py`.

Left out by design: the TPU chip claim and its claim probe (TPU-only); the
no-chip sentinel line (the port raises instead of printing a value); the
read of `BASELINE.json` (its figures are a TPU's): `vs_baseline` is 1.0,
JAX's value when no baseline exists (0.0 for multihost, as in JAX). The
window sweep's record goes to a new directory under the temp directory,
printed on stderr, never beside the sources.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

N_CHIPS = 1  # one process drives one device
WINDOW = 6   # JAX's bench window
TRACE_NAME = "profiler_trace.json"
KVCACHE_RECORD = "BENCH_serve_kvcache.json"
HEALTH_BUDGET_PCT = 2.0


def build_parser() -> argparse.ArgumentParser:
    """JAX's `bench.py` flags, defaults and choices, and `--device`."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--windows", type=int, default=5,
                   help="Timed windows; the train and e2e headlines take the best one.")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=456)
    p.add_argument("--mode", default="train",
                   choices=["train", "infer", "e2e", "mfu", "env", "multihost"])
    p.add_argument("--data_dir", default=os.path.join(tempfile.gettempdir(), "rt1_bench_episodes"),
                   help="e2e mode: episode cache dir (synthesized on first run).")
    p.add_argument("--episodes", type=int, default=24, help="e2e mode: corpus size.")
    p.add_argument("--src_height", type=int, default=180)
    p.add_argument("--src_width", type=int, default=320,
                   help="e2e mode: the synthetic corpus's source frame size (other sizes get "
                        "their own corpus dir).")
    p.add_argument("--packed", action="store_true",
                   help="e2e mode: feed from the packed cache through the sample-ahead feeder. "
                        "Metric gains a '_packed' suffix.")
    p.add_argument("--model", default="flagship", choices=["flagship", "tiny"],
                   help="'flagship' = configs.language_table, 'tiny' = configs.tiny; metrics "
                        "gain a '_tiny' suffix.")
    p.add_argument("--attention_impl", default="dense", choices=["dense", "pallas"],
                   help="infer mode: 'pallas' = the port's fused attention kernel.")
    p.add_argument("--inference_dtype", default="",
                   help="infer mode: comma serving dtypes to A/B (e.g. 'f32,bf16,int8') "
                        "through models/quant.py, in interleaved windows.")
    p.add_argument("--window_sweep", default="",
                   help="infer mode: comma window lengths (e.g. '3,6,15') to A/B the windowed "
                        "infer_step against infer_step_cached, in interleaved windows.")
    p.add_argument("--guard", action="store_true",
                   help="e2e mode: A/B the guarded train step (guard_overhead_pct).")
    p.add_argument("--health", action="store_true",
                   help="e2e mode: A/B the model-health pack (health_overhead_pct on "
                        "per-step-synced resident floors; budget 2%%).")
    p.add_argument("--mixed_precision", action="store_true",
                   help="mfu/e2e modes: A/B the bf16 compute copy of float32 masters against "
                        "the step as configured.")
    p.add_argument("--trace_dir", default="",
                   help="Write the first measured window's torch.profiler Chrome trace into "
                        "this directory (train/mfu/e2e/infer).")
    p.add_argument("--trace", default="",
                   help="Write the host span trace (obs/trace.py) to this path.")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; raises without a card) or cpu.")
    return p


def nvidia_smi() -> str:
    """`nvidia-smi --query-gpu=name,power.limit`'s first line."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_field(dev):
    """The headline's `device`: the card's name, count and nvidia-smi line,
    or "cpu"."""
    import torch

    if dev.type != "cuda":
        return "cpu"
    return {"name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
            "nvidia_smi": nvidia_smi()}


def headline(metric, value, unit, device, vs_baseline=1.0, **extra):
    print(json.dumps({"metric": metric, "value": value, "unit": unit,
                      "vs_baseline": vs_baseline, "device": device, **extra}), flush=True)


def detail(record):
    print(json.dumps(record), file=sys.stderr, flush=True)


def _wait(metrics):
    float(metrics["loss"])  # waits for the step


@contextlib.contextmanager
def _maybe_trace(trace_dir, dev):
    """torch.profiler over the block when `trace_dir` is set; the Chrome
    trace is written after the block, so its cost stays out of the timing
    read inside it."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=activities) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_NAME))


def bench_config(args):
    """The bench geometry on the config of `--model`: batch `--batch`,
    window 6, `--height` x `--width`, seed 0, Adam over 975 steps an epoch
    (JAX's bench optimizer), no health pack."""
    from rt1_tpu_torch.configs import get_config

    config = get_config("tiny" if args.model == "tiny" else "language_table")
    config.model.time_sequence_length = WINDOW
    config.model.attention_impl = "fused" if args.attention_impl == "pallas" else "dense"
    config.model.dtype = args.dtype
    config.per_host_batch_size = args.batch
    config.data.height, config.data.width = args.height, args.width
    config.seed = 0
    config.obs.model_health = False
    return config


class _Runner:
    """The train modes' state: one policy, its float32 masters and Adam
    state, shared by every step program an A/B times."""

    def __init__(self, args, dev):
        from rt1_tpu_torch.train.train import build_model, synthetic_batch
        from rt1_tpu_torch.trainer.optim import Adam
        from rt1_tpu_torch.trainer.state import create_train_state
        from rt1_tpu_torch.trainer.train import train_step_fns_from_config

        self.args, self.dev = args, dev
        self.config = bench_config(args)
        self.optimizer = Adam(steps_per_epoch=975)
        self.state = create_train_state(build_model(self.config, dev), self.optimizer)
        self.fns = train_step_fns_from_config(self.config, self.optimizer)
        self.batch = synthetic_batch(self.config, 0, 0, dev)
        self.step = 0

    def run(self, fns, batch):
        metrics = fns.train_step(self.state, batch, self.step)
        self.step += 1
        return metrics

    def timed_resident_loop(self, steps, warmup, resident=None, trace=False, fns=None):
        """Seconds of `steps` steps on one resident batch after `warmup`."""
        from rt1_tpu_torch.obs import trace as obs_trace

        fns = self.fns if fns is None else fns
        resident = self.batch if resident is None else resident
        for _ in range(warmup):
            _wait(self.run(fns, resident))
        with _maybe_trace(self.args.trace_dir if trace else "", self.dev):
            t0 = time.perf_counter()
            for i in range(steps):
                with obs_trace.span("bench_step", step=i):
                    metrics = self.run(fns, resident)
            _wait(metrics)
            dt = time.perf_counter() - t0
        return dt


def train_bench(args, dev, variant):
    """Best-of-`--windows` resident-batch steps/s."""
    runner = _Runner(args, dev)
    best_dt = min(runner.timed_resident_loop(args.steps, args.warmup if w == 0 else 0,
                                             trace=(w == 0))
                  for w in range(max(1, args.windows)))
    value = args.steps / best_dt / N_CHIPS
    headline(f"train_steps_per_sec_per_chip{variant}", round(value, 4), "steps/s/chip",
             device_field(dev))


def _flops(fns, runner):
    """FLOPs of one step of `fns` (obs/flops.py), the step itself counted."""
    from rt1_tpu_torch.obs import flops as flops_lib

    return flops_lib.train_step_flops(lambda: _wait(runner.run(fns, runner.batch)))


def mfu_bench(args, dev, variant):
    """MFU of the resident-batch step: its counted FLOPs over its best
    window's time and the peak; with --mixed_precision the bf16-compute
    step in interleaved windows beside it, each on its own FLOPs."""
    import torch

    from rt1_tpu_torch.obs import flops as flops_lib

    runner = _Runner(args, dev)
    mp = dataclasses.replace(runner.fns, mixed_precision=True, compute_dtype=torch.bfloat16) \
        if args.mixed_precision else None
    flops = _flops(runner.fns, runner)
    if flops is None:
        print("bench: FlopCounterMode counted no FLOPs for the train step — refusing to "
              "publish a zero MFU measurement", file=sys.stderr)
        sys.exit(1)
    flops_mp = _flops(mp, runner) if mp is not None else None
    dt = dt_mp = None
    for w in range(max(1, args.windows)):
        sides = [("base", runner.fns)] + ([("mp", mp)] if mp is not None else [])
        for name, fns in (sides[::-1] if w % 2 else sides):
            dt_w = runner.timed_resident_loop(args.steps, args.warmup if w == 0 else 0,
                                              trace=(w == 0 and name == "base"), fns=fns)
            if name == "base":
                dt = dt_w if dt is None else min(dt, dt_w)
            else:
                dt_mp = dt_w if dt_mp is None else min(dt_mp, dt_w)
    per_step = dt / args.steps
    mfu = flops_lib.mfu_pct(flops, per_step, N_CHIPS)
    record = {"mode": "mfu_detail", **flops_lib.mfu_detail(flops, per_step, N_CHIPS)}
    if dt_mp is not None:
        mp_per_step = dt_mp / args.steps
        record["mp_step_ms"] = round(mp_per_step * 1e3, 3)
        record["mp_speedup_pct"] = round((dt / dt_mp - 1.0) * 100.0, 2)
        record["windows"] = max(1, args.windows)
        if flops_mp is not None:
            record["mfu_mixed_precision"] = round(
                flops_lib.mfu_pct(flops_mp, mp_per_step, N_CHIPS), 3)
            record["mp_flops_per_step"] = flops_mp
        else:
            print("bench: FlopCounterMode counted no FLOPs for the mixed-precision step — "
                  "mp_step_ms/mp_speedup_pct are valid, mfu_mixed_precision omitted",
                  file=sys.stderr)
    detail(record)
    headline(f"train_step_mfu{variant}", round(mfu, 3), "%", device_field(dev))


def e2e_feed(args, dev, config):
    """The e2e device batches (a `DeviceFeeder`, two batches ahead, whose
    `close()` stops its source): the windowed torch loader over the bench
    corpus, or with --packed the packed cache through the sample-ahead
    feeder."""
    from rt1_tpu_torch.data.pipeline import WindowedEpisodeDataset, device_feeder, loader_batches
    from rt1_tpu_torch.train.profile_train import bench_episodes, packed_feed

    h, w = config.data.height, config.data.width
    if args.packed:
        t0 = time.perf_counter()  # the corpus, its pack and the feeder's start
        feed, _ = packed_feed(args, h, w, WINDOW, dev)
        detail({"mode": "pack_detail", "pack_seconds": round(time.perf_counter() - t0, 3)})
        return feed
    paths = bench_episodes(args.data_dir, args.episodes, args.src_height, args.src_width)
    ds = WindowedEpisodeDataset(paths, window=WINDOW, crop_factor=0.95, height=h, width=w)
    loader = ds.as_torch_loader(batch_size=args.batch, seed=0, pin_memory=dev.type == "cuda")
    return device_feeder(loader_batches(loader), dev, depth=2)


def e2e_bench(args, dev, variant):
    """Pipeline-fed steps/s (best of `--windows`), the stall share against
    the same uint8 batch resident, the feed's own rate, and the A/Bs."""
    import torch

    from rt1_tpu_torch.obs import trace as obs_trace

    runner = _Runner(args, dev)
    alternates = {}
    if args.guard:
        alternates["guard"] = dataclasses.replace(runner.fns, guard_nonfinite=True)
    if args.health:
        alternates["health"] = dataclasses.replace(runner.fns, model_health=True)
    if args.mixed_precision:
        alternates["mp"] = dataclasses.replace(runner.fns, mixed_precision=True,
                                               compute_dtype=torch.bfloat16)
    feed = e2e_feed(args, dev, runner.config)
    try:
        for _ in range(args.warmup):
            _wait(runner.run(runner.fns, next(feed)))
        # One pipeline batch kept on the card: the stall baseline times the
        # same uint8 program as the fed loop.
        resident = next(feed)
        for fns in alternates.values():
            for _ in range(args.warmup):
                _wait(runner.run(fns, next(feed)))

        def timed_window(fns):
            t0 = time.perf_counter()
            for i in range(args.steps):
                with obs_trace.span("wait_batch"):
                    batch = next(feed)
                with obs_trace.span("device_dispatch", step=i):
                    metrics = runner.run(fns, batch)
            _wait(metrics)
            return time.perf_counter() - t0

        # Rounds alternate the programs' order: a window drains the
        # feeder's queue, so the second program of a round starts starved.
        windows = {"headline": [], **{name: [] for name in alternates}}
        programs = [("headline", runner.fns)] + list(alternates.items())
        for w in range(max(1, args.windows)):
            for name, fns in (programs if w % 2 == 0 else programs[::-1]):
                with _maybe_trace(args.trace_dir if (w == 0 and name == "headline") else "", dev):
                    windows[name].append(timed_window(fns))
        best_dt = min(windows["headline"])

        def overhead_pct(name):
            return max(0.0, (min(windows[name]) / best_dt - 1.0) * 100.0)

        dt_compute = min(runner.timed_resident_loop(args.steps, 1 if w == 0 else 0, resident)
                         for w in range(max(1, args.windows)))
        health_overhead = None
        if "health" in alternates:
            # Per-step synced floors, alternating sides (JAX's estimator):
            # the pack's program delta, not the host's core budget.
            _wait(runner.run(alternates["health"], resident))
            floors = {"base": [], "health": []}
            for r in range(8):
                pair = [("base", runner.fns), ("health", alternates["health"])]
                for name, fns in (pair[::-1] if r % 2 else pair):
                    for _ in range(max(args.steps, 25)):
                        t0 = time.perf_counter()
                        _wait(runner.run(fns, resident))
                        floors[name].append(time.perf_counter() - t0)
            health_overhead = max(0.0, (min(floors["health"]) / min(floors["base"]) - 1.0) * 100)
        # The feed alone: batches with no step in the loop.
        n_drain = args.steps * 2
        t0 = time.perf_counter()
        for _ in range(n_drain):
            next(feed)
        dt_drain = time.perf_counter() - t0
    finally:
        feed.close()
    e2e = args.steps / best_dt / N_CHIPS
    record = {
        "mode": "e2e_detail",
        "compute_only_steps_per_sec_per_chip": round(args.steps / dt_compute / N_CHIPS, 4),
        "e2e_steps_per_sec_per_chip": round(e2e, 4),
        "input_stall_pct": round(max(0.0, 1.0 - dt_compute / best_dt) * 100, 2),
        "input_only_batches_per_sec": round(n_drain / dt_drain, 4),
        "packed": bool(args.packed),
        "model": args.model,
        "windows": max(1, args.windows),
    }
    if "guard" in alternates:
        record["e2e_guarded_steps_per_sec_per_chip"] = round(
            args.steps / min(windows["guard"]) / N_CHIPS, 4)
        record["guard_overhead_pct"] = round(overhead_pct("guard"), 2)
    if "mp" in alternates:
        record["e2e_mp_steps_per_sec_per_chip"] = round(
            args.steps / min(windows["mp"]) / N_CHIPS, 4)
        record["mp_speedup_pct"] = round((best_dt / min(windows["mp"]) - 1.0) * 100.0, 2)
    if "health" in alternates:
        record["e2e_health_steps_per_sec_per_chip"] = round(
            args.steps / min(windows["health"]) / N_CHIPS, 4)
        record["e2e_health_overhead_pct"] = round(overhead_pct("health"), 2)
        overhead = round(health_overhead, 2)
        record["health_overhead_pct"] = overhead
        record["health_budget_pct"] = HEALTH_BUDGET_PCT
        if overhead > HEALTH_BUDGET_PCT:
            record["health_over_budget"] = True
            print(f"bench: health-pack overhead {overhead}% exceeds the "
                  f"{HEALTH_BUDGET_PCT}% budget", file=sys.stderr)
    detail(record)
    headline(f"train_steps_per_sec_per_chip_e2e{variant}", round(e2e, 4), "steps/s/chip",
             device_field(dev))


def env_bench(args, dev):
    """Host simulator control steps/s: random actions, auto-reset, the
    observation render included; `--steps` x 20 timed steps after 20."""
    import numpy as np

    from rt1_tpu_torch.envs import LanguageTable, blocks
    from rt1_tpu_torch.envs.rewards import BlockToBlockReward

    env = LanguageTable(block_mode=blocks.BlockMode.BLOCK_4,
                        reward_factory=BlockToBlockReward, seed=0)
    rng = np.random.default_rng(0)
    env.reset()
    warmup = 20
    for _ in range(warmup):
        _, _, done, _ = env.step(rng.uniform(-0.03, 0.03, 2))
        if done:
            env.reset()
    n_steps = args.steps * 20
    t0 = time.perf_counter()
    for _ in range(n_steps):
        _, _, done, _ = env.step(rng.uniform(-0.03, 0.03, 2))
        if done:
            env.reset()
    dt = time.perf_counter() - t0
    detail({"mode": "env_detail", "control_steps": n_steps, "warmup_steps": warmup,
            "seconds": dt, "ran_on": "host"})
    headline("env_control_steps_per_sec", round(n_steps / dt, 2), "steps/s", device_field(dev),
             ran_on="host")


# ------------------------------------------------------------------ infer


def _master(config):
    """The policy of `config` in float32 on the CPU at the serving random
    init (`eval/restore.py`), every inference side's weights."""
    from rt1_tpu_torch.eval.restore import master_policy

    policy, _ = master_policy(config, None, None)
    return policy


def _on(master, dev, dtype):
    """A copy of `master` on `dev` in `dtype`, in eval mode."""
    policy = copy.deepcopy(master).to(device=dev, dtype=dtype)
    return policy.eval().requires_grad_(False)


def _frame(config, dev):
    """Frame 0 of row 0 of the bench's synthetic batch."""
    from rt1_tpu_torch.train.train import synthetic_batch

    obs, _ = synthetic_batch(config, 0, 0, dev)
    return {k: v[:1, 0] for k, v in obs.items()}


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed_infer(step, state, frame, dev):
    """(ms of one step ending in a synchronisation, its output, the new state)."""
    t0 = time.perf_counter()
    out, state = step(frame, state)
    _sync(dev)
    return (time.perf_counter() - t0) * 1e3, out, state


def infer_bench(args, dev):
    """Control-step latency p50 of `infer_step` at batch 1 with a rolling
    state, then the --inference_dtype and --window_sweep A/Bs."""
    import torch

    from rt1_tpu_torch.eval.restore import DTYPES
    from rt1_tpu_torch.parallel.flash_attention import fused_attention

    config = bench_config(args)
    master = _master(config)
    policy = _on(master, dev, DTYPES[args.dtype])
    frame = _frame(config, dev)
    state = policy.initial_state(1)
    times = []
    with torch.no_grad():
        for _ in range(max(args.warmup, 1)):
            _, _, state = _timed_infer(policy.infer_step, state, frame, dev)
        before = dict(fused_attention.launches_by_variant)  # the timed steps' launches only
        with _maybe_trace(args.trace_dir, dev):
            for _ in range(args.steps):
                ms, _, state = _timed_infer(policy.infer_step, state, frame, dev)
                times.append(ms)
    launches = {k: n - before[k] for k, n in fused_attention.launches_by_variant.items()}
    detail({"mode": "infer_detail", "steps": args.steps, "dtype": args.dtype,
            "attention_impl": args.attention_impl, "decoder_layers": policy.num_layers,
            "launches_by_variant": launches})
    metric = f"infer_step_latency_p50_{args.attention_impl}"
    headline(metric, round(statistics.median(times), 3), "ms", device_field(dev))
    if args.inference_dtype:
        infer_quant_ab(args, dev, config, master, frame)
    if args.window_sweep:
        infer_kvcache_sweep(args, dev, config, master, frame)


def _interleaved(sides, step_of, rounds, window, frame, dev):
    """Per side, the median ms of each of `rounds` windows of `window`
    steps, rounds alternating the sides' order; `step_of(side)` is
    (step fn, state key)."""
    import torch

    order = list(sides)
    with torch.no_grad():
        for r in range(rounds):
            for name in (order if r % 2 == 0 else order[::-1]):
                side = sides[name]
                step = step_of(side)
                times = []
                for _ in range(window):
                    ms, out, side["state"] = _timed_infer(step, side["state"], frame, dev)
                    times.append(ms)
                    side.setdefault("tokens", []).append(out["action_tokens"].cpu())
                side["window_medians"].append(statistics.median(times))


def infer_quant_ab(args, dev, config, master, frame):
    """Per serving dtype: control-step latency floor over interleaved
    windows, and the serving tree's bytes (`quant.tree_bytes`)."""
    import torch

    from rt1_tpu_torch.eval.restore import serving_policy
    from rt1_tpu_torch.models import quant

    dtypes = [d.strip() for d in args.inference_dtype.split(",") if d.strip()]
    sides = {}
    for dtype in dtypes:
        # bf16 computes in bfloat16, f32 and int8 in float32: each side's
        # own compute dtype, as in JAX's A/B.
        compute = torch.bfloat16 if dtype == "bf16" else torch.float32
        policy, serving, _, _ = serving_policy(copy.deepcopy(master), compute, dev, dtype)
        sides[dtype] = {"policy": policy, "state": policy.initial_state(1),
                        "param_bytes": quant.tree_bytes(serving), "window_medians": []}
    with torch.no_grad():
        for side in sides.values():  # warm-up: a step each
            _, _, side["state"] = _timed_infer(side["policy"].infer_step, side["state"],
                                               frame, dev)
    rounds, window = 4, max(args.steps // 4, 8)
    _interleaved(sides, lambda side: side["policy"].infer_step, rounds, window, frame, dev)
    f32_bytes = sides["f32"]["param_bytes"] if "f32" in sides else quant.tree_bytes(
        master.state_dict())
    per_dtype = {
        dtype: {"latency_p50_ms_floor": round(min(side["window_medians"]), 3),
                "window_medians_ms": [round(m, 3) for m in side["window_medians"]],
                "param_bytes": side["param_bytes"],
                "byte_reduction_vs_f32": round(f32_bytes / side["param_bytes"], 3)}
        for dtype, side in sides.items()}
    detail({"metric": "infer_quant_ab", "dtypes": dtypes, "per_dtype": per_dtype,
            "rounds": rounds, "window_steps": window,
            "timing_methodology": "interleaved windows, alternating dtype order per round, "
                                  "best-of (floor) window median per side"})


def infer_kvcache_sweep(args, dev, config, master, frame):
    """At each --window_sweep length T: the windowed `infer_step` against
    `infer_step_cached` in interleaved windows (the cached side warmed past
    roll-over), and the two sides' action-token agreement step for step
    while the window fills and after it rolls (every step of each side,
    warm-up included: both step one frame from a zeroed state). Writes the
    record to a new directory under the temp directory."""
    import torch

    from rt1_tpu_torch.eval.restore import DTYPES, build_policy

    windows = sorted({int(w) for w in args.window_sweep.split(",") if w.strip()})
    rounds, window_steps = 4, max(args.steps // 4, 8)
    per_window = {}
    for seq_len in windows:
        swept = copy.deepcopy(config)
        swept.model.time_sequence_length = seq_len
        policy = build_policy(swept)
        policy.load_state_dict(master.state_dict())  # the parameters are window-independent
        policy = policy.to(device=dev, dtype=DTYPES[args.dtype]).eval().requires_grad_(False)
        sides = {"windowed": {"step": policy.infer_step, "state": policy.initial_state(1),
                              "window_medians": []},
                 "cached": {"step": policy.infer_step_cached,
                            "state": policy.initial_state(1, cached=True),
                            "window_medians": []}}
        with torch.no_grad():
            for side in sides.values():  # compile-free warm-up past roll-over
                for _ in range(seq_len + 2):
                    _, out, side["state"] = _timed_infer(side["step"], side["state"], frame, dev)
                    side.setdefault("tokens", []).append(out["action_tokens"].cpu())
        _interleaved(sides, lambda side: side["step"], rounds, window_steps, frame, dev)
        windowed = torch.stack(sides["windowed"]["tokens"])
        cached = torch.stack(sides["cached"]["tokens"])
        row = {name: {"latency_p50_ms_floor": round(min(side["window_medians"]), 3),
                      "window_medians_ms": [round(x, 3) for x in side["window_medians"]]}
               for name, side in sides.items()}
        row["speedup_windowed_over_cached"] = round(
            row["windowed"]["latency_p50_ms_floor"] / row["cached"]["latency_p50_ms_floor"], 3)
        # While the window fills the cached decode is exact (JAX's cached
        # gate); after it rolls the two are reported apart.
        row["token_agreement_fill"] = float(
            (windowed[:seq_len] == cached[:seq_len]).float().mean())
        row["token_agreement_steady"] = float(
            (windowed[seq_len:] == cached[seq_len:]).float().mean())
        row["steps_compared"] = int(windowed.shape[0])
        per_window[str(seq_len)] = row
    lo, hi = str(windows[0]), str(windows[-1])

    def growth(side):
        return round(per_window[hi][side]["latency_p50_ms_floor"]
                     / per_window[lo][side]["latency_p50_ms_floor"], 3)

    record = {
        "metric": "serve_kvcache_cached_latency_growth", "value": growth("cached"), "unit": "x",
        "windows": windows, "per_window": per_window,
        "cached_latency_growth": growth("cached"), "windowed_latency_growth": growth("windowed"),
        "model": args.model, "attention_impl": args.attention_impl, "dtype": args.dtype,
        "image_hw": [args.height, args.width], "rounds": rounds, "window_steps": window_steps,
        "device": device_field(dev),
        "timing_methodology": "interleaved windows, alternating side order per round, best-of "
                              "(floor) window median per side; cached side warmed past window "
                              "roll-over",
    }
    detail(record)
    out_path = os.path.join(tempfile.mkdtemp(prefix="rt1_bench_"), KVCACHE_RECORD)
    with open(out_path, "w") as f:
        json.dump(record, f, indent=2)
        f.write("\n")
    print(f"bench: wrote {out_path}", file=sys.stderr)


# ------------------------------------------------------------------- main


def main(argv=None) -> int:
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)

    from rt1_tpu_torch import resolve_device
    from rt1_tpu_torch.obs import trace as obs_trace

    dev = resolve_device(args.device)  # no card and no --device cpu: raises
    if args.mode == "env":
        if args.trace_dir:
            print("bench: --trace_dir is ignored in --mode env (host-only loop)",
                  file=sys.stderr)
        env_bench(args, dev)
        return 0
    if args.mode == "multihost":
        # Gloo ranks on `--device`; all its other knobs live on its own CLI.
        from rt1_tpu_torch.bench_multihost import main as multihost_main

        record = multihost_main(["--steps", str(args.steps), "--device", args.device])
        headline("multihost_examples_per_sec_ratio_2p_over_1p",
                 record["scaling"]["examples_per_sec_ratio_2p_over_1p"], "x",
                 device_field(dev), vs_baseline=0.0)
        return 0
    for flag, modes in (("guard", ("e2e",)), ("health", ("e2e",)),
                        ("mixed_precision", ("mfu", "e2e"))):
        if getattr(args, flag) and args.mode not in modes:
            print(f"bench: --{flag} only applies to --mode {'/'.join(modes)}; ignored",
                  file=sys.stderr)
    variant = ("_tiny" if args.model == "tiny" else "") + (
        "_packed" if args.packed and args.mode == "e2e" else "")
    if args.trace:
        # Before any feeder thread exists, so their spans land in this trace.
        obs_trace.enable(args.trace)
    try:
        if args.mode == "infer":
            infer_bench(args, dev)
        else:
            {"train": train_bench, "mfu": mfu_bench, "e2e": e2e_bench}[args.mode](
                args, dev, variant)
    finally:
        if args.trace:
            obs_trace.disable()  # writes the trace
    if args.trace:
        detail({"mode": "host_trace", "path": args.trace})
    return 0


if __name__ == "__main__":
    sys.exit(main())
