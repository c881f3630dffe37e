"""Multi-host scale-out bench: 1 "host" vs 2 "hosts" of gloo ranks.

The port's counterpart of the JAX package's `scripts/bench_multihost.py`.
JAX spawns `jax.distributed` processes of `--devices_per_proc` forced CPU
devices each; here each JAX device becomes one gloo rank, a process of its
own (one host thread each), as in the port's parallel layout. A group of
`nproc` hosts is `nproc x --devices_per_proc` ranks, joined by
`parallel/distributed.py`'s rendezvous (RT1_COORDINATOR / RT1_PROCESS_ID /
RT1_NUM_PROCESSES). The ranks train the tiny RT-1 of JAX's script on a
packed corpus (`data/pack.py`) that the sample-ahead feeder slices per rank
in global order, over `parallel.auto`'s grid (2 ranks: dp 2; 4 ranks on 2
hosts: dp 2 across hosts x fsdp 2 within each), and record

* steps/s (after the warm-up, one timed window),
* MFU (FLOPs of the step by `obs/flops.py`, summed over the ranks, over the
  step time and the peak of the devices the ranks run on),
* each host's data-stall share (time blocked on the feeder in the timed
  window, the mean of its ranks'),

for the 1-host group and the 2-host group (weak scaling: the per-host batch
is fixed, the global batch doubles with the hosts).

Placement (`--device`): every rank computes on cuda:0 by default, or on the
host's CPU with `--device cpu`. NCCL takes one device a rank, so the ranks
share the card over gloo, whose all-reduce, all-gather and reduce-scatter
take CUDA tensors by staging them through the host; the per-rank FLOPs sum
is reduced on the host either way.

    python -m rt1_tpu_torch.bench_multihost --out /tmp/multihost.json
    python -m rt1_tpu_torch.bench_multihost --device cpu

The record goes to `--out`, else to `<workdir>/multihost_scaling.json`;
without `--workdir` the groups run in a new directory under the temp
directory. The path is printed on stderr. Nothing is written beside the
sources.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

SEED = 7
WINDOW = 2
H, W = 16, 24
RECORD_NAME = "multihost_scaling.json"


def build_parser() -> argparse.ArgumentParser:
    """JAX's flags and defaults, but for `--workdir` and `--out`, whose
    defaults (None) keep the record out of the sources' directory, and
    `--device`."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--local_batch", type=int, default=4,
                   help="Rows a host per step, split over its ranks.")
    p.add_argument("--devices_per_proc", type=int, default=2,
                   help="Ranks a host (JAX's forced CPU devices a process).")
    p.add_argument("--episodes", type=int, default=8)
    p.add_argument("--timeout_s", type=int, default=600)
    p.add_argument("--workdir", default=None,
                   help="Where the groups run (default: a new directory under the temp dir).")
    p.add_argument("--out", default=None,
                   help=f"The record's path (default: <workdir>/{RECORD_NAME}).")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="Where every rank computes: cuda:0 (default; raises without a card) "
                        "or the host's CPU.")
    # Worker plumbing (spawned by the parent, not for humans): one rank.
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--process_id", type=int, default=0, help=argparse.SUPPRESS)  # the rank
    p.add_argument("--nproc", type=int, default=1, help=argparse.SUPPRESS)       # hosts
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    return p


# --------------------------------------------------------------- worker


def _build_corpus(data_dir: str, episodes: int) -> str:
    import numpy as np

    from rt1_tpu_torch.data import episodes as ep_lib
    from rt1_tpu_torch.data import pack as pack_lib

    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    paths = []
    for i in range(episodes):
        path = os.path.join(data_dir, f"episode_{i}.npz")
        ep_lib.save_episode(path, ep_lib.generate_synthetic_episode(rng, num_steps=12,
                                                                    height=H, width=W))
        paths.append(path)
    pack_dir = os.path.join(data_dir, "packed")
    pack_lib.pack_episodes(paths, pack_dir, H, W, None)
    return pack_dir


def tiny_model():
    """JAX's script's tiny RT-1 (2 layers of 2 heads x 8, window 2)."""
    from rt1_tpu_torch.models.rt1 import RT1Policy
    from rt1_tpu_torch.models.tiny_tokenizer import TinyImageTokenizer
    from rt1_tpu_torch.specs import language_table_action_space

    return RT1Policy(
        action_space=language_table_action_space(),
        vocab_size=32,
        token_embedding_size=16,
        num_layers=2,
        layer_size=8,
        num_heads=2,
        feed_forward_size=16,
        dropout_rate=0.0,
        time_sequence_length=WINDOW,
        num_image_tokens=2,
        image_tokenizer=TinyImageTokenizer(num_tokens=2, emb=16),
    )


def _wait_for_corpus(ready: str, rank: int) -> None:
    for _ in range(1200):
        if os.path.exists(ready):
            return
        time.sleep(0.05)
    # Going on would open the corpus while rank 0 still packs it.
    raise TimeoutError(f"rank {rank}: corpus marker {ready} never appeared "
                       f"(rank 0 still packing, or it died)")


def run_worker(args) -> None:
    """One rank of a group of `--nproc` hosts: rendezvous, train
    `--warmup` + `--steps` steps, write `result_<rank>.json`."""
    import torch
    import torch.distributed as dist

    from rt1_tpu_torch.convert import init_weights
    from rt1_tpu_torch.data import pack as pack_lib
    from rt1_tpu_torch.data.feeder import SampleAheadFeeder
    from rt1_tpu_torch.data.pipeline import device_feeder
    from rt1_tpu_torch.obs import flops as flops_lib
    from rt1_tpu_torch.parallel import distributed as dist_lib
    from rt1_tpu_torch.parallel import mesh as mesh_lib
    from rt1_tpu_torch.parallel.partition import partition_policy
    from rt1_tpu_torch.parallel.plan import ShardingPlan
    from rt1_tpu_torch.trainer.optim import Adam
    from rt1_tpu_torch.trainer.state import create_train_state, shard_train_state
    from rt1_tpu_torch.trainer.train import TrainStepFns

    torch.set_num_threads(1)
    world = args.nproc * args.devices_per_proc
    dev = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    # Every rank on one device: the peak of one card, or of a CPU device a
    # rank as JAX counts its forced CPU devices.
    peak_devices = 1 if dev.type == "cuda" else world
    os.environ.update(RT1_COORDINATOR=f"127.0.0.1:{args.port}",
                      RT1_PROCESS_ID=str(args.process_id), RT1_NUM_PROCESSES=str(world))
    # gloo for either device (the module docstring's placement).
    dist_lib.initialize_from_config({"parallel": {"distributed": {"enabled": True}}}, "cpu")
    try:
        rank = dist.get_rank()
        # Shared corpus: rank 0 packs, the others wait on the marker.
        data_dir = os.path.join(args.workdir, "data")
        ready = os.path.join(args.workdir, "data_ready")
        if rank == 0:
            pack_dir = _build_corpus(data_dir, args.episodes)
            open(ready, "w").close()
        else:
            _wait_for_corpus(ready, rank)
            pack_dir = os.path.join(data_dir, "packed")

        plan = ShardingPlan.from_config({"parallel": {"auto": True}}, n_devices=world,
                                        local_device_count=args.devices_per_proc)
        grid = mesh_lib.RankGrid(plan.mesh)
        mesh_lib.set_current(grid)
        if args.local_batch % args.devices_per_proc:
            raise ValueError(f"--local_batch {args.local_batch} must divide over "
                             f"{args.devices_per_proc} ranks a host")
        feeder = SampleAheadFeeder(pack_lib.PackedEpisodeCache(pack_dir, window=WINDOW),
                                   args.local_batch // args.devices_per_proc, seed=SEED,
                                   num_epochs=None, process_index=grid.batch_index,
                                   process_count=grid.batch_ways)
        policy = tiny_model()
        init_weights(policy, torch.Generator().manual_seed(SEED))
        policy.to(dev)
        partition = partition_policy(policy, grid, plan)
        optimizer = Adam(steps_per_epoch=100)
        state = create_train_state(policy, optimizer, partition)
        if grid.size("fsdp") > 1:
            shard_train_state(state, grid.index("fsdp"), grid.size("fsdp"), optimizer)
        fns = TrainStepFns(optimizer, seed=SEED, grid=grid)

        stall = {"s": 0.0}

        def timed_host_stream():
            while True:
                t0 = time.perf_counter()
                batch = next(feeder)
                stall["s"] += time.perf_counter() - t0
                yield batch

        batches = device_feeder(timed_host_stream(), dev, depth=2)
        try:
            for i in range(args.warmup):
                metrics = fns.train_step(state, next(batches), i)
            float(metrics["loss"])
            stall["s"] = 0.0
            t0 = time.perf_counter()
            for i in range(args.steps):
                metrics = fns.train_step(state, next(batches), args.warmup + i)
            loss = float(metrics["loss"])  # waits for the step
            dt = time.perf_counter() - t0

            # FLOPs of this rank's forward and backward on one more batch,
            # its BatchNorm statistics put back; summed over the ranks.
            probe = next(batches)

            def forward_backward():
                saved = state.flat_buffers.clone()
                try:
                    fns.value_and_grad(state, probe, args.warmup + args.steps)
                finally:
                    state.flat_buffers.copy_(saved)

            rank_flops = flops_lib.train_step_flops(forward_backward)
        finally:
            batches.close()
            feeder.close()
        total = torch.tensor([rank_flops or 0.0], dtype=torch.float64)
        dist.all_reduce(total)
        flops = float(total) if rank_flops else None
        sec_per_step = dt / args.steps
        result = {
            "process_id": rank,
            "host": rank // args.devices_per_proc,
            "process_count": args.nproc,
            "devices_global": world,
            "mesh": dict(plan.mesh.shape),
            "global_batch": args.local_batch * args.nproc,
            "steps": args.steps,
            "steps_per_sec": round(args.steps / dt, 3),
            "sec_per_step": sec_per_step,
            "examples_per_sec": round(args.local_batch * args.nproc * args.steps / dt, 2),
            "data_stall_pct": round(100.0 * stall["s"] / dt, 2),
            "flops_per_step": flops,
            "mfu_pct": flops_lib.mfu_pct(flops, sec_per_step, peak_devices) if flops else None,
            "final_loss": loss,
        }
    finally:
        mesh_lib.set_current(None)
        dist_lib.shutdown()
    with open(os.path.join(args.workdir, f"result_{args.process_id}.json"), "w") as f:
        json.dump(result, f, indent=2, sort_keys=True)
    print(f"worker {args.process_id}/{world}: {result['steps_per_sec']} steps/s", flush=True)


# --------------------------------------------------------------- parent


def _package_root() -> str:
    import rt1_tpu_torch

    return os.path.dirname(os.path.dirname(os.path.abspath(rt1_tpu_torch.__file__)))


def _run_group(nproc: int, args, workdir: str):
    from rt1_tpu_torch.parallel.distributed import free_local_port

    # A fresh group dir every run: a stale data_ready marker would let a
    # rank read the packed corpus mid-rewrite.
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir, exist_ok=True)
    port = free_local_port()
    root = _package_root()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
    world = nproc * args.devices_per_proc
    logs = [open(os.path.join(workdir, f"rank_{r}.log"), "w+") for r in range(world)]
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "rt1_tpu_torch.bench_multihost", "--worker",
             "--process_id", str(r), "--nproc", str(nproc), "--port", str(port),
             "--workdir", workdir, "--steps", str(args.steps), "--warmup", str(args.warmup),
             "--local_batch", str(args.local_batch), "--device", args.device,
             "--devices_per_proc", str(args.devices_per_proc), "--episodes", str(args.episodes)],
            stdout=logs[r], stderr=subprocess.STDOUT, env=env, cwd=workdir)
        for r in range(world)
    ]
    deadline = time.monotonic() + args.timeout_s
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read())
            log.close()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"bench_multihost: rank {r}/{world} of the {nproc}-host group "
                               f"failed (exit {p.returncode}):\n{out[-3000:]}")
    results = []
    for r in range(world):
        with open(os.path.join(workdir, f"result_{r}.json")) as f:
            results.append(json.load(f))
    head = results[0]
    return {
        "processes": nproc,
        "devices_per_process": args.devices_per_proc,
        "devices_global": head["devices_global"],
        "mesh": head["mesh"],
        "global_batch": head["global_batch"],
        "steps_per_sec": head["steps_per_sec"],
        "examples_per_sec": head["examples_per_sec"],
        "mfu_pct": head["mfu_pct"],
        "flops_per_step": head["flops_per_step"],
        "per_host_data_stall_pct": [
            round(sum(r["data_stall_pct"] for r in results if r["host"] == h)
                  / args.devices_per_proc, 2) for h in range(nproc)],
        "final_loss": head["final_loss"],
    }


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.worker:
        return run_worker(args)

    from rt1_tpu_torch import resolve_device

    resolve_device(args.device)  # no card and no --device cpu: raises before any rank starts

    workdir = args.workdir or tempfile.mkdtemp(prefix="rt1_bench_multihost_")
    out = args.out or os.path.join(workdir, RECORD_NAME)
    groups = {}
    for nproc in (1, 2):
        t0 = time.perf_counter()
        groups[f"{nproc}proc"] = _run_group(nproc, args, os.path.join(workdir, f"g{nproc}"))
        print(f"bench_multihost: {nproc}-host group done in {time.perf_counter() - t0:.1f}s",
              file=sys.stderr)
    g1, g2 = groups["1proc"], groups["2proc"]
    dpp = args.devices_per_proc
    on_card = args.device == "cuda"
    where = "all on cuda:0" if on_card else "on the host's CPU"
    record = {
        "bench": "multihost_scaling",
        "model": "tiny",
        "seed": SEED,
        "window": WINDOW,
        "image_hw": [H, W],
        "local_batch": args.local_batch,
        "steps": args.steps,
        "groups": groups,
        "scaling": {
            # Weak scaling: the 2-host group moves twice the examples a step.
            "steps_per_sec_ratio_2p_over_1p": round(g2["steps_per_sec"] / g1["steps_per_sec"], 3),
            "examples_per_sec_ratio_2p_over_1p": round(
                g2["examples_per_sec"] / g1["examples_per_sec"], 3),
        },
        "methodology": {
            "topology": (f"gloo ranks {where}, one process and one host thread each "
                         f"({dpp} a host, JAX's forced CPU devices a process), collectives "
                         f"over loopback; the 2-host group = 2 hosts x {dpp} ranks"),
            "timing": (f"one resident loop, {args.warmup} warm-up steps then {args.steps} "
                       f"timed steps, ended by reading the loss"),
            "mfu": ("FlopCounterMode FLOPs of each rank's forward and backward (obs/flops.py), "
                    "summed over the ranks / measured step time / (devices x peak); peak = "
                    "RT1_TPU_PEAK_FLOPS or the H100's dense bf16 989 TFLOP/s; devices = 1 "
                    "when the ranks share the card, else the ranks"
                    + ("" if on_card else ", so MFU is comparable WITHIN this record only: "
                       "the ranks run on the host's CPU")),
            "caveats": ("Both 'hosts' share one machine"
                        + (" and one card, whose tensors gloo stages through the host," if on_card
                           else "")
                        + " and pay gloo-over-loopback latency for "
                        "every cross-rank collective; at the tiny model's millisecond steps "
                        "that latency dominates, so the 2-host steps/s measures the "
                        "collectives' cost, not compute scaling, and is a lower bound on two "
                        "real hosts. Only dp crosses hosts (parallel.auto keeps fsdp x tp "
                        "within a host)."),
        },
    }
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(record, f, indent=2, sort_keys=True)
    print(f"bench_multihost: wrote {out}", file=sys.stderr)
    print(json.dumps({"bench": "multihost_scaling",
                      "1proc_steps_per_sec": g1["steps_per_sec"],
                      "2proc_steps_per_sec": g2["steps_per_sec"],
                      "examples_per_sec_ratio": record["scaling"][
                          "examples_per_sec_ratio_2p_over_1p"],
                      "out": out}), flush=True)
    return record


if __name__ == "__main__":
    main()
