"""Chaos drill: prove the trainer's self-healing paths on a real tiny run
(counterpart of `scripts/chaos_train.py`).

Launches three short training runs of `python -m rt1_tpu_torch.train
--config tiny --device <device>` as subprocesses over a packed synthetic
corpus:

1. **reference** — fault-free; records the final checkpoint step.
2. **chaos phase A** — a seeded, randomized fault schedule drawn by this
   script: one NaN batch (the guard skips the update on the device), one
   transient checkpoint-save IOError (retried with backoff), one
   self-delivered SIGTERM mid-run (the preemption handler force-saves and
   exits 0).
3. **chaos phase B** — a plain relaunch in the same workdir; the resume
   carries it to completion.

Asserts: every run exits 0, the chaos run reaches the SAME final
checkpoint step as the reference, the phase-A flight-recorder dump has
reason "preempt" and shows the guard's device-skip counter, the retry
counter recorded at least one checkpoint-save retry (and the
`resilience: ckpt_save attempt` warning reached phase A's stderr), and
phase A's goodput summary (`obs/goodput.py`) attributes nonzero
preempt-drain and checkpoint-I/O badput with bucket fractions summing to
100%±1. Prints a JSON summary.

The fault schedule reaches the subprocesses through the ``RT1_FAULTS``
environment variable (`resilience/faults.py` grammar), the channel an
operator uses for ad-hoc drills::

    python -m rt1_tpu_torch.resilience.chaos_train --workdir /tmp/rt1_chaos --seed 0
    python -m rt1_tpu_torch.resilience.chaos_train --workdir /tmp/rt1_chaos --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

# The port's tiny config: 32x56 train frames, crop factor 0.95.
TINY_HEIGHT, TINY_WIDTH, TINY_CROP = 32, 56, 0.95


def _latest_ckpt_step(workdir):
    """The newest checkpoint step directory that holds files, or None."""
    ckpt_dir = os.path.join(workdir, "checkpoints")
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(d)
        for d in os.listdir(ckpt_dir)
        if d.isdigit() and os.listdir(os.path.join(ckpt_dir, d))
    ]
    return max(steps) if steps else None


def _build_corpus(data_dir, episodes, steps_per_episode, src_h, src_w, seed):
    import numpy as np

    from rt1_tpu_torch.data.episodes import generate_synthetic_episode, save_episode

    train = os.path.join(data_dir, "train")
    os.makedirs(train, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(episodes):
        path = os.path.join(train, f"episode_{i}.npz")
        if not os.path.exists(path):
            save_episode(
                path,
                generate_synthetic_episode(
                    rng, num_steps=steps_per_episode, height=src_h, width=src_w
                ),
            )
        paths.append(path)
    return paths


def _pack_corpus(paths, data_dir, height, width, crop_factor):
    from rt1_tpu_torch.data.pack import default_pack_dir, pack_episodes

    pack_dir = default_pack_dir(data_dir, "train")
    pack_episodes(paths, pack_dir, height, width, crop_factor)
    return pack_dir


def _run_train(workdir, data_dir, num_steps, device, faults="", packed=True, verbose=False):
    """One training subprocess; returns (returncode, stderr_text)."""
    cmd = [
        sys.executable, "-m", "rt1_tpu_torch.train",
        "--config", "tiny",
        "--device", device,
        "--workdir", workdir,
        "--set", f"num_steps={num_steps}",
        "--set", "checkpoint_every_steps=2",
        "--set", "log_every_steps=1",
        "--set", "resilience.retry_backoff_s=0.05",
    ]
    if data_dir:
        cmd += [
            "--set", f"data.data_dir={data_dir}",
            "--set", "data.loader=numpy",
            "--set", f"data.packed_cache={packed}",
        ]
    env = dict(os.environ)
    env["RT1_FAULTS"] = faults
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=600)
    if verbose or proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
    return proc.returncode, proc.stderr


def _draw_schedule(seed, num_steps):
    """Seeded random fault schedule with the ordering the proof needs:
    the NaN batch and the transient save failure land BEFORE the SIGTERM,
    so phase A exercises all three paths before it exits."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sig_step = int(rng.integers(num_steps // 2, num_steps // 2 + 2))
    nan_batch = int(rng.integers(1, max(2, sig_step - 2)))
    # Saves happen every 2 steps; occurrence 1 or 2 fires at step 2 or 4,
    # both before sig_step (>= num_steps // 2 >= 5 for the default 12).
    save_occurrence = int(rng.integers(1, 3))
    return (
        f"nan_batch@{nan_batch},ckpt_save@{save_occurrence},"
        f"sigterm@{sig_step}"
    ), sig_step


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m rt1_tpu_torch.resilience.chaos_train",
                                description=__doc__.split("\n")[0])
    p.add_argument("--workdir", required=True,
                   help="The drill's directory, wiped at start unless --keep.")
    p.add_argument("--seed", type=int, default=0,
                   help="Seeds the corpus AND the fault schedule draw.")
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--episodes", type=int, default=6)
    p.add_argument("--device", default="cuda", help="cuda | cpu: the train runs' device.")
    p.add_argument("--synthetic", action="store_true",
                   help="Skip the packed corpus; train on synthetic random "
                        "batches (faster, but does not exercise the feeder).")
    p.add_argument("--keep", action="store_true",
                   help="Keep the workdir (default: wiped at start).")
    p.add_argument("--verbose", action="store_true",
                   help="Mirror subprocess stderr.")
    args = p.parse_args(argv)

    if args.steps < 10:
        p.error("--steps must be >= 10 (the schedule needs room for a NaN "
                "batch and two saves before the mid-run SIGTERM)")
    if args.device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {args.device}: CUDA is not available "
                               "(pass --device cpu)")
    if os.path.isdir(args.workdir) and not args.keep:
        shutil.rmtree(args.workdir)
    os.makedirs(args.workdir, exist_ok=True)

    data_dir = ""
    if not args.synthetic:
        data_dir = os.path.join(args.workdir, "data")
        paths = _build_corpus(
            data_dir, args.episodes, steps_per_episode=24,
            src_h=48, src_w=84, seed=args.seed,
        )
        _pack_corpus(paths, data_dir, TINY_HEIGHT, TINY_WIDTH, TINY_CROP)

    def run(workdir, faults=""):
        return _run_train(workdir, data_dir, args.steps, args.device, faults=faults,
                          verbose=args.verbose)

    # 1. Fault-free reference.
    ref_dir = os.path.join(args.workdir, "reference")
    rc, _ = run(ref_dir)
    assert rc == 0, f"reference run failed (rc={rc})"
    ref_step = _latest_ckpt_step(ref_dir)
    assert ref_step == args.steps, (
        f"reference run final checkpoint {ref_step} != {args.steps}"
    )

    # 2. Chaos phase A: NaN + transient save IOError + SIGTERM, seeded.
    faults, sig_step = _draw_schedule(args.seed, args.steps)
    chaos_dir = os.path.join(args.workdir, "chaos")
    rc, stderr_a = run(chaos_dir, faults=faults)
    assert rc == 0, (
        f"chaos phase A must exit 0 on SIGTERM (save-and-exit), got rc={rc}"
    )
    step_a = _latest_ckpt_step(chaos_dir)
    assert step_a == sig_step + 1, (
        f"phase A saved step {step_a}, expected sig_step+1 = {sig_step + 1}"
    )

    # Preemption dump: reason "preempt", guard + retry events recorded.
    dump_path = os.path.join(chaos_dir, "flight_record.jsonl")
    assert os.path.exists(dump_path), "phase A left no flight-recorder dump"
    with open(dump_path) as f:
        header = json.loads(f.readline())["flight_recorder"]
        records = [json.loads(line) for line in f if line.strip()]
    assert header["reason"] == "preempt", header
    device_skips = max(
        (r.get("guard", {}).get("guard/device_skips_total", 0.0)
         for r in records),
        default=0.0,
    )
    assert device_skips >= 1, (
        f"guard device-skip counter absent from the dump: {records[-3:]}"
    )
    retry_events = max(
        (r.get("retry", {}).get("retry/ckpt_save_retries_total", 0.0)
         for r in records),
        default=0.0,
    )
    assert retry_events >= 1, "ckpt_save retry counter absent from the dump"
    assert "resilience: ckpt_save attempt" in stderr_a, (
        "retry warning missing from phase A logs"
    )

    # Goodput ledger: phase A's summary must attribute the preemption as
    # badput — nonzero preempt_drain bucket, preempted flag set, and the
    # bucket fractions must sum to 100%±1. (Read it BEFORE phase B
    # relaunches into the same workdir.)
    goodput_path = os.path.join(chaos_dir, "goodput_summary.json")
    assert os.path.exists(goodput_path), "phase A left no goodput summary"
    with open(goodput_path) as f:
        goodput_a = json.load(f)
    assert goodput_a["preempted"] is True, goodput_a
    preempt_badput_s = goodput_a["buckets_s"]["preempt_drain"]
    ckpt_badput_s = (
        goodput_a["buckets_s"]["ckpt_save"]
        + goodput_a["buckets_s"]["ckpt_restore"]
    )
    assert preempt_badput_s > 0, (
        f"preempt_drain badput not attributed: {goodput_a['buckets_s']}"
    )
    assert ckpt_badput_s > 0, (
        f"checkpoint I/O badput not attributed: {goodput_a['buckets_s']}"
    )
    fraction_sum = sum(goodput_a["fractions"].values())
    assert abs(fraction_sum - 1.0) < 0.01, (
        f"goodput fractions sum to {fraction_sum}, not 100%±1"
    )

    # 3. Chaos phase B: plain relaunch resumes to the reference's step.
    rc, _ = run(chaos_dir)
    assert rc == 0, f"chaos phase B failed (rc={rc})"
    final_step = _latest_ckpt_step(chaos_dir)
    assert final_step == ref_step, (
        f"chaos run finished at step {final_step}, reference at {ref_step}"
    )

    summary = {
        "ok": True,
        "faults": faults,
        "device": args.device,
        "reference_final_step": ref_step,
        "phase_a_saved_step": step_a,
        "final_step": final_step,
        "guard_device_skips": device_skips,
        "ckpt_save_retries": retry_events,
        "preempt_dump_records": len(records),
        # Unrounded: a drain of under half a millisecond rounded to 3
        # places reads 0.0, "not attributed", though it was.
        "preempt_badput_s": preempt_badput_s,
        "ckpt_badput_s": ckpt_badput_s,
        "goodput_pct_phase_a": round(goodput_a["goodput_pct"], 2),
        "packed": not args.synthetic,
    }
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
