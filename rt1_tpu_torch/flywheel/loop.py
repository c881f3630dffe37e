"""Data-flywheel loop: serve traffic -> captured episodes -> appended pack
shard -> a LIVE train job absorbs it mid-run:
`python -m rt1_tpu_torch.flywheel.loop`. Writes BENCH_flywheel.json.

The port's entry for the JAX package's `scripts/flywheel_loop.py`, with the
same acts and record, on the port's serve and train CLIs. Four acts:

1. **Seed corpus.** Synthetic episodes at the config's serve/train
   geometry, packed into the sharded cache (one base shard), and a
   2-step checkpoint trained on it.
2. **Serve with capture.** One real replica (`python -m rt1_tpu_torch.serve
   --workdir <that checkpoint> --capture_dir ...`) serves N deterministic
   sessions; each `/release` writes a standard episode `.npz` into the
   capture dir — observations, actions, action tokens, the `task` tag,
   the outcome. (JAX's script serves `--random_init`; the port's seeded
   random `tiny` answers a terminate token on every step, which ends each
   captured episode at one step, below the sink's two-step floor.)
3. **Torn-append chaos.** With `pack_append@1` armed, `append_shard` dies
   AFTER the shard files land and BEFORE the manifest rename; the loop
   asserts readers still see the intact one-shard corpus. The retry then
   appends the captured episodes for real: shards 1 -> 2,
   freshness_epoch 0 -> 1.
4. **Live pickup.** A train job launched BEFORE the append (packed feeder,
   `data.packed_refresh=True`, Prometheus scrape port) is polled for its
   `rt1_flywheel_corpus_windows` / `rt1_flywheel_corpus_steps` gauges: the
   loop asserts the corpus STRICTLY grows mid-run — the feeder picked
   the new shard up at an epoch boundary with no restart — then SIGTERMs
   the job (preemption save-and-exit, rc 0).

Run (the smoke config on the CPU; `--config language_table` and no
`--device` for the flagship on the card):

    python -m rt1_tpu_torch.flywheel.loop --config tiny --device cpu \\
        --workdir /tmp/rt1_flywheel --bench_out /tmp/BENCH_flywheel.json
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np

#: The repo root: the serve and train CLIs run from here as `python -m`.
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def post(url, payload, timeout=30.0):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def get_text(url, timeout=10.0, accept=None):
    req = urllib.request.Request(url, headers={"Accept": accept} if accept else {})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.read().decode()


def free_port() -> int:
    """An ephemeral localhost port that is free right now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def read_ready_line(proc, timeout_s=600.0):
    """Parse a server's `{"status": "serving", "port": ...}` line."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            if proc.poll() is not None:
                raise RuntimeError(f"subprocess exited rc={proc.returncode} before ready")
            time.sleep(0.1)
            continue
        try:
            msg = json.loads(line)
        except json.JSONDecodeError:
            continue
        if msg.get("status") == "serving":
            return msg
    raise TimeoutError("no ready line within the timeout")


def stop_process(proc, timeout=120.0) -> int:
    """SIGTERM (the CLIs' drain), then SIGKILL past `timeout`; the exit code."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
    return proc.returncode


def stop_and_collect(proc, timeout=180.0):
    """SIGTERM a process whose stdout is a pipe and read it to the end
    (reading while it drains, so a long final line cannot block it);
    SIGKILL past `timeout`. Returns its stdout."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate(timeout=30)
    return out


def build_corpus(data_dir, episodes, steps, height, width, seed=0, task="seed_corpus"):
    """Seeded synthetic episodes under `<data_dir>/train`; their paths."""
    from rt1_tpu_torch.data.episodes import (
        encode_instruction_text,
        generate_synthetic_episode,
        save_episode,
    )

    train = os.path.join(data_dir, "train")
    os.makedirs(train, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(episodes):
        ep = generate_synthetic_episode(rng, num_steps=steps, height=height, width=width)
        ep["task"] = encode_instruction_text(task)
        path = os.path.join(train, f"episode_{i}.npz")
        save_episode(path, ep)
        paths.append(path)
    return paths


def scrape_flywheel(port):
    """{gauge: value} for the rt1_flywheel_* families on the train scrape."""
    try:
        text = get_text(f"http://127.0.0.1:{port}/metrics", timeout=5.0)
    except (urllib.error.URLError, OSError):
        return None
    out = {}
    for line in text.splitlines():
        if line.startswith("rt1_flywheel_"):
            name, value = line.rsplit(" ", 1)
            out[name] = float(value)
    return out or None


def torn_append_chaos(pack_dir, staged):
    """Act 3a: prove the torn-append window is reader-safe."""
    from rt1_tpu_torch.data import pack as pack_lib
    from rt1_tpu_torch.resilience import faults

    before = pack_lib.load_manifest(pack_dir)
    faults.install_from("pack_append@1")
    injected = False
    try:
        try:
            pack_lib.append_shard(pack_dir, staged)
        except OSError as exc:
            injected = "pack_append" in str(exc)
    finally:
        faults.clear()
    after = pack_lib.load_manifest(pack_dir)
    intact = (
        after["freshness_epoch"] == before["freshness_epoch"]
        and len(after["shards"]) == len(before["shards"])
        and pack_lib.verify_shards(pack_dir, after) == []
    )
    # The cache must open and read the old corpus through the torn window.
    cache = pack_lib.PackedEpisodeCache(pack_dir, window=3)
    cache.get_window(0, np.random.default_rng(0))
    return {
        "injected": injected,
        "manifest_intact": intact,
        "cache_loads": True,
        "windows_visible": len(cache.index),
    }


def start_live_trainer(config, device, train_wd, data_dir, scrape_port, log):
    """A train job on the packed feed with the mid-run corpus pickup
    (`data.packed_refresh`) and a Prometheus listener; runs until SIGTERM."""
    return subprocess.Popen(
        [
            sys.executable, "-m", "rt1_tpu_torch.train",
            "--config", config,
            "--workdir", train_wd,
            "--device", device,
            "--set", f"data.data_dir={data_dir}",
            "--set", "data.packed_cache=True",
            "--set", "data.packed_refresh=True",
            "--set", "num_steps=1000000",
            "--set", "checkpoint_every_steps=5000",
            "--set", "log_every_steps=20",
            "--set", "eval_every_steps=0",
            "--set", f"obs.prometheus_port={scrape_port}",
        ],
        stdout=log, stderr=subprocess.STDOUT, cwd=REPO,
    )


def wait_flywheel_gauges(proc, port, timeout_s, grown_from=None):
    """Poll the train scrape until its rt1_flywheel_* gauges are up (or,
    with `grown_from` = windows seen before, until the corpus STRICTLY
    grew over two shards); returns (the gauges, samples polled)."""
    deadline = time.monotonic() + timeout_s
    samples = 0
    last = None
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(f"train job exited rc={proc.returncode} while polled")
        snap = scrape_flywheel(port)
        if snap:
            samples += 1
            last = snap
            if grown_from is None or (
                    snap["rt1_flywheel_corpus_windows"] > grown_from
                    and snap["rt1_flywheel_shards"] == 2):
                return snap, samples
        time.sleep(0.5)
    raise TimeoutError(f"flywheel gauges did not arrive or grow (last: {last})")


def _serve_and_capture(args, capture_dir, log_dir, height, width, serve_wd):
    """Act 2: one replica with capture on; returns the serve record."""
    stderr = open(os.path.join(log_dir, "serve.log"), "w")
    proc = subprocess.Popen(
        [
            sys.executable, "-m", "rt1_tpu_torch.serve",
            "--config", args.config,
            "--workdir", serve_wd,
            "--port", "0",
            "--device", args.device,
            "--max_sessions", str(max(4, args.sessions)),
            "--capture_dir", capture_dir,
        ],
        stdout=subprocess.PIPE, stderr=stderr, text=True, cwd=REPO,
    )
    record = {"sessions": args.sessions, "steps_per_session": args.steps}
    try:
        ready = read_ready_line(proc)
        url = f"http://127.0.0.1:{ready['port']}"
        rng = np.random.default_rng(7)
        embedding = [float(x) for x in rng.standard_normal(512).astype(np.float32)]
        ok = 0
        for s in range(args.sessions):
            sid = f"fly-{s}"
            post(url + "/reset", {"session_id": sid})
            for _ in range(args.steps):
                frame = rng.integers(0, 256, (height, width, 3), dtype=np.uint8)
                resp = post(url + "/act", {
                    "session_id": sid,
                    "image_b64": base64.b64encode(frame.tobytes()).decode("ascii"),
                    "embedding": embedding,
                    "task": "flywheel_demo",
                })
                assert "action" in resp, resp
                ok += 1
            post(url + "/release", {"session_id": sid})
        metrics = json.loads(get_text(url + "/metrics"))
        record.update(
            requests_ok=ok,
            compile_count=metrics.get("compile_count"),
            capture_episodes=metrics.get("capture_episodes_total"),
            capture_steps=metrics.get("capture_steps_total"),
            capture_write_errors=metrics.get("capture_write_errors_total"),
        )
    finally:
        stop_process(proc, timeout=60)
        stderr.close()
    record["serve_exit_code"] = proc.returncode
    return record


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m rt1_tpu_torch.flywheel.loop",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="tiny", help="language_table | tiny")
    p.add_argument("--device", default="cuda", help="cuda | cpu")
    p.add_argument("--workdir", default="/tmp/rt1_flywheel")
    p.add_argument("--bench_out", default=None,
                   help="The record's path (default <workdir>/BENCH_flywheel.json).")
    p.add_argument("--episodes", type=int, default=12, help="Seed-corpus episodes.")
    p.add_argument("--episode_steps", type=int, default=8)
    p.add_argument("--sessions", type=int, default=4, help="Served sessions to capture.")
    p.add_argument("--steps", type=int, default=10, help="Steps per served session.")
    p.add_argument("--pickup_timeout_s", type=float, default=240.0)
    args = p.parse_args(sys.argv[1:] if argv is None else argv)

    from rt1_tpu_torch import resolve_device
    from rt1_tpu_torch.configs import get_config
    from rt1_tpu_torch.data import pack as pack_lib
    from rt1_tpu_torch.flywheel.capture import capture_files

    resolve_device(args.device)
    config = get_config(args.config)
    height, width = config.data.height, config.data.width
    t_start = time.perf_counter()
    wd = os.path.abspath(args.workdir)
    shutil.rmtree(wd, ignore_errors=True)
    if args.bench_out is None:
        args.bench_out = os.path.join(wd, "BENCH_flywheel.json")
    data_dir = os.path.join(wd, "data")
    capture_dir = os.path.join(wd, "capture")
    log_dir = os.path.join(wd, "logs")
    train_wd = os.path.join(wd, "train")
    serve_wd = os.path.join(wd, "serve")
    for d in (data_dir, capture_dir, log_dir, train_wd, serve_wd):
        os.makedirs(d, exist_ok=True)

    bench = {
        "bench": "flywheel_e2e",
        "description": (
            "Closed collect->train->serve loop: a real replica captures "
            "served sessions, the packer appends them as a new shard, and "
            "a live train job's feeder absorbs the shard at an epoch "
            f"boundary without restart ({args.config} config, {args.device})."
        ),
        "config": {
            "seed_episodes": args.episodes,
            "episode_steps": args.episode_steps,
            "sessions": args.sessions,
            "steps_per_session": args.steps,
            "geometry": [height, width],
        },
    }

    # ---- Act 1: seed corpus + base pack
    paths = build_corpus(data_dir, args.episodes, args.episode_steps, height, width)
    pack_dir = pack_lib.default_pack_dir(data_dir, "train")
    manifest = pack_lib.pack_episodes(paths, pack_dir, height, width, config.data.crop_factor)
    windows_base = manifest["total_steps"]
    rc = subprocess.call(
        [sys.executable, "-m", "rt1_tpu_torch.train", "--config", args.config,
         "--workdir", serve_wd, "--device", args.device, "--set", f"data.data_dir={data_dir}",
         "--set", "data.packed_cache=True", "--set", "num_steps=2",
         "--set", "checkpoint_every_steps=2", "--set", "eval_every_steps=0"],
        stdout=open(os.path.join(log_dir, "seed_train.log"), "w"), stderr=subprocess.STDOUT,
        cwd=REPO)
    assert rc == 0, f"seed train failed rc={rc}"
    print(json.dumps({"phase": "seed", "episodes": len(paths),
                      "steps": manifest["total_steps"]}), flush=True)

    # ---- Act 2: serve with capture
    t0 = time.perf_counter()
    bench["serve"] = _serve_and_capture(args, capture_dir, log_dir, height, width, serve_wd)
    bench["serve"]["seconds"] = round(time.perf_counter() - t0, 1)
    staged = capture_files(capture_dir)
    bench["serve"]["captured_files"] = len(staged)
    print(json.dumps({"phase": "serve", **bench["serve"]}), flush=True)
    assert staged, "serve phase captured no episodes"
    assert bench["serve"]["capture_episodes"] >= args.sessions

    # ---- Act 4 setup: launch the train job BEFORE the append, so the
    # append provably lands mid-run.
    scrape_port = free_port()
    train_log = open(os.path.join(log_dir, "train.log"), "w")
    train_proc = start_live_trainer(args.config, args.device, train_wd, data_dir, scrape_port,
                                    train_log)
    bench["train"] = {"scrape_port": scrape_port}
    try:
        first, _ = wait_flywheel_gauges(train_proc, scrape_port, args.pickup_timeout_s)
        windows_before = first["rt1_flywheel_corpus_windows"]
        steps_before = first["rt1_flywheel_corpus_steps"]
        assert first["rt1_flywheel_shards"] == 1
        assert steps_before == windows_base
        bench["train"]["before"] = first
        print(json.dumps({"phase": "train_up", **first}), flush=True)

        # ---- Act 3: torn-append chaos, then the real append — both while
        # the train job is live.
        bench["torn_append"] = torn_append_chaos(pack_dir, staged)
        assert bench["torn_append"]["injected"]
        assert bench["torn_append"]["manifest_intact"]
        print(json.dumps({"phase": "torn_append", **bench["torn_append"]}), flush=True)

        t0 = time.perf_counter()
        manifest = pack_lib.append_shard(pack_dir, staged)
        bench["pack"] = {
            "shards_before": 1,
            "shards_after": len(manifest["shards"]),
            "freshness_epoch": manifest["freshness_epoch"],
            "appended_episodes": manifest["shards"][-1]["episodes"],
            "corpus_steps_after": manifest["total_steps"],
            "append_seconds": round(time.perf_counter() - t0, 2),
        }
        print(json.dumps({"phase": "append", **bench["pack"]}), flush=True)
        assert bench["pack"]["shards_after"] == 2

        # ---- Act 4: the live job must absorb the shard at an epoch
        # boundary: corpus windows/steps STRICTLY grow mid-run.
        grown, samples = wait_flywheel_gauges(train_proc, scrape_port, args.pickup_timeout_s,
                                              grown_from=windows_before)
        bench["train"]["after"] = grown
        bench["train"]["observed_growth_mid_run"] = True
        bench["train"]["train_alive_at_growth"] = train_proc.poll() is None
        bench["train"]["corpus_windows"] = [windows_before, grown["rt1_flywheel_corpus_windows"]]
        bench["train"]["corpus_steps"] = [steps_before, grown["rt1_flywheel_corpus_steps"]]
        bench["train"]["samples_polled"] = samples
        print(json.dumps({"phase": "pickup", **grown}), flush=True)
    finally:
        # Preemption path: SIGTERM -> force-save -> exit 0.
        stop_process(train_proc)
        train_log.close()
    bench["train"]["exit_code"] = train_proc.returncode
    assert train_proc.returncode == 0, "train preempt exit was not clean"
    assert bench["train"]["corpus_steps"][1] > bench["train"]["corpus_steps"][0]

    bench["total_seconds"] = round(time.perf_counter() - t_start, 1)
    bench["verdict"] = "flywheel_closed"
    with open(args.bench_out, "w") as f:
        json.dump(bench, f, indent=2, sort_keys=True)
    print(json.dumps({"phase": "done", "bench_out": args.bench_out,
                      "total_seconds": bench["total_seconds"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
