"""Continuous-deployment loop: train -> gate -> canary -> promote /
rollback against a REAL two-replica fleet:
`python -m rt1_tpu_torch.deploy.loop`. Writes BENCH_deploy.json.

The port's entry for the JAX package's `scripts/deploy_loop.py`, with the
same episodes, assertions and record, on the port's train CLI and fleet.
Two fleet episodes over ONE train workdir:

1. **Good candidate promoted.** Train to the first checkpoint, boot a
   real fleet with `--promote_from <train_wd>` (replicas restore the
   incumbent; the controller auto-detects its step), then resume the
   train job to the next checkpoint WHILE the fleet serves traffic. The
   controller discovers the candidate, runs the real offline gate
   (eval-matrix cells vs. the incumbent + the serve parity check, on
   `--device`), signs the verdict, canaries the candidate onto one
   replica behind the weighted fresh-session split, and — after a clean
   burn window — promotes it fleet-wide through the rolling reload.
   Sessions stick: zero `restarted` flags, zero failed requests,
   compile_count pinned at bucket_count on every replica.
2. **Bad candidate rolled back.** Same fleet, rebooted with
   `canary_slo_breach@N` armed: the next trained checkpoint passes the
   offline gate (the injected failure is a RUNTIME burn, which is the
   point — offline eval cannot see it), canaries, breaches its
   per-replica SLO burn for `breach_ticks` consecutive windows, and is
   auto-rolled-back: canary demoted, incumbent checkpoint restored
   onto the replica, canary-bound sessions re-homed through failover
   with `restarted: true` on their next act. The incumbent step never
   moves and no request fails.

Run (the smoke config on the CPU; `--config language_table` and no
`--device` for the flagship on the card):

    python -m rt1_tpu_torch.deploy.loop --config tiny --device cpu \\
        --workdir /tmp/rt1_deploy --bench_out /tmp/BENCH_deploy.json
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

from rt1_tpu_torch.flywheel.loop import (
    REPO,
    build_corpus,
    post,
    read_ready_line,
    stop_and_collect,
)


def get_json(url, timeout=20.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


def train_to(config, device, train_wd, data_dir, num_steps, log_path):
    """Run (or resume) the train job to `num_steps` total steps —
    restore-or-initialize makes later calls pure resumes that add exactly
    the next checkpoint. The packed corpus in `data_dir` stamps
    `<train_wd>/data_manifest.json`."""
    with open(log_path, "a") as log:
        rc = subprocess.call(
            [
                sys.executable, "-m", "rt1_tpu_torch.train",
                "--config", config,
                "--workdir", train_wd,
                "--device", device,
                "--set", f"data.data_dir={data_dir}",
                "--set", "data.packed_cache=True",
                "--set", f"num_steps={num_steps}",
                "--set", "checkpoint_every_steps=2",
                "--set", "log_every_steps=1",
                "--set", "eval_every_steps=0",
            ],
            stdout=log, stderr=subprocess.STDOUT, cwd=REPO,
        )
    if rc != 0:
        raise RuntimeError(f"train to {num_steps} failed rc={rc} (see {log_path})")


class Traffic(threading.Thread):
    """Continuous fleet client: a rolling pool of pinned sessions acted
    round-robin, plus a fresh session every `fresh_every_s` so the
    weighted canary split always has placements to work with. Every
    response is recorded; `restarted: true` flags are the re-homing
    evidence the record asserts on."""

    def __init__(self, url, height, width, seed=0, fresh_every_s=1.0, pool=6):
        super().__init__(daemon=True)
        self.url = url
        self.fresh_every_s = fresh_every_s
        self.pool = pool
        self.stop_evt = threading.Event()
        self.sessions = []       # every session id ever created (ordered)
        self.ok = 0
        self.failures = []       # [{session, error}]
        self.restarts = []       # [{session, unix_time}]
        rng = np.random.default_rng(seed)
        self._frame_b64 = base64.b64encode(
            rng.integers(0, 256, (height, width, 3), dtype=np.uint8).tobytes()).decode("ascii")
        self._embedding = [float(x) for x in rng.standard_normal(512).astype(np.float32)]
        self._counter = 0

    def act(self, sid):
        """One /act; returns the body or None (failure recorded)."""
        try:
            body = post(self.url + "/act", {
                "session_id": sid,
                "image_b64": self._frame_b64,
                "embedding": self._embedding,
                "task": "deploy_probe",
            }, timeout=120.0)
        except (urllib.error.URLError, OSError, socket.timeout) as exc:
            self.failures.append({"session": sid, "error": str(exc)})
            return None
        if "action" not in body:
            self.failures.append({"session": sid, "error": str(body)})
            return None
        self.ok += 1
        if body.get("restarted"):
            self.restarts.append({"session": sid, "unix_time": round(time.time(), 3)})
        return body

    def _fresh(self):
        sid = f"probe-{self._counter}"
        self._counter += 1
        self.sessions.append(sid)
        self.act(sid)

    def run(self):
        last_fresh = 0.0
        while not self.stop_evt.is_set():
            now = time.monotonic()
            if now - last_fresh >= self.fresh_every_s:
                self._fresh()
                last_fresh = now
            for sid in self.sessions[-self.pool:]:
                if self.stop_evt.is_set():
                    return
                self.act(sid)
            self.stop_evt.wait(0.2)

    def sweep(self, tail=12):
        """Act the newest `tail` sessions once (caller-thread, after the
        loop stopped): consumes any pending `restarted` flags so a
        rollback's re-homing is observed even if it landed between loop
        passes. Returns the restarted session ids."""
        restarted = []
        for sid in self.sessions[-tail:]:
            body = self.act(sid)
            if body is not None and body.get("restarted"):
                restarted.append(sid)
        return restarted


def deploy_status(url):
    try:
        return get_json(url + "/deploy/status", timeout=15.0)
    except (urllib.error.URLError, OSError, socket.timeout):
        return None


TERMINAL = ("promoted", "rolled_back", "gate_rejected", "canary_load_failed", "error")


def wait_terminal(url, timeout_s, after=0, poll_s=1.0):
    """Poll /deploy/status until a terminal timeline event past the first
    `after` entries lands; returns (event_entry, full_status). Scrapes
    stay live through the gate (the controller runs it unlocked)."""
    deadline = time.monotonic() + timeout_s
    status = None
    while time.monotonic() < deadline:
        status = deploy_status(url)
        if status is not None:
            for entry in status.get("timeline", [])[after:]:
                if entry.get("event") in TERMINAL:
                    return entry, status
        time.sleep(poll_s)
    raise TimeoutError(
        f"no terminal deploy event within {timeout_s}s "
        f"(last: {json.dumps(status)[:2000] if status else None})"
    )


def verify_verdict(train_wd, path):
    from rt1_tpu_torch.deploy import verdict as verdict_lib

    key = verdict_lib.signing_key(os.path.join(train_wd, "deploy"))
    payload, ok = verdict_lib.verify_verdict(path, key)
    return {
        "path": os.path.relpath(path, train_wd),
        "signature_ok": bool(ok),
        "passed": bool(payload.get("passed")) if payload else None,
        "candidate_step": payload.get("candidate_step") if payload else None,
        "incumbent_step": payload.get("incumbent_step") if payload else None,
    }


def fleet_argv(config, device, train_wd, *, clean_window_ticks, gate_tasks, gate_episodes,
               gate_max_steps, faults="", min_canary_requests=4, poll_interval_s=1.0,
               extra=()):
    """The `--promote_from` fleet of two replicas over `train_wd`."""
    argv = [
        sys.executable, "-m", "rt1_tpu_torch.serve.fleet",
        "--replicas", "2",
        "--port", "0",
        "--config", config,
        "--device", device,
        "--workdir", train_wd,
        "--promote_from", train_wd,
        "--max_sessions", "8",
        "--deploy_poll_interval_s", str(poll_interval_s),
        "--canary_weight", "0.5",
        "--breach_ticks", "2",
        "--clean_window_ticks", str(clean_window_ticks),
        "--min_canary_requests", str(min_canary_requests),
        "--gate_episodes", str(gate_episodes),
        "--gate_tasks", gate_tasks,
        "--gate_max_steps", str(gate_max_steps),
        *extra,
    ]
    if faults:
        argv += ["--faults", faults]
    return argv


def final_line(out):
    """The fleet's `{"status": "stopped", ...}` line, or None."""
    final = None
    for line in (out or "").splitlines():
        try:
            msg = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(msg, dict) and msg.get("status") == "stopped":
            final = msg
    return final


def replica_records(url):
    fstat = get_json(url + "/fleet/status", timeout=60.0)
    return [
        {
            "id": r["id"],
            "state": r["state"],
            "compile_count": r.get("metrics", {}).get("compile_count"),
            "bucket_count": r.get("metrics", {}).get("bucket_count"),
            "reloads_total": r.get("metrics", {}).get("reloads_total"),
        }
        for r in fstat["replicas"]
    ]


def _fleet_episode(tag, args, train_wd, log_dir, height, width, *, faults,
                   clean_window_ticks, next_train_steps, wait_s):
    """Boot the fleet, drive traffic, resume training to the candidate
    checkpoint, wait for the controller's terminal event, collect all
    the evidence, SIGTERM. Returns the episode record."""
    stderr = open(os.path.join(log_dir, f"fleet_{tag}.log"), "w")
    proc = subprocess.Popen(
        fleet_argv(args.config, args.device, train_wd, clean_window_ticks=clean_window_ticks,
                   gate_tasks=args.gate_tasks, gate_episodes=args.gate_episodes,
                   gate_max_steps=args.gate_max_steps, faults=faults),
        stdout=subprocess.PIPE, stderr=stderr, text=True, cwd=REPO,
    )
    record = {"episode": tag, "faults": faults or None}
    traffic = None
    try:
        ready = read_ready_line(proc, timeout_s=900.0)
        assert ready.get("deploy"), f"fleet armed no controller: {ready}"
        record["ready"] = {"port": ready["port"], "deploy": ready["deploy"]}
        url = f"http://127.0.0.1:{ready['port']}"
        print(json.dumps({"phase": f"{tag}_fleet_up", **ready["deploy"]}), flush=True)

        traffic = Traffic(url, height, width, seed=len(tag))
        traffic.start()

        # Resume the train job to the candidate checkpoint WHILE the
        # fleet serves: the controller's watcher must pick the new step
        # up from a live save.
        t0 = time.perf_counter()
        train_to(args.config, args.device, train_wd, args.data_dir, next_train_steps,
                 os.path.join(log_dir, "train.log"))
        record["train_resume_seconds"] = round(time.perf_counter() - t0, 1)
        print(json.dumps({"phase": f"{tag}_candidate_trained",
                          "num_steps": next_train_steps}), flush=True)

        terminal, status = wait_terminal(url, wait_s, poll_s=3.0)
        record["terminal_event"] = terminal
        record["timeline"] = status["timeline"]
        record["watch_log_tail"] = status["watch_log"][-12:]
        print(json.dumps({"phase": f"{tag}_terminal", **terminal}), flush=True)

        # A couple more seconds of live traffic, then stop the loop and
        # sweep the newest sessions from this thread: any canary-bound
        # session re-homed by a rollback must surface `restarted: true`.
        time.sleep(2.0)
        traffic.stop_evt.set()
        traffic.join(timeout=120)
        record["post_sweep_restarted"] = traffic.sweep()
        record["verdicts"] = [verify_verdict(train_wd, p) for p in status.get("verdicts", [])]
        record["replicas"] = replica_records(url)
        scrape = urllib.request.urlopen(urllib.request.Request(
            url + "/metrics", headers={"Accept": "text/plain"}), timeout=60.0).read().decode()
        record["deploy_scrape_lines"] = sorted(
            line for line in scrape.splitlines() if line.startswith("rt1_deploy_"))[:24]
    finally:
        if traffic is not None:
            traffic.stop_evt.set()
            traffic.join(timeout=120)
        out = stop_and_collect(proc)
        stderr.close()
    final = final_line(out)
    assert final is not None, "fleet printed no final record"
    record["fleet_exit_code"] = proc.returncode
    record["final_deploy"] = final["deploy"]
    record["final_slo"] = final["slo"]
    record["traffic"] = {
        "requests_ok": traffic.ok,
        "failures": traffic.failures,
        "restarts": traffic.restarts,
        "sessions_created": len(traffic.sessions),
    }
    return record


def events(record):
    return [e["event"] for e in record["timeline"]]


def assert_common(record):
    assert record["fleet_exit_code"] == 0, record["fleet_exit_code"]
    assert not record["traffic"]["failures"], record["traffic"]["failures"]
    assert record["traffic"]["requests_ok"] > 0
    by_class = record["final_slo"]["by_class"]
    assert by_class.get("failed", {}).get("count", 0) == 0, by_class
    for rep in record["replicas"]:
        assert rep["state"] == "ready", rep
        assert rep["compile_count"] == rep["bucket_count"], rep
    for v in record["verdicts"]:
        assert v["signature_ok"], v


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m rt1_tpu_torch.deploy.loop",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="tiny", help="language_table | tiny")
    p.add_argument("--device", default="cuda", help="cuda | cpu")
    p.add_argument("--workdir", default="/tmp/rt1_deploy")
    p.add_argument("--bench_out", default=None,
                   help="The record's path (default <workdir>/BENCH_deploy.json).")
    p.add_argument("--episodes", type=int, default=8, help="Synthetic corpus episodes.")
    p.add_argument("--episode_steps", type=int, default=8)
    p.add_argument("--gate_tasks", default="block2block",
                   help="Gate eval-matrix task list (comma separated).")
    p.add_argument("--gate_episodes", type=int, default=1)
    p.add_argument("--gate_max_steps", type=int, default=6)
    p.add_argument("--wait_s", type=float, default=1800.0,
                   help="Per-episode budget for gate+canary+verdict.")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)

    from rt1_tpu_torch import resolve_device
    from rt1_tpu_torch.configs import get_config
    from rt1_tpu_torch.data import pack as pack_lib

    resolve_device(args.device)
    config = get_config(args.config)
    height, width = config.data.height, config.data.width
    t_start = time.perf_counter()
    wd = os.path.abspath(args.workdir)
    shutil.rmtree(wd, ignore_errors=True)
    if args.bench_out is None:
        args.bench_out = os.path.join(wd, "BENCH_deploy.json")
    data_dir = os.path.join(wd, "data")
    log_dir = os.path.join(wd, "logs")
    train_wd = os.path.join(wd, "train")
    for d in (data_dir, log_dir, train_wd):
        os.makedirs(d, exist_ok=True)
    args.data_dir = data_dir

    bench = {
        "bench": "deploy_e2e",
        "description": (
            f"Continuous-deployment cycle on a real two-replica {args.config} "
            "fleet: a freshly trained checkpoint passes the offline "
            "eval+parity gate, canaries behind the weighted session "
            "split, and is promoted fleet-wide; a second candidate with "
            "an injected canary SLO burn is auto-rolled-back with "
            "sessions re-homed (restarted: true), zero failed requests "
            f"and the compile-count invariant intact throughout ({args.device})."
        ),
        "config": {
            "corpus_episodes": args.episodes,
            "episode_steps": args.episode_steps,
            "gate_tasks": args.gate_tasks,
            "gate_episodes": args.gate_episodes,
            "gate_max_steps": args.gate_max_steps,
            "geometry": [height, width],
        },
    }

    # ---- Corpus + first checkpoint (the incumbent).
    paths = build_corpus(data_dir, args.episodes, args.episode_steps, height, width,
                         task="deploy_corpus")
    pack_dir = pack_lib.default_pack_dir(data_dir, "train")
    pack_lib.pack_episodes(paths, pack_dir, height, width, config.data.crop_factor)
    t0 = time.perf_counter()
    train_to(args.config, args.device, train_wd, data_dir, 2, os.path.join(log_dir, "train.log"))
    bench["train_seed_seconds"] = round(time.perf_counter() - t0, 1)
    print(json.dumps({"phase": "incumbent_trained"}), flush=True)

    # ---- Episode 1: good candidate -> canary -> fleet-wide promote.
    good = _fleet_episode("promote", args, train_wd, log_dir, height, width, faults="",
                          clean_window_ticks=4, next_train_steps=4, wait_s=args.wait_s)
    assert_common(good)
    assert good["terminal_event"]["event"] == "promoted", good["terminal_event"]
    assert good["final_deploy"]["promotions_total"] == 1
    assert good["final_deploy"]["rollbacks_total"] == 0
    incumbent_0 = good["ready"]["deploy"]["incumbent_step"]
    promoted_step = good["terminal_event"]["step"]
    assert promoted_step > incumbent_0
    assert good["final_deploy"]["incumbent_step"] == promoted_step
    # Promote keeps sessions: nothing was orphaned, nothing restarted.
    assert not good["traffic"]["restarts"], good["traffic"]["restarts"]
    assert not good["post_sweep_restarted"]
    assert "gate_passed" in events(good)
    assert any(v["passed"] for v in good["verdicts"])
    bench["promote"] = good
    print(json.dumps({"phase": "promote_done", "step": promoted_step}), flush=True)

    # ---- Episode 2: next candidate burns its canary SLO -> rollback.
    bad = _fleet_episode("rollback", args, train_wd, log_dir, height, width,
                         faults="canary_slo_breach@4", clean_window_ticks=12,
                         next_train_steps=6, wait_s=args.wait_s)
    assert_common(bad)
    assert bad["terminal_event"]["event"] == "rolled_back", bad["terminal_event"]
    assert bad["terminal_event"]["reason"] == "slo_breach_injected"
    assert bad["ready"]["deploy"]["incumbent_step"] == promoted_step
    assert bad["final_deploy"]["rollbacks_total"] == 1
    assert bad["final_deploy"]["promotions_total"] == 0
    # The incumbent never moved, and the demoted replica restored it.
    assert bad["final_deploy"]["incumbent_step"] == promoted_step
    restore = bad["terminal_event"]["restore"]
    assert restore["status"] == 200, restore
    assert restore["checkpoint_step"] == promoted_step, restore
    # Re-homing evidence: at least one canary-bound session surfaced
    # `restarted: true` (in the live loop or the post-rollback sweep).
    rehomed = len(bad["traffic"]["restarts"]) + len(bad["post_sweep_restarted"])
    assert rehomed >= 1, (bad["traffic"]["restarts"], bad["post_sweep_restarted"])
    bench["rollback"] = bad
    print(json.dumps({"phase": "rollback_done", "rehomed": rehomed}), flush=True)

    bench["total_seconds"] = round(time.perf_counter() - t_start, 1)
    bench["verdict"] = "deploy_cycle_proven"
    tmp = args.bench_out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(bench, f, indent=2, sort_keys=True)
    os.replace(tmp, args.bench_out)
    print(json.dumps({"phase": "done", "bench_out": args.bench_out,
                      "total_seconds": bench["total_seconds"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
