"""The metrics plane's chaos proof (counterpart of
`scripts/obs_alerts_proof.py`): `python -m rt1_tpu_torch.obs.alerts_proof`.

Four phases against `python -m rt1_tpu_torch.serve.fleet` fleets (3
replicas; the collector armed where stated), with the JAX script's
expected sets and `--out` schema:

* **replica_kill** — `replica_kill@2` SIGKILLs a replica mid-traffic. The
  armed plane must fire ReplicaDown and the multi-window burn pair (the
  orphaned sessions' `restarted` re-homes spend error budget), then
  resolve all three once the victim is respawned and clean traffic
  decays the windowed burn: exactly `KILL_EXPECTED`. Detection latency
  runs from the watcher's first sight of `rt1_serve_replica_up 0` to
  each alert's firing time.
* **canary_breach** — `canary_slo_breach@1` condemns the first canary of
  a deploy cycle: CanarySLOBreach (`rt1_deploy_canary_burn`) must fire
  and resolve on the rollback, exactly `CANARY_EXPECTED`, while the
  request-indexed rolling burn of the clean traffic never crosses 2.
* **overhead** — `/act` latency with the collector off and on, the two
  fleets side by side, batches in turns. A reading, not a bound: unlike
  the JAX script's, its `within_2pct` does not decide `passed`, and
  `--overhead_acts` counts acts an arm (JAX's counts rounds of 60).
* **byte_identity** — an unarmed fleet 404s `/alerts`, `/history` and
  `/dashboard` and exposes no `rt1_alert_*` or `rt1_obs_collector_*`
  family.

Each phase is a function of fleets that are already running
(`phase_replica_kill(fleet, stop)`, ...), so a caller that boots its own
fleet can run it there; `replica_kill` is also split into its steps
(`Watcher`, `await_kill`, `touch`, `await_firing`, `decay`, `await_quiet`,
`kill_record`)
for a caller that interleaves checks of its own.

Replicas are real torch replicas of `--config` on `--device` (`cuda`
unless `--device cpu` is given), or with `--stub` the stub replicas the
JAX script uses. Without `--out` the record is printed and written
nowhere; the repository's `BENCH_obs_alerts.json` is the JAX package's.

    python -m rt1_tpu_torch.obs.alerts_proof --stub --out /tmp/obs_alerts.json
    python -m rt1_tpu_torch.obs.alerts_proof --config language_table
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

KILL_EXPECTED = {"ReplicaDown", "SLOBurnRateFast", "SLOBurnRateSlow"}
CANARY_EXPECTED = {"CanarySLOBreach"}
BURN_CROSSING = 2.0          # the rolling burn the canary's clean traffic must stay under
REPLICAS = 3
KILL_SESSIONS = 12           # placed before the kill: the victim's re-homes are the burn
DECAY_ACTS = 650             # clean acts that decay the windowed burn
CANARY_SESSIONS = 6          # the canary phase's clean traffic
OVERHEAD_BATCH = 60          # acts an arm a round of the overhead A/B
ACT_TIMEOUT_S = 120.0
WARMUP_TIMEOUT_S = 600.0     # a real replica's boot

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# ------------------------------------------------------------------ plumbing


def get(url: str, path: str, accept: Optional[str] = None, timeout: float = 5.0):
    """(status, text) of a GET; an HTTP error's body included."""
    req = urllib.request.Request(url + path, headers={"Accept": accept} if accept else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read().decode("utf-8")
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode("utf-8")


def stub_body(session_id: str) -> Dict:
    """The JAX script's `/act` body for a stub replica."""
    return {"session_id": session_id, "image_b64": "AAAA"}


def frame_body(height: int, width: int) -> Callable[[str], Dict]:
    """`/act` bodies for real replicas: one seeded uint8 frame of the
    config's size and an instruction, for any session."""
    import numpy as np

    frame = np.random.default_rng(0).integers(0, 256, (height, width, 3), np.uint8)
    image_b64 = base64.b64encode(frame.tobytes()).decode("ascii")

    def body(session_id: str) -> Dict:
        return {"session_id": session_id, "image_b64": image_b64,
                "instruction": "push the red star to the blue cube"}

    return body


class Fleet:
    """A serving fleet at `url`: `act` posts one `/act` built by `body`;
    `proc`, when this process started the fleet, is what `stop` signals."""

    def __init__(self, url: str, body: Callable[[str], Dict] = stub_body, proc=None):
        self.url, self.body, self.proc = url, body, proc

    def act(self, session_id: str):
        """(seconds, reply) of one `/act`."""
        req = urllib.request.Request(self.url + "/act",
                                     data=json.dumps(self.body(session_id)).encode(),
                                     headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=ACT_TIMEOUT_S) as resp:
            payload = json.loads(resp.read())
        return time.perf_counter() - t0, payload

    def stop(self) -> Dict:
        """SIGTERM and drain: the fleet's final status line."""
        self.proc.send_signal(signal.SIGTERM)
        out, _ = self.proc.communicate(timeout=180)
        return json.loads(out.strip().splitlines()[-1])

    def kill(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)


@dataclass
class FleetSpec:
    """How `spawn` starts fleets of `REPLICAS`: stub replicas, or real bf16
    replicas of `config` on `device`."""
    stub: bool = True
    config: str = "language_table"
    device: str = "cuda"

    def body(self) -> Callable[[str], Dict]:
        if self.stub:
            return stub_body
        sys.path.insert(0, REPO)
        from rt1_tpu_torch.configs import get_config

        data = get_config(self.config).data
        return frame_body(data.height, data.width)

    def argv(self, extra) -> List[str]:
        argv = [sys.executable, "-m", "rt1_tpu_torch.serve.fleet", "--replicas",
                str(REPLICAS), "--port", "0", "--poll_interval_s", "0.1",
                "--warmup_timeout_s", str(WARMUP_TIMEOUT_S)]
        if self.stub:
            argv.append("--stub")
        else:
            argv += ["--config", self.config, "--device", self.device,
                     "--inference_dtype", "bf16"]
            if "--workdir" not in extra:
                argv.append("--random_init")
        return argv + list(extra)


def spawn(spec: FleetSpec, extra=()) -> Fleet:
    """Start a fleet and wait for its ready line."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("RT1_FAULTS", None)
    proc = subprocess.Popen(spec.argv(extra), stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True, env=env, cwd=REPO)
    deadline = time.monotonic() + WARMUP_TIMEOUT_S
    for line in proc.stdout:
        try:
            ready = json.loads(line)
        except json.JSONDecodeError:
            continue
        if ready.get("status") == "serving":
            return Fleet(f"http://{ready['host']}:{ready['port']}", spec.body(), proc)
        if time.monotonic() > deadline:
            break
    proc.kill()
    raise RuntimeError("the fleet never printed its ready line")


class Watcher(threading.Thread):
    """Polls `/metrics` (text) and `/alerts` every `interval_s`, keeping
    the wall time each signal was first seen (the detection clock) and
    the largest request-indexed rolling burn."""

    def __init__(self, url: str, interval_s: float = 0.1):
        super().__init__(daemon=True)
        self.url, self.interval_s = url, interval_s
        self.first_seen: Dict[str, float] = {}
        self.max_rolling_burn = 0.0
        self._halt = threading.Event()

    def note(self, key: str) -> None:
        self.first_seen.setdefault(key, time.time())

    def poll(self) -> None:
        _, text = get(self.url, "/metrics", accept="text/plain")
        for line in text.splitlines():
            if line.startswith("rt1_serve_replica_up{") and line.endswith(" 0"):
                self.note("replica_down_observed")
            if line.startswith("rt1_deploy_canary_burn ") and float(line.split()[-1]) >= 1.0:
                self.note("canary_burn_observed")
            if line.startswith("rt1_serve_slo_error_budget_burn_rolling "):
                self.max_rolling_burn = max(self.max_rolling_burn, float(line.split()[-1]))
        _, body = get(self.url, "/alerts")
        for alert in json.loads(body).get("active", []):
            if alert["state"] == "firing":
                self.note(f"firing:{alert['alert']}")

    def run(self) -> None:
        while not self._halt.is_set():
            try:
                self.poll()
            except (OSError, ValueError):  # a scrape during the kill may fail
                pass
            self._halt.wait(self.interval_s)

    def stop(self) -> None:
        self._halt.set()
        self.join(timeout=5)


def event_summary(alert_events) -> Dict[str, Dict]:
    """Fired / resolved counts and the first firing time of each alert, from
    the fleet's final alert event stream."""
    out: Dict[str, Dict] = {}
    for ev in alert_events:
        entry = out.setdefault(ev["alert"], {"fired": 0, "resolved": 0, "first_fired_t": None})
        if ev["event"] == "firing":
            entry["fired"] += 1
            if entry["first_fired_t"] is None:
                entry["first_fired_t"] = ev["t"]
        else:
            entry["resolved"] += 1
    return out


def _alerts_active(url: str) -> list:
    return json.loads(get(url, "/alerts")[1])["active"]


# ------------------------------------------------------------ replica_kill


def await_kill(fleet: Fleet, timeout_s: float = 30.0) -> bool:
    """Wait, sending no traffic, until a replica has been restarted (the
    supervisor's latch, which a short down window cannot hide)."""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        replicas = json.loads(get(fleet.url, "/fleet/status")[1]).get("replicas", [])
        if any(r.get("restarts", 0) > 0 for r in replicas):
            return True
        time.sleep(0.1)
    return False


def touch(fleet: Fleet, sessions, tries: int = 3) -> Dict[str, bool]:
    """Act every session until some answer `restarted` (at most `tries`
    passes); returns each session's last `restarted` flag that was set."""
    restarted: Dict[str, bool] = {}
    for _ in range(tries):
        for sid in sessions:
            _, body = fleet.act(sid)
            restarted[sid] = restarted.get(sid, False) or bool(body.get("restarted"))
        if any(restarted.values()):
            break
        time.sleep(0.2)
    return restarted


def decay(fleet: Fleet, sessions, acts: int) -> None:
    """`acts` clean acts over `sessions`, each session's in order and the
    sessions at once: they shrink the windowed failure fraction below
    both burn thresholds (fast 8, slow 2)."""
    share = [acts // len(sessions) + (i < acts % len(sessions)) for i in range(len(sessions))]
    errors: List[BaseException] = []

    def drive(sid, n):
        try:
            for _ in range(n):
                fleet.act(sid)
        except (OSError, ValueError) as exc:
            errors.append(exc)

    threads = [threading.Thread(target=drive, args=(sid, n)) for sid, n in zip(sessions, share)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError(f"decay: {len(errors)} sessions failed, first: {errors[0]!r}")


def await_firing(watcher: Watcher, alerts, timeout_s: float = 15.0) -> bool:
    """Wait until the watcher has seen each of `alerts` firing: the clean
    traffic that decays the burn comes after the collector saw it."""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if all(f"firing:{name}" in watcher.first_seen for name in alerts):
            return True
        time.sleep(0.05)
    return False


def await_quiet(fleet: Fleet, timeout_s: float = 45.0) -> bool:
    """Wait until no alert is pending or firing."""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if not _alerts_active(fleet.url):
            return True
        time.sleep(0.25)
    return False


def kill_record(final: Dict, watcher: Watcher, t_armed: float, restarted: int,
                faults: str = "replica_kill@2") -> Dict:
    """The replica_kill phase's record from the fleet's final status."""
    events = event_summary(final["obs"]["alert_events"])
    fired = set(events)
    down_seen = watcher.first_seen.get("replica_down_observed")
    base = down_seen if down_seen is not None else t_armed
    latencies = {name: round(events[name]["first_fired_t"] - base, 3) for name in sorted(fired)}
    ok = fired == KILL_EXPECTED and all(e["resolved"] >= e["fired"] for e in events.values()) \
        and not final["obs"]["alerts"]["active"]
    return {
        "faults": faults,
        "expected_alerts": sorted(KILL_EXPECTED),
        "fired_alerts": sorted(fired),
        "events": events,
        "all_resolved": not final["obs"]["alerts"]["active"],
        "restarted_responses": restarted,
        "detection_latency_s": latencies,
        "driver_first_saw_replica_down_s_after_arm": (
            round(down_seen - t_armed, 3) if down_seen is not None else None),
        "collector": final["obs"]["collector"],
        "passed": ok,
    }


def phase_replica_kill(fleet: Fleet, stop: Callable[[], Dict]) -> Dict:
    """On a running fleet armed with the collector and `replica_kill@2`:
    place the sessions, wait for the kill, re-home the victim's sessions,
    decay the burn, wait for every alert to resolve, then `stop()` the
    fleet (its final status) and judge the alert events."""
    sessions = [f"k{i}" for i in range(KILL_SESSIONS)]
    watcher = Watcher(fleet.url)
    try:
        for sid in sessions:  # each session on a replica before the kill
            fleet.act(sid)
        watcher.start()
        t_armed = time.time()
        # No traffic until the kill: clean requests here would dilute the
        # windowed failure fraction below the burn thresholds.
        await_kill(fleet)
        restarted = sum(touch(fleet, sessions).values())
        await_firing(watcher, ("SLOBurnRateFast", "SLOBurnRateSlow"))
        decay(fleet, sessions, DECAY_ACTS)
        await_quiet(fleet)
        final = stop()
    finally:
        watcher.stop()
    return kill_record(final, watcher, t_armed, restarted)


# ----------------------------------------------------------- canary_breach


def canary_record(final: Dict, watcher: Watcher, faults: str = "canary_slo_breach@1") -> Dict:
    """The canary_breach phase's record from the fleet's final status."""
    events = event_summary(final["obs"]["alert_events"])
    fired = set(events)
    burn_seen = watcher.first_seen.get("canary_burn_observed")
    t_fire = events.get("CanarySLOBreach", {}).get("first_fired_t")
    ok = (fired == CANARY_EXPECTED and final["deploy"]["rollbacks_total"] == 1
          and not final["obs"]["alerts"]["active"]
          # The request-indexed rolling view never crossed: only the
          # time-indexed plane saw the breach.
          and watcher.max_rolling_burn < BURN_CROSSING)
    return {
        "faults": faults,
        "expected_alerts": sorted(CANARY_EXPECTED),
        "fired_alerts": sorted(fired),
        "events": events,
        "all_resolved": not final["obs"]["alerts"]["active"],
        "rollbacks_total": final["deploy"]["rollbacks_total"],
        "detection_latency_s": (round(t_fire - burn_seen, 3)
                                if t_fire is not None and burn_seen is not None else None),
        "request_indexed_rolling_burn_max": round(watcher.max_rolling_burn, 4),
        "rolling_view_ever_crossed_threshold": watcher.max_rolling_burn >= BURN_CROSSING,
        "passed": ok,
    }


def place_off_canary(fleet: Fleet, n: int) -> List[str]:
    """`n` sessions homed off the replica the controller will canary (the
    highest-id ready one, `deploy/controller.py::_pick_canary`): the
    rollback re-homes every session on the canary with `restarted`, a real
    SLO failure, so the clean traffic keeps off it. Sessions placed on it
    here are never acted again."""
    replicas = json.loads(get(fleet.url, "/fleet/status")[1])["replicas"]
    canary = max(r["id"] for r in replicas if r["state"] == "ready")
    sessions: List[str] = []
    for i in range(8 * n):
        _, body = fleet.act(f"c{i}")
        if body.get("replica_id") != canary:
            sessions.append(f"c{i}")
        if len(sessions) == n:
            return sessions
    raise RuntimeError(f"could not place {n} sessions off replica {canary}")


def phase_canary_breach(fleet: Fleet, stop: Callable[[], Dict],
                        publish_candidate: Callable[[], None], timeout_s: float = 45.0) -> Dict:
    """On a running fleet armed with the collector, `--promote_from` and
    `canary_slo_breach@1`: place the sessions off the replica to be
    canaried, publish a candidate, keep clean traffic flowing until
    it is rolled back and no alert is active, then `stop()` the fleet and
    judge."""
    watcher = Watcher(fleet.url)
    try:
        sessions = place_off_canary(fleet, CANARY_SESSIONS)
        watcher.start()
        publish_candidate()
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            for sid in sessions:  # clean traffic throughout
                fleet.act(sid)
            rollbacks = json.loads(get(fleet.url, "/deploy/status")[1]).get("rollbacks_total", 0)
            if rollbacks and not _alerts_active(fleet.url):
                break
            time.sleep(0.2)
        final = stop()
    finally:
        watcher.stop()
    return canary_record(final, watcher)


def _stub_checkpoint(workdir: str, step: int) -> None:
    """A checkpoint directory the stub fleet's watcher takes as a step
    (the port's layout: `<workdir>/checkpoints/<step>/state.pt`)."""
    directory = os.path.join(workdir, "checkpoints", str(step))
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "state.pt"), "w") as f:
        f.write("x")


# --------------------------------------------------------------- overhead


def timed_traffic(fleet: Fleet, n_acts: int) -> List[float]:
    return [fleet.act(f"o{i % 16}")[0] for i in range(n_acts)]


def phase_overhead(fleet_off: Fleet, fleet_on: Fleet, rounds: int) -> Dict:
    """`/act` latency, collector off vs on, in alternating batches on two
    running fleets (so host drift lands on both arms)."""
    lat = {"off": [], "on": []}
    timed_traffic(fleet_off, 40)  # warm connections and session slots
    timed_traffic(fleet_on, 40)
    for _ in range(rounds):
        lat["off"].extend(timed_traffic(fleet_off, OVERHEAD_BATCH))
        lat["on"].extend(timed_traffic(fleet_on, OVERHEAD_BATCH))
    out: Dict = {}
    for arm in ("off", "on"):
        values = lat[arm]
        out[arm] = {
            "acts": len(values),
            "median_ms": round(statistics.median(values) * 1e3, 4),
            "mean_ms": round(statistics.fmean(values) * 1e3, 4),
            "p99_ms": round(sorted(values)[max(0, int(len(values) * 0.99) - 1)] * 1e3, 4),
        }
    overhead_pct = round((out["on"]["median_ms"] - out["off"]["median_ms"])
                         / out["off"]["median_ms"] * 100.0, 3)
    out["overhead_pct_median"] = overhead_pct
    out["within_2pct"] = overhead_pct <= 2.0
    return out


# ----------------------------------------------------------- byte_identity


def phase_byte_identity(fleet: Fleet) -> Dict:
    """An unarmed running fleet: every ops surface 404s and no alert or
    collector family is exposed."""
    for i in range(4):
        fleet.act(f"b{i}")
    surfaces = {path: get(fleet.url, path)[0] for path in ("/alerts", "/history", "/dashboard")}
    _, text = get(fleet.url, "/metrics", accept="text/plain")
    leaked = sorted({line.split("{")[0].split()[-1] for line in text.splitlines()
                     if line.startswith("# TYPE rt1_alert_")
                     or line.startswith("# TYPE rt1_obs_collector_")})
    return {"unarmed_surface_status": surfaces, "unarmed_obs_families_leaked": leaked,
            "passed": all(code == 404 for code in surfaces.values()) and not leaked}


def run_overhead_and_identity(spec: FleetSpec, rounds: int) -> Dict:
    """The overhead and byte_identity phases on fleets of `spec` started
    and stopped here."""
    fleets = []
    try:
        fleets.append(spawn(spec))
        fleets.append(spawn(spec, ["--collector", "--collector_interval_s", "0.25"]))
        overhead = phase_overhead(fleets[0], fleets[1], rounds)
        identity = phase_byte_identity(fleets[0])
        for fleet in fleets:
            fleet.stop()
    finally:
        for fleet in fleets:
            fleet.kill()
    return {"overhead": overhead, "byte_identity": identity}


# -------------------------------------------------------------------- main


class _CanaryWorkdir:
    """The deploy workdir of the canary phase: stub checkpoints 2 and 4, or
    for real replicas a packed seed corpus and the train CLI to steps 2
    and 4 (the incumbent, then the candidate)."""

    def __init__(self, root: str, spec: FleetSpec):
        self.spec, self.workdir = spec, os.path.join(root, "train")
        self.log = os.path.join(root, "train.log")
        if spec.stub:
            _stub_checkpoint(self.workdir, 2)
            return
        from rt1_tpu_torch.configs import get_config
        from rt1_tpu_torch.data import pack as pack_lib
        from rt1_tpu_torch.data.episodes import write_manifest
        from rt1_tpu_torch.deploy.loop import train_to
        from rt1_tpu_torch.flywheel.loop import build_corpus

        data = get_config(spec.config).data
        self.data_dir = os.path.join(root, "data")
        paths = build_corpus(self.data_dir, 4, 12, data.height, data.width)
        write_manifest(self.data_dir, embedder="hash", episodes=4)
        pack_lib.pack_episodes(paths, pack_lib.default_pack_dir(self.data_dir, "train"),
                               data.height, data.width, data.crop_factor)
        train_to(spec.config, spec.device, self.workdir, self.data_dir, 2, self.log)

    def fleet_flags(self) -> List[str]:
        flags = ["--promote_from", self.workdir]
        if not self.spec.stub:
            flags += ["--workdir", self.workdir, "--gate_tasks", "block2block",
                      "--gate_episodes", "1", "--gate_max_steps", "10"]
        return flags

    def publish_candidate(self) -> None:
        if self.spec.stub:
            _stub_checkpoint(self.workdir, 4)
        else:
            from rt1_tpu_torch.deploy.loop import train_to

            train_to(self.spec.config, self.spec.device, self.workdir, self.data_dir, 4, self.log)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="", help="Write the record here as well.")
    parser.add_argument("--overhead_acts", type=int, default=400,
                        help="Acts an arm of the overhead A/B, in rounds of 60.")
    parser.add_argument("--stub", action="store_true", help="Stub replicas (no torch).")
    parser.add_argument("--config", default="language_table",
                        help="The real replicas' config (bf16).")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu.")
    args = parser.parse_args(argv)
    spec = FleetSpec(stub=args.stub, config=args.config, device=args.device)
    if not spec.stub:
        sys.path.insert(0, REPO)
        from rt1_tpu_torch import resolve_device

        resolve_device(args.device)  # no card and no --device cpu: refuse before any boot
    with tempfile.TemporaryDirectory(prefix="rt1_alerts_proof_") as root:
        # Real replicas take longer to place the sessions before the kill.
        fleet = spawn(spec, ["--collector", "--collector_interval_s", "0.25",
                             "--chaos_interval_s", "1.0" if spec.stub else "10.0",
                             "--faults", "replica_kill@2"])
        try:
            kill = phase_replica_kill(fleet, fleet.stop)
        finally:
            fleet.kill()
        workdir = _CanaryWorkdir(root, spec)
        fleet = spawn(spec, ["--collector", "--collector_interval_s", "0.2",
                             *workdir.fleet_flags(), "--deploy_poll_interval_s", "0.3",
                             "--breach_ticks", "3", "--min_canary_requests", "1",
                             "--canary_weight", "0.5", "--burn_threshold", "2.0",
                             "--faults", "canary_slo_breach@1"])
        try:
            canary = phase_canary_breach(fleet, fleet.stop, workdir.publish_candidate)
        finally:
            fleet.kill()
    rest = run_overhead_and_identity(spec, rounds=-(-args.overhead_acts // OVERHEAD_BATCH))
    record = {
        "bench": "obs_alerts",
        "description": (
            "Metrics-plane chaos proof on 3-replica fleets of the PyTorch port "
            f"({'stub' if spec.stub else spec.config + ' on ' + spec.device} replicas): "
            "replica_kill fires and resolves exactly {ReplicaDown, SLOBurnRateFast, "
            "SLOBurnRateSlow}; an injected canary SLO breach fires CanarySLOBreach off "
            "the rt1_deploy_canary_burn gauge while the request-indexed rolling burn "
            "never crosses; the collector's /act overhead (a reading); an unarmed fleet "
            "404s every ops surface and leaks no rt1_alert_*/rt1_obs_collector_* family."),
        "replica_kill": kill,
        "canary_breach": canary,
        **rest,
    }
    # The overhead is a reading: it does not decide `passed`.
    record["passed"] = all(record[k]["passed"]
                           for k in ("replica_kill", "canary_breach", "byte_identity"))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=2, sort_keys=True)
            f.write("\n")
    print(json.dumps(record, sort_keys=True), flush=True)
    return 0 if record["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
