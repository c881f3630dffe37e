"""Fleet supervisor: spawn, watch, restart, and chaos-test serving replicas.

The port's copy of `rt1_tpu/serve/fleet.py` (the port imports nothing of the
JAX package); it keeps the JAX module's names, flags and behaviour, and its
replicas are the port's.

`python -m rt1_tpu_torch.serve.fleet --replicas 2 --config language_table
--random_init` brings up N replica processes (`python -m rt1_tpu_torch.serve`
on `--device`, the card unless `--device cpu`; or the model-free stub
`python -m rt1_tpu_torch.serve.stub` with `--stub`), fronts them with the
session-affine `Router` (`serve/router.py`), and runs a supervision loop:

* **Warm-up gating.** A spawned replica is routable only after it prints
  the ready-line (which carries its ephemeral port) AND its `/readyz`
  returns 200 — a replica still importing torch, building the attention
  kernel or warming its buckets never sees traffic, on first boot and on
  every restart alike.
* **Death and hang detection.** Every poll cycle checks `proc.poll()`
  (crash/kill) and probes `/readyz`. A process that is alive to the OS but
  black-holing probes (`replica_hang` chaos = SIGSTOP, a wedged runtime in
  production) accumulates consecutive probe failures and is SIGKILLed and
  respawned — SIGKILL because a stopped process cannot run a SIGTERM
  handler. Either way the router orphans its sessions immediately; their
  next `/act` re-homes with ``"restarted": true``.
* **Deterministic chaos.** The supervisor consults the fault registry
  (`resilience/faults.py`, sites `replica_kill` / `replica_hang` /
  `serve_reload`) once per **chaos tick** — one tick every
  `chaos_interval_s`, counted only after the fleet first reports
  all-ready, with the tick ordinal as the fault index. Same plan, same
  failure schedule, every run: `replica_kill@1,serve_reload@2` always
  kills at tick 1 and rolls a reload at tick 2. Victim selection is
  deterministic too (lowest-id ready replica).
* **Elastic autoscaling** (`--min_replicas`/`--max_replicas`). Once per
  `--autoscale_interval_s` the supervisor feeds router-observed signals
  (windowed session occupancy, in-flight depth, admission sheds, SLO
  rolling burn) to the hysteretic `serve/autoscale.py` policy — scale up
  fast, down slow. Scale-up boots a **surge-tier** replica at
  `--surge_dtype` on a never-reused id; scale-down picks the highest-id
  surge replica, live-migrates its sessions, de-places it, grants a grace
  window for in-flight acts, SIGTERMs (the replica's own drain: flush,
  exit 0), reaps, and purges the id from every routing and metrics map —
  no ghost replicas on later scrapes. Every replica lifetime accrues into
  a per-dtype replica-second ledger; weighted by `DTYPE_COST_WEIGHTS` it
  becomes the fleet's cost units.

* **Metrics plane** (`--collector`). An in-process collector scrapes the
  fleet's own `/metrics` fan-out (and `/deploy/status` when promotion is
  armed) into a bounded ring TSDB every `--collector_interval_s`,
  evaluates the default alert ruleset (multi-window SLO burn, replica
  loss, compile drift, flap/storm detectors) after each cycle, and lights
  up `/alerts`, `/history` and `/dashboard` on the router port. Firing
  alerts land in the same evidence stream as the slow-request exemplars;
  on shutdown the TSDB snapshots into `<obs_dir>/tsdb_snapshot.jsonl`.
  Unarmed, every surface is byte-identical to the fleet without it.
* **Flywheel capture** (`--capture_dir`). Each real replica captures its
  served sessions as episodes under `<capture_dir>/replica_<id>`; the
  scrape loop sweeps completed files into `<capture_dir>/staging`, the
  one directory `data/pack.py::append_shard` packs from.
* **Continuous deployment** (`--promote_from`, `deploy/`). A controller
  watches the train workdir for new checkpoints, gates each offline (the
  eval matrix against the incumbent, then the serving parity check, on
  `--device`), canaries a passing one onto one replica at
  `--canary_weight`, promotes it fleet-wide by rolling reload after a
  clean burn window, and rolls it back on a breach. Stub fleets auto-pass
  the gate.

The supervisor owns processes, the router owns routing state; they meet at
the shared `Replica` objects. The supervisor and the router import neither
torch nor JAX; only a non-stub fleet imports torch, once, to check that its
`--device` exists.
"""

from __future__ import annotations

import collections
import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from rt1_tpu_torch.resilience import faults
from rt1_tpu_torch.serve.autoscale import (
    Autoscaler,
    AutoscalePolicy,
    FleetSignals,
)
from rt1_tpu_torch.serve.router import (
    DEAD,
    NOTREADY,
    READY,
    STARTING,
    TIER_BASE,
    TIER_SURGE,
    AdmissionController,
    Replica,
    Router,
    get_json,
    make_router_server,
)

#: The port's flagship (`language_table`) serving-tree bytes per inference
#: dtype: f32 and bf16 from `models/quant.py::quant_byte_report`, int8 as
#: the port holds it (int8 weights with a float32 scale per output channel,
#: every other leaf at bf16), which is what `tree_bytes` reads off the
#: engine on the card. `tests/test_torch_fleet.py` derives all three from a
#: meta-device flagship policy.
FLAGSHIP_PARAM_BYTES = {"f32": 141_120_128, "bf16": 70_560_064, "int8": 36_479_528}

#: Relative per-replica-second cost weight by inference dtype, proportional
#: to those device-resident bytes: an int8 surge replica-second costs
#: 0.2585 of an f32 one, a bf16 one 0.5.
DTYPE_COST_WEIGHTS = {
    dtype: nbytes / FLAGSHIP_PARAM_BYTES["f32"]
    for dtype, nbytes in FLAGSHIP_PARAM_BYTES.items()
}


class FleetSupervisor:
    """Owns N replica subprocesses on behalf of a Router."""

    def __init__(
        self,
        router: Router,
        spawn_argv_fn: Callable[[int], List[str]],
        n_replicas: int,
        *,
        poll_interval_s: float = 0.25,
        chaos_interval_s: float = 2.0,
        warmup_timeout_s: float = 600.0,
        hang_probe_failures: int = 3,
        probe_timeout_s: float = 2.0,
        max_restarts: int = 50,
        log_dir: Optional[str] = None,
        extra_env: Optional[Dict[str, str]] = None,
        exemplar_scrape_interval_s: float = 2.0,
        autoscale: Optional[AutoscalePolicy] = None,
        autoscale_interval_s: float = 1.0,
        max_sessions: int = 8,
        surge_dtype: Optional[str] = None,
        base_dtype_fn: Optional[Callable[[int], str]] = None,
        reclaim_grace_s: float = 0.5,
        reclaim_timeout_s: float = 30.0,
        capture_root: Optional[str] = None,
    ):
        self.router = router
        self._spawn_argv_fn = spawn_argv_fn
        self.n_replicas = n_replicas
        self.poll_interval_s = poll_interval_s
        self.chaos_interval_s = chaos_interval_s
        self.warmup_timeout_s = warmup_timeout_s
        self.hang_probe_failures = hang_probe_failures
        self.probe_timeout_s = probe_timeout_s
        self.max_restarts = max_restarts
        self.log_dir = log_dir
        self.extra_env = extra_env
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._scrape_thread: Optional[threading.Thread] = None
        # Chaos bookkeeping (summary + determinism evidence). Mutated only
        # on the single supervisor thread; readers (summary, tests)
        # tolerate a stale int — no lock needed or implied.
        self.chaos_tick = 0
        self._fleet_was_ready = False
        self.kills_injected = 0
        self.hangs_injected = 0
        self.reloads_injected = 0
        self.restarts_total = 0
        # Slow-request exemplars, scraped from each live replica's
        # GET /slow_requests on a slow cadence. A SIGKILLed replica never
        # runs its drain-time dump, so the supervisor's last scrape is
        # the only copy of "what the victim was serving when it died" —
        # the serve-side flight-recorder semantics the post-mortem needs.
        self.exemplar_scrape_interval_s = exemplar_scrape_interval_s
        # Written by the scrape thread, read by slow_request_evidence()
        # (fleet main's final status line, while the scraper still runs).
        self._exemplar_lock = threading.Lock()
        self.last_exemplars: Dict[int, Dict[str, Any]] = {}
        # Firing/resolving alerts ride the same evidence stream: the
        # AlertManager's callbacks land transitions here (collector
        # thread), so "what was alerting when the fleet died" survives
        # into the final status line even if /alerts was never scraped.
        # deque(maxlen) keeps appends atomic and the log bounded.
        self.alert_events: "collections.deque" = collections.deque(
            maxlen=256
        )
        # Data flywheel: each replica captures episodes into
        # <capture_root>/replica_<id>; the scrape loop sweeps completed
        # files into <capture_root>/staging, the ONE dir the packer appends
        # from, fed by N replicas that keep writing across kills and
        # respawns.
        self.capture_root = capture_root
        self.captures_swept = 0
        # Elastic fleet: the autoscaler decides, this
        # supervisor spawns/drains/reaps. `None` keeps the fixed-N
        # behavior byte-identical. Surge replicas (ids >= the initial
        # fleet) boot at `surge_dtype` in the "surge" tier; the initial
        # fleet is the pinned base tier. Every replica's lifetime is
        # accrued into replica-seconds per dtype — the cost side of the
        # elastic bench — whether or not autoscaling is on.
        self.autoscale_policy = autoscale
        self.autoscaler = Autoscaler(autoscale) if autoscale else None
        self.autoscale_interval_s = autoscale_interval_s
        self.max_sessions = max_sessions
        self.surge_dtype = surge_dtype
        self._base_dtype_fn = base_dtype_fn or (lambda _rid: "f32")
        self.reclaim_grace_s = reclaim_grace_s
        self.reclaim_timeout_s = reclaim_timeout_s
        self.scale_ups = 0
        self.scale_downs = 0
        self.scale_events: List[Dict[str, Any]] = []  # bounded (256)
        self._t0 = time.monotonic()
        self._next_replica_id = n_replicas
        self._last_shed_total = 0
        # Replicas mid-reclaim: the supervision loop must not "heal" a
        # deliberate drain (their process exit is expected, not a death).
        self._reclaiming: set = set()
        # Orders a respawn against a reclaim's start and end: the loop
        # checks a snapshot of the routing table, so without it a reclaim
        # that ends inside one pass (replica removed, id no longer in
        # `_reclaiming`) had its exited process "healed" into a new one
        # that no router entry tracks and `stop()` never ends.
        self._lifecycle_lock = threading.Lock()
        self._reclaim_threads: List[threading.Thread] = []
        self._accrual_lock = threading.Lock()
        self._replica_seconds: Dict[str, float] = {}

    # ------------------------------------------------------------ spawning

    def _argv_for(self, replica: Replica) -> List[str]:
        """Spawn argv, honoring a per-replica dtype override (surge tier)
        when the builder accepts one; single-arg builders (older tests,
        custom fns) keep working unchanged."""
        import inspect

        try:
            takes_dtype = (
                len(inspect.signature(self._spawn_argv_fn).parameters) >= 2
            )
        except (TypeError, ValueError):  # builtins/partials w/o signature
            takes_dtype = False
        if takes_dtype:
            return self._spawn_argv_fn(replica.id, replica.dtype)
        return self._spawn_argv_fn(replica.id)

    def _spawn(self, replica: Replica) -> None:
        """(Re)launch one replica; its ready-line reader runs on a thread."""
        argv = self._argv_for(replica)
        stderr = None
        if self.log_dir is not None:
            os.makedirs(self.log_dir, exist_ok=True)
            path = os.path.join(
                self.log_dir,
                f"replica{replica.id}.g{replica.restarts}.log",
            )
            stderr = open(path, "w")  # noqa: SIM115 - closed after Popen
        env = dict(os.environ)
        if self.extra_env:
            env.update(self.extra_env)
        replica.url = None
        replica.state = STARTING
        replica.consecutive_probe_failures = 0
        try:
            replica.proc = subprocess.Popen(
                argv,
                stdout=subprocess.PIPE,
                stderr=stderr,
                text=True,
                env=env,
            )
        finally:
            if stderr is not None:
                # Popen dup'd the fd into the child; keeping the parent's
                # copy open would leak one fd per (re)spawn.
                stderr.close()
        replica.spawned_at = time.monotonic()
        threading.Thread(
            target=self._read_ready_line,
            args=(replica, replica.proc),
            name=f"rt1-fleet-stdout-{replica.id}",
            daemon=True,
        ).start()

    def _read_ready_line(self, replica: Replica, proc) -> None:
        """Parse `{"status": "serving", "port": ...}` off the replica's
        stdout, then keep draining so the pipe never fills."""
        try:
            for line in proc.stdout:
                if replica.url is None:
                    try:
                        ready = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if ready.get("status") == "serving":
                        host = ready.get("host", "127.0.0.1")
                        replica.url = f"http://{host}:{ready['port']}"
        except (ValueError, OSError):
            pass  # closed pipe on kill/shutdown

    def start(self, wait_ready: bool = True) -> None:
        for i in range(self.n_replicas):
            replica = Replica(i)
            replica.tier = TIER_BASE  # the pinned full-precision tier
            replica.dtype = self._base_dtype_fn(i)
            self.router.add_replica(replica)
        for replica in self.router.replicas():
            self._spawn(replica)
        if wait_ready:
            try:
                self.wait_all_ready()
            except BaseException:
                # A failed warm-up (one replica crashed, bad config, ...)
                # must not leak the siblings that DID spawn.
                self.stop()
                raise
        self._thread = threading.Thread(
            target=self._supervise, name="rt1-fleet-supervisor", daemon=True
        )
        self._thread.start()
        if self.exemplar_scrape_interval_s > 0:
            # Own thread: a hung replica makes each /slow_requests probe
            # eat its full timeout, which on the supervision thread would
            # delay the very death detection that makes the scrape matter.
            self._scrape_thread = threading.Thread(
                target=self._scrape_loop,
                name="rt1-fleet-exemplar-scrape",
                daemon=True,
            )
            self._scrape_thread.start()

    def wait_all_ready(self) -> None:
        """Block until every replica passes warm-up (ready-line + /readyz),
        raising if one dies or the warm-up budget expires."""
        deadline = time.monotonic() + self.warmup_timeout_s
        pending = {r.id for r in self.router.replicas()}
        while pending:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"replicas {sorted(pending)} not ready after "
                    f"{self.warmup_timeout_s:.0f}s"
                )
            for replica in self.router.replicas():
                if replica.id not in pending:
                    continue
                if replica.proc.poll() is not None:
                    raise RuntimeError(
                        f"replica {replica.id} exited rc="
                        f"{replica.proc.returncode} during warm-up"
                        + (
                            f" (see {self.log_dir})"
                            if self.log_dir
                            else ""
                        )
                    )
                if self._probe_ready(replica):
                    pending.discard(replica.id)
            time.sleep(0.05)

    def _probe_ready(self, replica: Replica) -> bool:
        if replica.url is None:
            return False
        status, _ = get_json(
            replica.url + "/readyz", timeout=self.probe_timeout_s
        )
        if status == 200:
            replica.consecutive_probe_failures = 0
            self.router.set_state(replica.id, READY)
            return True
        return False

    # --------------------------------------------------------- supervision

    def _supervise(self) -> None:
        last_chaos = time.monotonic()
        last_autoscale = time.monotonic()
        while not self._stop.is_set():
            for replica in self.router.replicas():
                if replica.id in self._reclaiming:
                    continue  # deliberate drain: its exit is not a death
                try:
                    self._check_replica(replica)
                except Exception as exc:  # noqa: BLE001 - keep healing
                    # One bad cycle (full-disk log open, a wait()
                    # timeout) must not kill supervision for good — a
                    # dead supervisor means no respawns and a silently
                    # decaying fleet.
                    print(
                        json.dumps(
                            {
                                "status": "supervise_error",
                                "replica": replica.id,
                                "error": str(exc),
                            }
                        ),
                        file=sys.stderr,
                        flush=True,
                    )
            if not self._fleet_was_ready:
                # Chaos ticks start only once the fleet has been fully
                # ready once — fault indices then count ticks, making
                # the schedule independent of warm-up wall time.
                self._fleet_was_ready = self.router.ready_count() == (
                    self.n_replicas
                )
                last_chaos = time.monotonic()
            elif time.monotonic() - last_chaos >= self.chaos_interval_s:
                last_chaos = time.monotonic()
                self.chaos_tick += 1
                try:
                    self._inject_chaos(self.chaos_tick)
                except Exception as exc:  # noqa: BLE001 - see above
                    print(
                        json.dumps(
                            {
                                "status": "chaos_error",
                                "tick": self.chaos_tick,
                                "error": str(exc),
                            }
                        ),
                        file=sys.stderr,
                        flush=True,
                    )
            if (
                self.autoscaler is not None
                and self._fleet_was_ready
                and time.monotonic() - last_autoscale
                >= self.autoscale_interval_s
            ):
                last_autoscale = time.monotonic()
                try:
                    self._autoscale_tick()
                except Exception as exc:  # noqa: BLE001 - keep supervising
                    print(
                        json.dumps(
                            {"status": "autoscale_error", "error": str(exc)}
                        ),
                        file=sys.stderr,
                        flush=True,
                    )
            self._stop.wait(self.poll_interval_s)

    def _check_replica(self, replica: Replica) -> None:
        if replica.proc is None:
            return
        if replica.proc.poll() is not None:
            if replica.state != DEAD:
                self.router.mark_dead(replica, reason="process exited")
            self._respawn(replica)
            return
        if replica.url is None:
            return  # still booting, ready-line not printed yet
        status, _ = get_json(
            replica.url + "/readyz", timeout=self.probe_timeout_s
        )
        if status == 200:
            replica.consecutive_probe_failures = 0
            if replica.state != READY:
                self.router.set_state(replica.id, READY)
        elif status == 0:
            replica.consecutive_probe_failures += 1
            if replica.consecutive_probe_failures >= self.hang_probe_failures:
                # Alive to the OS, dead to HTTP: hung. SIGKILL (a stopped
                # process cannot run SIGTERM handlers) and respawn.
                self.router.mark_dead(replica, reason="hang detected")
                replica.proc.kill()
                replica.proc.wait(timeout=10)
                self._respawn(replica)
        else:  # a live 503: warming / draining / reloading
            replica.consecutive_probe_failures = 0
            if replica.state == READY:
                self.router.set_state(replica.id, NOTREADY)

    def _scrape_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._scrape_exemplars()
                self.sweep_captures()
            except Exception as exc:  # noqa: BLE001 - keep scraping
                print(
                    json.dumps(
                        {"status": "exemplar_scrape_error", "error": str(exc)}
                    ),
                    file=sys.stderr,
                    flush=True,
                )
            self._stop.wait(self.exemplar_scrape_interval_s)

    def _scrape_exemplars(self) -> None:
        """Pull each live replica's slow-request ring into supervisor
        memory, so the exemplars survive a SIGKILL/crash of the replica.
        Keyed by replica id; a respawned replica's fresh (empty) ring only
        replaces the dead generation's scrape once it has entries —
        "nothing recorded yet" must not erase the crash evidence."""
        for replica in self.router.replicas():
            if replica.url is None or replica.state == DEAD:
                continue
            status, body = get_json(
                replica.url + "/slow_requests", timeout=self.probe_timeout_s
            )
            if status != 200 or not isinstance(body, dict):
                continue
            with self._exemplar_lock:
                if (
                    body.get("retained")
                    or replica.id not in self.last_exemplars
                ):
                    body["scraped_at"] = time.time()
                    body["generation"] = replica.restarts
                    self.last_exemplars[replica.id] = body

    def note_alert(self, event: Dict[str, Any]) -> None:
        """AlertManager on_fire/on_resolve hook — alert transitions into
        the fleet's crash-surviving evidence stream."""
        self.alert_events.append(dict(event))

    def replica_capture_dir(self, replica_id: int) -> Optional[str]:
        if self.capture_root is None:
            return None
        return os.path.join(self.capture_root, f"replica_{replica_id}")

    def capture_staging_dir(self) -> Optional[str]:
        if self.capture_root is None:
            return None
        return os.path.join(self.capture_root, "staging")

    def sweep_captures(self) -> int:
        """Move completed per-replica capture files into the staging dir
        (same-filesystem renames; a SIGKILLed replica's already-renamed
        episodes survive it, exactly like the exemplar scrape)."""
        if self.capture_root is None:
            return 0
        from rt1_tpu_torch.flywheel.capture import sweep_captures

        moved = sweep_captures(
            [
                self.replica_capture_dir(r.id)
                for r in self.router.replicas()
            ],
            self.capture_staging_dir(),
        )
        self.captures_swept += moved
        return moved

    def _respawn(self, replica: Replica) -> None:
        with self._lifecycle_lock:
            if self._stop.is_set():
                return  # stopping: `stop()` ends what runs, heals nothing
            if replica.id in self._reclaiming or not any(
                r is replica for r in self.router.replicas()
            ):
                return  # reclaimed: the drain reaps it, the slot is gone
            # Close the dead generation's cost window FIRST: a replica
            # past the restart budget stays DEAD forever, and an open
            # window would keep accruing replica-seconds for a process
            # that isn't running.
            self._accrue(replica)
            if self.restarts_total >= self.max_restarts:
                return  # crash-looping fleet: stop burning the host
            self.restarts_total += 1
            replica.restarts += 1
            self._spawn(replica)

    # ---------------------------------------------------------- autoscaling

    def _live_replicas(self) -> List[Replica]:
        """Replicas that count as capacity for scaling decisions: not
        mid-reclaim and not DEAD. Excluding DEAD matters for liveness —
        a crash-looping slot that exhausted max_restarts stays DEAD
        forever, and counting it in replicas_total would wedge the
        total==ready decision gate permanently (no surge under overload,
        ever). A transiently-dead slot is respawned into STARTING within
        one poll cycle, so the warming gate still holds while it boots."""
        return [
            r
            for r in self.router.replicas()
            if r.id not in self._reclaiming and r.state != DEAD
        ]

    def _signals(self) -> FleetSignals:
        live = self._live_replicas()
        ready = sum(1 for r in live if r.state == READY)
        window = (
            self.autoscale_policy.active_window_s
            if self.autoscale_policy
            else 5.0
        )
        # Capacity pressure counts ONLY global-overload sheds: a
        # client_rate shed is the token bucket doing its job on one hot
        # client — more replicas cannot admit it, and counting it would
        # pin the fleet at max while idle (see ServeMetrics.shed_total).
        shed_total = self.router.metrics.shed_total("overload")
        shed_delta = shed_total - self._last_shed_total
        self._last_shed_total = shed_total
        return FleetSignals(
            replicas_total=len(live),
            replicas_ready=ready,
            active_sessions=self.router.active_session_count(window),
            session_slots=ready * self.max_sessions,
            inflight=self.router.inflight,
            shed_delta=shed_delta,
            # Time-windowed burn, not the request-indexed
            # rolling gauge: with no follow-on traffic the window ages
            # out and the burn decays to zero on the wall clock, so a
            # shed/restart burst can't pin scale-up pressure forever.
            rolling_burn=self.router.slo.windowed_burn(
                self.autoscale_policy.burn_window_s
                if self.autoscale_policy
                else 60.0
            ),
            replicas_booting=sum(1 for r in live if r.state == STARTING),
        )

    def _autoscale_tick(self) -> None:
        if self._reclaiming:
            # A drain is still in flight: it is invisible to the signal
            # computation (deliberately — a draining replica is not
            # capacity), so without this gate a scale-up during a slow
            # reclaim could run max_replicas+1 live processes. Checked
            # BEFORE _signals(): computing signals would advance the
            # overload-shed baseline and throw the delta away, erasing
            # exactly the pressure evidence a shed burst during the
            # drain window should carry into the next live tick.
            return
        signals = self._signals()
        # Fleet-shape gauges refresh every tick (rt1_serve_autoscale_*).
        tiers: Dict[str, int] = {}
        for replica in self._live_replicas():
            dtype = replica.dtype or "f32"
            tiers[dtype] = tiers.get(dtype, 0) + 1
        self.router.metrics.set_autoscale_state(
            replicas=signals.replicas_total, tier_replicas=tiers
        )
        decision = self.autoscaler.decide(signals)
        if decision is None:
            return
        if decision.direction == "up":
            self._scale_up(decision.reason)
        else:
            self._scale_down(decision.reason)

    def _record_scale_event(self, event: Dict[str, Any]) -> None:
        event["t_s"] = round(time.monotonic() - self._t0, 3)
        self.scale_events.append(event)
        del self.scale_events[:-256]  # bounded log
        self.router.metrics.observe_scale_event(event["direction"])

    def _scale_up(self, reason: str) -> None:
        """Boot one surge replica (fresh id — ids are never reused, so
        metrics labels stay unambiguous across the fleet's history)."""
        rid = self._next_replica_id
        self._next_replica_id += 1
        replica = Replica(rid)
        replica.tier = TIER_SURGE
        replica.dtype = self.surge_dtype or self._base_dtype_fn(rid)
        # Spawn BEFORE registering: a failed Popen (ENOMEM/EMFILE —
        # exactly when a surge fires) must not leave a proc-less ghost
        # in the routing table that the ready gate would wait on forever.
        self._spawn(replica)
        self.router.add_replica(replica)
        self.scale_ups += 1
        self._record_scale_event(
            {
                "direction": "up",
                "replica_id": rid,
                "tier": replica.tier,
                "dtype": replica.dtype,
                "reason": reason,
                "replicas_after": len(self._live_replicas()),
            }
        )

    def _scale_down(self, reason: str) -> None:
        """Drain and reap one replica: surge tier first (highest id), a
        base replica only when no surge remains — and never replica 0,
        the parity canary. The reclaim itself runs on its own thread (a
        graceful drain takes seconds; the supervision loop must keep
        probing the rest of the fleet)."""
        candidates = [
            r
            for r in self._live_replicas()
            if r.proc is not None and r.id != 0
        ]
        min_replicas = (
            self.autoscale_policy.min_replicas if self.autoscale_policy else 1
        )
        if len(self._live_replicas()) <= min_replicas or not candidates:
            return
        candidates.sort(key=lambda r: (r.tier != TIER_SURGE, -r.id))
        victim = candidates[0]
        with self._lifecycle_lock:
            self._reclaiming.add(victim.id)
        self.scale_downs += 1
        self._reclaim_threads = [
            t for t in self._reclaim_threads if t.is_alive()
        ]
        thread = threading.Thread(
            target=self._reclaim,
            args=(victim, reason),
            name=f"rt1-fleet-reclaim-{victim.id}",
            daemon=True,
        )
        self._reclaim_threads.append(thread)
        thread.start()

    def manual_scale_down(
        self, payload: Dict[str, Any]
    ) -> Dict[str, Any]:
        """Operator-driven elastic drain (router ``POST /scale_down``):
        reclaim one replica NOW through the same migrating drain the
        autoscaler uses — live-migrate its sessions, de-place, SIGTERM,
        reap. ``replica_id`` picks the victim explicitly; omitted, the
        autoscaler's preference applies (surge tier first, highest id,
        never replica 0). Raises KeyError/ValueError (router -> 400) on
        an unknown or unreclaimable victim."""
        replica_id = payload.get("replica_id")
        if replica_id is not None and not isinstance(replica_id, int):
            raise ValueError("'replica_id' must be an integer when given")
        candidates = [
            r
            for r in self._live_replicas()
            if r.proc is not None
            and r.id != 0
            and r.id not in self._reclaiming
        ]
        if replica_id is not None:
            victim = next(
                (r for r in candidates if r.id == replica_id), None
            )
            if victim is None:
                raise KeyError(
                    f"replica {replica_id} is not reclaimable (unknown, "
                    f"already draining, or the pinned replica 0)"
                )
        else:
            if not candidates:
                raise ValueError("no reclaimable replica")
            candidates.sort(key=lambda r: (r.tier != TIER_SURGE, -r.id))
            victim = candidates[0]
        with self._lifecycle_lock:
            self._reclaiming.add(victim.id)
        self.scale_downs += 1
        self._reclaim_threads = [
            t for t in self._reclaim_threads if t.is_alive()
        ]
        thread = threading.Thread(
            target=self._reclaim,
            args=(victim, "manual"),
            name=f"rt1-fleet-reclaim-{victim.id}",
            daemon=True,
        )
        self._reclaim_threads.append(thread)
        thread.start()
        return {"ok": True, "replica_id": victim.id, "draining": True}

    def _reclaim(self, victim: Replica, reason: str) -> None:
        """Graceful scale-down of one replica: live-migrate its sessions
        onto the least-loaded compatible survivor (their next act
        continues token-identically with ``migrated: true``), de-place
        (router stops routing to it; any session that could NOT migrate
        is orphaned so it re-homes through the legacy failover path with
        ``restarted: true``), give in-flight requests a grace window,
        snapshot the compile-count evidence, SIGTERM (the replica's own
        drain path: stop admitting, flush, exit 0), and only then reap
        the process and purge the id from the routing/metrics maps — no
        ghost replicas."""
        event: Dict[str, Any] = {
            "direction": "down",
            "replica_id": victim.id,
            "tier": victim.tier,
            "dtype": victim.dtype,
            "reason": reason,
        }
        try:
            try:
                migration = self.router.migrate_sessions_from(
                    victim.id, reason=f"scale_down:{reason}"
                )
                if migration.get("attempted") or migration.get("failed"):
                    event["sessions_migrated"] = migration["migrated"]
                    event["migration_failed"] = migration["failed"]
            except Exception as exc:  # noqa: BLE001 - drain must proceed
                # Migration is best-effort sugar on top of the drain:
                # any failure here degrades to the legacy orphan path
                # below, never wedges the reclaim thread.
                event["migration_error"] = str(exc)
            self.router.deplace(victim.id)
            time.sleep(self.reclaim_grace_s)
            if victim.url is not None:
                status, body = get_json(
                    victim.url + "/metrics", timeout=self.probe_timeout_s
                )
                if status == 200 and isinstance(body, dict):
                    # The reclaim survivor's pinned-compile evidence,
                    # recorded BEFORE the process dies — the elastic
                    # bench asserts compile_count == bucket_count on
                    # every replica lifetime, reaped ones included.
                    event["compile_count"] = body.get("compile_count")
                    event["bucket_count"] = body.get("bucket_count")
                    event["requests_total"] = body.get("requests_total")
            proc = victim.proc
            if proc is not None and proc.poll() is None:
                proc.send_signal(signal.SIGCONT)  # un-wedge SIGSTOP chaos
                proc.terminate()
                try:
                    proc.wait(timeout=self.reclaim_timeout_s)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=5)
            event["exit_code"] = (
                victim.proc.returncode if victim.proc is not None else None
            )
        except Exception as exc:  # noqa: BLE001 - reclaim must not wedge
            event["error"] = str(exc)
            if victim.proc is not None and victim.proc.poll() is None:
                victim.proc.kill()
                try:
                    # Reap the corpse: an unwaited kill leaves a zombie
                    # per failed reclaim for the supervisor's lifetime.
                    victim.proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    pass
            if victim.proc is not None:
                event["exit_code"] = victim.proc.returncode
        finally:
            self._accrue(victim)
            with self._lifecycle_lock:
                self.router.remove_replica(victim.id)
                event["replicas_after"] = len(self.router.replicas())
                self._record_scale_event(event)
                self._reclaiming.discard(victim.id)

    # ----------------------------------------------------- cost accounting

    def _accrue(self, replica: Replica) -> None:
        """Close the replica's current lifetime into the per-dtype
        replica-second ledger (idempotent: spawned_at is consumed)."""
        if replica.spawned_at is None:
            return
        seconds = max(time.monotonic() - replica.spawned_at, 0.0)
        replica.spawned_at = None
        dtype = replica.dtype or "f32"
        with self._accrual_lock:
            self._replica_seconds[dtype] = (
                self._replica_seconds.get(dtype, 0.0) + seconds
            )

    def replica_seconds_by_dtype(self) -> Dict[str, float]:
        """Accrued + live replica-seconds per dtype (non-mutating, so the
        fleet's final status line can be built before stop())."""
        now = time.monotonic()
        with self._accrual_lock:
            out = dict(self._replica_seconds)
        for replica in self.router.replicas():
            if replica.spawned_at is not None:
                dtype = replica.dtype or "f32"
                out[dtype] = out.get(dtype, 0.0) + (
                    now - replica.spawned_at
                )
        return {k: round(v, 3) for k, v in sorted(out.items())}

    def autoscale_summary(self) -> Dict[str, Any]:
        """The elastic-fleet evidence for the final status line: scale-event log, replica-seconds per dtype tier, and the
        byte-weighted cost units behind cost-per-request."""
        seconds = self.replica_seconds_by_dtype()
        cost_units = sum(
            s * DTYPE_COST_WEIGHTS.get(dtype, 1.0)
            for dtype, s in seconds.items()
        )
        policy = self.autoscale_policy
        return {
            "enabled": policy is not None,
            "min_replicas": policy.min_replicas if policy else None,
            "max_replicas": policy.max_replicas if policy else None,
            "surge_dtype": self.surge_dtype,
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "events": list(self.scale_events),
            "replica_seconds_by_dtype": seconds,
            "cost_units": round(cost_units, 3),
            "cost_weights": DTYPE_COST_WEIGHTS,
            "replicas_final": len(self._live_replicas()),
        }

    # --------------------------------------------------------------- chaos

    def _inject_chaos(self, tick: int) -> None:
        plan = faults.active()
        if plan is None:
            return
        if plan.should_fire("replica_kill", index=tick):
            victim = self._victim()
            if victim is not None:
                self.kills_injected += 1
                self.router.mark_dead(victim, reason="chaos replica_kill")
                victim.proc.kill()
        if plan.should_fire("replica_hang", index=tick):
            victim = self._victim()
            if victim is not None:
                self.hangs_injected += 1
                victim.proc.send_signal(signal.SIGSTOP)
        if plan.should_fire("serve_reload", index=tick):
            self.reloads_injected += 1
            threading.Thread(
                target=self.router.rolling_reload,
                name="rt1-fleet-chaos-reload",
                daemon=True,
            ).start()

    def _victim(self) -> Optional[Replica]:
        ready = [
            r for r in self.router.replicas()
            if r.state == READY and r.proc is not None
        ]
        return min(ready, key=lambda r: r.id) if ready else None

    # ------------------------------------------------------------ shutdown

    def stop(self, timeout: float = 15.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        if self._scrape_thread is not None:
            self._scrape_thread.join(timeout=timeout)
        for thread in self._reclaim_threads:
            thread.join(timeout=self.reclaim_timeout_s + timeout)
        for replica in self.router.replicas():
            proc = replica.proc
            if proc is None or proc.poll() is not None:
                continue
            proc.send_signal(signal.SIGCONT)  # un-wedge a SIGSTOP victim
            proc.terminate()
        for replica in self.router.replicas():
            proc = replica.proc
            if proc is None:
                continue
            try:
                proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5)
            self._accrue(replica)  # close every cost window on shutdown

    def summary(self) -> Dict[str, Any]:
        return {
            "chaos_ticks": self.chaos_tick,
            "kills_injected": self.kills_injected,
            "hangs_injected": self.hangs_injected,
            "reloads_injected": self.reloads_injected,
            "replica_restarts": self.restarts_total,
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "captures_swept": self.captures_swept,
            "faults_fired": (
                faults.active().fired_counts() if faults.active() else {}
            ),
        }

    def slow_request_evidence(
        self, per_replica: int = 8
    ) -> Dict[str, Any]:
        """The last-scraped exemplars, trimmed to the `per_replica` most
        recent records each — the fleet's crash-surviving slow-request
        evidence for the final status line / post-mortem."""
        out = {}
        with self._exemplar_lock:
            snapshot = sorted(self.last_exemplars.items())
        for rid, scrape in snapshot:
            records = scrape.get("slow_requests", [])
            out[str(rid)] = {
                **{k: v for k, v in scrape.items() if k != "slow_requests"},
                "slow_requests": records[-per_replica:],
            }
        return out


# -------------------------------------------------------------- entry point


# Mirrors models/quant.INFERENCE_DTYPES without importing torch into the
# supervisor/router process (which stays model-free).
VALID_REPLICA_DTYPES = ("f32", "bf16", "int8")


def replica_dtype_for(args, replica_id: int) -> str:
    """This replica's inference dtype: the per-replica `--replica_dtypes`
    list (a mixed-dtype fleet — cheap int8 replicas beside an f32
    reference) wins over the fleet-wide `--inference_dtype` default.

    Every list entry is validated here — unlike `--inference_dtype` there
    is no argparse `choices` guard, and an invalid entry would otherwise
    surface as a replica crash-loop at the CHILD's argparse instead of a
    message naming the typo.
    """
    per_replica = [
        d.strip()
        for d in getattr(args, "replica_dtypes", "").split(",")
        if d.strip()
    ]
    for dtype in per_replica:
        if dtype not in VALID_REPLICA_DTYPES:
            raise ValueError(
                f"--replica_dtypes entry {dtype!r} is not one of "
                f"{VALID_REPLICA_DTYPES}"
            )
    if per_replica:
        return per_replica[replica_id % len(per_replica)]
    return getattr(args, "inference_dtype", "f32")


def replica_argv_builder(args) -> Callable[..., List[str]]:
    """argv factory for one replica — the stub or the port's server.

    The returned builder takes ``(replica_id, dtype=None)``: the optional
    dtype override is how autoscaler-spawned surge replicas boot at
    ``--surge_dtype`` while the base tier keeps the
    ``--replica_dtypes``/``--inference_dtype`` assignment.
    """
    slow_threshold = getattr(args, "slow_threshold_ms", 0.0)
    scheduler = getattr(args, "scheduler", "continuous")
    buckets = getattr(args, "buckets", "auto")
    # Durable sessions: ONE shared snapshot directory for the whole fleet
    # (ring files are keyed per session, writes are atomic) — the replica
    # a SIGKILL'd session re-homes onto must be able to read the ring
    # entry its dead home wrote. Empty = off (no disk writes).
    snapshot_dir = getattr(args, "session_snapshot_dir", "")
    snapshot_max_age = getattr(args, "snapshot_max_age_s", 600.0)
    if args.stub:
        act_concurrency = getattr(args, "stub_act_concurrency", 0)

        def build(replica_id: int, dtype: Optional[str] = None) -> List[str]:
            argv = [
                sys.executable, "-m", "rt1_tpu_torch.serve.stub",
                "--port", "0",
                "--replica_id", str(replica_id),
                "--max_sessions", str(args.max_sessions),
                "--act_delay_s", str(args.stub_act_delay_s),
                "--act_concurrency", str(act_concurrency),
                "--slow_threshold_ms", str(slow_threshold),
                "--inference_dtype",
                dtype or replica_dtype_for(args, replica_id),
                "--scheduler", scheduler,
                # The stub has no compiler; it advertises the contract
                # field ("1" = one bucket) unless a ladder is forced.
                "--buckets", buckets if buckets != "auto" else "1",
            ]
            if snapshot_dir:
                argv.extend([
                    "--session_snapshot_dir", snapshot_dir,
                    "--snapshot_max_age_s", str(snapshot_max_age),
                ])
            return argv
        return build

    device = getattr(args, "device", "cuda")
    capture_root = getattr(args, "capture_dir", "")

    def build(replica_id: int, dtype: Optional[str] = None) -> List[str]:
        argv = [
            sys.executable, "-m", "rt1_tpu_torch.serve",
            "--config", args.config,
            "--port", "0",
            "--replica_id", str(replica_id),
            "--max_sessions", str(args.max_sessions),
            "--embedder", args.embedder,
            "--slow_threshold_ms", str(slow_threshold),
            "--inference_dtype",
            dtype or replica_dtype_for(args, replica_id),
            "--scheduler", scheduler,
            "--buckets", buckets,
            "--device", device,
        ]
        if snapshot_dir:
            argv.extend([
                "--session_snapshot_dir", snapshot_dir,
                "--snapshot_max_age_s", str(snapshot_max_age),
            ])
        if capture_root:
            # Per-replica capture dir; the supervisor sweeps completed
            # files into <capture_dir>/staging for the packer.
            argv.extend([
                "--capture_dir",
                os.path.join(capture_root, f"replica_{replica_id}"),
            ])
        if getattr(args, "allow_embedder_mismatch", False):
            argv.append("--allow_embedder_mismatch")
        if args.random_init:
            argv.append("--random_init")
        else:
            argv.extend(["--workdir", args.workdir])
        return argv
    return build


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m rt1_tpu_torch.serve.fleet",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("--replicas", type=int, default=2)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8400,
                        help="Router bind port (0 = ephemeral).")
    parser.add_argument("--config", default="",
                        help="language_table | tiny, forwarded to replicas.")
    parser.add_argument("--workdir", default="",
                        help="The port trainer's workdir, forwarded to "
                             "replicas (enables /reload from disk).")
    parser.add_argument("--random_init", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="Replica device, forwarded to every replica "
                             "(cuda | cpu).")
    parser.add_argument("--stub", action="store_true",
                        help="Spawn model-free stub replicas "
                             "(rt1_tpu_torch.serve.stub) — protocol-true, "
                             "no torch.")
    parser.add_argument("--max_sessions", type=int, default=8)
    parser.add_argument("--embedder", default="hash")
    parser.add_argument("--stub_act_delay_s", type=float, default=0.0)
    parser.add_argument(
        "--stub_act_concurrency", type=int, default=0,
        help="Stub device-concurrency limit: >0 serializes that many "
             "simulated device steps per stub replica, so replica count "
             "actually moves latency in elastic rehearsals (0 = "
             "unlimited).")
    parser.add_argument(
        "--min_replicas", type=int, default=0,
        help="Arm the autoscaler with this floor (also overrides "
             "--replicas as the initial fleet size). 0 = fixed fleet.")
    parser.add_argument(
        "--max_replicas", type=int, default=0,
        help="Autoscaler ceiling (required when --min_replicas > 0).")
    parser.add_argument("--autoscale_interval_s", type=float, default=1.0)
    parser.add_argument(
        "--scale_up_occupancy", type=float, default=0.75,
        help="Active sessions per ready slot at/above which sustained "
             "pressure scales up.")
    parser.add_argument(
        "--scale_down_occupancy", type=float, default=0.30,
        help="Occupancy at/below which sustained idleness scales down.")
    parser.add_argument(
        "--scale_up_ticks", type=int, default=2,
        help="Consecutive pressure ticks before scaling up (fast).")
    parser.add_argument(
        "--scale_down_ticks", type=int, default=6,
        help="Consecutive idle ticks before scaling down (slow).")
    parser.add_argument(
        "--active_window_s", type=float, default=5.0,
        help="A session counts toward occupancy this long after its "
             "last answered act.")
    parser.add_argument(
        "--surge_dtype", default="",
        choices=["", "f32", "bf16", "int8"],
        help="Dtype for autoscaler-spawned surge replicas (int8 holds "
             "0.2585 of the f32 flagship's device param bytes, "
             "DTYPE_COST_WEIGHTS); '' = same as the base tier.")
    parser.add_argument(
        "--reclaim_grace_s", type=float, default=0.5,
        help="Seconds between de-placement and SIGTERM on scale-down "
             "(in-flight acts finish inside this window).")
    parser.add_argument(
        "--session_snapshot_dir", default="",
        help="Durable sessions: shared on-disk session-snapshot ring, "
             "forwarded to every replica (serve/migrate.py). A SIGKILL'd "
             "replica's sessions restore mid-episode on the replica they "
             "re-home to (booked `migrated`, not `restarted`). '' = off.")
    parser.add_argument(
        "--snapshot_max_age_s", type=float, default=600.0,
        help="Crash-restore staleness bound forwarded to every replica "
             "(older ring snapshots start a fresh window instead).")
    parser.add_argument(
        "--admission_rate", type=float, default=0.0,
        help="Token-bucket refill per client id (requests/s); past the "
             "bucket the router sheds with a fast 429. 0 = off.")
    parser.add_argument(
        "--admission_burst", type=float, default=8.0,
        help="Token-bucket depth per client id.")
    parser.add_argument(
        "--max_inflight", type=int, default=0,
        help="Global shed threshold: 429 new /acts while more than this "
             "many are mid-route. 0 = off.")
    parser.add_argument(
        "--scheduler", default="continuous",
        choices=["continuous", "cycle"],
        help="Batch scheduler forwarded to every replica ('continuous' "
             "rolls requests into the next device step; 'cycle' waits "
             "for a full batch or its deadline).")
    parser.add_argument(
        "--buckets", default="auto",
        help="Batch-size buckets forwarded to every replica "
             "('auto' = pow2 ladder; comma ints to pin).")
    parser.add_argument(
        "--inference_dtype", default="f32",
        choices=["f32", "bf16", "int8"],
        help="Serving mode forwarded to every replica "
             "(models/quant.py).")
    parser.add_argument(
        "--replica_dtypes", default="",
        help="Comma list assigning a dtype per replica id (cycled), e.g. "
             "'f32,int8,int8' — a mixed-dtype fleet; overrides "
             "--inference_dtype.")
    parser.add_argument(
        "--slow_threshold_ms", type=float, default=0.0,
        help="Replica exemplar-ring threshold, forwarded to every "
             "replica (0 keeps the most recent window of all requests).")
    parser.add_argument(
        "--slo_availability", type=float, default=0.99,
        help="Router SLO: fraction of requests that must be ok.")
    parser.add_argument(
        "--slo_p50_ms", type=float, default=250.0,
        help="Router SLO: answered-request p50 objective (ms).")
    parser.add_argument(
        "--slo_p99_ms", type=float, default=2500.0,
        help="Router SLO: answered-request p99 objective (ms).")
    parser.add_argument(
        "--capture_dir", default="",
        help="Data flywheel: per-replica episode capture under "
             "<dir>/replica_<id>, swept into <dir>/staging by the "
             "supervisor (real replicas only; the model-free stub serves "
             "no observations worth capturing).")
    parser.add_argument(
        "--allow_embedder_mismatch", action="store_true",
        help="Forwarded to every replica: serve a --workdir checkpoint "
             "whose data_manifest.json records another embedder.")
    # Metrics plane: default off keeps surfaces byte-identical.
    parser.add_argument(
        "--collector", action="store_true",
        help="Arm the metrics plane: an in-process collector scrapes "
             "this fleet's own /metrics (and /deploy/status when "
             "promotion is armed) into a ring TSDB, evaluates the "
             "default alert ruleset each cycle, and serves /alerts, "
             "/history and /dashboard on the router port.")
    parser.add_argument(
        "--collector_interval_s", type=float, default=2.0,
        help="Scrape cadence — which is also the alert-evaluation "
             "cadence, like a Prometheus rule group.")
    parser.add_argument(
        "--obs_dir", default="",
        help="Where the armed collector writes tsdb_snapshot.jsonl on "
             "shutdown for the post-mortem (default: "
             "--workdir when set; neither set = no snapshot).")
    parser.add_argument(
        "--promote_from", default="",
        help="Continuous deployment (deploy/): watch this train "
             "workdir for new checkpoints, gate them offline, canary "
             "onto one replica at --canary_weight, promote fleet-wide "
             "after a clean burn window, auto-rollback on breach. Stub "
             "fleets auto-pass the offline gate (the supervisor process "
             "stays torch-free); real fleets run the eval-matrix + parity "
             "gate against --config on --device.")
    parser.add_argument(
        "--canary_weight", type=float, default=0.25,
        help="Fraction of FRESH sessions routed to the canary replica "
             "(existing sessions keep their affinity).")
    parser.add_argument(
        "--burn_threshold", type=float, default=2.0,
        help="Canary rolling error-budget burn rate that counts as a "
             "breach (must also strictly exceed the incumbent fleet's).")
    parser.add_argument(
        "--breach_ticks", type=int, default=2,
        help="Consecutive breach ticks before auto-rollback.")
    parser.add_argument(
        "--clean_window_ticks", type=int, default=5,
        help="Consecutive clean ticks before fleet-wide promotion.")
    parser.add_argument(
        "--min_canary_requests", type=int, default=8,
        help="Evidence floor: hold the canary verdict until it has "
             "served this many requests (breaches still fire).")
    parser.add_argument(
        "--deploy_poll_interval_s", type=float, default=1.0,
        help="Promotion-controller tick interval.")
    parser.add_argument(
        "--gate_episodes", type=int, default=2,
        help="Eval-matrix episodes per task cell in the promotion gate "
             "(real fleets only).")
    parser.add_argument(
        "--gate_tasks", default="",
        help="Comma list of reward-family tasks for the promotion gate "
             "(empty = every canonical family).")
    parser.add_argument(
        "--gate_max_steps", type=int, default=80,
        help="Max env steps per gate eval episode.")
    parser.add_argument(
        "--deploy_incumbent_step", type=int, default=-1,
        help="Checkpoint step the fleet is currently serving (the gate "
             "baseline and rollback target). -1 = auto: the newest step "
             "in --promote_from at arm time; only checkpoints appearing "
             "AFTER that are candidates.")
    parser.add_argument("--faults", default="",
                        help="Chaos plan, e.g. 'replica_kill@1,"
                             "serve_reload@2' (RT1_FAULTS appended).")
    parser.add_argument("--chaos_interval_s", type=float, default=2.0)
    parser.add_argument("--poll_interval_s", type=float, default=0.25)
    parser.add_argument("--replica_timeout_s", type=float, default=30.0)
    parser.add_argument("--max_failovers", type=int, default=2)
    parser.add_argument("--warmup_timeout_s", type=float, default=600.0)
    parser.add_argument("--log_dir", default="",
                        help="Per-replica stderr logs (default: inherit).")
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args(argv)

    if not args.stub and not args.config:
        parser.error("--config is required unless --stub")
    try:
        replica_dtype_for(args, 0)  # validates every --replica_dtypes entry
    except ValueError as exc:
        parser.error(str(exc))
    if not args.stub and not args.random_init and not args.workdir:
        parser.error("pass --workdir (checkpoint) or --random_init")
    if not args.stub:
        # Refuse here, not in N crash-looping replicas: a cuda fleet on a
        # machine without a card raises unless asked for the CPU.
        from rt1_tpu_torch import resolve_device

        resolve_device(args.device)

    policy = None
    if args.min_replicas > 0:
        if args.max_replicas < args.min_replicas:
            parser.error(
                "--max_replicas must be >= --min_replicas when the "
                "autoscaler is armed"
            )
        try:
            policy = AutoscalePolicy(
                min_replicas=args.min_replicas,
                max_replicas=args.max_replicas,
                scale_up_occupancy=args.scale_up_occupancy,
                scale_down_occupancy=args.scale_down_occupancy,
                up_sustain_ticks=args.scale_up_ticks,
                down_sustain_ticks=args.scale_down_ticks,
                active_window_s=args.active_window_s,
            )
        except ValueError as exc:
            parser.error(str(exc))
        # The autoscaler owns the fleet size: boot at the floor (the
        # pinned base tier) and let traffic earn the surge replicas.
        args.replicas = args.min_replicas

    admission = None
    if args.admission_rate > 0 or args.max_inflight > 0:
        admission = AdmissionController(
            rate_per_client=args.admission_rate,
            burst=args.admission_burst,
            max_inflight=args.max_inflight,
        )

    faults.install_from(args.faults)
    # Export the combined fault spec so SPAWNED replicas arm their own
    # sites too (session_restore fires inside the replica process; the
    # supervisor's in-process plan can't reach it). Popen inherits
    # os.environ, and replica mains call faults.install_from("").
    combined_faults = ",".join(
        s for s in (args.faults, os.environ.get(faults.ENV_VAR, "")) if s
    )
    if combined_faults:
        os.environ[faults.ENV_VAR] = combined_faults

    from rt1_tpu_torch.obs.slo import SLOLedger, SLOObjectives

    router = Router(
        replica_timeout_s=args.replica_timeout_s,
        max_failovers=args.max_failovers,
        slo=SLOLedger(
            SLOObjectives(
                availability=args.slo_availability,
                latency_p50_ms=args.slo_p50_ms,
                latency_p99_ms=args.slo_p99_ms,
            )
        ),
        admission=admission,
    )
    supervisor = FleetSupervisor(
        router,
        replica_argv_builder(args),
        args.replicas,
        chaos_interval_s=args.chaos_interval_s,
        poll_interval_s=args.poll_interval_s,
        warmup_timeout_s=args.warmup_timeout_s,
        log_dir=args.log_dir or None,
        autoscale=policy,
        autoscale_interval_s=args.autoscale_interval_s,
        max_sessions=args.max_sessions,
        surge_dtype=args.surge_dtype or None,
        base_dtype_fn=lambda rid: replica_dtype_for(args, rid),
        reclaim_grace_s=args.reclaim_grace_s,
        capture_root=(args.capture_dir or None) if not args.stub else None,
    )
    # Elastic-drain seam: POST /scale_down on the router drives the
    # supervisor's migrating drain (sessions carried to survivors before
    # the victim is reaped).
    router.scale_down_fn = supervisor.manual_scale_down
    supervisor.start(wait_ready=True)

    controller = None
    if args.promote_from:
        from rt1_tpu_torch.deploy.controller import PromotionController
        from rt1_tpu_torch.deploy.decision import CanaryPolicy
        from rt1_tpu_torch.deploy.watcher import latest_checkpoint_step

        if args.deploy_incumbent_step >= 0:
            incumbent = args.deploy_incumbent_step
        else:
            # Auto: whatever is newest at arm time is what the fleet is
            # (presumed) serving — only LATER checkpoints are candidates.
            incumbent = latest_checkpoint_step(
                os.path.join(args.promote_from, "checkpoints")
            )
        if args.stub:
            # The supervisor process stays torch-free with stub replicas:
            # the offline gate auto-passes (canary burn + rollback paths
            # are what a stub deploy cycle exercises).
            def gate_fn(candidate_step, incumbent_step):
                return {
                    "gate": "auto_pass_stub",
                    "passed": True,
                    "candidate_step": candidate_step,
                    "incumbent_step": incumbent_step,
                }
        else:
            from rt1_tpu_torch.deploy.gate import build_gate_fn, load_config

            gate_tasks = [t for t in args.gate_tasks.split(",") if t]
            gate_fn = build_gate_fn(
                load_config(args.config),
                args.promote_from,
                tasks=gate_tasks or None,
                episodes_per_cell=args.gate_episodes,
                max_episode_steps=args.gate_max_steps,
                inference_dtype=args.inference_dtype,
                embedder=args.embedder,
                device=args.device,
            )
        try:
            canary_policy = CanaryPolicy(
                burn_threshold=args.burn_threshold,
                breach_ticks=args.breach_ticks,
                clean_window_ticks=args.clean_window_ticks,
                min_canary_requests=args.min_canary_requests,
                canary_weight=args.canary_weight,
            )
        except ValueError as exc:
            parser.error(str(exc))
        controller = PromotionController(
            router,
            args.promote_from,
            gate_fn=gate_fn,
            policy=canary_policy,
            incumbent_step=incumbent,
            poll_interval_s=args.deploy_poll_interval_s,
        )
        router.deploy_gauges_fn = controller.deploy_gauges
        router.deploy_status_fn = controller.summary
        controller.start()

    httpd = make_router_server(
        router, host=args.host, port=args.port, quiet=not args.verbose
    )

    tsdb = None
    alert_manager = None
    collector = None
    if args.collector:
        from rt1_tpu_torch.obs.alerts import AlertManager, default_ruleset
        from rt1_tpu_torch.obs.collector import Collector, Target
        from rt1_tpu_torch.obs.dashboard import render_dashboard_html
        from rt1_tpu_torch.obs.tsdb import SNAPSHOT_BASENAME, TSDB

        tsdb = TSDB()
        alert_manager = AlertManager(
            tsdb,
            default_ruleset(),
            on_fire=supervisor.note_alert,
            on_resolve=supervisor.note_alert,
        )
        # The collector scrapes the fleet's OWN router port — the same
        # exposition text any external Prometheus would see, so the
        # history it stores can never disagree with the live scrape.
        router_url = (
            f"http://{httpd.server_address[0]}:{httpd.server_address[1]}"
        )
        obs_targets = [Target("fleet", router_url + "/metrics")]
        if controller is not None:
            obs_targets.append(
                Target(
                    "deploy",
                    router_url + "/deploy/status",
                    kind="json",
                    prefix="rt1_deploy_status",
                )
            )
        collector = Collector(
            tsdb,
            obs_targets,
            interval_s=args.collector_interval_s,
            alert_manager=alert_manager,
        )

        def _history(params: Dict[str, str]) -> Dict[str, Any]:
            # /history: no family = the series listing; family= one
            # family's windowed points across every label instance.
            # KeyError/ValueError propagate into the router's 400.
            window_s = float(params.get("window_s", 900.0))
            family = params.get("family", "")
            if not family:
                return {
                    "window_s": window_s,
                    "series": tsdb.series_index(),
                    "stats": tsdb.stats(),
                }
            series = [
                {
                    "family": family,
                    "labels": labels,
                    "points": tsdb.points(
                        family, labels=labels or None, window_s=window_s
                    ),
                }
                for labels in tsdb.instances(family)
            ]
            if not series:
                raise KeyError(family)
            return {
                "window_s": window_s, "family": family, "series": series,
            }

        router.alerts_status_fn = alert_manager.status
        router.history_fn = _history
        router.obs_metrics_text_fn = lambda: (
            alert_manager.prometheus_text() + collector.prometheus_text()
        )
        router.dashboard_html_fn = lambda: render_dashboard_html(
            tsdb,
            alert_manager=alert_manager,
            collector=collector,
            fleet_status=router.fleet_status(probe_metrics=False),
            deploy_status=(
                controller.deploy_gauges()
                if controller is not None
                else None
            ),
        )
        collector.start()


    stop_once = threading.Event()

    def _shutdown(signum, frame):  # noqa: ARG001 - signal signature
        if stop_once.is_set():
            return
        stop_once.set()
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _shutdown)
    signal.signal(signal.SIGINT, _shutdown)

    print(
        json.dumps(
            {
                "status": "serving",
                "role": "router",
                "host": httpd.server_address[0],
                "port": httpd.server_address[1],
                "replicas": args.replicas,
                "stub": bool(args.stub),
                "device": None if args.stub else args.device,
                "autoscale": (
                    {
                        "min": args.min_replicas,
                        "max": args.max_replicas,
                        "surge_dtype": args.surge_dtype or None,
                    }
                    if policy is not None
                    else None
                ),
                "admission": admission is not None,
                "collector": bool(args.collector),
                "deploy": (
                    {
                        "promote_from": args.promote_from,
                        "incumbent_step": controller.incumbent_step,
                        "canary_weight": args.canary_weight,
                    }
                    if controller is not None
                    else None
                ),
                "faults": args.faults or os.environ.get(faults.ENV_VAR, ""),
            }
        ),
        flush=True,
    )
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        if controller is not None:
            # Stop deciding BEFORE the drain flips: a promote/rollback
            # racing the shutdown would reload replicas mid-teardown.
            controller.stop()
        if collector is not None:
            # Stop scraping before teardown: a cycle racing the drain
            # would count shutdown 503s as target failures, and the
            # snapshot should capture the incident, not the funeral.
            collector.stop()
            obs_dir = args.obs_dir or args.workdir
            if obs_dir:
                tsdb.write_snapshot(
                    os.path.join(obs_dir, SNAPSHOT_BASENAME)
                )
        router.draining = True
        final = {
            "status": "stopped",
            "fleet": router.fleet_status(probe_metrics=True),
            "chaos": supervisor.summary(),
            # Elastic evidence: scale events + the per-dtype
            # replica-second cost ledger (always present; a fixed fleet
            # reports enabled=false with its own cost).
            "autoscale": supervisor.autoscale_summary(),
            "router_metrics": router.metrics_snapshot(),
            # The fleet's own judgement + crash-surviving exemplars.
            "slo": router.slo.summary(),
            "slow_requests": supervisor.slow_request_evidence(),
            # Promotion evidence (None without --promote_from): the full
            # gate/canary/promote/rollback timeline.
            "deploy": (
                controller.summary() if controller is not None else None
            ),
            # Metrics-plane evidence (None unless --collector): final
            # alert state + full transition history, per-target scrape
            # bookkeeping, and the TSDB's own bounds counters.
            "obs": (
                {
                    "alerts": alert_manager.status(),
                    "alert_events": list(supervisor.alert_events),
                    "collector": collector.stats(),
                    "tsdb": tsdb.stats(),
                }
                if collector is not None
                else None
            ),
        }
        supervisor.stop()
        # Replicas drained on SIGTERM (writing their in-flight capture
        # buffers); one last sweep moves those into staging.
        supervisor.sweep_captures()
        final["chaos"]["captures_swept"] = supervisor.captures_swept
        print(json.dumps(final), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
