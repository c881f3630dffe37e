"""PromotionController: the deploy state machine driving the fleet router.

The port's copy of `rt1_tpu/deploy/controller.py` (the port imports nothing of
the JAX package); it keeps the JAX module's names and behaviour.

The closed loop the ROADMAP names, one tick at a time:

    IDLE  --new checkpoint--> gate (inline, synchronous)
          --gate passed----> canary load (reload_one) + weighted split
    CANARY --clean window--> promote: rolling reload fleet-wide, clear
                             the split (canary sessions stay — they are
                             already on the promoted params)
           --burn breach---> rollback: demote the canary (sessions
                             re-home via failover, ``restarted: true``),
                             hot-swap the incumbent back onto the
                             canary replica; the incumbent fleet is
                             never touched

The controller owns no mechanism: checkpoint discovery is the torn-dir
tolerant `watcher`, the verdict is the injected ``gate_fn`` (auto-pass
for stub fleets, `deploy/gate.build_gate_fn` for real ones — signed to
disk either way via `verdict`), the traffic split and per-replica burn
attribution live in `serve/router.py`, and the promote/rollback
judgement is the pure `decision.CanaryJudge`. What remains here is the
state machine, its evidence (timeline events, ``rt1_deploy_*`` gauges,
the run-report summary), and the two chaos sites:

* ``promote@N`` — the N-th fleet-wide promote attempt raises before the
  roll starts; the controller must roll the canary back and leave the
  incumbent serving.
* ``canary_slo_breach@N`` — forces the observed canary burn over the
  threshold starting at canary-watch tick N (synthetic breach: client
  traffic stays clean; what's under test is the rollback path).

Import-light (stdlib + router/decision/watcher/verdict/faults): the
controller thread lives inside the fleet supervisor process, which never
pays the torch import for itself.
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

from rt1_tpu_torch.deploy import verdict as verdict_lib
from rt1_tpu_torch.deploy.decision import CanaryJudge, CanaryPolicy, CanarySignals
from rt1_tpu_torch.deploy.watcher import CheckpointWatcher
from rt1_tpu_torch.resilience import faults
from rt1_tpu_torch.serve.router import READY, Router

IDLE = "idle"
CANARY = "canary"

#: Watch-log ring bound: per-tick canary signals kept for the post-mortem
#: (the timeline keeps only state TRANSITIONS, so a long clean canary
#: doesn't bloat the summary).
WATCH_LOG_LIMIT = 256


class PromotionController:
    """Eval-gated promotion with router-weighted canary + auto-rollback.

    ``gate_fn(candidate_step, incumbent_step) -> verdict dict`` (must
    carry ``passed``); everything else is knobs. Drive it with
    :meth:`tick` (the tests' deterministic loop) or
    :meth:`start` (a daemon thread ticking every ``poll_interval_s``,
    the `--promote_from` supervisor arm).
    """

    def __init__(
        self,
        router: Router,
        workdir: str,
        *,
        gate_fn: Callable[[int, Optional[int]], Dict[str, Any]],
        policy: Optional[CanaryPolicy] = None,
        incumbent_step: Optional[int] = None,
        poll_interval_s: float = 1.0,
        verdict_dir: Optional[str] = None,
        signing_key: Optional[str] = None,
        min_incumbent_replicas: int = 1,
    ):
        self.router = router
        self.workdir = workdir
        self.gate_fn = gate_fn
        self.policy = policy or CanaryPolicy()
        self.poll_interval_s = poll_interval_s
        # The watcher's high-water mark starts at the incumbent: the
        # checkpoint the fleet booted from is not a candidate.
        self.watcher = CheckpointWatcher(workdir, seen_through=incumbent_step)
        self.incumbent_step = incumbent_step
        self.verdict_dir = verdict_dir or os.path.join(workdir, "deploy")
        self.signing_key = signing_key or verdict_lib.signing_key(
            self.verdict_dir
        )
        # A canary needs an incumbent fleet to compare against (and to
        # keep serving if it breaches): never canary below this many
        # OTHER ready replicas.
        self.min_incumbent_replicas = min_incumbent_replicas

        self.state = IDLE
        self.ticks = 0
        self.canary_tick = 0  # monotonic across episodes: the chaos index
        self.candidates_seen = 0
        self.gates_passed = 0
        self.gates_failed = 0
        self.promotions = 0
        self.rollbacks = 0
        self.promote_attempts = 0
        self.errors = 0
        self.timeline: List[Dict[str, Any]] = []
        self.watch_log: List[Dict[str, Any]] = []
        self.verdict_paths: List[str] = []

        self._judge = CanaryJudge(self.policy)
        self._candidate: Optional[int] = None
        self._canary_rid: Optional[int] = None
        self._canary_baseline = 0
        self._synthetic_breach = False  # latched for the canary episode
        # Last judged canary/fleet burn pair, held for the scrape between
        # ticks (0.0 while IDLE) — the `rt1_deploy_canary_burn` family
        # the CanarySLOBreach alert watches. Includes a synthetic breach's
        # forced burn: the alert plane must see exactly what the judge
        # saw, or a chaos-proved rollback would be alert-invisible.
        self._last_canary_burn = 0.0
        self._last_fleet_burn = 0.0
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name="rt1-deploy-controller", daemon=True
        )
        self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - the loop must survive
                self.errors += 1
                self._event("error", error=traceback.format_exc(limit=5))
            self._stop.wait(self.poll_interval_s)

    # ----------------------------------------------------------- the ticks

    def tick(self) -> None:
        """One controller step: candidate discovery + gate while IDLE,
        one burn-window judgement while CANARY."""
        with self._lock:
            self.ticks += 1
            state = self.state
        # Only this thread mutates controller state, so dispatching on a
        # snapshot is safe — and _tick_idle must run the (minutes-long,
        # device-heavy) gate WITHOUT the lock or every scrape of
        # /deploy/status and the rt1_deploy_* families would block on it.
        if state == IDLE:
            self._tick_idle()
        elif state == CANARY:
            with self._lock:
                self._tick_canary()

    def _event(self, event: str, **fields: Any) -> Dict[str, Any]:
        entry = {
            "tick": self.ticks,
            "unix_time": round(time.time(), 3),
            "event": event,
            **fields,
        }
        self.timeline.append(entry)
        return entry

    def _tick_idle(self) -> None:
        with self._lock:
            step = self.watcher.poll()
            if step is None:
                return
            self.candidates_seen += 1
            incumbent = self.incumbent_step
            self._event("candidate", step=step, incumbent=incumbent)
        # The gate runs unlocked: scrapes stay live while it evals.
        try:
            verdict = self.gate_fn(step, incumbent)
        except Exception as exc:  # noqa: BLE001 - a crashed gate rejects
            verdict = {"passed": False, "error": str(exc)}
        with self._lock:
            verdict = dict(verdict)
            verdict.setdefault("candidate_step", step)
            verdict.setdefault("incumbent_step", incumbent)
            path = os.path.join(self.verdict_dir, f"verdict_{step}.json")
            verdict_lib.write_verdict(path, verdict, self.signing_key)
            self.verdict_paths.append(path)
            if not verdict.get("passed"):
                self.gates_failed += 1
                self._event("gate_rejected", step=step, verdict_path=path)
                return
            self.gates_passed += 1
            self._event("gate_passed", step=step, verdict_path=path)
            self._start_canary(step)

    def _pick_canary(self) -> Optional[int]:
        """Highest-id READY replica, and only when enough OTHER ready
        replicas remain to hold the incumbent fleet. Highest id = the
        newest slot — base-tier low ids keep serving the steady state,
        mirroring the placement tiebreak."""
        ready = sorted(
            r.id for r in self.router.replicas() if r.state == READY
        )
        if len(ready) < self.min_incumbent_replicas + 1:
            return None
        return ready[-1]

    def _start_canary(self, step: int) -> None:
        rid = self._pick_canary()
        if rid is None:
            # No capacity to canary: the candidate stays gated-approved
            # but undeployed; surface it and retry on a later checkpoint
            # (the fleet is degraded — deploying into it would be worse).
            self._event("canary_unplaceable", step=step)
            return
        entry = self.router.reload_one(rid, step)
        if entry.get("status") != 200 or entry.get("recovered") is False:
            self._event("canary_load_failed", step=step, reload=entry)
            # Best effort: put the incumbent back on the replica.
            if self.incumbent_step is not None:
                self.router.reload_one(rid, self.incumbent_step)
            return
        snap = self.router.replica_slo_snapshot().get(rid, {})
        self._canary_baseline = int(snap.get("requests_total", 0))
        self._candidate = step
        self._canary_rid = rid
        self._judge.reset()
        self.router.set_canary(rid, self.policy.canary_weight)
        self.state = CANARY
        self._event(
            "canary_started",
            step=step,
            replica=rid,
            weight=self.policy.canary_weight,
        )

    def _tick_canary(self) -> None:
        self.canary_tick += 1
        rid = self._canary_rid
        snap = self.router.replica_slo_snapshot()
        entry = snap.get(rid, {})
        requests = int(entry.get("requests_total", 0)) - self._canary_baseline
        burn = float(entry.get("error_budget_burn_rolling", 0.0))
        fleet_burn = max(
            (
                float(e.get("error_budget_burn_rolling", 0.0))
                for r, e in snap.items()
                if r != rid
            ),
            default=0.0,
        )
        ready = any(
            r.id == rid and r.state == READY for r in self.router.replicas()
        )
        plan = faults.active()
        if (
            plan is not None
            and plan.should_fire("canary_slo_breach", index=self.canary_tick)
        ):
            # Latched for the rest of the episode: a real burn breach is
            # persistent too (the rolling window keeps reporting it), and
            # the rollback needs `breach_ticks` CONSECUTIVE breach ticks —
            # a one-tick blip is exactly what the hysteresis ignores.
            self._synthetic_breach = True
        synthetic = self._synthetic_breach
        if synthetic:
            # Synthetic breach: the observed burn is forced over both the
            # absolute threshold and the relative (strictly-above-fleet)
            # bar. Client traffic stays clean — the rollback PATH is what
            # the chaos run proves.
            burn = max(burn, self.policy.burn_threshold + fleet_burn)
        self._last_canary_burn = burn
        self._last_fleet_burn = fleet_burn
        signals = CanarySignals(
            canary_requests=max(requests, 0),
            canary_burn=burn,
            fleet_burn=fleet_burn,
            canary_ready=ready,
        )
        decision = self._judge.decide(signals)
        self.watch_log.append(
            {
                "canary_tick": self.canary_tick,
                "requests": signals.canary_requests,
                "burn": round(burn, 4),
                "fleet_burn": round(fleet_burn, 4),
                "ready": ready,
                "synthetic_breach": synthetic,
                "breach_streak": self._judge.breach_streak,
                "clean_streak": self._judge.clean_streak,
                "decision": decision,
            }
        )
        del self.watch_log[:-WATCH_LOG_LIMIT]
        if decision == "rollback":
            reason = "canary_died" if not ready else "slo_breach"
            if synthetic:
                reason = "slo_breach_injected"
            self._rollback(reason=reason, fleet_wide=False)
        elif decision == "promote":
            self._promote()

    def _promote(self) -> None:
        step = self._candidate
        self.promote_attempts += 1
        try:
            faults.maybe_fail(
                "promote", index=self.promote_attempts,
                what=f"fleet-wide promote of step {step}",
            )
            results = self.router.rolling_reload(step)
            failed = [
                r
                for r in results
                if r.get("status") != 200 or r.get("recovered") is False
            ]
            if failed:
                raise OSError(f"rolling reload failed: {failed}")
        except OSError as exc:
            self._event("promote_failed", step=step, error=str(exc))
            # A partial roll may have landed the candidate on some
            # replicas: the rollback is fleet-wide (idempotent for the
            # untouched ones).
            self._rollback(reason=f"promote_failed: {exc}", fleet_wide=True)
            return
        self.router.clear_canary()
        self.promotions += 1
        self._event(
            "promoted",
            step=step,
            previous_incumbent=self.incumbent_step,
            replicas=len(results),
        )
        self.incumbent_step = step
        self._end_canary()

    def _rollback(self, reason: str, fleet_wide: bool) -> None:
        step = self._candidate
        rid = self.router.demote_canary()
        restored: Any = None
        if self.incumbent_step is not None:
            if fleet_wide:
                restored = self.router.rolling_reload(self.incumbent_step)
            elif rid is not None:
                restored = self.router.reload_one(rid, self.incumbent_step)
        self.rollbacks += 1
        self._event(
            "rolled_back",
            step=step,
            replica=rid,
            reason=reason,
            incumbent=self.incumbent_step,
            restore=restored,
        )
        self._end_canary()

    def _end_canary(self) -> None:
        self._candidate = None
        self._canary_rid = None
        self._canary_baseline = 0
        self._synthetic_breach = False
        self._last_canary_burn = 0.0
        self._last_fleet_burn = 0.0
        self._judge.reset()
        self.state = IDLE

    # ------------------------------------------------------------ reporting

    def deploy_gauges(self) -> Dict[str, Any]:
        """Flat ``rt1_deploy_*`` scrape payload (strings render as
        info-style families, ``*_total`` as counters, the rest gauges —
        `obs/prometheus.render_deploy_snapshot`)."""
        with self._lock:
            return {
                "state": self.state,
                "ticks_total": self.ticks,
                "canary_ticks_total": self.canary_tick,
                "candidates_seen_total": self.candidates_seen,
                "gates_passed_total": self.gates_passed,
                "gates_failed_total": self.gates_failed,
                "promotions_total": self.promotions,
                "rollbacks_total": self.rollbacks,
                "promote_attempts_total": self.promote_attempts,
                "controller_errors_total": self.errors,
                "incumbent_step": (
                    -1 if self.incumbent_step is None else self.incumbent_step
                ),
                "candidate_step": (
                    -1 if self._candidate is None else self._candidate
                ),
                "canary_replica_id": (
                    -1 if self._canary_rid is None else self._canary_rid
                ),
                "canary_weight": self.policy.canary_weight,
                "canary_burn": self._last_canary_burn,
                "fleet_burn": self._last_fleet_burn,
                "breach_streak": self._judge.breach_streak,
                "clean_streak": self._judge.clean_streak,
            }

    def summary(self) -> Dict[str, Any]:
        """The post-mortem payload: gauges + policy + the full promotion
        timeline + the canary watch-log tail + verdict artifact paths."""
        with self._lock:
            return {
                **self.deploy_gauges(),
                "policy": self.policy.as_dict(),
                "workdir": self.workdir,
                "verdicts": list(self.verdict_paths),
                "timeline": list(self.timeline),
                "watch_log": list(self.watch_log),
            }
