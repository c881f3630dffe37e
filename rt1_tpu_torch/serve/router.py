"""Session-affine router for a fleet of serving replicas.

The port's copy of `rt1_tpu/serve/router.py` (the port imports nothing of the JAX
package); it keeps the JAX module's names, wire format and behaviour, with
two differences. An act that a replica answers after its session was
orphaned under it (a canary rollback, a drain or a death while the act was
in flight) leaves the orphan mark in place and is not flagged
``restarted``: the JAX router consumed the mark there, so the session's
`/release` then answered 404. And `GET /fleet/session?session_id=<id>`
reads the router's view of one session (its replica, its orphan and
migrated marks).

A single serving process (`python -m rt1_tpu_torch.serve`) holds one AOT-compiled
device batch; production traffic needs N of them. The catch is that a
session is not stateless: its rolling `network_state` (context image
tokens, action tokens, seq_idx) lives in a device slot on exactly ONE
replica (`serve/engine.py`), so a round-robin balancer would scatter a
session's observations across engines and corrupt every window. This
router keeps the affinity map — session id -> replica — and layers the
fleet behaviors on top:

* **Health-aware placement.** New sessions land on the READY replica with
  the fewest live sessions. Readiness comes from each replica's `/readyz`
  (warming / draining / reloading all report 503): a replica still paying
  its start-up or mid-hot-swap keeps serving its existing sessions but
  receives no new ones.
* **Bounded failover, surfaced honestly.** A transport-dead replica
  (connection refused/reset, timeout) fails the request over to a live
  one — the session's rolling window is gone with the dead engine, so the
  re-homed `/act` starts a fresh window (the engine zeroes the slot) and
  the response carries ``"restarted": true``. The client sees a context
  reset it can react to, never a 5xx. Every other session homed on the
  dead replica is marked orphaned and picks up the same flag on its next
  act. Failover is bounded (`max_failovers`); past it the router sheds
  with a retryable 503.
* **Durable sessions / live migration** (`serve/migrate.py`). Planned
  reclaims do NOT reset windows: the scale-down drain and the rolling
  reload export each victim session (replica `POST /session/export`)
  and import it onto the least-loaded compatible survivor BEFORE
  anything is orphaned — affinity remaps atomically and the client's
  next act continues token-identically, carrying ``"migrated": true``
  (an SLO-good outcome class) instead of ``"restarted": true``.
  `POST /rebalance` moves the N hottest sessions off an overloaded
  replica through the same path. A replica that restored a window from
  its crash-durability snapshot ring reports ``session_restored`` and
  is booked ``migrated`` too. A failed export/import (generation /
  window / engine-mode skew, injected fault) degrades to the legacy
  orphan/restart path — the flag flips back to ``restarted``, never a
  5xx.
* **Rolling checkpoint reload.** `POST /reload` walks the fleet one
  replica at a time: hot-swap (`serve/server.py` `/reload` — zero-downtime
  in-place), then wait for `/readyz` to report ready again before touching
  the next replica. At most one replica is ever in the not-ready drain
  state, so fleet capacity never dips by more than one engine.
* **Request tracing.** Every `/act` resolves one request id (client
  `X-RT1-Request-Id` header honored, else minted — `serve/reqtrace.py`),
  wraps the route in a `router_route` span carrying that id, and forwards
  the id to the replica in the same header, so the router span, the
  replica's `replica_act`/`batch_wait`/`device_step` spans, and the
  response's `request_id` all correlate in one Perfetto timeline.
* **SLO ledger.** Every routed request lands in one outcome class
  (ok / restarted / rejected / failed — `rt1_tpu/obs/slo.py`); the
  ledger's availability / error-budget-burn gauges ride `/metrics` as
  ``rt1_serve_slo_*`` and `GET /slo` returns the full judgement. Each
  outcome is ALSO attributed to the replica that answered (or died
  answering), so one replica's burn — the canary question — is
  distinguishable from the fleet's: per-replica ledgers ride
  `/fleet/status` (``slo`` sub-dict), the JSON `/metrics` fan-out
  (``replica_slo``), and Prometheus text
  (``rt1_serve_replica_outcome_total{replica_id=,outcome=}`` plus
  per-replica rolling availability/burn gauges). Outcomes no replica
  produced — admission sheds, no-capacity 503s, exhausted failover —
  stay fleet-wide only: blaming a replica for a request it never saw
  would poison a canary verdict.
* **Fleet metrics aggregation.** The router's `/metrics` fans out to
  every live replica's `/metrics` and merges the snapshots into ONE
  scrape target: JSON carries a ``replicas`` map keyed by replica id,
  Prometheus text renders each curated replica field as a labeled family
  (``rt1_serve_replica_*{replica_id="N"}``). `GET /fleet/slow_requests`
  fans out the slow-request exemplar rings the same way.
* **Admission control** (`AdmissionController`, opt-in). Per-client token
  buckets plus a global in-flight threshold shed overload as fast 429s
  in the ``rejected`` outcome class — priced honestly against the SLO
  ledger (latency objectives judge answered requests only; the per-class
  burn entries book every shed). Shed reasons ride
  ``rt1_serve_autoscale_shed_total{reason=}``.
* **Elastic-fleet hooks.** The autoscaling supervisor (`serve/fleet.py`)
  reads router-observed signals (`active_session_count` — sessions that
  acted inside the recency window, `inflight`, the SLO rolling burn) and
  drives scale-down through `deplace` (stop placement + orphan sessions
  so they re-home via the existing failover path) and `remove_replica`
  (purge the reaped id from every map, so `/metrics` and `/fleet/status`
  never report a ghost). Placement is tier-aware: load first, then the
  pinned base tier beats quantized surge replicas on ties.

The router carries no model code — stdlib HTTP + `ServeMetrics` only — so
it stays featherweight next to N torch replicas (`tests/test_torch_fleet.py`
checks that it imports no torch). Process supervision (spawn, restart,
chaos) lives in `serve/fleet.py`; the router only reads the replica table
the supervisor maintains.
"""

from __future__ import annotations

import collections
import json
import math
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler
from typing import Any, Callable, Dict, List, Optional, Tuple

from rt1_tpu_torch.obs import prometheus as obs_prometheus
from rt1_tpu_torch.obs import trace as obs_trace
from rt1_tpu_torch.obs.slo import OUTCOMES, SLOLedger, SLOObjectives
from rt1_tpu_torch.serve import migrate, reqtrace
from rt1_tpu_torch.serve.httpd import HTTPServer
from rt1_tpu_torch.serve.metrics import ServeMetrics

# Replica lifecycle as the router sees it. STARTING covers spawn ->
# ready-line -> first /readyz 200 (warm-up gating: never placed on);
# NOTREADY is a live replica whose /readyz says 503 (draining/reloading);
# DEAD is transport-dead or process-exited, awaiting supervisor respawn.
STARTING = "starting"
READY = "ready"
NOTREADY = "notready"
DEAD = "dead"


def post_json(
    url: str,
    payload: Dict[str, Any],
    timeout: float,
    headers: Optional[Dict[str, str]] = None,
) -> Tuple[int, Dict[str, Any]]:
    """POST JSON -> (status, body); status 0 = transport failure (the
    failover trigger: refused, reset, timeout, or a non-JSON corpse).
    `headers` rides extra metadata (the request-id propagation hop)."""
    req = urllib.request.Request(
        url,
        data=json.dumps(payload).encode("utf-8"),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        try:
            return exc.code, json.loads(exc.read())
        except Exception:  # noqa: BLE001 - non-JSON error body
            return exc.code, {"error": str(exc)}
    except Exception as exc:  # noqa: BLE001 - URLError/OSError/timeout/JSON
        return 0, {"error": str(exc)}


def get_json(url: str, timeout: float) -> Tuple[int, Dict[str, Any]]:
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        try:
            return exc.code, json.loads(exc.read())
        except Exception:  # noqa: BLE001
            return exc.code, {"error": str(exc)}
    except Exception as exc:  # noqa: BLE001
        return 0, {"error": str(exc)}


#: Placement preference order for capacity tiers: on a load tie, a new
#: session lands on the pinned full-precision base tier before a quantized
#: surge replica — the base tier is the parity canary, surge absorbs
#: overflow (docs/serving.md "Elastic fleet").
TIER_BASE = "base"
TIER_SURGE = "surge"
_TIER_RANK = {TIER_BASE: 0, TIER_SURGE: 1}


class Replica:
    """One serving process as the router tracks it (supervisor-owned
    fields — proc, restarts, tier, dtype, spawned_at — are written by
    serve/fleet.py)."""

    def __init__(self, replica_id: int, url: Optional[str] = None, proc=None):
        self.id = replica_id
        self.url = url  # base http://host:port, known once the ready-line
        #                 is read from the replica's stdout
        self.proc = proc
        self.state = STARTING
        self.restarts = 0  # times the supervisor respawned this slot
        self.consecutive_probe_failures = 0
        # Elastic-fleet capacity tiering: the initial fleet is the pinned
        # "base" tier; autoscaler-spawned surge replicas are "surge"
        # (typically quantized: int8 replicas hold fewer device param
        # bytes, `fleet.DTYPE_COST_WEIGHTS`). `dtype` and
        # `spawned_at` feed the replica-second cost accounting.
        self.tier = TIER_BASE
        self.dtype: Optional[str] = None
        self.spawned_at: Optional[float] = None

    def summary(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "url": self.url,
            "state": self.state,
            "restarts": self.restarts,
            "tier": self.tier,
            "dtype": self.dtype,
        }


class AdmissionController:
    """Router-side admission control: per-client token buckets + a global
    overload threshold, so overload produces fast ``rejected`` 429s
    instead of blown p99s.

    * **Token bucket per client id** (`client_id` payload field, else the
      session id): `rate_per_client` tokens/s refill up to `burst`; an
      /act with no token is shed with reason ``client_rate``. One hot
      client cannot starve the fleet.
    * **Global shed threshold**: when more than `max_inflight` requests
      are simultaneously mid-route through the router, new arrivals shed
      with reason ``overload`` — the fleet is saturated fleet-wide and a
      queued request would only blow the answered-request p99.

    Shedding is priced honestly: every 429 lands in the SLO ledger's
    ``rejected`` class (which burns error budget per-class) and the
    latency objectives are judged on answered requests only — a fleet
    cannot "fix" its p99 by shedding (`rt1_tpu/obs/slo.py`).

    Stdlib-only and clock-injectable (tests drive a fake monotonic
    clock). Zero `rate_per_client` disables the per-client bucket, zero
    `max_inflight` disables the global threshold — both default off, so
    a router without an admission config behaves exactly as before.
    """

    def __init__(
        self,
        rate_per_client: float = 0.0,
        burst: float = 8.0,
        max_inflight: int = 0,
        max_clients: int = 65536,
        clock=time.monotonic,
    ):
        if rate_per_client < 0 or burst < 1.0:
            # burst < 1 would mean no bucket ever reaches a whole token:
            # every client's every request shed, forever — a total
            # lockout, not a rate limit.
            raise ValueError(
                f"rate_per_client must be >= 0 and burst >= 1, got "
                f"{rate_per_client}/{burst}"
            )
        self.rate_per_client = rate_per_client
        self.burst = burst
        self.max_inflight = max_inflight
        self.max_clients = max_clients
        self._clock = clock
        self._lock = threading.Lock()
        # client id -> [tokens, last_refill]; LRU-bounded (a bucket is
        # two floats, so the 64k default costs ~6 MB worst case). A
        # client that went quiet long enough to be evicted re-enters
        # with a full bucket — exactly what its refill would have
        # reached. Limitation, stated honestly: with MORE simultaneously
        # active clients than max_clients, hot clients get continuously
        # evicted-and-refilled and the per-client rate stops binding;
        # size max_clients above the concurrent client population, and
        # rely on `max_inflight` as the id-cycling/overload backstop
        # (an adversary minting fresh client ids defeats any per-client
        # bucket by construction).
        self._buckets: collections.OrderedDict = collections.OrderedDict()

    def reject_reason(self, client_id: str, inflight: int) -> Optional[str]:
        """None = admitted; otherwise the shed-reason label. Checked (and
        the token spent) once per routed /act, before placement."""
        if self.max_inflight > 0 and inflight > self.max_inflight:
            return "overload"
        if self.rate_per_client <= 0:
            return None
        now = self._clock()
        with self._lock:
            bucket = self._buckets.get(client_id)
            if bucket is None:
                bucket = [self.burst, now]
                self._buckets[client_id] = bucket
                while len(self._buckets) > self.max_clients:
                    self._buckets.popitem(last=False)
            else:
                self._buckets.move_to_end(client_id)
            tokens, last = bucket
            tokens = min(
                self.burst, tokens + (now - last) * self.rate_per_client
            )
            if tokens < 1.0:
                bucket[0] = tokens
                bucket[1] = now
                return "client_rate"
            bucket[0] = tokens - 1.0
            bucket[1] = now
            return None

    def gauges(self) -> Dict[str, float]:
        """Token-bucket gauges for the router's /metrics merge."""
        with self._lock:
            tracked = len(self._buckets)
        return {
            "admission_clients_tracked": float(tracked),
            "admission_rate_per_client": self.rate_per_client,
            "admission_burst": self.burst,
            "admission_max_inflight": float(self.max_inflight),
        }


class Router:
    """Session-affinity routing table + failover + rolling reload."""

    def __init__(
        self,
        *,
        replica_timeout_s: float = 30.0,
        max_failovers: int = 2,
        reload_timeout_s: float = 300.0,
        max_tracked_sessions: int = 8192,
        metrics: Optional[ServeMetrics] = None,
        slo: Optional[SLOLedger] = None,
        metrics_probe_timeout_s: float = 3.0,
        admission: Optional[AdmissionController] = None,
    ):
        self._lock = threading.RLock()
        self._replicas: Dict[int, Replica] = {}
        # session id -> replica id, LRU-ordered and bounded: replicas cap
        # their own live state at max_sessions slots, so a router tracking
        # every id ever seen would leak memory and count long-evicted
        # sessions into "least-loaded" placement. Oldest entries fall off
        # past `max_tracked_sessions` (an evicted session that returns is
        # simply re-placed, same as after a replica-side LRU reclaim).
        self._sessions: collections.OrderedDict = collections.OrderedDict()
        self.max_tracked_sessions = max_tracked_sessions
        # Sessions whose replica died: their next successful act carries
        # "restarted": true so the client learns its context was reset.
        # Dict-as-ordered-set (values unused): bound eviction must drop
        # the OLDEST orphan first — set.pop() removed an arbitrary one,
        # which could silently eat a fresh orphan's restarted flag while
        # keeping a stale one forever.
        self._orphaned: Dict[str, None] = {}
        # Sessions whose window was carried to another replica intact
        # (live migration or ring restore): their next successful act
        # carries "migrated": true — continuity, not a reset. Same
        # ordered-set idiom and bound as the orphan map.
        self._migrated: Dict[str, None] = {}
        self.replica_timeout_s = replica_timeout_s
        self.max_failovers = max_failovers
        self.reload_timeout_s = reload_timeout_s
        self.metrics = metrics if metrics is not None else ServeMetrics()
        # The fleet's judge: every routed /act lands in exactly one
        # outcome class; gauges ride /metrics, GET /slo has the verdict.
        self.slo = slo if slo is not None else SLOLedger(SLOObjectives())
        # Per-replica attribution of the same outcome stream: one ledger
        # per replica that has ever answered (or died answering) an /act,
        # created lazily with the fleet ledger's objectives. A removed
        # replica's ledger is dropped with it (`remove_replica` — same
        # dropped-not-zeroed contract as the metrics fan-out).
        self._replica_slo: Dict[int, SLOLedger] = {}
        self.metrics_probe_timeout_s = metrics_probe_timeout_s
        # Admission control: None keeps the pre-elastic router
        # byte-identical — every request is admitted.
        self.admission = admission
        # Elastic-fleet occupancy signal: session id -> monotonic time of
        # its last answered act, recency-ordered. The affinity map counts
        # every session the router ever placed; the autoscaler needs the
        # sessions that are actually TALKING — active_session_count()
        # walks this from most-recent until it falls out of the window.
        self._act_times: collections.OrderedDict = collections.OrderedDict()
        # Requests currently mid-route (the router-side queue-depth
        # analogue): an autoscale signal and the global-shed input.
        self._inflight = 0
        self.draining = False
        # Weighted canary placement (deploy subsystem): while set, a
        # configured fraction of FRESH session placements land on the
        # canary replica instead of the least-loaded pick. Existing
        # sessions keep their affinity — a canary experiments on new
        # traffic, it never steals live windows.
        self._canary_id: Optional[int] = None
        self._canary_weight = 0.0
        self._fresh_placements = 0  # Bresenham counter, reset per canary
        # Deployment seam: fleet main points these at the
        # PromotionController when --promote_from is armed. The router
        # itself stays deploy-agnostic: when unset, /metrics and the
        # status surface are byte-identical to a fleet without a
        # controller.
        self.deploy_gauges_fn: Optional[Callable[[], Dict[str, Any]]] = None
        self.deploy_status_fn: Optional[Callable[[], Dict[str, Any]]] = None
        # Observability seam: fleet main points these at the
        # collector/TSDB/AlertManager when --collector is armed. Same
        # contract as the deploy seam: all None keeps every surface
        # (/alerts, /history, /dashboard, the appended rt1_alert_* /
        # rt1_obs_collector_* scrape families) absent and the unarmed
        # router byte-identical.
        self.alerts_status_fn: Optional[Callable[[], Dict[str, Any]]] = None
        # Elastic-drain seam: fleet main points this at the supervisor's
        # manual scale-down so `POST /scale_down` drives the migrating
        # drain end to end. Unset = 404 (routers without a supervisor).
        self.scale_down_fn: Optional[
            Callable[[Dict[str, Any]], Dict[str, Any]]
        ] = None
        self.history_fn: Optional[
            Callable[[Dict[str, str]], Dict[str, Any]]
        ] = None
        self.dashboard_html_fn: Optional[Callable[[], str]] = None
        self.obs_metrics_text_fn: Optional[Callable[[], str]] = None

    # ------------------------------------------------------------ registry

    def add_replica(self, replica: Replica) -> Replica:
        with self._lock:
            self._replicas[replica.id] = replica
        return replica

    def replicas(self) -> List[Replica]:
        with self._lock:
            return list(self._replicas.values())

    def set_state(self, replica_id: int, state: str) -> None:
        with self._lock:
            replica = self._replicas.get(replica_id)
            if replica is None:
                return
            replica.state = state
            if state == DEAD:
                self._orphan_sessions_locked(replica_id)

    def _orphan_sessions_locked(self, replica_id: int) -> None:
        lost = [s for s, r in self._sessions.items() if r == replica_id]
        for sid in lost:
            del self._sessions[sid]
            self._mark_orphaned_locked(sid)

    def _mark_orphaned_locked(self, session_id: str) -> None:
        """Insertion-ordered add + oldest-first bound eviction: a client
        that dies with its replica never comes back to consume its
        restarted flag, and repeated replica churn would otherwise grow
        this forever. Evicting oldest-first (not set.pop()'s arbitrary
        pick) guarantees a fresh orphan's flag survives eviction
        pressure."""
        self._orphaned.pop(session_id, None)  # re-orphan = newest again
        self._orphaned[session_id] = None
        while len(self._orphaned) > self.max_tracked_sessions:
            del self._orphaned[next(iter(self._orphaned))]

    def _mark_migrated_locked(self, session_id: str) -> None:
        """Same ordered-set discipline for the migrated-flag map."""
        self._migrated.pop(session_id, None)
        self._migrated[session_id] = None
        while len(self._migrated) > self.max_tracked_sessions:
            del self._migrated[next(iter(self._migrated))]

    def mark_dead(self, replica: Replica, reason: str = "") -> None:
        """Replica is gone: orphan its sessions so their next act re-homes
        (and reports restarted). Supervisor respawn flips it back later."""
        del reason  # kept for call-site readability / future logging
        self.set_state(replica.id, DEAD)

    def deplace(self, replica_id: int) -> None:
        """Scale-down drain, step one: stop placing on the replica
        (NOTREADY — its own /readyz will report 503 once it drains) and
        orphan its sessions NOW so their next act re-homes through the
        existing failover path with ``restarted: true``. The replica keeps
        answering whatever is already in flight; the supervisor reaps the
        process only after this and a drain grace."""
        with self._lock:
            replica = self._replicas.get(replica_id)
            if replica is None:
                return
            replica.state = NOTREADY
            self._orphan_sessions_locked(replica_id)

    def remove_replica(self, replica_id: int) -> Optional[Replica]:
        """Scale-down reclaim, final step: purge the reaped replica from
        the routing table entirely. Unlike a DEAD replica (which the
        supervisor will respawn into the same slot), a removed replica is
        GONE: `/fleet/status`, the `/metrics` fan-out, and the
        `rt1_serve_replica_*` labeled families stop reporting its id —
        dropped, not zeroed (a ghost `replica_up 0` forever would read as
        a permanently-failing probe, not a deliberate reclaim)."""
        with self._lock:
            replica = self._replicas.pop(replica_id, None)
            if replica is not None:
                self._orphan_sessions_locked(replica_id)
            self._replica_slo.pop(replica_id, None)
            return replica

    def _orphan_session(self, session_id: str, replica_id: int) -> None:
        """Re-home ONE session (replica slow or mid-respawn): unmap it and
        flag the restart, leaving its neighbors' state intact."""
        with self._lock:
            if self._sessions.get(session_id) == replica_id:
                del self._sessions[session_id]
            self._mark_orphaned_locked(session_id)

    # ----------------------------------------------------------- placement

    def session_count(self, replica_id: int) -> int:
        with self._lock:
            return sum(1 for r in self._sessions.values() if r == replica_id)

    def _place_locked(self, session_id: str) -> Optional[Replica]:
        ready = [r for r in self._replicas.values() if r.state == READY]
        if not ready:
            return None
        loads = {rid: 0 for rid in self._replicas}
        for rid in self._sessions.values():
            loads[rid] = loads.get(rid, 0) + 1

        def least_loaded(candidates):
            # Tier-aware least-loaded: load first (surge capacity absorbs
            # genuine overflow), then the pinned base tier on ties (the
            # full-precision parity canary keeps serving the steady
            # state).
            return min(
                candidates,
                key=lambda r: (
                    loads.get(r.id, 0),
                    _TIER_RANK.get(r.tier, 0),
                    r.id,
                ),
            )

        best = None
        canary = (
            self._replicas.get(self._canary_id)
            if self._canary_id is not None
            else None
        )
        if canary is not None and canary.state == READY:
            # Deterministic weighted split (Bresenham): the n-th fresh
            # placement goes to the canary iff the running floor of
            # n*weight ticks up — exactly weight of fresh sessions, no
            # RNG, replayable in tests. A not-READY canary (mid-reload)
            # simply drops out of the split until it recovers.
            n = self._fresh_placements
            self._fresh_placements = n + 1
            w = self._canary_weight
            if math.floor((n + 1) * w) > math.floor(n * w):
                best = canary
            else:
                rest = [r for r in ready if r.id != canary.id]
                if rest:
                    best = least_loaded(rest)
                # A fleet where the canary is the only ready replica
                # falls through: serving beats the split.
        if best is None:
            best = least_loaded(ready)
        self._sessions[session_id] = best.id
        self._sessions.move_to_end(session_id)
        while len(self._sessions) > self.max_tracked_sessions:
            stale, _ = self._sessions.popitem(last=False)
            self._orphaned.pop(stale, None)
            self._migrated.pop(stale, None)
        return best

    # -------------------------------------------------------------- canary

    def set_canary(self, replica_id: int, weight: float) -> None:
        """Start the weighted canary split: `weight` of FRESH session
        placements land on `replica_id` (its existing sessions and every
        other session's affinity are untouched). The Bresenham counter
        resets so each canary's split starts deterministically."""
        if not 0.0 < weight <= 1.0:
            raise ValueError(f"canary weight must be in (0, 1], got {weight}")
        with self._lock:
            if replica_id not in self._replicas:
                raise KeyError(f"unknown replica {replica_id}")
            self._canary_id = replica_id
            self._canary_weight = float(weight)
            self._fresh_placements = 0

    def clear_canary(self) -> Optional[int]:
        """End the split, keeping the canary's sessions where they are —
        the PROMOTE path (the canary's checkpoint just became the fleet's,
        so its sessions are already on the right params)."""
        with self._lock:
            rid = self._canary_id
            self._canary_id = None
            self._canary_weight = 0.0
            self._fresh_placements = 0
            return rid

    def demote_canary(self) -> Optional[int]:
        """End the split AND evict the canary's sessions — the ROLLBACK
        path: every session on the breaching candidate re-homes through
        the existing failover machinery (next act lands on an incumbent
        replica with ``restarted: true``, never a 5xx)."""
        with self._lock:
            rid = self._canary_id
            self._canary_id = None
            self._canary_weight = 0.0
            self._fresh_placements = 0
            if rid is not None:
                self._orphan_sessions_locked(rid)
            return rid

    def canary_status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "replica_id": self._canary_id,
                "weight": self._canary_weight,
                "fresh_placements": self._fresh_placements,
            }

    def reload_one(
        self, replica_id: int, step: Optional[int] = None
    ) -> Dict[str, Any]:
        """Hot-swap ONE replica — the canary-load / canary-rollback
        primitive. Same entry shape as a `rolling_reload` element: POST
        `/reload`, then wait for `/readyz` to recover (``recovered``), so
        the caller knows the replica is serving the requested step before
        any traffic decision leans on it."""
        with self._lock:
            replica = self._replicas.get(replica_id)
        if replica is None:
            return {"replica": replica_id, "skipped": "unknown"}
        if replica.state == DEAD or replica.url is None:
            return {"replica": replica_id, "skipped": replica.state}
        payload = {} if step is None else {"step": step}
        status, body = post_json(
            replica.url + "/reload", payload, self.reload_timeout_s
        )
        entry = {"replica": replica_id, "status": status, **body}
        if status == 0:
            self.mark_dead(replica, reason=body.get("error", ""))
        elif status == 200:
            entry["recovered"] = self._await_ready(replica)
            if not entry["recovered"]:
                entry["ok"] = False
            self.metrics.observe_reload()
        return entry

    def _replica_for(self, session_id: str) -> Optional[Replica]:
        """Existing assignment if its replica is still routable, else a
        fresh placement on the least-loaded ready replica (None when the
        fleet has no ready replica)."""
        with self._lock:
            rid = self._sessions.get(session_id)
            if rid is not None:
                replica = self._replicas.get(rid)
                # Affinity overrides readiness for NOTREADY (draining/
                # reloading replicas keep serving existing sessions);
                # only DEAD forces a re-placement.
                if replica is not None and replica.state != DEAD:
                    self._sessions.move_to_end(session_id)  # LRU touch
                    return replica
                del self._sessions[session_id]
                self._mark_orphaned_locked(session_id)
            return self._place_locked(session_id)

    # ------------------------------------------------------------- routing

    def route_act(
        self,
        payload: Dict[str, Any],
        headers=None,
    ) -> Tuple[int, Dict[str, Any]]:
        """Forward one /act with affinity + bounded failover. A replica
        death mid-request becomes `restarted: true` on the retried 200,
        never a client-visible 5xx.

        One request id spans the whole route: resolved here (client header
        / payload / minted), carried by the `router_route` span, forwarded
        to the replica in the `X-RT1-Request-Id` header, and echoed in the
        response body — including error bodies, so a client can quote the
        id of the exact request that was shed. Every exit classifies into
        the SLO ledger with the router-side wall time.
        """
        request_id = reqtrace.request_id_from(headers, payload)
        t0 = time.perf_counter()
        with self._lock:
            self._inflight += 1
        try:
            with obs_trace.span(
                "router_route",
                request_id=request_id,
                session=payload.get("session_id"),
            ):
                status, body, served_by = self._route_act_inner(
                    payload, request_id
                )
        finally:
            with self._lock:
                self._inflight -= 1
        body.setdefault("request_id", request_id)
        elapsed = time.perf_counter() - t0
        if status == 200 and "error" not in body:
            if body.get("migrated"):
                outcome = "migrated"
            elif body.get("restarted"):
                outcome = "restarted"
            else:
                outcome = "ok"
            self._note_act(payload.get("session_id"))
            # Router-side per-task labels under the single-replica family
            # names: fleet-wide task totals on the
            # router scrape, per-replica splits in the aggregated
            # rt1_serve_replica_task_* families.
            task = payload.get("task")
            self.metrics.observe_task_request(
                task if isinstance(task, str) else None,
                new_session=body.get("session_started", False),
            )
        elif status in (429, 503):
            # 429 = admission-control shed, 503 = backpressure/no-capacity
            # shed; both are the `rejected` outcome class, priced against
            # the error budget per-class by the SLO ledger.
            outcome = "rejected"
        else:
            outcome = "failed"
        self.slo.observe(outcome, elapsed)
        # Attribute the same outcome to the replica that produced it.
        # `served_by` is None for requests no replica answered (admission
        # shed, draining, no capacity, failover budget exhausted) — those
        # stay fleet-wide only.
        self._observe_replica(served_by, outcome, elapsed)
        return status, body

    def _observe_replica(
        self, replica_id: Optional[int], outcome: str, elapsed: float
    ) -> None:
        """Book one outcome on the serving replica's own ledger (lazily
        created with the fleet ledger's objectives). None = no replica
        produced this response; the fleet-wide ledger already has it."""
        if replica_id is None:
            return
        with self._lock:
            ledger = self._replica_slo.get(replica_id)
            if ledger is None:
                ledger = SLOLedger(self.slo.objectives)
                self._replica_slo[replica_id] = ledger
        ledger.observe(outcome, elapsed)

    def replica_slo_snapshot(self) -> Dict[int, Dict[str, Any]]:
        """Per-replica outcome attribution, keyed by replica id: the
        outcome-class counts plus the rolling availability / burn pair a
        canary judgement reads. Only replicas that ever answered appear;
        a removed replica's entry is dropped with it."""
        with self._lock:
            ledgers = sorted(self._replica_slo.items())
        out: Dict[int, Dict[str, Any]] = {}
        for rid, ledger in ledgers:
            gauges = ledger.gauges()
            out[rid] = {
                "outcomes": {
                    o: int(gauges[f"slo_requests_{o}"]) for o in OUTCOMES
                },
                "requests_total": int(gauges["slo_requests_total"]),
                "availability_rolling": gauges["slo_availability_rolling"],
                "error_budget_burn_rolling": gauges[
                    "slo_error_budget_burn_rolling"
                ],
            }
        return out

    def _note_act(self, session_id) -> None:
        """Record an answered act for the occupancy signal (recency
        order; bounded alongside the affinity map)."""
        if not isinstance(session_id, str):
            return
        with self._lock:
            self._act_times[session_id] = time.monotonic()
            self._act_times.move_to_end(session_id)
            while len(self._act_times) > self.max_tracked_sessions:
                self._act_times.popitem(last=False)

    def active_session_count(self, window_s: float) -> int:
        """Sessions that acted within the last `window_s` seconds — the
        autoscaler's occupancy numerator. A session that went quiet stops
        counting when the window passes it, even though its affinity-map
        entry (and its replica-side slot) still exists."""
        cutoff = time.monotonic() - window_s
        count = 0
        with self._lock:
            for _, t in reversed(self._act_times.items()):
                if t < cutoff:
                    break  # recency-ordered: everything older is stale too
                count += 1
        return count

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def _route_act_inner(
        self, payload: Dict[str, Any], request_id: str
    ) -> Tuple[int, Dict[str, Any], Optional[int]]:
        """Route one /act -> (status, body, served_by). ``served_by`` is
        the id of the replica whose answer (or terminal error) this is,
        None when no replica produced the response — the per-replica SLO
        attribution key."""
        session_id = payload.get("session_id")
        if not isinstance(session_id, str) or not session_id:
            return (
                400,
                {"error": "'session_id' must be a non-empty string"},
                None,
            )
        if self.draining:
            return 503, {"error": "draining"}, None
        if self.admission is not None:
            # Admission control BEFORE placement: a shed request must be
            # fast (no replica hop) and cheap (no affinity mutation). The
            # client id defaults to the session id; a client running many
            # sessions can declare `client_id` to share one bucket.
            client = payload.get("client_id")
            reason = self.admission.reject_reason(
                client if isinstance(client, str) and client else session_id,
                self.inflight,
            )
            if reason is not None:
                self.metrics.observe_shed(reason)
                return (
                    429,
                    {
                        "error": f"admission control shed this request "
                        f"({reason})",
                        "reason": reason,
                        # Explicitly NOT retry:true — the client should
                        # back off, not hammer the token bucket (contrast
                        # the transient 503 busy path).
                        "retry": False,
                    },
                    None,
                )
        fwd_headers = {reqtrace.REQUEST_ID_HEADER: request_id}
        last_error = "no ready replicas"
        for _ in range(self.max_failovers + 1):
            replica = self._replica_for(session_id)
            if replica is None:
                return (
                    503,
                    {"error": "no ready replicas", "retry": True},
                    None,
                )
            # Snapshot the url: the supervisor may respawn this replica
            # (resetting url to None) between our request and the probe.
            target_url = replica.url
            if target_url is None:
                self._orphan_session(session_id, replica.id)
                continue
            status, body = post_json(
                target_url + "/act",
                payload,
                self.replica_timeout_s,
                headers=fwd_headers,
            )
            if status == 0:
                # Transport failure. Dead and merely-slow look identical
                # from one request (a timeout is also status 0), but the
                # blast radius differs: probe /readyz once to tell them
                # apart before orphaning EVERY session homed there.
                last_error = body.get("error", "transport failure")
                probe, _ = get_json(target_url + "/readyz", timeout=2.0)
                if probe == 0:
                    # Probe dead too: the replica is gone (or wedged —
                    # the supervisor's hang detector will kill it).
                    self.mark_dead(replica, reason=last_error)
                else:
                    # Alive but slow for THIS request: re-home only this
                    # session (its window may have advanced server-side —
                    # honesty demands the restarted flag either way) and
                    # leave its neighbors' state intact.
                    self._orphan_session(session_id, replica.id)
                continue
            if status == 200:
                with self._lock:
                    if self._sessions.get(session_id) != replica.id:
                        # Orphaned (rollback, drain, death) or moved while
                        # this act was in flight: the replica answered from
                        # the window it held before that event, so the
                        # reply is neither a restart nor a migration. The
                        # marks stay for the act that lands on the
                        # session's next home, and /release still finds
                        # the orphan mark (200, not "unknown session").
                        # Re-mapping the session to this replica instead
                        # would undo the eviction the orphaning decided.
                        # (The JAX router pops the mark here and flags the
                        # stale reply `restarted`.)
                        pass
                    elif session_id in self._migrated:
                        # Live migration carried the window intact —
                        # continuity, not a reset. The migrated flag
                        # consumes any stale orphan mark from an earlier
                        # event on the same session.
                        self._migrated.pop(session_id, None)
                        self._orphaned.pop(session_id, None)
                        body["migrated"] = True
                        self.metrics.observe_session_migration()
                    elif session_id in self._orphaned:
                        self._orphaned.pop(session_id, None)
                        if body.get("session_restored"):
                            # The replica restored the orphan's window
                            # from its crash-durability snapshot ring —
                            # the event happened, but the window
                            # survived it.
                            body["migrated"] = True
                            self.metrics.observe_session_migration()
                        else:
                            body["restarted"] = True
                            self.metrics.observe_session_restart()
                    elif body.get("session_restored"):
                        # Restored without the router ever noticing the
                        # death (e.g. the supervisor respawned between
                        # acts): still preserved continuity.
                        body["migrated"] = True
                        self.metrics.observe_session_migration()
            return status, body, replica.id
        return (
            503,
            {
                "error": f"failover budget exhausted: {last_error}",
                "retry": True,
            },
            None,
        )

    def session_view(self, session_id: str) -> Dict[str, Any]:
        """The router's view of one session (`GET /fleet/session`): the
        replica it is mapped to (None when unmapped) and whether it carries
        the orphan or the migrated mark."""
        with self._lock:
            return {
                "session_id": session_id,
                "replica_id": self._sessions.get(session_id),
                "orphaned": session_id in self._orphaned,
                "migrated": session_id in self._migrated,
            }

    def route_session_op(
        self, path: str, payload: Dict[str, Any]
    ) -> Tuple[int, Dict[str, Any]]:
        """/reset places (a reset starts a fresh window anywhere);
        /release forwards to the owner and always clears the local map."""
        session_id = payload.get("session_id")
        if not isinstance(session_id, str) or not session_id:
            return 400, {"error": "'session_id' must be a non-empty string"}
        if path == "/release":
            with self._lock:
                rid = self._sessions.pop(session_id, None)
                was_orphaned = session_id in self._orphaned
                self._orphaned.pop(session_id, None)
                self._migrated.pop(session_id, None)
                # A released session is done talking: drop it from the
                # occupancy signal NOW (an orphaned session stays counted
                # — its client is alive and about to re-home).
                self._act_times.pop(session_id, None)
                replica = self._replicas.get(rid) if rid is not None else None
            if replica is None or replica.state == DEAD:
                # Never-seen is a client error; a session whose replica
                # died (orphaned, or mapped to a dead/gone replica) has no
                # server-side slot left to free — that release is a
                # successful no-op, not a 404.
                if rid is None and not was_orphaned:
                    return 404, {"error": f"unknown session {session_id!r}"}
                return 200, {"ok": True, "note": "replica was dead"}
            return post_json(
                replica.url + path, payload, self.replica_timeout_s
            )
        replica = self._replica_for(session_id)
        if replica is None:
            return 503, {"error": "no ready replicas", "retry": True}
        status, body = post_json(
            replica.url + path, payload, self.replica_timeout_s
        )
        if status == 0:
            self.mark_dead(replica, reason=body.get("error", ""))
            return 503, {"error": "replica died during reset", "retry": True}
        if status == 200:
            with self._lock:
                self._orphaned.pop(session_id, None)  # an explicit reset
                #   is a client-acknowledged fresh window, not a restart
                self._migrated.pop(session_id, None)
        return status, body

    # ----------------------------------------------------- live migration

    def _compat_surface(self, url: str) -> Optional[Tuple[Any, Any, Any]]:
        """(checkpoint_generation, window, cached_inference) from a
        replica's /healthz, or None when the probe failed or the replica
        predates the migration contract (no generation key — nothing to
        compare, let the import itself decide)."""
        status, body = get_json(url + "/healthz", timeout=5.0)
        if status != 200 or "checkpoint_generation" not in body:
            return None
        return (
            body.get("checkpoint_generation"),
            body.get("window"),
            bool(body.get("cached_inference", False)),
        )

    def migrate_sessions_from(
        self,
        replica_id: int,
        reason: str = "",
        session_ids: Optional[List[str]] = None,
        orphan_on_failure: bool = False,
    ) -> Dict[str, Any]:
        """Carry sessions off `replica_id` onto the least-loaded READY
        compatible survivor, one export/import round-trip each
        (`serve/migrate.py`), remapping affinity atomically on success —
        the client's next act continues token-identically with
        ``migrated: true``.

        `session_ids` narrows the move (the /rebalance path); None moves
        everything homed there (the drain / rolling-reload paths). The
        pre-flight /healthz compatibility guard skips targets whose
        checkpoint generation / window / engine mode differ from the
        source — a doomed import would only burn failure counters (the
        import itself still refuses, 409, if skew appears between probe
        and import). Sessions that could not migrate stay mapped unless
        `orphan_on_failure` (the drain path orphans them NOW so the
        legacy restart path picks them up; the rolling-reload path leaves
        them in place — the in-place hot-swap preserves their windows).

        Never raises; the summary dict reports attempted / migrated /
        failed / skipped with per-session detail.
        """
        out: Dict[str, Any] = {
            "replica_id": replica_id,
            "reason": reason,
            "attempted": 0,
            "migrated": 0,
            "failed": 0,
            "sessions": [],
        }
        with self._lock:
            source = self._replicas.get(replica_id)
            homed = [
                s for s, r in self._sessions.items() if r == replica_id
            ]
        if source is None or source.url is None:
            out["skipped"] = "source unknown or urlless"
            return out
        if session_ids is not None:
            homed_set = set(homed)
            homed = [s for s in session_ids if s in homed_set]
        if not homed:
            out["skipped"] = "no sessions to migrate"
            return out
        source_surface = self._compat_surface(source.url)
        for sid in homed:
            target = self._pick_migration_target(
                replica_id, source_surface
            )
            if target is None:
                entry = {
                    "session_id": sid,
                    "ok": False,
                    "error": "no compatible ready survivor",
                }
                out["failed"] += 1
            else:
                out["attempted"] += 1
                result = migrate.migrate_session(
                    source.url,
                    target.url,
                    sid,
                    timeout_s=self.replica_timeout_s,
                )
                entry = {**result, "target_id": target.id}
                if result.get("ok"):
                    with self._lock:
                        # Atomic remap: the next act routes straight to
                        # the importer (no orphan window in between).
                        self._sessions[sid] = target.id
                        self._sessions.move_to_end(sid)
                        self._orphaned.pop(sid, None)
                        self._mark_migrated_locked(sid)
                    out["migrated"] += 1
                    # Free the source's now-stale copy (best-effort: a
                    # draining/dying source may not answer, and that's
                    # fine — it's about to take the slot with it). The
                    # slot must not leak on a live source (rebalance),
                    # and a later failover back must not find a stale
                    # window to silently continue. keep_snapshot: the
                    # shared ring file now backs the TARGET's session —
                    # the usual release-drops-snapshot rule would strand
                    # the importer's crash durability until its next act.
                    status, _body = post_json(
                        source.url.rstrip("/") + "/release",
                        {"session_id": sid, "keep_snapshot": True},
                        self.replica_timeout_s,
                    )
                    entry["source_released"] = status == 200
                else:
                    out["failed"] += 1
            if not entry.get("ok") and orphan_on_failure:
                self._orphan_session(sid, replica_id)
                entry["orphaned"] = True
            out["sessions"].append(entry)
        return out

    def _pick_migration_target(
        self,
        source_id: int,
        source_surface: Optional[Tuple[Any, Any, Any]],
    ) -> Optional[Replica]:
        """Least-loaded READY survivor whose compatibility surface
        matches the source's (tier-aware on ties, same rule as
        placement). Recomputed per session: each successful migration
        shifts the load it balances against."""
        with self._lock:
            candidates = [
                r
                for r in self._replicas.values()
                if r.id != source_id
                and r.state == READY
                and r.url is not None
            ]
            loads: Dict[int, int] = {}
            for rid in self._sessions.values():
                loads[rid] = loads.get(rid, 0) + 1
        if source_surface is not None:
            candidates = [
                r
                for r in candidates
                if self._compat_surface(r.url) == source_surface
            ]
        if not candidates:
            return None
        return min(
            candidates,
            key=lambda r: (
                loads.get(r.id, 0),
                _TIER_RANK.get(r.tier, 0),
                r.id,
            ),
        )

    def hottest_sessions(self, replica_id: int, count: int) -> List[str]:
        """The `count` most recently acting sessions homed on
        `replica_id` — the /rebalance victim pick (recency from the
        occupancy signal; a session that never acted can't be hot)."""
        with self._lock:
            homed = {
                s for s, r in self._sessions.items() if r == replica_id
            }
            out: List[str] = []
            for sid in reversed(self._act_times):
                if sid in homed:
                    out.append(sid)
                    if len(out) >= count:
                        break
            return out

    def rebalance(
        self, replica_id: int, count: int = 1
    ) -> Tuple[int, Dict[str, Any]]:
        """POST /rebalance: migrate the `count` hottest sessions off an
        overloaded replica through the same export/import path the drain
        uses. Failed migrations leave sessions where they are (the
        replica is overloaded, not dying — a forced restart would be
        strictly worse than staying hot)."""
        with self._lock:
            known = replica_id in self._replicas
        if not known:
            return 404, {"error": f"unknown replica {replica_id}"}
        victims = self.hottest_sessions(replica_id, count)
        result = self.migrate_sessions_from(
            replica_id, reason="rebalance", session_ids=victims
        )
        return 200, {"ok": result["failed"] == 0, **result}

    # ------------------------------------------------------------- reload

    def rolling_reload(
        self, step: Optional[int] = None
    ) -> List[Dict[str, Any]]:
        """Hot-swap a checkpoint across the fleet one replica at a time.

        Each replica's own `/reload` is already zero-downtime; the rolling
        walk bounds fleet impact: wait for `/readyz` to recover before
        moving on, so at most one replica is in the reloading drain state
        at any moment. A replica that fails to reload is recorded and the
        roll continues — a bad checkpoint rejected by `swap_variables`
        leaves every replica serving the old params.
        """
        results = []
        for replica in sorted(self.replicas(), key=lambda r: r.id):
            if replica.state == DEAD or replica.url is None:
                results.append(
                    {"replica": replica.id, "skipped": replica.state}
                )
                continue
            # Durable sessions: carry this replica's windows to a
            # compatible survivor before it pays the swap, so no session
            # waits out the reload. NOT orphan-on-failure — the in-place
            # hot-swap preserves any session that could not move (late in
            # the roll every survivor is already on the new generation,
            # so the compatibility guard correctly keeps them home).
            migration = self.migrate_sessions_from(
                replica.id, reason="rolling_reload"
            )
            payload = {} if step is None else {"step": step}
            status, body = post_json(
                replica.url + "/reload", payload, self.reload_timeout_s
            )
            entry = {"replica": replica.id, "status": status, **body}
            if migration["attempted"] or migration["failed"]:
                entry["sessions_migrated"] = migration["migrated"]
                entry["migration_failed"] = migration["failed"]
            if status == 0:
                self.mark_dead(replica, reason=body.get("error", ""))
            elif status == 200:
                # A swap that lands but never returns to ready degraded
                # the fleet — surface it, don't report a clean roll.
                entry["recovered"] = self._await_ready(replica)
                if not entry["recovered"]:
                    entry["ok"] = False
            results.append(entry)
        if any(r.get("status") == 200 for r in results):
            self.metrics.observe_reload()  # one counted roll, however driven
        return results

    def _await_ready(self, replica: Replica, timeout: float = 60.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            status, _ = get_json(replica.url + "/readyz", timeout=5.0)
            if status == 200:
                self.set_state(replica.id, READY)
                return True
            time.sleep(0.05)
        return False

    # -------------------------------------------------------------- status

    def ready_count(self) -> int:
        with self._lock:
            return sum(
                1 for r in self._replicas.values() if r.state == READY
            )

    def _gauges(self) -> Dict[str, Any]:
        with self._lock:
            states: Dict[str, int] = {}
            for replica in self._replicas.values():
                states[replica.state] = states.get(replica.state, 0) + 1
            out = {
                "replicas_total": len(self._replicas),
                "replicas_ready": states.get(READY, 0),
                "replicas_dead": states.get(DEAD, 0),
                "sessions_total": len(self._sessions),
                "sessions_orphaned": len(self._orphaned),
                "replica_restarts_total": sum(
                    r.restarts for r in self._replicas.values()
                ),
                "draining": int(self.draining),
                "ready": int(states.get(READY, 0) > 0),
                "router_inflight": self._inflight,
                # Canary split state (-1 = no canary): dashboards correlate
                # a replica's burn series with the window it was canary.
                "canary_replica_id": (
                    -1 if self._canary_id is None else self._canary_id
                ),
                "canary_weight": self._canary_weight,
            }
        if self.admission is not None:
            out.update(self.admission.gauges())
        return out

    def metrics_snapshot(self) -> Dict[str, Any]:
        """Router-own counters + fleet gauges + the SLO ledger's
        ``slo_*`` gauges (exposed as ``rt1_serve_slo_*`` in text)."""
        return self.metrics.snapshot(**self._gauges(), **self.slo.gauges())

    def metrics_prometheus(self) -> str:
        return self.metrics.prometheus_text(
            **self._gauges(), **self.slo.gauges()
        )

    # -------------------------------------------------- fleet aggregation

    def _fan_out_get(self, path: str) -> Dict[int, Optional[Dict[str, Any]]]:
        """Probe `path` on every live replica CONCURRENTLY (one thread
        each): the scrape path must cost ~one probe timeout total, not
        replicas x timeout — a hung replica during an incident is exactly
        when the aggregated view matters most. {replica_id: body | None};
        None (dead, booting, probe failed) is preserved: the aggregated
        view reports absence (``replica_up 0``) instead of silently
        narrowing the fleet."""
        replicas = sorted(self.replicas(), key=lambda r: r.id)
        out: Dict[int, Optional[Dict[str, Any]]] = {
            r.id: None for r in replicas
        }

        def probe(replica: Replica) -> None:
            status, body = get_json(
                replica.url + path, timeout=self.metrics_probe_timeout_s
            )
            if status == 200 and isinstance(body, dict):
                out[replica.id] = body  # distinct key per thread: no lock

        threads = [
            threading.Thread(target=probe, args=(r,), daemon=True)
            for r in replicas
            if r.url is not None and r.state != DEAD
        ]
        for t in threads:
            t.start()
        deadline = time.monotonic() + self.metrics_probe_timeout_s + 1.0
        for t in threads:
            t.join(timeout=max(deadline - time.monotonic(), 0.0))
        return out

    def probe_replica_metrics(self) -> Dict[int, Optional[Dict[str, Any]]]:
        """Fan out to every registered replica's `/metrics` (JSON)."""
        return self._fan_out_get("/metrics")

    def fleet_metrics_snapshot(self) -> Dict[str, Any]:
        """The aggregated JSON view: the router's own snapshot (incl. SLO
        gauges) plus every replica's full snapshot under ``replicas``."""
        replicas = self.probe_replica_metrics()
        out = {
            **self.metrics_snapshot(),
            "replicas": {str(rid): snap for rid, snap in replicas.items()},
            "replica_slo": {
                str(rid): entry
                for rid, entry in self.replica_slo_snapshot().items()
            },
        }
        if self.deploy_gauges_fn is not None:
            out["deploy"] = self.deploy_gauges_fn()
        return out

    def fleet_metrics_prometheus(self) -> str:
        """One exposition body for the whole fleet: router families at
        their usual names + ``rt1_serve_replica_*{replica_id="N"}`` —
        plus the ``rt1_deploy_*`` families when a promotion controller
        is attached (one scrape target tells the whole rollout story)."""
        text = obs_prometheus.render_fleet_snapshot(
            self.metrics_snapshot(),
            self.probe_replica_metrics(),
            replica_slo=self.replica_slo_snapshot(),
        )
        if self.deploy_gauges_fn is not None:
            text += obs_prometheus.render_deploy_snapshot(
                self.deploy_gauges_fn()
            )
        if self.obs_metrics_text_fn is not None:
            # rt1_alert_* + rt1_obs_collector_* families when the metrics
            # plane is armed: the ops scrape carries its own health.
            text += self.obs_metrics_text_fn()
        return text

    def fleet_slow_requests(self) -> Dict[str, Any]:
        """Fan out `/slow_requests`: every live replica's exemplar ring,
        keyed by replica id (None for a replica that could not answer)."""
        probed = self._fan_out_get("/slow_requests")
        return {"replicas": {str(rid): body for rid, body in probed.items()}}

    def fleet_status(self, probe_metrics: bool = True) -> Dict[str, Any]:
        """Per-replica table for /fleet/status; with `probe_metrics`, each
        live replica's own /metrics is sampled for the single-compile and
        reload evidence the chaos bench asserts on."""
        replicas = []
        replica_slo = self.replica_slo_snapshot()
        for replica in sorted(self.replicas(), key=lambda r: r.id):
            entry = replica.summary()
            entry["sessions"] = self.session_count(replica.id)
            slo = replica_slo.get(replica.id)
            if slo is not None:
                entry["slo"] = slo
            if probe_metrics and replica.url and replica.state != DEAD:
                status, body = get_json(replica.url + "/metrics", timeout=5.0)
                if status == 200:
                    entry["metrics"] = {
                        k: body.get(k)
                        for k in (
                            "compile_count",
                            "bucket_count",
                            "reloads_total",
                            "requests_total",
                            "active_sessions",
                            "uptime_s",
                            "inference_dtype",
                            "param_bytes_device",
                        )
                    }
            replicas.append(entry)
        return {"replicas": replicas, **self._gauges()}

    def healthz(self) -> Dict[str, Any]:
        """Router liveness + the serving contract proxied from a ready
        replica (clients read image_shape from here, same as single-node)."""
        out: Dict[str, Any] = {
            "status": "draining" if self.draining else "ok",
            "role": "router",
            **self._gauges(),
        }
        for replica in self.replicas():
            if replica.state == READY and replica.url:
                status, body = get_json(
                    replica.url + "/healthz", timeout=5.0
                )
                if status == 200:
                    for key in ("image_shape", "embed_dim", "max_sessions"):
                        if key in body:
                            out[key] = body[key]
                    break
        return out

    def readyz(self) -> Tuple[int, Dict[str, Any]]:
        if self.draining:
            return 503, {"ready": False, "reason": "draining"}
        ready = self.ready_count()
        if ready == 0:
            return 503, {"ready": False, "reason": "no ready replicas"}
        return 200, {"ready": True, "replicas_ready": ready}


class _RouterHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    router: Router = None  # bound by make_router_server
    quiet: bool = True

    def log_message(self, fmt, *args):  # noqa: D102 - stdlib hook
        if not self.quiet:
            super().log_message(fmt, *args)

    def _reply(self, code: int, payload: Dict[str, Any]) -> None:
        body = json.dumps(payload).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_text(self, code: int, text: str, content_type: str) -> None:
        body = text.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 - stdlib casing
        if self.path.startswith("/history"):
            # /history[?family=...&window_s=...]: TSDB read-out (armed
            # fleets only; the query string selects one series window).
            if self.router.history_fn is None:
                self._reply(404, {"error": "no metrics collector armed"})
                return
            from urllib.parse import parse_qs, urlparse

            query = parse_qs(urlparse(self.path).query)
            params = {k: v[-1] for k, v in query.items()}
            try:
                self._reply(200, self.router.history_fn(params))
            except (KeyError, ValueError) as exc:
                self._reply(400, {"error": str(exc)})
            return
        if self.path == "/healthz":
            self._reply(200, self.router.healthz())
        elif self.path == "/readyz":
            code, payload = self.router.readyz()
            self._reply(code, payload)
        elif self.path == "/fleet/status":
            self._reply(200, self.router.fleet_status())
        elif self.path == "/fleet/slow_requests":
            self._reply(200, self.router.fleet_slow_requests())
        elif self.path.startswith("/fleet/session?"):
            from urllib.parse import parse_qs, urlparse

            sid = parse_qs(urlparse(self.path).query).get("session_id", [""])[-1]
            if not sid:
                self._reply(400, {"error": "'session_id' must be a non-empty string"})
            else:
                self._reply(200, self.router.session_view(sid))
        elif self.path == "/slo":
            self._reply(200, self.router.slo.summary())
        elif self.path == "/deploy/status":
            if self.router.deploy_status_fn is None:
                self._reply(404, {"error": "no promotion controller armed"})
            else:
                self._reply(200, self.router.deploy_status_fn())
        elif self.path == "/alerts":
            if self.router.alerts_status_fn is None:
                self._reply(404, {"error": "no metrics collector armed"})
            else:
                self._reply(200, self.router.alerts_status_fn())
        elif self.path == "/dashboard":
            if self.router.dashboard_html_fn is None:
                self._reply(404, {"error": "no metrics collector armed"})
            else:
                self._reply_text(
                    200,
                    self.router.dashboard_html_fn(),
                    "text/html; charset=utf-8",
                )
        elif self.path == "/metrics":
            # ONE scrape target for the whole fleet: the router's own
            # families plus every replica's curated fields, fanned out on
            # each scrape (same content negotiation as a lone replica).
            if obs_prometheus.accepts_text(self.headers.get("Accept")):
                self._reply_text(
                    200,
                    self.router.fleet_metrics_prometheus(),
                    obs_prometheus.CONTENT_TYPE,
                )
            else:
                self._reply(200, self.router.fleet_metrics_snapshot())
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):  # noqa: N802 - stdlib casing
        length = int(self.headers.get("Content-Length", 0))
        try:
            payload = json.loads(self.rfile.read(length)) if length else {}
        except json.JSONDecodeError as exc:
            self._reply(400, {"error": f"invalid JSON body: {exc}"})
            return
        if not isinstance(payload, dict):
            self._reply(400, {"error": "request body must be a JSON object"})
            return
        t0 = time.perf_counter()
        if self.path == "/act":
            status, body = self.router.route_act(payload, self.headers)
            if status in (429, 503):
                # Shed load (admission 429, no-ready-replicas / failover
                # 503) is the rejected counter, not errors_total — same
                # split the single-replica server makes for its busy 503s.
                self.router.metrics.observe_rejected()
            else:
                self.router.metrics.observe_request(
                    time.perf_counter() - t0, ok=status == 200
                )
            self._reply(status, body)
        elif self.path in ("/reset", "/release"):
            status, body = self.router.route_session_op(self.path, payload)
            if self.path == "/reset" and status == 200:
                self.router.metrics.observe_reset()
            self._reply(status, body)
        elif self.path == "/reload":
            results = self.router.rolling_reload(payload.get("step"))
            # A clean roll means every replica swapped AND recovered; a
            # skipped (dead/respawning) replica is a partial roll — the
            # fleet may be serving mixed checkpoint versions — and must
            # not be reported as ok.
            failed = [
                r
                for r in results
                if r.get("status") != 200 or r.get("recovered") is False
            ]
            self._reply(
                200 if not failed else 502,
                {"ok": not failed, "replicas": results},
            )
        elif self.path == "/rebalance":
            replica_id = payload.get("replica_id")
            count = payload.get("count", 1)
            if not isinstance(replica_id, int):
                self._reply(400, {"error": "'replica_id' must be an "
                                           "integer"})
                return
            if not isinstance(count, int) or count < 1:
                self._reply(400, {"error": "'count' must be a positive "
                                           "integer"})
                return
            status, body = self.router.rebalance(replica_id, count)
            self._reply(status, body)
        elif self.path == "/scale_down":
            # Elastic-drain entry point: wired to the fleet supervisor's
            # manual scale-down (migrating drain) by fleet main; 404 on a
            # router without a supervisor.
            if self.router.scale_down_fn is None:
                self._reply(404, {"error": "no fleet supervisor armed"})
                return
            try:
                self._reply(200, self.router.scale_down_fn(payload))
            except (KeyError, ValueError) as exc:
                self._reply(400, {"error": str(exc)})
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})


def make_router_server(
    router: Router, host: str = "127.0.0.1", port: int = 0, quiet: bool = True
) -> HTTPServer:
    """Bind an `httpd.HTTPServer` to `router` (port 0 = ephemeral)."""
    handler = type(
        "BoundRouterHandler", (_RouterHandler,),
        {"router": router, "quiet": quiet},
    )
    httpd = HTTPServer((host, port), handler)
    return httpd
