"""Deterministic fault injection: the failure paths become testable.

The port's copy of `rt1_tpu/resilience/faults.py` (the port imports nothing of the JAX
package); it keeps the JAX module's names, wire format and behaviour.

Every recovery path in this package (guard skip/rollback, checkpoint-save
retry, preemption save-and-exit, feeder stall diagnosis) exists because a
specific failure happens on real runs — and none of those failures can be
*scheduled* on demand without help. This registry injects them
deterministically: a fault plan is a list of ``site@occurrence`` specs,
matched by pure counting (no clocks, no randomness), so a test or a chaos
run reproduces the exact same failure at the exact same step every time.

Spec grammar (comma-separated)::

    nan_batch@7          poison host batch 7 (floats -> NaN) -> NaN loss
    ckpt_save@2          raise OSError on the 2nd CheckpointManager.save
                         (the 2nd LOGICAL save — retry attempts of one save
                         re-consult with the same ordinal, so an `x<K>`
                         budget fails K consecutive attempts of that save
                         rather than consuming later saves' occurrences)
    ckpt_restore@1       raise OSError on the 1st restore
    feeder_kill@12       the worker assembling ticket 12 raises
    feeder_hang@12       the worker assembling ticket 12 dies silently
                         (simulated deadlock; pairs with the feeder's
                         stall-timeout diagnosis)
    sigterm@5            deliver SIGTERM to this process at train step 5
    replica_kill@2       serve fleet: SIGKILL a serving replica at chaos
                         tick 2 (ticks count supervision cycles after the
                         fleet first reports all-ready; see serve/fleet.py)
    replica_hang@3       serve fleet: SIGSTOP a replica at chaos tick 3 —
                         alive to the OS, black-holes requests until the
                         supervisor's hang detector kills and respawns it
    serve_reload@4       serve fleet: start a rolling checkpoint reload
                         (one replica at a time) at chaos tick 4
    capture_write@2      flywheel: raise OSError on the 2nd episode the
                         serve-side capture sink tries to write (the sink
                         must drop the episode and keep serving)
    pack_append@1        flywheel: raise OSError on the 1st pack append,
                         AFTER the shard files land but BEFORE the
                         manifest rename — the torn-append window readers
                         must be immune to (rt1_tpu/data/pack.py)
    promote@1            deploy: raise OSError on the 1st fleet-wide
                         promote the PromotionController attempts — the
                         controller must roll the canary back and leave
                         the incumbent serving (rt1_tpu/deploy/)
    canary_slo_breach@3  deploy: force the canary burn signal over the
                         rollback threshold starting at canary-watch
                         tick 3 (synthetic breach: client traffic stays
                         clean, the decision path is what's under test)
    migrate_export@1     serve: raise OSError before the 1st session-
                         export leg of a live migration — the victim
                         session must degrade to the legacy
                         orphan+restart path, never a client 5xx
    migrate_import@2     serve: raise OSError before the 2nd session-
                         import leg of a live migration (export
                         succeeded; the snapshot is dropped and the
                         session restarts on its new replica)
    session_restore@1    serve: raise OSError on the 1st snapshot-ring
                         restore a replica attempts for an unknown
                         session — /act must fall back to a fresh
                         window (legacy restart), not fail the request
    <site>@<n>x<k>       fire on k consecutive occurrences starting at n
                         (e.g. nan_batch@3x4 poisons batches 3,4,5,6)

Two matching modes, chosen by the call site:

* count-based — ``should_fire(site)``: the injector counts calls to the
  site; the spec fires on occurrences ``at .. at+times-1`` (1-based). Only
  for call sites that are never retried — inside a retry loop every
  attempt would advance the count, silently consuming later occurrences.
* index-based — ``should_fire(site, index=i)``: the caller supplies the
  ordinal (batch index, feeder ticket, train step, logical save number);
  the spec fires while ``at <= i < at+times`` and the spec's own fire
  budget lasts. Every in-tree site uses this mode: the budget keeps a
  rolled-back run (whose batch indices restart at 0) from re-firing an
  exhausted fault, and the checkpoint layer passes its logical-operation
  ordinal so retry attempts don't advance the schedule.

Install a plan process-wide with :func:`install` /
:func:`install_from` (config string, with the ``RT1_FAULTS`` env var
appended — the subprocess-friendly channel chaos runs use). Call sites
pay one module-global read when no plan is installed.

This module is stdlib only at import: the router, the stub replica and the
fleet supervisor consult it. `poison_batch` imports numpy and torch inside
the call.
"""

from __future__ import annotations

import dataclasses
import os
import re
import signal
import threading
from typing import Dict, List, Optional

ENV_VAR = "RT1_FAULTS"

_SPEC_RE = re.compile(r"^(?P<site>[a-z0-9_]+)@(?P<at>\d+)(x(?P<times>\d+))?$")

KNOWN_SITES = (
    "nan_batch",
    "ckpt_save",
    "ckpt_restore",
    "feeder_kill",
    "feeder_hang",
    "sigterm",
    "replica_kill",
    "replica_hang",
    "serve_reload",
    "capture_write",
    "pack_append",
    "promote",
    "canary_slo_breach",
    "migrate_export",
    "migrate_import",
    "session_restore",
)


@dataclasses.dataclass
class FaultSpec:
    """One scheduled fault: fire `times` occurrences starting at `at`."""

    site: str
    at: int
    times: int = 1
    fired: int = 0

    def spec_str(self) -> str:
        return f"{self.site}@{self.at}" + (
            f"x{self.times}" if self.times != 1 else ""
        )


class FaultPlan:
    """A deterministic schedule of faults, matched by counting only."""

    def __init__(self, specs: List[FaultSpec]):
        self._specs = list(specs)
        self._lock = threading.Lock()
        self._site_calls: Dict[str, int] = {}

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        specs = []
        for part in (text or "").split(","):
            part = part.strip()
            if not part:
                continue
            m = _SPEC_RE.match(part)
            if not m:
                raise ValueError(
                    f"bad fault spec {part!r}; expected <site>@<n> or "
                    f"<site>@<n>x<times> (e.g. 'nan_batch@7,ckpt_save@2')"
                )
            site = m.group("site")
            if site not in KNOWN_SITES:
                raise ValueError(
                    f"unknown fault site {site!r}; known: {KNOWN_SITES}"
                )
            specs.append(
                FaultSpec(
                    site=site,
                    at=int(m.group("at")),
                    times=int(m.group("times") or 1),
                )
            )
        return cls(specs)

    def __len__(self) -> int:
        return len(self._specs)

    def should_fire(self, site: str, index: Optional[int] = None) -> bool:
        """True when a spec for `site` fires on this call.

        `index=None` counts calls to the site (1-based occurrence match);
        an explicit `index` matches the caller's own ordinal. Either way a
        spec fires at most `times` total — deterministic and replay-safe.
        """
        with self._lock:
            if index is None:
                self._site_calls[site] = self._site_calls.get(site, 0) + 1
                index = self._site_calls[site]
            for spec in self._specs:
                if (
                    spec.site == site
                    and spec.fired < spec.times
                    and spec.at <= index < spec.at + spec.times
                ):
                    spec.fired += 1
                    return True
        return False

    def fired_counts(self) -> Dict[str, int]:
        """{spec-string: times fired} — for logs and chaos-run summaries."""
        with self._lock:
            return {s.spec_str(): s.fired for s in self._specs}

    def counters(self, prefix: str = "faults/") -> Dict[str, float]:
        """Flat per-site fired totals for the obs scalar stream."""
        with self._lock:
            out: Dict[str, float] = {}
            for s in self._specs:
                key = f"{prefix}{s.site}_fired"
                out[key] = out.get(key, 0.0) + float(s.fired)
        return out


# ------------------------------------------------------------- process-wide

_active: Optional[FaultPlan] = None


def install(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Set (or with None, clear) the process-wide fault plan."""
    global _active
    _active = plan
    return plan


def clear() -> None:
    install(None)


def active() -> Optional[FaultPlan]:
    """The installed plan, or None (the zero-cost common case)."""
    return _active


def install_from(config_spec: str = "") -> Optional[FaultPlan]:
    """Build + install a plan from a config string, appending ``RT1_FAULTS``.

    Returns None (and installs nothing) when both sources are empty, so
    production runs never pay a per-call plan lookup beyond one global read.
    """
    parts = [p for p in (config_spec or "", os.environ.get(ENV_VAR, "")) if p]
    text = ",".join(parts)
    if not text:
        install(None)
        return None
    return install(FaultPlan.parse(text))


# ---------------------------------------------------------------- injectors


def maybe_fail(site: str, index: Optional[int] = None, what: str = "") -> None:
    """Raise an injected OSError when the active plan fires for `site`."""
    plan = _active
    if plan is not None and plan.should_fire(site, index=index):
        raise OSError(
            f"injected fault [{site}]" + (f": {what}" if what else "")
        )


def maybe_signal(site: str, index: Optional[int], signum=signal.SIGTERM) -> bool:
    """Deliver `signum` to this process when the plan fires; returns True."""
    plan = _active
    if plan is not None and plan.should_fire(site, index=index):
        os.kill(os.getpid(), signum)
        return True
    return False


def poison_batch(batch):
    """Return a copy of a nested batch with every float leaf set to NaN.

    Integer/uint8 leaves (token ids, packed images) pass through untouched —
    NaN has no integer encoding, and poisoning the float leaves (embeddings,
    actions) is already sufficient to drive the loss non-finite. A torch
    tensor is poisoned on the device it lives on; tuples (the loop's
    `(observations, actions)` device batches) keep their shape.
    """
    import numpy as np
    import torch

    def _poison(value):
        if isinstance(value, dict):
            return {k: _poison(v) for k, v in value.items()}
        if isinstance(value, tuple):
            return tuple(_poison(v) for v in value)
        if isinstance(value, torch.Tensor):
            return torch.full_like(value, float("nan")) if value.is_floating_point() else value
        arr = np.asarray(value)
        if np.issubdtype(arr.dtype, np.floating):
            return np.full_like(arr, np.nan)
        return arr

    return _poison(batch)
