"""Run-level goodput ledger: where did the run's *hours* go.

The port's copy of `rt1_tpu/obs/goodput.py` (the port imports nothing of
the JAX package): the same buckets, the same algebra and the same
`goodput_summary.json`. `StepTimeline` attributes one step's milliseconds;
`GoodputLedger` partitions the whole run's wall time into named buckets
and keeps the arithmetic honest: the fractions ALWAYS sum to 100% (an
explicit ``unattributed`` bucket absorbs whatever no instrument claimed,
so a hole in coverage is visible instead of silently inflating another
bucket).

Buckets:

* ``init``            — process start to the first loop step: model build,
  dataset open, state init, sharding (checkpoint restore time is carved
  out into ``ckpt_restore`` even when it happens inside init).
* ``compile``         — the first executed step's whole wall time. The
  port compiles no program, but its first step pays what JAX's first step
  pays as compilation: the attention library's load (or nvcc build) at
  first use, cuDNN/cuBLAS handle creation and autotuning, the caching
  allocator's first allocations. It is booked the same way.
* ``step``            — productive step time: everything in a non-replay
  step except its input-stall share. This is the GOODPUT bucket.
* ``data_stall``      — the ``wait_data + h2d`` share of productive steps
  (from the StepTimeline records the loop already produces).
* ``ckpt_save`` / ``ckpt_restore`` — checkpoint I/O, reported by the
  `rt1_tpu_torch/trainer/checkpoints.py` retry wrappers via ``on_io``.
* ``rollback_replay`` — steps re-run after a guard rollback (the whole
  step, stall included: replayed time is badput regardless of why it was
  slow), plus nothing else — the triggering restore lands in
  ``ckpt_restore``.
* ``preempt_drain``   — from acting on the preemption signal to exit:
  force-save (carved out into ``ckpt_save``) + feeder drain.
* ``unattributed``    — wall minus everything above: logging, eval,
  Python between steps. Large values are a finding, not an error.

A live MFU gauge rides along when the loop hands the ledger a
FLOPs-per-step count (:mod:`rt1_tpu_torch.obs.flops`): achieved FLOP/s
over *productive step time* against the card's peak.

Everything is host-side stdlib arithmetic on numbers the loop already has;
the clock is injectable so tests pin the bucket algebra exactly. Scalars
flow through the loop's writer at log steps (``goodput/*`` in
metrics.jsonl and ``rt1_train_goodput_*`` on the Prometheus listener), and
`write_summary` drops the final JSON next to the checkpoints, in the
format `scripts/run_report.py` reads.

Import-light by contract: stdlib only.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Callable, Dict, Mapping, Optional

#: Reporting order; ``unattributed`` is always computed, never accrued.
BUCKETS = (
    "init",
    "compile",
    "step",
    "data_stall",
    "ckpt_save",
    "ckpt_restore",
    "rollback_replay",
    "preempt_drain",
    "unattributed",
)

_IO_BUCKETS = ("ckpt_save", "ckpt_restore")

#: Default filename for the end-of-run summary (under the workdir).
SUMMARY_BASENAME = "goodput_summary.json"


class GoodputLedger:
    """Accrues run wall time into `BUCKETS`; fractions sum to 100%."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        self._buckets: Dict[str, float] = {b: 0.0 for b in BUCKETS[:-1]}
        self._steps_productive = 0
        self._steps_replayed = 0
        self._rollbacks = 0
        self._preempted = False
        self._flops_per_step: Optional[float] = None
        self._peak_flops: Optional[float] = None
        self._n_chips = 1
        # One open phase at a time (the loop is single-threaded); I/O
        # reported while a phase is open is "stolen" from it so a restore
        # inside init is not double-counted.
        self._phase_name: Optional[str] = None
        self._phase_t0 = 0.0
        self._phase_stolen = 0.0

    # ------------------------------------------------------------- phases

    def open_phase(self, name: str) -> None:
        if name not in self._buckets:
            raise ValueError(f"unknown bucket {name!r}")
        with self._lock:
            if self._phase_name is not None:
                raise RuntimeError(
                    f"phase {self._phase_name!r} still open"
                )
            self._phase_name = name
            self._phase_t0 = self._clock()
            self._phase_stolen = 0.0

    def close_phase(self) -> None:
        with self._lock:
            if self._phase_name is None:
                raise RuntimeError("no open phase")
            dt = self._clock() - self._phase_t0 - self._phase_stolen
            self._buckets[self._phase_name] += max(dt, 0.0)
            self._phase_name = None

    @contextlib.contextmanager
    def phase(self, name: str):
        """Accrue the block's wall time to bucket `name`."""
        self.open_phase(name)
        try:
            yield
        finally:
            self.close_phase()

    # -------------------------------------------------------------- events

    def note_io(self, kind: str, seconds: float) -> None:
        """Checkpoint I/O time from the CheckpointManager's ``on_io`` hook.

        `kind` is "ckpt_save" or "ckpt_restore" (unknown kinds are folded
        into ckpt_save rather than dropped — I/O time must not vanish).
        Steals from the currently open phase so a restore during ``init``
        or a force-save during ``preempt_drain`` is counted once.
        """
        seconds = max(float(seconds), 0.0)
        bucket = kind if kind in _IO_BUCKETS else "ckpt_save"
        with self._lock:
            self._buckets[bucket] += seconds
            if self._phase_name is not None:
                self._phase_stolen += seconds

    def note_step(self, record: Mapping[str, Any], replay: bool = False) -> None:
        """Consume one StepTimeline record (ms buckets, see obs/steps.py).

        The first record of the run goes wholesale to ``compile``; replayed
        steps (post-rollback re-runs) go wholesale to ``rollback_replay``;
        everything else splits into ``data_stall`` (wait_data + h2d) and
        ``step`` (the productive remainder).
        """
        total = float(record.get("total_ms", 0.0)) / 1e3
        stall = (
            float(record.get("wait_data_ms", 0.0))
            + float(record.get("h2d_ms", 0.0))
        ) / 1e3
        stall = min(max(stall, 0.0), max(total, 0.0))
        with self._lock:
            first = self._steps_productive == 0 and self._steps_replayed == 0
            if first and self._buckets["compile"] == 0.0:
                self._buckets["compile"] += total
            elif replay:
                self._buckets["rollback_replay"] += total
                self._steps_replayed += 1
            else:
                self._buckets["data_stall"] += stall
                self._buckets["step"] += total - stall
                self._steps_productive += 1

    def mark_rollback(self) -> None:
        with self._lock:
            self._rollbacks += 1

    def mark_preempted(self) -> None:
        with self._lock:
            self._preempted = True

    def set_flops_per_step(
        self,
        flops: Optional[float],
        peak_flops: Optional[float] = None,
        n_chips: int = 1,
    ) -> None:
        """Arm the MFU gauge (flops=None leaves it disarmed)."""
        with self._lock:
            self._flops_per_step = float(flops) if flops else None
            self._peak_flops = peak_flops
            self._n_chips = max(int(n_chips), 1)

    # ----------------------------------------------------------- reporting

    def _snapshot(self) -> Dict[str, float]:
        """Buckets incl. live partial of an open phase (scrape-safe)."""
        with self._lock:
            out = dict(self._buckets)
            if self._phase_name is not None:
                live = self._clock() - self._phase_t0 - self._phase_stolen
                out[self._phase_name] += max(live, 0.0)
            return out

    def wall_s(self) -> float:
        return max(self._clock() - self._t0, 0.0)

    def mfu_pct(self) -> Optional[float]:
        """Live MFU over productive step time, or None when disarmed."""
        with self._lock:
            flops, steps = self._flops_per_step, self._steps_productive
            step_s = self._buckets["step"]
            peak, n_chips = self._peak_flops, self._n_chips
        if not flops or steps <= 0 or step_s <= 0:
            return None
        from rt1_tpu_torch.obs import flops as flops_lib

        return flops_lib.mfu_pct(
            flops, step_s / steps, n_chips=n_chips, peak_flops=peak
        )

    def summary(self) -> Dict[str, Any]:
        """Final (or live) ledger: seconds, fractions summing to 1.0."""
        buckets = self._snapshot()
        attributed = sum(buckets.values())
        wall = self.wall_s()
        # The denominator is whichever is larger: clock skew between the
        # run timer and the per-bucket timers must never produce a
        # negative bucket or fractions past 1.
        denom = max(wall, attributed)
        buckets["unattributed"] = denom - attributed
        fractions = {
            b: (buckets[b] / denom if denom > 0 else 0.0) for b in BUCKETS
        }
        goodput_s = buckets["step"]
        out: Dict[str, Any] = {
            "wall_s": wall,
            "buckets_s": {b: buckets[b] for b in BUCKETS},
            "fractions": fractions,
            "goodput_pct": fractions["step"] * 100.0,
            "badput_pct": (1.0 - fractions["step"]) * 100.0,
            "steps_productive": self._steps_productive,
            "steps_replayed": self._steps_replayed,
            "rollbacks": self._rollbacks,
            "preempted": self._preempted,
        }
        if self._steps_productive > 0 and goodput_s > 0:
            out["sec_per_productive_step"] = (
                goodput_s / self._steps_productive
            )
        mfu = self.mfu_pct()
        if mfu is not None:
            out["mfu_pct"] = mfu
            out["flops_per_step"] = self._flops_per_step
        return out

    def scalars(self, prefix: str = "goodput/") -> Dict[str, float]:
        """Flat gauges for the writer/Prometheus (``rt1_train_goodput_*``)."""
        s = self.summary()
        out = {f"{prefix}wall_s": s["wall_s"]}
        for b in BUCKETS:
            out[f"{prefix}{b}_s"] = s["buckets_s"][b]
            out[f"{prefix}{b}_pct"] = s["fractions"][b] * 100.0
        out[f"{prefix}goodput_pct"] = s["goodput_pct"]
        out[f"{prefix}badput_pct"] = s["badput_pct"]
        out[f"{prefix}steps_replayed"] = float(s["steps_replayed"])
        out[f"{prefix}rollbacks_total"] = float(s["rollbacks"])
        out[f"{prefix}preempted"] = 1.0 if s["preempted"] else 0.0
        if "mfu_pct" in s:
            out[f"{prefix}mfu_pct"] = s["mfu_pct"]
        return out

    def write_summary(self, path: str) -> str:
        """Write the JSON summary (the run_report/post-mortem artifact)."""
        summary = self.summary()
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            json.dump(summary, f, indent=2, sort_keys=True)
            f.write("\n")
        return path


def read_summary(path: str) -> Dict[str, Any]:
    """Load a written summary (run_report's side of the contract)."""
    with open(path) as f:
        return json.load(f)
