"""The port's observability (copies of the JAX package's `rt1_tpu/obs/`
modules of the same names; the port imports nothing of the JAX package):

* :mod:`trace`      — host-side Chrome-trace span recorder.
* :mod:`steps`      — `StepTimeline`: per-step wall-time attribution
  (wait_data / h2d / device_step / host) + the rolling `stall_pct` gauge.
* :mod:`prometheus` — exposition text format, its parser and the scrape
  listener (`MetricsServer`).
* :mod:`recorder`   — `FlightRecorder` (the train loop's ring of step
  records, dumped on crash, SIGTERM or preemption) and `ExemplarRing`.
* :mod:`health`     — the model-health pack computed in the train step.
* :mod:`goodput`    — `GoodputLedger`: the run's wall time by bucket + live
  MFU.
* :mod:`flops`      — FLOPs of a step by FlopCounterMode + MFU math.
* :mod:`slo`        — the serving SLO ledger.
* :mod:`quantiles`  — the shared percentile math.
* :mod:`tsdb`       — the bounded ring time-series store of scrape history.
* :mod:`alerts`     — declarative alert rules over TSDB windows.
* :mod:`collector`  — the scrape loop feeding the TSDB and the alerts.
* :mod:`dashboard`  — the `/dashboard` page and the terminal console.

Stdlib only at import (torch inside the functions that need it), so the
serve fleet's router and stub replica import neither torch nor JAX.
`ObsOptions.from_config` resolves `config.obs` as JAX's does.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from rt1_tpu_torch.obs import (
    flops,
    goodput,
    health,
    prometheus,
    quantiles,
    recorder,
    slo,
    steps,
    trace,
)
from rt1_tpu_torch.obs.goodput import GoodputLedger
from rt1_tpu_torch.obs.prometheus import MetricsServer
from rt1_tpu_torch.obs.recorder import ExemplarRing, FlightRecorder
from rt1_tpu_torch.obs.slo import SLOLedger, SLOObjectives
from rt1_tpu_torch.obs.steps import StepTimeline
from rt1_tpu_torch.obs.trace import TraceRecorder

__all__ = [
    "ExemplarRing",
    "FlightRecorder",
    "GoodputLedger",
    "MetricsServer",
    "ObsOptions",
    "SLOLedger",
    "SLOObjectives",
    "StepTimeline",
    "TraceRecorder",
    "flops",
    "goodput",
    "health",
    "prometheus",
    "quantiles",
    "recorder",
    "slo",
    "steps",
    "trace",
]


@dataclasses.dataclass
class ObsOptions:
    """Resolved `config.obs` with defaults for configs that predate it.

    The train loop consumes this instead of poking `config.obs.*` directly
    so pre-obs configs (proof configs, pinned sweep artifacts) keep running
    unmodified, and so defaults live in exactly one place.
    """

    trace: bool = False
    trace_path: Optional[str] = None  # None -> <workdir>/trace.json
    trace_max_events: int = 200_000
    stall_window: int = 50
    sync_timing: bool = False
    prometheus_port: int = -1  # < 0: no train-side listener; 0: ephemeral
    prometheus_host: str = "127.0.0.1"
    flight_recorder: bool = True
    flight_recorder_size: int = 256
    flight_recorder_path: Optional[str] = None  # None -> <workdir>/...jsonl
    # Model-health pack (obs/health.py): computed inside the train step,
    # fetched at log steps. Off by default so configs predating it keep a
    # bit-identical step.
    model_health: bool = False
    health_group_depth: int = 2
    # Goodput ledger (obs/goodput.py): host-side run wall-time partition +
    # final JSON summary. Pure host arithmetic — safe to default on.
    goodput: bool = True
    goodput_summary_path: Optional[str] = None  # None -> <workdir>/goodput...
    # Live MFU gauge: FLOPs of one step counted once at startup
    # (obs/flops.py). Off by default: the count runs one extra forward and
    # backward.
    goodput_mfu: bool = False

    @classmethod
    def from_config(cls, config, workdir: Optional[str] = None) -> "ObsOptions":
        """Read `config.obs` if present (a dataclass, ml_collections or a
        plain mapping); absent keys fall back to the dataclass defaults."""
        node = None
        if config is not None:
            get = getattr(config, "get", None)
            node = get("obs") if callable(get) else getattr(config, "obs", None)
        kwargs = {}
        if node is not None:
            for field in dataclasses.fields(cls):
                getter = getattr(node, "get", None)
                value = (
                    getter(field.name)
                    if callable(getter)
                    else getattr(node, field.name, None)
                )
                if value is not None:
                    kwargs[field.name] = value
        opts = cls(**kwargs)
        if workdir:
            if opts.trace_path is None:
                opts.trace_path = os.path.join(workdir, "trace.json")
            if opts.flight_recorder_path is None:
                opts.flight_recorder_path = os.path.join(
                    workdir, "flight_record.jsonl"
                )
            if opts.goodput_summary_path is None:
                opts.goodput_summary_path = os.path.join(
                    workdir, goodput.SUMMARY_BASENAME
                )
        return opts
