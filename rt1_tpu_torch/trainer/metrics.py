"""Train metrics on the host (counterpart of `rt1_tpu/trainer/metrics.py`):
throughput over a sliding window, a JSON-lines writer in the workdir, and
the profiler's step mark.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Mapping

import torch


@contextlib.contextmanager
def step_trace(name: str, step_num: int):
    """Marks one step for `torch.profiler`: a `record_function` span named
    as JAX's `StepTraceAnnotation` names its TraceMe, `<name>#step_num=<n>#`.
    Outside a profiled region it records nothing."""
    with torch.profiler.record_function(f"{name}#step_num={int(step_num)}#"):
        yield


class ThroughputMeter:
    """steps/s, examples/s and frames/s (examples x window frames) over the
    host time since the previous update. The window starts at construction,
    anchored at `initial_step`."""

    def __init__(self, batch_size: int, frames_per_example: int, initial_step: int = 0):
        self._batch_size = batch_size
        self._frames = frames_per_example
        self._t0 = time.perf_counter()
        self._step0 = initial_step

    def update(self, step: int) -> Dict[str, float]:
        now = time.perf_counter()
        dt, dsteps = now - self._t0, step - self._step0
        if dt <= 0 or dsteps <= 0:
            return {}
        self._t0, self._step0 = now, step
        return {
            "steps_per_sec": dsteps / dt,
            "examples_per_sec": dsteps * self._batch_size / dt,
            "frames_per_sec": dsteps * self._batch_size * self._frames / dt,
        }


def scalars_from_metrics(metrics: Mapping[str, Any]) -> Dict[str, float]:
    """Device metrics as host floats (this waits for the card)."""
    out = {}
    for key, value in metrics.items():
        if isinstance(value, torch.Tensor):
            value = value.detach().float().mean().item()
        out[key] = float(value)
    return out


class MetricsWriter:
    """Appends one JSON object per record to `<workdir>/metrics.jsonl`;
    `enabled=False` (a rank other than 0) returns the records and writes
    nothing."""

    def __init__(self, workdir: str, filename: str = "metrics.jsonl", enabled: bool = True):
        self.enabled = enabled
        if enabled:
            os.makedirs(workdir, exist_ok=True)
        self.path = os.path.join(workdir, filename)

    def write(self, step: int, scalars: Mapping[str, float]) -> Dict[str, float]:
        record = {"step": int(step), **{k: float(v) for k, v in scalars.items()}}
        if self.enabled:
            with open(self.path, "a") as f:
                f.write(json.dumps(record) + "\n")
        return record
