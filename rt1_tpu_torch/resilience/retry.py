"""Exponential-backoff retry for the I/O seams of a long training run.

A 97k-step run touches remote storage thousands of times (checkpoint saves,
manifest opens, feeder construction over a network filesystem); any one of
those calls can hit a transient error that would kill the run outright even
though the same call succeeds 200 ms later. `retry_call` turns those into
logged warnings: exponential backoff with decorrelating jitter, a deadline
cap so a *persistent* failure still surfaces within bounded time, and an
exception filter so programming errors (TypeError, ValueError) never get
retried into oblivion.

Observability: every retry and every exhaustion bumps a process-wide
counter (``retry/<name>_retries_total`` / ``retry/<name>_exhausted_total``)
exposed via :func:`counters` — the train loop merges these into its scalar
stream, so they reach TensorBoard, the Prometheus listener
(``rt1_train_retry_*``), and the flight recorder. A counter event is also
emitted on the obs host trace when tracing is live.

The port's copy of `rt1_tpu/resilience/retry.py` (the port imports nothing
of the JAX package): the same schedule, counters and exhaustion; warnings
go to the stdlib `logging` module where JAX's go to absl's.

Import-light by contract: stdlib + `rt1_tpu_torch.obs.trace` only (the
checkpoint layer and the data feeder both import this module).
"""

from __future__ import annotations

import dataclasses
import logging
import random
import threading
import time
from typing import Callable, Dict, Optional, Tuple, Type

from rt1_tpu_torch.obs import trace as obs_trace

_log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class RetryOptions:
    """Shape of the backoff schedule; `retry_on` filters what is transient."""

    attempts: int = 3
    backoff_s: float = 0.5
    max_backoff_s: float = 8.0
    multiplier: float = 2.0
    # Fraction of each delay randomized away (full-jitter style): delay_k in
    # [(1-jitter)*d_k, d_k]. 0 = deterministic schedule (tests pin this).
    jitter: float = 0.25
    # Wall-clock cap over ALL attempts; None = attempts alone bound it.
    deadline_s: Optional[float] = 120.0
    retry_on: Tuple[Type[BaseException], ...] = (OSError, IOError)


# ------------------------------------------------------------------ counters

_counters_lock = threading.Lock()
_counters: Dict[str, int] = {}


def _bump(key: str, n: int = 1) -> None:
    with _counters_lock:
        _counters[key] = _counters.get(key, 0) + n


def counters(prefix: str = "retry/") -> Dict[str, float]:
    """Snapshot of process-wide retry counters for the obs scalar stream."""
    with _counters_lock:
        return {f"{prefix}{k}": float(v) for k, v in _counters.items()}


def reset_counters() -> None:
    """Test hook: zero the process-wide counters."""
    with _counters_lock:
        _counters.clear()


# ------------------------------------------------------------------- retry


def retry_call(
    fn: Callable,
    *args,
    options: Optional[RetryOptions] = None,
    name: str = "io",
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
    rng: Optional[random.Random] = None,
    **kwargs,
):
    """Call ``fn(*args, **kwargs)``, retrying filtered exceptions.

    Re-raises the last exception when attempts or the deadline run out
    (with the exhaustion counted and logged loudly); anything outside
    ``options.retry_on`` propagates immediately — a bug is not transient.
    `sleep`/`clock`/`rng` are injectable for deterministic tests.
    """
    options = options or RetryOptions()
    if options.attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {options.attempts}")
    rng = rng or random
    t0 = clock()
    delay = options.backoff_s
    for attempt in range(1, options.attempts + 1):
        try:
            return fn(*args, **kwargs)
        except options.retry_on as exc:
            if attempt >= options.attempts:
                _bump(f"{name}_exhausted_total")
                _log.error(
                    "resilience: %s failed %d/%d attempts, giving up: %s",
                    name, attempt, options.attempts, exc,
                )
                raise
            pause = min(delay, options.max_backoff_s)
            if options.jitter > 0:
                pause *= 1.0 - options.jitter * rng.random()
            if (
                options.deadline_s is not None
                and clock() - t0 + pause > options.deadline_s
            ):
                _bump(f"{name}_exhausted_total")
                _log.error(
                    "resilience: %s retry deadline (%.1fs) exceeded after "
                    "attempt %d: %s",
                    name, options.deadline_s, attempt, exc,
                )
                raise
            _bump(f"{name}_retries_total")
            if obs_trace.enabled():
                obs_trace.counter(f"retry_{name}", attempt)
            _log.warning(
                "resilience: %s attempt %d/%d failed (%s); retrying in "
                "%.2fs", name, attempt, options.attempts, exc, pause,
            )
            sleep(pause)
            delay *= options.multiplier
    raise AssertionError("unreachable")  # pragma: no cover


def retriable(options: Optional[RetryOptions] = None, name: str = "io"):
    """Decorator form of :func:`retry_call`."""

    def deco(fn: Callable) -> Callable:
        def wrapped(*args, **kwargs):
            return retry_call(fn, *args, options=options, name=name, **kwargs)

        wrapped.__name__ = getattr(fn, "__name__", name)
        wrapped.__doc__ = fn.__doc__
        return wrapped

    return deco
