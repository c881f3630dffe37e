"""Preemption coordinator: SIGTERM/SIGINT becomes "save, drain, exit 0".

The port's copy of `rt1_tpu/resilience/preempt.py` (the port imports nothing
of the JAX package).

Preemptible machines *will* be reclaimed mid-run; the scheduler's SIGTERM
is a routine event, not a crash. Without this module, the train loop's
SIGTERM story is the flight recorder's handler (rt1_tpu_torch/obs/recorder.py):
dump the ring, chain to SIG_DFL, die — a good post-mortem, a wasted epoch.

`PreemptionCoordinator` converts the first signal into a *cooperative*
shutdown request: the handler runs its callbacks (the train loop passes the
flight-recorder dump here, so the post-mortem artifact survives without the
recorder needing its own competing handler), sets a flag, and returns. The
train loop polls `triggered` once per step and performs the orderly exit
itself — force-save a checkpoint at the current step, drain the feeder,
return normally (exit 0) — which makes `restore_or_initialize` a true
preemption-resume path.

Chaining is explicit and escalation-safe: the previous handlers are saved
at install; a SECOND signal restores them and re-raises, so a wedged drain
(or an impatient operator's double Ctrl-C) still gets the pre-existing
behavior — including the flight recorder's die-with-dump handler if one was
installed before this coordinator.

Main-thread only (CPython delivers signals there); `install` returns False
and no-ops elsewhere, mirroring `FlightRecorder.install_sigterm`.
"""

from __future__ import annotations

import signal
import threading
import time
from typing import Callable, Dict, Iterable, Optional, Tuple


class PreemptionCoordinator:
    """First signal -> cooperative save-and-exit; second -> previous handler."""

    def __init__(
        self,
        callbacks: Iterable[Callable[[], None]] = (),
        signals: Tuple[int, ...] = (signal.SIGTERM, signal.SIGINT),
    ):
        self._callbacks = list(callbacks)
        self._signals = tuple(signals)
        self._event = threading.Event()
        self._prev: Dict[int, object] = {}
        self._signum: Optional[int] = None
        self._triggered_at: Optional[float] = None
        self._installed = False

    # -------------------------------------------------------------- handler

    def _handler(self, signum, frame):
        if self._event.is_set():
            # Second signal: the cooperative drain is not fast enough for
            # whoever is sending these — restore the previous handlers and
            # re-deliver, so the pre-coordinator semantics (flight-recorder
            # dump + die, or plain SIG_DFL) take over with an honest exit.
            self.uninstall()
            signal.raise_signal(signum)
            return
        self._signum = signum
        self._triggered_at = time.time()
        for cb in self._callbacks:
            try:
                cb()
            except Exception:  # noqa: BLE001 - exit path must not mask itself
                pass
        self._event.set()

    # ------------------------------------------------------------ lifecycle

    def install(self) -> bool:
        """Install handlers; False (no-op) off the main thread."""
        if threading.current_thread() is not threading.main_thread():
            return False
        if self._installed:
            return True
        for signum in self._signals:
            self._prev[signum] = signal.signal(signum, self._handler)
        self._installed = True
        return True

    def uninstall(self) -> None:
        if not self._installed:
            return
        for signum, prev in self._prev.items():
            try:
                signal.signal(signum, prev)
            except (ValueError, TypeError):  # non-main thread / exotic prev
                pass
        self._prev.clear()
        self._installed = False

    # ------------------------------------------------------------ inspection

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    @property
    def signum(self) -> Optional[int]:
        return self._signum

    @property
    def triggered_at(self) -> Optional[float]:
        return self._triggered_at

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def counters(self, prefix: str = "preempt/") -> Dict[str, float]:
        """Gauge for the obs scalar stream (1 once a signal arrived)."""
        return {f"{prefix}triggered": 1.0 if self.triggered else 0.0}
