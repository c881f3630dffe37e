"""Per-request tracing: ids, phase stamps, and linked serve spans.

The port's copy of `rt1_tpu/serve/reqtrace.py` (the port imports nothing of the JAX
package); it keeps the JAX module's names, wire format and behaviour.

A request that crosses router -> replica -> micro-batcher -> engine used
to leave four uncorrelated log lines. This module gives every request one
id and one phase ledger:

* **Request id.** Assigned at the first hop that sees the request (the
  router, or the replica for direct traffic); clients may supply their
  own via the ``X-RT1-Request-Id`` header and get it echoed back in the
  ``request_id`` response field, so a client-side timeout can be joined
  against server-side spans after the fact.
* **Phase stamps.** `RequestPhases` collects one `obs.trace.now_us()`
  timestamp per boundary as the request moves through admission ->
  batcher queue -> batch formation -> device step -> serialization.
  Stamping is unconditional (a perf_counter read per boundary — the
  loadgen A/B pins the cost under the 2% tracing budget); *emission* into
  the Chrome-trace ring and the `/act` response stays gated.
* **Linked spans.** `emit_trace` turns the stamps into `batch_wait` and
  `device_step` complete-events on the shared host timeline, each tagged
  with the request id — the same id the router's `router_route` and the
  replica's `replica_act` spans carry, so Perfetto shows one request's
  whole path across processes and threads.

The phase breakdown is returned in the `/act` response (``"phases"``)
when the request carries ``"debug": true``, and recorded in the bounded
slow-request `ExemplarRing` (`rt1_tpu/obs/recorder.py`) regardless, so
the exemplars a post-mortem needs exist even when no client asked for
debug output. Stdlib + obs only — the router process imports no torch.
"""

from __future__ import annotations

import re
import uuid
from typing import Any, Dict, Optional

from rt1_tpu_torch.obs import trace as obs_trace

REQUEST_ID_HEADER = "X-RT1-Request-Id"
# Payload key (not a header) so the flag rides through the router's
# verbatim /act forwarding with zero router logic.
DEBUG_KEY = "debug"


def new_request_id() -> str:
    """16 hex chars: unique enough for correlating a fleet's in-flight
    window, short enough to read in a trace viewer."""
    return uuid.uuid4().hex[:16]


# The id is client-controlled input that the router re-emits as an HTTP
# header on the replica hop: anything outside this set (CR/LF, non-latin-1)
# would make urllib reject the forwarded request, which the router cannot
# tell apart from a replica transport death.
_RID_SAFE = re.compile(r"[^A-Za-z0-9._:-]")


def request_id_from(headers, payload: Optional[Dict[str, Any]] = None) -> str:
    """Resolve the request id: client header wins, else payload field
    (the router forwards it in-band), else mint one."""
    rid = headers.get(REQUEST_ID_HEADER) if headers is not None else None
    if not rid and payload:
        rid = payload.get("request_id")
    if isinstance(rid, str) and rid:
        rid = _RID_SAFE.sub("", rid)[:64]
    if not isinstance(rid, str) or not rid:
        rid = new_request_id()
    return rid


class RequestPhases:
    """One request's boundary timestamps on the shared trace clock (µs).

    Stamps are written by three different threads (HTTP handler, batcher
    loop, executor) but each field has exactly one writer and is read
    only after the request's future resolves — no lock needed.
    """

    __slots__ = (
        "request_id",
        "t_admit",     # handler: request parsed, about to submit
        "t_enqueue",   # handler: submitted to the batcher queue
        "t_formed",    # batcher loop: popped into a batch
        "t_device0",   # executor: device step begins
        "t_device1",   # executor: device step ends
        "t_done",      # handler: response about to serialize
    )

    def __init__(self, request_id: Optional[str] = None):
        self.request_id = request_id or new_request_id()
        now = obs_trace.now_us()
        self.t_admit = now
        self.t_enqueue = None
        self.t_formed = None
        self.t_device0 = None
        self.t_device1 = None
        self.t_done = None

    @staticmethod
    def _delta_ms(a: Optional[float], b: Optional[float]) -> Optional[float]:
        if a is None or b is None:
            return None
        return round(max(b - a, 0.0) / 1e3, 3)

    def phases_ms(self) -> Dict[str, Any]:
        """The per-request breakdown: where this request's milliseconds
        went inside the replica. Phases a failed request never reached
        are None, not fabricated zeros."""
        end = self.t_done if self.t_done is not None else obs_trace.now_us()
        return {
            "request_id": self.request_id,
            # admission: JSON parse + validation + the draining check.
            "admission_ms": self._delta_ms(self.t_admit, self.t_enqueue),
            # queue wait: sat in the batcher's pending deque.
            "queue_wait_ms": self._delta_ms(self.t_enqueue, self.t_formed),
            # batch formation: popped -> executor start (handoff +
            # numpy batch assembly begins).
            "batch_form_ms": self._delta_ms(self.t_formed, self.t_device0),
            # device: the batched engine step this request rode in.
            "device_ms": self._delta_ms(self.t_device0, self.t_device1),
            # serialization: result future resolution -> response write.
            "serialize_ms": self._delta_ms(self.t_device1, end),
            "total_ms": self._delta_ms(self.t_admit, end),
        }

    def emit_trace(self, session_id: Optional[str] = None) -> None:
        """Write the cross-thread phases as linked complete-events (no-op
        when no trace recorder is installed)."""
        if not obs_trace.enabled():
            return
        if self.t_enqueue is not None and self.t_formed is not None:
            obs_trace.complete(
                "batch_wait",
                self.t_enqueue,
                self.t_formed - self.t_enqueue,
                request_id=self.request_id,
                **({"session": session_id} if session_id else {}),
            )


def device_step_span(batch_size: int, request_ids) -> Any:
    """`device_step` span around one batched engine step, tagged with
    every rider's request id."""
    return obs_trace.span(
        "device_step", batch=batch_size, request_ids=list(request_ids)
    )
