"""Serving-side fault injection: the fault plan's request-count kinds.
The port of ``pytorch_distributed_nn_tpu/serving/faultinject.py``.

Serving has no steps, so its faults are keyed by request count
(:mod:`..resilience.faults` grammar: ``slow_infer@1:0.06s:x400``,
``conn_reset@25``, ``http_503@40:x3``). ``serve run --faults`` builds one
:class:`ServingFaultInjector` and wires it into two layers:

- the engine (:meth:`ServingFaultInjector.attach_engine`): a
  ``slow_infer`` entry makes a covered request's batch serve slower,
  billed to ``infer_ms`` where a slow device would show;
- the HTTP handler (:meth:`ServingFaultInjector.http_action`):
  ``conn_reset`` closes the covered request's connection with no status
  line, and ``http_503`` answers it 503.

Counters are per layer (the engine counts the rows it infers, the HTTP
layer the requests it parses), deterministic for one sequential client.
Every entry emits its ``fault_injected`` event once, on its first
covered request.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

from pytorch_distributed_nn_tpu_torch.observability.core import get_telemetry

logger = logging.getLogger(__name__)


class ServingFaultInjector:
    """Applies a :class:`~..resilience.faults.FaultPlan`'s serving kinds
    to a live serving process (engine wrapper and HTTP-layer hook)."""

    def __init__(self, plan, telemetry=None):
        if not plan.has_serving_faults():
            raise ValueError(
                f"fault plan {plan.describe()!r} has no serving-side "
                "entries (slow_infer/conn_reset/http_503) — nothing "
                "would ever fire"
            )
        self.plan = plan
        self.telemetry = (
            telemetry if telemetry is not None else get_telemetry()
        )
        self._lock = threading.Lock()
        self._engine_count = 0
        self._http_count = 0
        self._emitted: set = set()
        self.fired = 0

    def _emit_once(self, entry, index: int, layer: str) -> None:
        """One ``fault_injected`` record per ENTRY (not per covered
        request): an x400 slowdown is one fault, not 400 stream rows."""
        with self._lock:
            if entry in self._emitted:
                return
            self._emitted.add(entry)
            self.fired += 1
        fields = dict(fault=entry.kind, request=index, layer=layer,
                      count=entry.count)
        if entry.kind == "slow_infer":
            fields["seconds"] = entry.seconds
        logger.warning("serving fault: %s fired at request %d", entry,
                       index)
        self.telemetry.emit("fault_injected", **fields)

    # -- engine layer ------------------------------------------------------

    def attach_engine(self, engine) -> None:
        """Wrap ``engine.infer`` so ``slow_infer`` entries delay covered
        batches, billed to the ``infer`` span/stat (a covered batch is
        slowed once by the largest per-row delay — the whole batch waits
        on its slowest row, like a real straggling device)."""
        inner = engine.infer

        def infer(xs):
            with self._lock:
                first = self._engine_count + 1
                self._engine_count += len(xs)
                last = self._engine_count
            outs, stats = inner(xs)
            delay = 0.0
            for idx in range(first, last + 1):
                for e in self.plan._serving_at("slow_infer", idx):
                    delay = max(delay, e.seconds)
                    self._emit_once(e, idx, "engine")
            if delay > 0 and stats.get("batch"):
                time.sleep(delay)
                stats = dict(
                    stats, infer_ms=stats["infer_ms"] + delay * 1000.0
                )
            return outs, stats

        engine.infer = infer

    # -- HTTP layer --------------------------------------------------------

    def http_action(self) -> Optional[str]:
        """Advance the HTTP request counter and return the action for
        this request: ``"conn_reset"``, ``"http_503"`` or ``None``.
        conn_reset wins when both cover the same request (the connection
        dies before any status could be written)."""
        with self._lock:
            self._http_count += 1
            index = self._http_count
        action = None
        for e in self.plan._serving_at("conn_reset", index):
            self._emit_once(e, index, "http")
            action = "conn_reset"
        if action is None:
            for e in self.plan._serving_at("http_503", index):
                self._emit_once(e, index, "http")
                action = "http_503"
        return action
