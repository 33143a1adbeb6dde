"""Per-phase timing and the step-record sink of the trainer: the port's
``pytorch_distributed_nn_tpu/utils/timing.py``.

:class:`PhaseTimer` adds up named wall-clock phases of one step (the
trainer's ``data`` and ``checkpoint``); given a metric registry it also
feeds each into the ``phase_seconds{phase=...}`` histogram.
:class:`MetricsLogger` writes one ``kind: "step"`` record per step into
a run's telemetry stream (:class:`..observability.core.Telemetry`).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, Optional


class PhaseTimer:
    """Named wall-clock phases of one iteration."""

    def __init__(self, registry=None):
        self.durations: Dict[str, float] = {}
        self._registry = registry

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.durations[name] = self.durations.get(name, 0.0) + dt
            if self._registry is not None:
                self._registry.histogram(
                    "phase_seconds", help="wall-clock per phase",
                    labels={"phase": name}).observe(dt)

    def reset(self) -> None:
        self.durations = {}


class MetricsLogger:
    """One record per step into a telemetry stream.

    ``MetricsLogger(path)`` opens its own stream at ``path`` (a manifest
    first); ``MetricsLogger(telemetry=t)`` writes into ``t``, whose
    lifetime stays the caller's."""

    def __init__(self, path: Optional[str] = None, telemetry=None):
        from pytorch_distributed_nn_tpu_torch.observability.core import (
            Telemetry,
        )

        self._owned = telemetry is None and bool(path)
        self._telemetry = (telemetry if telemetry is not None
                           else Telemetry.for_run(path) if path else None)

    def log(self, record: dict) -> None:
        if self._telemetry is not None:
            self._telemetry.log_step(record)

    def flush(self, fsync: bool = False) -> None:
        if self._telemetry is not None:
            self._telemetry.flush(fsync=fsync)

    def close(self) -> None:
        if self._telemetry is not None and self._owned:
            self._telemetry.close()
        self._telemetry = None
