"""Anomaly detectors over the live telemetry bus: the trigger layer of
the flight recorder (:mod:`.flightrec`). The port's copy of
``pytorch_distributed_nn_tpu/observability/detect.py``: the same
catalogue, spec grammar, defaults and triggers.

A few detectors subscribe to the run's bus and convict anomalies against
the run's OWN baseline, so the recorder can capture the evidence (a
profiler trace window, the event ring) while the anomaly is still hot.

Detector catalogue (``DETECTOR_KINDS``):

- ``step_regression`` — per-step wall time against an EWMA baseline of
  the run's healthy steps. The first step record after any manifest (the
  step that builds kernels and warms the libraries) never feeds the
  baseline or triggers; the next ``warmup`` records build the baseline
  before the detector arms; anomalous samples are not folded into the
  EWMA. A step's time is its record's ``step_time`` (seconds, the JAX
  trainer's field) or, in the port's records, ``step_ms`` / 1000.
- ``stall`` — the supervisor watchdog's ``stall`` event (heartbeat quiet
  past the grace window), also delivered through the direct
  ``RunSupervisor`` hook.
- ``straggler_burst`` — ``count`` distinct steps with ``straggler_drop``
  events inside a sliding ``window`` of steps (the port emits none until
  ROADMAP Queue 1 item 2 ports the straggler simulator).
- ``nonfinite`` — ``count`` ``nonfinite_skip`` events inside ``window``
  steps.
- ``ckpt_stall`` — a ``checkpoint_write`` whose loop stall exceeds
  ``factor`` x the median of the run's previous stalls (after ``warmup``
  writes, ignoring stalls under ``min_ms``).
- ``slo_breach`` — the SLO engine's edge-triggered ``slo_breach`` event.
  Inert in the port until ROADMAP Queue 1 item 6 ports the SLO engine:
  nothing emits the event yet.

Spec grammar (``--flightrec``, in the style of ``FaultPlan``)::

    spec     := "default" | item ("," item)*
    item     := detector | option
    detector := kind (":" key "=" value)*
    option   := key "=" value            (recorder-level knobs)

    kinds    : step_regression | stall | straggler_burst | nonfinite
             | ckpt_stall | slo_breach
    options  : cooldown (steps between captures, default 50)
             | max_bundles (hard cap per run, default 4)
             | capture_steps (profiler trace window K, default 4)
             | ring (event ring size, default 256)

``default`` arms every detector with its default parameters. Unknown
kinds, unknown parameters and non-numeric values are rejected at parse
time: a typo fails the run at flag validation, never silently disarms
the recorder.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import statistics
import threading
from typing import Callable, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

DETECTOR_KINDS = (
    "step_regression",
    "stall",
    "straggler_burst",
    "nonfinite",
    "ckpt_stall",
    "slo_breach",
)

#: per-kind default parameters (also the allowed parameter names)
DETECTOR_DEFAULTS: Dict[str, Dict[str, float]] = {
    "step_regression": {
        "factor": 3.0,   # trigger at step_time > factor * EWMA
        "warmup": 10,    # healthy samples before the detector arms
        "alpha": 0.2,    # EWMA smoothing
        "min_ms": 50.0,  # absolute floor: ignore sub-50ms jitter
    },
    "stall": {},
    "straggler_burst": {"count": 3, "window": 20},
    "nonfinite": {"count": 3, "window": 50},
    "ckpt_stall": {"factor": 3.0, "warmup": 2, "min_ms": 50.0},
    "slo_breach": {},
}

_OPTION_DEFAULTS = {
    "cooldown": 50,
    "max_bundles": 4,
    "capture_steps": 4,
    "ring": 256,
}


@dataclasses.dataclass(frozen=True)
class Trigger:
    """One convicted anomaly, handed to the recorder."""

    kind: str
    step: Optional[int]
    reason: str
    detail: dict


@dataclasses.dataclass(frozen=True)
class DetectorSpec:
    """Parsed ``--flightrec`` spec: which detectors, recorder knobs."""

    detectors: Tuple[Tuple[str, Dict[str, float]], ...]
    cooldown: int = 50
    max_bundles: int = 4
    capture_steps: int = 4
    ring: int = 256

    @classmethod
    def parse(cls, spec: str) -> "DetectorSpec":
        spec = (spec or "").strip()
        if not spec or spec == "default":
            return cls(detectors=tuple(
                (k, dict(DETECTOR_DEFAULTS[k])) for k in DETECTOR_KINDS
            ))
        detectors: List[Tuple[str, Dict[str, float]]] = []
        options = dict(_OPTION_DEFAULTS)
        for raw in spec.split(","):
            raw = raw.strip()
            if not raw:
                continue
            head, _, rest = raw.partition(":")
            if "=" in head:  # a recorder-level option, e.g. cooldown=100
                key, _, val = head.partition("=")
                if key not in _OPTION_DEFAULTS:
                    raise ValueError(
                        f"unknown flightrec option {key!r} in {raw!r} "
                        f"(options: {', '.join(_OPTION_DEFAULTS)})"
                    )
                options[key] = _num(val, raw)
                if rest:
                    raise ValueError(
                        f"option {key!r} takes a single value, got {raw!r}"
                    )
                continue
            if head not in DETECTOR_KINDS:
                raise ValueError(
                    f"unknown detector {head!r} in {raw!r} "
                    f"(kinds: {', '.join(DETECTOR_KINDS)})"
                )
            params = dict(DETECTOR_DEFAULTS[head])
            for arg in (a for a in rest.split(":") if a):
                key, eq, val = arg.partition("=")
                if not eq or key not in params:
                    raise ValueError(
                        f"bad parameter {arg!r} for detector {head!r} "
                        f"(known: {', '.join(params) or 'none'})"
                    )
                params[key] = _num(val, raw)
            detectors.append((head, params))
        if not detectors:
            raise ValueError(
                f"flightrec spec {spec!r} names no detector "
                f"(kinds: {', '.join(DETECTOR_KINDS)})"
            )
        return cls(
            detectors=tuple(detectors),
            cooldown=int(options["cooldown"]),
            max_bundles=int(options["max_bundles"]),
            capture_steps=int(options["capture_steps"]),
            ring=int(options["ring"]),
        )

    def describe(self) -> str:
        parts = [
            kind + "".join(f":{k}={v:g}" for k, v in sorted(p.items()))
            for kind, p in self.detectors
        ]
        parts += [
            f"cooldown={self.cooldown}",
            f"max_bundles={self.max_bundles}",
            f"capture_steps={self.capture_steps}",
            f"ring={self.ring}",
        ]
        return ",".join(parts)


def _num(val: str, where: str) -> float:
    try:
        return float(val)
    except ValueError:
        raise ValueError(f"non-numeric value {val!r} in {where!r}") from None


# ---------------------------------------------------------------------------
# Detectors
# ---------------------------------------------------------------------------


class StepRegressionDetector:
    """EWMA step-time regression vs the run's own healthy baseline."""

    kind = "step_regression"

    def __init__(self, factor=3.0, warmup=10, alpha=0.2, min_ms=50.0):
        self.factor = float(factor)
        self.warmup = int(warmup)
        self.alpha = float(alpha)
        self.min_ms = float(min_ms)
        self._ewma: Optional[float] = None
        self._healthy = 0
        self._skip_next = True  # first record after a manifest: warm-up step

    def observe(self, rec: dict) -> Optional[Trigger]:
        kind = rec.get("kind")
        if kind == "manifest":
            # a restart warms up again: its next step record is skipped too
            self._skip_next = True
            return None
        if kind != "step":
            return None
        if "step_time" in rec:
            st = float(rec["step_time"])
        elif "step_ms" in rec:
            st = float(rec["step_ms"]) / 1000.0
        else:
            return None
        if self._skip_next:
            self._skip_next = False
            return None
        if self._ewma is None:
            self._ewma = st
            self._healthy = 1
            return None
        anomalous = (
            self._healthy >= self.warmup
            and st > self.factor * self._ewma
            and (st - self._ewma) * 1000.0 >= self.min_ms
        )
        if anomalous:
            # the spike never feeds the EWMA: one anomaly must not raise
            # the baseline and mask the next one
            return Trigger(
                self.kind, rec.get("step"),
                reason=(
                    f"step_time {st * 1000:.1f} ms is "
                    f"{st / self._ewma:.1f}x the EWMA baseline "
                    f"{self._ewma * 1000:.1f} ms (factor {self.factor:g})"
                ),
                detail={"step_time": st, "ewma": self._ewma,
                        "factor": self.factor},
            )
        self._ewma += self.alpha * (st - self._ewma)
        self._healthy += 1
        return None


class StallDetector:
    """The supervisor watchdog convicted a stall; capture on recovery."""

    kind = "stall"

    def __init__(self):
        pass

    def observe(self, rec: dict) -> Optional[Trigger]:
        if rec.get("kind") != "event" or rec.get("type") != "stall":
            return None
        return Trigger(
            self.kind, rec.get("step"),
            reason=(
                f"heartbeat quiet {rec.get('age_seconds', '?')}s "
                f"(grace {rec.get('grace', '?')}s)"
            ),
            detail={k: rec.get(k) for k in ("age_seconds", "grace")},
        )


class _EventBurstDetector:
    """Shared machinery: >= count trigger events within a step window."""

    kind = "event_burst"
    event_type = ""

    def __init__(self, count=3, window=20):
        self.count = int(count)
        self.window = int(window)
        self._steps: collections.deque = collections.deque()

    def observe(self, rec: dict) -> Optional[Trigger]:
        if rec.get("kind") != "event" or rec.get("type") != self.event_type:
            return None
        step = rec.get("step")
        if step is None:
            return None
        self._steps.append(int(step))
        while self._steps and self._steps[0] < step - self.window + 1:
            self._steps.popleft()
        if len(self._steps) >= self.count:
            steps = sorted(self._steps)
            self._steps.clear()  # a burst is one incident, not count-N+1
            return Trigger(
                self.kind, step,
                reason=(
                    f"{len(steps)} {self.event_type} events within "
                    f"{self.window} steps (threshold {self.count})"
                ),
                detail={"steps": steps, "count": self.count,
                        "window": self.window},
            )
        return None


class StragglerBurstDetector(_EventBurstDetector):
    kind = "straggler_burst"
    event_type = "straggler_drop"


class NonfiniteDetector(_EventBurstDetector):
    kind = "nonfinite"
    event_type = "nonfinite_skip"


class CkptStallDetector:
    """A checkpoint write whose loop stall breaches the run's own norm."""

    kind = "ckpt_stall"

    def __init__(self, factor=3.0, warmup=2, min_ms=50.0):
        self.factor = float(factor)
        self.warmup = int(warmup)
        self.min_ms = float(min_ms)
        self._stalls: List[float] = []

    def observe(self, rec: dict) -> Optional[Trigger]:
        if rec.get("kind") != "event" or rec.get("type") != "checkpoint_write":
            return None
        if "stall_ms" in rec:
            stall = float(rec["stall_ms"])
        elif "seconds" in rec:  # pre-async streams: the write WAS the stall
            stall = float(rec["seconds"]) * 1000.0
        else:
            return None
        baseline = (
            statistics.median(self._stalls)
            if len(self._stalls) >= self.warmup else None
        )
        if (
            baseline is not None
            and stall > self.factor * baseline
            and stall >= self.min_ms
        ):
            return Trigger(
                self.kind, rec.get("step"),
                reason=(
                    f"checkpoint stall {stall:.1f} ms is "
                    f"{stall / baseline:.1f}x the median "
                    f"{baseline:.1f} ms of previous writes"
                ),
                detail={"stall_ms": stall, "median_ms": baseline,
                        "factor": self.factor},
            )
        self._stalls.append(stall)
        return None


class SLOBreachDetector:
    """The SLO engine convicted a burn (observability/slo.py); turn the
    edge-triggered ``slo_breach`` event into a capture. Inert on runs
    with no SLO engine attached — the event never fires."""

    kind = "slo_breach"

    def __init__(self):
        pass

    def observe(self, rec: dict) -> Optional[Trigger]:
        if rec.get("kind") != "event" or rec.get("type") != "slo_breach":
            return None
        return Trigger(
            self.kind, rec.get("step"),
            reason=(
                f"SLO {rec.get('slo')} burning at "
                f"{rec.get('burn_rate', '?')}x budget over "
                f"{rec.get('window_s', '?')}s "
                f"(short window {rec.get('burn_rate_short', '?')}x); "
                f"budget remaining {rec.get('budget_remaining', '?')}"
            ),
            detail={k: rec.get(k) for k in (
                "slo", "burn_rate", "burn_rate_short", "window_s",
                "events", "bad", "budget_remaining",
            )},
        )


_DETECTOR_CLASSES = {
    "step_regression": StepRegressionDetector,
    "stall": StallDetector,
    "straggler_burst": StragglerBurstDetector,
    "nonfinite": NonfiniteDetector,
    "ckpt_stall": CkptStallDetector,
    "slo_breach": SLOBreachDetector,
}


def build_detectors(spec: DetectorSpec) -> List[object]:
    return [_DETECTOR_CLASSES[kind](**params)
            for kind, params in spec.detectors]


class DetectorEngine:
    """Feeds every bus record through the armed detectors; thread-safe.

    Records arrive from whatever thread emits them (the step loop, the
    async checkpoint writer, the watchdog), so observation is serialized
    under one lock; ``on_trigger`` is invoked inside it and must be cheap
    and non-reentrant (the recorder only flips a pending flag).
    """

    def __init__(self, spec: DetectorSpec,
                 on_trigger: Callable[[Trigger], None]):
        self.spec = spec
        self._detectors = build_detectors(spec)
        self._on_trigger = on_trigger
        self._lock = threading.Lock()

    def observe(self, record: dict) -> None:
        with self._lock:
            for det in self._detectors:
                try:
                    trig = det.observe(record)
                except Exception:  # a broken detector must not kill the run
                    logger.exception(
                        "detector %s failed", getattr(det, "kind", det)
                    )
                    continue
                if trig is not None:
                    self._on_trigger(trig)
