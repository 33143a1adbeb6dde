"""The flight recorder: anomaly-triggered incident bundles. The port of
``pytorch_distributed_nn_tpu/observability/flightrec.py``, with a
``torch.profiler`` trace in each bundle.

- It subscribes to the run's telemetry bus and keeps the last N records
  in a ring;
- the detectors (:mod:`.detect`) convict anomalies (step-time EWMA
  regression, watchdog stall, nonfinite bursts, checkpoint-stall
  breaches) against the run's own baseline;
- on a trigger, the NEXT step boundary opens an **incident bundle**
  under ``<train_dir>/incidents/<step>-<kind>/``::

      incident.json   # trigger kind/step/reason/detail + spec + timing
      events.jsonl    # the ring: the last N records before the trigger
      manifest.json   # the run manifest (identity, config, geometry)
      env.json        # CUDA_/TORCH_/PYTORCH_/NCCL_ variables, versions,
                      # the card's name and power limit
      trace/          # torch.profiler trace of the next capture_steps steps
      report.md       # generated summary (observability/xplane.py)

Rate limiting is structural: at most one capture in flight, a finished
capture starts a ``cooldown``-step quiet window, and ``max_bundles``
caps the bundles of a run. Suppressed triggers are counted
(``detector_suppressed_total``).

Threading: triggers may arrive from any thread (the async checkpoint
writer emits ``checkpoint_write``, the watchdog ``stall``), but captures
start and stop only inside :meth:`FlightRecorder.tick`, which the trainer
calls once per completed step on its own thread: a profiler session
brackets whole steps.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import subprocess
import threading
import time
from typing import List, Optional

from pytorch_distributed_nn_tpu_torch.observability.detect import (
    DetectorEngine,
    DetectorSpec,
    Trigger,
)
from pytorch_distributed_nn_tpu_torch.utils import profiling

logger = logging.getLogger(__name__)

#: subdirectory of a train_dir holding incident bundles
INCIDENT_DIRNAME = "incidents"

#: environment variables captured into env.json (prefix match)
_ENV_PREFIXES = ("CUDA_", "TORCH_", "PYTORCH_", "NCCL_")


def incidents_dir(train_dir: str) -> str:
    return os.path.join(train_dir, INCIDENT_DIRNAME)


def resolved_env() -> dict:
    """The accelerator-relevant environment as the run resolved it: the
    variables of :data:`_ENV_PREFIXES`, torch's and CUDA's versions, and
    with a card its name, count and power limit (``nvidia-smi``)."""
    import torch

    env = {
        k: v for k, v in sorted(os.environ.items())
        if k.startswith(_ENV_PREFIXES)
    }
    out = {"env": env, "torch_version": torch.__version__,
           "cuda_version": torch.version.cuda}
    if torch.cuda.is_available():
        out["device_count"] = torch.cuda.device_count()
        out["device_name"] = torch.cuda.get_device_name(0)
        try:
            out["power_limit"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=30, check=True).stdout.strip().splitlines()[0]
        except (OSError, subprocess.SubprocessError, IndexError) as e:
            out["power_limit"] = f"unavailable ({e!r})"
    else:
        out["device_count"] = 0
    return out


class _Capture:
    """One in-flight incident capture."""

    def __init__(self, trigger: Trigger, bundle_dir: str, until_step: int):
        self.trigger = trigger
        self.bundle_dir = bundle_dir
        self.until_step = until_step
        self.trace_started = False
        self.trace_error: Optional[str] = None


class FlightRecorder:
    """Bus subscriber + detector engine + bundle writer (see module doc).

    ``tracer`` is the (start, stop) pair used for the profiler window;
    the default is :func:`..utils.profiling.start_trace` /
    ``stop_trace`` (tests inject fakes).
    """

    def __init__(self, train_dir: str, telemetry, spec: DetectorSpec,
                 tracer=None):
        self.train_dir = train_dir
        self.telemetry = telemetry
        self.spec = spec
        self.dir = incidents_dir(train_dir)
        self._ring: collections.deque = collections.deque(maxlen=spec.ring)
        self._lock = threading.Lock()
        self._pending: Optional[Trigger] = None
        self._capture: Optional[_Capture] = None
        self._bundles: List[str] = []
        self._cooldown_until = 0  # step before which new captures are muted
        self._step = 0  # last step seen by tick()
        self._suppressed = 0
        self._closed = False
        self._tracer = tracer
        self._report_thread: Optional[threading.Thread] = None
        self._engine = DetectorEngine(spec, self._on_trigger)
        if telemetry.manifest:
            # the sink wrote the manifest before any subscriber existed;
            # seed the ring so every bundle's event ring is self-describing
            self._ring.append(telemetry.manifest)
        telemetry.subscribe(self._on_record)
        self._armed_gauge = telemetry.registry.gauge(
            "detector_armed",
            help="1 while the flight recorder can open a new capture",
        )
        self._armed_gauge.set(1.0)

    # -- bus side (any thread) --------------------------------------------

    def _on_record(self, record: dict) -> None:
        self._ring.append(record)
        self._engine.observe(record)

    def _on_trigger(self, trigger: Trigger) -> None:
        with self._lock:
            if self._closed:
                return
            blocked = (
                self._pending is not None
                or self._capture is not None
                or len(self._bundles) >= self.spec.max_bundles
                or self._step < self._cooldown_until
            )
            if blocked:
                self._suppressed += 1
                self.telemetry.registry.counter(
                    "detector_suppressed_total",
                    help="triggers muted by cooldown/in-flight/cap",
                    labels={"kind": trigger.kind},
                ).inc()
                logger.info(
                    "flightrec: %s trigger at step %s suppressed "
                    "(cooldown/in-flight/cap)", trigger.kind, trigger.step,
                )
                return
            self._pending = trigger

    def notify_stall(self, age: float) -> None:
        """Direct watchdog hook (resilience/supervisor.RunSupervisor):
        works even when the watchdog's telemetry default is not this
        run's bus. Deduped against the bus-side stall event by the
        one-pending-trigger rule."""
        self._on_trigger(Trigger(
            "stall", None,
            reason=f"watchdog hook: heartbeat quiet {age:.1f}s",
            detail={"age_seconds": round(age, 3)},
        ))

    # -- step-loop side (main thread) -------------------------------------

    def tick(self, step: int, trace_ok: bool = True) -> None:
        """Once per completed step: finish a due capture, open a pending
        one. ``trace_ok=False`` (a user ``--profile`` trace is active)
        still writes the bundle, just without its own profiler window —
        two profiler sessions cannot nest."""
        self._step = max(self._step, int(step))
        if self._capture is not None and step >= self._capture.until_step:
            self._finish_capture(step)
        if self._capture is None:
            with self._lock:
                trigger, self._pending = self._pending, None
            if trigger is not None:
                self._begin_capture(trigger, step, trace_ok=trace_ok)
        self._armed_gauge.set(0.0 if (
            self._capture is not None
            or len(self._bundles) >= self.spec.max_bundles
            or self._step < self._cooldown_until
            or self._closed
        ) else 1.0)

    def due(self, step: int) -> bool:
        """Whether :meth:`tick` at ``step`` would stop a capture or open a
        pending one (the trainer completes its in-flight steps first)."""
        if self._capture is not None:
            return step >= self._capture.until_step
        return self._pending is not None

    def finalize(self, step: Optional[int] = None) -> None:
        """End-of-run: close an in-flight capture (the trace window is
        whatever steps actually ran), join the report writer, disarm."""
        if self._capture is not None:
            self._finish_capture(self._step if step is None else step)
        if self._report_thread is not None and self._report_thread.is_alive():
            self._report_thread.join()
        with self._lock:
            self._closed = True
        self._armed_gauge.set(0.0)

    def close(self) -> None:
        self.finalize()
        self.telemetry.unsubscribe(self._on_record)

    @property
    def bundles(self) -> List[str]:
        return list(self._bundles)

    @property
    def suppressed(self) -> int:
        return self._suppressed

    # -- capture machinery -------------------------------------------------

    def _begin_capture(self, trigger: Trigger, step: int,
                       trace_ok: bool) -> None:
        name = f"{trigger.step if trigger.step is not None else step}" \
               f"-{trigger.kind}"
        bundle = os.path.join(self.dir, name)
        suffix = 1
        while os.path.exists(bundle):
            suffix += 1
            bundle = os.path.join(self.dir, f"{name}.{suffix}")
        cap = _Capture(trigger, bundle,
                       until_step=step + self.spec.capture_steps)
        os.makedirs(bundle, exist_ok=True)
        with self._lock:
            ring = list(self._ring)
        _dump_json(os.path.join(bundle, "incident.json"), {
            "kind": trigger.kind,
            "step": trigger.step,
            "reason": trigger.reason,
            "detail": trigger.detail,
            "triggered_time": time.time(),
            "capture_from_step": step,
            "capture_until_step": cap.until_step,
            "spec": self.spec.describe(),
            "run_id": (self.telemetry.manifest or {}).get("run_id"),
        })
        with open(os.path.join(bundle, "events.jsonl"), "w") as f:
            for rec in ring:
                f.write(json.dumps(rec, default=str) + "\n")
        _dump_json(os.path.join(bundle, "manifest.json"),
                   self.telemetry.manifest or {})
        _dump_json(os.path.join(bundle, "env.json"), resolved_env())
        if trace_ok:
            try:
                self._trace_start(os.path.join(bundle, "trace"))
                cap.trace_started = True
            except Exception as e:  # profiler contention / unsupported
                cap.trace_error = repr(e)
                logger.warning("flightrec: trace start failed: %r", e)
        else:
            cap.trace_error = "user --profile trace active"
        self._capture = cap
        self.telemetry.registry.counter(
            "incidents_total", help="incident bundles opened by kind",
            labels={"kind": trigger.kind},
        ).inc()
        # NB: the field is `incident`, not `kind` — `kind` is the record
        # discriminator every reader switches on
        self.telemetry.emit(
            "incident", step=trigger.step,
            incident=trigger.kind, reason=trigger.reason,
            bundle=os.path.relpath(bundle, self.train_dir),
        )
        logger.warning(
            "flightrec: %s incident at step %s — capturing steps "
            "%d..%d into %s (%s)", trigger.kind, trigger.step,
            step + 1, cap.until_step, bundle, trigger.reason,
        )

    def _finish_capture(self, step: int) -> None:
        cap, self._capture = self._capture, None
        if cap is None:
            return
        # cooldown opens BEFORE any slow finalization below (the trace's
        # export and the report take seconds): a watchdog stall convicted
        # meanwhile must land in the cooldown, not open a capture of our
        # own report generation
        self._cooldown_until = step + self.spec.cooldown
        if cap.trace_started:
            try:
                self._trace_stop()
            except Exception as e:
                cap.trace_error = repr(e)
                logger.warning("flightrec: trace stop failed: %r", e)
        # report generation runs off the step loop (depth-1 like the
        # async-checkpoint writer); finalize() joins it
        prev = self._report_thread
        if prev is not None and prev.is_alive():
            prev.join()
        self._report_thread = threading.Thread(
            target=self._write_report, args=(cap,),
            name="pdtn-flightrec-report", daemon=True,
        )
        self._report_thread.start()
        self._bundles.append(cap.bundle_dir)
        logger.info(
            "flightrec: bundle %s complete (cooldown until step %d)",
            cap.bundle_dir, self._cooldown_until,
        )

    def _write_report(self, cap: _Capture) -> None:
        try:
            from pytorch_distributed_nn_tpu_torch.observability import xplane

            xplane.write_incident_report(cap.bundle_dir,
                                         trace_error=cap.trace_error)
        except Exception:
            logger.exception("flightrec: report generation failed")

    def _trace_start(self, trace_dir: str) -> None:
        if self._tracer is not None:
            self._tracer[0](trace_dir)
            return
        profiling.start_trace(trace_dir)

    def _trace_stop(self) -> None:
        if self._tracer is not None:
            self._tracer[1]()
            return
        profiling.stop_trace()


def _dump_json(path: str, payload: dict) -> None:
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, default=str)


# ---------------------------------------------------------------------------
# Offline inspection (the layout the JAX package's `obs incidents` reads)
# ---------------------------------------------------------------------------


def list_incidents(run_dir: str) -> List[dict]:
    """Incident bundles under ``run_dir``, oldest first.

    Each entry: ``name``, ``path``, ``kind``, ``step``, ``reason``,
    ``has_trace`` (non-empty trace dir), ``has_report``, ``events``
    (ring length). Unreadable bundles are reported with an ``error``
    field, never skipped silently."""
    base = os.path.basename(run_dir.rstrip(os.sep))
    root = run_dir if base == INCIDENT_DIRNAME else incidents_dir(run_dir)
    if not os.path.isdir(root):
        return []
    out = []
    for name in sorted(os.listdir(root)):
        bundle = os.path.join(root, name)
        if not os.path.isdir(bundle):
            continue
        entry = {"name": name, "path": bundle}
        try:
            with open(os.path.join(bundle, "incident.json")) as f:
                meta = json.load(f)
            entry.update(
                kind=meta.get("kind"), step=meta.get("step"),
                reason=meta.get("reason"),
                run_id=meta.get("run_id"),
            )
        except (OSError, ValueError) as e:
            entry["error"] = repr(e)
        trace = os.path.join(bundle, "trace")
        entry["has_trace"] = bool(
            os.path.isdir(trace)
            and any(files for _, _, files in os.walk(trace))
        )
        entry["has_report"] = os.path.isfile(
            os.path.join(bundle, "report.md")
        )
        try:
            with open(os.path.join(bundle, "events.jsonl")) as f:
                entry["events"] = sum(1 for line in f if line.strip())
        except OSError:
            entry["events"] = 0
        out.append(entry)
    return out


def _step_key(entry: dict):
    s = entry.get("step")
    return -1 if s is None else int(s)


def find_incident(run_dir: str, ref: str) -> Optional[dict]:
    """Resolve a bundle by name (``40-stall``) or step number (``40``)."""
    entries = list_incidents(run_dir)
    for e in entries:
        if e["name"] == ref:
            return e
    if ref.isdigit():
        matches = [e for e in entries if e.get("step") == int(ref)]
        if matches:
            return matches[0]
    return None
