"""The telemetry surface of the port: metric registry, typed events and
the crash-safe JSONL stream.

The port's copy of ``pytorch_distributed_nn_tpu/observability/core.py``,
on the same record schema, metric names and help strings, so either
package's ``obs`` tools read the other's streams and ``obs export``
replays a stream into the same Prometheus exposition:

- :class:`MetricRegistry`: counters, gauges and fixed-bucket histograms,
  optionally labelled, rendered by ``observability.promexport``.
- typed events (``Telemetry.emit``, :data:`EVENT_TYPES`); every emit
  also bumps ``events_total{type=...}``.
- :class:`TelemetrySink`: an append-only, line-buffered JSONL stream
  whose first record is the run's ``manifest``; a crash leaves a valid
  prefix and at most one torn tail line, which the reader tolerates.
- ``Telemetry.log_step``: one ``kind: "step"`` record per training step
  or per served request (a record with ``latency_ms``, routed to the
  ``serving_*`` family), and ``subscribe`` (live listeners: the flight
  recorder's detectors, the SLO engine, the canary router; a listener
  that raises is logged and skipped for that record).
- a process default (:func:`get_telemetry`, :func:`install`) where the
  low-level writers (checkpoint, retry, registry) emit.

Importing this module imports no torch: the frontend and the ``obs``
tools use it in processes that never touch the card.
"""

from __future__ import annotations

import json
import os
import platform
import re
import sys
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional, Tuple

SCHEMA_VERSION = 2

#: default basename of the per-run telemetry stream inside a train_dir
STREAM_BASENAME = "telemetry.jsonl"

#: basename of a SERVING run's stream (serving/loadgen.serving_telemetry):
#: same record schema, manifest-headed, but the per-"step" records are
#: per-REQUEST latencies — reader.find_stream falls back to this name so
#: `obs summary <serve_dir>` works unchanged
SERVING_BASENAME = "serving.jsonl"


def stream_basename(rank: Optional[int] = None) -> str:
    """Per-process stream basename inside a shared train_dir.

    Process 0 keeps the historical ``telemetry.jsonl`` (every existing
    reader path keeps working); other processes of a multi-host run get
    ``telemetry-rank<k>.jsonl`` so N processes never interleave appends
    into one file. ``reader.find_streams`` globs the whole family.
    """
    if not rank:
        return STREAM_BASENAME
    stem, ext = os.path.splitext(STREAM_BASENAME)
    return f"{stem}-rank{int(rank)}{ext}"

#: the typed-event catalogue (docs/observability.md). Emitting an unlisted
#: type is allowed (forward compatibility) but the canon lives here.
EVENT_TYPES = (
    "checkpoint_write",
    "ckpt_backpressure",
    "checkpoint_gc",
    "retry",
    "straggler_drop",
    "nonfinite_skip",
    "fault_injected",
    "eval_result",
    "preempt",
    "stall",
    "incident",
    "input_wait",
    "request_dropped",
    # SLO engine (observability/slo.py): emitted edge-triggered when an
    # objective's multi-window burn rate crosses into breach — the
    # slo_breach flight-recorder detector converts it into an incident
    "slo_breach",
    "elastic_resume",
    "data_refastforward",
    # sweep-journal events (experiments/runner.py, docs/experiments.md):
    # the sweep.jsonl journal is a manifest-headed stream of this same
    # schema; these record each trial attempt's dispatch and outcome
    "trial_start",
    "trial_end",
    # fleet lifecycle (experiments/fleet/, docs/experiments.md "Fleet"):
    # a host agent registered its capacity / missed its lease and was
    # declared dead / an in-flight trial was re-dispatched off a dead
    # host (it resumes elastically on the new host — the subsequent
    # trial_start names it)
    "host_join",
    "host_dead",
    "trial_migrate",
    # deployment lifecycle (serving/registry.py + router.py,
    # docs/serving.md "Deployment lifecycle"): registry entry added /
    # retired, weights hot-swapped under live traffic, canary ramp
    # transition, canary promoted to stable, canary convicted and
    # rolled back (edge-triggered, one per canary)
    "registry_publish",
    "registry_gc",
    "swap",
    "canary",
    "promote",
    "rollback",
    # serving availability layer (serving/batcher.py admission control +
    # serving/frontend.py, docs/serving.md "Availability & overload"):
    # a submit shed by the bounded admission queue (429 + Retry-After) /
    # a replica's circuit breaker opened on consecutive failures / the
    # breaker closed again after a successful half-open probe / a hedge
    # request fired for a slow primary (first response wins, request_id
    # deduped) / a replica joined or left the frontend's ready set /
    # a drain started (SIGTERM: admissions stop, in-flight finishes) /
    # a frontend forward returned a client-visible 5xx after exhausting
    # its retry budget (offered-but-not-served: the availability
    # metric's denominator)
    "request_shed",
    "request_failed",
    "breaker_open",
    "breaker_close",
    "hedge",
    "replica_up",
    "replica_down",
    "drain",
)

#: seconds-scale histogram buckets: wide enough for μs-scale data phases
#: and minute-scale checkpoint writes alike
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _labels_key(labels: Optional[Dict[str, str]]) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    for k in labels:
        if not _LABEL_RE.match(k):
            raise ValueError(f"bad label name {k!r}")
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonically-increasing metric (Prometheus `counter`)."""

    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc by {amount})")
        self.value += float(amount)


class Gauge:
    """Set-to-current-value metric (Prometheus `gauge`)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)


class Histogram:
    """Fixed-bucket histogram: cumulative-on-render, additive-on-merge.

    ``buckets`` are strictly-increasing upper bounds; observations past the
    last bound land in the implicit +Inf bucket. ``counts`` are *per-bucket*
    (not cumulative) so two histograms merge by element-wise addition — the
    property `obs export` relies on when replaying a stream.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None,
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        if not buckets or list(buckets) != sorted(set(buckets)):
            raise ValueError(
                f"histogram {name}: buckets must be strictly increasing, "
                f"got {buckets!r}"
            )
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.buckets = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self.sum = 0.0

    @property
    def count(self) -> int:
        return sum(self.counts)

    def observe(self, value: float) -> None:
        value = float(value)
        self.sum += value
        for i, bound in enumerate(self.buckets):
            if value <= bound:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def cumulative(self) -> List[Tuple[float, int]]:
        """[(upper_bound, cumulative_count), ...] ending with (inf, count)."""
        out, acc = [], 0
        for bound, c in zip(self.buckets, self.counts):
            acc += c
            out.append((bound, acc))
        out.append((float("inf"), acc + self.counts[-1]))
        return out

    def merge(self, other: "Histogram") -> None:
        if other.buckets != self.buckets:
            raise ValueError(
                f"histogram {self.name}: cannot merge bucket layouts "
                f"{self.buckets} and {other.buckets}"
            )
        self.counts = [a + b for a, b in zip(self.counts, other.counts)]
        self.sum += other.sum


class MetricRegistry:
    """Get-or-create registry keyed by (name, labels); thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, Tuple], object] = {}

    def _get_or_create(self, cls, name, help, labels, **kw):
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        key = (name, _labels_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, help=help, labels=labels, **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}"
                )
            return m

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Optional[Dict[str, str]] = None,
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets)

    def get(self, name: str, labels: Optional[Dict[str, str]] = None):
        """Lookup without creating; None when absent."""
        return self._metrics.get((name, _labels_key(labels)))

    def collect(self) -> List[object]:
        """All metrics, sorted by (name, labels) — stable exposition order."""
        with self._lock:
            return [
                self._metrics[k] for k in sorted(self._metrics, key=str)
            ]


def _json_default(obj):
    """numpy scalars / arrays sneak into records; coerce, never crash the
    sink (a failed telemetry write must not kill a training step)."""
    for caster in (float, int, str):
        try:
            return caster(obj)
        except (TypeError, ValueError):
            continue
    return repr(obj)


class TelemetrySink:
    """Append-only JSONL stream opened with a run-manifest header record.

    Line-buffered: every record hits the OS on its newline, so a crashed
    process loses at most the final partially-written line (the reader
    treats a torn tail as truncation, not corruption). ``flush(fsync=True)``
    — the preemption path — additionally forces the file to stable storage
    before the process exits.
    """

    def __init__(self, path: str, manifest: dict):
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self.path = path
        self._lock = threading.Lock()
        self._file = open(path, "a", buffering=1)
        # every open appends a manifest: the first is the stream header,
        # later ones mark restarts (resume appends to the same stream)
        self.write(manifest)

    def write(self, record: dict) -> None:
        with self._lock:
            if self._file is None:
                return
            self._file.write(
                json.dumps(record, default=_json_default) + "\n"
            )

    def flush(self, fsync: bool = False) -> None:
        with self._lock:
            if self._file is None:
                return
            self._file.flush()
            if fsync:
                os.fsync(self._file.fileno())

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.flush()
                self._file.close()
                self._file = None


def step_seconds(r: dict) -> Optional[float]:
    """A step record's step time in seconds: the JAX trainer's
    ``step_time``, else the port trainer's ``step_ms``; None without
    either."""
    if "step_time" in r:
        return float(r["step_time"])
    if "step_ms" in r:
        return float(r["step_ms"]) / 1000.0
    return None


def run_manifest(
    config: Optional[dict] = None,
    mesh_shape: Optional[dict] = None,
    **extra,
) -> dict:
    """Build a run-manifest record: identity + config + environment.

    torch's version is recorded only when torch is already imported: the
    frontend and the ``obs`` tools never pay its import for a manifest.
    Every manifest carries ``rank`` (0 unless passed), ``host`` and a
    ``clock`` (wall and monotonic time sampled together) for the
    cross-rank merge of ``reader.merge_streams``.
    """
    versions = {
        "python": platform.python_version(),
        "schema": SCHEMA_VERSION,
    }
    np = sys.modules.get("numpy")
    if np is not None:
        versions["numpy"] = np.__version__
    torch = sys.modules.get("torch")
    if torch is not None:
        versions["torch"] = getattr(torch, "__version__", "?")
    manifest = {
        "kind": "manifest",
        "schema": SCHEMA_VERSION,
        "run_id": uuid.uuid4().hex[:12],
        "time": time.time(),
        "versions": versions,
        "host": platform.node(),
        "rank": 0,
        "clock": {"wall": time.time(), "mono": time.monotonic()},
    }
    if config is not None:
        manifest["config"] = config
    if mesh_shape is not None:
        manifest["mesh_shape"] = mesh_shape
    # distributed-trace relay: a process spawned by the sweep runner or a
    # fleet agent inherits its attempt's span in PDTN_TRACE_CONTEXT; the
    # manifest derives its own child span under it, so trial telemetry
    # joins the sweep's trace (orchestrator -> agent -> trial, the agent
    # named by PDTN_TRACE_VIA). An unset or malformed value stamps
    # nothing: manifests must never fail on environment garbage.
    relayed = os.environ.get("PDTN_TRACE_CONTEXT")
    if relayed:
        from pytorch_distributed_nn_tpu_torch.observability import tracing

        try:
            ctx = tracing.TraceContext.from_header(relayed).child()
        except ValueError:
            pass
        else:
            block = ctx.fields()
            via = os.environ.get("PDTN_TRACE_VIA")
            if via:
                block["via"] = via
            manifest["trace_context"] = block
    for k, v in extra.items():
        if v is not None:
            manifest[k] = v
    return manifest


class Telemetry:
    """The facade: one registry + optional sink + subscribers.

    ``emit`` writes a typed event; ``log_step`` writes a per-step record —
    both update the registry so the Prometheus exposition and the JSONL
    stream can never disagree. ``subscribe(fn)`` registers a callback that
    receives every record (the `obs tail` hook for in-process consumers).
    """

    def __init__(self, registry: Optional[MetricRegistry] = None,
                 sink: Optional[TelemetrySink] = None,
                 manifest: Optional[dict] = None):
        self.registry = registry or MetricRegistry()
        self.sink = sink
        self.manifest = manifest
        self._subs: List[Callable[[dict], None]] = []

    @classmethod
    def for_run(cls, path: Optional[str], manifest: Optional[dict] = None,
                registry: Optional[MetricRegistry] = None) -> "Telemetry":
        manifest = manifest if manifest is not None else run_manifest()
        sink = TelemetrySink(path, manifest) if path else None
        return cls(registry=registry, sink=sink, manifest=manifest)

    # -- producers --------------------------------------------------------

    def emit(self, etype: str, step: Optional[int] = None, **fields) -> dict:
        record = {"kind": "event", "type": str(etype), "time": time.time(),
                  "mono": time.monotonic()}
        if step is not None:
            record["step"] = int(step)
        record.update(fields)
        self.registry.counter(
            "events_total", help="typed telemetry events by type",
            labels={"type": str(etype)},
        ).inc()
        self._publish(record)
        return record

    def log_step(self, record: dict) -> dict:
        """Write one per-step record (never mutates the caller's dict).

        Each record is stamped with wall + monotonic publish time (unless
        the caller supplied them) — the raw material for the cross-rank
        merge's clock-skew estimate. Publish time, not step-boundary time:
        with ``log_every > 1`` a whole window flushes together, so the
        alignment granularity is the log window.
        """
        rec = {"kind": "step", **record}
        rec.setdefault("time", time.time())
        rec.setdefault("mono", time.monotonic())
        reg = self.registry
        if rec.get("latency_ms") is not None:
            # serving request record (serving/batcher.py): route to the
            # pdtn_serving_* metric family and skip the train-step
            # counters — a served request is not an optimizer step
            reg.counter(
                "serving_requests_total", help="requests served",
            ).inc()
            for key, metric, help_ in (
                ("latency_ms", "serving_latency_seconds",
                 "end-to-end request latency (enqueue -> result)"),
                ("queue_ms", "serving_queue_seconds",
                 "request admission-queue wait"),
                ("infer_ms", "serving_infer_seconds",
                 "device forward time of the request's batch"),
            ):
                v = rec.get(key)
                if v is not None:
                    reg.histogram(metric, help=help_).observe(
                        float(v) / 1000.0
                    )
            if rec.get("batch") is not None:
                reg.gauge(
                    "serving_last_batch",
                    help="coalesced batch size of the last served batch",
                ).set(float(rec["batch"]))
            if rec.get("new_tokens") is not None:
                # generative request record (serving/generate/): token
                # throughput + latency-shape metrics alongside the
                # request-level family (pdtn_serving_tokens_total & co)
                reg.counter(
                    "serving_tokens_total",
                    help="tokens generated by the decode path",
                ).inc(float(rec["new_tokens"]))
                if rec.get("tokens_per_s") is not None:
                    reg.gauge(
                        "serving_tokens_per_s",
                        help="per-request generation rate "
                             "(new tokens / generation wall)",
                    ).set(float(rec["tokens_per_s"]))
                if rec.get("ttft_ms") is not None:
                    reg.histogram(
                        "serving_ttft_seconds",
                        help="time to first token (prefill latency)",
                    ).observe(float(rec["ttft_ms"]) / 1000.0)
                itl = rec.get("itl_ms") or {}
                if isinstance(itl, dict) and itl.get("mean") is not None:
                    reg.histogram(
                        "serving_inter_token_seconds",
                        help="per-request mean inter-token latency",
                    ).observe(float(itl["mean"]) / 1000.0)
            self._publish(rec)
            return rec
        reg.counter("steps_total", help="completed optimizer steps").inc()
        if "step" in rec:
            reg.gauge("last_step", help="last completed step").set(rec["step"])
        for key, metric in (
            ("step_time", "step_time_seconds"),
            ("data_time", "data_time_seconds"),
        ):
            v = rec.get(key)
            if v is not None:
                reg.histogram(metric, help=f"per-step {key}").observe(v)
        v = rec.get("input_wait_ms")
        if v is not None:
            # input-pipeline wait: how long the step loop blocked on the
            # loader (docs/data.md) — before this metric a slow loader
            # was invisible, billed to the step
            reg.histogram(
                "input_wait_seconds", help="per-step input-pipeline wait"
            ).observe(float(v) / 1000.0)
            reg.counter(
                "input_wait_ms_total",
                help="cumulative step-loop ms blocked on the input pipeline",
            ).inc(float(v))
        for key in ("loss", "acc1", "acc5"):
            v = rec.get(key)
            if v is not None:
                reg.gauge(key, help=f"last logged {key}").set(v)
        for key, counter in (
            ("skipped_nonfinite", "nonfinite_skips_total"),
            ("straggler_dropped", "straggler_dropped_total"),
        ):
            v = rec.get(key)
            if v:
                reg.counter(counter).inc(float(v))
        self._derive_efficiency(rec)
        self._publish(rec)
        return rec

    def _derive_efficiency(self, rec: dict) -> None:
        """Efficiency gauges from the manifest's static step cost.

        The trainer stamps ``step_cost`` (global per-step FLOPs/bytes +
        the backend peak table values) into the run manifest; every step
        record's wall time then yields achieved FLOP/s, **MFU** and the
        bandwidth-utilization gauges — derived HERE so the live registry
        and an ``obs export`` replay (which routes through this same
        method) can never disagree. Streams without a step cost (pre-
        efficiency runs, serving streams) skip silently — the absent-
        family contract `obs summary`/`compare` rely on.
        """
        sc = (self.manifest or {}).get("step_cost")
        if not sc:
            return
        try:
            st = step_seconds(rec)  # the JAX step_time or the port's step_ms
            if not st or st <= 0:
                return
            reg = self.registry
            flops = float(sc.get("flops") or 0.0)
            peak = float(sc.get("peak_flops_per_s") or 0.0)
            if flops:
                achieved = flops / st
                reg.gauge(
                    "achieved_flops_per_s",
                    help="global FLOP/s over the last step's wall time",
                ).set(achieved)
                if peak:
                    reg.gauge(
                        "mfu",
                        help="model FLOPs utilization: achieved FLOP/s / "
                             "backend peak (docs/observability.md)",
                    ).set(achieved / peak)
            hbm = float(sc.get("hbm_bytes") or 0.0)
            hbm_peak = float(sc.get("peak_hbm_bytes_per_s") or 0.0)
            if hbm and hbm_peak:
                reg.gauge(
                    "hbm_util",
                    help="HBM traffic utilization: static bytes/step over "
                         "wall time / peak bandwidth",
                ).set(hbm / st / hbm_peak)
            ici = sc.get("ici_bytes")
            if ici is not None:
                reg.gauge(
                    "ici_bytes_per_s",
                    help="interconnect bytes/s implied by the static "
                         "per-step collective payload",
                ).set(float(ici) / st)
        except (TypeError, ValueError):
            pass

    def _publish(self, record: dict) -> None:
        if self.sink is not None:
            self.sink.write(record)
        for fn in list(self._subs):
            try:
                fn(record)
            except Exception:  # a broken subscriber must not kill the run
                import logging

                logging.getLogger(__name__).exception(
                    "telemetry subscriber failed"
                )

    def subscribe(self, fn: Callable[[dict], None]) -> None:
        self._subs.append(fn)

    def unsubscribe(self, fn: Callable[[dict], None]) -> None:
        if fn in self._subs:
            self._subs.remove(fn)

    # -- lifecycle --------------------------------------------------------

    def flush(self, fsync: bool = False) -> None:
        if self.sink is not None:
            self.sink.flush(fsync=fsync)

    def close(self) -> None:
        if self.sink is not None:
            self.sink.close()


# ---------------------------------------------------------------------------
# Process-wide default: low-level emitters (retry, checkpoint, fault hooks)
# reach telemetry without a plumbed handle. Unconfigured, events land in an
# in-memory registry and no stream — emitting is always safe.
# ---------------------------------------------------------------------------

_default = Telemetry()
_default_lock = threading.Lock()


def get_telemetry() -> Telemetry:
    """The process-wide Telemetry (a run's, when one is installed)."""
    return _default


def install(telemetry: Telemetry) -> Telemetry:
    """Make ``telemetry`` the process default; returns the previous one."""
    global _default
    with _default_lock:
        prev, _default = _default, telemetry
        return prev


def uninstall(telemetry: Telemetry, previous: Telemetry) -> None:
    """Restore ``previous`` iff ``telemetry`` is still the default (two
    interleaved runs uninstalling out of order must not resurrect a closed
    sink)."""
    global _default
    with _default_lock:
        if _default is telemetry:
            _default = previous
