"""The telemetry surface the generative scheduler and server call.

A subset of ``pytorch_distributed_nn_tpu/observability/core.py``: the
metric registry (counters, gauges, histograms), the append-only JSONL
sink, and :class:`Telemetry` with ``emit`` (typed events) and
``log_step`` (one record per served request, routed to the
``serving_*`` metric family). Records keep the JAX package's stream
format, so its ``obs`` tools read a port stream. Training-step
efficiency gauges and the Prometheus exporter are not ported yet.
"""

from __future__ import annotations

import json
import os
import platform
import threading
import time
import uuid
from typing import Dict, Optional, Tuple

SCHEMA_VERSION = 2

#: latency-histogram bounds, seconds (the JAX package's DEFAULT_BUCKETS)
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def _labels_key(labels: Optional[Dict[str, str]]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in (labels or {}).items()))


class Counter:
    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name, self.help, self.labels = name, help, dict(labels or {})
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        self.value += float(amount)


class Gauge:
    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name, self.help, self.labels = name, help, dict(labels or {})
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)


class Histogram:
    """Fixed-bucket histogram with per-bucket (not cumulative) counts."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None,
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        self.name, self.help, self.labels = name, help, dict(labels or {})
        self.buckets = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self.sum = 0.0

    def observe(self, value: float) -> None:
        value = float(value)
        self.sum += value
        for i, bound in enumerate(self.buckets):
            if value <= bound:
                self.counts[i] += 1
                return
        self.counts[-1] += 1


class MetricRegistry:
    """Get-or-create registry keyed by (name, labels); thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, Tuple], object] = {}

    def _get_or_create(self, cls, name, help, labels):
        key = (name, _labels_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls(name, help=help, labels=labels)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{m.kind}, requested {cls.kind}")
            return m

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Optional[Dict[str, str]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels)


def _json_default(obj):
    for caster in (float, int, str):
        try:
            return caster(obj)
        except (TypeError, ValueError):
            continue
    return repr(obj)


class TelemetrySink:
    """Append-only, line-buffered JSONL stream opened with a manifest."""

    def __init__(self, path: str, manifest: dict):
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self.path = path
        self._lock = threading.Lock()
        self._file = open(path, "a", buffering=1)
        self.write(manifest)

    def write(self, record: dict) -> None:
        with self._lock:
            if self._file is not None:
                self._file.write(
                    json.dumps(record, default=_json_default) + "\n"
                )

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


def run_manifest(config: Optional[dict] = None, **extra) -> dict:
    """The stream's header record: identity, versions, clock."""
    import torch

    manifest = {
        "kind": "manifest",
        "schema": SCHEMA_VERSION,
        "run_id": uuid.uuid4().hex[:12],
        "time": time.time(),
        "versions": {"python": platform.python_version(),
                     "schema": SCHEMA_VERSION, "torch": torch.__version__},
        "host": platform.node(),
        "rank": 0,
        "clock": {"wall": time.time(), "mono": time.monotonic()},
    }
    if config is not None:
        manifest["config"] = config
    manifest.update({k: v for k, v in extra.items() if v is not None})
    return manifest


class Telemetry:
    """One metric registry + an optional JSONL sink."""

    def __init__(self, registry: Optional[MetricRegistry] = None,
                 sink: Optional[TelemetrySink] = None,
                 manifest: Optional[dict] = None):
        self.registry = registry or MetricRegistry()
        self.sink = sink
        self.manifest = manifest

    @classmethod
    def for_run(cls, path: Optional[str],
                manifest: Optional[dict] = None) -> "Telemetry":
        manifest = manifest if manifest is not None else run_manifest()
        sink = TelemetrySink(path, manifest) if path else None
        return cls(sink=sink, manifest=manifest)

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
        """Write one served request's record (never mutates the caller's
        dict) and update the ``serving_*`` metrics from it."""
        rec = {"kind": "step", **record}
        rec.setdefault("time", time.time())
        rec.setdefault("mono", time.monotonic())
        reg = self.registry
        reg.counter("serving_requests_total", help="requests served").inc()
        for key, metric in (("latency_ms", "serving_latency_seconds"),
                            ("queue_ms", "serving_queue_seconds"),
                            ("infer_ms", "serving_infer_seconds"),
                            ("ttft_ms", "serving_ttft_seconds")):
            v = rec.get(key)
            if v is not None:
                reg.histogram(metric).observe(float(v) / 1000.0)
        if rec.get("new_tokens") is not None:
            reg.counter("serving_tokens_total",
                        help="tokens generated by the decode path",
                        ).inc(float(rec["new_tokens"]))
        itl = rec.get("itl_ms") or {}
        if isinstance(itl, dict) and itl.get("mean") is not None:
            reg.histogram("serving_inter_token_seconds").observe(
                float(itl["mean"]) / 1000.0
            )
        self._publish(rec)
        return rec

    def _publish(self, record: dict) -> None:
        if self.sink is not None:
            self.sink.write(record)

    def close(self) -> None:
        if self.sink is not None:
            self.sink.close()


_default = Telemetry()


def get_telemetry() -> Telemetry:
    """The process-wide Telemetry (in-memory registry, no stream)."""
    return _default
