"""Prometheus textfile exposition for the metric registry.

The port's copy of
``pytorch_distributed_nn_tpu/observability/promexport.py``: the same
metric names and text, so a replayed stream renders as the JAX
package's.

Renders a :class:`~..core.MetricRegistry` in the text exposition format
(version 0.0.4) and publishes it atomically, so a node-exporter textfile
collector (or anything that can scrape a file) sees training health:

    node_exporter --collector.textfile.directory=<train_dir>

The trainer writes ``<train_dir>/metrics.prom`` on every supervisor
heartbeat tick (resilience/supervisor.RunSupervisor.beat); ``cli obs
export`` renders the same format offline by replaying a telemetry stream
(observability/reader.replay_registry).

``validate_exposition`` is the format checker the test-suite AND
``obs summary --selftest`` share: sample-line grammar, TYPE-before-sample,
histogram invariants (monotone cumulative buckets, ``+Inf`` == ``_count``,
``_sum``/``_count`` present), non-negative counters, no duplicate samples.

Trainer-core families (``Telemetry.log_step`` / trainer.py):
``pdtn_steps_total`` counter, ``pdtn_last_step`` / ``pdtn_step_rate`` /
``pdtn_eta_seconds`` / ``pdtn_num_workers`` /
``pdtn_sync_bytes_per_step`` gauges, ``pdtn_input_wait_seconds``
histogram + ``pdtn_input_wait_ms_total`` counter (step loop blocked on
the input pipeline, docs/data.md), ``pdtn_events_total{type=...}``
(typed telemetry events by type), ``pdtn_run_info{run_id=...}`` (run
identity, value always 1 — the classic info-gauge join key) and the
``pdtn_phase_seconds{phase=...}`` histogram (utils/timing.py phase
timer).

Checkpoint families (``training/async_ckpt.py``, docs/training.md):
``pdtn_ckpt_queue_depth`` (saves in flight) and
``pdtn_ckpt_stall_ms_total`` (cumulative train-loop ms blocked on
checkpointing) — a stall-rate alerting rule is the scrape-side mirror
of the async-checkpoint selftest's stall budget.

Flight-recorder families (observability/flightrec.py) ride the same
exposition: ``pdtn_incidents_total{kind=...}`` (bundles opened),
``pdtn_detector_armed`` (1 while a new capture could open) and
``pdtn_detector_suppressed_total{kind=...}`` (triggers muted by
cooldown/in-flight/cap) — an alerting rule on ``incidents_total`` is the
scrape-side mirror of the on-disk bundle.

Serving families (serving/batcher.py via ``Telemetry.log_step``'s
request branch, docs/serving.md): ``pdtn_serving_latency_seconds`` /
``pdtn_serving_queue_seconds`` / ``pdtn_serving_infer_seconds``
histograms, ``pdtn_serving_requests_total`` /
``pdtn_serving_dropped_total`` counters, the generative family
(``pdtn_serving_tokens_total``, ``pdtn_serving_tokens_per_s``,
``pdtn_serving_ttft_seconds``, ``pdtn_serving_inter_token_seconds`` —
serving/generate/) and ``pdtn_serving_last_batch``
— a p99-latency alerting rule over the latency histogram is the
scrape-side mirror of the ``obs compare`` serving gate.

Availability families (docs/serving.md "Availability & overload"):
``pdtn_serving_queue_depth`` / ``pdtn_serving_queue_depth_peak`` gauges
(the bounded admission queue, live + high-water), the
``pdtn_serving_shed_total`` counter (429s issued at the door), and the
frontend's ``pdtn_frontend_replicas{state=...}`` gauge,
``pdtn_frontend_inflight`` / ``pdtn_frontend_inflight_peak`` gauges
(concurrent forwards, live + high-water) and the
``pdtn_frontend_retries_total`` / ``pdtn_frontend_hedges_total`` /
``pdtn_frontend_failed_total`` counters — a shed-rate alerting rule
over ``serving_shed_total`` is the scrape-side mirror of the
`obs compare` shed-fraction gate.

Efficiency families (``Telemetry._derive_efficiency``, derived from the
run manifest's ``step_cost`` record — docs/observability.md
"Efficiency"): ``pdtn_mfu``, ``pdtn_achieved_flops_per_s``,
``pdtn_hbm_util``, ``pdtn_ici_bytes_per_s`` gauges. Absent from runs
whose manifest carries no step cost (pre-efficiency streams, serving
runs) — an alerting rule on ``pdtn_mfu`` dropping is the scrape-side
mirror of the ``obs compare`` MFU gate.

SLO families (``observability/slo.py``, docs/observability.md "SLOs &
error budgets"): ``pdtn_slo_error_budget_remaining{slo=...}`` (1 =
untouched, <= 0 = exhausted) and ``pdtn_slo_burn_rate{slo=...,
window=...}`` (1 = spending exactly at budget; one series per
long/short evaluation window) — an alerting rule on the burn rate is
the scrape-side mirror of ``obs slo check`` and the ``slo_breach``
flight-recorder detector.

Sweep families (``experiments/runner.py``, docs/experiments.md): the
orchestrator publishes ``<sweep_dir>/metrics.prom`` after every trial
event — ``pdtn_sweep_trials_total`` / ``pdtn_sweep_trials_completed``
/ ``pdtn_sweep_trials_failed`` / ``pdtn_sweep_trials_running`` gauges,
``pdtn_sweep_steps_executed``,
``pdtn_sweep_best_loss`` and ``pdtn_sweep_retries_total`` — so a fleet
dashboard watches sweep progress without touching the journal.

Fleet families (``experiments/fleet/scheduler.py``, docs/experiments.md
"Fleet"): ``pdtn_fleet_hosts{state="alive"|"dead"}`` (the registered
roster by lease-judged liveness), ``pdtn_fleet_trials_inflight``
(attempts currently assigned to hosts) and
``pdtn_fleet_migrations_total`` (in-flight trials re-dispatched off
dead hosts) — an alerting rule on ``fleet_hosts{state="dead"}`` is the
scrape-side mirror of the journal's ``host_dead`` events.
"""

from __future__ import annotations

import math
import os
import re
from typing import Dict, List, Optional, Tuple

from pytorch_distributed_nn_tpu_torch.observability.core import (
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
)

#: every exported metric name is prefixed so a shared Prometheus never
#: collides with other jobs' series
PREFIX = "pdtn_"

PROM_BASENAME = "metrics.prom"


def _escape_label(value: str) -> str:
    return (
        str(value)
        .replace("\\", r"\\")
        .replace("\n", r"\n")
        .replace('"', r'\"')
    )


def _labels_str(labels: Dict[str, str], extra: Optional[Tuple[str, str]] = None) -> str:
    items = sorted(labels.items())
    if extra is not None:
        items = items + [extra]
    if not items:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in items)
    return "{" + inner + "}"


def _fmt(value: float) -> str:
    # non-finite gauges are legal exposition values (a diverged run's
    # last-loss gauge IS NaN) and must never crash the writer: before
    # this guard ran first, a supervised run whose loss went non-finite
    # died inside the heartbeat's metrics.prom publish
    if isinstance(value, float) and math.isnan(value):
        return "NaN"
    if isinstance(value, float) and math.isinf(value):
        return "+Inf" if value > 0 else "-Inf"
    if float(value) == int(value) and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


def render(registry: MetricRegistry, prefix: str = PREFIX) -> str:
    """Registry -> exposition text. Metrics sharing a name (label variants)
    share one HELP/TYPE header, as the format requires."""
    lines: List[str] = []
    seen_headers = set()
    for metric in registry.collect():
        name = prefix + metric.name
        if name not in seen_headers:
            seen_headers.add(name)
            if metric.help:
                lines.append(f"# HELP {name} {metric.help}")
            lines.append(f"# TYPE {name} {metric.kind}")
        if isinstance(metric, (Counter, Gauge)):
            lines.append(
                f"{name}{_labels_str(metric.labels)} {_fmt(metric.value)}"
            )
        elif isinstance(metric, Histogram):
            for bound, cum in metric.cumulative():
                le = "+Inf" if math.isinf(bound) else _fmt(bound)
                lines.append(
                    f"{name}_bucket{_labels_str(metric.labels, ('le', le))}"
                    f" {cum}"
                )
            lines.append(
                f"{name}_sum{_labels_str(metric.labels)} {_fmt(metric.sum)}"
            )
            lines.append(
                f"{name}_count{_labels_str(metric.labels)} {metric.count}"
            )
    return "\n".join(lines) + ("\n" if lines else "")


def write_textfile(registry: MetricRegistry, path: str,
                   prefix: str = PREFIX) -> str:
    """Atomic publish (tmp + rename): a scraper never reads a torn file —
    the same contract the checkpoint writers keep."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(render(registry, prefix=prefix))
    os.replace(tmp, path)
    return path


# ---------------------------------------------------------------------------
# Validation (shared by tests and `obs summary --selftest`)
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?P<labels>\{[^}]*\})?"
    r" (?P<value>[+-]?(?:[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?|Inf|NaN|nan|inf))"
    r"( [0-9]+)?$"
)
_LABEL_PAIR_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"'
)


def _base_family(name: str, types: Dict[str, str]) -> str:
    """Map a histogram sample name back to its declared family."""
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix) and name[: -len(suffix)] in types:
            return name[: -len(suffix)]
    return name


def validate_exposition(text: str) -> List[str]:
    """Return a list of format violations ([] == valid exposition text)."""
    errors: List[str] = []
    types: Dict[str, str] = {}
    samples: Dict[str, float] = {}
    # histogram bookkeeping: family -> {"buckets": [(le, cum)], "sum": x,
    # "count": n} keyed by the non-`le` label set
    hist: Dict[Tuple[str, str], dict] = {}

    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ")
            if len(parts) != 4 or parts[3] not in (
                "counter", "gauge", "histogram", "summary", "untyped",
            ):
                errors.append(f"line {lineno}: malformed TYPE line {line!r}")
                continue
            if parts[2] in types:
                errors.append(f"line {lineno}: duplicate TYPE for {parts[2]}")
            types[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            errors.append(f"line {lineno}: malformed sample {line!r}")
            continue
        name, raw_labels = m.group("name"), m.group("labels") or ""
        value = float(m.group("value").replace("Inf", "inf"))
        family = _base_family(name, types)
        if family not in types:
            errors.append(f"line {lineno}: sample {name} has no TYPE line")
            continue
        key = name + raw_labels
        if key in samples:
            errors.append(f"line {lineno}: duplicate sample {key}")
        samples[key] = value
        ftype = types[family]
        if ftype == "counter" and value < 0:
            errors.append(f"line {lineno}: counter {name} is negative")
        if ftype == "histogram":
            pairs = dict(_LABEL_PAIR_RE.findall(raw_labels))
            le = pairs.pop("le", None)
            hkey = (family, str(sorted(pairs.items())))
            h = hist.setdefault(
                hkey, {"buckets": [], "sum": None, "count": None}
            )
            if name.endswith("_bucket"):
                if le is None:
                    errors.append(
                        f"line {lineno}: histogram bucket without le label"
                    )
                else:
                    h["buckets"].append(
                        (float(le.replace("+Inf", "inf")), value)
                    )
            elif name.endswith("_sum"):
                h["sum"] = value
            elif name.endswith("_count"):
                h["count"] = value
            else:
                errors.append(
                    f"line {lineno}: bare sample {name} for histogram family"
                )

    for (family, labels), h in hist.items():
        where = f"histogram {family}{labels or ''}"
        if h["sum"] is None or h["count"] is None:
            errors.append(f"{where}: missing _sum or _count")
            continue
        buckets = h["buckets"]
        if not buckets or not math.isinf(buckets[-1][0]):
            errors.append(f"{where}: missing +Inf bucket")
            continue
        bounds = [b for b, _ in buckets]
        if bounds != sorted(bounds):
            errors.append(f"{where}: bucket bounds not sorted")
        cums = [c for _, c in buckets]
        if any(b > a for a, b in zip(cums[1:], cums)):
            errors.append(f"{where}: bucket counts not monotone")
        if cums[-1] != h["count"]:
            errors.append(
                f"{where}: +Inf bucket {cums[-1]} != _count {h['count']}"
            )
    return errors
