"""Offline metrics analysis: speedups and per-phase time costs (the port
of ``pytorch_distributed_nn_tpu/analysis/run_metrics.py``).

The input is the structured JSONL a trainer of either package emits
(``metrics_path``): the JAX trainer's step records carry ``step_time``
(seconds) and ``imgs_per_sec``, the port's ``step_ms`` and
``images_per_sec`` (or ``tokens_per_sec``); each is read through
:func:`..observability.core.step_seconds` and :func:`_rate`, so both
streams summarize alike. Records without a ``data_time`` count none.
"""

from __future__ import annotations

import json
from typing import Dict, List

from pytorch_distributed_nn_tpu_torch.observability.core import step_seconds

#: a step record's throughput, by trainer: the JAX key first
_RATE_KEYS = ("imgs_per_sec", "images_per_sec", "tokens_per_sec")


def load_metrics(path: str) -> List[dict]:
    """Step records from a metrics/telemetry JSONL file.

    Reads both formats: the pre-telemetry stream (bare step records) and
    the unified telemetry stream (``kind``-tagged records with a
    manifest header and interleaved events; only the step records are
    returned). A torn final line (crashed writer) is skipped, matching
    the stream's valid-prefix crash contract.
    """
    out: List[dict] = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # torn tail
            if rec.get("kind", "step") == "step":
                out.append(rec)
    return out


def _rate(r: dict) -> float:
    for k in _RATE_KEYS:
        if k in r:
            return float(r[k])
    raise KeyError(f"step record without a throughput ({_RATE_KEYS})")


def summarize(records: List[dict], skip: int = 1) -> Dict[str, float]:
    """Mean per-step stats, skipping the first `skip` (compile) steps."""
    usable = records[skip:] if len(records) > skip else records
    if not usable:
        return {}
    n = len(usable)
    steps = [step_seconds(r) for r in usable]
    data = [float(r.get("data_time", 0.0)) for r in usable]
    return {
        "steps": n,
        "loss_first": usable[0]["loss"],
        "loss_last": usable[-1]["loss"],
        "mean_step_time": sum(steps) / n,
        "mean_data_time": sum(data) / n,
        "mean_imgs_per_sec": sum(_rate(r) for r in usable) / n,
        "total_time": sum(s + d for s, d in zip(steps, data)),
    }


def speedup(
    single_records: List[dict],
    distributed_records: List[dict],
    skip: int = 1,
) -> float:
    """Throughput ratio distributed/single — the notebooks' speedup metric.

    The reference defined speedup as single-node wall time over distributed
    wall time for the same work; images/sec ratio is the same quantity
    when both runs use the same global batch.
    """
    s = summarize(single_records, skip)
    d = summarize(distributed_records, skip)
    if not s or not d:
        raise ValueError("empty metric records")
    return d["mean_imgs_per_sec"] / s["mean_imgs_per_sec"]


def time_cost_report(records: List[dict], skip: int = 1) -> str:
    """Human-readable per-phase breakdown (the notebooks' time-cost plots)."""
    s = summarize(records, skip)
    if not s:
        return "no records"
    total = s["mean_step_time"] + s["mean_data_time"]
    return (
        f"steps={s['steps']} loss {s['loss_first']:.4f}->{s['loss_last']:.4f}  "
        f"step {s['mean_step_time'] * 1e3:.1f}ms "
        f"({100 * s['mean_step_time'] / total:.0f}%)  "
        f"data {s['mean_data_time'] * 1e3:.1f}ms "
        f"({100 * s['mean_data_time'] / total:.0f}%)  "
        f"throughput {s['mean_imgs_per_sec']:.0f} imgs/s"
    )
