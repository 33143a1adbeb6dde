"""Telemetry-stream reading, summarizing, comparing, replaying.

The port's copy of ``pytorch_distributed_nn_tpu/observability/reader.py``
(host code, stdlib only): it reads either package's streams and
summarizes them as the JAX reader does.

The consumer half of the telemetry layer (``core`` is the producer half):
everything the ``cli obs`` family needs to answer questions a human or a CI
gate asks about a run, from the single self-describing JSONL stream —
replacing the reference's regex-over-logs notebooks
(analysis/*.ipynb, src/tiny_tuning_parser.py) for good.

- :func:`read_stream` — tolerant parse: a torn final line (crash mid-write)
  is flagged as ``truncated`` and the valid prefix is kept; corrupt
  interior lines are counted, never fatal.
- :func:`summarize_run` — per-phase p50/p95/p99, step-rate trend, event
  counts, checkpoint durations, accuracy-vs-step.
- :func:`compare_runs` — regression deltas between two runs; the CI
  surface behind ``cli obs compare`` (nonzero exit over threshold).
- :func:`replay_registry` — stream → registry, through the *same*
  ``Telemetry.log_step``/``emit`` update path the live trainer uses, so
  ``obs export`` renders exactly what a live scrape would have seen.
- :func:`write_synthetic_run` — golden-fixture generator shared by the
  test-suite and ``obs summary --selftest``.
"""

from __future__ import annotations

import collections
import dataclasses
import glob
import json
import math
import os
import random
from typing import Dict, List, Optional

from pytorch_distributed_nn_tpu_torch.observability.core import (
    SERVING_BASENAME,
    STREAM_BASENAME,
    MetricRegistry,
    Telemetry,
    run_manifest,
    step_seconds,
    stream_basename,
)


@dataclasses.dataclass
class RunStream:
    """One parsed telemetry stream."""

    path: str
    manifest: Optional[dict]  # the header (first manifest record)
    manifests: List[dict]  # all manifest records (len > 1 == restarts)
    steps: List[dict]
    events: List[dict]
    bad_lines: int = 0  # undecodable interior lines
    truncated: bool = False  # torn final line (valid prefix kept)


def find_stream(target: str) -> str:
    """Resolve a run dir or a direct file path to the stream file."""
    if os.path.isfile(target):
        return target
    if os.path.isdir(target):
        # training stream first; a serving run dir (serve bench/run)
        # holds serving.jsonl, a sweep/fleet dir sweep.jsonl — same
        # schema, discovered transparently ("sweep.jsonl" is spelled out
        # rather than imported: observability must not depend on the
        # experiments layer)
        for base in (STREAM_BASENAME, SERVING_BASENAME, "sweep.jsonl"):
            candidate = os.path.join(target, base)
            if os.path.isfile(candidate):
                return candidate
        raise FileNotFoundError(
            f"no {STREAM_BASENAME}, {SERVING_BASENAME} or sweep.jsonl in "
            f"{target} — pass a run dir written by a --supervise/"
            "--eval-freq/--metrics-path run (or a serve run/bench, or a "
            "sweep/fleet dir), or the JSONL file itself"
        )
    raise FileNotFoundError(f"{target}: no such file or directory")


def find_streams(target: str) -> List[str]:
    """All per-process streams of a run: ``telemetry.jsonl`` (rank 0)
    first, then ``telemetry-rank<k>.jsonl`` siblings — the multi-host
    family ``core.stream_basename`` names. A direct file path is returned
    as-is (a one-stream family)."""
    if os.path.isfile(target):
        return [target]
    if os.path.isdir(target):
        stem, ext = os.path.splitext(STREAM_BASENAME)
        paths = glob.glob(os.path.join(target, f"{stem}*{ext}"))
        if not paths:
            for base in (SERVING_BASENAME, "sweep.jsonl"):
                single = os.path.join(target, base)
                if os.path.isfile(single):
                    return [single]
        if paths:
            # rank 0's basename first, rank-suffixed siblings after in
            # rank order ("-rank10" must sort after "-rank2")
            def key(p):
                name = os.path.basename(p)
                if name == STREAM_BASENAME:
                    return (0, 0, name)
                rank = name[len(stem) + len("-rank"):-len(ext)]
                return (1, int(rank) if rank.isdigit() else 1 << 30, name)

            return sorted(paths, key=key)
        raise FileNotFoundError(
            f"no {stem}*{ext} streams in {target} — pass a run dir "
            "written by a --supervise/--eval-freq/--metrics-path run, or "
            "a JSONL file itself"
        )
    raise FileNotFoundError(f"{target}: no such file or directory")


def read_streams(target: str) -> List["RunStream"]:
    return [read_stream(p) for p in find_streams(target)]


def read_stream(target: str) -> RunStream:
    path = find_stream(target)
    manifests: List[dict] = []
    steps: List[dict] = []
    events: List[dict] = []
    bad = 0
    truncated = False
    with open(path) as f:
        lines = f.readlines()
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            if i == len(lines) - 1:
                truncated = True  # crash mid-write: valid prefix survives
            else:
                bad += 1
            continue
        kind = rec.get("kind")
        if kind == "manifest":
            manifests.append(rec)
        elif kind == "event":
            events.append(rec)
        elif kind == "step" or (kind is None and "step" in rec):
            # kind-less records are the pre-telemetry MetricsLogger format
            steps.append(rec)
    return RunStream(
        path=path,
        manifest=manifests[0] if manifests else None,
        manifests=manifests,
        steps=steps,
        events=events,
        bad_lines=bad,
        truncated=truncated,
    )


# ---------------------------------------------------------------------------
# Summaries
# ---------------------------------------------------------------------------


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) — exact for small n."""
    if not values:
        return float("nan")
    vals = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(vals)))
    return vals[min(rank, len(vals)) - 1]


def phase_stats(values: List[float]) -> Optional[dict]:
    if not values:
        return None
    return {
        "count": len(values),
        "mean": sum(values) / len(values),
        "p50": percentile(values, 50),
        "p95": percentile(values, 95),
        "p99": percentile(values, 99),
        "total": sum(values),
    }


def _rate(records: List[dict]) -> float:
    """Steps per wall-second over ``records`` (step + data time)."""
    wall = sum(
        (step_seconds(r) or 0.0) + r.get("data_time", 0.0) for r in records
    )
    return len(records) / wall if wall > 0 else float("nan")


def _event_stall_ms(e: dict) -> Optional[float]:
    """Loop blockage of one checkpoint_write event, in ms.

    New streams carry ``stall_ms`` explicitly (async saves: the snapshot/
    backpressure stall; sync saves: the full write). Pre-async streams
    only carried ``seconds`` — and those writes were synchronous, so the
    whole write WAS the stall: fall back to it, keeping ``obs summary``
    and ``obs compare`` meaningful across old and new streams.
    """
    if "stall_ms" in e:
        return float(e["stall_ms"])
    if "seconds" in e:
        return float(e["seconds"]) * 1000.0
    return None


def io_stall_summary(rs: RunStream) -> Optional[dict]:
    """The I/O-stall section of ``obs summary``: how much the step loop
    actually blocked on host checkpoint I/O, vs how much writing happened
    in the background. ``None`` when the run never checkpointed."""
    writes = [e for e in rs.events if e.get("type") == "checkpoint_write"]
    if not writes:
        return None
    stalls = [s for s in map(_event_stall_ms, writes) if s is not None]
    write_ms = [
        float(e["write_ms"]) if "write_ms" in e
        else float(e["seconds"]) * 1000.0
        for e in writes if "write_ms" in e or "seconds" in e
    ]
    queued = [float(e["queued_ms"]) for e in writes if "queued_ms" in e]
    gc_events = [e for e in rs.events if e.get("type") == "checkpoint_gc"]
    return {
        "checkpoint_writes": len(writes),
        "async_writes": sum(1 for e in writes if e.get("async")),
        "bytes_total": sum(int(e["bytes"]) for e in writes if "bytes" in e),
        "stall_ms": phase_stats(stalls),
        "write_ms": phase_stats(write_ms),
        "queued_ms": phase_stats(queued),
        "backpressure_waits": sum(
            1 for e in rs.events if e.get("type") == "ckpt_backpressure"
        ),
        "gc_runs": len(gc_events),
        "gc_deleted": sum(len(e.get("deleted", [])) for e in gc_events),
        "gc_bytes_freed": sum(
            int(e.get("bytes_freed", 0)) for e in gc_events
        ),
    }


def _serving_summary_records(reqs: List[dict], drops: int,
                             sheds: int = 0, failed: int = 0) -> dict:
    """The serving-summary body over an explicit record subset — shared
    by the whole-stream section and the per-version split. ``sheds``
    counts ``request_shed`` events (bounded-admission rejections) and
    ``failed`` counts ``request_failed`` events (frontend forwards that
    returned a client-visible 5xx after exhausting retries) — both
    whole-stream only; the per-version split passes 0 because a shed or
    failed forward happens before any version could have served it."""
    from pytorch_distributed_nn_tpu_torch.observability import tracing

    times = sorted(float(r["time"]) for r in reqs if "time" in r)
    wall = times[-1] - times[0] if len(times) > 1 else 0.0
    pad = [
        1.0 - float(r["batch"]) / float(r["bucket"])
        for r in reqs
        if r.get("bucket") and r.get("batch") is not None
    ]
    # span breakdown (schema v2, observability/tracing.py): per-span
    # percentiles + the slowest-requests attribution table. None on v1
    # streams (no record carries spans) — the absent-family contract.
    span_samples = tracing.span_totals(reqs)
    versions = sorted({
        str(r["version"]) for r in reqs if r.get("version") is not None
    })
    # generation block (serving/generate/, docs/observability.md): token
    # throughput, prefill (TTFT) vs decode (inter-token) percentiles and
    # mean decode-batch occupancy. None on non-generative streams — the
    # absent-family contract `obs compare` relies on to skip its
    # generative gate rows cleanly.
    gen = [r for r in reqs if r.get("new_tokens") is not None]
    generate = None
    if gen:
        gtimes = sorted(float(r["time"]) for r in gen if "time" in r)
        gwall = gtimes[-1] - gtimes[0] if len(gtimes) > 1 else 0.0
        tokens = sum(int(r["new_tokens"]) for r in gen)
        generate = {
            "requests": len(gen),
            "tokens": tokens,
            "prompt_tokens": sum(
                int(r.get("prompt_tokens") or 0) for r in gen
            ),
            "tokens_per_s": tokens / gwall if gwall > 0 else float("nan"),
            "ttft_ms": phase_stats([
                float(r["ttft_ms"]) for r in gen
                if r.get("ttft_ms") is not None
            ]),
            "inter_token_ms": phase_stats([
                float(r["itl_ms"]["mean"]) for r in gen
                if isinstance(r.get("itl_ms"), dict)
                and r["itl_ms"].get("mean") is not None
            ]),
            # distribution of per-request ITL p99s: the tail-of-tails
            # the generative compare gate judges
            "inter_token_p99_ms": phase_stats([
                float(r["itl_ms"]["p99"]) for r in gen
                if isinstance(r.get("itl_ms"), dict)
                and r["itl_ms"].get("p99") is not None
            ]),
            "decode_batch_mean": (
                sum(float(r["batch"]) for r in gen if r.get("batch"))
                / max(1, sum(1 for r in gen if r.get("batch")))
            ),
            "refences": sum(int(r.get("refences") or 0) for r in gen),
        }
    # per-hop latency attribution (docs/observability.md "Distributed
    # tracing"): frontend records carry a `hops` list — one entry per
    # forward attempt, the winner annotated with the replica-reported
    # upstream/queue/infer split — so frontend overhead (client latency
    # minus the winning hop's upstream time) is computable without ever
    # opening a replica stream. None on non-frontend streams — the
    # absent-family contract.
    hops = None
    hop_recs = [r for r in reqs if isinstance(r.get("hops"), list)]
    if hop_recs:
        overhead: List[float] = []
        upstream: List[float] = []
        h_queue: List[float] = []
        h_infer: List[float] = []
        by_tag: collections.Counter = collections.Counter()
        hedged = 0
        for r in hop_recs:
            rows = [h for h in r["hops"] if isinstance(h, dict)]
            for h in rows:
                by_tag[str(h.get("tag", "?"))] += 1
            if any(h.get("tag") == "hedge" for h in rows):
                hedged += 1
            win = next(
                (h for h in rows if h.get("outcome") == "won"), None
            )
            if win is None:
                continue
            up = win.get("upstream_ms")
            if up is not None:
                upstream.append(float(up))
                if r.get("latency_ms") is not None:
                    overhead.append(
                        max(0.0, float(r["latency_ms"]) - float(up))
                    )
            if win.get("queue_ms") is not None:
                h_queue.append(float(win["queue_ms"]))
            if win.get("infer_ms") is not None:
                h_infer.append(float(win["infer_ms"]))
        hops = {
            "requests": len(hop_recs),
            "attempts": sum(by_tag.values()),
            "hedged": hedged,
            "by_tag": dict(sorted(by_tag.items())),
            "frontend_overhead_ms": phase_stats(overhead),
            "upstream_ms": phase_stats(upstream),
            "queue_ms": phase_stats(h_queue),
            "infer_ms": phase_stats(h_infer),
        }
    offered = len(reqs) + drops + sheds + failed
    return {
        "requests": len(reqs),
        "dropped": drops,
        # overload accounting (docs/serving.md "Availability &
        # overload"): shed = bounded-admission rejections (429s),
        # failed = client-visible frontend failures (5xx after retries);
        # availability = the fraction of offered requests actually
        # served. Streams predating admission control have shed and
        # failed 0 and availability degrades to served/(served+dropped).
        "shed": sheds,
        "failed": failed,
        "shed_fraction": (sheds / offered) if offered else 0.0,
        "availability": (len(reqs) / offered) if offered else None,
        "req_rate": (len(reqs) - 1) / wall if wall > 0 else float("nan"),
        "latency_ms": phase_stats([float(r["latency_ms"]) for r in reqs]),
        "queue_ms": phase_stats([
            float(r["queue_ms"]) for r in reqs if "queue_ms" in r
        ]),
        "infer_ms": phase_stats([
            float(r["infer_ms"]) for r in reqs if "infer_ms" in r
        ]),
        "batch_mean": (
            sum(float(r["batch"]) for r in reqs if "batch" in r)
            / max(1, sum(1 for r in reqs if "batch" in r))
        ),
        "pad_fraction": sum(pad) / len(pad) if pad else None,
        "hops": hops,
        "generate": generate,
        "spans": {
            name: phase_stats(span_samples[name])
            for name in (*tracing.SPAN_ORDER,
                         *sorted(set(span_samples)
                                 - set(tracing.SPAN_ORDER)))
            if name in span_samples
        } or None,
        "slowest": tracing.slowest_requests(reqs, 5) or None,
        "versions": versions or None,
        # per-request FLOPs shares (serving/batcher.py) sum to achieved
        # device FLOP/s over the stream's wall window; None on streams
        # predating the engine's bucket-flops estimates
        "achieved_flops_per_s": (
            sum(float(r["flops"]) for r in reqs if r.get("flops")) / wall
            if wall > 0 and any(r.get("flops") for r in reqs) else None
        ),
    }


def serving_summary(rs: RunStream) -> Optional[dict]:
    """The serving section of ``obs summary``: per-request latency
    percentiles, queue/infer split, coalescing stats, sustained request
    rate, and — on span-carrying (schema v2) streams — the per-span
    breakdown, slowest-requests attribution and artifact versions.
    ``None`` for a run with no request records — training streams keep
    their summaries (and ``obs compare`` rows) unchanged."""
    reqs = [r for r in rs.steps if r.get("latency_ms") is not None]
    drops = sum(1 for e in rs.events if e.get("type") == "request_dropped")
    # request_shed events are rate-limited under overload: each carries
    # the `count` of sheds it covers (default 1), so summing counts —
    # not events — recovers the exact shed total
    sheds = sum(
        int(e.get("count", 1)) for e in rs.events
        if e.get("type") == "request_shed"
    )
    # failed frontend forwards (5xx returned to the client after the
    # retry budget) are offered-but-not-served: without them a frontend
    # stream under an outage would still report availability 1.0
    failed = sum(
        int(e.get("count", 1)) for e in rs.events
        if e.get("type") == "request_failed"
    )
    if not reqs and not drops and not sheds and not failed:
        return None
    return _serving_summary_records(reqs, drops, sheds, failed)


#: bucket label for request records without a version stamp in a stream
#: that carries versions elsewhere (mixed mid-swap streams)
UNVERSIONED = "(unversioned)"


def summarize_by_version(rs: RunStream) -> Dict[str, dict]:
    """Per-artifact-version serving summaries of one stream.

    Returns ``{}`` for streams with no version stamps at all (v1 /
    training streams) — the caller skips the split, never fails on it.
    A mixed stream's unstamped records land under ``(unversioned)``.
    """
    reqs = [r for r in rs.steps if r.get("latency_ms") is not None]
    if not any(r.get("version") is not None for r in reqs):
        return {}
    by_version: Dict[str, List[dict]] = collections.defaultdict(list)
    for r in reqs:
        v = r.get("version")
        by_version[str(v) if v is not None else UNVERSIONED].append(r)
    drops_by_version: Dict[str, int] = collections.Counter()
    for e in rs.events:
        if e.get("type") != "request_dropped":
            continue
        v = e.get("version")
        drops_by_version[str(v) if v is not None else UNVERSIONED] += 1
    out = {}
    for version in sorted(by_version):
        out[version] = _serving_summary_records(
            by_version[version], drops_by_version.get(version, 0)
        )
    for version, drops in drops_by_version.items():
        if version not in out:
            out[version] = _serving_summary_records([], drops)
    return out


def efficiency_summary(rs: RunStream, skip: int = 1) -> Optional[dict]:
    """The efficiency section of ``obs summary``: MFU trend, bandwidth
    shares and the cost-model-vs-measured gap, derived host-side from the
    manifest's ``step_cost`` record + per-step wall times. ``None`` for
    streams without a step cost (pre-efficiency runs, serving streams) —
    the absent-family contract: old streams summarize and compare exactly
    as before.
    """
    sc = (rs.manifest or {}).get("step_cost") or {}
    flops = sc.get("flops")
    if not flops:
        return None
    timed = rs.steps[skip:] if len(rs.steps) > skip else rs.steps
    # either trainer's step time: the JAX step_time, the port's step_ms
    times = [t for t in map(step_seconds, timed) if t and t > 0]
    if not times:
        return None
    flops = float(flops)
    peak = float(sc.get("peak_flops_per_s") or 0.0)
    achieved = [flops / t for t in times]
    out = {
        "flops_per_step": flops,
        "peak_flops_per_s": peak or None,
        "devices": sc.get("devices"),
        "cost_source": sc.get("source"),
        "achieved_flops_per_s": phase_stats(achieved),
    }
    if peak:
        mfu = [a / peak for a in achieved]
        half = len(mfu) // 2
        rec = {
            "overall": sum(mfu) / len(mfu),
            "p50": percentile(mfu, 50),
            "first_half": (
                sum(mfu[:half]) / half if half else float("nan")
            ),
            "second_half": (
                sum(mfu[half:]) / (len(mfu) - half) if half
                else float("nan")
            ),
        }
        if half and rec["first_half"] > 0:
            rec["trend_pct"] = 100.0 * (
                rec["second_half"] / rec["first_half"] - 1.0
            )
        out["mfu"] = rec
    hbm = float(sc.get("hbm_bytes") or 0.0)
    hbm_peak = float(sc.get("peak_hbm_bytes_per_s") or 0.0)
    if hbm and hbm_peak:
        out["hbm_util"] = sum(hbm / t / hbm_peak for t in times) / len(times)
    ici = sc.get("ici_bytes")
    if ici is not None:
        out["ici_bytes_per_s"] = (
            sum(float(ici) / t for t in times) / len(times)
        )
    predicted = sc.get("predicted_ms")
    if predicted:
        measured = percentile(times, 50) * 1000.0
        out["predicted_ms"] = float(predicted)
        out["measured_p50_ms"] = measured
        out["cost_gap_pct"] = 100.0 * (
            measured / float(predicted) - 1.0
        )
    return out


def _fleet_summary(rs: RunStream) -> Optional[dict]:
    """Fold host_join/host_dead/trial_migrate (+ per-host trial_start
    attribution) into the `obs summary` fleet section."""
    hosts: Dict[str, dict] = {}
    migrations = []
    by_host: Dict[str, int] = {}
    for e in rs.events:
        etype = e.get("type")
        if etype == "host_join" and e.get("host") is not None:
            h = hosts.setdefault(str(e["host"]), {})
            h.update(state="alive", devices=e.get("devices"),
                     capacity=e.get("capacity"), addr=e.get("addr"))
        elif etype == "host_dead" and e.get("host") is not None:
            h = hosts.setdefault(str(e["host"]), {})
            h["state"] = "dead"
            h["reason"] = e.get("reason")
        elif etype == "trial_migrate":
            migrations.append({
                "trial": e.get("trial"), "rung": e.get("rung"),
                "from": e.get("from_host"), "reason": e.get("reason"),
            })
        elif etype == "trial_start" and e.get("host") is not None:
            by_host[str(e["host"])] = by_host.get(str(e["host"]), 0) + 1
    if not hosts and not migrations:
        return None
    for hid, n in by_host.items():
        hosts.setdefault(hid, {})["trials"] = n
    return {"hosts": hosts, "migrations": migrations,
            "dead": sum(1 for h in hosts.values()
                        if h.get("state") == "dead")}


def summarize_run(rs: RunStream, skip: int = 1) -> dict:
    """Everything `obs summary` prints, as one JSON-able dict.

    ``skip`` drops the first N step records from the *timing* stats (the
    compile step would dominate p99 on short runs); counts and loss cover
    every record.
    """
    timed = rs.steps[skip:] if len(rs.steps) > skip else rs.steps
    events_by_type = collections.Counter(
        e.get("type", "?") for e in rs.events
    )
    ckpt_secs = [
        float(e["seconds"])
        for e in rs.events
        if e.get("type") == "checkpoint_write" and "seconds" in e
    ]
    phases = {
        "data": phase_stats([
            r["data_time"] for r in timed if "data_time" in r
        ]),
        # input_wait: how long the loop actually BLOCKED on the loader
        # (seconds, from the per-step input_wait_ms field) — distinct
        # from "data", which also counts host work the loader did while
        # a prefetched batch was already ready
        "input_wait": phase_stats([
            float(r["input_wait_ms"]) / 1000.0
            for r in timed if "input_wait_ms" in r
        ]),
        "step": phase_stats([
            step_seconds(r) for r in timed if step_seconds(r) is not None
        ]),
        "checkpoint": phase_stats(ckpt_secs),
    }
    half = len(timed) // 2
    step_rate = {
        "overall": _rate(timed),
        "first_half": _rate(timed[:half]) if half else float("nan"),
        "second_half": _rate(timed[half:]) if half else float("nan"),
    }
    if half and step_rate["first_half"] > 0:
        step_rate["trend_pct"] = 100.0 * (
            step_rate["second_half"] / step_rate["first_half"] - 1.0
        )
    evals = [
        {
            "step": e.get("step"),
            "loss": e.get("loss"),
            "acc1": e.get("acc1"),
            "acc5": e.get("acc5"),
        }
        for e in rs.events
        if e.get("type") == "eval_result"
    ]
    summary = {
        "path": rs.path,
        "run_id": (rs.manifest or {}).get("run_id"),
        "schema": (rs.manifest or {}).get("schema"),
        "steps": len(rs.steps),
        "step_range": [rs.steps[0]["step"], rs.steps[-1]["step"]]
        if rs.steps else None,
        "restarts": max(len(rs.manifests) - 1, 0),
        "truncated": rs.truncated,
        "bad_lines": rs.bad_lines,
        "phases": phases,
        "step_rate": step_rate,
        "io_stall": io_stall_summary(rs),
        "serving": serving_summary(rs),
        "efficiency": efficiency_summary(rs, skip=skip),
        "events": dict(sorted(events_by_type.items())),
        # deployment transitions (serving/router.py, docs/serving.md
        # "Deployment lifecycle"): every swap/canary/promote/rollback of
        # a live-reload serving run, in stream order — a ramp and its
        # outcome are readable straight off `obs summary`
        "deployment": [
            {
                "type": e["type"],
                "version": e.get("version"),
                "from": e.get("from_version") or e.get("stable"),
                "phase": e.get("phase"),
                "fraction": e.get("fraction"),
                "reasons": e.get("reasons"),
                "source": e.get("source"),
            }
            for e in rs.events
            if e.get("type") in ("swap", "canary", "promote", "rollback")
        ],
        # geometry transitions (elastic resume): one entry per lifetime
        # that came back on a different fleet, so a run's mesh history is
        # readable straight off `obs summary`
        "elastic": [
            {
                "step": e.get("step"),
                "old": e.get("old"),
                "new": e.get("new"),
                "batch_size": e.get("batch_size"),
            }
            for e in rs.events if e.get("type") == "elastic_resume"
        ],
        # fleet section (experiments/fleet/, read off a sweep.jsonl
        # journal): host roster with per-host trial attribution and every
        # migration of an in-flight trial off a dead host — None for
        # streams with no fleet events
        "fleet": _fleet_summary(rs),
        "evals": evals,
        "nonfinite_skips": sum(
            int(r.get("skipped_nonfinite", 0)) for r in rs.steps
        ),
        "straggler_dropped": sum(
            int(r.get("straggler_dropped", 0)) for r in rs.steps
        ),
    }
    if rs.steps:
        last = rs.steps[-1]
        summary["loss_first"] = rs.steps[0].get("loss")
        summary["loss_last"] = last.get("loss")
    return summary


def _fmt_s(v: Optional[float]) -> str:
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return "      -"
    return f"{v:7.4f}"


def render_summary(summary: dict, manifest: Optional[dict] = None) -> str:
    """Human-readable `obs summary` text."""
    lines = []
    mf = manifest or {}
    cfg = mf.get("config") or {}
    head = f"run {summary.get('run_id') or '<no manifest>'}"
    if summary.get("schema") is not None:
        head += f" (schema {summary['schema']})"
    model = cfg.get("network")
    if model:
        head += f" — {model}/{cfg.get('dataset')}"
    mesh = mf.get("mesh_shape")
    if mesh:
        head += " · mesh " + " ".join(f"{k}={v}" for k, v in mesh.items())
    lines.append(head)
    vers = mf.get("versions") or {}
    if vers:
        lines.append(
            "  " + " · ".join(
                f"{k} {v}" for k, v in sorted(vers.items()) if k != "schema"
            )
        )
    geo = mf.get("geometry")
    if geo:
        lines.append(
            f"  geometry: {geo.get('devices')} device(s) / "
            f"{geo.get('processes')} process(es)"
            + (" · " + " ".join(f"{k}={v}"
                                for k, v in (geo.get("mesh") or {}).items())
               if geo.get("mesh") else "")
        )
    rng = summary.get("step_range")
    steps_line = f"steps: {summary['steps']}"
    if rng:
        steps_line += f" ({rng[0]}..{rng[1]})"
    if summary.get("restarts"):
        steps_line += f", {summary['restarts']} restart(s)"
    if summary.get("truncated"):
        steps_line += ", torn tail line (crash?)"
    if summary.get("bad_lines"):
        steps_line += f", {summary['bad_lines']} corrupt line(s)"
    lines.append(steps_line)

    def _geo(g):
        g = g or {}
        mesh = g.get("mesh") or {}
        s = f"{g.get('devices')}d"
        if mesh:
            s += "(" + " ".join(f"{k}={v}" for k, v in mesh.items()) + ")"
        return s

    for ev in summary.get("elastic") or []:
        lines.append(
            f"elastic resume @ step {ev.get('step')}: "
            f"{_geo(ev.get('old'))} -> {_geo(ev.get('new'))}"
            + (f", global batch {ev['batch_size']} preserved"
               if ev.get("batch_size") else "")
        )
    fleet = summary.get("fleet")
    if fleet:
        hosts = fleet.get("hosts") or {}
        lines.append(
            f"fleet: {len(hosts)} host(s), {fleet.get('dead', 0)} dead, "
            f"{len(fleet.get('migrations') or [])} migration(s)"
        )
        if hosts:
            lines.append(
                f"  {'host':<12} {'state':<6} {'devices':>7} "
                f"{'capacity':>8} {'trials':>6}"
            )
            for hid in sorted(hosts):
                h = hosts[hid]
                lines.append(
                    f"  {hid:<12} {h.get('state', '?'):<6} "
                    f"{h.get('devices') if h.get('devices') is not None else '-':>7} "
                    f"{h.get('capacity') if h.get('capacity') is not None else '-':>8} "
                    f"{h.get('trials', 0):>6}"
                )
        for m in fleet.get("migrations") or []:
            lines.append(
                f"  migrate trial {m.get('trial')} off "
                f"{m.get('from')} (rung {m.get('rung')}, "
                f"{m.get('reason') or 'host_dead'})"
            )
    if summary.get("loss_last") is not None:
        lines.append(
            f"loss: {summary.get('loss_first'):.4f} -> "
            f"{summary['loss_last']:.4f}"
        )
    if any(summary["phases"].get(n)
           for n in ("data", "input_wait", "step", "checkpoint")):
        lines.append("phases (seconds):")
        lines.append("  phase         p50     p95     p99    mean      n")
        for name in ("data", "input_wait", "step", "checkpoint"):
            st = summary["phases"].get(name)
            if not st:
                continue
            lines.append(
                f"  {name:<10} {_fmt_s(st['p50'])} {_fmt_s(st['p95'])} "
                f"{_fmt_s(st['p99'])} {_fmt_s(st['mean'])} {st['count']:6d}"
            )
    io = summary.get("io_stall")
    if io:
        lines.append(
            f"checkpoint I/O: {io['checkpoint_writes']} write(s)"
            + (f" ({io['async_writes']} async)" if io["async_writes"]
               else " (sync)")
            + (f", {io['bytes_total'] / 1e6:.1f} MB"
               if io.get("bytes_total") else "")
        )
        st = io.get("stall_ms")
        if st:
            lines.append(
                f"  loop stall (ms)   p50 {st['p50']:8.1f}  "
                f"p99 {st['p99']:8.1f}  total {st['total']:8.1f}"
            )
        wr = io.get("write_ms")
        if wr:
            lines.append(
                f"  write (ms)        p50 {wr['p50']:8.1f}  "
                f"p99 {wr['p99']:8.1f}  total {wr['total']:8.1f}"
            )
        if io.get("backpressure_waits"):
            lines.append(
                f"  backpressure: {io['backpressure_waits']} save(s) "
                "waited for the in-flight write"
            )
        if io.get("gc_runs"):
            lines.append(
                f"  retention GC: {io['gc_deleted']} checkpoint(s) "
                f"deleted, {io['gc_bytes_freed'] / 1e6:.1f} MB freed"
            )
    sv = summary.get("serving")
    if sv:
        rate = sv.get("req_rate")
        lines.append(
            f"serving: {sv['requests']} request(s), {sv['dropped']} "
            "deadline-dropped"
            + (f", {rate:.0f} req/s sustained"
               if rate is not None and rate == rate else "")
            + (f", mean batch {sv['batch_mean']:.1f}"
               if sv.get("batch_mean") else "")
            + (f", pad {sv['pad_fraction'] * 100:.0f}%"
               if sv.get("pad_fraction") is not None else "")
            + (f", {sv['achieved_flops_per_s'] / 1e9:.2f} GFLOP/s"
               if sv.get("achieved_flops_per_s") else "")
        )
        if sv.get("shed") or sv.get("failed") or (
                summary.get("events") or {}).get(
                "breaker_open") or (summary.get("events") or {}).get(
                "hedge"):
            # overload & availability (docs/serving.md "Availability &
            # overload"): admission sheds, the availability fraction and
            # the frontend's breaker/hedge activity in one line
            ev = summary.get("events") or {}
            avail = sv.get("availability")
            lines.append(
                f"  overload: {sv.get('shed', 0)} shed "
                f"({sv.get('shed_fraction', 0.0) * 100:.1f}% of offered)"
                + (f", {sv['failed']} failed forward(s)"
                   if sv.get("failed") else "")
                + (f", availability {avail * 100:.2f}%"
                   if avail is not None else "")
                + (f", {ev['breaker_open']} breaker open(s)"
                   if ev.get("breaker_open") else "")
                + (f", {ev['hedge']} hedge(s)"
                   if ev.get("hedge") else "")
            )
        if sv.get("versions"):
            lines.append(
                "  artifact version(s): " + ", ".join(sv["versions"])
            )
        for name, label in (("latency_ms", "latency (ms)"),
                            ("queue_ms", "queue   (ms)"),
                            ("infer_ms", "infer   (ms)")):
            st = sv.get(name)
            if st:
                lines.append(
                    f"  {label}   p50 {st['p50']:8.2f}  "
                    f"p95 {st['p95']:8.2f}  p99 {st['p99']:8.2f}"
                )
        hp = sv.get("hops")
        if hp:
            # per-hop attribution (docs/observability.md "Distributed
            # tracing"): where a forwarded request's wall time went —
            # frontend overhead (routing + network + retries) vs the
            # winning replica's queue vs infer
            tags = ", ".join(
                f"{n} {tag}" for tag, n in (hp.get("by_tag") or {}).items()
            )
            lines.append(
                f"  per-hop attribution: {hp['requests']} traced "
                f"forward(s), {hp['attempts']} attempt(s)"
                + (f" ({tags})" if tags else "")
                + (f", {hp['hedged']} hedged" if hp.get("hedged") else "")
            )
            for name, label in (
                ("frontend_overhead_ms", "frontend overhead"),
                ("queue_ms", "replica queue   "),
                ("infer_ms", "replica infer   "),
            ):
                st = hp.get(name)
                if st:
                    lines.append(
                        f"    {label} (ms)  p50 {st['p50']:8.2f}  "
                        f"p95 {st['p95']:8.2f}  p99 {st['p99']:8.2f}"
                    )
        gen = sv.get("generate")
        if gen:
            tps = gen.get("tokens_per_s")
            lines.append(
                f"  generation: {gen['tokens']} token(s) over "
                f"{gen['requests']} request(s)"
                + (f", {tps:.1f} tokens/s sustained"
                   if tps is not None and tps == tps else "")
                + (f", mean decode batch {gen['decode_batch_mean']:.1f}"
                   if gen.get("decode_batch_mean") else "")
                + (f", {gen['refences']} swap re-prefill(s)"
                   if gen.get("refences") else "")
            )
            for name, label in (
                ("ttft_ms", "prefill TTFT (ms)"),
                ("inter_token_ms", "inter-token (ms)"),
                ("inter_token_p99_ms", "ITL tail p99 (ms)"),
            ):
                st = gen.get(name)
                if st:
                    lines.append(
                        f"    {label:<18} p50 {st['p50']:8.2f}  "
                        f"p95 {st['p95']:8.2f}  p99 {st['p99']:8.2f}"
                    )
        spans = sv.get("spans")
        if spans:
            lines.append("  spans (ms):")
            for name, st in spans.items():
                lines.append(
                    f"    {name:<11} p50 {st['p50']:8.3f}  "
                    f"p95 {st['p95']:8.3f}  p99 {st['p99']:8.3f}"
                )
        dep = summary.get("deployment")
        if dep:
            lines.append("  deployment transitions:")
            for ev in dep:
                t = ev["type"]
                if t == "swap":
                    lines.append(
                        f"    swap     {ev.get('from')} -> "
                        f"{ev.get('version')}"
                        + (f" ({ev['source']})" if ev.get("source")
                           else "")
                    )
                elif t == "canary":
                    frac = ev.get("fraction")
                    lines.append(
                        f"    canary   {ev.get('version')} "
                        f"{ev.get('phase')}"
                        + (f" @ {frac * 100:.0f}%"
                           if frac is not None else "")
                    )
                elif t == "promote":
                    lines.append(
                        f"    promote  {ev.get('from')} -> "
                        f"{ev.get('version')}"
                    )
                else:
                    lines.append(
                        f"    ROLLBACK {ev.get('version')} -> "
                        f"{ev.get('from')}"
                        + (f" ({'; '.join(ev['reasons'])})"
                           if ev.get("reasons") else "")
                    )
        slowest = sv.get("slowest")
        if slowest:
            lines.append(
                "  slowest requests (obs trace <request_id> for the "
                "waterfall):"
            )
            lines.append(
                f"    {'request_id':<18} {'latency':>9}  "
                f"{'dominant span':<22} version"
            )
            for row in slowest:
                dom = row.get("dominant") or "-"
                dom_ms = row.get("dominant_ms")
                dom_s = (
                    f"{dom} ({dom_ms:.2f} ms)" if dom_ms is not None
                    else dom
                )
                lines.append(
                    f"    {str(row['request_id']):<18} "
                    f"{row['latency_ms']:7.2f}ms  {dom_s:<22} "
                    f"{row.get('version') or '-'}"
                )
    eff = summary.get("efficiency")
    if eff:
        mfu = eff.get("mfu") or {}
        line = "efficiency:"
        if mfu:
            line += f" MFU {mfu['overall'] * 100:.1f}%"
            if "trend_pct" in mfu:
                line += f" (trend {mfu['trend_pct']:+.1f}%)"
        ach = eff.get("achieved_flops_per_s") or {}
        if ach:
            line += f" · {ach['p50'] / 1e9:.2f} GFLOP/s achieved"
            if eff.get("peak_flops_per_s"):
                line += f" of {eff['peak_flops_per_s'] / 1e9:.1f} peak"
        lines.append(line)
        shares = []
        if eff.get("hbm_util") is not None:
            shares.append(f"HBM util {eff['hbm_util'] * 100:.1f}%")
        if eff.get("ici_bytes_per_s") is not None:
            shares.append(
                f"ICI {eff['ici_bytes_per_s'] / 1e6:.2f} MB/s/device"
            )
        if eff.get("cost_gap_pct") is not None:
            shares.append(
                f"cost-model gap {eff['cost_gap_pct']:+.1f}% "
                f"(predicted {eff['predicted_ms']:.1f} ms vs measured "
                f"{eff['measured_p50_ms']:.1f} ms p50)"
            )
        if shares:
            lines.append("  " + " · ".join(shares))
    sr = summary["step_rate"]
    if not math.isnan(sr.get("overall", float("nan"))):  # serving runs
        rate_line = f"step rate: {sr['overall']:.2f} steps/s"
        if not math.isnan(sr.get("first_half", float("nan"))):
            rate_line += (
                f" · first half {sr['first_half']:.2f}"
                f" · second half {sr['second_half']:.2f}"
            )
            if "trend_pct" in sr:
                rate_line += f" ({sr['trend_pct']:+.1f}%)"
        lines.append(rate_line)
    if summary["events"]:
        lines.append("events:")
        for etype, n in summary["events"].items():
            lines.append(f"  {etype:<18} {n}")
    counters = []
    if summary.get("nonfinite_skips"):
        counters.append(f"nonfinite skips {summary['nonfinite_skips']}")
    if summary.get("straggler_dropped"):
        counters.append(
            f"straggler contributions dropped "
            f"{summary['straggler_dropped']}"
        )
    if counters:
        lines.append("resilience: " + ", ".join(counters))
    if summary["evals"]:
        lines.append("eval accuracy (step: loss / acc1 / acc5):")
        for e in summary["evals"]:
            lines.append(
                f"  {e['step'] if e['step'] is not None else '-':>6}: "
                f"{e['loss']:.4f} / {e['acc1']:.4f} / {e['acc5']:.4f}"
            )
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Cross-rank merge (multi-host runs: one stream per process)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MergedRun:
    """N per-process streams merged on (step, rank), clocks aligned."""

    streams: List[RunStream]
    ranks: List[int]  # rank of each stream, reference (lowest) first
    steps: List[dict]  # stamped with rank/host/time_aligned, (step, rank) order
    events: List[dict]  # stamped with rank/host/time_aligned, time order
    clock_offsets: Dict[int, float]  # seconds ADDED to a rank's clock


def _stream_rank(rs: RunStream, fallback: int) -> int:
    try:
        return int((rs.manifest or {}).get("rank"))
    except (TypeError, ValueError):
        return fallback


def _clock_domain(rs: RunStream) -> str:
    """'mono' when every step record carries a monotonic stamp (immune to
    NTP wall-clock jumps mid-run), else 'time' (pre-merge streams)."""
    if rs.steps and all("mono" in r for r in rs.steps):
        return "mono"
    return "time"


def merge_streams(runs: List[RunStream], align: bool = True) -> MergedRun:
    """Merge per-process streams on (step, rank), aligning clocks.

    Hosts in a pod do not share a clock: wall clocks skew (NTP, VM
    migration) and monotonic clocks have arbitrary per-boot epochs. But
    under synchronous SPMD every rank finishes step N at the same real
    moment — the gradient collective IS a barrier — so the per-step
    timestamp difference between two streams is a direct measurement of
    their clock offset. The median over all common steps (robust to log
    flushes landing late on a busy host) is subtracted, putting every
    record on the reference (lowest-rank) stream's timeline; records
    gain ``time_aligned`` in the reference's wall domain. Each stream's
    offset is estimated on its monotonic clock when the stream carries
    one (so an NTP step mid-run cannot corrupt the alignment) and falls
    back to wall time for pre-``mono`` streams.
    """
    if not runs:
        raise ValueError("merge_streams needs at least one stream")
    ranked = []
    seen = set()
    for i, rs in enumerate(runs):
        rank = _stream_rank(rs, i)
        while rank in seen:  # collision (missing manifests): keep stable
            rank += 1
        seen.add(rank)
        ranked.append((rank, rs))
    ranked.sort(key=lambda t: t[0])
    ref_rank, ref = ranked[0]

    def clocks(rs):
        dom = _clock_domain(rs)
        return {
            int(r["step"]): float(r[dom])
            for r in rs.steps
            if "step" in r and dom in r
        }

    ref_clocks = clocks(ref)
    # reference domain -> wall mapping (identity when the domain IS wall)
    ref_manifest_clock = (ref.manifest or {}).get("clock") or {}
    if _clock_domain(ref) == "mono" and "mono" in ref_manifest_clock:
        to_wall = (
            float(ref_manifest_clock["wall"])
            - float(ref_manifest_clock["mono"])
        )
    else:
        to_wall = 0.0

    offsets: Dict[int, float] = {}
    steps: List[dict] = []
    events: List[dict] = []
    for rank, rs in ranked:
        dom = _clock_domain(rs)
        if rank == ref_rank or not align:
            off = 0.0
        else:
            mine = clocks(rs)
            deltas = sorted(
                ref_clocks[s] - mine[s] for s in ref_clocks.keys() & mine
            )
            off = deltas[len(deltas) // 2] if deltas else 0.0
        offsets[rank] = off
        host = (rs.manifest or {}).get("host")
        for rec in rs.steps:
            out = dict(rec)
            out["rank"] = rank
            if host is not None:
                out.setdefault("host", host)
            if dom in rec:
                out["time_aligned"] = float(rec[dom]) + off + to_wall
            steps.append(out)
        for rec in rs.events:
            out = dict(rec)
            out["rank"] = rank
            if host is not None:
                out.setdefault("host", host)
            clock = rec.get(dom, rec.get("time"))
            if clock is not None:
                out["time_aligned"] = float(clock) + off + to_wall
            events.append(out)
    steps.sort(key=lambda r: (r.get("step", -1), r["rank"]))
    events.sort(key=lambda r: (r.get("time_aligned", 0.0),
                               r.get("step", -1), r["rank"]))
    return MergedRun(
        streams=[rs for _, rs in ranked],
        ranks=[r for r, _ in ranked],
        steps=steps,
        events=events,
        clock_offsets=offsets,
    )


def _decode_rank_mask(mask_value: float) -> List[int]:
    """``straggler_dropped_mask`` bitmask -> rank list (a torch-free twin of
    resilience.stragglers.dropped_ranks; obs must not import torch)."""
    bits, out, r = int(round(float(mask_value))), [], 0
    while bits:
        if bits & 1:
            out.append(r)
        bits >>= 1
        r += 1
    return out


def summarize_by_rank(merged: MergedRun, skip: int = 1) -> dict:
    """The ``obs summary --by-rank`` payload: per-rank phase percentiles,
    clock offsets, cross-rank step-completion skew, and the straggler
    attribution table the reference faked with grep over rank logs.

    Two rank notions compose here: *process* ranks (one row per merged
    stream — phase timing lives there) and *data-parallel* ranks (the
    straggler simulator's attribution fields, identical in every stream —
    which replica was slowest / dropped, per step)."""
    by_rank: Dict[int, List[dict]] = collections.defaultdict(list)
    for rec in merged.steps:
        by_rank[rec["rank"]].append(rec)
    ranks = {}
    for rank in merged.ranks:
        recs = by_rank.get(rank, [])
        timed = recs[skip:] if len(recs) > skip else recs
        host = None
        for rs in merged.streams:
            if _stream_rank(rs, -1) == rank and rs.manifest:
                host = rs.manifest.get("host")
        ranks[rank] = {
            "host": host or (recs[0].get("host") if recs else None),
            "steps": len(recs),
            "phases": {
                "data": phase_stats([
                    r["data_time"] for r in timed if "data_time" in r
                ]),
                "step": phase_stats([
                    step_seconds(r) for r in timed
                    if step_seconds(r) is not None
                ]),
            },
            "step_rate": _rate(timed),
        }
    # cross-rank completion skew: spread of aligned per-step times
    by_step: Dict[int, List[float]] = collections.defaultdict(list)
    for rec in merged.steps:
        if "time_aligned" in rec and "step" in rec:
            by_step[rec["step"]].append(rec["time_aligned"])
    spreads = [
        max(ts) - min(ts) for ts in by_step.values() if len(ts) > 1
    ]
    # straggler attribution (data-parallel ranks): identical on every
    # stream, so read it from the reference stream's records only
    ref_steps = by_rank.get(merged.ranks[0], [])
    dropped: collections.Counter = collections.Counter()
    slowest: collections.Counter = collections.Counter()
    attributed = 0
    for rec in ref_steps:
        if rec.get("straggler_dropped"):
            if "straggler_dropped_mask" in rec:
                for r in _decode_rank_mask(rec["straggler_dropped_mask"]):
                    dropped[r] += 1
            else:
                dropped[-1] += int(rec["straggler_dropped"])  # unattributed
        if "straggler_slowest_rank" in rec:
            slowest[int(rec["straggler_slowest_rank"])] += 1
            attributed += 1
    for ev in (e for e in merged.events
               if e.get("type") == "straggler_drop"
               and e.get("rank") == merged.ranks[0]):
        # pre-attribution streams: events carry the rank list
        if not dropped and ev.get("ranks"):
            for r in ev["ranks"]:
                dropped[r] += 1
    return {
        "ranks": ranks,
        "clock_offsets_s": {
            r: round(v, 6) for r, v in merged.clock_offsets.items()
        },
        "skew": phase_stats(spreads),
        "straggler": {
            "dropped_by_rank": dict(sorted(dropped.items())),
            "slowest_by_rank": dict(sorted(slowest.items())),
            "steps_attributed": attributed,
        },
    }


def render_by_rank(summary: dict) -> str:
    """Human-readable ``obs summary --by-rank`` text."""
    lines = ["per-rank phases (seconds):"]
    lines.append(
        "  rank  host             steps  data p50  step p50  step p99"
        "    rate"
    )
    for rank, st in sorted(summary["ranks"].items()):
        data = st["phases"].get("data") or {}
        step = st["phases"].get("step") or {}
        host = str(st.get("host") or "-")[:15]
        lines.append(
            f"  {rank:>4}  {host:<15} {st['steps']:>6} "
            f"{_fmt_s(data.get('p50'))}  {_fmt_s(step.get('p50'))}  "
            f"{_fmt_s(step.get('p99'))} "
            f"{st['step_rate']:>7.2f}"
        )
    offs = summary.get("clock_offsets_s") or {}
    if len(offs) > 1:
        lines.append(
            "clock offsets vs reference rank (s): "
            + ", ".join(f"rank {r}: {v:+.3f}"
                        for r, v in sorted(offs.items()) if v)
        )
    skew = summary.get("skew")
    if skew:
        lines.append(
            f"cross-rank step-completion skew: p50 {skew['p50'] * 1e3:.1f} ms"
            f" · p95 {skew['p95'] * 1e3:.1f} ms"
            f" · max {max(skew['p99'], skew['p95']) * 1e3:.1f} ms"
            f" (over {skew['count']} steps)"
        )
    st = summary.get("straggler") or {}
    dropped = st.get("dropped_by_rank") or {}
    slowest = st.get("slowest_by_rank") or {}
    if dropped or slowest:
        lines.append("straggler attribution (data-parallel ranks):")
        lines.append("  rank   dropped   slowest-at-step")
        for rank in sorted(set(dropped) | set(slowest)):
            name = "(unattributed)" if rank == -1 else f"{rank:>4}"
            total = st.get("steps_attributed") or 0
            slow = slowest.get(rank, 0)
            slow_s = f"{slow}/{total}" if total else "-"
            lines.append(
                f"  {name:>4}  {dropped.get(rank, 0):>8}   {slow_s:>12}"
            )
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Compare (the CI surface)
# ---------------------------------------------------------------------------

#: (summary key path, human label, "higher_is" direction[, jitter floor]).
#: The optional 4th element is an ABSOLUTE floor in the metric's own unit:
#: a candidate only regresses when it is worse by more than the fractional
#: threshold AND by more than the floor — the same jitter-floor discipline
#: observability/detect.py applies (`min_ms`), because a millisecond-scale
#: p99 moves several ms run-to-run from OS scheduling alone and a purely
#: fractional gate would flap on it.
_COMPARE_METRICS = (
    (("phases", "step", "p50"), "step p50 (s)", "lower"),
    (("phases", "step", "p95"), "step p95 (s)", "lower"),
    (("phases", "data", "p50"), "data p50 (s)", "lower"),
    # input-pipeline stall gate (docs/data.md): a loader that stops
    # keeping up shows here even when raw step time is unchanged. Absent
    # on pre-input_wait streams (_dig skips the row) — backward
    # compatible like the ckpt stall gate below. The 5 ms absolute floor
    # (detect.py min_ms discipline) keeps twin runs whose waits are pure
    # queue-pop noise (tens of µs) from false-failing on the fraction.
    (("phases", "input_wait", "p95"), "input wait p95 (s)", "lower",
     0.005),
    (("step_rate", "overall"), "step rate (steps/s)", "higher"),
    # checkpoint loop-stall regression gate: old streams (pre-async) fall
    # back to the full write time via _event_stall_ms; streams with no
    # checkpoint_write events at all have io_stall None and _dig skips
    # the row — obs compare stays backward-compatible either way
    (("io_stall", "stall_ms", "p99"), "ckpt stall p99 (ms)", "lower"),
    # serving gates (docs/serving.md): request-latency percentiles and
    # sustained request rate. Absent from every training stream (the
    # serving section is None -> _dig skips the rows), so comparing two
    # training runs — or an old stream against a new one — can never
    # false-fail on a metric family it does not carry, the same contract
    # as the input-wait and ckpt-stall gates above.
    (("serving", "latency_ms", "p50"), "serve lat p50 (ms)", "lower", 1.0),
    (("serving", "latency_ms", "p99"), "serve lat p99 (ms)", "lower", 5.0),
    (("serving", "req_rate"), "serve rate (req/s)", "higher"),
    # shed-rate gate (docs/serving.md "Availability & overload"): a
    # serving change that makes admission control shed a larger fraction
    # of offered load regresses availability even when the latency of
    # the SERVED requests looks fine. The a==0 contract below means a
    # baseline that never shed (every pre-overload stream, and any
    # un-overloaded twin) skips the row — an overload soak gates its
    # served-request percentiles without the soak's sheds auto-failing
    # it; the row bites when BOTH runs shed and the candidate sheds
    # relatively more. 0.01 absolute floor: two overloaded twins jitter
    # a fraction of a percent in shed share.
    (("serving", "shed_fraction"), "serve shed fraction", "lower", 0.01),
    # generative gates (docs/serving.md "Generative serving"): token
    # throughput, time-to-first-token and the inter-token tail. The
    # absolute floors follow the detect.py min_ms discipline — CPU
    # inter-token latency at the millisecond scale jitters fractions of
    # a ms between twin runs, and a purely fractional threshold would
    # flap on it. Absent from every non-generative stream (the generate
    # block is None -> _dig skips the rows), so single-pass or training
    # compares can never false-fail on a family they do not carry.
    (("serving", "generate", "inter_token_p99_ms", "p99"),
     "gen ITL p99 (ms)", "lower", 2.0),
    (("serving", "generate", "ttft_ms", "p99"),
     "gen TTFT p99 (ms)", "lower", 5.0),
    (("serving", "generate", "tokens_per_s"), "gen tokens/s", "higher"),
    # efficiency gate (docs/observability.md "Efficiency"): MFU dropping
    # is the unit-free twin of the step-time gate — it also catches a
    # regression masked by a step-cost change between the two runs. The
    # 0.01 absolute floor (one MFU point) is the detect.py `min_ms`
    # discipline: CPU MFU at the percent scale moves fractions of a point
    # run-to-run from OS noise, and a purely fractional threshold would
    # flap on it. Absent from pre-efficiency and serving streams (_dig
    # skips the row) — old-vs-new compares never false-fail.
    (("efficiency", "mfu", "overall"), "mfu", "higher", 0.01),
)


def _dig(d: dict, path):
    for k in path:
        if d is None:
            return None
        d = d.get(k)
    return d


def _compare_rows(sa: dict, sb: dict, metrics, threshold: float,
                  lines: List[str], regressions: List[dict],
                  label_prefix: str = "") -> None:
    """Append the metric-row comparison of two summary dicts — shared by
    the whole-run gate and the per-version split."""
    for path, label, direction, *rest in metrics:
        floor = rest[0] if rest else 0.0
        a, b = _dig(sa, path), _dig(sb, path)
        if a is None or b is None or not (a == a and b == b):  # NaN guard
            continue
        if a == 0:
            continue
        delta = b / a - 1.0
        worse = delta > threshold if direction == "lower" else (
            -delta > threshold
        )
        if worse and abs(b - a) <= floor:
            worse = False  # within the metric's absolute jitter floor
        mark = "  REGRESSION" if worse else ""
        lines.append(
            f"  {label:<22} {a:>10.4f} {b:>10.4f} {delta:>+7.1%}{mark}"
        )
        if worse:
            regressions.append(
                {"metric": label_prefix + label, "baseline": a,
                 "candidate": b, "delta": delta}
            )


def compare_runs(sa: dict, sb: dict, threshold: float = 0.2):
    """Compare run B against baseline run A.

    Returns ``(lines, regressions)`` where ``regressions`` names every
    metric on which B is worse than A by more than ``threshold``
    (fractional, e.g. 0.2 == 20%). ``cli obs compare`` exits nonzero when
    ``regressions`` is non-empty — a 2x step-time regression can fail CI
    without a human reading a single log line.
    """
    lines = [
        f"baseline: {sa.get('run_id') or sa.get('path')} "
        f"({sa['steps']} steps)",
        f"candidate: {sb.get('run_id') or sb.get('path')} "
        f"({sb['steps']} steps)",
        f"threshold: {threshold * 100:.0f}%",
        "",
        f"  {'metric':<22} {'baseline':>10} {'candidate':>10} {'delta':>8}",
    ]
    regressions: List[dict] = []
    _compare_rows(sa, sb, _COMPARE_METRICS, threshold, lines, regressions)
    ea, eb = sa.get("events", {}), sb.get("events", {})
    for etype in sorted(set(ea) | set(eb)):
        lines.append(
            f"  {('event ' + etype):<22} {ea.get(etype, 0):>10} "
            f"{eb.get(etype, 0):>10}"
        )
    if regressions:
        lines.append("")
        lines.append(
            f"{len(regressions)} regression(s) over the "
            f"{threshold * 100:.0f}% threshold"
        )
    return lines, regressions


#: the serving subset of the gate — what the per-version split applies
#: to each artifact identity (paths are relative to one version's
#: serving summary, wrapped back under "serving" for _dig). Latency
#: PERCENTILES only: a version's request RATE is the router's traffic
#: split (a 10% canary serves 10% of the requests by design), so gating
#: per-version rate would convict every canary on arrival.
_SERVING_COMPARE_METRICS = tuple(
    row for row in _COMPARE_METRICS
    if row[0][0] == "serving" and row[0][1] == "latency_ms"
)


def compare_by_version(rs_a: RunStream, rs_b: RunStream,
                       threshold: float = 0.2):
    """Per-artifact-version percentile gating — the canary promotion
    gate (``obs compare --by-version``).

    Splits both streams by the ``version`` stamp and gates the serving
    metric rows per version. Versions present on only one side are
    reported and SKIPPED (a brand-new canary version has no baseline —
    that is not a regression); streams with no version stamps at all
    (v1 / pre-tracing) skip the whole split with an explanatory line and
    zero regressions — never a false failure.

    Returns ``(lines, regressions)`` like :func:`compare_runs`.
    """
    va = summarize_by_version(rs_a)
    vb = summarize_by_version(rs_b)
    lines = [
        f"baseline:  {rs_a.path} ({len(va)} version(s))",
        f"candidate: {rs_b.path} ({len(vb)} version(s))",
        f"threshold: {threshold * 100:.0f}%",
    ]
    regressions: List[dict] = []
    if not va and not vb:
        lines.append(
            "  neither stream carries artifact version stamps "
            "(pre-tracing v1 streams?) — per-version gate skipped"
        )
        return lines, regressions
    for version in sorted(set(va) | set(vb)):
        lines.append("")
        if version not in va:
            lines.append(
                f"version {version}: only in candidate (new canary?) — "
                "skipped, no baseline to gate against"
            )
            continue
        if version not in vb:
            lines.append(
                f"version {version}: only in baseline — skipped"
            )
            continue
        a, b = va[version], vb[version]
        lines.append(
            f"version {version}: {a['requests']} vs {b['requests']} "
            "request(s)"
        )
        before = len(regressions)
        _compare_rows(
            {"serving": a}, {"serving": b}, _SERVING_COMPARE_METRICS,
            threshold, lines, regressions,
            label_prefix=f"[{version}] ",
        )
        if len(regressions) == before:
            lines.append("  no regressions for this version")
    if regressions:
        lines.append("")
        lines.append(
            f"{len(regressions)} per-version regression(s) over the "
            f"{threshold * 100:.0f}% threshold"
        )
    return lines, regressions


def compare_serving_windows(reqs_a, reqs_b, threshold: float = 0.2,
                            drops_a: int = 0, drops_b: int = 0):
    """The per-version latency-percentile gate over two explicit record
    windows — the same metric rows, direction and jitter floors as
    ``obs compare --by-version``, applied to in-memory sliding windows
    instead of whole streams. This is what the canary router
    (``serving/router.py``) judges a live canary with, so an online
    conviction and an offline ``obs compare --by-version`` of the same
    records can never disagree. Returns ``(lines, regressions)``."""
    sa = _serving_summary_records(list(reqs_a), drops_a)
    sb = _serving_summary_records(list(reqs_b), drops_b)
    lines: List[str] = []
    regressions: List[dict] = []
    _compare_rows({"serving": sa}, {"serving": sb},
                  _SERVING_COMPARE_METRICS, threshold, lines, regressions)
    return lines, regressions


# ---------------------------------------------------------------------------
# Replay (obs export)
# ---------------------------------------------------------------------------


def replay_registry(rs: RunStream) -> MetricRegistry:
    """Rebuild a registry from a stream, via the same Telemetry update path
    the live trainer uses — `obs export` output matches a live scrape.
    The manifest rides along so the efficiency gauges (pdtn_mfu & co,
    derived from manifest.step_cost inside ``log_step``) replay too."""
    t = Telemetry(manifest=rs.manifest)
    mf = rs.manifest or {}
    if mf:
        labels = {"run_id": str(mf.get("run_id"))}
        cfg = mf.get("config") or {}
        if cfg.get("network"):
            labels["network"] = str(cfg["network"])
        t.registry.gauge(
            "run_info", help="run identity (value is always 1)",
            labels=labels,
        ).set(1.0)
    for rec in rs.steps:
        t.log_step({k: v for k, v in rec.items() if k != "kind"})
    for e in rs.events:
        fields = {
            k: v for k, v in e.items()
            if k not in ("kind", "type", "time", "step")
        }
        t.emit(e.get("type", "?"), step=e.get("step"), **fields)
    return t.registry


# ---------------------------------------------------------------------------
# Synthetic runs (golden fixtures for tests + --selftest)
# ---------------------------------------------------------------------------


def write_synthetic_run(
    run_dir: str,
    steps: int = 60,
    step_time: float = 0.01,
    data_time: float = 0.002,
    jitter: float = 0.1,
    seed: int = 0,
    eval_every: int = 30,
    with_events: bool = True,
    with_cost: bool = True,
) -> str:
    """Write a deterministic synthetic telemetry stream into ``run_dir``.

    Used as the golden fixture for `obs summary`/`obs compare` tests and
    built live by ``obs summary --selftest`` (fast: no torch, no training).
    ``with_cost=False`` drops the manifest's ``step_cost`` record — the
    PRE-efficiency stream shape, for the absent-section contract tests.
    Returns the stream path.
    """
    rng = random.Random(seed)
    # at the nominal step_time: achieved = 2e8/0.01 = 2e10 FLOP/s of the
    # 1e11 "peak" -> MFU 0.20; the selftest pins these derivations
    step_cost = {
        "flops": 2e8, "hbm_bytes": 1e7, "ici_bytes": 1e6,
        "peak_flops_per_s": 1e11, "peak_hbm_bytes_per_s": 1e10,
        "devices": 4, "backend": "cpu", "source": "lowered",
        "predicted_ms": 8.0,
        "families": {
            "convert_reduce_fusion": {"flops": 1e8, "hbm_bytes": 4e6,
                                      "count": 10},
            "multiply_add_fusion": {"flops": 9e7, "hbm_bytes": 4e6,
                                    "count": 10},
            "elementwise": {"flops": 1e7, "hbm_bytes": 2e6, "count": 50},
            "other": {"flops": 0.0, "hbm_bytes": 0.0, "count": 5},
        },
    } if with_cost else None
    manifest = run_manifest(
        config={"network": "SynthNet", "dataset": "Synthetic",
                "batch_size": 32, "max_steps": steps},
        mesh_shape={"data": 4, "model": 1, "seq": 1},
        param_count=1234,
        step_cost=step_cost,
    )
    path = os.path.join(run_dir, STREAM_BASENAME)
    t = Telemetry.for_run(path, manifest)
    try:
        for i in range(1, steps + 1):
            st = step_time * (1.0 + jitter * (2 * rng.random() - 1))
            dt = data_time * (1.0 + jitter * rng.random())
            record = {
                "step": i,
                "epoch": 0,
                "loss": 2.0 * (0.98 ** i),
                "acc1": min(0.9, 0.01 * i),
                "acc5": min(0.99, 0.02 * i),
                "data_time": dt,
                "step_time": st,
                # half the data phase was an actual loader block
                "input_wait_ms": round(dt * 500.0, 3),
                "imgs_per_sec": 32.0 / st,
            }
            t.log_step(record)
            if with_events and eval_every and i % eval_every == 0:
                secs = 0.05 + 0.01 * rng.random()
                t.emit("checkpoint_write", step=i,
                       seconds=secs, bytes=4096,
                       write_ms=round(secs * 1000, 3),
                       stall_ms=round(2.0 + rng.random(), 3),
                       queued_ms=round(0.5 * rng.random(), 3),
                       path=f"model_step_{i}", **{"async": True})
                t.emit("eval_result", step=i, loss=record["loss"],
                       acc1=record["acc1"], acc5=record["acc5"])
        if with_events:
            t.emit("retry", step=2, label="checkpoint write", attempt=1,
                   error="OSError: injected", delay=0.05)
            t.emit("straggler_drop", step=3, dropped=1, ranks=[2],
                   skew=7.5)
            t.emit("fault_injected", step=3, fault="delay@3:p2:5s")
            t.emit("input_wait", step=4, wait_ms=125.0)
    finally:
        t.close()
    return path


def write_synthetic_serving_run(
    run_dir: str,
    requests: int = 200,
    latency_ms: float = 5.0,
    rate: float = 1000.0,
    dropped: int = 2,
    jitter: float = 0.2,
    seed: int = 0,
    v1: bool = False,
    versions: Optional[Dict[str, float]] = None,
) -> str:
    """Deterministic synthetic SERVING stream (``serving.jsonl``): one
    request record per served request plus ``request_dropped`` events —
    the golden fixture for the serving sections of ``obs summary`` /
    ``obs compare`` and their selftest invariants.

    ``v1=True`` writes the PRE-tracing record shape (no ``request_id``/
    ``spans``/``version`` — the golden fixture for the schema-bump
    bidirectionality contract). ``versions`` maps artifact version
    stamps to their mean latency; requests round-robin across them (the
    mixed-version canary stream for ``--by-version`` tests). Default:
    one version ``synth@1:none`` at ``latency_ms``. Returns the path.
    """
    rng = random.Random(seed)
    manifest = run_manifest(
        config={"mode": "serving", "network": "SynthNet",
                "artifact": "synthetic", "batch_buckets": [1, 2, 4, 8]},
        param_count=1234,
    )
    if not v1:
        manifest["artifact_identity"] = {
            "version": "synth@1:none", "train_dir": "/synthetic",
            "step": 1, "quantize": "none", "network": "SynthNet",
        }
    vlist = (
        [(None, latency_ms)] if v1
        else sorted((versions or {"synth@1:none": latency_ms}).items())
    )
    path = os.path.join(run_dir, SERVING_BASENAME)
    t = Telemetry.for_run(path, manifest)
    base = 1_700_000_000.0
    try:
        for i in range(requests):
            version, v_lat = vlist[i % len(vlist)]
            lat = v_lat * (1.0 + jitter * (2 * rng.random() - 1))
            queue = lat * 0.3
            batch = rng.choice((1, 2, 3, 4, 6, 8))
            bucket = 1 << max(0, (batch - 1).bit_length())
            rec = {
                "step": i,
                "latency_ms": round(lat, 3),
                "queue_ms": round(queue, 3),
                "infer_ms": round(lat - queue, 3),
                "pad_ms": 0.05,
                "batch": batch,
                "bucket": bucket,
                # fixed wall stamps so req_rate is deterministic
                "time": base + i / rate,
                "mono": i / rate,
            }
            if not v1:
                rec["request_id"] = f"synth{seed:02d}-{i:06d}"
                rec["version"] = version
                infer = lat - queue - 0.2
                rec["spans"] = {
                    "admit": 0.01,
                    "queue": round(queue, 3),
                    "batch_form": 0.04,
                    "pad": 0.05,
                    "infer": round(max(infer, 0.01), 3),
                    "respond": 0.1,
                }
            t.log_step(rec)
        for i in range(dropped):
            # drops ride the same fixed timeline as the requests, so
            # window math over the fixture is deterministic
            fields = dict(request=requests + i, queued_ms=2000.0,
                          deadline_ms=2000.0,
                          time=base + (requests + i) / rate,
                          mono=(requests + i) / rate)
            if not v1:
                fields["request_id"] = f"synth{seed:02d}-drop{i}"
                fields["version"] = vlist[i % len(vlist)][0]
            t.emit("request_dropped", **fields)
    finally:
        t.close()
    return path


def write_synthetic_pod(
    run_dir: str,
    ranks: int = 2,
    steps: int = 40,
    step_time: float = 0.01,
    clock_skew: float = 5.0,
    straggler_rank: Optional[int] = None,
    seed: int = 0,
) -> List[str]:
    """Deterministic N-rank stream family with deliberately skewed clocks.

    Rank ``r``'s wall clock runs ``r * clock_skew`` seconds fast and its
    monotonic epoch is arbitrary (as on real distinct hosts), while the
    TRUE per-step completion instants are shared — the synchronous-SPMD
    barrier ``merge_streams`` exploits. ``straggler_rank`` plants
    attribution fields (``straggler_slowest_rank`` on every step,
    ``straggler_dropped[_mask]`` + a ``straggler_drop`` event every 10th
    step) so the ``--by-rank`` table has something to attribute. Returns
    the stream paths, rank 0 first. Records are written raw (not through
    ``Telemetry``) because the fixture must control the clocks."""
    rng = random.Random(seed)
    t0 = 1_700_000_000.0  # fixed wall epoch: fixture must be deterministic
    paths = []
    for r in range(ranks):
        wall_skew = r * clock_skew
        mono_epoch = 1000.0 + 77.7 * r  # arbitrary per-host boot epoch
        path = os.path.join(run_dir, stream_basename(r))
        manifest = {
            "kind": "manifest", "schema": 1,
            "run_id": f"podrun{seed:04d}", "rank": r,
            "host": f"host-{r}",
            "time": t0 + wall_skew,
            "clock": {"wall": t0 + wall_skew, "mono": t0 - mono_epoch},
            "config": {"network": "SynthNet", "dataset": "Synthetic"},
        }
        with open(path, "w") as f:
            f.write(json.dumps(manifest) + "\n")
            true_t = t0
            for i in range(1, steps + 1):
                st = step_time * (1.0 + 0.02 * r)  # rank's own compute
                # completion instants are SHARED (the sync barrier means
                # every rank finishes a step when the slowest one does)
                true_t += step_time * (1.0 + 0.02 * (ranks - 1))
                rec = {
                    "kind": "step", "step": i, "loss": 2.0 * (0.98 ** i),
                    "data_time": 0.001, "step_time": st,
                    "time": true_t + wall_skew,
                    "mono": true_t - mono_epoch,
                }
                if straggler_rank is not None:
                    rec["straggler_slowest_rank"] = float(straggler_rank)
                    rec["straggler_skew"] = 3.0 + rng.random()
                    if i % 10 == 0:
                        rec["straggler_dropped"] = 1.0
                        rec["straggler_dropped_mask"] = float(
                            2 ** straggler_rank
                        )
                    else:
                        rec["straggler_dropped"] = 0.0
                f.write(json.dumps(rec) + "\n")
                if (
                    straggler_rank is not None and i % 10 == 0
                ):
                    f.write(json.dumps({
                        "kind": "event", "type": "straggler_drop",
                        "step": i, "dropped": 1,
                        "ranks": [straggler_rank],
                        "slowest_rank": straggler_rank,
                        "time": true_t + wall_skew,
                        "mono": true_t - mono_epoch,
                    }) + "\n")
        paths.append(path)
    return paths


# ---------------------------------------------------------------------------
# Cross-process trace assembly (obs trace, docs/observability.md
# "Distributed tracing")
# ---------------------------------------------------------------------------


def find_trace_streams(target: str) -> List[str]:
    """Every telemetry stream under ``target``, recursively: the
    ``telemetry*.jsonl`` family, ``serving*.jsonl`` (frontend and
    replica serving streams) and ``sweep.jsonl`` fleet journals. A
    frontend run dir holds the frontend's own stream at the top and one
    replica stream per ``r<k>/serve/`` subdirectory — cross-process
    assembly needs them all. A direct file path is returned as-is."""
    if os.path.isfile(target):
        return [target]
    if not os.path.isdir(target):
        raise FileNotFoundError(f"{target}: no such file or directory")
    stem, ext = os.path.splitext(STREAM_BASENAME)
    sstem, _ = os.path.splitext(SERVING_BASENAME)
    paths = []
    for dirpath, dirnames, filenames in os.walk(target):
        dirnames.sort()  # deterministic discovery order
        for name in sorted(filenames):
            if not name.endswith(ext):
                continue
            if (name == "sweep.jsonl"
                    or name.startswith(stem) or name.startswith(sstem)):
                paths.append(os.path.join(dirpath, name))
    if not paths:
        raise FileNotFoundError(
            f"no {stem}*{ext}, {sstem}*{ext} or sweep.jsonl streams "
            f"anywhere under {target}"
        )
    return paths


def load_trace_streams(target: str) -> List[RunStream]:
    """Parse every stream :func:`find_trace_streams` discovers — load
    once, then :func:`assemble_trace` many requests against the same
    parsed set (what the chaos trace-completeness invariant does)."""
    return [read_stream(p) for p in find_trace_streams(target)]


def _stream_label(path: str, root: Optional[str]) -> str:
    if root and os.path.isdir(root):
        rel = os.path.relpath(path, root)
        if not rel.startswith(".."):
            return rel
    return path


def assemble_trace(target: str, key: str,
                   streams: Optional[List[RunStream]] = None) -> dict:
    """Join every stream under ``target`` into ONE tree for the trace
    (or request) ``key`` — the assembly half of distributed tracing.

    ``key`` may be a 32-hex trace id or a request id; either resolves
    to the trace via any record carrying both. Records across processes
    join on the span stamps the propagation layer wrote: the frontend
    record's ``hops`` list names one span per forward attempt, and each
    replica's record points back at its attempt via ``parent`` —
    ``attempts[i]["replica_record"]`` is that join. Per-stream clock
    offsets are estimated from *wall-time* deltas over the request ids
    the frontend and the replica both logged (median, the
    :func:`merge_streams` discipline — monotonic clocks have per-boot
    epochs, so cross-process joins must use wall time and report the
    measured skew rather than trust it). A non-root record whose parent
    span appears nowhere in the trace is flagged as an **orphan** — a
    torn stream or a propagation bug; the frontend root keeping a
    client-supplied parent is not one.

    Pre-tracing streams (no ``trace`` stamps) degrade to a request-id
    join: every record of ``key`` across streams, no tree. Raises
    ``FileNotFoundError`` when nothing matches.
    """
    if streams is None:
        streams = load_trace_streams(target)
    root = target if isinstance(target, str) else None
    key = str(key)

    def records(rs):
        for r in rs.steps:
            yield r
        for r in rs.events:
            yield r

    # resolve the key: trace id directly, or request id -> its trace
    trace_id = None
    request_id = None
    for rs in streams:
        for r in records(rs):
            if str(r.get("trace")) == key:
                trace_id = key
                break
            if r.get("request_id") is not None \
                    and str(r["request_id"]) == key:
                request_id = key
                if r.get("trace") is not None:
                    trace_id = str(r["trace"])
                break
        if trace_id is not None or request_id is not None:
            break
    if trace_id is None and request_id is None:
        raise FileNotFoundError(
            f"no record matching trace/request {key!r} in "
            f"{len(streams)} stream(s)"
        )

    matched: List[dict] = []
    for rs in streams:
        lab = _stream_label(rs.path, root)
        for r in records(rs):
            hit = (
                str(r.get("trace")) == trace_id if trace_id is not None
                else (r.get("request_id") is not None
                      and str(r["request_id"]) == request_id)
            )
            if hit:
                matched.append({"record": r, "stream": lab})

    # the frontend record is the one carrying the hops list; a served
    # request's step record wins over a request_failed event (both can
    # exist when a failed forward is later retried by the client)
    fe = None
    for e in matched:
        r = e["record"]
        if isinstance(r.get("hops"), list):
            if fe is None or (fe["record"].get("kind") == "event"
                              and r.get("kind") != "event"):
                fe = e
    if fe is not None and request_id is None:
        rid = fe["record"].get("request_id")
        request_id = str(rid) if rid is not None else None

    # join replica records to forward attempts: a replica's span is a
    # child of the attempt's hop span
    by_parent: Dict[str, dict] = {}
    span_ids = set()
    for e in matched:
        r = e["record"]
        if r.get("span") is not None:
            span_ids.add(str(r["span"]))
        if e is not fe and r.get("parent") is not None:
            by_parent.setdefault(str(r["parent"]), e)
    attempts: List[dict] = []
    if fe is not None:
        for hop in fe["record"].get("hops") or []:
            if not isinstance(hop, dict):
                continue
            att = dict(hop)
            span_ids.add(str(hop.get("span")))
            sub = by_parent.get(str(hop.get("span")))
            att["replica_record"] = sub["record"] if sub else None
            att["stream"] = sub["stream"] if sub else None
            attempts.append(att)

    orphans = [
        {"span": e["record"].get("span"),
         "parent": str(e["record"]["parent"]),
         "stream": e["stream"]}
        for e in matched
        if e is not fe and e["record"].get("parent") is not None
        and str(e["record"]["parent"]) not in span_ids
    ]

    # wall-clock offsets vs the frontend stream, over EVERY request id
    # both streams logged (not just this trace): median delta, robust
    # to the per-request network latency riding on each sample
    clock_offsets: Dict[str, float] = {}
    if fe is not None:
        fe_rs = next(
            (rs for rs in streams
             if _stream_label(rs.path, root) == fe["stream"]), None
        )
        contributing = {
            e["stream"] for e in matched if e is not fe
        }
        if fe_rs is not None:
            fe_times = {
                str(r["request_id"]): float(r["time"])
                for r in fe_rs.steps
                if r.get("request_id") is not None and "time" in r
            }
            for rs in streams:
                lab = _stream_label(rs.path, root)
                if rs is fe_rs or lab not in contributing:
                    continue
                deltas = sorted(
                    float(r["time"]) - fe_times[str(r["request_id"])]
                    for r in rs.steps
                    if r.get("request_id") is not None and "time" in r
                    and str(r["request_id"]) in fe_times
                )
                if deltas:
                    clock_offsets[lab] = round(
                        deltas[len(deltas) // 2], 3
                    )

    return {
        "trace": trace_id,
        "request_id": request_id,
        "frontend": fe,
        "attempts": attempts,
        "records": [e for e in matched if e is not fe],
        "orphans": orphans,
        "clock_offsets": clock_offsets,
        "streams": [_stream_label(rs.path, root) for rs in streams],
    }


def write_synthetic_frontend_run(run_dir: str) -> str:
    """Deterministic synthetic FRONTEND run for ``obs trace --selftest``
    and the assembly tests: a frontend ``serving.jsonl`` plus two
    replica streams under ``r0/serve/`` and ``r1/serve/``, covering

    - a plain forward (one attempt, won);
    - a hedged request — the first attempt LOSES (its replica record
      exists and must render as ``discarded``), the hedge wins;
    - a retried request — first attempt fails with a breaker
      annotation (no replica record), the retry wins;
    - an orphan record (its parent span appears in no stream);
    - replica r1's wall clock running ~120 s fast, so offset recovery
      has something to recover.

    Records are written raw (the fixture must control clocks and span
    ids). torch-free, milliseconds to run. Returns the frontend stream
    path.
    """
    t0 = 1_700_000_000.0
    skew = 120.5  # r1's wall clock runs this many seconds fast
    trace = {k: f"{k}0feed{i:027x}" for i, k in
             enumerate(("a", "b", "c", "d"))}
    span = {name: f"5ba2{i:012x}" for i, name in enumerate((
        "fe_a", "hop_a1", "r_a",
        "fe_b", "hop_b1", "hop_b2", "r_b1", "r_b2",
        "fe_c", "hop_c1", "hop_c2", "r_c2",
        "orphan", "ghost",
    ))}

    def manifest(run_id):
        return {"kind": "manifest", "schema": 2, "run_id": run_id,
                "time": t0, "config": {"mode": "serving"}}

    def replica_rec(step, rid, tr, sp, parent, lat, t, version="synth@1"):
        queue = round(lat * 0.35, 3)
        infer = round(lat * 0.5, 3)
        return {
            "kind": "step", "step": step, "request_id": rid,
            "latency_ms": lat, "queue_ms": queue, "infer_ms": infer,
            "batch": 1, "bucket": 1, "time": t, "version": version,
            "trace": tr, "span": sp, "parent": parent,
            "spans": {"admit": 0.01, "queue": queue, "batch_form": 0.04,
                      "pad": 0.05, "infer": infer, "respond": 0.1},
        }

    os.makedirs(run_dir, exist_ok=True)
    fe_path = os.path.join(run_dir, SERVING_BASENAME)
    with open(fe_path, "w") as f:
        f.write(json.dumps(manifest("synth-frontend")) + "\n")
        rows = [
            # plain: one attempt, won
            dict(step=1, request_id="fe-000001", latency_ms=6.2,
                 replica="r0", attempts=1, hedged=False, klass="stable",
                 trace=trace["a"], span=span["fe_a"],
                 hops=[dict(span=span["hop_a1"], tag="first",
                            replica="r0", start_ms=0.1, ms=5.8,
                            status=200, outcome="won", upstream_ms=5.1,
                            queue_ms=1.8, infer_ms=2.6)],
                 time=t0 + 1.0),
            # hedged: first loses (replica record EXISTS), hedge wins
            dict(step=2, request_id="fe-000002", latency_ms=31.0,
                 replica="r1", attempts=2, hedged=True, klass="stable",
                 trace=trace["b"], span=span["fe_b"],
                 hops=[dict(span=span["hop_b1"], tag="first",
                            replica="r0", start_ms=0.1,
                            status=200, outcome="discarded"),
                       dict(span=span["hop_b2"], tag="hedge",
                            replica="r1", start_ms=25.0, ms=5.6,
                            status=200, outcome="won", upstream_ms=4.9,
                            queue_ms=1.7, infer_ms=2.4)],
                 time=t0 + 2.0),
            # retried: first fails at an open breaker, retry wins
            dict(step=3, request_id="fe-000003", latency_ms=18.4,
                 replica="r1", attempts=2, hedged=False, klass="stable",
                 trace=trace["c"], span=span["fe_c"],
                 hops=[dict(span=span["hop_c1"], tag="first",
                            replica="r0", start_ms=0.1, ms=2.0,
                            outcome="failed",
                            error="ConnectionRefusedError: [Errno 111]",
                            annotations=["breaker_open"]),
                       dict(span=span["hop_c2"], tag="retry",
                            replica="r1", start_ms=2.5, ms=15.2,
                            status=200, outcome="won", upstream_ms=14.0,
                            queue_ms=9.1, infer_ms=4.2)],
                 time=t0 + 3.0),
        ]
        for r in rows:
            f.write(json.dumps({"kind": "step", **r}) + "\n")

    r0_dir = os.path.join(run_dir, "r0", "serve")
    os.makedirs(r0_dir, exist_ok=True)
    with open(os.path.join(r0_dir, SERVING_BASENAME), "w") as f:
        f.write(json.dumps(manifest("synth-r0")) + "\n")
        f.write(json.dumps(replica_rec(
            1, "fe-000001", trace["a"], span["r_a"], span["hop_a1"],
            5.0, t0 + 0.999)) + "\n")
        # the hedge LOSER: the batcher served it after the frontend had
        # already returned the hedge's response — the record must exist
        # and assemble as the discarded branch
        f.write(json.dumps(replica_rec(
            2, "fe-000002", trace["b"], span["r_b1"], span["hop_b1"],
            45.0, t0 + 2.020)) + "\n")

    r1_dir = os.path.join(run_dir, "r1", "serve")
    os.makedirs(r1_dir, exist_ok=True)
    with open(os.path.join(r1_dir, SERVING_BASENAME), "w") as f:
        f.write(json.dumps(manifest("synth-r1")) + "\n")
        f.write(json.dumps(replica_rec(
            1, "fe-000002", trace["b"], span["r_b2"], span["hop_b2"],
            4.8, t0 + skew + 1.998)) + "\n")
        f.write(json.dumps(replica_rec(
            2, "fe-000003", trace["c"], span["r_c2"], span["hop_c2"],
            13.9, t0 + skew + 2.997)) + "\n")
        # the planted orphan: parent span exists in NO stream (its
        # frontend died before flushing) — assemble_trace must flag it,
        # never silently drop it
        f.write(json.dumps(replica_rec(
            3, "fe-000004", trace["d"], span["orphan"], span["ghost"],
            7.7, t0 + skew + 4.0)) + "\n")
    return fe_path
