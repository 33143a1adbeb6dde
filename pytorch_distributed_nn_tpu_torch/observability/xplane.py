"""Summaries of ``torch.profiler`` traces for the command line and the
flight recorder: the port of ``pytorch_distributed_nn_tpu/observability/
xplane.py``. The module keeps its counterpart's name so a reader finds
it; the traces are ``torch.profiler`` Chrome traces
(``*.pt.trace.json``), not XLA's xplane protos.

- the command line: ``python -m pytorch_distributed_nn_tpu_torch.
  observability.xplane <trace_dir> [--steps N] [--full] [--top K]
  [--overlap]`` (the counterpart of ``tools/xplane_summary.py``);
- the flight recorder: :func:`write_incident_report` turns a captured
  incident bundle (:mod:`.flightrec`) into ``report.md``: the trigger,
  the per-kernel device-time table of the bundle's trace, the event
  ring's tail and the environment;
- the parsing core lives in :mod:`..utils.profiling` and is re-exported
  here.

Every entry point degrades instead of raising when a trace has no device
events (a CPU-only capture) or cannot be read: the report says why.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

from pytorch_distributed_nn_tpu_torch.utils.profiling import (
    FAMILIES,
    collective_overlap_report,
    device_step_time_ms,
    family_summary,
    find_trace,
    format_family_summary,
    format_summary,
    op_family,
    summarize_trace,
)

__all__ = [
    "FAMILIES",
    "collective_overlap_report",
    "device_step_time_ms",
    "family_summary",
    "format_family_summary",
    "format_summary",
    "op_family",
    "summarize_trace",
    "trace_summary_text",
    "render_incident_report",
    "write_incident_report",
    "main",
]


#: inline-report parse ceiling: the recorder's background report thread
#: must not spend the training host's CPU on a huge JSON trace; the
#: command line (`main`) has no cap
REPORT_MAX_TRACE_BYTES = 64 << 20


def trace_summary_text(trace_dir: str, top: int = 30, collapse: bool = True,
                       max_bytes: Optional[int] = None,
                       cost: Optional[dict] = None,
                       steps: Optional[int] = None) -> str:
    """Per-kernel table for ``trace_dir``, or a one-line reason it is
    unavailable — never raises (the recorder's report must always be
    writable, trace or no trace). A per-family table follows; with
    ``cost`` (per-step ``{family: {"flops", "hbm_bytes"}}``) and the step
    count the trace covers it has achieved-TFLOP/s columns."""
    if max_bytes is not None:
        try:
            size = os.path.getsize(find_trace(trace_dir))
        except Exception as e:
            return f"(trace summary unavailable: {e})"
        if size > max_bytes:
            return (
                f"(trace is {size / 1e6:.0f} MB — past the inline summary "
                "ceiling; run `python -m pytorch_distributed_nn_tpu_torch."
                f"observability.xplane {trace_dir}` or open it in Perfetto)"
            )
    try:
        summary = summarize_trace(trace_dir, top=top, collapse=collapse)
    except Exception as e:
        return f"(trace summary unavailable: {e})"
    if not summary:
        return ("(no device planes: the trace holds no kernel, copy or "
                "memset events — a CPU-only capture; open the raw trace in "
                "Perfetto)")
    out = format_summary(summary)
    try:
        fams = family_summary(summary)
        out += "\n\nper family:\n" + format_family_summary(
            fams, cost=cost, steps=steps
        )
    except Exception:  # the op table must survive a family-table bug
        pass
    return out


# ---------------------------------------------------------------------------
# Incident report generation (flightrec bundles)
# ---------------------------------------------------------------------------

_RING_TAIL = 40  # ring records rendered into the report


def _fmt_ring_record(rec: dict) -> str:
    kind = rec.get("kind")
    if kind == "manifest":
        return f"manifest run={rec.get('run_id')} rank={rec.get('rank')}"
    if kind == "event":
        extra = {
            k: v for k, v in rec.items()
            if k not in ("kind", "type", "time", "mono", "step")
        }
        step = f" step={rec['step']}" if "step" in rec else ""
        return (f"event {rec.get('type')}{step} "
                f"{json.dumps(extra, default=str)[:160]}")
    parts = [f"step={rec.get('step')}"]
    for k in ("loss", "step_time", "data_time", "straggler_dropped"):
        if k in rec:
            try:
                parts.append(f"{k}={float(rec[k]):.4f}")
            except (TypeError, ValueError):
                parts.append(f"{k}={rec[k]}")
    return "step " + " ".join(parts)


def render_incident_report(bundle_dir: str,
                           trace_error: Optional[str] = None) -> str:
    """Markdown report for one incident bundle (pure file reading)."""
    def load(name):
        try:
            with open(os.path.join(bundle_dir, name)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    incident = load("incident.json")
    manifest = load("manifest.json")
    env = load("env.json")
    lines = [
        f"# Incident: {incident.get('kind', '?')} @ step "
        f"{incident.get('step', '?')}",
        "",
        f"- **reason**: {incident.get('reason', '?')}",
        f"- **run**: `{incident.get('run_id') or manifest.get('run_id')}` "
        f"(rank {manifest.get('rank', 0)}, host "
        f"{manifest.get('host', '?')})",
        f"- **triggered**: {time.strftime('%Y-%m-%d %H:%M:%S %Z', time.localtime(incident['triggered_time'])) if incident.get('triggered_time') else '?'}",
        f"- **capture window**: steps "
        f"{incident.get('capture_from_step', '?')}.."
        f"{incident.get('capture_until_step', '?')}",
        f"- **detector spec**: `{incident.get('spec', '?')}`",
    ]
    detail = incident.get("detail")
    if detail:
        lines.append(f"- **detail**: `{json.dumps(detail, default=str)}`")
    cfg = manifest.get("config") or {}
    if cfg:
        lines.append(
            f"- **config**: {cfg.get('network')}/{cfg.get('dataset')} "
            f"batch {cfg.get('batch_size')} · geometry "
            f"{manifest.get('geometry')}"
        )
    lines += ["", "## Device trace", ""]
    trace_dir = os.path.join(bundle_dir, "trace")
    if trace_error:
        lines.append(f"(trace not captured: {trace_error})")
    elif not os.path.isdir(trace_dir):
        lines.append("(no trace directory in this bundle)")
    else:
        # efficiency columns: a manifest's static step cost and the
        # capture window's length
        cost = (manifest.get("step_cost") or {}).get("families")
        steps = None
        try:
            lo = incident.get("capture_from_step")
            hi = incident.get("capture_until_step")
            if lo is not None and hi is not None and int(hi) > int(lo):
                steps = int(hi) - int(lo)
        except (TypeError, ValueError):
            pass
        lines.append("```")
        lines.append(trace_summary_text(
            trace_dir, max_bytes=REPORT_MAX_TRACE_BYTES,
            cost=cost, steps=steps,
        ))
        lines.append("```")
    ring = []
    try:
        with open(os.path.join(bundle_dir, "events.jsonl")) as f:
            for line in f:
                line = line.strip()
                if line:
                    try:
                        ring.append(json.loads(line))
                    except ValueError:
                        pass
    except OSError:
        pass
    lines += [
        "",
        f"## Event ring ({len(ring)} records; last {_RING_TAIL} shown, "
        "newest last)",
        "",
        "```",
    ]
    lines += [_fmt_ring_record(r) for r in ring[-_RING_TAIL:]]
    lines.append("```")
    lines += ["", "## Environment", ""]
    env_flags = (env.get("env") or {})
    if env_flags:
        lines.append("```")
        lines += [f"{k}={v}" for k, v in env_flags.items()]
        lines.append("```")
    lines.append(
        f"(full capture: `env.json`; torch {env.get('torch_version', '?')}"
        f", CUDA {env.get('cuda_version', '?')} on "
        f"{env.get('device_name', '?')} ({env.get('power_limit', '?')}), "
        f"{env.get('device_count', '?')} device(s))"
    )
    lines.append("")
    return "\n".join(lines)


def write_incident_report(bundle_dir: str,
                          trace_error: Optional[str] = None) -> str:
    """Render and write ``report.md`` into the bundle; returns the path."""
    path = os.path.join(bundle_dir, "report.md")
    with open(path, "w") as f:
        f.write(render_incident_report(bundle_dir, trace_error=trace_error))
    return path


# ---------------------------------------------------------------------------
# Command line
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    """Print a per-kernel device-time table of a torch.profiler trace.

    <trace_dir> is a trainer's `--profile-dir` (default
    <train_dir>/profile) or an incident bundle's `trace/`; the newest
    *.pt.trace.json under it is read. `--full` keeps full kernel names.
    """
    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("trace_dir")
    p.add_argument("--full", action="store_true",
                   help="full kernel names (no collapsing to base names)")
    p.add_argument("--top", type=int, default=30)
    p.add_argument("--steps", type=int, default=None,
                   help="if given, also print device ms/step = total/steps")
    p.add_argument("--overlap", action="store_true",
                   help="report NCCL/compute overlap (meaningful on "
                        "multi-rank traces)")
    args = p.parse_args(argv)

    summary = summarize_trace(
        args.trace_dir, top=args.top, collapse=not args.full
    )
    if not summary:
        print("no device events (kernels, copies, memsets) found",
              file=sys.stderr)
        return 1
    print(format_summary(summary))
    print("\nper family:")
    print(format_family_summary(family_summary(summary)))
    if args.steps:
        print(f"\ndevice time: "
              f"{device_step_time_ms(args.trace_dir, args.steps):.3f} "
              f"ms/step over {args.steps} steps (all streams)")
    if args.overlap:
        print("\ncollective/compute overlap:",
              collective_overlap_report(args.trace_dir))
    return 0


if __name__ == "__main__":
    sys.exit(main())
