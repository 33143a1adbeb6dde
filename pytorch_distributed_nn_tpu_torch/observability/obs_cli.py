"""The `cli obs` inspection suite: summary / tail / compare / export /
incidents.

The port's copy of
``pytorch_distributed_nn_tpu/observability/obs_cli.py`` over the port's
reader, slo, promexport and flight recorder; it prints what the JAX
``obs`` prints for the same streams.

The human and CI surface over the unified telemetry stream — the tooling
that retires regex-over-logs (reference: src/tiny_tuning_parser.py,
analysis/*.ipynb) for good:

- ``obs summary <run>``   — per-phase p50/p95/p99, step-rate trend, event
  counts, checkpoint durations, accuracy-vs-step. ``--by-rank`` merges a
  multi-host run's per-process stream family on (step, rank) with
  clock-skew alignment and prints per-rank phase percentiles plus the
  straggler attribution table. ``--selftest`` builds a tiny synthetic run,
  summarizes it and checks the layer's invariants (manifest-first,
  percentile math, event accounting, exposition format, cross-rank
  merge).
- ``obs tail <run>``      — print the stream's tail; ``--follow`` keeps
  polling like ``tail -f`` (honoring the torn-tail contract: a partial
  line in flight is re-read, never printed half-way).
- ``obs compare <a> <b>`` — regression deltas between two runs; exits
  nonzero when the candidate regresses past ``--threshold`` — the CI
  gate. ``--by-version`` splits the serving percentile gate per artifact
  identity (the canary promotion gate, docs/observability.md).
- ``obs trace <run> <id>`` — assemble one request's CROSS-PROCESS
  waterfall from every stream under ``<run>`` (frontend + replicas +
  sweep journals, discovered recursively): forward attempts as
  competing branches (hedge winner marked, failures annotated), each
  replica's span bars nested underneath, clock offsets measured and
  orphan spans flagged (``reader.assemble_trace``). ``<id>`` is a
  request id or a 32-hex trace id. ``--selftest`` verifies the
  assembly invariants on a synthetic frontend run.
- ``obs bench-trend [--dir D]`` — fold the repo's ``BENCH_r*.json``
  round journals into per-section metric trajectories, flagging moves
  against the prior round; partial/failed rounds (probe timeouts,
  backend init errors) summarize instead of erroring. Always exits 0.
- ``obs slo status|check <run> --slo SPEC`` — multi-window burn-rate
  evaluation of a stream against an SLO spec (observability/slo.py);
  ``check`` exits 1 on any breach — the canary/CI surface, like
  ``compare``. ``obs slo --selftest`` verifies the burn-rate math.
- ``obs export <run>``    — replay the stream into a metric registry and
  render Prometheus exposition text (what a live scrape of
  ``<train_dir>/metrics.prom`` would have seen).
- ``obs incidents <run>`` — list the flight recorder's incident bundles
  (observability/flightrec.py); ``obs incidents <run> <name|step>``
  shows one bundle's trigger detail and generated report.

Pointing ``summary``/``compare``/``trace``/``slo`` at a missing path or
a file that is not a telemetry stream exits 2 with a one-line actionable
message, never a traceback.

Deliberately torch-free: every subcommand is pure host-side file reading, so
`obs` answers in milliseconds on a login node with no accelerator runtime.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

from pytorch_distributed_nn_tpu_torch.observability import promexport, reader


def _read_checked(target: str) -> reader.RunStream:
    """``read_stream`` + the not-actually-a-stream guard: a path that
    exists but holds no manifest and no records (an empty file, a random
    JSON, a binary) gets an actionable one-liner (rc 2 upstream), never
    a confusing all-zero summary or a traceback."""
    rs = reader.read_stream(target)
    if rs.manifest is None and not rs.steps and not rs.events:
        raise FileNotFoundError(
            f"{rs.path}: not a telemetry stream (no manifest header and "
            "no step/event records) — pass a run dir holding "
            "telemetry.jsonl/serving.jsonl, or the stream file itself"
        )
    return rs


def _fmt_record(rec: dict) -> str:
    kind = rec.get("kind")
    if kind == "manifest":
        return (
            f"manifest run={rec.get('run_id')} schema={rec.get('schema')} "
            f"config={json.dumps(rec.get('config', {}), default=str)[:120]}"
        )
    if kind == "event":
        extra = {
            k: v for k, v in rec.items()
            if k not in ("kind", "type", "time", "step")
        }
        step = f" step={rec['step']}" if "step" in rec else ""
        return f"event {rec.get('type')}{step} {json.dumps(extra, default=str)}"
    # step records (and legacy kind-less ones)
    parts = [f"step={rec.get('step')}"]
    for k in ("loss", "acc1", "step_time", "data_time"):
        if k in rec:
            parts.append(f"{k}={rec[k]:.4f}")
    return "step " + " ".join(parts)


def cmd_summary(args) -> int:
    if args.selftest:
        return _selftest()
    if args.by_rank:
        merged = reader.merge_streams(reader.read_streams(args.run))
        summary = reader.summarize_by_rank(merged, skip=args.skip)
        if args.json:
            print(json.dumps(summary, indent=2, default=str))
        else:
            print(reader.render_by_rank(summary))
        return 0
    rs = _read_checked(args.run)
    summary = reader.summarize_run(rs, skip=args.skip)
    if args.json:
        print(json.dumps(summary, indent=2, default=str))
    else:
        print(reader.render_summary(summary, rs.manifest))
    return 0


def cmd_tail(args) -> int:
    path = reader.find_stream(args.run)
    deadline = (
        time.monotonic() + args.max_seconds
        if args.max_seconds is not None else None
    )
    follow = args.follow or args.max_seconds is not None
    with open(path) as f:
        if not args.from_start:
            # show trailing context (the whole command without --follow)
            tail = f.readlines()[-args.context:]
            for line in tail:
                _print_line(line)
        elif not follow:
            for line in f:
                _print_line(line)
        if not follow:
            return 0
        while True:
            line = f.readline()
            if line:
                if line.endswith("\n"):
                    _print_line(line)
                else:
                    # torn-tail contract: a partial line is a write in
                    # flight, not corruption — rewind and re-read whole
                    f.seek(f.tell() - len(line))
                    time.sleep(args.poll)
            else:
                if deadline is not None and time.monotonic() >= deadline:
                    return 0
                time.sleep(args.poll)


def _print_line(line: str) -> None:
    line = line.strip()
    if not line:
        return
    try:
        print(_fmt_record(json.loads(line)))
    except ValueError:
        print(f"<torn line: {line[:80]!r}>")


def cmd_compare(args) -> int:
    rs_a = _read_checked(args.baseline)
    rs_b = _read_checked(args.candidate)
    if args.by_version:
        # the canary promotion gate: serving percentiles split per
        # artifact identity; version-less (v1) streams skip cleanly
        lines, regressions = reader.compare_by_version(
            rs_a, rs_b, threshold=args.threshold
        )
        print("\n".join(lines))
        return 1 if regressions else 0
    sa = reader.summarize_run(rs_a, skip=args.skip)
    sb = reader.summarize_run(rs_b, skip=args.skip)
    lines, regressions = reader.compare_runs(sa, sb,
                                             threshold=args.threshold)
    print("\n".join(lines))
    return 1 if regressions else 0


def cmd_trace(args) -> int:
    from pytorch_distributed_nn_tpu_torch.observability import tracing

    if args.selftest:
        return _trace_selftest()
    if args.run is None or args.request_id is None:
        print("obs: trace requires a run and a trace/request id "
              "(obs trace <run> <id>, or --selftest)", file=sys.stderr)
        return 2
    # discovery, not find_stream: ANY directory holding streams works —
    # a frontend run dir (frontend serving.jsonl + r<k>/serve/ replica
    # streams), a single serve dir, a sweep dir, or the file itself
    streams = reader.load_trace_streams(args.run)
    try:
        asm = reader.assemble_trace(args.run, args.request_id,
                                    streams=streams)
    except FileNotFoundError:
        carrying = sum(
            1 for rs in streams for r in rs.steps if r.get("request_id")
        )
        print(
            f"obs: no trace or request {args.request_id!r} in "
            f"{len(streams)} stream(s) under {args.run} ({carrying} "
            "record(s) carry request ids"
            + ("" if carrying else
               " — streams predate request tracing, schema v1")
            + ")",
            file=sys.stderr,
        )
        return 2
    if args.json:
        print(json.dumps(asm, indent=2, default=str))
        return 0
    entries = asm.get("records") or []
    if (asm.get("frontend") is None and len(entries) == 1
            and not asm.get("orphans")):
        # one record, no cross-process structure: the familiar
        # single-request waterfall (pre-tracing streams included)
        print(tracing.render_trace(entries[0]["record"]))
        return 0
    print(tracing.render_assembled_trace(asm))
    return 0


def _recover_bench_sections(tail: str) -> dict:
    """Best-effort section recovery from a TORN bench tail: the result
    line can be longer than the journal's tail window, so its head
    (``{"metric": ...``) is often cut off while whole per-section
    objects survive. Scan for ``"name": {...}`` fragments with balanced
    braces and parse each independently — partial data beats none in a
    trend table."""
    import re

    out = {}
    pos = 0
    for m in re.finditer(r'"([A-Za-z0-9_]+)":\s*\{', tail):
        if m.start() < pos:
            continue  # inside a fragment already consumed
        start = m.end() - 1
        depth = 0
        end = -1
        for i in range(start, len(tail)):
            if tail[i] == "{":
                depth += 1
            elif tail[i] == "}":
                depth -= 1
                if depth == 0:
                    end = i + 1
                    break
        if end < 0:
            continue
        try:
            obj = json.loads(tail[start:end])
        except ValueError:
            continue
        if isinstance(obj, dict) and obj:
            out[m.group(1)] = obj
            pos = end
    return out


def cmd_bench_trend(args) -> int:
    """Fold the repo's ``BENCH_r*.json`` round journals into one
    per-section trajectory table. Diagnostic, not a gate: partial and
    failed rounds are summarized (probe timeouts, backend init
    failures), never a nonzero exit."""
    paths = sorted(
        __import__("glob").glob(os.path.join(args.dir, "BENCH_r*.json"))
    )
    if not paths:
        print(f"obs: no BENCH_r*.json under {args.dir}")
        return 0
    rounds = []
    for p in paths:
        name = os.path.basename(p)[len("BENCH_"):-len(".json")]
        entry = {"round": name, "rc": None, "outcome": "unreadable",
                 "parsed": None}
        try:
            with open(p) as f:
                doc = json.load(f)
        except (ValueError, OSError) as e:
            entry["outcome"] = f"unreadable ({e})"
            rounds.append(entry)
            continue
        entry["rc"] = doc.get("rc")
        tail = doc.get("tail") or ""
        parsed = doc.get("parsed")
        if parsed is None:
            # a round can exit 0 with the result line buried in the
            # tail (harness missed it): recover the last JSON line
            for line in reversed(tail.splitlines()):
                line = line.strip()
                if line.startswith("{"):
                    try:
                        parsed = json.loads(line)
                        break
                    except ValueError:
                        continue
        recovered = False
        if not isinstance(parsed, dict):
            # the result line was longer than the tail window: its head
            # is gone, but whole sections usually survive — fold what
            # parses
            sections = _recover_bench_sections(tail)
            parsed = {"extra": sections} if sections else None
            recovered = bool(sections)
        entry["parsed"] = parsed if isinstance(parsed, dict) else None
        if "accelerator backend unavailable" in tail \
                or "probe timed out" in tail:
            entry["outcome"] = "probe-timeout"
        elif "Unable to initialize backend" in tail:
            entry["outcome"] = "backend-init-failed"
        elif recovered:
            entry["outcome"] = f"partial (rc={doc.get('rc')})"
        elif entry["parsed"] is not None:
            entry["outcome"] = "ok" if doc.get("rc") == 0 else (
                f"ok-but-rc={doc.get('rc')}"
            )
        else:
            entry["outcome"] = f"no-result (rc={doc.get('rc')})"
        rounds.append(entry)

    print(f"bench trend over {len(rounds)} round(s) under {args.dir}:")
    print(f"  {'round':<6} {'rc':>3}  {'outcome':<20} "
          f"{'headline':<42} {'vs_baseline':>11}")
    for r in rounds:
        parsed = r["parsed"] or {}
        head = "-"
        if parsed.get("metric") is not None:
            head = (f"{parsed['metric']} = {parsed.get('value')} "
                    f"{parsed.get('unit') or ''}").strip()
        vsb = parsed.get("vs_baseline")
        print(f"  {r['round']:<6} "
              f"{r['rc'] if r['rc'] is not None else '-':>3}  "
              f"{r['outcome']:<20} {head:<42} "
              f"{vsb if vsb is not None else '-':>11}")

    # per-section metric trajectories: flatten each round's extra block
    # to dotted scalar keys, then one row per metric across rounds
    def flatten(obj, prefix="", depth=0, out=None):
        if out is None:
            out = {}
        if isinstance(obj, dict) and depth < 3:
            for k, v in obj.items():
                key = f"{prefix}.{k}" if prefix else str(k)
                flatten(v, key, depth + 1, out)
        elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
            out[prefix] = float(obj)
        return out

    flat = {
        r["round"]: flatten((r["parsed"] or {}).get("extra") or {})
        for r in rounds
    }
    names = sorted({k for d in flat.values() for k in d})
    if not names:
        print("  (no round carries a per-section extra block)")
        return 0
    cols = [r["round"] for r in rounds]
    regressions = 0
    by_section = {}
    for name in names:
        by_section.setdefault(name.split(".", 1)[0], []).append(name)
    for section in sorted(by_section):
        print(f"  section {section}:")
        print("    " + f"{'metric':<34}"
              + "".join(f"{c:>12}" for c in cols))
        for name in by_section[section]:
            vals = [flat[c].get(name) for c in cols]
            cells, prev, flagged = [], None, False
            # direction heuristic: throughput-like names regress when
            # they DROP, latency-like when they RISE; ambiguous names
            # are shown but never flagged
            low = name.lower()
            direction = None
            if any(t in low for t in ("per_sec", "per_s", "speedup")):
                direction = "higher"
            elif low.endswith("_ms") or "ms_" in low.rsplit(".", 1)[-1]:
                direction = "lower"
            for v in vals:
                if v is None:
                    cells.append(f"{'-':>12}")
                    continue
                mark = ""
                if prev is not None and direction is not None and prev:
                    delta = v / prev - 1.0
                    worse = (delta < -args.threshold
                             if direction == "higher"
                             else delta > args.threshold)
                    if worse:
                        mark = "!"
                        flagged = True
                cells.append(f"{v:>11g}{mark or ' '}")
                prev = v
            short = name.split(".", 1)[1] if "." in name else name
            print(f"    {short:<34}" + "".join(cells))
            regressions += flagged
    if regressions:
        print(f"  {regressions} metric(s) regressed >"
              f"{args.threshold * 100:.0f}% vs their prior round (!)")
    return 0


def cmd_slo(args) -> int:
    from pytorch_distributed_nn_tpu_torch.observability import slo

    if args.selftest:
        return slo.selftest()
    if args.action is None or args.run is None:
        print("obs: slo requires an action and a run "
              "(obs slo status|check <run> --slo SPEC, or --selftest)",
              file=sys.stderr)
        return 2
    rs = _read_checked(args.run)
    spec = args.slo or (rs.manifest or {}).get("config", {}).get("slo")
    if not spec:
        print(
            "obs: no SLO spec — pass --slo (e.g. "
            "'lat_p99<25ms@60s,avail>99.5%@300s'); the stream's manifest "
            "carries none (serve run --slo stamps it)",
            file=sys.stderr,
        )
        return 2
    engine, status = slo.evaluate_stream(rs, spec,
                                         min_events=args.min_events)
    breached = engine.breached()
    if args.json:
        print(json.dumps({"status": status, "breached": breached},
                         indent=2, default=str))
    else:
        print(f"SLO evaluation of {rs.path}:")
        print(slo.render_status(status, breached))
    if args.action == "check":
        if breached:
            print(f"obs slo check: {len(breached)} objective(s) "
                  "breached", file=sys.stderr)
            return 1
        print("obs slo check: all objectives within budget",
              file=sys.stderr)
    return 0


def cmd_export(args) -> int:
    rs = reader.read_stream(args.run)
    registry = reader.replay_registry(rs)
    text = promexport.render(registry)
    if args.out:
        parent = os.path.dirname(args.out)
        if parent:
            os.makedirs(parent, exist_ok=True)
        tmp = args.out + ".tmp"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, args.out)
        print(f"wrote {args.out}")
    else:
        sys.stdout.write(text)
    return 0


def cmd_incidents(args) -> int:
    from pytorch_distributed_nn_tpu_torch.observability import flightrec

    if not os.path.isdir(args.run):
        raise FileNotFoundError(f"{args.run}: no such directory")
    if args.which:
        entry = flightrec.find_incident(args.run, args.which)
        if entry is None:
            print(f"obs: no incident {args.which!r} under {args.run} "
                  f"(have: {[e['name'] for e in flightrec.list_incidents(args.run)]})",
                  file=sys.stderr)
            return 2
        if args.json:
            with open(os.path.join(entry["path"], "incident.json")) as f:
                print(f.read())
            return 0
        print(f"incident {entry['name']} — {entry.get('kind')} @ step "
              f"{entry.get('step')}")
        print(f"  reason: {entry.get('reason')}")
        print(f"  bundle: {entry['path']}")
        print(f"  ring records: {entry.get('events')}  "
              f"trace: {'yes' if entry['has_trace'] else 'no'}  "
              f"report: {'yes' if entry['has_report'] else 'no'}")
        report = os.path.join(entry["path"], "report.md")
        if os.path.isfile(report):
            print()
            with open(report) as f:
                sys.stdout.write(f.read())
        return 0
    entries = flightrec.list_incidents(args.run)
    if args.json:
        print(json.dumps(entries, indent=2, default=str))
        return 0
    if not entries:
        print(f"no incidents under {args.run} "
              f"({flightrec.INCIDENT_DIRNAME}/ empty or absent)")
        return 0
    print(f"{len(entries)} incident(s) under "
          f"{flightrec.incidents_dir(args.run)}:")
    print(f"  {'name':<28} {'kind':<16} {'step':>6} "
          f"{'ring':>5} trace report")
    for e in entries:
        print(
            f"  {e['name']:<28} {str(e.get('kind')):<16} "
            f"{str(e.get('step')):>6} {e.get('events', 0):>5} "
            f"{'yes' if e['has_trace'] else ' no':>5} "
            f"{'yes' if e['has_report'] else ' no':>6}"
            + (f"  [{e['error']}]" if e.get("error") else "")
        )
    return 0


# ---------------------------------------------------------------------------
# Selftest: build a synthetic run, verify the invariants
# ---------------------------------------------------------------------------


def _selftest() -> int:
    checks = []

    def check(name, ok, detail=""):
        checks.append((name, ok, detail))

    with tempfile.TemporaryDirectory(prefix="pdtn_obs_selftest_") as d:
        run_a = os.path.join(d, "a")
        run_b = os.path.join(d, "b")
        os.makedirs(run_a)
        os.makedirs(run_b)
        reader.write_synthetic_run(run_a, steps=60, step_time=0.01)
        # candidate with a 2x step-time regression: compare must catch it
        reader.write_synthetic_run(run_b, steps=60, step_time=0.02)

        from pytorch_distributed_nn_tpu_torch.observability.core import (
            SCHEMA_VERSION,
        )

        rs = reader.read_stream(run_a)
        with open(rs.path) as f:
            first = json.loads(f.readline())
        check("manifest is the first record",
              first.get("kind") == "manifest" and "run_id" in first
              and first.get("schema") == SCHEMA_VERSION,
              f"kind={first.get('kind')}")
        check("all step records parsed", len(rs.steps) == 60,
              f"{len(rs.steps)} steps")

        s = reader.summarize_run(rs)
        p50 = s["phases"]["step"]["p50"]
        check("step p50 within jitter of the synthetic value",
              0.009 <= p50 <= 0.011, f"p50={p50:.5f}")
        check("event counts match what was written",
              s["events"].get("retry") == 1
              and s["events"].get("straggler_drop") == 1
              and s["events"].get("checkpoint_write") == 2
              and s["events"].get("eval_result") == 2,
              f"events={s['events']}")
        check("accuracy-vs-step section populated",
              len(s["evals"]) == 2 and s["evals"][-1]["step"] == 60,
              f"evals={s['evals']}")
        io = s.get("io_stall") or {}
        check("I/O-stall section carries loop-stall percentiles",
              io.get("checkpoint_writes") == 2
              and io.get("async_writes") == 2
              and (io.get("stall_ms") or {}).get("count") == 2
              and 0 < io["stall_ms"]["p99"] < io["write_ms"]["p50"],
              f"io_stall={io}")
        iw = s["phases"].get("input_wait") or {}
        check("input-wait phase percentiles populated from step records",
              iw.get("count") == 59
              and 0 < iw.get("p50", 0) <= iw.get("p99", 0)
              and s["events"].get("input_wait") == 1,
              f"input_wait={iw}, events={s['events']}")

        text = promexport.render(reader.replay_registry(rs))
        errors = promexport.validate_exposition(text)
        check("exposition format valid", not errors,
              "; ".join(errors[:3]))
        check("exposition carries the event counters",
              'pdtn_events_total{type="retry"} 1' in text,
              "missing retry counter sample")

        # efficiency invariants (docs/observability.md "Efficiency"):
        # the synthetic cost (2e8 FLOP @ 1e11 peak, 10 ms steps) must
        # derive MFU ~0.20, export the pdtn_mfu family, regress when step
        # time doubles, and be cleanly ABSENT from pre-efficiency streams
        eff = s.get("efficiency") or {}
        mfu = (eff.get("mfu") or {}).get("overall", 0.0)
        check("efficiency section derives MFU from the manifest cost",
              0.15 <= mfu <= 0.25 and eff.get("flops_per_step") == 2e8
              and (eff.get("cost_gap_pct") is not None),
              f"efficiency={eff}")
        check("exposition carries the pdtn_mfu / bandwidth gauges",
              "pdtn_mfu " in text and "pdtn_hbm_util " in text
              and "pdtn_ici_bytes_per_s " in text,
              "missing efficiency gauge samples")
        old = os.path.join(d, "old")
        os.makedirs(old)
        reader.write_synthetic_run(old, steps=30, step_time=0.01,
                                   with_cost=False)
        s_old = reader.summarize_run(reader.read_stream(old))
        old_lines, old_regs = reader.compare_runs(s_old, s, threshold=0.2)
        check("pre-efficiency stream skips the section + compare row",
              s_old.get("efficiency") is None
              and not any(r["metric"] == "mfu" for r in old_regs)
              and not any(
                  ln.lstrip().startswith("mfu") for ln in old_lines
              ),
              f"old efficiency={s_old.get('efficiency')}")

        _, same = reader.compare_runs(s, s)
        check("self-compare reports no regression", not same, str(same))
        sb = reader.summarize_run(reader.read_stream(run_b))
        _, regs = reader.compare_runs(s, sb, threshold=0.2)
        check("2x step-time regression detected",
              any("step p50" in r["metric"] for r in regs),
              f"regressions={[r['metric'] for r in regs]}")
        check("2x step-time regression also convicts MFU",
              any(r["metric"] == "mfu" for r in regs),
              f"regressions={[r['metric'] for r in regs]}")

        # cross-rank merge: a 2-rank family with 5s wall skew must align
        # to sub-step accuracy and attribute the planted straggler
        pod = os.path.join(d, "pod")
        os.makedirs(pod)
        reader.write_synthetic_pod(pod, ranks=2, steps=40,
                                   clock_skew=5.0, straggler_rank=1)
        merged = reader.merge_streams(reader.read_streams(pod))
        off = merged.clock_offsets.get(1, 0.0)
        # the fixture's rank-1 monotonic epoch trails rank 0's by 77.7s
        # (write_synthetic_pod); the estimator must recover it from the
        # shared per-step completion instants alone
        check("clock offset recovered from step co-occurrence",
              abs(off - 77.7) < 0.05, f"offset={off:.4f}s")
        br = reader.summarize_by_rank(merged)
        sk = (br.get("skew") or {}).get("p95", 1e9)
        check("aligned cross-rank skew collapses to sub-step",
              sk < 0.05, f"p95 skew={sk:.4f}s")
        check("straggler attribution names the planted rank",
              br["straggler"]["dropped_by_rank"].get(1, 0) == 4
              and br["straggler"]["slowest_by_rank"].get(1, 0) == 40,
              f"straggler={br['straggler']}")

        # serving-stream invariants (docs/serving.md): request records
        # summarize into the serving section, the metric family exports,
        # regressions are caught, and its ABSENCE from training streams
        # never false-fails a compare
        srv_a = os.path.join(d, "srv_a")
        srv_b = os.path.join(d, "srv_b")
        os.makedirs(srv_a)
        os.makedirs(srv_b)
        reader.write_synthetic_serving_run(srv_a, requests=150,
                                           latency_ms=5.0)
        reader.write_synthetic_serving_run(srv_b, requests=150,
                                           latency_ms=10.0)
        rs_srv = reader.read_stream(srv_a)
        ssrv = reader.summarize_run(rs_srv)
        sv = ssrv.get("serving") or {}
        check("serving section carries request percentiles",
              sv.get("requests") == 150 and sv.get("dropped") == 2
              and 4.0 <= (sv.get("latency_ms") or {}).get("p50", 0) <= 6.0
              and 900 <= (sv.get("req_rate") or 0) <= 1100,
              f"serving={sv}")
        srv_text = promexport.render(reader.replay_registry(rs_srv))
        check("serving metrics export as the pdtn_serving_* family",
              "pdtn_serving_latency_seconds_count 150" in srv_text
              and 'pdtn_events_total{type="request_dropped"} 2' in srv_text
              and not promexport.validate_exposition(srv_text),
              "missing serving samples or invalid exposition")
        train_lines, _ = reader.compare_runs(s, sb, threshold=1e9)
        check("training-only compare never shows serving rows",
              not any("serve" in ln for ln in train_lines))
        _, srv_regs = reader.compare_runs(
            ssrv, reader.summarize_run(reader.read_stream(srv_b)),
            threshold=0.2,
        )
        check("2x serving-latency regression detected",
              any("serve lat p50" in r["metric"] for r in srv_regs),
              f"regressions={[r['metric'] for r in srv_regs]}")
        _, srv_same = reader.compare_runs(ssrv, ssrv)
        check("serving self-compare reports no regression", not srv_same,
              str(srv_same))

        # request-tracing invariants (docs/observability.md "Request
        # tracing"): span percentiles + slowest-requests attribution on
        # v2 streams, waterfall rendering, per-version gating, and the
        # schema-bump bidirectionality contract (v1 streams skip every
        # new section, never false-fail)
        spans = sv.get("spans") or {}
        check("serving summary carries per-span percentiles",
              set(spans) >= {"admit", "queue", "batch_form", "pad",
                             "infer", "respond"}
              and (spans.get("infer") or {}).get("count") == 150,
              f"spans={sorted(spans)}")
        slowest = sv.get("slowest") or []
        check("slowest-requests table attributes a dominant span",
              len(slowest) == 5 and all(r.get("dominant") for r in slowest)
              and slowest[0]["latency_ms"] >= slowest[-1]["latency_ms"],
              f"slowest={slowest[:2]}")
        from pytorch_distributed_nn_tpu_torch.observability import tracing
        waterfall = tracing.render_trace(
            tracing.find_request(rs_srv.steps,
                                 slowest[0]["request_id"]) or {}
        )
        check("obs trace renders the span waterfall",
              "infer" in waterfall and "#" in waterfall
              and str(slowest[0]["request_id"]) in waterfall,
              waterfall[:120])

        # per-version split: a canary stream where only v2 regressed
        can_a = os.path.join(d, "can_a")
        can_b = os.path.join(d, "can_b")
        os.makedirs(can_a)
        os.makedirs(can_b)
        reader.write_synthetic_serving_run(
            can_a, requests=200,
            versions={"model@100:none": 5.0, "model@200:none": 5.0},
        )
        reader.write_synthetic_serving_run(
            can_b, requests=200,
            versions={"model@100:none": 5.0, "model@200:none": 12.0},
        )
        _, ver_regs = reader.compare_by_version(
            reader.read_stream(can_a), reader.read_stream(can_b),
            threshold=0.2,
        )
        check("--by-version convicts only the regressed artifact",
              ver_regs
              and all("[model@200:none]" in r["metric"] for r in ver_regs),
              f"regressions={[r['metric'] for r in ver_regs]}")

        # v1 golden stream: pre-tracing records must summarize, export
        # and compare cleanly, with the new sections absent
        old_srv = os.path.join(d, "srv_v1")
        os.makedirs(old_srv)
        reader.write_synthetic_serving_run(old_srv, requests=150,
                                           latency_ms=5.0, v1=True)
        rs_v1 = reader.read_stream(old_srv)
        s_v1 = reader.summarize_run(rs_v1)
        sv_v1 = s_v1.get("serving") or {}
        check("v1 serving stream skips spans/slowest/versions sections",
              sv_v1.get("requests") == 150
              and sv_v1.get("spans") is None
              and sv_v1.get("slowest") is None
              and sv_v1.get("versions") is None,
              f"v1 serving={ {k: sv_v1.get(k) for k in ('spans', 'slowest', 'versions')} }")
        _, v1_regs = reader.compare_runs(ssrv, s_v1, threshold=0.2)
        v1_lines, v1_ver_regs = reader.compare_by_version(
            reader.read_stream(old_srv), reader.read_stream(old_srv),
            threshold=0.2,
        )
        check("v1 stream compares cleanly and --by-version skips it",
              not any(r["metric"] == "mfu" for r in v1_regs)
              and not v1_ver_regs
              and any("skipped" in ln for ln in v1_lines),
              f"v1 regs={v1_ver_regs} lines={v1_lines}")
        check("v1 exposition still validates",
              not promexport.validate_exposition(
                  promexport.render(reader.replay_registry(rs_v1))
              ))

    failed = [c for c in checks if not c[1]]
    for name, ok, detail in checks:
        mark = "PASS" if ok else "FAIL"
        print(f"  [{mark}] {name}" + (f" — {detail}" if detail and not ok
                                      else ""))
    print(f"obs selftest: {len(checks) - len(failed)}/{len(checks)} "
          "invariants held")
    return 1 if failed else 0


def _trace_selftest() -> int:
    """Distributed-tracing invariants over the synthetic frontend run
    (``reader.write_synthetic_frontend_run``): cross-process assembly,
    hedge-loser completeness, clock-offset recovery, orphan flagging,
    and the directory-discovery path of ``obs trace``. torch-free, <5 s."""
    from pytorch_distributed_nn_tpu_torch.observability import tracing

    checks = []

    def check(name, ok, detail=""):
        checks.append((name, ok, detail))

    with tempfile.TemporaryDirectory(prefix="pdtn_trace_selftest_") as d:
        fe = os.path.join(d, "serve")
        reader.write_synthetic_frontend_run(fe)
        streams = reader.load_trace_streams(fe)
        check("discovery finds frontend + both replica streams",
              len(streams) == 3,
              f"{[s.path for s in streams]}")

        asm = reader.assemble_trace(fe, "fe-000001", streams=streams)
        check("plain forward assembles one won attempt, no orphans",
              len(asm["attempts"]) == 1
              and asm["attempts"][0]["outcome"] == "won"
              and asm["attempts"][0]["replica_record"] is not None
              and not asm["orphans"],
              f"attempts={asm['attempts']}")

        hedged = reader.assemble_trace(fe, "fe-000002", streams=streams)
        losers = [a for a in hedged["attempts"]
                  if a["outcome"] == "discarded"]
        check("hedge loser's replica record assembles into the trace",
              len(hedged["attempts"]) == 2 and len(losers) == 1
              and losers[0]["replica_record"] is not None
              and losers[0]["replica_record"]["request_id"]
              == "fe-000002",
              f"attempts={[a.get('outcome') for a in hedged['attempts']]}")
        text = tracing.render_assembled_trace(hedged)
        check("waterfall renders competing branches, winner marked",
              "[WON]" in text and "[discarded]" in text
              and "hedge" in text and "hedged" in text,
              text[:200])
        off = hedged["clock_offsets"].get(
            os.path.join("r1", "serve", "serving.jsonl")
        )
        check("replica clock skew recovered from shared request ids",
              off is not None and abs(off - 120.5) < 0.2,
              f"offsets={hedged['clock_offsets']}")
        check("trace-id key resolves to the same request",
              reader.assemble_trace(
                  fe, hedged["trace"], streams=streams
              )["request_id"] == "fe-000002")

        retried = reader.assemble_trace(fe, "fe-000003", streams=streams)
        first = retried["attempts"][0]
        check("failed first attempt keeps its breaker annotation",
              first["outcome"] == "failed"
              and "breaker_open" in (first.get("annotations") or [])
              and retried["attempts"][1]["outcome"] == "won"
              and not retried["orphans"],
              f"attempts={retried['attempts']}")

        orphaned = reader.assemble_trace(fe, "fe-000004",
                                         streams=streams)
        check("planted orphan span is flagged, never dropped",
              len(orphaned["orphans"]) == 1
              and "not found" in tracing.render_assembled_trace(orphaned),
              f"orphans={orphaned['orphans']}")

        check("obs trace accepts the run DIRECTORY (discovery path)",
              main_obs(["trace", fe, "fe-000002"]) == 0)
        check("obs trace exits 2 on an unknown id",
              main_obs(["trace", fe, "no-such-request"]) == 2)

        # per-hop attribution rides the same hops the assembly joins
        hops = (reader.summarize_run(reader.read_stream(fe))
                .get("serving") or {}).get("hops") or {}
        check("summary per-hop attribution covers every attempt",
              hops.get("attempts") == 5 and hops.get("hedged") == 1
              and (hops.get("frontend_overhead_ms") or {}).get("count")
              == 3,
              f"hops={hops}")

        # pre-distributed-tracing stream (request ids but no trace
        # stamps): the request-id join degrades to the familiar
        # single-process waterfall through the SAME command — the
        # absent-family contract
        solo = os.path.join(d, "solo")
        os.makedirs(solo)
        reader.write_synthetic_serving_run(solo, requests=5)
        check("trace-less stream keeps the single-process waterfall",
              main_obs(["trace", solo, "synth00-000002"]) == 0)
        v1 = os.path.join(d, "v1")
        os.makedirs(v1)
        reader.write_synthetic_serving_run(v1, requests=5, v1=True)
        check("v1 stream (no ids at all) exits 2 with guidance",
              main_obs(["trace", v1, "synth00-000002"]) == 2)

    failed = [c for c in checks if not c[1]]
    for name, ok, detail in checks:
        mark = "PASS" if ok else "FAIL"
        print(f"  [{mark}] {name}" + (f" — {detail}" if detail and not ok
                                      else ""))
    print(f"obs trace selftest: {len(checks) - len(failed)}/{len(checks)} "
          "invariants held")
    return 1 if failed else 0


def main_obs(argv=None) -> int:
    """Telemetry inspection (docs/observability.md)."""
    p = argparse.ArgumentParser(
        "pdtn-obs", description=main_obs.__doc__
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser(
        "summary",
        help="per-phase percentiles, step-rate trend, event counts",
    )
    ps.add_argument("run", nargs="?", default=None,
                    help="run dir (containing telemetry.jsonl) or the "
                         "JSONL file itself")
    ps.add_argument("--json", action="store_true",
                    help="emit the summary as JSON")
    ps.add_argument("--skip", type=int, default=1,
                    help="drop the first N steps from timing stats "
                         "(compile step; default 1)")
    ps.add_argument("--by-rank", action="store_true",
                    help="merge the run's per-process stream family on "
                         "(step, rank) with clock-skew alignment; print "
                         "per-rank phase percentiles + straggler "
                         "attribution")
    ps.add_argument("--selftest", action="store_true",
                    help="build a synthetic run, summarize it, verify the "
                         "telemetry invariants (CI hook, <5s)")
    ps.set_defaults(fn=cmd_summary)

    pt = sub.add_parser(
        "tail",
        help="print a stream's tail; --follow keeps polling (tail -f)",
    )
    pt.add_argument("run")
    pt.add_argument("--follow", "-f", action="store_true",
                    help="keep polling the stream for new records "
                         "(without it, print the tail and exit)")
    pt.add_argument("--from-start", action="store_true",
                    help="print the whole stream (before following, "
                         "with --follow)")
    pt.add_argument("--context", type=int, default=10,
                    help="without --from-start: show this many trailing "
                         "records first")
    pt.add_argument("--poll", type=float, default=0.5,
                    help="--follow: poll period in seconds")
    pt.add_argument("--max-seconds", type=float, default=None,
                    help="stop following after this long (implies "
                         "--follow; default with --follow: forever)")
    pt.set_defaults(fn=cmd_tail)

    pc = sub.add_parser(
        "compare",
        help="regression deltas A -> B; exit 1 past --threshold (CI gate)",
    )
    pc.add_argument("baseline")
    pc.add_argument("candidate")
    pc.add_argument("--threshold", type=float, default=0.2,
                    help="fractional regression that fails the gate "
                         "(default 0.2 = 20%%)")
    pc.add_argument("--skip", type=int, default=1)
    pc.add_argument("--by-version", action="store_true",
                    help="split the serving percentile gate per artifact "
                         "version stamp (the canary promotion gate); "
                         "version-less v1 streams skip cleanly")
    pc.set_defaults(fn=cmd_compare)

    ptr = sub.add_parser(
        "trace",
        help="assemble one request's CROSS-PROCESS waterfall — "
             "frontend attempts (first/hedge/retry/probe, winner "
             "marked) with each replica's span bars nested under them",
    )
    ptr.add_argument("run", nargs="?", default=None,
                     help="any directory holding telemetry/serving/"
                          "sweep streams (searched recursively — a "
                          "frontend run dir with its replica subdirs "
                          "works), or one stream file")
    ptr.add_argument("request_id", nargs="?", default=None,
                     help="a request id (X-Request-Id echo) or a "
                          "32-hex trace id (X-Trace-Context)")
    ptr.add_argument("--json", action="store_true",
                     help="emit the assembled trace as JSON instead of "
                          "the waterfall")
    ptr.add_argument("--selftest", action="store_true",
                     help="verify the distributed-tracing invariants on "
                          "a synthetic frontend+2-replica run (hedge, "
                          "retry, skewed clock, planted orphan; <5 s)")
    ptr.set_defaults(fn=cmd_trace)

    pbt = sub.add_parser(
        "bench-trend",
        help="fold BENCH_r*.json round journals into per-section "
             "metric trajectories (diagnostic; always exits 0)",
    )
    pbt.add_argument("--dir", default=".",
                     help="directory holding BENCH_r*.json (default .)")
    pbt.add_argument("--threshold", type=float, default=0.1,
                     help="fractional move vs the prior round that "
                          "flags a metric (default 0.1 = 10%%)")
    pbt.set_defaults(fn=cmd_bench_trend)

    psl = sub.add_parser(
        "slo",
        help="evaluate a stream against an SLO spec; `check` exits 1 on "
             "breach (the canary/CI surface)",
    )
    psl.add_argument("action", nargs="?", choices=("status", "check"),
                     default=None)
    psl.add_argument("run", nargs="?", default=None,
                     help="serve dir (serving.jsonl) or stream file")
    psl.add_argument("--slo", default=None, metavar="SPEC",
                     help="objectives, e.g. "
                          "'lat_p99<25ms@60s,avail>99.5%%@300s' "
                          "(default: the spec stamped in the stream "
                          "manifest by `serve run --slo`)")
    psl.add_argument("--min-events", type=int, default=20,
                     help="window sample floor before a burn rate can "
                          "convict (default 20)")
    psl.add_argument("--json", action="store_true")
    psl.add_argument("--selftest", action="store_true",
                     help="verify the SLO layer's invariants (grammar "
                          "fail-fast, hand-checked burn windows, edge-"
                          "triggered breaches, gauge exposition; <2 s)")
    psl.set_defaults(fn=cmd_slo)

    pe = sub.add_parser(
        "export",
        help="replay the stream into Prometheus exposition text",
    )
    pe.add_argument("run")
    pe.add_argument("--out", default=None,
                    help="write here (atomic) instead of stdout")
    pe.set_defaults(fn=cmd_export)

    pi = sub.add_parser(
        "incidents",
        help="list/show the flight recorder's incident bundles "
             "(docs/observability.md)",
    )
    pi.add_argument("run", help="run dir (train_dir) holding incidents/")
    pi.add_argument("which", nargs="?", default=None,
                    help="bundle name (e.g. 40-step_regression) or step "
                         "number: show that incident's detail + report")
    pi.add_argument("--json", action="store_true")
    pi.set_defaults(fn=cmd_incidents)

    args = p.parse_args(argv)
    if args.cmd == "summary" and not args.selftest and args.run is None:
        p.error("summary requires a run dir/file (or --selftest)")
    try:
        return args.fn(args)
    except FileNotFoundError as e:
        print(f"obs: {e}", file=sys.stderr)
        return 2
    except KeyboardInterrupt:
        return 130


if __name__ == "__main__":
    sys.exit(main_obs())
