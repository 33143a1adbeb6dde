"""Sweep reporting: trial metrics from telemetry streams, leaderboards
(the port's copy of the JAX package's ``experiments/report.py``).

Every number here is sourced from a structured stream — the trial's
manifest-headed ``telemetry.jsonl`` read through ``observability.reader``
(trailing loss, step rate, MFU) or the sweep journal (status, attempts,
rung). Nothing parses a log line: the capability the reference faked with
``src/tiny_tuning_parser.py``'s regex over worker stdout is served by the
same reader that powers ``obs summary``, and ``obs summary <trial_dir>``
works unchanged on any trial directory.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

from pytorch_distributed_nn_tpu_torch.experiments.journal import (
    JournalState,
    trial_dir,
)


def trailing_loss(steps: List[dict], tail: int = 10) -> Optional[float]:
    """Mean loss over the trailing ``tail`` steps (the tune.sh ranking
    statistic). Records are deduped by step with the LATEST occurrence
    winning — a crash-resumed trial's stream replays the steps between its
    last checkpoint and the crash point, and bitwise resume makes the
    replayed values identical, so the dedupe keeps interrupted and
    uninterrupted trials byte-comparable. Non-finite means rank as +inf
    (diverged trials sort last, matching the legacy lr_sweep contract)."""
    by_step = {}
    for r in steps:
        if r.get("step") is not None and r.get("loss") is not None:
            by_step[int(r["step"])] = float(r["loss"])
    if not by_step:
        return None
    ordered = [by_step[s] for s in sorted(by_step)]
    window = ordered[-min(tail, len(ordered)):]
    mean = sum(window) / len(window)
    return mean if math.isfinite(mean) else math.inf


def trial_metrics(tdir: str, tail: int = 10) -> Optional[dict]:
    """loss / steps / step-rate / MFU for one trial directory, from its
    telemetry stream. None when the trial never opened a stream. ``mfu``
    comes from the ``step_cost`` the trainer stamps in the manifest (None
    without one: a synthetic trial)."""
    from pytorch_distributed_nn_tpu_torch.observability import reader

    try:
        rs = reader.read_stream(tdir)
    except FileNotFoundError:
        return None
    summary = reader.summarize_run(rs)
    loss = trailing_loss(rs.steps, tail=tail)
    eff = summary.get("efficiency") or {}
    mfu = (eff.get("mfu") or {}).get("overall")
    rate = summary.get("step_rate", {}).get("overall")
    max_step = max(
        (int(r["step"]) for r in rs.steps if r.get("step") is not None),
        default=0,
    )
    nonfinite = any(
        r.get("loss") is not None and not math.isfinite(float(r["loss"]))
        for r in rs.steps
    )
    return {
        "loss": loss,
        "steps": max_step,
        "step_rate": rate if rate == rate else None,  # NaN -> None
        "mfu": mfu,
        "nonfinite": nonfinite,
        "restarts": summary.get("restarts", 0),
        "truncated": rs.truncated,
        # where the LAST lifetime started (its manifest's start_step):
        # the runner charges an attempt only for steps it actually ran
        "attempt_start_step": int(
            (rs.manifests[-1].get("start_step") or 0)
            if rs.manifests else 0
        ),
    }


def leaderboard(
    sweep_dir: str, jstate: JournalState, tail: int = 10
) -> List[dict]:
    """Ranked rows, best first: completed trials by trailing loss (finite
    first, ties on index), then unfinished/failed trials by index."""
    rows = []
    for idx in sorted(jstate.trials):
        st = jstate.trials[idx]
        end = st.last_end or {}
        metrics = trial_metrics(trial_dir(sweep_dir, idx), tail=tail) or {}
        loss = metrics.get("loss")
        if loss is None and end.get("loss") is not None:
            loss = float(end["loss"])  # journal fallback (dir GC'd)
        rows.append({
            "trial": idx,
            "overrides": end.get("overrides")
            or (st.last_start or {}).get("overrides") or {},
            "status": st.status,
            "rung": end.get("rung"),
            "attempts": st.starts,
            "steps": metrics.get("steps") or end.get("steps") or 0,
            "loss": loss,
            "step_rate": metrics.get("step_rate"),
            "mfu": metrics.get("mfu"),
            "nonfinite": bool(metrics.get("nonfinite")),
        })

    def key(row):
        done = row["status"] == "completed"
        loss = row["loss"]
        finite = loss is not None and math.isfinite(loss)
        return (
            not done,
            not finite,
            loss if finite else 0.0,
            row["trial"],
        )

    return sorted(rows, key=key)


def _fmt(v, spec="{:.4f}", dash="-") -> str:
    if v is None:
        return dash
    if isinstance(v, float) and not math.isfinite(v):
        return "inf" if v > 0 else "-inf"
    return spec.format(v)


def _fmt_overrides(ov: Dict) -> str:
    return " ".join(
        f"{k}={v:g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in ov.items()
    ) or "-"


def render_leaderboard(rows: List[dict]) -> str:
    lines = [
        f"  {'rank':>4} {'trial':>5} {'config':<28} {'steps':>6} "
        f"{'loss':>9} {'steps/s':>8} {'mfu':>6}  status"
    ]
    for rank, row in enumerate(rows, 1):
        mfu = (
            f"{row['mfu'] * 100:5.1f}%" if row.get("mfu") is not None
            else "     -"
        )
        status = row["status"]
        if row.get("nonfinite"):
            status += " (nonfinite)"
        lines.append(
            f"  {rank:>4} {row['trial']:>5} "
            f"{_fmt_overrides(row['overrides']):<28.28} "
            f"{row['steps']:>6} {_fmt(row['loss'], '{:9.4f}'):>9} "
            f"{_fmt(row['step_rate'], '{:8.2f}'):>8} {mfu}  {status}"
        )
    return "\n".join(lines)


def render_fleet(jstate: JournalState) -> str:
    """The fleet half of ``cli fleet status``: host roster + migrations,
    reconstructed purely from the journal fold (the state `fleet run
    --resume` starts from when the orchestrator itself died)."""
    meta = jstate.sweep_meta.get("fleet") or {}
    lines = [
        f"fleet: transport {meta.get('transport', '?')} · "
        f"{len(jstate.hosts)} host(s) journaled · "
        f"{jstate.migrations} migration(s)"
    ]
    if jstate.hosts:
        lines.append(f"  {'host':<12} {'state':<6} {'devices':>7} "
                     f"{'capacity':>8}  addr")
        for hid in sorted(jstate.hosts):
            h = jstate.hosts[hid]
            lines.append(
                f"  {hid:<12} {h.get('state', '?'):<6} "
                f"{_fmt(h.get('devices'), '{:d}', '-'):>7} "
                f"{_fmt(h.get('capacity'), '{:d}', '-'):>8}  "
                f"{h.get('addr') or '-'}"
                + (f" ({h['reason']})" if h.get("reason") else "")
            )
    migrated = {
        idx: st for idx, st in sorted(jstate.trials.items())
        if st.migrations
    }
    for idx, st in migrated.items():
        lines.append(
            f"  trial {idx}: migrated {st.migrations}x, last host "
            f"{st.host or '-'}"
        )
    return "\n".join(lines)


def render_status(jstate: JournalState) -> str:
    """The ``cli sweep status`` view: journal-only, no stream reads."""
    meta = jstate.sweep_meta
    lines = [
        f"sweep {(jstate.manifest or {}).get('run_id', '?')}: "
        f"spec {meta.get('spec', '?')!r} · scheduler "
        f"{(meta.get('scheduler') or {}).get('kind', '?')} · "
        f"{len(jstate.trials)} trial(s) journaled"
    ]
    if len(jstate.manifests) > 1:
        lines.append(f"  resumed {len(jstate.manifests) - 1} time(s)")
    if jstate.truncated:
        lines.append("  torn tail line (killed mid-append; prefix intact)")
    counts: Dict[str, int] = {}
    for st in jstate.trials.values():
        counts[st.status] = counts.get(st.status, 0) + 1
    lines.append(
        "  " + " · ".join(f"{k}: {n}" for k, n in sorted(counts.items()))
    )
    lines.append(f"  {'trial':>5} {'status':<12} {'attempts':>8} "
                 f"{'rung':>4} {'steps':>6} {'loss':>9}")
    for idx in sorted(jstate.trials):
        st = jstate.trials[idx]
        end = st.last_end or {}
        lines.append(
            f"  {idx:>5} {st.status:<12} {st.starts:>8} "
            f"{_fmt(end.get('rung'), '{:d}', '-'):>4} "
            f"{_fmt(end.get('steps'), '{:d}', '-'):>6} "
            f"{_fmt(end.get('loss'), '{:9.4f}'):>9}"
        )
    return "\n".join(lines)
