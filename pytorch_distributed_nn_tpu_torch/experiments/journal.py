"""The sweep journal: crash-safe record of everything the sweep decided
(the port's copy of the JAX package's ``experiments/journal.py``: the
same file, events and fields, so either package folds the other's).

``<sweep_dir>/sweep.jsonl`` is a manifest-headed append-only JSONL stream —
exactly the observability stream contract (observability/core.TelemetrySink):
the first record is a manifest carrying the full sweep identity (spec
string, base config, scheduler, runner knobs), every orchestration decision
is a typed event (``trial_start`` / ``trial_end`` / ``retry`` /
``nonfinite_skip`` / ``preempt``; fleet sweeps add ``host_join`` /
``host_dead`` / ``trial_migrate`` — experiments/fleet/), a crash leaves a
valid prefix plus at most one torn tail line, and a resumed sweep appends
a fresh manifest to the same stream. ``observability.reader.read_stream``
parses it unchanged.

Journal-first discipline: a ``trial_start`` is appended BEFORE its
subprocess spawns and a ``trial_end`` after its stream has been read back,
so ``--resume`` can always classify every trial:

- has a completed ``trial_end`` at its final rung -> done, never re-run
  (its recorded metrics are reused verbatim — byte-identical results);
- has a ``trial_start`` without an end -> was in flight; re-queued with
  ``resume=True`` so the trainer continues from its last valid checkpoint;
- never started -> queued normally.

:func:`load_journal` folds the event stream into that per-trial state; the
fold is pure, so schedulers re-derive identical promotion decisions from
an interrupted journal (docs/experiments.md "Resume contract").
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

from pytorch_distributed_nn_tpu_torch.observability.core import (
    Telemetry,
    run_manifest,
)

SWEEP_BASENAME = "sweep.jsonl"
TRIALS_SUBDIR = "trials"

#: ``trial_end`` statuses (docs/experiments.md failure table)
STATUS_COMPLETED = "completed"
STATUS_CRASHED = "crashed"  # nonzero exit code
STATUS_TIMEOUT = "timeout"  # exceeded --trial-timeout, terminated
STATUS_INCOMPLETE = "incomplete"  # rc 0 but stream short of the budget


def journal_path(sweep_dir: str) -> str:
    return os.path.join(sweep_dir, SWEEP_BASENAME)


def trial_dir(sweep_dir: str, index: int) -> str:
    return os.path.join(sweep_dir, TRIALS_SUBDIR, f"{int(index):04d}")


def open_journal(
    sweep_dir: str,
    spec_desc: str,
    base_config: Optional[dict],
    sweep_meta: dict,
    resumed: bool = False,
) -> Telemetry:
    """Open (append) the journal stream; the manifest written here is the
    header on a fresh sweep and a restart marker on ``--resume`` — the
    same contract a trainer stream keeps."""
    os.makedirs(os.path.join(sweep_dir, TRIALS_SUBDIR), exist_ok=True)
    manifest = run_manifest(
        config=base_config,
        sweep=dict(sweep_meta, spec=spec_desc, resumed=resumed),
    )
    return Telemetry.for_run(journal_path(sweep_dir), manifest)


# ---------------------------------------------------------------------------
# Folding the stream back into per-trial state
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrialState:
    """Everything the journal knows about one trial."""

    index: int
    starts: int = 0  # trial_start events (attempts across all rungs)
    #: rung -> the COMPLETED trial_end record for that rung
    rungs: Dict[int, dict] = dataclasses.field(default_factory=dict)
    last_start: Optional[dict] = None
    last_end: Optional[dict] = None  # last trial_end of any status
    #: fleet (experiments/fleet/): trial_migrate events folded in — how
    #: many times this trial was re-dispatched off a dead host — and the
    #: host named by its most recent trial_start
    migrations: int = 0
    host: Optional[str] = None
    #: a trial_start with no trial_end after it (STREAM order, not clock
    #: order — journal lifetimes have unrelated monotonic epochs): the
    #: crash-interrupted shape --resume re-queues with resume=True
    in_flight: bool = False

    def completed_at(self, rung: int) -> Optional[dict]:
        return self.rungs.get(int(rung))

    @property
    def status(self) -> str:
        if self.in_flight:
            return "running"
        if self.last_end is not None:
            return str(self.last_end.get("status", "?"))
        return "running" if self.starts else "queued"


@dataclasses.dataclass
class JournalState:
    path: str
    manifest: Optional[dict]
    manifests: List[dict]
    trials: Dict[int, TrialState]
    events: List[dict]
    truncated: bool = False
    bad_lines: int = 0
    #: fleet host state folded from host_join/host_dead events:
    #: agent_id -> {"state": "alive"|"dead", "devices", "capacity",
    #: "labels", "addr", "joins", "reason"?}. Empty for single-host
    #: sweeps. A resumed fleet's fresh host_join flips a dead host back
    #: to alive (stream order — the fold IS the reconstruction
    #: `fleet run --resume` relies on when the orchestrator died).
    hosts: Dict[str, dict] = dataclasses.field(default_factory=dict)

    @property
    def sweep_meta(self) -> dict:
        return (self.manifest or {}).get("sweep") or {}

    @property
    def migrations(self) -> int:
        return sum(st.migrations for st in self.trials.values())

    @property
    def base_config(self) -> Optional[dict]:
        return (self.manifest or {}).get("config")

    def results_at(self, rung: int) -> Dict[int, float]:
        """trial index -> recorded loss for trials completed at ``rung``
        (the scheduler's promotion input; deterministic by construction)."""
        out = {}
        for idx, st in self.trials.items():
            rec = st.completed_at(rung)
            if rec is not None and rec.get("loss") is not None:
                out[idx] = float(rec["loss"])
        return out


def load_journal(sweep_dir: str) -> Optional[JournalState]:
    """Parse + fold ``sweep.jsonl``; None when no journal exists.

    Torn-tail tolerant via ``observability.reader.read_stream`` — a sweep
    killed mid-append loses at most its final line; every completed
    trial's record (and therefore its byte-exact metrics) survives.
    """
    from pytorch_distributed_nn_tpu_torch.observability import reader

    path = journal_path(sweep_dir)
    if not os.path.isfile(path):
        return None
    rs = reader.read_stream(path)
    trials: Dict[int, TrialState] = {}
    hosts: Dict[str, dict] = {}

    def state(idx: int) -> TrialState:
        return trials.setdefault(idx, TrialState(index=idx))

    for e in rs.events:
        etype = e.get("type")
        if etype == "host_join" and e.get("host") is not None:
            h = hosts.setdefault(str(e["host"]), {"joins": 0})
            h.update(
                state="alive",
                devices=e.get("devices"), capacity=e.get("capacity"),
                labels=e.get("labels"), addr=e.get("addr"),
            )
            h["joins"] += 1
            h.pop("reason", None)
            continue
        if etype == "host_dead" and e.get("host") is not None:
            h = hosts.setdefault(str(e["host"]), {"joins": 0})
            h["state"] = "dead"
            h["reason"] = e.get("reason")
            continue
        if e.get("trial") is None:
            continue
        idx = int(e["trial"])
        if etype == "trial_start":
            st = state(idx)
            st.starts += 1
            st.last_start = e
            st.in_flight = True
            if e.get("host") is not None:
                st.host = str(e["host"])
        elif etype == "trial_end":
            st = state(idx)
            st.last_end = e
            st.in_flight = False
            if e.get("status") == STATUS_COMPLETED:
                st.rungs[int(e.get("rung", 0))] = e
        elif etype == "trial_migrate":
            state(idx).migrations += 1
    return JournalState(
        path=path,
        manifest=rs.manifest,
        manifests=rs.manifests,
        trials=trials,
        events=rs.events,
        truncated=rs.truncated,
        bad_lines=rs.bad_lines,
        hosts=hosts,
    )
