"""Deterministic, seeded fault injection: the port's copy of
``pytorch_distributed_nn_tpu/resilience/faults.py`` (the same grammar,
the same errors and the same ``fault_injected`` fields).

A :class:`FaultPlan` parsed from a spec string names which fault fires
at which step, so a failure scenario replays like a seed. Spec grammar
(comma-separated entries; steps are 1-indexed trainer steps)::

    spec    := entry ("," entry)*
    entry   := kind "@" step (":" arg)*
    kind    := "delay" | "crash" | "preempt" | "nan_grad" | "torn_ckpt"
             | "flaky_io" | "slow_infer" | "conn_reset" | "http_503"
    arg     := "p" RANK          (delay: which data-parallel rank; default all)
             | FLOAT "s"         (delay/slow_infer: seconds; default 1.0)
             | "x" COUNT         (serving kinds: consecutive requests the
                                  fault covers; default 1)

Where each kind fires:

- ``delay`` — :meth:`FaultPlan.pre_step` sleeps the host entering the
  step. The port runs one process per rank, so a ``delay@N:pK`` entry
  sleeps rank K only and the other ranks wait for it at the step's
  collectives: the step's wall time grows by the delay on every rank. An
  entry without a rank sleeps every rank. Every rank records the entry
  as fired. With the straggler simulator on (``--straggler-deadline``,
  :mod:`.stragglers`), the trainer calls ``pre_step(...,
  sleep_delays=False)``: the delay enters the step's simulated arrival
  times through :meth:`FaultPlan.delay_table`, nothing sleeps, and the
  event says ``simulated: true``.
- ``crash`` — ``pre_step`` raises :class:`InjectedCrash` entering the
  step; the trainer writes an emergency checkpoint of the completed step
  and re-raises.
- ``preempt`` — ``pre_step`` sends SIGTERM to the own process; the
  supervisor finishes the step, checkpoints and exits 0.
- ``nan_grad`` — :meth:`FaultPlan.poison_batch` sets the float leaves of
  the step's host batch (numpy arrays or CPU tensors, before the copy to
  the card) to NaN: the injection point of ``--skip-nonfinite``.
- ``torn_ckpt`` — the checkpoint writer truncates the step's published
  file (:meth:`FaultPlan.should_tear`); the CRC32 manifest convicts it
  and resume quarantines it.
- ``flaky_io`` — the checkpoint writer fails the step's first publish
  attempt with ``OSError`` (:meth:`FaultPlan.should_flake`); the retry
  absorbs it and emits ``retry``.
- ``slow_infer``, ``conn_reset``, ``http_503`` — serving kinds, keyed by
  request count (``kind@N`` fires at the N-th request, ``xCOUNT`` widens
  it), consumed by :mod:`..serving.faultinject`, never by the trainer.

Every fired fault emits a ``fault_injected`` event into the process's
telemetry, so a run's stream records which faults fired.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
import signal
import time
from typing import Optional, Sequence, Tuple

import numpy as np

from pytorch_distributed_nn_tpu_torch.observability.core import get_telemetry

log = logging.getLogger(__name__)

KINDS = ("delay", "crash", "preempt", "nan_grad", "torn_ckpt", "flaky_io",
         "slow_infer", "conn_reset", "http_503")

#: kinds keyed by REQUEST count (serving.faultinject), not trainer step
SERVING_KINDS = ("slow_infer", "conn_reset", "http_503")


def _emit_fault(kind: str, step: int, **fields) -> None:
    """Record a FIRED fault in the run's telemetry stream."""
    get_telemetry().emit("fault_injected", step=step, fault=kind, **fields)


_ENTRY_RE = re.compile(
    r"^(?P<kind>[a-z_0-9]+)@(?P<step>\d+)(?P<args>(?::[^:,]+)*)$"
)
_RANK_RE = re.compile(r"^p(\d+)$")
_SECS_RE = re.compile(r"^(\d+(?:\.\d+)?)s$")
_COUNT_RE = re.compile(r"^x(\d+)$")


class InjectedCrash(RuntimeError):
    """Raised by ``FaultPlan.pre_step`` for a ``crash@N`` entry."""


@dataclasses.dataclass(frozen=True)
class FaultEntry:
    kind: str
    step: int  # 1-indexed trainer step (serving kinds: request index)
    rank: Optional[int] = None  # delay: data-parallel rank (None = all)
    seconds: float = 1.0  # delay/slow_infer: seconds of added latency
    count: int = 1  # serving kinds: consecutive requests covered

    def __str__(self) -> str:
        s = f"{self.kind}@{self.step}"
        if self.kind == "delay":
            if self.rank is not None:
                s += f":p{self.rank}"
            s += f":{self.seconds:g}s"
        elif self.kind in SERVING_KINDS:
            if self.kind == "slow_infer":
                s += f":{self.seconds:g}s"
            if self.count != 1:
                s += f":x{self.count}"
        return s

    def covers(self, index: int) -> bool:
        """Serving kinds: whether this entry covers 1-indexed request
        ``index`` (``step <= index < step + count``)."""
        return self.step <= index < self.step + self.count


def _nanify(x, poisoned: list):
    """``x`` with its float leaves NaN (tuples, lists and dicts walked)."""
    import torch

    if isinstance(x, (tuple, list)):
        return type(x)(_nanify(v, poisoned) for v in x)
    if isinstance(x, dict):
        return {k: _nanify(v, poisoned) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        if x.is_floating_point():
            poisoned.append(True)
            return torch.full_like(x, float("nan"))
        return x
    arr = np.asarray(x)
    if np.issubdtype(arr.dtype, np.floating):
        poisoned.append(True)
        return np.full(arr.shape, np.nan, arr.dtype)
    return x


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable schedule of injected faults plus the hooks that fire
    them."""

    entries: Tuple[FaultEntry, ...] = ()
    seed: int = 0

    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "FaultPlan":
        entries = []
        for raw in spec.split(","):
            raw = raw.strip()
            if not raw:
                continue
            m = _ENTRY_RE.match(raw)
            if not m:
                raise ValueError(
                    f"bad fault entry {raw!r}: expected kind@step[:args] "
                    f"(kinds: {', '.join(KINDS)})"
                )
            kind, step = m.group("kind"), int(m.group("step"))
            if kind not in KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r} in {raw!r} "
                    f"(kinds: {', '.join(KINDS)})"
                )
            if step < 1:
                raise ValueError(f"{raw!r}: steps are 1-indexed")
            rank, seconds, count = None, 1.0, 1
            for arg in (a for a in m.group("args").split(":") if a):
                if rm := _RANK_RE.match(arg):
                    rank = int(rm.group(1))
                elif cm := _COUNT_RE.match(arg):
                    count = int(cm.group(1))
                elif sm := _SECS_RE.match(arg):
                    seconds = float(sm.group(1))
                else:
                    raise ValueError(
                        f"bad fault arg {arg!r} in {raw!r}: expected pRANK, "
                        "SECONDSs or xCOUNT (e.g. p3, 2.5s, x400)"
                    )
            if (rank is not None or seconds != 1.0) \
                    and kind not in ("delay", "slow_infer"):
                raise ValueError(
                    f"{raw!r}: rank/duration args only apply to delay and "
                    "slow_infer faults"
                )
            if rank is not None and kind == "slow_infer":
                raise ValueError(
                    f"{raw!r}: slow_infer has no ranks — it is keyed by "
                    "request count"
                )
            if count != 1 and kind not in SERVING_KINDS:
                raise ValueError(
                    f"{raw!r}: the xCOUNT arg only applies to serving "
                    f"faults ({', '.join(SERVING_KINDS)})"
                )
            if count < 1:
                raise ValueError(f"{raw!r}: xCOUNT must be >= 1")
            entries.append(FaultEntry(kind, step, rank, seconds, count))
        return cls(entries=tuple(entries), seed=seed)

    def describe(self) -> str:
        return ",".join(str(e) for e in self.entries) or "<empty>"

    def _at(self, kind: str, step: int):
        return [e for e in self.entries if e.kind == kind and e.step == step]

    # -- trainer hooks ------------------------------------------------------

    def pre_step(self, step: int, sleep_delays: bool = True,
                 rank: Optional[int] = None) -> None:
        """Trainer hook, called ENTERING 1-indexed ``step``. May sleep
        (delay: every rank for an entry without one, else rank ``rank``
        when it is the entry's; ``rank=None`` sleeps for every entry),
        raise (crash) or SIGTERM the own process (preempt)."""
        for e in self._at("delay", step):
            _emit_fault("delay", step, seconds=e.seconds, rank=e.rank,
                        simulated=not sleep_delays)
            if sleep_delays and (e.rank is None or rank is None
                                 or e.rank == rank):
                log.warning("fault: delay@%d — host sleeping %.3gs", step,
                            e.seconds)
                time.sleep(e.seconds)
        if self._at("preempt", step):
            log.warning("fault: preempt@%d — SIGTERM to self", step)
            _emit_fault("preempt", step)
            os.kill(os.getpid(), signal.SIGTERM)
        if self._at("crash", step):
            _emit_fault("crash", step)
            raise InjectedCrash(f"fault: crash@{step}")

    def poison_step(self, step: int) -> bool:
        """True when a ``nan_grad`` fault fires at this step."""
        return bool(self._at("nan_grad", step))

    def poison_batch(self, step: int, batch):
        """NaN-corrupt the float leaves of the host ``batch`` (numpy arrays
        or CPU tensors) for a nan_grad step; the batch unchanged on other
        steps. A batch without a float leaf raises (integer token ids
        cannot carry a NaN)."""
        if not self.poison_step(step):
            return batch
        poisoned: list = []
        out = _nanify(batch, poisoned)
        if not poisoned:
            raise ValueError(
                "nan_grad fault fired but the batch has no float leaves "
                "to poison (text batches are integer token ids)"
            )
        log.warning("fault: nan_grad@%d — batch float leaves set to NaN", step)
        _emit_fault("nan_grad", step)
        return out

    def should_tear(self, step: int) -> bool:
        """Checkpoint-layer hook: truncate the file written at this step
        after its atomic publish."""
        return bool(self._at("torn_ckpt", step))

    def should_flake(self, step: int) -> bool:
        """Checkpoint-layer hook: fail this step's FIRST publish attempt
        with a transient OSError (absorbed by the write's retry)."""
        return bool(self._at("flaky_io", step))

    # -- serving hooks (request-count keyed; serving.faultinject) -----------

    def has_serving_faults(self) -> bool:
        """True when any entry is a serving kind."""
        return any(e.kind in SERVING_KINDS for e in self.entries)

    def _serving_at(self, kind: str, index: int):
        return [e for e in self.entries
                if e.kind == kind and e.covers(index)]

    def serving_delay(self, index: int) -> float:
        """Seconds of injected latency covering 1-indexed request
        ``index`` (summed over overlapping ``slow_infer`` entries)."""
        return sum(e.seconds for e in self._serving_at("slow_infer", index))

    def should_conn_reset(self, index: int) -> bool:
        """HTTP-layer hook: drop request ``index``'s connection without a
        response."""
        return bool(self._serving_at("conn_reset", index))

    def should_503(self, index: int) -> bool:
        """HTTP-layer hook: answer request ``index`` with a 503."""
        return bool(self._serving_at("http_503", index))

    def delay_table(self) -> Tuple[Tuple[int, Optional[int], float], ...]:
        """``((step, rank_or_None, seconds), ...)`` of the delay entries:
        what a straggler simulator consumes."""
        return tuple(
            (e.step, e.rank, e.seconds)
            for e in self.entries
            if e.kind == "delay"
        )

    def max_rank_referenced(self) -> int:
        """Highest rank named by any delay entry (-1 if none), for
        validation against the data-parallel degree."""
        ranks = [e.rank for e in self.entries
                 if e.kind == "delay" and e.rank is not None]
        return max(ranks) if ranks else -1


def all_finite(tensors: Sequence[torch.Tensor]) -> bool:
    """Whether every element of every tensor is finite (one device read):
    the train step's non-finite-update guard."""
    import torch

    if not tensors:
        return True
    return bool(torch.stack([torch.isfinite(t).all() for t in tensors]).all())
