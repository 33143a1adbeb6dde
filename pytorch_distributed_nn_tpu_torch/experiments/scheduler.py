"""Sweep schedulers: full-grid baseline + ASHA-style successive halving
(the port's copy of the JAX package's ``experiments/scheduler.py``).

Successive halving (Li et al., "A System for Massively Parallel
Hyperparameter Tuning", MLSys 2020 — the ASHA paper, PAPERS.md) turns "run
every candidate to the full budget" into "run everyone a little, keep the
top 1/eta, triple their budget, repeat": the best configuration gets the
full budget while the grid's losers spend a small fraction of theirs.

This implementation is the RUNG-SYNCHRONIZED variant: a rung completes
before its promotions are computed. True ASHA promotes asynchronously
(first-come-first-promoted) which is deliberately racy; a rung barrier
costs a little wall-clock at small trial counts and buys the property the
journal contract requires — **promotions are a pure function of the
recorded rung results**, so an interrupted sweep re-derives exactly the
same decisions on ``--resume`` (test: promotion determinism in
tests/test_experiments.py).

Everything here is host-side arithmetic over plain dicts — no torch, no
subprocesses — so the scheduler invariants run in ``sweep --selftest``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class Rung:
    """One promotion rung.

    ``budget`` is the CUMULATIVE optimizer-step budget a trial has consumed
    once it completes this rung (trials continue across rungs through the
    checkpoint ``--resume`` path — promotion never retrains from scratch).
    ``keep`` is how many trials enter the rung.
    """

    index: int
    budget: int
    keep: int


def grid_rungs(n_trials: int, max_steps: int) -> List[Rung]:
    """The reference grid: every trial straight to the full budget."""
    _validate(n_trials, max_steps)
    return [Rung(index=0, budget=int(max_steps), keep=int(n_trials))]


def asha_rungs(
    n_trials: int,
    max_steps: int,
    eta: int = 3,
    min_steps: Optional[int] = None,
) -> List[Rung]:
    """Successive-halving rung ladder for ``n_trials`` candidates.

    Budgets grow geometrically by ``eta`` up to ``max_steps``; the entrant
    count shrinks by ``eta`` per rung (``ceil(n / eta^k)``). The rung count
    defaults to ``ceil(log_eta(n)) + 1`` — enough rungs that the ladder
    narrows to a single finalist — or follows ``min_steps`` (the first
    rung's budget) when given. Invariants (selftest-pinned): budgets
    strictly increasing, last budget == ``max_steps``, keeps non-
    increasing, first keep == ``n_trials``, last keep >= 1.
    """
    _validate(n_trials, max_steps)
    if eta < 2:
        raise ValueError(f"eta must be >= 2, got {eta}")
    if min_steps is not None:
        if not 1 <= min_steps <= max_steps:
            raise ValueError(
                f"min_steps must be in [1, max_steps], got {min_steps}"
            )
        levels = int(math.floor(
            math.log(max_steps / min_steps, eta)
        )) + 1 if min_steps < max_steps else 1
    else:
        levels = (
            int(math.ceil(math.log(n_trials, eta))) + 1
            if n_trials > 1 else 1
        )
    rungs: List[Rung] = []
    prev_budget = 0
    for k in range(levels):
        if k == levels - 1:
            budget = int(max_steps)
        elif min_steps is not None:
            # explicit floor: budgets grow geometrically FROM min_steps
            budget = min(int(max_steps), int(min_steps) * eta ** k)
        else:
            # derived: budgets divide geometrically DOWN from max_steps
            budget = max(
                1, int(math.ceil(max_steps / eta ** (levels - 1 - k)))
            )
        if budget <= prev_budget:  # tiny max_steps: collapse dup levels
            continue
        keep = max(1, int(math.ceil(n_trials / eta ** k)))
        rungs.append(Rung(index=len(rungs), budget=budget, keep=keep))
        prev_budget = budget
    # collapsed levels can leave keeps equal across rungs; re-monotonize
    for i in range(1, len(rungs)):
        if rungs[i].keep >= rungs[i - 1].keep and i > 0:
            rungs[i] = dataclasses.replace(
                rungs[i],
                keep=max(1, min(rungs[i].keep,
                                int(math.ceil(rungs[i - 1].keep / eta)))),
            )
    return rungs


def make_rungs(
    kind: str,
    n_trials: int,
    max_steps: int,
    eta: int = 3,
    min_steps: Optional[int] = None,
) -> List[Rung]:
    if kind == "grid":
        return grid_rungs(n_trials, max_steps)
    if kind == "asha":
        return asha_rungs(n_trials, max_steps, eta=eta, min_steps=min_steps)
    raise ValueError(f"unknown scheduler {kind!r} (grid | asha)")


def promote(results: Dict[int, float], keep: int) -> List[int]:
    """The top ``keep`` trials of a rung, deterministically.

    Finite losses rank first (ascending), non-finite (diverged) trials
    last; ties break on trial index. Pure function of ``results`` — the
    promotion-determinism contract ``--resume`` relies on.
    """
    if keep < 0:
        raise ValueError(f"keep must be >= 0, got {keep}")
    ranked = sorted(
        results.items(),
        key=lambda kv: (
            not _finite(kv[1]),  # finite first
            kv[1] if _finite(kv[1]) else 0.0,
            kv[0],
        ),
    )
    return [idx for idx, _ in ranked[:keep]]


def planned_steps(rungs: Sequence[Rung]) -> int:
    """Total optimizer steps the ladder schedules (the budget math the
    acceptance criterion measures: ASHA's plan must be <= 50% of the
    grid's for the default lr sweep). Incremental per rung: a promoted
    trial resumes from its previous rung's checkpoint, so rung ``k``
    charges ``keep_k * (budget_k - budget_{k-1})``."""
    total, prev = 0, 0
    for r in rungs:
        total += r.keep * (r.budget - prev)
        prev = r.budget
    return total


def _finite(v: float) -> bool:
    try:
        return math.isfinite(float(v))
    except (TypeError, ValueError):
        return False


def _validate(n_trials: int, max_steps: int) -> None:
    if n_trials < 1:
        raise ValueError(f"n_trials must be >= 1, got {n_trials}")
    if max_steps < 1:
        raise ValueError(f"max_steps must be >= 1, got {max_steps}")
