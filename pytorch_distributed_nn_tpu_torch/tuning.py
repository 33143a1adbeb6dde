"""Learning-rate sweep harness: the port's copy of the JAX package's
``tuning.py``.

Capability parity with the reference's grid-search tooling (reference:
src/tune.sh:1-36 + src/tiny_tuning_parser.py:1-27): run a short training job
per lr candidate and rank candidates by the mean loss over the final steps.
The reference launched a 17-process mpirun per candidate and regex-parsed
worker logs.

This module is a thin shim over the sweep runner
(:class:`~.experiments.runner.SweepRunner`): candidates run as isolated
spawned subprocesses under a bounded pool, every trial writes a
manifest-headed telemetry stream (a diverged candidate leaves
``nonfinite_skip`` evidence instead of a bare ``inf`` rank), and the whole
sweep is journaled in ``<sweep_dir>/sweep.jsonl`` — killed sweeps continue
with the same journal.

The reference's default candidate grid (src/tune.sh:8: 0.4 0.2 0.1 0.05
0.025 0.0125 0.00625) is kept as the default. The in-process sequential
loop runs when the caller passes an explicit ``device`` (the JAX
package's explicit ``devices``); otherwise the trials run on ``trial_device``
(None: the card) in their own processes.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
from typing import List, Optional, Sequence

from pytorch_distributed_nn_tpu_torch.training.config import TrainConfig

logger = logging.getLogger(__name__)

DEFAULT_CANDIDATES = (0.4, 0.2, 0.1, 0.05, 0.025, 0.0125, 0.00625)


@dataclasses.dataclass
class TrialResult:
    lr: float
    final_loss: float  # mean loss over the trailing window
    history: list


def lr_sweep(
    base_config: TrainConfig,
    candidates: Sequence[float] = DEFAULT_CANDIDATES,
    steps: int = 100,
    tail: int = 10,
    device=None,
    sweep_dir: Optional[str] = None,
    concurrency: int = 2,
    trial_device: Optional[str] = None,
) -> List[TrialResult]:
    """Train `steps` steps per lr candidate; rank by trailing mean loss.

    Returns results sorted best-first. (reference: tune.sh runs 100 steps
    per candidate and averages the step-100 worker losses,
    tiny_tuning_parser.py:13-27.)

    Runs through the sweep runner: concurrent subprocess trials on
    ``trial_device`` (None: the card), journal under ``sweep_dir``
    (default ``<train_dir>/lr_sweep``), per-trial telemetry streams. A
    journal left by an interrupted sweep is resumed — completed
    candidates are not retrained. ``device`` runs the candidates in this
    process instead, one after another, on that device.
    """
    if device is not None:
        return _lr_sweep_inproc(base_config, candidates, steps, tail,
                                device)
    from pytorch_distributed_nn_tpu_torch.experiments import (
        journal as sweep_journal,
    )
    from pytorch_distributed_nn_tpu_torch.experiments.runner import (
        RunnerConfig,
        SweepRunner,
    )
    from pytorch_distributed_nn_tpu_torch.experiments.spec import SweepSpec
    from pytorch_distributed_nn_tpu_torch.observability import reader

    spec = SweepSpec.parse(
        "lr=" + ",".join(f"{float(c):g}" for c in candidates),
        sweep_seed=base_config.seed,
    )
    sdir = sweep_dir or os.path.join(base_config.train_dir, "lr_sweep")
    resume = os.path.isfile(sweep_journal.journal_path(sdir))
    runner = SweepRunner(
        spec, base_config,
        RunnerConfig(
            sweep_dir=sdir, max_steps=steps, tail=tail,
            concurrency=max(1, concurrency), scheduler="grid",
            retries=1, resume=resume, device=trial_device,
        ),
    )
    result = runner.run()
    trials = {t.index: t for t in spec.trials()}
    out: List[TrialResult] = []
    for row in result["leaderboard"]:
        lr = float(trials[row["trial"]].overrides["lr"])
        loss = row["loss"]
        final = float(loss) if loss is not None else math.inf
        if not math.isfinite(final):
            final = math.inf  # diverged trials rank last
        history: list = []
        try:
            rs = reader.read_stream(
                sweep_journal.trial_dir(sdir, row["trial"])
            )
            by_step = {r["step"]: r for r in rs.steps if "step" in r}
            history = [by_step[s] for s in sorted(by_step)]
        except FileNotFoundError:
            pass
        logger.info("lr %g -> final loss %.4f", lr, final)
        out.append(TrialResult(lr=lr, final_loss=final, history=history))
    return sorted(out, key=lambda r: r.final_loss)


def _lr_sweep_inproc(
    base_config: TrainConfig,
    candidates: Sequence[float],
    steps: int,
    tail: int,
    device,
) -> List[TrialResult]:
    """The sequential loop in this process (explicit ``device`` only)."""
    from pytorch_distributed_nn_tpu_torch.training.trainer import Trainer

    results = []
    for lr in candidates:
        cfg = dataclasses.replace(
            base_config, lr=lr, max_steps=steps, eval_freq=0, resume=False
        )
        trainer = Trainer(cfg, device=device)
        try:
            history = trainer.train()
        finally:
            trainer.close()
        window = history[-min(tail, len(history)):]
        final = sum(r["loss"] for r in window) / max(len(window), 1)
        if not math.isfinite(final):
            final = math.inf  # diverged trials rank last
        logger.info("lr %g -> final loss %.4f", lr, final)
        results.append(TrialResult(lr=lr, final_loss=final, history=history))
    return sorted(results, key=lambda r: r.final_loss)


def best_lr(
    base_config: TrainConfig,
    candidates: Sequence[float] = DEFAULT_CANDIDATES,
    steps: int = 100,
    device=None,
    trial_device: Optional[str] = None,
) -> float:
    return lr_sweep(base_config, candidates, steps, device=device,
                    trial_device=trial_device)[0].lr
