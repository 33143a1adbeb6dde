"""experiments/ — resumable multi-trial sweep orchestration: the port's
copy of the JAX package's ``experiments/``.

The reference system's layer-5 tooling was an lr grid-search harness that
launched a 17-process mpirun per candidate and regex-parsed worker logs
(reference: src/tune.sh + src/tiny_tuning_parser.py). This package is that
layer on top of the port:

- :mod:`.spec`      — grid/random sweep specs over ``TrainConfig`` fields,
  per-trial seeds derived as ``SeedSequence((sweep_seed, index))``.
- :mod:`.journal`   — the crash-safe append-only ``sweep.jsonl`` journal:
  manifest-first, torn-tail-tolerant (the observability stream contract),
  folded back into per-trial state for ``--resume``.
- :mod:`.scheduler` — full-grid baseline plus an ASHA-style successive-
  halving rung scheduler; promotions are pure functions of the journal.
- :mod:`.runner`    — N trials as spawned subprocesses under a bounded
  pool, per-trial timeout + retry-with-backoff, every trial a
  ``--supervise``-style telemetry run of the port's trainer.
- :mod:`.report`    — ranked leaderboard (trailing loss / step rate / MFU
  pulled from the trial telemetry streams, never from logs).
- :mod:`.fleet`     — the same sweep over host agents on TCP: placement,
  leases, migration of a dead host's trials (``cli fleet``).

CLI surface: ``sweep run/status/report/resume`` (+ ``--selftest``),
``fleet agent/run/status/agents/drain`` (+ ``--selftest``);
``tune`` / :func:`~..tuning.lr_sweep` are thin shims over this runner.
Nothing here imports torch: only the trials do.
"""

from pytorch_distributed_nn_tpu_torch.experiments.journal import (  # noqa
    SWEEP_BASENAME,
    load_journal,
    trial_dir,
)
from pytorch_distributed_nn_tpu_torch.experiments.report import (  # noqa
    leaderboard,
    render_leaderboard,
)
from pytorch_distributed_nn_tpu_torch.experiments.runner import (  # noqa
    RunnerConfig,
    SweepInterrupted,
    SweepRunner,
)
from pytorch_distributed_nn_tpu_torch.experiments.scheduler import (  # noqa
    Rung,
    asha_rungs,
    grid_rungs,
    make_rungs,
    planned_steps,
    promote,
)
from pytorch_distributed_nn_tpu_torch.experiments.spec import (  # noqa
    DEFAULT_SPEC,
    SweepSpec,
    Trial,
    trial_seed,
)
