"""The port's ``sweep_resume`` chaos scenario on the CPU, at the JAX
suite's size (12 LeNet trials, 3 at a time, a ``sweep run`` subprocess
SIGTERMed and resumed): it exits 0 with every invariant of the JAX
scenario held, under the JAX check names, in order."""

from torch_chaos_cli import run_chaos
import torch_cpu  # noqa: F401  (one intra-op thread)

CHECKS = [
    "reference sweep: 12/12 trials completed",
    "sweep killed mid-flight (completed + in-flight + queued mix)",
    "journal survives the kill (manifest-first, torn tail at worst)",
    "cli sweep resume finishes the sweep (rc 0)",
    "completed trials were not re-run on resume",
    "pre-kill completed results byte-identical to the reference",
    "final leaderboard identical to an uninterrupted run",
    "in-flight trial resumed from its last valid checkpoint",
]


def test_sweep_resume_holds_every_invariant(tmp_path, capsys):
    rc, held, failed = run_chaos("sweep_resume", tmp_path, capsys)
    assert (rc, failed) == (0, [])
    assert held == CHECKS
