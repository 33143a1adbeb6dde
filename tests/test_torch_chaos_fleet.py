"""The port's ``fleet_preempt`` chaos scenario on the CPU, at the JAX
suite's sizes, one case a file so that ``--dist loadfile``'s workers can
take them apart (``elastic``: ``test_torch_chaos_fleet_elastic.py``):
``synthetic`` runs 3 agents and a 12-trial ASHA sweep of the synthetic
trial main, one agent SIGKILLed mid-rung, and exits 0 with every
invariant of the JAX scenario held, under the JAX check names, in
order."""

import pytest

from torch_chaos_cli import run_chaos
import torch_cpu  # noqa: F401  (one intra-op thread)

CHECKS = {
    "synthetic": [
        "synthetic: agent SIGKILLed mid-rung, ASHA sweep completed, "
        "zero trials lost",
        "synthetic: host_dead journaled, trials migrated with retry "
        "budget untouched",
        "synthetic: ASHA leaderboard BYTE-identical to the "
        "uninterrupted run",
        "synthetic: every transition visible in obs summary "
        "(fleet section) and the journal",
        "synthetic: pdtn_fleet_* gauges published and valid",
    ],
}


@pytest.mark.parametrize("case", list(CHECKS))
def test_case_holds_every_invariant(case, tmp_path, capsys):
    rc, held, failed = run_chaos("fleet_preempt", tmp_path, capsys,
                                 cases=[case])
    assert (rc, failed) == (0, [])
    assert held == CHECKS[case]
