"""The port's ``fleet_preempt --cases elastic`` on the CPU, at the JAX
suite's size (``synthetic``: ``test_torch_chaos_fleet.py``): LeNet
trials on agents of 4, 2 and 2 devices, whose trials are 4 and 2 gloo
rank processes; the 4-device agent is SIGKILLed once its trial has
checkpointed, the trial resumes on 2 ranks with ``elastic_resume`` 4 ->
2, and the scenario exits 0 with every invariant of the JAX scenario
held, under the JAX check names, in order."""

import pytest

from torch_chaos_cli import run_chaos
import torch_cpu  # noqa: F401  (one intra-op thread)

CHECKS = {
    "elastic": [
        "elastic: 4-device agent SIGKILLed with a checkpointed trial "
        "in flight; sweep completed, zero trials lost",
        "elastic: host_dead + trial_migrate journaled; re-dispatch "
        "landed on a surviving host",
        "elastic: migrated trial ELASTICALLY resumed on a different "
        "device count (typed elastic_resume, 4d -> 2d)",
        "elastic: leaderboard rank identical, losses within the "
        "elastic tolerance (<=1e-3 rtol)",
    ],
}


@pytest.mark.parametrize("case", list(CHECKS))
def test_case_holds_every_invariant(case, tmp_path, capsys):
    rc, held, failed = run_chaos("fleet_preempt", tmp_path, capsys,
                                 cases=[case])
    assert (rc, failed) == (0, [])
    assert held == CHECKS[case]
