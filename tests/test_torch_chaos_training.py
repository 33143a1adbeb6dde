"""The port's training chaos scenarios on the CPU, at the JAX suite's
sizes and rank counts (gloo rank processes): each exits 0 with every
invariant of the JAX scenario held, under the JAX check names, in
order."""

import pytest

from torch_chaos_cli import run_chaos
import torch_cpu  # noqa: F401  (one intra-op thread)

CHECKS = {
    "crash_resume": [
        "crash fired", "emergency checkpoint",
        "resumed from emergency step",
        "crash+resume == uninterrupted (params+opt, bitwise)",
    ],
    "preempt": [
        "clean early exit", "emergency checkpoint",
        "emergency checkpoint verifies",
        "telemetry manifest is the stream header",
        "final step record survives preemption", "preempt event recorded",
    ],
    "straggler": [
        "delayed rank dropped at fault step", "no drops on healthy steps",
        "observed skew reported", "slowest rank attributed",
        "losses finite through the drop", "params finite",
    ],
    "torn_ckpt": [
        "torn checkpoint convicted by manifest",
        "previous checkpoint still valid",
        "resume falls back to latest VALID step",
        "torn checkpoint quarantined",
    ],
    "nan_grad": [
        "poisoned step skipped, healthy steps applied", "params finite",
        "training recovers after the skip",
    ],
}


@pytest.mark.parametrize("name", list(CHECKS))
def test_scenario_holds_every_invariant(name, tmp_path, capsys):
    rc, held, failed = run_chaos(name, tmp_path, capsys)
    assert (rc, failed) == (0, [])
    assert held == CHECKS[name]
