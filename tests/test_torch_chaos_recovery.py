"""The port's checkpoint, flight-recorder and streaming-resume chaos
scenarios on the CPU, at the JAX suite's sizes and rank counts (gloo rank
processes): each exits 0 with every invariant of the JAX scenario held,
under the JAX check names, in order."""

import pytest

from torch_chaos_cli import run_chaos
import torch_cpu  # noqa: F401  (one intra-op thread)

CHECKS = {
    "async_ckpt": [
        "async step-2 checkpoint byte-identical to sync",
        "async step-2 checkpoint verifies",
        "async step-4 checkpoint byte-identical to sync",
        "async step-4 checkpoint verifies",
        "async stream records stall_ms on every write",
        "crash fired with a save in flight",
        "in-flight (and emergency) step-4 checkpoint torn",
        "restart resumes from the last VALID step",
        "torn in-flight checkpoint quarantined",
        "keep-last GC leaves only the newest step",
        "checkpoint_gc event names the deleted step",
    ],
    "flightrec": [
        "run completed under the recorder",
        "exactly one incident bundle (second delay muted by cooldown)",
        "incident kind is stall or step_regression",
        "bundle carries a non-empty trace dir",
        "bundle carries a generated report.md",
        "bundle carries the run manifest copy",
        "event ring contains the fault_injected record",
        "stream records exactly one incident event",
        "obs incidents lists the bundle and exits 0",
    ],
    "data_resume": [
        "batch sequence identical across workers counts (0 vs 2)",
        "restore at a mid-epoch step continues the exact stream",
        "crash fired mid-epoch",
        "emergency checkpoint carries the iterator-state sidecar",
        "resumed from the emergency step",
        "post-resume loss trajectory bitwise-matches the uninterrupted run",
        "crash+resume == uninterrupted (params+opt, bitwise)",
    ],
}


@pytest.mark.parametrize("name", list(CHECKS))
def test_scenario_holds_every_invariant(name, tmp_path, capsys):
    rc, held, failed = run_chaos(name, tmp_path, capsys)
    assert (rc, failed) == (0, [])
    assert held == CHECKS[name]
