"""Run one of the port's chaos scenarios through its CLI on the CPU and
read back which invariants held (``tests/test_torch_chaos_*.py``)."""

import re

from pytorch_distributed_nn_tpu_torch.cli import main

_LINE = re.compile(r"^  \[(PASS|FAIL)\] (.+?)(?: — .*)?$")


def run_chaos(name, workdir, capsys, cases=None):
    """``(exit code, names of the checks that held, names of those that
    failed)`` of ``chaos --scenario name --device cpu``; the output
    goes on to the test's log."""
    argv = ["chaos", "--scenario", name, "--device", "cpu",
            "--workdir", str(workdir)]
    if cases:
        argv += ["--cases", ",".join(cases)]
    rc = main(argv)
    out = capsys.readouterr().out
    print(out)
    held, failed = [], []
    for line in out.splitlines():
        m = _LINE.match(line)
        if m:
            (held if m.group(1) == "PASS" else failed).append(m.group(2))
    return rc, held, failed
