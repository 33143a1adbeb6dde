"""``tools/dist_sync_check.py`` over gloo at 2 ranks on the CPU, at narrow
shapes (BertTiny, a global batch of 4 sequences of 32, buckets of 64
KB): the tensor-parallel sums at mesh 1,1,2, the gradient sync in each
mode at mesh 2,1,1, and the spmd step and the sharded save at both. The
tool runs once, as its own ``torch.distributed.run`` launch with a time
limit of its own; each case is then held to its bounds on its own. The
same tool runs over NCCL on four cards (``--device cuda``)."""

import json
import os
import socket
import subprocess
import sys

import pytest

from torch_cpu import SUBPROCESS_ENV

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ("2,1,1", "1,1,2")
#: the cases each mesh runs: the sync where data > 1, tp where model > 1
CASES = {
    "2x1x1": ["sync none", "sync int8", "sync topk", "sync int8 bucket",
              "spmd step", "sharded save"],
    "1x1x2": ["tp", "spmd step", "sharded save"],
}
TIME_LIMIT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def run():
    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--nproc-per-node", "2", "--master-addr", "127.0.0.1",
           "--master-port", str(_free_port()), "-m",
           "pytorch_distributed_nn_tpu_torch.tools.dist_sync_check",
           "--device", "cpu", "--network", "BertTiny", "--batch", "4",
           "--seq-len", "32", "--bucket-kb", "64"]
    for m in MESHES:
        cmd += ["--mesh", m]
    out = subprocess.run(cmd, cwd=REPO, env=SUBPROCESS_ENV,
                         capture_output=True, text=True,
                         timeout=TIME_LIMIT_S)
    lines = [json.loads(line) for line in out.stdout.splitlines()
             if line.startswith("{")]
    return out, lines


def test_the_run_passes_and_every_rank_reports_every_case(run):
    out, lines = run
    assert out.returncode == 0, (out.stdout[-3000:], out.stderr[-3000:])
    result = lines[-1]
    assert result["ok"] is True and result["world"] == 2
    assert sorted(result["meshes"]) == sorted(CASES)
    for mesh, names in CASES.items():
        assert sorted(result["meshes"][mesh]) == sorted(names)
        for r in (0, 1):
            got = sorted(x["case"] for x in lines[:-1]
                         if x["rank"] == r and x["mesh"] == mesh)
            assert got == sorted(names), (mesh, r)


@pytest.mark.parametrize("mesh,case", [(m, c) for m, names in CASES.items()
                                       for c in names])
def test_case_in_bounds(run, mesh, case):
    row = run[1][-1]["meshes"][mesh][case]
    assert row["of_bound"] <= 1, row
    assert row["unequal"] == 0, row
    if case.startswith("sync") or case == "sharded save":
        assert row["err"] == 0.0, row  # bit for bit
    if case == "spmd step":
        assert row["losses"] == pytest.approx(row["world1_losses"],
                                              rel=1e-5)
        assert len(row["losses"]) == 2
    if case == "sharded save":
        assert row["step"] == 2 and row["leaves"] > 0
