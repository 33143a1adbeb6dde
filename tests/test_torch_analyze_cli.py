"""``python -m pytorch_distributed_nn_tpu_torch analyze`` on the CPU: the
JAX ``analyze``'s exit codes and outputs, by the port's walk.

``--plan --check`` passes (rc 0), ``--check`` alone and the HLO
auditor's flags exit 2; the default run prints the mesh's collective
inventory and step cost; ``--cost`` on a decoder adds the JAX decode
block with its numbers; ``--calibrate`` writes a ``calibration.json``
the JAX package reads, from the defaults or from a trace; ``--plan
--validate --device cpu`` measures each candidate as gloo rank
processes.
"""

import json
import os
from types import SimpleNamespace

import pytest

from pytorch_distributed_nn_tpu import cli as jax_cli
from pytorch_distributed_nn_tpu.analysis import calibration as jax_cal
from pytorch_distributed_nn_tpu_torch.cli import main, main_analyze

import torch_cpu  # noqa: F401  (one intra-op thread)


def test_plan_check_rc0(capsys):
    assert main(["analyze", "--plan", "--check"]) == 0
    out = capsys.readouterr()
    assert "predicted fastest: 1" in out.out
    assert "plan --check: PASS" in out.err


def test_check_without_plan_rc2(capsys):
    assert main_analyze(["--check"]) == 2
    assert "--check only applies with --plan" in capsys.readouterr().err


@pytest.mark.parametrize("flag", [["--fail-on", "SL001"],
                                  ["--suppress=SL002"],
                                  ["--check-recompile"],
                                  ["--check-donation"]])
def test_auditor_flags_exit_2_naming_it(flag, capsys):
    assert main_analyze(["--model", "lenet", "--mesh", "2", *flag]) == 2
    assert "HLO auditor" in capsys.readouterr().err


def test_default_run_prints_collectives_and_cost(capsys):
    assert main_analyze(["--model", "lenet", "--mesh", "2", "--cost"]) == 0
    out = capsys.readouterr().out
    assert "all-reduce" in out and "groups of 2" in out
    assert "step cost (walk of the dispatched ops):" in out
    assert "convert_reduce_fusion" in out
    assert main_analyze(["--model", "lenet", "--mesh", "2", "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["cost"]["flops"] > 0 and doc["cost"]["source"] == "walk"
    assert doc["findings"] == [] and doc["fired_rules"] == []
    assert doc["totals"]["est_ici_bytes_per_step"] == pytest.approx(
        doc["cost"]["ici_bytes"], abs=1)
    assert main_analyze(["--model", "lenet", "--mesh", "2x2"]) == 2


def test_cost_decode_block_equals_jax(capsys):
    assert main_analyze(["--model", "gpt_mini", "--mesh", "1", "--cost",
                         "--json", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)["decode_cost"]
    args = SimpleNamespace(vocab_size=None, seq_len=None, d_model=None,
                           num_layers=None, num_heads=None, d_ff=None,
                           batch_size=None)
    want = jax_cli._decode_cost_block(args, "GptMini")
    want.pop("text")
    assert got == want
    assert main_analyze(["--model", "gpt_mini", "--mesh", "1", "--cost",
                         "--device", "cpu"]) == 0
    assert "roofline tokens/s" in capsys.readouterr().out


def test_calibrate_defaults_read_by_jax(tmp_path, capsys):
    out = str(tmp_path / "calibration.json")
    assert main_analyze(["--calibrate", "--out", out, "--device",
                         "cpu"]) == 0
    prof = jax_cal.CalibrationProfile.load(out)
    assert prof.backend == "cpu" and prof.shared_substrate
    assert "wrote" in capsys.readouterr().out


def test_calibrate_from_a_trace(tmp_path, capsys):
    """A trace of 2 LeNet steps: each compute family's ceiling is its
    walked FLOPs x 2 over its device time."""
    tdir = tmp_path / "profile"
    os.makedirs(tdir)
    events = [{"ph": "X", "cat": "kernel", "name": n, "ts": i * 1e3,
               "dur": 1e3, "pid": 0, "tid": 7,
               "args": {"device": 0, "stream": 7, "correlation": i}}
              for i, n in enumerate(["cutlass_80_gemm_kernel",
                                     "vectorized_elementwise_kernel"])]
    with open(tdir / "h_1.1.pt.trace.json", "w") as f:
        json.dump({"traceEvents": events}, f)
    out = str(tmp_path / "calibration.json")
    assert main_analyze(["--calibrate", "--trace", str(tdir),
                         "--trace-steps", "2", "--model", "lenet", "--mesh",
                         "1", "--out", out, "--device", "cpu"]) == 0
    capsys.readouterr()
    prof = jax_cal.CalibrationProfile.load(out)
    assert main_analyze(["--model", "lenet", "--mesh", "1", "--json"]) == 0
    cost = json.loads(capsys.readouterr().out)["cost"]["families"]
    # the gemm row has no host launch in this trace: forward compute
    assert prof.compute_ceilings["convert_reduce_fusion"] == pytest.approx(
        cost["convert_reduce_fusion"]["flops"] * 2 / 1e-3)
    assert prof.compute_ceilings["elementwise"] == pytest.approx(
        cost["elementwise"]["flops"] * 2 / 1e-3)
    assert main_analyze(["--calibrate", "--trace", str(tmp_path / "none"),
                         "--model", "lenet", "--mesh", "1", "--out", out,
                         "--device", "cpu"]) == 2


def test_plan_validate_on_cpu_ranks(capsys):
    """``--validate --device cpu``: each candidate trains as gloo rank
    processes (dp 2 is two of them) and reports its measured ms and
    kernel launches (none on the CPU)."""
    assert main_analyze(["--plan", "--model", "lenet", "--devices", "2",
                         "--batch-size", "8", "--optimizer", "sgd",
                         "--validate", "--device", "cpu", "--json"]) == 0
    result = json.loads(capsys.readouterr().out)
    assert [c["mesh"]["data"] for c in result["candidates"]] == [1, 2]
    for c in result["candidates"]:
        assert c["measured_ms"] > 0, c.get("unmeasured")
        assert not any(c["launches"].values())
    assert result["measured_fastest"] in ("1", "2")
