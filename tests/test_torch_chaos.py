"""The port's chaos suite (pytorch_distributed_nn_tpu_torch/resilience/
chaos.py and the CLI's ``chaos``): the registry against the JAX one, the
refusal of a scenario that needs more cards than there are, the rank
launcher, and ``smoke`` on the CPU against the JAX package's.

The scenarios themselves run in ``test_torch_chaos_*.py``, one file a
group, each on the CPU at the JAX suite's sizes and rank counts.
"""

import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu.resilience import chaos as jax_chaos
from pytorch_distributed_nn_tpu_torch.cli import main
from pytorch_distributed_nn_tpu_torch.resilience import chaos
import torch_cpu  # noqa: F401  (one intra-op thread)


def test_registry_is_the_jax_one_less_fleet_preempt():
    want = list(jax_chaos.SCENARIOS)
    assert list(chaos.SCENARIOS) == want
    assert len(want) == 16
    assert set(chaos.RANKS) == set(chaos.SCENARIOS)
    for name, fn in chaos.SCENARIOS.items():
        assert fn.__doc__, name


def test_list_names_every_scenario_in_order_with_its_cards(capsys):
    assert main(["chaos", "--scenario", "list"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    assert [ln.split(":", 1)[0] for ln in lines] == list(chaos.SCENARIOS)
    by_name = dict(ln.split(":", 1) for ln in lines)
    assert by_name["smoke"].endswith("[2 cards]")
    assert by_name["generate"].endswith("[1 card]")
    assert by_name["elastic_resume"].endswith(
        "[cards: shrink 8, regrow 4, corrupt 8]")
    assert by_name["live_reload"].endswith("[cards: swap 2, canary 1]")
    assert by_name["fleet_preempt"].endswith(
        "[cards: synthetic 0, elastic 8]")


@pytest.mark.parametrize("name", ["nope"])
def test_unknown_scenario_and_fleet_preempt_exit_2(name, capsys):
    assert main(["chaos", "--scenario", name, "--device", "cpu"]) == 2
    out = capsys.readouterr().out
    assert "unknown scenario 'nope'" in out


@pytest.mark.parametrize("name,cases,need", [
    ("smoke", None, 2), ("preempt", None, 4), ("generate", None, 1),
    ("elastic_resume", None, 8), ("elastic_resume", ("regrow",), 4),
    ("live_reload", ("canary",), 1), ("live_reload", None, 2),
    ("fleet_preempt", None, 8), ("fleet_preempt", ("synthetic",), 0),
])
def test_ranks_needed(name, cases, need):
    assert chaos.ranks_needed(name, cases) == need


@pytest.mark.parametrize("argv,need,found", [
    (["--scenario", "smoke"], 2, 1),
    (["--scenario", "elastic_resume", "--cases", "regrow"], 4, 2),
    (["--scenario", "flightrec", "--device", "cuda:0"], 4, 3),
    (["--scenario", "fleet_preempt"], 8, 4),
    (["--scenario", "fleet_preempt", "--cases", "synthetic,elastic"], 8, 7),
])
def test_too_few_cards_refused_before_any_cuda_call(
        monkeypatch, capsys, tmp_path, argv, need, found):
    """On the card a scenario that needs more ranks than there are cards
    exits 2, naming both counts, and touches the card no other way
    (``torch.cuda.device_count`` is its one CUDA call) and writes
    nothing."""
    def no_cuda(*a, **k):
        raise AssertionError("a CUDA call before the refusal")

    monkeypatch.setattr(torch.cuda, "device_count", lambda: found)
    for fn in ("is_available", "init", "set_device", "synchronize",
               "get_device_name", "current_device"):
        monkeypatch.setattr(torch.cuda, fn, no_cuda)
    wd = tmp_path / "wd"
    assert main(["chaos", *argv, "--workdir", str(wd)]) == 2
    out = capsys.readouterr().out
    assert f"needs {need} cards (one per rank), found {found}" in out
    assert "refused before training" in out
    assert not wd.exists()


def test_trees_bitwise_equal_names_the_first_differing_leaf():
    a = {"params/w": np.arange(4, dtype=np.float32),
         "opt_state/m": np.zeros(3, np.float32)}
    assert chaos._trees_bitwise_equal(a, dict(a)).ok
    b = dict(a, **{"params/w": a["params/w"] + np.float32(0.5)})
    got = chaos._trees_bitwise_equal(a, b)
    assert not got.ok and got.name == "bitwise equality"
    assert "leaf 1 differs (max abs diff 5.000e-01)" == got.detail
    got = chaos._trees_bitwise_equal(a, {"params/w": a["params/w"]})
    assert (got.name, got.ok) == ("tree structure", False)


def test_flatten_keeps_every_leaf_under_its_path():
    tree = {"b": [np.ones(2), {"c": np.float32(3)}], "a": np.zeros(1),
            "n": None}
    flat = chaos._flatten(tree)
    assert list(flat) == ["a", "b/0", "b/1/c"]
    assert flat["b/1/c"] == 3


def test_smoke_equals_the_jax_scenario(tmp_path):
    """Both packages' ``smoke`` on the CPU (JAX: 2 virtual devices; the
    port: 2 gloo rank processes): the same checks in the same order, all
    held, the same ``skipped_nonfinite`` by step, the same resumed start
    step and the same quarantined checkpoint."""
    want = jax_chaos.scenario_smoke(str(tmp_path / "jax"))
    got = chaos.scenario_smoke(str(tmp_path / "port"), "cpu")
    assert [c.name for c in got] == [c.name for c in want] == [
        "nan step skipped", "params finite", "torn checkpoint convicted",
        "validated resume skips the torn step", "torn checkpoint quarantined"]
    assert all(c.ok for c in want) and all(c.ok for c in got), got
    for i in (0, 3, 4):  # the flags by step, start_step=2, quarantine/
        assert got[i].detail == want[i].detail
    assert got[0].detail == "skipped flags: {1: 0.0, 2: 1.0, 3: 0.0}"
    assert got[3].detail == "start_step=2"
    assert "'model_step_3'" in got[4].detail


def test_a_failing_rank_fails_the_launch_with_its_log(tmp_path):
    """A rank that raises ends the launch with a RuntimeError naming it
    and quoting its log; no rank process is left running."""
    cfg = chaos._lenet_cfg(str(tmp_path / "bad"), num_workers=2,
                           max_steps=1, faults="delay@1:p5:1s")
    with pytest.raises(RuntimeError) as err:
        chaos._launch(cfg, "cpu")
    assert "exited 1" in str(err.value)
    assert "fault plan references rank p5" in str(err.value)


def test_chaos_check_tool_records_each_run(tmp_path, capsys):
    """``tools/chaos_check.py`` runs each scenario through the CLI and
    keeps one row a run: here two refusals, an unknown case (one failed
    check, rc 1) and an unknown scenario (rc 2 and no checks)."""
    from pytorch_distributed_nn_tpu_torch.tools import chaos_check

    out = tmp_path / "runs.json"
    assert chaos_check.main(["fleet_preempt --cases bogus", "nope",
                             "--device", "cpu", "--out", str(out)]) == 1
    import json

    rows = json.loads(out.read_text())
    assert [(r["scenario"], r["run"], r["rc"], r["checks"]) for r in rows] \
        == [("fleet_preempt --cases bogus", 1, 1, 1), ("nope", 1, 2, 0)]
    assert rows[0]["failed"] == ["unknown fleet_preempt case(s) ['bogus'] "
                                 "— have: synthetic, elastic"]
    assert "unknown scenario 'nope'" in rows[1]["error_tail"]
