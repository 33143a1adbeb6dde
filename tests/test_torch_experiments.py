"""The port's sweep layer (``pytorch_distributed_nn_tpu_torch/experiments``)
against the JAX package's ``experiments/``: the counterpart of
``tests/test_experiments.py``.

Specs, seeds, rungs, promotions and ``classify_attempt`` equal the JAX
results exactly. The synthetic sweeps run ``synthetic_trial_main`` of
each package with the same spec, seed and ``RunnerConfig``, one trial at
a time so the journal's order is fixed: the events equal the JAX ones in
type, order and fields, apart from wall stamps, trace and span ids and
the attempt's wall time (``duration_s``, ``step_rate``). Each package's
``load_journal`` folds the other's journal to the same results and
statuses, and both render the same leaderboard text. One sweep trains
the port's ``Trainer`` on the CPU in spawned trials.
"""

import json
import math
import os
import subprocess
import sys

import pytest

from pytorch_distributed_nn_tpu.experiments import journal as jax_jr
from pytorch_distributed_nn_tpu.experiments import report as jax_report
from pytorch_distributed_nn_tpu.experiments import runner as jax_runner
from pytorch_distributed_nn_tpu.experiments import scheduler as jax_sched
from pytorch_distributed_nn_tpu.experiments import spec as jax_spec
from pytorch_distributed_nn_tpu_torch.experiments import (
    RunnerConfig,
    SweepRunner,
    SweepSpec,
    load_journal,
    render_leaderboard,
    trial_dir,
)
from pytorch_distributed_nn_tpu_torch.experiments import journal as jr
from pytorch_distributed_nn_tpu_torch.experiments import report, scheduler
from pytorch_distributed_nn_tpu_torch.experiments import runner as port_runner
from pytorch_distributed_nn_tpu_torch.experiments import spec as port_spec
from pytorch_distributed_nn_tpu_torch.experiments.runner import (
    classify_attempt,
    synthetic_trial_main,
)
from pytorch_distributed_nn_tpu_torch.experiments.spec import trial_seed
from torch_cpu import SUBPROCESS_ENV

SYNTH_BASE = {"network": "SynthNet", "lr": 0.1, "batch_size": 32,
              "faults": None}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# spec grammar
# ---------------------------------------------------------------------------

GOOD_SPECS = [
    ("lr=0.1,0.01;batch_size=32,64", {"sweep_seed": 3}),
    ("lr=0.4,0.2,0.1,0.05,0.025,0.0125,0.00625", {}),
    ("compression=none,int8;nesterov=true,false", {}),
    ("straggler_deadline=none,1.5;num_aggregate=none,2", {"sweep_seed": 9}),
    ("lr=log:1e-4..1e-1;batch_size=16..128", {"samples": 6,
                                              "sweep_seed": 11}),
    ("lr=log:1e-4..1e-1;momentum=0.8..0.99;network=LeNet,ResNet18",
     {"samples": 5, "sweep_seed": 12}),
    ("grad_accum=1..4;lr=0.1", {"samples": 4}),
]


@pytest.mark.parametrize("text,kw", GOOD_SPECS)
def test_spec_trials_equal_jax(text, kw):
    port, ref = SweepSpec.parse(text, **kw), jax_spec.SweepSpec.parse(text,
                                                                      **kw)
    got = [(t.index, t.overrides, t.seed) for t in port.trials()]
    want = [(t.index, t.overrides, t.seed) for t in ref.trials()]
    assert got == want
    assert [type(v) for _, o, _ in got for v in o.values()] == \
        [type(v) for _, o, _ in want for v in o.values()]
    assert port.describe() == ref.describe()
    assert (port.mode, port.samples, port.sweep_seed) == \
        (ref.mode, ref.samples, ref.sweep_seed)
    # the canonical form parses back to itself
    assert SweepSpec.parse(port.describe(), **kw).describe() == \
        port.describe()
    assert [t.label() for t in port.trials()] == \
        [t.label() for t in ref.trials()]


def test_spec_grid_product_and_roundtrip():
    s = SweepSpec.parse("lr=0.1,0.01;batch_size=32,64", sweep_seed=3)
    trials = s.trials()
    assert [t.overrides for t in trials] == [
        {"lr": 0.1, "batch_size": 32}, {"lr": 0.1, "batch_size": 64},
        {"lr": 0.01, "batch_size": 32}, {"lr": 0.01, "batch_size": 64},
    ]
    assert [t.index for t in trials] == [0, 1, 2, 3]
    s2 = SweepSpec.parse("compression=none,int8;nesterov=true,false")
    assert s2.trials()[0].overrides == {"compression": "none",
                                        "nesterov": True}
    s3 = SweepSpec.parse("straggler_deadline=none,1.5")
    assert s3.trials()[0].overrides == {"straggler_deadline": None}


BAD_SPECS = [
    ("learning=0.1", {}),  # unknown TrainConfig field
    ("train_dir=/tmp", {}),  # runner-owned field
    ("seed=1,2", {}),  # runner-owned (per-trial seeds are derived)
    ("lr=1e-4..1e-1", {}),  # range axis in grid mode
    ("lr=log:0..1", {"samples": 4}),  # log range needs lo > 0
    ("lr=0.1;lr=0.2", {}),  # duplicate axis
    ("lr=abc", {}),  # uncoercible value
    ("lr=", {}),  # empty value
    ("", {}),  # empty spec
    ("network=log:1..2", {"samples": 2}),  # range on a str field
    ("lr=0.1", {"samples": 0}),  # samples must be >= 1
]


@pytest.mark.parametrize("text,kw", BAD_SPECS)
def test_spec_bad_specs_fail_fast_in_both_packages(text, kw):
    with pytest.raises(ValueError):
        jax_spec.SweepSpec.parse(text, **kw)
    with pytest.raises(ValueError):
        SweepSpec.parse(text, **kw)


def test_spec_random_deterministic_and_typed():
    s = SweepSpec.parse("lr=log:1e-4..1e-1;batch_size=16..128",
                        samples=6, sweep_seed=11)
    a, b = s.trials(), s.trials()
    assert [t.overrides for t in a] == [t.overrides for t in b]
    for t in a:
        assert 1e-4 <= t.overrides["lr"] <= 1e-1
        assert isinstance(t.overrides["batch_size"], int)
        assert 16 <= t.overrides["batch_size"] <= 128
    s2 = SweepSpec.parse("lr=log:1e-4..1e-1;batch_size=16..128",
                         samples=6, sweep_seed=12)
    assert [t.overrides for t in s2.trials()] != [t.overrides for t in a]


def test_trial_seed_determinism_and_jax_equality():
    assert trial_seed(0, 5) == trial_seed(0, 5)
    assert trial_seed(0, 5) != trial_seed(0, 6)
    assert trial_seed(0, 5) != trial_seed(1, 5)
    assert len({trial_seed(0, i) for i in range(64)}) == 64
    assert [trial_seed(s, i) for s in (0, 1, 2**31) for i in range(16)] == \
        [jax_spec.trial_seed(s, i) for s in (0, 1, 2**31) for i in range(16)]
    assert port_spec.RESERVED_FIELDS == jax_spec.RESERVED_FIELDS


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------

RUNG_GRID = [(kind, n, steps, eta, min_steps)
             for kind in ("grid", "asha")
             for n in (1, 2, 3, 7, 12, 27)
             for steps in (1, 5, 9, 100)
             for eta in (2, 3, 4)
             for min_steps in (None, 1, 3, 10)]


def _rungs(mod, *args):
    try:
        return [(r.index, r.budget, r.keep)
                for r in mod.make_rungs(args[0], *args[1:3], eta=args[3],
                                        min_steps=args[4])]
    except ValueError:
        return "ValueError"


@pytest.mark.parametrize("kind", ["grid", "asha"])
def test_rungs_and_planned_steps_equal_jax(kind):
    for args in RUNG_GRID:
        if args[0] != kind:
            continue
        got, want = _rungs(scheduler, *args), _rungs(jax_sched, *args)
        assert got == want, args
        if got != "ValueError":
            rungs = scheduler.make_rungs(kind, *args[1:3], eta=args[3],
                                         min_steps=args[4])
            ref = jax_sched.make_rungs(kind, *args[1:3], eta=args[3],
                                       min_steps=args[4])
            assert scheduler.planned_steps(rungs) == \
                jax_sched.planned_steps(ref)
    for bad in ((0, 100), (4, 0)):
        for mod in (scheduler, jax_sched):
            with pytest.raises(ValueError):
                mod.make_rungs(kind, *bad)
    for mod in (scheduler, jax_sched):
        with pytest.raises(ValueError):
            mod.make_rungs("sha?", 4, 100)


PROMOTE_CASES = [
    {0: 0.5, 1: 0.1, 2: float("nan"), 3: 0.1, 4: float("inf")},
    {},
    {3: float("nan"), 1: float("nan"), 0: float("-inf"), 2: 1.0},
    {i: round(0.1 * (i % 3), 1) for i in range(9)},
    {5: 2.0, 4: 2.0, 9: None, 1: "x", 0: 2.0},
]


@pytest.mark.parametrize("results", PROMOTE_CASES)
def test_promote_equals_jax(results):
    for keep in range(len(results) + 2):
        assert scheduler.promote(results, keep) == \
            jax_sched.promote(results, keep)
        # independent of the dict's order
        assert scheduler.promote(dict(reversed(list(results.items()))),
                                 keep) == scheduler.promote(results, keep)
    for mod in (scheduler, jax_sched):
        with pytest.raises(ValueError):
            mod.promote(results, -1)


def test_asha_rungs_and_budget_math():
    for n in (2, 7, 12, 27):
        rungs = scheduler.asha_rungs(n, 100, eta=3)
        budgets = [r.budget for r in rungs]
        keeps = [r.keep for r in rungs]
        assert budgets == sorted(set(budgets)) and budgets[-1] == 100
        assert keeps[0] == n and keeps[-1] >= 1
        assert all(a >= b for a, b in zip(keeps, keeps[1:]))
        if n >= 3:
            assert scheduler.planned_steps(rungs) <= 0.5 * n * 100
    rungs = scheduler.asha_rungs(9, 100, eta=3, min_steps=10)
    assert rungs[0].budget == 10 and rungs[-1].budget == 100
    assert scheduler.planned_steps(scheduler.grid_rungs(7, 100)) == 700
    assert scheduler.asha_rungs(1, 5)[-1].budget == 5
    with pytest.raises(ValueError):
        scheduler.asha_rungs(4, 100, eta=1)


def test_classify_attempt_table_equals_jax():
    table = [(rc, timed_out, steps, budget)
             for rc in (0, 1, -15, -9, 17, None)
             for timed_out in (False, True)
             for steps in (0, 3, 9, 10, 12)
             for budget in (1, 10)]
    assert [classify_attempt(*row) for row in table] == \
        [jax_runner.classify_attempt(*row) for row in table]
    assert classify_attempt(0, False, 9, 10) == "incomplete"
    assert classify_attempt(-15, True, 3, 10) == "timeout"


# ---------------------------------------------------------------------------
# the runner over each package's synthetic trial main
# ---------------------------------------------------------------------------

#: (spec, base overrides, RunnerConfig fields): one trial at a time
SYNTH_SWEEPS = {
    "grid": ("lr=0.5,0.05,10.0", {},
             dict(max_steps=8, retries=0)),
    "asha": ("lr=0.5,0.2,0.05,0.02,0.01,3.0", {},
             dict(max_steps=9, scheduler="asha", eta=3)),
    "crash_retry": ("lr=0.05", {"faults": "crash@3"},
                    dict(max_steps=6, retries=1, retry_base_delay=0.01)),
    "retries_exhausted": ("lr=0.05", {"faults": "crash@1"},
                          dict(max_steps=4, retries=1,
                               retry_base_delay=0.01)),
    "timeout": ("lr=0.05", {"faults": "delay@2:30s"},
                dict(max_steps=4, retries=0, trial_timeout=1.5)),
}

#: event fields that are stamps of one run, not results
RUN_STAMPS = ("time", "mono", "trace", "span", "parent", "duration_s",
              "step_rate")


def _events(jstate):
    return [{k: v for k, v in e.items() if k not in RUN_STAMPS}
            for e in jstate.events]


def _run_both(tmp_path, name):
    text, base, kw = SYNTH_SWEEPS[name]
    base = dict(SYNTH_BASE, **base)
    dirs = {}
    for pkg, mod_runner, mod_spec in (("jax", jax_runner, jax_spec),
                                      ("port", port_runner, port_spec)):
        d = str(tmp_path / pkg)
        cfg = mod_runner.RunnerConfig(sweep_dir=d, concurrency=1, **kw)
        result = mod_runner.SweepRunner(
            mod_spec.SweepSpec.parse(text), base, cfg,
            trial_main=mod_runner.synthetic_trial_main).run()
        dirs[pkg] = (d, result)
    return dirs


@pytest.mark.parametrize("name", sorted(SYNTH_SWEEPS))
def test_synthetic_sweep_journal_equals_jax(tmp_path, name):
    dirs = _run_both(tmp_path, name)
    (jd, jres), (pd, pres) = dirs["jax"], dirs["port"]
    for key in ("scheduler", "trials", "rungs", "planned_steps",
                "executed_steps", "failed"):
        assert pres[key] == jres[key], key
    jj, pj = jax_jr.load_journal(jd), load_journal(pd)
    assert _events(pj) == _events(jj)
    strip = lambda m: {k: v for k, v in m["sweep"].items()  # noqa: E731
                       if k != "trace"}
    assert strip(pj.manifest) == strip(jj.manifest)
    assert pj.manifest["config"] == jj.manifest["config"]
    # each package folds the other's journal to the same state
    for a, b in ((load_journal(jd), jj), (jax_jr.load_journal(pd), pj)):
        assert sorted(a.trials) == sorted(b.trials)
        for rung in range(len(jres["rungs"])):
            assert a.results_at(rung) == b.results_at(rung)
        assert {i: st.status for i, st in a.trials.items()} == \
            {i: st.status for i, st in b.trials.items()}
        assert {i: st.starts for i, st in a.trials.items()} == \
            {i: st.starts for i, st in b.trials.items()}
    # the leaderboards agree but for the measured step rate, and both
    # packages render the same rows to the same text
    prow = report.leaderboard(pd, pj)
    jrow = jax_report.leaderboard(jd, jj)
    drop = lambda rows: [{k: v for k, v in r.items()  # noqa: E731
                          if k != "step_rate"} for r in rows]
    assert drop(prow) == drop(jrow)
    assert render_leaderboard(jrow) == jax_report.render_leaderboard(jrow)
    assert report.render_status(pj).split("\n", 1)[1] == \
        jax_report.render_status(jj).split("\n", 1)[1]
    # per-trial streams are manifest-headed and reader-compatible
    for idx in pj.trials:
        got = report.trial_metrics(trial_dir(pd, idx))
        want = jax_report.trial_metrics(jax_jr.trial_dir(jd, idx))
        assert {k: v for k, v in got.items() if k != "step_rate"} == \
            {k: v for k, v in want.items() if k != "step_rate"}


def test_mini_sweep_grid_and_journal(tmp_path):
    sdir = str(tmp_path / "sweep")
    spec = SweepSpec.parse("lr=0.5,0.05,10.0")
    result = SweepRunner(
        spec, SYNTH_BASE,
        RunnerConfig(sweep_dir=sdir, max_steps=8, concurrency=2,
                     retries=0),
        trial_main=synthetic_trial_main,
    ).run()
    assert result["failed"] == []
    assert result["best"]["overrides"] == {"lr": 0.05}
    assert result["executed_steps"] == result["planned_steps"] == 24
    with open(jr.journal_path(sdir)) as f:
        first = json.loads(f.readline())
    assert first["kind"] == "manifest"
    assert first["sweep"]["spec"] == "lr=0.5,0.05,10"
    jstate = load_journal(sdir)
    assert jstate.results_at(0)[2] == math.inf
    assert any(e.get("type") == "nonfinite_skip" and e.get("trial") == 2
               for e in jstate.events)
    m = report.trial_metrics(trial_dir(sdir, 1))
    assert m is not None and m["steps"] == 8 and math.isfinite(m["loss"])
    # a synthetic trial trains no model: its manifest has no step cost
    # (a real trial's mfu: test_e2e_mini_sweep_real_trainer)
    assert m["mfu"] is None
    prom = open(os.path.join(sdir, "metrics.prom")).read()
    assert "pdtn_sweep_trials_total 3" in prom


def test_journal_torn_tail_recovery_and_resume(tmp_path):
    sdir = str(tmp_path / "sweep")
    SweepRunner(
        SweepSpec.parse("lr=0.5,0.05"), SYNTH_BASE,
        RunnerConfig(sweep_dir=sdir, max_steps=4, concurrency=2),
        trial_main=synthetic_trial_main,
    ).run()
    intact = load_journal(sdir)
    with open(jr.journal_path(sdir), "a") as f:
        f.write('{"kind": "event", "type": "trial_end", "trial": 0, "lo')
    for fold in (load_journal, jax_jr.load_journal):
        torn = fold(sdir)
        assert torn.truncated
        assert torn.results_at(0) == intact.results_at(0)
    resumed = SweepRunner(
        SweepSpec.parse("lr=0.5,0.05"), SYNTH_BASE,
        RunnerConfig(sweep_dir=sdir, max_steps=4, concurrency=2,
                     resume=True),
        trial_main=synthetic_trial_main,
    ).run()
    assert resumed["executed_steps"] == 0
    assert [r["loss"] for r in resumed["leaderboard"]] == [
        intact.results_at(0)[i] for i in (1, 0)]


def test_resume_requires_matching_spec(tmp_path):
    sdir = str(tmp_path / "sweep")
    SweepRunner(
        SweepSpec.parse("lr=0.5"), SYNTH_BASE,
        RunnerConfig(sweep_dir=sdir, max_steps=2),
        trial_main=synthetic_trial_main,
    ).run()
    with pytest.raises(ValueError, match="already holds"):
        SweepRunner(
            SweepSpec.parse("lr=0.5"), SYNTH_BASE,
            RunnerConfig(sweep_dir=sdir, max_steps=2),
            trial_main=synthetic_trial_main,
        ).run()
    with pytest.raises(ValueError, match="spec mismatch"):
        SweepRunner(
            SweepSpec.parse("lr=0.25"), SYNTH_BASE,
            RunnerConfig(sweep_dir=sdir, max_steps=2, resume=True),
            trial_main=synthetic_trial_main,
        ).run()
    with pytest.raises(ValueError, match="no sweep.jsonl"):
        SweepRunner(
            SweepSpec.parse("lr=0.5"), SYNTH_BASE,
            RunnerConfig(sweep_dir=str(tmp_path / "nope"), max_steps=2,
                         resume=True),
            trial_main=synthetic_trial_main,
        ).run()
    # --plan-mesh is accepted now; a network the planner cannot build
    # keeps the base mesh (the JAX runner's best effort), planned in a
    # spawned subprocess
    planned = SweepRunner(
        SweepSpec.parse("lr=0.5"), SYNTH_BASE,
        RunnerConfig(sweep_dir=sdir, max_steps=2, plan_mesh=4,
                     device="cpu"),
        trial_main=synthetic_trial_main,
    )
    assert planned._plan_mesh_overrides("SynthNet") == {}


def test_asha_promotes_and_resumes_across_rungs(tmp_path):
    sdir = str(tmp_path / "sweep")
    spec = SweepSpec.parse("lr=0.5,0.2,0.05,0.02,0.01,3.0")
    result = SweepRunner(
        spec, SYNTH_BASE,
        RunnerConfig(sweep_dir=sdir, max_steps=9, concurrency=3,
                     scheduler="asha", eta=3),
        trial_main=synthetic_trial_main,
    ).run()
    assert [r["keep"] for r in result["rungs"]] == [6, 2, 1]
    assert result["executed_steps"] == result["planned_steps"]
    assert result["best"]["overrides"] == {"lr": 0.05}
    m = report.trial_metrics(trial_dir(sdir, 2))
    assert m["steps"] == 9 and m["restarts"] == 2
    jstate = load_journal(sdir)
    promoted = scheduler.promote(jstate.results_at(0), 2)
    assert set(idx for idx, st in jstate.trials.items()
               if 1 in st.rungs) == set(promoted)


def test_leaderboard_rendering(tmp_path):
    sdir = str(tmp_path / "sweep")
    SweepRunner(
        SweepSpec.parse("lr=0.05,10.0"), SYNTH_BASE,
        RunnerConfig(sweep_dir=sdir, max_steps=4, concurrency=2),
        trial_main=synthetic_trial_main,
    ).run()
    rows = report.leaderboard(sdir, load_journal(sdir))
    text = render_leaderboard(rows)
    assert rows[0]["overrides"] == {"lr": 0.05}
    assert rows[1]["nonfinite"]
    lines = text.splitlines()
    assert "loss" in lines[0] and "steps/s" in lines[0] and "mfu" in \
        lines[0]
    assert "lr=0.05" in lines[1] and "inf" in lines[2]
    assert "(nonfinite)" in lines[2]
    assert text == jax_report.render_leaderboard(rows)


# ---------------------------------------------------------------------------
# CLI exit codes
# ---------------------------------------------------------------------------


def test_cli_sweep_rc_codes(tmp_path, capsys, monkeypatch):
    from pytorch_distributed_nn_tpu_torch.cli import main, main_sweep

    sdir = str(tmp_path / "s")
    assert main_sweep(["run", "--sweep-dir", sdir,
                       "--spec", "not_a_field=1"]) == 2
    assert main_sweep(["run", "--sweep-dir", sdir,
                       "--spec", "lr=1e-4..1e-1"]) == 2
    assert not os.path.exists(jr.journal_path(sdir))
    # --plan-mesh plans LeNet's mesh for 2 devices in a subprocess, and
    # the trial trains under it (the CPU profile's dp 1): rc 0
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    pdir = str(tmp_path / "planned")
    assert main(["sweep", "run", "--sweep-dir", pdir, "--spec", "lr=0.01",
                 "--plan-mesh", "2", "--device", "cpu", "--steps", "2",
                 "--network", "LeNet", "--synthetic-size", "64",
                 "--batch-size", "16", "--concurrency", "1",
                 "--retries", "0"]) == 0
    from pytorch_distributed_nn_tpu_torch.observability import reader

    manifest = reader.read_stream(trial_dir(pdir, 0)).manifest
    assert manifest["config"]["num_workers"] == 1
    assert manifest["step_cost"]["source"] == "walk"
    capsys.readouterr()
    for cmd in ("status", "report", "resume"):
        assert main_sweep([cmd, "--sweep-dir", sdir]) == 2
    assert main(["sweep", "--selftest"]) == 0
    capsys.readouterr()


def test_cli_sweep_status_and_report(tmp_path, capsys):
    from pytorch_distributed_nn_tpu_torch.cli import main_sweep

    sdir = str(tmp_path / "sweep")
    SweepRunner(
        SweepSpec.parse("lr=0.5,0.05"), SYNTH_BASE,
        RunnerConfig(sweep_dir=sdir, max_steps=4, concurrency=2),
        trial_main=synthetic_trial_main,
    ).run()
    assert main_sweep(["status", "--sweep-dir", sdir]) == 0
    out = capsys.readouterr().out
    assert "completed: 2" in out and "lr=0.5,0.05" in out
    assert main_sweep(["report", "--sweep-dir", sdir, "--json"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert rows[0]["overrides"] == {"lr": 0.05}
    assert main_sweep(["run", "--sweep-dir", sdir,
                       "--spec", "lr=0.5,0.05"]) == 2
    capsys.readouterr()


NO_CUDA_SCRIPT = r"""
import json, sys, tempfile
from pytorch_distributed_nn_tpu_torch.experiments import (
    RunnerConfig, SweepRunner, SweepSpec)
from pytorch_distributed_nn_tpu_torch.experiments.runner import (
    synthetic_trial_main)
d = tempfile.mkdtemp()
res = SweepRunner(SweepSpec.parse("lr=0.5,0.05"),
                  {"network": "SynthNet", "lr": 0.1, "faults": None},
                  RunnerConfig(sweep_dir=d, max_steps=3, concurrency=2),
                  trial_main=synthetic_trial_main).run()
mods = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
              or m.startswith("pytorch_distributed_nn_tpu."))
had_torch = "torch" in sys.modules
import torch
print(json.dumps({"failed": res["failed"], "mods": mods,
                  "had_torch": had_torch,
                  "cuda_initialized": torch.cuda.is_initialized()}))
"""


def test_orchestrator_imports_no_jax_no_torch_and_no_cuda():
    out = subprocess.run([sys.executable, "-c", NO_CUDA_SCRIPT], cwd=REPO,
                         env=SUBPROCESS_ENV, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"failed": [], "mods": [], "had_torch": False,
                   "cuda_initialized": False}


# ---------------------------------------------------------------------------
# end to end with the port's trainer on the CPU
# ---------------------------------------------------------------------------


def test_e2e_mini_sweep_real_trainer(tmp_path, monkeypatch):
    import torch

    from pytorch_distributed_nn_tpu_torch.observability import reader
    from pytorch_distributed_nn_tpu_torch.training.config import TrainConfig

    # the spawned trials inherit one intra-op thread (torch_cpu.py)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    sdir = str(tmp_path / "sweep")
    base = TrainConfig(
        network="LeNet", dataset="MNIST", batch_size=16,
        test_batch_size=16, num_workers=1, synthetic_size=64,
    )
    result = SweepRunner(
        # lr=1e6 overflows float32 within a couple of steps: the
        # guaranteed-divergent candidate
        SweepSpec.parse("lr=1000000.0,0.01"), base,
        # one trial at a time: two torch processes at once would weigh on
        # the suite's other workers
        RunnerConfig(sweep_dir=sdir, max_steps=5, ckpt_every=5,
                     concurrency=1, retries=0, device="cpu"),
    ).run()
    assert result["failed"] == []
    assert result["best"]["overrides"] == {"lr": 0.01}
    jstate = load_journal(sdir)
    assert jstate.results_at(0)[0] == math.inf
    assert any(e.get("type") == "nonfinite_skip" and e.get("trial") == 0
               for e in jstate.events)
    # the journal's config is the JAX one: the device is no field of it
    assert "device" not in jstate.base_config
    rs = reader.read_stream(trial_dir(sdir, 1))
    summary = reader.summarize_run(rs)
    assert summary["steps"] == 5
    assert summary["loss_last"] is not None
    # the trial counted its own kernel launches: one lifetime of 5 steps,
    # none launched on the CPU (the wrappers take their plain versions)
    with open(os.path.join(trial_dir(sdir, 1),
                           port_runner.LAUNCHES_BASENAME)) as f:
        lives = [json.loads(line) for line in f]
    assert [(x["start_step"], x["steps"]) for x in lives] == [(0, 5)]
    assert lives[0]["launches"] and not any(lives[0]["launches"].values())
    # the port's records carry step_ms (the JAX trainer's: step_time);
    # the step rate counts it as the JAX reader counts step_time
    timed = rs.steps[1:]
    wall = sum(r["step_ms"] / 1e3 + r["data_time"] for r in timed)
    assert summary["step_rate"]["overall"] == pytest.approx(
        len(timed) / wall, rel=1e-12)
    assert summary["phases"]["step"]["count"] == len(timed)
    # the trainer stamped its step cost: the sweep's mfu column is filled
    m = report.trial_metrics(trial_dir(sdir, 1))
    assert m["mfu"] is not None and m["mfu"] > 0
    assert rs.manifest["step_cost"]["source"] == "walk"
    # the JAX package reads the port's journal and trial streams too
    assert jax_jr.load_journal(sdir).results_at(0) == jstate.results_at(0)
    assert not torch.cuda.is_initialized()


PLAN_MESH_SCRIPT = r"""
import json, sys, tempfile
from pytorch_distributed_nn_tpu_torch.experiments import (
    RunnerConfig, SweepRunner, SweepSpec)
from pytorch_distributed_nn_tpu_torch.experiments import scheduler
from pytorch_distributed_nn_tpu_torch.experiments.runner import (
    _Attempt, synthetic_trial_main)
spec = SweepSpec.parse("lr=0.1")
runner = SweepRunner(spec, json.loads(sys.argv[1]),
                     RunnerConfig(sweep_dir=tempfile.mkdtemp(), max_steps=3,
                                  plan_mesh=2, device="cpu"),
                     trial_main=synthetic_trial_main)
trial = spec.trials()[0]
cfg = runner._trial_config(trial, scheduler.make_rungs("grid", 1, 3)[0],
                           _Attempt(trial))
print(json.dumps({"overrides": runner._plan_mesh_overrides("LeNet"),
                  "cfg": {k: cfg.get(k) for k in ("num_workers",
                          "tensor_parallel", "seq_parallel")},
                  "had_torch": "torch" in sys.modules}))
"""


def test_plan_mesh_gives_lenet_the_jax_runners_overrides(tmp_path):
    """``--plan-mesh 2 --device cpu``: the port's runner plans LeNet's
    mesh in a spawned subprocess (the orchestrator imports no torch) and
    its trials get the JAX runner's overrides for the same base config."""
    base = {"network": "LeNet", "dataset": "MNIST", "batch_size": 16,
            "optimizer": "sgd", "lr": 0.1, "faults": None}
    out = subprocess.run(
        [sys.executable, "-c", PLAN_MESH_SCRIPT, json.dumps(base)],
        cwd=REPO, env=SUBPROCESS_ENV, capture_output=True, text=True,
        timeout=180)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    want = jax_runner.SweepRunner(
        jax_spec.SweepSpec.parse("lr=0.1"), base,
        jax_runner.RunnerConfig(sweep_dir=str(tmp_path / "jax"),
                                max_steps=3, plan_mesh=2),
    )._plan_mesh_overrides("LeNet")
    assert want == {"num_workers": 1, "tensor_parallel": 1,
                    "seq_parallel": 1}
    assert got == {"overrides": want, "cfg": want, "had_torch": False}

