"""``sweep --selftest``: the sweep layer's <15 s invariants (the port's
copy of the JAX package's ``experiments/selftest.py``).

Covers what a CI box can prove without training anything real: the spec
grammar (good specs round-trip, bad specs fail fast), per-trial seed
determinism, ASHA rung/budget math (including the <= 50%-of-grid plan the
acceptance criterion measures), promotion determinism, and an end-to-end
mini-sweep over :func:`~.runner.synthetic_trial_main` — real subprocesses,
real journal, injected crash + retry, a divergent trial, a SIGTERM-free
resume — finished with torn-tail recovery and Prometheus exposition
validity. The sweep must not import torch into the orchestrating
process.
"""

from __future__ import annotations

import json
import os
import tempfile


def run_selftest() -> int:
    import sys

    had_torch = "torch" in sys.modules
    from pytorch_distributed_nn_tpu_torch.experiments import (
        journal as jr,
    )
    from pytorch_distributed_nn_tpu_torch.experiments import (
        report,
        scheduler,
        spec as spec_mod,
    )
    from pytorch_distributed_nn_tpu_torch.experiments.runner import (
        RunnerConfig,
        SweepRunner,
        synthetic_trial_main,
    )
    from pytorch_distributed_nn_tpu_torch.observability.promexport import (
        render,
        validate_exposition,
    )

    checks = []

    def check(name, ok, detail=""):
        checks.append((name, bool(ok), detail))

    # -- spec grammar -----------------------------------------------------
    s = spec_mod.SweepSpec.parse("lr=0.1,0.01;batch_size=32,64")
    trials = s.trials()
    check("grid spec enumerates the cartesian product",
          len(trials) == 4
          and trials[0].overrides == {"lr": 0.1, "batch_size": 32}
          and trials[3].overrides == {"lr": 0.01, "batch_size": 64},
          f"{[t.overrides for t in trials]}")
    check("spec describe round-trips",
          spec_mod.SweepSpec.parse(s.describe()).describe() == s.describe(),
          s.describe())
    bad = 0
    for text, kw in (
        ("learning=0.1", {}),  # unknown field
        ("train_dir=/tmp", {}),  # reserved field
        ("lr=1e-4..1e-1", {}),  # range without samples
        ("lr=log:0..1", {"samples": 4}),  # log range needs lo > 0
        ("lr=0.1;lr=0.2", {}),  # duplicate axis
        ("lr=abc", {}),  # uncoercible value
    ):
        try:
            spec_mod.SweepSpec.parse(text, **kw)
        except ValueError:
            bad += 1
    check("bad specs fail fast at parse time", bad == 6, f"{bad}/6 raised")
    r = spec_mod.SweepSpec.parse("lr=log:1e-4..1e-1", samples=5,
                                 sweep_seed=7)
    ra, rb = r.trials(), r.trials()
    check("random sampling is deterministic under sweep_seed",
          [t.overrides for t in ra] == [t.overrides for t in rb]
          and all(1e-4 <= t.overrides["lr"] <= 1e-1 for t in ra),
          f"{[t.overrides['lr'] for t in ra]}")
    check("per-trial seeds: SeedSequence((sweep_seed, i)), stable+distinct",
          spec_mod.trial_seed(0, 1) == spec_mod.trial_seed(0, 1)
          and len({spec_mod.trial_seed(0, i) for i in range(32)}) == 32
          and spec_mod.trial_seed(0, 1) != spec_mod.trial_seed(1, 1))

    # -- scheduler math ---------------------------------------------------
    for n, max_steps in ((7, 100), (12, 100)):
        grid = scheduler.grid_rungs(n, max_steps)
        asha = scheduler.asha_rungs(n, max_steps, eta=3)
        budgets = [r.budget for r in asha]
        keeps = [r.keep for r in asha]
        check(
            f"asha rungs well-formed (n={n})",
            budgets == sorted(set(budgets)) and budgets[-1] == max_steps
            and keeps[0] == n and keeps[-1] >= 1
            and all(a >= b for a, b in zip(keeps, keeps[1:])),
            f"budgets={budgets} keeps={keeps}",
        )
        ratio = scheduler.planned_steps(asha) / scheduler.planned_steps(grid)
        check(
            f"asha plans <= 50% of the grid budget (n={n})",
            ratio <= 0.5,
            f"{scheduler.planned_steps(asha)}/"
            f"{scheduler.planned_steps(grid)} = {ratio:.0%}",
        )
    promoted = scheduler.promote(
        {0: 0.5, 1: 0.1, 2: float("nan"), 3: 0.1, 4: float("inf")}, 3
    )
    check("promotion deterministic: finite first, ties on index",
          promoted == [1, 3, 0], f"{promoted}")

    # -- end-to-end mini-sweep over the synthetic trial main --------------
    with tempfile.TemporaryDirectory(prefix="pdtn_sweep_selftest_") as d:
        sdir = os.path.join(d, "sweep")
        sp = spec_mod.SweepSpec.parse("lr=0.5,0.05,10.0")
        base = {"network": "SynthNet", "lr": 0.1, "faults": None,
                "batch_size": 32}
        runner = SweepRunner(
            sp, base,
            RunnerConfig(sweep_dir=sdir, max_steps=9, concurrency=2,
                         retries=1, scheduler="asha", eta=3,
                         retry_base_delay=0.01),
            trial_main=synthetic_trial_main,
        )
        result = runner.run()
        check("mini-sweep: asha finds the planted optimum",
              result["best"] is not None
              and result["best"]["overrides"].get("lr") == 0.05,
              f"best={result['best']}")
        check("mini-sweep: executed steps within the planned budget",
              0 < result["executed_steps"] <= result["planned_steps"],
              f"{result['executed_steps']} vs plan "
              f"{result['planned_steps']}")
        with open(jr.journal_path(sdir)) as f:
            first = json.loads(f.readline())
        check("journal is manifest-first and carries the spec",
              first.get("kind") == "manifest"
              and (first.get("sweep") or {}).get("spec") == sp.describe(),
              f"kind={first.get('kind')}")
        jstate = jr.load_journal(sdir)
        check("divergent trial leaves typed nonfinite_skip evidence",
              any(e.get("type") == "nonfinite_skip"
                  and e.get("trial") == 2 for e in jstate.events))
        rows = report.leaderboard(sdir, jstate)
        text = report.render_leaderboard(rows)
        check("leaderboard renders loss/steps-rate/mfu columns",
              "loss" in text and "steps/s" in text and "mfu" in text
              and rows[0]["overrides"].get("lr") == 0.05, text.split("\n")[0])
        check("obs-style per-trial stream readable",
              report.trial_metrics(jr.trial_dir(sdir, 1)) is not None)
        exposition = render(runner.journal.registry)
        errs = validate_exposition(exposition)
        check("sweep gauges render valid Prometheus exposition",
              not errs and "sweep_trials_total" in exposition,
              "; ".join(errs[:3]))

        # torn tail: a kill mid-append must cost at most the final line
        with open(jr.journal_path(sdir), "a") as f:
            f.write('{"kind": "event", "type": "trial_end", "trial":')
        torn = jr.load_journal(sdir)
        check("torn journal tail tolerated; completed trials intact",
              torn.truncated
              and len(torn.results_at(0)) == len(jstate.results_at(0)))

        # resume over a finished sweep: pure journal replay, nothing re-run
        resumed = SweepRunner(
            sp, base,
            RunnerConfig(sweep_dir=sdir, max_steps=9, concurrency=2,
                         retries=1, scheduler="asha", eta=3, resume=True),
            trial_main=synthetic_trial_main,
        ).run()
        check("resume of a finished sweep re-runs nothing",
              resumed["executed_steps"] == 0
              and [r["loss"] for r in resumed["leaderboard"]]
              == [r["loss"] for r in result["leaderboard"]],
              f"executed={resumed['executed_steps']}")

        # crash + retry classification through a real subprocess
        sdir2 = os.path.join(d, "crash")
        r2 = SweepRunner(
            spec_mod.SweepSpec.parse("lr=0.05"),
            dict(base, faults="crash@3"),
            RunnerConfig(sweep_dir=sdir2, max_steps=6, concurrency=1,
                         retries=1, retry_base_delay=0.01),
            trial_main=synthetic_trial_main,
        ).run()
        j2 = jr.load_journal(sdir2)
        st = j2.trials.get(0)
        check("crashed attempt retried with backoff, resumed, completed",
              r2["failed"] == [] and st is not None and st.starts == 2
              and any(e.get("type") == "retry" for e in j2.events)
              and st.status == "completed",
              f"starts={getattr(st, 'starts', None)}")

    check("the orchestrator imported no torch",
          had_torch or "torch" not in sys.modules)

    failed = [(n, d_) for n, ok, d_ in checks if not ok]
    for name, ok, detail in checks:
        mark = "ok " if ok else "FAIL"
        print(f"  [{mark}] {name}" + (f" — {detail}" if detail and not ok
                                      else ""))
    print(f"sweep selftest: {len(checks) - len(failed)}/{len(checks)} "
          f"checks passed")
    return 1 if failed else 0
