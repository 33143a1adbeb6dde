"""``cli fleet --selftest``: the fleet layer's <15 s lint-time invariants
(the port's copy of the JAX package's ``experiments/fleet/selftest.py``:
its checks, in its order, under its names).

What a CI box can prove without training anything real: cache
content-addressing (hit/miss/identity-conviction), capacity-aware
placement and per-host mesh assignment as pure functions, transport
retry-backoff and lease-based dead-agent declaration, the agent protocol
over REAL local agent subprocesses (hello/assign/poll/drain), and the
headline end-to-end: a synthetic mini-sweep over 3 local agents with one
agent SIGKILLed mid-flight — its trials migrate without spending retry
budget, the sweep completes with a leaderboard byte-identical to the
single-host pool's, the journal folds back the host roster, and the
fleet gauges render valid Prometheus exposition. Then it asserts that
the surviving agent processes never loaded torch (their memory maps hold
no file of the torch package), and finishes by asserting that the
orchestrator process NEVER imported torch.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time


def loaded_torch(pid: int) -> bool:
    """Whether process ``pid`` has mapped a file of the torch package
    (``/proc/<pid>/maps``): importing torch loads its shared libraries."""
    with open(f"/proc/{pid}/maps") as f:
        return any(f"{os.sep}torch{os.sep}" in line for line in f)


def run_selftest() -> int:
    from pytorch_distributed_nn_tpu_torch.experiments import (
        RunnerConfig,
        SweepRunner,
        SweepSpec,
        load_journal,
    )
    from pytorch_distributed_nn_tpu_torch.experiments.fleet.cache import (
        FleetCache,
        cache_key,
    )
    from pytorch_distributed_nn_tpu_torch.experiments.fleet.scheduler import (
        FleetConfig,
        FleetScheduler,
        host_mesh_overrides,
        place_trial,
    )
    from pytorch_distributed_nn_tpu_torch.experiments.fleet.transport import (
        AgentDead,
        AgentInfo,
        AgentRefused,
        AgentUnreachable,
        FleetTransport,
        LocalTransport,
    )
    from pytorch_distributed_nn_tpu_torch.experiments.runner import (
        synthetic_trial_main,
    )
    from pytorch_distributed_nn_tpu_torch.observability.promexport import (
        render,
        validate_exposition,
    )

    checks = []

    def check(name, ok, detail=""):
        checks.append((name, bool(ok), detail))

    # -- cache: content addressing ---------------------------------------
    with tempfile.TemporaryDirectory(prefix="pdtn_fleet_cache_") as d:
        cache = FleetCache(d)
        check("cache key: stable, order-insensitive, version-sensitive",
              cache_key("plan", model="LeNet", devices=2, torch="2.5")
              == cache_key("plan", devices=2, torch="2.5", model="LeNet")
              and cache_key("plan", model="LeNet", devices=2, torch="2.5")
              != cache_key("plan", model="LeNet", devices=2,
                           torch="2.6"))
        miss = cache.get("plan", model="LeNet", devices=2)
        cache.put("plan", {"num_workers": 2}, model="LeNet", devices=2)
        hit = cache.get("plan", model="LeNet", devices=2)
        check("cache: miss then hit round-trips the value",
              miss is None and hit == {"num_workers": 2}
              and cache.stats()["hits"] == 1
              and cache.stats()["misses"] == 1, f"{cache.stats()}")
        # identity conviction: a colliding/hand-edited entry is a miss
        path = cache._path("plan", {"model": "LeNet", "devices": 2})
        with open(path, "w") as f:
            json.dump({"kind": "plan", "ident": {"model": "VGG11",
                                                 "devices": 2},
                       "value": {"num_workers": 8}}, f)
        check("cache: identity mismatch degrades to a miss",
              cache.get("plan", model="LeNet", devices=2) is None)

    # -- placement: pure function ----------------------------------------
    hosts = [
        AgentInfo("a", "h", 1, devices=2, capacity=2),
        AgentInfo("b", "h", 2, devices=4, capacity=1),
        AgentInfo("c", "h", 3, devices=8, capacity=1, draining=True),
    ]
    check("placement: most free slots wins, draining skipped",
          place_trial(hosts, {"a": set(), "b": set()}, set()).agent_id
          == "a"
          and place_trial(hosts, {"a": {1, 2}, "b": set()},
                          set()).agent_id == "b")
    check("placement: device need beats idleness; dead hosts skipped",
          place_trial(hosts, {"a": set(), "b": set()}, set(),
                      need_devices=4).agent_id == "b"
          and place_trial(hosts, {"a": set(), "b": set()},
                          {"a", "b"}) is None
          and place_trial(hosts, {"a": {1, 2}, "b": {3}}, set()) is None)

    # -- per-host mesh assignment ----------------------------------------
    with tempfile.TemporaryDirectory(prefix="pdtn_fleet_mesh_") as d:
        from pytorch_distributed_nn_tpu_torch.experiments.fleet.cache import (
            torch_version,
        )

        cache = FleetCache(d)
        small = AgentInfo("s", "h", 1, devices=2,
                          profile={"backend": "cpu"})
        capped = host_mesh_overrides(
            {"network": "LeNet", "num_workers": 8, "batch_size": 32},
            small,
        )
        check("mesh: requested dp beyond the host caps via the elastic "
              "K-of-N walk-down",
              capped.get("num_workers") == 2, f"{capped}")
        cache.put("plan", {"num_workers": 2, "tensor_parallel": 1,
                           "seq_parallel": 1},
                  model="LeNet", devices=2, backend="cpu",
                  torch=torch_version())
        planned = host_mesh_overrides(
            {"network": "LeNet", "batch_size": 32}, small,
            cache=cache, plan=True,
        )
        check("mesh: planner profile served from the shared cache",
              planned.get("num_workers") == 2
              and cache.stats()["hits"] == 1, f"{planned}")

    # -- transport: backoff + lease --------------------------------------
    sleeps = []
    t = FleetTransport(lease=3600.0, call_timeout=0.2, attempts=3,
                       retry_base_delay=0.01, sleep=sleeps.append)
    t._agents["ghost"] = AgentInfo("ghost", "127.0.0.1", 1)  # nothing there
    t._last_ok["ghost"] = time.monotonic()
    try:
        t.call("ghost", "ping")
        outcome = "no error"
    except AgentUnreachable:
        outcome = "unreachable"
    except AgentDead:
        outcome = "dead"
    check("transport: refused calls retry with backoff, then stay "
          "within-lease transient",
          outcome == "unreachable" and len(sleeps) == 2
          and sleeps[1] > sleeps[0] * 0.9,
          f"outcome={outcome} sleeps={sleeps}")
    t._last_ok["ghost"] = time.monotonic() - 7200.0
    try:
        t.call("ghost", "ping")
        outcome = "no error"
    except AgentDead:
        outcome = "dead"
    except AgentUnreachable:
        outcome = "unreachable"
    check("transport: a failure past the lease declares the agent DEAD, "
          "exactly once",
          outcome == "dead" and t.is_dead("ghost")
          and t.take_newly_dead() == ["ghost"]
          and t.take_newly_dead() == [],
          f"outcome={outcome}")

    # -- the protocol over real local agents + migration e2e -------------
    with tempfile.TemporaryDirectory(prefix="pdtn_fleet_selftest_") as d:
        base = {"network": "SynthNet", "lr": 0.1, "faults": None,
                "step_sleep": 0.15}
        spec = SweepSpec.parse("lr=0.5,0.05,10.0,0.2,0.02,0.1")
        # reference: the single-host pool on the same spec — synthetic
        # loss is a pure function of (lr, seed, step), so the fleet must
        # reproduce it byte-identically even across a migration
        ref = SweepRunner(
            spec, base,
            RunnerConfig(sweep_dir=os.path.join(d, "ref"), max_steps=4,
                         concurrency=3, retries=1,
                         retry_base_delay=0.01),
            trial_main=synthetic_trial_main,
        ).run()

        sdir = os.path.join(d, "fleet")
        transport = LocalTransport(
            fleet_dir=os.path.join(sdir, "fleet"), agents=3,
            devices=[1, 2, 4], capacity=1, device="cpu", lease=1.5,
            call_timeout=0.5,
        )
        fs = FleetScheduler(
            spec, base,
            FleetConfig(sweep_dir=sdir, max_steps=4, retries=1,
                        retry_base_delay=0.01, lease=1.5,
                        call_timeout=0.5,
                        trial_main_name="synthetic"),
            transport=transport,
        )
        result = {}
        err = []

        def drive():
            try:
                result.update(fs.run())
            except Exception as e:  # pragma: no cover - surfaced below
                err.append(e)

        thread = threading.Thread(target=drive)
        thread.start()
        victim = "agent0"
        killed = False
        deadline = time.monotonic() + 30

        def victim_trial_streaming(j):
            # in flight on the victim AND its stream is open: the assign
            # definitely landed, so the kill preempts a RUNNING trial
            from pytorch_distributed_nn_tpu_torch.experiments import trial_dir

            for idx, st in j.trials.items():
                if not (st.in_flight and st.host == victim):
                    continue
                tp = os.path.join(trial_dir(sdir, idx),
                                  "telemetry.jsonl")
                if os.path.isfile(tp) and os.path.getsize(tp) > 0:
                    return True
            return False

        while time.monotonic() < deadline and thread.is_alive():
            j = load_journal(sdir)
            if j is not None and victim_trial_streaming(j):
                transport.kill_agent(victim)
                killed = True
                break
            time.sleep(0.05)
        thread.join(60)
        check("fleet e2e: victim agent SIGKILLed mid-flight, sweep "
              "finished anyway",
              killed and not thread.is_alive() and not err
              and result.get("failed") == [],
              f"killed={killed} err={err!r} "
              f"failed={result.get('failed')}")
        jf = load_journal(sdir)
        check("fleet e2e: host_dead journaled and folded "
              "(lease conviction)",
              jf is not None
              and jf.hosts.get(victim, {}).get("state") == "dead"
              and sum(1 for h in jf.hosts.values()
                      if h.get("state") == "alive") == 2,
              f"hosts={jf.hosts if jf else None}")
        migrated = [idx for idx, st in (jf.trials if jf else {}).items()
                    if st.migrations]
        check("fleet e2e: the victim's trials migrated without spending "
              "retry budget",
              len(migrated) >= 1 and all(
                  (jf.trials[i].last_end or {}).get("attempt") == 0
                  for i in migrated
              ),
              f"migrated={migrated}")

        def key(rows):
            return [(r["trial"], r["steps"], r["loss"]) for r in rows]

        check("fleet e2e: leaderboard byte-identical to the single-host "
              "pool",
              key(result.get("leaderboard", []))
              == key(ref["leaderboard"]),
              f"{key(result.get('leaderboard', []))} vs "
              f"{key(ref['leaderboard'])}")
        from pytorch_distributed_nn_tpu_torch.observability import reader

        summary = reader.summarize_run(reader.read_stream(sdir))
        fl = summary.get("fleet") or {}
        check("obs summary: fleet section renders hosts + migrations",
              fl.get("dead") == 1 and len(fl.get("migrations") or []) >= 1
              and "fleet:" in reader.render_summary(summary),
              f"{fl}")
        exposition = render(fs.journal.registry)
        errs = validate_exposition(exposition)
        check("fleet gauges: valid exposition with host/inflight "
              "families",
              not errs and 'pdtn_fleet_hosts{state="dead"} 1' in exposition
              and "pdtn_fleet_trials_inflight" in exposition
              and "pdtn_fleet_migrations_total" in exposition,
              "; ".join(errs[:3]) or exposition[:200])
        try:
            pids = [a.pid for a in transport.alive()]
            loaded = {pid: loaded_torch(pid) for pid in pids}
        except OSError as e:
            loaded = {"error": repr(e)}
        finally:
            transport.close()
        check("agents stayed torch-free (trial ranks import torch in "
              "their own processes)",
              len(loaded) == 2 and not any(loaded.values()),
              f"torch mapped by pid: {loaded}")

    check("orchestrator stayed torch-free (trials import torch in their "
          "own processes)", "torch" not in sys.modules)

    failed = [(n, d_) for n, ok, d_ in checks if not ok]
    for name, ok, detail in checks:
        mark = "ok " if ok else "FAIL"
        print(f"  [{mark}] {name}" + (f" — {detail}" if detail and not ok
                                      else ""))
    print(f"fleet selftest: {len(checks) - len(failed)}/{len(checks)} "
          f"checks passed")
    return 1 if failed else 0
