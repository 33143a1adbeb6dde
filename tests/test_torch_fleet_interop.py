"""The port's fleet held against the JAX package's (``experiments/fleet``
of each): the pure placement and mesh functions give the same answers;
each package's client speaks to the other's agent over the one wire;
each package folds the other's fleet journal and renders it to the same
text; and a 3-agent synthetic ASHA fleet of the port with an agent
SIGKILLed mid-rung ranks its trials byte for byte as the JAX package's
single-host ``SweepRunner`` does on the same spec. ``fleet --selftest``
holds the JAX selftest's checks under their names, and that its
orchestrator and agents import no torch."""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from pytorch_distributed_nn_tpu.experiments import (
    RunnerConfig as JaxRunnerConfig,
)
from pytorch_distributed_nn_tpu.experiments import (
    SweepRunner as JaxSweepRunner,
)
from pytorch_distributed_nn_tpu.experiments import SweepSpec as JaxSweepSpec
from pytorch_distributed_nn_tpu.experiments import journal as jax_jr
from pytorch_distributed_nn_tpu.experiments import report as jax_report
from pytorch_distributed_nn_tpu.experiments.fleet import (
    FleetConfig as JaxFleetConfig,
)
from pytorch_distributed_nn_tpu.experiments.fleet import (
    FleetScheduler as JaxFleetScheduler,
)
from pytorch_distributed_nn_tpu.experiments.fleet import (
    LocalTransport as JaxLocalTransport,
)
from pytorch_distributed_nn_tpu.experiments.fleet import scheduler as jax_sched
from pytorch_distributed_nn_tpu.experiments.fleet import transport as jax_tr
from pytorch_distributed_nn_tpu.experiments.runner import (
    synthetic_trial_main as jax_synthetic_trial_main,
)
from pytorch_distributed_nn_tpu_torch.experiments import SweepSpec
from pytorch_distributed_nn_tpu_torch.experiments import journal as jr
from pytorch_distributed_nn_tpu_torch.experiments import report
from pytorch_distributed_nn_tpu_torch.experiments.fleet import (
    FleetConfig,
    FleetScheduler,
    LocalTransport,
)
from pytorch_distributed_nn_tpu_torch.experiments.fleet import (
    scheduler as sched,
)
from pytorch_distributed_nn_tpu_torch.experiments.fleet import transport as tr
from torch_cpu import SUBPROCESS_ENV

SYNTH_BASE = {"network": "SynthNet", "lr": 0.1, "batch_size": 32,
              "faults": None}
#: six trials, one divergent: ASHA rungs of 1, 3 and 9 steps
ASHA_SPEC = "lr=0.4,0.2,0.1,0.05,0.025,2.0"
ASHA_KW = dict(max_steps=9, scheduler="asha", eta=3, retries=1,
               retry_base_delay=0.01)
ASHA_BASE = dict(SYNTH_BASE, step_sleep=0.15)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# the pure functions
# ---------------------------------------------------------------------------


def _host_sets(seed, n=40):
    """``n`` draws of (hosts as field dicts, inflight, dead, need)."""
    rng = np.random.RandomState(seed)
    for _ in range(n):
        hosts = [dict(agent_id=f"a{k}", host="h", port=k,
                      devices=int(rng.choice([1, 2, 4, 8])),
                      capacity=int(rng.randint(1, 4)),
                      draining=bool(rng.rand() < 0.2))
                 for k in rng.permutation(int(rng.randint(1, 6)))]
        inflight = {h["agent_id"]: set(range(int(rng.randint(0, 4))))
                    for h in hosts if rng.rand() < 0.7}
        dead = {h["agent_id"] for h in hosts if rng.rand() < 0.25}
        need = [None, 1, 2, 4, 8][rng.randint(5)]
        yield hosts, inflight, dead, need


@pytest.mark.parametrize("seed", range(4))
def test_place_trial_equals_jax(seed):
    for hosts, inflight, dead, need in _host_sets(seed):
        got = sched.place_trial([tr.AgentInfo(**h) for h in hosts],
                                inflight, dead, need_devices=need)
        want = jax_sched.place_trial([jax_tr.AgentInfo(**h) for h in hosts],
                                     inflight, dead, need_devices=need)
        assert (got and got.agent_id) == (want and want.agent_id)


def _mesh_outcome(fn, info_cls, cfg, devices):
    try:
        return fn(cfg, info_cls("h", "h", 1, devices=devices), plan=False)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("seed", range(4))
def test_host_mesh_overrides_equals_jax(seed):
    rng = np.random.RandomState(100 + seed)
    for _ in range(60):
        cfg = {"network": "BertTiny",
               "num_workers": [None, 0, 1, 2, 3, 4, 8, 16][rng.randint(8)],
               "tensor_parallel": [None, 1, 2, 4][rng.randint(4)],
               "seq_parallel": [None, 1, 2][rng.randint(3)],
               "batch_size": int(rng.choice([8, 12, 16, 32, 48, 96]))}
        devices = int(rng.choice([1, 2, 4, 8]))
        assert _mesh_outcome(sched.host_mesh_overrides, tr.AgentInfo, cfg,
                             devices) == _mesh_outcome(
            jax_sched.host_mesh_overrides, jax_tr.AgentInfo, cfg, devices)


# ---------------------------------------------------------------------------
# the wire: each package's client against the other's agent
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def agents(tmp_path_factory):
    """One local agent of each package, on the CPU."""
    root = tmp_path_factory.mktemp("agents")
    port = LocalTransport(fleet_dir=str(root / "port"), agents=1,
                          device="cpu", lease=30.0, call_timeout=2.0)
    jax = JaxLocalTransport(fleet_dir=str(root / "jax"), agents=1,
                            platform="cpu", lease=30.0, call_timeout=2.0)
    port.start()
    try:
        jax.start()
        try:
            yield {"port": port.agents()[0], "jax": jax.agents()[0],
                   "root": str(root)}
        finally:
            jax.close()
    finally:
        port.close()


def test_hello_has_the_same_keys(agents):
    port = tr.call_once(agents["port"].addr, {"op": "hello"})
    jax = jax_tr.call_once(agents["jax"].addr, {"op": "hello"})
    assert sorted(port) == sorted(jax)
    assert {k: type(v) for k, v in port.items()} == {
        k: type(v) for k, v in jax.items()}
    assert port["profile"]["backend"] == "cpu"


@pytest.mark.parametrize("client,agent", [("port", "jax"), ("jax", "port")])
def test_client_assigns_and_polls_the_other_packages_agent(
        agents, client, agent):
    call_once = (tr if client == "port" else jax_tr).call_once
    addr = agents[agent].addr
    tdir = os.path.join(agents["root"], f"{client}-to-{agent}")
    idx = 0 if client == "port" else 1
    hello = call_once(addr, {"op": "hello"})
    assert hello["ok"] and hello["running"] == []
    r = call_once(addr, {"op": "assign", "trial": idx, "trial_dir": tdir,
                         "cfg": dict(SYNTH_BASE, max_steps=3, seed=1,
                                     resume=False),
                         "main": "synthetic", "env": {}})
    assert r["ok"] and r["pid"] > 0
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        r = call_once(addr, {"op": "poll", "trial": idx})
        if r["state"] == "exited":
            break
        time.sleep(0.05)
    assert r == {"ok": True, "state": "exited", "rc": 0}
    from pytorch_distributed_nn_tpu_torch.observability import reader

    assert [s["step"] for s in reader.read_stream(tdir).steps] == [1, 2, 3]
    refused = call_once(addr, {"op": "assign", "trial": 9,
                               "trial_dir": tdir, "cfg": {},
                               "main": "__import__"})
    assert refused["ok"] is False and "unknown trial main" in refused["error"]


# ---------------------------------------------------------------------------
# a killed fleet of each package: journals and the leaderboard
# ---------------------------------------------------------------------------


def _killed_fleet(sdir, jax: bool):
    """A 3-agent synthetic ASHA fleet of one package with agent0
    SIGKILLed once a trial of its streams; returns (result, killed)."""
    Transport = JaxLocalTransport if jax else LocalTransport
    device_kw = {"platform": "cpu"} if jax else {"device": "cpu"}
    transport = Transport(fleet_dir=os.path.join(sdir, "fleet"), agents=3,
                          devices=[1, 1, 1], capacity=1, lease=1.5,
                          call_timeout=0.5, **device_kw)
    if jax:
        fs = JaxFleetScheduler(
            JaxSweepSpec.parse(ASHA_SPEC), ASHA_BASE,
            JaxFleetConfig(sweep_dir=sdir, lease=1.5, call_timeout=0.5,
                           trial_main_name="synthetic", **ASHA_KW),
            transport=transport)
        load = jax_jr.load_journal
    else:
        fs = FleetScheduler(
            SweepSpec.parse(ASHA_SPEC), ASHA_BASE,
            FleetConfig(sweep_dir=sdir, lease=1.5, call_timeout=0.5,
                        trial_main_name="synthetic", device="cpu",
                        **ASHA_KW),
            transport=transport)
        load = jr.load_journal
    result, err = {}, []

    def drive():
        try:
            result.update(fs.run())
        except Exception as e:
            err.append(e)

    thread = threading.Thread(target=drive)
    thread.start()
    killed = False
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and thread.is_alive():
            j = load(sdir)
            if j is not None and any(
                    st.in_flight and st.host == "agent0" and os.path.isfile(
                        os.path.join(jr.trial_dir(sdir, i),
                                     "telemetry.jsonl"))
                    for i, st in j.trials.items()):
                transport.kill_agent("agent0")
                killed = True
                break
            time.sleep(0.05)
        thread.join(120)
        assert not thread.is_alive(), "fleet run hung"
    finally:
        transport.close()
    if err:
        raise err[0]
    return result, killed


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    root = tmp_path_factory.mktemp("fleets")
    out = {}
    for name in ("port", "jax"):
        sdir = str(root / name)
        result, killed = _killed_fleet(sdir, jax=name == "jax")
        assert killed and result["failed"] == []
        out[name] = (sdir, result)
    return out


def test_killed_fleet_leaderboard_is_the_jax_single_host_ones(
        fleets, tmp_path):
    ref = JaxSweepRunner(
        JaxSweepSpec.parse(ASHA_SPEC), ASHA_BASE,
        JaxRunnerConfig(sweep_dir=str(tmp_path / "ref"), concurrency=3,
                        **ASHA_KW),
        trial_main=jax_synthetic_trial_main,
    ).run()
    sdir, result = fleets["port"]
    j = jr.load_journal(sdir)
    assert j.hosts["agent0"]["state"] == "dead" and j.migrations >= 1

    def key(rows):
        return [(r["trial"], r["steps"], r["loss"]) for r in rows]

    assert key(result["leaderboard"]) == key(ref["leaderboard"])


@pytest.mark.parametrize("written_by", ["port", "jax"])
def test_each_package_folds_the_others_fleet_journal(fleets, written_by):
    sdir, _ = fleets[written_by]
    port = jr.load_journal(sdir)
    jax = jax_jr.load_journal(sdir)
    assert port.hosts == jax.hosts and port.migrations == jax.migrations
    assert port.hosts["agent0"]["state"] == "dead"
    assert {i: (s.status, s.host, s.migrations, s.starts, s.last_end)
            for i, s in port.trials.items()} == {
        i: (s.status, s.host, s.migrations, s.starts, s.last_end)
        for i, s in jax.trials.items()}
    assert report.render_fleet(port) == jax_report.render_fleet(jax)
    assert report.render_status(port) == jax_report.render_status(jax)
    assert "migrated 1x" in report.render_fleet(port)


#: the JAX selftest's checks in its order, the last naming the process
#: that must not import the framework (JAX: jax), and the port's check
#: of its agents before it
SELFTEST_CHECKS = [
    "cache key: stable, order-insensitive, version-sensitive",
    "cache: miss then hit round-trips the value",
    "cache: identity mismatch degrades to a miss",
    "placement: most free slots wins, draining skipped",
    "placement: device need beats idleness; dead hosts skipped",
    "mesh: requested dp beyond the host caps via the elastic K-of-N "
    "walk-down",
    "mesh: planner profile served from the shared cache",
    "transport: refused calls retry with backoff, then stay within-lease "
    "transient",
    "transport: a failure past the lease declares the agent DEAD, exactly "
    "once",
    "fleet e2e: victim agent SIGKILLed mid-flight, sweep finished anyway",
    "fleet e2e: host_dead journaled and folded (lease conviction)",
    "fleet e2e: the victim's trials migrated without spending retry budget",
    "fleet e2e: leaderboard byte-identical to the single-host pool",
    "obs summary: fleet section renders hosts + migrations",
    "fleet gauges: valid exposition with host/inflight families",
    "agents stayed torch-free (trial ranks import torch in their own "
    "processes)",
    "orchestrator stayed torch-free (trials import torch in their own "
    "processes)",
]


def test_selftest_holds_every_check_and_imports_no_torch():
    """``fleet --selftest`` in a process of its own (this one imports
    torch): rc 0, every check of the JAX selftest held under its name,
    the orchestrator's and the agents' freedom from torch among them."""
    out = subprocess.run(
        [sys.executable, "-m", "pytorch_distributed_nn_tpu_torch", "fleet",
         "--selftest"], cwd=REPO, env=SUBPROCESS_ENV, capture_output=True,
        text=True, timeout=180)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    held = [ln[len("  [ok ] "):] for ln in out.stdout.splitlines()
            if ln.startswith("  [ok ] ")]
    assert held == SELFTEST_CHECKS
    assert out.stdout.splitlines()[-1] == (
        f"fleet selftest: {len(SELFTEST_CHECKS)}/{len(SELFTEST_CHECKS)} "
        "checks passed")
