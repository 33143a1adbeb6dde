"""The port's fleet (``pytorch_distributed_nn_tpu_torch/experiments/
fleet``): the counterpart of ``tests/test_fleet.py``, every case of it
but the slow one under its name, on the port's agents (``--device cpu``)
and synthetic trials; the one real-trainer migration is chaos
``fleet_preempt --cases elastic`` (``test_torch_chaos_fleet.py``).

Beside them: the rank launcher a trial of several ranks runs on, and the
launch counts of a trial lifetime that was SIGKILLed. The cases that
hold the port against the JAX package are in
``test_torch_fleet_interop.py``.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from pytorch_distributed_nn_tpu_torch.experiments import (
    RunnerConfig,
    SweepRunner,
    SweepSpec,
    load_journal,
    trial_dir,
)
from pytorch_distributed_nn_tpu_torch.experiments import journal as jr
from pytorch_distributed_nn_tpu_torch.experiments import runner as port_runner
from pytorch_distributed_nn_tpu_torch.experiments.fleet import (
    AgentDead,
    AgentInfo,
    AgentRefused,
    AgentUnreachable,
    FleetCache,
    FleetConfig,
    FleetScheduler,
    LocalTransport,
    cache_key,
    host_mesh_overrides,
    place_trial,
)
from pytorch_distributed_nn_tpu_torch.experiments.fleet.cache import (
    torch_version,
)
from pytorch_distributed_nn_tpu_torch.experiments.fleet.transport import (
    FleetTransport,
)
from pytorch_distributed_nn_tpu_torch.experiments.runner import (
    synthetic_trial_main,
)
from pytorch_distributed_nn_tpu_torch.parallel import launch
from pytorch_distributed_nn_tpu_torch.parallel.launch import RankProcesses
from torch_cpu import SUBPROCESS_ENV

SYNTH_BASE = {"network": "SynthNet", "lr": 0.1, "batch_size": 32,
              "faults": None}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------


def test_cache_key_canonical_and_version_sensitive():
    a = cache_key("plan", model="LeNet", devices=4, torch="2.5.0")
    assert a == cache_key("plan", torch="2.5.0", devices=4, model="LeNet")
    assert a != cache_key("plan", model="LeNet", devices=2, torch="2.5.0")
    assert a != cache_key("plan", model="LeNet", devices=4, torch="2.5.1")
    assert a != cache_key("calibration", model="LeNet", devices=4,
                          torch="2.5.0")


def test_cache_hit_miss_and_identity_conviction(tmp_path):
    cache = FleetCache(str(tmp_path))
    assert cache.get("plan", model="LeNet", devices=4) is None
    cache.put("plan", {"num_workers": 4}, model="LeNet", devices=4)
    assert cache.get("plan", model="LeNet", devices=4) == {
        "num_workers": 4
    }
    assert cache.stats() == {"hits": 1, "misses": 1, "entries": 1}
    # a corrupted/colliding entry degrades to a miss, never a wrong value
    path = cache._path("plan", {"model": "LeNet", "devices": 4})
    with open(path, "w") as f:
        json.dump({"kind": "plan", "ident": {"model": "VGG11",
                                             "devices": 4},
                   "value": {"num_workers": 64}}, f)
    assert cache.get("plan", model="LeNet", devices=4) is None
    with open(path, "w") as f:
        f.write("{torn")
    assert cache.get("plan", model="LeNet", devices=4) is None


# ---------------------------------------------------------------------------
# placement + per-host mesh assignment (pure)
# ---------------------------------------------------------------------------


def _hosts():
    return [
        AgentInfo("a", "h", 1, devices=2, capacity=2),
        AgentInfo("b", "h", 2, devices=4, capacity=1),
        AgentInfo("c", "h", 3, devices=8, capacity=1),
    ]


def test_place_trial_capacity_aware():
    hosts = _hosts()
    empty = {h.agent_id: set() for h in hosts}
    # most free slots wins; ties break on agent id
    assert place_trial(hosts, empty, set()).agent_id == "a"
    assert place_trial(hosts, {"a": {0, 1}}, set()).agent_id == "b"
    # full fleet -> None (the attempt waits orchestrator-side)
    assert place_trial(hosts, {"a": {0, 1}, "b": {2}, "c": {3}},
                       set()) is None


def test_place_trial_prefers_enough_devices_and_skips_dead():
    hosts = _hosts()
    empty = {h.agent_id: set() for h in hosts}
    assert place_trial(hosts, empty, set(),
                       need_devices=4).agent_id == "b"
    assert place_trial(hosts, empty, {"b"},
                       need_devices=4).agent_id == "c"
    # nobody big enough: a starved host still beats nothing
    assert place_trial(hosts, empty, {"b", "c"},
                       need_devices=4).agent_id == "a"
    assert place_trial(hosts, empty, {"a", "b", "c"}) is None
    hosts[0].draining = True
    assert place_trial(hosts, empty, {"b", "c"}) is None


def test_host_mesh_overrides_caps_through_elastic_policy():
    small = AgentInfo("s", "h", 1, devices=2)
    capped = host_mesh_overrides(
        {"network": "LeNet", "num_workers": 8, "batch_size": 32}, small
    )
    assert capped == {"num_workers": 2}
    # fits: untouched
    assert host_mesh_overrides(
        {"network": "LeNet", "num_workers": 2, "batch_size": 32}, small
    ) == {}
    # tp*sp counts against the device budget
    capped = host_mesh_overrides(
        {"network": "BertTiny", "num_workers": 4, "tensor_parallel": 2,
         "batch_size": 32}, AgentInfo("m", "h", 1, devices=4)
    )
    assert capped == {"num_workers": 2}


def test_host_mesh_overrides_planner_profile_from_cache(tmp_path):
    cache = FleetCache(str(tmp_path))
    host = AgentInfo("s", "h", 1, devices=4,
                     profile={"backend": "cpu"})
    cache.put("plan", {"num_workers": 2, "tensor_parallel": 2,
                       "seq_parallel": 1},
              model="BertTiny", devices=4, backend="cpu",
              torch=torch_version())
    got = host_mesh_overrides(
        {"network": "BertTiny", "batch_size": 32}, host,
        cache=cache, plan=True,
    )
    assert got["num_workers"] == 2 and got["tensor_parallel"] == 2
    assert cache.stats()["hits"] == 1


# ---------------------------------------------------------------------------
# transport: lease + retry semantics
# ---------------------------------------------------------------------------


def _ghost_transport(lease, sleeps):
    t = FleetTransport(lease=lease, call_timeout=0.2, attempts=3,
                       retry_base_delay=0.01, sleep=sleeps.append)
    t._agents["ghost"] = AgentInfo("ghost", "127.0.0.1", 1)
    t._last_ok["ghost"] = time.monotonic()
    return t


def test_transport_backoff_on_transient_refusal():
    sleeps = []
    t = _ghost_transport(3600.0, sleeps)
    with pytest.raises(AgentUnreachable):
        t.call("ghost", "ping")
    # attempts=3 -> two backoff sleeps, exponentially growing
    assert len(sleeps) == 2 and sleeps[1] > sleeps[0]
    assert not t.is_dead("ghost")


def test_transport_lease_expiry_declares_dead_once():
    t = _ghost_transport(1.0, [])
    t._last_ok["ghost"] = time.monotonic() - 10.0
    with pytest.raises(AgentDead):
        t.call("ghost", "ping")
    assert t.is_dead("ghost")
    assert t.take_newly_dead() == ["ghost"]
    assert t.take_newly_dead() == []  # surfaced exactly once
    # a dead agent refuses further calls immediately
    with pytest.raises(AgentDead):
        t.call("ghost", "ping")


# ---------------------------------------------------------------------------
# agent protocol over a real local agent
# ---------------------------------------------------------------------------


@pytest.fixture
def one_agent(tmp_path):
    transport = LocalTransport(
        fleet_dir=str(tmp_path / "fleet"), agents=1, devices=1,
        capacity=1, device="cpu", lease=5.0, call_timeout=1.0,
    )
    transport.start()
    yield transport, str(tmp_path)
    transport.close()


def test_agent_hello_assign_poll_roundtrip(one_agent):
    transport, root = one_agent
    info = transport.agents()[0]
    assert info.devices == 1 and info.capacity == 1
    tdir = os.path.join(root, "t0")
    cfg = dict(SYNTH_BASE, max_steps=3, seed=1, resume=False)
    transport.call(info.agent_id, "assign", trial=0, trial_dir=tdir,
                   cfg=cfg, main="synthetic")
    # at capacity: a second assign is a typed refusal, never a queue
    with pytest.raises(AgentRefused):
        transport.call(info.agent_id, "assign", trial=1,
                       trial_dir=os.path.join(root, "t1"), cfg=cfg,
                       main="synthetic")
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        r = transport.call(info.agent_id, "poll", trial=0)
        if r["state"] == "exited":
            break
        time.sleep(0.05)
    assert r["state"] == "exited" and r["rc"] == 0
    # the trial wrote a real manifest-headed stream into its dir
    from pytorch_distributed_nn_tpu_torch.observability import reader

    rs = reader.read_stream(tdir)
    assert len(rs.steps) == 3
    # unknown trials poll as "unknown" (scheduler treats as crashed)
    assert transport.call(info.agent_id, "poll",
                          trial=99)["state"] == "unknown"
    # drain: running trials finish, new assigns refused
    transport.call(info.agent_id, "drain")
    with pytest.raises(AgentRefused):
        transport.call(info.agent_id, "assign", trial=2,
                       trial_dir=os.path.join(root, "t2"), cfg=cfg,
                       main="synthetic")
    assert transport.call(info.agent_id, "hello")["draining"] is True


def test_agent_rejects_unknown_trial_main(one_agent):
    transport, root = one_agent
    info = transport.agents()[0]
    with pytest.raises(AgentRefused):
        transport.call(info.agent_id, "assign", trial=0,
                       trial_dir=os.path.join(root, "t0"),
                       cfg=dict(SYNTH_BASE), main="__import__")


def test_agent_idle_timeout_self_terminates(tmp_path):
    transport = LocalTransport(
        fleet_dir=str(tmp_path / "fleet"), agents=1, devices=1,
        device="cpu", lease=0.5, call_timeout=1.0, idle_timeout=1.0,
    )
    transport.start()
    try:
        pid = transport.agents()[0].pid
        proc = transport._procs["agent0"]
        # no orchestrator contact: the orphan guard exits the agent
        deadline = time.monotonic() + 10
        while proc.poll() is None and time.monotonic() < deadline:
            time.sleep(0.1)
        assert proc.poll() == 0, f"agent {pid} did not self-terminate"
    finally:
        transport.close()


# ---------------------------------------------------------------------------
# fleet scheduler: migration + resume semantics
# ---------------------------------------------------------------------------


def _run_fleet(sdir, spec, base, *, kill_when=None, devices=(1, 1, 1),
               agents=3, **cfg_kw):
    """Drive a FleetScheduler; optionally SIGKILL agent0 when
    ``kill_when(journal)`` first returns True."""
    transport = LocalTransport(
        fleet_dir=os.path.join(sdir, "fleet"), agents=agents,
        devices=list(devices), capacity=1, device="cpu", lease=1.5,
        call_timeout=0.5,
    )
    kw = dict(sweep_dir=sdir, max_steps=4, retries=1,
              retry_base_delay=0.01, lease=1.5, call_timeout=0.5,
              trial_main_name="synthetic", device="cpu")
    kw.update(cfg_kw)
    fs = FleetScheduler(spec, base, FleetConfig(**kw),
                        transport=transport)
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
        if kill_when is not None:
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline and thread.is_alive():
                j = load_journal(sdir)
                if j is not None and kill_when(j):
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
    return fs, result, killed


def _victim_streaming(sdir):
    def ready(j):
        for idx, st in j.trials.items():
            if not (st.in_flight and st.host == "agent0"):
                continue
            tp = os.path.join(trial_dir(sdir, idx), "telemetry.jsonl")
            if os.path.isfile(tp) and os.path.getsize(tp) > 0:
                return True
        return False

    return ready


def test_fleet_migration_byte_identity_vs_single_host(tmp_path):
    """The headline contract: a host SIGKILLed mid-sweep costs nothing —
    migrated trials resume where they stopped and the leaderboard is
    byte-identical to the single-host pool's (and therefore to a fresh
    `--resume`: both read the same journal + streams)."""
    spec = SweepSpec.parse("lr=0.5,0.05,10.0,0.2,0.02,0.1")
    base = dict(SYNTH_BASE, step_sleep=0.15)
    ref = SweepRunner(
        spec, base,
        RunnerConfig(sweep_dir=str(tmp_path / "ref"), max_steps=4,
                     concurrency=3, retries=1, retry_base_delay=0.01),
        trial_main=synthetic_trial_main,
    ).run()
    sdir = str(tmp_path / "fleet")
    fs, result, killed = _run_fleet(
        sdir, spec, base, kill_when=_victim_streaming(sdir),
    )
    assert killed and result["failed"] == []
    j = load_journal(sdir)
    migrated = [idx for idx, st in j.trials.items() if st.migrations]
    assert migrated, "no trial migrated off the killed host"
    # migration spent no retry budget: final attempt number is still 0
    assert all(
        (j.trials[i].last_end or {}).get("attempt") == 0
        for i in migrated
    )
    # the migrated trial RESUMED (second lifetime in its stream) rather
    # than restarting: its stream holds a restart manifest
    from pytorch_distributed_nn_tpu_torch.observability import reader

    resumed = [
        i for i in migrated
        if len(reader.read_stream(trial_dir(sdir, i)).manifests) >= 2
    ]
    assert resumed == migrated

    def key(rows):
        return [(r["trial"], r["steps"], r["loss"]) for r in rows]

    assert key(result["leaderboard"]) == key(ref["leaderboard"])
    # journal fold reconstructs the fleet: dead host + survivors
    assert j.hosts["agent0"]["state"] == "dead"
    assert sum(1 for h in j.hosts.values()
               if h["state"] == "alive") == 2
    assert j.migrations == len(migrated)


def _fleet_cli_popen(*args):
    return subprocess.Popen(
        [sys.executable, "-m", "pytorch_distributed_nn_tpu_torch", "fleet",
         *args],
        cwd=REPO, env=SUBPROCESS_ENV, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL, start_new_session=True,
    )


def test_fleet_journal_reconstruction_after_orchestrator_kill(tmp_path):
    """SIGKILL the ORCHESTRATOR (cli fleet run) mid-sweep; `fleet run
    --resume` replays the journal against a fresh fleet: completed
    trials reused byte-identically, in-flight ones re-dispatched."""
    sdir = str(tmp_path / "sweep")
    spec_text = "lr=0.5,0.05,0.2,0.02"
    proc = _fleet_cli_popen(
        "run", "--sweep-dir", sdir, "--spec", spec_text,
        "--steps", "12", "--agents", "2", "--lease", "1.0",
        "--synthetic-trials", "--step-sleep", "0.25",
    )
    deadline = time.time() + 60
    killed = False
    while time.time() < deadline and proc.poll() is None:
        j = load_journal(sdir)
        done = sum(1 for st in (j.trials if j else {}).values()
                   if st.status == "completed")
        inflight = any(st.in_flight for st in (j.trials or {}).values()) \
            if j else False
        if j is not None and done >= 1 and inflight:
            os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
            killed = True
            break
        time.sleep(0.1)
    proc.wait(timeout=30)
    assert killed, "never saw completed+in-flight mix before the deadline"
    j_kill = load_journal(sdir)
    assert j_kill is not None and j_kill.hosts  # host_join folded back
    pre_done = {
        idx: float(st.rungs[0]["loss"])
        for idx, st in j_kill.trials.items()
        if st.status == "completed" and 0 in st.rungs
    }
    # local agents are children of the killed orchestrator's session:
    # give the orphan guard (idle timeout = 3x lease) a moment so no
    # stale agent still writes to the trial dirs
    time.sleep(4.0)
    out = _fleet_cli(
        "run", "--sweep-dir", sdir, "--spec", spec_text,
        "--steps", "12", "--agents", "2", "--lease", "1.0",
        "--synthetic-trials", "--step-sleep", "0.25",
        "--resume", "--json", timeout=180,
    )
    assert out.returncode == 0, out.stderr[-500:]
    result = json.loads(out.stdout)
    assert result["failed"] == []
    assert len(result["leaderboard"]) == 4
    j_res = load_journal(sdir)
    for idx, loss in pre_done.items():
        assert j_res.trials[idx].starts == 1  # never re-run
        row = [r for r in result["leaderboard"] if r["trial"] == idx][0]
        assert row["loss"] == loss  # byte-identical reuse


def test_fleet_all_hosts_dead_fails_actionably(tmp_path):
    from pytorch_distributed_nn_tpu_torch.experiments.fleet.transport import (
        FleetError,
    )

    sdir = str(tmp_path / "sweep")
    spec = SweepSpec.parse("lr=0.5,0.05")
    with pytest.raises(FleetError, match="every fleet host is dead"):
        _run_fleet(
            sdir, spec, dict(SYNTH_BASE, step_sleep=0.3), agents=1,
            devices=(1,), kill_when=_victim_streaming(sdir),
        )


# ---------------------------------------------------------------------------
# pool heartbeat-staleness bugfix (single-host runner)
# ---------------------------------------------------------------------------


def test_pool_convicts_stale_heartbeat_before_trial_timeout(tmp_path):
    """A silently-wedged trial (alive, heartbeat stale) is re-queued at
    heartbeat-grace instead of waiting out the (absent) trial timeout.
    The heartbeat is FABRICATED stale: synthetic trials never beat, so
    the pre-written file is the only (and convicting) evidence."""
    from pytorch_distributed_nn_tpu_torch.resilience.supervisor import (
        heartbeat_path,
    )

    sdir = str(tmp_path / "sweep")
    tdir = trial_dir(sdir, 0)
    os.makedirs(tdir)
    with open(heartbeat_path(tdir), "w") as f:
        json.dump({"step": 1, "time": time.time() - 3600.0,
                   "pid": 0}, f)
    spec = SweepSpec.parse("lr=0.5")
    t0 = time.monotonic()
    result = SweepRunner(
        spec, dict(SYNTH_BASE, faults="delay@2:60s"),
        RunnerConfig(sweep_dir=sdir, max_steps=4, concurrency=1,
                     retries=0, heartbeat_grace=1.0),
        trial_main=synthetic_trial_main,
    ).run()
    wall = time.monotonic() - t0
    # convicted at ~grace, not after the 60s injected wedge
    assert wall < 30.0, f"stale trial waited {wall:.0f}s"
    assert result["failed"] == [0]
    j = load_journal(sdir)
    stalls = [e for e in j.events if e.get("type") == "stall"
              and e.get("source") == "pool"]
    assert stalls and stalls[0]["trial"] == 0
    assert stalls[0]["age_seconds"] >= 1.0
    assert j.trials[0].last_end["status"] == jr.STATUS_TIMEOUT
    # the Watchdog conviction left its marker in the trial dir
    assert os.path.exists(os.path.join(tdir, "STALLED"))


def test_pool_missing_heartbeat_never_convicts(tmp_path):
    """No heartbeat file = no conviction (compile time is unbounded and
    synthetic trials never beat): the run completes normally."""
    sdir = str(tmp_path / "sweep")
    result = SweepRunner(
        SweepSpec.parse("lr=0.5"), dict(SYNTH_BASE),
        RunnerConfig(sweep_dir=sdir, max_steps=3, concurrency=1,
                     retries=0, heartbeat_grace=0.05),
        trial_main=synthetic_trial_main,
    ).run()
    assert result["failed"] == []
    j = load_journal(sdir)
    assert not any(e.get("type") == "stall" for e in j.events)


# ---------------------------------------------------------------------------
# CLI rc codes
# ---------------------------------------------------------------------------


def _fleet_cli(*args, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "pytorch_distributed_nn_tpu_torch", "fleet",
         *args],
        cwd=REPO, env=SUBPROCESS_ENV, capture_output=True, text=True,
        timeout=timeout,
    )


def test_cli_rc_codes(tmp_path):
    # bad spec -> 2, parse-time
    out = _fleet_cli("run", "--sweep-dir", str(tmp_path / "s"),
                     "--spec", "learning=0.1", "--agents", "1")
    assert out.returncode == 2 and "unknown TrainConfig field" in out.stderr
    # tcp without hosts -> 2
    out = _fleet_cli("run", "--sweep-dir", str(tmp_path / "s2"),
                     "--transport", "tcp")
    assert out.returncode == 2 and "--hosts" in out.stderr
    # status on a journal-less dir -> 2
    out = _fleet_cli("status", "--sweep-dir", str(tmp_path / "empty"))
    assert out.returncode == 2
    # agents probe against nothing -> 1, reports UNREACHABLE
    out = _fleet_cli("agents", "--hosts", "127.0.0.1:1",
                     "--call-timeout", "0.3")
    assert out.returncode == 1 and "UNREACHABLE" in out.stdout


def test_cli_run_and_status_roundtrip(tmp_path):
    sdir = str(tmp_path / "sweep")
    out = _fleet_cli(
        "run", "--sweep-dir", sdir, "--spec", "lr=0.5,0.05",
        "--steps", "3", "--agents", "2", "--synthetic-trials",
        "--json", timeout=180,
    )
    assert out.returncode == 0, out.stderr[-500:]
    result = json.loads(out.stdout)
    assert result["failed"] == [] and len(result["leaderboard"]) == 2
    assert result["fleet"]["migrations"] == 0
    assert {h["state"] for h in result["fleet"]["hosts"]} == {"alive"}
    out = _fleet_cli("status", "--sweep-dir", sdir)
    assert out.returncode == 0
    assert "fleet: transport local" in out.stdout
    assert "agent0" in out.stdout and "completed" in out.stdout


# ---------------------------------------------------------------------------
# the port's own: cards, ranks, launch counts
# ---------------------------------------------------------------------------


def test_plan_hosts_is_refused_naming_7d(tmp_path, monkeypatch):
    """``--plan-hosts`` (refused before the cost model existed, hence the
    name) now plans: the host's mesh comes from the roofline planner in
    a spawned subprocess, is cached under (model, devices, backend, torch
    version), and a second trial on a host of that profile reads the
    cache without planning again."""
    from pytorch_distributed_nn_tpu_torch.experiments.fleet import (
        scheduler as fleet_scheduler,
    )

    assert FleetConfig(sweep_dir=str(tmp_path / "s"), plan_hosts=True)
    cache = FleetCache(str(tmp_path / "cache"))
    host = AgentInfo("a", "h", 1, devices=2, profile={"backend": "cpu"})
    cfg = {"network": "LeNet", "batch_size": 16, "optimizer": "sgd"}
    got = host_mesh_overrides(cfg, host, cache=cache, plan=True)
    # the CPU profile's plan for LeNet on 2 devices: dp 1 first
    assert got == {"num_workers": 1, "tensor_parallel": 1,
                   "seq_parallel": 1}
    rec = cache.get("plan", model="LeNet", devices=2, backend="cpu",
                    torch=torch_version())
    assert rec["num_workers"] == 1 and rec["predicted_ms"] > 0

    def no_planning(*a, **kw):
        raise AssertionError("planned again despite a cached plan")

    monkeypatch.setattr(fleet_scheduler, "plan_in_subprocess", no_planning)
    assert host_mesh_overrides(cfg, host, cache=cache, plan=True) == got
    # the CLI accepts the flag and plans each host of the sweep
    out = _fleet_cli("run", "--sweep-dir", str(tmp_path / "s"),
                     "--plan-hosts", "--synthetic-trials", "--agents", "1",
                     "--steps", "2", timeout=180)
    assert out.returncode == 0, out.stderr[-1500:]
    assert os.path.exists(tmp_path / "s" / jr.SWEEP_BASENAME)


def test_too_few_cards_refused_before_any_agent_starts(tmp_path):
    """A fleet on the card asking for more cards than there are exits 2,
    naming both counts, with no agent started and nothing journaled (on
    this host ``nvidia-smi`` finds none); an agent refuses to serve a
    card it does not have."""
    sdir = tmp_path / "s"
    out = _fleet_cli("run", "--sweep-dir", str(sdir), "--device", "cuda",
                     "--agents", "2", "--spec", "lr=0.1", "--steps", "1")
    assert out.returncode == 2, out.stderr[-500:]
    assert "needs 2 cards" in out.stderr and "found 0" in out.stderr
    assert not os.path.exists(sdir / "fleet")
    assert not os.path.exists(sdir / jr.SWEEP_BASENAME)
    out = _fleet_cli("agent", "--device", "cuda", "--devices", "1",
                     "--register", str(tmp_path / "agent.json"))
    assert out.returncode == 2 and "needs 1 cards, found 0" in out.stderr
    assert not os.path.exists(tmp_path / "agent.json")


def test_rank_processes_exitcode_and_grace(tmp_path, monkeypatch):
    """The rank handle: None while any rank runs; the first failed rank's
    code once one fails (the rest killed past the grace); 0 when all
    exit 0; every rank gets the torchrun environment."""
    monkeypatch.setattr(launch, "GRACE_S", 0.5)
    env = dict(SUBPROCESS_ENV)
    ok = RankProcesses.start(
        [sys.executable, "-c", "import os; print(os.environ['RANK'], "
         "os.environ['WORLD_SIZE'], os.environ['LOCAL_RANK'], "
         "os.environ['MASTER_PORT'])"],
        2, env, logs=[str(tmp_path / f"r{r}.log") for r in range(2)])
    ok.join(30)
    assert ok.exitcode == 0 and ok.failed is None
    lines = [open(tmp_path / f"r{r}.log").read().split() for r in range(2)]
    assert [x[:3] for x in lines] == [["0", "2", "0"], ["1", "2", "1"]]
    assert lines[0][3] == lines[1][3]
    t0 = time.monotonic()
    bad = RankProcesses.start(
        [sys.executable, "-c", "import os, sys, time; r = "
         "int(os.environ['RANK']); time.sleep(60) if r == 0 else "
         "sys.exit(5)"], 2, env)
    assert bad.exitcode is None or bad.exitcode == 5
    bad.join(30)
    assert bad.exitcode == 5 and bad.failed == 1
    assert bad.procs[0].returncode == -signal.SIGKILL
    assert time.monotonic() - t0 < 20


class _Trainer:
    """What the launch counter reads of a trainer."""

    def __init__(self, start_step, rank, world):
        self.start_step, self.rank, self.world = start_step, rank, world


def test_a_killed_lifetime_is_counted_by_the_next(tmp_path):
    """Each rank's counts go to its live file after every step; a
    lifetime that ends appends its line and removes the file; one that
    was SIGKILLed leaves it, and the next lifetime's rank 0 folds it
    into a line marked ``killed`` before it trains."""
    tdir = str(tmp_path)
    counts = {"quantize_int8_scaled": 0}

    def launches():
        return dict(counts)

    lives = [port_runner._LifetimeLaunches(tdir, _Trainer(0, r, 2),
                                            launches) for r in range(2)]
    for step in range(3):
        counts["quantize_int8_scaled"] += 1
        for life in lives:
            life.on_record({"kind": "step", "step": step + 1})
        lives[0].on_record({"kind": "event", "type": "checkpoint_write"})
    # SIGKILL: neither rank closes; the next lifetime folds both
    port_runner._fold_killed_lifetimes(tdir)
    nxt = port_runner._LifetimeLaunches(tdir, _Trainer(2, 0, 1), launches)
    counts["quantize_int8_scaled"] += 1
    nxt.on_record({"kind": "step", "step": 3})
    nxt.close()
    with open(os.path.join(tdir, port_runner.LAUNCHES_BASENAME)) as f:
        got = [json.loads(line) for line in f]
    assert [(x["start_step"], x["steps"], x["rank"], x["world"],
             x.get("killed", False)) for x in got] == [
        (0, 3, 0, 2, True), (0, 3, 1, 2, True), (2, 1, 0, 1, False)]
    assert [x["launches"]["quantize_int8_scaled"] for x in got] == [3, 3, 4]
    assert sorted(os.listdir(tdir)) == [port_runner.LAUNCHES_BASENAME]

