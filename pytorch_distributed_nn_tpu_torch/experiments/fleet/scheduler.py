"""The fleet scheduler: the ASHA sweep runner, dispatching over hosts
(the port's copy of the JAX package's ``experiments/fleet/scheduler.py``:
the same placement, migration, journal events, gauges and errors).

:class:`FleetScheduler` extends :class:`~..runner.SweepRunner` — spec
grammar, rung ladder, journal-first discipline, retry/backoff, report
surface all UNCHANGED — and replaces only the execution substrate: a
trial attempt is assigned to a host agent over the transport and polled
remotely instead of spawned locally. What that buys:

- **capacity-aware placement** (:func:`place_trial`): a trial goes to
  the alive, non-draining host with a free slot, preferring hosts with
  enough devices for the trial's requested mesh, then the most idle
  capacity; deterministic tie-break on agent id.
- **per-host mesh assignment** (:func:`host_mesh_overrides`): with
  ``plan_hosts`` the roofline planner ranks meshes for the host's profile
  (backend + device count) in a spawned subprocess
  (:func:`..runner.plan_in_subprocess`: the orchestrator imports no
  torch), memoized in the shared :class:`~.cache.FleetCache`
  (content-addressed by model, devices, backend and torch version); the
  top candidate's dp/tp/sp land in the trial's config, unless the sweep
  names a mesh axis itself. An explicit ``num_workers``
  larger than the host is capped through the elastic policy
  (``derive_data_parallel``), so a fresh trial can never launch more
  ranks than its host has devices.
- **migration, not failure**: when the transport declares a host dead
  (lease missed), its in-flight trials are re-dispatched to surviving
  hosts with the SAME attempt number — preemption never spends the
  trial's retry budget — and resume from their last valid checkpoint
  through the trainer's elastic path: a different device count (so
  another number of rank processes) on the new host is the normal
  case. Typed
  ``host_dead`` + ``trial_migrate`` journal events make every
  transition visible to ``fleet status`` / ``obs summary``.

The journal stays the single source of truth: ``fleet run --resume``
replays ``sweep.jsonl`` exactly like ``sweep resume`` (completed trials
reused byte-identically, in-flight ones re-dispatched with
``resume=True``), against a fresh fleet — orchestrator death is just
another preemption.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Dict, List, Optional, Set, Tuple

from pytorch_distributed_nn_tpu_torch.experiments import journal as jr
from pytorch_distributed_nn_tpu_torch.experiments.fleet.cache import (
    FleetCache,
    torch_version,
)
from pytorch_distributed_nn_tpu_torch.experiments.fleet.transport import (
    AgentDead,
    AgentInfo,
    AgentRefused,
    AgentUnreachable,
    FleetError,
    FleetTransport,
    LocalTransport,
    TcpTransport,
)
from pytorch_distributed_nn_tpu_torch.experiments.runner import (
    RunnerConfig,
    SweepRunner,
    _Attempt,
    _Running,
    plan_in_subprocess,
)
from pytorch_distributed_nn_tpu_torch.observability import tracing

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class FleetConfig(RunnerConfig):
    """Runner knobs + the fleet's transport/lease/planner surface. The
    trials' device is :attr:`RunnerConfig.device` (None: the card), the
    device of the local transport's agents; it is no journal field."""

    transport: str = "local"  # local | tcp
    agents: int = 3  # local: how many agent subprocesses
    agent_devices: Tuple[int, ...] = ()  # local: per-agent device counts
    agent_capacity: int = 1  # local: concurrent trials per agent
    hosts: Tuple[str, ...] = ()  # tcp: host:port addresses
    lease: float = 10.0  # seconds of silence before a host is dead
    call_timeout: float = 2.0  # per-RPC socket timeout
    plan_hosts: bool = False  # planner-assigned mesh per host profile
    trial_main_name: str = "default"  # default | synthetic (wire name)


def place_trial(
    hosts: List[AgentInfo],
    inflight: Dict[str, Set[int]],
    dead: Set[str],
    need_devices: Optional[int] = None,
) -> Optional[AgentInfo]:
    """Pick the host for the next attempt (pure — unit-testable).

    Eligible = alive, not draining, free slot. Preference order: hosts
    with at least ``need_devices`` devices first (a requested mesh
    should not be capped if somewhere it can run whole), then most free
    slots (spread load), then lowest agent id (determinism). ``None``
    when the whole fleet is busy — the attempt waits, it is never
    queued agent-side.
    """
    best = None
    best_key = None
    for h in hosts:
        if h.agent_id in dead or h.draining:
            continue
        free = h.capacity - len(inflight.get(h.agent_id, ()))
        if free <= 0:
            continue
        starved = (
            1 if need_devices is not None and h.devices < need_devices
            else 0
        )
        key = (starved, -free, h.agent_id)
        if best_key is None or key < best_key:
            best, best_key = h, key
    return best


def host_mesh_overrides(
    cfg: dict,
    host: AgentInfo,
    cache: Optional[FleetCache] = None,
    plan: bool = False,
    plan_timeout: float = 300.0,
) -> dict:
    """Per-host mesh factors for one trial config (host-side, no torch).

    With ``plan=True`` the roofline planner ranks meshes for (network,
    host devices) — in a spawned subprocess, memoized in the fleet cache
    under (model, devices, backend, torch version). The fallback contract
    either way: an explicit ``num_workers`` beyond the host's devices is
    walked down through the elastic K-of-N policy (batch divisibility
    preserved), so placement on a smaller host yields a runnable mesh
    instead of more ranks than devices.
    """
    from pytorch_distributed_nn_tpu_torch.resilience.elastic import (
        derive_data_parallel,
    )

    network = cfg.get("network")
    overrides: dict = {}
    if plan and network and cache is not None:
        backend = str(host.profile.get("backend") or "cpu")
        ident = dict(model=str(network), devices=int(host.devices),
                     backend=backend, torch=torch_version())
        plan_rec = cache.get("plan", **ident)
        if plan_rec is None:
            plan_rec = plan_in_subprocess(
                cfg, host.devices, "cpu" if backend == "cpu" else None,
                timeout=plan_timeout)
            if plan_rec is not None:
                cache.put("plan", plan_rec, **ident)
        if plan_rec:
            overrides.update({
                k: int(plan_rec[k])
                for k in ("num_workers", "tensor_parallel", "seq_parallel")
                if plan_rec.get(k)
            })
    tp = int(overrides.get("tensor_parallel")
             or cfg.get("tensor_parallel") or 1)
    sp = int(overrides.get("seq_parallel") or cfg.get("seq_parallel") or 1)
    requested = overrides.get("num_workers", cfg.get("num_workers"))
    if requested is not None and (
        int(requested) * tp * sp > host.devices
        or int(requested) < 1
    ):
        capped = derive_data_parallel(
            host.devices, int(cfg.get("batch_size") or 1),
            tensor_parallel=tp, seq_parallel=sp,
            requested=max(int(requested), 1),
        )
        logger.warning(
            "fleet: trial wants dp=%s but host %s has %d device(s) — "
            "capping to dp=%d (elastic K-of-N walk-down)",
            requested, host.agent_id, host.devices, capped,
        )
        overrides["num_workers"] = capped
    return overrides


class _RemoteTrial:
    """Process-like adapter over one assigned trial, so the base runner's
    reap/terminate/finish machinery works unchanged on remote attempts.

    ``is_alive`` keeps answering True while the HOST is merely dead-or-
    silent — "not known to have exited" — so the base loop never
    misclassifies a preemption as a crash; migration is the scheduler's
    ``_poll_hosts`` job, which reads :attr:`host_dead`.
    """

    def __init__(self, transport: FleetTransport, agent_id: str,
                 trial: int, poll_interval: float = 0.2):
        self.transport = transport
        self.agent_id = agent_id
        self.trial = int(trial)
        self.poll_interval = float(poll_interval)
        self.host_dead = False
        self.heartbeat_age: Optional[float] = None
        self.heartbeat_step: Optional[int] = None
        self._state = "running"
        self._rc: Optional[int] = None
        self._last_poll = float("-inf")

    def _poll(self, force: bool = False) -> None:
        if self._state == "exited" or self.host_dead:
            return
        now = time.monotonic()
        if not force and now - self._last_poll < self.poll_interval:
            return
        self._last_poll = now
        try:
            r = self.transport.call(self.agent_id, "poll",
                                    trial=self.trial)
        except AgentDead:
            self.host_dead = True
            return
        except (AgentUnreachable, AgentRefused):
            return  # transient: judge again next poll
        state = r.get("state")
        if state == "exited":
            self._state = "exited"
            self._rc = r.get("rc")
        elif state == "unknown":
            # the agent restarted underneath us: whatever ran is gone;
            # surface as a crash so the retry path re-dispatches
            self._state = "exited"
            self._rc = -1
        self.heartbeat_age = r.get("heartbeat_age")
        self.heartbeat_step = r.get("heartbeat_step")

    def is_alive(self) -> bool:
        self._poll()
        return self._state == "running"

    @property
    def exitcode(self) -> Optional[int]:
        return self._rc

    def terminate(self) -> None:
        try:
            self.transport.call(self.agent_id, "cancel", trial=self.trial)
        except (AgentDead, AgentUnreachable, AgentRefused):
            pass

    def kill(self) -> None:
        try:
            self.transport.call(self.agent_id, "cancel", trial=self.trial,
                                force=True)
        except (AgentDead, AgentUnreachable, AgentRefused):
            pass

    def join(self, timeout: Optional[float] = None) -> None:
        deadline = (
            time.monotonic() + timeout if timeout is not None else None
        )
        while self._state == "running" and not self.host_dead:
            self._poll(force=True)
            if self._state != "running" or self.host_dead:
                return
            if deadline is not None and time.monotonic() > deadline:
                return
            time.sleep(0.05)


class FleetScheduler(SweepRunner):
    """SweepRunner whose attempts run on a fleet of host agents."""

    def __init__(
        self,
        spec,
        base_config,
        cfg: FleetConfig,
        transport: Optional[FleetTransport] = None,
    ):
        super().__init__(spec, base_config, cfg)
        self.transport = transport
        self.cache: Optional[FleetCache] = None
        self._hosts: Dict[str, AgentInfo] = {}
        self._inflight_by_host: Dict[str, Set[int]] = {}
        self._migrations_total = 0

    # -- lifecycle --------------------------------------------------------

    def _build_transport(self) -> FleetTransport:
        c = self.cfg
        if c.transport == "local":
            return LocalTransport(
                fleet_dir=os.path.join(c.sweep_dir, "fleet"),
                agents=c.agents,
                devices=list(c.agent_devices) or 1,
                capacity=c.agent_capacity,
                # synthetic trials touch no device: their agents need no
                # card
                device=("cpu" if c.trial_main_name == "synthetic"
                        else c.device),
                lease=c.lease, call_timeout=c.call_timeout,
            )
        if c.transport == "tcp":
            return TcpTransport(
                list(c.hosts), lease=c.lease, call_timeout=c.call_timeout,
            )
        raise ValueError(
            f"unknown transport {c.transport!r} (local | tcp)"
        )

    def run(self) -> dict:
        c = self.cfg
        owned = self.transport is None
        if owned:
            self.transport = self._build_transport()
        self.cache = FleetCache.for_sweep(c.sweep_dir)
        try:
            self.transport.start()
            self._hosts = {
                a.agent_id: a for a in self.transport.agents()
            }
            self._inflight_by_host = {h: set() for h in self._hosts}
            # fleet-wide concurrency IS the fleet's capacity; the base
            # loop's bound then only trips when every slot is taken
            c.concurrency = max(
                1, sum(h.capacity for h in self._hosts.values())
            )
            result = super().run()
            result["fleet"] = self.fleet_state()
            return result
        finally:
            if owned and self.transport is not None:
                self.transport.close()

    def fleet_state(self) -> dict:
        return {
            "transport": self.cfg.transport,
            "hosts": [
                dict(h.to_dict(),
                     state=("dead" if self.transport.is_dead(h.agent_id)
                            else "alive"))
                for h in self._hosts.values()
            ],
            "migrations": self._migrations_total,
            "cache": self.cache.stats() if self.cache else {},
        }

    # -- runner seams -----------------------------------------------------

    def _sweep_meta_extra(self) -> dict:
        c = self.cfg
        return {"fleet": {
            "transport": c.transport, "lease": c.lease,
            "plan_hosts": c.plan_hosts,
            "trial_main": c.trial_main_name,
        }}

    def _on_journal_open(self) -> None:
        for h in self._hosts.values():
            self.journal.emit(
                "host_join", host=h.agent_id, addr=f"{h.host}:{h.port}",
                devices=h.devices, capacity=h.capacity, labels=h.labels,
                profile=h.profile,
            )
        self.journal.flush()
        self._fleet_gauges()

    def _launch(self, att: _Attempt, rung) -> Optional[_Running]:
        c = self.cfg
        trial = att.trial
        need = trial.overrides.get(
            "num_workers", self._base_dict.get("num_workers")
        )
        host = place_trial(
            list(self._hosts.values()), self._inflight_by_host,
            {h for h in self._hosts
             if self.transport.is_dead(h)},
            need_devices=int(need) if need else None,
        )
        if host is None:
            return None
        tdir = jr.trial_dir(c.sweep_dir, trial.index)
        os.makedirs(tdir, exist_ok=True)
        cfg = self._trial_config(trial, rung, att)
        # an explicitly-swept mesh axis beats the planner (the sweep is
        # the experiment); the elastic cap inside host_mesh_overrides
        # still protects it on a smaller host
        plan = c.plan_hosts and not any(
            k in trial.overrides
            for k in ("num_workers", "tensor_parallel", "seq_parallel")
        )
        cfg.update(host_mesh_overrides(
            cfg, host, cache=self.cache, plan=plan,
        ))
        env = {}
        # trace relay over the wire: the agent applies this env before the
        # trial spawn, so the trial's manifest derives its child span from
        # the attempt's — orchestrator -> agent -> trial lineage, with the
        # relaying hop recorded as "via"
        span = self.trace.child()
        env[tracing.TRACE_ENV] = span.header()
        env["PDTN_TRACE_VIA"] = host.agent_id
        self.journal.emit(
            "trial_start", trial=trial.index, rung=rung.index,
            attempt=att.attempt, budget=rung.budget, seed=trial.seed,
            overrides=trial.overrides, resume=cfg["resume"],
            host=host.agent_id, **span.fields(),
        )
        self.journal.flush()
        try:
            self.transport.call(
                host.agent_id, "assign", trial=trial.index,
                trial_dir=tdir, cfg=cfg, main=c.trial_main_name,
                env=env,
            )
        except (AgentDead, AgentUnreachable, AgentRefused) as e:
            # the host vanished (or filled) between placement and assign:
            # the dangling trial_start reads as in-flight, the base loop
            # re-queues this attempt, and the next placement skips the
            # now-suspect host
            logger.warning("fleet: assign of trial %d to %s failed: %s",
                           trial.index, host.agent_id, e)
            return None
        self._inflight_by_host.setdefault(host.agent_id, set()).add(
            trial.index
        )
        self._fleet_gauges()
        now = time.monotonic()
        return _Running(
            proc=_RemoteTrial(self.transport, host.agent_id, trial.index),
            att=att, rung=rung, t0=now,
            deadline=(now + c.trial_timeout) if c.trial_timeout else None,
        )

    def _poll_hosts(self, running, pend, rung) -> None:
        t = self.transport
        # keep leases honest for hosts no running trial is polling (a
        # trial's own poll convicts its host through the same call path)
        for agent_id in self._hosts:
            t.ensure_fresh(agent_id)
        newly = t.take_newly_dead()
        now = time.monotonic()
        for agent_id in newly:
            victims = sorted(
                idx for idx, run in running.items()
                if getattr(run.proc, "agent_id", None) == agent_id
            )
            self.journal.emit(
                "host_dead", host=agent_id,
                reason=t.dead_reason(agent_id), inflight=victims,
            )
            for idx in victims:
                run = running.pop(idx)
                # migration is not a failure: the SAME attempt number is
                # re-queued — host death never spends the retry budget —
                # and the re-dispatch resumes from the trial's last valid
                # checkpoint (resume=True by the stream-exists rule),
                # reshard-on-loading if the new host's device count
                # differs (the elastic path, docs/resilience.md)
                self.journal.emit(
                    "trial_migrate", trial=idx, rung=run.rung.index,
                    attempt=run.att.attempt, from_host=agent_id,
                    reason="host_dead",
                )
                self._migrations_total += 1
                # head of the queue: a migrated trial already lost its
                # lease-detection window; it takes the next free slot
                pend.insert(0, _Attempt(
                    trial=run.att.trial, attempt=run.att.attempt,
                    not_before=now + 0.1,
                ))
            self._inflight_by_host.pop(agent_id, None)
            self.journal.flush(fsync=True)
            self._fleet_gauges()
            self._export_prom()
        if self._hosts and all(
            t.is_dead(h) for h in self._hosts
        ):
            # nothing left to run on: fail fast with the resume recipe
            # instead of spinning on placement forever — the journal
            # already holds every completed result
            raise FleetError(
                "every fleet host is dead — restart agents and continue "
                f"with 'fleet run --resume --sweep-dir "
                f"{self.cfg.sweep_dir}'"
            )

    def _heartbeat_stale(self, run: _Running) -> Optional[float]:
        grace = self.cfg.heartbeat_grace
        age = getattr(run.proc, "heartbeat_age", None)
        if not grace or age is None or age <= grace:
            return None
        return float(age)

    def _attempt_extra(self, run: _Running) -> dict:
        agent_id = getattr(run.proc, "agent_id", None)
        if agent_id is None:
            return {}
        self._inflight_by_host.get(agent_id, set()).discard(
            run.att.trial.index
        )
        self._fleet_gauges()
        return {"host": agent_id}

    # -- telemetry --------------------------------------------------------

    def _fleet_gauges(self) -> None:
        reg = self.journal.registry if self.journal is not None else None
        if reg is None:
            return
        dead = sum(
            1 for h in self._hosts if self.transport.is_dead(h)
        )
        reg.gauge(
            "fleet_hosts", help="registered fleet hosts by liveness",
            labels={"state": "alive"},
        ).set(len(self._hosts) - dead)
        reg.gauge(
            "fleet_hosts", help="registered fleet hosts by liveness",
            labels={"state": "dead"},
        ).set(dead)
        reg.gauge(
            "fleet_trials_inflight",
            help="trial attempts currently assigned to fleet hosts",
        ).set(sum(len(s) for s in self._inflight_by_host.values()))
        c = reg.counter(
            "fleet_migrations_total",
            help="in-flight trials re-dispatched off dead hosts",
        )
        if self._migrations_total > c.value:
            c.inc(self._migrations_total - c.value)
