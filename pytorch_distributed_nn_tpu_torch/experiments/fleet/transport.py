"""Fleet transport: one call surface, lease-based liveness, two wirings
(the port's copy of the JAX package's ``experiments/fleet/transport.py``:
the same wire, ops, leases, retries and errors).

Protocol (docs/experiments.md "Fleet"): one JSON object per line, one
request/response per TCP connection — the same "a crash costs at most one
line" framing as every stream in this repo, applied to the wire. Requests
are ``{"op": ..., ...}``; responses ``{"ok": true, ...}`` or
``{"ok": false, "error": ...}``. Ops: ``hello`` / ``assign`` / ``poll`` /
``cancel`` / ``drain`` / ``reset`` / ``ping`` / ``shutdown``
(experiments/fleet/agent.py is the server half).

Failure semantics, the part that matters:

- every call runs under the shared :func:`resilience.retry.retry_call`
  backoff (transient connection refusals and timeouts are retried with
  exponential backoff + jitter, deterministically seeded);
- liveness is **lease-based**: each agent's last successful contact is
  tracked, and a call that still fails after its retries either raises
  :class:`AgentUnreachable` (lease not yet expired — a blip) or declares
  the agent DEAD (:class:`AgentDead`, recorded, surfaced once through
  :meth:`FleetTransport.take_newly_dead`). A dead agent is never
  hung-waited: the scheduler migrates its trials instead of blocking on
  a socket.
- the agent enforces the mirror lease: started with ``--idle-timeout``
  (the local transport always sets it), an agent that has heard nothing
  from any orchestrator for that long SIGTERMs its trials (they
  emergency-checkpoint) and exits — a SIGKILLed orchestrator never
  leaves orphan trial writers behind.

``local`` spawns its agents as subprocesses in their own process groups
on loopback TCP (``cli fleet agent --listen 127.0.0.1:0``), each writing
a registration file once bound — so killing a "host" is one ``killpg``
(the agent and every rank of its trials), which is exactly what the
``fleet_preempt`` chaos scenario does. On the card each local agent owns
cards of its own (``CUDA_VISIBLE_DEVICES``): a fleet that asks for more
cards than the host has is refused before any agent starts.
``tcp`` attaches to agents someone else started (real remote hosts; the
sweep directory must be on storage shared with them — the reference's
NFS assumption, documented).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import signal
import socket
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

#: basename of the registration file a local agent writes once bound
REGISTER_BASENAME = "agent.json"


def on_card(device: Optional[str]) -> bool:
    """Whether ``device`` names the card (None is the card, as it is for
    every entry point of the port)."""
    return device is None or device == "cuda" or device.startswith("cuda:")


def visible_cards() -> List[str]:
    """The NVIDIA cards this process may use, as ``CUDA_VISIBLE_DEVICES``
    entries, counted without importing torch: ``nvidia-smi -L``'s GPUs,
    narrowed to ``CUDA_VISIBLE_DEVICES`` where it is set (up to its first
    entry that names no card, as CUDA reads it). Empty without
    ``nvidia-smi``."""
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return []
    if out.returncode != 0:
        return []
    n = sum(1 for line in out.stdout.splitlines() if line.startswith("GPU "))
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is None:
        return [str(i) for i in range(n)]
    cards: List[str] = []
    for entry in (e.strip() for e in env.split(",")):
        ok = (entry.isdigit() and int(entry) < n) or entry.startswith(
            ("GPU-", "MIG-"))
        if not ok or entry in cards:
            break
        cards.append(entry)
    return cards


class FleetError(RuntimeError):
    """Base class for fleet transport failures."""


class AgentDead(FleetError):
    """The agent missed its lease: declared dead, trials must migrate."""


class AgentUnreachable(FleetError):
    """A call failed after retries but the lease has not expired yet —
    treat as a transient blip, not a death."""


class AgentRefused(FleetError):
    """The agent answered but refused the operation (at capacity,
    draining, unknown trial, ...)."""


@dataclasses.dataclass
class AgentInfo:
    """One registered host: identity, address, capacity, planner profile."""

    agent_id: str
    host: str
    port: int
    devices: int = 1
    capacity: int = 1
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    profile: Dict[str, object] = dataclasses.field(default_factory=dict)
    pid: Optional[int] = None  # local transport only
    draining: bool = False

    @property
    def addr(self) -> Tuple[str, int]:
        return (self.host, int(self.port))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def call_once(
    addr: Tuple[str, int], msg: dict, timeout: float = 2.0
) -> dict:
    """One request/response round trip; raises OSError on any transport
    failure (the retry layer's conviction surface)."""
    with socket.create_connection(addr, timeout=timeout) as sock:
        sock.settimeout(timeout)
        f = sock.makefile("rwb")
        f.write(json.dumps(msg).encode() + b"\n")
        f.flush()
        line = f.readline()
    if not line:
        raise ConnectionError(f"agent at {addr[0]}:{addr[1]} closed the "
                              "connection without answering")
    try:
        return json.loads(line)
    except ValueError as e:
        # a half-dead agent garbling its reply is a transport failure,
        # not a protocol negotiation: let the retry/lease layer judge it
        raise ConnectionError(f"garbled reply from {addr}: {e}") from None


def probe_hosts(
    addrs: List[str], timeout: float = 2.0
) -> List[Tuple[str, Optional[AgentInfo], Optional[str]]]:
    """``hello`` every ``host:port`` once (no retries): the ``cli fleet
    agents`` surface. Returns (addr, info-or-None, error-or-None) rows."""
    rows = []
    for a in addrs:
        host, _, port = a.rpartition(":")
        try:
            resp = call_once((host, int(port)), {"op": "hello"},
                             timeout=timeout)
            rows.append((a, _info_from_hello(resp), None))
        except (OSError, ValueError) as e:
            rows.append((a, None, f"{type(e).__name__}: {e}"))
    return rows


def _info_from_hello(resp: dict) -> AgentInfo:
    return AgentInfo(
        agent_id=str(resp.get("agent_id") or "?"),
        host=str(resp.get("host") or "?"),
        port=int(resp.get("port") or 0),
        devices=int(resp.get("devices") or 1),
        capacity=int(resp.get("capacity") or 1),
        labels=dict(resp.get("labels") or {}),
        profile=dict(resp.get("profile") or {}),
        pid=resp.get("pid"),
        draining=bool(resp.get("draining")),
    )


class FleetTransport:
    """Shared call/lease machinery over a set of registered agents.

    Subclasses populate ``self._agents`` (``start()``); everything else —
    retries, lease accounting, dead-agent bookkeeping — lives here so the
    ``local`` and ``tcp`` wirings cannot diverge in failure semantics.
    """

    kind = "base"

    def __init__(
        self,
        lease: float = 10.0,
        call_timeout: float = 2.0,
        attempts: int = 3,
        retry_base_delay: float = 0.05,
        sleep: Callable[[float], None] = time.sleep,
    ):
        if lease <= 0:
            raise ValueError(f"lease must be > 0, got {lease}")
        self.lease = float(lease)
        self.call_timeout = float(call_timeout)
        self.attempts = int(attempts)
        self.retry_base_delay = float(retry_base_delay)
        self._sleep = sleep
        self._agents: Dict[str, AgentInfo] = {}
        self._last_ok: Dict[str, float] = {}
        self._dead: Dict[str, str] = {}  # agent_id -> reason
        self._newly_dead: List[str] = []

    # -- registry ---------------------------------------------------------

    def start(self) -> "FleetTransport":
        return self

    def agents(self) -> List[AgentInfo]:
        return [self._agents[k] for k in sorted(self._agents)]

    def agent(self, agent_id: str) -> AgentInfo:
        return self._agents[agent_id]

    def is_dead(self, agent_id: str) -> bool:
        return agent_id in self._dead

    def alive(self) -> List[AgentInfo]:
        return [a for a in self.agents() if a.agent_id not in self._dead]

    def mark_dead(self, agent_id: str, reason: str) -> None:
        if agent_id in self._dead:
            return
        logger.warning("fleet: agent %s declared DEAD (%s)",
                       agent_id, reason)
        self._dead[agent_id] = reason
        self._newly_dead.append(agent_id)

    def take_newly_dead(self) -> List[str]:
        """Agents declared dead since the last take — the scheduler's
        migration trigger (each death is surfaced exactly once)."""
        out, self._newly_dead = self._newly_dead, []
        return out

    def dead_reason(self, agent_id: str) -> Optional[str]:
        return self._dead.get(agent_id)

    # -- calls ------------------------------------------------------------

    def call(self, agent_id: str, op: str, attempts: Optional[int] = None,
             **payload) -> dict:
        """One logical RPC with retry + lease accounting.

        Raises :class:`AgentDead` when the agent is (or becomes) declared
        dead, :class:`AgentUnreachable` on a still-within-lease failure,
        :class:`AgentRefused` when the agent answers ``ok: false``.
        """
        from pytorch_distributed_nn_tpu_torch.resilience.retry import (
            retry_call,
        )

        if agent_id in self._dead:
            raise AgentDead(
                f"agent {agent_id} is dead ({self._dead[agent_id]})"
            )
        info = self._agents[agent_id]
        msg = {"op": op, **payload}
        try:
            resp = retry_call(
                call_once, info.addr, msg, timeout=self.call_timeout,
                attempts=attempts if attempts is not None else self.attempts,
                base_delay=self.retry_base_delay, max_delay=1.0,
                retry_on=(OSError,), seed=hash(agent_id) & 0xFFFF,
                sleep=self._sleep, label=f"fleet:{op}@{agent_id}",
            )
        except OSError as e:
            age = time.monotonic() - self._last_ok.get(
                agent_id, float("-inf")
            )
            if age >= self.lease:
                self.mark_dead(
                    agent_id,
                    f"lease expired ({age:.1f}s > {self.lease:.1f}s "
                    f"since last contact; {type(e).__name__}: {e})",
                )
                raise AgentDead(
                    f"agent {agent_id} missed its lease: {e}"
                ) from e
            raise AgentUnreachable(
                f"agent {agent_id} unreachable (lease has "
                f"{self.lease - age:.1f}s left): {e}"
            ) from e
        self._last_ok[agent_id] = time.monotonic()
        if not resp.get("ok", False):
            raise AgentRefused(
                f"agent {agent_id} refused {op!r}: "
                f"{resp.get('error', '?')}"
            )
        return resp

    def ensure_fresh(self, agent_id: str) -> None:
        """Keep the lease honest for agents nothing else is talking to:
        past half a lease of silence, ping once (the failure path runs
        the full lease judgement in :meth:`call`)."""
        if agent_id in self._dead:
            return
        age = time.monotonic() - self._last_ok.get(agent_id, float("-inf"))
        if age < self.lease / 2.0:
            return
        try:
            self.call(agent_id, "ping", attempts=1)
        except (AgentDead, AgentUnreachable):
            pass

    def _hello(self, agent_id: str) -> AgentInfo:
        resp = self.call(agent_id, "hello")
        info = _info_from_hello(resp)
        self._agents[agent_id] = info
        return info

    def close(self) -> None:  # pragma: no cover - subclass surface
        pass


class TcpTransport(FleetTransport):
    """Attach to already-running agents at explicit ``host:port`` addrs.

    The agents' lifecycle is someone else's (systemd, a pod, a human with
    ``cli fleet agent``); ``close()`` only drops the client side. Every
    attach begins with ``reset`` so trials an earlier (possibly SIGKILLed)
    orchestrator left running are stopped — the journal, not the agent,
    is the source of truth for what should be in flight.
    """

    kind = "tcp"

    def __init__(self, hosts: List[str], reset: bool = True, **kw):
        super().__init__(**kw)
        self._hosts = list(hosts)
        self._reset = reset

    def start(self) -> "TcpTransport":
        for spec in self._hosts:
            host, _, port = spec.rpartition(":")
            if not host or not port.isdigit():
                raise ValueError(
                    f"bad --hosts entry {spec!r}: expected host:port"
                )
            resp = call_once((host, int(port)), {"op": "hello"},
                             timeout=self.call_timeout)
            info = _info_from_hello(resp)
            self._agents[info.agent_id] = info
            self._last_ok[info.agent_id] = time.monotonic()
            if self._reset:
                self.call(info.agent_id, "reset")
        if not self._agents:
            raise ValueError("tcp transport: no agents in --hosts")
        return self


class LocalTransport(FleetTransport):
    """Spawn N agents as loopback-TCP subprocesses — the CI/chaos fleet.

    Each agent runs ``cli fleet agent`` in its OWN process group
    (``start_new_session``), so :meth:`kill_agent` can take out the host
    *and its trial subprocesses* with one ``killpg`` — a faithful local
    model of spot-instance preemption. Per-agent device counts come from
    ``devices`` (an int, or a list cycled over the agents), and each
    agent runs its trials on ``device`` (None: the card): on the CPU a
    trial of N ranks is N gloo processes; on the card agent k owns the
    next ``devices[k]`` cards (``CUDA_VISIBLE_DEVICES``), never shared.
    """

    kind = "local"

    def __init__(
        self,
        fleet_dir: str,
        agents: int = 3,
        devices=1,
        capacity: int = 1,
        device: Optional[str] = None,
        start_timeout: float = 30.0,
        idle_timeout: Optional[float] = None,
        **kw,
    ):
        super().__init__(**kw)
        if agents < 1:
            raise ValueError(f"agents must be >= 1, got {agents}")
        self.fleet_dir = fleet_dir
        self.n_agents = int(agents)
        self.devices = (
            [int(d) for d in devices]
            if isinstance(devices, (list, tuple)) else [int(devices)]
        )
        self.capacity = int(capacity)
        self.device = device
        self.start_timeout = float(start_timeout)
        # mirror lease: agents self-terminate after this much orchestrator
        # silence, so a SIGKILLed orchestrator cannot leave orphan trial
        # writers fighting a resumed sweep over the same trial dirs
        self.idle_timeout = (
            float(idle_timeout) if idle_timeout is not None
            else max(5.0, 3.0 * self.lease)
        )
        self._procs: Dict[str, subprocess.Popen] = {}

    def agent_dir(self, agent_id: str) -> str:
        return os.path.join(self.fleet_dir, agent_id)

    def _cards_by_agent(self) -> List[Optional[str]]:
        """Each agent's ``CUDA_VISIBLE_DEVICES`` on the card (the next
        ``devices[k]`` of the visible cards), or None on the CPU. Raises
        ``ValueError`` naming both counts, before any agent starts, when
        the fleet asks for more cards than there are."""
        counts = [self.devices[k % len(self.devices)]
                  for k in range(self.n_agents)]
        if not on_card(self.device):
            return [None] * self.n_agents
        cards = visible_cards()
        if sum(counts) > len(cards):
            raise ValueError(
                f"the fleet needs {sum(counts)} cards ({self.n_agents} "
                f"agent(s) with {counts} device(s)), found {len(cards)}: "
                "agents never share a card and never fall back to the CPU")
        out, at = [], 0
        for n in counts:
            out.append(",".join(cards[at:at + n]))
            at += n
        return out

    def start(self) -> "LocalTransport":
        cards = self._cards_by_agent()
        os.makedirs(self.fleet_dir, exist_ok=True)
        ids = [f"agent{k}" for k in range(self.n_agents)]
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        for k, agent_id in enumerate(ids):
            adir = self.agent_dir(agent_id)
            os.makedirs(adir, exist_ok=True)
            reg = os.path.join(adir, REGISTER_BASENAME)
            if os.path.exists(reg):
                os.unlink(reg)  # stale registration from an earlier run
            cmd = [
                sys.executable, "-m", "pytorch_distributed_nn_tpu_torch",
                "fleet", "agent",
                "--listen", "127.0.0.1:0",
                "--agent-id", agent_id,
                "--devices", str(self.devices[k % len(self.devices)]),
                "--capacity", str(self.capacity),
                "--register", reg,
                "--device", "cuda" if on_card(self.device) else "cpu",
                "--idle-timeout", str(self.idle_timeout),
            ]
            agent_env = (env if cards[k] is None
                         else dict(env, CUDA_VISIBLE_DEVICES=cards[k]))
            with open(os.path.join(adir, "agent.log"), "ab") as logf:
                self._procs[agent_id] = subprocess.Popen(
                    cmd, stdout=logf, stderr=logf, start_new_session=True,
                    env=agent_env,
                )
        deadline = time.monotonic() + self.start_timeout
        for agent_id in ids:
            reg = os.path.join(self.agent_dir(agent_id), REGISTER_BASENAME)
            while True:
                if os.path.isfile(reg):
                    try:
                        with open(reg) as f:
                            d = json.load(f)
                        break
                    except ValueError:
                        pass  # mid-write; registration is atomic-renamed
                proc = self._procs[agent_id]
                if proc.poll() is not None:
                    raise FleetError(
                        f"local agent {agent_id} exited rc={proc.returncode}"
                        f" before registering (see "
                        f"{self.agent_dir(agent_id)}/agent.log)"
                    )
                if time.monotonic() > deadline:
                    raise FleetError(
                        f"local agent {agent_id} did not register within "
                        f"{self.start_timeout:.0f}s"
                    )
                time.sleep(0.05)
            info = AgentInfo(
                agent_id=agent_id, host=d["host"], port=int(d["port"]),
                devices=int(d.get("devices") or 1),
                capacity=int(d.get("capacity") or 1),
                labels=dict(d.get("labels") or {}),
                profile=dict(d.get("profile") or {}),
                pid=int(d.get("pid") or self._procs[agent_id].pid),
            )
            self._agents[agent_id] = info
            self._last_ok[agent_id] = time.monotonic()
            self._hello(agent_id)  # round-trip proves the server is up
        return self

    def kill_agent(self, agent_id: str, sig: int = signal.SIGKILL) -> None:
        """Preempt a "host": signal the agent's whole process group (the
        agent AND its trial subprocesses — what losing the machine means).
        The transport does NOT mark it dead here; death is only ever
        declared by the lease, the same way a real fleet learns it."""
        proc = self._procs[agent_id]
        try:
            os.killpg(os.getpgid(proc.pid), sig)
        except ProcessLookupError:  # already gone
            pass

    def close(self) -> None:
        for agent_id, proc in self._procs.items():
            if proc.poll() is not None or agent_id in self._dead:
                continue
            try:
                self.call(agent_id, "shutdown", attempts=1)
            except FleetError:
                pass
        deadline = time.monotonic() + 10.0
        for agent_id, proc in self._procs.items():
            while proc.poll() is None and time.monotonic() < deadline:
                time.sleep(0.05)
            if proc.poll() is None:
                self.kill_agent(agent_id, signal.SIGKILL)
                proc.wait(timeout=5)
