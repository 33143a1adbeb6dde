"""The fleet host agent: capacity registration + supervised trial runner
(the port's copy of the JAX package's ``experiments/fleet/agent.py``:
the same ops, replies, lifecycle and registration file).

One agent per host (``cli fleet agent --listen HOST:PORT``). It is
deliberately *thin* and imports no torch: it advertises capacity (device
count, labels, a planner calibration profile stub), runs assigned trials
as freshly-spawned supervised subprocesses — the execution model of the
single-host pool (``experiments/runner.py``), so a trial cannot tell
which side of the wire launched it — and relays each trial's
``heartbeat.json`` upstream through ``poll``. The *trials* import torch
in their own processes; the agent never does.

**A trial of several ranks.** A JAX trial is one process holding every
device of its host. A port trial of ``num_workers x tensor_parallel x
seq_parallel`` ranks (the agent's ``devices`` when ``num_workers`` is
None) is that many processes of one torchrun world
(:class:`..parallel.launch.RankProcesses`), gloo on the CPU and NCCL on
the card, rank r on the agent's r-th card. The agent holds them as one
process-like handle: its ``exitcode`` is None while any rank runs, else
the first non-zero exit code or 0; ``cancel`` SIGTERMs every rank (each
takes its emergency checkpoint) and ``cancel --force`` SIGKILLs them.
The ranks stay in the agent's process group, so losing the host (one
``killpg``) loses them too. A ``synthetic`` trial touches no device and
is one process.

Lifecycle contracts:

- **SIGTERM** (host preemption notice): running trials get SIGTERM —
  they are ``supervise=True`` runs, so each writes an atomic emergency
  checkpoint and exits cleanly — then the agent exits 0. SIGKILL (what
  the chaos scenario's ``killpg`` models) gives no such grace; the
  scheduler's lease notices and migrates.
- **idle timeout** (the mirror of the scheduler's lease): with
  ``--idle-timeout S``, an agent that has heard nothing for S seconds
  assumes its orchestrator is gone, SIGTERMs its trials and exits —
  no orphan trial ever fights a resumed sweep over a trial directory.
- ``assign`` refuses over-capacity and draining agents (typed refusal,
  never a queue: queueing is the scheduler's job); ``reset`` stops
  everything an earlier orchestrator left behind; ``drain`` stops new
  work while running trials finish.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import platform as _platform
import socketserver
import sys
import threading
import time
from typing import Dict, Optional

logger = logging.getLogger(__name__)

#: trial entry points an agent will run, by wire name — a closed set so a
#: compromised orchestrator message cannot name arbitrary callables
TRIAL_MAINS = ("default", "synthetic")


def _resolve_trial_main(name: str):
    from pytorch_distributed_nn_tpu_torch.experiments import runner

    if name == "default":
        return runner.default_trial_main
    if name == "synthetic":
        return runner.synthetic_trial_main
    raise ValueError(
        f"unknown trial main {name!r} (have: {', '.join(TRIAL_MAINS)})"
    )


#: the job a trial's rank processes read (``python -m`` this module)
RANK_JOB_BASENAME = "rank_job.json"


def trial_world(main: str, cfg: dict, devices: int) -> int:
    """The ranks of one trial: one for ``synthetic``; else ``num_workers
    x tensor_parallel x seq_parallel``, or the host's ``devices`` when
    ``num_workers`` is None (as the JAX trainer takes every device of
    its host)."""
    if main != "default":
        return 1
    if cfg.get("num_workers") is None:
        return int(devices)
    return (int(cfg["num_workers"]) * int(cfg.get("tensor_parallel") or 1)
            * int(cfg.get("seq_parallel") or 1))


@dataclasses.dataclass
class _AgentTrial:
    trial: int
    trial_dir: str
    proc: object
    started: float


class HostAgent:
    """State + op dispatch for one host agent (thread-safe)."""

    def __init__(
        self,
        agent_id: str,
        devices: int = 1,
        capacity: int = 1,
        labels: Optional[Dict[str, str]] = None,
        backend: str = "cuda",
    ):
        self.agent_id = agent_id
        self.devices = int(devices)
        self.capacity = int(capacity)
        self.labels = dict(labels or {})
        self.backend = backend  # the trials' device: "cuda" or "cpu"
        self.host = _platform.node()
        self.port = 0  # filled once the server binds
        self.draining = False
        self.last_contact = time.monotonic()
        self._lock = threading.Lock()
        self._trials: Dict[int, _AgentTrial] = {}
        self._stop = threading.Event()

    # -- capacity ---------------------------------------------------------

    def _active(self) -> Dict[int, _AgentTrial]:
        return {
            k: t for k, t in self._trials.items()
            if t.proc.exitcode is None
        }

    def profile(self) -> dict:
        """The host's planner calibration profile stub: what the fleet
        scheduler keys plan/calibration cache entries on. Backend and
        device count only — fitting real ceilings is the trial
        processes' business (``cli analyze --calibrate``)."""
        return {"backend": self.backend, "devices": self.devices}

    # -- ops --------------------------------------------------------------

    def handle(self, msg: dict) -> dict:
        self.last_contact = time.monotonic()
        op = msg.get("op")
        with self._lock:
            if op == "hello":
                return self._hello()
            if op == "ping":
                return {"ok": True}
            if op == "assign":
                return self._assign(msg)
            if op == "poll":
                return self._poll(msg)
            if op == "cancel":
                return self._cancel(msg)
            if op == "drain":
                self.draining = True
                return {"ok": True,
                        "running": sorted(self._active())}
            if op == "reset":
                return self._reset()
            if op == "shutdown":
                self._terminate_all()
                self._stop.set()
                return {"ok": True}
        return {"ok": False, "error": f"unknown op {op!r}"}

    def _hello(self) -> dict:
        return {
            "ok": True,
            "agent_id": self.agent_id,
            "host": self.host,
            "port": self.port,
            "pid": os.getpid(),
            "devices": self.devices,
            "capacity": self.capacity,
            "labels": self.labels,
            "profile": self.profile(),
            "draining": self.draining,
            "running": sorted(self._active()),
        }

    def _assign(self, msg: dict) -> dict:
        from pytorch_distributed_nn_tpu_torch.parallel.launch import (
            RankProcesses,
        )

        if self.draining:
            return {"ok": False, "error": "draining"}
        active = self._active()
        if len(active) >= self.capacity:
            return {"ok": False,
                    "error": f"at capacity ({self.capacity})"}
        try:
            trial = int(msg["trial"])
            trial_dir = str(msg["trial_dir"])
            cfg = dict(msg["cfg"])
            name = str(msg.get("main") or "default")
            _resolve_trial_main(name)
            world = trial_world(name, cfg, self.devices)
        except (KeyError, TypeError, ValueError) as e:
            return {"ok": False, "error": f"bad assign: {e}"}
        if trial in active:
            return {"ok": False, "error": f"trial {trial} already running"}
        # env the trial's ranks get (the trace relay), on top of the
        # agent's own
        env = dict(os.environ)
        env.update({str(k): str(v) for k, v in (msg.get("env") or {}).items()})
        if self.backend == "cpu":
            env["OMP_NUM_THREADS"] = "1"  # the ranks share the host's cores
        os.makedirs(trial_dir, exist_ok=True)
        job = os.path.join(trial_dir, RANK_JOB_BASENAME)
        with open(job + ".tmp", "w") as f:
            json.dump({"main": name, "trial_dir": trial_dir, "cfg": cfg,
                       "device": "cpu" if self.backend == "cpu" else None},
                      f)
        os.replace(job + ".tmp", job)
        proc = RankProcesses.start(
            [sys.executable, "-m", __name__, "--rank", job], world, env,
            new_session=False)
        self._trials[trial] = _AgentTrial(
            trial=trial, trial_dir=trial_dir, proc=proc,
            started=time.monotonic(),
        )
        logger.info("agent %s: assigned trial %d (%d rank(s), rank 0 pid "
                    "%s)", self.agent_id, trial, world, proc.pid)
        return {"ok": True, "pid": proc.pid}

    def _poll(self, msg: dict) -> dict:
        try:
            trial = int(msg["trial"])
        except (KeyError, TypeError, ValueError) as e:
            return {"ok": False, "error": f"bad poll: {e}"}
        t = self._trials.get(trial)
        if t is None:
            # an agent restart in between (or a never-assigned trial):
            # the scheduler treats unknown as crashed and re-dispatches
            return {"ok": True, "state": "unknown"}
        rc = t.proc.exitcode
        out = {
            "ok": True,
            "state": "running" if rc is None else "exited",
            "rc": rc,
        }
        # heartbeat relay: the supervised trial beats into its trial_dir
        # every step (resilience/supervisor.py); the agent reads it off
        # ITS disk so the orchestrator's staleness conviction does not
        # depend on shared-filesystem metadata freshness
        from pytorch_distributed_nn_tpu_torch.resilience.supervisor import (
            read_heartbeat,
        )

        beat = read_heartbeat(t.trial_dir)
        if beat is not None:
            out["heartbeat_age"] = round(
                max(0.0, time.time() - float(beat.get("time", 0.0))), 3
            )
            out["heartbeat_step"] = beat.get("step")
        return out

    def _cancel(self, msg: dict) -> dict:
        try:
            trial = int(msg["trial"])
        except (KeyError, TypeError, ValueError) as e:
            return {"ok": False, "error": f"bad cancel: {e}"}
        t = self._trials.get(trial)
        if t is None:
            return {"ok": True, "state": "unknown"}
        if t.proc.exitcode is None:
            if msg.get("force"):
                t.proc.kill()
            else:
                t.proc.terminate()  # SIGTERM -> emergency checkpoint
        return {"ok": True}

    def _reset(self) -> dict:
        """Stop everything and clear drain state. Caller holds
        ``_lock`` (the ``handle`` dispatch)."""
        stopped = sorted(self._active())
        self._terminate_all()
        self._trials.clear()
        self.draining = False
        return {"ok": True, "stopped": stopped}

    def _terminate_all(self) -> None:
        for t in self._trials.values():
            if t.proc.exitcode is None:
                t.proc.terminate()
        for t in self._trials.values():
            t.proc.join(15)
            if t.proc.exitcode is None:  # pragma: no cover - hang guard
                t.proc.kill()
                t.proc.join(5)

    # -- server loop ------------------------------------------------------

    def serve(
        self,
        listen: str = "127.0.0.1:0",
        register: Optional[str] = None,
        idle_timeout: float = 0.0,
    ) -> int:
        """Serve until SIGTERM/SIGINT, shutdown op, or idle timeout."""
        import signal as _signal

        agent = self
        host, _, port = listen.rpartition(":")

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                line = self.rfile.readline()
                if not line:
                    return
                try:
                    msg = json.loads(line)
                except ValueError:
                    resp = {"ok": False, "error": "bad json"}
                else:
                    try:
                        resp = agent.handle(msg)
                    except Exception as e:  # never kill the server
                        logger.exception("agent op failed")
                        resp = {"ok": False,
                                "error": f"{type(e).__name__}: {e}"}
                self.wfile.write(json.dumps(resp).encode() + b"\n")

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        srv = Server((host or "127.0.0.1", int(port or 0)), Handler)
        self.port = srv.server_address[1]
        if not host or host == "0.0.0.0":  # registration needs a real addr
            self.host = "127.0.0.1" if not host else self.host
        else:
            self.host = host
        thread = threading.Thread(
            target=srv.serve_forever, name="pdtn-fleet-agent", daemon=True,
        )
        thread.start()
        if register:
            tmp = register + ".tmp"
            with open(tmp, "w") as f:
                json.dump({
                    "agent_id": self.agent_id, "host": self.host,
                    "port": self.port, "pid": os.getpid(),
                    "devices": self.devices, "capacity": self.capacity,
                    "labels": self.labels, "profile": self.profile(),
                }, f)
            os.replace(tmp, register)

        def _on_signal(signum, frame):
            logger.warning(
                "agent %s: signal %d — terminating trials (emergency "
                "checkpoints) and exiting", self.agent_id, signum,
            )
            self._stop.set()

        if threading.current_thread() is threading.main_thread():
            _signal.signal(_signal.SIGTERM, _on_signal)
            _signal.signal(_signal.SIGINT, _on_signal)
        logger.info("agent %s listening on %s:%d (devices=%d capacity=%d)",
                    self.agent_id, self.host, self.port, self.devices,
                    self.capacity)
        try:
            while not self._stop.wait(0.2):
                if idle_timeout and (
                    time.monotonic() - self.last_contact > idle_timeout
                ):
                    logger.warning(
                        "agent %s: no orchestrator contact for %.0fs — "
                        "stopping trials and exiting (orphan guard)",
                        self.agent_id, idle_timeout,
                    )
                    break
        finally:
            with self._lock:
                self._terminate_all()
            srv.shutdown()
            srv.server_close()
        return 0


def agent_main(args) -> int:
    """``cli fleet agent`` entry: the device check + serve loop.

    ``--device cpu --devices N``: each trial of the agent runs as up to
    N gloo rank processes on the CPU. ``--device cuda --devices N``: the
    agent's trials run on N cards of its own (rank r on the r-th card
    ``CUDA_VISIBLE_DEVICES`` shows it); with fewer cards the agent
    refuses to start (``ValueError``, exit 2) — it never trains on the
    CPU instead.
    """
    from pytorch_distributed_nn_tpu_torch.experiments.fleet.transport import (
        visible_cards,
    )

    if args.device == "cuda":
        found = len(visible_cards())
        if found < args.devices:
            raise ValueError(
                f"--device cuda --devices {args.devices} needs "
                f"{args.devices} cards, found {found}")
    labels = {}
    for item in args.label or []:
        k, sep, v = item.partition("=")
        if not sep:
            raise ValueError(f"bad --label {item!r}: expected key=value")
        labels[k] = v
    agent = HostAgent(
        agent_id=args.agent_id,
        devices=args.devices,
        capacity=args.capacity,
        labels=labels,
        backend=args.device,
    )
    return agent.serve(
        listen=args.listen,
        register=args.register,
        idle_timeout=args.idle_timeout,
    )


def rank_main(job_path: str) -> int:
    """One rank process of a trial: ``main(trial_dir, cfg, device)`` of
    the job the agent wrote (its torchrun environment names the rank)."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s "
                               "%(message)s")
    with open(job_path) as f:
        job = json.load(f)
    _resolve_trial_main(job["main"])(job["trial_dir"], job["cfg"],
                                     job["device"])
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"] and len(sys.argv) == 3:
        sys.exit(rank_main(sys.argv[2]))
    sys.exit("usage: python -m pytorch_distributed_nn_tpu_torch.experiments"
             ".fleet.agent --rank JOB (a rank of a fleet trial; run agents "
             "with the package's fleet agent command)")
