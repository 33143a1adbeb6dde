"""Rank processes of one torchrun world, started and held as one handle.

The port runs one rank per process (``torch.distributed.run``'s model):
a launch of ``world`` ranks is ``world`` processes of one command, rank
``r`` with the torchrun environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``),
so each builds its group as ``train`` under ``torch.distributed.run``
does: gloo on the CPU, NCCL with rank r on ``cuda:r`` on the card. The
chaos suite's rank launches (``resilience/chaos.py``) and a fleet
agent's trials (``experiments/fleet/agent.py``) both start their ranks
here. This module imports no torch: the agent that holds the handle
never does.
"""

from __future__ import annotations

import signal
import socket
import subprocess
import time
from typing import List, Optional, Sequence

#: seconds the other ranks get to leave once one rank has failed
GRACE_S = 20.0


def free_port() -> int:
    """A TCP port on the loopback interface that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class RankProcesses:
    """The processes of one world, held as one process-like handle
    (:meth:`start`): :attr:`exitcode` is None while any rank runs, else
    the exit code of the first rank seen to fail, or 0. Once a rank has
    failed, the others get :data:`GRACE_S` seconds to leave before they
    are killed: a rank whose peer died waits in its next collective."""

    def __init__(self, procs: List[subprocess.Popen]):
        self.procs = procs
        self.failed: Optional[int] = None  # the first rank seen to fail
        self._kill_at: Optional[float] = None

    @classmethod
    def start(cls, argv: Sequence[str], world: int, env: dict,
              logs: Optional[Sequence[str]] = None,
              new_session: bool = True) -> "RankProcesses":
        """Start ``world`` processes of ``argv`` with ``env`` plus the
        torchrun environment of a single-host world on a free loopback
        port. Rank r's output goes to ``logs[r]`` (appended), else to
        this process's. ``new_session=False`` keeps the ranks in the
        caller's process group, so that a signal to the group reaches
        them."""
        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        base = dict(env, MASTER_ADDR="127.0.0.1",
                    MASTER_PORT=str(free_port()), WORLD_SIZE=str(world),
                    LOCAL_WORLD_SIZE=str(world))
        procs: List[subprocess.Popen] = []
        try:
            for r in range(world):
                log = open(logs[r], "ab") if logs else None
                try:
                    procs.append(subprocess.Popen(
                        list(argv),
                        env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
                        stdout=log, stderr=(subprocess.STDOUT if log
                                            else None),
                        start_new_session=new_session))
                finally:
                    if log is not None:
                        log.close()
        except BaseException:
            for p in procs:
                p.kill()
                p.wait()
            raise
        return cls(procs)

    @property
    def pid(self) -> int:
        """Rank 0's process id."""
        return self.procs[0].pid

    @property
    def exitcode(self) -> Optional[int]:
        """None while a rank runs, else the first failed rank's exit code
        or 0; reading it kills the ranks left past the grace that the
        first failure started."""
        rcs = [p.poll() for p in self.procs]
        if self.failed is None:
            bad = [r for r, rc in enumerate(rcs) if rc not in (None, 0)]
            if bad:
                self.failed = bad[0]
                self._kill_at = time.monotonic() + GRACE_S
        if any(rc is None for rc in rcs):
            if self._kill_at is None or time.monotonic() < self._kill_at:
                return None
            self.kill()
        return (self.procs[self.failed].returncode
                if self.failed is not None else 0)

    def _signal(self, sig: int) -> None:
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.send_signal(sig)
                except ProcessLookupError:  # exited in between
                    pass

    def terminate(self) -> None:
        """SIGTERM every rank still running: a supervised trainer takes
        its emergency checkpoint and exits."""
        self._signal(signal.SIGTERM)

    def kill(self) -> None:
        """SIGKILL every rank still running, and reap them."""
        self._signal(signal.SIGKILL)
        for p in self.procs:
            p.wait()

    def join(self, timeout: Optional[float] = None) -> None:
        """Wait until every rank has exited, or ``timeout`` seconds."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.exitcode is None:
            if deadline is not None and time.monotonic() > deadline:
                return
            time.sleep(0.05)
