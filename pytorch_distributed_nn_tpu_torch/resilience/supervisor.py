"""Run supervision: signals, heartbeat, stall watchdog and validated
resume. The port's ``pytorch_distributed_nn_tpu/resilience/supervisor.py``.

- :class:`RunSupervisor` turns SIGTERM/SIGINT into a flag the trainer
  reads at each step boundary: the step in flight completes, an emergency
  checkpoint is written, and the process exits 0 (a pause to resume, not a
  failure). It beats ``<train_dir>/heartbeat.json`` after every step.
- :class:`Watchdog` (``--heartbeat-grace``) flags a run whose heartbeat
  is older than its grace: ``<train_dir>/STALLED``, a ``stall`` event, and
  the ``on_stall`` callback.
- :func:`resume_latest_valid` walks ``model_step_<N>`` newest first,
  verifies each against its manifest, restores the first that proves
  intact, and quarantines the rest on its way.

The JAX supervisor also writes the metric registry to ``metrics.prom``
at each beat; the port has no Prometheus exporter yet (ROADMAP Queue 1
item 6).
"""

from __future__ import annotations

import json
import logging
import os
import signal
import threading
import time
from typing import Callable, Optional

from pytorch_distributed_nn_tpu_torch.observability.core import get_telemetry

logger = logging.getLogger(__name__)

HEARTBEAT_FILE = "heartbeat.json"
STALLED_FILE = "STALLED"


class RunSupervisor:
    """Context manager: signal handlers, heartbeat and, with ``grace``, a
    :class:`Watchdog`. Handlers are installed from the main thread only
    (``signal.signal`` is restricted to it; elsewhere the supervisor only
    beats) and restored on exit."""

    def __init__(self, run_dir: Optional[str] = None,
                 grace: Optional[float] = None,
                 on_stall: Optional[Callable[[float], None]] = None,
                 signals=(signal.SIGTERM, signal.SIGINT)):
        self.run_dir = run_dir
        self.grace = grace
        self._signals = signals
        self._old_handlers: dict = {}
        self._stop = threading.Event()
        self.stop_signal: Optional[int] = None
        self._watchdog: Optional[Watchdog] = None
        self._on_stall = on_stall
        #: fields every heartbeat carries besides step, time and pid
        self.extra: dict = {}

    def __enter__(self) -> "RunSupervisor":
        if threading.current_thread() is threading.main_thread():
            for sig in self._signals:
                self._old_handlers[sig] = signal.signal(sig, self._handler)
        else:
            logger.info("RunSupervisor outside the main thread: heartbeat "
                        "only, no signal handlers")
        if self.run_dir is not None and self.grace is not None:
            self._watchdog = Watchdog(heartbeat_path(self.run_dir),
                                      grace=self.grace,
                                      on_stall=self._on_stall).start()
        return self

    def __exit__(self, *exc) -> None:
        for sig, old in self._old_handlers.items():
            signal.signal(sig, old)
        self._old_handlers.clear()
        if self._watchdog is not None:
            self._watchdog.stop()
            self._watchdog = None

    def _handler(self, signum, frame) -> None:
        logger.warning("signal %s received: finishing the step in flight, "
                       "then an emergency checkpoint and a clean exit",
                       signal.Signals(signum).name)
        self.stop_signal = signum
        self._stop.set()

    @property
    def should_stop(self) -> bool:
        return self._stop.is_set()

    def request_stop(self) -> None:
        """What the signal handler does, for a caller."""
        self._stop.set()

    def beat(self, step: int) -> None:
        """Record that ``step`` completed (an atomic write)."""
        if self.run_dir is not None:
            write_heartbeat(self.run_dir, step, extra=self.extra or None)


def heartbeat_path(run_dir: str) -> str:
    return os.path.join(run_dir, HEARTBEAT_FILE)


def write_heartbeat(run_dir: str, step: int,
                    extra: Optional[dict] = None) -> None:
    os.makedirs(run_dir, exist_ok=True)
    path = heartbeat_path(run_dir)
    payload = {"step": int(step), "time": time.time(), "pid": os.getpid()}
    if extra:
        payload.update(extra)
    with open(path + ".tmp", "w") as f:
        json.dump(payload, f)
    os.replace(path + ".tmp", path)


class Watchdog:
    """A daemon thread that flags the run as stalled when the heartbeat is
    older than ``grace`` seconds, once per stall episode (a fresh beat
    ends the episode). A missing heartbeat is not a stall: the first step
    may still be building its kernels."""

    def __init__(self, hb_path: str, grace: float,
                 on_stall: Optional[Callable[[float], None]] = None,
                 poll: Optional[float] = None):
        if grace <= 0:
            raise ValueError(f"grace must be > 0, got {grace}")
        self.hb_path = hb_path
        self.grace = grace
        self.on_stall = on_stall
        self.poll = poll if poll is not None else max(grace / 4.0, 0.05)
        self.stalled = threading.Event()
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Watchdog":
        self._thread = threading.Thread(target=self._run, name="pdtn-watchdog",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._done.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    def check_once(self) -> Optional[float]:
        """One poll: the heartbeat's age when stalled, else ``None``."""
        try:
            with open(self.hb_path) as f:
                beat = json.load(f)
        except (OSError, ValueError):
            return None
        age = time.time() - float(beat.get("time", 0.0))
        if age <= self.grace:
            if self.stalled.is_set():
                logger.info("watchdog: heartbeat recovered (age %.1fs)", age)
                self.stalled.clear()
            return None
        if not self.stalled.is_set():
            self.stalled.set()
            step = beat.get("step")
            logger.error("watchdog: run STALLED: heartbeat %.1fs old (grace "
                         "%.1fs), last completed step %s", age, self.grace,
                         step)
            try:
                marker = os.path.join(os.path.dirname(self.hb_path),
                                      STALLED_FILE)
                with open(marker, "w") as f:
                    json.dump({"age": age, "step": step,
                               "time": time.time()}, f)
            except OSError:
                logger.exception("watchdog: could not write STALLED marker")
            get_telemetry().emit("stall", step=step,
                                 age_seconds=round(age, 3), grace=self.grace)
            if self.on_stall is not None:
                self.on_stall(age)
        return age

    def _run(self) -> None:
        while not self._done.wait(self.poll):
            self.check_once()


def resume_latest_valid(directory: str, state, params_only: bool = False,
                        quarantine: bool = True, restore_fn=None):
    """Restore into ``state`` the newest checkpoint of ``directory`` that
    verifies and restores; quarantine each newer one that does not.
    Returns the restored state, or ``None`` when none is valid.
    ``restore_fn(path, state)`` replaces ``checkpoint.restore_checkpoint``."""
    from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt

    from pytorch_distributed_nn_tpu_torch.models.convert import (
        load_train_state,
    )

    for step in ckpt.all_steps(directory)[::-1]:
        path = ckpt.checkpoint_path(directory, step)
        try:
            if restore_fn is not None:
                ok, reason = ckpt.verify_checkpoint(path)
                if ok:
                    return restore_fn(path, state)
            else:
                load_train_state(state, ckpt.load_verified(path),
                                 params_only=params_only)
                return state
        except (ValueError, RuntimeError, KeyError, OSError) as e:
            reason = str(e)
        logger.warning("checkpoint %s is corrupt (%s)", path, reason)
        if quarantine:
            logger.warning("quarantined %s -> %s", path,
                           ckpt.quarantine_checkpoint(path))
    return None
