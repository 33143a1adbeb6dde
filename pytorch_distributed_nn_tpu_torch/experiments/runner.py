"""The sweep runner: N trials as supervised subprocesses, crash-safe
(the port's copy of the JAX package's ``experiments/runner.py``: the same
journal events and fields, scheduling, retries and exit statuses; each
trial trains the port's :class:`~..training.trainer.Trainer`).

Execution model (docs/experiments.md):

- **Subprocess isolation** (the bench.py lesson): every trial attempt runs
  in a freshly SPAWNED process — three Trainers sharing one interpreter
  contaminate each other's allocator/GC behavior, and a diverged trial
  must never poison its siblings' runtime. The parent imports no torch
  and never touches CUDA; it only spawns children and reads their
  streams back. The children are spawned, not forked: a child forked
  from a process holding a CUDA context cannot use the card.
- **The device**: :attr:`RunnerConfig.device` is handed to each trial as
  an argument of its own (not a config field, so the journal's
  overrides and config stay the JAX package's). ``None`` trains on the
  card, and a trial without one fails (journaled ``crashed``); ``"cpu"``
  trains on the CPU.
- **Bounded pool**: at most ``concurrency`` trials run at once; the rest
  queue. On an accelerator host keep concurrency at 1 (trials would fight
  for the chip); CPU sweeps parallelize freely.
- **Supervised trials**: every trial trains with ``supervise=True`` into
  ``<sweep_dir>/trials/<id>/`` — a manifest-headed telemetry stream (the
  telemetry blindness the in-process lr_sweep had is gone), heartbeat,
  and an emergency checkpoint on SIGTERM. Results are read back from the
  stream via ``observability.reader`` — never from stdout.
- **Timeout + retry**: an attempt past ``trial_timeout`` is terminated
  (SIGTERM first — the supervised trial checkpoints — then SIGKILL);
  crashed/timed-out/short attempts retry up to ``retries`` times with the
  shared backoff schedule (``resilience.retry.backoff_delays``), resuming
  from the trial's last valid checkpoint instead of restarting.
- **Journal-first**: ``trial_start`` is appended before a spawn and
  ``trial_end`` after the stream read, so ``--resume`` re-derives exactly
  which trials are done (skipped — results reused byte-identically),
  dead (re-queued) or in flight (resumed through the checkpoint path).
- **Launch counts**: every trial lifetime appends the port's kernel
  launch counts of its steps to ``trials/<id>/launches.jsonl``, so the
  kernels a spawned trial ran are counted by the trial itself.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import re
import signal
import time
from typing import Callable, Dict, List, Optional

from pytorch_distributed_nn_tpu_torch.experiments import journal as jr
from pytorch_distributed_nn_tpu_torch.experiments import report, scheduler
from pytorch_distributed_nn_tpu_torch.experiments.spec import SweepSpec, Trial
from pytorch_distributed_nn_tpu_torch.observability import tracing

logger = logging.getLogger(__name__)

#: exit code ``synthetic_trial_main`` uses for an injected crash
SYNTHETIC_CRASH_RC = 17
#: one line per trial lifetime: its start step, steps and kernel launches
LAUNCHES_BASENAME = "launches.jsonl"


class SweepInterrupted(RuntimeError):
    """SIGTERM landed mid-sweep: children were asked to checkpoint and
    stop, the journal was fsynced. ``cli sweep`` maps this to rc 3; the
    sweep continues later with ``cli sweep resume``."""


@dataclasses.dataclass
class RunnerConfig:
    sweep_dir: str
    max_steps: int = 100  # per-trial full budget (tune.sh: 100)
    tail: int = 10  # trailing-loss ranking window
    concurrency: int = 2
    trial_timeout: Optional[float] = None  # seconds per attempt
    retries: int = 1  # extra attempts per trial after a failure
    ckpt_every: Optional[int] = None  # trial eval_freq (None: rung budget)
    scheduler: str = "grid"  # grid | asha
    eta: int = 3
    min_steps: Optional[int] = None  # asha: first-rung budget override
    resume: bool = False
    # device budget of the --plan-mesh hook (0 = off): the roofline
    # planner picks each network's mesh, in a subprocess
    plan_mesh: int = 0
    retry_base_delay: float = 0.25  # backoff base between attempts
    # Heartbeat-staleness conviction (the supervisor Watchdog grace,
    # routed through the pool): a RUNNING trial whose heartbeat.json goes
    # quiet past this many seconds is terminated and re-queued NOW
    # instead of waiting out --trial-timeout (which may be unset — the
    # old behavior waited forever on a silently-wedged trial). A missing
    # heartbeat never convicts: compile time is unbounded, and synthetic
    # trials don't beat (the Watchdog contract).
    heartbeat_grace: Optional[float] = None
    # the trials' torch device: None = the card, "cpu" = the CPU
    device: Optional[str] = None


def default_trial_main(trial_dir: str, cfg: dict,
                       device: Optional[str] = None) -> None:
    """Child entry point: one real training run from a config dict on
    ``device`` (None: the card), as one rank of the torchrun world of
    its environment (a fleet agent's trial of several ranks,
    ``experiments/fleet/agent.py``), else as a world of one.

    Runs in a spawned subprocess; the torch import and the card's context
    happen HERE, never in the orchestrating parent. cuDNN runs its
    deterministic algorithms, so that a trial resumed from a checkpoint
    continues bit for bit (the journal reuses a trial's records as they
    are, and :func:`.report.trailing_loss` dedupes replayed steps on that
    promise). Every rank counts its kernel launches over the lifetime's
    steps (:class:`_LifetimeLaunches`).
    """
    from pytorch_distributed_nn_tpu_torch.ops import kernels
    from pytorch_distributed_nn_tpu_torch.training.trainer import (
        TrainConfig,
        Trainer,
    )
    from pytorch_distributed_nn_tpu_torch.utils.device import deterministic

    deterministic()
    cfg = dict(cfg)
    cfg["kill_ranks"] = tuple(cfg.get("kill_ranks") or ())
    if int(os.environ.get("RANK", "0")) == 0:
        # before the group forms: no rank of this lifetime has stepped yet
        _fold_killed_lifetimes(trial_dir)
    trainer = Trainer(TrainConfig(**cfg), device=device)
    try:
        kernels.reset_launch_counts()
        counts = _LifetimeLaunches(trial_dir, trainer, kernels.launch_counts)
        trainer.telemetry.subscribe(counts.on_record)
        trainer.train()
        counts.close()
    finally:
        trainer.close()


#: a lifetime's counts so far, one file a rank, rewritten after each step
LIVE_LAUNCHES = "launches.live.r{rank}.json"


class _LifetimeLaunches:
    """One rank's kernel launches over one lifetime of a trial: after
    every step record :data:`LIVE_LAUNCHES` is rewritten (atomically)
    with ``{start_step, steps, launches, rank, world}``, and
    :meth:`close` moves it to a line of :data:`LAUNCHES_BASENAME` once
    the lifetime has trained (a preempted one too: it returns after its
    emergency checkpoint). A SIGKILLed lifetime leaves its live file
    behind, and the next lifetime folds it into a line
    (:func:`_fold_killed_lifetimes`): every lifetime is counted."""

    def __init__(self, trial_dir: str, trainer, launch_counts):
        self.path = os.path.join(trial_dir, LAUNCHES_BASENAME)
        self.live = os.path.join(trial_dir,
                                 LIVE_LAUNCHES.format(rank=trainer.rank))
        self._trainer = trainer
        self._launch_counts = launch_counts
        self.steps = 0
        self._publish()

    def record(self) -> dict:
        t = self._trainer
        return {"start_step": t.start_step, "steps": self.steps,
                "launches": self._launch_counts(), "rank": t.rank,
                "world": t.world}

    def _publish(self) -> None:
        with open(self.live + ".tmp", "w") as f:
            json.dump(self.record(), f)
        os.replace(self.live + ".tmp", self.live)

    def on_record(self, rec: dict) -> None:
        if rec.get("kind") == "step":
            self.steps += 1
            self._publish()

    def close(self) -> None:
        _append_line(self.path, self.record())
        os.unlink(self.live)


def _fold_killed_lifetimes(trial_dir: str) -> None:
    """The live files a SIGKILLed lifetime left in ``trial_dir`` become its
    lines of :data:`LAUNCHES_BASENAME` (rank order), marked ``killed``."""
    pat = re.compile(re.escape(LIVE_LAUNCHES).replace(
        re.escape("{rank}"), r"(\d+)") + "$")
    try:
        names = os.listdir(trial_dir)
    except FileNotFoundError:
        return
    left = sorted((int(m.group(1)), n) for n in names
                  if (m := pat.match(n)))
    for _, name in left:
        path = os.path.join(trial_dir, name)
        with open(path) as f:
            rec = json.load(f)
        _append_line(os.path.join(trial_dir, LAUNCHES_BASENAME),
                     dict(rec, killed=True))
        os.unlink(path)


def _append_line(path: str, rec: dict) -> None:
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")
        f.flush()
        os.fsync(f.fileno())


def _synthetic_loss(lr: float, seed: int, step: int) -> float:
    """Pure deterministic 'training curve': minimized near lr=0.05 at any
    step (so grid and ASHA agree on the winner), decreasing in step,
    divergent (NaN from step 2) for lr > 1."""
    if lr > 1.0 and step >= 2:
        return float("nan")
    dist = abs(math.log10(max(lr, 1e-9)) - math.log10(0.05))
    return (0.2 + dist) * (1.0 + 10.0 / (step + 5.0)) + 1e-4 * (seed % 7)


def synthetic_trial_main(trial_dir: str, cfg: dict,
                         device: Optional[str] = None) -> None:
    """A fake trial for tests/selftest: identical orchestration surface
    (manifest-headed stream, resume, the FaultPlan crash/delay grammar)
    with zero torch cost (``device`` is not used). ``faults="crash@N"``
    exits mid-run on the first lifetime only; ``delay@N:Ts`` sleeps (the
    timeout-classification fixture). Loss is :func:`_synthetic_loss` — a pure function of
    (lr, seed, step), so resumed and uninterrupted trials match exactly.
    """
    from pytorch_distributed_nn_tpu_torch.observability import reader
    from pytorch_distributed_nn_tpu_torch.observability.core import (
        STREAM_BASENAME,
        Telemetry,
        run_manifest,
    )
    from pytorch_distributed_nn_tpu_torch.resilience.faults import FaultPlan

    plan = FaultPlan.parse(cfg.get("faults") or "")
    path = os.path.join(trial_dir, STREAM_BASENAME)
    start = 0
    if cfg.get("resume") and os.path.isfile(path):
        rs = reader.read_stream(path)
        start = max(
            (int(r["step"]) for r in rs.steps if r.get("step") is not None),
            default=0,
        )
    lr = float(cfg.get("lr") or 0.1)
    seed = int(cfg.get("seed") or 0)
    budget = int(cfg.get("max_steps") or 0)
    # uniform per-step pacing (distinct from the targeted delay@ fault):
    # what the fleet's chaos and tests use to model a workload whose wall
    # time is real while its loss stays a pure function of (lr, seed, step)
    step_sleep = float(cfg.get("step_sleep") or 0.0)
    t = Telemetry.for_run(path, run_manifest(
        config={"network": cfg.get("network"), "lr": lr, "seed": seed},
        start_step=start,
    ))
    try:
        for step in range(start + 1, budget + 1):
            if step_sleep:
                time.sleep(step_sleep)
            for s, _rank, secs in plan.delay_table():
                if s == step:
                    time.sleep(secs)
            if start == 0 and any(
                e.kind == "crash" and e.step == step for e in plan.entries
            ):
                t.flush(fsync=True)
                os._exit(SYNTHETIC_CRASH_RC)
            t.log_step({
                "step": step,
                "loss": _synthetic_loss(lr, seed, step),
                "step_time": 1e-3,
                "data_time": 0.0,
            })
    finally:
        t.close()


def classify_attempt(
    rc: Optional[int], timed_out: bool, steps: int, budget: int
) -> str:
    """Attempt outcome -> trial_end status (docs/experiments.md failure
    table). Pure — unit-tested without a single subprocess."""
    if timed_out:
        return jr.STATUS_TIMEOUT
    if rc != 0:
        return jr.STATUS_CRASHED
    if steps < budget:
        return jr.STATUS_INCOMPLETE
    return jr.STATUS_COMPLETED


@dataclasses.dataclass
class _Attempt:
    trial: Trial
    attempt: int = 0
    not_before: float = 0.0  # monotonic: backoff gate


@dataclasses.dataclass
class _Running:
    proc: object
    att: _Attempt
    rung: "scheduler.Rung"
    t0: float
    deadline: Optional[float]
    hb: object = None  # supervisor.Watchdog over the trial's heartbeat


class SweepRunner:
    """Drives one sweep end to end (or resumes one from its journal)."""

    def __init__(
        self,
        spec: SweepSpec,
        base_config,
        cfg: RunnerConfig,
        trial_main: Optional[
            Callable[[str, dict, Optional[str]], None]] = None,
    ):
        self.spec = spec
        self.cfg = cfg
        self.trial_main = trial_main or default_trial_main
        self._base_dict = (
            dataclasses.asdict(base_config)
            if dataclasses.is_dataclass(base_config) else dict(base_config)
        )
        self._stop = False
        # sweep root of the distributed trace: every trial attempt gets a
        # child span relayed through PDTN_TRACE_CONTEXT, so trial
        # manifests carry orchestrator -> (agent ->) trial lineage
        self.trace = tracing.new_trace_context()
        self._failed: List[int] = []
        self._executed_steps = 0
        self._retries_total = 0
        self.journal: Optional[object] = None
        self._completed_count = 0
        self._mesh_cache: Dict[str, dict] = {}

    # -- lifecycle --------------------------------------------------------

    def run(self) -> dict:
        c = self.cfg
        if c.concurrency < 1:
            raise ValueError(f"concurrency must be >= 1, got "
                             f"{c.concurrency}")
        trials = self.spec.trials()
        rungs = scheduler.make_rungs(
            c.scheduler, len(trials), c.max_steps,
            eta=c.eta, min_steps=c.min_steps,
        )
        prior = jr.load_journal(c.sweep_dir)
        if prior is not None and not c.resume:
            raise ValueError(
                f"{c.sweep_dir} already holds a sweep journal — "
                "use 'cli sweep resume' (or run --resume) to continue it, "
                "or a fresh --sweep-dir"
            )
        if c.resume:
            if prior is None:
                raise ValueError(
                    f"--resume: no {jr.SWEEP_BASENAME} under {c.sweep_dir}"
                )
            recorded = prior.sweep_meta.get("spec")
            if recorded and recorded != self.spec.describe():
                raise ValueError(
                    "--resume spec mismatch: journal records "
                    f"{recorded!r}, got {self.spec.describe()!r} — a "
                    "resumed sweep must re-run the recorded spec"
                )
        t_start = time.monotonic()
        self.journal = jr.open_journal(
            c.sweep_dir,
            self.spec.describe(),
            self._base_dict,
            sweep_meta={
                "samples": self.spec.samples,
                "sweep_seed": self.spec.sweep_seed,
                "mode": self.spec.mode,
                "scheduler": {
                    "kind": c.scheduler, "eta": c.eta,
                    "min_steps": c.min_steps,
                    "max_steps": c.max_steps,
                    "planned_steps": scheduler.planned_steps(rungs),
                    "rungs": [dataclasses.asdict(r) for r in rungs],
                },
                "runner": {
                    "concurrency": c.concurrency,
                    "trial_timeout": c.trial_timeout,
                    "retries": c.retries,
                    "ckpt_every": c.ckpt_every,
                    "tail": c.tail,
                    "plan_mesh": c.plan_mesh,
                    "heartbeat_grace": c.heartbeat_grace,
                },
                "trace": self.trace.fields(),
                **self._sweep_meta_extra(),
            },
            resumed=bool(c.resume),
        )
        reg = self.journal.registry
        reg.gauge(
            "sweep_trials_total", help="trials in the sweep spec",
        ).set(len(trials))
        self._gauges()
        self._on_journal_open()
        prev_handler = None
        try:
            prev_handler = signal.signal(signal.SIGTERM, self._on_sigterm)
        except ValueError:  # non-main thread (tests driving in a worker)
            prev_handler = None
        try:
            results: Dict[int, float] = {}
            by_index = {t.index: t for t in trials}
            entrants = [t.index for t in trials]
            for rung in rungs:
                if rung.index > 0:
                    entrants = scheduler.promote(results, rung.keep)
                results = self._run_rung(
                    rung, [by_index[i] for i in entrants], prior,
                )
            wall = time.monotonic() - t_start
            self.journal.flush(fsync=True)
            jstate = jr.load_journal(c.sweep_dir)
            rows = report.leaderboard(c.sweep_dir, jstate, tail=c.tail)
            best = rows[0] if rows and rows[0]["status"] == "completed" \
                else None
            if best is not None:
                reg.gauge(
                    "sweep_best_loss",
                    help="trailing loss of the current best trial",
                ).set(best["loss"] if best["loss"] is not None
                      else float("nan"))
            self._export_prom()
            return {
                "sweep_dir": c.sweep_dir,
                "scheduler": c.scheduler,
                "trials": len(trials),
                "rungs": [dataclasses.asdict(r) for r in rungs],
                "planned_steps": scheduler.planned_steps(rungs),
                "executed_steps": self._executed_steps,
                "failed": sorted(self._failed),
                "wall_s": wall,
                "best": best,
                "leaderboard": rows,
            }
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)
            self.journal.close()

    def _on_sigterm(self, signum, frame):  # pragma: no cover - signal path
        logger.warning("sweep: SIGTERM — stopping after running trials "
                       "checkpoint")
        self._stop = True

    # -- rung execution ---------------------------------------------------

    def _run_rung(
        self,
        rung: scheduler.Rung,
        entrants: List[Trial],
        prior: Optional[jr.JournalState],
    ) -> Dict[int, float]:
        c = self.cfg
        results: Dict[int, float] = {}
        pend: List[_Attempt] = []
        for trial in entrants:
            rec = (
                prior.trials.get(trial.index).completed_at(rung.index)
                if prior is not None and trial.index in prior.trials
                else None
            )
            if rec is not None and rec.get("loss") is not None:
                # journaled result reused verbatim: a completed trial is
                # never re-run, its metrics stay byte-identical
                results[trial.index] = float(rec["loss"])
                self._completed_count += 1
                continue
            pend.append(_Attempt(trial=trial))
        self._gauges(running=0)
        running: Dict[int, _Running] = {}
        try:
            while pend or running:
                if self._stop:
                    raise SweepInterrupted(
                        f"interrupted with {len(running)} trial(s) running "
                        f"and {len(pend)} queued"
                    )
                self._poll_hosts(running, pend, rung)
                now = time.monotonic()
                for att in list(pend):
                    if len(running) >= c.concurrency:
                        break
                    if att.not_before > now:
                        continue
                    pend.remove(att)
                    handle = self._launch(att, rung)
                    if handle is None:
                        # fleet: no host has a free slot right now — the
                        # attempt re-queues AT ITS PLACE IN LINE behind a
                        # short gate (a migrated trial at the head stays
                        # at the head) instead of blocking the loop
                        att.not_before = time.monotonic() + 0.1
                        pend.insert(0, att)
                        continue
                    running[att.trial.index] = handle
                    self._gauges(running=len(running))
                progressed = False
                for idx, run in list(running.items()):
                    now = time.monotonic()
                    timed_out = (
                        run.deadline is not None and now > run.deadline
                    )
                    if run.proc.is_alive() and not timed_out:
                        stale = self._heartbeat_stale(run)
                        if stale is None:
                            continue
                        # silent wedge: the trial process is alive but
                        # its heartbeat went quiet past the grace — the
                        # Watchdog conviction, routed through the pool.
                        # Terminate (SIGTERM first: a merely-slow trial
                        # still emergency-checkpoints) and let the retry
                        # path re-queue it NOW, not at --trial-timeout.
                        timed_out = True
                        self.journal.emit(
                            "stall", trial=idx,
                            age_seconds=round(stale, 3),
                            grace=c.heartbeat_grace, source="pool",
                        )
                    self._reap(run.proc, timed_out)
                    del running[idx]
                    progressed = True
                    status, loss, fields = self._finish(run, timed_out)
                    if status == jr.STATUS_COMPLETED:
                        results[idx] = loss
                        self._completed_count += 1
                    elif run.att.attempt < c.retries:
                        delay = self._retry_delay(run.att)
                        self.journal.emit(
                            "retry", label=f"trial {idx}",
                            attempt=run.att.attempt + 1,
                            attempts=c.retries + 1,
                            error=f"trial {status}", exhausted=False,
                            trial=idx,
                        )
                        self._retries_total += 1
                        pend.append(_Attempt(
                            trial=run.att.trial,
                            attempt=run.att.attempt + 1,
                            not_before=time.monotonic() + delay,
                        ))
                    else:
                        self._failed.append(idx)
                    self._gauges(running=len(running))
                    self._export_prom()
                if not progressed and running:
                    time.sleep(0.05)
                elif pend and not running:
                    # everything queued is backoff-gated: wait it out
                    time.sleep(min(
                        0.05,
                        max(0.0, min(a.not_before for a in pend)
                            - time.monotonic()) + 0.01,
                    ))
        except SweepInterrupted:
            self._terminate(running)
            self.journal.emit(
                "preempt", reason="sigterm",
                running=sorted(running), queued=len(pend),
            )
            self.journal.flush(fsync=True)
            self._export_prom()
            raise
        return results

    # -- one attempt ------------------------------------------------------

    def _launch(self, att: _Attempt,
                rung: scheduler.Rung) -> Optional[_Running]:
        import multiprocessing

        c = self.cfg
        trial = att.trial
        tdir = jr.trial_dir(c.sweep_dir, trial.index)
        os.makedirs(tdir, exist_ok=True)
        cfg = self._trial_config(trial, rung, att)
        span = self.trace.child()
        self.journal.emit(
            "trial_start", trial=trial.index, rung=rung.index,
            attempt=att.attempt, budget=rung.budget, seed=trial.seed,
            overrides=trial.overrides, resume=cfg["resume"],
            **span.fields(),
        )
        self.journal.flush()
        ctx = multiprocessing.get_context("spawn")
        proc = ctx.Process(
            target=self.trial_main, args=(tdir, cfg, c.device),
            daemon=False,
        )
        # spawn snapshots os.environ at start(): hand the attempt's span
        # down via the trace-relay env var (the launch loop is single-
        # threaded, so set-around-start is race-free), then restore so
        # the orchestrator's own environment stays untouched
        prev = os.environ.get(tracing.TRACE_ENV)
        os.environ[tracing.TRACE_ENV] = span.header()
        try:
            proc.start()
        finally:
            if prev is None:
                os.environ.pop(tracing.TRACE_ENV, None)
            else:
                os.environ[tracing.TRACE_ENV] = prev
        now = time.monotonic()
        hb = None
        if c.heartbeat_grace:
            from pytorch_distributed_nn_tpu_torch.resilience import (
                supervisor,
            )

            # never start()ed: the pool polls check_once() itself, so
            # the conviction (STALLED marker + typed stall event) is the
            # supervisor Watchdog's own, without a thread per trial
            hb = supervisor.Watchdog(supervisor.heartbeat_path(tdir),
                                     grace=c.heartbeat_grace)
        return _Running(
            proc=proc, att=att, rung=rung, t0=now,
            deadline=(now + c.trial_timeout) if c.trial_timeout else None,
            hb=hb,
        )

    def _trial_config(
        self, trial: Trial, rung: scheduler.Rung, att: _Attempt
    ) -> dict:
        c = self.cfg
        tdir = jr.trial_dir(c.sweep_dir, trial.index)
        cfg = dict(self._base_dict)
        cfg.update(self._plan_mesh_overrides(
            trial.overrides.get("network") or cfg.get("network")
        ))
        cfg.update(trial.overrides)
        budget = rung.budget
        eval_freq = (
            min(int(c.ckpt_every), budget) if c.ckpt_every else budget
        )
        from pytorch_distributed_nn_tpu_torch.observability.core import (
            STREAM_BASENAME,
        )

        resume = (
            att.attempt > 0
            or rung.index > 0
            or os.path.isfile(os.path.join(tdir, STREAM_BASENAME))
        )
        cfg.update(
            train_dir=tdir,
            seed=trial.seed,
            max_steps=budget,
            eval_freq=eval_freq,
            supervise=True,
            resume=resume,
            log_every=1,
            metrics_path=None,
            warm_start=None,
        )
        return cfg

    def _plan_mesh_overrides(self, network: Optional[str]) -> dict:
        """The ``--plan-mesh`` hook: the roofline planner's
        predicted-fastest mesh for this trial's model on the configured
        device budget, planned in a spawned subprocess (this process
        imports no torch). Best effort: an unplannable model keeps the
        base mesh."""
        c = self.cfg
        if not c.plan_mesh or not network:
            return {}
        if network not in self._mesh_cache:
            rec = plan_in_subprocess(dict(self._base_dict, network=network),
                                     c.plan_mesh, c.device)
            overrides = {} if rec is None else {
                k: rec[k] for k in ("num_workers", "tensor_parallel",
                                    "seq_parallel")}
            if overrides:
                logger.info(
                    "plan-mesh: %s on %d device(s) -> dp=%d tp=%d sp=%d",
                    network, c.plan_mesh, overrides["num_workers"],
                    overrides["tensor_parallel"], overrides["seq_parallel"])
            else:
                logger.warning("plan-mesh: planner failed for %s (trials "
                               "keep the base mesh)", network)
            self._mesh_cache[network] = overrides
        return self._mesh_cache[network]

    def _reap(self, proc, timed_out: bool) -> None:
        if timed_out and proc.is_alive():
            # SIGTERM first: a supervised trial writes its emergency
            # checkpoint and exits cleanly; escalate only if it hangs
            proc.terminate()
            proc.join(15)
            if proc.is_alive():  # pragma: no cover - pathological hang
                proc.kill()
        proc.join(15)

    def _finish(self, run: _Running, timed_out: bool):
        """Read the attempt's stream back; journal its trial_end."""
        c = self.cfg
        trial = run.att.trial
        tdir = jr.trial_dir(c.sweep_dir, trial.index)
        metrics = report.trial_metrics(tdir, tail=c.tail) or {}
        steps = int(metrics.get("steps") or 0)
        status = classify_attempt(
            run.proc.exitcode, timed_out, steps, run.rung.budget
        )
        loss = metrics.get("loss")
        if status == jr.STATUS_COMPLETED and (
            loss is None or not math.isfinite(loss)
        ):
            # diverged, not broken: the trial ran its budget but its loss
            # is not a number. Rank it last AND leave typed evidence — the
            # lr_sweep of old returned a bare `inf` with no trace of why.
            loss = float("inf")
            self.journal.emit(
                "nonfinite_skip", trial=trial.index, rung=run.rung.index,
                steps=steps, reason="nonfinite trailing loss",
            )
        self._executed_steps += max(
            0, steps - int(metrics.get("attempt_start_step") or 0)
        )
        self.journal.emit(
            "trial_end", trial=trial.index, rung=run.rung.index,
            attempt=run.att.attempt, status=status, rc=run.proc.exitcode,
            steps=steps, loss=loss,
            step_rate=metrics.get("step_rate"), mfu=metrics.get("mfu"),
            overrides=trial.overrides,
            duration_s=round(time.monotonic() - run.t0, 3),
            **self._attempt_extra(run),
        )
        self.journal.flush()
        return status, loss, metrics

    # -- fleet seams (experiments/fleet/scheduler.py overrides these) -----

    def _sweep_meta_extra(self) -> dict:
        """Extra sweep-manifest fields (fleet: transport + lease)."""
        return {}

    def _on_journal_open(self) -> None:
        """Called once the journal is writable (fleet: host_join events,
        fleet gauges)."""

    def _poll_hosts(self, running, pend, rung) -> None:
        """Called every loop iteration before launches/reaps (fleet:
        lease pings, dead-host detection, trial migration)."""

    def _heartbeat_stale(self, run: _Running) -> Optional[float]:
        """Stale heartbeat age for a RUNNING attempt, or None. The base
        pool polls the trial's local heartbeat file through the
        supervisor Watchdog; the fleet uses the agent-relayed age."""
        if run.hb is None:
            return None
        return run.hb.check_once()

    def _attempt_extra(self, run: _Running) -> dict:
        """Extra trial_end fields (fleet: the host that ran it)."""
        return {}

    def _retry_delay(self, att: _Attempt) -> float:
        from pytorch_distributed_nn_tpu_torch.resilience.retry import (
            backoff_delays,
        )

        delays = backoff_delays(
            self.cfg.retries + 1, base_delay=self.cfg.retry_base_delay,
            max_delay=5.0, seed=att.trial.seed,
        )
        return delays[min(att.attempt, len(delays) - 1)] if delays else 0.0

    def _terminate(self, running: Dict[int, _Running]) -> None:
        for run in running.values():
            if run.proc.is_alive():
                run.proc.terminate()
        for run in running.values():
            run.proc.join(15)
            if run.proc.is_alive():  # pragma: no cover
                run.proc.kill()
                run.proc.join(5)

    # -- telemetry --------------------------------------------------------

    def _gauges(self, running: int = 0) -> None:
        reg = self.journal.registry
        reg.gauge(
            "sweep_trials_completed", help="trial/rung completions so far",
        ).set(self._completed_count)
        reg.gauge(
            "sweep_trials_failed",
            help="trials that exhausted their retry budget",
        ).set(len(self._failed))
        reg.gauge(
            "sweep_trials_running", help="trial subprocesses alive now",
        ).set(running)
        reg.gauge(
            "sweep_steps_executed",
            help="optimizer steps actually trained across all attempts",
        ).set(self._executed_steps)
        c = reg.counter(
            "sweep_retries_total", help="trial attempts retried",
        )
        if self._retries_total > c.value:
            c.inc(self._retries_total - c.value)

    def _export_prom(self) -> None:
        from pytorch_distributed_nn_tpu_torch.observability import promexport

        try:
            promexport.write_textfile(
                self.journal.registry,
                os.path.join(self.cfg.sweep_dir, promexport.PROM_BASENAME),
            )
        except OSError:  # pragma: no cover - scrape surface best-effort
            logger.exception("sweep metrics.prom write failed")


def plan_in_subprocess(cfg: dict, devices: int, device: Optional[str] = None,
                       timeout: float = 300.0) -> Optional[dict]:
    """The roofline planner's top candidate for ``cfg``'s network on
    ``devices`` devices, planned in a SPAWNED process (the orchestrator
    imports no torch): ``{"num_workers", "tensor_parallel",
    "seq_parallel", "predicted_ms"}``, or None when planning failed or
    timed out. ``device`` ("cpu", or None for the card) picks the
    planner's default profile."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=_plan_worker,
                    args=(dict(cfg), int(devices), device or "cuda", q),
                    daemon=True)
    p.start()
    try:
        return q.get(timeout=timeout)
    except Exception:
        logger.warning("plan-mesh: the planner gave no plan in %g s",
                       timeout)
        return None
    finally:
        p.join(5)
        if p.is_alive():  # pragma: no cover - planner hang guard
            p.kill()
            p.join(5)


def _plan_worker(cfg: dict, devices: int, device: str, q) -> None:
    """Child entry: torch and the planner live HERE."""
    try:
        from pytorch_distributed_nn_tpu_torch.analysis import planner

        result = planner.plan(
            cfg.get("network"), devices,
            batch_size=cfg.get("batch_size"),
            optimizer=cfg.get("optimizer") or "sgd",
            seq_len=cfg.get("seq_len"),
            device=device,
        )
        top = next((c for c in result.get("candidates", [])
                    if not c.get("skipped")), None)
        if top is None:
            q.put(None)
            return
        mesh = top.get("mesh") or {}
        q.put({
            "num_workers": int(mesh.get("data") or 1),
            "tensor_parallel": int(mesh.get("model") or 1),
            "seq_parallel": int(mesh.get("seq") or 1),
            "predicted_ms": top.get("predicted_ms"),
        })
    except Exception as e:
        logging.getLogger(__name__).warning("plan worker: %r", e)
        q.put(None)
