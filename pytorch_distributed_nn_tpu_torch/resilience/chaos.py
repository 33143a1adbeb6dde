"""Canned chaos scenarios: the CI-gateable proof that fault handling works.
The port's copy of ``pytorch_distributed_nn_tpu/resilience/chaos.py``:
the same scenarios, checks, check wording and exit codes, on the port's
trainer, loaders, checkpoints and serving stack.

Each scenario builds real Trainers on a tiny model, injects faults through
the same ``--faults`` surface users get, and asserts the *invariant* the
subsystem promises — not just "it didn't crash":

- ``crash_resume``  — crash mid-run, resume from the emergency checkpoint,
  and the final params + optimizer state are BITWISE identical to an
  uninterrupted run (the data stream, dropout keys and sync keys are all
  functions of (seed, step), never of wall-clock or restart count).
- ``preempt``       — SIGTERM mid-run: the supervisor finishes the
  in-flight step, writes an emergency checkpoint, and exits CLEANLY.
- ``straggler``     — a 5s-delayed contributor against a 1s deadline is
  dropped (K-of-N) exactly at the fault step, the report names the rank,
  and the renormalized update keeps every parameter finite.
- ``torn_ckpt``     — a checkpoint torn after publish is convicted by its
  CRC32 manifest, quarantined, and resume lands on the previous valid step.
- ``nan_grad``      — a NaN-poisoned batch is caught by the non-finite
  guard: that step's update is skipped, parameters never absorb a NaN.
- ``async_ckpt``    — the zero-stall checkpoint pipeline: async output is
  byte-identical to sync; a crash while a background save is in flight
  drains it, the torn in-flight file is quarantined on restart and resume
  lands on the last VALID step; keep-last GC bounds the train_dir.
- ``flightrec``     — an injected 5s stall is convicted by the flight
  recorder and captured as exactly one incident bundle; a second stall
  inside the cooldown window is rate-limited away.
- ``data_resume``   — streaming input: a run killed mid-epoch resumes via
  the checkpoint's iterator-state sidecar, and its loss trajectory and
  final params+opt are BITWISE identical to an uninterrupted run's.
- ``elastic_resume`` — resume on another number of ranks (shrink, regrow)
  and a corrupt shard convicted mid-reshard.
- ``slo_burn``      — an injected serving slowdown burns the SLO: one
  ``slo_breach`` bundle, ``obs slo check`` fails, a healthy twin passes.
- ``live_reload``   — registry → hot-swap → canary → auto-rollback under
  load, zero dropped requests.
- ``generate``      — generative serving with a mid-stream hot swap.
- ``replica_loss``  — the replicated frontend survives a SIGKILLed replica
  and a rolling restart with zero client-visible failures.
- ``sweep_resume``  — a SIGTERMed sweep resumes from its journal.
- ``fleet_preempt`` — a fleet agent SIGKILLed mid-rung: its trials
  migrate and resume elastically on the survivors.
- ``smoke``         — a fast composite (nan_grad + torn_ckpt + validated
  resume).

**Ranks are processes.** The JAX suite runs a data-parallel scenario's
``num_workers`` workers as virtual devices of one process. The port runs
one rank per process (``torchrun``'s model): a config of ``k > 1``
workers is launched as ``k`` rank processes of this module, each with the
torchrun environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``), so the trainer builds its group as
``train`` under ``torch.distributed.run`` does: gloo on the CPU, NCCL with
rank r on ``cuda:r`` on the card. Each rank writes its records to a
directory of its own and rank 0 its final state; the launcher reads them
back. Every rank has a main thread, so ``preempt``'s SIGTERM and the
supervised runs behave as in ``train``. A one-rank config trains
in-process.

**Devices.** Every trainer, engine and replica of a scenario runs on the
scenario's ``device`` (the CLI's ``--device``; the card by default). On
the card a scenario that needs more ranks than there are cards is
refused before it trains (:func:`run_scenario` returns 2): ranks never
share a card and never move to the CPU. The ranks run cuDNN's
deterministic algorithms (:func:`..utils.device.deterministic`), which
the bitwise invariants need.

``cli chaos --scenario <name>`` exits nonzero on any violated invariant.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class Check:
    name: str
    ok: bool
    detail: str = ""


def _lenet_cfg(train_dir: str, **kw):
    from pytorch_distributed_nn_tpu_torch.training.config import TrainConfig

    base = dict(
        network="LeNet", dataset="MNIST", batch_size=32, test_batch_size=32,
        lr=0.01, momentum=0.9, num_workers=4, synthetic_size=64,
        train_dir=train_dir, log_every=100,
    )
    base.update(kw)
    return TrainConfig(**base)


def _bert_cfg(train_dir: str, **kw):
    from pytorch_distributed_nn_tpu_torch.training.config import TrainConfig

    base = dict(
        network="BertTiny", dataset="MLMSynth", batch_size=8,
        test_batch_size=8, optimizer="adam", lr=1e-3, num_workers=2,
        seq_len=32, vocab_size=64, train_dir=train_dir, log_every=100,
    )
    base.update(kw)
    return TrainConfig(**base)


# ---------------------------------------------------------------------------
# rank processes
# ---------------------------------------------------------------------------

#: seconds a launch of rank processes may take before it is killed
RANK_TIMEOUT_S = 900.0


@dataclasses.dataclass
class _Outcome:
    """One launch of a training config, as rank 0 reports it: its step
    records, where it started, its data-parallel degree and global
    batch, whether an :class:`InjectedCrash` ended it, the elastic plan
    it took (``{"changed", "describe"}`` or None) and the state trees it
    captured (``"initial"``: after construction and resume, ``"final"``:
    after training or the crash), flat ``{path: array}`` on the host."""

    history: List[dict]
    start_step: int
    n_workers: int
    batch_size: int
    crashed: bool
    plan: Optional[dict]
    states: Dict[str, dict]


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """``{"a/b/c": array}`` of a nested dict/list tree's leaves."""
    if isinstance(tree, dict):
        out: Dict[str, np.ndarray] = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
        return out
    if tree is None:
        return {}
    return {prefix.rstrip("/"): np.asarray(tree)}


def _host_state(trainer) -> Dict[str, np.ndarray]:
    """The trainer's params and optimizer state on the host, flat."""
    from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt

    tree = ckpt.state_tree(trainer.state)
    return _flatten({"params": tree["params"],
                     "opt_state": tree["opt_state"]})


def _config_dict(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d["kill_ranks"] = list(d.get("kill_ranks") or ())
    return d


def _train_rank(cfg: dict, device: str, train: bool = True,
                capture: Tuple[str, ...] = ("final",)):
    """One rank of a training launch: build the trainer (it joins the
    torchrun world of its environment), train unless ``train`` is False,
    and return ``(record, states)`` (:class:`_Outcome`'s fields, and the
    rank's kernel launches, ``launches``)."""
    from pytorch_distributed_nn_tpu_torch.ops import kernels
    from pytorch_distributed_nn_tpu_torch.resilience.faults import (
        InjectedCrash,
    )
    from pytorch_distributed_nn_tpu_torch.training.trainer import (
        TrainConfig,
        Trainer,
    )

    cfg = dict(cfg, kill_ranks=tuple(cfg.get("kill_ranks") or ()))
    before = kernels.launch_counts()
    t = Trainer(TrainConfig(**cfg), device=device)
    states: Dict[str, dict] = {}
    try:
        plan = t._elastic_plan
        rec = {
            "start_step": t.start_step, "n_workers": t.n_workers,
            "batch_size": t.config.batch_size, "history": [],
            "crashed": False,
            "plan": None if plan is None else {
                "changed": plan.changed, "describe": plan.describe()},
        }
        keep = t.rank == 0
        if "initial" in capture and keep:
            states["initial"] = _host_state(t)
        if train:
            try:
                rec["history"] = t.train()
            except InjectedCrash:
                rec["crashed"] = True
        if "final" in capture and keep:
            states["final"] = _host_state(t)
    finally:
        t.close()
    rec["launches"] = {k: v - before.get(k, 0)
                       for k, v in kernels.launch_counts().items()}
    return rec, states


def _package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _log_tail(path: str, n: int = 3000) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(max(0, os.path.getsize(path) - n))
            return f.read().decode("utf-8", "replace")
    except OSError:
        return ""


#: kernel launches of the rank processes started since
#: :func:`run_scenario` began, by kernel (it reports them with its own)
_RANK_LAUNCHES: Dict[str, int] = {}


def _spawn_ranks(job: str, world: int, device: str, out_dir: str,
                 kwargs: dict) -> List[dict]:
    """Run :data:`_RANK_JOBS` ``[job](device=device, **kwargs)`` in
    ``world`` rank processes of one torchrun world
    (:class:`..parallel.launch.RankProcesses`); returns each rank's
    record. Rank 0's state trees land in ``out_dir/states_<name>.npz``.
    A rank that fails fails the launch with its log's tail; the others
    then get the launcher's grace to leave before they are killed."""
    from pytorch_distributed_nn_tpu_torch.parallel.launch import (
        RankProcesses,
    )

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "job.json"), "w") as f:
        json.dump({"job": job, "device": device, "kwargs": kwargs}, f)
    env = dict(os.environ)
    root = _package_root()
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"  # as _one_thread says
    logs = [os.path.join(out_dir, f"rank{r}.log") for r in range(world)]
    ranks = RankProcesses.start(
        [sys.executable, "-m", __name__, "--rank-job", out_dir], world, env,
        logs=logs)
    try:
        ranks.join(RANK_TIMEOUT_S)
        if ranks.exitcode is None:
            raise RuntimeError(
                f"chaos ranks of {job!r} did not finish in "
                f"{RANK_TIMEOUT_S:.0f}s; rank logs under {out_dir}")
        if ranks.failed is not None:
            raise RuntimeError(
                f"chaos rank {ranks.failed} of {world} ({job!r}) exited "
                f"{ranks.procs[ranks.failed].returncode}; its log ends:\n"
                + _log_tail(logs[ranks.failed]))
    finally:
        ranks.kill()
    records = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            records.append(json.load(f))
        for k, v in (records[-1].get("launches") or {}).items():
            _RANK_LAUNCHES[k] = _RANK_LAUNCHES.get(k, 0) + v
    return records


def _load_states(out_dir: str) -> Dict[str, dict]:
    states = {}
    for name in ("initial", "final"):
        path = os.path.join(out_dir, f"states_{name}.npz")
        if os.path.isfile(path):
            with np.load(path) as z:
                states[name] = {k: z[k] for k in z.files}
    return states


def _launch(cfg, device: str, world: Optional[int] = None,
            train: bool = True,
            capture: Tuple[str, ...] = ("final",)) -> _Outcome:
    """Build (and with ``train`` train) ``cfg`` on ``world`` ranks
    (default: its ``num_workers``) on ``device``: in-process for one
    rank, else as rank processes (module docstring)."""
    world = int(world or cfg.num_workers or 1)
    if world == 1:
        rec, states = _train_rank(_config_dict(cfg), device, train, capture)
    else:
        parent = os.path.dirname(os.path.abspath(cfg.train_dir))
        os.makedirs(parent, exist_ok=True)
        out_dir = tempfile.mkdtemp(
            prefix=os.path.basename(cfg.train_dir) + ".ranks-", dir=parent)
        rec = _spawn_ranks("train", world, device, out_dir, dict(
            cfg=_config_dict(cfg), train=train, capture=list(capture)))[0]
        states = _load_states(out_dir)
    return _Outcome(rec["history"], rec["start_step"], rec["n_workers"],
                    rec["batch_size"], rec["crashed"], rec["plan"], states)


def _run(cfg, device: str, world: Optional[int] = None):
    """Train to completion; returns (history, final host state tree,
    start step). An injected crash raises, as the JAX ``_run`` lets it."""
    from pytorch_distributed_nn_tpu_torch.resilience.faults import (
        InjectedCrash,
    )

    o = _launch(cfg, device, world)
    if o.crashed:
        raise InjectedCrash(f"the run of {cfg.train_dir} crashed")
    return o.history, o.states["final"], o.start_step


def _trees_bitwise_equal(a: dict, b: dict) -> Check:
    la, lb = sorted(a), sorted(b)
    if la != lb:
        return Check("tree structure", False,
                     f"{len(la)} vs {len(lb)} leaves")
    for i, k in enumerate(la):
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.shape != y.shape or not np.array_equal(x, y):
            diff = (np.max(np.abs(x.astype(np.float64) - y.astype(np.float64)))
                    if x.shape == y.shape else float("nan"))
            return Check("bitwise equality", False,
                         f"leaf {i} differs (max abs diff {diff:.3e})")
    return Check("bitwise equality", True, f"{len(la)} leaves identical")


def _params_finite(state: dict) -> Check:
    bad = sum(int(not np.all(np.isfinite(v)))
              for k, v in state.items() if k.startswith("params/"))
    return Check("params finite", bad == 0,
                 "all finite" if bad == 0 else f"{bad} non-finite leaves")


def _by_step(history) -> Dict[int, dict]:
    return {r["step"]: r for r in history}


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------


def scenario_crash_resume(workdir: str, device: str) -> List[Check]:
    """Crash entering step 4, resume from the emergency checkpoint: the
    final params + optimizer state equal an uninterrupted run's bit for
    bit (BertTiny on 2 ranks)."""
    from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt

    crash_at, total = 4, 6
    dir_a = os.path.join(workdir, "uninterrupted")
    dir_b = os.path.join(workdir, "crashed")
    checks: List[Check] = []

    _, state_a, _ = _run(_bert_cfg(dir_a, max_steps=total), device)

    crashed = _launch(_bert_cfg(dir_b, max_steps=total,
                                faults=f"crash@{crash_at}"),
                      device, capture=()).crashed
    checks.append(Check("crash fired", crashed,
                        f"InjectedCrash raised entering step {crash_at}"))
    latest = ckpt.latest_step(dir_b)
    checks.append(Check(
        "emergency checkpoint", latest == crash_at - 1,
        f"latest_step={latest}, expected {crash_at - 1}",
    ))

    _, state_b, start = _run(_bert_cfg(dir_b, max_steps=total, resume=True),
                             device)
    checks.append(Check("resumed from emergency step", start == crash_at - 1,
                        f"start_step={start}"))
    eq = _trees_bitwise_equal(state_a, state_b)
    checks.append(Check(
        "crash+resume == uninterrupted (params+opt, bitwise)", eq.ok,
        eq.detail,
    ))
    return checks


def scenario_preempt(workdir: str, device: str) -> List[Check]:
    """SIGTERM entering step 3 of a supervised run: the step in flight
    completes, an emergency checkpoint is written and the run exits
    cleanly, its telemetry intact (LeNet on 4 ranks)."""
    from pytorch_distributed_nn_tpu_torch.observability import reader
    from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt

    stop_at, total = 3, 8
    d = os.path.join(workdir, "preempted")
    history, _, _ = _run(_lenet_cfg(
        d, max_steps=total, supervise=True, faults=f"preempt@{stop_at}",
    ), device)
    checks = [Check(
        "clean early exit", len(history) == stop_at - 1,
        f"{len(history)} steps completed before exiting (expected "
        f"{stop_at - 1} of {total})",
    )]
    latest = ckpt.latest_step(d)
    checks.append(Check("emergency checkpoint", latest == stop_at - 1,
                        f"latest_step={latest}"))
    ok, reason = ckpt.verify_checkpoint(ckpt.checkpoint_path(d, latest))
    checks.append(Check("emergency checkpoint verifies", ok, reason))
    # telemetry survives preemption: the emergency path fsyncs the stream,
    # so the final completed step's record — and the preempt event — must
    # be readable from the run dir after the "dead" process is gone
    rs = reader.read_stream(d)
    checks.append(Check(
        "telemetry manifest is the stream header",
        rs.manifest is not None and rs.manifest.get("run_id") is not None,
        f"manifest={bool(rs.manifest)}",
    ))
    last_step = rs.steps[-1]["step"] if rs.steps else None
    checks.append(Check(
        "final step record survives preemption",
        last_step == stop_at - 1 and not rs.truncated,
        f"last step record={last_step}, truncated={rs.truncated} "
        f"(expected {stop_at - 1}, clean tail)",
    ))
    checks.append(Check(
        "preempt event recorded",
        any(e.get("type") == "preempt" for e in rs.events),
        f"event types: {sorted({e.get('type') for e in rs.events})}",
    ))
    return checks


def scenario_straggler(workdir: str, device: str) -> List[Check]:
    """A 5s-delayed rank against a 1s deadline is dropped (K-of-N) at the
    fault step, named in the report, and every update stays finite
    (LeNet on 4 ranks)."""
    fault_step, fault_rank = 3, 2
    d = os.path.join(workdir, "straggler")
    history, state, _ = _run(_lenet_cfg(
        d, max_steps=4,
        straggler_deadline=1.0,
        faults=f"delay@{fault_step}:p{fault_rank}:5s",
    ), device)
    by_step = _by_step(history)
    rec = by_step.get(fault_step, {})
    checks = [Check(
        "delayed rank dropped at fault step",
        rec.get("straggler_dropped") == 1.0
        and rec.get("straggler_dropped_mask") == float(2**fault_rank),
        f"step {fault_step}: dropped={rec.get('straggler_dropped')}, "
        f"mask={rec.get('straggler_dropped_mask')} "
        f"(expected 1 / {2**fault_rank})",
    )]
    others = {
        s: r.get("straggler_dropped")
        for s, r in by_step.items()
        if s != fault_step
    }
    checks.append(Check(
        "no drops on healthy steps",
        all(v == 0.0 for v in others.values()),
        f"drops by step: {others}",
    ))
    checks.append(Check(
        "observed skew reported",
        rec.get("straggler_skew", 0.0) > 5.0,
        f"skew={rec.get('straggler_skew', 0.0):.1f}x at the fault step",
    ))
    checks.append(Check(
        "slowest rank attributed",
        rec.get("straggler_slowest_rank") == float(fault_rank),
        f"straggler_slowest_rank={rec.get('straggler_slowest_rank')} "
        f"(expected {fault_rank})",
    ))
    checks.append(Check(
        "losses finite through the drop",
        all(np.isfinite(r["loss"]) for r in history),
        "renormalized K-of-N average kept every update finite",
    ))
    checks.append(_params_finite(state))
    return checks


def scenario_torn_ckpt(workdir: str, device: str) -> List[Check]:
    """A checkpoint torn after publish is convicted by its CRC32 manifest
    and quarantined; resume lands on the previous valid step (LeNet on 4
    ranks)."""
    from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt

    d = os.path.join(workdir, "torn")
    _run(_lenet_cfg(d, max_steps=6, eval_freq=2, faults="torn_ckpt@6"),
         device)
    checks = []
    ok, reason = ckpt.verify_checkpoint(ckpt.checkpoint_path(d, 6))
    checks.append(Check("torn checkpoint convicted by manifest", not ok,
                        f"verify says: {reason}"))
    ok4, _ = ckpt.verify_checkpoint(ckpt.checkpoint_path(d, 4))
    checks.append(Check("previous checkpoint still valid", ok4, "step 4 ok"))

    start = _launch(_lenet_cfg(d, max_steps=6, resume=True), device,
                    train=False, capture=()).start_step
    checks.append(Check(
        "resume falls back to latest VALID step", start == 4,
        f"start_step={start} (torn step 6 skipped)",
    ))
    qdir = os.path.join(d, ckpt.QUARANTINE_DIR)
    quarantined = sorted(os.listdir(qdir)) if os.path.isdir(qdir) else []
    checks.append(Check(
        "torn checkpoint quarantined", "model_step_6" in quarantined,
        f"quarantine/: {quarantined}",
    ))
    return checks


def scenario_nan_grad(workdir: str, device: str) -> List[Check]:
    """A NaN-poisoned batch is caught by the non-finite guard: that
    step's update is skipped and the parameters never absorb a NaN
    (LeNet on 4 ranks)."""
    fault_step = 2
    d = os.path.join(workdir, "nan")
    history, state, _ = _run(_lenet_cfg(
        d, max_steps=4, faults=f"nan_grad@{fault_step}",
        skip_nonfinite=True, data_layout="host",
    ), device)
    by_step = _by_step(history)
    skipped = {s: r.get("skipped_nonfinite") for s, r in by_step.items()}
    checks = [Check(
        "poisoned step skipped, healthy steps applied",
        all(
            v == (1.0 if s == fault_step else 0.0)
            for s, v in skipped.items()
        ),
        f"skipped_nonfinite by step: {skipped}",
    )]
    checks.append(_params_finite(state))
    post = [r["loss"] for r in history if r["step"] > fault_step]
    checks.append(Check(
        "training recovers after the skip",
        all(np.isfinite(x) for x in post),
        f"post-fault losses: {[round(x, 4) for x in post]}",
    ))
    return checks


def scenario_async_ckpt(workdir: str, device: str) -> List[Check]:
    """Async checkpoint pipeline under fire (training/async_ckpt.py; LeNet
    on 4 ranks):

    1. byte identity — the same deterministic run checkpointed sync and
       async produces byte-for-byte identical ``model_step_<N>`` files,
       both passing verify, and the async stream carries ``stall_ms``;
    2. crash with a save in flight — the in-flight async save of step 4 is
       torn (``torn_ckpt@4`` fires on the WRITER THREAD), the crash
       entering step 5 drains it and writes an emergency checkpoint that
       the same fault tears again; validated resume quarantines the torn
       step and falls back to the last VALID step;
    3. retention — ``keep_last=1`` deletes the older verified step after
       the newer publish and emits ``checkpoint_gc``.
    """
    from pytorch_distributed_nn_tpu_torch.observability import reader
    from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt

    checks: List[Check] = []

    # -- 1: sync-vs-async byte identity on the same deterministic run ----
    d_sync = os.path.join(workdir, "sync")
    d_async = os.path.join(workdir, "async")
    _run(_lenet_cfg(d_sync, max_steps=4, eval_freq=2, async_ckpt=False),
         device)
    _run(_lenet_cfg(d_async, max_steps=4, eval_freq=2, async_ckpt=True),
         device)
    for s in (2, 4):
        with open(ckpt.checkpoint_path(d_sync, s), "rb") as f:
            a = f.read()
        with open(ckpt.checkpoint_path(d_async, s), "rb") as f:
            b = f.read()
        checks.append(Check(
            f"async step-{s} checkpoint byte-identical to sync", a == b,
            f"{len(a)} vs {len(b)} bytes",
        ))
        ok, reason = ckpt.verify_checkpoint(ckpt.checkpoint_path(d_async, s))
        checks.append(Check(f"async step-{s} checkpoint verifies", ok,
                            reason))
    rs = reader.read_stream(d_async)
    writes = [e for e in rs.events if e.get("type") == "checkpoint_write"]
    checks.append(Check(
        "async stream records stall_ms on every write",
        len(writes) == 2 and all("stall_ms" in e and e.get("async")
                                 for e in writes),
        f"stall_ms: {[e.get('stall_ms') for e in writes]}",
    ))

    # -- 2: crash while a background save is in flight --------------------
    d_crash = os.path.join(workdir, "crash")
    crashed = _launch(_lenet_cfg(
        d_crash, max_steps=6, eval_freq=2, async_ckpt=True,
        faults="torn_ckpt@4,crash@5",
    ), device, capture=()).crashed
    checks.append(Check("crash fired with a save in flight", crashed,
                        "InjectedCrash entering step 5"))
    ok4, reason4 = ckpt.verify_checkpoint(ckpt.checkpoint_path(d_crash, 4))
    checks.append(Check(
        "in-flight (and emergency) step-4 checkpoint torn", not ok4,
        f"verify says: {reason4}",
    ))
    start = _launch(_lenet_cfg(d_crash, max_steps=6, resume=True), device,
                    train=False, capture=()).start_step
    checks.append(Check(
        "restart resumes from the last VALID step", start == 2,
        f"start_step={start} (torn step 4 skipped)",
    ))
    qdir = os.path.join(d_crash, ckpt.QUARANTINE_DIR)
    quarantined = sorted(os.listdir(qdir)) if os.path.isdir(qdir) else []
    checks.append(Check(
        "torn in-flight checkpoint quarantined",
        "model_step_4" in quarantined,
        f"quarantine/: {quarantined}",
    ))

    # -- 3: keep-last retention ------------------------------------------
    d_gc = os.path.join(workdir, "gc")
    _run(_lenet_cfg(d_gc, max_steps=4, eval_freq=2, async_ckpt=True,
                    keep_last=1), device)
    steps_left = ckpt.all_steps(d_gc)
    checks.append(Check(
        "keep-last GC leaves only the newest step", steps_left == [4],
        f"steps on disk: {steps_left}",
    ))
    rs_gc = reader.read_stream(d_gc)
    gc_events = [e for e in rs_gc.events if e.get("type") == "checkpoint_gc"]
    checks.append(Check(
        "checkpoint_gc event names the deleted step",
        len(gc_events) == 1 and gc_events[0].get("deleted") == [2],
        f"gc events: {gc_events}",
    ))
    return checks


def scenario_flightrec(workdir: str, device: str) -> List[Check]:
    """Flight recorder under a real injected stall (LeNet on 4 ranks):

    a 5s host delay of rank 1 at step 40 (under a 2s heartbeat grace) must
    be convicted — by the watchdog's stall event or the step-time EWMA
    regression, whichever lands first — and captured as exactly ONE
    incident bundle: non-empty profiler trace dir, event ring containing
    the ``fault_injected`` record, run-manifest copy, resolved env, and a
    generated ``report.md``. A second identical delay at step 55 falls
    inside the capture cooldown and must NOT produce a second bundle.
    ``obs incidents`` lists the bundle and exits 0.
    """
    from pytorch_distributed_nn_tpu_torch.observability import (
        flightrec,
        reader,
    )
    from pytorch_distributed_nn_tpu_torch.observability.obs_cli import (
        main_obs,
    )

    d = os.path.join(workdir, "flightrec")
    history, _, _ = _run(_lenet_cfg(
        d, max_steps=70, log_every=1, flightrec="default",
        supervise=True, heartbeat_grace=2.0,
        faults="delay@40:p1:5s,delay@55:p1:5s",
    ), device)
    checks = [Check("run completed under the recorder", len(history) == 70,
                    f"{len(history)} steps")]
    incidents = flightrec.list_incidents(d)
    checks.append(Check(
        "exactly one incident bundle (second delay muted by cooldown)",
        len(incidents) == 1,
        f"bundles: {[e['name'] for e in incidents]}",
    ))
    if not incidents:
        return checks
    inc = incidents[0]
    checks.append(Check(
        "incident kind is stall or step_regression",
        inc.get("kind") in ("stall", "step_regression"),
        f"kind={inc.get('kind')} step={inc.get('step')}",
    ))
    checks.append(Check(
        "bundle carries a non-empty trace dir", inc["has_trace"],
        f"trace/ under {inc['name']}",
    ))
    checks.append(Check(
        "bundle carries a generated report.md",
        inc["has_report"]
        and os.path.getsize(os.path.join(inc["path"], "report.md")) > 200,
        "report.md",
    ))
    checks.append(Check(
        "bundle carries the run manifest copy",
        os.path.isfile(os.path.join(inc["path"], "manifest.json"))
        and os.path.isfile(os.path.join(inc["path"], "env.json")),
        "manifest.json + env.json",
    ))
    ring_types = set()
    fault_steps = []
    with open(os.path.join(inc["path"], "events.jsonl")) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get("kind") == "event":
                ring_types.add(rec.get("type"))
                if rec.get("type") == "fault_injected":
                    fault_steps.append(rec.get("step"))
    checks.append(Check(
        "event ring contains the fault_injected record",
        40 in fault_steps,
        f"fault_injected steps in ring: {fault_steps} "
        f"(ring event types: {sorted(ring_types)})",
    ))
    rs = reader.read_stream(d)
    incident_events = [e for e in rs.events if e.get("type") == "incident"]
    checks.append(Check(
        "stream records exactly one incident event",
        len(incident_events) == 1,
        f"{[(e.get('incident'), e.get('step')) for e in incident_events]}",
    ))
    checks.append(Check(
        "obs incidents lists the bundle and exits 0",
        main_obs(["incidents", d]) == 0
        and main_obs(["incidents", d, inc["name"]]) == 0,
        "cli obs incidents",
    ))
    return checks


def _same_batch(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def scenario_data_resume(workdir: str, device: str) -> List[Check]:
    """Streaming-input resume (docs/data.md): the loader's iterator state
    rides inside the checkpoint, so a run killed MID-EPOCH and resumed
    consumes a bitwise-identical batch sequence to an uninterrupted run.

    1. loader level — same seed + same shard layout ⇒ identical batch
       sequence across ``workers`` counts, and across a ``state()`` /
       ``restore()`` at an arbitrary mid-epoch step with prefetch in
       flight;
    2. trainer level — a BertTiny run over token shards (2 ranks) crashed
       entering step 4 writes an emergency checkpoint WITH the
       ``model_step_<N>.data.json`` sidecar; the resumed run's per-step
       losses match the uninterrupted run's bitwise and the final
       params + optimizer state are bitwise identical — which can only
       hold if the resumed batch sequence (packing carry included) was
       exactly the uninterrupted one.
    """
    from pytorch_distributed_nn_tpu_torch.data.streaming import (
        StreamingLoader,
        export_text_corpus,
    )
    from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt

    checks: List[Check] = []
    shards = os.path.join(workdir, "shards")
    export_text_corpus(shards, shards=4, sequences=600, vocab_size=64,
                       min_len=8, max_len=48, seed=0)

    # -- 1: loader-level determinism + mid-epoch restore ------------------
    kw = dict(batch_size=8, seq_len=32, seed=0, device=device)
    a = StreamingLoader(shards, prefetch=0, **kw)
    b = StreamingLoader(shards, prefetch=3, workers=2, **kw)
    same = True
    for _ in range(10):
        same = same and _same_batch(a.next_batch(), b.next_batch())
    checks.append(Check(
        "batch sequence identical across workers counts (0 vs 2)", same,
        "10 batches, sync vs prefetch=3/workers=2",
    ))
    st = a.state()
    c = StreamingLoader(shards, prefetch=2, workers=1, **kw)
    c.restore(st)
    same = True
    for _ in range(6):
        same = same and _same_batch(a.next_batch(), c.next_batch())
    checks.append(Check(
        "restore at a mid-epoch step continues the exact stream", same,
        f"state: consumed={st['consumed']}, carry={len(st['carry'])} tokens",
    ))
    a.close(); b.close(); c.close()

    # -- 2: crash mid-epoch, resume, bitwise-identical run ----------------
    crash_at, total = 4, 6
    dir_a = os.path.join(workdir, "uninterrupted")
    dir_b = os.path.join(workdir, "crashed")
    run_kw = dict(max_steps=total, eval_freq=2, data_path=shards,
                  stream_prefetch=2, loader_workers=2)
    hist_a, state_a, _ = _run(_bert_cfg(dir_a, **run_kw), device)

    crashed = _launch(_bert_cfg(dir_b, faults=f"crash@{crash_at}", **run_kw),
                      device, capture=()).crashed
    checks.append(Check("crash fired mid-epoch", crashed,
                        f"InjectedCrash entering step {crash_at} "
                        f"(steps_per_epoch >> {total})"))
    emer = ckpt.checkpoint_path(dir_b, crash_at - 1)
    data_state = ckpt.load_data_state(emer)
    checks.append(Check(
        "emergency checkpoint carries the iterator-state sidecar",
        data_state is not None
        and data_state.get("consumed") == crash_at - 1,
        f"{ckpt.data_state_path(emer)}: consumed="
        f"{None if data_state is None else data_state.get('consumed')}",
    ))

    hist_b, state_b, start = _run(_bert_cfg(dir_b, resume=True, **run_kw),
                                  device)
    checks.append(Check("resumed from the emergency step",
                        start == crash_at - 1, f"start_step={start}"))
    loss_a = {r["step"]: r["loss"] for r in hist_a}
    loss_b = {r["step"]: r["loss"] for r in hist_b}
    checks.append(Check(
        "post-resume loss trajectory bitwise-matches the uninterrupted run",
        all(loss_a[s] == loss_b.get(s) for s in range(crash_at, total + 1)),
        f"steps {crash_at}..{total}: "
        f"{[(loss_a[s], loss_b.get(s)) for s in range(crash_at, total + 1)]}",
    ))
    eq = _trees_bitwise_equal(state_a, state_b)
    checks.append(Check(
        "crash+resume == uninterrupted (params+opt, bitwise)", eq.ok,
        eq.detail,
    ))
    return checks


# Elastic tolerance contract (docs/resilience.md#elastic-resume): after a
# geometry change the gradient all-reduce groups differently, so per-step
# losses drift by float-reduction order only. The gate leaves headroom.
ELASTIC_LOSS_RTOL = 1e-3


def _elastic_shards(workdir: str) -> str:
    """Shared streaming shard export for the elastic cases: the streaming
    loader's checkpointable iterator state is what makes the post-resume
    BATCH sequence identical to the uninterrupted run's, so the loss-curve
    comparison isolates the geometry change itself (the in-memory image
    loader reshuffles on restart — its resumed batches differ by design)."""
    shards = os.path.join(workdir, "shards")
    if not os.path.isdir(shards):
        from pytorch_distributed_nn_tpu_torch.data.datasets import (
            load_dataset,
        )
        from pytorch_distributed_nn_tpu_torch.data.streaming import (
            export_image_dataset,
        )

        ds = load_dataset("MNIST", train=True,
                          data_dir=os.path.join(workdir, "data"),
                          synthetic_size=64)
        export_image_dataset(ds, shards, shards=4)
    return shards


def _elastic_crash_resume(
    workdir: str, device: str, tag: str, old_workers: int, new_devices: int,
    resume_workers, checks: List[Check],
) -> None:
    """Shared shrink/regrow machinery: run a baseline on ``old_workers``
    ranks, crash a twin run, resume it on ``new_devices`` ranks, and
    assert the elastic contract — bitwise-equal restored state, preserved
    global batch, a typed ``elastic_resume`` event, and a post-resume loss
    curve matching the uninterrupted baseline within tolerance."""
    from pytorch_distributed_nn_tpu_torch.observability import reader

    crash_at, total = 4, 6
    dir_a = os.path.join(workdir, f"{tag}-uninterrupted")
    dir_b = os.path.join(workdir, f"{tag}-crashed")
    kw = dict(max_steps=total, eval_freq=2,
              data_path=_elastic_shards(workdir), stream_prefetch=2)

    hist_a, _, _ = _run(_lenet_cfg(dir_a, num_workers=old_workers, **kw),
                        device, world=old_workers)

    crash = _launch(_lenet_cfg(dir_b, num_workers=old_workers,
                               faults=f"crash@{crash_at}", **kw),
                    device, world=old_workers)
    checks.append(Check(
        f"[{tag}] crash fired on the {old_workers}-device mesh",
        crash.crashed, f"InjectedCrash entering step {crash_at}",
    ))

    resumed = _launch(
        _lenet_cfg(dir_b, num_workers=resume_workers, resume=True, **kw),
        device, world=new_devices, capture=("initial",))
    plan = resumed.plan
    checks.append(Check(
        f"[{tag}] geometry change detected ({old_workers}->"
        f"{new_devices} devices)",
        plan is not None and plan["changed"]
        and resumed.n_workers == new_devices,
        "no plan engaged" if plan is None else plan["describe"],
    ))
    checks.append(Check(
        f"[{tag}] resumed from the emergency step",
        resumed.start_step == crash_at - 1,
        f"start_step={resumed.start_step}",
    ))
    checks.append(Check(
        f"[{tag}] global batch preserved across the transition",
        resumed.batch_size == 32
        and resumed.batch_size % resumed.n_workers == 0,
        f"batch {resumed.batch_size} over {resumed.n_workers} workers "
        f"(per-device {resumed.batch_size // resumed.n_workers})",
    ))
    eq = _trees_bitwise_equal(crash.states["final"],
                              resumed.states["initial"])
    checks.append(Check(
        f"[{tag}] reshard-on-load is bitwise-lossless (params+opt)",
        eq.ok, eq.detail,
    ))
    hist_b = resumed.history
    loss_a = {r["step"]: r["loss"] for r in hist_a}
    loss_b = {r["step"]: r["loss"] for r in hist_b}
    post = range(crash_at, total + 1)
    rel = [
        abs(loss_b.get(s, float("inf")) - loss_a[s])
        / max(abs(loss_a[s]), 1e-12)
        for s in post
    ]
    checks.append(Check(
        f"[{tag}] post-resume loss curve within tolerance "
        f"(rtol {ELASTIC_LOSS_RTOL})",
        all(r <= ELASTIC_LOSS_RTOL for r in rel),
        f"max rel diff {max(rel):.2e} over steps {crash_at}..{total}",
    ))
    rs = reader.read_stream(dir_b)
    ev = [e for e in rs.events if e.get("type") == "elastic_resume"]
    checks.append(Check(
        f"[{tag}] typed elastic_resume event with old/new geometry",
        len(ev) == 1
        and (ev[0].get("old") or {}).get("devices") == old_workers
        and (ev[0].get("new") or {}).get("devices") == new_devices,
        f"events: {[(e.get('old'), e.get('new')) for e in ev]}",
    ))


#: the toy sharded state of the ``corrupt`` case: BertTiny (tp=2) at the
#: suite's text widths, no dropout
_TOY_KW = dict(vocab_size=64, max_len=32, dropout_rate=0.0)


def _toy_state(mesh, seed: int, device: str):
    """A tp/sp train state on ``mesh`` whose weights are drawn from
    ``seed`` and whose step is ``seed``: the JAX case's ``toy(mesh,
    scale)``."""
    import torch

    from pytorch_distributed_nn_tpu_torch.models import build_model
    from pytorch_distributed_nn_tpu_torch.optim import (
        build_optimizer,
        make_schedule,
    )
    from pytorch_distributed_nn_tpu_torch.training import spmd

    full = build_model("BertTiny", **_TOY_KW, dtype="float32")
    full.init_weights(torch.Generator().manual_seed(seed))
    local = build_model("BertTiny", **_TOY_KW, dtype="float32", mesh=mesh)
    sched = make_schedule(1e-2)
    state = spmd.create_spmd_state(
        spmd.shard_model(full, local, mesh),
        lambda p: build_optimizer("adam", p, sched), mesh, device)
    state.step = seed
    return state


def _toy_group(device: str):
    from pytorch_distributed_nn_tpu_torch.parallel.mesh import init_group
    from pytorch_distributed_nn_tpu_torch.utils.device import resolve_device

    group, dev = init_group(resolve_device(device))
    return group, str(dev)


def _corrupt_save_rank(directory: str, device: str):
    """8 ranks, mesh dp=4 tp=2: the toy states of steps 2 and 4 saved as
    sharded directories."""
    from pytorch_distributed_nn_tpu_torch.parallel.mesh import (
        axis_sizes,
        make_mesh,
    )
    from pytorch_distributed_nn_tpu_torch.resilience import elastic
    from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt

    group, dev = _toy_group(device)
    mesh = make_mesh(group, 4, 2, 1)
    geometry = elastic.rank_geometry(group.size(), axis_sizes(mesh))
    paths = [ckpt.save_sharded(directory, _toy_state(mesh, s, dev), step=s,
                               geometry=geometry) for s in (2, 4)]
    return {"paths": paths}, {}


def _corrupt_restore_rank(directory: str, device: str):
    """4 ranks, mesh dp=2 tp=2 (the shrunk fleet): restore the corrupt
    step 4 (the CRC must convict it), then the resume scan (rank 0 scans
    and quarantines, the others restore the step it found, as the
    trainer's resume does), and the restored regions against the step-2
    toy state's."""
    import torch

    from pytorch_distributed_nn_tpu_torch.parallel.mesh import (
        all_reduce,
        make_mesh,
    )
    from pytorch_distributed_nn_tpu_torch.resilience.supervisor import (
        resume_latest_valid,
    )
    from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt

    group, dev = _toy_group(device)
    mesh = make_mesh(group, 2, 2, 1)
    template = _toy_state(mesh, 0, dev)
    convicted = False
    try:
        ckpt.restore_resharded(ckpt.checkpoint_path(directory, 4), template)
    except ValueError as e:
        convicted = "CRC32" in str(e)
    # every rank has read step 4 before rank 0 may quarantine it
    all_reduce(torch.zeros(1, device=dev), "sum", group)
    found = 0
    if group.rank() == 0:
        restored = resume_latest_valid(
            directory, template,
            restore_fn=lambda p, t: ckpt.restore_resharded(p, t))
        found = 0 if restored is None else int(template.step) + 1
    flag = torch.tensor([found], dtype=torch.int64, device=dev)
    found = int(all_reduce(flag, "sum", group).item())
    if group.rank() != 0 and found:
        ckpt.restore_resharded(ckpt.checkpoint_path(directory, found - 1),
                               template)
    eq = Check("bitwise equality", False, "nothing restored")
    if found:
        want = _toy_state(mesh, 2, dev)
        eq = _trees_bitwise_equal(_flatten(ckpt.state_tree(want)),
                                  _flatten(ckpt.state_tree(template)))
    return {"convicted": convicted,
            "step": found - 1 if found else None,
            "equal": eq.ok, "detail": eq.detail}, {}


def scenario_elastic_resume(
    workdir: str, device: str, cases=("shrink", "regrow", "corrupt")
) -> List[Check]:
    """Elastic training (docs/resilience.md#elastic-resume): resume across
    a DIFFERENT number of ranks.

    - ``shrink``  — crash on 8 data-parallel ranks, resume on 4: the
      elastic plan re-derives dp=4 (global batch preserved, per-rank
      batch doubled), the restored params+opt are BITWISE equal to the
      crashed run's state, the post-resume loss curve matches the
      uninterrupted 8-rank run within the documented tolerance, and a
      typed ``elastic_resume`` event records old/new geometry.
    - ``regrow``  — the same contract growing a 2-rank run onto 4.
    - ``corrupt`` — a sharded checkpoint with one corrupt shard file is
      convicted by its per-shard CRC32 during elastic resume, quarantined,
      and the scan falls back to the previous valid step — resharding a
      dp=4 tp=2 checkpoint of 8 ranks onto a dp=2 tp=2 mesh of 4 on the
      way.
    """
    from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt

    checks: List[Check] = []
    if "shrink" in cases:
        _elastic_crash_resume(workdir, device, "shrink", old_workers=8,
                              new_devices=4, resume_workers=8,
                              checks=checks)
    if "regrow" in cases:
        # resume_workers=None: use every rank the regrown fleet offers
        _elastic_crash_resume(workdir, device, "regrow", old_workers=2,
                              new_devices=4, resume_workers=None,
                              checks=checks)
    if "corrupt" in cases:
        d = os.path.join(workdir, "corrupt")
        ranks = os.path.join(workdir, "corrupt.ranks")
        path4 = _spawn_ranks("corrupt_save", 8, device,
                             os.path.join(ranks, "save"),
                             {"directory": d})[0]["paths"][1]
        # flip bytes inside step 4's shard file: bitrot the per-shard
        # CRC32 must convict
        shard = next(
            os.path.join(path4, f) for f in sorted(os.listdir(path4))
            if f.startswith("shards_p")
        )
        with open(shard, "r+b") as f:
            f.seek(256)
            f.write(b"\xff" * 64)

        got = _spawn_ranks("corrupt_restore", 4, device,
                           os.path.join(ranks, "restore"),
                           {"directory": d})
        checks.append(Check(
            "[corrupt] per-shard CRC convicts mid-reshard",
            all(r["convicted"] for r in got),
            "restore_resharded raised the CRC32 mismatch",
        ))
        step = got[0]["step"]
        checks.append(Check(
            "[corrupt] elastic resume falls back to the previous valid "
            "step",
            step == 2,
            f"restored step={step}",
        ))
        qdir = os.path.join(d, ckpt.QUARANTINE_DIR)
        quarantined = sorted(os.listdir(qdir)) if os.path.isdir(qdir) else []
        checks.append(Check(
            "[corrupt] corrupt step quarantined",
            "model_step_4" in quarantined,
            f"quarantine/: {quarantined}",
        ))
        if step is not None:
            checks.append(Check(
                "[corrupt] fallback restore resharded bitwise onto the "
                "shrunk mesh", all(r["equal"] for r in got),
                "; ".join(sorted({r["detail"] for r in got})),
            ))
    return checks


def scenario_slo_burn(workdir: str, device: str) -> List[Check]:
    """Serving SLO engine + request tracing under a real burn
    (docs/observability.md "SLOs & error budgets"):

    two live serving runs under open-loop loadgen traffic against the
    same artifact — one with a 60 ms injected engine slowdown (a
    ``slow_infer@1:0.06s`` FaultPlan entry through the serving fault
    injector — every request blows the 25 ms p99 objective), one
    healthy twin. The burn run must produce a span-carrying,
    version-stamped ``serving.jsonl``,
    a failing ``obs slo check`` (exit 1, spec read from the stream
    manifest), exactly ONE ``slo_breach`` incident bundle (the breach is
    edge-triggered and the recorder's cooldown mutes the sustained
    burn), and an ``infer``-dominant slowest-requests attribution; the
    healthy twin passes the same check with zero bundles, and
    ``obs compare --by-version`` convicts the burn per artifact version.
    """
    from pytorch_distributed_nn_tpu_torch.observability import (
        flightrec,
        reader,
        tracing,
    )
    from pytorch_distributed_nn_tpu_torch.observability.detect import (
        DetectorSpec,
    )
    from pytorch_distributed_nn_tpu_torch.observability.flightrec import (
        FlightRecorder,
    )
    from pytorch_distributed_nn_tpu_torch.observability.obs_cli import (
        main_obs,
    )
    from pytorch_distributed_nn_tpu_torch.observability.slo import SLOEngine
    from pytorch_distributed_nn_tpu_torch.serving.batcher import Batcher
    from pytorch_distributed_nn_tpu_torch.serving.engine import (
        InferenceEngine,
    )
    from pytorch_distributed_nn_tpu_torch.serving.loadgen import (
        make_tiny_artifact,
        run_load,
        sample_inputs,
        serving_telemetry,
    )

    spec = "lat_p99<25ms@5s"
    artifact = make_tiny_artifact(os.path.join(workdir, "root"))

    def serve(name: str, slowdown: float):
        d = os.path.join(workdir, name)
        os.makedirs(d, exist_ok=True)
        engine = InferenceEngine(artifact, batch_buckets=(1, 2, 4, 8),
                                 device=device)
        engine.warmup()
        telemetry = serving_telemetry(d, engine, extra={"slo": spec})
        if slowdown:
            # the injected fault rides the FaultPlan serving grammar
            # (resilience/faults.py): every request's batch serves
            # `slowdown` slower, attributed to the infer span exactly
            # where a real device regression would land
            from pytorch_distributed_nn_tpu_torch.resilience.faults import (
                FaultPlan,
            )
            from pytorch_distributed_nn_tpu_torch.serving.faultinject import (
                ServingFaultInjector,
            )

            injector = ServingFaultInjector(
                FaultPlan.parse(f"slow_infer@1:{slowdown:g}s:x1000000"),
                telemetry=telemetry,
            )
            injector.attach_engine(engine)
        slo_engine = SLOEngine(spec, telemetry=telemetry, min_events=20)
        recorder = FlightRecorder(d, telemetry,
                                  DetectorSpec.parse("slo_breach"))
        batcher = Batcher(engine, telemetry=telemetry,
                          on_batch=recorder.tick)
        try:
            result = run_load(batcher, sample_inputs(engine, 64),
                              offered_rps=100.0, duration_s=4.0,
                              timeout_s=5.0)
        finally:
            batcher.close()
            recorder.close()
            slo_engine.close()
            telemetry.close()
        return d, result

    burn_dir, burn_res = serve("burn", 0.06)
    healthy_dir, healthy_res = serve("healthy", 0.0)

    checks = [Check(
        "both runs served the offered load",
        burn_res["served"] > 100 and healthy_res["served"] > 100
        and healthy_res["dropped"] == 0,
        f"burn={burn_res['served']} healthy={healthy_res['served']} "
        f"(healthy dropped {healthy_res['dropped']})",
    )]

    rs = reader.read_stream(burn_dir)
    span_ok = rs.steps and all(
        rec.get("request_id")
        and set(rec.get("spans") or {}) >= set(tracing.SPANS)
        and rec.get("version")
        for rec in rs.steps
    )
    checks.append(Check(
        "burn stream is span-carrying and version-stamped (schema v2)",
        bool(span_ok)
        and (rs.manifest or {}).get("artifact_identity") is not None,
        f"records={len(rs.steps)}",
    ))

    checks.append(Check(
        "obs slo check fails the burn run (spec from the manifest)",
        main_obs(["slo", "check", burn_dir]) == 1,
        "expected exit 1",
    ))
    checks.append(Check(
        "obs slo check passes the healthy twin",
        main_obs(["slo", "check", healthy_dir]) == 0,
        "expected exit 0",
    ))

    breaches = [e for e in rs.events if e.get("type") == "slo_breach"]
    checks.append(Check(
        "sustained burn emits exactly one edge-triggered slo_breach",
        len(breaches) == 1 and breaches[0].get("slo") == spec,
        f"breach events: {len(breaches)}",
    ))
    incidents = flightrec.list_incidents(burn_dir)
    checks.append(Check(
        "exactly one slo_breach incident bundle captured",
        len(incidents) == 1 and incidents[0].get("kind") == "slo_breach",
        f"bundles: {[(e['name'], e.get('kind')) for e in incidents]}",
    ))
    if incidents:
        inc = incidents[0]
        checks.append(Check(
            "bundle carries the ring + manifest + report",
            inc.get("events", 0) > 0
            and os.path.isfile(os.path.join(inc["path"], "manifest.json"))
            and inc["has_report"],
            f"incident={inc['name']} events={inc.get('events')}",
        ))
    checks.append(Check(
        "healthy twin: zero breaches, zero bundles",
        not flightrec.list_incidents(healthy_dir)
        and not any(
            e.get("type") == "slo_breach"
            for e in reader.read_stream(healthy_dir).events
        ),
    ))

    summary = reader.summarize_run(rs)
    spans = (summary.get("serving") or {}).get("spans") or {}
    healthy_spans = (
        reader.summarize_run(reader.read_stream(healthy_dir))
        .get("serving") or {}
    ).get("spans") or {}
    checks.append(Check(
        "span attribution pins the injected slowdown on infer",
        (spans.get("infer") or {}).get("p50", 0) >= 55.0
        and (healthy_spans.get("infer") or {}).get("p50", 1e9) < 25.0,
        f"burn infer p50={(spans.get('infer') or {}).get('p50')} ms, "
        f"healthy={(healthy_spans.get('infer') or {}).get('p50')} ms",
    ))
    slowest = (summary.get("serving") or {}).get("slowest") or []
    checks.append(Check(
        "slowest-requests table attributes queue-or-infer dominance",
        bool(slowest)
        and all(row.get("dominant") in ("queue", "infer")
                for row in slowest),
        f"slowest={[(r.get('request_id'), r.get('dominant')) for r in slowest]}",
    ))
    if slowest:
        checks.append(Check(
            "obs trace renders the slowest request's waterfall",
            main_obs(["trace", burn_dir,
                      str(slowest[0]["request_id"])]) == 0,
            "cli obs trace",
        ))

    checks.append(Check(
        "obs compare --by-version convicts the burn per artifact",
        main_obs(["compare", healthy_dir, burn_dir, "--by-version"]) == 1
        and main_obs(["compare", healthy_dir, healthy_dir,
                      "--by-version"]) == 0,
        "per-version gate",
    ))
    return checks


class _Load:
    """Open-loop generator running until stopped: fixed arrival
    schedule, per-request futures collected for the drop/served audit
    (run_load is fixed-duration; swaps need open-ended)."""

    def __init__(self, router, inputs, rps: float):
        import threading

        self.router, self.inputs, self.rps = router, inputs, rps
        self.reqs: list = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        t0, submitted = time.monotonic(), 0
        while not self._stop.is_set():
            due = int((time.monotonic() - t0) * self.rps) + 1
            while submitted < due:
                self.reqs.append(self.router.submit(
                    self.inputs[submitted % len(self.inputs)],
                    timeout_s=10.0,
                ))
                submitted += 1
            time.sleep(0.002)

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=10.0)
        deadline = time.monotonic() + 15.0
        for r in self.reqs:
            r.done.wait(timeout=max(0.0, deadline - time.monotonic()))
        served = sum(
            1 for r in self.reqs if r.done.is_set() and r.error is None
        )
        failed = sum(1 for r in self.reqs if r.error is not None)
        return served, failed


def scenario_live_reload(workdir: str, device: str,
                         cases=None) -> List[Check]:
    """Live-reload serving fleet (docs/serving.md "Deployment
    lifecycle"): registry → hot-swap → canary → auto-rollback, zero
    downtime. Two cases (``--cases swap,canary``):

    - ``swap``: a training run (LeNet on 2 ranks) checkpoints every step;
      each step is exported, published into the registry under the
      ``stable`` label, and picked up by the registry watch while an
      open-loop load generator hammers the live router — ≥10 weight
      hot-swaps under sustained traffic with ZERO dropped requests, ZERO
      retraces, every record stamped with the version that actually
      served it, and every transition visible in ``obs summary``.
    - ``canary``: a good artifact published under the ``canary`` label
      ramps through the schedule and AUTO-PROMOTES (stable label moves
      atomically); then an injected-bad artifact (NaN weights + a 60 ms
      shadow slowdown) is canaried, convicted by the per-version
      percentile gate (the ``obs compare --by-version`` rows), and
      AUTO-ROLLED-BACK with exactly one typed ``rollback`` event, the
      ``stable`` label restored, and all post-rollback traffic back on
      the stable version.
    """
    from pytorch_distributed_nn_tpu_torch.observability import reader
    from pytorch_distributed_nn_tpu_torch.observability.obs_cli import (
        main_obs,
    )
    from pytorch_distributed_nn_tpu_torch.serving.artifact import (
        export_artifact,
    )
    from pytorch_distributed_nn_tpu_torch.serving.batcher import Batcher
    from pytorch_distributed_nn_tpu_torch.serving.engine import (
        InferenceEngine,
    )
    from pytorch_distributed_nn_tpu_torch.serving.loadgen import (
        make_tiny_artifact,
        sample_inputs,
        serving_telemetry,
    )
    from pytorch_distributed_nn_tpu_torch.serving.registry import Registry
    from pytorch_distributed_nn_tpu_torch.serving.router import (
        CanaryPolicy,
        CanaryRouter,
        RegistryWatcher,
    )

    cases = tuple(cases) if cases else ("swap", "canary")
    unknown = set(cases) - {"swap", "canary"}
    if unknown:
        return [Check(f"unknown live_reload case(s) {sorted(unknown)}",
                      False, "have: swap, canary")]
    checks: List[Check] = []

    if "swap" in cases:
        # the training run whose checkpoints feed the swap pipeline: a
        # checkpoint every step, exactly like a publisher following a
        # live run
        td = os.path.join(workdir, "swap", "train_dir")
        steps = 12
        _run(_lenet_cfg(td, max_steps=steps, num_workers=2, batch_size=16,
                        eval_freq=1, data_layout="host"), device)
        from pytorch_distributed_nn_tpu_torch.training import (
            checkpoint as ckpt,
        )

        have = ckpt.all_steps(td)
        checks.append(Check(
            "training published a checkpoint per step",
            len(have) >= steps, f"steps on disk: {have}",
        ))

        reg = Registry(os.path.join(workdir, "swap", "registry"))

        def publish(step: int, labels=("stable",)) -> dict:
            out = os.path.join(workdir, "swap", "artifacts", f"s{step}")
            export_artifact(td, out, step=step, network="LeNet",
                            num_classes=10)
            return reg.publish(out, labels=labels)

        first = publish(have[0])
        engine = InferenceEngine(first["artifact"],
                                 batch_buckets=(1, 2, 4, 8), device=device)
        engine.warmup()
        serve_dir = os.path.join(workdir, "swap", "serve")
        os.makedirs(serve_dir)
        telemetry = serving_telemetry(serve_dir, engine)
        batcher = Batcher(engine, telemetry=telemetry)
        router = CanaryRouter(batcher, telemetry=telemetry, registry=reg)
        watcher = RegistryWatcher(reg, router, poll_s=0.1)
        load = _Load(router, sample_inputs(engine, 64), rps=250.0)
        swapped_to = []
        try:
            time.sleep(0.5)  # traffic on v1 before the first swap
            for step in have[1:steps]:
                entry = publish(step)
                action = watcher.poll_once()
                deadline = time.monotonic() + 5.0
                while (router.state()["stable"]["version"]
                       != entry["version"]
                       and time.monotonic() < deadline):
                    time.sleep(0.01)
                swapped_to.append((entry["version"], action))
                time.sleep(0.25)  # traffic ON each version
        finally:
            served, failed = load.stop()
        router.close()
        batcher.close()
        telemetry.close()

        checks.append(Check(
            "watch-driven hot swaps: 10+ under live traffic",
            engine.swaps >= 10
            and all(a == f"swap {v}" for v, a in swapped_to),
            f"swaps={engine.swaps}, actions={swapped_to}",
        ))
        checks.append(Check(
            "zero dropped/failed requests across every swap",
            failed == 0 and router.dropped == 0 and served == len(load.reqs)
            and served > 500,
            f"served={served} failed={failed} "
            f"router.dropped={router.dropped}",
        ))
        retr = engine.retraces()
        checks.append(Check(
            "zero jit retraces across every swap", retr == 0,
            f"retraces={retr}",
        ))
        rs = reader.read_stream(serve_dir)
        versions = {r.get("version") for r in rs.steps}
        checks.append(Check(
            "every record stamped with the version that served it",
            None not in versions and len(versions) >= 11,
            f"{len(versions)} version(s)",
        ))
        summary = reader.summarize_run(rs)
        dep = summary.get("deployment") or []
        checks.append(Check(
            "all swap transitions visible in obs summary",
            sum(1 for d in dep if d["type"] == "swap") == engine.swaps
            and summary["events"].get("swap") == engine.swaps
            and main_obs(["summary", serve_dir]) == 0,
            f"deployment={[(d['type'], d['version']) for d in dep]}",
        ))
        checks.append(Check(
            "registry stable label tracks the newest publish",
            reg.labels().get("stable") == swapped_to[-1][0]
            if swapped_to else False,
            f"labels={reg.labels()}",
        ))

    if "canary" in cases:
        root = os.path.join(workdir, "canary")
        stable_art = make_tiny_artifact(
            os.path.join(root, "a1"), seed=0, step=1)
        good_art = make_tiny_artifact(
            os.path.join(root, "a2"), seed=1, step=2)
        bad_art = make_tiny_artifact(
            os.path.join(root, "abad"), seed=2, step=66, poison_nan=True)
        reg = Registry(os.path.join(root, "registry"))
        reg.publish(stable_art, labels=("stable",))
        reg.publish(good_art)
        reg.publish(bad_art)

        engine = InferenceEngine(stable_art, batch_buckets=(1, 2, 4, 8),
                                 device=device)
        engine.warmup()
        serve_dir = os.path.join(root, "serve")
        os.makedirs(serve_dir)
        telemetry = serving_telemetry(serve_dir, engine)
        batcher = Batcher(engine, telemetry=telemetry)

        def shadow_factory(artifact_dir):
            """The injected fault: the BAD artifact's shadow engine is
            also 60 ms slower per batch (slo_burn's slowdown, attributed
            to infer) so the latency-percentile gate convicts it the
            way a real device regression would."""
            sh = engine.shadow(artifact_dir)
            if artifact_dir == bad_art:
                orig = sh.infer

                def slow_infer(xs):
                    outs, stats = orig(xs)
                    time.sleep(0.06)
                    return outs, dict(
                        stats, infer_ms=stats["infer_ms"] + 60.0)

                sh.infer = slow_infer
            return sh

        policy = CanaryPolicy(ramp=(30.0, 60.0), stage_requests=40,
                              threshold=0.5, window=120, min_samples=25)
        router = CanaryRouter(batcher, telemetry=telemetry, registry=reg,
                              policy=policy,
                              shadow_factory=shadow_factory,
                              decide_every_s=0.01)
        watcher = RegistryWatcher(reg, router, poll_s=0.1)
        load = _Load(router, sample_inputs(engine, 64), rps=250.0)
        try:
            time.sleep(0.5)  # stable-only baseline window
            reg.label("canary", "train_dir@2:none")
            watcher.poll_once()
            deadline = time.monotonic() + 12.0
            while (router.promotes == 0 and router.rollbacks == 0
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            promoted_version = engine.version
            good_ok = (router.promotes == 1 and router.rollbacks == 0
                       and promoted_version == "train_dir@2:none")
            time.sleep(0.3)  # post-promote traffic on the new stable

            reg.label("canary", "train_dir@66:none")
            watcher.poll_once()
            deadline = time.monotonic() + 12.0
            while router.rollbacks == 0 and time.monotonic() < deadline:
                time.sleep(0.05)
            rolled = router.last_rollback
            time.sleep(0.5)  # post-rollback traffic, all stable
        finally:
            served, failed = load.stop()
        router.close()
        batcher.close()
        telemetry.close()

        checks.append(Check(
            "good canary ramps and AUTO-PROMOTES to stable",
            good_ok and reg.labels().get("stable") == "train_dir@2:none",
            f"promotes={router.promotes} rollbacks={router.rollbacks} "
            f"serving={promoted_version} labels={reg.labels()}",
        ))
        checks.append(Check(
            "bad canary convicted by the per-version percentile gate",
            rolled is not None
            and rolled["version"] == "train_dir@66:none"
            and any("serve lat" in r for r in rolled["reasons"]),
            f"last_rollback={rolled}",
        ))
        checks.append(Check(
            "quality gate also names the non-finite outputs",
            rolled is not None
            and any("non-finite" in r for r in rolled["reasons"]),
            f"reasons={rolled['reasons'] if rolled else None}",
        ))
        rs = reader.read_stream(serve_dir)
        rollbacks = [e for e in rs.events if e.get("type") == "rollback"]
        checks.append(Check(
            "exactly one edge-triggered typed rollback event",
            len(rollbacks) == 1
            and rollbacks[0].get("version") == "train_dir@66:none"
            and rollbacks[0].get("stable") == "train_dir@2:none",
            f"rollback events: {len(rollbacks)}",
        ))
        checks.append(Check(
            "stable label restored atomically, canary cleared",
            reg.labels() == {"stable": "train_dir@2:none"},
            f"labels={reg.labels()}",
        ))
        # post-rollback routing must be 100% stable. Requests ADMITTED
        # before the rollback may still complete on the canary (they
        # drain, never drop — that is the zero-downtime contract), so
        # the invariant keys on admit time (record time - latency), not
        # completion time.
        t_rb = rollbacks[0]["time"] if rollbacks else 0
        after = [
            r for r in rs.steps
            if r.get("time", 0) - float(r.get("latency_ms", 0)) / 1000.0
            > t_rb + 0.05
        ]
        checks.append(Check(
            "every request admitted after rollback routes to stable",
            bool(after) and all(
                r.get("version") == "train_dir@2:none" for r in after
            ),
            f"{len(after)} record(s) admitted after rollback, versions "
            f"{ {r.get('version') for r in after} }",
        ))
        checks.append(Check(
            "zero dropped/failed requests through promote AND rollback",
            failed == 0 and router.dropped == 0,
            f"served={served} failed={failed} "
            f"dropped={router.dropped}",
        ))
        retr = engine.retraces()
        checks.append(Check(
            "zero retraces across canary shadows, promote and rollback",
            retr == 0, f"retraces={retr}",
        ))
        summary = reader.summarize_run(rs)
        dep = [d["type"] for d in summary.get("deployment") or []]
        checks.append(Check(
            "full lifecycle visible in obs summary "
            "(canary/promote/canary/rollback)",
            dep == ["canary", "canary", "promote", "canary", "rollback"]
            or dep == ["canary", "promote", "canary", "rollback"],
            f"deployment={dep}",
        ))
    return checks


def scenario_generate(workdir: str, device: str) -> List[Check]:
    """Generative serving under load with one mid-stream hot-swap
    (docs/serving.md "Generative serving"): mixed-length prompts over
    the KV-cache continuous-batching scheduler, a weight swap landing
    while sequences are mid-generation. Invariants: zero dropped
    requests, zero retraces across prefill+decode families, every
    request's tokens stamped with the version that ACTUALLY produced
    them (requests in flight at the swap are fenced and re-prefilled —
    deterministic sampling makes their output single-version by
    construction), KV pages of the outgoing engine provably not reused
    (ledger fence violations == 0, all live pages on the new epoch),
    and greedy generation bitwise-matching a full-recompute loop.
    """
    import threading

    import torch

    from pytorch_distributed_nn_tpu_torch.models import build_model
    from pytorch_distributed_nn_tpu_torch.models.convert import (
        flax_to_state_dict,
    )
    from pytorch_distributed_nn_tpu_torch.observability import reader
    from pytorch_distributed_nn_tpu_torch.serving.artifact import (
        load_artifact,
    )
    from pytorch_distributed_nn_tpu_torch.serving.generate import (
        GenerateScheduler,
        GenerativeEngine,
    )
    from pytorch_distributed_nn_tpu_torch.serving.loadgen import (
        make_tiny_decoder_artifact,
        sample_prompts,
        serving_telemetry,
    )

    art1 = make_tiny_decoder_artifact(os.path.join(workdir, "a1"),
                                      seed=0, step=1)
    art2 = make_tiny_decoder_artifact(os.path.join(workdir, "a2"),
                                      seed=1, step=2)
    engine = GenerativeEngine(art1, batch_buckets=(1, 2, 4),
                              seq_buckets=(32, 64), pool_slots=8,
                              device=device)
    engine.warmup()
    v1, v2 = engine.version, None
    serve_dir = os.path.join(workdir, "serve")
    os.makedirs(serve_dir)
    telemetry = serving_telemetry(serve_dir, engine,
                                  extra={"generative": True})
    sched = GenerateScheduler(engine, telemetry=telemetry)
    prompts = sample_prompts(engine, 48, reserve=14)

    reqs: list = []
    stop = threading.Event()

    def _load():
        t0, submitted = time.monotonic(), 0
        while not stop.is_set():
            due = int((time.monotonic() - t0) * 120.0) + 1
            while submitted < due:
                reqs.append(sched.submit(
                    prompts[submitted % len(prompts)],
                    max_new_tokens=10, timeout_s=20.0,
                ))
                submitted += 1
            time.sleep(0.002)

    loader = threading.Thread(target=_load, daemon=True)
    loader.start()
    time.sleep(0.6)  # traffic on v1, sequences mid-generation
    v2 = sched.swap(art2)
    swap_mono = time.monotonic()
    time.sleep(0.6)  # traffic on v2
    stop.set()
    loader.join(timeout=10.0)
    deadline = time.monotonic() + 30.0
    for r in reqs:
        r.done.wait(timeout=max(0.0, deadline - time.monotonic()))
    sched.close()
    telemetry.close()

    served = sum(1 for r in reqs if r.done.is_set() and r.error is None)
    failed = sum(1 for r in reqs if r.error is not None)
    checks = [Check(
        "zero dropped/failed requests across the mid-stream swap",
        failed == 0 and sched.dropped == 0 and served == len(reqs)
        and served > 50,
        f"served={served}/{len(reqs)} failed={failed} "
        f"dropped={sched.dropped}",
    )]
    retr = engine.retraces()
    checks.append(Check(
        "zero jit retraces across prefill+decode families and the swap",
        retr == 0, f"retraces={retr}",
    ))
    checks.append(Check(
        "in-flight sequences were fenced and re-prefilled",
        sched.refenced_total >= 1 and engine.swaps == 1,
        f"refenced={sched.refenced_total} swaps={engine.swaps}",
    ))
    stale = {
        s: p.stale_slots(engine.epoch) for s, p in engine.pools.items()
    }
    checks.append(Check(
        "old engine's KV pages provably not reused (ledger fence: 0 "
        "violations, no live page on the old epoch)",
        engine.fence_violations == 0
        and all(not v for v in stale.values()),
        f"fence_violations={engine.fence_violations} stale={stale}",
    ))
    # per-request version honesty: the version stamp is the weights the
    # FINAL emitted tokens came from; a request that generated entirely
    # after the swap must be stamped v2
    versions = {r.version for r in reqs}
    checks.append(Check(
        "both artifact versions served, every request stamped",
        versions == {v1, v2},
        f"versions={versions}",
    ))
    post = [r for r in reqs if r.enqueued > swap_mono + 0.05]
    checks.append(Check(
        "every request admitted after the swap is stamped with the "
        "new version",
        bool(post) and all(r.version == v2 for r in post),
        f"{len(post)} post-swap request(s), versions "
        f"{ {r.version for r in post} }",
    ))
    refenced = [r for r in reqs if r.refences]
    checks.append(Check(
        "re-prefilled (fence-crossing) requests emit new-version tokens "
        "only",
        all(r.version == v2 for r in refenced),
        f"{len(refenced)} refenced request(s)",
    ))
    rs = reader.read_stream(serve_dir)
    checks.append(Check(
        "stream: one span-carrying, version-stamped record per request",
        len(rs.steps) == served and all(
            rec.get("request_id")
            and set(rec.get("spans") or {}) >= {
                "admit", "queue", "prefill", "decode", "respond"}
            and rec.get("version") in (v1, v2)
            and rec.get("new_tokens") == 10
            for rec in rs.steps
        ),
        f"records={len(rs.steps)}",
    ))
    summary = reader.summarize_run(rs)
    gen = (summary.get("serving") or {}).get("generate") or {}
    dep = summary.get("deployment") or []
    checks.append(Check(
        "obs summary: generation block + the swap transition",
        gen.get("tokens", 0) == served * 10
        and any(d["type"] == "swap" and d.get("version") == v2
                for d in dep),
        f"generate={ {k: gen.get(k) for k in ('tokens', 'requests')} } "
        f"deployment={[(d['type'], d.get('version')) for d in dep]}",
    ))
    # decode-vs-recompute ground truth on the LIVE engine: greedy
    # generation through the KV cache must match a token-by-token full
    # recompute by the model's own forward on the loaded artifact
    # bitwise (the test suite pins logits; chaos pins the end-to-end
    # token stream on the post-swap weights)
    prompt = prompts[0][:12]
    sched2 = GenerateScheduler(engine, telemetry=None, start=True)
    got = sched2.submit(prompt, max_new_tokens=6,
                        timeout_s=30.0).wait(60.0)
    sched2.close()
    manifest, params, _ = load_artifact(art2)
    model = build_model(manifest["network"], manifest.get("num_classes", 0),
                        **manifest.get("model_kw", {}))
    model.load_state_dict(flax_to_state_dict(params))
    model = model.to(engine.device).eval()
    seq = [int(t) for t in prompt]
    with torch.no_grad():
        for _ in range(6):
            pad = np.zeros((1, 64), np.int64)
            pad[0, :len(seq)] = seq
            fmask = (np.arange(64)[None, :] < len(seq)).astype(np.int64)
            logits = model(torch.from_numpy(pad).to(engine.device),
                           mask=torch.from_numpy(fmask).to(engine.device))
            seq.append(int(logits[0, len(seq) - 1].argmax()))
    checks.append(Check(
        "KV-cache generation matches full-recompute greedy decode",
        got == seq[len(prompt):],
        f"kv={got} recompute={seq[len(prompt):]}",
    ))
    return checks


def scenario_smoke(workdir: str, device: str) -> List[Check]:
    """Fast composite for a CI gate: one tiny run exercises the
    non-finite guard, the torn-checkpoint manifest, quarantine, and
    validated resume (LeNet on 2 ranks)."""
    from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt

    d = os.path.join(workdir, "smoke")
    history, state, _ = _run(_lenet_cfg(
        d, max_steps=3, num_workers=2, batch_size=16, eval_freq=1,
        faults="nan_grad@2,torn_ckpt@3", skip_nonfinite=True,
        data_layout="host",
    ), device)
    by_step = _by_step(history)
    checks = [Check(
        "nan step skipped",
        by_step.get(2, {}).get("skipped_nonfinite") == 1.0
        and by_step.get(1, {}).get("skipped_nonfinite") == 0.0,
        f"skipped flags: { {s: r.get('skipped_nonfinite') for s, r in by_step.items()} }",
    ), _params_finite(state)]
    ok, reason = ckpt.verify_checkpoint(ckpt.checkpoint_path(d, 3))
    checks.append(Check("torn checkpoint convicted", not ok, reason))
    start = _launch(_lenet_cfg(d, max_steps=3, num_workers=2, batch_size=16,
                               resume=True, data_layout="host"),
                    device, train=False, capture=()).start_step
    checks.append(Check(
        "validated resume skips the torn step", start == 2,
        f"start_step={start}",
    ))
    qdir = os.path.join(d, ckpt.QUARANTINE_DIR)
    checks.append(Check(
        "torn checkpoint quarantined",
        os.path.isdir(qdir) and "model_step_3" in os.listdir(qdir),
        f"quarantine/: {sorted(os.listdir(qdir)) if os.path.isdir(qdir) else []}",
    ))
    return checks


def scenario_sweep_resume(workdir: str, device: str) -> List[Check]:
    """A 12-trial concurrency-3 sweep killed mid-flight resumes: only the
    remaining trials run, completed results stay byte-identical, and the
    in-flight trial continues from its last valid checkpoint
    (experiments/, docs/experiments.md "Resume contract").

    Reference sweep (A) runs uninterrupted in-process; candidate sweep (B)
    runs as a real ``cli sweep run`` subprocess, is SIGTERMed once >= 3
    trials completed and >= 1 in-flight trial has published its step-3
    checkpoint, then continues via ``cli sweep resume``. Every trial
    carries a ``delay@5:1.5s`` fault so a trial is reliably catchable
    between its mid-trial checkpoint and its finish (LeNet steps are
    milliseconds; without the delay the kill window would be luck).
    Every trial trains on ``device``.
    """
    from pytorch_distributed_nn_tpu_torch.data.datasets import load_dataset
    from pytorch_distributed_nn_tpu_torch.data.streaming import (
        export_image_dataset,
    )
    from pytorch_distributed_nn_tpu_torch.experiments import (
        RunnerConfig,
        SweepRunner,
        SweepSpec,
        load_journal,
        trial_dir,
    )
    from pytorch_distributed_nn_tpu_torch.observability import reader
    from pytorch_distributed_nn_tpu_torch.training.config import TrainConfig

    spec_text = "lr=0.1,0.05,0.01,0.005;batch_size=16,24,32"  # 12 trials
    steps, ck, conc = 6, 3, 3
    faults = "delay@5:1.5s"
    # trials read the STREAMING loader (docs/data.md): its checkpointed
    # iterator state is what makes an interrupted trial's resume bitwise
    # (the in-memory image loaders replay their epoch on restart —
    # chaos data_resume owns that contract)
    shard_dir = os.path.join(workdir, "shards")
    export_image_dataset(
        load_dataset("MNIST", train=True, data_dir=workdir,
                     synthetic_size=64),
        shard_dir, shards=2,
    )
    base = TrainConfig(
        network="LeNet", dataset="MNIST", batch_size=32,
        test_batch_size=32, num_workers=1, synthetic_size=64,
        data_path=shard_dir, faults=faults, seed=0,
    )
    checks: List[Check] = []

    def rows_key(result_rows):
        # the deterministic identity of a leaderboard: per-trial rank,
        # step count and BITWISE loss (timing columns excluded)
        return [(r["trial"], r["steps"], r["loss"]) for r in result_rows]

    # --- A: the uninterrupted reference sweep ---------------------------
    a_dir = os.path.join(workdir, "a")
    spec = SweepSpec.parse(spec_text, sweep_seed=0)
    result_a = SweepRunner(
        spec, base,
        RunnerConfig(sweep_dir=a_dir, max_steps=steps, ckpt_every=ck,
                     concurrency=conc, scheduler="grid", retries=1,
                     device=device),
    ).run()
    checks.append(Check(
        "reference sweep: 12/12 trials completed",
        len(result_a["leaderboard"]) == 12 and not result_a["failed"],
        f"failed={result_a['failed']}",
    ))

    # --- B: the same sweep as a CLI subprocess, killed mid-flight -------
    b_dir = os.path.join(workdir, "b")
    cmd_common = [
        sys.executable, "-m", "pytorch_distributed_nn_tpu_torch", "sweep",
    ]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_package_root()]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.Popen(
        cmd_common + [
            "run", "--sweep-dir", b_dir, "--spec", spec_text,
            "--steps", str(steps), "--ckpt-every", str(ck),
            "--concurrency", str(conc), "--scheduler", "grid",
            "--network", "LeNet", "--dataset", "MNIST",
            "--batch-size", "32", "--test-batch-size", "32",
            "--num-workers", "1", "--synthetic-size", "64",
            "--data-path", shard_dir, "--faults", faults,
            "--device", device,
        ],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, env=env,
    )

    def kill_window_open():
        j = load_journal(b_dir)
        if j is None:
            return False
        done = sum(1 for s in j.trials.values()
                   if s.status == "completed")
        mid_trial = any(
            s.in_flight and os.path.exists(
                os.path.join(trial_dir(b_dir, idx), f"model_step_{ck}")
            )
            for idx, s in j.trials.items()
        )
        return done >= 3 and mid_trial

    deadline = time.monotonic() + 180
    killed_mid_flight = False
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            break  # finished before we caught it (should not happen)
        if kill_window_open():
            proc.send_signal(signal.SIGTERM)
            killed_mid_flight = True
            break
        time.sleep(0.25)
    try:
        rc_kill = proc.wait(timeout=120)
    except subprocess.TimeoutExpired:  # pragma: no cover - hang guard
        proc.kill()
        rc_kill = proc.wait()
    checks.append(Check(
        "sweep killed mid-flight (completed + in-flight + queued mix)",
        killed_mid_flight and rc_kill == 3,
        f"killed={killed_mid_flight} rc={rc_kill}",
    ))
    j_kill = load_journal(b_dir)
    pre_completed = {
        idx: float(s.rungs[0]["loss"])
        for idx, s in (j_kill.trials if j_kill else {}).items()
        if s.status == "completed" and 0 in s.rungs
    }
    pre_inflight = sorted(
        idx for idx, s in (j_kill.trials if j_kill else {}).items()
        if s.in_flight
    )
    # the invariant's subject: in-flight trials that had PUBLISHED a
    # checkpoint when the kill landed (one is guaranteed by the kill
    # window; a sibling killed during startup has nothing to resume from
    # and legitimately restarts)
    pre_inflight_ckpt = [
        idx for idx in pre_inflight
        if os.path.exists(
            os.path.join(trial_dir(b_dir, idx), f"model_step_{ck}")
        )
    ]
    checks.append(Check(
        "journal survives the kill (manifest-first, torn tail at worst)",
        j_kill is not None and len(pre_completed) >= 3
        and len(pre_inflight_ckpt) >= 1,
        f"completed={sorted(pre_completed)} inflight={pre_inflight} "
        f"with-ckpt={pre_inflight_ckpt}",
    ))

    # --- resume: only the remaining trials run --------------------------
    out = subprocess.run(
        cmd_common + ["resume", "--sweep-dir", b_dir, "--json",
                      "--device", device],
        capture_output=True, text=True, timeout=600, env=env,
    )
    checks.append(Check(
        "cli sweep resume finishes the sweep (rc 0)",
        out.returncode == 0, f"rc={out.returncode} err={out.stderr[-200:]}",
    ))
    result_b = json.loads(out.stdout) if out.returncode == 0 else {}
    j_b = load_journal(b_dir)
    rerun = [
        idx for idx in sorted(pre_completed)
        if j_b is not None and j_b.trials[idx].starts != 1
    ]
    checks.append(Check(
        "completed trials were not re-run on resume",
        j_b is not None and not rerun, f"re-run: {rerun}",
    ))
    a_by_trial = {r["trial"]: r for r in result_a["leaderboard"]}
    mismatched = [
        idx for idx, loss in pre_completed.items()
        if a_by_trial[idx]["loss"] != loss
    ]
    checks.append(Check(
        "pre-kill completed results byte-identical to the reference",
        not mismatched, f"losses differ for trials {mismatched}",
    ))
    checks.append(Check(
        "final leaderboard identical to an uninterrupted run",
        bool(result_b) and rows_key(result_b.get("leaderboard", []))
        == rows_key(result_a["leaderboard"]),
        "rank/steps/loss triples diverge",
    ))
    resumed_from = {}
    for idx in pre_inflight_ckpt:
        rs = reader.read_stream(trial_dir(b_dir, idx))
        start = int((rs.manifests[-1].get("start_step") or 0)
                    if rs.manifests else 0)
        resumed_from[idx] = (len(rs.manifests), start)
    checks.append(Check(
        "in-flight trial resumed from its last valid checkpoint",
        all(n >= 2 and start > 0 for n, start in resumed_from.values()),
        f"(manifests, start_step) by trial: {resumed_from}",
    ))
    return checks


def scenario_fleet_preempt(workdir: str, device: str,
                           cases=None) -> List[Check]:
    """Fleet scheduler under host preemption (experiments/fleet/,
    docs/experiments.md "Fleet"): an agent SIGKILLed mid-rung — the
    whole process group, the local model of losing the machine — has its
    in-flight trials migrated to surviving hosts and elastically
    resumed, with the journal/obs trail proving every transition.

    Two cases, splitting the acceptance criterion along what floating
    point can actually promise:

    - ``synthetic`` — 3 local agents, 12-trial ASHA sweep over the
      synthetic trial main (loss a pure function of (lr, seed, step), so
      migration is math-invariant BY CONSTRUCTION): one agent killed
      mid-rung, zero trials lost, zero retry budget spent, and the final
      ASHA leaderboard BYTE-identical to an uninterrupted single-host
      run — rank, steps and bitwise losses.
    - ``elastic`` — real LeNet trials on agents exposing DIFFERENT
      device counts (4/2/2). The victim's in-flight trial (checkpoint
      published) migrates to a 2-device host and resumes through the
      reshard-on-load path — typed ``elastic_resume`` event with old
      devices=4 -> new devices=2 in the trial's own stream — and the
      leaderboard matches the uninterrupted reference in rank with
      losses inside the documented elastic tolerance (params reshard
      bitwise at restore; the dp-degree change reorders the grad
      reduction, docs/resilience.md#elastic-resume).

    On the port a trial is one process per rank: on the CPU the elastic
    agents' trials are 4, 2 and 2 gloo rank processes, on the card 8
    cards (:data:`RANKS`), and the reference trains each trial on one
    rank of ``device``. The ``synthetic`` case's trials touch no device:
    its agents run on the CPU whatever ``device`` is.
    """
    import json
    import threading
    import time

    from pytorch_distributed_nn_tpu_torch.experiments import (
        RunnerConfig,
        SweepRunner,
        SweepSpec,
        load_journal,
        trial_dir,
    )
    from pytorch_distributed_nn_tpu_torch.experiments.fleet import (
        FleetConfig,
        FleetScheduler,
        LocalTransport,
    )
    from pytorch_distributed_nn_tpu_torch.experiments.runner import (
        synthetic_trial_main,
    )
    from pytorch_distributed_nn_tpu_torch.observability import reader
    from pytorch_distributed_nn_tpu_torch.observability.promexport import (
        validate_exposition,
    )

    cases = tuple(cases) if cases else ("synthetic", "elastic")
    bad = [c for c in cases if c not in ("synthetic", "elastic")]
    if bad:
        return [Check(f"unknown fleet_preempt case(s) {bad}", False,
                      "have: synthetic, elastic")]
    checks: List[Check] = []

    def run_fleet_with_kill(sdir, spec, base, fcfg, devices,
                            kill_ready, label):
        """Drive a FleetScheduler in a thread; SIGKILL agent0's process
        group once ``kill_ready(journal, victim)`` opens; return
        (result, killed, error)."""
        transport = LocalTransport(
            fleet_dir=os.path.join(sdir, "fleet"), agents=3,
            devices=devices, capacity=1, device=fcfg.device,
            lease=fcfg.lease, call_timeout=fcfg.call_timeout,
        )
        fs = FleetScheduler(spec, base, fcfg, transport=transport)
        result, err = {}, []

        def drive():
            try:
                result.update(fs.run())
            except Exception as e:
                err.append(e)

        thread = threading.Thread(target=drive, name=f"fleet-{label}")
        thread.start()
        victim = "agent0"
        killed = False
        deadline = time.monotonic() + 180
        while time.monotonic() < deadline and thread.is_alive():
            j = load_journal(sdir)
            if j is not None and kill_ready(j, victim):
                transport.kill_agent(victim)
                killed = True
                break
            time.sleep(0.1)
        thread.join(300)
        return fs, result, killed, err, victim

    def rows_key(rows):
        return [(r["trial"], r["steps"], r["loss"]) for r in rows]

    def inflight_with_stream(j, victim, sdir):
        for idx, st in j.trials.items():
            if not (st.in_flight and st.host == victim):
                continue
            tpath = os.path.join(
                trial_dir(sdir, idx), "telemetry.jsonl"
            )
            if os.path.isfile(tpath) and os.path.getsize(tpath) > 0:
                return True
        return False

    # --- synthetic: byte-identical ASHA leaderboard across a kill -------
    if "synthetic" in cases:
        lrs = ("0.4,0.2,0.1,0.05,0.025,0.0125,0.00625,"
               "0.3,0.15,0.075,0.0375,2.0")  # 12 trials, one divergent
        spec = SweepSpec.parse(f"lr={lrs}")
        base = {"network": "SynthNet", "lr": 0.1, "faults": None,
                "step_sleep": 0.3}
        ref = SweepRunner(
            spec, base,
            RunnerConfig(sweep_dir=os.path.join(workdir, "syn_ref"),
                         max_steps=9, concurrency=3, scheduler="asha",
                         eta=3, retries=1, retry_base_delay=0.01),
            trial_main=synthetic_trial_main,
        ).run()
        sdir = os.path.join(workdir, "syn_fleet")
        fs, result, killed, err, victim = run_fleet_with_kill(
            sdir, spec, base,
            FleetConfig(sweep_dir=sdir, max_steps=9, scheduler="asha",
                        eta=3, retries=1, retry_base_delay=0.01,
                        lease=1.5, call_timeout=0.5,
                        trial_main_name="synthetic", device="cpu"),
            devices=[1, 1, 1],
            kill_ready=lambda j, v: inflight_with_stream(j, v, sdir),
            label="synthetic",
        )
        checks.append(Check(
            "synthetic: agent SIGKILLed mid-rung, ASHA sweep completed, "
            "zero trials lost",
            killed and not err and result.get("failed") == [],
            f"killed={killed} err={err!r} failed={result.get('failed')}",
        ))
        j = load_journal(sdir)
        migrated = sorted(
            idx for idx, st in (j.trials if j else {}).items()
            if st.migrations
        )
        checks.append(Check(
            "synthetic: host_dead journaled, trials migrated with retry "
            "budget untouched",
            j is not None
            and j.hosts.get(victim, {}).get("state") == "dead"
            and len(migrated) >= 1
            and all((j.trials[i].last_end or {}).get("attempt") == 0
                    for i in migrated),
            f"migrated={migrated} hosts={j.hosts if j else None}",
        ))
        checks.append(Check(
            "synthetic: ASHA leaderboard BYTE-identical to the "
            "uninterrupted run",
            bool(result) and rows_key(result.get("leaderboard", []))
            == rows_key(ref["leaderboard"]),
            "rank/steps/loss triples diverge",
        ))
        summary = reader.summarize_run(reader.read_stream(sdir))
        fl = summary.get("fleet") or {}
        checks.append(Check(
            "synthetic: every transition visible in obs summary "
            "(fleet section) and the journal",
            fl.get("dead") == 1
            and len(fl.get("migrations") or []) >= 1
            and all(
                (fl.get("hosts") or {}).get(f"agent{k}", {}).get("trials")
                for k in range(3)
            ),
            f"{fl}",
        ))
        prom_path = os.path.join(sdir, "metrics.prom")
        try:
            with open(prom_path) as f:
                prom = f.read()
            perrs = validate_exposition(prom)
        except OSError as e:
            prom, perrs = "", [repr(e)]
        checks.append(Check(
            "synthetic: pdtn_fleet_* gauges published and valid",
            not perrs and 'pdtn_fleet_hosts{state="dead"} 1' in prom
            and "pdtn_fleet_trials_inflight" in prom,
            "; ".join(perrs[:3]),
        ))

    # --- elastic: real training migrates across device counts -----------
    if "elastic" in cases:
        from pytorch_distributed_nn_tpu_torch.data.datasets import load_dataset
        from pytorch_distributed_nn_tpu_torch.data.streaming import (
            export_image_dataset,
        )
        from pytorch_distributed_nn_tpu_torch.training.config import (
            TrainConfig,
        )

        # streaming input so a resumed trial's batch sequence continues
        # bitwise (the sweep_resume discipline); the only post-migration
        # divergence left is the dp-degree change itself
        shard_dir = os.path.join(workdir, "shards")
        export_image_dataset(
            load_dataset("MNIST", train=True, data_dir=workdir,
                         synthetic_size=64),
            shard_dir, shards=2,
        )
        steps, ck = 6, 3
        spec = SweepSpec.parse("lr=0.1,0.05,0.01")
        base = TrainConfig(
            network="LeNet", dataset="MNIST", batch_size=32,
            test_batch_size=32, num_workers=None, synthetic_size=64,
            data_path=shard_dir, faults="delay@5:1.5s", seed=0,
        )
        ref = SweepRunner(
            spec, base,
            RunnerConfig(sweep_dir=os.path.join(workdir, "el_ref"),
                         max_steps=steps, ckpt_every=ck, concurrency=3,
                         retries=1, device=device),
        ).run()

        def ckpt_published(j, victim):
            for idx, st in j.trials.items():
                if st.in_flight and st.host == victim and os.path.exists(
                    os.path.join(trial_dir(sdir, idx),
                                 f"model_step_{ck}")
                ):
                    return True
            return False

        sdir = os.path.join(workdir, "el_fleet")
        fs, result, killed, err, victim = run_fleet_with_kill(
            sdir, spec, base,
            FleetConfig(sweep_dir=sdir, max_steps=steps, ckpt_every=ck,
                        retries=1, retry_base_delay=0.01,
                        lease=2.0, call_timeout=0.5,
                        trial_main_name="default", device=device),
            devices=[4, 2, 2],
            kill_ready=ckpt_published,
            label="elastic",
        )
        checks.append(Check(
            "elastic: 4-device agent SIGKILLed with a checkpointed trial "
            "in flight; sweep completed, zero trials lost",
            killed and not err and result.get("failed") == []
            and all(r["steps"] == steps
                    for r in result.get("leaderboard", [])),
            f"killed={killed} err={err!r} failed={result.get('failed')}",
        ))
        j = load_journal(sdir)
        migrated = sorted(
            idx for idx, st in (j.trials if j else {}).items()
            if st.migrations
        )
        checks.append(Check(
            "elastic: host_dead + trial_migrate journaled; re-dispatch "
            "landed on a surviving host",
            j is not None
            and j.hosts.get(victim, {}).get("state") == "dead"
            and len(migrated) >= 1
            and all(j.trials[i].host != victim for i in migrated),
            f"migrated={migrated}",
        ))
        elastic_events = []
        for idx in migrated:
            rs = reader.read_stream(trial_dir(sdir, idx))
            elastic_events += [
                e for e in rs.events
                if e.get("type") == "elastic_resume"
            ]
        checks.append(Check(
            "elastic: migrated trial ELASTICALLY resumed on a different "
            "device count (typed elastic_resume, 4d -> 2d)",
            any(
                (e.get("old") or {}).get("devices") == 4
                and (e.get("new") or {}).get("devices") == 2
                for e in elastic_events
            ),
            f"elastic events: {json.dumps(elastic_events)[:300]}",
        ))
        a = {r["trial"]: r for r in ref["leaderboard"]}
        b = {r["trial"]: r
             for r in result.get("leaderboard", [])} if result else {}
        rank_same = (
            [r["trial"] for r in ref["leaderboard"]]
            == [r["trial"] for r in result.get("leaderboard", [])]
        )
        loss_close = bool(b) and all(
            a[i]["loss"] is not None and b[i]["loss"] is not None
            and abs(a[i]["loss"] - b[i]["loss"])
            <= 1e-3 * max(abs(a[i]["loss"]), 1e-9)
            for i in a
        )
        checks.append(Check(
            "elastic: leaderboard rank identical, losses within the "
            "elastic tolerance (<=1e-3 rtol)",
            rank_same and loss_close,
            f"rank_same={rank_same} a={[(i, a[i]['loss']) for i in sorted(a)]} "
            f"b={[(i, b[i]['loss']) for i in sorted(b)]}",
        ))
    return checks


class _HttpLoad:
    """``loadgen.run_http_load`` in a process of its own (this module's
    ``--http-load`` entry): the clients' 64 threads and their JSON
    encoding stay out of the interpreter that runs the frontend, as a
    real client's would. :meth:`result` waits for its dict;
    :meth:`stop` is its ``stop_early`` (SIGTERM)."""

    def __init__(self, workdir: str, host: str, port: int, rows,
                 **kw):
        job = tempfile.mkdtemp(prefix="http-load-", dir=workdir)
        self._out = os.path.join(job, "result.json")
        with open(os.path.join(job, "job.json"), "w") as f:
            json.dump({"host": host, "port": port, "rows": rows,
                       "kw": kw, "out": self._out}, f)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [_package_root()]
            + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        self.proc = subprocess.Popen(
            [sys.executable, "-m", __name__, "--http-load", job],
            env=env, stdout=subprocess.PIPE, text=True)
        self.proc.stdout.readline()  # "started": the schedule's t0

    def stop(self) -> None:
        self.proc.send_signal(signal.SIGTERM)

    def result(self, timeout: float = 180.0) -> dict:
        try:
            self.proc.wait(timeout=timeout)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
            self.proc.stdout.close()
        with open(self._out) as f:
            return json.load(f)


def _http_load_main(job_dir: str) -> int:
    """The :class:`_HttpLoad` process: one ``run_http_load`` with the
    job's arguments, SIGTERM its ``stop_early``; the dict to the job's
    ``out``."""
    import threading

    from pytorch_distributed_nn_tpu_torch.serving.loadgen import (
        run_http_load,
    )

    with open(os.path.join(job_dir, "job.json")) as f:
        job = json.load(f)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    print("started", flush=True)
    res = run_http_load(job["host"], job["port"], job["rows"],
                        stop_early=stop, **job["kw"])
    with open(job["out"] + ".tmp", "w") as f:
        json.dump(res, f)
    os.replace(job["out"] + ".tmp", job["out"])
    return 0


def scenario_replica_loss(workdir: str, device: str,
                          cases=None) -> List[Check]:
    """Serving availability layer (docs/serving.md "Availability &
    overload"): the replicated frontend survives replica loss and
    rolls replicas with zero client-visible failures. Two cases
    (``--cases kill,drain``); the 3 spawned replicas serve on
    ``device`` (on the card they share it, as ``serve frontend``'s
    do), and the HTTP clients run in a process of their own
    (:class:`_HttpLoad`: in the frontend's interpreter their 64
    threads held it under the 100 requests/s the kill case requires,
    of the 150 offered, on a CPU host and on an H100's):

    - ``kill`` — 3 spawned replicas under open-loop HTTP load; one is
      SIGKILLed (whole process group) mid-load. Every client request
      must still answer 200 (the in-flight tail to the dead replica is
      covered by retry/hedge), the dead replica's circuit breaker opens
      exactly ONCE (edge-triggered — request failures and the health
      loop's down-detection share the edge), the pool keeps serving on
      2 replicas, and a respawn rejoins via ``/readyz`` with a typed
      ``replica_up(rejoin)`` + ``breaker_close``.
    - ``drain`` — a rolling restart under load: each replica is
      drained (SIGTERM → admissions stop → in-flight batches finish →
      exit 0) and respawned one at a time. Zero failed requests, zero
      deadline drops across every replica lifetime, zero retraces on
      the restarted replicas, and the typed ``drain`` events show each
      replica's clean exit.
    """
    import http.client as _http

    from pytorch_distributed_nn_tpu_torch.observability import reader
    from pytorch_distributed_nn_tpu_torch.serving.frontend import (
        Frontend,
        frontend_telemetry,
    )
    from pytorch_distributed_nn_tpu_torch.serving.loadgen import (
        make_tiny_artifact,
    )

    all_cases = ("kill", "drain")
    cases = tuple(cases) if cases else all_cases
    checks: List[Check] = []
    unknown = sorted(set(cases) - set(all_cases))
    if unknown:
        return [Check(
            "replica_loss cases are valid", False,
            f"unknown case(s) {unknown}; have {list(all_cases)}",
        )]

    artifact = make_tiny_artifact(os.path.join(workdir, "root"))
    rng = np.random.RandomState(0)
    rows = [
        rng.rand(28, 28, 1).astype(np.float32).tolist() for _ in range(8)
    ]

    def launch(name: str):
        fe_dir = os.path.join(workdir, name)
        tel = frontend_telemetry(os.path.join(fe_dir, "serve"))
        fe = Frontend(
            fe_dir, telemetry=tel, timeout_s=5.0, max_inflight=128,
            retries=2, poll_s=0.1, lease_s=2.0,
            breaker_threshold=3, breaker_cooldown_s=1.0, device=device,
        )
        for i in range(3):
            fe.spawn_replica(f"r{i}", artifact,
                             serve_args=["--buckets", "1,2,4,8"],
                             env={"PYTHONPATH": os.pathsep.join(
                                 [_package_root()]
                                 + ([os.environ["PYTHONPATH"]]
                                    if os.environ.get("PYTHONPATH")
                                    else []))})
        fe.start()
        fe.wait_ready(timeout=180)
        return fe, tel, fe_dir

    def replica_stats(fe, name):
        r = fe._find(name)
        conn = _http.HTTPConnection(r.host, r.port, timeout=2.0)
        try:
            conn.request("GET", "/stats")
            return json.loads(conn.getresponse().read())
        finally:
            conn.close()

    def events_by_type(fe_dir):
        rs = reader.read_stream(os.path.join(fe_dir, "serve"))
        out: Dict[str, list] = {}
        for e in rs.events:
            out.setdefault(e.get("type", "?"), []).append(e)
        return rs, out

    # -- case: SIGKILL one of three under load -----------------------------
    if "kill" in cases:
        fe, tel, fe_dir = launch("kill")
        try:
            load = _HttpLoad(workdir, fe.host, fe.port, rows,
                             offered_rps=150.0, duration_s=5.0,
                             timeout_s=5.0, workers=64)
            time.sleep(1.2)  # load warm: every replica has traffic
            fe.kill_replica("r0")
            res = load.result()
            checks.append(Check(
                "kill: zero client-visible failures under open-loop load",
                res["failed"] == 0 and res["shed"] == 0
                and res["ok"] == res["submitted"] > 500,
                f"statuses={res['statuses']} ok={res['ok']}/"
                f"{res['submitted']}",
            ))
            checks.append(Check(
                "kill: the in-flight tail was covered by retry/hedge",
                fe.retried + fe.hedges > 0,
                f"retried={fe.retried} hedges={fe.hedges}",
            ))
            st = fe.state()
            checks.append(Check(
                "kill: pool kept serving on the 2 survivors",
                st["ready"] == 2 and res["sustained_rps"] > 100.0,
                f"ready={st['ready']} sustained={res['sustained_rps']}",
            ))
            fe.restart_replica("r0")
            checks.append(Check(
                "kill: killed replica rejoined via /readyz",
                fe.state()["ready"] == 3,
                f"state={fe.state()['replicas']}",
            ))
            rejoined = replica_stats(fe, "r0")
            checks.append(Check(
                "kill: rejoined replica is a fresh, ready process",
                rejoined.get("ready") is True
                and rejoined.get("served") == 0
                and rejoined.get("retraces") == 0,
                f"stats={rejoined}",
            ))
        finally:
            fe.close()
            tel.close()
        rs, ev = events_by_type(fe_dir)
        checks.append(Check(
            "kill: exactly one edge-triggered breaker_open",
            len(ev.get("breaker_open", [])) == 1
            and ev["breaker_open"][0].get("replica") == "r0",
            f"breaker_open={ev.get('breaker_open')}",
        ))
        checks.append(Check(
            "kill: one replica_down (process exit) + rejoin replica_up "
            "+ breaker_close",
            len(ev.get("replica_down", [])) == 1
            and "exited" in ev["replica_down"][0].get("reason", "")
            and any(e.get("rejoin") and e.get("replica") == "r0"
                    for e in ev.get("replica_up", []))
            and len(ev.get("breaker_close", [])) == 1,
            f"down={ev.get('replica_down')} "
            f"up={ev.get('replica_up')}",
        ))
        summary = reader.summarize_run(rs)
        sv = summary.get("serving") or {}
        checks.append(Check(
            "kill: frontend stream accounts every request "
            "(availability 1.0, zero shed)",
            sv.get("requests", 0) > 500 and sv.get("shed") == 0
            and sv.get("availability") == 1.0,
            f"serving={ {k: sv.get(k) for k in ('requests', 'shed', 'availability')} }",
        ))
        # trace completeness across SIGKILL (docs/observability.md
        # "Distributed tracing"): every answered request must assemble
        # into ONE cross-process waterfall — frontend hop spans joined
        # with the winning replica's record — with exactly one marked
        # winner and zero orphan spans; a hedged request shows both
        # competing branches. The killed replica's lost attempts appear
        # as failed/rerouted hops, never as missing winners.
        streams = reader.load_trace_streams(fe_dir)
        assembled = 0
        bad: Dict[str, int] = {
            "unresolved": 0, "no_frontend": 0, "orphans": 0,
            "no_winner": 0, "no_winner_record": 0, "hedged_single": 0,
        }
        for rec in rs.steps:
            rid = rec.get("request_id")
            if not rid or not isinstance(rec.get("hops"), list):
                continue
            try:
                asm = reader.assemble_trace(fe_dir, rid, streams=streams)
            except FileNotFoundError:
                bad["unresolved"] += 1
                continue
            assembled += 1
            if asm["frontend"] is None:
                bad["no_frontend"] += 1
            if asm["orphans"]:
                bad["orphans"] += 1
            won = [a for a in asm["attempts"] if a.get("outcome") == "won"]
            if len(won) != 1:
                bad["no_winner"] += 1
            elif won[0].get("replica_record") is None:
                bad["no_winner_record"] += 1
            if rec.get("hedged") and len(asm["attempts"]) < 2:
                bad["hedged_single"] += 1
        checks.append(Check(
            "kill: every answered request assembles end-to-end "
            "(one marked winner, winner record joined, zero orphans)",
            assembled > 500 and not any(bad.values()),
            f"assembled={assembled} bad={bad}",
        ))

    # -- case: rolling SIGTERM restart under load --------------------------
    if "drain" in cases:
        fe, tel, fe_dir = launch("drain")
        try:
            load = _HttpLoad(workdir, fe.host, fe.port, rows,
                             offered_rps=100.0, duration_s=60.0,
                             timeout_s=5.0, workers=64)
            time.sleep(1.0)
            restarted = fe.rolling_restart()
            time.sleep(0.5)  # a beat of post-restart traffic
            load.stop()
            res = load.result()
            checks.append(Check(
                "drain: rolling restart covered all 3 replicas",
                restarted == 3 and fe.state()["ready"] == 3,
                f"restarted={restarted} ready={fe.state()['ready']}",
            ))
            checks.append(Check(
                "drain: zero failed requests across the whole rolling "
                "restart",
                res["failed"] == 0 and res["shed"] == 0
                and res["ok"] == res["submitted"] > 100,
                f"statuses={res['statuses']}",
            ))
            post = [replica_stats(fe, f"r{i}") for i in range(3)]
            checks.append(Check(
                "drain: restarted replicas serve with zero retraces",
                all(p.get("retraces") == 0 for p in post),
                f"retraces={[p.get('retraces') for p in post]}",
            ))
        finally:
            fe.close()
            tel.close()
        rs, ev = events_by_type(fe_dir)
        drains = ev.get("drain", [])
        done = [e for e in drains if e.get("phase") == "done"]
        checks.append(Check(
            "drain: 3 drain starts, 3 clean exits (rc=0)",
            sum(1 for e in drains if e.get("phase") == "start") == 3
            and len(done) == 3 and all(e.get("clean") for e in done),
            f"drain={drains}",
        ))
        checks.append(Check(
            "drain: no breaker opened and nothing was declared down "
            "uncleanly",
            not ev.get("breaker_open")
            and not ev.get("replica_down"),
            f"breaker={ev.get('breaker_open')} "
            f"down={ev.get('replica_down')}",
        ))
        # zero deadline-drops across every replica LIFETIME: each
        # replica's own serving stream (pre- and post-restart manifests
        # append to one file) must carry no request_dropped at all
        dropped = {}
        for i in range(3):
            rdir = os.path.join(fe_dir, f"r{i}", "serve")
            rrs = reader.read_stream(rdir)
            dropped[f"r{i}"] = sum(
                1 for e in rrs.events
                if e.get("type") == "request_dropped"
            )
        checks.append(Check(
            "drain: zero deadline drops in every replica stream",
            all(v == 0 for v in dropped.values()),
            f"dropped={dropped}",
        ))
    return checks


SCENARIOS: Dict[str, Callable[..., List[Check]]] = {
    "smoke": scenario_smoke,
    "crash_resume": scenario_crash_resume,
    "preempt": scenario_preempt,
    "straggler": scenario_straggler,
    "torn_ckpt": scenario_torn_ckpt,
    "nan_grad": scenario_nan_grad,
    "async_ckpt": scenario_async_ckpt,
    "flightrec": scenario_flightrec,
    "slo_burn": scenario_slo_burn,
    "replica_loss": scenario_replica_loss,
    "live_reload": scenario_live_reload,
    "generate": scenario_generate,
    "data_resume": scenario_data_resume,
    "elastic_resume": scenario_elastic_resume,
    "sweep_resume": scenario_sweep_resume,
    "fleet_preempt": scenario_fleet_preempt,
}

#: the ranks each scenario trains on — on the card, the cards it needs —
#: per case where its cases differ. The replicas of ``replica_loss`` and
#: the trials of ``sweep_resume`` are processes of one rank each, on one
#: card; ``fleet_preempt``'s elastic agents own 4 + 2 + 2 cards, and its
#: synthetic trials touch none.
RANKS: Dict[str, object] = {
    "smoke": 2, "crash_resume": 2, "preempt": 4, "straggler": 4,
    "torn_ckpt": 4, "nan_grad": 4, "async_ckpt": 4, "flightrec": 4,
    "slo_burn": 1, "replica_loss": 1,
    "live_reload": {"swap": 2, "canary": 1},
    "generate": 1, "data_resume": 2,
    "elastic_resume": {"shrink": 8, "regrow": 4, "corrupt": 8},
    "sweep_resume": 1,
    "fleet_preempt": {"synthetic": 0, "elastic": 8},
}



def ranks_needed(name: str, cases=None) -> int:
    """The ranks scenario ``name`` trains on at most, over ``cases`` (all
    of its cases by default)."""
    need = RANKS[name]
    if isinstance(need, dict):
        picked = [need[c] for c in (cases or need) if c in need]
        return max(picked or [1])
    return int(need)


def describe_ranks(name: str) -> str:
    """``"2 cards"``, or one count per case: the ``list`` column."""
    need = RANKS[name]
    if isinstance(need, dict):
        return "cards: " + ", ".join(f"{c} {n}" for c, n in need.items())
    return f"{need} card" + ("s" if need != 1 else "")


def _cuda(device: str) -> bool:
    return device == "cuda" or device.startswith("cuda:")


def _one_thread() -> None:
    """On the CPU this process, and every rank, replica and trial it
    starts, runs torch on one intra-op thread: they share the host's
    cores, and a pool of one thread per core stalls at its parallel
    regions on a shared host (a LeNet batch of one took 20-60 ms instead
    of 1, past ``slo_burn``'s 25 ms objective for its healthy twin)."""
    import torch

    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)


def run_scenario(
    name: str, device: str, workdir=None, keep: bool = False, cases=None
) -> int:
    """Run one scenario on ``device`` ("cuda" for the card, "cpu"); prints
    a PASS/FAIL line per invariant.

    ``cases`` restricts a multi-case scenario to the named sub-cases.
    Returns a process exit code: 0 only when every invariant held, 1
    when any failed, 2 for an unknown scenario, and on the card for a
    scenario that needs more cards than there are (refused before
    anything trains or any agent starts).
    """
    if name not in SCENARIOS:
        print(f"unknown scenario {name!r}; have: {', '.join(SCENARIOS)}")
        return 2
    fn = SCENARIOS[name]
    kwargs = {}
    if cases is not None:
        import inspect

        if "cases" not in inspect.signature(fn).parameters:
            print(f"scenario {name!r} has no sub-cases (--cases ignored)")
            cases = None
        else:
            kwargs["cases"] = tuple(cases)
    if _cuda(device):
        import torch

        need, found = ranks_needed(name, cases), torch.cuda.device_count()
        if need > found:
            print(f"chaos {name}: needs {need} cards (one per rank), found "
                  f"{found}; refused before training")
            return 2
    from pytorch_distributed_nn_tpu_torch.utils.device import deterministic

    deterministic()
    if not _cuda(device):
        _one_thread()
    from pytorch_distributed_nn_tpu_torch.ops import kernels

    owned = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix=f"pdtn_chaos_{name}_")
    print(f"chaos scenario {name!r} on {device} (workdir: {workdir})")
    _RANK_LAUNCHES.clear()
    before = kernels.launch_counts()
    try:
        checks = fn(workdir, device, **kwargs)
    finally:
        if owned and not keep:
            import shutil

            shutil.rmtree(workdir, ignore_errors=True)
    launches = {k: v - before.get(k, 0) + _RANK_LAUNCHES.get(k, 0)
                for k, v in kernels.launch_counts().items()}
    failed = [c for c in checks if not c.ok]
    for c in checks:
        mark = "PASS" if c.ok else "FAIL"
        print(f"  [{mark}] {c.name}" + (f" — {c.detail}" if c.detail else ""))
    print(f"chaos {name}: kernel launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})} (this "
          "process and its rank processes)")
    print(
        f"chaos {name}: {len(checks) - len(failed)}/{len(checks)} "
        f"invariants held"
    )
    return 1 if failed else 0


#: what a rank process can run: ``fn(device=..., **kwargs) -> (record,
#: states)``
_RANK_JOBS: Dict[str, Callable] = {
    "train": _train_rank,
    "corrupt_save": _corrupt_save_rank,
    "corrupt_restore": _corrupt_restore_rank,
}


def _rank_main(out_dir: str) -> int:
    """One rank process of :func:`_spawn_ranks`: run the job of
    ``out_dir/job.json`` and write ``rank<r>.json`` (and rank 0's state
    trees)."""
    from pytorch_distributed_nn_tpu_torch.utils.device import deterministic

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s "
                               "%(message)s")
    rank = int(os.environ["RANK"])
    with open(os.path.join(out_dir, "job.json")) as f:
        job = json.load(f)
    deterministic()
    record, states = _RANK_JOBS[job["job"]](device=job["device"],
                                            **job["kwargs"])
    for key, flat in states.items():
        np.savez(os.path.join(out_dir, f"states_{key}.npz"), **flat)
    tmp = os.path.join(out_dir, f"rank{rank}.json.tmp")
    with open(tmp, "w") as f:
        json.dump(record, f)
    os.replace(tmp, os.path.join(out_dir, f"rank{rank}.json"))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-job"] and len(sys.argv) == 3:
        sys.exit(_rank_main(sys.argv[2]))
    if sys.argv[1:2] == ["--http-load"] and len(sys.argv) == 3:
        sys.exit(_http_load_main(sys.argv[2]))
    sys.exit("usage: python -m pytorch_distributed_nn_tpu_torch.resilience"
             ".chaos --rank-job DIR | --http-load DIR (a rank or the HTTP "
             "clients of a chaos scenario; run scenarios with the "
             "package's chaos command)")
