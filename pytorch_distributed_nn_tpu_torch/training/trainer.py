"""Training: the port of ``pytorch_distributed_nn_tpu/training/trainer.py``
for two paths.

- Image models (the CNN zoo on MNIST/CIFAR/SVHN): data-parallel over a
  process group (:mod:`..parallel.mesh`; one rank per process, the
  torchrun world or one rank), with the JAX package's gradient sync
  (``sync_mode`` allreduce/ps/local, ``num_aggregate``, ``kill_ranks``,
  ``compression`` none/int8: the int8 quantize kernel on the card),
  ``bn_stats_sync`` and ``grad_accum``. Data: real files under
  ``data_dir`` or the synthetic set; ``data_layout`` ``device`` keeps the
  uint8 set on the card and builds batches there, ``host`` prepares them
  on a thread, ``auto`` is device when the two splits take under 2 GiB.
- Text models (the transformer family, dataset ``MLMSynth``): MLM
  training on one device (``attn_impl="pallas"`` -> the hand-written
  flash kernel, ``"full"`` -> plain attention in PyTorch; ``fused_ln`` is
  accepted: the port's one LayerNorm is the kernel). Their gradient sync
  over several ranks is not ported yet.

``Trainer(config)`` validates the config as the JAX trainer does, for the
subset the port runs, and builds the model, the optimizer with its
schedule and the loaders. ``train()`` runs ``max_steps`` steps (or
``epochs`` epochs) and returns one record per step: step, loss, acc1,
acc5, step_ms and ``images_per_sec`` or ``tokens_per_sec`` (and
``skipped_nonfinite`` with ``skip_nonfinite``); ``evaluate()`` scores the
test split (images) or the fixed eval set (text).

Checkpoints, resume and supervision, as the JAX trainer runs them:

- ``eval_freq = N`` writes ``<train_dir>/model_step_<k>`` every N steps
  in the JAX package's FILE format (:mod:`.checkpoint`), through the
  background writer (:mod:`.async_ckpt`; ``async_ckpt=False`` writes
  inline). ``keep_last`` deletes older verified steps after each publish;
  ``overlap_eval`` runs the eval pass on each checkpoint's device
  snapshot on a thread and its own stream (``eval_result`` events with
  ``source="overlap"``). Rank 0 writes.
- ``resume`` restores the newest checkpoint that verifies, whichever
  package wrote it (corrupt newer ones are quarantined), the MLM batch
  stream from its ``.data.json`` sidecar (the image loaders restart, as
  in the JAX package), and numbers the steps on from there. Dropout is
  re-seeded from (seed, rank, step) at each step, so a resumed run draws
  what an uninterrupted one draws. Resume is elastic
  (:mod:`..resilience.elastic`): before the gradient sync is built, the
  checkpoint's recorded geometry is held against the world size of this
  launch; a changed one keeps the global batch (the per-rank batch and
  ``grad_accum`` rescale) and emits ``elastic_resume``, and under
  ``strict_geometry`` raises, naming both geometries.
- ``supervise``: SIGTERM/SIGINT stop the run at the next step boundary
  with an emergency checkpoint of the completed step and a ``preempt``
  event (the process exits 0); ``heartbeat.json`` is beaten every step,
  and ``heartbeat_grace`` adds the stall watchdog. The in-flight async
  save is drained first, and at the end of every run.
- ``skip_nonfinite``: the train step's guard (:mod:`.train_step`).
- ``faults`` (:class:`..resilience.faults.FaultPlan`): ``delay``,
  ``crash`` and ``preempt`` fire entering their step (``delay@N:pK``
  sleeps rank K only, an entry without a rank every rank; a crash writes
  the emergency checkpoint and re-raises, a preempt takes the SIGTERM
  path), ``nan_grad`` poisons the step's host batch before its copy to
  the card (``data_layout="host"``; image models only), ``flaky_io`` and
  ``torn_ckpt`` fire in the checkpoint writer.
- ``profile_steps = N``: a ``torch.profiler`` trace of steps 2 to N + 1
  of the run (rank 0) into ``profile_dir`` (default
  ``<train_dir>/profile``), stopped also when the run ends inside it;
  read it with ``python -m pytorch_distributed_nn_tpu_torch.
  observability.xplane``.
- ``flightrec`` (:mod:`..observability.flightrec`, rank 0): detectors on
  the run's stream open incident bundles under ``<train_dir>/incidents``
  with a ``torch.profiler`` trace of the steps after the trigger (none
  while a ``profile_steps`` window is open: two sessions cannot nest);
  the supervisor's stall watchdog reports to it directly.

The run's telemetry stream (``metrics_path``, else
``<train_dir>/telemetry.jsonl`` when the run checkpoints or is
supervised) starts with its ``manifest``; steps are ``kind: "step"``
records and ``checkpoint_write``, ``checkpoint_gc``, ``eval_result``,
``preempt``, ``nonfinite_skip``, ``fault_injected``, ``retry``,
``incident`` and ``elastic_resume`` are events with the JAX package's
field names.

Every flag the port cannot honour yet raises, naming the ROADMAP item
that ports it (:data:`UNSUPPORTED`, :data:`TEXT_UNSUPPORTED`); none is
silently ignored: the sharded and streaming paths (items 1 and 3) and
the rest of the gradient sync (item 2, with ``straggler_deadline``). The
trainer runs on the card unless ``device="cpu"`` is given; without a card
it raises, it never falls back to the CPU.

Weights are initialised from ``seed`` with a ``torch.Generator``: the
flax initialisation's scheme, not its numbers (JAX's PRNG differs).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import threading
import time
from typing import Dict, List, Optional

import torch

from pytorch_distributed_nn_tpu_torch.data.datasets import load_dataset
from pytorch_distributed_nn_tpu_torch.data.loader import (
    DataLoader,
    DeviceDataLoader,
)
from pytorch_distributed_nn_tpu_torch.data.text import MLMBatches, MLMLoader
from pytorch_distributed_nn_tpu_torch.models import (
    build_model,
    input_spec,
    is_text_model,
)
from pytorch_distributed_nn_tpu_torch.observability import core as obs
from pytorch_distributed_nn_tpu_torch.observability.detect import DetectorSpec
from pytorch_distributed_nn_tpu_torch.observability.flightrec import (
    FlightRecorder,
)
from pytorch_distributed_nn_tpu_torch.ops import kernels
from pytorch_distributed_nn_tpu_torch.optim import (
    build_optimizer,
    make_schedule,
)
from pytorch_distributed_nn_tpu_torch.parallel.grad_sync import (
    make_grad_sync,
)
from pytorch_distributed_nn_tpu_torch.parallel.mesh import (
    all_reduce,
    env_ranks,
    init_group,
)
from pytorch_distributed_nn_tpu_torch.resilience import elastic
from pytorch_distributed_nn_tpu_torch.resilience.faults import (
    FaultPlan,
    InjectedCrash,
)
from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt
from pytorch_distributed_nn_tpu_torch.training.config import TrainConfig
from pytorch_distributed_nn_tpu_torch.training.train_step import (
    TrainState,
    build_eval_step,
    build_image_eval_step,
    build_image_train_step,
    build_train_step,
    create_train_state,
    param_count,
    run_eval_pass,
    sync_seed,
)
from pytorch_distributed_nn_tpu_torch.utils import profiling
from pytorch_distributed_nn_tpu_torch.utils.device import resolve_device
from pytorch_distributed_nn_tpu_torch.utils.timing import (
    MetricsLogger,
    PhaseTimer,
)

logger = logging.getLogger(__name__)

_SYNC = "ROADMAP Queue 1 item 2 (gradient sync over torch.distributed)"
_SPMD = "ROADMAP Queue 1 item 1 (dp x tp x sp training)"
_DATA = "ROADMAP Queue 1 item 3 (data)"

#: config field -> (the values the port runs, the ROADMAP item that ports
#: the rest); any other value raises
UNSUPPORTED = {
    "bucket_bytes": ((None,), _SYNC),
    "straggler_deadline": ((None,), _SYNC),
    "tensor_parallel": ((1,), _SPMD),
    "seq_parallel": ((1,), _SPMD),
    "remat": ((False,), _SPMD),
    "warm_start": ((None,), _SPMD),
    "data_path": ((None,), _DATA),
    "loader_workers": ((0,), _DATA),
}

#: what the text models' single-device MLM step does not run yet: their
#: gradient sync over several ranks (the image path runs all of these)
TEXT_UNSUPPORTED = {
    "num_workers": ((None, 1), _SYNC),
    "num_aggregate": ((None,), _SYNC),
    "kill_ranks": (((),), _SYNC),
    "compression": (("none",), _SYNC),
    "sync_mode": (("allreduce", "local"), _SYNC),
}


def _check_unsupported(c: TrainConfig, table: dict) -> None:
    for field, (allowed, item) in table.items():
        value = getattr(c, field)
        if value not in allowed:
            raise NotImplementedError(
                f"{field}={value!r} is not ported yet: {item}")


def validate(c: TrainConfig) -> None:
    """Raise on what the port's trainer does not run (yet), and on what
    the JAX trainer refuses."""
    _check_unsupported(c, UNSUPPORTED)
    text = is_text_model(c.network)
    if text:
        _check_unsupported(c, TEXT_UNSUPPORTED)
        if c.dataset != "MLMSynth":
            raise ValueError(f"text model {c.network!r} requires "
                             f"dataset='MLMSynth' (got {c.dataset!r})")
        if c.attn_impl not in ("full", "pallas"):
            raise ValueError(f"unknown attn_impl {c.attn_impl!r}")
    else:
        if c.dataset == "MLMSynth":
            raise ValueError("dataset='MLMSynth' requires a text model (got "
                             f"{c.network!r})")
        for field in ("fused_ln", "remat"):
            if getattr(c, field):
                raise ValueError(f"{field} only applies to text models "
                                 f"(got network={c.network!r})")
        if c.attn_impl != "full":
            raise ValueError(f"attn_impl={c.attn_impl!r} only applies to "
                             f"text models (got network={c.network!r})")
        if c.compression == "topk":
            raise NotImplementedError(
                f"compression='topk' is not ported yet: {_SYNC}")
        if c.data_layout not in ("auto", "device", "host"):
            raise ValueError(f"unknown data_layout {c.data_layout!r}")
    if c.dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown dtype {c.dtype!r}")
    if c.grad_accum < 1 or c.batch_size % c.grad_accum:
        raise ValueError(f"global batch {c.batch_size} not divisible by "
                         f"grad_accum={c.grad_accum} microbatches")
    if c.warmup_steps < 0:
        raise ValueError(f"warmup_steps must be >= 0, got {c.warmup_steps}")
    if c.eval_freq < 0:
        raise ValueError(f"eval_freq must be >= 0, got {c.eval_freq}")
    if c.keep_last is not None and c.keep_last < 1:
        raise ValueError(f"keep_last must be >= 1, got {c.keep_last}")
    if c.overlap_eval and not (c.async_ckpt and c.eval_freq):
        raise ValueError(
            "overlap_eval runs the eval pass on the async checkpoint "
            "snapshot; it requires async_ckpt=True and eval_freq > 0")


def build_train_model(c: TrainConfig) -> torch.nn.Module:
    """A fresh model of ``c``'s network and model flags, its weights drawn
    from ``c.seed`` (on the CPU)."""
    if is_text_model(c.network):
        model_kw = {"dtype": c.dtype}
        if c.vocab_size is not None:
            model_kw["vocab_size"] = c.vocab_size
        if c.seq_len is not None:
            model_kw["max_len"] = c.seq_len
        if c.fused_ln:
            model_kw["fused_ln"] = True
        if c.attn_impl == "pallas":
            model_kw["attn_fn"] = kernels.flash_attention
        model = build_model(c.network, **model_kw)
    else:
        num_classes = 100 if c.dataset == "Cifar100" else 10
        model = build_model(c.network, num_classes, dtype=c.dtype)
    model.init_weights(torch.Generator().manual_seed(c.seed))
    return model


class Trainer:
    """``Trainer(config, device=None, group=None)``: ``group`` is the
    process group of the image path's ranks (default: the torchrun world,
    :func:`..parallel.mesh.init_group`); the tests pass gloo groups of
    ranks that run as threads."""

    def __init__(self, config: TrainConfig, device=None, group=None):
        c = self.config = config
        validate(c)
        # a bad --flightrec or --faults spec fails before any model is
        # built
        self._flightrec_spec = (DetectorSpec.parse(c.flightrec)
                                if c.flightrec else None)
        self.fault_plan = (FaultPlan.parse(c.faults, seed=c.seed)
                           if c.faults else None)
        self.device = resolve_device(device)
        self.is_text = is_text_model(c.network)
        if self.is_text and self.fault_plan is not None and any(
                e.kind == "nan_grad" for e in self.fault_plan.entries):
            raise ValueError(
                "nan_grad faults poison the float image batch; text "
                "batches are integer token ids (no NaN representation)")
        self._elastic_plan = None
        if c.resume:
            self._plan_elastic(group)
        schedule = make_schedule(c.lr, c.warmup_steps, c.lr_decay_steps,
                                 c.lr_decay_factor)

        def build_opt(params):
            return build_optimizer(
                c.optimizer, params, schedule, momentum=c.momentum,
                weight_decay=c.weight_decay, nesterov=c.nesterov)

        if self.is_text:
            self._init_text(build_opt)
        else:
            self._init_image(build_opt, group)
        if c.overlap_eval and self.n_workers > 1:
            raise NotImplementedError(
                "overlap_eval over several ranks (an eval pass on a thread "
                f"beside the training collectives) is not ported yet: {_SYNC}")
        self._check_fault_plan()
        self._geometry = elastic.rank_geometry(self.n_workers)
        self.start_step = 0
        if c.resume:
            self._resume()
        self._init_telemetry()
        if self._elastic_plan is not None:
            self.telemetry.emit("elastic_resume", step=self.start_step,
                                **self._elastic_plan.event_fields())
        # after the telemetry install, so that the detectors see every
        # record of the run; rank 0 only (bundles live in train_dir)
        self._flightrec = None
        if self._flightrec_spec is not None and self.rank == 0:
            self._flightrec = FlightRecorder(c.train_dir, self.telemetry,
                                             self._flightrec_spec)
            logger.info("Flight recorder armed: %s",
                        self._flightrec_spec.describe())
        self.last_profile = None  # the --profile window's torch.profiler
        # after the telemetry install: the writer's events land in the
        # run's stream. Rank 0 writes (the state is the same on every rank)
        self._async_ckpt = None
        self._overlap_eval_thread: Optional[threading.Thread] = None
        self._eval_model = None
        self._eval_stream = None
        if c.eval_freq and c.async_ckpt and self.rank == 0:
            from pytorch_distributed_nn_tpu_torch.training.async_ckpt import (
                AsyncCheckpointer,
            )

            self._async_ckpt = AsyncCheckpointer(
                c.train_dir, keep_last=c.keep_last, geometry=self._geometry)
            self._async_ckpt.warmup(self.state)
        if self.start_step:
            self._restore_data_stream()
        logger.info("Trainer: %s (%d params, %s) on %s, rank %d of %d, from "
                    "step %d", c.network, param_count(self.model), c.dtype,
                    self.device, self.rank, self.n_workers, self.start_step)

    def _init_text(self, build_opt) -> None:
        c = self.config
        self.group, self.rank, self.n_workers = None, 0, 1
        self.model = build_train_model(c)
        self.state = create_train_state(self.model, build_opt, self.device,
                                        seed=c.seed + 1)
        self.seq_len = c.seq_len or input_spec(c.network)[0]
        self.vocab_size = c.vocab_size or self.model.config.vocab_size
        self.train_step = build_train_step(grad_accum=c.grad_accum,
                                           nonfinite_guard=c.skip_nonfinite)
        self.eval_step = build_eval_step()
        self.train_loader = MLMLoader(
            MLMBatches(vocab_size=self.vocab_size, seq_len=self.seq_len,
                       batch_size=c.batch_size, seed=c.seed,
                       mask_prob=c.mask_prob, branching=c.corpus_branching),
            self.device,
        )
        self.test_loader = MLMLoader(
            MLMBatches(vocab_size=self.vocab_size, seq_len=self.seq_len,
                       batch_size=c.test_batch_size, seed=c.seed + 10_000,
                       mask_prob=c.mask_prob, branching=c.corpus_branching,
                       corpus_seed=c.seed),  # same language as training
            self.device, eval_batches=c.eval_batches,
        )

    def _plan_elastic(self, group) -> None:
        """The elastic resume plan, before the sync is built: the world
        this launch gives against the checkpoint's recorded geometry
        (JAX trainer semantics; module docstring). Adopts the derived
        ``num_workers`` and ``grad_accum`` into the config, which the
        run's manifest then records."""
        c = self.config
        world = 1 if self.is_text else (
            group.size() if group is not None else env_ranks()[1])
        plan = elastic.plan_resume(
            c.train_dir, world, batch_size=c.batch_size,
            num_workers=c.num_workers, grad_accum=c.grad_accum,
            tensor_parallel=c.tensor_parallel, seq_parallel=c.seq_parallel)
        if plan is None:
            return
        if plan.changed and c.strict_geometry:
            raise elastic.strict_geometry_error(plan, c.train_dir)
        if plan.num_workers != world:
            raise ValueError(
                f"global batch {c.batch_size} gives {plan.num_workers} "
                f"data-parallel workers on a world of {world} rank(s): "
                f"launch {plan.num_workers} rank(s)")
        impossible = c.num_workers is not None and c.num_workers != world
        if plan.changed or impossible:
            if not self.is_text:
                c.num_workers = plan.num_workers
            c.grad_accum = plan.grad_accum
        if plan.changed:
            self._elastic_plan = plan
            logger.warning("Elastic resume engaged: %s", plan.describe())

    def _check_fault_plan(self) -> None:
        """JAX trainer's checks of the plan against the built run."""
        plan = self.fault_plan
        if plan is None:
            return
        bad_rank = plan.max_rank_referenced()
        if bad_rank >= self.n_workers:
            raise ValueError(
                f"fault plan references rank p{bad_rank} but the run has "
                f"{self.n_workers} data-parallel workers")
        if any(e.kind == "nan_grad" for e in plan.entries):
            if not isinstance(self.train_loader, DataLoader):
                raise ValueError(
                    "nan_grad faults poison the HOST batch, but data_layout "
                    "resolved to 'device' (batches are built on the card and "
                    "never pass through the host); run with "
                    "data_layout='host' to use nan_grad injection")
            # the k-th batch of this loader is step start_step + k
            self.train_loader.host_transform = (
                lambda k, b: plan.poison_batch(self.start_step + k, b))
        logger.info("Fault plan: %s", plan.describe())

    def _init_image(self, build_opt, group=None) -> None:
        c = self.config
        if group is None:
            self.group, self.device = init_group(self.device, c.num_workers)
        else:
            if c.num_workers is not None and c.num_workers != group.size():
                raise ValueError(
                    f"num_workers={c.num_workers} but the group has "
                    f"{group.size()} rank(s)")
            self.group = group
        self.rank, self.n_workers = self.group.rank(), self.group.size()
        n = self.n_workers
        if c.batch_size % (n * c.grad_accum):
            raise ValueError(
                f"global batch {c.batch_size} not divisible by {n} workers "
                f"x grad_accum={c.grad_accum} microbatches")
        if c.sync_mode == "local" and n > 1:
            raise ValueError("sync_mode='local' requires a single worker")
        if c.kill_ranks:
            bad = [k for k in c.kill_ranks if not 0 <= k < n]
            if bad:
                raise ValueError(f"kill_ranks {bad} out of range for {n} "
                                 "data-parallel workers")
            if len(set(c.kill_ranks)) >= n:
                raise ValueError("kill_ranks names every data-parallel worker "
                                 "— no gradients would ever be aggregated")
        self.grad_sync = make_grad_sync(
            self.group, c.sync_mode, num_aggregate=c.num_aggregate,
            compression=c.compression, topk_ratio=c.topk_ratio,
            kill_ranks=tuple(c.kill_ranks), bucket_bytes=c.bucket_bytes)
        self.model = build_train_model(c)
        # one dropout stream per rank and step, as the JAX step folds the
        # dropout key with both
        self.state = create_train_state(self.model, build_opt, self.device,
                                        seed=c.seed + 1, rank=self.rank)
        self.train_step = build_image_train_step(
            self.grad_sync, bn_stats_sync=c.bn_stats_sync,
            grad_accum=c.grad_accum, nonfinite_guard=c.skip_nonfinite)
        self.eval_step = build_image_eval_step(self.group)

        train_ds = load_dataset(c.dataset, train=True, data_dir=c.data_dir,
                                synthetic_size=c.synthetic_size)
        test_ds = load_dataset(c.dataset, train=False, data_dir=c.data_dir,
                               synthetic_size=c.synthetic_size)
        data_bytes = train_ds.raw_images.nbytes + test_ds.raw_images.nbytes
        self.data_layout = c.data_layout
        if c.data_layout == "auto":
            self.data_layout = "device" if data_bytes < 2 << 30 else "host"
        # the test batch: at most the split, a multiple of the workers
        test_bs = min(c.test_batch_size, (len(test_ds) // n) * n)
        test_bs = max(n, test_bs - test_bs % n)
        kw = dict(rank=self.rank, world=n)
        if self.data_layout == "device":
            self.train_loader = DeviceDataLoader(
                train_ds, c.batch_size, self.device, shuffle=True,
                seed=c.seed, **kw)
            self.test_loader = DeviceDataLoader(
                test_ds, test_bs, self.device, shuffle=False, **kw)
        else:
            self.train_loader = DataLoader(
                train_ds, c.batch_size, shuffle=True, seed=c.seed,
                device=self.device, **kw)
            self.test_loader = DataLoader(
                test_ds, test_bs, shuffle=False, prefetch=0,
                device=self.device, **kw)

    # -- resume and telemetry ----------------------------------------------

    def _resume(self) -> None:
        """Restore the newest valid checkpoint of ``train_dir``: rank 0
        scans (verifying, quarantining what fails), the others restore the
        step it found."""
        from pytorch_distributed_nn_tpu_torch.resilience.supervisor import (
            resume_latest_valid,
        )

        c = self.config
        found = 0
        if self.rank == 0:
            restored = resume_latest_valid(c.train_dir, self.state)
            found = 0 if restored is None else self.state.step + 1
        if self.n_workers > 1:
            flag = torch.tensor([found], dtype=torch.int64,
                                device=self.device)
            found = int(all_reduce(flag, "sum", self.group).item())
            if self.rank != 0 and found:
                ckpt.restore_checkpoint(
                    ckpt.checkpoint_path(c.train_dir, found - 1), self.state)
        if found:
            self.start_step = self.state.step
            logger.info("Resumed from step %d", self.start_step)
        else:
            logger.info("Resume: no valid checkpoint in %s; starting fresh",
                        c.train_dir)

    def _init_telemetry(self) -> None:
        """The run's stream: ``metrics_path``, else
        ``<train_dir>/telemetry.jsonl`` when the run checkpoints or is
        supervised; rank 0 writes it (other ranks keep an in-memory
        registry). The manifest is its first record."""
        c = self.config
        path = c.metrics_path
        if path is None and (c.supervise or c.eval_freq):
            path = os.path.join(c.train_dir, obs.STREAM_BASENAME)
        if self.rank != 0:
            path = None
        manifest = obs.run_manifest(
            config=dataclasses.asdict(c),
            geometry=self._geometry,
            param_count=param_count(self.model),
            param_bytes=int(sum(p.numel() * p.element_size()
                                for p in self.model.parameters())),
            start_step=self.start_step,
            device=str(self.device),
        )
        manifest["rank"] = self.rank
        self.telemetry = obs.Telemetry.for_run(path, manifest)
        self.telemetry.registry.gauge(
            "num_workers", help="data-parallel degree").set(self.n_workers)
        # the process default: the checkpoint, retry and evaluator writers
        # emit into this run's stream
        self._prev_telemetry = obs.install(self.telemetry)
        self.metrics = MetricsLogger(telemetry=self.telemetry)

    def _restore_data_stream(self) -> None:
        """A resumed MLM run continues its batch stream from the
        checkpoint's ``.data.json`` sidecar, else by skipping the steps
        done; the image loaders restart their epoch (the JAX trainer's
        semantics)."""
        restore = getattr(self.train_loader, "restore", None)
        if restore is None:
            return
        data_state = ckpt.load_data_state(
            ckpt.checkpoint_path(self.config.train_dir, self.start_step))
        if data_state is not None:
            try:
                restore(data_state)
                logger.info("Restored the input stream at step %d (%s)",
                            self.start_step, data_state)
                return
            except (ValueError, KeyError):
                logger.exception("iterator-state restore failed; "
                                 "falling back to skip-based fast-forward")
        logger.warning("Input stream fast-forwarding %d batch(es) by skip "
                       "(no usable iterator-state sidecar)", self.start_step)
        self.telemetry.emit("data_refastforward", step=self.start_step,
                            mode="skip", batches=self.start_step)
        self.train_loader.skip(self.start_step)

    def _loader_state(self) -> Optional[dict]:
        fn = getattr(self.train_loader, "state", None)
        return fn() if callable(fn) else None

    # -- the loop ------------------------------------------------------------

    def _sync(self) -> None:
        # the training stream only: a device-wide sync would also wait for
        # the checkpoint writer's copies to the host on its own stream
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def step(self, batch) -> Dict[str, torch.Tensor]:
        """One training step on ``batch`` (this rank's slice); metrics
        stay on the device."""
        if self.is_text:
            return self.train_step(self.state, batch)
        # the JAX trainer's step key is PRNGKey(seed + 1) folded with the
        # step: the same on every rank, another at every step
        return self.train_step(self.state, batch,
                               sync_seed(self.config.seed + 1,
                                         self.state.step))

    def _stop_requested(self, sup) -> bool:
        """Whether a signal asked this run to stop; over several ranks,
        whether any rank's did (every rank leaves at the same step)."""
        if sup is None:
            return False
        stop = sup.should_stop
        if self.n_workers > 1:
            flag = torch.tensor([int(stop)], dtype=torch.int64,
                                device=self.device)
            stop = bool(all_reduce(flag, "max", self.group).item())
        return stop

    def train(self) -> List[dict]:
        """Run the steps from ``start_step``; returns the per-step
        records. Metrics are read (one sync of the training stream)
        every ``log_every`` steps; a step's time is its window's wall time
        less the batch fetches, over the window's steps (a checkpoint's
        stall is not billed to the next window)."""
        c = self.config
        per_epoch = self.train_loader.steps_per_epoch
        total = c.max_steps if c.max_steps is not None else per_epoch * c.epochs
        items = c.batch_size * (self.seq_len if self.is_text else 1)
        rate_key = "tokens_per_sec" if self.is_text else "images_per_sec"
        history: List[dict] = []
        pending: List[dict] = []
        timer = PhaseTimer(registry=self.telemetry.registry)
        window_t0, window_data = time.perf_counter(), 0.0

        def flush():
            nonlocal window_t0, window_data
            if not pending:
                return
            self._sync()
            step_s = max((time.perf_counter() - window_t0 - window_data)
                         / len(pending), 1e-9)
            for rec in pending:
                m = rec.pop("_metrics")
                rec.update({k: float(v) for k, v in m.items()})
                rec["step_ms"] = step_s * 1e3
                rec[rate_key] = items / step_s
                history.append(rec)
                self.metrics.log(rec)
                if rec.get("skipped_nonfinite", 0):
                    self.telemetry.emit("nonfinite_skip", step=rec["step"])
            last = pending[-1]
            logger.info("Step: %d, Epoch: %d, Loss: %.4f, Prec@1: %.4f, "
                        "Prec@5: %.4f, StepTime: %.4f ms, %s: %.1f",
                        last["step"], last["epoch"], last["loss"],
                        last["acc1"], last["acc5"], last["step_ms"],
                        rate_key, last[rate_key])
            pending.clear()
            window_t0, window_data = time.perf_counter(), 0.0

        sup = None
        if c.supervise:
            from pytorch_distributed_nn_tpu_torch.resilience.supervisor import (
                RunSupervisor,
            )

            sup = RunSupervisor(
                c.train_dir, grace=c.heartbeat_grace,
                on_stall=(self._flightrec.notify_stall
                          if self._flightrec is not None else None))
            sup.extra["geometry"] = self._geometry

        def preempt_exit(completed: int):
            flush()
            self.telemetry.emit("preempt", step=completed,
                                signal=sup.stop_signal)
            self._emergency_save()
            self.telemetry.flush(fsync=True)
            logger.warning("Preempted after step %d: emergency checkpoint "
                           "written, exiting cleanly", completed)

        plan = self.fault_plan
        # the --profile window: steps start_step + 2 .. + 1 + profile_steps
        profile_at = (self.start_step + 1
                      if c.profile_steps > 0 and self.rank == 0 else None)
        profile_stop = None
        ok = False
        step = self.start_step - 1  # the last completed step
        try:
            with sup if sup is not None else contextlib.nullcontext():
                for step in range(self.start_step, total):
                    if plan is not None:
                        plan.pre_step(step + 1, rank=self.rank)
                    if self._stop_requested(sup):
                        preempt_exit(step)
                        break
                    if step == profile_at and profiling.trace_active():
                        logger.warning("--profile window skipped: a flight "
                                       "recorder capture holds the profiler")
                        profile_at = None
                    if step == profile_at:
                        flush()
                        pdir = c.profile_dir or os.path.join(c.train_dir,
                                                             "profile")
                        profiling.start_trace(pdir)
                        profile_stop = step + c.profile_steps
                        logger.info("Profiling steps %d..%d to %s", step + 1,
                                    profile_stop, pdir)
                        window_t0 = time.perf_counter()
                    timer.reset()
                    with timer.phase("data"):
                        batch = self.train_loader.next_batch()
                    window_data += timer.durations["data"]
                    metrics = self.step(batch)
                    pending.append({
                        "step": step + 1, "epoch": step // per_epoch,
                        "_metrics": metrics,
                        "data_time": timer.durations["data"],
                        "input_wait_ms": self.train_loader.last_wait_ms})
                    if (step + 1) % c.log_every == 0 or step + 1 == total:
                        flush()
                    if profile_stop is not None and step + 1 >= profile_stop:
                        flush()  # the trace holds whole steps
                        self.last_profile = profiling.stop_trace()
                        profile_stop = profile_at = None
                        window_t0 = time.perf_counter()
                    if c.eval_freq and (step + 1) % c.eval_freq == 0:
                        flush()
                        self._save_periodic(step + 1, timer)
                        window_t0 = time.perf_counter()
                    if self._flightrec is not None:
                        # a capture starts or stops between whole steps;
                        # inside a --profile window it takes no trace
                        due = self._flightrec.due(step + 1)
                        if due:
                            flush()
                        self._flightrec.tick(step + 1,
                                             trace_ok=profile_stop is None)
                        if due:
                            window_t0 = time.perf_counter()
                    if sup is not None:
                        sup.beat(step + 1)
                        # a signal during the step stops here: the grace
                        # window is one step and a checkpoint
                        if self._stop_requested(sup):
                            preempt_exit(step + 1)
                            break
            ok = True
        except InjectedCrash:
            # an abrupt failure: checkpoint the last completed step (the
            # crash fires entering its step) and let it propagate
            self._emergency_save()
            self.telemetry.flush(fsync=True)
            raise
        finally:
            # an open capture stops its trace and writes its report first
            # (a failing run is when the bundle matters)
            if self._flightrec is not None:
                try:
                    self._flightrec.finalize(step + 1)
                except Exception:
                    logger.exception("flight recorder finalize failed")
            # the last enqueued save publishes before the run is done, and
            # a writer failure fails the run as a sync write would (on the
            # success path; a failing run keeps its own error)
            try:
                self._finish_background_io(raise_errors=ok)
            finally:
                if sup is not None:
                    sup.beat(step + 1)
                flush()
                self.telemetry.flush()
                if profile_stop is not None:  # the run ended in the window
                    try:
                        self.last_profile = profiling.stop_trace()
                    except Exception:
                        if ok:
                            raise
                        logger.exception("stop_trace failed during shutdown")
        return history

    def _save_periodic(self, step: int, timer: PhaseTimer) -> None:
        """The checkpoint of ``step`` (rank 0): handed to the async writer
        (the loop stalls for the snapshot), or written inline."""
        c = self.config
        if self.rank != 0:
            return
        data_state = self._loader_state()
        if self._async_ckpt is not None:
            with timer.phase("checkpoint"):
                handle = self._async_ckpt.save(
                    self.state, step=step,
                    retain_device_state=c.overlap_eval,
                    data_state=data_state, fault_plan=self.fault_plan)
            logger.info("Checkpoint step %d handed to the async writer "
                        "(loop stalled %.1f ms)", step, handle.stall_ms)
            if c.overlap_eval:
                self._start_overlap_eval(handle)
            return
        with timer.phase("checkpoint"):
            path = ckpt.save_checkpoint(c.train_dir, self.state, step=step,
                                        data_state=data_state,
                                        geometry=self._geometry,
                                        fault_plan=self.fault_plan)
        if c.keep_last is not None:
            ckpt.gc_checkpoints(c.train_dir, c.keep_last)
        logger.info("Checkpointed step %d to %s", step, path)

    def _snapshot_state(self, snap) -> TrainState:
        """A model that reads the snapshot's tensors (no copy): the
        overlapped eval's, built once."""
        if self._eval_model is None:
            self._eval_model = build_train_model(self.config).to(
                self.device)
        named = {k.split("/", 1)[1]: v for k, v in snap.tensors.items()
                 if k.startswith(("params/", "batch_stats/"))}
        self._eval_model.load_state_dict(named, strict=True, assign=True)
        return TrainState(self._eval_model, None, step=snap.step)

    def _start_overlap_eval(self, handle) -> None:
        """The eval pass on ``handle``'s device snapshot, on a thread and
        (on the card) its own stream, while training goes on; depth 1, as
        the writer. Emits ``eval_result`` with ``source="overlap"``."""
        prev = self._overlap_eval_thread
        if prev is not None:
            prev.join()
        telemetry = self.telemetry
        snap = handle.dev_state
        if self.device.type == "cuda" and self._eval_stream is None:
            self._eval_stream = torch.cuda.Stream(self.device)

        def _run():
            try:
                with torch.cuda.stream(self._eval_stream) \
                        if self._eval_stream is not None \
                        else contextlib.nullcontext():
                    snap.wait(self._eval_stream)
                    out = run_eval_pass(self.eval_step,
                                        self._snapshot_state(snap),
                                        self.test_loader)
                if out:
                    seqs = getattr(self.test_loader, "eval_sequences", None)
                    telemetry.emit(
                        "eval_result", step=handle.step,
                        loss=out["loss"], acc1=out["acc1"], acc5=out["acc5"],
                        sequences=seqs, source="overlap")
                    logger.info("Overlapped eval @ step %d: loss %.4f, "
                                "prec@1 %.4f, prec@5 %.4f", handle.step,
                                out["loss"], out["acc1"], out["acc5"])
            except Exception:
                logger.exception("overlapped eval failed (non-fatal)")
            finally:
                handle.dev_state = None

        self._overlap_eval_thread = threading.Thread(
            target=_run, name="pdtn-overlap-eval", daemon=True)
        self._overlap_eval_thread.start()

    def _finish_background_io(self, raise_errors: bool) -> None:
        """Join the overlapped eval and drain the async writer: where the
        writer's faults surface."""
        prev = self._overlap_eval_thread
        if prev is not None:
            prev.join()
            self._overlap_eval_thread = None
        if self._async_ckpt is not None:
            self._async_ckpt.drain(raise_errors=raise_errors)

    def _emergency_save(self) -> Optional[str]:
        """A synchronous checkpoint of the live state at the completed
        step (the preemption path), after draining the async writer so
        the two never race on one path. Best effort: logged, not
        raised."""
        c = self.config
        try:
            self._finish_background_io(raise_errors=False)
        except Exception:
            logger.exception("async drain before emergency save failed")
        if self.rank != 0:
            return None
        try:
            path = ckpt.save_checkpoint(c.train_dir, self.state,
                                        data_state=self._loader_state(),
                                        geometry=self._geometry,
                                        fault_plan=self.fault_plan)
            logger.info("Emergency checkpoint: %s", path)
            return path
        except Exception:
            logger.exception("emergency checkpoint failed")
            return None

    def evaluate(self) -> Dict[str, float]:
        """Mean loss/acc1/acc5 over the test split (images) or the fixed
        eval set (text); ``{}`` when it is empty. Emits ``eval_result``
        (``source="trainer"``)."""
        out = run_eval_pass(self.eval_step, self.state, self.test_loader)
        if not out:
            logger.info("Validation skipped: eval set is empty")
            return {}
        if self.is_text:
            unit, count = "sequences", self.test_loader.eval_sequences
        else:
            unit = "images"
            count = self.test_loader.steps_per_epoch \
                * self.test_loader.batch_size
        logger.info("Validation: loss %.4f, prec@1 %.4f, prec@5 %.4f "
                    "(%d %s)", out["loss"], out["acc1"], out["acc5"], count,
                    unit)
        self.telemetry.emit("eval_result", step=self.state.step,
                            loss=out["loss"], acc1=out["acc1"],
                            acc5=out["acc5"], source="trainer",
                            **{unit: count})
        return out

    def close(self) -> None:
        try:
            if self._flightrec is not None:
                self._flightrec.close()
            self._finish_background_io(raise_errors=False)
            if self._async_ckpt is not None:
                self._async_ckpt.close()
        finally:
            self.train_loader.close()
            self.test_loader.close()
            self.metrics.close()
            self.telemetry.close()
            obs.uninstall(self.telemetry, self._prev_telemetry)
