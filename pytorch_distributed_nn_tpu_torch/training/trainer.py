"""Training: the port of ``pytorch_distributed_nn_tpu/training/trainer.py``
for two paths.

Both families train data-parallel over a process group
(:mod:`..parallel.mesh`; one rank per process, the torchrun world or one
rank), each rank on its slice of the global batch, with the JAX package's
gradient sync (``sync_mode`` allreduce/ps/local, ``num_aggregate``,
``kill_ranks``, ``compression`` none/int8/topk: the int8 quantize kernel
on the card, topk with error feedback; ``bucket_bytes``; and the
straggler simulator, ``straggler_deadline``/``straggler_min_keep``) and
``grad_accum``.

- Image models (the CNN zoo on MNIST/CIFAR/SVHN), with ``bn_stats_sync``.
  Data: real files under ``data_dir`` or the synthetic set;
  ``data_layout`` ``device`` keeps the uint8 set on the card and builds
  batches there, ``host`` prepares them on a thread (``loader_workers =
  N``: in N worker processes), ``auto`` is device when the two splits
  take under 2 GiB.
- Text models (the transformer family, dataset ``MLMSynth``): MLM
  training, the JAX trainer's shard_map path at tp = sp = 1 (and its
  GSPMD path above 1, below): the masked
  mean over the global masked count (``attn_impl="pallas"`` -> the
  hand-written flash kernel, ``"full"`` -> plain attention in PyTorch;
  ``fused_ln`` is accepted: the port's one LayerNorm is the kernel).
- ``data_path``: a shard directory of ``data export``
  (:mod:`..data.streaming`) feeds training through the
  ``StreamingLoader`` (``stream_prefetch`` batches ready, the transform
  on ``loader_workers`` threads); its kind must match the network. Image
  models evaluate on the in-memory test split, text models on the fixed
  eval set, as the JAX trainer does. One node is one JAX host: its
  ranks read the same shards and each keeps its rows of the host batch
  (under ``multihost`` each node reads its own shards).

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
  ``source="overlap"``): over several ranks every rank snapshots its own
  state and scores its share of the eval batches on its thread, whose
  collectives go over a second process group built at startup (two
  threads never share a communicator); each rank joins its previous pass
  at the same boundary. Rank 0 writes; a topk run's residuals are
  gathered to it from every rank for each save, and scattered back from
  the file it restores (another replica count resets them, with a
  warning; an emergency save whose gather fails writes none).
- ``resume`` restores the newest checkpoint that verifies, whichever
  package wrote it (corrupt newer ones are quarantined), the MLM and
  streaming batch streams from its ``.data.json`` sidecar (a streaming
  state of another shard layout is re-partitioned; without a sidecar the
  stream skips the steps done; the in-memory image loaders restart, as
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
  sleeps rank K only, an entry without a rank every rank; with the
  straggler simulator on, the delay is simulated instead: it enters the
  step's arrival times and nothing sleeps; a crash writes the emergency
  checkpoint and re-raises, a preempt takes the SIGTERM path),
  ``nan_grad`` poisons the step's host batch before its copy to the card
  (``data_layout="host"`` or ``data_path``; image models only),
  ``flaky_io`` and ``torn_ckpt`` fire in the checkpoint writer. A step
  whose sync dropped stragglers logs a warning and emits
  ``straggler_drop`` (the ``straggler_burst`` detector's input).
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
``incident``, ``straggler_drop`` and ``elastic_resume`` are events with
the JAX package's field names.

Tensor and sequence parallelism (``tensor_parallel``/``seq_parallel`` >
1, the JAX trainer's GSPMD path, :mod:`.spmd`): the world is ``dp * sp *
tp`` ranks on the (data, seq, model) mesh (:func:`..parallel.mesh.
make_mesh`); every rank builds the whole model from ``seed`` and keeps its
regions, attention is ring or Ulysses over the seq group (``seq_attn``)
or, tp-only with ``attn_impl="pallas"``, the flash kernels on the rank's
heads; the sync is the spmd step's (``compression`` none or int8). Its
checkpoints are sharded directories, written by every rank (async: a
writer on each rank), and ``resume`` restores a directory or a file of
any mesh. ``remat`` checkpoints each block; ``warm_start`` merges a FILE
checkpoint's parameters into the freshly initialised model
(:mod:`.warm_start`) before the run's state is built. The JAX trainer's
refusals stand, as ``ValueError`` with its reasons; ``overlap_eval``
under tp/sp is not ported and raises.

The trainer runs on the card unless ``device="cpu"`` is given; without a
card it raises, it never falls back to the CPU.

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
from pytorch_distributed_nn_tpu_torch.data.streaming import (
    StreamingLoader,
    load_meta,
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
from pytorch_distributed_nn_tpu_torch.models.convert import (
    cnn_to_state_dict,
    flax_to_state_dict,
    is_cnn,
    state_dict_to_cnn,
    state_dict_to_flax,
)
from pytorch_distributed_nn_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    all_reduce,
    axis_sizes,
    env_ranks,
    init_group,
    make_mesh,
    sibling_group,
)
from pytorch_distributed_nn_tpu_torch.parallel.ring_attention import (
    make_mesh_attn,
    make_tp_flash_attn,
)
from pytorch_distributed_nn_tpu_torch.resilience import elastic
from pytorch_distributed_nn_tpu_torch.resilience.faults import (
    FaultPlan,
    InjectedCrash,
)
from pytorch_distributed_nn_tpu_torch.resilience.stragglers import (
    dropped_ranks,
    make_straggler_sim,
)
from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt
from pytorch_distributed_nn_tpu_torch.training.config import TrainConfig
from pytorch_distributed_nn_tpu_torch.training.spmd import (
    build_spmd_eval_step,
    build_spmd_train_step,
    create_spmd_state,
    shard_model,
)
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

#: seconds an emergency checkpoint waits for the other ranks' residuals
EF_GATHER_TIMEOUT_S = 60.0


def use_spmd(c: TrainConfig) -> bool:
    """Whether ``c`` runs the tp/sp (GSPMD) path."""
    return c.tensor_parallel > 1 or c.seq_parallel > 1


def validate(c: TrainConfig) -> None:
    """Raise on what the JAX trainer refuses."""
    text = is_text_model(c.network)
    if use_spmd(c):
        _validate_spmd(c, text)
    if c.warm_start and c.resume:
        raise ValueError(
            "warm_start and resume are mutually exclusive: resume restores "
            "this run's own checkpoints (same geometry + optimizer state); "
            "warm_start performs cross-geometry parameter surgery from "
            "another run's checkpoint")
    if text:
        if c.dataset != "MLMSynth":
            raise ValueError(f"text model {c.network!r} requires "
                             f"dataset='MLMSynth' (got {c.dataset!r})")
        if c.attn_impl not in ("full", "pallas"):
            raise ValueError(f"unknown attn_impl {c.attn_impl!r}")
    else:
        if c.dataset == "MLMSynth":
            raise ValueError("dataset='MLMSynth' requires a text model (got "
                             f"{c.network!r})")
        if c.remat:
            raise ValueError(
                "remat applies to text models (the CNN zoo's activations "
                "are small; use it for long sequences)")
        if c.fused_ln:
            raise ValueError("fused_ln only applies to text models "
                             f"(got network={c.network!r})")
        if c.attn_impl != "full":
            raise ValueError(f"attn_impl={c.attn_impl!r} only applies to "
                             f"text models (got network={c.network!r})")
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


def _validate_spmd(c: TrainConfig, text: bool) -> None:
    """The JAX trainer's refusals of the tp/sp path, with its reasons."""
    if not text:
        raise ValueError(
            "tensor/sequence parallelism applies to text models (got "
            f"network={c.network!r}; the CNN zoo has no sharded-parameter "
            "annotations)")
    if c.sync_mode != "allreduce" or c.compression not in ("none", "int8") \
            or c.kill_ranks:
        raise ValueError(
            "tp/sp use the GSPMD path: gradient sync is the "
            "compiler-inserted all-reduce (sync_mode='allreduce') or its "
            "int8-quantized form (compression='int8', "
            "training/spmd._int8_spmd_step); PS emulation, topk compression "
            "and kill_ranks are shard_map-DP features (tp=sp=1)")
    if c.grad_accum > 1 and c.compression == "int8":
        raise ValueError(
            "grad_accum>1 with compression='int8' under tp/sp is not "
            "implemented (the quantized dp sync would need the microbatch "
            "scan inside its manual region); use one or the other")
    if c.seq_attn not in ("ring", "ulysses"):
        raise ValueError(f"unknown seq_attn {c.seq_attn!r}")
    if c.attn_impl == "pallas" and c.seq_parallel > 1:
        raise ValueError(
            "attn_impl='pallas' composes with tensor parallelism (heads "
            "shard over the model axis and each shard runs the flash "
            "kernel) but not with seq_parallel > 1: sp uses ring/ulysses "
            "attention, whose per-device inner step is already flash-style")
    if c.fused_ln:
        raise ValueError(
            "fused_ln is not supported under tensor/sequence parallelism "
            "yet (GSPMD has no partitioning rule for the LN custom call); "
            "drop --fused-ln or tp/sp")
    if c.straggler_deadline is not None:
        raise ValueError(
            "straggler simulation masks per-replica gradients inside the "
            "shard_map DP sync; the GSPMD (tp/sp) all-reduce has no "
            "per-replica contribution to drop")
    if c.skip_nonfinite:
        raise ValueError(
            "skip_nonfinite guards the shard_map DP step; the GSPMD (tp/sp) "
            "step has no non-finite guard yet")
    if c.overlap_eval:
        raise ValueError("overlap_eval under tensor/sequence parallelism is "
                         "not ported: evaluate with the evaluator process")
    seq_len = c.seq_len or input_spec(c.network)[0]
    if seq_len % c.seq_parallel:
        raise ValueError(f"seq_len {seq_len} not divisible by "
                         f"seq_parallel={c.seq_parallel}")


def text_model_kw(c: TrainConfig) -> dict:
    """The model flags of a text run (no attention function)."""
    model_kw = {"dtype": c.dtype}
    if c.vocab_size is not None:
        model_kw["vocab_size"] = c.vocab_size
    if c.seq_len is not None:
        model_kw["max_len"] = c.seq_len
    if c.fused_ln:
        model_kw["fused_ln"] = True
    if c.remat:
        model_kw["remat"] = True
    return model_kw


def check_heads(c: TrainConfig, num_heads: int) -> None:
    """The JAX trainer's head-split checks of a tp/sp run."""
    tp, sp = c.tensor_parallel, c.seq_parallel
    if num_heads % tp:
        raise ValueError(
            f"num_heads={num_heads} not divisible by tensor_parallel={tp} "
            "(heads shard over the model axis)")
    if sp > 1 and c.seq_attn == "ulysses" and (num_heads // tp) % sp:
        raise ValueError(
            f"ulysses needs heads/tp={num_heads // tp} divisible by "
            f"seq_parallel={sp} (all-to-all re-shards seq->heads); use "
            "seq_attn='ring'")


def build_train_model(c: TrainConfig) -> torch.nn.Module:
    """A fresh model of ``c``'s network and model flags, its weights drawn
    from ``c.seed`` (on the CPU, or under ``torch.device("meta")`` on the
    meta device: the cost walk's model)."""
    if is_text_model(c.network):
        model_kw = text_model_kw(c)
        if c.attn_impl == "pallas":
            model_kw["attn_fn"] = kernels.flash_attention
        model = build_model(c.network, **model_kw)
    else:
        num_classes = 100 if c.dataset == "Cifar100" else 10
        model = build_model(c.network, num_classes, dtype=c.dtype)
    model.init_weights(torch.Generator().manual_seed(c.seed))
    return model


class Trainer:
    """``Trainer(config, device=None, group=None, multihost=False)``:
    ``group`` is the process group of the ranks (default: the torchrun
    world, :func:`..parallel.mesh.init_group`; the tests pass gloo groups
    of ranks that run as threads, built by ``mesh.new_group``);
    ``multihost`` requires the torchrun environment and retries its
    rendezvous (``train --multihost``)."""

    def __init__(self, config: TrainConfig, device=None, group=None,
                 multihost: bool = False):
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
        self._multihost = multihost
        self.spmd = use_spmd(c)
        self.mesh = None
        self._elastic_plan = None
        if c.resume:
            self._plan_elastic(group)
        schedule = make_schedule(c.lr, c.warmup_steps, c.lr_decay_steps,
                                 c.lr_decay_factor)

        def build_opt(params):
            return build_optimizer(
                c.optimizer, params, schedule, momentum=c.momentum,
                weight_decay=c.weight_decay, nesterov=c.nesterov)

        self._build_opt = build_opt
        self._init_sync(group, multihost)
        if self.is_text:
            self._init_text(build_opt)
        else:
            self._init_image(build_opt)
        # the overlapped eval's collectives run on a thread: a group of
        # their own, built by every rank here
        self.eval_group = (sibling_group(self.group, "pdtn_eval")
                           if c.overlap_eval else None)
        self._check_fault_plan()
        self._geometry = elastic.rank_geometry(
            self.group.size(),
            axis_sizes(self.mesh) if self.mesh is not None else None)
        self.start_step = 0
        if c.resume:
            self._resume()
        self._init_telemetry()
        if self._elastic_plan is not None:
            self.telemetry.emit("elastic_resume", step=self.start_step,
                                **self._elastic_plan.event_fields(
                                    self.state.ef_state is not None))
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
        self._overlap_eval_step = None
        if self.eval_group is not None:
            self._overlap_eval_step = (
                build_eval_step(self.eval_group) if self.is_text
                else build_image_eval_step(self.eval_group))
        if c.eval_freq and c.async_ckpt and (self.rank == 0 or self.spmd):
            from pytorch_distributed_nn_tpu_torch.training.async_ckpt import (
                AsyncCheckpointer,
            )

            # a tp/sp run: every rank writes its shard file
            self._async_ckpt = AsyncCheckpointer(
                c.train_dir, keep_last=c.keep_last, geometry=self._geometry,
                mesh=self.mesh)
            self._async_ckpt.warmup(self.state)
        if self.start_step:
            self._restore_data_stream()
        logger.info("Trainer: %s (%d params, %s) on %s, rank %d of %d, from "
                    "step %d", c.network, param_count(self.model), c.dtype,
                    self.device, self.rank, self.world, self.start_step)

    def _init_sync(self, group, multihost: bool = False) -> None:
        """The process group, this rank, and the gradient sync with its
        straggler simulator (both families)."""
        c = self.config
        if group is None:
            self.group, self.device = init_group(
                self.device, None if c.num_workers is None else
                c.num_workers * c.tensor_parallel * c.seq_parallel,
                multihost=multihost)
        else:
            self.group = group
        per = c.tensor_parallel * c.seq_parallel
        world = self.group.size()
        if c.num_workers is not None and c.num_workers * per != world:
            raise ValueError(
                f"num_workers={c.num_workers} but the group has {world} "
                f"rank(s)" + (f" (tensor_parallel x seq_parallel = {per})"
                              if per > 1 else ""))
        self.rank = self.group.rank()
        if self.spmd:
            if world % per:
                raise ValueError(f"{world} ranks not divisible by "
                                 f"tensor_parallel*seq_parallel={per}")
            self.mesh = make_mesh(self.group, world // per,
                                  c.tensor_parallel, c.seq_parallel)
        self.world = world
        self.n_workers = world // per  # the data-parallel degree
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
        self._straggler_sim = None
        if c.straggler_deadline is not None:
            self._straggler_sim = make_straggler_sim(
                c.straggler_deadline, min_keep=c.straggler_min_keep,
                fault_plan=self.fault_plan)
        if self.spmd:  # the spmd step syncs over the mesh itself
            self.grad_sync = None
            return
        self.grad_sync = self._make_sync(self.group, self._straggler_sim)

    def _make_sync(self, group, straggler):
        """The run's gradient sync over ``group``."""
        c = self.config
        return make_grad_sync(
            group, c.sync_mode, num_aggregate=c.num_aggregate,
            compression=c.compression, topk_ratio=c.topk_ratio,
            kill_ranks=tuple(c.kill_ranks), bucket_bytes=c.bucket_bytes,
            straggler=straggler)

    def _init_text(self, build_opt) -> None:
        c = self.config
        n = self.n_workers
        if c.test_batch_size % n:
            raise ValueError(f"test batch {c.test_batch_size} not divisible "
                             f"by {n} workers")
        self.model = build_train_model(c)
        self.warm_start_report = None
        if c.warm_start:
            self._warm_start(self.model)
        self.seq_len = c.seq_len or input_spec(c.network)[0]
        self.vocab_size = c.vocab_size or self.model.config.vocab_size
        data_rank = self.rank
        if self.spmd:
            check_heads(c, self.model.config.num_heads)
            self.model = self._local_model(self.model)
            self.state = create_spmd_state(self.model, build_opt, self.mesh,
                                           self.device, seed=c.seed + 1)
            self.train_step = build_spmd_train_step(
                self.mesh, compression=c.compression,
                grad_accum=c.grad_accum)
            self.eval_step = build_spmd_eval_step(self.mesh)
            data_rank = self.mesh.coords[DATA_AXIS]
        else:
            # one dropout stream per rank and step
            self.state = create_train_state(
                self.model, build_opt, self.device, seed=c.seed + 1,
                rank=self.rank, grad_sync=self.grad_sync)
            self.train_step = build_train_step(
                self.grad_sync, grad_accum=c.grad_accum,
                nonfinite_guard=c.skip_nonfinite)
            self.eval_step = build_eval_step(self.group)
        kw = dict(rank=data_rank, world=n)
        meta = self._stream_meta()
        if meta is not None:
            if int(meta["vocab_size"]) > self.vocab_size:
                raise ValueError(
                    f"shard corpus vocab {meta['vocab_size']} exceeds the "
                    f"model's vocab_size={self.vocab_size}; pass "
                    "--vocab-size >= the exported corpus's")
            self.train_loader = self._streaming_loader(
                seq_len=self.seq_len, mask_prob=c.mask_prob,
                vocab_size=self.vocab_size)
        else:
            self.train_loader = MLMLoader(
                MLMBatches(vocab_size=self.vocab_size, seq_len=self.seq_len,
                           batch_size=c.batch_size, seed=c.seed,
                           mask_prob=c.mask_prob,
                           branching=c.corpus_branching),
                self.device, **kw)
        self.test_loader = MLMLoader(
            MLMBatches(vocab_size=self.vocab_size, seq_len=self.seq_len,
                       batch_size=c.test_batch_size, seed=c.seed + 10_000,
                       mask_prob=c.mask_prob, branching=c.corpus_branching,
                       corpus_seed=c.seed),  # same language as training
            self.device, eval_batches=c.eval_batches, **kw)

    def _warm_start(self, model) -> None:
        """Merge the ``warm_start`` FILE checkpoint's parameters into the
        freshly initialised ``model`` (every rank alike: the file and the
        init are the same on all)."""
        from pytorch_distributed_nn_tpu_torch.training.warm_start import (
            warm_start_params,
        )

        c = self.config
        if is_cnn(model):  # the params tree; BatchNorm statistics stay
            params, stats = state_dict_to_cnn(model.state_dict())
            merged, self.warm_start_report = warm_start_params(
                c.warm_start, params)
            sd = cnn_to_state_dict(merged, stats)
        else:
            merged, self.warm_start_report = warm_start_params(
                c.warm_start, state_dict_to_flax(model.state_dict(),
                                                 model.config.num_heads))
            sd = flax_to_state_dict(merged)
        model.load_state_dict(sd, strict=True)

    def _local_model(self, full) -> torch.nn.Module:
        """This rank's model of a tp/sp run: built on the mesh with the
        run's attention, holding its regions of ``full``'s weights."""
        c = self.config
        attn_fn = None
        if c.seq_parallel > 1:
            attn_fn = make_mesh_attn(self.mesh, c.seq_attn)
        elif c.attn_impl == "pallas":
            attn_fn = make_tp_flash_attn(self.mesh)
        local = build_model(c.network, mesh=self.mesh, attn_fn=attn_fn,
                            **text_model_kw(c))
        return shard_model(full, local, self.mesh)

    def _stream_meta(self) -> Optional[dict]:
        """The manifest of ``data_path`` (None without one); its kind must
        be the network's."""
        c = self.config
        if not c.data_path:
            return None
        meta = load_meta(c.data_path)
        want = "tokens" if self.is_text else "image"
        if meta["kind"] != want:
            raise ValueError(f"{c.data_path} holds {meta['kind']!r} shards "
                             f"but network {c.network!r} needs {want!r} data")
        return meta

    def _streaming_loader(self, **kw) -> StreamingLoader:
        """The training stream of ``data_path``: one node is one JAX host
        (module docstring)."""
        c = self.config
        host_index, host_count = 0, 1
        if self._multihost:
            local = int(os.environ.get("LOCAL_WORLD_SIZE", self.world))
            host_index, host_count = (self.rank // local,
                                      max(1, self.world // local))
        rank = (self.mesh.coords[DATA_AXIS] if self.mesh is not None
                else self.rank)
        return StreamingLoader(
            c.data_path, c.batch_size, seed=c.seed,
            prefetch=c.stream_prefetch, workers=c.loader_workers,
            host_index=host_index, host_count=host_count, rank=rank,
            world=self.n_workers, device=self.device, **kw)

    def _plan_elastic(self, group) -> None:
        """The elastic resume plan, before the sync is built: the world
        this launch gives against the checkpoint's recorded geometry
        (JAX trainer semantics; module docstring). Adopts the derived
        ``num_workers`` and ``grad_accum`` into the config, which the
        run's manifest then records."""
        c = self.config
        world = group.size() if group is not None else env_ranks()[1]
        plan = elastic.plan_resume(
            c.train_dir, world, batch_size=c.batch_size,
            num_workers=c.num_workers, grad_accum=c.grad_accum,
            tensor_parallel=c.tensor_parallel, seq_parallel=c.seq_parallel)
        if plan is None:
            return
        if plan.changed and c.strict_geometry:
            raise elastic.strict_geometry_error(plan, c.train_dir)
        per = c.tensor_parallel * c.seq_parallel
        if plan.num_workers * per != world:
            raise ValueError(
                f"global batch {c.batch_size} gives {plan.num_workers} "
                f"data-parallel workers on a world of {world} rank(s): "
                f"launch {plan.num_workers * per} rank(s)")
        impossible = (c.num_workers is not None
                      and c.num_workers * per != world)
        if plan.changed or impossible:
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
            if not hasattr(self.train_loader, "host_transform"):
                raise ValueError(
                    "nan_grad faults poison the HOST batch, but data_layout "
                    "resolved to 'device' (batches are built on the card and "
                    "never pass through the host); run with "
                    "data_layout='host' to use nan_grad injection")
            # the k-th batch of this loader is step start_step + k
            self.train_loader.host_transform = (
                lambda k, b: plan.poison_batch(self.start_step + k, b))
        logger.info("Fault plan: %s", plan.describe())

    def _init_image(self, build_opt) -> None:
        c = self.config
        n = self.n_workers
        self.model = build_train_model(c)
        self.warm_start_report = None
        if c.warm_start:
            self._warm_start(self.model)
        # one dropout stream per rank and step, as the JAX step folds the
        # dropout key with both
        self.state = create_train_state(self.model, build_opt, self.device,
                                        seed=c.seed + 1, rank=self.rank,
                                        grad_sync=self.grad_sync)
        self.train_step = build_image_train_step(
            self.grad_sync, bn_stats_sync=c.bn_stats_sync,
            grad_accum=c.grad_accum, nonfinite_guard=c.skip_nonfinite)
        self.eval_step = build_image_eval_step(self.group)

        meta = self._stream_meta()
        kw = dict(rank=self.rank, world=n)
        test_ds = load_dataset(c.dataset, train=False, data_dir=c.data_dir,
                               synthetic_size=c.synthetic_size)
        # the test batch: at most the split, a multiple of the workers
        test_bs = min(c.test_batch_size, (len(test_ds) // n) * n)
        test_bs = max(n, test_bs - test_bs % n)
        if meta is not None:
            # the training set streams from its shards; the test split
            # stays in memory for the eval pass
            want = 100 if c.dataset == "Cifar100" else 10
            got = int(meta.get("num_classes", 0))
            if got and got != want:
                raise ValueError(
                    f"{c.data_path} was exported from a {got}-class dataset "
                    f"({meta.get('name')!r}) but --dataset {c.dataset!r} "
                    f"has {want} classes")
            self.train_loader = self._streaming_loader()
            self.test_loader = DataLoader(
                test_ds, test_bs, shuffle=False, prefetch=0,
                device=self.device, **kw)
            return
        train_ds = load_dataset(c.dataset, train=True, data_dir=c.data_dir,
                                synthetic_size=c.synthetic_size)
        data_bytes = train_ds.raw_images.nbytes + test_ds.raw_images.nbytes
        self.data_layout = c.data_layout
        if c.data_layout == "auto":
            self.data_layout = "device" if data_bytes < 2 << 30 else "host"
        if self.data_layout == "device":
            if c.loader_workers > 0:
                logger.warning(
                    "--loader-workers %d ignored: data_layout resolved to "
                    "'device' (batches are built on-chip; there is no host "
                    "loader to parallelize). Pass --data-layout host to use "
                    "the worker pool.", c.loader_workers)
            self.train_loader = DeviceDataLoader(
                train_ds, c.batch_size, self.device, shuffle=True,
                seed=c.seed, **kw)
            self.test_loader = DeviceDataLoader(
                test_ds, test_bs, self.device, shuffle=False, **kw)
        else:
            self.train_loader = DataLoader(
                train_ds, c.batch_size, shuffle=True, seed=c.seed,
                device=self.device, workers=c.loader_workers, **kw)
            self.test_loader = DataLoader(
                test_ds, test_bs, shuffle=False, prefetch=0,
                device=self.device, **kw)

    # -- resume and telemetry ----------------------------------------------

    def _resume(self) -> None:
        """Restore the newest valid checkpoint of ``train_dir``: rank 0
        scans (verifying, quarantining what fails), the others restore the
        step it found; a topk run's residuals come from rank 0's read, each
        rank its row (:meth:`_scatter_ef`). Residuals of another replica
        count reset to zero under an elastic plan, and raise without
        one."""
        from pytorch_distributed_nn_tpu_torch.resilience.supervisor import (
            resume_latest_valid,
        )

        c = self.config
        found, rows = 0, []
        if self.rank == 0:
            restored = resume_latest_valid(
                c.train_dir, self.state, ef_rows=rows,
                ef="raise" if self._elastic_plan is None else "reset")
            found = 0 if restored is None else self.state.step + 1
        if self.world > 1:
            flag = torch.tensor([found, len(rows)], dtype=torch.int64,
                                device=self.device)
            found, n_rows = (int(v) for v in
                             all_reduce(flag, "sum", self.group).tolist())
            if self.rank != 0 and found:
                path = ckpt.checkpoint_path(c.train_dir, found - 1)
                if self._elastic_plan is not None and self.spmd:
                    ckpt.restore_resharded(path, self.state)
                else:
                    ckpt.restore_checkpoint(path, self.state, ef="skip")
            if found and self.state.ef_state is not None:
                self._scatter_ef(rows if n_rows == self.n_workers else None)
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
        sync_bytes = (None if self.grad_sync is None else
                      self.grad_sync.estimate_sync_bytes(
                          list(self.model.parameters())))
        # the step's static cost (analysis/costmodel.py), for the MFU,
        # HBM and ICI gauges and ``obs summary``'s efficiency section;
        # sink-less runs (other ranks, unit tests) skip the walk, as the
        # JAX trainer skips its lowering
        step_cost = None
        if path is not None:
            try:
                step_cost = self._static_step_cost(sync_bytes)
            except Exception:
                logger.exception(
                    "static step-cost accounting failed (run continues "
                    "without efficiency telemetry)")
        manifest = obs.run_manifest(
            config=dataclasses.asdict(c),
            geometry=self._geometry,
            param_count=param_count(self.model),
            param_bytes=int(sum(p.numel() * p.element_size()
                                for p in self.model.parameters())),
            sync_bytes_per_step=sync_bytes,
            start_step=self.start_step,
            step_cost=step_cost,
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

    def _walk_bundle(self) -> dict:
        """The world-size-1 step of this run's configuration at the GLOBAL
        batch, on the meta device (the JAX record is global): a fresh
        model and optimizer of the config, the step of the run's path
        with its sync over a fake group of one rank (the int8 codec is
        in it; the non-finite guard, a host read, is not: analysis/
        costmodel.py). Not :func:`..analysis.costmodel.walk_step`, which
        walks a zoo model by name: this is the run's own model, sync,
        straggler simulator, BatchNorm sync and seed."""
        from pytorch_distributed_nn_tpu_torch.parallel.mesh import (
            fake_group,
        )
        from pytorch_distributed_nn_tpu_torch.training.spmd import (
            spmd_audit_bundle,
        )
        from pytorch_distributed_nn_tpu_torch.training.train_step import (
            dp_audit_bundle,
        )

        c = self.config
        with torch.device("meta"):
            model = build_train_model(c)
        if self.spmd:
            return spmd_audit_bundle(
                model, self._build_opt, make_mesh(None, 1, 1, 1),
                (c.batch_size, self.seq_len), compression=c.compression,
                grad_accum=c.grad_accum, seed=c.seed + 1)
        straggler = None
        if c.straggler_deadline is not None:
            straggler = make_straggler_sim(
                c.straggler_deadline, min_keep=c.straggler_min_keep)
        sync = self._make_sync(fake_group(0, 1), straggler)
        if self.is_text:
            return dp_audit_bundle(
                model, self._build_opt, sync, (self.seq_len,),
                c.batch_size, text=True, seed=c.seed + 1,
                grad_accum=c.grad_accum)
        return dp_audit_bundle(
            model, self._build_opt, sync, input_spec(c.network),
            c.batch_size, seed=c.seed + 1, bn_stats_sync=c.bn_stats_sync,
            grad_accum=c.grad_accum)

    def _static_step_cost(self, sync_bytes) -> dict:
        """The manifest's ``step_cost`` (the JAX trainer's keys): the
        walk's FLOPs and bytes of one GLOBAL step
        (:meth:`_walk_bundle`), the ICI bytes of the sync's payload by
        the ring estimate, the peaks of the run's devices at its compute
        dtype, and the roofline's prediction over one device's share.
        Adds ``peak_dtype`` (the MFU peak follows the dtype) and
        ``walk_s`` (the walk's seconds)."""
        from pytorch_distributed_nn_tpu_torch.analysis import costmodel
        from pytorch_distributed_nn_tpu_torch.analysis.calibration import (
            default_profile,
            peak_flops_per_device,
            predict_step_ms,
        )

        c = self.config
        t0 = time.perf_counter()
        bundle = self._walk_bundle()
        ici = None
        if sync_bytes and self.n_workers > 1:
            n = self.n_workers
            ici = 2.0 * float(sync_bytes) * (n - 1) / n
        cost = costmodel.step_cost_from_walk(
            bundle["step_fn"], bundle["args"], ici_bytes=ici)
        walk_s = time.perf_counter() - t0
        devices = self.world
        on_card = self.device.type == "cuda"
        backend = "gpu" if on_card else "cpu"
        kind = torch.cuda.get_device_name(self.device) if on_card else "cpu"
        peak_dev = peak_flops_per_device(backend, kind, c.dtype)
        prof = default_profile(backend, c.dtype)
        d = cost.to_dict()
        scale = 1.0 / max(devices, 1)
        per_dev = dict(d)
        per_dev["flops"] = d["flops"] * scale
        per_dev["hbm_bytes"] = d["hbm_bytes"] * scale
        per_dev["families"] = {
            f: {**fc, "flops": fc["flops"] * scale,
                "hbm_bytes": fc["hbm_bytes"] * scale}
            for f, fc in (d.get("families") or {}).items()
        }
        pred = predict_step_ms(per_dev, prof, devices=devices)
        logger.info("Static step cost: %.4g GFLOP a global step, walked in "
                    "%.3f s", d["flops"] / 1e9, walk_s)
        return {
            "flops": d["flops"],
            "hbm_bytes": d["hbm_bytes"],
            "ici_bytes": d["ici_bytes"],
            "families": d["families"],
            "source": d["source"],
            "devices": devices,
            "backend": backend,
            "device_kind": kind,
            "peak_flops_per_s": peak_dev * devices,
            "peak_hbm_bytes_per_s": prof.hbm_peak_bytes_per_s * devices,
            "predicted_ms": round(pred["predicted_ms"], 3),
            "calibration": prof.name,
            "peak_dtype": c.dtype,
            "walk_s": round(walk_s, 3),
        }

    def _restore_data_stream(self) -> None:
        """A resumed MLM or streaming run continues its batch stream from
        the checkpoint's ``.data.json`` sidecar (a streaming state of
        another shard layout re-partitioned, with a ``data_refastforward``
        event of ``mode="repartition"``), else by skipping the steps done;
        the in-memory image loaders restart their epoch (the JAX
        trainer's semantics)."""
        restore = getattr(self.train_loader, "restore", None)
        if restore is None:
            return
        data_state = ckpt.load_data_state(
            ckpt.checkpoint_path(self.config.train_dir, self.start_step))
        repart = getattr(self.train_loader, "restore_repartitioned", None)
        if data_state is not None:
            try:
                if repart is None:
                    restore(data_state)
                    logger.info("Restored the input stream at step %d (%s)",
                                self.start_step, data_state)
                    return
                info = repart(data_state)
                if info.get("repartitioned"):
                    logger.warning(
                        "Input-pipeline shard layout changed (%s -> %s host "
                        "shards): re-partitioned at consumed=%s",
                        info.get("saved_shards"), info.get("shards"),
                        info.get("consumed"))
                    self.telemetry.emit("data_refastforward",
                                        step=self.start_step,
                                        mode="repartition", **info)
                else:
                    logger.info("Restored the input stream at step %d "
                                "(consumed=%s)", self.start_step,
                                info.get("consumed"))
                return
            except (ValueError, KeyError):
                logger.exception("iterator-state restore failed; "
                                 "falling back to skip-based fast-forward")
        logger.warning("Input stream fast-forwarding %d batch(es) by skip "
                       "(no usable iterator-state sidecar)", self.start_step)
        self.telemetry.emit("data_refastforward", step=self.start_step,
                            mode="skip", batches=self.start_step)
        self.train_loader.skip(self.start_step)

    # -- the residuals of topk error feedback across ranks -------------------

    def _ef_flat(self) -> torch.Tensor:
        return torch.cat([e.detach().reshape(-1).to(torch.float32)
                          for e in self.state.ef_state])

    def _ef_unflat(self, flat: torch.Tensor, n: int) -> list:
        """(n, total) or (total,) -> one (n, *shape) or (*shape) tensor per
        parameter, in the residuals' dtypes."""
        out, off = [], 0
        for e in self.state.ef_state:
            k = e.numel()
            part = flat[..., off:off + k]
            out.append(part.reshape(*flat.shape[:-1], *e.shape).to(e.dtype))
            off += k
        return out

    def _gather_ef(self, timeout_s: Optional[float] = None):
        """Every rank's residuals on rank 0 for a save, one (n, *shape)
        tensor per parameter (``None`` on the other ranks and without
        topk): one gather of one flat f32 buffer a rank, which every rank
        joins. With ``timeout_s`` a gather that does not complete in time
        (a rank is gone) gives ``()`` on rank 0: the save then writes no
        residuals."""
        ef = self.state.ef_state
        if ef is None:
            return None
        n = self.n_workers
        if n == 1:
            return [e.detach()[None] for e in ef]
        import datetime

        import torch.distributed as dist

        flat = self._ef_flat()
        out = ([[torch.empty_like(flat) for _ in range(n)]]
               if self.rank == 0 else [])
        opts = dist.GatherOptions()
        opts.rootRank = 0
        try:
            work = self.group.gather(out, [flat], opts)
            if timeout_s is None:
                work.wait()
            else:
                work.wait(datetime.timedelta(seconds=timeout_s))
        except Exception:
            if timeout_s is None:
                raise
            logger.exception("residual gather for the emergency checkpoint "
                             "failed: it is written without ef_state")
            return ()
        if self.rank != 0:
            return None
        return self._ef_unflat(torch.stack(out[0]), n)

    def _scatter_ef(self, rows) -> None:
        """Each rank's row of the residuals rank 0 restored (``rows``: a
        list over ranks of ``{name: tensor}``, on rank 0; ``None`` when the
        file held none of this replica count: every rank keeps zeros)."""
        import torch.distributed as dist

        if rows is None:
            for e in self.state.ef_state:
                e.zero_()
            return
        mine = torch.empty_like(self._ef_flat())
        inputs = []
        if self.rank == 0:
            names = [n for n, _ in self.model.named_parameters()]
            inputs = [[torch.cat([row[k].reshape(-1).to(torch.float32)
                                  for k in names]).to(mine.device)
                       for row in rows]]
        opts = dist.ScatterOptions()
        opts.rootRank = 0
        self.group.scatter([mine], inputs, opts).wait()
        self.state.ef_state = self._ef_unflat(mine, 1)

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
        if self.world > 1:
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
                if rec.get("straggler_dropped", 0):
                    self._straggler_event(rec)
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

            # every rank takes the signals; rank 0 alone beats
            # heartbeat.json and metrics.prom in train_dir (each rank's
            # write would race the others' rename of the shared tmp file)
            lead = self.rank == 0
            sup = RunSupervisor(
                c.train_dir if lead else None,
                grace=c.heartbeat_grace if lead else None,
                telemetry=self.telemetry,
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
                        # with the simulator on, a delay is simulated:
                        # it enters the sync's arrival times, no sleep
                        plan.pre_step(step + 1, rank=self.rank,
                                      sleep_delays=self._straggler_sim is None)
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

    def _straggler_event(self, rec: dict) -> None:
        """The warning and the ``straggler_drop`` event of a step whose
        sync dropped stragglers (after its step record)."""
        ranks = (dropped_ranks(rec["straggler_dropped_mask"])
                 if "straggler_dropped_mask" in rec else None)
        logger.warning("Step %d: dropped %d straggler(s)%s, skew %.2fx",
                       rec["step"], int(rec["straggler_dropped"]),
                       f" (ranks {ranks})" if ranks is not None else "",
                       rec.get("straggler_skew", float("nan")))
        self.telemetry.emit(
            "straggler_drop", step=rec["step"],
            dropped=int(rec["straggler_dropped"]), ranks=ranks,
            skew=rec.get("straggler_skew"),
            slowest_rank=(int(rec["straggler_slowest_rank"])
                          if "straggler_slowest_rank" in rec else None))

    def _save_periodic(self, step: int, timer: PhaseTimer) -> None:
        """The checkpoint of ``step``: every rank joins the residuals'
        gather (topk) and, with ``overlap_eval``, snapshots its state for
        its eval thread; rank 0 hands the save to the async writer (the
        loop stalls for the snapshot), or writes it inline."""
        c = self.config
        if self.spmd:
            self._save_sharded(step, timer)
            return
        ef_rows = None
        if self.state.ef_state is not None:
            with timer.phase("checkpoint"):
                ef_rows = self._gather_ef()
        if self.rank != 0:
            if c.overlap_eval:
                from pytorch_distributed_nn_tpu_torch.training.async_ckpt \
                    import snapshot

                # this rank's own state, the residuals left out
                self._start_overlap_eval(step, snapshot(self.state, ()))
            return
        data_state = self._loader_state()
        if self._async_ckpt is not None:
            with timer.phase("checkpoint"):
                handle = self._async_ckpt.save(
                    self.state, step=step,
                    retain_device_state=c.overlap_eval,
                    data_state=data_state, fault_plan=self.fault_plan,
                    ef_rows=ef_rows)
            logger.info("Checkpoint step %d handed to the async writer "
                        "(loop stalled %.1f ms)", step, handle.stall_ms)
            if c.overlap_eval:
                self._start_overlap_eval(step, handle.dev_state, handle)
            return
        with timer.phase("checkpoint"):
            path = ckpt.save_checkpoint(c.train_dir, self.state, step=step,
                                        data_state=data_state,
                                        geometry=self._geometry,
                                        fault_plan=self.fault_plan,
                                        ef_rows=ef_rows)
        if c.keep_last is not None:
            ckpt.gc_checkpoints(c.train_dir, c.keep_last)
        logger.info("Checkpointed step %d to %s", step, path)

    def _save_sharded(self, step: Optional[int], timer=None) -> str:
        """A tp/sp run's checkpoint directory of ``step``: every rank
        writes its shard file (through its async writer, or inline);
        rank 0 commits, and GCs with ``keep_last``."""
        c = self.config
        data_state = self._loader_state() if self.rank == 0 else None
        phase = (timer.phase("checkpoint") if timer is not None
                 else contextlib.nullcontext())
        with phase:
            if self._async_ckpt is not None:
                handle = self._async_ckpt.save(self.state, step=step,
                                               data_state=data_state)
                logger.info("Checkpoint step %s handed to the async writer "
                            "(loop stalled %.1f ms)", step, handle.stall_ms)
                return ckpt.checkpoint_path(c.train_dir, handle.step)
            path = ckpt.save_sharded(c.train_dir, self.state, step=step,
                                     data_state=data_state,
                                     geometry=self._geometry)
        if c.keep_last is not None and self.rank == 0:
            ckpt.gc_checkpoints(c.train_dir, c.keep_last)
        logger.info("Checkpointed step %s to %s", step, path)
        return path

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

    def _start_overlap_eval(self, step: int, snap, handle=None) -> None:
        """The eval pass on the device snapshot ``snap`` of ``step`` (the
        async save ``handle``'s on rank 0), on a thread and (on the card)
        its own stream, while training goes on; its collectives over the
        eval group. Depth 1, as the writer: every rank joins its previous
        pass here, at the same boundary. Emits ``eval_result`` with
        ``source="overlap"``."""
        prev = self._overlap_eval_thread
        if prev is not None:
            prev.join()
        telemetry = self.telemetry
        if self.device.type == "cuda" and self._eval_stream is None:
            self._eval_stream = torch.cuda.Stream(self.device)

        def _run():
            try:
                with torch.cuda.stream(self._eval_stream) \
                        if self._eval_stream is not None \
                        else contextlib.nullcontext():
                    snap.wait(self._eval_stream)
                    out = run_eval_pass(self._overlap_eval_step,
                                        self._snapshot_state(snap),
                                        self.test_loader)
                if out:
                    seqs = getattr(self.test_loader, "eval_sequences", None)
                    telemetry.emit(
                        "eval_result", step=step,
                        loss=out["loss"], acc1=out["acc1"], acc5=out["acc5"],
                        sequences=seqs, source="overlap")
                    logger.info("Overlapped eval @ step %d: loss %.4f, "
                                "prec@1 %.4f, prec@5 %.4f", step,
                                out["loss"], out["acc1"], out["acc5"])
            except Exception:
                logger.exception("overlapped eval failed (non-fatal)")
            finally:
                if handle is not None:
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
        the two never race on one path. A topk run's residuals are
        gathered from every rank within ``EF_GATHER_TIMEOUT_S``; when a
        rank is gone the file holds none (a resume starts them at zero).
        Best effort: logged, not raised."""
        c = self.config
        try:
            self._finish_background_io(raise_errors=False)
        except Exception:
            logger.exception("async drain before emergency save failed")
        if self.spmd:  # collective: every rank writes its shards
            try:
                path = ckpt.save_sharded(c.train_dir, self.state,
                                         data_state=self._loader_state(),
                                         geometry=self._geometry)
                logger.info("Emergency checkpoint: %s", path)
                return path
            except Exception:
                logger.exception("emergency checkpoint failed")
                return None
        ef_rows = self._gather_ef(timeout_s=EF_GATHER_TIMEOUT_S)
        if self.rank != 0:
            return None
        try:
            path = ckpt.save_checkpoint(c.train_dir, self.state,
                                        data_state=self._loader_state(),
                                        geometry=self._geometry,
                                        fault_plan=self.fault_plan,
                                        ef_rows=ef_rows)
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
