"""The training flag surface: the port's own copy of the JAX package's
:class:`TrainConfig` (same fields, defaults and meanings)."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class TrainConfig:
    """The training flag surface, field for field the JAX package's
    ``TrainConfig`` (``training/config.py``), so a config moves across
    unchanged. The port's trainer runs every field, and raises where the
    JAX trainer refuses a value (``training/trainer.py:validate``)."""

    network: str = "ResNet18"
    dataset: str = "Cifar10"  # image dataset, or "MLMSynth" for text models
    batch_size: int = 128
    test_batch_size: int = 1000
    lr: float = 0.01
    # Step decay: lr * factor^(step // decay_steps). The reference had no
    # schedule at all (fixed lr for the whole run); the CIFAR accuracy
    # recipes need the decay for the last couple of points
    # (docs/RECIPES.md).
    lr_decay_steps: Optional[int] = None
    lr_decay_factor: float = 0.1
    # Linear lr warmup over the first N steps (0 = off) — composes with
    # the step decay; the standard large-vocab transformer stabilizer.
    warmup_steps: int = 0
    momentum: float = 0.9
    optimizer: str = "sgd"
    weight_decay: float = 0.0
    nesterov: bool = False
    max_steps: Optional[int] = None
    epochs: int = 1
    num_workers: Optional[int] = None  # data-parallel degree; None = all devices
    sync_mode: str = "allreduce"  # allreduce | ps | local
    num_aggregate: Optional[int] = None
    # Straggler mitigation (reference --mode/--kill-threshold): these
    # data-parallel ranks compute but never contribute to the aggregate
    # (parallel/grad_sync.GradSyncConfig.kill_ranks).
    kill_ranks: tuple = ()
    compression: str = "none"  # none | int8 | topk
    # Accumulate gradients over K microbatches per step (one sync +
    # optimizer update): K x less activation memory at the same effective
    # batch, on the shard_map (DP/PS) path; batch_size must divide
    # workers*K. Image models average uniform microbatch gradients; text
    # models accumulate exact (Σ masked-xent, Σ mask-count) pairs and
    # normalize once at the sync (ops.metrics.mlm_sums), so the MLM
    # global-masked-mean is preserved exactly.
    grad_accum: int = 1
    topk_ratio: float = 0.01
    bucket_bytes: Optional[int] = None  # bucketed collectives (C12 parity)
    eval_freq: int = 0  # 0 = no checkpointing
    train_dir: str = "./train_dir"
    # Checkpoints written while training goes on (training/async_ckpt.py):
    # the loop enqueues a device clone of the state on its stream and a
    # background thread copies it to the host, serialises, compresses and
    # publishes it, so the loop pays the clone (and a wait when the
    # previous write is still running) instead of the write, which the
    # host codec sets: on an H100 80GB HBM3 host about 3 s for ResNet-18
    # and 45 s for a BERT-base Adam state, against a 4-12 ms stall
    # (chip_smoke.py phase 7; PERF.md). Bytes are identical to the sync
    # path; emergency saves are always synchronous. Default on.
    async_ckpt: bool = True
    # Retention: after every successful publish, delete verified
    # checkpoints older than the newest N (never the resume target,
    # never unverified/corrupt evidence). None = keep everything.
    keep_last: Optional[int] = None
    # Run the periodic eval pass on the checkpoint snapshot in a
    # background thread instead of blocking the step loop (requires
    # async_ckpt + eval_freq; results land in the telemetry stream as
    # eval_result events with source="overlap").
    overlap_eval: bool = False
    resume: bool = False
    # Elastic resume (resilience/elastic.py, docs/resilience.md): by
    # default --resume adapts to a changed device fleet — when the newest
    # valid checkpoint's recorded geometry differs from the live one, a
    # legal mesh is re-derived (data-parallel degree shrinks K-of-N when
    # devices vanished, regrows on capacity; tp/sp stay as configured),
    # the GLOBAL batch is preserved (per-device batch rescales,
    # grad_accum lowered if the old microbatching no longer divides), the
    # state is reshard-on-loaded (checkpoint.restore_resharded) and a
    # typed `elastic_resume` event records old/new geometry.
    # strict_geometry=True keeps the exact-match contract: a detected
    # change raises up front, naming both geometries.
    strict_geometry: bool = False
    # Vocabulary-curriculum warm start (training/warm_start.py): path to a
    # FILE checkpoint whose model may have a SMALLER vocab/max_len than
    # this config's; trunk weights are copied, vocab-sized leaves take the
    # overlapping rows, optimizer starts cold. Mutually exclusive with
    # resume (resume restores this run's own geometry + optimizer state).
    warm_start: Optional[str] = None
    seed: int = 0
    bn_stats_sync: str = "mean"
    dtype: str = "float32"  # model compute dtype: float32 | bfloat16
    # "device" keeps the whole image dataset resident in HBM (uint8) and
    # builds batches on-device — per-step host->device traffic is a 4 KB
    # index array instead of ~13 MB of pixels (data/loader.DeviceDataLoader).
    # "host" is the classic prefetch-thread loader. "auto" = device when
    # the uint8 dataset fits a 2 GB HBM budget (all reference datasets
    # do), host past that.
    data_layout: str = "auto"  # auto | device | host
    # Host-layout loader: number of loader WORKER PROCESSES (the
    # reference's fork-worker capability, my_data_loader.py:37-53).
    # 0 = the single prefetch daemon thread. Only meaningful with
    # data_layout="host" (the device loader builds batches on-chip);
    # with data_path set it is the streaming loader's decode-thread
    # count instead.
    loader_workers: int = 0
    # Sharded streaming input (data/streaming.py, docs/data.md): path to
    # a shard directory written by `cli data export`. The training
    # stream is read from per-host file shards, decoded/augmented on
    # background threads and prefetched to device — datasets no longer
    # need to fit in RAM/HBM — and the loader's iterator state rides in
    # every checkpoint (`model_step_<N>.data.json`), so --resume
    # continues the exact batch sequence (chaos scenario data_resume).
    # None keeps the in-memory loaders. Eval/test data stays in-memory.
    data_path: Optional[str] = None
    # Streaming loader: depth of the ready-batch prefetch queue.
    # 0 = fully synchronous reads on the step loop (the "cold" path
    # bench.py --only input_stall measures).
    stream_prefetch: int = 2
    data_dir: str = "./data"
    synthetic_size: Optional[int] = None  # force synthetic data of this size
    metrics_path: Optional[str] = None
    log_every: int = 1
    profile_steps: int = 0  # trace this many steps with jax.profiler (0 = off)
    profile_dir: Optional[str] = None  # default: <train_dir>/profile
    # Text / MLM fields (active when `network` is a text model):
    seq_len: Optional[int] = None  # None = the model family's input_spec
    vocab_size: Optional[int] = None  # None = the model config's vocab
    mask_prob: float = 0.15
    corpus_branching: int = 8
    # MLM eval set size in batches of test_batch_size (fixed deterministic
    # snapshot; every reported accuracy covers eval_batches * test batch
    # sequences — data/text.MLMBatches.eval_set)
    eval_batches: int = 64
    attn_impl: str = "full"  # full | pallas (fused flash kernel)
    remat: bool = False  # text models: rematerialize encoder blocks
    fused_ln: bool = False  # text models: Pallas one-pass LayerNorm
    # Multi-dimensional parallelism (text models; the GSPMD path in
    # training/spmd.py). tp shards attention heads / MLP, sp shards the
    # sequence axis (ring or Ulysses attention). dp is num_workers (or
    # whatever devices remain). tp=sp=1 keeps the shard_map DP path with
    # its PS/compression modes; tp>1 or sp>1 requires sync_mode=allreduce
    # and compression in {none, int8} (int8 quantizes the dp gradient
    # sync inside the GSPMD step — training/spmd._int8_spmd_step).
    tensor_parallel: int = 1
    seq_parallel: int = 1
    seq_attn: str = "ring"  # ring | ulysses (when seq_parallel > 1)
    # --- Resilience (resilience/, docs/resilience.md) ---
    # Deterministic fault-injection spec, e.g.
    # "delay@120:p3:2.5s,crash@200,nan_grad@150,torn_ckpt@100"
    # (resilience/faults.FaultPlan grammar; steps are 1-indexed).
    faults: Optional[str] = None
    # Skip the optimizer update when the SYNCED gradient holds NaN/Inf
    # (train_step nonfinite_guard): params/opt/BN/EF keep their previous
    # values, the step is flagged in metrics. shard_map DP path only.
    skip_nonfinite: bool = False
    # Deadline-based straggler dropping (resilience/stragglers.py):
    # simulated per-rank arrival times; contributions slower than this
    # many (simulated) seconds are dropped and the aggregate renormalized
    # by the live count. None disables. shard_map DP path only.
    straggler_deadline: Optional[float] = None
    straggler_min_keep: int = 1  # fastest K always aggregate
    # Preemption-safe supervision (resilience/supervisor.py): SIGTERM/
    # SIGINT triggers an atomic emergency checkpoint + clean exit; the
    # trainer beats <train_dir>/heartbeat.json each step and, when
    # heartbeat_grace is set, a watchdog flags a stalled run.
    supervise: bool = False
    heartbeat_grace: Optional[float] = None  # seconds; None = no watchdog
    # Flight recorder (observability/flightrec.py, docs/observability.md):
    # detector spec ("default" or the detect.DetectorSpec grammar, e.g.
    # "step_regression:factor=2.5,stall,cooldown=100"). Detectors watch
    # the live telemetry bus; a convicted anomaly captures an incident
    # bundle (profiler trace window, event ring, manifest, env, report)
    # under <train_dir>/incidents/. None = off.
    flightrec: Optional[str] = None
