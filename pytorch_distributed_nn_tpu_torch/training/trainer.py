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
acc5, step_ms and ``images_per_sec`` or ``tokens_per_sec``;
``evaluate()`` scores the test split (images) or the fixed eval set
(text).

Every flag the port cannot honour yet raises, naming the ROADMAP item
that ports it (:data:`UNSUPPORTED`, :data:`TEXT_UNSUPPORTED`); none is
silently ignored. The trainer runs on the card unless ``device="cpu"`` is
given; without a card it raises, it never falls back to the CPU.

Weights are initialised from ``seed`` with a ``torch.Generator``: the
flax initialisation's scheme, not its numbers (JAX's PRNG differs).
"""

from __future__ import annotations

import json
import logging
import time
from typing import Dict, List

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
from pytorch_distributed_nn_tpu_torch.ops import kernels
from pytorch_distributed_nn_tpu_torch.optim import (
    build_optimizer,
    make_schedule,
)
from pytorch_distributed_nn_tpu_torch.parallel.grad_sync import (
    make_grad_sync,
)
from pytorch_distributed_nn_tpu_torch.parallel.mesh import init_group
from pytorch_distributed_nn_tpu_torch.training.config import TrainConfig
from pytorch_distributed_nn_tpu_torch.training.train_step import (
    build_eval_step,
    build_image_eval_step,
    build_image_train_step,
    build_train_step,
    create_train_state,
    param_count,
    run_eval_pass,
    sync_seed,
)
from pytorch_distributed_nn_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

_SYNC = "ROADMAP Queue 1 item 2 (gradient sync over torch.distributed)"
_SPMD = "ROADMAP Queue 1 item 1 (dp x tp x sp training)"
_DATA = "ROADMAP Queue 1 item 3 (data)"
_CKPT = "ROADMAP Queue 1 item 4 (checkpoint, trainer, evaluator)"

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
    "eval_freq": ((0,), _CKPT),
    "resume": ((False,), _CKPT),
    "keep_last": ((None,), _CKPT),
    "overlap_eval": ((False,), _CKPT),
    "faults": ((None,), _CKPT),
    "skip_nonfinite": ((False,), _CKPT),
    "supervise": ((False,), _CKPT),
    "heartbeat_grace": ((None,), _CKPT),
    "flightrec": ((None,), _CKPT),
    "profile_steps": ((0,), _CKPT),
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


class Trainer:
    def __init__(self, config: TrainConfig, device=None):
        c = self.config = config
        validate(c)
        self.device = resolve_device(device)
        self.is_text = is_text_model(c.network)
        schedule = make_schedule(c.lr, c.warmup_steps, c.lr_decay_steps,
                                 c.lr_decay_factor)

        def build_opt(params):
            return build_optimizer(
                c.optimizer, params, schedule, momentum=c.momentum,
                weight_decay=c.weight_decay, nesterov=c.nesterov)

        if self.is_text:
            self._init_text(build_opt)
        else:
            self._init_image(build_opt)
        # one record stream per run: rank 0 writes it
        self._metrics = (open(c.metrics_path, "a")
                         if c.metrics_path and self.rank == 0 else None)
        logger.info("Trainer: %s (%d params, %s) on %s, rank %d of %d",
                    c.network, param_count(self.model), c.dtype, self.device,
                    self.rank, self.n_workers)

    def _init_text(self, build_opt) -> None:
        c = self.config
        self.group, self.rank, self.n_workers = None, 0, 1
        model_kw = {"dtype": c.dtype}
        if c.vocab_size is not None:
            model_kw["vocab_size"] = c.vocab_size
        if c.seq_len is not None:
            model_kw["max_len"] = c.seq_len
        if c.fused_ln:
            model_kw["fused_ln"] = True
        if c.attn_impl == "pallas":
            model_kw["attn_fn"] = kernels.flash_attention
        self.model = build_model(c.network, **model_kw)
        self.model.init_weights(torch.Generator().manual_seed(c.seed))
        self.state = create_train_state(self.model, build_opt, self.device,
                                        seed=c.seed + 1)
        self.seq_len = c.seq_len or input_spec(c.network)[0]
        self.vocab_size = c.vocab_size or self.model.config.vocab_size
        self.train_step = build_train_step(grad_accum=c.grad_accum)
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

    def _init_image(self, build_opt) -> None:
        c = self.config
        self.group, self.device = init_group(self.device, c.num_workers)
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
        num_classes = 100 if c.dataset == "Cifar100" else 10
        self.model = build_model(c.network, num_classes, dtype=c.dtype)
        self.model.init_weights(torch.Generator().manual_seed(c.seed))
        # one dropout stream per rank, as the JAX step folds in the rank
        self.state = create_train_state(self.model, build_opt, self.device,
                                        seed=c.seed + 1 + 1_000_003 * self.rank)
        self.train_step = build_image_train_step(
            self.grad_sync, bn_stats_sync=c.bn_stats_sync,
            grad_accum=c.grad_accum)
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

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _log(self, record: dict) -> None:
        if self._metrics is not None:
            self._metrics.write(json.dumps(record) + "\n")
            self._metrics.flush()

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

    def train(self) -> List[dict]:
        """Run the steps; returns the per-step records. Metrics are read
        (one device sync) every ``log_every`` steps; a step's time is its
        window's wall time less the batch fetches, over the window's
        steps."""
        c = self.config
        per_epoch = self.train_loader.steps_per_epoch
        total = c.max_steps if c.max_steps is not None else per_epoch * c.epochs
        items = c.batch_size * (self.seq_len if self.is_text else 1)
        rate_key = "tokens_per_sec" if self.is_text else "images_per_sec"
        history: List[dict] = []
        pending: List[dict] = []
        window_t0, window_data = time.perf_counter(), 0.0

        def flush():
            nonlocal window_t0, window_data
            self._sync()
            step_s = max((time.perf_counter() - window_t0 - window_data)
                         / len(pending), 1e-9)
            for rec in pending:
                m = rec.pop("_metrics")
                rec.update({k: float(v) for k, v in m.items()})
                rec["step_ms"] = step_s * 1e3
                rec[rate_key] = items / step_s
                history.append(rec)
                self._log(rec)
            last = pending[-1]
            logger.info("Step: %d, Epoch: %d, Loss: %.4f, Prec@1: %.4f, "
                        "Prec@5: %.4f, StepTime: %.4f ms, %s: %.1f",
                        last["step"], last["epoch"], last["loss"],
                        last["acc1"], last["acc5"], last["step_ms"],
                        rate_key, last[rate_key])
            pending.clear()
            window_t0, window_data = time.perf_counter(), 0.0

        for step in range(total):
            t0 = time.perf_counter()
            batch = self.train_loader.next_batch()
            data_s = time.perf_counter() - t0
            window_data += data_s
            metrics = self.step(batch)
            pending.append({"step": step + 1, "epoch": step // per_epoch,
                            "_metrics": metrics, "data_time": data_s,
                            "input_wait_ms": self.train_loader.last_wait_ms})
            if (step + 1) % c.log_every == 0 or step + 1 == total:
                flush()
        return history

    def evaluate(self) -> Dict[str, float]:
        """Mean loss/acc1/acc5 over the test split (images) or the fixed
        eval set (text); ``{}`` when it is empty."""
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
        self._log({"eval": out, "step": self.state.step, unit: count})
        return out

    def close(self) -> None:
        self.train_loader.close()
        self.test_loader.close()
        if self._metrics is not None:
            self._metrics.close()
            self._metrics = None
