"""Single-device MLM training of the transformer family: the port of
``pytorch_distributed_nn_tpu/training/trainer.py`` for text models on one
card.

``Trainer(config)`` validates the config as the JAX trainer does, for
the subset the port runs, builds the model (``attn_impl="pallas"`` ->
the hand-written flash kernel, ``"full"`` -> plain attention in PyTorch,
what XLA ran; ``fused_ln`` is accepted: the port's one LayerNorm is the
kernel), the optimizer with its schedule, and the synthetic MLM loaders.
``train()`` runs ``max_steps`` steps (or ``epochs`` nominal epochs of
100 steps) and returns one record per step: step, loss, acc1, acc5,
step_ms, tokens_per_sec; ``evaluate()`` scores the fixed eval set.

Every flag the port cannot honour yet raises, naming the ROADMAP item
that ports it (:data:`UNSUPPORTED`); none is silently ignored.
Checkpoints, resume, the flight recorder and the supervisor come with
that item. The trainer runs on the card unless ``device="cpu"`` is
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
from pytorch_distributed_nn_tpu_torch.training.config import TrainConfig
from pytorch_distributed_nn_tpu_torch.training.train_step import (
    build_eval_step,
    build_train_step,
    create_train_state,
    param_count,
    run_eval_pass,
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
    "num_workers": ((None, 1), _SYNC),
    "num_aggregate": ((None,), _SYNC),
    "kill_ranks": (((),), _SYNC),
    "compression": (("none",), _SYNC),
    "bucket_bytes": ((None,), _SYNC),
    "straggler_deadline": ((None,), _SYNC),
    "sync_mode": (("allreduce", "local"), _SYNC),
    "tensor_parallel": ((1,), _SPMD),
    "seq_parallel": ((1,), _SPMD),
    "remat": ((False,), _SPMD),
    "warm_start": ((None,), _SPMD),
    "data_path": ((None,), _DATA),
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


def validate(c: TrainConfig) -> None:
    """Raise on what the port's trainer does not run (yet)."""
    for field, (allowed, item) in UNSUPPORTED.items():
        value = getattr(c, field)
        if value not in allowed:
            raise NotImplementedError(
                f"{field}={value!r} is not ported yet: {item}")
    if not is_text_model(c.network):
        raise NotImplementedError(
            f"network {c.network!r}: the port trains the transformer family "
            f"only; the CNNs come with {_SYNC}")
    if c.dataset != "MLMSynth":
        raise ValueError(f"text model {c.network!r} requires "
                         f"dataset='MLMSynth' (got {c.dataset!r})")
    if c.dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown dtype {c.dtype!r}")
    if c.attn_impl not in ("full", "pallas"):
        raise ValueError(f"unknown attn_impl {c.attn_impl!r}")
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
        schedule = make_schedule(c.lr, c.warmup_steps, c.lr_decay_steps,
                                 c.lr_decay_factor)
        self.state = create_train_state(
            self.model,
            lambda params: build_optimizer(
                c.optimizer, params, schedule, momentum=c.momentum,
                weight_decay=c.weight_decay, nesterov=c.nesterov),
            self.device, seed=c.seed + 1,
        )
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
        self._metrics = open(c.metrics_path, "a") if c.metrics_path else None
        logger.info("Trainer: %s (%d params, %s, attn %s) on %s",
                    c.network, param_count(self.model), c.dtype, c.attn_impl,
                    self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _log(self, record: dict) -> None:
        if self._metrics is not None:
            self._metrics.write(json.dumps(record) + "\n")
            self._metrics.flush()

    def train(self) -> List[dict]:
        """Run the steps; returns the per-step records. Metrics are read
        (one device sync) every ``log_every`` steps; a step's time is its
        window's wall time less the batch fetches, over the window's
        steps."""
        c = self.config
        per_epoch = self.train_loader.steps_per_epoch
        total = c.max_steps if c.max_steps is not None else per_epoch * c.epochs
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
                rec["tokens_per_sec"] = c.batch_size * self.seq_len / step_s
                history.append(rec)
                self._log(rec)
            last = pending[-1]
            logger.info("Step: %d, Epoch: %d, Loss: %.4f, Prec@1: %.4f, "
                        "Prec@5: %.4f, StepTime: %.4f ms, tokens/s: %.1f",
                        last["step"], last["epoch"], last["loss"],
                        last["acc1"], last["acc5"], last["step_ms"],
                        last["tokens_per_sec"])
            pending.clear()
            window_t0, window_data = time.perf_counter(), 0.0

        for step in range(total):
            t0 = time.perf_counter()
            batch = self.train_loader.next_batch()
            data_s = time.perf_counter() - t0
            window_data += data_s
            metrics = self.train_step(self.state, batch)
            pending.append({"step": step + 1, "epoch": step // per_epoch,
                            "_metrics": metrics, "data_time": data_s,
                            "input_wait_ms": self.train_loader.last_wait_ms})
            if (step + 1) % c.log_every == 0 or step + 1 == total:
                flush()
        return history

    def evaluate(self) -> Dict[str, float]:
        """Mean loss/acc1/acc5 over the fixed eval set (``eval_batches``
        batches of ``test_batch_size``); ``{}`` when it is empty."""
        out = run_eval_pass(self.eval_step, self.state, self.test_loader)
        if not out:
            logger.info("Validation skipped: eval set is empty")
            return {}
        logger.info("Validation: loss %.4f, prec@1 %.4f, prec@5 %.4f "
                    "(%d sequences)", out["loss"], out["acc1"], out["acc5"],
                    self.test_loader.eval_sequences)
        self._log({"eval": out, "step": self.state.step,
                   "sequences": self.test_loader.eval_sequences})
        return out

    def close(self) -> None:
        self.train_loader.close()
        self.test_loader.close()
        if self._metrics is not None:
            self._metrics.close()
            self._metrics = None
