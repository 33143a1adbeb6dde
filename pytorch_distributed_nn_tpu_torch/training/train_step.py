"""The training step of the port, on one device: the counterpart of
``pytorch_distributed_nn_tpu/training/train_step.py`` for a single
replica.

One step is the forward, the masked-mean MLM loss, the backward, the
optimizer update and the metrics ``loss``/``acc1``/``acc5``. With
``grad_accum = K`` the batch splits into K microbatches whose
unnormalised sums (``ops.metrics.mlm_sums``: the masked cross-entropy
sum and the masked count) accumulate, and the gradient and the metrics
are divided once by the total count: the masked mean of the whole batch,
exactly, as the JAX step's ``pair_accum_fn`` path does. On one replica
the JAX package's data-parallel sync (``grad_sync``) is the identity.

The state is the model and its optimizer; the step updates both in
place (the JAX step returns a new state: PyTorch owns its buffers).
Metrics stay on the device as 0-d tensors until the caller reads them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from pytorch_distributed_nn_tpu_torch.ops.metrics import (
    masked_cross_entropy,
    mlm_metrics,
    mlm_sums,
)
from pytorch_distributed_nn_tpu_torch.optim import ScheduledOptimizer


@dataclasses.dataclass
class TrainState:
    """What the JAX ``TrainState`` holds, for one device: the model (its
    parameters; its dropout draws from a generator it holds) and the
    optimizer (its state and update count)."""

    model: torch.nn.Module
    optimizer: ScheduledOptimizer

    @property
    def step(self) -> int:
        return self.optimizer.count


def create_train_state(model: torch.nn.Module, build_opt: Callable,
                       device, seed: int = 0) -> TrainState:
    """Move ``model`` to ``device``, build its optimizer with
    ``build_opt(params)``, and seed a dropout generator on the device."""
    device = torch.device(device)
    model = model.to(device)
    model.set_dropout_generator(
        torch.Generator(device=device).manual_seed(seed))
    return TrainState(model, build_opt(model.parameters()))


def param_count(model: torch.nn.Module) -> int:
    return int(sum(p.numel() for p in model.parameters()))


def build_train_step(grad_accum: int = 1):
    """``step(state, batch) -> metrics``: one update of ``state`` in
    place from ``batch = (tokens, labels)``."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        tokens, labels = batch
        model, opt = state.model, state.optimizer
        model.train()
        opt.zero_grad()
        if grad_accum == 1:
            logits = model(tokens)
            loss = masked_cross_entropy(logits, labels)
            loss.backward()
            metrics = {"loss": loss.detach(),
                       **mlm_metrics(logits.detach(), labels)}
        else:
            n = tokens.shape[0]
            if n % grad_accum:
                raise ValueError(f"batch {n} not divisible by "
                                 f"grad_accum={grad_accum}")
            sums: Dict[str, torch.Tensor] = {}
            for tok, lab in zip(tokens.chunk(grad_accum),
                                labels.chunk(grad_accum)):
                s = mlm_sums(model(tok), lab)
                s["loss_sum"].backward()
                for k, v in s.items():
                    sums[k] = sums.get(k, 0) + v.detach()
            denom = sums["count"].clamp_min(1.0)
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(denom)
            metrics = {"loss": sums["loss_sum"] / denom,
                       **{k: v / denom for k, v in sums.items()
                          if k not in ("loss_sum", "count")}}
        opt.step()
        return metrics

    return step


def build_eval_step():
    """``eval_step(state, batch) -> metrics`` without gradients."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        tokens, labels = batch
        state.model.eval()
        logits = state.model(tokens)
        return {"loss": masked_cross_entropy(logits, labels),
                **mlm_metrics(logits, labels)}

    return eval_step


def run_eval_pass(eval_step, state: TrainState, loader) -> Dict[str, float]:
    """Mean loss/acc1/acc5 over ``loader.epoch_batches()``, summed on the
    device and read once; ``{}`` for an empty eval set."""
    totals, n = None, 0
    for batch in loader.epoch_batches():
        m = eval_step(state, batch)
        totals = m if totals is None else {k: totals[k] + m[k] for k in m}
        n += 1
    if n == 0:
        return {}
    return {k: float(v) / n for k, v in totals.items()}
