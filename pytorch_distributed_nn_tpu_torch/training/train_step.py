"""The training steps of the port: the counterpart of
``pytorch_distributed_nn_tpu/training/train_step.py``.

:func:`build_image_train_step` is the data-parallel image step (the JAX
``per_replica`` + ``_finish``): forward in train mode (BatchNorm on batch
statistics), cross-entropy, backward, the gradient sync over the process
group, the optimizer update, the BatchNorm running statistics reduced
across ranks (``mean``: their average; ``rank0``: rank 0's), and the
metrics averaged across ranks. Each rank holds the whole model and steps
on its slice of the global batch.

:func:`build_train_step` is the data-parallel MLM step of the text
models (the same JAX step with the global masked-mean loss and metrics):
the forward, the masked cross-entropy over the GLOBAL masked count
(``ops.metrics.make_global_masked_cross_entropy``: this rank's sum over
the mean count across ranks), the backward, the gradient sync, the
optimizer update and the metrics ``loss``/``acc1``/``acc5`` averaged over
the ranks. With ``grad_accum = K`` the batch splits into K microbatches
whose unnormalised sums (``ops.metrics.mlm_sums``: the masked
cross-entropy sum and the masked count) accumulate, and the gradient and
the metrics are divided once by the mean accumulated count over the
ranks: the masked mean of the whole global batch, exactly, as the JAX
step's ``pair_accum_fn`` path does. Without a ``grad_sync`` it is the
step of one device.

Both steps give the sync the step's seed and its 1-indexed number (the
straggler simulator's ``delay@N``), merge ``grad_sync.pop_report()``
into the metrics, and carry this rank's topk error-feedback residuals in
``TrainState.ef_state``.

The state is the model, its optimizer and the step count; the step
updates them in place (the JAX step returns a new state: PyTorch owns
its buffers). Metrics stay on the device as 0-d tensors until the caller
reads them.

Dropout draws from one generator on the device, re-seeded at every step
from (seed, rank, step) (:func:`dropout_seed`), as the JAX step folds its
dropout key with the rank and the step: a run resumed at step N draws at
step N + 1 what an uninterrupted run draws there, with nothing of the
generator in the checkpoint.

``nonfinite_guard`` (``--skip-nonfinite``, the JAX step's guard): when
the loss or a gradient (after the sync, so every rank decides alike) is
not finite, the update is skipped: parameters, optimizer state and count,
and BatchNorm statistics keep their values, the step count advances, and
the metrics carry ``skipped_nonfinite`` 1 (else 0). The error-feedback
residuals keep theirs too. The check reads one flag from the device each
step.

The image steps of a float32 model run with TF32 off
(:func:`..utils.precision.no_tf32`): PyTorch's cuDNN default would run
their convolutions with a 10-bit mantissa, where the JAX package's are
f32. The switches come back after each step; a bf16 model's steps leave
them alone.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from pytorch_distributed_nn_tpu_torch.ops.metrics import (
    cross_entropy_loss,
    make_global_masked_cross_entropy,
    make_global_mlm_metrics,
    mean_count,
    mlm_sums,
    topk_accuracy,
)
from pytorch_distributed_nn_tpu_torch.ops.reference import f32_reciprocal
from pytorch_distributed_nn_tpu_torch.optim import ScheduledOptimizer
from pytorch_distributed_nn_tpu_torch.parallel.mesh import (
    all_reduce,
    rank,
    world_size,
)
from pytorch_distributed_nn_tpu_torch.resilience.faults import all_finite
from pytorch_distributed_nn_tpu_torch.utils.precision import f32_context


@dataclasses.dataclass
class TrainState:
    """What the JAX ``TrainState`` holds, for one device: the model (its
    parameters and BatchNorm statistics), the optimizer (its state and
    update count, which a skipped step leaves alone) and the step count;
    and the dropout generator the model draws from, with the seed and
    rank it is re-seeded from at every step. ``ef_state`` is this rank's
    topk error-feedback residuals, one per parameter in
    ``model.parameters()`` order (``None`` without topk): the JAX state's
    ``ef_state`` row of this replica, of ``replicas`` (the data-parallel
    degree; checkpoints stack every replica's row)."""

    model: torch.nn.Module
    optimizer: ScheduledOptimizer
    step: int = 0
    dropout_generator: Optional[torch.Generator] = None
    seed: int = 0
    rank: int = 0
    ef_state: Optional[List[torch.Tensor]] = None
    replicas: int = 1
    #: the (data, seq, model) mesh of a tp/sp state (training/spmd.py):
    #: the model holds this rank's regions; ``None`` elsewhere
    mesh: Any = None


def create_train_state(model: torch.nn.Module, build_opt: Callable,
                       device, seed: int = 0, rank: int = 0,
                       grad_sync=None) -> TrainState:
    """Move ``model`` to ``device``, build its optimizer with
    ``build_opt(params)``, and give it a dropout generator on the device
    that each step re-seeds from ``(seed, rank, step)``; and, given a
    ``grad_sync`` with topk compression, zero residuals. On the meta
    device (the cost walk's) the generator is a CPU one: the meta
    device has none, and meta draws take any generator."""
    device = torch.device(device)
    model = model.to(device)
    gen = torch.Generator(device="cpu" if device.type == "meta" else device)
    model.set_dropout_generator(gen)
    ef, replicas = None, 1
    if grad_sync is not None:
        ef = grad_sync.init_state(model.parameters())
        replicas = world_size(grad_sync.group)
    return TrainState(model, build_opt(model.parameters()),
                      dropout_generator=gen, seed=seed, rank=rank,
                      ef_state=ef, replicas=replicas)


def dropout_seed(seed: int, rank: int, step: int) -> int:
    """The dropout generator's seed at a step: a function of (seed, rank,
    step) alone, another for every rank and every step (the JAX step's
    ``fold_in(fold_in(key, rank), step)``)."""
    words = np.random.SeedSequence([int(seed), int(rank), int(step)]) \
        .generate_state(2, np.uint64)
    return int(words[0] >> np.uint64(1))


def _seed_dropout(state: TrainState) -> None:
    if state.dropout_generator is not None:
        state.dropout_generator.manual_seed(
            dropout_seed(state.seed, state.rank, state.step))


def param_count(model: torch.nn.Module) -> int:
    return int(sum(p.numel() for p in model.parameters()))


def build_train_step(grad_sync=None, grad_accum: int = 1,
                     nonfinite_guard: bool = False):
    """``step(state, batch, seed=0) -> metrics``: one update of ``state``
    in place from this rank's ``batch = (tokens, labels)``, with the
    step's sync ``seed`` (:func:`sync_seed`); without ``grad_sync``, one
    device and no sync."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    group = None if grad_sync is None else grad_sync.group
    loss_fn = make_global_masked_cross_entropy(group)
    metrics_fn = make_global_mlm_metrics(group)

    def step(state: TrainState, batch, seed: int = 0
             ) -> Dict[str, torch.Tensor]:
        tokens, labels = batch
        model, opt = state.model, state.optimizer
        model.train()
        _seed_dropout(state)
        opt.zero_grad()
        if grad_accum == 1:
            logits = model(tokens)
            loss = loss_fn(logits, labels)
            loss.backward()
            metrics = {"loss": loss.detach(),
                       **metrics_fn(logits.detach(), labels)}
        else:
            n = tokens.shape[0]
            if n % grad_accum:
                raise ValueError(f"per-replica batch {n} not divisible by "
                                 f"grad_accum={grad_accum}")
            sums: Dict[str, torch.Tensor] = {}
            for tok, lab in zip(tokens.chunk(grad_accum),
                                labels.chunk(grad_accum)):
                s = mlm_sums(model(tok), lab)
                s["loss_sum"].backward()
                for k, v in s.items():
                    sums[k] = sums.get(k, 0) + v.detach()
            # the mean accumulated count over the ranks: the mean of the
            # ranks' gradients is then global sum / global count
            denom = mean_count(sums["count"], group)
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(denom)
            metrics = {"loss": sums["loss_sum"] / denom,
                       **{k: v / denom for k, v in sums.items()
                          if k not in ("loss_sum", "count")}}
        metrics = _mean_over_ranks(metrics, group)
        ok = _sync_and_check(state, grad_sync, seed, metrics,
                             nonfinite_guard, tokens.device)
        if ok:
            opt.step()
        state.step += 1
        return metrics

    return step


def _sync_and_check(state: TrainState, grad_sync, seed: int,
                    metrics: Dict, nonfinite_guard: bool, device) -> bool:
    """The shared tail of both steps: this rank's gradients (``p.grad``)
    through ``grad_sync`` with its residuals, the step's number and seed;
    the report merged into ``metrics``; and the non-finite guard over the
    rank-mean loss and the synced gradients (every rank decides alike).
    The residuals move on only when the update is taken. Returns whether
    it is."""
    params = list(state.model.parameters())
    idx = [i for i, p in enumerate(params) if p.grad is not None]
    new_ef = None
    if grad_sync is not None:
        ef = state.ef_state
        synced, new_ef = grad_sync(
            [params[i].grad for i in idx],
            None if ef is None else [ef[i] for i in idx], seed,
            step=state.step + 1)
        for i, g in zip(idx, synced):
            params[i].grad = g
        metrics.update(grad_sync.pop_report())
    ok = True
    if nonfinite_guard:
        ok = all_finite([metrics["loss"]] + [params[i].grad for i in idx])
        metrics["skipped_nonfinite"] = torch.tensor(0.0 if ok else 1.0,
                                                    device=device)
    if ok and new_ef is not None:
        for i, e in zip(idx, new_ef):
            state.ef_state[i] = e
    return ok


def sync_seed(seed: int, step: int) -> int:
    """The gradient sync's seed of one step: the same on every rank (the
    JAX step folds its sync key with the step, not the rank, so every
    replica draws the same arrival order and quantization noise) and
    another at every step."""
    return int(np.random.SeedSequence([int(seed), int(step)])
               .generate_state(1)[0])


def _classification_metrics(logits, labels) -> Dict[str, torch.Tensor]:
    acc1, acc5 = topk_accuracy(logits, labels, (1, 5))
    return {"acc1": acc1, "acc5": acc5}


def _mean_over_ranks(metrics: Dict[str, torch.Tensor], group):
    """Every metric averaged over the ranks, in one collective."""
    if group is None:
        return metrics
    keys = sorted(metrics)
    packed = torch.stack([metrics[k].float() for k in keys])
    all_reduce(packed, "sum", group)
    packed.mul_(f32_reciprocal(world_size(group)))
    return dict(zip(keys, packed.unbind()))


def bn_reduce(model: torch.nn.Module, mode: str, group) -> None:
    """The JAX ``_bn_reduce`` of the BatchNorm running statistics, in
    place: ``mean`` averages them over the ranks, ``rank0`` gives every
    rank rank 0's."""
    if mode not in ("mean", "rank0"):
        raise ValueError(f"unknown bn_stats_sync {mode!r}")
    if group is None:
        return
    keep = float(rank(group) == 0)
    recip = f32_reciprocal(world_size(group))  # lax.pmean's product
    for buf in model.buffers():
        if mode == "mean":
            all_reduce(buf, "sum", group)
            buf.mul_(recip)
        else:
            buf.mul_(keep)
            all_reduce(buf, "sum", group)


def build_image_train_step(grad_sync, bn_stats_sync: str = "mean",
                           grad_accum: int = 1,
                           nonfinite_guard: bool = False):
    """``step(state, batch, seed) -> metrics``: one data-parallel update of
    ``state`` in place from this rank's ``batch = (images, labels)``, with
    the step's sync ``seed`` (:func:`sync_seed`); without ``grad_sync``,
    one device and no sync. ``grad_accum = K`` splits
    the batch into K microbatches whose gradients are summed and divided
    by K before the one sync (BatchNorm statistics move once per
    microbatch, as K small steps would move them)."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    group = None if grad_sync is None else grad_sync.group

    def step(state: TrainState, batch, seed: int) -> Dict[str, torch.Tensor]:
        with f32_context(state.model):
            return _step(state, batch, seed)

    def _step(state: TrainState, batch, seed: int):
        images, labels = batch
        model, opt = state.model, state.optimizer
        model.train()
        _seed_dropout(state)
        opt.zero_grad()
        stats = ([b.clone() for b in model.buffers()] if nonfinite_guard
                 else None)
        n = images.shape[0]
        if n % grad_accum:
            raise ValueError(f"per-replica batch {n} not divisible by "
                             f"grad_accum={grad_accum}")
        ms = []
        for im, lb in zip(images.chunk(grad_accum), labels.chunk(grad_accum)):
            logits = model(im)
            loss = cross_entropy_loss(logits, lb)
            loss.backward()
            ms.append({"loss": loss.detach(),
                       **_classification_metrics(logits.detach(), lb)})
        if grad_accum > 1:
            for p in model.parameters():
                if p.grad is not None:
                    p.grad = p.grad / grad_accum
        metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        metrics = _mean_over_ranks(metrics, group)
        ok = _sync_and_check(state, grad_sync, seed, metrics,
                             nonfinite_guard, images.device)
        if ok:
            opt.step()
            bn_reduce(model, bn_stats_sync, group)
        else:
            with torch.no_grad():
                for b, old in zip(model.buffers(), stats):
                    b.copy_(old)
        state.step += 1
        return metrics

    return step


def build_image_eval_step(group):
    """``eval_step(state, batch) -> metrics`` of the image models: eval
    mode (BatchNorm on running statistics), averaged over the ranks."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        images, labels = batch
        state.model.eval()
        with f32_context(state.model):
            logits = state.model(images)
        return _mean_over_ranks(
            {"loss": cross_entropy_loss(logits, labels),
             **_classification_metrics(logits, labels)}, group)

    return eval_step


def build_eval_step(group=None):
    """``eval_step(state, batch) -> metrics`` of the text models without
    gradients: this rank's share of the batch, the global masked mean
    over the ranks of ``group`` (one device without one)."""
    loss_fn = make_global_masked_cross_entropy(group)
    metrics_fn = make_global_mlm_metrics(group)

    @torch.no_grad()
    def eval_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        tokens, labels = batch
        state.model.eval()
        logits = state.model(tokens)
        return _mean_over_ranks({"loss": loss_fn(logits, labels),
                                 **metrics_fn(logits, labels)}, group)

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


def dp_audit_bundle(model: torch.nn.Module, build_opt: Callable, grad_sync,
                    input_shape, global_batch: int, text: bool = False,
                    seed: int = 0, **build_kw) -> dict:
    """The data-parallel step of the cost walk (the JAX
    ``dp_audit_bundle``, :mod:`..analysis.costmodel`): ``model`` (built
    on the meta device, or moved there), its optimizer from
    ``build_opt``, and the step of its family (:func:`build_train_step`
    for a text model, :func:`build_image_train_step` else, with
    ``build_kw``) over ``grad_sync``'s group (a fake group on the meta
    device; ``None``: one device, no sync), on this rank's rows of
    ``global_batch`` inputs of ``input_shape`` (f32 images NHWC, or
    int64 token ids). Returns ``{"step_fn", "args", "params"}``: the walk
    runs ``step_fn(*args)``."""
    n = 1 if grad_sync is None else world_size(grad_sync.group)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"dp={n}")
    state = create_train_state(model, build_opt, "meta", seed=seed,
                               rank=rank(None if grad_sync is None
                                         else grad_sync.group),
                               grad_sync=grad_sync)
    rows = global_batch // n
    if text:
        step = build_train_step(grad_sync, **build_kw)
        tok = torch.zeros((rows, *input_shape), dtype=torch.int64,
                          device="meta")
        batch = (tok, tok)
    else:
        step = build_image_train_step(grad_sync, **build_kw)
        batch = (torch.zeros((rows, *input_shape), device="meta"),
                 torch.zeros((rows,), dtype=torch.int64, device="meta"))
    return {"step_fn": step, "args": (state, batch, sync_seed(seed + 1, 0)),
            "params": list(state.model.parameters())}
