"""Losses and metrics: the port of ``cross_entropy_loss``,
``topk_accuracy`` and the masked-LM part of
``pytorch_distributed_nn_tpu/ops/metrics.py``.

The "global" MLM forms (:func:`make_global_masked_cross_entropy`,
:func:`make_global_mlm_metrics`) divide each rank's sums by the mean
masked count over the ranks of a process group (one ``all_reduce`` of the
count), so that the mean over the ranks of their values, and of their
gradients, is the global masked mean. On one rank they are the local
forms.

:func:`vocab_parallel_sums` is :func:`mlm_sums` of logits split over
the vocabulary across the model group (tensor parallelism), without
gathering the ``(B * L, V)`` f32 logits, the step's largest tensor:
Megatron's vocab-parallel cross-entropy (the row max, the sum of
exponentials and the target's logit each reduced over the group), and
top-k hits by rank counting (the number of logits at or above the
label's, summed over the group): the tie conventions of
:func:`in_top_k`, exactly.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from pytorch_distributed_nn_tpu_torch.ops.reference import f32_reciprocal
from pytorch_distributed_nn_tpu_torch.parallel.mesh import (
    all_reduce,
    world_size,
)
from pytorch_distributed_nn_tpu_torch.parallel.tensor_parallel import (
    max_from_group,
    reduce_from_group,
)

#: label sentinel for positions outside the masked objective
IGNORE_INDEX = -1


def _mask_and_safe(labels: torch.Tensor, ignore_index: int):
    mask = labels != ignore_index
    return mask.to(torch.float32), torch.where(mask, labels,
                                               torch.zeros_like(labels))


def _token_losses(logits: torch.Tensor, safe: torch.Tensor) -> torch.Tensor:
    V = logits.shape[-1]
    return F.cross_entropy(logits.reshape(-1, V).float(),
                           safe.reshape(-1).long(),
                           reduction="none").reshape(safe.shape)


def in_top_k(logits: torch.Tensor, labels: torch.Tensor,
             k: int) -> torch.Tensor:
    """Is each label among the k highest logits? (f32 0/1 per position.)

    Rank counting with the JAX package's ``_in_top_k`` conventions: ties
    count against the label (all-equal logits score 0), and a non-finite
    label logit is never a hit."""
    label_logit = torch.gather(logits, -1, labels[..., None].long())
    n_above = (logits >= label_logit).sum(dim=-1) - 1
    hit = (n_above < k) & torch.isfinite(label_logit[..., 0])
    return hit.to(torch.float32)


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over integer labels, f32 (optax's
    ``softmax_cross_entropy_with_integer_labels(...).mean()``)."""
    return F.cross_entropy(logits.float(), labels.long())


@torch.no_grad()
def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                  topk=(1, 5)):
    """Fraction of samples whose label is among the k highest logits, for
    each k (rank counting, the JAX package's tie conventions)."""
    return tuple(in_top_k(logits, labels, k).mean() for k in topk)


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    """Mean softmax cross-entropy over positions where ``labels !=
    ignore_index``: logits (B, L, V) f32, labels (B, L)."""
    mask, safe = _mask_and_safe(labels, ignore_index)
    losses = _token_losses(logits, safe)
    return (losses * mask).sum() / mask.sum().clamp_min(1.0)


@torch.no_grad()
def mlm_metrics(logits: torch.Tensor, labels: torch.Tensor,
                ignore_index: int = IGNORE_INDEX) -> Dict[str, torch.Tensor]:
    """acc1 / acc5 over the masked positions (hits over max(count, 1))."""
    mask, safe = _mask_and_safe(labels, ignore_index)
    count = mask.sum().clamp_min(1.0)
    return {f"acc{k}": (in_top_k(logits, safe, k) * mask).sum() / count
            for k in (1, 5)}


def mean_count(count: torch.Tensor, group) -> torch.Tensor:
    """max(the mean over the ranks of ``group`` of their masked
    ``count``s, 1): the JAX ``lax.pmean(count)`` (a sum, then a product
    with the world size's f32 reciprocal), one ``all_reduce``."""
    if group is not None:
        count = all_reduce(count.detach().clone(), "sum", group)
        count = count * f32_reciprocal(world_size(group))
    return count.clamp_min(1.0)


def make_global_masked_cross_entropy(group):
    """Masked cross-entropy over the GLOBAL masked count: this rank's sum
    of masked token losses over :func:`mean_count`. Per-rank counts
    differ; dividing by the mean count makes the mean of the ranks'
    gradients the gradient of global sum / global count."""

    def loss(logits, labels, ignore_index: int = IGNORE_INDEX):
        mask, safe = _mask_and_safe(labels, ignore_index)
        return (_token_losses(logits, safe) * mask).sum() \
            / mean_count(mask.sum(), group)

    return loss


def make_global_mlm_metrics(group):
    """acc1 / acc5 over the GLOBAL masked count: this rank's hits over
    :func:`mean_count`, so the mean over the ranks is global hits over
    global count."""

    @torch.no_grad()
    def metrics(logits, labels, ignore_index: int = IGNORE_INDEX):
        mask, safe = _mask_and_safe(labels, ignore_index)
        count = mean_count(mask.sum(), group)
        return {f"acc{k}": (in_top_k(logits, safe, k) * mask).sum() / count
                for k in (1, 5)}

    return metrics


def mlm_sums(logits: torch.Tensor, labels: torch.Tensor,
             ignore_index: int = IGNORE_INDEX) -> Dict[str, torch.Tensor]:
    """Unnormalised sums for exact gradient accumulation:
    ``loss_sum`` (differentiable), ``count`` and the acc1/acc5 hit counts.
    Divided once by the accumulated count, they reproduce the masked mean
    of the whole batch exactly."""
    mask, safe = _mask_and_safe(labels, ignore_index)
    out = {"loss_sum": (_token_losses(logits, safe) * mask).sum(),
           "count": mask.sum()}
    with torch.no_grad():
        for k in (1, 5):
            out[f"acc{k}"] = (in_top_k(logits, safe, k) * mask).sum()
    return out


def vocab_parallel_sums(logits: torch.Tensor, labels: torch.Tensor,
                        vocab_start: int = 0, group=None,
                        ignore_index: int = IGNORE_INDEX
                        ) -> Dict[str, torch.Tensor]:
    """:func:`mlm_sums` of ``logits`` (B, L, V_local), this rank's slice
    of the vocabulary from id ``vocab_start``, over the model ``group``
    (``None``: the whole vocabulary is here, :func:`mlm_sums`). Every
    rank of the group gets the same sums; ``loss_sum``'s gradient reaches
    this rank's logits only."""
    if group is None:
        return mlm_sums(logits, labels, ignore_index)
    mask, safe = _mask_and_safe(labels, ignore_index)
    lf = logits.float()
    local = safe.long() - vocab_start
    hit = (local >= 0) & (local < lf.shape[-1])
    idx = torch.where(hit, local, torch.zeros_like(local))[..., None]
    shifted = lf - max_from_group(lf.amax(dim=-1), group)[..., None]
    zero = torch.zeros((), dtype=lf.dtype, device=lf.device)
    target = reduce_from_group(
        torch.where(hit, torch.gather(shifted, -1, idx)[..., 0], zero), group)
    sumexp = reduce_from_group(torch.exp(shifted).sum(dim=-1), group)
    out = {"loss_sum": ((torch.log(sumexp) - target) * mask).sum(),
           "count": mask.sum()}
    with torch.no_grad():
        label_logit = all_reduce(
            torch.where(hit, torch.gather(lf, -1, idx)[..., 0], zero),
            "sum", group)
        above = all_reduce((lf >= label_logit[..., None]).sum(dim=-1)
                           .to(torch.float32), "sum", group) - 1
        finite = torch.isfinite(label_logit)
        for k in (1, 5):
            out[f"acc{k}"] = (((above < k) & finite).to(torch.float32)
                              * mask).sum()
    return out
