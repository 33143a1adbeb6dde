"""Masked-LM loss and metrics: the port of the MLM part of
``pytorch_distributed_nn_tpu/ops/metrics.py``.

On one replica the JAX package's "global" forms
(``make_global_masked_cross_entropy``, ``make_global_mlm_metrics``:
local sums over the mean count across replicas) are the local forms
here: the count of one replica is the global count.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

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
