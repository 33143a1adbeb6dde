"""The collectives of tensor parallelism as autograd functions (Megatron's
f and g): what XLA's SPMD partitioner inserts around the JAX model's
column- and row-parallel matmuls.

- :func:`copy_to_group` (f): identity forward, a sum over the group in
  the backward. It stands before a column-parallel layer: the replicated
  input's gradient is the sum of every shard's contribution.
- :func:`reduce_from_group` (g): a sum over the group forward, identity
  backward. It follows a row-parallel layer (and the vocab-parallel
  embedding lookup): each shard holds a partial sum of the output.

A group of ``None`` (an axis of extent one) makes both the identity.
"""

from __future__ import annotations

import torch

from pytorch_distributed_nn_tpu_torch.parallel.mesh import all_reduce


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), "sum", ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _MaxFromGroup(torch.autograd.Function):
    """The max over the group, no gradient (a shift that cancels)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), "max", group)

    @staticmethod
    def backward(ctx, g):
        return None, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x
    return _ReduceFromGroup.apply(x, group)


def max_from_group(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x.detach()
    return _MaxFromGroup.apply(x.detach(), group)
