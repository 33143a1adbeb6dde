"""Gradient compression fused around the collective, over
``torch.distributed``: the port of ``psum_mean``, ``_int8_quantize_leaf``
and ``int8_psum_mean`` of ``pytorch_distributed_nn_tpu/ops/compression.py``,
plus the host-side int8 weight codec of serving artifacts
(``quantize_int8_host`` for the exporter, ``dequantize_int8_host`` for the
reader).

``int8``: stochastic-rounded int8 quantization with a scale shared across
ranks (one ``all_reduce(MAX)`` of the vector of every leaf's amax, the JAX
per-leaf ``lax.pmax``), so the ranks' int8 payloads are summable; the
payload is cast to int32 before the ``all_reduce(SUM)``, as the JAX
package casts before its psum.

Leaves of at least :data:`QUANT_KERNEL_MIN_SIZE` elements are quantized
together by ``quantize_int8_scaled_group`` (one launch of the hand-written
kernel on CUDA tensors, its plain version on CPU tensors); smaller ones by
the small-leaf formula ``floor(x * 127 / amax) + (u < frac)`` on either
device. That threshold is
the JAX package's own dispatch rule (its TPU program sends the large leaves
to the Pallas kernel), not a fallback. Both are unbiased stochastic
rounding; they are different realisations of it.

Collectives take the process group explicitly (``group``, from
:mod:`..parallel.mesh`); ``group=None`` is the JAX ``axis_name=None``
single-contributor mode: the same codec arithmetic with no collective.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from pytorch_distributed_nn_tpu_torch.ops import kernels
from pytorch_distributed_nn_tpu_torch.ops.reference import (
    RECIP127,
    f32_reciprocal,
)
from pytorch_distributed_nn_tpu_torch.parallel.mesh import (
    all_reduce,
    world_size,
)

#: leaves at least this large take ``quantize_int8_scaled_group`` (the JAX
#: package's ``_PALLAS_QUANT_MIN_SIZE``)
QUANT_KERNEL_MIN_SIZE = 16384


def psum_mean(grads: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Plain full-precision gradient averaging: the sum over the ranks
    divided by their number (``lax.pmean``)."""
    recip = f32_reciprocal(world_size(group))
    out = [g.clone() for g in grads]
    for g in out:
        all_reduce(g, "sum", group)
        g.mul_(recip)
    return out


def leaf_noise(shape, seed: int, device) -> torch.Tensor:
    """u ~ U[0, 1) f32 of the small-leaf formula, from a generator on
    ``device`` seeded with ``seed`` (the same draws on every rank of one
    device type)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.rand(shape, generator=gen, device=device,
                      dtype=torch.float32)


def quantize_small_leaf(g: torch.Tensor, amax: torch.Tensor,
                        u: torch.Tensor) -> torch.Tensor:
    """The small-leaf formula of ``_int8_quantize_leaf``: scaled =
    g * (127 / amax) (0 when amax is 0), ``floor(scaled) + (u < frac)``,
    clipped to [-127, 127], int8."""
    # a true division (a traced divisor in XLA); ``127.0 / amax`` would be
    # torch's reciprocal-then-multiply
    scale = torch.where(amax > 0, torch.full_like(amax, 127.0) / amax,
                        torch.zeros_like(amax))
    scaled = g.float() * scale
    floor = torch.floor(scaled)
    q = floor + (u < scaled - floor).to(torch.float32)
    return q.clamp(-127, 127).to(torch.int8)


def quantize_leaves(grads: Sequence[torch.Tensor], seeds: Sequence[int],
                    amax: torch.Tensor,
                    group_quantizer=None) -> List[torch.Tensor]:
    """``_int8_quantize_leaf`` of every leaf: g_i -> int8 of g_i's shape,
    ``amax`` a (k,) f32 vector on the leaves' device with amax[i] >=
    max|g_i|. The leaves of at least :data:`QUANT_KERNEL_MIN_SIZE` elements
    go together to ``group_quantizer`` (default
    :func:`.kernels.quantize_int8_scaled_group`: one launch on the card)
    with scale amax / 127 (as ``amax * f32(1/127)``; 1 when amax is 0,
    where g is all zero and q is 0 either way); the others take the
    small-leaf formula."""
    scales = torch.where(amax > 0, amax * RECIP127, torch.ones_like(amax))
    big = [i for i, g in enumerate(grads)
           if g.numel() >= QUANT_KERNEL_MIN_SIZE]
    out: List[Optional[torch.Tensor]] = [None] * len(grads)
    if big:
        quantizer = group_quantizer or kernels.quantize_int8_scaled_group
        qs = quantizer([grads[i].float() for i in big],
                       [scales[i] for i in big], [seeds[i] for i in big])
        for i, q in zip(big, qs):
            out[i] = q
    for i, g in enumerate(grads):
        if out[i] is None:
            out[i] = quantize_small_leaf(
                g, amax[i], leaf_noise(g.shape, seeds[i], g.device))
    return out


def leaf_seeds(seed: int, count: int) -> List[int]:
    """``count`` 32-bit seeds, one per leaf, from one sync seed: the same
    on every rank (the JAX ``jax.random.split(key, len(leaves))``)."""
    return [int(s) for s in
            np.random.SeedSequence(int(seed)).generate_state(count)]


def int8_psum_mean(grads: Sequence[torch.Tensor], seed: int, group,
                   mask: Optional[float] = None,
                   denom: Optional[float] = None,
                   group_quantizer=None) -> List[torch.Tensor]:
    """Quantized allreduce: int8 payloads, int32 accumulation.

    The scale of each leaf is shared across ranks by one
    ``all_reduce(MAX)`` of the vector of every leaf's amax. ``mask`` (this
    rank's 0/1) excludes its contribution (PS num-aggregate emulation,
    killed ranks). ``denom`` overrides the divisor
    (PS mode divides by the fixed num_aggregate); else it is the live
    contributor count, ``max(sum of masks, 1)``, or the world size without
    a mask. ``group=None``: one contributor, no collectives. ``seed`` must
    be the same on every rank. ``group_quantizer``: the grouped hook of
    :func:`quantize_leaves` (the card's sync check passes the plain
    ``reference.quantize_int8_scaled_group``).
    """
    if not grads:
        return []
    count = None
    if denom is None and mask is not None:
        # the live contributor count, as a device value (no host sync)
        count = torch.tensor(float(mask), dtype=torch.float32,
                             device=grads[0].device)
        if group is not None:
            all_reduce(count, "sum", group)
        count = count.clamp_min(1.0)
    # a divisor known when the program is built: XLA turns the JAX
    # package's division by it into a product with its f32 reciprocal
    recip = f32_reciprocal(max(
        float(world_size(group) if denom is None else denom), 1.0))
    # every leaf's amax in one vector, shared across ranks by one
    # all_reduce(MAX): max is free of order, so this is the per-leaf pmax
    amax = torch.stack([g.detach().abs().amax().to(torch.float32)
                        for g in grads])
    if group is not None:
        all_reduce(amax, "max", group)
    qs = quantize_leaves(grads, leaf_seeds(seed, len(grads)), amax,
                         group_quantizer)
    scales = torch.where(amax > 0, amax * RECIP127, torch.zeros_like(amax))
    out = []
    for i, (g, q) in enumerate(zip(grads, qs)):
        if mask is not None and not mask:
            q = torch.zeros_like(q)  # q * mask, with this rank's 0/1 mask
        total = q.to(torch.int32)
        if group is not None:
            all_reduce(total, "sum", group)
        dequant = total.to(torch.float32) * scales[i]
        avg = dequant / count if count is not None else dequant * recip
        out.append(avg.to(g.dtype))
    return out


def quantize_int8_host(arr) -> Tuple[np.ndarray, np.float32]:
    """Symmetric per-tensor int8 of frozen weights: ``(q, scale)`` with
    ``q = rint(arr / scale)`` clipped to +-127 and ``scale = max|arr| /
    127`` (1 for an all-zero leaf). Round-to-nearest in numpy, the JAX
    package's function: a true division here (XLA is not involved), so
    the bytes equal its."""
    a = np.asarray(arr, np.float32)
    amax = float(np.max(np.abs(a))) if a.size else 0.0
    scale = np.float32(amax / 127.0 if amax > 0 else 1.0)
    q = np.clip(np.rint(a / scale), -127, 127).astype(np.int8)
    return q, scale


def dequantize_int8_host(q: np.ndarray, scale, dtype=np.float32) -> np.ndarray:
    """``q * scale`` in f32, cast to ``dtype`` — the exact inverse map of
    the JAX package's ``quantize_int8_host`` (up to quantization error)."""
    return (np.asarray(q, np.float32) * np.float32(scale)).astype(dtype)
