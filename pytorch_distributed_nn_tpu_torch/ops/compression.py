"""Gradient compression fused around the collective, over
``torch.distributed``: the port of ``psum_mean``, ``_int8_quantize_leaf``,
``int8_psum_mean``, the top-k sparsification with error feedback
(``topk_mask_leaf``, ``topk_compress_ef``, ``init_ef_state``) and the
gradient buckets (``flatten_buckets``, ``unflatten_buckets``) of
``pytorch_distributed_nn_tpu/ops/compression.py``, plus the host-side int8
weight codec of serving artifacts (``quantize_int8_host`` for the
exporter, ``dequantize_int8_host`` for the reader).

``int8``: stochastic-rounded int8 quantization with a scale shared across
ranks (one ``all_reduce(MAX)`` of the vector of every leaf's amax, the JAX
per-leaf ``lax.pmax``), so the ranks' int8 payloads are summable; the
payload is cast to int32 before the ``all_reduce(SUM)``, as the JAX
package casts before its psum. Every sum over the ranks is one collective
of one flat buffer (:func:`psum`), the counterpart of XLA's all-reduce
combiner, which merges the JAX step's per-leaf psums.

Leaves of at least :data:`QUANT_KERNEL_MIN_SIZE` elements are quantized
together by ``quantize_int8_scaled_group`` (one launch of the hand-written
kernel on CUDA tensors, its plain version on CPU tensors); smaller ones by
the small-leaf formula ``floor(x * 127 / amax) + (u < frac)`` on either
device. That threshold is
the JAX package's own dispatch rule (its TPU program sends the large leaves
to the Pallas kernel), not a fallback. Both are unbiased stochastic
rounding; they are different realisations of it.

``topk``: each rank sends the ``k = ceil(ratio * size)`` largest-magnitude
coordinates of gradient + residual (ties at the k-th magnitude kept) and
keeps the rest as its residual for the next step: nothing is lost, only
delayed. The threshold is ``torch.topk``'s k-th value, exact on every
device: the JAX package's ``method="auto"`` takes ``lax.approx_max_k`` on
a TPU and the exact ``lax.top_k`` elsewhere, so ``"auto"`` and
``"approx"`` are exact here (a stated departure).

Buckets: the gradient leaves flattened in order into f32 buckets of
``bucket_bytes // 4`` elements (boundaries need not fall on leaf
boundaries), one collective and, for int8, one shared scale a bucket;
``unflatten_buckets`` restores each leaf's shape and dtype.

Collectives take the process group explicitly (``group``, from
:mod:`..parallel.mesh`); ``group=None`` is the JAX ``axis_name=None``
single-contributor mode: the same codec arithmetic with no collective.
"""

from __future__ import annotations

import dataclasses
import math
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


def psum(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """The sum over the ranks of each tensor (one dtype), new tensors: one
    ``all_reduce`` of one flat buffer and views of it, as XLA's
    all-reduce combiner merges the JAX step's per-leaf psums (a collective
    a leaf costs its host launch: 201 of them a BertBase step)."""
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce(flat, "sum", group)
    return [part.view(t.shape) for part, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def psum_mean(grads: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Plain full-precision gradient averaging: the sum over the ranks
    divided by their number (``lax.pmean``), in one collective
    (:func:`psum`)."""
    recip = f32_reciprocal(world_size(group))
    return [g.mul_(recip) for g in psum(grads, group)]


def leaf_noise(shape, seed: int, device) -> torch.Tensor:
    """u ~ U[0, 1) f32 of the small-leaf formula, from a generator on
    ``device`` seeded with ``seed`` (the same draws on every rank of one
    device type). The meta device (the cost walk's) has no generator: a
    CPU one drives its draw."""
    meta = torch.device(device).type == "meta"
    gen = torch.Generator(device="cpu" if meta else device).manual_seed(
        int(seed))
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
                    amax: torch.Tensor, group_quantizer=None,
                    regions: Optional[Sequence["LeafRegion"]] = None
                    ) -> List[torch.Tensor]:
    """``_int8_quantize_leaf`` of every leaf: g_i -> int8 of g_i's shape,
    ``amax`` a (k,) f32 vector on the leaves' device with amax[i] >=
    max|g_i|. The leaves of at least :data:`QUANT_KERNEL_MIN_SIZE` elements
    go together to ``group_quantizer`` (default
    :func:`.kernels.quantize_int8_scaled_group`: one launch on the card)
    with scale amax / 127 (as ``amax * f32(1/127)``; 1 when amax is 0,
    where g is all zero and q is 0 either way); the others take the
    small-leaf formula. With ``regions`` each g_i is the canonical view
    of a region of a larger leaf (:class:`LeafRegion`): the size that
    picks the formula is the whole leaf's, and the noise is the whole
    leaf's draw at the region's elements."""
    n = len(grads)
    regions = [None] * n if regions is None else list(regions)
    scales = torch.where(amax > 0, amax * RECIP127, torch.ones_like(amax))
    # a region's view is (local rows, cols)
    whole = [g.numel() if r is None else r.rows * g.shape[1]
             for g, r in zip(grads, regions)]
    firsts = [0 if r is None else r.row0 * g.shape[1]
              for g, r in zip(grads, regions)]
    big = [i for i in range(n) if whole[i] >= QUANT_KERNEL_MIN_SIZE]
    out: List[Optional[torch.Tensor]] = [None] * n
    if big:
        quantizer = group_quantizer or kernels.quantize_int8_scaled_group
        kw = ({"firsts": [firsts[i] for i in big]}
              if any(firsts[i] for i in big) else {})
        qs = quantizer([grads[i].float() for i in big],
                       [scales[i] for i in big], [seeds[i] for i in big],
                       **kw)
        for i, q in zip(big, qs):
            out[i] = q
    for i, g in enumerate(grads):
        if out[i] is not None:
            continue
        r = regions[i]
        if r is None:
            u = leaf_noise(g.shape, seeds[i], g.device)
        else:
            u = leaf_noise((r.rows, g.shape[1]), seeds[i], g.device)
            u = u[r.row0:r.row0 + g.shape[0]].reshape(g.shape)
        out[i] = quantize_small_leaf(g, amax[i], u)
    return out


@dataclasses.dataclass(frozen=True)
class LeafRegion:
    """A tensor-parallel region of a gradient leaf in the leaf's canonical
    numbering: the leaf as ``(rows, cols)`` with its split axis outermost
    (a port weight split on its input dimension is transposed first,
    ``transpose``), this region its rows ``[row0, row0 + local rows)``. A
    replicated leaf is one region of all its rows. The numbering is the
    same at every tp degree, so the int8 result of a leaf does not depend
    on the degree."""

    rows: int
    row0: int = 0
    transpose: bool = False

    def view(self, g: torch.Tensor) -> torch.Tensor:
        """``g`` as its canonical (local rows, cols) view."""
        g = g.t() if self.transpose else g
        return g.reshape(g.shape[0], -1).contiguous()

    def unview(self, c: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if self.transpose:
            return c.reshape(like.shape[1], like.shape[0]).t().contiguous()
        return c.reshape(like.shape)


def leaf_seeds(seed: int, count: int) -> List[int]:
    """``count`` 32-bit seeds, one per leaf, from one sync seed: the same
    on every rank (the JAX ``jax.random.split(key, len(leaves))``)."""
    return [int(s) for s in
            np.random.SeedSequence(int(seed)).generate_state(count)]


def int8_psum_mean(grads: Sequence[torch.Tensor], seed: int, group,
                   mask: Optional[float] = None,
                   denom=None, group_quantizer=None,
                   regions: Optional[Sequence[LeafRegion]] = None,
                   amax_groups: Sequence = ()) -> List[torch.Tensor]:
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
    ``reference.quantize_int8_scaled_group``). A tensor ``denom`` (the
    tp/sp step's global masked count, on the device) divides, as the JAX
    step divides by its traced count.

    Tensor parallelism: ``regions`` (one :class:`LeafRegion` a leaf) makes
    each gradient a region of its leaf, quantized in the leaf's canonical
    numbering; ``amax_groups`` (the model group) join the amax MAX, so
    the scale is the whole logical leaf's.
    """
    if not grads:
        return []
    if regions is not None:
        views = [r.view(g) for g, r in zip(grads, regions)]
        outs = _int8_psum_mean(views, seed, group, mask, denom,
                               group_quantizer, regions, amax_groups)
        return [r.unview(o, g) for o, g, r in zip(outs, grads, regions)]
    return _int8_psum_mean(grads, seed, group, mask, denom, group_quantizer,
                           None, amax_groups)


def _int8_psum_mean(grads, seed, group, mask, denom, group_quantizer,
                    regions, amax_groups) -> List[torch.Tensor]:
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
    divide = torch.is_tensor(denom)
    if divide:
        denom = denom.clamp_min(1.0)
    recip = None if divide else f32_reciprocal(max(
        float(world_size(group) if denom is None else denom), 1.0))
    # every leaf's amax in one vector, shared across ranks by one
    # all_reduce(MAX): max is free of order, so this is the per-leaf pmax
    amax = torch.stack([g.detach().abs().amax().to(torch.float32)
                        for g in grads])
    for g in (group, *amax_groups):
        if g is not None:
            all_reduce(amax, "max", g)
    qs = quantize_leaves(grads, leaf_seeds(seed, len(grads)), amax,
                         group_quantizer, regions)
    scales = torch.where(amax > 0, amax * RECIP127, torch.zeros_like(amax))
    # q * mask, with this rank's 0/1 mask; int32 sums of every leaf in
    # one collective (exact in any order)
    totals = [(torch.zeros_like(q) if mask is not None and not mask else q)
              .to(torch.int32) for q in qs]
    if group is not None:
        totals = psum(totals, group)
    out = []
    for i, (g, total) in enumerate(zip(grads, totals)):
        dequant = total.to(torch.float32) * scales[i]
        if divide:
            avg = dequant / denom
        else:
            avg = dequant / count if count is not None else dequant * recip
        out.append(avg.to(g.dtype))
    return out


def topk_mask_leaf(g: torch.Tensor, ratio: float,
                   method: str = "auto") -> torch.Tensor:
    """0/1 mask (``g``'s dtype) keeping the ``k = max(1, int(size * ratio
    + 0.999999))`` largest ``|g|``, ties at the k-th magnitude kept
    (``>=``): the JAX ``_topk_mask_leaf``. The threshold is the k-th value
    of ``torch.topk``, exact for every ``method`` (module docstring)."""
    if method not in ("auto", "exact", "approx"):
        raise ValueError(f"unknown topk method {method!r}; expected "
                         "auto|exact|approx")
    flat = g.detach().abs().reshape(-1)
    k = max(1, int(flat.numel() * ratio + 0.999999))
    if k >= flat.numel():
        return torch.ones_like(g)
    kth = torch.topk(flat, k, sorted=False).values.min()
    return (g.abs() >= kth).to(g.dtype)


def topk_compress_ef(grads: Sequence[torch.Tensor],
                     ef_state: Sequence[torch.Tensor], ratio: float,
                     method: str = "auto"):
    """Top-k sparsification with error feedback, on this rank (no
    collective): ``(sent, residuals)``, lists in the order of ``grads``,
    with ``acc = g + e``, ``sent = acc * mask`` and ``residual = acc -
    sent``, so ``sent + residual == g + e`` exactly."""
    sent, resid = [], []
    for g, e in zip(grads, ef_state):
        acc = g + e
        s = acc * topk_mask_leaf(acc, ratio, method)
        sent.append(s)
        resid.append(acc - s)
    return sent, resid


def init_ef_state(params) -> List[torch.Tensor]:
    """Zero error-feedback residuals shaped like the gradients."""
    return [torch.zeros_like(p.detach()) for p in params]


def flatten_buckets(grads: Sequence[torch.Tensor], bucket_bytes: int):
    """``(buckets, meta)``: the leaves flattened in order into one f32
    vector, split into buckets of ``bucket_bytes // 4`` elements (the last
    one shorter); ``meta`` (each leaf's shape and dtype) restores them
    through :func:`unflatten_buckets`."""
    meta = [(tuple(g.shape), g.dtype) for g in grads]
    if not grads:
        return [], meta
    flat = torch.cat([g.reshape(-1).to(torch.float32) for g in grads])
    per = max(1, bucket_bytes // 4)
    return list(torch.split(flat, per)), meta


def unflatten_buckets(buckets: Sequence[torch.Tensor],
                      meta) -> List[torch.Tensor]:
    """The inverse of :func:`flatten_buckets`: each leaf back at its
    shape and dtype."""
    if not meta:
        return []
    flat = torch.cat(list(buckets)) if len(buckets) > 1 else buckets[0]
    out, off = [], 0
    for shape, dtype in meta:
        n = math.prod(shape)
        out.append(flat[off:off + n].reshape(shape).to(dtype))
        off += n
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
