"""Sequence parallelism: ring attention and Ulysses all-to-all, in plain
PyTorch ops over the seq group, the port of ``pytorch_distributed_nn_tpu/
parallel/ring_attention.py`` (which writes them in plain jnp).

Both take the model's attention signature ``fn(q, k, v, mask,
causal=...)`` with q/k/v ``(B, Lc, H, D)``, this rank's chunk of the
sequence (seq rank ``s`` holds positions ``[s * Lc, (s + 1) * Lc)``), and
``mask`` its ``(B, Lc)`` key pad mask (1 attend, 0 pad) or ``None``.

- :func:`ring_attention`: the K/V blocks (and the mask) rotate one hop a
  step around the seq group while this rank's Q stays; the softmax
  statistics (running max and normaliser) accumulate in f32, flash-style:
  block 0 resident, then S - 1 rotations. It is a
  ``torch.autograd.Function``: its backward is a second ring pass in which
  dq stays home and dk/dv ride with their block, arriving home after S
  hops, so it keeps O(Lc * D) residuals (q, k, v, the output and its
  log-sum-exp), never a per-hop ``(Lc, Lc)`` probability block. Causal
  masking uses each block's origin positions (``src = (rank - j) mod S``).
  A hop posts every send and receive before it waits on any (blocking
  pairs would deadlock at S = 2), in an order that alternates with the
  rank's parity (see :func:`_hop`).
- :func:`ulysses_attention`: two ``alltoall_base`` calls around full
  attention re-shard the activations from sequence-sharded to
  head-sharded and back (needs ``H % S == 0``); the mask is gathered.

:func:`make_mesh_attn` composes them with tensor parallelism: under the
port's model each rank already holds its ``H / tp`` heads, so the seq
group alone carries the attention's collectives. :func:`make_tp_flash_attn`
is the tp-only (sp = 1) path of ``attn_impl="pallas"``: each rank runs the
hand-written flash kernels (``ops.kernels.flash_attention``) on its own
``H / tp`` heads at the full sequence, with no collective. The ring's
inner block stays plain ops, as in the JAX package, which refuses the
Pallas kernel with sp > 1.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional

import torch

from pytorch_distributed_nn_tpu_torch.parallel.mesh import (
    SEQ_AXIS,
    rank,
    world_size,
)

_NEG_INF = -1e30


def _hop(tensors, group, S: int, r: int):
    """Each tensor sent to seq rank r + 1 and received from r - 1 (mod S):
    every send and receive posted before any is waited on, even ranks
    posting each tensor's send first and odd ranks its receive. At S = 2
    both go to one peer, and NCCL runs a pair's transfers on one stream
    in the order posted: a send posted first on both ranks would wait,
    once a block exceeds NCCL's buffer, for a receive queued behind the
    peer's own send."""
    outs = [torch.empty_like(t) for t in tensors]
    works = []
    for tag, (t, o) in enumerate(zip(tensors, outs)):
        def send():
            return group.send([t.contiguous()], (r + 1) % S, tag)

        def recv():
            return group.recv([o], (r - 1) % S, tag)

        works += [send(), recv()] if r % 2 == 0 else [recv(), send()]
    for w in works:
        w.wait()
    return outs


def _positions(start: int, n: int, device) -> torch.Tensor:
    return start + torch.arange(n, device=device)


def _block_update(q, k, v, kv_mask, q_pos, k_pos, causal, o, m, l):
    """One flash-style accumulation step against a K/V block (f32
    statistics)."""
    D = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(D)
    if kv_mask is not None:
        keep = kv_mask[:, None, None, :].to(torch.bool)
        scores = torch.where(keep, scores, torch.full_like(scores, _NEG_INF))
    if causal:
        allowed = (q_pos[:, None] >= k_pos[None, :])[None, None]
        scores = torch.where(allowed, scores,
                             torch.full_like(scores, _NEG_INF))
    m_new = torch.maximum(m, scores.amax(dim=-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(scores - m_new[..., None])
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), v).float()
    o_new = o * corr.transpose(1, 2)[..., None] + pv
    return o_new, m_new, l_new


def _ring_forward(q, k, v, mask, causal, group):
    """(out, lse) with lse = m + log l, (B, H, Lc) f32."""
    S, r = world_size(group), rank(group)
    B, Lc, H, D = q.shape
    dev = q.device
    q_pos = _positions(r * Lc, Lc, dev)
    o = torch.zeros((B, Lc, H, D), dtype=torch.float32, device=dev)
    m = torch.full((B, H, Lc), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Lc), dtype=torch.float32, device=dev)
    o, m, l = _block_update(q, k, v, mask, q_pos, q_pos, causal, o, m, l)
    for j in range(1, S):
        moving = [k, v] if mask is None else [k, v, mask]
        moving = _hop(moving, group, S, r)
        k, v = moving[0], moving[1]
        mask = None if mask is None else moving[2]
        src = (r - j) % S  # the origin rank of the block now held
        o, m, l = _block_update(q, k, v, mask, q_pos,
                                _positions(src * Lc, Lc, dev), causal,
                                o, m, l)
    out = o / torch.clamp(l.transpose(1, 2), min=1e-30)[..., None]
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    return out.to(q.dtype), lse


def _ring_block_grads(q, k, v, g, delta, lse, kv_mask, q_pos, k_pos,
                      causal):
    """One (q chunk, kv block) pair's gradients from the saved lse: p is
    recomputed for the block (transient, never saved)."""
    D = q.shape[-1]
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    keep = torch.ones(s.shape, dtype=torch.bool, device=s.device)
    if kv_mask is not None:
        keep = keep & kv_mask[:, None, None, :].to(torch.bool)
    if causal:
        keep = keep & (q_pos[:, None] >= k_pos[None, :])[None, None]
    p = torch.where(keep, torch.exp(s - lse[..., None]),
                    torch.zeros_like(s))
    gf = g.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, v.float())
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dq, dk, dv


def _ring_backward(q, k, v, mask, out, lse, g, causal, group):
    """The second ring pass: dq accumulates here, dk/dv accumulate on the
    rotating block and arrive home after S hops."""
    S, r = world_size(group), rank(group)
    B, Lc, H, D = q.shape
    dev = q.device
    q_pos = _positions(r * Lc, Lc, dev)
    delta = torch.einsum("bqhd,bqhd->bhq", g.float(), out.float())
    dq = torch.zeros((B, Lc, H, D), dtype=torch.float32, device=dev)
    dk = torch.zeros_like(dq)
    dv = torch.zeros_like(dq)
    for j in range(S):
        src = (r - j) % S
        dq_b, dk_b, dv_b = _ring_block_grads(
            q, k, v, g, delta, lse, mask, q_pos,
            _positions(src * Lc, Lc, dev), causal)
        dq = dq + dq_b
        dk = dk + dk_b
        dv = dv + dv_b
        if S == 1:
            break
        if j < S - 1:
            moving = [k, v, dk, dv] + ([] if mask is None else [mask])
            moving = _hop(moving, group, S, r)
            k, v, dk, dv = moving[:4]
            mask = None if mask is None else moving[4]
        else:
            # the last hop carries only the accumulators home
            dk, dv = _hop([dk, dv], group, S, r)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, causal, group):
        out, lse = _ring_forward(q, k, v, mask, causal, group)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.causal, ctx.group = causal, group
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, mask, out, lse, g.contiguous(),
                                    ctx.causal, ctx.group)
        return dq, dk, dv, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor] = None, causal: bool = False,
                   group=None) -> torch.Tensor:
    """Blockwise ring attention over the seq ``group`` (module docstring);
    equals full attention on the gathered sequence to f32 accumulation
    tolerance."""
    return _RingAttention.apply(q, k, v, mask, causal, group)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (S, ...) -> (S, ...): slice j to rank j, slice j of the
    result from rank j."""
    x = x.contiguous()
    out = torch.empty_like(x)
    group.alltoall_base(out, x, [], []).wait()
    return out


def _seq_to_heads(x: torch.Tensor, group, S: int) -> torch.Tensor:
    """(B, Lc, H, D) -> (B, S * Lc, H / S, D): the JAX
    ``all_to_all(split_axis=2, concat_axis=1, tiled=True)``."""
    B, Lc, H, D = x.shape
    y = x.reshape(B, Lc, S, H // S, D).permute(2, 0, 1, 3, 4)
    y = _all_to_all(y, group)
    return y.permute(1, 0, 2, 3, 4).reshape(B, S * Lc, H // S, D)


def _heads_to_seq(x: torch.Tensor, group, S: int) -> torch.Tensor:
    """The inverse of :func:`_seq_to_heads`."""
    B, L, Hs, D = x.shape
    y = x.reshape(B, S, L // S, Hs, D).permute(1, 0, 2, 3, 4)
    y = _all_to_all(y, group)
    return y.permute(1, 2, 0, 3, 4).reshape(B, L // S, S * Hs, D)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, S):
        ctx.group, ctx.S = group, S
        return _seq_to_heads(x, group, S)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g.contiguous(), ctx.group, ctx.S), None, None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, S):
        ctx.group, ctx.S = group, S
        return _heads_to_seq(x, group, S)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g.contiguous(), ctx.group, ctx.S), None, None


def _gather_mask(mask: torch.Tensor, group, S: int) -> torch.Tensor:
    parts = [torch.empty_like(mask) for _ in range(S)]
    group.allgather([parts], [mask.contiguous()]).wait()
    return torch.cat(parts, dim=1)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask: Optional[torch.Tensor] = None,
                      causal: bool = False, group=None) -> torch.Tensor:
    """All-to-all sequence parallelism (module docstring); requires
    ``num_heads % S == 0``."""
    from pytorch_distributed_nn_tpu_torch.models.transformer import (
        full_attention,
    )

    S = world_size(group)
    H = q.shape[2]
    if H % S:
        raise ValueError(f"num_heads={H} not divisible by seq axis size {S}")
    if S == 1:
        return full_attention(q, k, v, mask, causal=causal)
    qg, kg, vg = (_SeqToHeads.apply(t, group, S) for t in (q, k, v))
    full_mask = None if mask is None else _gather_mask(mask, group, S)
    out = full_attention(qg, kg, vg, full_mask, causal=causal)
    return _HeadsToSeq.apply(out, group, S)


def make_seq_attn(impl: str, group=None):
    """The attention function of ``impl`` ('ring' | 'ulysses') over the
    seq ``group``."""
    if impl == "ring":
        return partial(ring_attention, group=group)
    if impl == "ulysses":
        return partial(ulysses_attention, group=group)
    raise ValueError(f"unknown sequence-parallel attention impl {impl!r}")


def make_mesh_attn(mesh, impl: str = "ring"):
    """Ring or Ulysses attention over ``mesh``'s seq group, on each rank's
    own heads (the model holds ``H / tp`` of them)."""
    return make_seq_attn(impl, mesh.group(SEQ_AXIS))


def make_tp_flash_attn(mesh):
    """The hand-written flash kernels on each rank's own ``H / tp`` heads
    at the full sequence (sp = 1): the port of the JAX
    ``make_tp_flash_attn``. No collective runs inside attention; the
    model's projections carry the tp sums."""
    from pytorch_distributed_nn_tpu_torch.ops import kernels

    if mesh.shape[SEQ_AXIS] != 1:
        raise ValueError("make_tp_flash_attn runs the full sequence on "
                         "each rank: it needs seq_parallel = 1")
    return kernels.flash_attention
