"""Plain PyTorch versions of the port's hand-written kernels.

Each function computes what its kernel in :mod:`.kernels` computes, with
the JAX package's arithmetic (f32 statistics, the same masking constant,
the same places where values are rounded to the working type). The CPU
path of every kernel wrapper runs these, the tests hold them against the
JAX functions, and ``chip_smoke.py`` holds each kernel against them on the
card. Nothing on the serving or training path calls them when the
tensors lie on a card (``use_kernels=False`` models aside: those are the
plain references).

Layouts are the kernels': attention operands (B, L, H, D), the pad mask
(B, L) with 1 attend / 0 pad, the per-row ``lse`` and ``delta`` of the
flash backward (B, H, L) f32; LayerNorm statistics ``mu`` and ``rs`` have
x's leading shape, f32.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

#: additive mask value of the JAX kernels (ops/pallas_kernels._NEG_INF)
NEG_INF = -1e30


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
    """Single-position attention against a KV cache.

    q (B, 1, H, D); k, v (B, S, H, D) in q's dtype; positions (B,) int,
    the cache index of each row's newest token. Keys with index >
    ``positions[b]`` are masked with an additive -1e30. Returns
    (B, 1, H, D) in q's dtype. Scores, max, sum and the P @ V product
    accumulate in f32; probabilities are rounded to the cache type
    before P @ V, as ``pallas_decode_attention`` does.
    """
    S, D = k.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s * (1.0 / math.sqrt(D))
    idx = torch.arange(S, device=q.device)
    valid = idx[None, :] <= positions.to(torch.long)[:, None]  # (B, S)
    bias = torch.where(valid, 0.0, NEG_INF).to(torch.float32)
    s = s + bias[:, None, None, :]
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    w = (p / l).to(v.dtype).float()
    out = torch.einsum("bhqk,bkhd->bqhd", w, v.float())
    return out.to(q.dtype)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to 10
    explicit mantissa bits, to nearest with ties away from zero (half a
    TF32 unit, 0x1000, added to the bits, then their low 13 bits cleared),
    in int32 bit operations. For finite x."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` as the f32 tensor-core kernels carry it into a product:
    hi + lo with hi = tf32(x) and lo = tf32(x - hi), summed exactly in f32
    (22 significant bits at most). Relative error <= 2^-22."""
    hi = tf32(x)
    return hi + tf32(x.float() - hi)


def einsum_3xtf32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` of f32 operands as the f32 flash kernels
    take it: each operand split into hi = tf32(x) and lo = tf32(x - hi),
    and three products lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b), each
    exact in f32 terms, summed in f32."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a.float() - a_hi), tf32(b.float() - b_hi)
    return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)
            + torch.einsum(eq, a_hi, b_hi))


def _scores(q, k, mask, causal, einsum=torch.einsum) -> torch.Tensor:
    """(B, H, Lq, Lk) f32 scores of the flash kernels: ``(q . k) * D^-1/2``
    plus the additive pad bias, then -1e30 above the causal diagonal."""
    D = q.shape[-1]
    s = einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s * (1.0 / math.sqrt(D))
    if mask is not None:
        bias = torch.where(mask.to(torch.bool), 0.0, NEG_INF)
        s = s + bias.to(torch.float32)[:, None, None, :]
    if causal:
        Lq, Lk = q.shape[1], k.shape[1]
        keep = torch.ones(Lq, Lk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    return s


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        causal: bool = False, einsum=torch.einsum
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax attention as ``_flash_forward`` computes it: q/k/v
    (B, L, H, D) -> (out (B, L, H, D) in q's dtype, lse (B, H, L) f32).

    m = max(-1e30, row max), p = exp(s - m), l = max(sum p, 1e-30);
    p is rounded to v's dtype before P @ V (f32 accumulation), and
    lse = m + log(l). Differentiable by autograd, so it also serves as
    the plain attention of a ``use_kernels=False`` model. ``einsum``
    takes every product (here and in the backward below):
    :func:`einsum_3xtf32` gives the f32 kernels' three TF32 products."""
    s = _scores(q, k, mask, causal, einsum)
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    out = acc / l.permute(0, 2, 1, 3)
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def flash_attention(q, k, v, mask=None, causal: bool = False):
    """The output of :func:`flash_attention_fwd` (an ``attn_fn``)."""
    return flash_attention_fwd(q, k, v, mask, causal)[0]


def flash_attention_delta(out: torch.Tensor, dout: torch.Tensor):
    """delta = rowsum(dO * O), (B, H, L) f32: the softmax VJP's rank-1
    term, a plain reduction outside the kernels as in ``_flash_backward``."""
    return (dout.float() * out.float()).sum(dim=-1).transpose(1, 2)


def _probs_and_ds(q, k, v, mask, lse, delta, dout, causal,
                  einsum=torch.einsum):
    D = q.shape[-1]
    p = torch.exp(_scores(q, k, mask, causal, einsum) - lse[..., None])
    dp = einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    ds = p * (dp - delta[..., None]) * (1.0 / math.sqrt(D))
    return p, ds


def flash_attention_dq(q, k, v, mask, lse, delta, dout,
                       causal: bool = False, einsum=torch.einsum
                       ) -> torch.Tensor:
    """dq of ``_flash_dq_kernel``: p = exp(s - lse), dp = dO . V in f32,
    ds = p (dp - delta) / sqrt(D), rounded to k's dtype before ds @ K."""
    _, ds = _probs_and_ds(q, k, v, mask, lse, delta, dout, causal, einsum)
    dq = einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype)


def split_bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` as the bf16 tensor-core kernels carry it into a product:
    hi + lo with hi = bf16(x) and lo = bf16(x - hi), summed exactly in f32
    (17 significant bits at most). Relative error <= 2^-17."""
    hi = x.to(torch.bfloat16).float()
    return hi + (x - hi).to(torch.bfloat16).float()


def flash_attention_dkv(q, k, v, mask, lse, delta, dout, causal: bool = False,
                        einsum=torch.einsum
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) of ``_flash_dkv_kernel``: dv = p^T @ dO and dk = ds^T @ Q,
    with p, ds, Q and dO all in f32. For bf16 operands p and ds enter the
    products as the dk/dv kernel splits them (:func:`split_bf16`): the
    tensor cores multiply bf16 only, and dO and Q are exact in bf16."""
    p, ds = _probs_and_ds(q, k, v, mask, lse, delta, dout, causal, einsum)
    if q.dtype == torch.bfloat16:
        p, ds = split_bf16(p), split_bf16(ds)
    dv = einsum("bhqk,bqhd->bkhd", p, dout.float())
    dk = einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q, k, v, mask, out, lse, dout, causal: bool = False,
                        einsum=torch.einsum):
    """(dq, dk, dv) of ``_flash_backward`` from the forward's out and lse."""
    delta = flash_attention_delta(out, dout)
    dq = flash_attention_dq(q, k, v, mask, lse, delta, dout, causal, einsum)
    dk, dv = flash_attention_dkv(q, k, v, mask, lse, delta, dout, causal,
                                 einsum)
    return dq, dk, dv


def layer_norm_fwd(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   eps: float = 1e-6, out_dtype=None):
    """``_ln_fwd_kernel``: (y in ``out_dtype`` (default x's dtype), mu, rs),
    f32 two-pass statistics, mu and rs of x's leading shape."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rs = torch.rsqrt(var + eps)
    y = xc * rs * gamma.float() + beta.float()
    return y.to(out_dtype), mu[..., 0], rs[..., 0]


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-6, out_dtype=None) -> torch.Tensor:
    """LayerNorm over the last axis with f32 two-pass statistics, the
    result written in ``out_dtype`` (default: x's dtype)."""
    return layer_norm_fwd(x, gamma, beta, eps, out_dtype)[0]


def f32_reciprocal(n: float) -> float:
    """1/n rounded to f32. XLA compiles a division by a constant into a
    product with it, and the port computes what XLA computes: the same
    value on the CPU and the card, where torch would divide by a Python
    scalar on one and multiply by its reciprocal on the other."""
    return float(np.float32(1.0) / np.float32(n))


_MASK32 = 0xFFFFFFFF
#: the int8 scales' ``amax / 127.0`` is ``amax * RECIP127`` in XLA (about
#: 5% of amax values round differently from a true division), so the
#: port multiplies too, on both devices and in the kernel
RECIP127 = f32_reciprocal(127.0)
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo32(a: torch.Tensor, m: int):
    """(high, low) 32-bit words of ``a * m`` for int64 tensors ``a`` in
    [0, 2^32) and a 32-bit constant ``m``, with no int64 overflow: ``a``
    splits into 16-bit halves, whose products with ``m`` stay below 2^48."""
    t = (a & 0xFFFF) * m
    u = (a >> 16) * m
    hi = (u + (t >> 16)) >> 16
    lo = (((u & 0xFFFF) << 16) + t) & _MASK32
    return hi, lo


def philox4x32(counter, key):
    """Philox4x32-10 (Salmon et al., SC'11) in int64 torch arithmetic:
    ``counter`` four and ``key`` two tensors (or ints) of 32-bit words,
    broadcast together; returns the four output words as int64 tensors.
    The kernels in ``csrc/int8_quant.cu`` compute the same function."""
    c = [torch.as_tensor(w, dtype=torch.int64) for w in counter]
    k0, k1 = (torch.as_tensor(w, dtype=torch.int64) for w in key)
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo32(c[0], _PHILOX_M[0])
        hi1, lo1 = _mulhilo32(c[2], _PHILOX_M[1])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return c


def philox_uniform(seed: int, n: int, device=None,
                   first: int = 0) -> torch.Tensor:
    """The int8 kernels' noise: u[i] in [0, 1) f32 from word (e & 3) of
    Philox4x32-10 at counter (e >> 2, e >> 34, 0, 0), key (seed, 0), for
    e = first + i, mapped as ``(bits >> 8) * 2^-24`` (the TPU kernel's
    mapping)."""
    first = int(first)
    lo, skip = first >> 2, first & 3
    quads = -(-(n + skip) // 4)
    t = lo + torch.arange(quads, dtype=torch.int64, device=device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    words = philox4x32((t & _MASK32, t >> 32, zero, zero),
                       (int(seed) & _MASK32, 0))
    bits = torch.stack(torch.broadcast_tensors(*words),
                       dim=1).reshape(-1)[skip:skip + n]
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _round_stochastic(x: torch.Tensor, scale: torch.Tensor,
                      u: torch.Tensor) -> torch.Tensor:
    q = torch.floor(x.float() / scale + u)
    return q.clamp(-127, 127).to(torch.int8)


def _noise(x: torch.Tensor, seed: Optional[int], u: Optional[torch.Tensor],
           first: int = 0):
    if (seed is None) == (u is None):
        raise ValueError("give the noise either as a seed or as u")
    if u is None:
        return philox_uniform(seed, x.numel(), x.device,
                              first).reshape(x.shape)
    return u.to(device=x.device, dtype=torch.float32).reshape(x.shape)


def quantize_int8_scaled(x: torch.Tensor, scale, seed: Optional[int] = None,
                         u: Optional[torch.Tensor] = None,
                         first: int = 0) -> torch.Tensor:
    """``quantize_int8_scaled``: ``clip(floor(x / scale + u), -127, 127)``
    as int8, x's shape, scale a given f32 (0-d tensor or number). The noise
    ``u`` is given, or drawn from ``seed`` as the kernel draws it, x's
    element 0 at index ``first``."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    return _round_stochastic(x, scale, _noise(x, seed, u, first))


def quantize_int8_scaled_group(xs: Sequence[torch.Tensor], scales,
                               seeds: Optional[Sequence[int]] = None,
                               us: Optional[Sequence[torch.Tensor]] = None,
                               firsts: Optional[Sequence[int]] = None
                               ) -> List[torch.Tensor]:
    """The grouped ``quantize_int8_scaled``: :func:`quantize_int8_scaled`
    of each leaf with its scale (``scales`` a (k,) tensor or a sequence of
    one value each) and its seed (its element 0 at index ``firsts[i]``),
    or its given noise ``us[i]``."""
    if torch.is_tensor(scales):
        scales = scales.reshape(-1).unbind()
    n = len(xs)
    seeds = [None] * n if seeds is None else seeds
    us = [None] * n if us is None else us
    firsts = [0] * n if firsts is None else firsts
    return [quantize_int8_scaled(x, s, seed=k, u=u, first=f)
            for x, s, k, u, f in zip(xs, scales, seeds, us, firsts)]


def quantize_int8(x: torch.Tensor, seed: Optional[int] = None,
                  u: Optional[torch.Tensor] = None):
    """``quantize_int8``: (q int8 of x's shape, scale 0-d f32) with
    ``scale = max|x| * f32(1/127)`` (1 when x is all zero; XLA's form of
    the JAX ``amax / 127.0``, see :data:`RECIP127`) and the rounding of
    :func:`quantize_int8_scaled`."""
    amax = x.float().abs().amax()
    scale = torch.where(amax > 0, amax * RECIP127, torch.ones_like(amax))
    return _round_stochastic(x, scale, _noise(x, seed, u)), scale


def dequantize_int8(q: torch.Tensor, scale) -> torch.Tensor:
    """``dequantize_int8``: ``q * scale`` in f32."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=q.device)
    return q.to(torch.float32) * scale


def layer_norm_bwd(x: torch.Tensor, gamma: torch.Tensor, mu: torch.Tensor,
                   rs: torch.Tensor, dy: torch.Tensor):
    """``_ln_bwd_kernel`` plus the partial sums: (dx in x's dtype,
    dgamma f32, dbeta f32)."""
    D = x.shape[-1]
    xhat = (x.float() - mu[..., None]) * rs[..., None]
    dyf = dy.float()
    dxhat = dyf * gamma.float()
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = (rs[..., None] * (dxhat - m1 - xhat * m2)).to(x.dtype)
    dgamma = (dyf * xhat).reshape(-1, D).sum(dim=0)
    dbeta = dyf.reshape(-1, D).sum(dim=0)
    return dx, dgamma, dbeta
