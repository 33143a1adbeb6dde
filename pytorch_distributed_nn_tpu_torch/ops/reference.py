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
from typing import Optional, Tuple

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


def _scores(q, k, mask, causal) -> torch.Tensor:
    """(B, H, Lq, Lk) f32 scores of the flash kernels: ``(q . k) * D^-1/2``
    plus the additive pad bias, then -1e30 above the causal diagonal."""
    D = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
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
                        causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax attention as ``_flash_forward`` computes it: q/k/v
    (B, L, H, D) -> (out (B, L, H, D) in q's dtype, lse (B, H, L) f32).

    m = max(-1e30, row max), p = exp(s - m), l = max(sum p, 1e-30);
    p is rounded to v's dtype before P @ V (f32 accumulation), and
    lse = m + log(l). Differentiable by autograd, so it also serves as
    the plain attention of a ``use_kernels=False`` model."""
    s = _scores(q, k, mask, causal)
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    out = acc / l.permute(0, 2, 1, 3)
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def flash_attention(q, k, v, mask=None, causal: bool = False):
    """The output of :func:`flash_attention_fwd` (an ``attn_fn``)."""
    return flash_attention_fwd(q, k, v, mask, causal)[0]


def flash_attention_delta(out: torch.Tensor, dout: torch.Tensor):
    """delta = rowsum(dO * O), (B, H, L) f32: the softmax VJP's rank-1
    term, a plain reduction outside the kernels as in ``_flash_backward``."""
    return (dout.float() * out.float()).sum(dim=-1).transpose(1, 2)


def _probs_and_ds(q, k, v, mask, lse, delta, dout, causal):
    D = q.shape[-1]
    p = torch.exp(_scores(q, k, mask, causal) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    ds = p * (dp - delta[..., None]) * (1.0 / math.sqrt(D))
    return p, ds


def flash_attention_dq(q, k, v, mask, lse, delta, dout,
                       causal: bool = False) -> torch.Tensor:
    """dq of ``_flash_dq_kernel``: p = exp(s - lse), dp = dO . V in f32,
    ds = p (dp - delta) / sqrt(D), rounded to k's dtype before ds @ K."""
    _, ds = _probs_and_ds(q, k, v, mask, lse, delta, dout, causal)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype)


def flash_attention_dkv(q, k, v, mask, lse, delta, dout, causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) of ``_flash_dkv_kernel``: dv = p^T @ dO and dk = ds^T @ Q,
    with p, ds, Q and dO all in f32."""
    p, ds = _probs_and_ds(q, k, v, mask, lse, delta, dout, causal)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q, k, v, mask, out, lse, dout, causal: bool = False):
    """(dq, dk, dv) of ``_flash_backward`` from the forward's out and lse."""
    delta = flash_attention_delta(out, dout)
    dq = flash_attention_dq(q, k, v, mask, lse, delta, dout, causal)
    dk, dv = flash_attention_dkv(q, k, v, mask, lse, delta, dout, causal)
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
