"""Plain PyTorch versions of the port's hand-written kernels.

Each function computes what its kernel in :mod:`.kernels` computes, with
the JAX package's arithmetic (f32 statistics, the same masking constant,
the same places where values are rounded to the working type). The CPU
path of every kernel wrapper runs these, the tests hold them against the
JAX functions, and ``chip_smoke.py`` holds each kernel against them on the
card. Nothing on the serving path calls them when the tensors lie on a
card.
"""

from __future__ import annotations

import math

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


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-6, out_dtype=None) -> torch.Tensor:
    """LayerNorm over the last axis with f32 two-pass statistics, the
    result written in ``out_dtype`` (default: x's dtype)."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    return y.to(out_dtype)
