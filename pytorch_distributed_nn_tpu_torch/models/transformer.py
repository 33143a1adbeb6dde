"""Causal decoder (GPT-style) in PyTorch: the port of
``pytorch_distributed_nn_tpu/models/transformer.py``'s decoder path.

Same architecture, parameter shapes and arithmetic as the flax modules:
pre-LN blocks, LayerNorm eps 1e-6 with its output in ``ln_dtype`` (f32)
then cast to ``dtype``, tanh-approximated GELU (flax's ``nn.gelu``
default), a tied head (``logits = x @ embed.T`` in ``dtype``, then f32,
plus ``lm_bias``), softmax statistics in f32. Parameter names follow the
flax tree (``scale``/``bias`` for LayerNorm) so
:mod:`.convert` maps one onto the other leaf by leaf.

Three call modes, as in the JAX package:

- full: ``model(tokens, mask=None)`` -> ``(B, L, vocab)`` f32 logits;
- prefill: ``return_kv=True`` also returns per-layer ``(k, v)``, each
  ``(B, L, H, D)``;
- decode: ``cache=((k, v), ...)`` with each ``(B, S, H, D)`` and
  ``positions`` (B,) int32: tokens is ``(B, 1)``; each row's new K/V are
  written into the cache at its position (in place: the caller passes
  tensors it owns) before attention runs; returns
  ``(next_logits (B, vocab), cache)``.

LayerNorm and decode attention go through the hand-written kernels of
:mod:`..ops.kernels` (their plain versions on CPU tensors). With
``use_kernels=False`` the model calls the plain versions on any device:
the full-recompute reference that ``chip_smoke.py`` holds the served
logits against. ``decode_attn_fn`` overrides the decode attention alone,
as the JAX package's argument of that name does. Prefill attention, projections and the MLP are plain
PyTorch, as they were plain XLA (no Pallas kernel) in the JAX package.
The encoder and ``BertMLM`` wait for the training slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_nn_tpu_torch.ops import kernels, reference

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The fields the decoder uses (defaults: BERT-base widths)."""

    vocab_size: int = 30522
    max_len: int = 512
    d_model: int = 768
    num_heads: int = 12
    num_layers: int = 12
    d_ff: int = 3072
    dropout_rate: float = 0.1
    dtype: Any = torch.bfloat16
    ln_dtype: Any = torch.float32
    # The JAX package picks its Pallas LayerNorm with this flag and flax's
    # nn.LayerNorm without it; the port has one LayerNorm, the kernel, and
    # keeps the field so manifests written for either load unchanged.
    fused_ln: bool = False


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor] = None,
                   causal: bool = False) -> torch.Tensor:
    """Softmax attention, q/k/v (B, L, H, D) -> (B, L, H, D). ``mask``
    (B, Lk): 1 attend, 0 pad. Scores and softmax in f32; the products in
    the input dtype."""
    D = q.shape[-1]
    Lq, Lk = q.shape[1], k.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(D)
    if mask is not None:
        keep = mask[:, None, None, :].to(torch.bool)
        scores = scores.masked_fill(~keep, reference.NEG_INF)
    if causal:
        idx = torch.arange(max(Lq, Lk), device=q.device)
        keep = idx[:Lq, None] >= idx[None, :Lk]
        scores = scores.masked_fill(~keep, reference.NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _dense(x: torch.Tensor, layer: nn.Linear, dtype) -> torch.Tensor:
    """flax ``Dense(dtype=...)``: inputs and parameters cast to ``dtype``."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with f32 statistics, backed by the
    hand-written kernel; ``out_dtype`` is written directly."""

    def __init__(self, dim: int, out_dtype=torch.float32, eps: float = 1e-6,
                 use_kernels: bool = True):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.out_dtype = out_dtype
        self.eps = eps
        self._ln = kernels.layer_norm if use_kernels else reference.layer_norm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._ln(x, self.scale, self.bias, self.eps, self.out_dtype)


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: TransformerConfig, use_kernels: bool = True,
                 decode_attn_fn=None):
        super().__init__()
        self.cfg = cfg
        H, D = cfg.num_heads, cfg.d_model // cfg.num_heads
        self.query = nn.Linear(cfg.d_model, H * D)
        self.key = nn.Linear(cfg.d_model, H * D)
        self.value = nn.Linear(cfg.d_model, H * D)
        self.out = nn.Linear(H * D, cfg.d_model)
        self._decode_attn = decode_attn_fn or (
            kernels.decode_attention if use_kernels
            else reference.decode_attention
        )

    def forward(self, x, mask=None, cache=None, positions=None):
        cfg = self.cfg
        B, L, _ = x.shape
        H, D = cfg.num_heads, cfg.d_model // cfg.num_heads
        q = _dense(x, self.query, cfg.dtype).view(B, L, H, D)
        k = _dense(x, self.key, cfg.dtype).view(B, L, H, D)
        v = _dense(x, self.value, cfg.dtype).view(B, L, H, D)
        if cache is None:
            out = full_attention(q, k, v, mask, causal=True)
            new_kv = (k, v)
        else:
            k_cache, v_cache = cache  # (B, S, H, D), written in place
            rows = torch.arange(B, device=x.device)
            k_cache[rows, positions] = k[:, 0].to(k_cache.dtype)
            v_cache[rows, positions] = v[:, 0].to(v_cache.dtype)
            out = self._decode_attn(
                q, k_cache.to(q.dtype), v_cache.to(q.dtype), positions
            )
            new_kv = (k_cache, v_cache)
        out = _dense(out.reshape(B, L, H * D), self.out, cfg.dtype)
        out = F.dropout(out, cfg.dropout_rate, self.training)
        return out, new_kv


class DecoderBlock(nn.Module):
    """Pre-LN causal block with K/V threading."""

    def __init__(self, cfg: TransformerConfig, use_kernels: bool = True,
                 decode_attn_fn=None):
        super().__init__()
        self.cfg = cfg
        self.ln_attn = LayerNorm(cfg.d_model, cfg.ln_dtype,
                                 use_kernels=use_kernels)
        self.attn = CausalSelfAttention(cfg, use_kernels, decode_attn_fn)
        self.ln_mlp = LayerNorm(cfg.d_model, cfg.ln_dtype,
                                use_kernels=use_kernels)
        self.mlp_in = nn.Linear(cfg.d_model, cfg.d_ff)
        self.mlp_out = nn.Linear(cfg.d_ff, cfg.d_model)

    def forward(self, x, mask=None, cache=None, positions=None):
        cfg = self.cfg
        h, new_kv = self.attn(self.ln_attn(x).to(cfg.dtype), mask,
                              cache=cache, positions=positions)
        x = x + h
        h = _dense(self.ln_mlp(x), self.mlp_in, cfg.dtype)
        h = F.gelu(h, approximate="tanh")
        h = _dense(h, self.mlp_out, cfg.dtype)
        h = F.dropout(h, cfg.dropout_rate, self.training)
        return x + h, new_kv


class CausalLM(nn.Module):
    """GPT-style decoder-only LM; see the module docstring for its modes."""

    def __init__(self, cfg: TransformerConfig, use_kernels: bool = True,
                 decode_attn_fn=None):
        super().__init__()
        self.config = cfg
        self.token_embed = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.pos_embed = nn.Parameter(torch.zeros(cfg.max_len, cfg.d_model))
        self.blocks = nn.ModuleList(
            DecoderBlock(cfg, use_kernels, decode_attn_fn)
            for _ in range(cfg.num_layers)
        )
        self.ln_final = LayerNorm(cfg.d_model, cfg.ln_dtype,
                                  use_kernels=use_kernels)
        self.lm_bias = nn.Parameter(torch.zeros(cfg.vocab_size))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "CausalLM":
        """The flax initialisation: normal(0.02) embeddings and kernels,
        zero biases, unit LayerNorm scales — drawn from ``generator``."""
        for name, p in self.named_parameters():
            if name.endswith(".scale"):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
        return self

    def forward(self, tokens, mask=None, cache=None, positions=None,
                return_kv: bool = False):
        cfg = self.config
        decode = cache is not None
        x = self.token_embed(tokens).to(cfg.dtype)
        if decode:
            x = x + self.pos_embed[positions][:, None].to(cfg.dtype)
        else:
            x = x + self.pos_embed[: tokens.shape[1]].to(cfg.dtype)
        x = F.dropout(x, cfg.dropout_rate, self.training)
        kvs = []
        for i, block in enumerate(self.blocks):
            x, kv = block(x, mask, cache=cache[i] if decode else None,
                          positions=positions)
            kvs.append(kv)
        x = self.ln_final(x)
        logits = x.to(cfg.dtype) @ self.token_embed.weight.to(cfg.dtype).T
        logits = logits.float() + self.lm_bias
        if decode:
            return logits[:, 0], tuple(kvs)
        if return_kv:
            return logits, tuple(kvs)
        return logits


def _norm_dtype(kw: dict) -> dict:
    """model_kw rides in JSON manifests: dtype names become torch dtypes."""
    for key in ("dtype", "ln_dtype"):
        v = kw.get(key)
        if isinstance(v, str):
            kw[key] = _DTYPES[v]
    return kw


def gpt_tiny(num_classes: int = 0, use_kernels: bool = True,
             decode_attn_fn=None, **kw) -> CausalLM:
    """2-layer/64-wide causal decoder for tests and smoke runs."""
    del num_classes
    cfg = dict(vocab_size=256, max_len=64, d_model=64, num_heads=4,
               num_layers=2, d_ff=256, dtype=torch.float32)
    cfg.update(_norm_dtype(dict(kw)))
    return CausalLM(TransformerConfig(**cfg), use_kernels, decode_attn_fn)


def gpt_mini(num_classes: int = 0, use_kernels: bool = True,
             decode_attn_fn=None, **kw) -> CausalLM:
    """bert_tiny-sized decoder (4 layers / 128 wide, 1k vocab)."""
    del num_classes
    cfg = dict(vocab_size=1024, max_len=128, d_model=128, num_heads=4,
               num_layers=4, d_ff=512, dtype=torch.float32)
    cfg.update(_norm_dtype(dict(kw)))
    return CausalLM(TransformerConfig(**cfg), use_kernels, decode_attn_fn)
