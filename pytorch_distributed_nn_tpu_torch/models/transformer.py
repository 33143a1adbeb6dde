"""The transformer family in PyTorch: the port of
``pytorch_distributed_nn_tpu/models/transformer.py``.

Two models, with the flax modules' architecture, parameter shapes and
arithmetic: ``BertMLM`` (the pre-LN encoder with the BERT masked-LM head,
``bert_base``/``bert_tiny``) and ``CausalLM`` (the GPT-style decoder,
``gpt_tiny``/``gpt_mini``). Shared by both: LayerNorm eps 1e-6 with its
output in ``ln_dtype`` (f32) then cast to ``dtype``, tanh-approximated
GELU (flax's ``nn.gelu`` default), projections as ``flax.Dense(dtype=...)``
(inputs and weights cast to ``dtype``), a tied head (``logits = x @
embed.T`` in ``dtype``, then f32, plus the head bias), softmax statistics
in f32, the position embedding ``pos[:L]`` cast to ``dtype``. Parameter
names follow the flax tree (``scale``/``bias`` for LayerNorm) so
:mod:`.convert` maps one onto the other leaf by leaf.

The masked-LM head: ``mlm_transform`` (a Dense with a zero-initialised
bias) -> GELU -> ``mlm_ln`` with f32 output -> the tied vocab projection
(or ``mlm_out`` when ``tie_embeddings`` is off) -> f32 plus ``mlm_bias``.

``CausalLM`` has three call modes, as in the JAX package:

- full: ``model(tokens, mask=None)`` -> ``(B, L, vocab)`` f32 logits;
- prefill: ``return_kv=True`` also returns per-layer ``(k, v)``, each
  ``(B, L, H, D)``;
- decode: ``cache=((k, v), ...)`` with each ``(B, S, H, D)`` and
  ``positions`` (B,) int32: tokens is ``(B, 1)``; each row's new K/V are
  written into the cache at its position (in place: the caller passes
  tensors it owns) before attention runs; returns
  ``(next_logits (B, vocab), cache)``.

Kernels: LayerNorm (forward and, under autograd, backward) and decode
attention go through the hand-written kernels of :mod:`..ops.kernels`
(their plain versions on CPU tensors). Attention over a whole sequence
(training, prefill, the encoder) is ``attn_fn``, as the JAX modules'
argument of that name: ``full_attention`` (plain PyTorch, what XLA ran)
by default, or ``kernels.flash_attention``, the port of
``pallas_attention``. With ``use_kernels=False`` LayerNorm and decode
attention use the plain versions on any device: the reference that
``chip_smoke.py`` holds the kernel model against. ``decode_attn_fn``
overrides the decode attention alone. Projections, the MLP and the head
are plain PyTorch, as they were plain XLA (no Pallas kernel).

Dropout draws from an explicit ``torch.Generator``
(:meth:`set_dropout_generator`; the trainer seeds it from ``--seed``),
never from the global RNG; a model in training mode with a non-zero rate
and no generator raises.
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
    """The transformer family's fields (defaults: BERT-base widths)."""

    vocab_size: int = 30522
    max_len: int = 512
    d_model: int = 768
    num_heads: int = 12
    num_layers: int = 12
    d_ff: int = 3072
    dropout_rate: float = 0.1
    dtype: Any = torch.bfloat16
    causal: bool = False
    tie_embeddings: bool = True
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


def dense(x: torch.Tensor, layer: nn.Linear, dtype) -> torch.Tensor:
    """flax ``Dense(dtype=...)``: inputs and parameters cast to ``dtype``."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class Dropout(nn.Module):
    """flax ``nn.Dropout``: keep each element with probability 1 - rate
    and scale it by 1 / (1 - rate); the draws come from ``generator``."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError(
                "dropout in training mode needs a torch.Generator: call "
                "model.set_dropout_generator(gen)"
            )
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < 1.0 - self.rate
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with f32 statistics, backed by the
    hand-written kernels; ``out_dtype`` is written directly."""

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


class MultiHeadAttention(nn.Module):
    """Multi-head self-attention over a whole sequence through
    ``attn_fn`` (default :func:`full_attention`)."""

    def __init__(self, cfg: TransformerConfig, attn_fn=None):
        super().__init__()
        self.cfg = cfg
        H, D = cfg.num_heads, cfg.d_model // cfg.num_heads
        self.query = nn.Linear(cfg.d_model, H * D)
        self.key = nn.Linear(cfg.d_model, H * D)
        self.value = nn.Linear(cfg.d_model, H * D)
        self.out = nn.Linear(H * D, cfg.d_model)
        self.dropout = Dropout(cfg.dropout_rate)
        self._attn = attn_fn or full_attention
        self.causal = cfg.causal

    def _qkv(self, x):
        B, L, _ = x.shape
        H, D = self.cfg.num_heads, self.cfg.d_model // self.cfg.num_heads
        return tuple(dense(x, layer, self.cfg.dtype).view(B, L, H, D)
                     for layer in (self.query, self.key, self.value))

    def _out(self, o):
        B, L = o.shape[:2]
        return self.dropout(dense(o.reshape(B, L, -1), self.out,
                                   self.cfg.dtype))

    def forward(self, x, mask=None):
        q, k, v = self._qkv(x)
        return self._out(self._attn(q, k, v, mask, causal=self.causal))


class CausalSelfAttention(MultiHeadAttention):
    """Causal attention with the decoder's KV-cache decode mode."""

    def __init__(self, cfg: TransformerConfig, use_kernels: bool = True,
                 decode_attn_fn=None, attn_fn=None):
        super().__init__(cfg, attn_fn)
        self.causal = True
        self._decode_attn = decode_attn_fn or (
            kernels.decode_attention if use_kernels
            else reference.decode_attention
        )

    def forward(self, x, mask=None, cache=None, positions=None):
        q, k, v = self._qkv(x)
        if cache is None:
            return self._out(self._attn(q, k, v, mask, causal=True)), (k, v)
        k_cache, v_cache = cache  # (B, S, H, D), written in place
        rows = torch.arange(x.shape[0], device=x.device)
        k_cache[rows, positions] = k[:, 0].to(k_cache.dtype)
        v_cache[rows, positions] = v[:, 0].to(v_cache.dtype)
        out = self._decode_attn(q, k_cache.to(q.dtype), v_cache.to(q.dtype),
                                positions)
        return self._out(out), (k_cache, v_cache)


class EncoderBlock(nn.Module):
    """Pre-LN transformer block."""

    def __init__(self, cfg: TransformerConfig, use_kernels: bool = True,
                 attn_fn=None, attn: Optional[nn.Module] = None):
        super().__init__()
        self.cfg = cfg
        self.ln_attn = LayerNorm(cfg.d_model, cfg.ln_dtype,
                                 use_kernels=use_kernels)
        self.attn = attn if attn is not None \
            else MultiHeadAttention(cfg, attn_fn)
        self.ln_mlp = LayerNorm(cfg.d_model, cfg.ln_dtype,
                                use_kernels=use_kernels)
        self.mlp_in = nn.Linear(cfg.d_model, cfg.d_ff)
        self.mlp_out = nn.Linear(cfg.d_ff, cfg.d_model)
        self.dropout = Dropout(cfg.dropout_rate)

    def _mlp(self, x):
        dtype = self.cfg.dtype
        h = F.gelu(dense(self.ln_mlp(x), self.mlp_in, dtype),
                   approximate="tanh")
        return x + self.dropout(dense(h, self.mlp_out, dtype))

    def forward(self, x, mask=None):
        x = x + self.attn(self.ln_attn(x).to(self.cfg.dtype), mask)
        return self._mlp(x)


class DecoderBlock(EncoderBlock):
    """Pre-LN causal block with K/V threading."""

    def __init__(self, cfg: TransformerConfig, use_kernels: bool = True,
                 decode_attn_fn=None, attn_fn=None):
        super().__init__(cfg, use_kernels, attn=CausalSelfAttention(
            cfg, use_kernels, decode_attn_fn, attn_fn))

    def forward(self, x, mask=None, cache=None, positions=None):
        h, new_kv = self.attn(self.ln_attn(x).to(self.cfg.dtype), mask,
                              cache=cache, positions=positions)
        return self._mlp(x + h), new_kv


class _Model(nn.Module):
    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
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

    def set_dropout_generator(self, generator: Optional[torch.Generator]):
        """Every dropout of the model draws from ``generator`` (on the
        model's device)."""
        for m in self.modules():
            if isinstance(m, Dropout):
                m.generator = generator
        return self

    def _embed(self, tokens, positions=None):
        cfg = self.config
        x = self.token_embed(tokens).to(cfg.dtype)
        if positions is not None:
            x = x + self.pos_embed[positions][:, None].to(cfg.dtype)
        else:
            x = x + self.pos_embed[: tokens.shape[1]].to(cfg.dtype)
        return self.dropout(x)

    def _tied_logits(self, x, bias):
        dtype = self.config.dtype
        logits = x.to(dtype) @ self.token_embed.weight.to(dtype).T
        return logits.float() + bias


class TransformerEncoder(_Model):
    """Token + position embeddings -> pre-LN blocks -> final LayerNorm."""

    def __init__(self, cfg: TransformerConfig, use_kernels: bool = True,
                 attn_fn=None):
        super().__init__()
        self.config = cfg
        self.token_embed = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.pos_embed = nn.Parameter(torch.zeros(cfg.max_len, cfg.d_model))
        self.dropout = Dropout(cfg.dropout_rate)
        self.blocks = nn.ModuleList(
            EncoderBlock(cfg, use_kernels, attn_fn)
            for _ in range(cfg.num_layers)
        )
        self.ln_final = LayerNorm(cfg.d_model, cfg.ln_dtype,
                                  use_kernels=use_kernels)

    def forward(self, tokens, mask=None):
        x = self._embed(tokens)
        for block in self.blocks:
            x = block(x, mask)
        return self.ln_final(x)


class BertMLM(_Model):
    """BERT-style masked LM: tokens (B, L) -> (B, L, vocab) f32 logits."""

    def __init__(self, cfg: TransformerConfig, use_kernels: bool = True,
                 attn_fn=None):
        super().__init__()
        self.config = cfg
        self.encoder = TransformerEncoder(cfg, use_kernels, attn_fn)
        self.mlm_transform = nn.Linear(cfg.d_model, cfg.d_model)
        self.mlm_ln = LayerNorm(cfg.d_model, torch.float32,
                                use_kernels=use_kernels)
        if not cfg.tie_embeddings:
            self.mlm_out = nn.Linear(cfg.d_model, cfg.vocab_size)
        self.mlm_bias = nn.Parameter(torch.zeros(cfg.vocab_size))

    def forward(self, tokens, mask=None):
        cfg = self.config
        x = self.encoder(tokens, mask)
        x = F.gelu(dense(x, self.mlm_transform, cfg.dtype),
                   approximate="tanh")
        x = self.mlm_ln(x)
        if cfg.tie_embeddings:
            return self.encoder._tied_logits(x, self.mlm_bias)
        return dense(x, self.mlm_out, cfg.dtype).float() + self.mlm_bias


class CausalLM(_Model):
    """GPT-style decoder-only LM; see the module docstring for its modes."""

    def __init__(self, cfg: TransformerConfig, use_kernels: bool = True,
                 decode_attn_fn=None, attn_fn=None):
        super().__init__()
        self.config = cfg
        self.token_embed = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.pos_embed = nn.Parameter(torch.zeros(cfg.max_len, cfg.d_model))
        self.dropout = Dropout(cfg.dropout_rate)
        self.blocks = nn.ModuleList(
            DecoderBlock(cfg, use_kernels, decode_attn_fn, attn_fn)
            for _ in range(cfg.num_layers)
        )
        self.ln_final = LayerNorm(cfg.d_model, cfg.ln_dtype,
                                  use_kernels=use_kernels)
        self.lm_bias = nn.Parameter(torch.zeros(cfg.vocab_size))

    def forward(self, tokens, mask=None, cache=None, positions=None,
                return_kv: bool = False):
        decode = cache is not None
        x = self._embed(tokens, positions if decode else None)
        kvs = []
        for i, block in enumerate(self.blocks):
            x, kv = block(x, mask, cache=cache[i] if decode else None,
                          positions=positions)
            kvs.append(kv)
        logits = self._tied_logits(self.ln_final(x), self.lm_bias)
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


def _config(defaults: dict, kw: dict) -> TransformerConfig:
    cfg = dict(defaults)
    cfg.update(_norm_dtype(dict(kw)))
    return TransformerConfig(**cfg)


def gpt_tiny(num_classes: int = 0, use_kernels: bool = True,
             decode_attn_fn=None, attn_fn=None, **kw) -> CausalLM:
    """2-layer/64-wide causal decoder for tests and smoke runs."""
    del num_classes
    cfg = _config(dict(vocab_size=256, max_len=64, d_model=64, num_heads=4,
                       num_layers=2, d_ff=256, dtype=torch.float32,
                       causal=True), kw)
    return CausalLM(cfg, use_kernels, decode_attn_fn, attn_fn)


def gpt_mini(num_classes: int = 0, use_kernels: bool = True,
             decode_attn_fn=None, attn_fn=None, **kw) -> CausalLM:
    """bert_tiny-sized decoder (4 layers / 128 wide, 1k vocab)."""
    del num_classes
    cfg = _config(dict(vocab_size=1024, max_len=128, d_model=128,
                       num_heads=4, num_layers=4, d_ff=512,
                       dtype=torch.float32, causal=True), kw)
    return CausalLM(cfg, use_kernels, decode_attn_fn, attn_fn)


def bert_base(num_classes: int = 0, use_kernels: bool = True, attn_fn=None,
              **kw) -> BertMLM:
    """BERT-base MLM (110M params): the config's defaults."""
    del num_classes
    return BertMLM(_config({}, kw), use_kernels, attn_fn)


def bert_tiny(num_classes: int = 0, use_kernels: bool = True, attn_fn=None,
              **kw) -> BertMLM:
    """4-layer/128-wide variant for tests and CPU smoke runs."""
    del num_classes
    cfg = _config(dict(vocab_size=1024, max_len=128, d_model=128,
                       num_heads=4, num_layers=4, d_ff=512), kw)
    return BertMLM(cfg, use_kernels, attn_fn)
