"""Bindings and dispatch of the port's hand-written Hopper kernels.

The counterpart of ``pytorch_distributed_nn_tpu/ops/pallas_kernels.py``:

===================  ========================  ==============================
kernel (count name)  CUDA source               TPU kernel it replaces
===================  ========================  ==============================
decode_attention     csrc/decode_attention.cu  ``_decode_attn_kernel``
layer_norm           csrc/layer_norm.cu        ``_ln_fwd_kernel``
layer_norm_bwd       csrc/layer_norm.cu        ``_ln_bwd_kernel``
flash_attention_fwd  csrc/flash_attention.cu   ``_flash_fwd_kernel_res``
flash_attention_dq   csrc/flash_attention.cu   ``_flash_dq_kernel_res``
flash_attention_dkv  csrc/flash_attention.cu   ``_flash_dkv_kernel_res``
===================  ========================  ==============================

:func:`flash_attention` and :func:`layer_norm` are differentiable
(``torch.autograd.Function``): their forward and backward launch the
kernels on CUDA tensors. ``layer_norm`` outside autograd (serving, eval)
launches the forward alone, without the mu/rs the backward needs.

Dispatch is by the tensors' device: CPU tensors go to the plain version
in :mod:`.reference`, CUDA tensors to the kernel. A kernel that fails to
build or launch raises; nothing falls back to the plain version.

Each wrapper adds one to ``LAUNCHES[name]`` where it launches its
kernel, and nowhere else, so a run can show that its path went through
the kernels (:func:`reset_launch_counts`, :func:`launch_counts`).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from pytorch_distributed_nn_tpu_torch.ops import reference

_PALLAS = "pytorch_distributed_nn_tpu/ops/pallas_kernels.py"
_CSRC = "pytorch_distributed_nn_tpu_torch/ops/csrc"

#: kernel name -> its library (CUDA source ops/csrc/<lib>.cu) and the TPU
#: kernel it replaces (file:line of its ``pl.pallas_call``)
KERNELS = {
    "decode_attention": {"lib": "decode_attention", "replaces": 751},
    "layer_norm": {"lib": "layer_norm", "replaces": 1032},
    "layer_norm_bwd": {"lib": "layer_norm", "replaces": 1067},
    "flash_attention_fwd": {"lib": "flash_attention", "replaces": 201},
    "flash_attention_dq": {"lib": "flash_attention", "replaces": 544},
    "flash_attention_dkv": {"lib": "flash_attention", "replaces": 556},
}
for _k in KERNELS.values():
    _k["source"] = f"{_CSRC}/{_k['lib']}.cu"
    _k["replaces"] = f"{_PALLAS}:{_k['replaces']}"

LIBRARIES = sorted({k["lib"] for k in KERNELS.values()})

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

#: head dims the flash kernels are instantiated for: those of the port's
#: models (GptTiny 16, GptMini and BertTiny 32, BertBase 64)
FLASH_HEAD_DIMS = (16, 32, 64)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


_SIGNATURES = {
    "decode_attention": {
        "pdtn_decode_attention": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  *[_LL] * 8, _F, _P],
    },
    "layer_norm": {
        "pdtn_layer_norm_fwd": [_I, _I, _P, _P, _P, _P, _P, _P, _LL, _I, _F,
                                _P],
        "pdtn_layer_norm_bwd": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _LL,
                                _I, _P],
        "pdtn_layer_norm_bwd_rows_per_block": [],
    },
    "flash_attention": {
        "pdtn_flash_fwd": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                           *[_LL] * 9, _F, _P],
        "pdtn_flash_dq": [_I, _I, _I, *[_P] * 8, _I, _I, _I, *[_LL] * 12,
                          _F, _P],
        "pdtn_flash_dkv": [_I, _I, _I, *[_P] * 9, _I, _I, _I, *[_LL] * 12,
                           _F, _P],
    },
}

_BOUND: Dict[str, ctypes.CDLL] = {}


def _lib(name: str) -> ctypes.CDLL:
    """The kernel library ``name`` with its C signatures declared (built
    and loaded at first use)."""
    lib = _BOUND.get(name)
    if lib is not None:
        return lib
    from pytorch_distributed_nn_tpu_torch.utils.native_build import (
        load_kernel,
    )

    lib = load_kernel(name)
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).restype = _I
        getattr(lib, fn).argtypes = argtypes
    _BOUND[name] = lib
    return lib


def build_all() -> None:
    """Build (in parallel) and load every kernel library of the package."""
    from pytorch_distributed_nn_tpu_torch.utils.native_build import (
        build_kernels,
    )

    build_kernels(LIBRARIES)
    for name in LIBRARIES:
        _lib(name)


def _check(lib: ctypes.CDLL, name: str, rc: int) -> None:
    if rc != 0:
        msg = lib.pdtn_cuda_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({rc})")
    LAUNCHES[name] += 1


def _dtype_code(t: torch.Tensor, what: str) -> int:
    code = _DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"{what}: dtype {t.dtype} not supported "
                        "(float32 or bfloat16)")
    return code


def _on_cpu(*tensors: Optional[torch.Tensor]) -> bool:
    tensors = [t for t in tensors if t is not None]
    devs = {t.device.type for t in tensors}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(f"tensors must all lie on one CPU or CUDA device, got "
                     f"{sorted(str(t.device) for t in tensors)}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# -- decode attention ----------------------------------------------------


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
    """Single-position decode attention: q (B, 1, H, D), k/v (B, S, H, D)
    in q's dtype, positions (B,) int32 -> (B, 1, H, D). The cache is read
    in place through its strides (its last axis must be contiguous)."""
    if _on_cpu(q, k, v, positions):
        return reference.decode_attention(q, k, v, positions)
    B, one, H, D = q.shape
    S = k.shape[1]
    if one != 1 or k.shape != (B, S, H, D) or v.shape != k.shape:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("decode_attention: q, k and v must share a dtype")
    if positions.dtype != torch.int32 or positions.shape != (B,):
        raise TypeError("decode_attention: positions must be (B,) int32")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("decode_attention: the head axis (D) must be "
                         "contiguous")
    if D > 256:
        raise ValueError(f"decode_attention: head dim {D} > 256")
    code = _dtype_code(q, "decode_attention")
    positions = positions.contiguous()
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
    lib = _lib("decode_attention")
    rc = lib.pdtn_decode_attention(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        positions.data_ptr(), out.data_ptr(), B, H, S, D,
        q.stride(0), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), 1.0 / math.sqrt(D),
        _stream(q),
    )
    _check(lib, "decode_attention", rc)
    return out


# -- LayerNorm -----------------------------------------------------------


def _ln_params(x, gamma, beta=None):
    D = x.shape[-1]
    for p in (gamma, beta):
        if p is not None and (p.shape != (D,) or p.dtype != torch.float32):
            raise TypeError("layer_norm: gamma and beta must be (D,) float32")
    return D, (x.numel() // D if D else 0)


def _ln_forward(x, gamma, beta, eps, out_dtype, with_stats: bool):
    out_dtype = x.dtype if out_dtype is None else out_dtype
    D, N = _ln_params(x, gamma, beta)
    in_code = _dtype_code(x, "layer_norm input")
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    out_code = _dtype_code(out, "layer_norm output")
    mu = rs = None
    if with_stats:
        mu = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
        rs = torch.empty_like(mu)
    if N == 0:
        return out, mu, rs
    x2 = x.contiguous()
    gamma, beta = gamma.contiguous(), beta.contiguous()
    lib = _lib("layer_norm")
    rc = lib.pdtn_layer_norm_fwd(
        in_code, out_code, x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        out.data_ptr(), mu.data_ptr() if with_stats else None,
        rs.data_ptr() if with_stats else None, N, D, float(eps), _stream(x),
    )
    _check(lib, "layer_norm", rc)
    return out, mu, rs


def layer_norm_fwd(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   eps: float = 1e-6, out_dtype=None):
    """(y, mu, rs): the forward kernel with the statistics the backward
    needs (mu, rs f32 of x's leading shape)."""
    if _on_cpu(x, gamma, beta):
        return reference.layer_norm_fwd(x, gamma, beta, eps, out_dtype)
    return _ln_forward(x, gamma, beta, eps, out_dtype, with_stats=True)


def layer_norm_bwd(x: torch.Tensor, gamma: torch.Tensor, mu: torch.Tensor,
                   rs: torch.Tensor, dy: torch.Tensor):
    """(dx in x's dtype, dgamma, dbeta): the backward kernel's dx and
    per-block partials, the partials summed here (``torch.sum``, as the
    JAX package sums them outside the kernel)."""
    if _on_cpu(x, gamma, mu, rs, dy):
        return reference.layer_norm_bwd(x, gamma, mu, rs, dy)
    D, N = _ln_params(x, gamma)
    if dy.shape != x.shape or mu.shape != x.shape[:-1] \
            or rs.shape != mu.shape:
        raise ValueError(f"layer_norm_bwd: shapes x {tuple(x.shape)}, dy "
                         f"{tuple(dy.shape)}, mu {tuple(mu.shape)}, rs "
                         f"{tuple(rs.shape)}")
    if mu.dtype != torch.float32 or rs.dtype != torch.float32:
        raise TypeError("layer_norm_bwd: mu and rs must be float32")
    x_code = _dtype_code(x, "layer_norm_bwd x")
    dy_code = _dtype_code(dy, "layer_norm_bwd dy")
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    if N == 0:
        zeros = torch.zeros(D, dtype=torch.float32, device=x.device)
        return dx, zeros, zeros.clone()
    lib = _lib("layer_norm")
    rows = lib.pdtn_layer_norm_bwd_rows_per_block()
    part = torch.empty((2, -(-N // rows), D), dtype=torch.float32,
                       device=x.device)
    x2, dy2 = x.contiguous(), dy.contiguous()
    mu, rs, gamma = mu.contiguous(), rs.contiguous(), gamma.contiguous()
    rc = lib.pdtn_layer_norm_bwd(
        x_code, dy_code, x2.data_ptr(), dy2.data_ptr(), mu.data_ptr(),
        rs.data_ptr(), gamma.data_ptr(), dx.data_ptr(), part[0].data_ptr(),
        part[1].data_ptr(), N, D, _stream(x),
    )
    _check(lib, "layer_norm_bwd", rc)
    sums = part.sum(dim=1)
    return dx, sums[0], sums[1]


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps, out_dtype):
        y, mu, rs = layer_norm_fwd(x, gamma, beta, eps, out_dtype)
        ctx.save_for_backward(x, gamma, mu, rs)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, mu, rs = ctx.saved_tensors
        dx, dgamma, dbeta = layer_norm_bwd(x, gamma, mu, rs, dy)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, dgamma if need[1] else None,
                dbeta if need[2] else None, None, None)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-6, out_dtype=None) -> torch.Tensor:
    """LayerNorm over the last axis with f32 statistics; the output is
    written directly in ``out_dtype`` (default: x's dtype). gamma and
    beta are (D,) float32. Differentiable in x, gamma and beta: under
    autograd the forward kernel also writes mu and rs, and the backward
    is the backward kernel."""
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                    or beta.requires_grad):
        _on_cpu(x, gamma, beta)
        return _LayerNorm.apply(x, gamma, beta, eps, out_dtype)
    if _on_cpu(x, gamma, beta):
        return reference.layer_norm(x, gamma, beta, eps, out_dtype)
    return _ln_forward(x, gamma, beta, eps, out_dtype, with_stats=False)[0]


# -- flash attention -----------------------------------------------------


def _pad_bias(mask: Optional[torch.Tensor], B: int, L: int, device):
    """(B, L) 1/0 pad mask -> the kernels' additive f32 bias (0 / -1e30)."""
    if mask is None:
        return None
    if mask.shape != (B, L):
        raise ValueError(f"flash_attention: mask must be (B, L) = {(B, L)}, "
                         f"got {tuple(mask.shape)}")
    return torch.where(mask.to(device=device, dtype=torch.bool), 0.0,
                       reference.NEG_INF).to(torch.float32).contiguous()


def _flash_check(q, k, v, *more):
    B, L, H, D = q.shape
    for t in (k, v, *more):
        if t.shape != q.shape:
            raise ValueError(f"flash_attention: shapes {tuple(q.shape)} and "
                             f"{tuple(t.shape)} differ (self-attention over "
                             "one length)")
        if t.dtype != q.dtype:
            raise TypeError("flash_attention: operands must share a dtype")
    if D not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in "
                         f"{FLASH_HEAD_DIMS}")
    if B * H > 65535:
        raise ValueError(f"flash_attention: B*H = {B * H} > 65535")
    return B, L, H, D, _dtype_code(q, "flash_attention")


def _strides(*tensors):
    out = []
    for t in tensors:
        out += [t.stride(0), t.stride(1), t.stride(2)]
    return out


def _inner_contiguous(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        causal: bool = False):
    """(out (B, L, H, D), lse (B, H, L) f32) of the forward kernel. q, k
    and v are read in place through their strides (D contiguous)."""
    if _on_cpu(q, k, v, mask):
        return reference.flash_attention_fwd(q, k, v, mask, causal)
    q, k, v = map(_inner_contiguous, (q, k, v))
    B, L, H, D, code = _flash_check(q, k, v)
    bias = _pad_bias(mask, B, L, q.device)
    out = torch.empty((B, L, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    lib = _lib("flash_attention")
    rc = lib.pdtn_flash_fwd(
        code, D, int(causal), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, H, L, *_strides(q, k, v), 1.0 / math.sqrt(D),
        _stream(q),
    )
    _check(lib, "flash_attention_fwd", rc)
    return out, lse


def _bwd_operands(q, k, v, mask, lse, delta, dout):
    q, k, v, dout = map(_inner_contiguous, (q, k, v, dout))
    B, L, H, D, code = _flash_check(q, k, v, dout)
    for t in (lse, delta):
        if t.shape != (B, H, L) or t.dtype != torch.float32:
            raise ValueError("flash_attention: lse and delta must be "
                             f"(B, H, L) = {(B, H, L)} float32")
    bias = _pad_bias(mask, B, L, q.device)
    return (q, k, v, dout, bias, lse.contiguous(), delta.contiguous(),
            (B, L, H, D, code))


def flash_attention_dq(q, k, v, mask, lse, delta, dout, causal=False):
    """dq (B, L, H, D) of the dq kernel, from the forward's lse and
    delta = rowsum(dO * O) (both (B, H, L) f32)."""
    if _on_cpu(q, k, v, mask, lse, delta, dout):
        return reference.flash_attention_dq(q, k, v, mask, lse, delta, dout,
                                            causal)
    q, k, v, dout, bias, lse, delta, (B, L, H, D, code) = _bwd_operands(
        q, k, v, mask, lse, delta, dout)
    dq = torch.empty((B, L, H, D), dtype=q.dtype, device=q.device)
    lib = _lib("flash_attention")
    rc = lib.pdtn_flash_dq(
        code, D, int(causal), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        dout.data_ptr(), None if bias is None else bias.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, H, L,
        *_strides(q, k, v, dout), 1.0 / math.sqrt(D), _stream(q),
    )
    _check(lib, "flash_attention_dq", rc)
    return dq


def flash_attention_dkv(q, k, v, mask, lse, delta, dout, causal=False):
    """(dk, dv), each (B, L, H, D), of the dk/dv kernel."""
    if _on_cpu(q, k, v, mask, lse, delta, dout):
        return reference.flash_attention_dkv(q, k, v, mask, lse, delta,
                                             dout, causal)
    q, k, v, dout, bias, lse, delta, (B, L, H, D, code) = _bwd_operands(
        q, k, v, mask, lse, delta, dout)
    dk = torch.empty((B, L, H, D), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    lib = _lib("flash_attention")
    rc = lib.pdtn_flash_dkv(
        code, D, int(causal), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        dout.data_ptr(), None if bias is None else bias.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, H, L, *_strides(q, k, v, dout), 1.0 / math.sqrt(D), _stream(q),
    )
    _check(lib, "flash_attention_dkv", rc)
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, causal):
        out, lse = flash_attention_fwd(q, k, v, mask, causal)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask, out, lse = ctx.saved_tensors
        delta = reference.flash_attention_delta(out, dout)
        dq = flash_attention_dq(q, k, v, mask, lse, delta, dout, ctx.causal)
        dk, dv = flash_attention_dkv(q, k, v, mask, lse, delta, dout,
                                     ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    causal: bool = False) -> torch.Tensor:
    """Blockwise softmax attention, q/k/v (B, L, H, D) -> (B, L, H, D),
    with an optional (B, L) pad mask (1 attend, 0 pad) and causal flag:
    the port's ``pallas_attention``. Differentiable: one forward launch,
    and one dq plus one dk/dv launch in the backward."""
    return _FlashAttention.apply(q, k, v, mask, causal)
