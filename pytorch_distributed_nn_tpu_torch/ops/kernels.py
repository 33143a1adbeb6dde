"""Bindings and dispatch of the port's hand-written Hopper kernels.

The counterpart of ``pytorch_distributed_nn_tpu/ops/pallas_kernels.py``:

====================  ========================  ==============================
kernel (count name)   CUDA source               TPU kernel it replaces
====================  ========================  ==============================
decode_attention      csrc/decode_attention.cu  ``_decode_attn_kernel``
layer_norm            csrc/layer_norm.cu        ``_ln_fwd_kernel``
layer_norm_bwd        csrc/layer_norm.cu        ``_ln_bwd_kernel``
flash_attention_fwd   csrc/flash_attention.cu   ``_flash_fwd_kernel_res``
flash_attention_dq    csrc/flash_attention.cu   ``_flash_dq_kernel_res``
flash_attention_dkv   csrc/flash_attention.cu   ``_flash_dkv_kernel_res``
quantize_int8_scaled  csrc/int8_quant.cu        ``_quant_scaled_kernel_prng``
                                                (one launch per group of
                                                up to 64 leaves)
quantize_int8         csrc/int8_quant.cu        ``_quant_kernel_prng``
                                                (one cooperative launch)
dequantize_int8       csrc/int8_quant.cu        ``_dequant_kernel``
====================  ========================  ==============================

:func:`flash_attention` and :func:`layer_norm` are differentiable
(``torch.autograd.Function``): their forward and backward launch the
kernels on CUDA tensors. The three flash kernels run on the tensor cores
for both dtypes (``mma.sync``): bf16 operands as they are
(``*_tc_kernel``), f32 ones each split into two TF32 terms and multiplied
as three TF32 products, to f32 accuracy (``*_3xtf32_kernel``); one count
each either way. ``layer_norm`` outside autograd (serving, eval)
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
from typing import Dict, List, Optional, Sequence

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
    "quantize_int8_scaled": {"lib": "int8_quant", "replaces": 907},
    "quantize_int8": {"lib": "int8_quant", "replaces": 822},
    "dequantize_int8": {"lib": "int8_quant", "replaces": 933},
}
for _k in KERNELS.values():
    _k["source"] = f"{_CSRC}/{_k['lib']}.cu"
    _k["replaces"] = f"{_PALLAS}:{_k['replaces']}"

LIBRARIES = sorted({k["lib"] for k in KERNELS.values()})

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

#: head dims the flash kernels are instantiated for: those of the port's
#: models (GptTiny 16, GptMini and BertTiny 32, BertBase 64)
FLASH_HEAD_DIMS = (16, 32, 64)

#: widths the vectorised LayerNorm kernels, forward and backward, are
#: instantiated for (``by_width`` in csrc/layer_norm.cu): the port's
#: models' (GptTiny 64, GptMini and BertTiny 128, BertBase 768); the
#: general kernels take any other width
LN_WIDTHS = (64, 128, 768)

#: leaves one grouped quantize launch covers (``kGroupLeaves`` in
#: csrc/int8_quant.cu: the descriptor table is the kernel's parameter)
QUANT_GROUP_LEAVES = 64

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_U = ctypes.c_uint
_PP = ctypes.POINTER(ctypes.c_void_p)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


_SIGNATURES = {
    "decode_attention": {
        "pdtn_decode_attention": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  *[_LL] * 8, _F, *[_I] * 6, _P],
    },
    "layer_norm": {
        "pdtn_layer_norm_fwd": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _LL, _I,
                                _F, _P],
        "pdtn_layer_norm_bwd": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                                _P, _LL, _I, _P],
        "pdtn_layer_norm_bwd_partial_rows": [_I, _I, _LL, _I, _I],
    },
    "flash_attention": {
        "pdtn_flash_fwd": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                           *[_LL] * 9, _F, _P],
        "pdtn_flash_dq": [_I, _I, _I, *[_P] * 8, _I, _I, _I, *[_LL] * 12,
                          _F, _P],
        "pdtn_flash_dkv": [_I, _I, _I, *[_P] * 9, _I, _I, _I, *[_LL] * 12,
                           _F, _P],
    },
    "int8_quant": {
        "pdtn_quantize_int8_scaled_group": [
            _I, _PP, _PP, _PP, ctypes.POINTER(_LL), ctypes.POINTER(_U),
            ctypes.POINTER(_I), _P],
        "pdtn_quantize_int8_blocks": [_LL],
        "pdtn_quantize_int8_register_elements": [],
        "pdtn_quantize_int8": [_P, _P, _P, _P, _LL, _U, _I, _I, _P],
        "pdtn_dequantize_int8": [_P, _P, _P, _LL, _I, _P],
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
    """The current stream of t's card as a raw handle (what
    ``torch.cuda.current_stream(t.device).cuda_stream`` gives, without
    building a ``Stream`` object on every launch)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


# -- decode attention ----------------------------------------------------

#: head dims the decode kernel is compiled for with q in registers (GptTiny
#: 16, GptMini 32, BertBase 64); any other D <= 256 takes its general
#: instantiation
DECODE_HEAD_DIMS = (16, 32, 64)
#: warps a block of the decode kernel may have (csrc/decode_attention.cu)
_DECODE_MAX_WARPS = 16
#: keys a warp takes when a head is split over several
_DECODE_KEYS_PER_WARP = 128
#: a block's staging for K and V: one warp per head stages both of a short
#: cache at once in it; the warps of a split head share it for their tiles
_DECODE_STAGE_BYTES = 96 * 1024


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def decode_launch_plan(B: int, H: int, S: int, D: int,
                       elem: int) -> Dict[str, int]:
    """The decode kernel's launch geometry for a (B, S, H, D) cache of
    ``elem``-byte elements, a pure function of the shapes: one block per
    (batch, head), B * H blocks of 32 * ``warps_per_head`` threads.

    - One warp per (batch, head) when the head's K and V rows (S rounded
      up to 32, at most 128) fit :data:`_DECODE_STAGE_BYTES`: the warp
      stages both at once and passes no barrier.
    - Otherwise the keys are split over the block's ``warps_per_head``
      warps (128 keys a warp, up to 16 warps, fewer where their smallest
      tiles would not fit the staging; any S), each staging its share K
      tile by tile and then V, in tiles of ``tile_keys`` keys (a multiple
      of 32) under :data:`_DECODE_STAGE_BYTES`.

    Returns blocks, warps_per_head, keys_per_warp, tile_keys, together
    (1: K and V staged at once) and smem_bytes (the block's shared memory,
    as ``pdtn_decode_attention`` checks it). Raises ValueError for a head
    dim the kernel does not take."""
    if not 1 <= D <= 256:
        raise ValueError(f"decode_attention: head dim {D} not in [1, 256]")
    row = _round_up(D * elem, 16) + 16  # a row in shared memory, padded
    keys = _round_up(S, 32)
    extra = 8 * D + 8  # partial sums, q and the statistics of a warp
    if keys <= _DECODE_KEYS_PER_WARP and 2 * keys * row <= _DECODE_STAGE_BYTES:
        W, C, tile, together = 1, keys, keys, 1
    else:
        # the fewest warps that hold 128 keys each, at most as many as
        # whose smallest tiles (32 keys) fit the staging
        fit = _DECODE_STAGE_BYTES // (32 * row + extra)
        W = min(_DECODE_MAX_WARPS, fit, -(-S // _DECODE_KEYS_PER_WARP))
        C = _round_up(-(-S // W), 32)
        W = -(-S // C)  # no warp without keys
        tile = min(C, (_DECODE_STAGE_BYTES // W - extra) // row // 32 * 32)
        together = 0
    smem = W * ((2 if together else 1) * tile * row + extra)
    return {"blocks": B * H, "warps_per_head": W, "keys_per_warp": C,
            "tile_keys": tile, "together": together, "smem_bytes": smem}


def decode_vector_loads(k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the decode kernel stages k and v with 16-byte copies: every
    row of both starts on a 16-byte boundary (data pointer and batch,
    sequence and head strides) and is a whole number of 16 bytes long.
    Otherwise it stages them with scalar loads (the same kernel)."""
    elem = k.element_size()
    return all(t.data_ptr() % 16 == 0
               and all(st * elem % 16 == 0 for st in t.stride()[:-1])
               for t in (k, v)) and k.shape[-1] * elem % 16 == 0


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
    code = _dtype_code(q, "decode_attention")
    plan = decode_launch_plan(B, H, S, D, q.element_size())
    positions = positions.contiguous()
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
    lib = _lib("decode_attention")
    rc = lib.pdtn_decode_attention(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        positions.data_ptr(), out.data_ptr(), B, H, S, D,
        q.stride(0), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), 1.0 / math.sqrt(D),
        plan["warps_per_head"], plan["keys_per_warp"], plan["tile_keys"],
        plan["together"],
        int(decode_vector_loads(k, v)), plan["smem_bytes"], _stream(q),
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


def _ln_vec(D: int, *ptrs: int) -> bool:
    """D among :data:`LN_WIDTHS` and every pointer on a 16-byte boundary."""
    low = 0
    for p in ptrs:
        low |= p
    return D in LN_WIDTHS and low % 16 == 0


def layer_norm_fwd_vectorised(x: torch.Tensor, y: torch.Tensor,
                              gamma: torch.Tensor, beta: torch.Tensor) -> bool:
    """Which forward kernel takes these contiguous operands: the
    vectorised one (rows in registers; vector loads and stores, 16 bytes
    a lane for f32, 8 for bf16) when D is one of :data:`LN_WIDTHS` and x,
    y, gamma and beta start on 16-byte boundaries (every row then does: D
    * elem is a multiple of 16), else the general one (scalar loads, any
    D). A dispatch on shape and alignment; both compute the same
    function."""
    return _ln_vec(x.shape[-1], x.data_ptr(), y.data_ptr(), gamma.data_ptr(),
                   beta.data_ptr())


_LN_FWD = None  # the bound C entry, looked up at the first launch


def _ln_forward(x, gamma, beta, eps, out_dtype, with_stats: bool):
    global _LN_FWD
    out_dtype = x.dtype if out_dtype is None else out_dtype
    D, N = _ln_params(x, gamma, beta)
    in_code = _dtype_code(x, "layer_norm input")
    out = torch.empty_like(x, dtype=out_dtype,
                           memory_format=torch.contiguous_format)
    out_code = _dtype_code(out, "layer_norm output")
    mu = rs = None
    if with_stats:
        mu = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
        rs = torch.empty_like(mu)
    if N == 0:
        return out, mu, rs
    if not x.is_contiguous():
        x = x.contiguous()
    if not gamma.is_contiguous():
        gamma = gamma.contiguous()
    if not beta.is_contiguous():
        beta = beta.contiguous()
    if _LN_FWD is None:
        _LN_FWD = _lib("layer_norm").pdtn_layer_norm_fwd
    px, pg, pb, py = (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                      out.data_ptr())
    rc = _LN_FWD(in_code, out_code, _ln_vec(D, px, pg, pb, py), px, pg, pb,
                 py, mu.data_ptr() if with_stats else None,
                 rs.data_ptr() if with_stats else None, N, D, float(eps),
                 _stream(x))
    _check(_BOUND["layer_norm"], "layer_norm", rc)
    return out, mu, rs


def layer_norm_fwd(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   eps: float = 1e-6, out_dtype=None):
    """(y, mu, rs): the forward kernel with the statistics the backward
    needs (mu, rs f32 of x's leading shape). One count per call; the
    kernel is chosen by :func:`layer_norm_fwd_vectorised`."""
    if _on_cpu(x, gamma, beta):
        return reference.layer_norm_fwd(x, gamma, beta, eps, out_dtype)
    return _ln_forward(x, gamma, beta, eps, out_dtype, with_stats=True)


def layer_norm_bwd_vectorised(x: torch.Tensor, dy: torch.Tensor,
                              dx: torch.Tensor) -> bool:
    """Which backward kernel takes these contiguous operands: the
    vectorised one (rows in registers, 16-byte loads) when D is one of
    :data:`LN_WIDTHS` and x, dy and dx start on 16-byte boundaries
    (every row then does: D * elem is a multiple of 16), else the general
    one (scalar loads, any D). A dispatch on shape and alignment; both
    compute the same function."""
    return _ln_vec(x.shape[-1], x.data_ptr(), dy.data_ptr(), dx.data_ptr())


def layer_norm_bwd(x: torch.Tensor, gamma: torch.Tensor, mu: torch.Tensor,
                   rs: torch.Tensor, dy: torch.Tensor):
    """(dx in x's dtype, dgamma, dbeta): the backward kernel's dx, and
    its per-block partial rows of dgamma / dbeta summed in a fixed order
    by its second kernel (the JAX package sums its partials outside the
    kernel). One count per call; the kernel is chosen by
    :func:`layer_norm_bwd_vectorised`."""
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
    x2, dy2 = x.contiguous(), dy.contiguous()
    mu, rs, gamma = mu.contiguous(), rs.contiguous(), gamma.contiguous()
    vec = int(layer_norm_bwd_vectorised(x2, dy2, dx))
    P = lib.pdtn_layer_norm_bwd_partial_rows(x_code, dy_code, N, D, vec)
    if P < 1:
        raise RuntimeError(f"layer_norm_bwd: no partial rows for N={N}, "
                           f"D={D} (vectorised={vec})")
    part = torch.empty((2, P, D), dtype=torch.float32, device=x.device)
    dgdb = torch.empty((2, D), dtype=torch.float32, device=x.device)
    rc = lib.pdtn_layer_norm_bwd(
        x_code, dy_code, vec, x2.data_ptr(), dy2.data_ptr(), mu.data_ptr(),
        rs.data_ptr(), gamma.data_ptr(), dx.data_ptr(), part.data_ptr(), P,
        dgdb.data_ptr(), N, D, _stream(x),
    )
    _check(lib, "layer_norm_bwd", rc)
    return dx, dgdb[0], dgdb[1]


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


def _flash_operand(t: torch.Tensor) -> torch.Tensor:
    """An operand as the flash kernels read it: their 16-byte ``cp.async``
    copies read whole rows, so D contiguous and every row starting on a
    16-byte boundary (data pointer, and batch / sequence / head strides
    multiples of the 8 bf16 or 4 f32 elements of 16 bytes). Anything else
    is copied into a fresh contiguous tensor."""
    elems = 16 // t.element_size()
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 \
            and all(s % elems == 0 for s in t.stride()[:-1]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        causal: bool = False):
    """(out (B, L, H, D), lse (B, H, L) f32) of the forward kernel (bf16,
    or f32 as three TF32 products). q, k and v are read in place through
    their strides (see :func:`_flash_operand`)."""
    if _on_cpu(q, k, v, mask):
        return reference.flash_attention_fwd(q, k, v, mask, causal)
    q, k, v = map(_flash_operand, (q, k, v))
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
    q, k, v, dout = map(_flash_operand, (q, k, v, dout))
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


# -- int8 gradient codec --------------------------------------------------


def _int8_operands(x: torch.Tensor, what: str):
    if x.dtype != torch.float32:
        raise TypeError(f"{what}: x must be float32, got {x.dtype}")
    return x.contiguous()


def _scale_tensor(scale, device) -> torch.Tensor:
    s = torch.as_tensor(scale, dtype=torch.float32, device=device)
    if s.numel() != 1:
        raise ValueError(f"scale must hold one value, got shape "
                         f"{tuple(s.shape)}")
    return s.reshape(1)


def _aligned(*pairs) -> int:
    """1 when every (tensor, bytes) pair's data starts on that boundary:
    the kernels then move whole quads with vector loads and stores."""
    return int(all(t.data_ptr() % b == 0 for t, b in pairs))


def quantize_int8_scaled_group(xs: Sequence[torch.Tensor], scales,
                               seeds: Sequence[int]) -> List[torch.Tensor]:
    """Stochastic int8 rounding of a group of leaves, each with its given
    scale: ``q_i = clip(floor(x_i / scale_i + u_i), -127, 127)``, x_i f32
    of any shape -> int8 of x_i's shape. ``scales`` holds one f32 value per
    leaf: a (k,) tensor, or a sequence of one-value tensors (read on the
    device, no host sync) or numbers; ``u_i`` comes from Philox4x32-10
    keyed by the 32-bit ``seeds[i]`` (:func:`.reference.philox_uniform`),
    numbered within the leaf. One launch, counted once, covers up to
    :data:`QUANT_GROUP_LEAVES` non-empty leaves."""
    xs, seeds = list(xs), list(seeds)
    if torch.is_tensor(scales):
        scales = scales.reshape(-1).unbind()
    scales = list(scales)
    if not len(xs) == len(scales) == len(seeds):
        raise ValueError(f"quantize_int8_scaled_group: {len(xs)} leaves, "
                         f"{len(scales)} scales, {len(seeds)} seeds")
    if not xs:
        return []
    if _on_cpu(*xs, *(s for s in scales if torch.is_tensor(s))):
        return reference.quantize_int8_scaled_group(xs, scales, seeds)
    device = xs[0].device
    xs = [_int8_operands(x, "quantize_int8_scaled") for x in xs]
    scales = [_scale_tensor(s, device) for s in scales]
    qs = [torch.empty(x.shape, dtype=torch.int8, device=device) for x in xs]
    live = [i for i, x in enumerate(xs) if x.numel()]
    lib = _lib("int8_quant")
    for start in range(0, len(live), QUANT_GROUP_LEAVES):
        idx = live[start:start + QUANT_GROUP_LEAVES]
        k = len(idx)
        ptrs = [(ctypes.c_void_p * k)(*(t[i].data_ptr() for i in idx))
                for t in (xs, qs, scales)]
        rc = lib.pdtn_quantize_int8_scaled_group(
            k, *ptrs, (_LL * k)(*(xs[i].numel() for i in idx)),
            (_U * k)(*(int(seeds[i]) & 0xFFFFFFFF for i in idx)),
            (_I * k)(*(_aligned((xs[i], 16), (qs[i], 4)) for i in idx)),
            _stream(xs[0]))
        _check(lib, "quantize_int8_scaled", rc)
    return qs


def quantize_int8_scaled(x: torch.Tensor, scale, seed: int) -> torch.Tensor:
    """Stochastic int8 rounding with a given scale: ``clip(floor(x / scale
    + u), -127, 127)``, x f32 of any shape -> int8 of x's shape. ``scale``
    is a one-value f32 tensor (read on the device, no host sync) or a
    number; ``u`` comes from Philox4x32-10 keyed by the 32-bit ``seed``
    (:func:`.reference.philox_uniform`). A group of one leaf
    (:func:`quantize_int8_scaled_group`)."""
    return quantize_int8_scaled_group([x], [scale], [seed])[0]


def quantize_int8_register_elements() -> int:
    """Elements the own-scale quantize holds in registers across its grid
    barrier on this card; a larger x takes a second pass over its
    remaining quads inside the same launch."""
    held = _lib("int8_quant").pdtn_quantize_int8_register_elements()
    if held < 1:
        raise RuntimeError("quantize_int8: no resident blocks on this card")
    return held


def quantize_int8(x: torch.Tensor, seed: int):
    """One-pass int8 quantization with its own scale: (q int8 of x's
    shape, scale 0-d f32) with ``scale = max|x| / 127`` (1 for an all-zero
    x) and the rounding of :func:`quantize_int8_scaled`. One cooperative
    launch, its grid sized by the C entry; its per-block partial amax
    scratch is written before it is read, so nothing is zeroed first."""
    if _on_cpu(x):
        return reference.quantize_int8(x, seed=seed)
    x2 = _int8_operands(x, "quantize_int8")
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.ones((), dtype=torch.float32, device=x.device)
    n = x2.numel()
    if n == 0:
        return q, scale
    lib = _lib("int8_quant")
    blocks = lib.pdtn_quantize_int8_blocks(n)
    if blocks < 1:
        raise RuntimeError("quantize_int8: no resident blocks on this card")
    partial = torch.empty(blocks, dtype=torch.float32, device=x.device)
    rc = lib.pdtn_quantize_int8(
        x2.data_ptr(), q.data_ptr(), scale.data_ptr(), partial.data_ptr(), n,
        int(seed) & 0xFFFFFFFF, _aligned((x2, 16), (q, 4)), blocks,
        _stream(x))
    _check(lib, "quantize_int8", rc)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale) -> torch.Tensor:
    """``q * scale`` in f32, q int8 of any shape, scale one f32 value."""
    if _on_cpu(q) and not (torch.is_tensor(scale) and scale.is_cuda):
        return reference.dequantize_int8(q, scale)
    if q.device.type != "cuda":
        raise ValueError(f"dequantize_int8: q on {q.device}, scale on the "
                         "card")
    if q.dtype != torch.int8:
        raise TypeError(f"dequantize_int8: q must be int8, got {q.dtype}")
    q2 = q.contiguous()
    s = _scale_tensor(scale, q.device)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    n = q2.numel()
    if n == 0:
        return out
    lib = _lib("int8_quant")
    rc = lib.pdtn_dequantize_int8(q2.data_ptr(), s.data_ptr(), out.data_ptr(),
                                  n, _aligned((q2, 4), (out, 16)), _stream(q))
    _check(lib, "dequantize_int8", rc)
    return out
