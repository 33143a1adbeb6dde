"""Bindings and dispatch of the port's hand-written Hopper kernels.

The counterpart of ``pytorch_distributed_nn_tpu/ops/pallas_kernels.py``
for the kernels the serving path runs:

==================  =======================  ================================
wrapper             CUDA source              TPU kernel it replaces
==================  =======================  ================================
decode_attention    csrc/decode_attention.cu ``_decode_attn_kernel``
layer_norm          csrc/layer_norm.cu       ``_ln_fwd_kernel``
==================  =======================  ================================

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
from typing import Dict

import torch

from pytorch_distributed_nn_tpu_torch.ops import reference

#: kernel name -> CUDA source (under ops/csrc/) and the TPU kernel it
#: replaces (file:line of its ``pl.pallas_call``)
KERNELS = {
    "decode_attention": {
        "source": "pytorch_distributed_nn_tpu_torch/ops/csrc/decode_attention.cu",
        "replaces": "pytorch_distributed_nn_tpu/ops/pallas_kernels.py:751",
    },
    "layer_norm": {
        "source": "pytorch_distributed_nn_tpu_torch/ops/csrc/layer_norm.cu",
        "replaces": "pytorch_distributed_nn_tpu/ops/pallas_kernels.py:1032",
    },
}

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


_BOUND: Dict[str, ctypes.CDLL] = {}


def _lib(name: str) -> ctypes.CDLL:
    """The kernel library ``name`` with its C signature declared (built
    and loaded at first use)."""
    lib = _BOUND.get(name)
    if lib is not None:
        return lib
    from pytorch_distributed_nn_tpu_torch.utils.native_build import (
        load_kernel,
    )

    lib = load_kernel(name)
    if name == "decode_attention":
        lib.pdtn_decode_attention.restype = _I
        lib.pdtn_decode_attention.argtypes = [
            _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
            _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, ctypes.c_float, _P,
        ]
    else:
        lib.pdtn_layer_norm_fwd.restype = _I
        lib.pdtn_layer_norm_fwd.argtypes = [
            _I, _I, _P, _P, _P, _P, _LL, _I, ctypes.c_float, _P,
        ]
    _BOUND[name] = lib
    return lib


def build_all() -> None:
    """Build (in parallel) and load every kernel library of the package."""
    from pytorch_distributed_nn_tpu_torch.utils.native_build import (
        build_kernels,
    )

    build_kernels(KERNELS)
    for name in KERNELS:
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


def _on_cpu(*tensors: torch.Tensor) -> bool:
    devs = {t.device.type for t in tensors}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(f"tensors must all lie on one CPU or CUDA device, got "
                     f"{sorted(str(t.device) for t in tensors)}")


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
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _check(lib, "decode_attention", rc)
    return out


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-6, out_dtype=None) -> torch.Tensor:
    """LayerNorm over the last axis with f32 statistics; the output is
    written directly in ``out_dtype`` (default: x's dtype). gamma and
    beta are (D,) float32."""
    if _on_cpu(x, gamma, beta):
        return reference.layer_norm(x, gamma, beta, eps, out_dtype)
    out_dtype = x.dtype if out_dtype is None else out_dtype
    D = x.shape[-1]
    if gamma.shape != (D,) or beta.shape != (D,) \
            or gamma.dtype != torch.float32 or beta.dtype != torch.float32:
        raise TypeError("layer_norm: gamma and beta must be (D,) float32")
    in_code = _dtype_code(x, "layer_norm input")
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    out_code = _dtype_code(out, "layer_norm output")
    N = x.numel() // D if D else 0
    if N == 0:
        return out
    x2 = x.contiguous()
    gamma, beta = gamma.contiguous(), beta.contiguous()
    lib = _lib("layer_norm")
    rc = lib.pdtn_layer_norm_fwd(
        in_code, out_code, x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        out.data_ptr(), N, D, float(eps),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _check(lib, "layer_norm", rc)
    return out
