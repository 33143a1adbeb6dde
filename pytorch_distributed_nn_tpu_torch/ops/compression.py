"""Host-side int8 weight codec: the inverse the artifact reader needs
(``pytorch_distributed_nn_tpu/ops/compression.py``'s
``dequantize_int8_host``). The gradient-compression collectives are not
ported yet."""

from __future__ import annotations

import numpy as np


def dequantize_int8_host(q: np.ndarray, scale, dtype=np.float32) -> np.ndarray:
    """``q * scale`` in f32, cast to ``dtype`` — the exact inverse map of
    the JAX package's ``quantize_int8_host`` (up to quantization error)."""
    return (np.asarray(q, np.float32) * np.float32(scale)).astype(dtype)
