"""ctypes binding of the native host codec (``native/codec.cpp``):
decompression of host-codec-compressed serving artifacts.

The port's own binding of the library the JAX package's
``ops/host_codec.py`` binds; the blob layout (a 16-byte header of
original size and shuffle width, then the payload) is the same. The
library is built from the checkout's ``native/`` sources at first use.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

_HEADER = np.dtype([("orig_size", "<u8"), ("width", "<u4"), ("pad", "<u4")])
_lib = None
_lock = threading.Lock()


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            from pytorch_distributed_nn_tpu_torch.utils.native_build import (
                ensure_native,
            )

            lib = ctypes.CDLL(ensure_native("libpdtn_codec.so"))
            lib.pdtn_decompress.restype = ctypes.c_int64
            lib.pdtn_decompress.argtypes = [
                ctypes.c_char_p, ctypes.c_uint64,
                ctypes.c_char_p, ctypes.c_uint64,
                ctypes.c_uint32,
            ]
            _lib = lib
    return _lib


def decompress(blob: bytes) -> bytes:
    lib = _load()
    header = np.frombuffer(blob[: _HEADER.itemsize], _HEADER)[0]
    n = int(header["orig_size"])
    payload = blob[_HEADER.itemsize:]
    out = ctypes.create_string_buffer(n)
    size = lib.pdtn_decompress(payload, len(payload), out, n,
                               int(header["width"]))
    if size != n:
        raise RuntimeError("pdtn_decompress failed")
    return out.raw
