"""ctypes binding of the native host codec (``native/codec.cpp``):
byte-shuffle + DEFLATE, for compressed checkpoints (``PDTZ``) and
serving artifacts (``PDAZ``).

The port's own binding of the library the JAX package's
``ops/host_codec.py`` binds, with its interface and defaults: ``compress``
/ ``decompress`` over bytes (level 1, shuffle width 4), and
``w_compress`` / ``w_decompress`` over numpy arrays. The blob layout (a
16-byte header of original size and shuffle width, then the payload) is
the same, so either package reads the other's blobs, and both give the
same bytes for the same input. :func:`compress_parts` gives a blob as
its header and a view of the payload, written once into a buffer of its
own, and :func:`decompress` inflates straight into the output: the
checkpoint writer's thread holds the GIL for no copy of the payload. The
library is built from the checkout's ``native/`` sources at first use;
:func:`available` says whether it built (the checkpoint writer then
falls back to raw ``PDTN``, as the JAX package does).
"""

from __future__ import annotations

import ctypes
import logging
import threading
from typing import Optional, Tuple

import numpy as np

_HEADER = np.dtype([("orig_size", "<u8"), ("width", "<u4"), ("pad", "<u4")])
_lib = None
_load_error: Optional[str] = None
_lock = threading.Lock()


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_error
    with _lock:
        if _lib is None and _load_error is None:
            from pytorch_distributed_nn_tpu_torch.utils.native_build import (
                ensure_native,
            )

            try:
                lib = ctypes.CDLL(ensure_native("libpdtn_codec.so"))
            except (OSError, RuntimeError, ValueError) as e:
                _load_error = str(e)
                logging.getLogger(__name__).warning(
                    "native host codec unavailable: %s", e)
                return None
            lib.pdtn_max_compressed_size.restype = ctypes.c_uint64
            lib.pdtn_max_compressed_size.argtypes = [ctypes.c_uint64]
            lib.pdtn_compress.restype = ctypes.c_int64
            lib.pdtn_compress.argtypes = [
                ctypes.c_void_p, ctypes.c_uint64,
                ctypes.c_void_p, ctypes.c_uint64,
                ctypes.c_int, ctypes.c_uint32,
            ]
            lib.pdtn_decompress.restype = ctypes.c_int64
            lib.pdtn_decompress.argtypes = [
                ctypes.c_void_p, ctypes.c_uint64,
                ctypes.c_void_p, ctypes.c_uint64,
                ctypes.c_uint32,
            ]
            _lib = lib
    return _lib


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native codec unavailable: {_load_error}")
    return lib


def available() -> bool:
    """Whether ``native/libpdtn_codec.so`` built and loaded."""
    return _load() is not None


def compress_parts(data, level: int = 1,
                   width: int = 4) -> Tuple[bytes, memoryview]:
    """The blob of :func:`compress` as ``(header, payload)``: the 16-byte
    header, and a view of the payload in the one buffer the codec wrote
    it to. ``data`` is any contiguous buffer (bytes, a uint8 array)."""
    lib = _require()
    src = np.frombuffer(data, np.uint8)
    n = src.nbytes
    cap = lib.pdtn_max_compressed_size(n)
    out = np.empty(cap, np.uint8)
    size = lib.pdtn_compress(src.ctypes.data, n, out.ctypes.data, cap,
                             level, width)
    if size < 0:
        raise RuntimeError("pdtn_compress failed")
    header = np.zeros(1, _HEADER)
    header["orig_size"] = n
    header["width"] = width
    return header.tobytes(), out[:size].data


def compress(data, level: int = 1, width: int = 4) -> bytes:
    """Compress bytes with byte-shuffle width ``width`` (4 = float32)."""
    return b"".join(compress_parts(data, level=level, width=width))


def decompress(blob) -> memoryview:
    """The bytes a :func:`compress` blob (any buffer) holds, inflated
    straight into a new buffer: a view of it."""
    lib = _require()
    src = np.frombuffer(blob, np.uint8)
    header = src[: _HEADER.itemsize].view(_HEADER)[0]
    n = int(header["orig_size"])
    payload = src[_HEADER.itemsize:]
    out = np.empty(n, np.uint8)
    size = lib.pdtn_decompress(payload.ctypes.data, payload.nbytes,
                               out.ctypes.data, n, int(header["width"]))
    if size != n:
        raise RuntimeError("pdtn_decompress failed")
    return out.data


def w_compress(arr: np.ndarray, level: int = 1) -> bytes:
    """An array as ``dtype|shape|`` and its compressed bytes."""
    arr = np.ascontiguousarray(arr)
    meta = (str(arr.dtype).encode() + b"|"
            + ",".join(map(str, arr.shape)).encode() + b"|")
    return meta + compress(arr.tobytes(), level=level,
                           width=arr.dtype.itemsize)


def w_decompress(blob: bytes) -> np.ndarray:
    """The inverse of :func:`w_compress`."""
    dtype_end = blob.index(b"|")
    shape_end = blob.index(b"|", dtype_end + 1)
    dtype = np.dtype(blob[:dtype_end].decode())
    shape_s = blob[dtype_end + 1: shape_end].decode()
    shape = tuple(int(s) for s in shape_s.split(",")) if shape_s else ()
    data = decompress(memoryview(blob)[shape_end + 1:])
    return np.frombuffer(data, dtype).reshape(shape)
