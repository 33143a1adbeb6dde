"""ctypes binding of the native augmentation engine (``native/augment.cpp``):
threaded C++ reflect-pad-crop-flip of NHWC f32 batches on the host, the
port's own binding of the library the JAX package's
``data/native_augment.py`` binds, with its contract.

The library is built from the checkout's ``native/`` sources at first use
(``utils/native_build.ensure_native``); a failed build is logged once as a
warning and :func:`augment_f32` then returns None, as it does for inputs
outside the engine's contract: f32 only (a cast would change the bytes of
other dtypes), and spatial dims above ``pad`` (the C++ reflect bounces
once, numpy's ``mode="reflect"`` again and again). The caller then takes
the numpy gather (``data/datasets.augment_gather``), which gives the same
bytes for the same draws. Nothing here imports torch: the loader's worker
processes call it.
"""

from __future__ import annotations

import ctypes
import logging
import subprocess
import threading
from typing import Optional

import numpy as np

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
                lib = ctypes.CDLL(ensure_native("libpdtn_augment.so"))
            except (OSError, RuntimeError, ValueError,
                    subprocess.SubprocessError) as e:
                _load_error = str(e)
                logging.getLogger(__name__).warning(
                    "native augment engine unavailable: %s", e)
                return None
            lib.pdtn_augment_f32.restype = None
            lib.pdtn_augment_f32.argtypes = [
                ctypes.POINTER(ctypes.c_float),  # in
                ctypes.POINTER(ctypes.c_float),  # out
                ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
                ctypes.c_uint64,                 # n, h, w, c
                ctypes.POINTER(ctypes.c_int32),  # ys
                ctypes.POINTER(ctypes.c_int32),  # xs
                ctypes.POINTER(ctypes.c_uint8),  # flips
                ctypes.c_int32,                  # pad
                ctypes.c_int32,                  # nthreads
            ]
            _lib = lib
    return _lib


def available() -> bool:
    """Whether ``native/libpdtn_augment.so`` built and loaded."""
    return _load() is not None


def augment_f32(images: np.ndarray, ys: np.ndarray, xs: np.ndarray,
                flips: np.ndarray, pad: int = 4,
                nthreads: int = 0) -> Optional[np.ndarray]:
    """Crop and flip ``images`` (N, H, W, C f32) image by image at (ys, xs,
    flips); None when the library is unavailable or the inputs are outside
    its contract (module docstring). ``nthreads`` 0: the engine's own
    choice (the host's cores, at most 8)."""
    if images.dtype != np.float32:
        return None
    if images.shape[1] <= pad or images.shape[2] <= pad:
        return None
    lib = _load()
    if lib is None:
        return None
    images = np.ascontiguousarray(images)
    ys = np.ascontiguousarray(ys, dtype=np.int32)
    xs = np.ascontiguousarray(xs, dtype=np.int32)
    flips = np.ascontiguousarray(flips, dtype=np.uint8)
    n, h, w, c = images.shape
    out = np.empty_like(images)
    lib.pdtn_augment_f32(
        images.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, h, w, c,
        ys.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        xs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        flips.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        pad, nthreads,
    )
    return out
