"""Float32 precision of the port's forwards and steps.

PyTorch lets cuDNN run float32 convolutions in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is ``True``); the JAX package's f32
convolutions and matmuls are f32. :func:`no_tf32` turns both TF32
switches off while a float32 forward or training step runs and gives them
back after. The switches are process-wide and several threads may run
such code at once (the serving engine's scheduler threads, the trainer
and its overlapped eval), so the first user saves them, the last restores
them.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import torch

_lock = threading.Lock()
_users = 0
_saved: Optional[Tuple[bool, bool]] = None


@contextlib.contextmanager
def no_tf32():
    """Hold ``cuda.matmul.allow_tf32`` and ``cudnn.allow_tf32`` off inside
    the block; the values from before the first concurrent user come
    back when the last one leaves."""
    global _users, _saved
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    with _lock:
        if _users == 0:
            _saved = (matmul.allow_tf32, cudnn.allow_tf32)
            matmul.allow_tf32 = cudnn.allow_tf32 = False
        _users += 1
    try:
        yield
    finally:
        with _lock:
            _users -= 1
            if _users == 0:
                matmul.allow_tf32, cudnn.allow_tf32 = _saved


def f32_context(model: torch.nn.Module):
    """:func:`no_tf32` for a model that computes in float32 (its ``dtype``
    attribute, float32 when it has none), else a no-op: a bf16 model's
    layers keep their own precision."""
    if getattr(model, "dtype", torch.float32) == torch.float32:
        return no_tf32()
    return contextlib.nullcontext()
