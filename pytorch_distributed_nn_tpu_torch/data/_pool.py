"""The image loader's worker processes (``DataLoader(workers=N)``): what
runs in each spawned worker. numpy only, so a worker imports neither
torch nor anything that touches CUDA.

The parent copies the uint8 dataset once into a ``SharedMemory`` block;
:func:`init` attaches each worker to it without registering it with the
resource tracker (only the parent, which created it, unlinks it), and
:func:`make_batch` builds one batch as the JAX package's
``_pool_make_batch`` does: gather, normalise, then augment with the draws
of ``RandomState([seed, counter])`` for the whole global batch, keeping
the rows of one rank.
"""

from __future__ import annotations

from multiprocessing import resource_tracker, shared_memory

import numpy as np

from pytorch_distributed_nn_tpu_torch.data.datasets import (
    augment,
    augment_draws,
    normalize,
)

_STATE = None  # (shm, raw, labels, mean, std, augment), set by init


def attach(name: str) -> shared_memory.SharedMemory:
    """Attach to the block ``name`` without the resource tracker's
    registration (which would unlink it, or warn, when this process
    exits)."""
    try:
        return shared_memory.SharedMemory(name=name, track=False)
    except TypeError:  # Python < 3.13 has no track argument
        pass
    register = resource_tracker.register
    resource_tracker.register = lambda *args, **kwargs: None
    try:
        return shared_memory.SharedMemory(name=name)
    finally:
        resource_tracker.register = register


def init(shm_name, shape, labels, mean, std, augment_on) -> None:
    """Worker initializer: attach the shared uint8 pixels."""
    global _STATE
    shm = attach(shm_name)
    raw = np.ndarray(shape, dtype=np.uint8, buffer=shm.buf)
    _STATE = (shm, raw, labels, mean, std, augment_on)


def make_batch(idx: np.ndarray, aug_seed, rows):
    """Rows ``rows`` (start, stop) of the batch of indices ``idx``:
    normalised, and augmented with the draws of ``RandomState(list(
    aug_seed))`` for all ``len(idx)`` images. Returns (images f32,
    labels int32)."""
    _, raw, labels, mean, std, augment_on = _STATE
    local = idx[slice(*rows)]
    x = normalize(raw[local], mean, std)
    if augment_on:
        ys, xs, flip = augment_draws(np.random.RandomState(list(aug_seed)),
                                     len(idx))
        sl = slice(*rows)
        x = augment(x, ys[sl], xs[sl], flip[sl])
    return x, labels[local]
