"""Bucket policy shared with the generative engine (the single-pass
inference engine of ``pytorch_distributed_nn_tpu/serving/engine.py`` is
not ported yet)."""

from __future__ import annotations

from typing import Tuple


def length_buckets(max_len: int) -> Tuple[int, ...]:
    """Sequence-length buckets for token models: powers of two up to (and
    always including) ``max_len``."""
    out, b = [], 1
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(sorted(set(out)))
