"""Retry with exponential backoff and jitter for flaky host I/O: the
port's own copy of ``pytorch_distributed_nn_tpu/resilience/retry.py``.

The checkpoint writers wrap their atomic publish (tmp file +
``os.replace``) in :func:`retry_call`, so a transient ``OSError`` of a
network file system costs a retry, never the run; atomicity makes the
retry safe, since a failed attempt published nothing. The jitter comes
from a private ``random.Random(seed)`` and the sleep is injectable, so a
test reads the exact schedule without sleeping.
"""

from __future__ import annotations

import logging
import random
import time
from typing import Callable, Optional, Tuple, Type

from pytorch_distributed_nn_tpu_torch.observability.core import get_telemetry

log = logging.getLogger(__name__)


def backoff_delays(attempts: int, base_delay: float = 0.1,
                   max_delay: float = 5.0, jitter: float = 0.5,
                   seed: Optional[int] = None):
    """The ``attempts - 1`` sleeps :func:`retry_call` would take:
    doubling from ``base_delay``, capped at ``max_delay``, each scaled by
    a random factor in ``[1, 1 + jitter]``."""
    rng = random.Random(seed)
    return [min(max_delay, base_delay * (2 ** i)) * (1.0 + jitter * rng.random())
            for i in range(max(attempts - 1, 0))]


def retry_call(fn: Callable, *args, attempts: int = 3,
               base_delay: float = 0.1, max_delay: float = 5.0,
               jitter: float = 0.5,
               retry_on: Tuple[Type[BaseException], ...] = (OSError,),
               seed: Optional[int] = None,
               sleep: Callable[[float], None] = time.sleep,
               label: Optional[str] = None, **kwargs):
    """``fn(*args, **kwargs)``, called up to ``attempts`` times while it
    raises one of ``retry_on``; each failure emits a ``retry`` event and
    the last one propagates unchanged. Only for idempotent or atomic
    operations."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    delays = backoff_delays(attempts, base_delay, max_delay, jitter, seed)
    name = label or getattr(fn, "__name__", repr(fn))
    for i in range(attempts):
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            get_telemetry().emit(
                "retry", label=name, attempt=i + 1, attempts=attempts,
                error=f"{type(e).__name__}: {e}"[:200],
                exhausted=i == attempts - 1)
            if i == attempts - 1:
                log.error("%s failed after %d attempts: %s", name, attempts, e)
                raise
            log.warning("%s failed (attempt %d/%d): %s; retrying in %.2fs",
                        name, i + 1, attempts, e, delays[i])
            sleep(delays[i])
    raise AssertionError("unreachable")


def timed_out(start: float, timeout: Optional[float]) -> bool:
    """Whether ``timeout`` seconds have passed since the monotonic time
    ``start`` (``None``: never)."""
    return timeout is not None and (time.monotonic() - start) >= timeout
