"""Straggler-tolerant aggregation, deadline-based K-of-N gradient dropping:
the port's copy of ``pytorch_distributed_nn_tpu/resilience/stragglers.py``.

The reference's backup workers let the parameter server take the first
``num_aggregate`` gradients of a step and drop the rest; the PS mode of
:mod:`..parallel.grad_sync` is that fixed-K policy. This module is the
deadline policy: a contribution slower than ``deadline`` seconds is
dropped, however many that is, and the aggregate is renormalised by the
live count. ``min_keep`` keeps the fastest ranks always, so the update
never goes empty.

Arrival times are simulated, not measured: ``mean * exp(sigma * N(0, 1))``
per rank, from a CPU ``torch.Generator`` seeded with the step's straggler
seed (JAX's law, other draws: a stated departure, as the PS arrival
order's), plus the ``delay@step[:pR]`` entries of the run's fault plan
(``FaultPlan.delay_table()``). Every rank computes the whole time vector
on the host from the same seed, so each knows its own mask and the
whole report without a collective, which is what the JAX package gets
from its shared key. The drop depends on (seed, step, rank) alone, never
on the gradients, and the sum is divided by the realised contributor
count: an unbiased average of a random subset of the shards' gradients.

Times are float32 throughout, as the JAX arrays are, so a run without
noise (``sigma = 0``) reports the JAX package's numbers exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

#: the dropped-rank bitmask is reported while every rank's bit is an exact
#: f32 integer (2^24); past that only the count and skew are
_MAX_MASK_RANKS = 24


@dataclasses.dataclass(frozen=True)
class StragglerSim:
    """Seeded arrival-time model and deadline drop policy of the sync.

    deadline: simulated seconds after which a contribution is dropped.
    min_keep: the fastest ``min_keep`` ranks always contribute.
    mean/sigma: the arrival model ``mean * exp(sigma * N(0, 1))`` per
        (step, rank).
    delays: ``((step, rank_or_None, seconds), ...)`` injected latencies
        (``FaultPlan.delay_table()``); ``rank=None`` hits every rank.
    """

    deadline: float
    min_keep: int = 1
    mean: float = 0.1
    sigma: float = 0.1
    delays: Tuple[Tuple[int, Optional[int], float], ...] = ()

    def __post_init__(self):
        if self.deadline <= 0:
            raise ValueError(f"deadline must be > 0, got {self.deadline}")
        if self.min_keep < 1:
            raise ValueError(f"min_keep must be >= 1, got {self.min_keep}")
        if self.mean <= 0 or self.sigma < 0:
            raise ValueError(
                f"arrival model needs mean > 0, sigma >= 0 "
                f"(got mean={self.mean}, sigma={self.sigma})")

    def times(self, seed: int, step: int, n: int) -> np.ndarray:
        """(n,) f32 simulated arrival seconds at 1-indexed ``step``."""
        gen = torch.Generator().manual_seed(int(seed))
        z = torch.randn(n, generator=gen, dtype=torch.float32).numpy()
        t = np.float32(self.mean) * np.exp(np.float32(self.sigma) * z)
        for s, rank, seconds in self.delays:
            if int(step) != s:
                continue
            if rank is None:
                t = t + np.float32(seconds)
            elif rank < n:
                t[rank] += np.float32(seconds)
        return t.astype(np.float32)

    def mask_and_report(self, seed: int, step: int,
                        n: int) -> Tuple[List[float], Dict[str, float]]:
        """(every rank's 0/1 contribution mask, the report) of one step
        over ``n`` ranks: the same on every rank, so each takes its own
        mask and the whole report without a collective (the JAX
        ``mask_and_report`` gives one replica its mask). The report's
        keys:

        - ``straggler_dropped``: how many ranks missed the deadline;
        - ``straggler_dropped_mask``: rank r dropped -> bit 2^r (n <= 24);
        - ``straggler_skew``: the slowest over the fastest arrival;
        - ``straggler_slowest_rank`` and ``straggler_arrival_max``: which
          rank arrived last, and when.
        """
        t = self.times(seed, step, n)
        idx = np.arange(n)
        # arrival position with an index tie-break, so the floor keeps
        # exactly min_keep ranks
        pos = np.sum((t[None, :] < t[:, None])
                     | ((t[None, :] == t[:, None])
                        & (idx[None, :] < idx[:, None])), axis=1)
        keep = (t <= np.float32(self.deadline)) | (pos < min(self.min_keep,
                                                               n))
        keepf = keep.astype(np.float32)
        report = {
            "straggler_dropped": float(np.float32(n) - keepf.sum()),
            "straggler_skew": float(t.max() / t.min()),
            "straggler_slowest_rank": float(np.argmax(t)),
            "straggler_arrival_max": float(t.max()),
        }
        if n <= _MAX_MASK_RANKS:
            report["straggler_dropped_mask"] = float(np.sum(
                (np.float32(1.0) - keepf)
                * (np.float32(2.0) ** np.arange(n, dtype=np.float32))))
        return [float(k) for k in keepf], report


def dropped_ranks(mask_value: float) -> list:
    """Decode a ``straggler_dropped_mask`` metric back to rank indices."""
    bits, out, r = int(round(mask_value)), [], 0
    while bits:
        if bits & 1:
            out.append(r)
        bits >>= 1
        r += 1
    return out


def make_straggler_sim(deadline: float, min_keep: int = 1, fault_plan=None,
                       mean: float = 0.1, sigma: float = 0.1) -> StragglerSim:
    """A simulator with the delay entries of ``fault_plan``, if any."""
    return StragglerSim(
        deadline=deadline, min_keep=min_keep, mean=mean, sigma=sigma,
        delays=fault_plan.delay_table() if fault_plan is not None else ())
