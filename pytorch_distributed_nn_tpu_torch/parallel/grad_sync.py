"""Gradient synchronization over ``torch.distributed``: the port of
``pytorch_distributed_nn_tpu/parallel/grad_sync.py``.

Three modes, as in the JAX package:

- ``allreduce``: the mean of the ranks' gradients (sum, then divide by
  the world size);
- ``ps``: parameter-server emulation: only the first ``num_aggregate``
  ranks of a per-step arrival order contribute (``arrival="rank"``: the
  lowest ranks; ``"random"``: a fresh permutation each step, the same on
  every rank), and the sum is divided by the fixed ``num_aggregate``;
- ``local``: no sync.

``kill_ranks`` names ranks that compute but never contribute; the
divisor is then the live contributor count (or ``num_aggregate`` in PS
mode). Compression ``none`` or ``int8`` (:mod:`..ops.compression`).

The JAX stage runs inside ``shard_map`` with one traced mask per replica;
here every rank knows the whole arrival order and kill list on the host,
so the masks are host values and cost no collective. The random arrival
draws from a CPU ``torch.Generator`` seeded from the step's sync seed,
not JAX's permutation: the same law, other draws.

Not ported (each raises ``NotImplementedError`` naming its ROADMAP item):
``topk`` compression with error feedback, bucketed collectives
(``bucket_bytes``) and the straggler simulator.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from pytorch_distributed_nn_tpu_torch.ops import compression as C
from pytorch_distributed_nn_tpu_torch.ops.reference import f32_reciprocal
from pytorch_distributed_nn_tpu_torch.parallel.mesh import (
    all_reduce,
    rank,
    world_size,
)

_SYNC = "ROADMAP Queue 1 item 2 (gradient sync over torch.distributed)"


@dataclasses.dataclass(frozen=True)
class GradSyncConfig:
    """The JAX ``GradSyncConfig``'s fields and checks (``axis_name`` has
    no counterpart: the process group is given to :class:`GradSync`)."""

    mode: str = "allreduce"
    num_aggregate: Optional[int] = None
    arrival: str = "random"
    compression: str = "none"
    topk_ratio: float = 0.01
    topk_method: str = "auto"
    bucket_bytes: Optional[int] = None
    kill_ranks: tuple = ()
    straggler: Optional[Any] = None

    def __post_init__(self):
        if self.mode not in ("allreduce", "ps", "local"):
            raise ValueError(f"unknown grad-sync mode {self.mode!r}")
        if self.compression not in ("none", "int8", "topk"):
            raise ValueError(f"unknown compression {self.compression!r}")
        if self.arrival not in ("rank", "random"):
            raise ValueError(f"unknown arrival order {self.arrival!r}")
        if self.topk_method not in ("auto", "exact", "approx"):
            raise ValueError(f"unknown topk_method {self.topk_method!r}")
        if self.kill_ranks and self.mode == "local":
            raise ValueError("kill_ranks requires a distributed sync mode")
        if self.bucket_bytes is not None and self.bucket_bytes <= 0:
            raise ValueError("bucket_bytes must be positive")
        unported = {"compression": self.compression == "topk",
                    "bucket_bytes": self.bucket_bytes is not None,
                    "straggler": self.straggler is not None}
        for field, asked in unported.items():
            if asked:
                raise NotImplementedError(f"{field}={getattr(self, field)!r} "
                                          f"is not ported yet: {_SYNC}")


class GradSync:
    """Callable sync stage: ``(grads, seed) -> synced grads`` over
    ``group`` (a list of tensors in, a new list out). ``seed`` must be the
    same on every rank; it keys the arrival order and the quantization
    noise."""

    def __init__(self, config: GradSyncConfig, group):
        self.config = config
        self.group = group
        n = world_size(group)
        if config.mode != "local" and group is None:
            raise ValueError(f"mode {config.mode!r} needs a process group")
        bad = [k for k in config.kill_ranks if not 0 <= k < n]
        if bad:
            raise ValueError(f"kill_ranks {bad} out of range for {n} "
                             "data-parallel workers")

    def _mask_of(self, r: int, order: Optional[np.ndarray]) -> float:
        """Rank r's 0/1: does its gradient make this step's aggregate?
        (the first num_aggregate arrivals, never a killed rank)"""
        cfg = self.config
        alive = float(r not in cfg.kill_ranks)
        if order is None:
            return alive
        position = r if cfg.arrival == "rank" else int(np.argmax(order == r))
        return alive * float(position < cfg.num_aggregate)

    def masks(self, mask_seed: int) -> Optional[List[float]]:
        """Every rank's 0/1 mask for one step, or None when all contribute
        (the JAX ``_contribution_mask`` / ``_alive_mask``, for each rank)."""
        cfg, n = self.config, world_size(self.group)
        ps_order = None
        if cfg.mode == "ps" and cfg.num_aggregate is not None \
                and cfg.num_aggregate < n:
            gen = torch.Generator().manual_seed(int(mask_seed))
            ps_order = torch.randperm(n, generator=gen).numpy()
        if ps_order is None and not cfg.kill_ranks:
            return None
        return [self._mask_of(r, ps_order) for r in range(n)]

    def __call__(self, grads: Sequence[torch.Tensor],
                 seed: int) -> List[torch.Tensor]:
        cfg = self.config
        if cfg.mode == "local":
            return list(grads)
        mask_seed, quant_seed = C.leaf_seeds(seed, 2)
        masks = self.masks(mask_seed)
        mask = None if masks is None else masks[rank(self.group)]
        fixed = (cfg.num_aggregate
                 if cfg.mode == "ps" and cfg.num_aggregate is not None
                 else None)
        if cfg.compression == "int8":
            # PS mode keeps the fixed num_aggregate divisor, as the
            # uncompressed branch does
            return C.int8_psum_mean(grads, quant_seed, self.group,
                                    mask=mask, denom=fixed)
        if mask is None:
            return C.psum_mean(grads, self.group)
        if fixed is not None:
            recip = f32_reciprocal(fixed)
        elif grads:
            # the live count, a traced divisor in the JAX program: a true
            # division (a device tensor, so torch divides on the card too)
            live = torch.tensor(max(sum(masks), 1.0), device=grads[0].device)
        out = []
        for g in grads:
            total = g * mask
            all_reduce(total, "sum", self.group)
            out.append(total * recip if fixed is not None else total / live)
        return out

    def estimate_sync_bytes(self, grads_template) -> int:
        """Bytes of gradient payload one rank sends per step (one
        direction, no ring factor): f32 words uncompressed, one byte per
        element plus one f32 scale per leaf for int8."""
        if self.config.mode == "local":
            return 0
        elems = [int(t.numel()) for t in grads_template]
        if self.config.compression == "int8":
            return sum(elems) + 4 * len(elems)
        return sum(elems) * 4


def make_grad_sync(group, mode: str = "allreduce",
                   num_aggregate: Optional[int] = None,
                   compression: str = "none", topk_ratio: float = 0.01,
                   arrival: str = "random", kill_ranks: tuple = (),
                   bucket_bytes: Optional[int] = None,
                   topk_method: str = "auto", straggler=None) -> GradSync:
    return GradSync(GradSyncConfig(
        mode=mode, num_aggregate=num_aggregate, arrival=arrival,
        compression=compression, topk_ratio=topk_ratio,
        topk_method=topk_method, bucket_bytes=bucket_bytes,
        kill_ranks=tuple(kill_ranks), straggler=straggler,
    ), group)
