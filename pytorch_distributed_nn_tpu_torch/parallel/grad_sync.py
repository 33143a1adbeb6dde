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
mode). ``straggler`` (:class:`..resilience.stragglers.StragglerSim`)
drops the ranks that miss a simulated deadline this step, multiplied into
the PS/kill mask and renormalised by the live count. Compression
``none``, ``int8`` or ``topk`` with error feedback, and ``bucket_bytes``
flattens the leaves into f32 buckets of that size for ``none`` and
``int8`` (one collective and one int8 scale a bucket)
(:mod:`..ops.compression`).

The JAX stage runs inside ``shard_map`` with one traced mask per replica;
here every rank knows the whole arrival order, kill list and simulated
arrival times on the host, so the masks are host values and cost no
collective. The random arrival and the straggler times draw from CPU
``torch.Generator``s seeded from the step's sync seed, not JAX's
permutation and normal draws: the same laws, other draws. The straggler
stream's seed is another function of the sync seed, so that the mask and
quantization seeds (``leaf_seeds(seed, 2)``) are those of a run without
the simulator (the JAX stage folds its key for the same reason).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from pytorch_distributed_nn_tpu_torch.ops import compression as C
from pytorch_distributed_nn_tpu_torch.ops.reference import f32_reciprocal
from pytorch_distributed_nn_tpu_torch.parallel.mesh import (
    rank,
    world_size,
)



def straggler_seed(seed: int) -> int:
    """The straggler simulator's seed of a step: another stream of the
    sync seed, which leaves ``leaf_seeds(seed, 2)`` as they are (the JAX
    stage's ``fold_in(key, 0x57A6)``)."""
    return int(np.random.SeedSequence([int(seed), 0x57A6])
               .generate_state(1)[0])


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
        if self.straggler is not None:
            if self.mode == "local":
                raise ValueError(
                    "straggler simulation requires a distributed sync mode")
            if self.compression == "topk":
                raise ValueError(
                    "straggler simulation is incompatible with topk "
                    "compression: a dropped replica's sent coordinates "
                    "would leave its error-feedback residual inconsistent; "
                    "use compression 'none' or 'int8'")
        if self.bucket_bytes is not None:
            if self.bucket_bytes <= 0:
                raise ValueError("bucket_bytes must be positive")
            if self.compression == "topk":
                raise ValueError("bucketing is incompatible with topk "
                                 "compression (top-k masks are per-leaf)")


class GradSync:
    """Callable sync stage over ``group``: ``(grads, state, seed,
    step=None) -> (synced, state)``, lists of tensors in and out.

    ``state`` is this rank's error-feedback residuals under topk
    compression (:meth:`init_state`), else ``None``. ``seed`` must be the
    same on every rank; it keys the arrival order, the quantization noise
    and the straggler times. ``step`` (1-indexed) lets the straggler
    simulator match ``delay@step`` entries; without it none fires."""

    def __init__(self, config: GradSyncConfig, group):
        self.config = config
        self.group = group
        self._report: Dict[str, float] = {}
        n = world_size(group)
        if config.mode != "local" and group is None:
            raise ValueError(f"mode {config.mode!r} needs a process group")
        bad = [k for k in config.kill_ranks if not 0 <= k < n]
        if bad:
            raise ValueError(f"kill_ranks {bad} out of range for {n} "
                             "data-parallel workers")

    def init_state(self, params) -> Optional[List[torch.Tensor]]:
        """Zero residuals shaped like ``params`` under topk compression
        (and a distributed mode), else ``None``."""
        if self.config.compression == "topk" and self.config.mode != "local":
            return C.init_ef_state(params)
        return None

    def _alive(self, r: int) -> float:
        return float(r not in self.config.kill_ranks)

    def _mask_of(self, r: int, order: Optional[np.ndarray]) -> float:
        """Rank r's 0/1: does its gradient make this step's aggregate?
        (the first num_aggregate arrivals, never a killed rank)"""
        cfg = self.config
        alive = self._alive(r)
        if order is None:
            return alive
        position = r if cfg.arrival == "rank" else int(np.argmax(order == r))
        return alive * float(position < cfg.num_aggregate)

    def masks(self, mask_seed: int) -> Optional[List[float]]:
        """Every rank's 0/1 mask for one step from the PS arrival order
        and the kill list, or None when all contribute (the JAX
        ``_contribution_mask`` in PS mode, ``_alive_mask`` otherwise, for
        each rank)."""
        cfg, n = self.config, world_size(self.group)
        ps_order = None
        if cfg.mode == "ps" and cfg.num_aggregate is not None \
                and cfg.num_aggregate < n:
            gen = torch.Generator().manual_seed(int(mask_seed))
            ps_order = torch.randperm(n, generator=gen).numpy()
        if ps_order is None and not cfg.kill_ranks:
            return None
        return [self._mask_of(r, ps_order) for r in range(n)]

    def __call__(self, grads: Sequence[torch.Tensor], state, seed: int,
                 step: Optional[int] = None):
        cfg = self.config
        self._report = {}
        if cfg.mode == "local":
            return list(grads), state
        me = rank(self.group)
        mask_seed, quant_seed = C.leaf_seeds(seed, 2)
        masks = self.masks(mask_seed)
        if cfg.straggler is not None:
            keep, self._report = cfg.straggler.mask_and_report(
                straggler_seed(seed), 0 if step is None else step,
                world_size(self.group))
            masks = keep if masks is None else [
                m * k for m, k in zip(masks, keep)]
        mask = None if masks is None else masks[me]
        grads = list(grads)

        if cfg.compression == "topk":
            grads, state = C.topk_compress_ef(grads, state, cfg.topk_ratio,
                                              cfg.topk_method)
            if mask is not None and cfg.mode == "ps" \
                    and cfg.arrival == "random":
                # a rank the random arrival dropped this step puts its
                # sent coordinates back into its residual; ranks excluded
                # every step (killed, or arriving past num_aggregate by
                # rank) do not, or their residual would grow without bound
                transient = self._alive(me) * (1.0 - mask)
                state = [e + s * transient for e, s in zip(state, grads)]

        meta = None
        if cfg.bucket_bytes is not None:
            grads, meta = C.flatten_buckets(grads, cfg.bucket_bytes)
        fixed = (cfg.num_aggregate
                 if cfg.mode == "ps" and cfg.num_aggregate is not None
                 else None)
        if cfg.compression == "int8":
            # PS mode keeps the fixed num_aggregate divisor, as the
            # uncompressed branch does
            out = C.int8_psum_mean(grads, quant_seed, self.group,
                                   mask=mask, denom=fixed)
        elif mask is None:
            out = C.psum_mean(grads, self.group)
        else:
            out = self._masked_mean(grads, mask, masks, fixed)
        if meta is not None:
            out = C.unflatten_buckets(out, meta)
        return out, state

    def _masked_mean(self, grads, mask: float, masks: List[float],
                     fixed: Optional[int]) -> List[torch.Tensor]:
        if fixed is not None:
            recip = f32_reciprocal(fixed)
        elif grads:
            # the live count, a traced divisor in the JAX program: a true
            # division (a device tensor, so torch divides on the card too)
            live = torch.tensor(max(sum(masks), 1.0), device=grads[0].device)
        totals = C.psum([g * mask for g in grads], self.group)
        return [t * recip if fixed is not None else t / live
                for t in totals]

    def pop_report(self) -> Dict[str, float]:
        """The straggler report of the last call (empty without a
        simulator), once: the same on every rank, so the train step merges
        it into the step's metrics as it is. Keys as
        :meth:`..resilience.stragglers.StragglerSim.mask_and_report`."""
        r, self._report = self._report, {}
        return r

    def estimate_sync_bytes(self, grads_template) -> int:
        """Bytes of gradient payload one rank sends per step (one
        direction, no ring factor): f32 words uncompressed, one byte per
        element plus one f32 scale per leaf for int8, and a value and an
        index word per kept coordinate for topk."""
        cfg = self.config
        if cfg.mode == "local":
            return 0
        elems = [int(t.numel()) for t in grads_template]
        if cfg.compression == "int8":
            return sum(elems) + 4 * len(elems)
        if cfg.compression == "topk":
            return sum(max(1, int(n * cfg.topk_ratio)) for n in elems) * 8
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
