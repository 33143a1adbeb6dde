"""Process groups of the port's data parallelism: the counterpart of
``make_mesh``/``num_workers`` of ``pytorch_distributed_nn_tpu/parallel/
mesh.py`` for the data axis.

One rank is one data-parallel replica (the JAX mesh's ``data`` axis, the
reference's workers). Rank, world size and local rank come from the
``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` environment that ``torchrun`` sets
(with ``MASTER_ADDR``/``MASTER_PORT`` for the rendezvous), else the run is
one rank. NCCL serves CUDA tensors, gloo CPU tensors; a rank on the card
uses ``cuda:LOCAL_RANK``.

Every function takes the group explicitly: a group is a plain
``torch.distributed.ProcessGroup`` object, built here and never installed
as the process's default group, so one process can hold several (the
tests run several gloo ranks, one thread each, over one in-process store).
At world size 1 the collectives are still called. A group that cannot be
built raises; nothing falls back to running without one.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def env_ranks() -> Tuple[int, int, int]:
    """(rank, world size, local rank) from the torchrun environment, or
    (0, 1, 0)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    local = int(os.environ.get("LOCAL_RANK", str(rank if world > 1 else 0)))
    if not 0 <= rank < world:
        raise ValueError(f"RANK={rank} outside WORLD_SIZE={world}")
    return rank, world, local


def new_group(store, rank: int, world: int, device: torch.device,
              timeout_s: float = 600.0):
    """A process group over ``store``: NCCL for a CUDA ``device``, gloo
    for the CPU."""
    if device.type == "cuda":
        if not hasattr(dist, "ProcessGroupNCCL"):
            raise RuntimeError("this torch build has no NCCL")
        return dist.ProcessGroupNCCL(store, rank, world)
    return dist.ProcessGroupGloo(store, rank, world,
                                 datetime.timedelta(seconds=timeout_s))


def init_group(device: torch.device, num_workers: Optional[int] = None):
    """(group, device) of this process: the group of the torchrun world (or
    of one rank), and the device the rank runs on (``cuda:LOCAL_RANK`` when
    ``device`` is the card). ``num_workers`` must equal the world size."""
    rank, world, local = env_ranks()
    if num_workers is not None and num_workers != world:
        raise ValueError(
            f"num_workers={num_workers} but the world has {world} rank(s): "
            "launch one process per worker (torchrun --nproc-per-node N)")
    if device.type == "cuda":
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    if world == 1:
        store = dist.HashStore()
    else:
        store = dist.TCPStore(
            os.environ.get("MASTER_ADDR", "localhost"),
            int(os.environ["MASTER_PORT"]), world, rank == 0,
            timeout=datetime.timedelta(seconds=600))
    return new_group(dist.PrefixStore("pdtn_dp", store), rank, world,
                     device), device


def rank(group) -> int:
    return 0 if group is None else group.rank()


def world_size(group) -> int:
    return 1 if group is None else group.size()


def all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """In-place all-reduce of ``t`` over ``group`` (``op`` "sum" or
    "max"); waits for the work (on the card: the current stream waits)."""
    opts = dist.AllreduceOptions()
    opts.reduceOp = _OPS[op]
    group.allreduce([t], opts).wait()
    return t
