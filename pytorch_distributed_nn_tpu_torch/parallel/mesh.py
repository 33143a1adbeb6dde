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
:func:`sibling_group` builds a second group of the same ranks over the
same store, for collectives issued from another thread (the overlapped
eval): two threads never share one communicator. At world size 1 the
collectives are still called. A group that cannot be built raises;
nothing falls back to running without one.

The (data, seq, model) mesh of the tp/sp path (:func:`make_mesh`, the
JAX ``make_mesh``/``axis_sizes``): a world of ``dp * sp * tp`` ranks,
rank ``r`` at coordinate ``(d, s, m)`` with ``r = (d * sp + s) * tp + m``
(the JAX ``reshape(num_data, num_seq, num_model)`` order). Each rank
builds one group per axis of extent above one, over the ranks that share
its other two coordinates, on the world group's store under a key prefix
of its own (as :func:`sibling_group` does); their ranks are the
coordinates on that axis. None of them is the default group: collectives
and ring hops go through these ``ProcessGroup`` objects.

``multihost=True`` (``train --multihost``, the JAX CLI's
``jax.distributed.initialize``) requires the whole torchrun environment
and builds the rendezvous store under
:func:`..resilience.retry.retry_call` with the JAX CLI's arguments (4
attempts, 2 s base, 15 s cap), since a store's first connect races the
other hosts' start.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time
import weakref
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}

#: the torchrun environment ``multihost`` requires
TORCHRUN_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")

#: group -> what built it (store, rank, world, device, timeout), for
#: :func:`sibling_group`
_ORIGINS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
#: group -> how many meshes were built over it: each mesh's groups take
#: their own store prefix (NCCL reads a communicator's id from the store
#: under a key every group reuses, so a second mesh's group on a shared
#: prefix could read the first one's stale id)
_MESHES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def env_ranks() -> Tuple[int, int, int]:
    """(rank, world size, local rank) from the torchrun environment, or
    (0, 1, 0)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    local = int(os.environ.get("LOCAL_RANK", str(rank if world > 1 else 0)))
    if not 0 <= rank < world:
        raise ValueError(f"RANK={rank} outside WORLD_SIZE={world}")
    return rank, world, local


def fake_group(rank: int, world: int):
    """A process group of ``world`` ranks whose collectives move nothing
    and return at once (the ``FakeProcessGroup`` backend, on the CPU and
    meta devices): the cost walk's (:mod:`..analysis.costmodel`). Its
    collectives reach a dispatch mode as a real group's do."""
    from torch._C._distributed_c10d import FakeProcessGroup

    group = dist.ProcessGroup(dist.HashStore(), rank, world)
    backend = FakeProcessGroup._create_internal(
        rank, world, FakeProcessGroup.Options())
    custom = dist.ProcessGroup.BackendType.CUSTOM
    group._set_default_backend(custom)
    for dev in ("cpu", "meta"):
        group._register_backend(torch.device(dev), custom, backend)
    return register_fake(group, rank, world)


def register_fake(group, rank: int, world: int):
    """Record ``group`` (a fake group) so that :func:`make_mesh` builds
    fake axis groups over it on the meta device."""
    _ORIGINS[group] = (dist.HashStore(), rank, world, torch.device("meta"),
                       0.0)
    return group


def new_group(store, rank: int, world: int, device: torch.device,
              timeout_s: float = 600.0):
    """A process group over ``store``: NCCL for a CUDA ``device``, gloo
    for the CPU, a fake group (:func:`fake_group`) on the meta device."""
    if device.type == "meta":
        return fake_group(rank, world)
    if device.type == "cuda":
        if not hasattr(dist, "ProcessGroupNCCL"):
            raise RuntimeError("this torch build has no NCCL")
        group = dist.ProcessGroupNCCL(store, rank, world)
    else:
        group = dist.ProcessGroupGloo(store, rank, world,
                                      datetime.timedelta(seconds=timeout_s))
    _ORIGINS[group] = (store, rank, world, device, timeout_s)
    return group


def sibling_group(group, name: str):
    """A second group of ``group``'s ranks over its store, under the key
    prefix ``name``: every rank must call this at the same point, as it
    built ``group``."""
    try:
        store, r, world, device, timeout_s = _ORIGINS[group]
    except KeyError:
        raise ValueError("sibling_group: the group was not built by "
                         "parallel.mesh.new_group") from None
    return new_group(dist.PrefixStore(name, store), r, world, device,
                     timeout_s)


def multihost_env() -> None:
    """Raise unless the whole torchrun environment is set (``train
    --multihost``), naming what is missing."""
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"--multihost needs the torchrun environment; {', '.join(missing)}"
            " not set (launch with torchrun / torch.distributed.run, one "
            "process per card)")


def tcp_store(rank: int, world: int, multihost: bool = False,
              sleep=time.sleep):
    """The rendezvous ``TCPStore`` at ``MASTER_ADDR:MASTER_PORT`` (rank 0
    hosts it); ``multihost`` builds it under ``retry_call`` (4 attempts,
    2 s base, 15 s cap, on ``RuntimeError``/``OSError``/``ValueError``),
    sleeping with ``sleep`` between attempts."""
    addr = os.environ.get("MASTER_ADDR", "localhost")
    port = int(os.environ["MASTER_PORT"])
    timeout = datetime.timedelta(seconds=600)
    if not multihost:
        return dist.TCPStore(addr, port, world, rank == 0, timeout=timeout)
    from pytorch_distributed_nn_tpu_torch.resilience.retry import retry_call

    return retry_call(dist.TCPStore, addr, port, world, rank == 0,
                      timeout=timeout, attempts=4, base_delay=2.0,
                      max_delay=15.0,
                      retry_on=(RuntimeError, OSError, ValueError),
                      sleep=sleep, label="torch.distributed.TCPStore")


def init_group(device: torch.device, num_workers: Optional[int] = None,
               multihost: bool = False):
    """(group, device) of this process: the group of the torchrun world (or
    of one rank), and the device the rank runs on (``cuda:LOCAL_RANK`` when
    ``device`` is the card). ``num_workers`` must equal the world size.
    ``multihost``: the torchrun environment is required, and its store is
    built with retries."""
    if multihost:
        multihost_env()
    rank, world, local = env_ranks()
    if num_workers is not None and num_workers != world:
        raise ValueError(
            f"num_workers={num_workers} but the world has {world} rank(s): "
            "launch one process per worker (torchrun --nproc-per-node N)")
    if device.type == "cuda":
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    if world == 1 and not multihost:
        store = dist.HashStore()
    else:
        store = tcp_store(rank, world, multihost)
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


# -- the (data, seq, model) mesh -------------------------------------------

DATA_AXIS = "data"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"
#: the mesh's axes, outermost first
AXES = (DATA_AXIS, SEQ_AXIS, MODEL_AXIS)


@dataclasses.dataclass
class Mesh:
    """One rank's view of the (data, seq, model) mesh: the extents
    (``shape``), this rank's coordinates (``coords``), and the group of
    each axis (``groups``; ``None`` for an axis of extent one: its
    collectives are the identity). ``world`` is the group of all ranks
    (``None`` for a mesh of one rank)."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, object]
    world: object = None
    device: torch.device = torch.device("cpu")

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[SEQ_AXIS] \
            * self.shape[MODEL_AXIS]

    @property
    def rank(self) -> int:
        return mesh_rank(self.shape, self.coords)

    def group(self, axis: str):
        return self.groups[axis]


def mesh_rank(shape: Dict[str, int], coords: Dict[str, int]) -> int:
    """The world rank of mesh coordinates: ``(d * sp + s) * tp + m``."""
    return ((coords[DATA_AXIS] * shape[SEQ_AXIS] + coords[SEQ_AXIS])
            * shape[MODEL_AXIS] + coords[MODEL_AXIS])


def mesh_coords(shape: Dict[str, int], r: int) -> Dict[str, int]:
    """The coordinates of world rank ``r`` (the inverse of
    :func:`mesh_rank`)."""
    tp, sp = shape[MODEL_AXIS], shape[SEQ_AXIS]
    return {DATA_AXIS: r // (sp * tp), SEQ_AXIS: (r // tp) % sp,
            MODEL_AXIS: r % tp}


def make_mesh(group, num_data: Optional[int] = None, num_model: int = 1,
              num_seq: int = 1) -> Mesh:
    """The (data, seq, model) mesh over the ranks of ``group`` (built by
    :func:`new_group`, or ``None`` for one rank): the JAX ``make_mesh``,
    with its argument order. ``num_data=None`` takes the world over
    ``num_model * num_seq``. Every rank of the world calls this at the
    same point, and builds its meshes over ``group`` in the same order."""
    world = world_size(group)
    per_replica = num_model * num_seq
    if num_data is None:
        if world % per_replica:
            raise ValueError(f"{world} devices not divisible by "
                             f"num_model*num_seq={per_replica}")
        num_data = world // per_replica
    if num_data * per_replica != world:
        raise ValueError(f"requested {num_data}x{num_seq}x{num_model} mesh "
                         f"but the world has {world} rank(s)")
    shape = {DATA_AXIS: num_data, SEQ_AXIS: num_seq, MODEL_AXIS: num_model}
    coords = mesh_coords(shape, rank(group))
    device = torch.device("cpu")
    groups: Dict[str, object] = {a: None for a in AXES}
    if group is not None:
        try:
            store, _, _, device, timeout_s = _ORIGINS[group]
        except KeyError:
            raise ValueError("make_mesh: the group was not built by "
                             "parallel.mesh.new_group") from None
        n = _MESHES.get(group, 0)
        _MESHES[group] = n + 1
        for axis in AXES:
            if shape[axis] == 1:
                continue
            others = ",".join(f"{a}{coords[a]}" for a in AXES if a != axis)
            groups[axis] = new_group(
                dist.PrefixStore(f"pdtn_mesh{n}/{axis}/{others}", store),
                coords[axis], shape[axis], device, timeout_s)
    return Mesh(shape, coords, groups, group, device)


def axis_sizes(mesh: Mesh) -> dict:
    """``{axis name: extent}`` in mesh order: the shape record of run and
    checkpoint manifests."""
    return {a: int(mesh.shape[a]) for a in AXES}
