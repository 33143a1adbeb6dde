"""Elastic resume: continue a run on another number of ranks. The port of
``pytorch_distributed_nn_tpu/resilience/elastic.py`` over the port's
FILE checkpoints.

At resume time the trainer asks :func:`plan_resume` for an
:class:`ElasticPlan`, before it builds its gradient sync:

- the checkpoint's **recorded geometry** comes from its manifest
  (:func:`..training.checkpoint.checkpoint_geometry`; the port records
  ``{"devices", "processes", "mesh": {"data", "seq", "model"}}``), else
  from the newest run manifest of ``<train_dir>/telemetry.jsonl``, else
  from ``heartbeat.json``;
- the **live geometry** is the world size the launch gives (one process
  and one device per rank): the data-parallel degree is the largest one
  at most the world size (and at most a requested ``num_workers``) that
  divides the global batch, which is PRESERVED (the per-rank batch
  rescales); ``grad_accum`` drops to the largest count that still
  divides;
- :meth:`ElasticPlan.event_fields` is the ``elastic_resume`` event; a
  topk run's says whether its error-feedback residuals were reset (the
  residuals are per replica: another data-parallel degree restarts them
  at zero, with a warning, as the JAX ``restore_resharded`` does).

``--strict-geometry`` keeps the exact-match contract: a changed geometry
raises :func:`strict_geometry_error`, naming both. The port's state is
replicated on every rank but the residuals, so a changed world size
needs no reshard: the same file restores on any number of ranks. The
streaming input's state needs none either: every rank of a node reads
the node's shards, so a resume on another world size sees the same
shard list and takes the exact restore; a changed host count
re-partitions the stream (``StreamingLoader.restore_repartitioned``, a
``data_refastforward`` event). A tp/sp run's world is ``dp * tp * sp``
ranks: the plan derives dp from the world over ``tp * sp``, and its
sharded directories restore on any mesh (each rank assembles the leaves
and takes its regions, ``training.checkpoint.restore_resharded``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Optional

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One run's device geometry: device count, process count and mesh
    factors (``{"data": 8, "seq": 1, "model": 1}``; ``None`` when only
    the counts were recorded)."""

    devices: int
    processes: int = 1
    mesh: Optional[dict] = None

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> Optional["Geometry"]:
        if not isinstance(d, dict) or "devices" not in d:
            return None
        mesh = d.get("mesh")
        return cls(
            devices=int(d["devices"]),
            processes=int(d.get("processes", 1)),
            mesh={str(k): int(v) for k, v in mesh.items()}
            if isinstance(mesh, dict) else None,
        )

    def to_dict(self) -> dict:
        out = {"devices": self.devices, "processes": self.processes}
        if self.mesh is not None:
            out["mesh"] = dict(self.mesh)
        return out

    def describe(self) -> str:
        s = f"{self.devices} device(s) / {self.processes} process(es)"
        if self.mesh:
            s += " mesh " + " ".join(
                f"{k}={v}" for k, v in self.mesh.items()
            )
        return s

    def matches(self, other: "Geometry") -> bool:
        """Device and process counts always compare; mesh factors only
        when both sides recorded them."""
        if self.devices != other.devices or self.processes != other.processes:
            return False
        if self.mesh is not None and other.mesh is not None:
            return dict(self.mesh) == dict(other.mesh)
        return True


def rank_geometry(world: int, mesh: Optional[dict] = None) -> dict:
    """The geometry record of a port run of ``world`` ranks (one process
    and one device each): data parallel only, or the tp/sp run's
    ``mesh`` extents (``{"data", "seq", "model"}``)."""
    return Geometry(devices=int(world), processes=int(world),
                    mesh=dict(mesh) if mesh is not None else
                    {"data": int(world), "seq": 1, "model": 1}).to_dict()


@dataclasses.dataclass
class ElasticPlan:
    """What :func:`plan_resume` decided: the checkpoint to resume, the
    geometry it was written on, and the data-parallel degree, batch and
    microbatch count derived for the live world."""

    step: int
    old: Geometry
    new: Geometry
    num_workers: int  # new data-parallel degree
    grad_accum: int
    batch_size: int  # the PRESERVED global batch
    changed: bool

    def describe(self) -> str:
        return (
            f"checkpoint step {self.step} written on {self.old.describe()}; "
            f"live fleet gives {self.new.describe()} — global batch "
            f"{self.batch_size} preserved "
            f"(per-device {self.batch_size // max(self._old_dp, 1)} -> "
            f"{self.batch_size // self.num_workers}), "
            f"grad_accum {self.grad_accum}"
        )

    @property
    def _old_dp(self) -> int:
        if self.old.mesh and "data" in self.old.mesh:
            return int(self.old.mesh["data"])
        return int(self.old.devices)

    def event_fields(self, error_feedback: bool = False) -> dict:
        """The ``elastic_resume`` telemetry event payload; for a run with
        topk error feedback also ``ef_state``: ``"reset"`` when the
        data-parallel degree changed (the residuals of the old replicas
        restart at zero), else ``"restored"``."""
        out = {
            "old": self.old.to_dict(),
            "new": self.new.to_dict(),
            "num_workers": self.num_workers,
            "grad_accum": self.grad_accum,
            "batch_size": self.batch_size,
            "per_device_batch": self.batch_size // self.num_workers,
        }
        if error_feedback:
            out["ef_state"] = ("reset" if self._old_dp != self.num_workers
                               else "restored")
        return out


def derive_data_parallel(
    devices_available: int,
    batch_size: int,
    tensor_parallel: int = 1,
    seq_parallel: int = 1,
    requested: Optional[int] = None,
) -> int:
    """The legal data-parallel degree for ``devices_available`` devices:
    from the capacity ceiling (devices over the tp*sp block, capped by a
    ``requested`` degree) down to the first that divides the global
    batch; dp = 1 always divides."""
    per_replica = tensor_parallel * seq_parallel
    cap = devices_available // per_replica
    if cap < 1:
        raise ValueError(
            f"tensor_parallel*seq_parallel={per_replica} exceeds the "
            f"{devices_available} available device(s) — no legal mesh; "
            "lower tp/sp or wait for capacity"
        )
    if requested is not None:
        cap = min(cap, int(requested))
    for dp in range(max(cap, 1), 0, -1):
        if batch_size % dp == 0:
            return dp
    return 1  # unreachable: dp=1 divides any batch


def rescale_grad_accum(batch_size: int, dp: int, grad_accum: int) -> int:
    """The largest microbatch count <= the configured one that still
    divides the preserved global batch on the new dp degree."""
    for a in range(max(int(grad_accum), 1), 0, -1):
        if batch_size % (dp * a) == 0:
            return a
    return 1


def _manifest_geometry(train_dir: str) -> Optional[Geometry]:
    """The newest run manifest's geometry in ``<train_dir>/
    telemetry.jsonl``."""
    from pytorch_distributed_nn_tpu_torch.observability.core import (
        STREAM_BASENAME,
    )

    found = None
    try:
        with open(os.path.join(train_dir, STREAM_BASENAME)) as f:
            for line in f:
                if '"manifest"' not in line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if rec.get("kind") == "manifest":
                    geom = Geometry.from_dict(rec.get("geometry"))
                    found = geom if geom is not None else found
    except OSError:
        return None
    return found


def recorded_geometry(train_dir: str, step: int) -> Optional[Geometry]:
    """The geometry checkpoint ``step`` of ``train_dir`` was written on:
    its manifest's, else the newest run manifest's, else
    ``heartbeat.json``'s; ``None`` when nothing recorded one."""
    from pytorch_distributed_nn_tpu_torch.resilience.supervisor import (
        heartbeat_path,
    )
    from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt

    geom = Geometry.from_dict(
        ckpt.checkpoint_geometry(ckpt.checkpoint_path(train_dir, step)))
    if geom is None:
        geom = _manifest_geometry(train_dir)
    if geom is None:
        try:
            with open(heartbeat_path(train_dir)) as f:
                geom = Geometry.from_dict(json.load(f).get("geometry"))
        except (OSError, ValueError, AttributeError):
            geom = None
    return geom


def plan_resume(
    train_dir: str,
    devices_available: int,
    *,
    batch_size: int,
    num_workers: Optional[int] = None,
    grad_accum: int = 1,
    tensor_parallel: int = 1,
    seq_parallel: int = 1,
) -> Optional[ElasticPlan]:
    """How ``--resume`` maps onto a world of ``devices_available`` ranks.

    ``None`` when there is nothing to adapt to: no checkpoint of
    ``train_dir`` verifies, or no geometry was recorded. Otherwise the
    plan names the newest verified step (the one the resume restores),
    the recorded and the derived geometry, and whether they differ."""
    from pytorch_distributed_nn_tpu_torch.training import checkpoint as ckpt

    step = None
    for s in ckpt.all_steps(train_dir)[::-1]:
        ok, _ = ckpt.verify_checkpoint(ckpt.checkpoint_path(train_dir, s))
        if ok:
            step = s
            break
    if step is None:
        return None
    old = recorded_geometry(train_dir, step)
    if old is None:
        return None
    dp = derive_data_parallel(
        devices_available, batch_size,
        tensor_parallel=tensor_parallel, seq_parallel=seq_parallel,
        requested=num_workers,
    )
    accum = rescale_grad_accum(batch_size, dp, grad_accum)
    new = Geometry(
        devices=dp * tensor_parallel * seq_parallel,
        # the port runs one process a device
        processes=dp * tensor_parallel * seq_parallel,
        mesh={"data": dp, "seq": seq_parallel, "model": tensor_parallel},
    )
    plan = ElasticPlan(
        step=step, old=old, new=new, num_workers=dp, grad_accum=accum,
        batch_size=int(batch_size), changed=not old.matches(new),
    )
    if plan.changed:
        logger.warning("elastic resume: %s", plan.describe())
    return plan


def strict_geometry_error(plan: ElasticPlan, train_dir: str) -> ValueError:
    """The exact-match failure of ``--strict-geometry``, naming both
    geometries."""
    return ValueError(
        f"--strict-geometry: checkpoint step {plan.step} in {train_dir} "
        f"was written on {plan.old.describe()} but the live fleet derives "
        f"{plan.new.describe()}. Rebuild the original geometry, or drop "
        "--strict-geometry to let elastic resume adapt"
    )
