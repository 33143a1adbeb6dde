"""The collective inventory and step cost of one walked step: the port
of ``pytorch_distributed_nn_tpu/analysis/report.py`` (the same
``to_dict`` keys, so CI consumers read either package's JSON).

``findings`` is always ``[]``: the SL rules belong to the JAX package's
HLO auditor, which has no counterpart in the port (the port has no HLO
to lint); ``analyze --fail-on``, ``--suppress``, ``--check-recompile``
and ``--check-donation`` exit 2, naming it.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

from pytorch_distributed_nn_tpu_torch.analysis.costmodel import (
    StepCost,
    WalkCollective,
)


@dataclasses.dataclass
class CollectiveSummary:
    """One (kind, dtype, shape, in_loop) bucket of identical collectives."""

    kind: str
    dtype: str
    shape: Tuple[int, ...]
    group_size: int
    in_loop: bool
    count: int
    payload_bytes_each: int
    est_ici_bytes_each: int

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "dtype": self.dtype,
            "shape": list(self.shape),
            "group_size": self.group_size,
            "in_loop": self.in_loop,
            "count": self.count,
            "payload_bytes_each": self.payload_bytes_each,
            "est_ici_bytes_each": self.est_ici_bytes_each,
        }


@dataclasses.dataclass
class Report:
    """The walk of one train step over a mesh: its collectives and cost."""

    mesh_shape: Dict[str, int]
    collectives: List[CollectiveSummary]
    findings: List = dataclasses.field(default_factory=list)
    num_params: int = 0
    param_bytes: int = 0
    cost: Optional[StepCost] = None

    def kinds(self) -> Dict[str, int]:
        """Total collective count per kind."""
        out: Dict[str, int] = {}
        for c in self.collectives:
            out[c.kind] = out.get(c.kind, 0) + c.count
        return out

    def est_ici_bytes_per_step(self) -> int:
        """Estimated per-device interconnect traffic of one step."""
        return sum(c.est_ici_bytes_each * c.count for c in self.collectives)

    def fired_rules(self) -> List[str]:
        return []

    def to_dict(self) -> dict:
        return {
            "mesh": dict(self.mesh_shape),
            "num_params": self.num_params,
            "param_bytes": self.param_bytes,
            "collectives": [c.to_dict() for c in self.collectives],
            "totals": {
                "by_kind": self.kinds(),
                "est_ici_bytes_per_step": self.est_ici_bytes_per_step(),
            },
            "findings": [],
            "fired_rules": [],
            "cost": self.cost.to_dict() if self.cost is not None else None,
        }

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def to_text(self) -> str:
        """Human-readable summary (the CLI's non-JSON output)."""
        lines = [
            "mesh: " + " × ".join(
                f"{k}={v}" for k, v in self.mesh_shape.items()
            ),
            f"params: {self.num_params} tensors, {self.param_bytes:,} bytes",
            f"est. ICI traffic/step/device: "
            f"{self.est_ici_bytes_per_step():,} bytes",
            "",
            "collectives:",
        ]
        if not self.collectives:
            lines.append("  (none)")
        for c in sorted(
            self.collectives,
            key=lambda c: -c.est_ici_bytes_each * c.count,
        ):
            shape = ",".join(map(str, c.shape))
            lines.append(
                f"  {c.kind:20s} {c.dtype}[{shape}] ×{c.count} "
                f"(groups of {c.group_size}, "
                f"~{c.est_ici_bytes_each * c.count:,} B/step)"
            )
        lines.append("")
        lines.append("findings: none (the HLO auditor has no port)")
        return "\n".join(lines)


def summarize_collectives(ops: List[WalkCollective]
                          ) -> List[CollectiveSummary]:
    """Bucket the walk's collectives for the report."""
    buckets: Dict[tuple, CollectiveSummary] = {}
    for op in ops:
        key = (op.kind, op.dtype, op.shape, op.group_size, op.in_loop)
        if key in buckets:
            buckets[key].count += 1
        else:
            buckets[key] = CollectiveSummary(
                kind=op.kind,
                dtype=op.dtype,
                shape=op.shape,
                group_size=op.group_size,
                in_loop=op.in_loop,
                count=1,
                payload_bytes_each=op.payload_bytes,
                est_ici_bytes_each=op.est_ici_bytes,
            )
    return sorted(
        buckets.values(), key=lambda c: (c.kind, c.dtype, c.shape)
    )
