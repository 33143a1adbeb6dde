"""Static analysis of the port's training step: the cost model, the
roofline calibration and the mesh planner, and the offline metrics
analysis (the port of ``pytorch_distributed_nn_tpu/analysis``).

- ``costmodel``: the step's FLOPs and bytes by a walk of its dispatched
  operations on the meta device (the JAX package walks HLO text);
- ``calibration``: per-family roofline ceilings, ``calibration.json``;
- ``planner``: mesh candidates ranked by the calibrated roofline;
- ``report``: the walk's collective inventory and cost;
- ``run_metrics``: speedups and time costs of a run's JSONL stream.

The JAX package's HLO auditor (``audit``, the SL rules, ``hlo``) and its
source linter have no counterpart here. Exports resolve lazily (PEP
562), as in the JAX package: importing the package imports no torch.
"""

import importlib

# public name -> submodule that defines it
_LAZY = {
    "FAMILIES": "costmodel",
    "FamilyCost": "costmodel",
    "StepCost": "costmodel",
    "op_family": "costmodel",
    "step_cost_from_walk": "costmodel",
    "walk_step": "costmodel",
    "decode_phase_cost": "costmodel",
    "DecodeCost": "costmodel",
    "CalibrationProfile": "calibration",
    "default_profile": "calibration",
    "fit_from_trace": "calibration",
    "fit_microbench": "calibration",
    "predict_step_ms": "calibration",
    "peak_flops_per_device": "calibration",
    "plan": "planner",
    "render_plan": "planner",
    "enumerate_meshes": "planner",
    "Candidate": "planner",
    "Report": "report",
    "CollectiveSummary": "report",
    "summarize_collectives": "report",
    "load_metrics": "run_metrics",
    "summarize": "run_metrics",
    "speedup": "run_metrics",
    "time_cost_report": "run_metrics",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        )
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
