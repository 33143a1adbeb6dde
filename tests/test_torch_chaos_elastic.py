"""The port's ``elastic_resume`` chaos scenario on the CPU, case by case,
at the JAX suite's rank counts (gloo rank processes: shrink 8 -> 4,
regrow 2 -> 4, a corrupt shard of an 8-rank dp=4 tp=2 directory read on
4 ranks): each case exits 0 with every invariant of the JAX case held,
under the JAX check names, in order."""

import pytest

from torch_chaos_cli import run_chaos
import torch_cpu  # noqa: F401  (one intra-op thread)


def _resume_checks(tag, old, new):
    return [
        f"[{tag}] crash fired on the {old}-device mesh",
        f"[{tag}] geometry change detected ({old}->{new} devices)",
        f"[{tag}] resumed from the emergency step",
        f"[{tag}] global batch preserved across the transition",
        f"[{tag}] reshard-on-load is bitwise-lossless (params+opt)",
        f"[{tag}] post-resume loss curve within tolerance (rtol 0.001)",
        f"[{tag}] typed elastic_resume event with old/new geometry",
    ]


CASES = {
    "shrink": _resume_checks("shrink", 8, 4),
    "regrow": _resume_checks("regrow", 2, 4),
    "corrupt": [
        "[corrupt] per-shard CRC convicts mid-reshard",
        "[corrupt] elastic resume falls back to the previous valid step",
        "[corrupt] corrupt step quarantined",
        "[corrupt] fallback restore resharded bitwise onto the shrunk mesh",
    ],
}


@pytest.mark.parametrize("case", list(CASES))
def test_case_holds_every_invariant(case, tmp_path, capsys):
    rc, held, failed = run_chaos("elastic_resume", tmp_path, capsys,
                                 cases=[case])
    assert (rc, failed) == (0, [])
    assert held == CASES[case]
