"""The port's serving chaos scenarios on the CPU, at the JAX suite's sizes:
each exits 0 with every invariant of the JAX scenario held, under the
JAX check names, in order (``live_reload``'s swap case trains on 2 gloo
rank processes; ``replica_loss`` spawns 3 replicas and its HTTP
clients' process)."""

import pytest

from torch_chaos_cli import run_chaos
import torch_cpu  # noqa: F401  (one intra-op thread)

CHECKS = {
    ("slo_burn", None): [
        "both runs served the offered load",
        "burn stream is span-carrying and version-stamped (schema v2)",
        "obs slo check fails the burn run (spec from the manifest)",
        "obs slo check passes the healthy twin",
        "sustained burn emits exactly one edge-triggered slo_breach",
        "exactly one slo_breach incident bundle captured",
        "bundle carries the ring + manifest + report",
        "healthy twin: zero breaches, zero bundles",
        "span attribution pins the injected slowdown on infer",
        "slowest-requests table attributes queue-or-infer dominance",
        "obs trace renders the slowest request's waterfall",
        "obs compare --by-version convicts the burn per artifact",
    ],
    ("generate", None): [
        "zero dropped/failed requests across the mid-stream swap",
        "zero jit retraces across prefill+decode families and the swap",
        "in-flight sequences were fenced and re-prefilled",
        "old engine's KV pages provably not reused (ledger fence: 0 "
        "violations, no live page on the old epoch)",
        "both artifact versions served, every request stamped",
        "every request admitted after the swap is stamped with the new "
        "version",
        "re-prefilled (fence-crossing) requests emit new-version tokens "
        "only",
        "stream: one span-carrying, version-stamped record per request",
        "obs summary: generation block + the swap transition",
        "KV-cache generation matches full-recompute greedy decode",
    ],
    ("live_reload", "swap"): [
        "training published a checkpoint per step",
        "watch-driven hot swaps: 10+ under live traffic",
        "zero dropped/failed requests across every swap",
        "zero jit retraces across every swap",
        "every record stamped with the version that served it",
        "all swap transitions visible in obs summary",
        "registry stable label tracks the newest publish",
    ],
    ("live_reload", "canary"): [
        "good canary ramps and AUTO-PROMOTES to stable",
        "bad canary convicted by the per-version percentile gate",
        "quality gate also names the non-finite outputs",
        "exactly one edge-triggered typed rollback event",
        "stable label restored atomically, canary cleared",
        "every request admitted after rollback routes to stable",
        "zero dropped/failed requests through promote AND rollback",
        "zero retraces across canary shadows, promote and rollback",
        "full lifecycle visible in obs summary "
        "(canary/promote/canary/rollback)",
    ],
    ("replica_loss", "kill"): [
        "kill: zero client-visible failures under open-loop load",
        "kill: the in-flight tail was covered by retry/hedge",
        "kill: pool kept serving on the 2 survivors",
        "kill: killed replica rejoined via /readyz",
        "kill: rejoined replica is a fresh, ready process",
        "kill: exactly one edge-triggered breaker_open",
        "kill: one replica_down (process exit) + rejoin replica_up "
        "+ breaker_close",
        "kill: frontend stream accounts every request "
        "(availability 1.0, zero shed)",
        "kill: every answered request assembles end-to-end "
        "(one marked winner, winner record joined, zero orphans)",
    ],
    ("replica_loss", "drain"): [
        "drain: rolling restart covered all 3 replicas",
        "drain: zero failed requests across the whole rolling restart",
        "drain: restarted replicas serve with zero retraces",
        "drain: 3 drain starts, 3 clean exits (rc=0)",
        "drain: no breaker opened and nothing was declared down uncleanly",
        "drain: zero deadline drops in every replica stream",
    ],
}


@pytest.mark.parametrize("name,case", list(CHECKS))
def test_scenario_holds_every_invariant(name, case, tmp_path, capsys):
    rc, held, failed = run_chaos(name, tmp_path, capsys,
                                 cases=[case] if case else None)
    assert (rc, failed) == (0, [])
    assert held == CHECKS[name, case]
