"""Sweep specs: grid/random search over ``TrainConfig`` fields (the
port's copy of the JAX package's ``experiments/spec.py``: the same
grammar, reserved fields, enumeration and seeds, so a spec gives the same
trials in both packages).

A sweep is declared as a compact spec string — the same philosophy as the
fault grammar (resilience/faults.py): one validated, reproducible input
instead of a shell script of flag permutations. Grammar::

    spec   := axis (";" axis)*
    axis   := FIELD "=" values
    values := scalar ("," scalar)*          # explicit candidate list
            | LO ".." HI                    # uniform range   (random mode)
            | "log:" LO ".." HI             # log-uniform     (random mode)

``FIELD`` must name a :class:`~..training.trainer.TrainConfig` dataclass
field (lr, batch_size, network, num_workers, compression,
straggler_deadline, ...). Values are coerced to the field's declared type;
a typo'd field or an uncoercible value fails at parse time, never after N
trials have burned their budget. Runner-owned fields (train_dir, seed,
max_steps, resume, ...) are reserved — the orchestrator sets those.

Examples::

    lr=0.4,0.2,0.1,0.05,0.025,0.0125,0.00625      # the reference tune.sh grid
    lr=0.1,0.01;batch_size=32,64,128              # 2x3 grid, 6 trials
    lr=log:1e-4..1e-1;momentum=0.8..0.99          # random search (--samples N)

Modes: ``grid`` (default) takes the cartesian product of explicit lists —
range axes are rejected. ``random`` (``samples=N`` / ``--samples N``) draws
N trials: range axes sample their interval, list axes sample uniformly
from the list. Both enumerations are deterministic under ``sweep_seed``.

Per-trial seeds: ``SeedSequence((sweep_seed, trial_index))`` — any trial is
individually reproducible from (spec, sweep_seed, index) alone, and no two
trials share a stream (the property the reference's "same seed everywhere"
grid silently lacked).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

#: the reference's default candidate grid (src/tune.sh:8), as a spec
DEFAULT_SPEC = "lr=0.4,0.2,0.1,0.05,0.025,0.0125,0.00625"

#: fields the runner owns per trial; a spec naming one is a bug, not a knob
RESERVED_FIELDS = frozenset({
    "train_dir", "resume", "max_steps", "eval_freq", "supervise",
    "seed", "metrics_path", "warm_start", "log_every",
})


def trial_seed(sweep_seed: int, index: int) -> int:
    """The trial's ``TrainConfig.seed``: ``SeedSequence((sweep_seed, i))``
    spun down to one 32-bit word. Stable across processes and platforms
    (numpy's SeedSequence is specified, not implementation-defined)."""
    ss = np.random.SeedSequence((int(sweep_seed), int(index)))
    return int(ss.generate_state(1)[0])


@dataclasses.dataclass(frozen=True)
class Axis:
    field: str
    kind: str  # "list" | "range" | "logrange"
    values: Tuple = ()  # list kind: coerced candidates, declaration order
    lo: float = 0.0  # range kinds
    hi: float = 0.0

    def __str__(self) -> str:
        if self.kind == "list":
            vals = ",".join(_fmt_value(v) for v in self.values)
            return f"{self.field}={vals}"
        prefix = "log:" if self.kind == "logrange" else ""
        return f"{self.field}={prefix}{self.lo:g}..{self.hi:g}"


@dataclasses.dataclass
class Trial:
    """One point of the sweep: index, config overrides, derived seed."""

    index: int
    overrides: Dict[str, object]
    seed: int

    def label(self) -> str:
        return " ".join(
            f"{k}={_fmt_value(v)}" for k, v in self.overrides.items()
        )


def _fmt_value(v) -> str:
    if isinstance(v, float):
        return f"{v:g}"
    return str(v)


def _config_field_types() -> Dict[str, str]:
    """``TrainConfig`` field name -> declared type string, from the
    port's torch-free ``training.config`` (field for field the JAX
    ``TrainConfig``), so spec validation and the orchestrator built on it
    never import torch."""
    from pytorch_distributed_nn_tpu_torch.training.config import TrainConfig

    return {f.name: str(f.type) for f in dataclasses.fields(TrainConfig)}


def _coerce(field: str, type_str: str, text: str):
    """Coerce one spec token to the field's declared type.

    Declared types are annotation STRINGS (trainer uses deferred
    annotations): "float", "Optional[int]", "str", "bool", ... ``none``
    is accepted for Optional fields (e.g. straggler_deadline=none,1.0).
    """
    text = text.strip()
    if not text:
        raise ValueError(f"{field}: empty value in spec")
    # 'none' clears an Optional field; for plain str fields it is just a
    # string (compression=none is a legitimate candidate value)
    if text.lower() == "none" and "Optional" in type_str:
        return None
    try:
        if "bool" in type_str:
            if text.lower() in ("true", "1", "yes"):
                return True
            if text.lower() in ("false", "0", "no"):
                return False
            raise ValueError("expected true/false")
        if "int" in type_str:
            return int(text)
        if "float" in type_str:
            return float(text)
    except ValueError as e:
        raise ValueError(
            f"{field}: cannot coerce {text!r} to {type_str}: {e}"
        ) from None
    return text  # str-typed fields take the token verbatim


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """A parsed, validated sweep declaration (immutable, like FaultPlan)."""

    axes: Tuple[Axis, ...]
    mode: str = "grid"  # grid | random
    samples: Optional[int] = None  # random mode: number of trials
    sweep_seed: int = 0

    @classmethod
    def parse(
        cls,
        text: str,
        samples: Optional[int] = None,
        sweep_seed: int = 0,
    ) -> "SweepSpec":
        field_types = _config_field_types()
        axes: List[Axis] = []
        seen = set()
        for raw in text.split(";"):
            raw = raw.strip()
            if not raw:
                continue
            if "=" not in raw:
                raise ValueError(
                    f"bad spec axis {raw!r}: expected field=values"
                )
            field, _, values = raw.partition("=")
            field = field.strip()
            if field not in field_types:
                raise ValueError(
                    f"unknown TrainConfig field {field!r} in spec "
                    f"(see docs/experiments.md for the sweepable surface)"
                )
            if field in RESERVED_FIELDS:
                raise ValueError(
                    f"field {field!r} is runner-owned and cannot be swept "
                    f"(reserved: {', '.join(sorted(RESERVED_FIELDS))})"
                )
            if field in seen:
                raise ValueError(f"duplicate spec axis {field!r}")
            seen.add(field)
            values = values.strip()
            log = values.startswith("log:")
            body = values[4:] if log else values
            if ".." in body:
                lo_s, _, hi_s = body.partition("..")
                try:
                    lo, hi = float(lo_s), float(hi_s)
                except ValueError:
                    raise ValueError(
                        f"{field}: bad range {body!r} (expected LO..HI)"
                    ) from None
                if not (math.isfinite(lo) and math.isfinite(hi)) or lo >= hi:
                    raise ValueError(
                        f"{field}: range needs finite LO < HI, got {body!r}"
                    )
                if log and lo <= 0:
                    raise ValueError(
                        f"{field}: log range needs LO > 0, got {lo:g}"
                    )
                tname = field_types[field]
                if "int" not in tname and "float" not in tname:
                    raise ValueError(
                        f"{field}: ranges need a numeric field "
                        f"(declared {tname})"
                    )
                axes.append(Axis(field, "logrange" if log else "range",
                                 lo=lo, hi=hi))
                continue
            if log:
                raise ValueError(
                    f"{field}: 'log:' only applies to LO..HI ranges"
                )
            vals = tuple(
                _coerce(field, field_types[field], v)
                for v in values.split(",")
            )
            axes.append(Axis(field, "list", values=vals))
        if not axes:
            raise ValueError("empty sweep spec")
        mode = "random" if samples is not None else "grid"
        if samples is not None and samples < 1:
            raise ValueError(f"samples must be >= 1, got {samples}")
        if mode == "grid":
            ranged = [a.field for a in axes if a.kind != "list"]
            if ranged:
                raise ValueError(
                    f"range axes ({', '.join(ranged)}) need random mode — "
                    "pass samples=N (--samples N)"
                )
        return cls(axes=tuple(axes), mode=mode, samples=samples,
                   sweep_seed=int(sweep_seed))

    # -- enumeration ------------------------------------------------------

    def trials(self) -> List[Trial]:
        """The sweep's trial list, in deterministic index order."""
        if self.mode == "grid":
            combos = itertools.product(*(a.values for a in self.axes))
            return [
                Trial(
                    index=i,
                    overrides={a.field: v
                               for a, v in zip(self.axes, combo)},
                    seed=trial_seed(self.sweep_seed, i),
                )
                for i, combo in enumerate(combos)
            ]
        rng = np.random.default_rng(
            np.random.SeedSequence((int(self.sweep_seed), 0x5EED))
        )
        types = _config_field_types()
        out = []
        for i in range(int(self.samples or 0)):
            overrides = {}
            for a in self.axes:
                if a.kind == "list":
                    overrides[a.field] = a.values[
                        int(rng.integers(len(a.values)))
                    ]
                else:
                    if a.kind == "logrange":
                        v = math.exp(
                            math.log(a.lo)
                            + (math.log(a.hi) - math.log(a.lo))
                            * float(rng.random())
                        )
                    else:
                        v = a.lo + (a.hi - a.lo) * float(rng.random())
                    if "int" in types[a.field]:
                        v = int(round(v))
                    overrides[a.field] = v
            out.append(Trial(index=i, overrides=overrides,
                             seed=trial_seed(self.sweep_seed, i)))
        return out

    def describe(self) -> str:
        """Canonical round-trippable string (the journal's spec record)."""
        return ";".join(str(a) for a in self.axes)
