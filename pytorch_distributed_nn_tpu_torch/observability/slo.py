"""SLO engine: objectives, multi-window burn rates, error budgets.

The port's copy of ``pytorch_distributed_nn_tpu/observability/slo.py``:
the same grammar, burn-rate math and events.

Percentile gates (``obs compare``) answer "is B worse than A"; an SLO
answers the operational question "is the service keeping its promise
*right now*, and how fast is it spending the error budget" — the signal
a canary controller pages or rolls back on. This module is that layer
for the serving tier:

- an **SLO spec grammar** in the established FaultPlan flag style
  (parse-time fail-fast — a typo fails the run at flag validation)::

      spec := item ("," item)*
      item := "lat_p" P "<" N ("ms"|"s") "@" W "s"     # latency objective
            | "avail" ">" PCT "%" "@" W "s"            # availability
      P    := 50 | 90 | 95 | 99

  Examples: ``lat_p99<25ms@60s``, ``avail>99.5%@300s``,
  ``lat_p99<25ms@60s,avail>99.5%@300s``.

- **burn-rate semantics** (the SRE-workbook shape): a latency objective
  ``lat_p99<25ms@60s`` grants an error budget of 1% of requests slower
  than 25 ms; ``avail>99.5%`` grants 0.5% failed/dropped. Over a window
  ``W``, ``burn_rate = bad_fraction(W) / budget`` — 1.0 means spending
  the budget exactly as fast as the objective allows. Each objective is
  evaluated over **two windows**: its spec window (long) and a short
  window of ``W/12`` (≥ 1 s). A **breach** requires BOTH to burn past
  1.0 — the long window proves the budget is really being spent, the
  short one proves the burn is *still happening* (an old burst with a
  healthy tail must not page). A deadline-dropped request counts bad for
  every objective: it was certainly not served within any latency
  target.

- an **error budget** over the whole evaluation lifetime:
  ``budget_remaining = 1 - bad_fraction / budget`` (1.0 = untouched,
  0 = exhausted, negative = overspent).

One evaluator (:class:`SLOEngine`) serves both modes, like
``reader.replay_registry``: attached to a live telemetry bus it updates
the ``slo_error_budget_remaining{slo}`` / ``slo_burn_rate{slo,window}``
gauges (exported as ``pdtn_slo_*`` by ``promexport``) and emits an
edge-triggered ``slo_breach`` event — which the ``slo_breach`` flight-
recorder detector (``observability/detect.py``) turns into exactly one
incident bundle under the existing cooldown discipline; fed an offline
stream (``evaluate_stream``) it replays the same math record by record,
so ``obs slo status|check`` and the live gauges can never disagree.

Torch-free, like every ``obs`` backend.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import re
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

#: latency percentiles the grammar accepts (the budget is 1 - P/100)
_PERCENTILES = (50, 90, 95, 99)

_LAT_RE = re.compile(
    r"^lat_p(?P<pct>\d{2})<(?P<val>\d+(?:\.\d+)?)(?P<unit>ms|s)"
    r"@(?P<win>\d+(?:\.\d+)?)s$"
)
_AVAIL_RE = re.compile(
    r"^avail>(?P<pct>\d+(?:\.\d+)?)%@(?P<win>\d+(?:\.\d+)?)s$"
)

#: short-window divisor (the SRE-workbook 1h/5m shape, scaled)
_SHORT_DIV = 12.0


@dataclasses.dataclass(frozen=True)
class SLO:
    """One parsed objective."""

    raw: str  # the item as written — the {slo} label on every gauge
    metric: str  # "latency" | "availability"
    window_s: float
    budget: float  # bad-event budget fraction (1 - target)
    threshold_ms: Optional[float] = None  # latency objectives only
    target: Optional[float] = None  # availability target fraction

    @property
    def short_window_s(self) -> float:
        return max(1.0, self.window_s / _SHORT_DIV)

    def is_bad(self, latency_ms: Optional[float], dropped: bool) -> bool:
        """Does one request spend error budget against this objective?"""
        if dropped:
            return True
        if self.metric == "latency":
            return latency_ms is None or latency_ms > self.threshold_ms
        return False  # availability: a served request is a success


def parse_slos(spec: str) -> Tuple[SLO, ...]:
    """Parse an SLO spec; raises ``ValueError`` on any malformed item
    (parse-time fail-fast, the FaultPlan discipline)."""
    out: List[SLO] = []
    for raw in (spec or "").split(","):
        raw = raw.strip()
        if not raw:
            continue
        if m := _LAT_RE.match(raw):
            pct = int(m.group("pct"))
            if pct not in _PERCENTILES:
                raise ValueError(
                    f"bad SLO {raw!r}: latency percentile p{pct} not in "
                    f"{{{', '.join(f'p{p}' for p in _PERCENTILES)}}}"
                )
            val = float(m.group("val"))
            ms = val * 1000.0 if m.group("unit") == "s" else val
            win = float(m.group("win"))
            if ms <= 0 or win <= 0:
                raise ValueError(
                    f"bad SLO {raw!r}: threshold and window must be > 0"
                )
            out.append(SLO(raw=raw, metric="latency", window_s=win,
                           budget=1.0 - pct / 100.0, threshold_ms=ms))
        elif m := _AVAIL_RE.match(raw):
            pct = float(m.group("pct"))
            win = float(m.group("win"))
            if not (0.0 < pct < 100.0):
                raise ValueError(
                    f"bad SLO {raw!r}: availability target must be in "
                    "(0, 100)%"
                )
            if win <= 0:
                raise ValueError(f"bad SLO {raw!r}: window must be > 0")
            out.append(SLO(raw=raw, metric="availability", window_s=win,
                           budget=1.0 - pct / 100.0, target=pct / 100.0))
        else:
            raise ValueError(
                f"bad SLO {raw!r}: expected lat_pP<Nms@Ws or "
                "avail>PCT%@Ws (e.g. lat_p99<25ms@60s, avail>99.5%@300s)"
            )
    if not out:
        raise ValueError(f"SLO spec {spec!r} names no objective")
    seen = set()
    for slo in out:
        if slo.raw in seen:
            raise ValueError(f"duplicate SLO {slo.raw!r} in {spec!r}")
        seen.add(slo.raw)
    return tuple(out)


def describe(slos: Sequence[SLO]) -> str:
    return ",".join(s.raw for s in slos)


class _Tracker:
    """One objective's sliding windows + lifetime budget accounting."""

    def __init__(self, slo: SLO):
        self.slo = slo
        self.events: collections.deque = collections.deque()  # (t, bad)
        self.total = 0
        self.bad_total = 0
        self.breached_now = False
        self.breaches = 0
        self.first_breach_t: Optional[float] = None

    def observe(self, t: float, bad: bool) -> None:
        self.events.append((t, bad))
        self.total += 1
        if bad:
            self.bad_total += 1
        horizon = t - self.slo.window_s
        while self.events and self.events[0][0] < horizon:
            self.events.popleft()

    def _window_counts(self, window_s: float, now: float):
        lo = now - window_s
        total = bad = 0
        for t, b in reversed(self.events):
            if t < lo:
                break
            total += 1
            bad += int(b)
        return total, bad

    def burn_rate(self, window_s: float, now: float,
                  min_events: int) -> Optional[float]:
        """``None`` when the window holds too few events to say anything
        — distinct from an informed 0.0 (enough traffic, none bad): a
        breach needs informed burning on BOTH windows, and recovery
        needs an informed acquittal, not silence (a lull in traffic must
        neither convict nor re-arm)."""
        total, bad = self._window_counts(window_s, now)
        if total < max(1, min_events):
            return None
        return (bad / total) / self.slo.budget

    def budget_remaining(self) -> float:
        if self.total == 0:
            return 1.0
        return 1.0 - (self.bad_total / self.total) / self.slo.budget

    def evaluate(self, now: float, min_events: int) -> dict:
        burn_long = self.burn_rate(self.slo.window_s, now, min_events)
        # the short window carries proportionally less signal; scale its
        # floor so a 60s/5s pair does not need 12x the traffic to arm
        short_floor = max(1, int(math.ceil(min_events / _SHORT_DIV)))
        burn_short = self.burn_rate(self.slo.short_window_s, now,
                                    short_floor)
        total, bad = self._window_counts(self.slo.window_s, now)
        return {
            "slo": self.slo.raw,
            "window_s": self.slo.window_s,
            "short_window_s": round(self.slo.short_window_s, 3),
            "events": total,
            "bad": bad,
            # None = window below its sample floor (no signal)
            "burn_rate": (
                round(burn_long, 4) if burn_long is not None else None
            ),
            "burn_rate_short": (
                round(burn_short, 4) if burn_short is not None else None
            ),
            "budget_remaining": round(self.budget_remaining(), 4),
            "breached_now": self.breached_now,
            "breaches": self.breaches,
        }


class SLOEngine:
    """Multi-window burn-rate evaluator over request records.

    ``telemetry=None`` is the offline mode (``evaluate_stream``): no
    gauges, no events, every record evaluated. With a live
    :class:`~.core.Telemetry`, the engine subscribes to the bus,
    throttles evaluation to ``eval_every_s`` (burn math over a deque is
    not free at 4000 req/s), keeps the ``slo_*`` gauges current and
    emits an edge-triggered ``slo_breach`` event per objective on each
    healthy→breach transition (re-armed only after the long window
    recovers below 1.0 — a sustained burn is ONE incident, not one per
    request).
    """

    def __init__(self, slos: Union[str, Sequence[SLO]], telemetry=None,
                 min_events: int = 20, eval_every_s: float = 0.05):
        self.slos = parse_slos(slos) if isinstance(slos, str) else \
            tuple(slos)
        if not self.slos:
            raise ValueError("SLOEngine needs at least one objective")
        self.telemetry = telemetry
        self.min_events = int(min_events)
        self.eval_every_s = float(eval_every_s)
        self._trackers = [_Tracker(s) for s in self.slos]
        self._last_eval = -math.inf
        self._subscribed = False
        if telemetry is not None:
            telemetry.subscribe(self.observe_record)
            self._subscribed = True

    # -- ingestion ---------------------------------------------------------

    def observe_record(self, rec: dict) -> None:
        """Bus/stream hook: request records and drop events feed the
        trackers; everything else passes through untouched."""
        kind = rec.get("kind")
        if kind == "step" and rec.get("latency_ms") is not None:
            t = float(rec.get("time") or time.time())
            lat = float(rec["latency_ms"])
            for tr in self._trackers:
                tr.observe(t, tr.slo.is_bad(lat, dropped=False))
        elif kind == "event" and rec.get("type") == "request_dropped":
            t = float(rec.get("time") or time.time())
            for tr in self._trackers:
                tr.observe(t, True)
        else:
            return
        if self.eval_every_s and t - self._last_eval < self.eval_every_s:
            return
        self._last_eval = t
        self._evaluate(t)

    def _evaluate(self, now: float) -> None:
        for tr in self._trackers:
            res = tr.evaluate(now, self.min_events)
            long_b, short_b = res["burn_rate"], res["burn_rate_short"]
            burning = (
                long_b is not None and long_b > 1.0
                and short_b is not None and short_b > 1.0
            )
            if burning and not tr.breached_now:
                tr.breached_now = True
                tr.breaches += 1
                if tr.first_breach_t is None:
                    tr.first_breach_t = now
                self._emit_breach(res, now)
            elif (tr.breached_now and short_b is not None
                  and short_b <= 1.0):
                # re-arm only on an INFORMED short-window recovery — the
                # long window stays burned for up to window_s after a
                # burst ends (latching on it would hide every later
                # burn), while a traffic lull (short window below its
                # sample floor) proves nothing and must not re-arm; a
                # sustained breach stays ONE breach
                tr.breached_now = False
            self._update_gauges(tr, res)

    def _emit_breach(self, res: dict, now: float) -> None:
        if self.telemetry is None:
            return
        self.telemetry.emit(
            "slo_breach",
            slo=res["slo"],
            burn_rate=res["burn_rate"],
            burn_rate_short=res["burn_rate_short"],
            window_s=res["window_s"],
            events=res["events"],
            bad=res["bad"],
            budget_remaining=res["budget_remaining"],
        )

    def _update_gauges(self, tr: _Tracker, res: dict) -> None:
        if self.telemetry is None:
            return
        reg = self.telemetry.registry
        reg.gauge(
            "slo_error_budget_remaining",
            help="error budget left for the objective (1 = untouched, "
                 "<= 0 = exhausted)",
            labels={"slo": tr.slo.raw},
        ).set(res["budget_remaining"])
        for window, burn in (
            (f"{tr.slo.window_s:g}s", res["burn_rate"]),
            (f"{tr.slo.short_window_s:g}s", res["burn_rate_short"]),
        ):
            reg.gauge(
                "slo_burn_rate",
                help="error-budget burn rate over the window (1 = "
                     "spending exactly at budget; NaN = window below "
                     "its sample floor)",
                labels={"slo": tr.slo.raw, "window": window},
            ).set(burn if burn is not None else float("nan"))

    # -- queries -----------------------------------------------------------

    def status(self, now: Optional[float] = None) -> List[dict]:
        """Per-objective state at ``now`` (default: last observed or
        wall clock)."""
        if now is None:
            now = self._last_eval if self._last_eval > 0 else time.time()
        return [tr.evaluate(now, self.min_events) for tr in self._trackers]

    def breached(self) -> List[dict]:
        """Objectives that breached at ANY point of the evaluation —
        the ``obs slo check`` conviction list."""
        return [
            {"slo": tr.slo.raw, "breaches": tr.breaches,
             "first_breach_time": tr.first_breach_t,
             "budget_remaining": round(tr.budget_remaining(), 4)}
            for tr in self._trackers if tr.breaches
        ]

    def close(self) -> None:
        if self._subscribed and self.telemetry is not None:
            self.telemetry.unsubscribe(self.observe_record)
            self._subscribed = False


# ---------------------------------------------------------------------------
# Offline evaluation (obs slo status|check)
# ---------------------------------------------------------------------------


def evaluate_stream(rs, slos: Union[str, Sequence[SLO]],
                    min_events: int = 20) -> Tuple["SLOEngine", List[dict]]:
    """Replay a parsed stream (``reader.RunStream``) through the same
    engine the live bus uses, evaluating at EVERY record (no throttle:
    offline cost is paid once). Returns ``(engine, status)`` where
    ``status`` is the per-objective state at the stream's end —
    ``engine.breached()`` lists objectives that burned at any point."""
    engine = SLOEngine(slos, telemetry=None, min_events=min_events,
                       eval_every_s=0.0)
    records = sorted(
        (r for r in list(rs.steps) + list(rs.events)
         if r.get("time") is not None),
        key=lambda r: float(r["time"]),
    )
    last_t = None
    for rec in records:
        engine.observe_record(rec)
        if (rec.get("kind") == "step" and rec.get("latency_ms") is not None) \
                or rec.get("type") == "request_dropped":
            last_t = float(rec["time"])
    return engine, engine.status(now=last_t)


def render_status(status: List[dict], breached: List[dict]) -> str:
    """Human-readable ``obs slo status`` text."""
    lines = [
        f"  {'objective':<24} {'events':>7} {'bad':>5} {'burn':>7} "
        f"{'burn(short)':>11} {'budget left':>11}  state"
    ]
    breached_names = {b["slo"] for b in breached}

    def _b(v):
        return "      -" if v is None else f"{v:7.2f}"

    for s in status:
        if s["slo"] in breached_names:
            state = "BREACHED"
        elif s["breached_now"]:
            state = "burning"
        else:
            state = "ok"
        lines.append(
            f"  {s['slo']:<24} {s['events']:>7} {s['bad']:>5} "
            f"{_b(s['burn_rate'])} {_b(s['burn_rate_short']):>11} "
            f"{s['budget_remaining']:>11.2f}  {state}"
        )
    for b in breached:
        lines.append(
            f"  breach: {b['slo']} burned past budget "
            f"{b['breaches']} time(s); budget remaining "
            f"{b['budget_remaining']:.2f}"
        )
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Selftest (obs slo --selftest)
# ---------------------------------------------------------------------------


def _synthetic_requests(engine: SLOEngine, n: int, rate: float,
                        bad_at=(), t0: float = 1_700_000_000.0,
                        lat_ok: float = 5.0, lat_bad: float = 100.0):
    for i in range(n):
        engine.observe_record({
            "kind": "step", "step": i, "time": t0 + i / rate,
            "latency_ms": lat_bad if i in bad_at else lat_ok,
        })
    return t0 + (n - 1) / rate


def selftest() -> int:
    """Invariant check for the SLO layer (<2 s, no torch): grammar
    round-trip + fail-fast, hand-checked burn-rate windows, budget
    arithmetic, multi-window breach logic, edge-triggered events, gauge
    exposition validity."""
    from pytorch_distributed_nn_tpu_torch.observability import promexport
    from pytorch_distributed_nn_tpu_torch.observability.core import (
        Telemetry,
        run_manifest,
    )

    checks = []

    def check(name, ok, detail=""):
        checks.append((name, bool(ok), detail))

    # grammar round-trip
    slos = parse_slos("lat_p99<25ms@60s,avail>99.5%@300s")
    check(
        "spec grammar parses budgets and windows",
        len(slos) == 2
        and abs(slos[0].budget - 0.01) < 1e-12
        and slos[0].threshold_ms == 25.0 and slos[0].window_s == 60.0
        and abs(slos[1].budget - 0.005) < 1e-12
        and slos[1].window_s == 300.0
        and slos[0].short_window_s == 5.0,
        describe(slos),
    )
    check(
        "latency thresholds accept seconds",
        parse_slos("lat_p50<1.5s@30s")[0].threshold_ms == 1500.0,
    )
    bad_specs = (
        "lat_p98<25ms@60s",   # unsupported percentile
        "avail>101%@60s",      # impossible target
        "lat_p99<25@60s",      # missing unit
        "qps>100@60s",         # unknown metric
        "",                    # empty
        "lat_p99<25ms@60s,lat_p99<25ms@60s",  # duplicate
    )
    failed_fast = 0
    for spec in bad_specs:
        try:
            parse_slos(spec)
        except ValueError:
            failed_fast += 1
    check(
        "malformed specs fail at parse time",
        failed_fast == len(bad_specs),
        f"{failed_fast}/{len(bad_specs)} rejected",
    )

    # hand-checked burn rate: 100 req over 10s (all inside the 60s
    # window), 3 slower than target, p99 budget 1% -> burn = 3.0
    eng = SLOEngine("lat_p99<25ms@60s", min_events=10, eval_every_s=0.0)
    end = _synthetic_requests(eng, 100, rate=10.0, bad_at=(10, 50, 90))
    s = eng.status(now=end)[0]
    check(
        "burn rate matches the hand calculation (3% bad / 1% budget)",
        abs(s["burn_rate"] - 3.0) < 1e-9 and s["events"] == 100
        and s["bad"] == 3,
        f"burn={s['burn_rate']}",
    )
    check(
        "budget remaining = 1 - bad_frac/budget",
        abs(s["budget_remaining"] - (1.0 - 3.0)) < 1e-9,
        f"remaining={s['budget_remaining']}",
    )

    # multi-window logic: an OLD burst with a healthy tail must not be
    # "breached now" (short window clean), but the budget stays spent
    eng2 = SLOEngine("lat_p99<25ms@60s", min_events=10, eval_every_s=0.0)
    end2 = _synthetic_requests(
        eng2, 600, rate=10.0, bad_at=tuple(range(0, 30))
    )  # 60s of traffic: burst in the first 3s, tail healthy
    s2 = eng2.status(now=end2)[0]
    check(
        "old burst with healthy tail: long window burns, short does not",
        s2["burn_rate"] > 1.0 and s2["burn_rate_short"] == 0.0
        and not s2["breached_now"],
        f"long={s2['burn_rate']} short={s2['burn_rate_short']}",
    )

    # edge-triggered breach events through a live telemetry bus
    t = Telemetry(manifest=run_manifest(config={"mode": "serving"}))
    eng3 = SLOEngine("lat_p99<25ms@10s", telemetry=t, min_events=10,
                     eval_every_s=0.0)
    _synthetic_requests(eng3, 200, rate=100.0,
                        bad_at=tuple(range(100, 200)))
    ctr = t.registry.get("events_total", {"type": "slo_breach"})
    check(
        "sustained burn emits exactly one edge-triggered slo_breach",
        ctr is not None and ctr.value == 1
        and len(eng3.breached()) == 1,
        f"events={ctr.value if ctr else None} "
        f"breached={eng3.breached()}",
    )
    text = promexport.render(t.registry)
    check(
        "slo gauges export and validate",
        'pdtn_slo_error_budget_remaining{slo="lat_p99<25ms@10s"}' in text
        and 'pdtn_slo_burn_rate{' in text
        and not promexport.validate_exposition(text),
        "missing slo gauge samples or invalid exposition",
    )
    dropped_eng = SLOEngine("avail>99%@10s", min_events=5,
                            eval_every_s=0.0)
    t0 = 1_700_000_000.0
    for i in range(20):
        dropped_eng.observe_record({
            "kind": "step", "step": i, "time": t0 + i * 0.1,
            "latency_ms": 3.0,
        })
    for i in range(5):
        dropped_eng.observe_record({
            "kind": "event", "type": "request_dropped",
            "time": t0 + 2.0 + i * 0.1,
        })
    sd = dropped_eng.status(now=t0 + 2.5)[0]
    check(
        "deadline drops spend availability budget",
        sd["bad"] == 5 and sd["burn_rate"] > 1.0,
        f"status={sd}",
    )

    failed = [c for c in checks if not c[1]]
    for name, ok, detail in checks:
        mark = "PASS" if ok else "FAIL"
        print(f"  [{mark}] {name}" + (f" — {detail}" if detail and not ok
                                      else ""))
    print(f"slo selftest: {len(checks) - len(failed)}/{len(checks)} "
          "invariants held")
    return 1 if failed else 0
