"""Canary router: traffic splitting, ramp, auto-promote, auto-rollback.

The port of ``pytorch_distributed_nn_tpu/serving/router.py``: the same
policy grammar, split, gate and events, so one record stream drives the
JAX router and this one to the same decisions.

The last piece of the deployment lifecycle (docs/serving.md): the
registry names versions, the engine hot-swaps weights, and this module
decides WHICH weights each request sees and whether a new artifact earns
full traffic:

- **Deterministic split.** Each request hashes its request id
  (``crc32(request_id) % 10_000``) against the current canary fraction —
  the same id always lands on the same side, so a client retrying a
  request cannot flap between versions and the split is reproducible
  from the stream alone.
- **Two engines, one warm set.** The canary runs on
  ``engine.shadow(artifact)`` — its own module on the card, sharing the
  stable engine's warmed shapes, so starting a canary builds nothing and
  ``retraces() == 0`` covers both sides. Its batcher's scheduler thread
  runs the shadow's ``warm_thread`` before it takes a batch (a new
  thread's cuBLAS and cuDNN handles and plans are cold), and the batcher
  is built before the router's lock is taken, so live traffic never
  waits on that pass.
- **Ramp on evidence.** The canary fraction walks a schedule
  (``CanaryPolicy.ramp``); each stage must serve ``stage_requests``
  canary requests with the gate green before the next. The gate is three
  independent convictions over sliding windows:

  1. latency percentiles — ``reader.compare_serving_windows``, literally
     the ``obs compare --by-version`` rows (thresholds AND jitter
     floors), canary window vs stable window;
  2. SLO burn — a dedicated :class:`~..observability.slo.SLOEngine` fed
     only canary records (same math as ``obs slo check``);
  3. output quality — the engine's per-row non-finite flag (a
     NaN-emitting artifact is a bad deploy latency can never convict).

- **Rollback is edge-triggered.** One typed ``rollback`` event per
  canary, traffic snaps back to stable between two batches, the
  ``stable`` label is restored and ``canary`` cleared in ONE atomic
  registry write. Promote is the mirror image: the stable engine
  hot-swaps to the canary's artifact (zero downtime — the canary's
  in-flight requests drain on its shadow engine) and the labels move
  atomically.

:class:`RegistryWatcher` closes the loop the reference's NFS-polling
evaluator hinted at: a live server follows the registry's labels —
``stable`` moves hot-swap, ``canary`` moves start a ramp — so publishing
IS deploying.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
import zlib
from typing import Callable, Optional, Tuple

logger = logging.getLogger(__name__)

#: hash space of the deterministic split (basis points of traffic)
_SPLIT_BUCKETS = 10_000


@dataclasses.dataclass(frozen=True)
class CanaryPolicy:
    """When and how a canary earns (or loses) traffic.

    Parsed from the ``--canary`` flag spec in the FaultPlan grammar
    style: ``ramp=5:25:50,stage=200,threshold=0.5,window=400,min=50,
    nonfinite=0`` — unknown keys and malformed values fail at parse
    time, before any engine pays warmup.
    """

    #: traffic fractions the canary ramps through (percent, increasing)
    ramp: Tuple[float, ...] = (5.0, 25.0, 50.0)
    #: canary requests each stage must serve (gate green) before the
    #: next stage — the last stage's quota completing promotes
    stage_requests: int = 200
    #: relative regression threshold on the latency-percentile rows
    threshold: float = 0.5
    #: sliding-window length (records per side) the gate judges over
    window: int = 400
    #: per-side sample floor below which the gate stays silent — a
    #: traffic lull neither convicts nor promotes
    min_samples: int = 50
    #: fraction of windowed canary responses allowed to be non-finite
    #: (0 = any NaN/Inf output convicts)
    nonfinite: float = 0.0
    #: SLO objectives evaluated over the canary's records (the
    #: ``obs slo`` grammar); None = no SLO gate
    slo: Optional[str] = None

    @classmethod
    def parse(cls, spec: Optional[str], slo: Optional[str] = None
              ) -> "CanaryPolicy":
        kw: dict = {"slo": slo}
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(
                    f"bad canary spec entry {part!r}: expected key=value "
                    "(ramp=5:25:50,stage=200,threshold=0.5,window=400,"
                    "min=50,nonfinite=0)"
                )
            key, val = part.split("=", 1)
            key = key.strip()
            try:
                if key == "ramp":
                    ramp = tuple(float(v) for v in val.split(":"))
                    if not ramp or any(
                        not 0 < f <= 100 for f in ramp
                    ) or list(ramp) != sorted(ramp):
                        raise ValueError
                    kw["ramp"] = ramp
                elif key == "stage":
                    kw["stage_requests"] = int(val)
                    if kw["stage_requests"] < 1:
                        raise ValueError
                elif key == "threshold":
                    kw["threshold"] = float(val)
                    if kw["threshold"] <= 0:
                        raise ValueError
                elif key == "window":
                    kw["window"] = int(val)
                    if kw["window"] < 2:
                        raise ValueError
                elif key == "min":
                    kw["min_samples"] = int(val)
                    if kw["min_samples"] < 1:
                        raise ValueError
                elif key == "nonfinite":
                    kw["nonfinite"] = float(val)
                    if not 0 <= kw["nonfinite"] <= 1:
                        raise ValueError
                else:
                    raise ValueError(
                        f"unknown canary spec key {key!r} (have ramp, "
                        "stage, threshold, window, min, nonfinite)"
                    )
            except ValueError as e:
                if e.args:
                    raise
                raise ValueError(
                    f"bad canary spec value {part!r}"
                ) from None
        return cls(**kw)


class _CanarySide:
    """One in-flight canary: shadow engine + its own batcher + gate
    state. Created by ``start_canary``, destroyed by promote/rollback."""

    def __init__(self, engine, batcher, artifact_dir: str, version: str):
        self.engine = engine
        self.batcher = batcher
        self.artifact_dir = artifact_dir
        self.version = version
        self.stage = 0
        self.stage_served = 0
        self.started = time.time()
        self.drops = 0
        self.slo_engine = None


class CanaryRouter:
    """Routes ``submit`` traffic between the stable batcher and an
    optional canary side, and runs the promotion/rollback controller
    off the telemetry bus (the SLOEngine subscription pattern).

    Duck-types the scheduler surface the HTTP server and load generator
    use (``submit`` / ``served`` / ``dropped`` / ``default_timeout_s`` /
    ``engine``), so it drops into their ``batcher`` seat unchanged.
    With no canary in flight it is a passthrough.
    """

    def __init__(self, batcher, telemetry=None, registry=None,
                 policy: Optional[CanaryPolicy] = None,
                 shadow_factory: Optional[Callable] = None,
                 decide_every_s: float = 0.05):
        from pytorch_distributed_nn_tpu_torch.observability.core import (
            get_telemetry,
        )

        self.batcher = batcher
        self.engine = batcher.engine
        self.telemetry = (
            telemetry if telemetry is not None else get_telemetry()
        )
        self.registry = registry
        self.policy = policy or CanaryPolicy()
        self._shadow_factory = shadow_factory
        self.decide_every_s = float(decide_every_s)
        self._lock = threading.RLock()
        self._canary: Optional[_CanarySide] = None
        self._windows: dict = {}  # version -> deque of request records
        self._last_decide = -float("inf")
        self.promotes = 0
        self.rollbacks = 0
        self.last_rollback: Optional[dict] = None
        self._retired_served = 0  # served counts of closed canary sides
        self._retired_dropped = 0
        self.telemetry.subscribe(self._observe)

    # -- scheduler surface -------------------------------------------------

    @property
    def default_timeout_s(self) -> float:
        return self.batcher.default_timeout_s

    @property
    def served(self) -> int:
        with self._lock:
            extra = self._canary.batcher.served if self._canary else 0
            return self.batcher.served + extra + self._retired_served

    @property
    def dropped(self) -> int:
        with self._lock:
            extra = self._canary.batcher.dropped if self._canary else 0
            return self.batcher.dropped + extra + self._retired_dropped

    @staticmethod
    def split_bucket(request_id: str) -> int:
        """Deterministic hash bucket of a request id in
        ``[0, 10000)`` — bucket < fraction·10000 routes to the canary."""
        return zlib.crc32(str(request_id).encode()) % _SPLIT_BUCKETS

    def submit(self, x, timeout_s: Optional[float] = None,
               request_id: Optional[str] = None, klass: str = "stable",
               trace=None):
        from pytorch_distributed_nn_tpu_torch.observability import tracing

        rid = request_id if request_id is not None \
            else tracing.new_request_id()
        with self._lock:
            side = self.batcher
            if self._canary is not None:
                fraction = self.policy.ramp[self._canary.stage] / 100.0
                if self.split_bucket(rid) < fraction * _SPLIT_BUCKETS:
                    side = self._canary.batcher
        return side.submit(x, timeout_s=timeout_s, request_id=rid,
                           klass=klass, trace=trace)

    @property
    def shed(self) -> int:
        with self._lock:
            extra = self._canary.batcher.shed if self._canary else 0
            return self.batcher.shed + extra

    @property
    def max_queue(self):
        return self.batcher.max_queue

    @property
    def draining(self) -> bool:
        return self.batcher.draining

    def begin_drain(self) -> None:
        """Drain both sides (SIGTERM path): stable and any in-flight
        canary batcher stop admitting; queued work finishes."""
        with self._lock:
            side = self._canary
        self.batcher.begin_drain()
        if side is not None:
            side.batcher.begin_drain()

    # -- lifecycle transitions ---------------------------------------------

    def swap(self, artifact_dir: str, source: str = "api") -> str:
        """Direct hot-swap of the STABLE side (no canary evaluation) —
        the ``stable``-label follow path and the admin endpoint's
        default action. Emits one typed ``swap`` event."""
        old = self.engine.version
        new = self.engine.swap(artifact_dir)
        self.telemetry.emit(
            "swap", from_version=old, version=new, source=source,
            swaps=self.engine.swaps,
        )
        if self.registry is not None and self.registry.get(new):
            try:
                self.registry.label("stable", new)
            except Exception:
                logger.exception("swap: could not move the stable label")
        return new

    def start_canary(self, artifact_dir: str, source: str = "api") -> str:
        """Bring up a canary side on ``artifact_dir`` at the first ramp
        fraction. One canary at a time; returns its version."""
        from pytorch_distributed_nn_tpu_torch.serving.batcher import Batcher

        def _busy():
            return RuntimeError(
                f"a canary is already in flight ({self._canary.version}); "
                "promote or roll it back first")

        with self._lock:
            if self._canary is not None:
                raise _busy()
        factory = self._shadow_factory or self.engine.shadow
        shadow = factory(artifact_dir)
        if shadow.version == self.engine.version:
            raise ValueError(
                f"canary artifact resolves to the serving version "
                f"{shadow.version} — nothing to evaluate"
            )
        # its scheduler thread warms the shadow before start() returns
        batcher = Batcher(
            shadow, telemetry=self.telemetry,
            batch_window_s=self.batcher.batch_window_s,
            default_timeout_s=self.batcher.default_timeout_s,
            max_queue=self.batcher.max_queue,
            canary_share=self.batcher.canary_share,
        )
        with self._lock:
            if self._canary is not None:
                batcher.close(drain=False)
                raise _busy()
            side = _CanarySide(shadow, batcher, artifact_dir,
                               shadow.version)
            if self.policy.slo:
                from pytorch_distributed_nn_tpu_torch.observability.slo import (
                    SLOEngine,
                )

                # offline-mode engine (no gauges/events of its own): the
                # router is the one deciding, the breach it emits is the
                # typed rollback
                side.slo_engine = SLOEngine(
                    self.policy.slo, telemetry=None,
                    min_events=self.policy.min_samples,
                )
            self._windows.setdefault(side.version, _deque(
                self.policy.window
            ))
            self._windows.setdefault(self.engine.version, _deque(
                self.policy.window
            ))
            self._canary = side
        self.telemetry.emit(
            "canary", phase="start", version=side.version,
            stable=self.engine.version,
            fraction=self.policy.ramp[0] / 100.0, source=source,
        )
        logger.info("canary %s started at %.1f%% against stable %s",
                    side.version, self.policy.ramp[0], self.engine.version)
        return side.version

    def _retire_canary(self) -> None:
        """Detach the canary side; its batcher drains in the background
        (closing it inline would deadlock when the decision fired on its
        own scheduler thread). Caller holds ``_lock`` — the detach must
        be atomic with the promote/rollback decision that triggered it."""
        side = self._canary
        self._canary = None

        def _close():
            side.batcher.close()
            with self._lock:
                self._retired_served += side.batcher.served
                self._retired_dropped += side.batcher.dropped

        threading.Thread(
            target=_close, name="pdtn-canary-drain", daemon=True
        ).start()

    def rollback(self, reasons, source: str = "gate") -> None:
        """Convict the canary: snap traffic back to stable, emit ONE
        typed ``rollback`` event, restore the ``stable`` label and clear
        ``canary`` in one atomic registry write. Idempotent — a second
        conviction (or an operator racing the gate) is a no-op."""
        if isinstance(reasons, str):
            reasons = [reasons]
        with self._lock:
            side = self._canary
            if side is None:
                return
            self._retire_canary()
            self.rollbacks += 1
            self.last_rollback = {
                "version": side.version, "stable": self.engine.version,
                "time": time.time(), "reasons": list(reasons),
                "stage": side.stage, "canary_served": side.batcher.served,
            }
            # the labels move before the lock is released: a watcher that
            # reads the router's state and then the labels never sees the
            # new state beside the old labels
            self._move_labels(self.engine.version, "rollback")
        self.telemetry.emit(
            "rollback", version=side.version, stable=self.engine.version,
            reasons=list(reasons), stage=side.stage, source=source,
        )
        logger.warning("canary %s ROLLED BACK (%s); stable %s restored",
                       side.version, "; ".join(reasons),
                       self.engine.version)

    def _move_labels(self, stable: str, what: str) -> None:
        """Clear ``canary`` and point ``stable`` at ``stable`` (when the
        registry holds it) in one index write. Called under ``_lock``."""
        if self.registry is None:
            return
        try:
            moves = {"canary": None}
            if self.registry.get(stable):
                moves["stable"] = stable
            self.registry.set_labels(moves)
        except Exception:
            logger.exception("%s: could not move registry labels", what)

    def _promote(self) -> None:
        with self._lock:
            side = self._canary
            if side is None:
                return
            old = self.engine.version
            # zero-downtime promote: stable adopts the shadow's module,
            # already on the device (one install between batches); the
            # canary side's in-flight requests drain on the shadow
            self.engine.adopt(side.engine)
            self._retire_canary()
            self.promotes += 1
            self._move_labels(side.version, "promote")
        self.telemetry.emit(
            "promote", version=side.version, from_version=old,
            stages=len(self.policy.ramp), canary_served=side.batcher.served,
            swaps=self.engine.swaps,
        )
        logger.info("canary %s PROMOTED (stable was %s)",
                    side.version, old)

    # -- the controller: bus observer + gate -------------------------------

    def _observe(self, rec: dict) -> None:
        """Telemetry-bus hook (runs on the batcher scheduler threads):
        windows per version, feeds the canary's SLO engine, and runs the
        throttled promote/rollback decision."""
        version = rec.get("version")
        if version is None:
            return
        if rec.get("kind") == "step" and rec.get("latency_ms") is not None:
            with self._lock:
                win = self._windows.get(str(version))
                if win is not None:
                    win.append(rec)
                side = self._canary
                if side is not None and str(version) == side.version:
                    side.stage_served += 1
                    if side.slo_engine is not None:
                        side.slo_engine.observe_record(rec)
        elif rec.get("kind") == "event" \
                and rec.get("type") == "request_dropped":
            with self._lock:
                side = self._canary
                if side is not None and str(version) == side.version:
                    side.drops += 1
                    if side.slo_engine is not None:
                        side.slo_engine.observe_record(rec)
        else:
            return
        now = time.monotonic()
        if now - self._last_decide < self.decide_every_s:
            return
        self._last_decide = now
        self._decide()

    def _gate(self, side: "_CanarySide"):
        """(verdict, reasons): ``False`` convicts. Called under lock."""
        from pytorch_distributed_nn_tpu_torch.observability import reader

        stable_win = self._windows.get(self.engine.version) or ()
        canary_win = self._windows.get(side.version) or ()
        if len(canary_win) < self.policy.min_samples \
                or len(stable_win) < self.policy.min_samples:
            return None, []  # below the sample floor: no signal
        reasons = []
        _, regressions = reader.compare_serving_windows(
            stable_win, canary_win, threshold=self.policy.threshold,
        )
        for r in regressions:
            reasons.append(
                f"{r['metric']}: {r['baseline']:.2f} -> "
                f"{r['candidate']:.2f} ({r['delta']:+.0%} > "
                f"{self.policy.threshold:.0%})"
            )
        if side.slo_engine is not None:
            for b in side.slo_engine.breached():
                reasons.append(
                    f"slo {b['slo']} breached "
                    f"(budget {b['budget_remaining']:.2f})"
                )
        bad = sum(1 for r in canary_win if r.get("nonfinite"))
        if bad > self.policy.nonfinite * len(canary_win):
            reasons.append(
                f"non-finite outputs: {bad}/{len(canary_win)} windowed "
                f"responses (limit {self.policy.nonfinite:.0%})"
            )
        return (not reasons), reasons

    def _decide(self) -> None:
        advance = promote = False
        reasons = []
        with self._lock:
            side = self._canary
            if side is None:
                return
            verdict, reasons = self._gate(side)
            if verdict is False:
                pass  # conviction handled below, outside the lock path
            elif verdict and side.stage_served >= self.policy.stage_requests:
                if side.stage + 1 < len(self.policy.ramp):
                    side.stage += 1
                    side.stage_served = 0
                    advance = True
                    fraction = self.policy.ramp[side.stage] / 100.0
                    version = side.version
                else:
                    promote = True
        if reasons:
            self.rollback(reasons)
        elif advance:
            self.telemetry.emit(
                "canary", phase="ramp", version=version,
                stable=self.engine.version, fraction=fraction,
            )
            logger.info("canary %s ramped to %.1f%%", version,
                        fraction * 100)
        elif promote:
            self._promote()

    # -- observability -----------------------------------------------------

    def state(self) -> dict:
        """The full router state ``GET /stats`` reports: stable + canary
        versions, live traffic split, swap/promote/rollback counters and
        the last rollback — what lets an operator SEE a ramp in
        progress."""
        with self._lock:
            side = self._canary
            fraction = (
                self.policy.ramp[side.stage] / 100.0 if side else 0.0
            )
            return {
                "stable": {
                    "version": self.engine.version,
                    "artifact": self.engine.artifact_dir,
                    "served": self.batcher.served,
                },
                "canary": {
                    "version": side.version,
                    "artifact": side.artifact_dir,
                    "stage": side.stage,
                    "ramp": list(self.policy.ramp),
                    "fraction": fraction,
                    "served": side.batcher.served,
                    "stage_served": side.stage_served,
                    "drops": side.drops,
                } if side else None,
                "traffic_split": {
                    "stable": 1.0 - fraction, "canary": fraction,
                },
                "swaps": self.engine.swaps,
                "promotes": self.promotes,
                "rollbacks": self.rollbacks,
                "last_rollback": self.last_rollback,
            }

    def close(self) -> None:
        """Detach from the bus and retire any in-flight canary; the
        stable batcher stays with its owner."""
        self.telemetry.unsubscribe(self._observe)
        with self._lock:
            if self._canary is not None:
                self._retire_canary()


def _deque(maxlen: int):
    import collections

    return collections.deque(maxlen=maxlen)


class RegistryWatcher:
    """Follow the registry's labels from a live server — the NFS-poll
    loop, grown up (``serve run --registry R --reload-poll S``):

    - ``stable`` label moved to a version the router is not serving (and
      no canary in flight) → direct hot-swap;
    - ``canary`` label set to a new version → start a canary ramp (the
      router clears the label again on promote/rollback, so a convicted
      canary cannot restart itself).

    Polling tolerates transient registry errors (a publish's atomic
    replace racing the read) by skipping the tick.
    """

    def __init__(self, registry, router: CanaryRouter,
                 poll_s: float = 2.0):
        self.registry = registry
        self.router = router
        self.poll_s = float(poll_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.polls = 0
        self.actions = 0

    def poll_once(self) -> Optional[str]:
        """One label diff; returns a description of the action taken
        (or None). Exposed for tests and for deterministic chaos
        driving."""
        self.polls += 1
        # the state first: the router moves the labels under the lock of
        # a promote or rollback, so labels read after the state are never
        # older than it (read before it, a promote in between would look
        # like a stable label to swap back to)
        state = self.router.state()
        try:
            labels = self.registry.labels()
        except Exception:
            logger.exception("registry watch: index unreadable; skipping")
            return None
        serving = state["stable"]["version"]
        canary = state["canary"]
        canary_v = labels.get("canary")
        stable_v = labels.get("stable")
        try:
            if canary_v and canary is None and canary_v != serving:
                self.router.start_canary(
                    self.registry.resolve(canary_v)["artifact"],
                    source="registry",
                )
                self.actions += 1
                return f"canary {canary_v}"
            if stable_v and canary is None and stable_v != serving:
                self.router.swap(
                    self.registry.resolve(stable_v)["artifact"],
                    source="registry",
                )
                self.actions += 1
                return f"swap {stable_v}"
        except Exception:
            logger.exception("registry watch: transition failed")
        return None

    def start(self) -> None:
        def _loop():
            while not self._stop.wait(self.poll_s):
                self.poll_once()

        self._thread = threading.Thread(
            target=_loop, name="pdtn-registry-watch", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.poll_s + 5.0)
