"""Continuous-batching admission queue with deadline drop: the port of
``pytorch_distributed_nn_tpu/serving/batcher.py`` (the single-pass
path, ``POST /v1/infer``).

The scheduling contract, in order:

1. Requests enqueue with a deadline (``submit(x, timeout_s)``); the caller
   blocks on ``Request.done`` (the HTTP handler) or polls it (the load
   generator).
2. One scheduler thread coalesces what is queued into the largest fitting
   bucket: it takes a batch as soon as the queue fills the largest bucket,
   or once the OLDEST queued request has waited ``batch_window_s``. It is
   the only thread that runs the engine, so the only one that launches
   work on the card. Before it takes a batch it runs the engine's
   ``warm_thread`` (every bucket once on this thread, which builds its own
   cuBLAS and cuDNN handles and convolution plans), and
   :meth:`Batcher.start` returns only after that.
3. A request whose deadline passed while queued is DROPPED, never served
   late: a typed ``request_dropped`` event, the ``serving_dropped_total``
   counter and a :class:`DeadlineExceeded` on its future.
4. Admission is BOUNDED (``max_queue``): a submit past the bound is SHED
   at the door with a (rate-limited) typed ``request_shed`` event, the
   ``serving_shed_total`` counter and a :class:`QueueShed` carrying a
   Retry-After taken from the observed service rate (HTTP 429).
   Admission is class-aware (:data:`TRAFFIC_CLASSES`): ``probe`` always
   admits, ``canary`` caps at :data:`CANARY_SHARE` of the bound; the
   ``serving_queue_depth`` and ``serving_queue_depth_peak`` gauges show
   the queue.
5. ``begin_drain()`` stops admissions with :class:`Draining` (HTTP 503)
   while queued and in-flight batches finish; ``close()`` then serves
   what is queued and rejects what could not be scheduled.

Every served request writes one ``kind="step"`` record (``latency_ms``,
``queue_ms``, ``infer_ms``, ``pad_ms``, ``batch``, ``bucket``, the
``spans`` admit / queue / batch_form / pad / infer / respond, the
``request_id``, the artifact ``version``, the trace fields, and the
request's share of the bucket's ``flops``) into the run's
``serving.jsonl``, in the JAX package's stream format, so its ``obs``
tools read a port stream.

:class:`DeadlineExceeded`, :class:`QueueShed` and :class:`Draining` are
shared with the generative scheduler and the HTTP server.
"""

from __future__ import annotations

import collections
import itertools
import logging
import threading
import time
from typing import Optional

from pytorch_distributed_nn_tpu_torch.observability import tracing
from pytorch_distributed_nn_tpu_torch.observability.core import get_telemetry

logger = logging.getLogger(__name__)

DEFAULT_TIMEOUT_S = 2.0

#: admission traffic classes: probes always admit, canary admission caps
#: at CANARY_SHARE of the bound
TRAFFIC_CLASSES = ("stable", "canary", "probe")
CANARY_SHARE = 0.5


class DeadlineExceeded(Exception):
    """The request's deadline passed before it was scheduled."""


class QueueShed(Exception):
    """The admission queue is at capacity: the request was rejected at
    the door (HTTP 429 + ``Retry-After``), never silently queued."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class Draining(Exception):
    """The scheduler is draining: new admissions are refused (HTTP 503)
    while queued and in-flight work finishes."""


class Request:
    """One in-flight inference request (the future the caller waits on)."""

    __slots__ = ("id", "request_id", "x", "enqueued", "deadline", "done",
                 "result", "error", "queue_ms", "latency_ms", "spans",
                 "version", "klass", "trace")

    def __init__(self, rid: int, x, enqueued: float, deadline: float,
                 request_id: Optional[str] = None, klass: str = "stable",
                 trace=None):
        self.id = rid
        self.request_id = request_id  # trace id; minted if None at submit
        self.klass = klass  # admission class (TRAFFIC_CLASSES)
        self.trace = trace  # tracing.TraceContext (distributed lineage)
        self.x = x
        self.enqueued = enqueued  # monotonic
        self.deadline = deadline  # monotonic
        self.done = threading.Event()
        self.result = None
        self.error: Optional[Exception] = None
        self.queue_ms = 0.0
        self.latency_ms = 0.0
        self.spans: dict = {}  # ms per lifecycle span (tracing.SPANS)
        self.version: Optional[str] = None  # weights that served it

    def wait(self, timeout: Optional[float] = None):
        """Block until served/dropped; returns the output or raises."""
        if not self.done.wait(timeout):
            raise TimeoutError(f"request {self.id} still pending")
        if self.error is not None:
            raise self.error
        return self.result


class Batcher:
    """The scheduler: admission queue -> bucket coalescing -> engine."""

    def __init__(
        self,
        engine,
        telemetry=None,
        batch_window_s: float = 0.002,
        default_timeout_s: float = DEFAULT_TIMEOUT_S,
        start: bool = True,
        max_queue: Optional[int] = None,
    ):
        self.engine = engine
        self.telemetry = telemetry if telemetry is not None else get_telemetry()
        self.batch_window_s = float(batch_window_s)
        self.default_timeout_s = float(default_timeout_s)
        if max_queue is not None and int(max_queue) < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = int(max_queue) if max_queue is not None else None
        self._q: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._ids = itertools.count()
        self._stop = False
        self._draining = False
        self.served = 0
        self.dropped = 0
        self.shed = 0
        self._canary_queued = 0
        self._depth_peak = 0
        # request_shed events are rate-limited to ~1/s (each carries the
        # `count` of sheds it covers): under a 10x overload an event PER
        # shed is an observability storm that eats the CPU the serving
        # path needs — the counter/summary stay exact via the counts
        self._shed_last_emit = -float("inf")
        self._shed_unreported = 0
        # observed service rate (requests/s, EWMA over scheduled batches):
        # the Retry-After estimate's denominator
        self._rate_ewma = 0.0
        self._last_batch_t: Optional[float] = None
        self._thread = threading.Thread(
            target=self._loop, name="pdtn-serve-scheduler", daemon=True
        )
        self._started = False
        self._warmed = threading.Event()
        self._warm_error: Optional[BaseException] = None
        if start:
            self.start()

    def start(self) -> None:
        """Start the scheduler thread; returns once it has run the
        engine's ``warm_thread`` (raising what that raised)."""
        if not self._started:
            self._started = True
            self._thread.start()
            self._warmed.wait()
            if self._warm_error is not None:
                raise self._warm_error

    @property
    def version(self) -> Optional[str]:
        """The engine's artifact version, stamped on drop and shed events
        (None for an engine without one)."""
        return getattr(self.engine, "version", None)

    # -- producer side ----------------------------------------------------

    def _set_depth_locked(self) -> None:
        """Publish the live queue depth (and its high-water mark) to the
        registry — the bound's observability (``pdtn_serving_queue_depth``
        in the Prometheus exposition). Called under ``_cv``."""
        depth = len(self._q)
        if depth > self._depth_peak:
            self._depth_peak = depth
        reg = self.telemetry.registry
        reg.gauge(
            "serving_queue_depth",
            help="live admission-queue depth (bounded by --max-queue)",
        ).set(float(depth))
        reg.gauge(
            "serving_queue_depth_peak",
            help="admission-queue high-water mark since startup",
        ).set(float(self._depth_peak))

    def retry_after_s(self) -> float:
        """Seconds a shed client should wait before retrying: current
        queue depth over the observed service rate, clamped to
        [0.1, 5.0]; 1.0 before any batch has been served."""
        with self._cv:
            return self.retry_after_s_locked()

    def retry_after_s_locked(self) -> float:
        depth = len(self._q)
        rate = self._rate_ewma
        if rate <= 0:
            return 1.0
        return round(min(5.0, max(0.1, depth / rate)), 3)

    def _shed(self, klass: str, depth: int, cap: int) -> None:
        """Reject one submit at the door: typed (rate-limited) event +
        exact counter + the QueueShed the HTTP layer maps to 429 with
        Retry-After. Called under ``_cv``."""
        self.shed += 1
        retry_after = self.retry_after_s_locked()
        self.telemetry.registry.counter(
            "serving_shed_total",
            help="requests shed by admission control (bounded queue)",
        ).inc()
        now = time.monotonic()
        self._shed_unreported += 1
        if now - self._shed_last_emit >= 1.0:
            count, self._shed_unreported = self._shed_unreported, 0
            self._shed_last_emit = now
            fields = dict(klass=klass, depth=depth,
                          max_queue=self.max_queue, cap=cap,
                          retry_after_s=retry_after, count=count)
            if self.version is not None:
                fields["version"] = self.version
            self.telemetry.emit("request_shed", **fields)
        raise QueueShed(
            f"admission queue at capacity ({depth}/{cap} for class "
            f"{klass!r}): request shed, retry after {retry_after:.1f}s",
            retry_after_s=retry_after,
        )

    def _flush_shed(self) -> None:
        """Emit the trailing rate-limited shed tally (close/drain path)
        so the stream's counts always sum to the exact shed total."""
        with self._cv:
            count, self._shed_unreported = self._shed_unreported, 0
            depth = len(self._q)
        if count:
            self.telemetry.emit(
                "request_shed", klass="stable", depth=depth,
                max_queue=self.max_queue, cap=self.max_queue,
                retry_after_s=1.0, count=count, trailing=True,
                **({"version": self.version}
                   if self.version is not None else {}),
            )

    def submit(self, x, timeout_s: Optional[float] = None,
               request_id: Optional[str] = None,
               klass: str = "stable", trace=None) -> Request:
        """Enqueue one request; returns its future. Never blocks.

        ``request_id`` is the client's trace id (validated upstream by
        the HTTP layer); one is minted when absent, so every record in
        the stream is traceable. ``trace`` is the request's distributed
        :class:`~..observability.tracing.TraceContext` (already the
        RECEIVER's child span, derived by the HTTP layer from the
        ``X-Trace-Context`` header); its ``trace``/``span``/``parent``
        stamp lands on the request's stream record so
        ``reader.assemble_trace`` can join this hop to the frontend's.
        ``klass`` is the admission class: ``stable`` sees the full
        ``max_queue`` bound, ``canary`` caps at :data:`CANARY_SHARE` of it,
        ``probe`` (health/breaker probes) always admits. Raises
        :class:`QueueShed` past the bound and :class:`Draining` after
        :meth:`begin_drain`."""
        if klass not in TRAFFIC_CLASSES:
            raise ValueError(
                f"unknown traffic class {klass!r} "
                f"(have: {', '.join(TRAFFIC_CLASSES)})"
            )
        entry = time.monotonic()
        timeout = self.default_timeout_s if timeout_s is None else timeout_s
        rid = request_id if request_id is not None \
            else tracing.new_request_id()
        req = Request(next(self._ids), x, entry, entry + timeout,
                      request_id=rid, klass=klass, trace=trace)
        with self._cv:
            if self._stop:
                raise RuntimeError("batcher is shut down")
            if self._draining:
                raise Draining(
                    "batcher is draining: admissions stopped, in-flight "
                    "work finishing"
                )
            if self.max_queue is not None and klass != "probe":
                depth = len(self._q)
                if depth >= self.max_queue:
                    self._shed(klass, depth, self.max_queue)
                if klass == "canary":
                    cap = max(1, int(self.max_queue * CANARY_SHARE))
                    if self._canary_queued >= cap:
                        self._shed(klass, self._canary_queued, cap)
            if req.klass == "canary":
                self._canary_queued += 1
            self._q.append(req)
            self._set_depth_locked()
            self._cv.notify()
        # admit: submit-call overhead (entry -> queued) — tiny by design,
        # but the span proves it stays tiny under contention
        req.spans["admit"] = round((time.monotonic() - entry) * 1000, 3)
        return req

    # -- scheduler --------------------------------------------------------

    def _take_batch(self):
        """Block until a batch is ready (continuous-batching admission:
        full bucket OR oldest-request window expiry), then pop it."""
        max_batch = self.engine.max_batch
        with self._cv:
            while True:
                if self._q:
                    if len(self._q) >= max_batch:
                        break
                    waited = time.monotonic() - self._q[0].enqueued
                    remaining = self.batch_window_s - waited
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
                elif self._stop:
                    return None
                else:
                    self._cv.wait()
            batch = [self._q.popleft()
                     for _ in range(min(len(self._q), max_batch))]
            self._canary_queued -= sum(
                1 for r in batch if r.klass == "canary"
            )
            self._set_depth_locked()
            return batch

    def _drop(self, req: Request, now: float) -> None:
        self.dropped += 1
        req.error = DeadlineExceeded(
            f"request {req.id} dropped: queued "
            f"{(now - req.enqueued) * 1000:.1f} ms, deadline was "
            f"{(req.deadline - req.enqueued) * 1000:.1f} ms"
        )
        self.telemetry.registry.counter(
            "serving_dropped_total",
            help="requests deadline-dropped by the scheduler",
        ).inc()
        fields = dict(
            request=req.id, request_id=req.request_id,
            queued_ms=round((now - req.enqueued) * 1000, 3),
            deadline_ms=round((req.deadline - req.enqueued) * 1000, 3),
        )
        if req.trace is not None:
            fields.update(req.trace.fields())
        if self.version is not None:
            fields["version"] = self.version
        self.telemetry.emit("request_dropped", **fields)
        req.done.set()

    def _update_rate(self, n: int, now: float) -> None:
        """EWMA of the service rate (requests/s) over scheduled batches —
        the Retry-After estimate's denominator."""
        if self._last_batch_t is not None:
            dt = max(now - self._last_batch_t, 1e-6)
            inst = n / dt
            self._rate_ewma = (
                inst if self._rate_ewma <= 0
                else 0.8 * self._rate_ewma + 0.2 * inst
            )
        self._last_batch_t = now

    def _warm(self) -> bool:
        """The engine's per-thread warm pass, on this thread."""
        try:
            warm = getattr(self.engine, "warm_thread", None)
            if warm is not None:
                warm()
            return True
        except BaseException as e:
            self._warm_error = e
            return False
        finally:
            self._warmed.set()

    def _loop(self) -> None:
        if not self._warm():
            return
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            now = time.monotonic()  # pop instant: ends the queue span
            self._update_rate(len(batch), now)
            live = []
            for req in batch:
                if now > req.deadline:
                    self._drop(req, now)
                else:
                    live.append(req)
            if not live:
                continue
            infer_entry = time.monotonic()
            try:
                outs, stats = self.engine.infer([r.x for r in live])
            except Exception as e:  # an engine fault fails ITS batch only
                logger.exception("engine.infer failed for a batch of %d",
                                 len(live))
                for req in live:
                    req.error = e
                    req.done.set()
                continue
            done_t = time.monotonic()
            # batch_form: pop -> engine call (deadline checks, list
            # build); pad/infer come from the engine's own stats
            batch_form_ms = round((infer_entry - now) * 1000, 3)
            # the version the engine says served this batch; engines
            # without one in their stats fall back to the batcher's
            batch_version = stats.get("version") or self.version
            finite_rows = stats.get("finite_rows")
            for idx, (req, out) in enumerate(zip(live, outs)):
                req.result = out
                req.version = batch_version
                req.queue_ms = (now - req.enqueued) * 1000
                req.latency_ms = (done_t - req.enqueued) * 1000
                req.done.set()
                self.served += 1
                req.spans.update({
                    # queue excludes the admit overhead already accounted
                    # for, so the spans tile the lifecycle without overlap
                    "queue": round(
                        max(0.0, req.queue_ms - req.spans.get("admit", 0.0)),
                        3,
                    ),
                    "batch_form": batch_form_ms,
                    "pad": stats["pad_ms"],
                    "infer": stats["infer_ms"],
                })
                # respond: result attach + future wake + record build,
                # measured per request right before its record publishes
                req.spans["respond"] = round(
                    (time.monotonic() - done_t) * 1000, 3
                )
                record = {
                    "step": req.id,
                    "request_id": req.request_id,
                    "latency_ms": round(req.latency_ms, 3),
                    "queue_ms": round(req.queue_ms, 3),
                    "infer_ms": stats["infer_ms"],
                    "pad_ms": stats["pad_ms"],
                    "batch": stats["batch"],
                    "bucket": stats["bucket"],
                    "spans": dict(req.spans),
                }
                if req.trace is not None:
                    # distributed lineage: trace/span/parent join this
                    # hop's record to the frontend's attempt span
                    record.update(req.trace.fields())
                if batch_version is not None:
                    record["version"] = batch_version
                if finite_rows is not None and not bool(finite_rows[idx]):
                    # output-quality flag (engine.infer): a row with a
                    # NaN or an infinity in its output
                    record["nonfinite"] = True
                if stats.get("flops"):
                    # this request's share of the padded bucket's device
                    # work — summing over records gives achieved FLOP/s
                    # without double-counting coalesced batches
                    record["flops"] = round(
                        stats["flops"] / stats["batch"], 1
                    )
                self.telemetry.log_step(record)

    # -- lifecycle --------------------------------------------------------

    @property
    def draining(self) -> bool:
        return self._draining

    def begin_drain(self) -> None:
        """Stop admissions (new submits raise :class:`Draining`) while
        queued and in-flight batches finish — the SIGTERM half of a
        zero-downtime drain.
        Emits one typed ``drain`` event; idempotent."""
        with self._cv:
            if self._draining:
                return
            self._draining = True
            depth = len(self._q)
        self.telemetry.emit(
            "drain", phase="start", queued=depth, served=self.served,
        )

    def drain(self, timeout: float = 30.0) -> None:
        """Wait until the queue is empty and all scheduled work finished."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._cv:
                if not self._q:
                    break
            time.sleep(0.005)
        # the last popped batch may still be in the engine; served/dropped
        # settle once its done events fire — a short settle poll bounds it
        time.sleep(0.01)

    def close(self, drain: bool = True) -> None:
        """Clean shutdown: stop admitting, serve what is queued, join."""
        self._flush_shed()
        if drain and self._started:
            self.drain()
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._started:
            self._thread.join(timeout=30.0)
        # anything still queued after the join is rejected, not lost
        while self._q:
            req = self._q.popleft()
            req.error = RuntimeError("batcher shut down before scheduling")
            req.done.set()
