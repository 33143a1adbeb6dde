"""Per-token continuous batching for the generative engine.

The PyTorch port's copy of the JAX package's scheduler of the same name:
the loop is host code and runs unchanged over the port's engine. A
decoder's unit of work is one TOKEN, so the scheduling loop here runs at
token granularity:

1. Requests enqueue with a prompt, ``max_new_tokens``, optional stop
   tokens and a deadline. A request claims a KV-cache slot in the pool
   of the smallest bucket fitting ``prompt + max_new_tokens`` (the
   largest-fitting-bucket admission policy); when every slot is live it
   waits — and is deadline-dropped, never served late, exactly like the
   single-pass queue.
2. One scheduler thread alternates admission and decode **at step
   boundaries**: each round it (a) prefetches any waiting request into a
   freed slot (prefill + cache insert + first token), (b) re-prefills
   sequences whose KV pages were fenced by a hot swap, then (c) runs ONE
   decode step per cache bucket with live sequences,
   advancing up to a batch bucket of them together. A request finishing
   mid-stream frees its slot; the very next round a queued request joins
   the running batch — continuous batching, per token.
3. Greedy (argmax) sampling: token-id in, token-ids out, deterministic —
   what lets the tests hold decode against a full recompute.

Every finished request writes ONE telemetry record through the same
``Telemetry.log_step`` routing the single-pass batcher uses (it carries
``latency_ms`` so the ``pdtn_serving_*`` family applies), extended with
the generative fields: ``prompt_tokens`` / ``new_tokens`` /
``tokens_per_s`` / ``ttft_ms`` / ``itl_ms`` (per-request inter-token
stats) / mean decode-batch occupancy, and ``prefill`` / ``decode``
spans in the trace breakdown (docs/observability.md "Request tracing").

Swap fencing: :meth:`GenerateScheduler.swap` hot-swaps the engine, which
bumps the KV epoch; this loop re-prefills every fenced sequence under
the new weights before its next decode step (generation restarts from
the prompt — deterministic sampling means a request's emitted tokens are
ALWAYS the product of exactly one weight version, the one stamped on its
record). The pool ledger enforces the fence independently
(``fence_violations`` stays 0 or the chaos gate fails).
"""

from __future__ import annotations

import collections
import itertools
import logging
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from pytorch_distributed_nn_tpu_torch.serving.batcher import (
    DeadlineExceeded,
    Draining,
    QueueShed,
)
from pytorch_distributed_nn_tpu_torch.serving.generate.engine import (
    StaleBatchEpoch,
)
from pytorch_distributed_nn_tpu_torch.serving.generate.kvcache import (
    StaleKVPage,
)

logger = logging.getLogger(__name__)

DEFAULT_GENERATE_TIMEOUT_S = 30.0


def _pctl(vals: List[float], q: float) -> float:
    import math

    vals = sorted(vals)
    if not vals:
        return float("nan")
    return vals[min(max(1, math.ceil(q / 100 * len(vals))), len(vals)) - 1]


class GenerateRequest:
    """One in-flight generation (the future the caller waits on)."""

    __slots__ = (
        "id", "request_id", "prompt", "max_new_tokens", "stop_tokens",
        "enqueued", "deadline", "done", "tokens", "error", "version",
        "finish_reason", "queue_ms", "latency_ms", "ttft_ms", "spans",
        "itl_samples", "refences", "trace",
        # scheduler-internal sequence state
        "slot", "bucket", "next_token", "next_position", "epoch",
        "prefill_ms", "decode_ms", "first_token_t", "last_token_t",
        "occ_sum", "occ_steps", "admitted_t",
    )

    def __init__(self, rid: int, prompt: np.ndarray, max_new_tokens: int,
                 stop_tokens, enqueued: float, deadline: float,
                 request_id: Optional[str], trace=None):
        self.id = rid
        self.request_id = request_id
        self.trace = trace  # tracing.TraceContext (distributed lineage)
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.stop_tokens = frozenset(int(t) for t in (stop_tokens or ()))
        self.enqueued = enqueued
        self.deadline = deadline
        self.done = threading.Event()
        self.tokens: List[int] = []
        self.error: Optional[Exception] = None
        self.version: Optional[str] = None
        self.finish_reason: Optional[str] = None
        self.queue_ms = 0.0
        self.latency_ms = 0.0
        self.ttft_ms: Optional[float] = None
        self.spans: dict = {}
        self.itl_samples: List[float] = []
        self.refences = 0
        self.slot = self.bucket = None
        self.next_token = self.next_position = None
        self.epoch = None
        self.prefill_ms = 0.0
        self.decode_ms = 0.0
        self.first_token_t = self.last_token_t = None
        self.occ_sum = 0
        self.occ_steps = 0
        self.admitted_t: Optional[float] = None

    def wait(self, timeout: Optional[float] = None) -> List[int]:
        """Block until finished/dropped; returns the generated token ids
        (stop token included when one fired) or raises."""
        if not self.done.wait(timeout):
            raise TimeoutError(f"generate request {self.id} still pending")
        if self.error is not None:
            raise self.error
        return list(self.tokens)


class GenerateScheduler:
    """Admission queue -> KV slots -> per-token continuous batching."""

    def __init__(self, engine, telemetry=None,
                 default_timeout_s: float = DEFAULT_GENERATE_TIMEOUT_S,
                 default_max_new_tokens: int = 16, start: bool = True,
                 max_queue: Optional[int] = None):
        from pytorch_distributed_nn_tpu_torch.observability.core import (
            get_telemetry,
        )

        self.engine = engine
        self.telemetry = (
            telemetry if telemetry is not None else get_telemetry()
        )
        self.default_timeout_s = float(default_timeout_s)
        self.default_max_new_tokens = int(default_max_new_tokens)
        if max_queue is not None and int(max_queue) < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = int(max_queue) if max_queue is not None else None
        self.shed = 0
        # request_shed events are rate-limited to ~1/s with a covering
        # `count` (the batcher's discipline, serving/batcher.py): under
        # sustained overload an event PER shed is an observability storm
        # that eats the CPU the decode path needs — the counter/summary
        # stay exact via the counts (trailing tally flushed at close)
        self._shed_last_emit = -float("inf")
        self._shed_unreported = 0
        # observed service rate (requests/s, EWMA over retirements):
        # the Retry-After estimate's denominator
        self._rate_ewma = 0.0
        self._last_finish_t: Optional[float] = None
        self._depth_peak = 0
        self._q: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._ids = itertools.count()
        self._stop = False
        self._draining = False
        #: per cache bucket: live sequences in admission order
        self._active: Dict[int, List[GenerateRequest]] = {
            s: [] for s in engine.seq_buckets
        }
        self.served = 0
        self.dropped = 0
        self.refenced_total = 0
        self._thread = threading.Thread(
            target=self._loop, name="pdtn-generate-scheduler", daemon=True
        )
        self._started = False
        if start:
            self.start()

    def start(self) -> None:
        if not self._started:
            self._started = True
            self._thread.start()

    @property
    def version(self) -> Optional[str]:
        return getattr(self.engine, "version", None)

    # -- producer side -----------------------------------------------------

    def submit(self, token_ids: Sequence[int],
               max_new_tokens: Optional[int] = None,
               stop_tokens: Optional[Sequence[int]] = None,
               timeout_s: Optional[float] = None,
               request_id: Optional[str] = None,
               trace=None) -> GenerateRequest:
        """Enqueue one generation; returns its future. Never blocks.

        ``trace`` is the request's distributed ``TraceContext`` (the
        receiver-side child span the HTTP layer derived from
        ``X-Trace-Context``); its stamp lands on the finished record.
        Validates against the bucket table up front so an impossible
        request fails at submit (HTTP 400), not in the scheduler."""
        from pytorch_distributed_nn_tpu_torch.observability import tracing

        entry = time.monotonic()
        prompt = np.asarray(token_ids, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        max_new = (
            self.default_max_new_tokens if max_new_tokens is None
            else int(max_new_tokens)
        )
        if max_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
        # fail-fast bucket check (select_* raise with the real limits)
        self.engine.select_prompt_bucket(int(prompt.size))
        self.engine.select_seq_bucket(int(prompt.size) + max_new)
        timeout = (
            self.default_timeout_s if timeout_s is None else float(timeout_s)
        )
        rid = request_id if request_id is not None \
            else tracing.new_request_id()
        req = GenerateRequest(next(self._ids), prompt, max_new,
                              stop_tokens, entry, entry + timeout, rid,
                              trace=trace)
        with self._cv:
            if self._stop:
                raise RuntimeError("generate scheduler is shut down")
            if self._draining:
                raise Draining(
                    "generate scheduler is draining: admissions stopped, "
                    "live sequences finishing"
                )
            depth = len(self._q)
            if self.max_queue is not None and depth >= self.max_queue:
                # bounded admission (docs/serving.md "Availability &
                # overload"): shed at the door, never silent queue growth
                self._shed(depth)
            self._q.append(req)
            depth += 1
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
            self._cv.notify()
        req.spans["admit"] = round((time.monotonic() - entry) * 1000, 3)
        return req

    def _retry_after_s_locked(self, depth: int) -> float:
        """Seconds a shed client should wait before retrying: current
        queue depth over the observed retirement-rate EWMA, clamped to
        [0.1, 5.0]; 1.0 before any request has finished. Called under
        ``_cv``."""
        rate = self._rate_ewma
        if rate <= 0:
            return 1.0
        return round(min(5.0, max(0.1, depth / rate)), 3)

    def _shed(self, depth: int) -> None:
        """Reject one submit at the door: typed (rate-limited) event +
        exact counter + the QueueShed the HTTP layer maps to 429 with
        Retry-After. Called under ``_cv``."""
        self.shed += 1
        retry_after = self._retry_after_s_locked(depth)
        self.telemetry.registry.counter(
            "serving_shed_total",
            help="requests shed by admission control (bounded queue)",
        ).inc()
        now = time.monotonic()
        self._shed_unreported += 1
        if now - self._shed_last_emit >= 1.0:
            count, self._shed_unreported = self._shed_unreported, 0
            self._shed_last_emit = now
            self.telemetry.emit(
                "request_shed", klass="stable", depth=depth,
                max_queue=self.max_queue, cap=self.max_queue,
                retry_after_s=retry_after, generative=True, count=count,
                **({"version": self.version}
                   if self.version is not None else {}),
            )
        raise QueueShed(
            f"generate admission queue at capacity "
            f"({depth}/{self.max_queue}): request shed, retry after "
            f"{retry_after:.1f}s",
            retry_after_s=retry_after,
        )

    def _flush_shed(self) -> None:
        """Emit the trailing rate-limited shed tally (close/drain path)
        so the stream's counts always sum to the exact shed total."""
        with self._cv:
            count, self._shed_unreported = self._shed_unreported, 0
            depth = len(self._q)
            retry_after = self._retry_after_s_locked(depth)
        if count:
            self.telemetry.emit(
                "request_shed", klass="stable", depth=depth,
                max_queue=self.max_queue, cap=self.max_queue,
                retry_after_s=retry_after, generative=True, count=count,
                trailing=True,
                **({"version": self.version}
                   if self.version is not None else {}),
            )

    # -- drain (zero-downtime SIGTERM half) --------------------------------

    @property
    def draining(self) -> bool:
        return self._draining

    def begin_drain(self) -> None:
        """Stop admissions (new submits raise :class:`Draining`) while
        queued and live sequences finish; one typed ``drain`` event."""
        with self._cv:
            if self._draining:
                return
            self._draining = True
            depth = len(self._q)
        # the stream's shed counts must sum to the exact total before
        # the drain event lands (nothing sheds after admissions stop)
        self._flush_shed()
        self.telemetry.emit(
            "drain", phase="start", queued=depth, served=self.served,
            generative=True,
        )

    # -- lifecycle transitions (fleet wiring) ------------------------------

    def swap(self, artifact_dir: str, source: str = "api") -> str:
        """Hot-swap the engine's weights under live generation. The KV
        epoch fence makes every live sequence re-prefill under the new
        weights before its next token; emits one typed ``swap`` event."""
        old = self.engine.version
        new = self.engine.swap(artifact_dir)
        self.telemetry.emit(
            "swap", from_version=old, version=new, source=source,
            swaps=self.engine.swaps, generative=True,
        )
        with self._cv:
            self._cv.notify()
        return new

    # -- scheduler loop ----------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._cv:
                while (not self._stop and not self._q
                       and not any(self._active.values())):
                    self._cv.wait()
                if self._stop and not self._q \
                        and not any(self._active.values()):
                    return
            try:
                self._admit_round()
                epoch = self._refence_round()
                self._decode_round(epoch)
            except Exception as e:
                # a scheduler crash must fail loudly per-request, never
                # silently hang every future
                logger.exception("generate scheduler round failed")
                self._fail_all(
                    RuntimeError(f"generate scheduler crashed: {e!r}")
                )
                return

    def _fail_all(self, err: Exception) -> None:
        with self._cv:
            pending = list(self._q)
            self._q.clear()
        for bucket, seqs in self._active.items():
            for req in seqs:
                self.engine.pools[bucket].free(req.slot)
                self._finish(req, error=err)
            seqs.clear()
        for req in pending:
            req.error = err
            req.done.set()

    # admission: prefill waiting requests into free slots --------------------

    def _admit_round(self) -> None:
        from pytorch_distributed_nn_tpu_torch.serving.generate.kvcache import (
            PoolExhausted,
        )

        while True:
            with self._cv:
                if not self._q:
                    return
                req = self._q[0]
                now = time.monotonic()
                if now > req.deadline:
                    self._q.popleft()
                    self._drop(req, now)
                    continue
                bucket = self.engine.select_seq_bucket(
                    int(req.prompt.size) + req.max_new_tokens
                )
                if self.engine.pools[bucket].free_slots == 0:
                    # head-of-line full: try the next queued request
                    # whose bucket HAS room (mixed-length traffic must
                    # not convoy behind one exhausted pool)
                    req = None
                    for cand in list(self._q)[1:]:
                        b = self.engine.select_seq_bucket(
                            int(cand.prompt.size) + cand.max_new_tokens
                        )
                        if self.engine.pools[b].free_slots > 0:
                            req, bucket = cand, b
                            break
                    if req is None:
                        return
                    self._q.remove(req)
                else:
                    self._q.popleft()
            try:
                slot = self.engine.pools[bucket].alloc(
                    self.engine.epoch, owner=req.request_id
                )
            except PoolExhausted:  # raced a concurrent alloc; requeue
                with self._cv:
                    self._q.appendleft(req)
                return
            try:
                self._prefill_into(req, bucket, slot)
            except Exception as e:
                self.engine.pools[bucket].free(slot)
                self._finish(req, error=e)

    def _prefill_into(self, req: GenerateRequest, bucket: int,
                      slot: int) -> None:
        """Prefill (or RE-prefill after a fence) ``req`` into its slot:
        prompt forward, cache insert, first token."""
        t_start = time.monotonic()
        logits, kvs, stats = self.engine.prefill(req.prompt)
        self.engine.insert(bucket, slot, kvs)
        self.engine.pools[bucket].rebind(slot, stats["epoch"])
        now = time.monotonic()
        first = req.admitted_t is None
        if first:
            req.admitted_t = t_start
            req.queue_ms = (t_start - req.enqueued) * 1000
            req.slot, req.bucket = slot, bucket
            self._active[bucket].append(req)
        req.epoch = stats["epoch"]
        req.version = stats["version"]
        req.prefill_ms += (now - t_start) * 1000
        # generation (re)starts from the prompt: deterministic sampling
        # means the emitted tokens are the product of ONE weight version
        req.tokens = []
        req.itl_samples = []
        tok = int(np.argmax(logits))
        req.tokens.append(tok)
        req.first_token_t = req.first_token_t or now
        req.last_token_t = now
        if req.ttft_ms is None:
            req.ttft_ms = (now - req.enqueued) * 1000
        req.next_token = tok
        req.next_position = int(req.prompt.size)
        if self._check_finished(req):
            self._retire(req)

    # swap fencing: re-prefill stale sequences -------------------------------

    def _refence_round(self) -> int:
        """Re-prefill every fenced sequence; returns the epoch this
        round validated against, which the decode round echoes back to
        the engine so a swap landing after it is told apart from a
        genuinely stale batch."""
        epoch = self.engine.epoch
        for bucket, seqs in self._active.items():
            stale = set(self.engine.pools[bucket].stale_slots(epoch))
            if not stale:
                continue
            for req in list(seqs):
                if req.slot in stale:
                    req.refences += 1
                    self.refenced_total += 1
                    try:
                        self._prefill_into(req, bucket, req.slot)
                    except Exception as e:
                        seqs.remove(req)
                        self.engine.pools[bucket].free(req.slot)
                        self._finish(req, error=e)
        return epoch

    # decode: one step per bucket with live sequences ------------------------

    def _decode_round(self, epoch: int) -> None:
        for bucket, seqs in self._active.items():
            if not seqs:
                continue
            batch = seqs[: self.engine.batch_buckets[-1]]
            try:
                logits, stats = self.engine.decode(
                    bucket,
                    [r.slot for r in batch],
                    [r.next_token for r in batch],
                    [r.next_position for r in batch],
                    expected_epoch=epoch,
                )
            except (StaleBatchEpoch, StaleKVPage):
                # swap landed between the fence round and this step: the
                # ledger refused the stale pages — re-prefill next round.
                # Any other error (a kernel that fails to launch) reaches
                # _loop, which fails every request loudly
                logger.info(
                    "decode fenced mid-round (bucket %d); re-prefilling",
                    bucket,
                )
                continue
            now = time.monotonic()
            dms = stats["decode_ms"]
            for i, req in enumerate(batch):
                req.decode_ms += dms
                req.occ_sum += stats["batch"]
                req.occ_steps += 1
                tok = int(np.argmax(logits[i]))
                req.tokens.append(tok)
                req.itl_samples.append((now - req.last_token_t) * 1000)
                req.last_token_t = now
                req.next_token = tok
                req.next_position += 1
                if self._check_finished(req):
                    self._retire(req)

    def _check_finished(self, req: GenerateRequest) -> bool:
        if req.tokens and req.tokens[-1] in req.stop_tokens:
            req.finish_reason = "stop"
            return True
        if len(req.tokens) >= req.max_new_tokens:
            req.finish_reason = "length"
            return True
        return False

    # completion -------------------------------------------------------------

    def _retire(self, req: GenerateRequest) -> None:
        """Free the slot (the join point for the next queued request)
        and publish the request's record."""
        self._active[req.bucket].remove(req)
        self.engine.pools[req.bucket].free(req.slot)
        self._finish(req)

    def _finish(self, req: GenerateRequest,
                error: Optional[Exception] = None) -> None:
        done_t = time.monotonic()
        req.latency_ms = (done_t - req.enqueued) * 1000
        if error is not None:
            req.error = error
            req.done.set()
            return
        req.done.set()
        self.served += 1
        # EWMA of the retirement rate (requests/s) — the Retry-After
        # estimate's denominator (the batcher's _update_rate twin)
        with self._cv:
            if self._last_finish_t is not None:
                dt = max(done_t - self._last_finish_t, 1e-6)
                inst = 1.0 / dt
                self._rate_ewma = (
                    inst if self._rate_ewma <= 0
                    else 0.8 * self._rate_ewma + 0.2 * inst
                )
            self._last_finish_t = done_t
        req.spans.update({
            "queue": round(
                max(0.0, req.queue_ms - req.spans.get("admit", 0.0)), 3
            ),
            "prefill": round(req.prefill_ms, 3),
            "decode": round(req.decode_ms, 3),
        })
        req.spans["respond"] = round(
            (time.monotonic() - done_t) * 1000, 3
        )
        n = len(req.tokens)
        gen_wall_s = max(
            (req.last_token_t or done_t) - (req.admitted_t or done_t),
            1e-9,
        )
        itl = req.itl_samples
        record = {
            "step": req.id,
            "request_id": req.request_id,
            "latency_ms": round(req.latency_ms, 3),
            "queue_ms": round(req.queue_ms, 3),
            "infer_ms": round(req.prefill_ms + req.decode_ms, 3),
            "prompt_tokens": int(req.prompt.size),
            "new_tokens": n,
            "tokens_per_s": round(n / gen_wall_s, 3),
            "ttft_ms": round(req.ttft_ms, 3)
            if req.ttft_ms is not None else None,
            "itl_ms": {
                "mean": round(sum(itl) / len(itl), 3),
                "p50": round(_pctl(itl, 50), 3),
                "p99": round(_pctl(itl, 99), 3),
                "max": round(max(itl), 3),
            } if itl else None,
            "batch": (
                round(req.occ_sum / req.occ_steps, 2)
                if req.occ_steps else 1
            ),
            "seq_bucket": req.bucket,
            "finish": req.finish_reason,
            "spans": dict(req.spans),
        }
        if req.trace is not None:
            # distributed lineage: trace/span/parent join this hop's
            # record to the caller's attempt span
            record.update(req.trace.fields())
        if req.refences:
            record["refences"] = req.refences
        if req.version is not None:
            record["version"] = req.version
        self.telemetry.log_step(record)

    def _drop(self, req: GenerateRequest, now: float) -> None:
        self.dropped += 1
        req.error = DeadlineExceeded(
            f"generate request {req.id} dropped: queued "
            f"{(now - req.enqueued) * 1000:.1f} ms waiting for a KV "
            f"slot, deadline was "
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
            generative=True,
        )
        if req.trace is not None:
            fields.update(req.trace.fields())
        if self.version is not None:
            fields["version"] = self.version
        self.telemetry.emit("request_dropped", **fields)
        req.done.set()

    # -- lifecycle ---------------------------------------------------------

    def drain(self, timeout: float = 60.0) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._cv:
                idle = not self._q and not any(self._active.values())
            if idle:
                break
            time.sleep(0.005)

    def close(self, drain: bool = True) -> None:
        self._flush_shed()
        if drain and self._started:
            self.drain()
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._started:
            self._thread.join(timeout=60.0)
        while self._q:
            req = self._q.popleft()
            req.error = RuntimeError(
                "generate scheduler shut down before scheduling"
            )
            req.done.set()
