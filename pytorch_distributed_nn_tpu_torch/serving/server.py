"""HTTP front end over the batcher and the generative scheduler — stdlib
only.

The port of ``pytorch_distributed_nn_tpu/serving/server.py``, on the same
JSON contract. ``ThreadingHTTPServer`` gives one thread per connection;
each handler submits its rows to the shared batcher (or scheduler) and
blocks on the futures, so concurrent connections coalesce into the same
device batches. Only the scheduler threads run the engines.

- ``POST /v1/infer`` — body ``{"inputs": [<row>, ...], "timeout_s": S}``,
  a row being a nested float list of exactly the artifact's input spec
  (image) or a flat list of 1 to ``max_len`` token ids in [0, vocab)
  (tokens); any other row makes the whole body a 400. Response:
  ``{"outputs": [...], "top1": [...], "latency_ms": [...], "queue_ms":
  [...], "infer_ms": [...], "request_ids": [...], "versions": [...]}``.
  Needs a batcher.
- ``POST /v1/generate`` — body ``{"inputs": [[id, ...], ...],
  "max_new_tokens": N, "stop": [id, ...], "timeout_s": S}``. Response:
  ``{"outputs": [[id, ...], ...], "new_tokens": [...], "ttft_ms": [...],
  "latency_ms": [...], "finish": [...], "request_ids": [...],
  "versions": [...]}``; each row rides the per-token continuous-batching
  scheduler. Needs a generator.
- Both: ``X-Request-Id`` is accepted (row *i* > 0 gets ``<id>.<i>``) or
  minted, and echoed; ``X-Trace-Context`` makes each row a child span of
  the caller's. A bad body is 400, a shed admission 429 with
  ``Retry-After``, a deadline drop or a draining server 503.
- ``GET /healthz`` — artifact identity + liveness (a draining process is
  still alive).
- ``GET /readyz`` — 200 once warm and not draining, else 503.
- ``GET /stats`` — served/dropped/shed counters, the queue bound,
  readiness and drain state, retraces, the engine's batches and
  precision, the generative engine's state, the artifact identity and
  uptime.

Injected faults (``faults``: a :class:`~.faultinject.ServingFaultInjector`,
``serve run --faults``) act on ``POST /v1/infer`` and ``/v1/generate``
before a body is read: ``conn_reset`` closes the connection with no
status line, ``http_503`` answers 503. Admin swap, canaries and SLOs
wait for ROADMAP Queue 1 item 6.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from pytorch_distributed_nn_tpu_torch.observability import tracing
from pytorch_distributed_nn_tpu_torch.serving.batcher import (
    DeadlineExceeded,
    Draining,
    QueueShed,
)

logger = logging.getLogger(__name__)


class ServingServer:
    """Owns the listening socket over an infer ``batcher`` (a
    :class:`~.batcher.Batcher`), a ``generator`` (a
    :class:`~.generate.GenerateScheduler`), or both, as the JAX
    ``ServingServer(engine, batcher, ..., generator=)``; ``engine`` is the
    one ``/healthz`` and ``/stats`` report. ``port=0`` binds an ephemeral
    port and ``self.port`` reports it."""

    def __init__(self, engine, batcher, host: str = "127.0.0.1",
                 port: int = 8000, generator=None, faults=None):
        if batcher is None and generator is None:
            raise ValueError("a server needs a batcher, a generator or both")
        self.engine = engine
        self.batcher = batcher
        self.generator = generator
        # serving fault injector (serving/faultinject.py): HTTP-layer hooks
        self.faults = faults
        self.started = time.time()
        # readiness: constructed after the engines' warmup, so ready
        # until a drain begins (liveness never flips)
        self.ready = True
        self.draining = False
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # keep-alive: every reply carries Content-Length
            protocol_version = "HTTP/1.1"
            # a reply is two small writes; Nagle would hold the second
            # behind the peer's delayed ACK
            disable_nagle_algorithm = True

            def log_message(self, fmt, *args):
                logger.debug("http: " + fmt, *args)

            def _reply(self, code: int, payload: dict,
                       request_id: Optional[str] = None,
                       retry_after_s: Optional[float] = None):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                if request_id is not None:
                    self.send_header("X-Request-Id", request_id)
                if retry_after_s is not None:
                    # integer seconds, never 0
                    self.send_header(
                        "Retry-After", str(max(1, int(round(retry_after_s))))
                    )
                self.end_headers()
                self.wfile.write(body)

            def _row_traces(self, n: int):
                """One TraceContext per body row: children of the
                caller's ``X-Trace-Context``, else fresh roots. Garbage
                raises ValueError (400)."""
                h = self.headers.get(tracing.TRACE_HEADER)
                if h is not None:
                    base = tracing.TraceContext.from_header(h)
                    return [base.child() for _ in range(n)]
                base = tracing.new_trace_context()
                return [
                    base if i == 0 else tracing.TraceContext(
                        base.trace_id, tracing.new_span_id()
                    )
                    for i in range(n)
                ]

            def _request_ids(self, n: int):
                header_rid = self.headers.get("X-Request-Id")
                base = (tracing.validate_request_id(header_rid)
                        if header_rid is not None
                        else tracing.new_request_id())
                return base, [base if i == 0 else f"{base}.{i}"
                              for i in range(n)]

            def _discard_body(self) -> None:
                """Read and drop the body before an early reply: closing
                with unread data resets the connection."""
                try:
                    n = int(self.headers.get("Content-Length", 0) or 0)
                    if n > 0:
                        self.rfile.read(n)
                except (ValueError, OSError):
                    pass

            def _read_rows(self):
                n = int(self.headers.get("Content-Length", 0))
                doc = json.loads(self.rfile.read(n))
                rows = doc["inputs"]
                if not isinstance(rows, list) or not rows:
                    raise ValueError("'inputs' must be a non-empty list")
                return doc, rows

            def do_GET(self):
                if self.path == "/healthz":
                    m = outer.engine.manifest
                    self._reply(200, {
                        "status": "ok",
                        "network": m["network"],
                        "source_step": (m.get("source") or {}).get("step"),
                        "quantize": m.get("quantize", "none"),
                    })
                elif self.path == "/readyz":
                    if outer.ready and not outer.draining:
                        self._reply(200, {"status": "ready"})
                    else:
                        self._reply(503, {
                            "status": "draining" if outer.draining
                            else "warming",
                            "draining": outer.draining,
                        })
                elif self.path == "/stats":
                    sched = outer.batcher or outer.generator
                    self._reply(200, {
                        "served": sched.served,
                        "dropped": sched.dropped,
                        "shed": sched.shed,
                        "max_queue": sched.max_queue,
                        "ready": outer.ready,
                        "draining": outer.draining or sched.draining,
                        "retraces": outer.engine.retraces(),
                        "infer_batches": getattr(outer.engine,
                                                 "infer_batches", None),
                        "precision": getattr(outer.engine, "precision",
                                             None),
                        "generate": (outer.generator.engine.stats()
                                     if outer.generator is not None
                                     else None),
                        "artifact": outer.engine.identity,
                        "uptime_s": round(time.time() - outer.started, 3),
                    })
                else:
                    self._reply(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                with outer._inflight_lock:
                    outer._inflight += 1
                try:
                    if self.path == "/v1/infer":
                        self._do_infer()
                    elif self.path == "/v1/generate":
                        self._do_generate()
                    else:
                        self._discard_body()
                        self._reply(404, {"error": f"no route {self.path}"})
                finally:
                    with outer._inflight_lock:
                        outer._inflight -= 1

            def _injected_fault(self) -> bool:
                """Fire an HTTP-layer fault covering this request; True
                when the fault consumed it."""
                if outer.faults is None:
                    return False
                action = outer.faults.http_action()
                if action == "conn_reset":
                    # no status line, no body: the client sees the
                    # connection reset or an empty response
                    self.close_connection = True
                    try:
                        self.connection.close()
                    except OSError:
                        pass
                    return True
                if action == "http_503":
                    self._discard_body()
                    self._reply(503, {"error": "injected http_503 fault"})
                    return True
                return False

            def _refuse(self, needed) -> bool:
                """An early reply when this server lacks the path's
                scheduler, an injected fault takes the request, or the
                server is draining."""
                if needed is None:
                    self._discard_body()
                    self._reply(400, {"error": (
                        "this server is generative-only — POST /v1/generate"
                        if self.path == "/v1/infer" else
                        "this server has no generative engine (the "
                        "artifact is single-pass — POST /v1/infer)")})
                    return True
                if self._injected_fault():
                    return True
                if outer.draining:
                    self._discard_body()
                    self._reply(503, {"error": "draining", "draining": True})
                    return True
                return False

            def _do_infer(self):
                batcher = outer.batcher
                if self._refuse(batcher):
                    return
                try:
                    doc, rows = self._read_rows()
                    timeout = float(doc.get("timeout_s",
                                            batcher.default_timeout_s))
                    # every row checked before any is queued: a bad row
                    # is this request's 400, not its batch's failure
                    xs = [batcher.engine.check_input(row) for row in rows]
                    base_rid, rids = self._request_ids(len(xs))
                    traces = self._row_traces(len(xs))
                    klass = str(self.headers.get("X-Traffic-Class",
                                                 "stable")).strip().lower()
                except (KeyError, TypeError, ValueError) as e:
                    self._reply(400, {"error": f"bad request: {e}"})
                    return
                try:
                    reqs = [batcher.submit(x, timeout_s=timeout,
                                           request_id=rid, klass=klass,
                                           trace=tc)
                            for x, rid, tc in zip(xs, rids, traces)]
                except QueueShed as e:
                    self._reply(429, {"error": str(e),
                                      "retry_after_s": e.retry_after_s},
                                request_id=base_rid,
                                retry_after_s=e.retry_after_s)
                    return
                except Draining as e:
                    self._reply(503, {"error": str(e), "draining": True},
                                request_id=base_rid)
                    return
                except ValueError as e:  # an unknown traffic class
                    self._reply(400, {"error": f"bad request: {e}"})
                    return
                try:
                    outputs = [req.wait(timeout=timeout + 5.0)
                               for req in reqs]
                except DeadlineExceeded as e:
                    self._reply(503, {"error": str(e)}, request_id=base_rid)
                    return
                except Exception as e:
                    self._reply(500, {"error": repr(e)}, request_id=base_rid)
                    return
                self._reply(200, {
                    "outputs": [np.asarray(o).tolist() for o in outputs],
                    "top1": [int(np.argmax(o)) for o in outputs],
                    "latency_ms": [round(r.latency_ms, 3) for r in reqs],
                    "queue_ms": [round(r.queue_ms, 3) for r in reqs],
                    "infer_ms": [r.spans.get("infer") for r in reqs],
                    "request_ids": rids,
                    # the weights that served each row
                    "versions": [r.version for r in reqs],
                }, request_id=base_rid)

            def _do_generate(self):
                gen = outer.generator
                if self._refuse(gen):
                    return
                try:
                    doc, rows = self._read_rows()
                    timeout = float(doc.get("timeout_s",
                                            gen.default_timeout_s))
                    base_rid, rids = self._request_ids(len(rows))
                    traces = self._row_traces(len(rows))
                    reqs = [
                        gen.submit(row,
                                   max_new_tokens=doc.get("max_new_tokens"),
                                   stop_tokens=doc.get("stop") or (),
                                   timeout_s=timeout, request_id=rid,
                                   trace=tc)
                        for row, rid, tc in zip(rows, rids, traces)
                    ]
                except QueueShed as e:
                    self._reply(429, {"error": str(e),
                                      "retry_after_s": e.retry_after_s},
                                retry_after_s=e.retry_after_s)
                    return
                except Draining as e:
                    self._reply(503, {"error": str(e), "draining": True})
                    return
                except (KeyError, TypeError, ValueError) as e:
                    self._reply(400, {"error": f"bad request: {e}"})
                    return
                try:
                    outputs = [req.wait(timeout=timeout + 30.0)
                               for req in reqs]
                except DeadlineExceeded as e:
                    self._reply(503, {"error": str(e)}, request_id=base_rid)
                    return
                except Exception as e:
                    self._reply(500, {"error": repr(e)}, request_id=base_rid)
                    return
                self._reply(200, {
                    "outputs": [[int(t) for t in out] for out in outputs],
                    "new_tokens": [len(out) for out in outputs],
                    "ttft_ms": [req.ttft_ms for req in reqs],
                    "latency_ms": [round(req.latency_ms, 3) for req in reqs],
                    "finish": [req.finish_reason for req in reqs],
                    "request_ids": rids,
                    "versions": [req.version for req in reqs],
                }, request_id=base_rid)

        class _Server(ThreadingHTTPServer):
            request_queue_size = 128
            daemon_threads = True

        self._httpd = _Server((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        """Serve on a background thread."""
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="pdtn-serve-http",
            daemon=True,
        )
        self._thread.start()
        logger.info("serving on http://%s:%d", self.host, self.port)

    @property
    def inflight(self) -> int:
        """POST handlers running now (the drain barrier)."""
        with self._inflight_lock:
            return self._inflight

    def begin_drain(self) -> None:
        """Stop admissions: /readyz flips 503, new POSTs get 503, the
        schedulers refuse new submits; in-flight requests finish."""
        self.draining = True
        for sched in (self.batcher, self.generator):
            if sched is not None:
                sched.begin_drain()

    def drain_and_close(self, timeout: float = 30.0) -> bool:
        """The SIGTERM path: stop admissions, wait for every in-flight
        handler, then close the listener. True when the drain finished
        inside ``timeout``."""
        self.begin_drain()
        deadline = time.monotonic() + timeout
        while self.inflight and time.monotonic() < deadline:
            time.sleep(0.01)
        clean = self.inflight == 0
        if not clean:
            logger.warning("drain timed out with %d request(s) in flight",
                           self.inflight)
        self.close()
        return clean

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
