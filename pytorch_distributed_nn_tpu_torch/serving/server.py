"""Generate-only HTTP front end — stdlib only.

The port of ``pytorch_distributed_nn_tpu/serving/server.py`` for
generative artifacts, on the same JSON contract:

- ``POST /v1/generate`` — body ``{"inputs": [[id, ...], ...],
  "max_new_tokens": N, "stop": [id, ...], "timeout_s": S}``. Response:
  ``{"outputs": [[id, ...], ...], "new_tokens": [...], "ttft_ms": [...],
  "latency_ms": [...], "finish": [...], "request_ids": [...],
  "versions": [...]}``. Each row rides the per-token continuous-batching
  scheduler. ``X-Request-Id`` is accepted (row *i* > 0 gets
  ``<id>.<i>``) or minted, and echoed; ``X-Trace-Context`` makes each row
  a child span of the caller's. A shed admission is 429 with
  ``Retry-After``; a deadline drop or a draining server is 503.
- ``GET /healthz`` — artifact identity + liveness.
- ``GET /readyz`` — 200 once warm and not draining, else 503.
- ``GET /stats`` — served/dropped/shed counters, retraces, the engine's
  generation state, the artifact identity and uptime.

``POST /v1/infer`` answers 400: the single-pass engine is not ported yet.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from pytorch_distributed_nn_tpu_torch.observability import tracing
from pytorch_distributed_nn_tpu_torch.serving.batcher import (
    DeadlineExceeded,
    Draining,
    QueueShed,
)

logger = logging.getLogger(__name__)


class ServingServer:
    """Owns the listening socket over one :class:`GenerateScheduler`;
    ``port=0`` binds an ephemeral port and ``self.port`` reports it."""

    def __init__(self, generator, host: str = "127.0.0.1", port: int = 8000):
        self.generator = generator
        self.engine = generator.engine
        self.started = time.time()
        # readiness: constructed after the engine's warmup, so ready
        # until a drain begins
        self.ready = True
        self.draining = False
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
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
                    self.send_header(
                        "Retry-After", str(max(1, int(round(retry_after_s))))
                    )
                self.end_headers()
                self.wfile.write(body)

            def _row_traces(self, n: int):
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

            def _discard_body(self) -> None:
                try:
                    n = int(self.headers.get("Content-Length", 0) or 0)
                    if n > 0:
                        self.rfile.read(n)
                except (ValueError, OSError):
                    pass

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
                    sched = outer.generator
                    self._reply(200, {
                        "served": sched.served,
                        "dropped": sched.dropped,
                        "shed": sched.shed,
                        "max_queue": sched.max_queue,
                        "ready": outer.ready,
                        "draining": outer.draining or sched.draining,
                        "retraces": outer.engine.retraces(),
                        "generate": outer.engine.stats(),
                        "artifact": outer.engine.identity,
                        "uptime_s": round(time.time() - outer.started, 3),
                    })
                else:
                    self._reply(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                if self.path == "/v1/infer":
                    self._discard_body()
                    self._reply(400, {
                        "error": "this server is generative-only — "
                                 "POST /v1/generate",
                    })
                    return
                if self.path != "/v1/generate":
                    self._discard_body()
                    self._reply(404, {"error": f"no route {self.path}"})
                    return
                if outer.draining:
                    self._discard_body()
                    self._reply(503, {"error": "draining", "draining": True})
                    return
                gen = outer.generator
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    doc = json.loads(self.rfile.read(n))
                    rows = doc["inputs"]
                    if not isinstance(rows, list) or not rows:
                        raise ValueError("'inputs' must be a non-empty "
                                         "list of token-id lists")
                    timeout = float(doc.get("timeout_s",
                                            gen.default_timeout_s))
                    header_rid = self.headers.get("X-Request-Id")
                    base_rid = (
                        tracing.validate_request_id(header_rid)
                        if header_rid is not None
                        else tracing.new_request_id()
                    )
                    rids = [base_rid if i == 0 else f"{base_rid}.{i}"
                            for i in range(len(rows))]
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

    def serve_forever(self) -> None:
        logger.info("serving on http://%s:%d", self.host, self.port)
        self._httpd.serve_forever()

    def begin_drain(self) -> None:
        """Stop admissions: /readyz flips 503, new POSTs get 503, the
        scheduler refuses new submits; in-flight requests finish."""
        self.draining = True
        self.generator.begin_drain()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
