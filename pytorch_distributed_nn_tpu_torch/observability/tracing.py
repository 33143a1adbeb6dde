"""Request identity for the serving tier: request ids and distributed
trace contexts.

- every request carries a **request id**, accepted from the client via
  the ``X-Request-Id`` HTTP header (and echoed back) or minted here
  (:func:`new_request_id`);
- every request carries a :class:`TraceContext`, parsed from the
  ``X-Trace-Context`` header (a W3C-traceparent-shaped value) or minted
  as a root, whose ``fields()`` stamp the request's stream record so
  the JAX package's ``obs trace`` joins it to its caller's spans;
- the batcher and the generative scheduler stamp each record with a
  ``spans`` breakdown in the order of :data:`SPANS` and
  :data:`GENERATE_SPANS`.

The part of the JAX package's module of the same name that the port's
server and scheduler use, kept as the port's own copy; the stream
format is the same, so the JAX package's ``obs`` tools render a port
stream.
"""

from __future__ import annotations

import re
import uuid
from typing import Optional

#: the single-pass request's span catalogue, in lifecycle order
#: (serving/batcher.py): the spans tile the request's latency
SPANS = ("admit", "queue", "batch_form", "pad", "infer", "respond")

#: the generative request's span catalogue, in lifecycle order
#: (serving/generate/scheduler.py): prefill covers prompt forward +
#: cache insert + first token, decode the per-token continuous-batching
#: steps
GENERATE_SPANS = ("admit", "queue", "prefill", "decode", "respond")

#: accepted request-id shape (the X-Request-Id header is client input):
#: bounded length, URL/log-safe characters only
_REQUEST_ID_RE = re.compile(r"^[A-Za-z0-9._:\-]{1,128}\Z")

#: the cross-process trace-context carrier (docs/observability.md
#: "Distributed tracing"): a W3C-traceparent-shaped header —
#: ``00-<32 hex trace id>-<16 hex span id>-<2 hex flags>`` — minted at
#: the frontend door (or honored from the client) and re-derived as a
#: child span at every hop, next to the existing ``X-Request-Id``
TRACE_HEADER = "X-Trace-Context"

_TRACE_CONTEXT_RE = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})\Z"
)


def new_request_id() -> str:
    """Mint a request id (128-bit uuid, 16 hex chars — short enough to
    read in a log line, long enough to never collide in a stream)."""
    return uuid.uuid4().hex[:16]


def validate_request_id(rid: str) -> str:
    """Accept a client-supplied id or raise ``ValueError`` — the HTTP
    layer turns that into a 400, never into a poisoned stream record."""
    rid = str(rid)
    if not _REQUEST_ID_RE.match(rid):
        raise ValueError(
            f"bad request id {rid[:140]!r}: expected 1-128 chars of "
            "[A-Za-z0-9._:-]"
        )
    return rid


def new_span_id() -> str:
    """Mint a span id (64 bits of uuid — 16 hex chars, the traceparent
    span width)."""
    return uuid.uuid4().hex[:16]


class TraceContext:
    """One hop's identity in a distributed trace: the shared trace id,
    this hop's span id, and the parent span that caused it (``None`` at
    the root — the door mint). Immutable by convention; ``child()`` is
    how the context crosses a process or attempt boundary."""

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str] = None):
        self.trace_id = str(trace_id)
        self.span_id = str(span_id)
        self.parent_id = None if parent_id is None else str(parent_id)

    @classmethod
    def from_header(cls, value: str) -> "TraceContext":
        """Parse an ``X-Trace-Context`` header or raise ``ValueError``
        — the HTTP layer turns that into a 400 (client input must never
        poison a stream record). The parsed span is the CALLER's: the
        receiver derives its own via :meth:`child`."""
        m = _TRACE_CONTEXT_RE.match(str(value).strip().lower())
        if not m:
            raise ValueError(
                f"bad trace context {str(value)[:96]!r}: expected "
                "00-<32 hex trace>-<16 hex span>-<2 hex flags>"
            )
        return cls(m.group(1), m.group(2))

    def child(self) -> "TraceContext":
        """A fresh span under this one, same trace — one per forward
        attempt, per HTTP hop, per fleet trial."""
        return TraceContext(self.trace_id, new_span_id(),
                            parent_id=self.span_id)

    def fields(self) -> dict:
        """The record stamp: ``trace``/``span`` (+ ``parent`` when not
        the root) — what every stream record carries so
        ``reader.assemble_trace`` can join streams into one tree."""
        out = {"trace": self.trace_id, "span": self.span_id}
        if self.parent_id is not None:
            out["parent"] = self.parent_id
        return out


def new_trace_context() -> TraceContext:
    """Mint a root context (a request that came without an
    ``X-Trace-Context`` header)."""
    return TraceContext(uuid.uuid4().hex, new_span_id())
