"""Request-lifecycle tracing for the serving tier.

The port's copy of ``pytorch_distributed_nn_tpu/observability/tracing.py``:
the same span catalogue, headers and renderers.

A flat ``latency_ms`` answers "how slow"; it cannot answer "*where* did
the time go" — queued behind a full bucket? padded into a cold shape?
stuck on the device? This module defines the serving request's span
catalogue and the tooling that renders it, so every served request is a
one-line distributed trace:

- every request carries a **request id** — accepted from the client via
  the ``X-Request-Id`` HTTP header (and echoed back) or minted by the
  scheduler (:func:`new_request_id`);
- the scheduler (``serving/batcher.py``) stamps each request record with
  a ``spans`` breakdown covering the whole lifecycle, in wall order::

      admit       submit() overhead: entry -> queued (lock + append)
      queue       queued -> popped into a coalesced batch
      batch_form  popped -> engine call (deadline checks, list build)
      pad         engine: staging-buffer fill + device_put of the padded
                  bucket
      infer       engine: the pre-traced executable's wall time
      respond     result attach + future wake + record build

  ``latency_ms`` stays what it always was (enqueue -> result, the
  client-visible number); the spans bracket it on both sides (admit
  precedes the enqueue stamp, respond follows the result stamp), so
  ``sum(spans) >= latency_ms`` by roughly admit+respond.
- records also carry the serving artifact's identity (``version``) so a
  mixed-version stream — the canary case — splits cleanly
  (``reader.summarize_by_version``, ``obs compare --by-version``).

``obs trace <run> <request_id>`` renders the waterfall
(:func:`render_trace`); ``obs summary`` renders the slowest-requests
table with per-span attribution. Streams predating the spans field
(schema v1) simply skip both — the absent-family contract.

Deliberately torch-free, like every ``obs`` backend.
"""

from __future__ import annotations

import re
import uuid
from typing import Dict, List, Optional

#: the single-pass span catalogue, in lifecycle order
#: (docs/observability.md "Request tracing"). Renderers keep this
#: order; unknown extra spans in a record are appended after, so the
#: schema can grow.
SPANS = ("admit", "queue", "batch_form", "pad", "infer", "respond")

#: the generative request's catalogue (serving/generate/scheduler.py):
#: prefill covers prompt forward + cache insert + first token, decode
#: the per-token continuous-batching steps
GENERATE_SPANS = ("admit", "queue", "prefill", "decode", "respond")

#: merged lifecycle order for rendering either record shape — a
#: generative record's prefill/decode land in wall order, not appended
#: after respond like unknown spans would be
SPAN_ORDER = (
    "admit", "queue", "prefill", "batch_form", "pad", "infer",
    "decode", "respond",
)

#: accepted request-id shape (the X-Request-Id header is client input):
#: bounded length, URL/log-safe characters only
_REQUEST_ID_RE = re.compile(r"^[A-Za-z0-9._:\-]{1,128}\Z")

#: the cross-process trace-context carrier (docs/observability.md
#: "Distributed tracing"): a W3C-traceparent-shaped header —
#: ``00-<32 hex trace id>-<16 hex span id>-<2 hex flags>`` — minted at
#: the frontend door (or honored from the client) and re-derived as a
#: child span at every hop, next to the existing ``X-Request-Id``
TRACE_HEADER = "X-Trace-Context"

#: env relay for process trees that are not HTTP hops (sweep
#: orchestrator -> fleet agent -> trial): holds one header value; the
#: child process's ``run_manifest`` derives its own span from it
TRACE_ENV = "PDTN_TRACE_CONTEXT"

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

    def header(self) -> str:
        """This context as the propagation header value (flags fixed at
        01 = sampled; every trace here is sampled)."""
        return f"00-{self.trace_id}-{self.span_id}-01"

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

    def __repr__(self) -> str:
        return (f"TraceContext(trace={self.trace_id[:8]}…, "
                f"span={self.span_id}, parent={self.parent_id})")

    def __eq__(self, other) -> bool:
        return (isinstance(other, TraceContext)
                and self.trace_id == other.trace_id
                and self.span_id == other.span_id
                and self.parent_id == other.parent_id)


def new_trace_context() -> TraceContext:
    """Mint a root context — the frontend door (no client header) or a
    sweep orchestrator starting a fresh lineage."""
    return TraceContext(uuid.uuid4().hex, new_span_id())


def span_items(rec: dict) -> List[tuple]:
    """``[(span, ms), ...]`` of one request record, catalogue order
    first, unknown spans after; ``[]`` when the record predates spans."""
    spans = rec.get("spans")
    if not isinstance(spans, dict):
        return []
    out = [
        (name, float(spans[name])) for name in SPAN_ORDER if name in spans
    ]
    out += [
        (name, float(v)) for name, v in spans.items()
        if name not in SPAN_ORDER
    ]
    return out


def dominant_span(rec: dict) -> Optional[str]:
    """The span a slow request actually spent its time in."""
    items = span_items(rec)
    if not items:
        return None
    return max(items, key=lambda kv: kv[1])[0]


def find_request(steps: List[dict], request_id: str) -> Optional[dict]:
    """The record of ``request_id`` in a stream's step records (serving
    streams: one step record per served request)."""
    for rec in steps:
        if str(rec.get("request_id")) == str(request_id):
            return rec
    return None


def render_trace(rec: dict, width: int = 40) -> str:
    """One request's span waterfall, as ``obs trace`` prints it.

    Bars are laid out on the request's own timeline (each span starts
    where the previous ended), scaled so the whole lifecycle spans
    ``width`` columns — the classic trace-viewer shape, in a terminal.
    """
    rid = rec.get("request_id", rec.get("step", "?"))
    head = f"request {rid}"
    if rec.get("version"):
        head += f" — version {rec['version']}"
    parts = []
    if rec.get("batch") is not None and rec.get("bucket") is not None:
        parts.append(f"batch {rec['batch']} -> bucket {rec['bucket']}")
    if rec.get("latency_ms") is not None:
        parts.append(f"latency {float(rec['latency_ms']):.2f} ms")
    if parts:
        head += " · " + " · ".join(parts)
    lines = [head]
    items = span_items(rec)
    if not items:
        lines.append(
            "  (record carries no span breakdown — stream predates "
            "request tracing, schema v1)"
        )
        return "\n".join(lines)
    total = sum(ms for _, ms in items) or 1.0
    offset_ms = 0.0
    for name, ms in items:
        # clamp so even a sub-pixel span at the right edge keeps its
        # one-column bar
        start = min(int(round(offset_ms / total * width)), width - 1)
        length = max(1, int(round(ms / total * width)))
        bar = " " * start + "#" * min(length, width - start)
        lines.append(f"  {name:<11} {ms:9.3f} ms  |{bar:<{width}}|")
        offset_ms += ms
    lines.append(
        f"  {'(spans)':<11} {total:9.3f} ms"
        + (f"  ({total - float(rec['latency_ms']):+.3f} ms vs latency)"
           if rec.get("latency_ms") is not None else "")
    )
    return "\n".join(lines)


def render_assembled_trace(asm: dict, width: int = 40) -> str:
    """The cross-process waterfall ``obs trace`` prints for an
    assembled trace (``reader.assemble_trace``): the frontend's request
    at the root, one branch per forward attempt (``first``/``hedge``/
    ``retry``/``probe``) with its outcome — hedges render as competing
    branches with the winner marked ``WON`` — and each attempt's replica
    record nested underneath as the familiar single-process span bars.
    Traces with no frontend record (a direct replica run) degrade to the
    single-record waterfall."""
    lines = []
    fe = asm.get("frontend") or {}
    rec = fe.get("record")
    head = f"trace {asm.get('trace')}"
    if asm.get("request_id"):
        head += f" · request {asm['request_id']}"
    attempts = asm.get("attempts") or []
    if rec is not None:
        if rec.get("latency_ms") is not None:
            head += f" · latency {float(rec['latency_ms']):.2f} ms"
        head += f" · {len(attempts)} attempt(s)"
        if rec.get("hedged"):
            head += " · hedged"
        lines.append(head)
        lines.append(
            f"  frontend span {rec.get('span')} klass={rec.get('klass')}"
            f" replica={rec.get('replica')}"
            + (f"  ({fe.get('stream')})" if fe.get("stream") else "")
        )
    else:
        lines.append(head)
    for i, att in enumerate(attempts):
        last = i == len(attempts) - 1
        branch = "└─" if last else "├─"
        outcome = str(att.get("outcome", "?"))
        mark = "WON" if outcome == "won" else outcome
        line = (f"  {branch} {str(att.get('tag', '?')):<6}-> "
                f"{att.get('replica')}  span {att.get('span')}  "
                f"+{float(att.get('start_ms', 0.0)):.1f} ms")
        if att.get("ms") is not None:
            line += f"  {float(att['ms']):.1f} ms"
        line += f"  [{mark}]"
        ann = att.get("annotations") or []
        if ann:
            line += "  (" + ", ".join(str(a) for a in ann) + ")"
        lines.append(line)
        rrec = att.get("replica_record")
        pad = "       " if last else "  │    "
        if rrec is not None:
            for sub in render_trace(rrec, width=width).splitlines():
                lines.append(pad + sub)
        elif outcome == "discarded":
            lines.append(pad + "(no replica record: attempt abandoned "
                               "in flight)")
    if rec is None:
        # no frontend hop: render every joined record's own waterfall
        for entry in asm.get("records") or []:
            for sub in render_trace(entry["record"],
                                    width=width).splitlines():
                lines.append("  " + sub)
    offs = asm.get("clock_offsets") or {}
    if offs:
        lines.append(
            "  clock offsets vs frontend: "
            + ", ".join(f"{k} {v:+.3f}s" for k, v in sorted(offs.items()))
        )
    orphans = asm.get("orphans") or []
    if orphans:
        lines.append(f"  orphan spans: {len(orphans)} — "
                     + ", ".join(
                         f"{o.get('span')} (parent {o.get('parent')} "
                         f"not found, {o.get('stream')})"
                         for o in orphans[:4]))
    else:
        lines.append("  orphan spans: 0")
    return "\n".join(lines)


def span_totals(steps: List[dict]) -> Dict[str, List[float]]:
    """Per-span samples (ms) over a stream's request records — the raw
    material for the per-span percentile table. Records without spans
    contribute nothing (v1 streams -> empty dict)."""
    out: Dict[str, List[float]] = {}
    for rec in steps:
        for name, ms in span_items(rec):
            out.setdefault(name, []).append(ms)
    return out


def slowest_requests(steps: List[dict], n: int = 5) -> List[dict]:
    """The ``n`` slowest served requests with per-span attribution:
    ``request_id``, ``latency_ms``, ``version``, ``dominant`` span and
    its ms. Only records that carry spans qualify (the table is about
    attribution, not just ranking)."""
    carrying = [
        r for r in steps
        if r.get("latency_ms") is not None and span_items(r)
    ]
    carrying.sort(key=lambda r: float(r["latency_ms"]), reverse=True)
    out = []
    for rec in carrying[:n]:
        dom = dominant_span(rec)
        spans = dict(span_items(rec))
        out.append({
            "request_id": rec.get("request_id", rec.get("step")),
            "latency_ms": float(rec["latency_ms"]),
            "version": rec.get("version"),
            "dominant": dom,
            "dominant_ms": spans.get(dom),
            "spans": spans,
        })
    return out
