"""Trace context: mint/parse/propagate one causal id per label decision
(the port's own copy of ``coda_tpu/telemetry/trace.py``, stdlib only).

A trace context is an immutable ``(trace_id, span_id, parent)`` triple,
W3C-traceparent-shaped but deliberately smaller: the serve stack only ever
crosses one trust boundary (client -> router -> replica), so the flags and
version fields buy nothing. The wire form is one HTTP header::

    coda-trace: <trace_id>-<span_id>

where ``trace_id`` is 16 bytes hex (the whole causal chain) and ``span_id``
is 8 bytes hex (the caller's span — the receiver records it as ``parent``
and mints a fresh ``span_id`` for its own work). ``InprocReplica`` passes
the parsed tuple as a keyword argument instead of serializing; both roads
meet in the replica verb, preserving the transport parity contract.

Design rule (the non-perturbation contract): a trace context may touch *tickets, spans,
metrics and recorder rows* — never session state, PRNG keys, or posterior
math. With tracing off every code path sees ``None`` and takes the exact
branch it took before this module existed.
"""

from __future__ import annotations

import os
import re
from typing import NamedTuple, Optional

# HTTP header carrying the context (lower-case: our parser lower-cases all
# header names, and urllib title-cases on send — match case-insensitively)
TRACE_HEADER = "coda-trace"

_HEX = re.compile(r"^[0-9a-f]+$")


class TraceContext(NamedTuple):
    """One hop of a causal chain. ``parent`` is the caller's span_id
    (empty string at the front door)."""
    trace_id: str
    span_id: str
    parent: str = ""

    def header(self) -> str:
        """Wire form for the ``coda-trace`` header (parent is implicit:
        the receiver treats our ``span_id`` as its parent)."""
        return f"{self.trace_id}-{self.span_id}"

    def child(self) -> "TraceContext":
        """Fresh span under the same trace, parented to this span."""
        return TraceContext(self.trace_id, _new_span_id(), self.span_id)

    def attrs(self) -> dict:
        """Span-recorder attrs for this context (the keys the per-trace
        retention index and the stitcher key off)."""
        d = {"trace": self.trace_id, "span": self.span_id}
        if self.parent:
            d["parent"] = self.parent
        return d


def _new_span_id() -> str:
    return os.urandom(8).hex()


def mint() -> TraceContext:
    """Front-door mint: fresh trace, fresh root span, no parent."""
    return TraceContext(os.urandom(16).hex(), _new_span_id(), "")


def parse(header: Optional[str]) -> Optional[TraceContext]:
    """Parse a ``coda-trace`` header value; ``None`` on anything malformed
    (a bad header must degrade to untraced, never to a 500)."""
    if not header:
        return None
    parts = header.strip().lower().split("-")
    if len(parts) != 2:
        return None
    tid, sid = parts
    if len(tid) != 32 or len(sid) != 16:
        return None
    if not (_HEX.match(tid) and _HEX.match(sid)):
        return None
    return TraceContext(tid, sid, "")


def continue_from(ctx: Optional["TraceContext"]) -> Optional["TraceContext"]:
    """Receiver-side continuation: mint a child span under the caller's
    context, or ``None`` when the caller sent none (stay untraced)."""
    return ctx.child() if ctx is not None else None
