"""Trace contexts, spans, the ring buffer, and the Tracer front door.

A :class:`TraceContext` is a 128-bit trace id plus the 64-bit id of the
span the next child should parent to.  It is accepted/emitted on the
RPC layer via the ``X-Trace-Id`` header and generated at
``BatchScheduler.submit`` for direct callers, then rides the pending
request through every hop of the serving stack.

Spans are *host-side* typed intervals on the monotonic
``time.perf_counter`` clock (one process, one clock — cross-span math
like the device-idle gap is exact, not NTP-fuzzy).  A span is recorded
only when it *ends*; the :class:`SpanBuffer` ring retains the last N
ended spans and counts what it dropped, so memory is bounded no matter
how long the server runs.

The overhead contract: a disabled :class:`Tracer` never allocates a
span — every ``start_span``/``record`` call returns ``None`` after one
plain counter bump (``noop_calls``), and ``spans_recorded`` stays 0.
The serve bench asserts exactly that on its no-trace path.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

# Wire header carrying the trace context: "<32 hex>" (trace id alone)
# or "<32 hex>-<16 hex>" (trace id + parent span id).
TRACE_HEADER = "X-Trace-Id"

_HEX = set("0123456789abcdef")


def _rand_hex(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


def new_trace_context() -> "TraceContext":
    """A fresh root context: random 128-bit trace id, random 64-bit
    span id (the id request root spans parent to when the caller did
    not send one)."""
    return TraceContext(trace_id=_rand_hex(16), span_id=_rand_hex(8))


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """Where in a trace we are: the trace id plus the current span id
    (children parent to ``span_id``)."""

    trace_id: str   # 32 lowercase hex chars (128-bit)
    span_id: str    # 16 lowercase hex chars (64-bit)

    def child_of(self, span_id: str) -> "TraceContext":
        """The context a child span should inherit: same trace,
        parented to ``span_id``."""
        return TraceContext(trace_id=self.trace_id, span_id=span_id)

    def header_value(self) -> str:
        return f"{self.trace_id}-{self.span_id}"


def parse_trace_header(value: Optional[str]) -> Optional[TraceContext]:
    """Parse an ``X-Trace-Id`` header into a context; ``None`` on a
    missing or malformed value (a bad trace header must never reject a
    request — tracing is best-effort metadata, not admission)."""
    if not value:
        return None
    parts = value.strip().lower().split("-")
    trace_id = parts[0]
    if len(trace_id) != 32 or not set(trace_id) <= _HEX:
        return None
    if len(parts) == 1:
        return TraceContext(trace_id=trace_id, span_id=_rand_hex(8))
    span_id = parts[1]
    if len(parts) != 2 or len(span_id) != 16 or not set(span_id) <= _HEX:
        return None
    return TraceContext(trace_id=trace_id, span_id=span_id)


@dataclasses.dataclass
class Span:
    """One typed host-side interval.  ``t_end`` is 0.0 until the span
    ends; only ended spans enter the ring."""

    trace_id: str
    span_id: str
    parent_id: Optional[str]
    name: str                      # taxonomy type, e.g. "queue.wait"
    t_start: float                 # perf_counter seconds
    t_end: float = 0.0
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def duration_s(self) -> float:
        return max(0.0, self.t_end - self.t_start)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "t_start": self.t_start,
            "t_end": self.t_end,
            "attrs": dict(self.attrs),
        }


class SpanBuffer:
    """Bounded ring of the last ``capacity`` ended spans.

    Appends are a slot write + index bump under a small lock (the
    "lock-free-ish" compromise: contention is one uncontended mutex in
    the common case, and correctness beats cleverness in the flight
    recorder's evidence store).  ``snapshot`` returns spans oldest to
    newest; ``dropped`` counts what the ring has already forgotten.
    """

    def __init__(self, capacity: int = 16384):
        if capacity < 1:
            raise ValueError(f"capacity={capacity} < 1")
        self.capacity = int(capacity)
        self._slots: List[Optional[Span]] = [None] * self.capacity
        self._n = 0               # total spans ever appended
        self._lock = threading.Lock()

    def append(self, span: Span) -> None:
        with self._lock:
            self._slots[self._n % self.capacity] = span
            self._n += 1

    def __len__(self) -> int:
        with self._lock:
            return min(self._n, self.capacity)

    @property
    def total(self) -> int:
        with self._lock:
            return self._n

    @property
    def dropped(self) -> int:
        with self._lock:
            return max(0, self._n - self.capacity)

    def snapshot(self) -> List[Span]:
        """The ring's spans, oldest first."""
        with self._lock:
            n = self._n
            if n <= self.capacity:
                return [s for s in self._slots[:n] if s is not None]
            head = n % self.capacity
            return ([s for s in self._slots[head:] if s is not None]
                    + [s for s in self._slots[:head] if s is not None])

    def clear(self) -> None:
        with self._lock:
            self._slots = [None] * self.capacity
            self._n = 0


class Tracer:
    """The tracing front door every instrumented call site talks to.

    ``enabled`` is fixed at construction so hot paths may cache it as a
    plain bool.  Disabled tracers are pure no-ops: ``start_span`` /
    ``record`` return ``None`` after bumping ``noop_calls`` (a GIL-racy
    plain int — it is diagnostic, not an invariant), and nothing is
    allocated or locked.  ``spans_recorded`` counts ended spans that
    actually entered the ring; "tracing off => spans are no-ops" is
    asserted as ``spans_recorded == 0``.
    """

    def __init__(self, enabled: bool = True, capacity: int = 16384, *,
                 annotate_device: bool = False):
        self.enabled = bool(enabled)
        self.buffer = SpanBuffer(capacity)
        # Opt-in NVTX ranges (obs.profiler.annotation) around dispatches, so
        # device-profiler traces line up with host spans by name.
        self.annotate_device = bool(annotate_device)
        self.spans_started = 0
        self.spans_recorded = 0
        self.noop_calls = 0

    # -- span lifecycle ---------------------------------------------------

    def start_span(self, name: str, trace_id: str,
                   parent_id: Optional[str] = None,
                   t_start: Optional[float] = None,
                   **attrs: Any) -> Optional[Span]:
        """Open a span; returns ``None`` when disabled.  The span is
        not in the ring until :meth:`end`."""
        if not self.enabled:
            self.noop_calls += 1
            return None
        self.spans_started += 1
        return Span(trace_id=trace_id, span_id=_rand_hex(8),
                    parent_id=parent_id, name=name,
                    t_start=(time.perf_counter() if t_start is None
                             else t_start),
                    attrs=attrs)

    def end(self, span: Optional[Span],
            t_end: Optional[float] = None, **attrs: Any) -> None:
        """Close a span and commit it to the ring.  ``None`` (the
        disabled-tracer span) is accepted and ignored so call sites
        need no branching."""
        if span is None:
            self.noop_calls += 1
            return
        span.t_end = time.perf_counter() if t_end is None else t_end
        if attrs:
            span.attrs.update(attrs)
        self.buffer.append(span)
        self.spans_recorded += 1

    def record(self, name: str, trace_id: str,
               parent_id: Optional[str], t_start: float, t_end: float,
               **attrs: Any) -> Optional[Span]:
        """Record an already-measured interval (e.g. ``device.solve``
        reconstructed from dispatch/complete timestamps) in one call."""
        span = self.start_span(name, trace_id, parent_id,
                               t_start=t_start, **attrs)
        if span is not None:
            self.end(span, t_end=t_end)
        return span

    # -- views ------------------------------------------------------------

    def spans(self) -> List[Span]:
        return self.buffer.snapshot()

    def stats(self) -> Dict[str, int]:
        return {
            "enabled": int(self.enabled),
            "spans_started": self.spans_started,
            "spans_recorded": self.spans_recorded,
            "noop_calls": self.noop_calls,
            "ring_len": len(self.buffer),
            "ring_capacity": self.buffer.capacity,
            "ring_dropped": self.buffer.dropped,
        }


# The shared disabled tracer: what every instrumented component uses
# when no tracer was injected, so call sites never need None checks.
NOOP_TRACER = Tracer(enabled=False, capacity=1)


# -- ambient context (for log injection) -----------------------------------

_current: contextvars.ContextVar[Optional[Dict[str, Any]]] = \
    contextvars.ContextVar("repro_obs_context", default=None)


def current_context() -> Dict[str, Any]:
    """The ambient observability fields (trace_id, span_id, tenant,
    bucket, ...) bound by :func:`use_context`; empty when none."""
    ctx = _current.get()
    return dict(ctx) if ctx else {}


@contextlib.contextmanager
def use_context(**fields: Any) -> Iterator[None]:
    """Bind fields into the ambient context for the dynamic extent of
    the block — the JSON log formatter stamps them onto every record
    emitted inside.  Nested uses merge (inner wins)."""
    merged = current_context()
    merged.update({k: v for k, v in fields.items() if v is not None})
    token = _current.set(merged)
    try:
        yield
    finally:
        _current.reset(token)


def span_index(spans: List[Span]) -> Dict[str, Span]:
    """``span_id -> Span`` for a snapshot (helper for checkers)."""
    return {s.span_id: s for s in spans}


def spans_for_trace(spans: List[Span], trace_id: str) -> List[Span]:
    """All spans belonging to ``trace_id``: its own spans plus flush
    spans whose ``trace_ids`` membership attribute names it, plus the
    children of those flush spans (dispatch / device.solve / scatter
    carry only the flush's primary trace id — membership rides on the
    ``flush.assemble`` span to keep ring entries small)."""
    own = [s for s in spans if s.trace_id == trace_id]
    flushes: List[str] = []
    for s in spans:
        if (s.name == "flush.assemble"
                and trace_id in s.attrs.get("trace_ids", ())):
            flushes.append(s.attrs.get("flush", ""))
    if not flushes:
        return own
    flush_set = set(flushes)
    seen = {s.span_id for s in own}
    extra = [s for s in spans
             if s.attrs.get("flush") in flush_set
             and s.span_id not in seen]
    return own + extra


def flush_membership(spans: List[Span]
                     ) -> Dict[str, Tuple[str, ...]]:
    """``flush name -> member trace ids`` from assemble spans."""
    out: Dict[str, Tuple[str, ...]] = {}
    for s in spans:
        if s.name == "flush.assemble":
            out[s.attrs.get("flush", "")] = tuple(
                s.attrs.get("trace_ids", ()))
    return out
