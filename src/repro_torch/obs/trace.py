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

When a tracer records: an injected ``Tracer(enabled=True)`` always; the
process default tracer (:func:`default_tracer`, what every component
built without a tracer uses) while a ``torch.profiler`` session records,
read from ``torch.autograd.profiler._is_profiler_enabled`` (process-wide:
worker threads see it too).  A span started while recording is committed
when it ends, whether or not recording has stopped by then, and so is a
:meth:`Tracer.child` of it.

A span that starts and ends on one thread can have a *twin*: a
record-function range of the profiler named ``repro_torch.<span name>``,
opened only while a profiler records, so the span also lands in the
profiler's trace on the device's clock.

The overhead contract: a tracer that is not recording never allocates a
span — ``start_span``/``record``/:func:`open_span` return ``None`` after
one flag read, and ``spans_started`` stays 0.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import random
import threading
import time
from itertools import chain
from typing import Any, ClassVar, Dict, Iterator, List, Optional, Tuple

import torch
from torch.autograd import profiler as _torch_profiler

# Wire header carrying the trace context: "<32 hex>" (trace id alone)
# or "<32 hex>-<16 hex>" (trace id + parent span id).
TRACE_HEADER = "X-Trace-Id"

# Prefix of a span's twin in a profiler trace.
TWIN_PREFIX = "repro_torch."

_HEX = set("0123456789abcdef")


def _rand_hex(nbytes: int) -> str:
    """``nbytes`` random bytes as hex, from the ``random`` module's
    generator (seeded from the OS, and again in a forked child): a
    fraction of ``os.urandom``'s system call."""
    return "%0*x" % (2 * nbytes, random.getrandbits(8 * nbytes))


# The record function a twin opens: the profiler's C++ one, at a tenth of
# ``torch.profiler.record_function``'s cost; it shows as a ``cpu_op``.
_Twin = torch._C._profiler._RecordFunctionFast


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
    # Not fields (class defaults, set per span while recording): the tracer
    # whose ring the span goes to, and its twin while open (``True`` once
    # closed; ``None``: the span has none).
    _tracer: ClassVar[Any] = None
    _twin: ClassVar[Any] = None

    @property
    def has_twin(self) -> bool:
        """Whether the span has a twin in the profiler's trace."""
        return self._twin is not None

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

    A slot holds a span as a tuple of plain values, which Python's
    collector stops tracking while it is young: a full ring of a
    recording server then adds nothing to a full collection's walk, nor
    brings the next one sooner.  ``snapshot`` builds the spans anew.
    """

    def __init__(self, capacity: int = 16384):
        if capacity < 1:
            raise ValueError(f"capacity={capacity} < 1")
        self.capacity = int(capacity)
        self._slots: List[Optional[tuple]] = [None] * self.capacity
        self._n = 0               # total spans ever appended
        self._lock = threading.Lock()

    def append(self, span: Span) -> None:
        # Attributes flattened, so that no dict keeps ``rec`` tracked.
        attrs = tuple(chain.from_iterable(span.attrs.items()))
        rec = (span.trace_id, span.span_id, span.parent_id, span.name,
               span.t_start, span.t_end, attrs, span._twin is not None)
        lock = self._lock
        lock.acquire()
        self._slots[self._n % self.capacity] = rec
        self._n += 1
        lock.release()

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
                recs = self._slots[:n]
            else:
                head = n % self.capacity
                recs = self._slots[head:] + self._slots[:head]
        return [_span_of(r) for r in recs if r is not None]

    def clear(self) -> None:
        with self._lock:
            self._slots = [None] * self.capacity
            self._n = 0


def _span_of(rec: tuple) -> Span:
    kv = rec[6]
    span = Span(*rec[:6], attrs=dict(zip(kv[::2], kv[1::2])))
    if rec[7]:
        span._twin = True
    return span


class Tracer:
    """The tracing front door every instrumented call site talks to.

    ``Tracer(enabled=True)`` records always, ``Tracer(enabled=False)``
    never, and the process default tracer (:func:`default_tracer`) while
    a ``torch.profiler`` session records.
    :attr:`enabled` says whether it records now; a call site reads it
    once and, when it is False, allocates nothing.  ``spans_started``
    counts spans opened, ``spans_recorded`` ended spans that entered the
    ring; "tracing off => spans are no-ops" is asserted as
    ``spans_started == 0``.
    """

    def __init__(self, enabled: bool = True, capacity: int = 16384):
        self._on = bool(enabled)
        self.buffer = SpanBuffer(capacity)
        self.spans_started = 0
        self.spans_recorded = 0

    @property
    def enabled(self) -> bool:
        """Whether spans opened now are recorded."""
        return self._on

    # -- span lifecycle ---------------------------------------------------

    def start_span(self, name: str, trace_id: str,
                   parent_id: Optional[str] = None,
                   t_start: Optional[float] = None, *, twin: bool = False,
                   **attrs: Any) -> Optional[Span]:
        """Open a span; returns ``None`` when not recording.  The span is
        not in the ring until :meth:`end`.  ``twin``: the span ends on
        this thread, so open its twin while a profiler records."""
        if not self.enabled:
            return None
        return self._start(name, trace_id, parent_id, t_start, twin, attrs)

    def child(self, parent: Optional[Span], name: str,
              t_start: Optional[float] = None, *, twin: bool = False,
              **attrs: Any) -> Optional[Span]:
        """Open a span under ``parent``, in its trace; ``None`` when
        ``parent`` is.  Recorded whether or not this tracer records now:
        a recorded parent (a flush dispatched while recording) keeps its
        children."""
        if parent is None:
            return None
        return self._start(name, parent.trace_id, parent.span_id, t_start,
                           twin, attrs)

    def _start(self, name: str, trace_id: str, parent_id: Optional[str],
               t_start: Optional[float], twin: bool,
               attrs: Dict[str, Any]) -> Span:
        self.spans_started += 1
        span = Span(trace_id, _rand_hex(8), parent_id, name,
                    time.perf_counter() if t_start is None else t_start,
                    0.0, attrs)
        span._tracer = self
        if twin and _torch_profiler._is_profiler_enabled:
            rf = _Twin(TWIN_PREFIX + name)
            rf.__enter__()
            span._twin = rf
        return span

    def end(self, span: Optional[Span],
            t_end: Optional[float] = None, **attrs: Any) -> None:
        """Close a span (and its twin) and commit it to the ring.
        ``None`` (the span of a tracer that was not recording) is
        accepted and ignored so call sites need no branching."""
        if span is None:
            return
        span.t_end = time.perf_counter() if t_end is None else t_end
        rf = span._twin
        if rf is not None and rf is not True:
            rf.__exit__(None, None, None)
            span._twin = True
        if attrs:
            span.attrs.update(attrs)
        self.buffer.append(span)
        self.spans_recorded += 1

    def record(self, name: str, trace_id: str,
               parent_id: Optional[str], t_start: float, t_end: float,
               **attrs: Any) -> Optional[Span]:
        """Record an already-measured interval in one call; ``None`` when
        not recording."""
        span = self.start_span(name, trace_id, parent_id,
                               t_start=t_start, **attrs)
        if span is not None:
            self.end(span, t_end=t_end)
        return span

    # -- views ------------------------------------------------------------

    def spans(self) -> List[Span]:
        return self.buffer.snapshot()

    def reset(self) -> None:
        """Empty the ring and zero the counters."""
        self.buffer.clear()
        self.spans_started = 0
        self.spans_recorded = 0

    def stats(self) -> Dict[str, int]:
        return {
            "enabled": int(self.enabled),
            "spans_started": self.spans_started,
            "spans_recorded": self.spans_recorded,
            "ring_len": len(self.buffer),
            "ring_capacity": self.buffer.capacity,
            "ring_dropped": self.buffer.dropped,
        }


# A tracer that never records: inject it to keep a component's spans off
# even while a profiler records.
NOOP_TRACER = Tracer(enabled=False, capacity=1)

class _WhileProfiling(Tracer):
    """A tracer that records while a ``torch.profiler`` session records."""

    @property
    def enabled(self) -> bool:
        return _torch_profiler._is_profiler_enabled


# The process default tracer: what every component built without a
# tracer uses.  Its ring holds a served slice of a few seconds (three
# spans a request, about a dozen a flush) with room to spare.
_DEFAULT_TRACER = _WhileProfiling(capacity=1 << 17)


def default_tracer() -> Tracer:
    """The process default tracer (records while a profiler records)."""
    return _DEFAULT_TRACER


# -- the span a thread's work runs under -------------------------------------

# Set by a traced flush's dispatch so the solve it runs records its spans
# into the flush's own tracer, under its flush.dispatch span.
_current_span: contextvars.ContextVar[Optional[Span]] = \
    contextvars.ContextVar("repro_torch_obs_span", default=None)


def current_span() -> Optional[Span]:
    """The span set by :func:`set_current_span` in this context, if any."""
    return _current_span.get()


def set_current_span(span: Span) -> contextvars.Token:
    """Make ``span`` the parent of :func:`open_span` calls in this context
    (until :func:`reset_current_span` with the returned token)."""
    return _current_span.set(span)


def reset_current_span(token: contextvars.Token) -> None:
    _current_span.reset(token)


def open_span(name: str) -> Optional[Span]:
    """Open a span that ends on this thread, with its twin: under the
    current span when there is one, else as the root of a new trace of
    the process default tracer.  ``None`` when nothing records; close it
    with :func:`close_span`."""
    parent = _current_span.get()
    if parent is not None:
        return parent._tracer.child(parent, name, twin=True)
    if not _DEFAULT_TRACER.enabled:
        return None
    return _DEFAULT_TRACER._start(name, _rand_hex(16), None, None, True, {})


def stage(parent: Optional[Span], prev: Optional[Span],
          name: Optional[str]) -> Optional[Span]:
    """Close ``prev`` and open the stage ``name`` (none: open nothing)
    under ``parent``, each with its twin; ``None`` throughout when
    ``parent`` is ``None``, as it is when nothing records."""
    if parent is None:
        return None
    tr = parent._tracer
    if prev is not None:
        tr.end(prev)
    if name is None:
        return None
    return tr.child(parent, name, twin=True)


def close_span(span: Optional[Span]) -> None:
    """End a span opened by :func:`open_span`."""
    if span is not None:
        span._tracer.end(span)


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
