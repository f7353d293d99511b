"""repro_torch.obs — dependency-free observability for the serving stack.

The part of the reference's ``repro.obs`` that the serving scheduler
imports: typed spans and the tracer front door, the flight recorder, and
the device-profiler annotation hook.  ``trace`` and ``recorder`` are
stdlib-only and built so the *disabled* path costs nothing but a counter
bump.

Layers::

    trace     TraceContext (128-bit trace id), typed Spans, the
              SpanBuffer ring and the Tracer front door
    recorder  FlightRecorder: ring + scheduler-state snapshots dumped
              to a bounded JSON spool on errors / SLO violations /
              p99-threshold flushes
    profiler  opt-in NVTX ranges so device traces line up with host spans

The Chrome-trace export, the span-chain checker, the measured device-idle
fraction and the JSON log formatter are not ported yet.

The span taxonomy: ``request`` -> ``queue.wait`` -> ``flush.assemble`` ->
``flush.dispatch`` -> ``device.solve`` (one per launch group) ->
``flush.scatter``.
"""
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.obs.trace import (NOOP_TRACER, TRACE_HEADER, Span,
                                   SpanBuffer, TraceContext, Tracer,
                                   current_context, new_trace_context,
                                   parse_trace_header, use_context)

__all__ = [
    "FlightRecorder", "NOOP_TRACER", "Span", "SpanBuffer", "TRACE_HEADER",
    "TraceContext", "Tracer", "current_context", "new_trace_context",
    "parse_trace_header", "use_context",
]
