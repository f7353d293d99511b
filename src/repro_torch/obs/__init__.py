"""repro_torch.obs — dependency-free observability for the serving stack.

The reference's ``repro.obs`` for the port: typed spans and the tracer
front door, the Chrome-trace exporter with the span-chain checker and the
measured device-idle fraction, the flight recorder, structured logs and
the device-profiler hooks.  ``trace``, ``export``, ``recorder`` and
``log`` are built so a tracer that is not recording costs one flag read
a call site (``trace`` imports torch only for the profiler's flag and the
spans' twins in a profiler trace).

Layers::

    trace     TraceContext (128-bit trace id), typed Spans, the
              SpanBuffer ring, the Tracer front door, the process
              default tracer (records while a torch.profiler session
              records) and the current span a flush's solve runs under
    export    Chrome trace_event JSON (Perfetto-loadable), the span
              chain checker, and the device-idle fraction read from
              device.solve spans (a lower bound: the spans are host-
              observed dispatch-to-complete windows)
    recorder  FlightRecorder: ring + scheduler-state snapshots dumped
              to a bounded JSON spool on errors / SLO violations /
              p99-threshold flushes
    log       stdlib-logging JSON formatter with trace_id/span_id/
              tenant/bucket injected from the active context
    profiler  ProfileSession: torch.profiler over a run, every thread,
              with the ring's cross-thread spans added to its trace on
              the trace's clock

The span taxonomy: ``rpc.handle`` -> ``admit`` -> ``request`` ->
``queue.wait`` -> ``flush.assemble`` ->
``flush.dispatch`` (-> ``solve`` -> its stages) -> ``device.solve``
(one per launch group) -> ``flush.scatter``; ``submit`` over
``BatchScheduler.submit``; ``solve`` -> ``solve.cast``,
``solve.normalize``, ``solve.shuffle``, ``solve.pack``, ``solve.pad``,
``solve.launch``, ``solve.objective`` over a solve.
"""
from repro_torch.obs.export import (check_span_chains, device_idle,
                                    to_chrome_trace)
from repro_torch.obs.log import JsonFormatter, setup_logging
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.obs.trace import (NOOP_TRACER, TRACE_HEADER, Span,
                                   SpanBuffer, TraceContext, Tracer,
                                   current_context, default_tracer,
                                   new_trace_context, parse_trace_header,
                                   use_context)

__all__ = [
    "FlightRecorder", "JsonFormatter", "NOOP_TRACER", "Span",
    "SpanBuffer", "TRACE_HEADER", "TraceContext", "Tracer",
    "check_span_chains", "current_context", "default_tracer", "device_idle",
    "new_trace_context", "parse_trace_header", "setup_logging",
    "to_chrome_trace", "use_context",
]
