"""ProfileSession: a ``torch.profiler`` trace of a run, every thread of it,
with the program's own spans on the trace's clock.

:class:`ProfileSession` brackets a run with ``torch.profiler`` (CPU
activity, and CUDA activity when a card is visible) over every thread of
the process, not only the one that started it, so the flush thread's and
the completion worker's work is in the trace
(``python -m repro_torch.serve_lp.rpc --profile-dir``).  While it records,
the process default tracer records too, and every span that starts and
ends on one thread is in the trace already, as its twin (a record-function
range named ``repro_torch.<span name>``).  On :meth:`~ProfileSession.stop` the
session adds the tracer ring's other spans (``request``, ``queue.wait``,
``device.solve``: begun on one thread and ended on another, or recorded
after the fact) to the trace it writes, placed on the trace's clock
through one anchor: ``(perf_counter_ns, time_ns)`` read back to back when
recording starts, and the trace's ``baseTimeNanoseconds`` (a trace's
``ts`` plus the base is the Unix time in microseconds).
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.obs.export import to_chrome_trace
from repro_torch.obs.trace import Span, Tracer, default_tracer


class ProfileSession:
    """Start/stop a ``torch.profiler`` trace around a run.

    ``start()`` returns False (and profiles nothing) without a
    ``log_dir`` or when already started; ``stop()`` exports the trace as
    ``log_dir/profile-<pid>-<unix ms>.json`` (Chrome trace format, which
    Perfetto loads) with ``tracer``'s cross-thread spans of the session
    added (the process default tracer when ``None``), records the path
    in :attr:`trace_path`, and tolerates never-started and double-stop
    so shutdown paths can call it unconditionally.
    """

    def __init__(self, log_dir: Optional[str],
                 tracer: Optional[Tracer] = None):
        self.log_dir = log_dir
        self.tracer = tracer if tracer is not None else default_tracer()
        self.active = False
        self.trace_path: Optional[str] = None
        self.anchor: Optional[tuple] = None   # (perf_counter_ns, time_ns)
        self.base_ns: Optional[int] = None    # the trace's zero, Unix ns
        self._prof = None

    def start(self) -> bool:
        if not self.log_dir or self.active:
            return False
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(
            activities=activities,
            experimental_config=torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True))
        self._prof.__enter__()
        self.anchor = (time.perf_counter_ns(), time.time_ns())
        self.active = True
        return True

    def trace_us(self, t: float) -> float:
        """A ``perf_counter`` time (s) as a ``ts`` of the written trace."""
        pc_ns, unix_ns = self.anchor
        return (t * 1e9 - pc_ns + unix_ns - self.base_ns) / 1e3

    def stop(self) -> bool:
        if not self.active:
            return False
        self.active = False
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(
            self.log_dir,
            f"profile-{os.getpid()}-{int(time.time() * 1e3)}.json")
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            trace = json.load(f)
        self.base_ns = int(trace.get("baseTimeNanoseconds", 0))
        t_start = self.anchor[0] / 1e9
        spans = [s for s in self.tracer.spans()
                 if not s.has_twin and s.t_start >= t_start]
        trace["traceEvents"].extend(self._span_events(trace, spans))
        with open(path, "w", encoding="utf-8") as f:
            json.dump(trace, f)
        self.trace_path = path
        return True

    def _span_events(self, trace: Dict[str, Any],
                     spans: List[Span]) -> List[Dict[str, Any]]:
        """``spans`` as trace events on the trace's clock, under a process
        id of their own."""
        if not spans:
            return []
        base = self.anchor[0] / 1e9 - (
            self.anchor[1] - self.base_ns) / 1e9   # perf_counter of ts 0
        pids = [e["pid"] for e in trace["traceEvents"]
                if isinstance(e.get("pid"), int)]
        pid = max(pids, default=0) + 1
        events = to_chrome_trace(spans, base=base)["traceEvents"]
        for e in events:
            e["pid"] = pid
        return events

    def __enter__(self) -> "ProfileSession":
        self.start()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.stop()
