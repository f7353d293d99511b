"""What the readers of the program's own spans share.

The program records its spans (``repro_torch.obs``) into its process
default tracer's ring while a ``torch.profiler`` session records.  The
harness profiles only the slice of a traced run, so after the loop that
ring holds the slice's spans: each begun while the profiler recorded, and
committed when it ended, maybe after the slice.  A reader takes them
through ``repro_torch.obs.default_tracer`` and gives ``None`` where the
program has no such tracer, the ring holds none of the spans it reads, or
the ring dropped spans.  Host times read here are taken under the
profiler, as the device numbers beside them.

The profiler stops just after the last span with a twin began (a
``repro_torch.*`` range in its trace, opened only while it records): that
start is the *cut*.  A request submitted near the cut may be answered
while the harness exports its trace and holds the interpreter, and its
spans carry that pause; taking only spans that ended before the cut would
keep a late request only where its wait was short.  So the serving
readers take the requests submitted at least ``SETTLE_WAITS`` times the
scheduler's ``max_wait_s`` before the cut, whenever they were answered
(all are, before the loop returns; one never answered reads as infinite,
as the harness's own latency does), and the flushes whose dispatch ended
before the cut.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional

import numpy as np

# How many of the scheduler's ``max_wait_s`` before the cut a request of
# the serving readers was submitted: a wait seldom passes one.
SETTLE_WAITS = 5

# The solver front end's stages other than the launch (``solve.launch``).
PASSES = ("solve.cast", "solve.normalize", "solve.shuffle", "solve.pack",
          "solve.pad", "solve.objective")


def program_spans(run) -> Optional[list]:
    """The spans the program recorded in the run (none: ``None``)."""
    try:
        from repro_torch.obs import default_tracer
    except ImportError:
        return None
    tracer = default_tracer()
    if tracer.buffer.dropped:
        return None
    return tracer.spans() or None


def p99(values: Iterable[float]) -> Optional[float]:
    """The 99th percentile; ``None`` for no values, or where it is not
    finite (requests never answered)."""
    v = np.asarray(list(values), dtype=np.float64)
    if not len(v):
        return None
    with np.errstate(invalid="ignore"):
        q = float(np.percentile(v, 99))
    return q if math.isfinite(q) else None


def cut(spans: list) -> float:
    """The last start of a span with a twin: the profiler stopped after."""
    return max((s.t_start for s in spans if s.has_twin), default=math.inf)


def settled_waits(run, spans: list) -> list:
    """The ``queue.wait`` spans of the requests submitted at least
    ``SETTLE_WAITS`` times ``max_wait_s`` before the cut, cancelled ones
    aside."""
    waits = [s for s in spans if s.name == "queue.wait"]
    if not waits:
        return []
    last = cut(spans) - SETTLE_WAITS * float(
        run.config["scheduler"]["max_wait_s"])
    return [s for s in waits
            if s.t_start <= last and not s.attrs.get("cancelled")]


def queue_wait_ms(run) -> List[float]:
    """Each settled request's ``queue.wait``: its submit to its flush's
    assembly start."""
    spans = program_spans(run) or []
    return [(s.t_end - s.t_start) * 1e3 for s in settled_waits(run, spans)]


def post_wait_ms(run) -> List[float]:
    """For each settled request, from its ``queue.wait``'s end to its
    ``request``'s end: assembly, dispatch and the wait for an in-flight
    slot, the device, the completion's pick-up and the scatter; infinite
    for one whose ``request`` never ended, none for one that failed."""
    spans = program_spans(run) or []
    ends: Dict[str, Optional[float]] = {
        s.span_id: s.t_end if "feasible" in s.attrs else None
        for s in spans if s.name == "request"}
    out = []
    for w in settled_waits(run, spans):
        end = ends.get(w.parent_id, math.inf)
        if end is not None:
            out.append((end - w.t_end) * 1e3)
    return out


def flush_enqueue_ms(run) -> List[float]:
    """Each flush's ``device.solve`` ``enqueue_ms``: copy-in start to
    copy-out end between CUDA events on its stream, which wait on the
    host's launches (none on the CPU); the flushes dispatched before the
    cut."""
    spans = program_spans(run) or []
    last = cut(spans)
    return [float(s.attrs["enqueue_ms"]) for s in spans
            if s.name == "device.solve" and "enqueue_ms" in s.attrs
            and s.t_start <= last]


def per_solve_ms(run, names: Iterable[str]) -> Optional[float]:
    """The mean over the ``solve`` spans of the time in their stages named
    ``names``."""
    spans = program_spans(run) or []
    names = set(names)
    solves = {s.span_id: 0.0 for s in spans if s.name == "solve"}
    if not solves:
        return None
    for s in spans:
        if s.name in names and s.parent_id in solves:
            solves[s.parent_id] += (s.t_end - s.t_start) * 1e3
    return float(np.mean(list(solves.values())))
