"""What the crowd cells read from a profiled slice and from the program's
``crowd.*`` spans.

:func:`profile` is :func:`lpbench.trace.profile` with one more reading from
the same trace: the device time of the work launched inside the
``repro_torch.crowd.build`` ranges (the twins of the program's
``crowd.build`` spans).  A launch is a CUDA runtime or driver call on the
host thread within such a range; the kernels, copies and memsets it
started carry its ``correlation`` id.

The span readers take the ``crowd.step`` spans of the process default
tracer whose stages are all in its ring (a served slice records three
spans a request and may overflow the ring, which then keeps the later
steps whole), and give ``None`` where there are none or the program has
no such tracer.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from lpbench import trace as tr

BUILD = "repro_torch.crowd.build"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# The stages a step of each path records under its ``crowd.step``.
STAGES = {
    "direct": ("crowd.build", "crowd.solve", "crowd.apply"),
    "served": ("crowd.build", "crowd.submit", "crowd.wait", "crowd.apply"),
}


def build_device(trace: dict) -> Tuple[float, int]:
    """``(seconds, ranges)``: the device time of everything launched inside
    the ``crowd.build`` ranges of a Chrome trace, and how many ranges."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "ts" in e and "dur" in e]
    ranges = [(e.get("pid"), e.get("tid"), float(e["ts"]),
               float(e["ts"]) + float(e["dur"]))
              for e in events if e.get("name") == BUILD]
    if not ranges:
        return 0.0, 0
    by_thread: Dict[tuple, List[Tuple[float, float]]] = {}
    for pid, tid, s, t in ranges:
        by_thread.setdefault((pid, tid), []).append((s, t))
    ids = set()
    for e in events:
        if e.get("cat") not in LAUNCH_CATS:
            continue
        corr = (e.get("args") or {}).get("correlation")
        spans = by_thread.get((e.get("pid"), e.get("tid")))
        if corr is None or not spans:
            continue
        ts = float(e["ts"])
        if any(s <= ts <= t for s, t in spans):
            ids.add(corr)
    us = sum(float(e["dur"]) for e in events
             if e.get("cat") in tr.DEVICE_CATS
             and (e.get("args") or {}).get("correlation") in ids)
    return us / 1e6, len(ranges)


def profile(fn: Callable[[], int], sync: Callable[[], None]
            ) -> Tuple[Optional[tr.Slice], float, int]:
    """Run ``fn`` under the profiler as :func:`lpbench.trace.profile` does;
    the parsed slice, and :func:`build_device` of the same trace."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(tr.SLICE):
            n = fn()
            sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    sl = tr.parse(trace)
    if sl is not None:
        sl.calls = n
    return (sl,) + build_device(trace)


def steps(path: str) -> List[Dict[str, float]]:
    """Each whole ``crowd.step`` of the ring: its stages' host seconds by
    name."""
    try:
        from repro_torch.obs import default_tracer
    except ImportError:
        return []
    spans = default_tracer().spans()
    tops = {s.span_id: {} for s in spans if s.name == "crowd.step"}
    for s in spans:
        if s.parent_id in tops:
            tops[s.parent_id][s.name] = s.t_end - s.t_start
    want = STAGES[path]
    return [st for st in tops.values() if all(n in st for n in want)]


def mean_ms(run, names) -> Optional[float]:
    """The mean over the whole steps of the host time in the stages
    ``names``."""
    got = steps(run.traffic["path"])
    if not got:
        return None
    return float(np.mean([sum(st[n] for n in names) for st in got])) * 1e3
