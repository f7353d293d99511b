"""A profiled slice of a run and what the readers take from it.

:func:`profile` runs a function under ``torch.profiler`` (host and CUDA
activity) inside a host span named ``lpbench.slice``, exports the Chrome
trace to a temporary file, reads it back and deletes it.  :func:`parse`
turns the trace into a :class:`Slice`: the slice's bounds on the trace's
clock, the device's activity (kernels, copies, memsets) clipped to them,
and the host's spans.  The union of the device intervals is the busy time;
each gap between them is named by what the host was doing in its middle.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
from typing import Callable, Dict, List, Optional, Tuple

import torch

SLICE = "lpbench.slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op")


@dataclasses.dataclass
class Slice:
    start_us: float
    end_us: float
    device: List[Tuple[float, float, str]]   # (start, end, name), clipped
    host: List[Tuple[float, float, str, str]]  # (start, end, name, cat)
    calls: int = 0                            # calls or requests in it

    @property
    def length_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        out: List[Tuple[float, float]] = []
        for s, e, _ in sorted(self.device):
            if out and s <= out[-1][1]:
                if e > out[-1][1]:
                    out[-1] = (out[-1][0], e)
            else:
                out.append((s, e))
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def device_s(self, match: Optional[str] = None) -> float:
        """Device seconds of every activity, or of those whose name holds
        ``match`` (overlaps counted twice: a sum, not a union)."""
        return sum(e - s for s, e, n in self.device
                   if match is None or match in n) / 1e6

    def top_ops(self, k: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for s, e, n in self.device:
            by[n] = by.get(n, 0.0) + (e - s) / 1e6
        return [[n, t] for n, t in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def gaps(self) -> List[Tuple[float, float]]:
        out, t = [], self.start_us
        for s, e in self.busy_intervals():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.end_us > t:
            out.append((t, self.end_us))
        return out

    def idle_by_host(self, k: int = 10) -> List[list]:
        """Idle seconds by what the host was doing in the middle of each
        gap: the innermost harness span (``lpbench.*``, the slice aside)
        and the innermost operator, on any thread; the ``k`` largest."""
        events = sorted(h for h in self.host if h[2] != SLICE)
        gaps = sorted(((s + e) / 2, e - s) for s, e in self.gaps())
        by: Dict[str, float] = {}
        active: list = []
        i = 0
        for t, length in gaps:
            while i < len(events) and events[i][0] <= t:
                active.append(events[i])
                i += 1
            active = [a for a in active if a[1] >= t]
            span = max((a for a in active if a[3] == "user_annotation"
                        and a[2].startswith("lpbench.")), default=None)
            op = max((a for a in active if a[3] == "cpu_op"), default=None)
            parts = [p[2] for p in (span, op) if p is not None]
            name = "/".join(parts) if parts else "host_between_spans"
            by[name] = by.get(name, 0.0) + length / 1e6
        return [[n, t] for n, t in sorted(by.items(), key=lambda x: -x[1])[:k]]


def short_name(name: str) -> str:
    """A C++ kernel's name without its argument list; any other name (a
    copy, a memset) whole."""
    if "::" not in name:
        return name
    cut = name.find("(", name.find(">") if "<" in name else 0)
    return name[:cut].strip() if cut > 0 else name


def span(name: str, on: bool):
    """A host span in the profiled slice, a null context outside it."""
    return torch.profiler.record_function(name) if on else \
        contextlib.nullcontext()


def parse(trace: dict) -> Optional[Slice]:
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e and "ts" in e]
    bounds = [e for e in events
              if e.get("name") == SLICE and e.get("cat") == "user_annotation"]
    if not bounds:
        return None
    lo = float(bounds[0]["ts"])
    hi = lo + float(bounds[0]["dur"])
    device, host = [], []
    for e in events:
        s = float(e["ts"])
        t = s + float(e["dur"])
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            s, t = max(s, lo), min(t, hi)
            if t > s:
                device.append((s, t, short_name(str(e.get("name", "")))))
        elif cat in HOST_CATS:
            host.append((s, t, str(e.get("name", "")), cat))
    return Slice(lo, hi, device, host)


def profile(fn: Callable[[], int], sync: Callable[[], None]) -> Optional[Slice]:
    """Run ``fn`` (which returns how many calls or requests it made) under
    the profiler, then ``sync``; the parsed slice, or ``None`` when the
    trace has no slice span."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(SLICE):
            n = fn()
            sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            sl = parse(json.load(f))
    finally:
        os.remove(path)
    if sl is not None:
        sl.calls = n
    return sl


def warm(sync: Callable[[], None]) -> None:
    """Pay the profiler's first start (its library set-up) in set-up."""
    profile(lambda: 0, sync)
