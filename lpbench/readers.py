"""What the metric readers under ``lpbench/metrics/`` share.

Each reader file is one metric: ``read(run)`` returns its number from a
:class:`lpbench.drivers.Run`, or ``None`` when the run holds nothing to
read it from (then the metric is left out of the result line).  A quantity
that moves two end-to-end metrics has two files, one for each name, and
both point here.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

from lpbench import peaks


def _number(v: float) -> Optional[float]:
    return float(v) if math.isfinite(v) else None


def lps_per_s(run) -> Optional[float]:
    """LPs whose answers came back in the window, over the window."""
    if not run.lps_done or run.window_s <= 0:
        return None
    return run.lps_done / run.window_s


def latency_ms(run, q: float) -> Optional[float]:
    """The ``q``-th percentile of due-to-answer latency over every request
    due in the window; a request never answered counts as infinite."""
    if run.latency_s is None or not len(run.latency_s):
        return None
    return _number(np.percentile(run.latency_s, q) * 1e3)


def setup_s(run) -> Optional[float]:
    return run.setup_s if run.setup_s > 0 else None


def call_host_ms(run) -> Optional[float]:
    """Mean host time from entering ``Solver.solve`` to its return."""
    if run.call_host_s is None or not len(run.call_host_s):
        return None
    return float(np.mean(run.call_host_s)) * 1e3


def submit_us(run) -> Optional[float]:
    """Mean host time in ``BatchScheduler.submit`` over the window."""
    if run.submit_s is None or not len(run.submit_s):
        return None
    return float(np.mean(run.submit_s)) * 1e6


def flush_lps(run) -> Optional[float]:
    """LPs a flush over the window (the scheduler's own counters)."""
    c = run.counters
    if not c or not c.get("n_flushes"):
        return None
    return c["n_solved"] / c["n_flushes"]


def device_idle(run) -> Optional[float]:
    """Per cent of the profiled slice in which nothing ran on the device."""
    sl = run.slice
    if sl is None or sl.length_s <= 0 or not sl.device:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.length_s)


def roofline(run, nbytes: int, match: Optional[str]) -> Optional[float]:
    """Per cent of the memory roofline of one call: its bytes over the
    device time a call (of every activity, or of the kernels whose name
    holds ``match``) in the profiled slice."""
    sl = run.slice
    if sl is None or not sl.calls or not nbytes:
        return None
    dev = sl.device_s(match)
    if dev <= 0:
        return None
    return peaks.roofline_share(nbytes, dev / sl.calls)
