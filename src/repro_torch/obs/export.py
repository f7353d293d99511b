"""Span exporters: Chrome ``trace_event`` JSON, span-chain validation,
and the measured device-idle fraction.

The Chrome format (loadable in Perfetto / ``chrome://tracing``) is a
flat ``{"traceEvents": [...]}`` list.  We render:

* one **complete** ("X") event per ``device.solve`` span per device it
  covered, on a named per-device track — the flush timeline the paper's
  utilization claim needs;
* one "X" event per flush-plane span (``flush.assemble`` /
  ``flush.dispatch`` / ``flush.scatter``) on a named per-m-bucket
  track, so each bucket's cadence reads as a lane;
* request-plane spans (``rpc.handle``, ``admit``, ``request``,
  ``queue.wait``) as **async nestable** ("b"/"e") events grouped by
  trace id — thousands of concurrent requests render as their own
  little chains instead of a single malformed stack.

Timestamps are microseconds relative to the earliest span in the
export (Chrome wants small positive ``ts``), or to a given ``base`` on
the spans' clock: :class:`~repro_torch.obs.profiler.ProfileSession`
passes the ``perf_counter`` time of its profiler trace's zero, so the
spans land on that trace's clock.

:func:`device_idle` turns the per-device ``device.solve`` tracks into
the *measured* idle fraction: union the busy intervals per device,
divide by the observation window.  This replaces the serving metrics'
"device-idle-gap estimate" whenever tracing is on.  In this package a
``device.solve`` span covers the host-observed window from a flush's
dispatch (the launches enqueued) to its completion (the D2H copy's event
observed by the completion worker), which contains the device's work and
may extend past it: an idle fraction read from these spans is a *lower
bound* on the device's idle share.

:func:`check_span_chains` is the ``--assert-trace`` contract: every
completed request trace must have a full chain
``request -> queue.wait -> (its flush's) assemble -> dispatch ->
device.solve -> scatter`` with sane parent links and ordering.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.trace import Span

# Track-id blocks for the synthetic Chrome thread ids.
_PID = 1
_TID_DEVICE = 1000     # + device index
_TID_BUCKET = 2000     # + dense bucket index (sorted m)

REQUEST_PLANE = ("rpc.handle", "admit", "request", "queue.wait")
FLUSH_PLANE = ("flush.assemble", "flush.dispatch", "flush.scatter")


def _us(t: float, t0: float) -> float:
    return round((t - t0) * 1e6, 3)


def to_chrome_trace(spans: Sequence[Span],
                    base: Optional[float] = None) -> Dict[str, Any]:
    """Render a span snapshot as a Chrome ``trace_event`` object; ``ts``
    counts from ``base`` (``perf_counter`` seconds), by default the
    earliest span's start."""
    spans = [s for s in spans if s.t_end >= s.t_start]
    if not spans:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t0 = min(s.t_start for s in spans) if base is None else base
    events: List[Dict[str, Any]] = []

    def meta(tid: int, name: str, sort: int) -> None:
        events.append({"ph": "M", "pid": _PID, "tid": tid,
                       "name": "thread_name", "args": {"name": name}})
        events.append({"ph": "M", "pid": _PID, "tid": tid,
                       "name": "thread_sort_index",
                       "args": {"sort_index": sort}})

    events.append({"ph": "M", "pid": _PID, "name": "process_name",
                   "args": {"name": "repro_torch.serve_lp"}})

    devices = sorted({int(d) for s in spans if s.name == "device.solve"
                      for d in s.attrs.get("devices", ())})
    for d in devices:
        meta(_TID_DEVICE + d, f"device{d} solve", 10 + d)
    buckets = sorted({int(s.attrs["bucket_m"]) for s in spans
                      if s.name in FLUSH_PLANE and "bucket_m" in s.attrs})
    bucket_tid = {bm: _TID_BUCKET + i for i, bm in enumerate(buckets)}
    for bm, tid in bucket_tid.items():
        meta(tid, f"bucket m={bm}", 100 + tid - _TID_BUCKET)

    for s in spans:
        args = {"trace_id": s.trace_id, "span_id": s.span_id,
                **{k: v for k, v in s.attrs.items()
                   if k != "trace_ids"}}
        if "trace_ids" in s.attrs:
            args["n_traces"] = len(s.attrs["trace_ids"])
        if s.name == "device.solve":
            for d in s.attrs.get("devices", ()):
                events.append({
                    "name": s.name, "ph": "X", "pid": _PID,
                    "tid": _TID_DEVICE + int(d),
                    "ts": _us(s.t_start, t0),
                    "dur": max(_us(s.t_end, t0) - _us(s.t_start, t0),
                               0.001),
                    "cat": "device", "args": args})
        elif s.name in FLUSH_PLANE and "bucket_m" in s.attrs:
            events.append({
                "name": s.name, "ph": "X", "pid": _PID,
                "tid": bucket_tid[int(s.attrs["bucket_m"])],
                "ts": _us(s.t_start, t0),
                "dur": max(_us(s.t_end, t0) - _us(s.t_start, t0),
                           0.001),
                "cat": "flush", "args": args})
        else:
            # Request plane: async nestable pairs keyed by trace id.
            common = {"name": s.name, "cat": "request", "pid": _PID,
                      "tid": 1, "id": s.trace_id}
            events.append({**common, "ph": "b",
                           "ts": _us(s.t_start, t0), "args": args})
            events.append({**common, "ph": "e",
                           "ts": _us(s.t_end, t0)})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(spans: Sequence[Span], path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(to_chrome_trace(spans), f)


# Phases a torch.profiler trace adds to ours: instants, counters, flows.
_OTHER_PHASES = ("i", "I", "C", "s", "t", "f")


def validate_chrome_trace(obj: Dict[str, Any]) -> None:
    """Structural check of an exported trace object (tests/CI), ours or a
    profiler trace with our spans added: raises ValueError on anything
    Perfetto would choke on."""
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("trace object needs a traceEvents list")
    events = obj["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("traceEvents must be a list")
    open_async: Dict[Tuple[str, str], int] = {}
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            raise ValueError(f"event {i} is not an object")
        ph = e.get("ph")
        if ph not in ("X", "M", "b", "e") + _OTHER_PHASES:
            raise ValueError(f"event {i}: unsupported phase {ph!r}")
        if ph in _OTHER_PHASES:
            continue
        if "pid" not in e:
            raise ValueError(f"event {i}: missing pid")
        if ph == "M":
            continue
        if not isinstance(e.get("name"), str) or not e["name"]:
            raise ValueError(f"event {i}: missing name")
        ts = e.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            raise ValueError(f"event {i}: bad ts {ts!r}")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"event {i}: bad dur {dur!r}")
        elif ph == "b":
            open_async[(e.get("id"), e["name"])] = \
                open_async.get((e.get("id"), e["name"]), 0) + 1
        elif ph == "e":
            key = (e.get("id"), e["name"])
            if open_async.get(key, 0) < 1:
                raise ValueError(
                    f"event {i}: async end without begin for {key}")
            open_async[key] -= 1
    dangling = {k: v for k, v in open_async.items() if v}
    if dangling:
        raise ValueError(f"unbalanced async events: {dangling}")


# -- measured device idleness ----------------------------------------------

def _merge(intervals: List[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def device_idle(spans: Sequence[Span],
                window: Optional[Tuple[float, float]] = None
                ) -> Dict[str, Any]:
    """The measured device-idle picture from ``device.solve`` spans.

    Per device: busy = union of its solve intervals; idle fraction =
    1 - busy / window.  ``window`` defaults to the [earliest start,
    latest end] over all device spans — the span of time the device
    plane was observably in use.  Returns zeros when no device spans
    exist (nothing was traced)."""
    per_dev: Dict[int, List[Tuple[float, float]]] = {}
    for s in spans:
        if s.name != "device.solve" or s.t_end <= s.t_start:
            continue
        for d in s.attrs.get("devices", ()):
            per_dev.setdefault(int(d), []).append((s.t_start, s.t_end))
    if not per_dev:
        return {"devices": {}, "window_s": 0.0,
                "idle_frac": 0.0, "busy_s": 0.0, "idle_s": 0.0}
    if window is None:
        lo = min(iv[0] for ivs in per_dev.values() for iv in ivs)
        hi = max(iv[1] for ivs in per_dev.values() for iv in ivs)
    else:
        lo, hi = window
    span_s = max(hi - lo, 1e-12)
    devices: Dict[str, Dict[str, float]] = {}
    busy_total = 0.0
    for d, ivs in sorted(per_dev.items()):
        busy = sum(min(b, hi) - max(a, lo)
                   for a, b in _merge(ivs) if min(b, hi) > max(a, lo))
        busy_total += busy
        devices[str(d)] = {
            "busy_s": busy,
            "idle_s": span_s - busy,
            "idle_frac": max(0.0, 1.0 - busy / span_s),
            "n_solves": len(ivs),
        }
    n = len(per_dev)
    return {
        "devices": devices,
        "window_s": span_s,
        "busy_s": busy_total,
        "idle_s": n * span_s - busy_total,
        "idle_frac": max(0.0, 1.0 - busy_total / (n * span_s)),
    }


# -- the span-chain contract -----------------------------------------------

def check_span_chains(spans: Sequence[Span]) -> Dict[str, Any]:
    """Verify every completed request trace has a full span chain.

    A *completed* request is one whose ``request`` span ended without a
    ``cancelled``/``error`` attribute.  For each, require:

    * a ``queue.wait`` span in the same trace, parented to the request
      span, starting no earlier than it;
    * membership in a flush: the one the ``queue.wait`` span names (its
      ``flush`` attr), else the first ``flush.assemble`` span whose
      ``trace_ids`` list the trace.  The requests of one trace may sit
      in different flushes — a batch ``POST`` shares one trace id among
      LPs of different m-buckets — so each request is held against its
      own flush (the reference takes the trace's first flush for every
      request, which reports such requests as out of order);
    * that flush having ``flush.dispatch``, at least one
      ``device.solve``, and ``flush.scatter`` spans, ordered
      ``assemble.start <= dispatch.start <= solve.start <=
      solve.end <= scatter.end``.

    Returns ``{"complete": n, "problems": [...]}``; an empty problem
    list is the contract ``--assert-trace`` enforces.
    """
    spans = list(spans)
    by_trace: Dict[str, List[Span]] = {}
    for s in spans:
        by_trace.setdefault(s.trace_id, []).append(s)
    flushes: Dict[str, Dict[str, List[Span]]] = {}
    membership: Dict[str, List[str]] = {}
    for s in spans:
        fl = s.attrs.get("flush")
        if fl:
            flushes.setdefault(fl, {}).setdefault(s.name, []).append(s)
        if s.name == "flush.assemble":
            for tid in s.attrs.get("trace_ids", ()):
                membership.setdefault(tid, []).append(
                    s.attrs.get("flush", ""))
    problems: List[str] = []
    n_complete = 0
    for trace_id, ss in by_trace.items():
        reqs = [s for s in ss if s.name == "request"]
        if not reqs:
            continue    # flush-plane primary trace or rpc-only trace
        for req in reqs:
            if req.attrs.get("cancelled") or req.attrs.get("error"):
                continue
            n_complete += 1
            qs = [s for s in ss if s.name == "queue.wait"
                  and s.parent_id == req.span_id]
            if not qs:
                problems.append(
                    f"{trace_id}: no queue.wait child of request")
                continue
            q = qs[0]
            if q.t_start < req.t_start - 1e-6:
                problems.append(
                    f"{trace_id}: queue.wait starts before request")
            names = membership.get(trace_id, [])
            if not names:
                problems.append(
                    f"{trace_id}: no flush lists this trace")
                continue
            fl = q.attrs.get("flush") or names[0]
            if fl not in names:
                problems.append(
                    f"{trace_id}: flush {fl} does not list this trace")
                continue
            unit = flushes.get(fl, {})
            missing = [n for n in ("flush.assemble", "flush.dispatch",
                                   "device.solve", "flush.scatter")
                       if not unit.get(n)]
            if missing:
                problems.append(
                    f"{trace_id}: flush {fl} missing {missing}")
                continue
            asm = unit["flush.assemble"][0]
            disp = unit["flush.dispatch"][0]
            sca = unit["flush.scatter"][0]
            for dev in unit["device.solve"]:
                ordered = (asm.t_start <= disp.t_start + 1e-6
                           <= dev.t_start + 2e-6
                           and dev.t_end <= sca.t_end + 1e-6)
                if not ordered:
                    problems.append(
                        f"{trace_id}: flush {fl} spans out of order")
                    break
            if q.t_end > asm.t_end + 1e-6:
                problems.append(
                    f"{trace_id}: queue.wait ends after assemble ends")
    return {"complete": n_complete, "problems": problems,
            "traces": len(by_trace), "flushes": len(flushes)}
