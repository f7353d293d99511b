"""Building executables: one ExecSpec -> one dispatch/complete Executable.

A :class:`~repro_torch.serve_lp.mesh_layout.MeshLayout` plans per-device
row counts for the flushed super-batch (uneven shards allowed; unused
devices get zero rows).  The planner owns padding: ``b_pad`` only needs
to be positive — rows are padded with neutral LPs up to whole kernel
tiles here, never up to ``tile * n_devices`` blocks, so a prime-sized
flush on 4 devices is legal.

Built executables are *two-stage* so the serve loop can pipeline:

* :meth:`Executable.dispatch` takes the scheduler's packed host buffers
  ``(L (B, 4, m), c (B, 2), mv (B, 1))`` (numpy views of pinned memory
  when the devices are cards) already padded to the spec's shapes.  For
  every launch group and every device of it, on that device's own
  stream, it enqueues a ``non_blocking`` host-to-device copy of the
  device's rows, the solve, a device-to-host copy into pinned output
  buffers, and records a :class:`torch.cuda.Event`.  It returns the
  in-flight handle without synchronising.
* :meth:`Executable.complete` waits on those **events** (the completion
  worker is another thread: current device and stream are thread-local,
  an event is not) and returns host numpy ``(x (B, 2), feasible (B,)
  bool)`` — the scheduler's completion worker scatters those rows
  straight into per-request futures.

A dispatch under a recorded span (a traced flush's ``flush.dispatch``,
:func:`repro_torch.obs.trace.current_span`) is *timed*: four timing events
a shard on its stream, at copy-in start, after the copy in, after the
solve and after the copy out, and ``complete`` leaves the intervals
between them and its own wait on the last in the handle's ``timing``.
An interval on the stream is the longer of the host's enqueue of its work
and the device's run of it: a flush's solve is ~25 eager launches that
the host issues slower than the device runs them, so its intervals time
the enqueue, not the device's work.  Any other dispatch records one
untimed event a shard.

On CPU devices (the tests) the solve runs synchronously at dispatch and
``complete`` only concatenates.

Calling the executable like a function composes the two stages
synchronously.  Nothing is donated: PyTorch has no counterpart of XLA's
input buffer donation, the device-side copies are freed to the caching
allocator when the handle is dropped.

The solve wraps the packed block in a
:class:`~repro_torch.core.packed.PackedLPBatch` view (no repack) and runs
the same :func:`repro_torch.solver.solve_with_spec` core as every other
entry point.  Because every problem row is independent, per-problem
results do not depend on which device solved them — sharding is pure
layout.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.lp import PAD_B
from repro_torch.core.packed import PackedLPBatch
from repro_torch.device import default_devices
from repro_torch.obs.trace import current_span
from repro_torch.serve_lp.buckets import ExecSpec
from repro_torch.serve_lp.mesh_layout import MeshLayout, plan_layout
from repro_torch.solver import solve_with_spec

def _make_solve(spec: ExecSpec) -> Callable:
    """The per-shard solve as a function of the packed tensors — the
    same :func:`repro_torch.solver.solve_with_spec` core every other
    entry point runs through, so scheduler round-trips stay
    bit-identical to direct solves with the same spec."""

    def solve(L, c, mv):
        sol = solve_with_spec(spec.solver,
                              PackedLPBatch(L=L, c=c, m_valid=mv))
        return sol.x, sol.feasible

    return solve


class Executable:
    """A built flush solver split into dispatch and complete stages.

    ``dispatch(L, c, mv)`` enqueues the solve and returns an opaque
    handle without synchronizing; ``complete(handle)`` blocks until the
    device is done and returns host numpy ``(x, feasible)``.  The
    object is also callable — ``exe(L, c, mv)`` is the synchronous
    composition of the two stages.

    ``layout`` is the :class:`MeshLayout` the executable was planned
    with (``None`` for injected executables); ``shards``/``n_launches``
    expose the per-device row counts and launch-group count for metrics.
    """

    __slots__ = ("_dispatch", "_complete", "layout")

    def __init__(self, dispatch: Callable, complete: Callable, *,
                 layout: Optional[MeshLayout] = None):
        self._dispatch = dispatch
        self._complete = complete
        self.layout = layout

    @property
    def shards(self) -> Tuple[int, ...]:
        return self.layout.shards if self.layout is not None else ()

    @property
    def n_launches(self) -> int:
        return self.layout.n_launches if self.layout is not None else 1

    def dispatch(self, L, c, mv) -> Any:
        """Enqueue the solve; returns the in-flight result handle."""
        return self._dispatch(L, c, mv)

    def complete(self, handle) -> Tuple[np.ndarray, np.ndarray]:
        """Block until ``handle``'s solve finishes; host ``(x, feas)``."""
        return self._complete(handle)

    def __call__(self, L, c, mv) -> Tuple[np.ndarray, np.ndarray]:
        return self.complete(self.dispatch(L, c, mv))


def as_executable(fn) -> Executable:
    """Adapt a plain synchronous callable to the dispatch/complete
    protocol: its whole solve runs at dispatch time and ``complete`` is
    the identity.  Objects already exposing ``dispatch``/``complete``
    (built :class:`Executable`\\ s, test doubles) pass through unchanged,
    so injected caches keep working in the pipelined serve loop."""
    if hasattr(fn, "dispatch") and hasattr(fn, "complete"):
        return fn
    return Executable(fn, lambda handle: handle)


def _pad_rows(L, c, mv, b_pad: int):
    """Extend host buffers with neutral LPs (always-feasible, m_valid=0)
    up to ``b_pad`` rows — the planner-owned padding for flush sizes
    that are not whole-tile multiples."""
    n = b_pad - L.shape[0]
    if n <= 0:
        return L, c, mv
    Lp = np.zeros((n,) + L.shape[1:], dtype=L.dtype)
    Lp[:, 2, :] = PAD_B
    cp = np.zeros((n, 2), dtype=c.dtype)
    cp[:, 0] = 1.0
    mvp = np.zeros((n, 1), dtype=mv.dtype)
    return (np.concatenate([L, Lp]), np.concatenate([c, cp]),
            np.concatenate([mv, mvp]))


class _DeviceStreams:
    """One side stream per CUDA device, created on first use and shared
    by every executable of the process: flushes on one device queue in
    order on its stream, flushes on different devices overlap."""

    def __init__(self):
        self._lock = threading.Lock()
        self._streams: Dict[torch.device, "torch.cuda.Stream"] = {}

    def get(self, device: torch.device) -> "torch.cuda.Stream":
        with self._lock:
            s = self._streams.get(device)
            if s is None:
                s = self._streams[device] = torch.cuda.Stream(device=device)
            return s


_streams = _DeviceStreams()


class FlushHandle:
    """One dispatched flush: a ``(x_host, feas_host, event, keepalive,
    timing_events)`` tuple a shard, in launch-group order.  After
    :meth:`Executable.complete` of a timed dispatch, ``timing`` holds a
    dict a shard, each interval between its CUDA events on the stream
    (the longer of the host's enqueue and the device's run):
    ``enqueue_ms`` (copy-in start to copy-out end), ``copy_in_ms``,
    ``solve_enqueue_ms``, ``copy_out_ms``; and ``waited_ms`` (the host
    blocked on the shard's last event)."""

    __slots__ = ("shards", "timing")

    def __init__(self, shards: list):
        self.shards = shards
        self.timing: Optional[List[Dict[str, float]]] = None


def _dispatch_shard(solve, device: torch.device, L, c, mv, timed: bool):
    """Run one device's rows.  CPU: solve now, hand back numpy.  CUDA:
    enqueue copy-in, solve and copy-out on the device's stream and hand
    back ``(x_host, feas_host, event, keepalive, timing_events)`` without
    waiting; ``timed``: four timing events around the stages (the last is
    ``event``), else one untimed event and ``None``."""
    Lt, ct, mvt = (torch.from_numpy(a) for a in (L, c, mv))
    if device.type == "cpu":
        x, feas = solve(Lt, ct, mvt)
        return x.numpy(), feas.numpy(), None, None, None
    stream = _streams.get(device)
    evs = None
    with torch.cuda.device(device), torch.cuda.stream(stream):
        if timed:
            evs = tuple(torch.cuda.Event(enable_timing=True)
                        for _ in range(4))
            evs[0].record(stream)
        Ld = Lt.to(device, non_blocking=True)
        cd = ct.to(device, non_blocking=True)
        mvd = mvt.to(device, non_blocking=True)
        if timed:
            evs[1].record(stream)
        x, feas = solve(Ld, cd, mvd)
        if timed:
            evs[2].record(stream)
        x_h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        f_h = torch.empty(feas.shape, dtype=feas.dtype, pin_memory=True)
        x_h.copy_(x, non_blocking=True)
        f_h.copy_(feas, non_blocking=True)
        event = evs[3] if timed else torch.cuda.Event()
        event.record(stream)
    # The device tensors ride along in the handle so they outlive the
    # copies that read them; they were allocated on, and are only ever
    # used on, this stream, so freeing them later is safe.
    return x_h, f_h, event, (Ld, cd, mvd, x, feas), evs


def _shard_timing(evs, waited_s: float) -> Dict[str, float]:
    return {"enqueue_ms": evs[0].elapsed_time(evs[3]),
            "copy_in_ms": evs[0].elapsed_time(evs[1]),
            "solve_enqueue_ms": evs[1].elapsed_time(evs[2]),
            "copy_out_ms": evs[2].elapsed_time(evs[3]),
            "waited_ms": waited_s * 1e3}


def _build_mesh_executable(spec: ExecSpec, devices: List[torch.device],
                           solve) -> Executable:
    """Plan a :class:`MeshLayout` for the spec; one dispatch per
    :class:`LaunchGroup` (uneven layouts need at most two), one solve per
    member device on that device's stream, so launches on different
    devices overlap."""
    layout = plan_layout(spec.b_pad, spec.tile, len(devices))
    b_pad = spec.b_pad
    groups = layout.groups

    def dispatch(L, c, mv):
        if L.shape[0] != layout.b_pad:
            L, c, mv = _pad_rows(L, c, mv, layout.b_pad)
        timed = current_span() is not None
        shards = []
        for g in groups:
            for k in range(g.n_devices):
                lo = g.offset + k * g.rows_per_device
                hi = lo + g.rows_per_device
                shards.append(_dispatch_shard(
                    solve, devices[g.start + k], L[lo:hi], c[lo:hi],
                    mv[lo:hi], timed))
        return FlushHandle(shards)

    def complete(handle):
        xs, fs = [], []
        timing = []
        for x_h, f_h, event, _keep, evs in handle.shards:
            if event is not None:
                t = time.perf_counter() if evs is not None else 0.0
                event.synchronize()
                if evs is not None:
                    timing.append(
                        _shard_timing(evs, time.perf_counter() - t))
                x_h, f_h = x_h.numpy(), f_h.numpy()
            xs.append(x_h)
            fs.append(f_h)
        if timing:
            handle.timing = timing
        x = xs[0] if len(xs) == 1 else np.concatenate(xs)
        feas = fs[0] if len(fs) == 1 else np.concatenate(fs)
        return x[:b_pad], feas[:b_pad]

    return Executable(dispatch, complete, layout=layout)


def build_executable(
    spec: ExecSpec,
    devices: Optional[Sequence[torch.device]] = None,
) -> Executable:
    """Build the solver for one spec.  ``devices`` defaults to every
    visible CUDA device (:func:`repro_torch.device.default_devices`,
    which raises when there is none); pass ``[torch.device("cpu")]`` to
    run on the CPU."""
    devices = ([torch.device(d) for d in devices] if devices is not None
               else default_devices())
    if len(devices) != spec.n_devices:
        raise ValueError(
            f"spec.n_devices={spec.n_devices} != len(devices)="
            f"{len(devices)}")
    return _build_mesh_executable(spec, devices, _make_solve(spec))
