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
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.lp import PAD_B
from repro_torch.core.packed import PackedLPBatch
from repro_torch.device import default_devices
from repro_torch.obs.profiler import annotation as _device_annotation
from repro_torch.serve_lp.buckets import ExecSpec
from repro_torch.serve_lp.mesh_layout import MeshLayout, plan_layout
from repro_torch.solver import solve_with_spec

# Opt-in per-launch NVTX range around each launch-group dispatch, so
# device-profiler timelines carry the same launch labels as the host-side
# device.solve spans.  Off by default: the annotation context costs a
# little per launch and is only useful while a profiler is recording.
_ANNOTATE_LAUNCHES = False


def set_launch_annotations(enabled: bool) -> None:
    """Enable/disable per-launch-group profiler annotations (the
    scheduler flips this on when its tracer was built with
    ``annotate_device=True``)."""
    global _ANNOTATE_LAUNCHES
    _ANNOTATE_LAUNCHES = bool(enabled)


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


def _dispatch_shard(solve, device: torch.device, L, c, mv):
    """Run one device's rows.  CPU: solve now, hand back numpy.  CUDA:
    enqueue copy-in, solve and copy-out on the device's stream and hand
    back ``(x_host, feas_host, event, keepalive)`` without waiting."""
    Lt, ct, mvt = (torch.from_numpy(a) for a in (L, c, mv))
    if device.type == "cpu":
        x, feas = solve(Lt, ct, mvt)
        return x.numpy(), feas.numpy(), None, None
    stream = _streams.get(device)
    with torch.cuda.device(device), torch.cuda.stream(stream):
        Ld = Lt.to(device, non_blocking=True)
        cd = ct.to(device, non_blocking=True)
        mvd = mvt.to(device, non_blocking=True)
        x, feas = solve(Ld, cd, mvd)
        x_h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        f_h = torch.empty(feas.shape, dtype=feas.dtype, pin_memory=True)
        x_h.copy_(x, non_blocking=True)
        f_h.copy_(feas, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    # The device tensors ride along in the handle so they outlive the
    # copies that read them; they were allocated on, and are only ever
    # used on, this stream, so freeing them later is safe.
    return x_h, f_h, event, (Ld, cd, mvd, x, feas)


def _build_mesh_executable(spec: ExecSpec, devices: List[torch.device],
                           solve) -> Executable:
    """Plan a :class:`MeshLayout` for the spec; one dispatch per
    :class:`LaunchGroup` (uneven layouts need at most two), one solve per
    member device on that device's stream, so launches on different
    devices overlap."""
    layout = plan_layout(spec.b_pad, spec.tile, len(devices))
    b_pad = spec.b_pad
    groups = layout.groups
    labels = tuple(
        f"launch d{g.start}+{g.n_devices} rows{g.rows} m{spec.bucket_m}"
        for g in groups)

    def dispatch_group(g, L, c, mv):
        out = []
        for k in range(g.n_devices):
            lo = g.offset + k * g.rows_per_device
            hi = lo + g.rows_per_device
            out.append(_dispatch_shard(solve, devices[g.start + k],
                                       L[lo:hi], c[lo:hi], mv[lo:hi]))
        return out

    def dispatch(L, c, mv):
        if L.shape[0] != layout.b_pad:
            L, c, mv = _pad_rows(L, c, mv, layout.b_pad)
        handles = []
        for g, label in zip(groups, labels):
            if _ANNOTATE_LAUNCHES:
                with _device_annotation(label):
                    handles.extend(dispatch_group(g, L, c, mv))
            else:
                handles.extend(dispatch_group(g, L, c, mv))
        return tuple(handles)

    def complete(handles):
        xs, fs = [], []
        for x_h, f_h, event, _keep in handles:
            if event is not None:
                event.synchronize()
                x_h, f_h = x_h.numpy(), f_h.numpy()
            xs.append(x_h)
            fs.append(f_h)
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
