"""Micro-batching scheduler: per-request submit/future API over the
batch solver.

Requests land in per-``bucket_m`` queues.  A queue flushes when it
reaches ``max_batch`` (size trigger, runs inline on the submitting
thread so a full batch never waits) or when its oldest request exceeds
``max_wait_s`` (wait trigger, run by a background timer thread started
via ``with scheduler:`` or :meth:`start`).  ``flush()`` drains
everything immediately — the deterministic path used by tests and
step-synchronous callers like the crowd simulation.

The serve loop is *pipelined*: a flush is three named stages instead of
one blocking call —

* **assemble** (:meth:`BatchScheduler._assemble`, on the flushing
  thread) — lease packed host buffers from the per-bucket
  :class:`_FlushBufferPool`, fill them directly in the SoA layout the
  device wants (one block ``L (b_pad, 4, bucket_m)`` with
  ``(a_x, a_y, b, 0)`` rows; no AoS intermediate, no device-side
  repack — ``core.pack_call_count`` stays flat; on a card the buffers
  are pinned, so the copy to the device is asynchronous), and fetch the
  cached
  :class:`~repro_torch.serve_lp.sharding.Executable` for the flush's
  :class:`~repro_torch.serve_lp.buckets.ExecSpec`;
* **dispatch** (:meth:`BatchScheduler._dispatch`, same thread) — hand
  the buffers to ``Executable.dispatch`` (async: enqueues copy-in,
  solve and copy-out on the device's stream and returns event handles
  without synchronizing) and enqueue an :class:`_InflightFlush`
  work unit.  Dispatch blocks while ``max_inflight`` flushes are
  already in flight (backpressure), which is what bounds device queue
  depth and lets the *next* flush's assembly overlap the in-flight
  solve;
* **complete** (the ``serve-lp-complete`` worker thread) — block on the
  handles (``Executable.complete``), return the leased buffers to the
  pool, record metrics, and scatter an :class:`LPResult` into every
  future in submission order.  ``_InflightFlush.done`` is the explicit
  per-unit join point; :meth:`drain` joins all of them.

``pipeline=False`` restores the stop-and-go loop (the three stages run
back-to-back on the flushing thread), which is still what you want for
strictly step-synchronous callers that flush and immediately wait.

Flushes shard over devices per the scheduler's ``sharding`` mode.
``"mesh"`` (the only mode ported; the reference's legacy ``"pmap"``
escape hatch is not) plans a
:class:`~repro_torch.serve_lp.mesh_layout.MeshLayout` per flush — uneven
per-device shards, planner-owned padding (the batch ladder unit is one
kernel ``tile``, not ``tile * n_devices``) and grouped launches.  Mesh
mode also enables **cross-bucket fusing** (``fuse=True``): buckets whose
queues are individually under the size trigger but jointly fill a
launch are drained into one *fused flush unit* — their requests packed
into a single super-batch padded to the largest member's ``m_pad``
(still a ladder value, so fused flushes reuse the same cached
executables), solved in one launch, and scattered back to each
request's own future.  Fusing fires on the submit path (joint-fill
trigger, reason ``"fused"``), in the wait-trigger sweep, and on manual
:meth:`flush`; the SLO controller can veto it per bucket via the
3-tuple bucket-policy form.

Failure discipline: a solve failure reaches every future of *its own*
flush via ``set_exception`` and never orphans another bucket — manual
and expired flushes isolate per-bucket errors and re-raise the first
one only after every drained bucket has been dispatched.  Completion
failures land on the flush's futures and in the
``ServeMetrics`` error counters (never silently swallowed).

Two per-flush costs are engineered away:

* *launch geometry* — specs with unset ``tile``/``chunk`` are pinned
  **per bucket shape** via
  :meth:`~repro_torch.solver.SolverSpec.resolve_for_shape` (explicit >
  measured tuning table > heuristic), so each bucket's executable runs
  the geometry measured best for its shape class;
* *host allocation* — the packed flush buffers come from a per-bucket
  :class:`_FlushBufferPool` and are reused across flushes (steady-state
  traffic on a stable bucket performs zero buffer allocations; the pool
  counts allocations so tests can assert it).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.lp import PAD_B
from repro_torch.device import default_devices
from repro_torch.kernels.batch_lp import LANE
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.obs.trace import (Span, TraceContext, Tracer,
                                   default_tracer, new_trace_context,
                                   reset_current_span, set_current_span)
from repro_torch.serve_lp.buckets import (SHARDING_MODES, ExecSpec,
                                    ExecutableCache, bucket_batch, bucket_m)
from repro_torch.serve_lp.metrics import ServeMetrics
from repro_torch.serve_lp.sharding import as_executable, build_executable
from repro_torch.solver import SolverSpec

# Default bound on concurrently in-flight flushes: two is enough to
# overlap assembly with an in-flight solve without letting the device
# queue (and tail latency) grow unboundedly.
DEFAULT_MAX_INFLIGHT = 2


def _try_set_result(fut: Future, value: Any) -> bool:
    """``fut.set_result(value)``, tolerating a concurrent cancel.

    The RPC layer cancels futures from the asyncio thread on deadline
    expiry while flush threads settle them; a ``done()`` pre-check only
    narrows that window.  Losing the race must skip *one* future — an
    ``InvalidStateError`` escaping here would abort the completion
    scatter mid-flush and orphan every later future of the flush."""
    if fut.done():
        return False
    try:
        fut.set_result(value)
        return True
    except InvalidStateError:
        return False


def _try_set_exception(fut: Future, exc: BaseException) -> bool:
    """``fut.set_exception(exc)`` with the same race tolerance as
    :func:`_try_set_result`."""
    if fut.done():
        return False
    try:
        fut.set_exception(exc)
        return True
    except InvalidStateError:
        return False


class _FlushBufferPool:
    """Reuse the host-side packed flush buffers across flushes.

    One flush needs ``L (b_pad, 4, bm)``, ``c (b_pad, 2)`` and
    ``mv (b_pad, 1)``; allocating them fresh per flush was the last
    per-flush cost on the serving hot path.  ``lease`` hands out a
    zeroed buffer set for a shape (reusing a previously returned one
    when available — steady-state traffic on a stable bucket allocates
    exactly once); ``release`` takes it back.  Concurrent flushes of
    the same shape (pipelined in-flight flushes, timer thread + inline
    size trigger) each get their own set; at most ``max_per_key`` sets
    are retained per shape.

    **Lifetime contract (pipelined serve loop).**  A leased buffer set
    stays leased until its flush *completes*, not merely until dispatch
    returns: dispatch is asynchronous, so the host-to-device copy of
    the buffers may still be in progress (or pending) when the
    dispatching thread moves on.  Only the completion stage — after
    ``Executable.complete`` has waited on the flush's events — may call
    :meth:`release`.

    ``pinned=True`` (what the scheduler passes when its devices are
    cards) allocates the buffers as page-locked tensors
    (``torch.empty(..., pin_memory=True)``) and hands out their
    ``.numpy()`` views, so assembly stays numpy while the copy to the
    device is a true asynchronous DMA.  (A view keeps its tensor alive.)
    """

    def __init__(self, max_per_key: int = 2, *, pinned: bool = False):
        self._free: Dict[tuple, List[tuple]] = {}
        self._lock = threading.Lock()
        self._max_per_key = max_per_key
        self.pinned = bool(pinned)
        self.alloc_count = 0   # fresh allocations (tests assert reuse)
        self.lease_count = 0
        self.release_count = 0  # lease_count - release_count = leased now

    def lease(self, b_pad: int, bm: int, dtype: np.dtype
              ) -> Tuple[tuple, tuple]:
        """Lease an initialized ``(L, c, mv)`` set for one flush shape;
        returns ``(key, bufs)`` — pass both back to :meth:`release`
        when (and only when) the flush has completed."""
        key = (b_pad, bm, np.dtype(dtype).str)
        with self._lock:
            self.lease_count += 1
            stack = self._free.get(key)
            bufs = stack.pop() if stack else None
            if bufs is None:
                self.alloc_count += 1
        if bufs is None:
            bufs = tuple(
                self._empty(shape, dt) for shape, dt in (
                    ((b_pad, 4, bm), dtype), ((b_pad, 2), dtype),
                    ((b_pad, 1), np.int32)))
        L, c, mv = bufs
        # Reset to the neutral flush background: padding columns and
        # problems must look exactly like freshly zeroed buffers.
        L.fill(0.0)
        L[:, 2, :] = PAD_B
        c[:, 0] = 1.0
        c[:, 1] = 0.0
        mv.fill(0)
        return key, bufs

    def _empty(self, shape: tuple, dtype) -> np.ndarray:
        if not self.pinned:
            return np.empty(shape, dtype)
        return torch.empty(shape, dtype=getattr(torch, np.dtype(dtype).name),
                           pin_memory=True).numpy()

    def release(self, key: tuple, bufs: tuple) -> None:
        """Return a leased set once its flush has fully completed."""
        with self._lock:
            self.release_count += 1
            stack = self._free.setdefault(key, [])
            if len(stack) < self._max_per_key:
                stack.append(bufs)


@dataclasses.dataclass(frozen=True)
class LPResult:
    """Per-request solve result delivered through the future."""

    x: np.ndarray        # (2,) argmax (garbage where infeasible)
    feasible: bool
    objective: float     # c @ x
    m: int               # the request's own constraint count
    bucket_m: int        # shape bucket it was solved in
    batch_size: int      # real requests fused into its flush
    latency_s: float     # submit -> result


@dataclasses.dataclass
class _Pending:
    """One queued request, already split into the packed row layout so
    a flush copies straight into the ``L`` block."""

    ax: np.ndarray       # (m,) constraint normal x-components
    ay: np.ndarray       # (m,) constraint normal y-components
    b: np.ndarray        # (m,) offsets
    c: np.ndarray        # (2,) objective
    m: int
    future: Future
    t_submit: float
    # Tracing (None when the scheduler's tracer is disabled): the
    # request's context, its open "request" span, and its open
    # "queue.wait" span.  Open spans are nulled once ended so no path
    # can commit one to the ring twice.
    trace: Optional[TraceContext] = None
    span: Any = None
    qspan: Any = None


@dataclasses.dataclass
class _InflightFlush:
    """One named in-flight flush work unit: everything the completion
    stage needs to finish a dispatched solve — the leased host buffers
    (returned to the pool only here), the device result handles, the
    futures to scatter into, and the stage timestamps the metrics
    report.  ``done`` is the unit's explicit join point (:meth:`
    BatchScheduler.drain` joins all units via the in-flight gauge)."""

    name: str                    # "flush-<seq> m<bucket>xb<b_pad>"
    bucket_m: int
    b_pad: int
    reqs: List[_Pending]
    reason: str
    exe: Any                     # dispatch/complete executable
    buf_key: tuple               # pool lease (returned at completion)
    bufs: tuple                  # (L, c, mv) host arrays
    t_assemble: float            # assembly start
    n_buckets: int = 1           # m-buckets fused into this unit
    t_assembled: float = 0.0     # assembly done (dispatch entered)
    t_dispatch: float = 0.0      # dispatch enqueued (device handed work)
    t_complete: float = 0.0      # device results materialized on host
    handle: Any = None           # in-flight device result handle
    counted: bool = False        # holds an in-flight slot (pipelined)
    # Tracing: flush-plane spans are emitted once per flush under the
    # *primary* trace (the submit span's for an inline flush, else the
    # first member request's); membership of every fused-in trace rides
    # on the flush.assemble span's trace_ids attr.  A flush assembled
    # while its tracer records keeps every span to its scatter.
    trace_id: Optional[str] = None
    asm_span: Any = None         # the flush.assemble span (parent link)
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event)


class BatchScheduler:
    """Accumulate single 2-D LPs into bucketed super-batches and solve.

    Parameters
    ----------
    spec:
        the :class:`~repro_torch.solver.SolverSpec` every flush solves with.
        It becomes part of each flush's :class:`ExecSpec` cache key, so
        two schedulers with different specs can never alias
        executables.  ``backend="auto"``/``interpret=None`` resolve
        against the platform of ``devices`` at construction (the m-bucket
        ladder depends on the backend, so auto cannot stay
        shape-dependent here — pass an explicit backend to choose);
        ``tile=None``/``chunk=None`` are pinned per bucket shape at
        flush time (measured tuning table first, then the backend's
        own default: see ``SolverSpec.resolve_for_shape``).
    method, tile, chunk, M, normalize, interpret:
        deprecated flag-bag alternative to ``spec`` (mapped onto an
        equivalent SolverSpec; passing both is an error).
    max_batch:
        size trigger — a bucket flushes as soon as it holds this many.
    max_wait_s:
        wait trigger — no request waits longer than this once the
        background thread is running.
    pipeline:
        overlap flush assembly with in-flight solves (default).  A
        flush's dispatch returns without synchronizing and a completion
        worker scatters results; ``False`` restores the stop-and-go
        loop where each flush blocks until its results are scattered.
    max_inflight:
        backpressure bound — a new dispatch blocks while this many
        flushes are already in flight (pipelined mode only).
    devices:
        list of :class:`torch.device` to shard flushes over; default
        every visible CUDA device (raises when there is none — pass
        ``[torch.device("cpu")]`` to serve on the CPU).  All devices
        must be of one type.
    sharding:
        flush-sharding mode — ``"mesh"`` (MeshLayout planner; uneven
        shards, planner-owned padding).  The reference's ``"pmap"``
        hatch is not ported and raises ``ValueError``.
    fuse:
        enable cross-bucket fused flush units.  Defaults to ``True``
        under mesh sharding.
    fuse_max_m_ratio:
        never fuse buckets whose ``m_pad`` differ by more than this
        factor — fusing an m=8 bucket into an m=4096 flush would burn
        more pad cells than the saved launch is worth.
    tracer:
        a :class:`repro_torch.obs.Tracer` to emit typed spans into
        (submit, request, queue.wait, flush.assemble/dispatch/scatter,
        the flush's solve and its stages, device.solve per launch
        group).  Default is the process default tracer
        (:func:`repro_torch.obs.default_tracer`), which records while a
        ``torch.profiler`` session records; otherwise a call site costs
        one flag read and no span is allocated.
    recorder:
        a :class:`repro_torch.obs.FlightRecorder`; when given, the scheduler
        binds :meth:`debug_state` as its state source, shares its
        tracer, and wires ``ServeMetrics.record_error`` plus a
        debounced post-flush p99 check to its triggers.
    """

    def __init__(
        self,
        spec: Optional[SolverSpec] = None,
        *,
        method: Optional[str] = None,
        max_batch: int = 256,
        max_wait_s: float = 0.005,
        tile: Optional[int] = None,
        chunk: Optional[int] = None,
        M: Optional[float] = None,
        normalize: Optional[bool] = None,
        interpret: Optional[bool] = None,
        pipeline: bool = True,
        max_inflight: int = DEFAULT_MAX_INFLIGHT,
        devices: Optional[Sequence] = None,
        metrics: Optional[ServeMetrics] = None,
        sharding: str = "mesh",
        fuse: Optional[bool] = None,
        fuse_max_m_ratio: float = 8.0,
        tracer: Optional[Tracer] = None,
        recorder: Optional[FlightRecorder] = None,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch={max_batch} < 1")
        if max_inflight < 1:
            raise ValueError(f"max_inflight={max_inflight} < 1")
        if sharding not in SHARDING_MODES:
            raise ValueError(
                f"sharding={sharding!r} not in {SHARDING_MODES}")
        if fuse_max_m_ratio < 1:
            raise ValueError(
                f"fuse_max_m_ratio={fuse_max_m_ratio} < 1")
        legacy = {k: v for k, v in dict(
            backend=method, tile=tile, chunk=chunk, M=M,
            normalize=normalize, interpret=interpret).items()
            if v is not None}
        if spec is None:
            spec = SolverSpec(**{"backend": "rgb", **legacy})
        elif legacy:
            raise TypeError(
                f"pass either spec= or legacy solver kwargs, not both "
                f"(got {sorted(legacy)})")
        elif not isinstance(spec, SolverSpec):
            raise TypeError(f"spec must be a SolverSpec, got "
                            f"{type(spec)!r}")
        self._devices = ([torch.device(d) for d in devices]
                         if devices is not None else default_devices())
        platforms = {d.type for d in self._devices}
        if len(platforms) != 1:
            raise ValueError(
                f"devices must be a non-empty list of one device type, "
                f"got {[str(d) for d in self._devices]}")
        self._platform = platforms.pop()
        spec = spec.resolve(self._platform)
        if spec.shuffle:
            # The spec-seeded shuffle permutes the *flushed super-batch*,
            # so a request's constraint order would depend on its row and
            # on b_pad — breaking the guarantee that scheduler round
            # trips are bit-identical to direct solves with the spec.
            raise ValueError(
                "BatchScheduler does not support shuffle=True specs: "
                "per-request results would depend on flush composition; "
                "pre-shuffle requests client-side if randomised order is "
                "needed")
        # tile/chunk left unset stay unset here: they are pinned *per
        # bucket shape* at flush time (resolve_for_shape: explicit >
        # tuning table > heuristic), so different buckets can run the
        # geometry measured best for their shape class.
        self.spec = spec
        # Request buffers are assembled host-side at the solve dtype, so
        # a float64 spec is not silently truncated to float32 on submit.
        self._dtype = np.dtype(spec.dtype)
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.pipeline = bool(pipeline)
        self.max_inflight = max_inflight
        self.sharding = sharding
        self.fuse = (sharding == "mesh") if fuse is None else bool(fuse)
        self.fuse_max_m_ratio = float(fuse_max_m_ratio)
        # Only the kernel backend takes LANE-multiple constraint counts;
        # the dense solvers bucket on a finer ladder so tiny LPs are not
        # padded 16x (crowd_sim submits m=8).
        self.bucket_base = LANE if spec.backend == "kernel" else 8
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self.tracer = tracer if tracer is not None else default_tracer()
        self.recorder = recorder
        if recorder is not None:
            recorder.bind_state(self.debug_state)
            if recorder.tracer is None:
                recorder.tracer = self.tracer
            self.metrics.set_error_hook(recorder.on_error)
        self.cache = ExecutableCache(
            lambda s: build_executable(s, self._devices))
        # Pinned host buffers on a card, so the copy in is asynchronous.
        self.buffers = _FlushBufferPool(pinned=self._platform == "cuda")
        self._queues: Dict[int, List[_Pending]] = {}
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._closed = False
        # Pipelined-flush state: the in-flight gauge (guarded by its
        # condition variable — dispatch backpressure and drain() both
        # wait on it), the completion work queue, and the lazily
        # started completion worker.  `_active` counts flushes in *any*
        # stage (assemble included, reserved while the queue pop is
        # still lock-held), which is what makes drain() a real join —
        # `_inflight` alone would miss a flush between pop and
        # dispatch.
        self._active = 0
        self._inflight = 0
        self._inflight_cv = threading.Condition()
        self._work_q: "queue.Queue[Optional[_InflightFlush]]" = \
            queue.Queue()
        self._completer: Optional[threading.Thread] = None
        self._flush_seq = 0
        # Optional per-bucket (max_batch, max_wait_s) override hook —
        # installed by the SLO controller so different m-buckets can
        # run different batching limits (a big-m flush takes longer, so
        # holding a p99 target means batching it less / flushing it
        # sooner).  None falls back to the scheduler-wide limits.
        self._bucket_policy: Optional[Any] = None

    # Legacy attribute views (pre-SolverSpec callers/reporting).
    @property
    def method(self) -> str:
        return self.spec.backend

    @property
    def tile(self) -> Optional[int]:
        """The spec's explicit tile; ``None`` when every bucket's flush
        pins its own (``_pin_for_bucket``)."""
        return self.spec.tile

    @property
    def chunk(self) -> int:
        return 0 if self.spec.chunk is None else self.spec.chunk

    @property
    def M(self) -> float:
        return self.spec.M

    @property
    def normalize(self) -> bool:
        return self.spec.normalize

    @property
    def interpret(self) -> bool:
        return self.spec.interpret

    @property
    def n_devices(self) -> int:
        return len(self._devices)

    @property
    def devices(self) -> List[torch.device]:
        """The devices flushes are sharded over."""
        return list(self._devices)

    @property
    def inflight(self) -> int:
        """Flushes currently dispatched but not yet completed."""
        with self._inflight_cv:
            return self._inflight

    @property
    def closed(self) -> bool:
        """True once :meth:`close` has begun (submissions refused)."""
        with self._lock:
            return self._closed

    def set_bucket_policy(
            self, policy: Optional[Any]) -> None:
        """Install (or clear) a per-bucket limits hook.

        ``policy(bucket_m)`` returns ``(max_batch, max_wait_s)`` or
        ``(max_batch, max_wait_s, allow_fuse)`` for that m-bucket, or
        ``None`` to fall back to the scheduler-wide limits.  The hook
        is consulted on the submit path (size trigger), by the
        wait-trigger sweep, and — via the optional third element — by
        the cross-bucket fuse planner (``allow_fuse=False`` keeps the
        bucket out of fused flush units).  The timer *tick* still
        derives from the scheduler-wide ``max_wait_s``, so callers
        installing shorter per-bucket waits should also lower that
        (the SLO controller does)."""
        self._bucket_policy = policy

    def _policy_for(self, bm: int) -> Optional[tuple]:
        """The raw policy tuple for one bucket, or None.  A broken
        policy must never take the serve loop down — it is counted and
        the globals apply."""
        policy = self._bucket_policy
        if policy is None:
            return None
        try:
            return policy(bm)
        except Exception as e:
            self.metrics.record_error(
                "bucket_policy",
                warn=f"serve_lp: bucket policy failed for "
                     f"bucket_m={bm} ({e!r}); using scheduler-wide "
                     "limits")
            return None

    def _limits_for(self, bm: int) -> Tuple[int, float]:
        """Effective (max_batch, max_wait_s) for one bucket: the policy
        hook when installed and opinionated, else the globals."""
        lim = self._policy_for(bm)
        if lim is not None:
            mb, mw = lim[0], lim[1]
            return max(1, int(mb)), float(mw)
        return self.max_batch, self.max_wait_s

    def _fuse_ok(self, bm: int) -> bool:
        """Whether the bucket policy allows this bucket in fused flush
        units (the optional third policy element; default yes)."""
        lim = self._policy_for(bm)
        if lim is None or len(lim) < 3:
            return True
        return bool(lim[2])

    def queue_age_s(self, now: Optional[float] = None) -> float:
        """Age of the oldest queued (not yet flushed) request, seconds;
        0.0 when every queue is empty.  The RPC admission layer sheds
        load on this — a growing oldest-age means flushes are not
        keeping up with arrivals."""
        if now is None:
            now = time.perf_counter()
        with self._lock:
            oldest = min((q[0].t_submit for q in self._queues.values()
                          if q), default=None)
        return 0.0 if oldest is None else max(0.0, now - oldest)

    def debug_state(self) -> Dict[str, Any]:
        """One JSON-serializable picture of the scheduler right now —
        what the flight recorder snapshots next to the span ring: queue
        depths per bucket, pipeline counters, buffer-pool leases, and
        the full metrics snapshot (per-device row counts included)."""
        now = time.perf_counter()
        with self._lock:
            queues = {int(bm): len(q)
                      for bm, q in self._queues.items() if q}
            oldest = min((q[0].t_submit
                          for q in self._queues.values() if q),
                         default=None)
            closed = self._closed
        with self._inflight_cv:
            active = self._active
            inflight = self._inflight
        bp = self.buffers
        return {
            "queues": queues,
            "pending": sum(queues.values()),
            "queue_age_s": (0.0 if oldest is None
                            else max(0.0, now - oldest)),
            "closed": closed,
            "active_flushes": active,
            "inflight": inflight,
            "max_inflight": self.max_inflight,
            "pipeline": self.pipeline,
            "sharding": self.sharding,
            "fuse": self.fuse,
            "n_devices": len(self._devices),
            "buffer_pool": {
                "alloc_count": bp.alloc_count,
                "lease_count": bp.lease_count,
                "release_count": bp.release_count,
                "leased_now": bp.lease_count - bp.release_count,
            },
            "metrics": self.metrics.snapshot(self.cache.stats()),
        }

    def _pin_for_bucket(self, bm: int, batch: int) -> SolverSpec:
        """The fully shape-resolved spec one bucket's flush runs with:
        explicit spec values win, then the measured tuning table at
        this bucket's shape class, then the backend's default.  The
        pinned tile is also the unit a flush's batch is padded to (the
        MeshLayout planner owns the per-device distribution)."""
        return self.spec.resolve_for_shape(bm, batch,
                                           platform=self._platform)

    # -- submission ------------------------------------------------------

    def submit(self, A, b, c, *,
               trace: Optional[TraceContext] = None) -> Future:
        """Submit one LP (A (m,2), b (m,), c (2,)); returns a Future
        resolving to :class:`LPResult`.  Buffers are kept at the spec's
        dtype and pre-split into packed rows.

        ``trace`` propagates an upstream :class:`TraceContext` (the RPC
        layer's parsed ``X-Trace-Id``); when the scheduler's tracer
        records and none is given, a fresh root context is generated
        here, so every traced request has a full span chain either
        way.  The call is then a ``submit`` span, the parent of the
        flush it runs inline (size or fuse trigger)."""
        tracer = self.tracer
        if not tracer.enabled:
            return self._submit(A, b, c, None, None)
        ctx = trace if trace is not None else new_trace_context()
        sub = tracer.start_span("submit", ctx.trace_id,
                                parent_id=ctx.span_id, twin=True)
        try:
            return self._submit(A, b, c, ctx, sub)
        finally:
            tracer.end(sub)

    def _submit(self, A, b, c, ctx: Optional[TraceContext],
                sub: Optional[Span]) -> Future:
        dt = self._dtype
        A = np.asarray(A, dt).reshape(-1, 2)
        m = A.shape[0]
        b = np.asarray(b, dt).reshape(m)
        c = np.asarray(c, dt).reshape(2)
        if m < 1:
            raise ValueError("LP needs at least one constraint")
        fut: Future = Future()
        req = _Pending(ax=np.ascontiguousarray(A[:, 0]),
                       ay=np.ascontiguousarray(A[:, 1]),
                       b=b, c=c, m=m, future=fut,
                       t_submit=time.perf_counter())
        bm = bucket_m(m, base=self.bucket_base)
        if ctx is not None:
            tracer = self.tracer
            req.trace = ctx
            req.span = tracer.start_span(
                "request", ctx.trace_id, parent_id=ctx.span_id,
                t_start=req.t_submit, bucket_m=bm, m=m)
            req.qspan = tracer.child(req.span, "queue.wait",
                                     t_start=req.t_submit, bucket_m=bm)
        self.metrics.touch_clock()
        ready = None
        fused = None
        with self._lock:
            # Closed-ness is decided under the same lock close() takes
            # *before* its final flush: a submit either loses the race
            # (raises here) or its request is visible to that flush —
            # no request can slip in after the final flush with no
            # timer thread left to serve it.
            if self._closed:
                raise RuntimeError("scheduler is closed")
            q = self._queues.setdefault(bm, [])
            q.append(req)
            if len(q) >= self._limits_for(bm)[0]:
                ready = self._queues.pop(bm)
                # Reserve the flush in the active count while the pop
                # is still lock-held, so a concurrent close()'s drain
                # cannot slip between pop and dispatch and miss it.
                with self._inflight_cv:
                    self._active += 1
            elif self.fuse:
                fused = self._pop_fused_locked()
                if fused is not None:
                    with self._inflight_cv:
                        self._active += 1
        if ready is not None:
            self._solve(bm, ready, reason="size", pre_counted=True,
                        parent=sub)
        elif fused is not None:
            self._solve_unit(fused, reason="fused", pre_counted=True,
                             parent=sub)
        return fut

    def _pop_fused_locked(self) -> Optional[List[Tuple[int, list]]]:
        """Joint-fill fuse trigger (call with ``_lock`` held): when
        several buckets are each under their size trigger but together
        fill a launch, pop them as one fused flush unit.

        Returns the popped ``[(bucket_m, reqs), ...]`` parts, or None
        when no fusable group of >= 2 buckets reaches ``max_batch``
        rows.  Grouping mirrors :meth:`_plan_units`: buckets sorted by
        ``m_pad``, split where the spread exceeds ``fuse_max_m_ratio``.
        """
        total = sum(len(q) for q in self._queues.values())
        if total < self.max_batch:
            return None
        cands = sorted(
            ((b, q) for b, q in self._queues.items()
             if q and self._fuse_ok(b)),
            key=lambda t: t[0])
        if len(cands) < 2:
            return None
        best: List[Tuple[int, list]] = []
        best_rows = 0
        cur: List[Tuple[int, list]] = []
        cur_rows = 0
        for b, q in cands:
            if cur and b > cur[0][0] * self.fuse_max_m_ratio:
                cur, cur_rows = [], 0
            cur.append((b, q))
            cur_rows += len(q)
            if len(cur) >= 2 and cur_rows > best_rows:
                best, best_rows = list(cur), cur_rows
        if best_rows < self.max_batch:
            return None
        for b, _ in best:
            self._queues.pop(b)
        return best

    def submit_many(self, As, bs, cs, m_valid=None) -> List[Future]:
        """Row-wise submit of stacked arrays (B, m, 2)/(B, m)/(B, 2);
        ``m_valid`` optionally trims each problem's constraint count."""
        As = np.asarray(As, self._dtype)
        bs = np.asarray(bs, self._dtype)
        cs = np.asarray(cs, self._dtype)
        B = As.shape[0]
        if m_valid is None:
            m_valid = np.full((B,), As.shape[1], np.int32)
        else:
            m_valid = np.asarray(m_valid, np.int32)
        return [self.submit(As[i, :m_valid[i]], bs[i, :m_valid[i]], cs[i])
                for i in range(B)]

    # -- flushing --------------------------------------------------------

    def flush(self) -> int:
        """Drain all buckets now (manual trigger); returns LPs solved
        (dispatched — use :meth:`drain` or the futures to wait for
        completion in pipelined mode).

        One unit's failure never orphans another's futures: every
        drained unit is dispatched regardless, each failure lands on
        its own flush's futures, and the first error is re-raised only
        after the loop.
        """
        with self._lock:
            drained = [(bm, q) for bm, q in self._queues.items() if q]
            self._queues = {}
        return self._solve_drained(drained, reason="manual")

    def _solve_drained(self, drained: List[Tuple[int, list]], *,
                       reason: str) -> int:
        """Dispatch already-popped buckets as flush units (fused where
        the planner allows), isolating per-unit errors."""
        n = 0
        first_err: Optional[BaseException] = None
        for parts in self._plan_units(drained):
            try:
                self._solve_unit(
                    parts,
                    reason="fused" if len(parts) > 1 else reason)
            except Exception as e:
                if first_err is None:
                    first_err = e
            n += sum(len(q) for _, q in parts)
        if first_err is not None:
            raise first_err
        return n

    def _plan_units(self, drained: List[Tuple[int, list]]
                    ) -> List[List[Tuple[int, list]]]:
        """Partition drained buckets into flush units.

        With fusing off (or one bucket) every bucket is its own unit —
        the pre-mesh behaviour.  Otherwise buckets that are underfull
        *and* policy-fusable are sorted by ``m_pad`` and greedily
        packed into fused units, closing a unit when the m-spread
        would exceed ``fuse_max_m_ratio`` (pad-cell waste) or the row
        count would exceed ``max_batch`` (keeps fused ``b_pad`` on the
        same ladder rungs normal flushes compile)."""
        if not self.fuse or len(drained) < 2:
            return [[(bm, q)] for bm, q in drained]
        singles: List[List[Tuple[int, list]]] = []
        cands: List[Tuple[int, list]] = []
        for bm, q in drained:
            if len(q) >= self._limits_for(bm)[0] or not self._fuse_ok(bm):
                singles.append([(bm, q)])
            else:
                cands.append((bm, q))
        cands.sort(key=lambda t: t[0])
        units: List[List[Tuple[int, list]]] = []
        cur: List[Tuple[int, list]] = []
        cur_rows = 0
        for bm, q in cands:
            if cur and (bm > cur[0][0] * self.fuse_max_m_ratio
                        or cur_rows + len(q) > self.max_batch):
                units.append(cur)
                cur, cur_rows = [], 0
            cur.append((bm, q))
            cur_rows += len(q)
        if cur:
            units.append(cur)
        return singles + units

    def pending(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._queues.values())

    def _flush_expired(self) -> None:
        now = time.perf_counter()
        with self._lock:
            expired = [
                (bm, q) for bm, q in self._queues.items()
                if q and now - q[0].t_submit >= self._limits_for(bm)[1]]
            for bm, _ in expired:
                self._queues.pop(bm)
        # Expired buckets fuse with each other when the planner allows:
        # wait-triggered flushes are underfull by definition, the exact
        # case fused units exist for.
        self._solve_drained(expired, reason="wait")

    # -- background wait-trigger thread ----------------------------------

    def start(self) -> "BatchScheduler":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._timer_loop, name="serve-lp-flush", daemon=True)
            self._thread.start()
        return self

    def stop(self, *, final_flush: bool = True) -> None:
        """Stop the timer thread, optionally flush the tail, and join
        every in-flight flush (quiescent on return).

        A drain that times out is surfaced (not swallowed): it is
        counted as a ``drain_timeout`` error in :class:`ServeMetrics`
        and warned once — callers that need the boolean call
        :meth:`drain` themselves."""
        if self._thread is not None:
            self._stop.set()
            self._thread.join()
            self._thread = None
        if final_flush:
            self.flush()
        if not self.drain():
            self.metrics.record_error(
                "drain_timeout",
                warn="serve_lp: stop() timed out draining in-flight "
                     "flushes; some futures may still be pending "
                     "(counted in ServeMetrics errors)")

    def drain(self, timeout: Optional[float] = 600.0) -> bool:
        """Join point: block until every flush in any stage (assemble,
        dispatch, in flight) has completed or failed.  Returns ``True``
        when fully drained; ``False`` when the timeout expired with
        flushes still active (never silently — callers that would
        otherwise treat a timed-out drain as quiescence must check)."""
        with self._inflight_cv:
            return bool(self._inflight_cv.wait_for(
                lambda: self._active == 0, timeout=timeout))

    def __enter__(self) -> "BatchScheduler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def close(self) -> None:
        """Permanently shut down: refuse new submissions, flush and
        resolve everything already queued, join in-flight flushes and
        stop the worker threads.

        ``_closed`` is set under ``_lock`` *before* the final flush so
        a concurrent :meth:`submit` either raises or its request is
        caught by that flush — it can never enqueue after the final
        flush with no timer thread left to serve it.
        """
        with self._lock:
            self._closed = True
        self.stop()
        self._stop_completer()

    def _timer_loop(self) -> None:
        tick = max(self.max_wait_s / 4.0, 1e-4)
        while not self._stop.wait(tick):
            try:
                self._flush_expired()
            except Exception as e:
                # The flush's futures already carry the exception; the
                # timer must survive so later buckets still get
                # flushed.  But never silently: count it (surfaced in
                # snapshot()/format_report()) and warn once.
                self.metrics.record_error(
                    "timer_flush",
                    warn=f"serve_lp: background flush failed ({e!r}); "
                         "the failing flush's futures carry the "
                         "exception and the timer thread is still "
                         "running (counted in ServeMetrics errors)")

    # -- the pipelined solve path ----------------------------------------

    def _solve(self, bm: int, reqs: List[_Pending], *, reason: str,
               pre_counted: bool = False,
               parent: Optional[Span] = None) -> None:
        """Flush one bucket (the single-bucket unit)."""
        self._solve_unit([(bm, reqs)], reason=reason,
                         pre_counted=pre_counted, parent=parent)

    def _solve_unit(self, parts: List[Tuple[int, List[_Pending]]], *,
                    reason: str, pre_counted: bool = False,
                    parent: Optional[Span] = None) -> None:
        """Flush one unit — one bucket, or several fused: assemble,
        dispatch and — pipelined — hand completion to the worker.  A
        fused unit solves every member's requests in a single
        super-batch padded to the largest member's ``m_pad`` (the
        per-problem results are bit-identical either way — padding
        columns are neutral).  Errors on the assemble/dispatch path
        reach every future of this unit and re-raise.

        Requests whose future was cancelled while queued (deadline
        expiry in the RPC layer) are dropped here — expired work is
        cancelled instead of solved; a unit that cancels down to
        nothing is skipped entirely.  Surviving futures are *claimed*
        (``set_running_or_notify_cancel``) so a later ``cancel()`` from
        another thread returns False instead of racing the completion
        scatter.  ``parent`` is the ``submit`` span of an inline flush."""
        tracer = self.tracer
        live: List[Tuple[int, List[_Pending]]] = []
        for bm_i, q in parts:
            kept: List[_Pending] = []
            for r in q:
                if r.future.set_running_or_notify_cancel():
                    kept.append(r)
                elif r.span is not None:
                    tracer.end(r.qspan, cancelled=True)
                    tracer.end(r.span, cancelled=True)
                    r.qspan = r.span = None
            if kept:
                live.append((bm_i, kept))
        if not live:
            if pre_counted:
                with self._inflight_cv:
                    self._active -= 1
                    self._inflight_cv.notify_all()
            return
        bm = max(bm_i for bm_i, _ in live)
        reqs = [r for _, q in live for r in q]
        if not pre_counted:
            with self._inflight_cv:
                self._active += 1
        try:
            unit = self._assemble(bm, reqs, reason,
                                  n_buckets=len(live), parent=parent)
            self._dispatch(unit)
        except Exception as e:  # propagate to every waiter, don't hang
            with self._inflight_cv:
                self._active -= 1
                self._inflight_cv.notify_all()
            for r in reqs:
                _try_set_exception(r.future, e)
                if r.span is not None:
                    tracer.end(r.qspan, error=type(e).__name__)
                    tracer.end(r.span, error=type(e).__name__)
                    r.qspan = r.span = None
            raise
        if not self.pipeline:
            err = self._complete_unit(unit)
            if err is not None:
                raise err

    def _assemble(self, bm: int, reqs: List[_Pending],
                  reason: str, n_buckets: int = 1,
                  parent: Optional[Span] = None) -> _InflightFlush:
        """Host-side stage: lease packed buffers, fill them directly in
        the SoA layout (neutral columns/problems are a_x = a_y = 0,
        b = PAD_B, c = (1, 0), m_valid = 0 — no AoS intermediate, no
        device-side re-stack) and resolve the executable.  While the
        tracer records it is a ``flush.assemble`` span: under
        ``parent`` (an inline flush's ``submit`` span) when given, else
        under the first traced request's ``request`` span, else the root
        of a new trace."""
        B = len(reqs)
        pinned = self._pin_for_bucket(bm, B)
        b_pad = bucket_batch(B, pinned.tile)
        spec = ExecSpec(bucket_m=bm, b_pad=b_pad, solver=pinned,
                        n_devices=len(self._devices),
                        sharding=self.sharding)
        # The flush is named before any work so its queue.wait /
        # flush.* spans can carry the name from the start.
        with self._lock:
            self._flush_seq += 1
            seq = self._flush_seq
        name = f"flush-{seq} m{bm}xb{b_pad}"
        tracer = self.tracer
        trace_id = None
        asm_span = None
        if tracer.enabled:
            if parent is not None:
                trace_id, parent_id = parent.trace_id, parent.span_id
            else:
                primary = next(
                    (r for r in reqs if r.trace is not None), None)
                trace_id = (primary.trace if primary is not None
                            else new_trace_context()).trace_id
                parent_id = (primary.span.span_id
                             if primary is not None
                             and primary.span is not None else None)
            asm_span = tracer.start_span(
                "flush.assemble", trace_id, parent_id=parent_id,
                twin=True, flush=name, bucket_m=bm,
                b_pad=b_pad, n_real=B, n_buckets=n_buckets, reason=reason,
                trace_ids=tuple(r.trace.trace_id for r in reqs
                                if r.trace is not None))
            if asm_span is None:
                trace_id = None
        t0 = (asm_span.t_start if asm_span is not None
              else time.perf_counter())
        for r in reqs:
            if r.qspan is not None:
                tracer.end(r.qspan, t_end=t0, flush=name)
                r.qspan = None
        self.metrics.record_queue_waits(
            [(t0 - r.t_submit,
              r.trace.trace_id if r.trace is not None else None)
             for r in reqs])
        key, bufs = self.buffers.lease(b_pad, bm, self._dtype)
        try:
            L, c, mv = bufs
            for i, r in enumerate(reqs):
                L[i, 0, :r.m] = r.ax
                L[i, 1, :r.m] = r.ay
                L[i, 2, :r.m] = r.b
                c[i] = r.c
                mv[i, 0] = r.m
            exe = as_executable(self.cache.get(spec))
        except Exception as e:
            self.buffers.release(key, bufs)
            tracer.end(asm_span, error=type(e).__name__)
            raise
        tracer.end(asm_span)
        return _InflightFlush(
            name=name, bucket_m=bm, b_pad=b_pad,
            reqs=reqs, reason=reason, exe=exe, buf_key=key, bufs=bufs,
            t_assemble=t0, n_buckets=n_buckets,
            trace_id=trace_id, asm_span=asm_span)

    def _dispatch(self, unit: _InflightFlush) -> None:
        """Async stage: reserve an in-flight slot (backpressure — blocks
        while ``max_inflight`` flushes are in flight), enqueue the solve
        on the device and hand the unit to the completion worker.  In a
        traced flush it is a ``flush.dispatch`` span, with the time
        blocked on ``max_inflight`` as ``inflight_wait_ms``; the solve it
        enqueues records its spans under it, and its stages on the stream
        are timed with CUDA events."""
        tracer = self.tracer
        unit.t_assembled = t0 = time.perf_counter()
        # Covers backpressure wait + the async dispatch call; the
        # device.solve span then starts where this one ends.
        dspan = tracer.child(unit.asm_span, "flush.dispatch", t_start=t0,
                             twin=True, flush=unit.name,
                             bucket_m=unit.bucket_m)
        if self.pipeline:
            with self._inflight_cv:
                self._inflight_cv.wait_for(
                    lambda: self._inflight < self.max_inflight)
                self._inflight += 1
                unit.counted = True
        t_slot = time.perf_counter()
        L, c, mv = unit.bufs
        token = set_current_span(dspan) if dspan is not None else None
        try:
            unit.handle = unit.exe.dispatch(L, c, mv)
        except Exception as e:
            self._release_slot(unit)
            self.buffers.release(unit.buf_key, unit.bufs)
            tracer.end(dspan, error=type(e).__name__)
            raise
        finally:
            if token is not None:
                reset_current_span(token)
        unit.t_dispatch = time.perf_counter()
        tracer.end(dspan, t_end=unit.t_dispatch,
                   launches=getattr(unit.exe, "n_launches", 1),
                   inflight_wait_ms=(t_slot - t0) * 1e3)
        self.metrics.record_dispatch()
        if self.pipeline:
            self._ensure_completer()
            self._work_q.put(unit)

    def _release_slot(self, unit: _InflightFlush) -> None:
        if unit.counted:
            with self._inflight_cv:
                self._inflight -= 1
                self._inflight_cv.notify_all()
            unit.counted = False

    def _ensure_completer(self) -> None:
        t = self._completer
        if t is not None and t.is_alive():
            return
        with self._lock:
            if self._completer is None or not self._completer.is_alive():
                self._completer = threading.Thread(
                    target=self._completion_loop,
                    name="serve-lp-complete", daemon=True)
                self._completer.start()

    def _stop_completer(self) -> None:
        t = self._completer
        if t is not None and t.is_alive():
            self._work_q.put(None)
            t.join()
        self._completer = None

    def _completion_loop(self) -> None:
        """The completion worker: finish dispatched flushes in dispatch
        order, off the submit/assembly path."""
        while True:
            unit = self._work_q.get()
            if unit is None:
                return
            try:
                self._complete_unit(unit)
            except Exception as e:   # must never die mid-queue
                self.metrics.record_error(
                    "completion_worker",
                    warn=f"serve_lp: completion worker error {e!r}")

    def _complete_unit(self, unit: _InflightFlush
                       ) -> Optional[BaseException]:
        """Join stage: block on the device results, return the leased
        buffers (safe only now — see :class:`_FlushBufferPool`), record
        metrics, scatter futures.  Returns the solve error, if any,
        instead of raising (the sync path re-raises it; the worker
        routes it to futures + error counters)."""
        err: Optional[BaseException] = None
        x = feas = None
        try:
            x, feas = unit.exe.complete(unit.handle)
        except Exception as e:
            err = e
        unit.t_complete = time.perf_counter()
        tracer = self.tracer
        sspan = tracer.child(unit.asm_span, "flush.scatter", twin=True,
                             flush=unit.name, bucket_m=unit.bucket_m)
        timing = getattr(unit.handle, "timing", None)
        unit.handle = None
        # Device is synchronized (or dead): the host buffers are free.
        self.buffers.release(unit.buf_key, unit.bufs)
        self._release_slot(unit)
        with self._inflight_cv:
            self._active -= 1
            self._inflight_cv.notify_all()
        self.metrics.record_complete()
        if unit.asm_span is not None:
            # One device.solve span per launch group, reconstructed
            # from the host-observed dispatch -> complete window (the
            # device service interval the union/idle math runs on).
            self._record_device_spans(unit, timing)
        if err is not None:
            # Order matters: commit the errored spans, fire the flight
            # recorder (via the record_error hook) so its snapshot holds
            # them as evidence, and only then settle the futures — a
            # caller woken by its future sees evidence fully captured.
            for r in unit.reqs:
                if r.span is not None:
                    tracer.end(r.span, error=type(err).__name__,
                               flush=unit.name)
                    r.span = None
            tracer.end(sspan, error=type(err).__name__)
            if self.pipeline:
                self.metrics.record_error(
                    "solve",
                    warn=f"serve_lp: {unit.name} failed ({err!r}); its "
                         "futures carry the exception")
            for r in unit.reqs:
                _try_set_exception(r.future, err)
            unit.done.set()
            return err
        B = len(unit.reqs)
        now = time.perf_counter()
        # Metrics before the scatter: a caller woken by future.result()
        # observes a fully consistent snapshot (flush counted, buffers
        # back in the pool, in-flight gauge decremented).  The flush's
        # futures were claimed in _solve, so a concurrent cancel can no
        # longer settle them — and the scatter below tolerates a lost
        # settle race anyway rather than orphaning the rest of the
        # flush.
        for r in unit.reqs:
            if not r.future.done():
                self.metrics.record_latency(
                    now - r.t_submit,
                    trace_id=(r.trace.trace_id
                              if r.trace is not None else None))
        self.metrics.record_flush(
            n_real=B, b_pad=unit.b_pad, bucket_m=unit.bucket_m,
            sum_m=sum(r.m for r in unit.reqs),
            solve_seconds=unit.t_complete - unit.t_dispatch,
            assemble_seconds=unit.t_assembled - unit.t_assemble,
            dispatch_seconds=unit.t_dispatch - unit.t_assembled,
            reason=unit.reason,
            n_buckets=unit.n_buckets,
            launches=getattr(unit.exe, "n_launches", 1),
            shards=getattr(unit.exe, "shards", ()),
            trace_id=unit.trace_id)
        if self.recorder is not None:
            self.recorder.maybe_check_p99(
                lambda: self.metrics.percentile(99.0))
        for i, r in enumerate(unit.reqs):
            if r.future.done():
                if r.span is not None:
                    tracer.end(r.span, t_end=now, flush=unit.name,
                               dropped=True)
                    r.span = None
                continue
            xi = np.asarray(x[i])
            _try_set_result(r.future, LPResult(
                x=xi,
                feasible=bool(feas[i]),
                objective=float(r.c @ xi),
                m=r.m,
                bucket_m=unit.bucket_m,
                batch_size=B,
                latency_s=now - r.t_submit,
            ))
            if r.span is not None:
                tracer.end(r.span, t_end=now, flush=unit.name,
                           feasible=bool(feas[i]))
                r.span = None
        tracer.end(sspan)
        unit.done.set()
        return None

    def _record_device_spans(self, unit: _InflightFlush,
                             timing: Optional[List[Dict[str, float]]]
                             ) -> None:
        """Emit per-launch-group ``device.solve`` spans for one
        completed flush: mesh executables get one span per
        :class:`~repro_torch.serve_lp.mesh_layout.LaunchGroup` (its device
        indices and row geometry as attrs); injected executables
        without a layout get a single span over every participating
        device.

        A span's bounds are the host's window from the dispatch's return
        to the completion observed (it holds the device's work and may
        run past it).  On a card, the dispatch of a traced flush is timed
        with CUDA events on its stream, and the span carries
        ``enqueue_ms`` (copy-in start to copy-out end), ``copy_in_ms``,
        ``solve_enqueue_ms``, ``copy_out_ms`` and ``waited_ms`` (the
        completion blocked on the device), each the largest over the
        group's shards.  The stream waits on the host between the solve's
        eager launches, so these time the enqueue, not the device's work
        (:mod:`repro_torch.serve_lp.sharding`)."""
        layout = getattr(unit.exe, "layout", None)
        groups = getattr(layout, "groups", ()) if layout is not None \
            else ()
        if groups:
            k = 0
            for g in groups:
                self._device_span(
                    unit, _group_timing(timing, k, g.n_devices),
                    devices=g.device_indices,
                    rows_per_device=g.rows_per_device, rows=g.rows)
                k += g.n_devices
            return
        shards = tuple(getattr(unit.exe, "shards", ()) or ())
        devices = (tuple(i for i, s in enumerate(shards) if s)
                   or tuple(range(len(self._devices))))
        self._device_span(
            unit, _group_timing(timing, 0, len(timing or ())),
            devices=devices,
            rows=int(sum(shards)) if shards else unit.b_pad)

    def _device_span(self, unit: _InflightFlush,
                     times: Dict[str, float], **attrs: Any) -> None:
        span = self.tracer.child(
            unit.asm_span, "device.solve", t_start=unit.t_dispatch,
            flush=unit.name, bucket_m=unit.bucket_m, **attrs, **times)
        self.tracer.end(span, t_end=unit.t_complete)


def _group_timing(timing: Optional[List[Dict[str, float]]], lo: int,
                  n: int) -> Dict[str, float]:
    """The largest of each device time over shards ``lo .. lo + n`` (a
    launch group's devices run side by side); empty when untimed."""
    part = (timing or [])[lo:lo + n]
    if not part:
        return {}
    return {k: max(t[k] for t in part) for k in part[0]}
