"""`Solver` — a reusable executor for one :class:`SolverSpec` on one device.

``spec.build()`` resolves ``"auto"`` choices against the solver's device
(the card unless the caller passes ``device="cpu"``) and returns a Solver
that

* moves each batch to its device (a no-op when it is already there) and
  solves it (``solve``);
* stays a plain function: ``solver(batch)`` is ``solve_with_spec`` with
  the solver's spec;
* offers ``solve_one(A, b, c)`` for the single-LP convenience case.

``solve_with_spec`` is the underlying pure function.  Every layer — the
serving executables in ``serve_lp.sharding`` included — runs through it,
which is what makes "same problem, every backend, bit-for-bit comparable"
a one-liner.  It resolves the spec against the device the batch's tensors
lie on, so a CUDA batch goes to the CUDA kernel and a CPU batch to the
plain ops; it never moves data.

Both entry points accept either constraint layout: the AoS
:class:`~repro_torch.core.lp.LPBatch` or the packed SoA
:class:`~repro_torch.core.packed.PackedLPBatch`.  A packed batch stays
packed end-to-end — normalise/shuffle run in their packed-native forms,
the kernel backend consumes ``L`` directly, and the dense backends consume
the ``L`` component rows directly too.  The AoS entry slices its normals
into the same rows, so both layouts run the identical ops and
``solve(pack(batch))`` is bit-identical to ``solve(batch)``.  (One caveat:
padding the constraint axis — in *either* layout — changes the score
shape ``shuffle`` draws from, so for ``shuffle=True`` specs the identity
needs matching ``m``; a padded batch still agrees on the optimum to the
usual tolerance, just not bit-for-bit.)

On the card, an unshuffled kernel-backend solve runs its front end as two
hand-written launches around the kernel instead (``_solve_fused``):
``prep_cuda`` normalises, packs and pads either layout in one pass, and
``finish_cuda`` writes the objective and the flags.  They equal the eager
chain in every bit; every other call (the CPU, ``meta``, ``interpret``,
the dense backends, a shuffled spec) runs that chain, which is their plain
version.

Such a solve on plain CUDA tensors, with no dispatch or function mode
active, runs from a *launch plan*: one a key of what the call can observe
(the spec object the caller holds, the active tuning table's
:func:`~repro_torch.tune.table_version`, and each tensor's shape, dtype,
card and contiguity).  The first call of a key resolves the shape, runs
the wrappers' checks and binds the three launches
(:class:`~repro_torch.kernels.batch_lp.FusedLaunch`); a later call looks
the plan up and enqueues ``prep``, ``rgb`` and ``finish`` through their
ctypes entry points, with no resolution, no checks and no operator
dispatch.  Under a mode (``FlopCounterMode``, fake tensors, the dry run's
counters) or on a tensor subclass the call keeps ``_solve_fused``, which
dispatches ``torch.ops.repro_torch.rgb`` for them to see.  The plans sit
in one bounded module-level cache (:data:`PLAN_CACHE_SIZE`) that
``Solver.solve`` and ``solve_with_spec`` share; ``solve_with_spec``'s
``plan_hits`` and ``plan_misses`` count its use.

Launch geometry left unset on the spec (``tile``/``chunk`` ``None``) is
pinned here per input shape via
:meth:`~repro_torch.solver.spec.SolverSpec.resolve_for_shape` — explicit
values win, then the measured :mod:`repro_torch.tune` table for this
device, then the static heuristics.

There is no compile cache (PyTorch runs eagerly; the CUDA kernel is built
once per process; the launch plans hold no code, only what each call
resolved): ``cache_info`` is bookkeeping of the distinct shapes solved.
"""
from __future__ import annotations

import threading
from typing import NamedTuple, Optional, Union

import torch

from repro_torch.core.lp import (LPBatch, LPSolution, _objective,
                                 make_batch, normalize_batch, shuffle_batch)
from repro_torch.core.packed import (PackedLPBatch, count_pack,
                                     normalize_packed, pack, pad_packed,
                                     pad_packed_batch_dim, shuffle_packed)
from repro_torch.core.seidel import (solve_naive, solve_naive_packed,
                                     solve_rgb, solve_rgb_packed)
from repro_torch.device import DeviceLike, as_device
from repro_torch.kernels.batch_lp import (LANE, FusedLaunch, LaunchGeometry,
                                          _check_finish, _check_launch,
                                          _check_prep, _pick_tile,
                                          current_card, finish_cuda,
                                          launch_geometry, prep_cuda,
                                          raw_stream, rgb_cuda, rgb_plain)
from repro_torch.obs.trace import Span, close_span, open_span, stage
from repro_torch.pdhg import solve_pdhg, solve_pdhg_packed
from repro_torch.solver.spec import RGB_DEFAULT_TILE, SolverSpec

AnyLPBatch = Union[LPBatch, PackedLPBatch]

_TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def solve_with_spec(spec: SolverSpec, batch: AnyLPBatch,
                    generator: Optional[torch.Generator] = None
                    ) -> LPSolution:
    """Solve ``batch`` (AoS or packed) per ``spec``, on the device the
    batch lies on.

    ``generator`` overrides the spec's shuffle policy for this call; with
    ``generator=None`` the batch is shuffled iff ``spec.shuffle`` (seeded
    by ``spec.seed``).

    Under a traced flush's dispatch, or else while the process default
    tracer records (while a profiler records), the call is a ``solve``
    span with one child a stage (``solve.cast``, ``.normalize``, ``.shuffle``,
    ``.pack``, ``.pad``, ``.launch``, ``.objective``, as far as the
    backend takes them; the fused front end records its ``prep`` launch
    as ``.normalize`` and its ``finish`` as ``.objective``); under a flush
    they go to the flush's tracer, under its ``flush.dispatch`` span.
    A call from a launch plan records ``.cast`` (the plan's lookup, and on
    a miss its construction and the wrappers' checks), ``.normalize``,
    ``.launch`` and ``.objective``, and marks the ``solve`` span ``plan``
    ``hit`` or ``miss``.
    """
    top = open_span("solve")
    if top is None:
        return _solve(spec, batch, generator, None)
    try:
        return _solve(spec, batch, generator, top)
    finally:
        close_span(top)


def _solve(spec: SolverSpec, batch: AnyLPBatch,
           generator: Optional[torch.Generator],
           top: Optional[Span]) -> LPSolution:
    key = _plan_key(spec, batch, generator)
    if key is not None:
        return _solve_keyed(spec, batch, key, top)
    return _solve_eager(spec, batch, generator, top)


def _solve_eager(spec: SolverSpec, batch: AnyLPBatch,
                 generator: Optional[torch.Generator],
                 top: Optional[Span]) -> LPSolution:
    is_packed = isinstance(batch, PackedLPBatch)
    m = batch.m_pad if is_packed else batch.m
    device = batch.device
    spec = spec.resolve_for_shape(m, batch.batch, platform=device.type)
    dt = _TORCH_DTYPES[spec.dtype]
    if generator is None and spec.shuffle:
        generator = torch.Generator(device=device).manual_seed(spec.seed)
    if top is not None:
        top.attrs.update(B=batch.batch, m_pad=m, backend=spec.backend,
                         tile=spec.tile)
    st = stage(top, None, "solve.cast")
    if _takes_fused(spec, device, generator, batch.batch, m):
        return _solve_fused(spec, batch, is_packed, dt, top, st)
    if is_packed:
        return _solve_packed(spec, batch, dt, generator, top, st)
    # Cast each tensor (``to`` is the identity when already dt): A alone
    # matching must not let a mixed-dtype b or c leak through.
    batch = LPBatch(A=batch.A.to(dt), b=batch.b.to(dt),
                    c=batch.c.to(dt), m_valid=batch.m_valid)
    if spec.normalize:
        st = stage(top, st, "solve.normalize")
        batch = normalize_batch(batch)
    if generator is not None:
        st = stage(top, st, "solve.shuffle")
        batch = shuffle_batch(generator, batch)
    if spec.backend == "kernel":
        st = stage(top, st, "solve.pack")
        return _solve_kernel(spec, pack(batch), top, st)
    st = stage(top, st, "solve.launch")
    sol = _solve_dense(spec, batch)
    stage(top, st, None)
    return sol


def _solve_packed(spec: SolverSpec, pb: PackedLPBatch, dt, generator,
                  top: Optional[Span], st: Optional[Span]) -> LPSolution:
    """The packed-native pipeline: cast -> normalise -> shuffle without
    leaving the SoA layout, then hand the ``L`` rows straight to the
    backend (kernel and dense alike — no unpack)."""
    pb = PackedLPBatch(L=pb.L.to(dt), c=pb.c.to(dt), m_valid=pb.m_valid)
    if spec.normalize:
        st = stage(top, st, "solve.normalize")
        pb = normalize_packed(pb)
    if generator is not None:
        st = stage(top, st, "solve.shuffle")
        pb = shuffle_packed(generator, pb)
    if spec.backend == "kernel":
        return _solve_kernel(spec, pb, top, st)
    st = stage(top, st, "solve.launch")
    if spec.backend == "pdhg":
        sol = solve_pdhg_packed(pb, M=spec.M, tol=spec.tol,
                                max_iters=spec.max_iters,
                                iter_block=spec.iter_block,
                                restart_period=spec.restart_period)
    elif spec.backend == "naive":
        sol = solve_naive_packed(pb, M=spec.M)
    else:
        sol = solve_rgb_packed(pb, M=spec.M,
                               tile=spec.tile or RGB_DEFAULT_TILE,
                               chunk=spec.chunk or 0)
    stage(top, st, None)
    return sol


def _solve_dense(spec: SolverSpec, batch: LPBatch) -> LPSolution:
    if spec.backend == "pdhg":
        return solve_pdhg(batch, M=spec.M, tol=spec.tol,
                          max_iters=spec.max_iters,
                          iter_block=spec.iter_block,
                          restart_period=spec.restart_period)
    if spec.backend == "naive":
        return solve_naive(batch, M=spec.M)
    return solve_rgb(batch, M=spec.M,
                     tile=spec.tile or RGB_DEFAULT_TILE,
                     chunk=spec.chunk or 0)


def _solve_kernel(spec: SolverSpec, pb: PackedLPBatch,
                  top: Optional[Span], st: Optional[Span]) -> LPSolution:
    st = stage(top, st, "solve.pad")
    B = pb.batch
    pb = pad_packed(pb, -(-pb.m_pad // LANE) * LANE)
    tile = spec.tile or _pick_tile(B)
    run = pad_packed_batch_dim(pb, -(-B // tile) * tile)
    L, c = run.L.contiguous(), run.c.contiguous()
    mv = run.m_valid.to(torch.int32).contiguous()
    if top is not None:
        top.attrs.update(m_pad=pb.m_pad, tile=tile)
    # ``interpret`` is the one explicit way to ask for the plain version;
    # it resolves to True by itself only on the CPU platform.  Otherwise
    # the wrapper launches the kernel (or raises) for CUDA tensors.
    st = stage(top, st, "solve.launch")
    launch = rgb_plain if spec.interpret else rgb_cuda
    x, feas = launch(L, c, mv, M=spec.M, tile=tile, chunk=spec.chunk or 0)
    st = stage(top, st, "solve.objective")
    x, feas = x[:B], feas[:B, 0]
    sol = LPSolution(
        x=x,
        feasible=feas.to(torch.bool),
        objective=_objective(pb.c.to(x.dtype), x),
    )
    stage(top, st, None)
    return sol


def _takes_fused(spec: SolverSpec, device: torch.device,
                 generator: Optional[torch.Generator], batch: int,
                 m: int) -> bool:
    """Whether a solve takes the fused front end: the kernel on the card,
    no shuffle, and something to solve.  Every other call (the CPU,
    ``meta``, ``interpret``, the dense backends, a shuffled spec) runs the
    eager chain.  Unwatched CUDA tensors take it from a launch plan
    (``_solve_keyed``), which asks this again on every call."""
    return (spec.backend == "kernel" and not spec.interpret
            and generator is None and device.type == "cuda"
            and batch > 0 and m > 0)


def _dense(t: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``t`` in ``dt`` and contiguous: ``t`` itself when it already is."""
    return t.to(dt).contiguous()


def _solve_fused(spec: SolverSpec, batch: AnyLPBatch, is_packed: bool,
                 dt: torch.dtype, top: Optional[Span],
                 st: Optional[Span]) -> LPSolution:
    """The kernel backend's front end on the card: three launches.
    ``prep_cuda`` normalises, packs and pads either layout into the
    kernel's arrays (stage ``solve.normalize``), ``rgb_cuda`` solves
    (``solve.launch``), ``finish_cuda`` writes the objective and the flags
    (``solve.objective``).  Equal in bits to the eager chain; an AoS batch
    counts as one pack.  A launch plan runs the same three launches; this
    path serves the calls a mode or a tensor subclass watches (see
    :func:`unwatched`), for which ``rgb_cuda`` dispatches the operator."""
    if is_packed:
        src, b, m = _dense(batch.L, dt), None, batch.m_pad
    else:
        src, b, m = _dense(batch.A, dt), _dense(batch.b, dt), batch.m
        count_pack()
    c = _dense(batch.c, dt)
    mv = _dense(batch.m_valid, torch.int32)
    B = batch.batch
    tile = spec.tile or _pick_tile(B)
    m_pad = -(-m // LANE) * LANE
    if top is not None:
        top.attrs.update(m_pad=m_pad, tile=tile)
    st = stage(top, st, "solve.normalize")
    L, c, mv = prep_cuda(src, b, c, mv, m_pad=m_pad,
                         b_pad=-(-B // tile) * tile,
                         normalize=spec.normalize)
    st = stage(top, st, "solve.launch")
    x, feas = rgb_cuda(L, c, mv, M=spec.M, tile=tile, chunk=spec.chunk or 0)
    st = stage(top, st, "solve.objective")
    objective, feasible = finish_cuda(x, feas, c, B)
    stage(top, st, None)
    return LPSolution(x=x[:B], feasible=feasible, objective=objective)


# -- launch plans --------------------------------------------------------------

# Most launch plans kept; the oldest goes first.  The serving ladder's
# buckets, each at a few batch rungs, and a caller's own shapes fit.
PLAN_CACHE_SIZE = 256

_plans: dict = {}
_plan_lock = threading.Lock()
_dispatch_modes = torch._C._len_torch_dispatch_stack
_function_modes = torch._C._is_torch_function_mode_enabled
_table = None


def _table_version() -> int:
    """The active tuning table's :func:`~repro_torch.tune.table_version`
    (bound at first use: :mod:`repro_torch.tune` imports this package)."""
    global _table
    if _table is None:
        from repro_torch.tune import table
        _table = table
    return _table.table_version()


class PlanShape(NamedTuple):
    """What a fused solve of one shape resolves to."""
    spec: SolverSpec           # the spec pinned for the shape
    tile: int
    m_pad: int
    b_pad: int
    geometry: LaunchGeometry   # the kernel's launch


def plan_shape(spec: SolverSpec, batch: int, m: int,
               platform: str = "cuda") -> PlanShape:
    """The fused path's per-call arithmetic for ``batch`` problems of
    ``m`` constraints (an AoS batch's ``m``, a packed one's ``m_pad``):
    :meth:`~SolverSpec.resolve_for_shape`, the tile, the padding to
    ``LANE`` columns and to whole tiles, and :func:`~repro_torch.kernels.
    batch_lp.launch_geometry`.  No card is asked; a plan holds the result
    for every later call of its key."""
    spec = spec.resolve_for_shape(m, batch, platform=platform)
    tile = spec.tile or _pick_tile(batch)
    m_pad = -(-m // LANE) * LANE
    itemsize = _TORCH_DTYPES[spec.dtype].itemsize
    return PlanShape(spec, tile, m_pad, -(-batch // tile) * tile,
                     launch_geometry(m_pad, itemsize, tile))


class _Plan(NamedTuple):
    held: SolverSpec       # the caller's spec: its id is in the key
    shape: PlanShape
    launch: FusedLaunch
    packed: bool
    cast: bool             # an input is not yet in dtype, or not contiguous
    fused: tuple           # ``_takes_fused``'s arguments for the plan


def unwatched(tensors) -> bool:
    """Whether an operation on ``tensors`` reaches nothing but the
    dispatcher's kernels: each a plain ``torch.Tensor`` (no fake,
    functional or other subclass), and no ``TorchDispatchMode``
    (``FlopCounterMode``, the roofline's counters, fake mode) and no
    ``TorchFunctionMode`` active.  Only then does a solve launch the kernel
    without dispatching ``torch.ops.repro_torch.rgb``: whatever watches
    the dispatcher sees the operator."""
    if _dispatch_modes() or _function_modes():
        return False
    for t in tensors:
        if type(t) is not torch.Tensor:
            return False
    return True


def _plan_key(spec: SolverSpec, batch: AnyLPBatch,
              generator: Optional[torch.Generator]) -> Optional[tuple]:
    """The launch plan's key for a call, or ``None`` where the call cannot
    take one (a shuffle; not unwatched CUDA tensors)."""
    if generator is not None or spec.shuffle:
        return None
    packed = isinstance(batch, PackedLPBatch)
    ts = ((batch.L, batch.c, batch.m_valid) if packed
          else (batch.A, batch.b, batch.c, batch.m_valid))
    if not unwatched(ts) or not ts[0].is_cuda:
        return None
    return _key(spec, packed, ts)


def _key(spec: SolverSpec, packed: bool, tensors) -> tuple:
    """The spec object (a plan holds it, so its id is not reused while
    the plan lives), the table's version, the layout, and each tensor's
    shape, dtype, card and contiguity."""
    key = [id(spec), _table_version(), packed]
    for t in tensors:
        key += (t.shape, t.dtype, t.get_device(), t.is_contiguous())
    return tuple(key)


def _solve_keyed(spec: SolverSpec, batch: AnyLPBatch, key: tuple,
                 top: Optional[Span]) -> LPSolution:
    """A call with a plan key: from the key's plan, made on a miss where
    the call takes the fused front end; else the eager chain."""
    st = stage(top, None, "solve.cast")
    plan = _plans.get(key)
    if plan is not None and _takes_fused(*plan.fused):
        return _run_plan(plan, batch, top, st, None)
    packed = isinstance(batch, PackedLPBatch)
    B, m = batch.batch, batch.m_pad if packed else batch.m
    device = batch.device
    shape = plan_shape(spec, B, m, device.type)
    fused = (shape.spec, device, None, B, m)
    if not _takes_fused(*fused):
        stage(top, st, None)
        return _solve_eager(shape.spec, batch, None, top)
    dt = _TORCH_DTYPES[shape.spec.dtype]
    cast = any(t is not None and (t.dtype != d or not t.is_contiguous())
               for t, d in zip(_inputs(batch, packed),
                               (dt, dt, dt, torch.int32)))
    launch = FusedLaunch(dt, device, batch=B, m=m, m_pad=shape.m_pad,
                         b_pad=shape.b_pad, tile=shape.tile,
                         M=shape.spec.M, packed=packed,
                         normalize=shape.spec.normalize,
                         geometry=shape.geometry)
    plan = _Plan(spec, shape, launch, packed, cast, fused)
    return _run_plan(plan, batch, top, st, key)


def _inputs(batch: AnyLPBatch, packed: bool) -> tuple:
    """``(src, b, c, m_valid)`` as ``prep`` takes them (``b`` ``None``
    for a packed batch)."""
    if packed:
        return batch.L, None, batch.c, batch.m_valid
    return batch.A, batch.b, batch.c, batch.m_valid


def _run_plan(plan: _Plan, batch: AnyLPBatch, top: Optional[Span],
              st: Optional[Span], new_key: Optional[tuple]) -> LPSolution:
    """Enqueue ``prep``, ``rgb`` and ``finish`` from ``plan``.  A new
    plan (``new_key`` given) first runs the checks of ``prep_cuda``,
    ``rgb_cuda`` and ``finish_cuda`` on this call's tensors and is kept
    under ``new_key`` once its call has launched."""
    launch, shape = plan.launch, plan.shape
    index = launch.device.index
    if current_card() != index:
        with torch.cuda.device(index):
            return _run_plan(plan, batch, top, st, new_key)
    src, b, c, mv = _inputs(batch, plan.packed)
    if not plan.packed:
        count_pack()
    if plan.cast or new_key is not None:
        dt = launch.dtype
        src, c, mv = _dense(src, dt), _dense(c, dt), _dense(mv, torch.int32)
        if b is not None:
            b = _dense(b, dt)
    if new_key is not None:
        _check_prep(src, b, c, mv, m_pad=shape.m_pad, b_pad=shape.b_pad)
    if top is not None:
        top.attrs.update(B=launch.batch, m_pad=shape.m_pad,
                         backend=shape.spec.backend, tile=shape.tile,
                         plan="hit" if new_key is None else "miss")
    stream = raw_stream(index)
    st = stage(top, st, "solve.normalize")
    ws = launch.prep(src, b, c, mv, stream)
    st = stage(top, st, "solve.launch")
    if new_key is not None:
        L, c, mv, _ = launch.views(ws)
        _check_launch(L, c, mv, shape.tile, shape.spec.chunk or 0)
    x = launch.rgb(ws, stream)
    st = stage(top, st, "solve.objective")
    B = launch.batch
    if new_key is not None:
        _, c, _, feas = launch.views(ws)
        _check_finish(x, feas, c, B)
    objective, feasible = launch.finish(x, ws, stream)
    stage(top, st, None)
    if new_key is None:
        with _plan_lock:
            solve_with_spec.plan_hits += 1
    else:
        _keep(new_key, plan)
    return LPSolution(x=x if launch.b_pad == B else x[:B],
                      feasible=feasible, objective=objective)


def _keep(key: tuple, plan: _Plan) -> None:
    """Cache ``plan`` under ``key`` (the oldest plan goes at the bound)
    and count a miss."""
    with _plan_lock:
        solve_with_spec.plan_misses += 1
        if key not in _plans and len(_plans) >= PLAN_CACHE_SIZE:
            del _plans[next(iter(_plans))]
        _plans[key] = plan


# Fused solves that found their launch plan, and those that made it.
solve_with_spec.plan_hits = 0
solve_with_spec.plan_misses = 0


class Solver:
    """Executor for one resolved :class:`SolverSpec` on one device.

    Construct via ``spec.build()`` (or :func:`~repro_torch.solver.spec.
    get_solver` for the process-wide cached instance).  ``device=None``
    means the card: :func:`repro_torch.device.default_device` raises when
    there is none; pass ``device="cpu"`` to run on the CPU.
    """

    def __init__(self, spec: SolverSpec, device: DeviceLike = None):
        if not isinstance(spec, SolverSpec):
            raise TypeError(f"expected SolverSpec, got {type(spec)!r}")
        self.device = as_device(device)
        self.spec = spec.resolve(self.device.type)
        # ``backend="auto"`` stays "auto" on the *solving* spec so each
        # input shape can pick the fastest measured backend from the
        # tuning table (``self.spec`` above is the introspection view
        # and the choice on a table miss).  Note the process-wide
        # :func:`~repro_torch.solver.spec.get_solver` cache keys on the
        # resolved spec, so it pins "auto" to the platform default.
        self._solve_spec = spec if spec.backend == "auto" else self.spec
        self._shapes = set()
        self._on_device = set()   # plan keys of batches already here

    # -- plain-function entry point ---------------------------------------

    def __call__(self, batch: AnyLPBatch,
                 generator: Optional[torch.Generator] = None) -> LPSolution:
        """``solve_with_spec`` with this solver's spec, on the device the
        batch already lies on (no transfer, no bookkeeping)."""
        return solve_with_spec(self._solve_spec, batch, generator)

    # -- host entry points -------------------------------------------------

    def solve(self, batch: AnyLPBatch,
              generator: Optional[torch.Generator] = None) -> LPSolution:
        """Solve one batch (AoS or packed) on this solver's device: one
        ``solve`` span, the move to the device included."""
        top = open_span("solve")
        if top is None:
            return self._solve_here(batch, generator, None)
        try:
            return self._solve_here(batch, generator, top)
        finally:
            close_span(top)

    def _solve_here(self, batch: AnyLPBatch,
                    generator: Optional[torch.Generator],
                    top: Optional[Span]) -> LPSolution:
        spec = self._solve_spec
        key = _plan_key(spec, batch, generator)
        if key is None or key not in self._on_device:
            here = batch.to(self.device)
            arr = here.L if isinstance(here, PackedLPBatch) else here.A
            self._shapes.add((type(here).__name__, tuple(arr.shape),
                              str(arr.dtype), generator is not None))
            if here is not batch:
                batch, key = here, _plan_key(spec, here, generator)
            if key is not None:
                if len(self._on_device) >= PLAN_CACHE_SIZE:
                    self._on_device.clear()
                self._on_device.add(key)
        if key is None:
            return _solve_eager(spec, batch, generator, top)
        return _solve_keyed(spec, batch, key, top)

    def solve_one(self, A, b, c,
                  generator: Optional[torch.Generator] = None) -> LPSolution:
        """Solve a single LP (``A (m,2)``, ``b (m,)``, ``c (2,)``);
        returns an :class:`LPSolution` with the batch axis dropped."""
        sol = self.solve(make_batch(A, b, c, device=self.device),
                         generator=generator)
        return LPSolution(x=sol.x[0], feasible=sol.feasible[0],
                          objective=sol.objective[0])

    # -- introspection ----------------------------------------------------

    def cache_info(self) -> dict:
        """Distinct (layout, shape, dtype, keyed) entries solved so far —
        bookkeeping only: nothing is compiled per shape."""
        return {"n_entries": len(self._shapes),
                "shapes": sorted(str(k) for k in self._shapes)}

    def __repr__(self) -> str:
        return f"Solver({self.spec!r}, device={str(self.device)!r})"
