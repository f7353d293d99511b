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

Launch geometry left unset on the spec (``tile``/``chunk`` ``None``) is
pinned here per input shape via
:meth:`~repro_torch.solver.spec.SolverSpec.resolve_for_shape` — explicit
values win, then the measured :mod:`repro_torch.tune` table for this
device, then the static heuristics.

There is no compile cache (PyTorch runs eagerly; the CUDA kernel is built
once per process): ``cache_info`` is bookkeeping of the distinct shapes
solved.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.core.lp import (LPBatch, LPSolution, _objective,
                                 make_batch, normalize_batch, shuffle_batch)
from repro_torch.core.packed import (PackedLPBatch, count_pack,
                                     normalize_packed, pack, pad_packed,
                                     pad_packed_batch_dim, shuffle_packed)
from repro_torch.core.seidel import (solve_naive, solve_naive_packed,
                                     solve_rgb, solve_rgb_packed)
from repro_torch.device import DeviceLike, as_device
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
    # Deferred import: kernels.ops wraps this package for its public
    # compatibility surface, so the dependency must point one way only.
    from repro_torch.kernels.batch_lp import (LANE, _pick_tile, rgb_cuda,
                                              rgb_plain)

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
    eager chain."""
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
    counts as one pack."""
    from repro_torch.kernels.batch_lp import (LANE, _pick_tile,
                                              finish_cuda, prep_cuda,
                                              rgb_cuda)

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
        batch = batch.to(self.device)
        arr = batch.L if isinstance(batch, PackedLPBatch) else batch.A
        self._shapes.add((type(batch).__name__, tuple(arr.shape),
                          str(arr.dtype), generator is not None))
        return _solve(self._solve_spec, batch, generator, top)

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
