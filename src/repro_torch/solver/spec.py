"""`SolverSpec` — the one frozen, hashable description of *how* to solve.

Every public entry point used to carry its own loose bag of kwargs
(the historical ``method=``/``tile=`` call styles, since-retired
compat wrappers with conflicting ``normalize`` defaults, the serving
scheduler re-threading tile/M/interpret by hand).  A
:class:`SolverSpec` replaces all of them:
it validates once at construction, hashes and compares by value — so it
can key executable caches — and builds a reusable
:class:`~repro_torch.solver.solver.Solver` via :meth:`build`.  Field for
field it is the reference's ``repro.solver.SolverSpec``
(``dataclasses.asdict`` of one builds the other).

The *shuffle policy* lives in the spec rather than in a per-call kwarg:
``shuffle=True`` applies Seidel's randomised constraint order on every
solve, keyed by ``seed`` unless the caller passes an explicit key.  A
key passed at call time always wins, so ``shuffle=False`` specs can
still opt in per call (the old ``key=`` behaviour).

Launch geometry (``tile``/``chunk``) is resolved in two stages.
:meth:`resolve` pins only environment-dependent fields (backend,
interpret) and leaves unset geometry as the sentinel ``None``;
:meth:`resolve_for_shape` — called wherever the input shape is known
(the solve core, the serving scheduler's per-bucket flush) — pins it
with the precedence **explicit > tuning table > heuristic**: values the
user set always win, otherwise the measured
:class:`repro_torch.tune.TuningTable` for this device is consulted, and a
table miss falls back to the static defaults (never an error).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import TYPE_CHECKING, Optional

import torch

from repro_torch.device import DeviceLike
from repro_torch.pdhg.solve import DEFAULT_ITER_BLOCK, DEFAULT_RESTART_PERIOD

if TYPE_CHECKING:  # pragma: no cover - import cycle guard, typing only
    from repro_torch.solver.solver import Solver

# Box bound default: "very large so as not to affect the optimum".
DEFAULT_M = 1.0e4

BACKENDS = ("naive", "rgb", "kernel", "pdhg", "auto")
DTYPES = ("float32", "float64")

# Spec knobs that only the first-order backend interprets; validation
# rejects them on any other backend so a typo'd spec fails loudly
# instead of silently ignoring a tolerance.
PDHG_ONLY_FIELDS = ("iter_block", "restart_period", "tol", "max_iters")

# Backend-default tiles when ``tile=None`` and the tuning table has no
# entry: the plain-PyTorch cooperative solver uses the paper-faithful
# warp-sized tile; the CUDA kernel picks its tile per input shape at
# solve time (``kernels.batch_lp._pick_tile``).
RGB_DEFAULT_TILE = 32


def default_platform() -> str:
    """``"cuda"`` when a card is visible, else ``"cpu"`` — what
    :meth:`SolverSpec.resolve` pins ``"auto"`` choices against when the
    caller names no platform.  (Choosing a *device* is
    :func:`repro_torch.device.default_device`'s job, and that raises
    without a card; the solve core always resolves against the device
    its tensors lie on.)"""
    return "cuda" if torch.cuda.is_available() else "cpu"


@dataclasses.dataclass(frozen=True)
class SolverSpec:
    """Full configuration of a batch 2-D LP solve.

    Parameters
    ----------
    backend:
        ``"naive"`` (divergence-emulating baseline), ``"rgb"``
        (plain-PyTorch cooperative tiles), ``"kernel"`` (the CUDA
        kernel), ``"pdhg"`` (restarted first-order solver, plain
        PyTorch ops) or ``"auto"`` (the fastest *measured*
        backend for the input shape when the tuning table has entries,
        else kernel on ``cuda`` / rgb on ``cpu`` — resolved by
        :meth:`resolve`/:meth:`build` and :meth:`resolve_for_shape`).
    tile:
        problems per cooperative tile.  ``None`` means "pick per
        shape": the measured tuning table when it has an entry,
        otherwise the backend default (32 for ``rgb``, one problem per
        warp of a CTA for ``kernel``); ignored by ``naive``.
    chunk:
        chunk size for the chunked O(i) re-solve.  ``None`` means
        "pick per shape" (table, then the dense default); ``0``
        explicitly requests the dense re-solve.
    M:
        box bound on both coordinates (must not bind at the optimum).
    normalize:
        scale every constraint to unit norm before solving (keeps every
        epsilon an absolute distance; strongly recommended).
    shuffle:
        apply Seidel's randomised constraint order on every solve,
        keyed by ``seed`` unless a per-call key is given.
    seed:
        key for ``shuffle=True`` when no per-call key overrides it.
    interpret:
        ``kernel`` backend only — run the kernel's plain PyTorch
        version (``rgb_plain``) instead of launching it; the one
        explicit way to ask for that.  ``None`` resolves to True on
        the ``cpu`` platform only (so the backend stays runnable in
        tests), never for tensors on a card.
    dtype:
        solve precision, ``"float32"`` or ``"float64"`` (inputs are
        cast on entry).
    iter_block:
        ``pdhg`` only — iterations per block
        (residuals/restarts are checked at block boundaries).  ``None``
        means "pick per shape": tuning table, then the pdhg default.
    restart_period:
        ``pdhg`` only — artificial restart period in iterations (``0``
        disables the periodic trigger, adaptive restarts still fire).
        ``None`` resolves like ``iter_block``.
    tol:
        ``pdhg`` only — relative KKT tolerance; ``None`` picks the
        dtype default (1e-4 float32, 1e-8 float64).
    max_iters:
        ``pdhg`` only — iteration budget; ``None`` picks the dtype
        default (20k float32, 100k float64).
    """

    backend: str = "auto"
    tile: Optional[int] = None
    chunk: Optional[int] = None
    M: float = DEFAULT_M
    normalize: bool = True
    shuffle: bool = False
    seed: int = 0
    interpret: Optional[bool] = None
    dtype: str = "float32"
    iter_block: Optional[int] = None
    restart_period: Optional[int] = None
    tol: Optional[float] = None
    max_iters: Optional[int] = None

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; expected one of "
                f"{BACKENDS}")
        if self.tile is not None and (not isinstance(self.tile, int)
                                      or self.tile < 1):
            raise ValueError(f"tile={self.tile!r} must be a positive int "
                             "or None")
        if self.chunk is not None and (not isinstance(self.chunk, int)
                                       or self.chunk < 0):
            raise ValueError(f"chunk={self.chunk!r} must be an int >= 0 "
                             "or None")
        M = float(self.M)
        if not M > 0.0:
            raise ValueError(f"M={self.M!r} must be > 0")
        object.__setattr__(self, "M", M)
        if not isinstance(self.seed, int):
            raise ValueError(f"seed={self.seed!r} must be an int")
        dt = str(self.dtype)
        if dt not in DTYPES:
            raise ValueError(f"dtype={self.dtype!r}; expected one of "
                             f"{DTYPES}")
        object.__setattr__(self, "dtype", dt)
        if self.iter_block is not None and (
                not isinstance(self.iter_block, int)
                or self.iter_block < 1):
            raise ValueError(f"iter_block={self.iter_block!r} must be a "
                             "positive int or None")
        if self.restart_period is not None and (
                not isinstance(self.restart_period, int)
                or self.restart_period < 0):
            raise ValueError(f"restart_period={self.restart_period!r} "
                             "must be an int >= 0 or None (0 disables "
                             "the periodic trigger)")
        if self.tol is not None:
            tol = float(self.tol)
            if not tol > 0.0:
                raise ValueError(f"tol={self.tol!r} must be > 0 or None")
            object.__setattr__(self, "tol", tol)
        if self.max_iters is not None and (
                not isinstance(self.max_iters, int)
                or self.max_iters < 1):
            raise ValueError(f"max_iters={self.max_iters!r} must be a "
                             "positive int or None")
        if self.backend != "pdhg":
            stray = [f for f in PDHG_ONLY_FIELDS
                     if getattr(self, f) is not None]
            if stray:
                raise ValueError(
                    f"{', '.join(stray)} are pdhg-only knobs; "
                    f"backend={self.backend!r} does not interpret them "
                    "(build a SolverSpec(backend='pdhg', ...) instead)")

    # -- resolution ------------------------------------------------------

    @property
    def is_resolved(self) -> bool:
        """True once ``backend`` and ``interpret`` are concrete."""
        return self.backend != "auto" and self.interpret is not None

    def resolve(self, platform: Optional[str] = None) -> "SolverSpec":
        """Pin ``"auto"`` choices against ``platform`` (``"cuda"`` or
        ``"cpu"``, ``"meta"`` taken as ``"cuda"``; default
        :func:`default_platform`) and canonicalise
        inert fields.

        Environment-dependent choices (``backend="auto"``,
        ``interpret=None``) become concrete; fields that cannot affect
        execution are pinned (``interpret`` off the kernel backend,
        ``seed`` when ``shuffle=False``), so specs with identical
        execution plans resolve equal and share executable-cache
        entries.  Unset launch geometry (``tile=None``/``chunk=None``)
        stays the sentinel — it means "pick per shape" and is pinned by
        :meth:`resolve_for_shape` where the input shape is known.
        """
        platform = platform or default_platform()
        if platform == "meta":  # a dry run on meta tensors models the card
            platform = "cuda"
        if platform not in ("cuda", "cpu"):
            raise ValueError(
                f"platform={platform!r}; expected 'cuda' or 'cpu'")
        backend = self.backend
        if backend == "auto":
            backend = "kernel" if platform == "cuda" else "rgb"
        if backend == "kernel":
            interpret = (platform == "cpu" if self.interpret is None
                         else bool(self.interpret))
        else:
            interpret = False
        seed = self.seed if self.shuffle else 0
        if (backend == self.backend and interpret == self.interpret
                and seed == self.seed):
            return self
        return dataclasses.replace(self, backend=backend,
                                   interpret=interpret, seed=seed)

    @property
    def is_shape_resolved(self) -> bool:
        """True once launch geometry is concrete as well (for ``pdhg``
        that includes the block/restart schedule)."""
        if self.backend == "pdhg" and (self.iter_block is None
                                       or self.restart_period is None):
            return False
        return (self.is_resolved and self.tile is not None
                and self.chunk is not None)

    def resolve_for_shape(self, m: int, batch: Optional[int] = None,
                          platform: Optional[str] = None) -> "SolverSpec":
        """Fully pin the spec for one input shape: environment choices
        via :meth:`resolve`, then launch geometry with the precedence
        **explicit > tuning table > heuristic**.

        ``m`` is the (padded) constraint count of the batch, ``batch``
        its problem count (``None`` if unknown — table lookups then use
        the batch-wildcard rung).  For ``backend="auto"`` the measured
        table may also pick the backend: the fastest recorded backend
        at this shape wins over the platform default when measurements
        exist.  A table miss — or the table being unavailable for any
        reason — falls back to today's static heuristics; this method
        never raises on tuning problems.
        """
        from repro_torch.kernels.batch_lp import LANE, _pick_tile  # deferred
        platform = platform or default_platform()
        # The table is keyed by device kind: "cpu" on the CPU platform,
        # the first card's name otherwise.
        kind = "cpu" if platform == "cpu" else None
        try:
            from repro_torch.tune.table import active_table
            table = active_table()
        except Exception:   # tuning must never take the solver down
            table = None
        spec = self
        if spec.backend == "auto" and table is not None:
            try:
                best = table.lookup_best_backend(dtype=spec.dtype, m=m,
                                                 batch=batch,
                                                 device_kind=kind)
            except Exception:
                best = None
            if best is not None:
                spec = dataclasses.replace(
                    spec, backend=best.key.backend)
        spec = spec.resolve(platform)
        if spec.is_shape_resolved:
            return spec
        if spec.backend == "pdhg":
            return spec._resolve_pdhg_shape(table, m, batch, kind)
        tile, chunk = spec.tile, spec.chunk
        entry = None
        if table is not None and (tile is None or chunk is None):
            try:
                entry = table.lookup(backend=spec.backend,
                                     dtype=spec.dtype, m=m, batch=batch,
                                     device_kind=kind)
            except Exception:
                entry = None
        if entry is not None:
            if tile is None:
                tile = entry.tile
            if chunk is None:
                chunk = entry.chunk
        # Heuristic floor: exactly the pre-tuning behaviour.
        m_lane = -(-m // LANE) * LANE
        if tile is None:
            if spec.backend == "kernel":
                tile = _pick_tile(batch)
            else:
                tile = RGB_DEFAULT_TILE
        chunk_from_table = chunk is not None and spec.chunk is None
        if chunk is None:
            chunk = 0
        if (spec.backend == "kernel" and chunk and chunk_from_table
                and m_lane % chunk):
            # A bucketed table entry can carry a chunk that does not
            # divide this shape's lane-rounded m; run dense instead of
            # letting rgb_cuda reject the launch.  (An *explicit*
            # invalid chunk still fails loudly there, as before.)
            chunk = 0
        if tile == spec.tile and chunk == spec.chunk:
            return spec
        return dataclasses.replace(spec, tile=tile, chunk=chunk)

    def _resolve_pdhg_shape(self, table, m: int, batch: Optional[int],
                            kind: Optional[str] = None) -> "SolverSpec":
        """Pin the pdhg schedule (same precedence as tile/chunk).  A
        pdhg table entry's two geometry slots carry ``(iter_block,
        restart_period)`` — see :mod:`repro_torch.tune.table`.  ``tile`` and
        ``chunk`` are inert for pdhg but still pinned to concrete
        values so shape-resolved consumers (the serving layer's
        ``ExecSpec`` batch ladder) keep working unchanged."""
        ib, rp = self.iter_block, self.restart_period
        if table is not None and (ib is None or rp is None):
            try:
                entry = table.lookup(backend="pdhg", dtype=self.dtype,
                                     m=m, batch=batch, device_kind=kind)
            except Exception:
                entry = None
            if entry is not None:
                if ib is None:
                    ib = entry.tile
                if rp is None:
                    rp = entry.chunk
        if ib is None:
            ib = DEFAULT_ITER_BLOCK
        if rp is None:
            rp = DEFAULT_RESTART_PERIOD
        tile = self.tile if self.tile is not None else RGB_DEFAULT_TILE
        chunk = self.chunk if self.chunk is not None else 0
        if (ib == self.iter_block and rp == self.restart_period
                and tile == self.tile and chunk == self.chunk):
            return self
        return dataclasses.replace(self, iter_block=ib,
                                   restart_period=rp, tile=tile,
                                   chunk=chunk)

    # -- construction of the runtime object ------------------------------

    def build(self, device: DeviceLike = None) -> "Solver":
        """Resolve against ``device`` (default: the card —
        :func:`repro_torch.device.default_device`, which raises when
        there is none) and wrap into a reusable :class:`Solver` (fresh
        instance; use :func:`get_solver` for a process-wide cached
        one)."""
        from repro_torch.solver.solver import Solver  # deferred: import cycle
        return Solver(self, device=device)


@functools.lru_cache(maxsize=None)
def _cached_solver(spec: SolverSpec, device: torch.device) -> "Solver":
    from repro_torch.solver.solver import Solver  # deferred: import cycle
    return Solver(spec, device=device)


def get_solver(spec: SolverSpec, device: DeviceLike = None) -> "Solver":
    """Process-wide ``(spec, device) -> Solver`` cache: equal specs on
    one device share one Solver."""
    from repro_torch.device import as_device
    device = as_device(device)
    return _cached_solver(spec.resolve(device.type), device)
