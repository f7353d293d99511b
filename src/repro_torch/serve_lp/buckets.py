"""Shape bucketing and the executable cache.

Heterogeneous request streams would otherwise produce one buffer shape
(pinned host buffers, device allocations, launch plan) per distinct
``(B, m)`` — the bucketing here rounds both dimensions up a small
geometric ladder so steady-state traffic lands on a bounded set of
executables, the same ladder as the reference's:

* the constraint dimension ``m`` rounds up to ``base * 2^k`` — base is
  LANE (128) for the kernel backend, which takes a LANE multiple, and 8
  for the dense solvers, which have no layout requirement and should not
  pad an m=8 LP 16x (doubling bounds waste at 2x and caps the ladder at
  ~log2(m_max/base) rungs);
* the batch dimension rounds up to ``unit * 2^k`` where ``unit`` is one
  kernel ``tile`` (the MeshLayout planner owns any further per-device
  padding); doubling again bounds the rung count.

The :class:`ExecutableCache` maps an :class:`ExecSpec` (the full shape +
method key) to a built solver executable and counts hits/misses so the
serving metrics can prove the bucketing works.  Since the serve loop
went pipelined, built entries are two-stage
:class:`~repro_torch.serve_lp.sharding.Executable` objects (async ``dispatch``
returning device handles + blocking ``complete`` materializing host
numpy); plain synchronous callables are still accepted — the scheduler
adapts them via :func:`~repro_torch.serve_lp.sharding.as_executable` — so
injected test build functions keep working.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List

from repro_torch.kernels.batch_lp import LANE
from repro_torch.solver import SolverSpec
# One ladder implementation serves serving buckets *and* tuning-table
# shape classes — their alignment is what makes table lookups for a
# flush's bucket land on the entries the tuner recorded.
from repro_torch.tune.table import bucket_pow2


def bucket_m(m: int, *, base: int = LANE) -> int:
    """Round a constraint count up to the geometric LANE ladder
    {base, 2*base, 4*base, ...}."""
    if m < 1:
        raise ValueError(f"m={m} < 1")
    return bucket_pow2(m, base)


def bucket_batch(batch: int, unit: int) -> int:
    """Round a flush size up to the geometric ladder of ``unit``
    multiples {unit, 2*unit, 4*unit, ...}."""
    if batch < 1:
        raise ValueError(f"batch={batch} < 1")
    return bucket_pow2(batch, unit)


def shape_ladder(m_max: int, *, base: int = LANE) -> List[int]:
    """All m-buckets needed to cover constraint counts up to ``m_max``."""
    out = [base]
    while out[-1] < m_max:
        out.append(out[-1] * 2)
    return out


# Flush-sharding modes a spec (and the scheduler) may name: "mesh" is
# the MeshLayout planner.  The reference's legacy "pmap" even-split
# escape hatch is not ported; asking for it raises the same ValueError
# any unknown mode does.
SHARDING_MODES = ("mesh",)


@dataclasses.dataclass(frozen=True)
class ExecSpec:
    """Everything that determines a built solver executable: the
    padded shapes, the device count, the sharding mode and the full
    (resolved) :class:`~repro_torch.solver.SolverSpec`.

    Embedding the whole solver spec in the cache key is deliberate —
    two schedulers with different specs (dtype, shuffle seed, M, ...)
    can never alias each other's executables.  Likewise ``sharding``:
    executables of different sharding modes are different plans and
    must not alias."""

    bucket_m: int      # padded constraint count (LANE multiple)
    b_pad: int         # padded batch size (see sharding-mode rules)
    solver: SolverSpec
    n_devices: int = 1
    sharding: str = "mesh"

    def __post_init__(self):
        if not isinstance(self.solver, SolverSpec):
            raise TypeError(
                f"solver must be a SolverSpec, got {type(self.solver)!r}")
        # Canonicalise so equal execution plans hash equal.
        object.__setattr__(self, "solver", self.solver.resolve())
        if self.solver.tile is None:
            raise ValueError(
                "ExecSpec needs a concrete solver.tile (shards are "
                "whole numbers of tiles)")
        if self.sharding not in SHARDING_MODES:
            raise ValueError(
                f"sharding={self.sharding!r} not in {SHARDING_MODES}")
        if self.bucket_m < 1:
            raise ValueError(f"bucket_m={self.bucket_m} < 1")
        if self.b_pad < 1:
            raise ValueError(f"b_pad={self.b_pad} < 1")
        # Only the kernel backend has a lane-layout requirement.
        if self.solver.backend == "kernel" and self.bucket_m % LANE:
            raise ValueError(f"bucket_m={self.bucket_m} not a {LANE} "
                             "multiple")
        # The mesh planner owns padding and accepts any positive b_pad.

    # Convenience views kept for call sites/reporting that predate the
    # embedded spec.
    @property
    def method(self) -> str:
        return self.solver.backend

    @property
    def tile(self) -> int:
        return self.solver.tile

    @property
    def chunk(self) -> int:
        return self.solver.chunk


class ExecutableCache:
    """spec -> built executable, with hit/miss accounting.

    ``build_fn`` is called under the cache lock on a miss; the returned
    executable (a dispatch/complete
    :class:`~repro_torch.serve_lp.sharding.Executable` or any callable) is
    stored and reused for every later flush with the same spec.  One cached
    executable may serve several concurrently in-flight flushes of the
    same spec: dispatch/complete hold no per-flush state, so that is
    safe by construction.
    """

    def __init__(self, build_fn: Callable[[ExecSpec], Callable]):
        self._build_fn = build_fn
        self._cache: Dict[ExecSpec, Callable] = {}
        self._uses: Dict[ExecSpec, int] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, spec: ExecSpec) -> Callable:
        with self._lock:
            self._uses[spec] = self._uses.get(spec, 0) + 1
            fn = self._cache.get(spec)
            if fn is not None:
                self.hits += 1
                return fn
            self.misses += 1
            fn = self._cache[spec] = self._build_fn(spec)
            return fn

    def __len__(self) -> int:
        return len(self._cache)

    def uses(self) -> Dict[ExecSpec, int]:
        """How often each spec was asked for (hit or miss) since the last
        reset: the shapes and launch geometry the flushes really ran."""
        with self._lock:
            return dict(self._uses)

    def stats(self) -> Dict[str, float]:
        total = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "size": len(self._cache),
            "hit_rate": self.hits / total if total else 0.0,
        }

    def reset_stats(self) -> None:
        """Zero the hit/miss counters but keep built executables — used
        after a warmup pass so reports show steady-state behaviour."""
        with self._lock:
            self.hits = 0
            self.misses = 0
            self._uses.clear()

    def clear(self) -> None:
        with self._lock:
            self._cache.clear()
            self._uses.clear()
            self.hits = 0
            self.misses = 0
