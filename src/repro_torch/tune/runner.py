"""The measured tuning loop: time candidates, record winners.

A measurement harness, not a wall-clock guess:

* the workload is a *representative packed batch* — the same
  :class:`~repro_torch.core.packed.PackedLPBatch` layout the serving hot
  path feeds the solver, drawn from the paper's random-feasible
  distribution at the target shape, on the device being tuned;
* every candidate is timed with ``warmup`` untimed calls first (the
  kernel's build, the allocator's first touch), then ``iters`` timed
  calls, each a host clock around the whole solve call fenced by
  ``torch.cuda.synchronize(device)`` on a card (no fence on the CPU,
  where the call returns with its result), and the **median** is kept;
  a shape's candidates take their calls in turn, round by round, so a
  drift over the run does not rank them;
* candidates are built as fully-explicit :class:`SolverSpec`\\ s (tile
  and chunk pinned), so timing a candidate never consults the tuning
  table — no feedback loop between measuring and resolving;
* a backend's winner is the heuristic's own candidate unless another is
  faster beyond the noise band (:func:`winner_entries`).  On the card the
  solve call is host-bound (0.2-0.6 ms, of which the kernel is 0.01-0.1
  ms), so the fastest median alone would pin a tile on noise.

:func:`tune` drives the space over a grid of shapes and folds the
per-backend winners into a :class:`~repro_torch.tune.table.TuningTable`;
``scripts/tune_table.py`` is the offline entry point on the card.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.packed import PackedLPBatch, packed_from_numpy
from repro_torch.device import DeviceLike, as_device
from repro_torch.solver import SolverSpec
from repro_torch.tune.space import (Candidate, candidate_space,
                                    heuristic_candidate)
from repro_torch.tune.table import (BATCH_BUCKET_BASE, M_BUCKET_BASE,
                                    TableEntry, TableKey, TuningTable,
                                    bucket_pow2, current_device_kind)

DEFAULT_WARMUP = 1
DEFAULT_ITERS = 5


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """One timed candidate at one shape, with the measurement spread
    (``iqr_seconds`` over ``k`` repetitions) kept alongside the median so
    table merges can tell improvement from noise."""

    candidate: Candidate
    m_pad: int
    batch: int
    dtype: str
    device_kind: str
    seconds: float            # median wall-clock per solve
    iqr_seconds: float = 0.0  # interquartile range of the samples
    k: int = 1                # timed repetitions

    @property
    def us_per_lp(self) -> float:
        return self.seconds / self.batch * 1e6

    @property
    def us_iqr(self) -> float:
        return self.iqr_seconds / self.batch * 1e6


def _fence_device(args, device: DeviceLike) -> Optional[torch.device]:
    """The CUDA device a timed call must be fenced on: ``device`` when
    given, else that of the first argument with a ``device``; ``None``
    for the CPU (nothing runs behind the host's back there)."""
    if device is None:
        device = next((a.device for a in args if hasattr(a, "device")),
                      None)
    if device is None:
        return None
    device = torch.device(device)
    return device if device.type == "cuda" else None


def measure_stats_many(fns: Sequence, *args, warmup: int = DEFAULT_WARMUP,
                       iters: int = DEFAULT_ITERS,
                       device: DeviceLike = None
                       ) -> List[Tuple[float, float, int]]:
    """``(median, iqr, k)`` wall-clock seconds of each ``fn(*args)``,
    device-fenced: on a CUDA device (``device``, or the first argument's)
    each timed call starts after ``torch.cuda.synchronize`` and ends with
    one, so the device's work is inside the clock.

    The calls are interleaved: each of ``warmup`` rounds, then each of
    ``iters`` timed rounds, calls every ``fn`` once in turn, so a drift
    of the host or the card over the run lands on every ``fn`` alike
    rather than on whichever was timed first.  The IQR (75th - 25th
    percentile of the sorted samples, by index — exact quartile
    interpolation would be false precision at these k) is the noise band
    table merges honour."""
    if iters < 1:
        raise ValueError(f"iters={iters} < 1")
    dev = _fence_device(args, device)

    def fence():
        if dev is not None:
            torch.cuda.synchronize(dev)

    for _ in range(warmup):
        for fn in fns:
            fn(*args)
    fence()
    samples = [[] for _ in fns]
    for _ in range(iters):
        for fn, ts in zip(fns, samples):
            t0 = time.perf_counter()
            fn(*args)
            fence()
            ts.append(time.perf_counter() - t0)
    out = []
    for ts in samples:
        ts.sort()
        n = len(ts)
        iqr = ts[(3 * n) // 4] - ts[n // 4] if n > 1 else 0.0
        out.append((ts[n // 2], iqr, n))
    return out


def measure_stats(fn, *args, warmup: int = DEFAULT_WARMUP,
                  iters: int = DEFAULT_ITERS,
                  device: DeviceLike = None) -> Tuple[float, float, int]:
    """``(median, iqr, k)`` wall-clock seconds of ``fn(*args)``,
    device-fenced (:func:`measure_stats_many` of one function)."""
    return measure_stats_many([fn], *args, warmup=warmup, iters=iters,
                              device=device)[0]


def measure(fn, *args, warmup: int = DEFAULT_WARMUP,
            iters: int = DEFAULT_ITERS, device: DeviceLike = None) -> float:
    """Median wall-clock seconds of ``fn(*args)``, device-fenced."""
    return measure_stats(fn, *args, warmup=warmup, iters=iters,
                         device=device)[0]


def _random_feasible_arrays(rng: np.random.Generator, batch: int, m: int):
    """numpy twin of ``core.random_feasible_lp`` (radius 100, slack 5),
    drawn in float32 as the reference draws it."""
    f32 = np.float32
    xstar = rng.uniform(-50.0, 50.0, (batch, 1, 2)).astype(f32)
    theta = rng.uniform(0.0, 2.0 * np.pi, (batch, m)).astype(f32)
    A = np.stack([np.cos(theta), np.sin(theta)], axis=-1)
    s = rng.uniform(0.1, 5.0, (batch, m)).astype(f32)
    b = (A * xstar).sum(axis=-1) + s
    phi = rng.uniform(0.0, 2.0 * np.pi, batch).astype(f32)
    c = np.stack([np.cos(phi), np.sin(phi)], axis=-1)
    return A, b, c


def representative_batch(m_pad: int, batch: int, *,
                         dtype: str = "float32", seed: int = 0,
                         device: DeviceLike = None) -> PackedLPBatch:
    """A packed random-feasible batch at the target shape — the layout
    and distribution the serving hot path runs — on ``device`` (the card
    by default).  Seeded as the reference seeds its key
    (``seed ^ (m_pad * 7919 + batch)``); the streams differ, the shape
    class and the distribution do not."""
    rng = np.random.default_rng(seed ^ (m_pad * 7919 + batch))
    A, b, c = _random_feasible_arrays(rng, batch, m_pad)
    L = np.stack([A[..., 0], A[..., 1], b, np.zeros_like(b)], axis=1)
    npdt = np.dtype(dtype)
    return packed_from_numpy(L.astype(npdt), c.astype(npdt),
                             np.full((batch, 1), m_pad, np.int32),
                             device=as_device(device))


def candidate_spec(cand: Candidate, *, dtype: str = "float32",
                   interpret: Optional[bool] = None) -> SolverSpec:
    """The fully-explicit spec for one candidate (tile and chunk pinned,
    so resolution never re-enters the tuning table).  A pdhg candidate's
    slots map back to its iteration schedule."""
    if cand.backend == "pdhg":
        return SolverSpec(backend="pdhg", iter_block=cand.tile,
                          restart_period=cand.chunk, dtype=dtype)
    return SolverSpec(backend=cand.backend, tile=cand.tile,
                      chunk=cand.chunk, dtype=dtype, interpret=interpret)


def time_candidate(cand: Candidate, pb: PackedLPBatch, *,
                   dtype: str = "float32",
                   interpret: Optional[bool] = None,
                   warmup: int = DEFAULT_WARMUP,
                   iters: int = DEFAULT_ITERS) -> float:
    """Median seconds for one candidate over one packed batch."""
    return time_candidate_stats(cand, pb, dtype=dtype,
                                interpret=interpret, warmup=warmup,
                                iters=iters)[0]


def time_candidate_stats(cand: Candidate, pb: PackedLPBatch, *,
                         dtype: str = "float32",
                         interpret: Optional[bool] = None,
                         warmup: int = DEFAULT_WARMUP,
                         iters: int = DEFAULT_ITERS
                         ) -> Tuple[float, float, int]:
    """``(median, iqr, k)`` seconds for one candidate over one packed
    batch, on the device the batch lies on."""
    solver = candidate_spec(cand, dtype=dtype,
                            interpret=interpret).build(device=pb.device)
    return measure_stats(solver.solve, pb, warmup=warmup, iters=iters)


def tune_shape(
    m_pad: int,
    batch: int,
    *,
    dtype: str = "float32",
    backends: Optional[Sequence[str]] = None,
    device_kind: Optional[str] = None,
    interpret: Optional[bool] = None,
    warmup: int = DEFAULT_WARMUP,
    iters: int = DEFAULT_ITERS,
    seed: int = 0,
    device: DeviceLike = None,
) -> List[TuneResult]:
    """Time every valid candidate at one shape on ``device`` (the card by
    default), interleaved (:func:`measure_stats_many`); sorted
    fastest-first.  Results are keyed by ``device_kind``
    (default: the card's name, ``"cpu"`` on a CPU device)."""
    device = as_device(device)
    kind = device_kind
    if kind is None:
        kind = "cpu" if device.type == "cpu" else current_device_kind()
    pb = representative_batch(m_pad, batch, dtype=dtype, seed=seed,
                              device=device)
    cands = candidate_space(m_pad, batch, dtype=dtype, device_kind=kind,
                            backends=backends)
    solvers = [candidate_spec(cand, dtype=dtype,
                              interpret=interpret).build(device=pb.device)
               for cand in cands]
    stats = measure_stats_many([s.solve for s in solvers], pb,
                               warmup=warmup, iters=iters)
    results = [TuneResult(candidate=cand, m_pad=m_pad, batch=batch,
                          dtype=dtype, device_kind=kind, seconds=seconds,
                          iqr_seconds=iqr, k=k)
               for cand, (seconds, iqr, k) in zip(cands, stats)]
    results.sort(key=lambda r: r.seconds)
    return results


def results_to_entries(results: Iterable[TuneResult]) -> List[TableEntry]:
    """Per-backend winners of one shape's results as table entries."""
    best = {}
    for r in results:
        cur = best.get(r.candidate.backend)
        if cur is None or r.seconds < cur.seconds:
            best[r.candidate.backend] = r
    entries = []
    for r in best.values():
        key = TableKey(
            device_kind=r.device_kind, backend=r.candidate.backend,
            dtype=r.dtype,
            m_bucket=bucket_pow2(r.m_pad, M_BUCKET_BASE),
            batch_bucket=bucket_pow2(r.batch, BATCH_BUCKET_BASE))
        entries.append(TableEntry(key=key, tile=r.candidate.tile,
                                  chunk=r.candidate.chunk,
                                  us_per_lp=r.us_per_lp,
                                  us_iqr=r.us_iqr, k=r.k))
    return entries


def winner_entries(results: Iterable[TuneResult]) -> List[TableEntry]:
    """Per-backend winners of one shape's results as table entries, the
    incumbent being :func:`~repro_torch.tune.space.heuristic_candidate`
    (what a table miss runs): another candidate takes the row only when
    it is faster by more than the larger of the two IQRs,
    :meth:`TuningTable.merge`'s dead zone.  A backend whose heuristic
    candidate was not timed gets its fastest."""
    results = list(results)
    incumbents = [r for r in results if r.candidate
                  == heuristic_candidate(r.candidate.backend, r.batch)]
    table = TuningTable(results_to_entries(incumbents))
    return table.merge(TuningTable(results_to_entries(results))).entries()


def tune(
    shapes: Sequence[Tuple[int, int]],
    *,
    dtype: str = "float32",
    backends: Optional[Sequence[str]] = None,
    device_kind: Optional[str] = None,
    interpret: Optional[bool] = None,
    warmup: int = DEFAULT_WARMUP,
    iters: int = DEFAULT_ITERS,
    table: Optional[TuningTable] = None,
    on_result=None,
    device: DeviceLike = None,
) -> TuningTable:
    """Tune a grid of ``(m_pad, batch)`` shapes into a table.

    Each shape's winners are :func:`winner_entries`; ``table`` (if
    given) is updated in place via the faster-wins merge;
    ``on_result`` is an optional callback fired with every
    :class:`TuneResult` as it lands (``scripts/tune_table.py`` streams
    them as JSON rows)."""
    if table is None:
        table = TuningTable()
    for m_pad, batch in shapes:
        results = tune_shape(m_pad, batch, dtype=dtype, backends=backends,
                             device_kind=device_kind, interpret=interpret,
                             warmup=warmup, iters=iters, device=device)
        if on_result is not None:
            for r in results:
                on_result(r)
        table.merge(TuningTable(winner_entries(results)))
    return table
