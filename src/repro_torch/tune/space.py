"""Candidate launch-geometry enumeration.

A :class:`Candidate` is one ``(backend, tile, chunk)`` configuration the
tuner may time.  :func:`candidate_space` enumerates exactly the
configurations that are *valid* for a given ``(m_pad, batch, dtype,
device kind)`` — the constraints mirror the execution layers:

* ``naive`` has no launch geometry: a single candidate, recorded with
  the serving-default tile so the entry can still drive the scheduler's
  batch ladder.
* ``rgb`` tiles are powers of two (8..256), clamped so a tile never
  exceeds the (8-rounded) batch; chunks are 0 (dense re-solve) or blocks
  strictly smaller than the padded constraint count (a chunk >= m_pad
  degenerates to the dense variant).
* ``kernel`` candidates come from the Hopper kernel's geometry, not from
  a memory budget: tiles are whole CTAs of ``WARPS_PER_CTA`` problems
  times a power of two (8..128, a warp walking ``tile / warps``
  problems), clamped to the batch, each checked through
  :func:`~repro_torch.kernels.batch_lp.launch_geometry`.  The only chunk
  is ``0``: the kernel's re-solve scans the warp-rounded prefix before
  the violated constraint whatever ``chunk`` says, so every chunk gives
  the same bits and the same work, and timing it again would only
  measure noise.
* ``pdhg`` has no launch geometry — its knobs are the iteration
  schedule.  A pdhg candidate reinterprets the ``(tile, chunk)`` slots as
  ``(iter_block, restart_period)`` (the same reinterpretation
  :class:`~repro_torch.tune.table.TableEntry` records and
  ``SolverSpec.resolve_for_shape`` reads back).

Everything returned here is safe to *run*; which candidate is fastest is
the runner's job to measure, never this module's to guess.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.kernels.batch_lp import (LANE, WARPS_PER_CTA, _pick_tile,
                                          launch_geometry)
from repro_torch.pdhg.solve import DEFAULT_ITER_BLOCK, DEFAULT_RESTART_PERIOD
from repro_torch.solver.spec import DTYPES, RGB_DEFAULT_TILE
from repro_torch.tune.table import current_device_kind, device_platform

RGB_TILES = (8, 16, 32, 64, 128, 256)
RGB_CHUNKS = (0, 64, 128)
KERNEL_TILES = tuple(WARPS_PER_CTA << k for k in range(5))   # 8..128
KERNEL_CHUNKS = (0,)
# pdhg iteration schedule, riding in the (tile, chunk) slots.
PDHG_ITER_BLOCKS = (32, 64, 128)
PDHG_RESTART_PERIODS = (0, 512, 2048)


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One tunable configuration (tile/chunk are concrete, never None).

    For ``backend="pdhg"`` the slots carry ``(iter_block,
    restart_period)`` instead of launch geometry."""

    backend: str
    tile: int
    chunk: int

    def label(self) -> str:
        if self.backend == "pdhg":
            return f"pdhg/ib{self.tile}/rp{self.chunk}"
        return f"{self.backend}/t{self.tile}/c{self.chunk}"


def heuristic_candidate(backend: str, batch: int) -> Candidate:
    """The configuration a table miss resolves to at this batch (the
    heuristic floor of ``SolverSpec.resolve_for_shape``): the tuner's
    incumbent, which a measured candidate replaces only when it is faster
    beyond the noise band."""
    if backend == "kernel":
        return Candidate("kernel", _pick_tile(batch), 0)
    if backend == "pdhg":
        return Candidate("pdhg", DEFAULT_ITER_BLOCK, DEFAULT_RESTART_PERIOD)
    return Candidate(backend, RGB_DEFAULT_TILE, 0)


def default_backends(device_kind: Optional[str] = None) -> tuple:
    """Backends worth timing on a device family.

    On an NVIDIA card (``gpu`` platform): the CUDA kernel and pdhg.  The
    reference's rule is that the compiled kernel is timed where it runs
    compiled; its converse holds here — on the card ``rgb`` and ``naive``
    are the plain PyTorch Seidel path, which waits on the host at every
    incremental step (435-545 ms a call at the figure-3 shape on an
    NVIDIA H100 80GB HBM3 at 700 W, ``PERF.md``), so timing them only
    spends the tuning run.  ``backends=`` can still ask for them.
    Elsewhere (the CPU): the dense pair and pdhg, as in the reference.
    """
    kind = device_kind if device_kind is not None else current_device_kind()
    if device_platform(kind) == "gpu":
        return ("kernel", "pdhg")
    return ("naive", "rgb", "pdhg")


def candidate_space(
    m_pad: int,
    batch: int,
    *,
    dtype: str = "float32",
    device_kind: Optional[str] = None,
    backends: Optional[Sequence[str]] = None,
) -> List[Candidate]:
    """All valid candidates for one shape class, deterministic order."""
    if m_pad < 1 or batch < 1:
        raise ValueError(f"need m_pad >= 1 and batch >= 1, got "
                         f"({m_pad}, {batch})")
    if dtype not in DTYPES:
        raise ValueError(f"dtype={dtype!r}; expected one of {DTYPES}")
    if backends is None:
        backends = default_backends(device_kind)
    batch_cap = max(8, -(-batch // 8) * 8)  # 8-rounded batch
    out: List[Candidate] = []
    for backend in backends:
        if backend == "naive":
            out.append(Candidate("naive", RGB_DEFAULT_TILE, 0))
        elif backend == "rgb":
            for tile in RGB_TILES:
                if tile > batch_cap and tile != RGB_TILES[0]:
                    continue  # keep one rung even for tiny batches
                for chunk in RGB_CHUNKS:
                    if chunk and chunk >= m_pad:
                        continue
                    out.append(Candidate("rgb", tile, chunk))
        elif backend == "kernel":
            m_lane = -(-m_pad // LANE) * LANE
            itemsize = np.dtype(dtype).itemsize
            for tile in KERNEL_TILES:
                if tile > batch_cap and tile != KERNEL_TILES[0]:
                    continue
                launch_geometry(m_lane, itemsize, tile)  # raises if refused
                for chunk in KERNEL_CHUNKS:
                    out.append(Candidate("kernel", tile, chunk))
        elif backend == "pdhg":
            for iter_block in PDHG_ITER_BLOCKS:
                for period in PDHG_RESTART_PERIODS:
                    if period and period < iter_block:
                        continue  # a period under one block never fires
                    out.append(Candidate("pdhg", iter_block, period))
        else:
            raise ValueError(f"unknown backend {backend!r}")
    return out
