"""Each agent's nearest neighbours from a uniform grid, on the device.

The square ``[-world, world]^2`` is cut into cells of side ``dist`` (the
neighbour radius), so an agent's neighbours lie in its own cell and the
eight around it.  Agents are sorted by cell (a stable sort), each cell's
agents counted (``index_add_``) and its first sorted position taken (the
exclusive cumsum).  An agent outside the square is binned into the nearest
edge cell, which loses no neighbour: the binning is monotone, so two agents
closer than ``dist`` still bin at most one cell apart.  Of the candidates,
the ``k`` nearest ``j != i`` with ``|p_j - p_i| < dist`` (squared, in the
positions' precision) are kept, ties broken by index.

:func:`neighbours` dispatches on the positions' device.  On a card it
launches ``kernels/crowd_grid.py::neighbours_cuda`` after the binning: the
kernel tests every agent of the nine cells, with no capacity, so every
agent is placed exactly (``unplaced`` is 0) and ``capacity`` only counts
``over_cells``; ``fallback`` is not read.  On the CPU it runs
:func:`neighbours_plain`, the kernel's plain version, which the tests hold
the kernel against: each agent gathers the first ``capacity`` agents of
each of its nine cells and takes the ``k`` nearest by a top-k, and a cell
holding more than ``capacity`` agents is handled exactly by a second pass:
the first ``fallback`` agents (by index) whose nine cells include such a
cell are searched against every agent, a ``(fallback, N)`` block.  Agents
beyond ``fallback`` are counted in ``unplaced``, which the caller must see
as a failure.  The two agree in every bit wherever the plain version
places every agent.  Every size comes from the arguments: nothing is read
back from the device.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels.crowd_grid import neighbours_cuda

# Sorts after every real key: a slot with no neighbour in it.
_NONE = torch.iinfo(torch.int64).max



@dataclasses.dataclass(frozen=True)
class Neighbours:
    """``k`` slots an agent, nearest first, filled from the front."""

    idx: torch.Tensor       # (N, k) int64 neighbour index (0 where empty)
    valid: torch.Tensor     # (N, k) bool
    count: torch.Tensor     # (N,) int64 filled slots
    over_cells: torch.Tensor  # () int64 cells holding more than capacity
    unplaced: torch.Tensor  # () int64 agents the second pass could not
    #                         take (0 from the kernel)


def _keys(d2: torch.Tensor, j: torch.Tensor,
          keep: torch.Tensor) -> torch.Tensor:
    """One int64 sort key a candidate: the bits of ``d2`` (non-negative
    floats order as their bit patterns) above the index ``j``."""
    bits = d2.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(keep, (bits << 32) | j, _NONE)


def _nearest(keys: torch.Tensor, k: int):
    if keys.shape[1] < k:   # fewer candidates than slots: pad with none
        keys = torch.nn.functional.pad(keys, (0, k - keys.shape[1]),
                                       value=_NONE)
    top = torch.topk(keys, k, dim=1, largest=False, sorted=True).values
    valid = top != _NONE
    idx = torch.where(valid, top & 0xFFFFFFFF, 0)
    return idx, valid


def _bins(pos: torch.Tensor, dist: float, world: float):
    """``(G, xy (N, 2), cell (N,), order, counts, start)``: the grid's
    side, each agent's cell as ``(x, y)`` and as ``y * G + x``, the agents
    sorted by cell, and each cell's agents and first sorted position."""
    dev = pos.device
    G = max(1, math.ceil(2.0 * world / dist))
    xy = torch.clamp(torch.floor((pos + world) / dist), 0, G - 1).to(
        torch.int64)
    cell = xy[:, 1] * G + xy[:, 0]
    order = torch.argsort(cell, stable=True)
    # Not bincount: on the card it reads the largest bin back to size
    # its output.
    counts = torch.zeros(G * G, dtype=torch.int64, device=dev).index_add_(
        0, cell, torch.ones_like(cell))
    start = torch.cumsum(counts, 0) - counts
    return G, xy, cell, order, counts, start


def neighbours(pos: torch.Tensor, *, dist: float, k: int, world: float,
               capacity: int, fallback: int) -> Neighbours:
    """The ``k`` nearest agents ``j != i`` with ``|p_j - p_i| < dist`` of
    every agent of ``pos (N, 2)``: the kernel for a tensor on a card
    (float32, ``k`` at most 16; it raises where it cannot launch: no
    fallback), :func:`neighbours_plain` for one on the CPU."""
    if pos.device.type == "cpu":
        return neighbours_plain(pos, dist=dist, k=k, world=world,
                                capacity=capacity, fallback=fallback)
    G, _, cell, order, counts, start = _bins(pos, dist, world)
    idx, valid, count = neighbours_cuda(pos, cell, order, start, counts,
                                        grid=G, dist=dist, k=k)
    return Neighbours(idx=idx, valid=valid, count=count,
                      over_cells=(counts > capacity).sum(),
                      unplaced=torch.zeros((), dtype=torch.int64,
                                           device=pos.device))


def neighbours_plain(pos: torch.Tensor, *, dist: float, k: int,
                     world: float, capacity: int,
                     fallback: int) -> Neighbours:
    """:func:`neighbours` in torch operations on any device: the capped
    gather, the top-k and the second pass (the module's note)."""
    N = pos.shape[0]
    dev = pos.device
    rng = torch.arange(N, device=dev)
    G, xy, cell, order, counts, start = _bins(pos, dist, world)
    # The nine cells around an agent's own, made on the device (a tensor
    # copied from the host would wait for the stream).
    o = torch.arange(9, device=dev)
    near = xy[:, None, :] + torch.stack([o % 3 - 1, o // 3 - 1], dim=1)
    inside = ((near >= 0) & (near < G)).all(dim=2)            # (N, 9)
    ncell = near[..., 1].clamp(0, G - 1) * G + near[..., 0].clamp(0, G - 1)
    held = torch.where(inside, counts[ncell], 0)
    slot = torch.arange(capacity, device=dev)
    taken = (slot < held[..., None]).reshape(N, -1)           # (N, 9 cap)
    at = (start[ncell][..., None] + slot).reshape(N, -1).clamp(max=N - 1)
    j = order[at]
    d = pos[j] - pos[:, None, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    keep = taken & (j != rng[:, None]) & (d2 < dist * dist)
    idx, valid = _nearest(_keys(d2, j, keep), k)

    # Second pass: agents next to a cell over capacity, against everyone.
    over = counts > capacity
    bad = (over[ncell] & inside).any(dim=1)
    F = min(fallback, N)
    score, who = torch.topk(torch.where(bad, N - rng, -1), F)
    took = score > 0
    d = pos[None, :, :] - pos[who][:, None, :]                # (F, N, 2)
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    keep = (rng[None, :] != who[:, None]) & (d2 < dist * dist)
    idx_b, valid_b = _nearest(_keys(d2, rng.expand(F, N), keep), k)
    idx[who] = torch.where(took[:, None], idx_b, idx[who])
    valid[who] = torch.where(took[:, None], valid_b, valid[who])
    return Neighbours(idx=idx, valid=valid, count=valid.sum(dim=1),
                      over_cells=over.sum(),
                      unplaced=torch.clamp(bad.sum() - F, min=0))
