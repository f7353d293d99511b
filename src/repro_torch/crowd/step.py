"""A crowd's state and its step: build every agent's LP, solve, move.

``step_direct`` solves the step's batch with one ``Solver.solve`` and
never waits for the device; ``step_served`` hands every agent's LP to
``BatchScheduler.submit_many``, flushes, and waits on the futures.  The
LPs, and so the trajectories, are the same in bits on the same start.  On
a card the build (the grid's binning and its kernel, then the rows: small
launches that would hold the host) is captured once as two CUDA graphs and
replayed.

While the process default tracer records (while a ``torch.profiler``
session records) a step is a ``crowd.step`` span with the stages
``crowd.build`` (itself ``crowd.neighbours`` then ``crowd.orca``),
``crowd.solve`` (direct; the solver's ``solve`` spans under it) or
``crowd.submit`` and ``crowd.wait`` (served), and ``crowd.apply``.  The
span carries ``n_agents`` and ``episode_step``; a served step, which has
them on the host anyway, adds ``rows`` (the sum of ``m_valid``),
``n_infeasible`` and ``n_unsure_cells`` (cells over the grid's capacity).
A direct step reads nothing back from the device, traced or not.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.lp import PAD_B, LPBatch, LPSolution
from repro_torch.crowd import grid, orca
from repro_torch.kernels.crowd_grid import add_launches, neighbours_cuda
from repro_torch.obs.trace import (close_span, open_span, reset_current_span,
                                   set_current_span, stage)

# How long a served step waits for one future.
RESULT_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class CrowdParams:
    """An ORCA deployment: RVO2's agent parameters (its ``Blocks``
    example's defaults), the time step, and the neighbour grid's extent
    (``world``: the half-width of the square it bins), its ``capacity``
    a cell and the number of agents its second pass can take (``fallback``).
    On a card the grid's kernel tests every agent of a cell, so
    ``capacity`` only counts the cells over it and ``fallback`` is not
    read; both bound the plain version (``grid.neighbours_plain``)."""

    neighbor_dist: float = 15.0
    max_neighbors: int = 10
    time_horizon: float = 5.0
    radius: float = 2.0
    max_speed: float = 2.0
    time_step: float = 0.25
    world: float = 1000.0
    capacity: int = 32
    fallback: int = 256


@dataclasses.dataclass(frozen=True)
class CrowdState:
    """Agents' positions, velocities, goals and fixed perturbations
    (``(N, 2)`` each, on one device), the step within the episode, and
    ``unplaced``: agents the neighbour grid could not place exactly, summed
    over the steps (a device scalar; anything but 0 is a failure)."""

    pos: torch.Tensor
    vel: torch.Tensor
    goal: torch.Tensor
    eps: torch.Tensor
    step: int = 0
    unplaced: Optional[torch.Tensor] = None
    # The build captured as CUDA graphs, by ``CrowdParams`` (a card only);
    # states made from one another share it.
    graphs: Dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    @classmethod
    def start(cls, pos, goal, eps) -> "CrowdState":
        """Agents at rest at ``pos``."""
        return cls(pos=pos, vel=torch.zeros_like(pos), goal=goal, eps=eps,
                   unplaced=torch.zeros((), dtype=torch.int64,
                                        device=pos.device))

    @property
    def n_agents(self) -> int:
        return self.pos.shape[0]


def _neighbours(pos, params: CrowdParams) -> grid.Neighbours:
    return grid.neighbours(pos, dist=params.neighbor_dist,
                           k=params.max_neighbors, world=params.world,
                           capacity=params.capacity, fallback=params.fallback)


def _rows(pos, vel, goal, eps, nb: grid.Neighbours,
          params: CrowdParams) -> LPBatch:
    a, b = orca.orca_rows(pos, vel, nb.idx, radius=params.radius,
                          tau=params.time_horizon, dt=params.time_step)
    a = torch.where(nb.valid[..., None], a, 0.0)
    b = torch.where(nb.valid, b, PAD_B)
    c = orca.objective(pos, goal, eps)
    sa, sb = orca.speed_rows(c, params.max_speed)
    return LPBatch(A=torch.cat([sa, a], dim=1), b=torch.cat([sb, b], dim=1),
                   c=c, m_valid=(nb.count + orca.SPEED_ROWS).to(torch.int32))


class _Graphs:
    """The build on a card as two CUDA graphs, the grid and then the rows:
    a step's small launches cost the host two replays and four copies.
    Inputs and outputs are the graphs' own tensors; a replay overwrites the
    last one's outputs, in stream order.  The first calls, outside the
    capture, build and load the grid's kernel; ``grid_launches`` is the
    kernel's launches in the grid graph, added to its count a replay."""

    def __init__(self, state: CrowdState, params: CrowdParams):
        self.inputs = [t.clone() for t in (state.pos, state.vel, state.goal,
                                           state.eps)]
        pos = self.inputs[0]
        dev = pos.device
        side = torch.cuda.Stream(dev)      # the first calls, outside capture
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            _rows(*self.inputs, _neighbours(pos, params), params)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.grid, self.orca = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        before = neighbours_cuda.launches
        with torch.cuda.graph(self.grid):
            self.nb = _neighbours(pos, params)
        self.grid_launches = neighbours_cuda.launches - before
        add_launches(-self.grid_launches)   # captured, not launched
        with torch.cuda.graph(self.orca, pool=self.grid.pool()):
            self.lp = _rows(*self.inputs, self.nb, params)

    def load(self, state: CrowdState) -> None:
        for dst, src in zip(self.inputs, (state.pos, state.vel, state.goal,
                                          state.eps)):
            dst.copy_(src)


def build(state: CrowdState, params: CrowdParams,
          parent=None) -> Tuple[LPBatch, grid.Neighbours]:
    """Every agent's LP (``m_valid`` = 8 + its neighbours): the octagon's
    rows first, then one ORCA row a neighbour, nearest first; the rest
    padding (``0 . x <= 1``).  ``parent``: the ``crowd.build`` span the
    stages record under.  On a card the build is replayed from CUDA
    graphs captured at the first call (the same kernels), and what it
    returns is overwritten by the next build of the same crowd."""
    graphs = None
    if state.pos.device.type == "cuda":
        graphs = state.graphs.get(params)
        if graphs is None:
            graphs = state.graphs[params] = _Graphs(state, params)
        graphs.load(state)
    st = stage(parent, None, "crowd.neighbours")
    if graphs is None:
        nb = _neighbours(state.pos, params)
    else:
        graphs.grid.replay()
        add_launches(graphs.grid_launches)
        nb = graphs.nb
    st = stage(parent, st, "crowd.orca")
    if graphs is None:
        lp = _rows(state.pos, state.vel, state.goal, state.eps, nb, params)
    else:
        graphs.orca.replay()
        lp = graphs.lp
    stage(parent, st, None)
    return lp, nb


def apply(state: CrowdState, x: torch.Tensor, feasible: torch.Tensor,
          params: CrowdParams, nb: grid.Neighbours) -> CrowdState:
    """``v = x`` where the LP is feasible, else 0 (the agent stops); then
    ``p += dt v``."""
    vel = torch.where(feasible[:, None], x, torch.zeros_like(x))
    return dataclasses.replace(
        state, pos=state.pos + params.time_step * vel, vel=vel,
        step=state.step + 1, unplaced=state.unplaced + nb.unplaced)


def _open(state: CrowdState):
    top = open_span("crowd.step")
    if top is not None:
        top.attrs.update(n_agents=state.n_agents, episode_step=state.step)
    return top


def _build(state, params, top):
    st = stage(top, None, "crowd.build")
    lp, nb = build(state, params, st)
    return lp, nb, st


def step_direct(state: CrowdState, solver, params: CrowdParams
                ) -> Tuple[CrowdState, LPBatch, LPSolution]:
    """One step with one ``solver.solve`` of every agent's LP; no host
    sync.  Returns the new state, the step's LPs and their answers."""
    top = _open(state)
    try:
        lp, nb, st = _build(state, params, top)
        st = stage(top, st, "crowd.solve")
        token = set_current_span(st) if st is not None else None
        try:
            sol = solver.solve(lp)
        finally:
            if token is not None:
                reset_current_span(token)
        st = stage(top, st, "crowd.apply")
        new = apply(state, sol.x, sol.feasible, params, nb)
        stage(top, st, None)
        return new, lp, sol
    finally:
        close_span(top)


def step_served(state: CrowdState, sched, params: CrowdParams
                ) -> Tuple[CrowdState, LPBatch, LPSolution]:
    """One step through ``sched``: every agent's LP by ``submit_many``,
    a ``flush``, the futures' answers back onto the device; returns as
    :func:`step_direct` does.  Raises where the grid could not place
    every agent."""
    top = _open(state)
    try:
        lp, nb, st = _build(state, params, top)
        st = stage(top, st, "crowd.submit")
        mv = lp.m_valid.cpu().numpy()
        over, unplaced = (int(v) for v in torch.stack(
            [nb.over_cells, state.unplaced + nb.unplaced]).cpu())
        if unplaced:
            raise RuntimeError(
                f"crowd: {unplaced} agents next to a grid cell over its "
                f"capacity {params.capacity} beyond the second pass's "
                f"{params.fallback}")
        futs = sched.submit_many(lp.A.cpu().numpy(), lp.b.cpu().numpy(),
                                 lp.c.cpu().numpy(), mv)
        sched.flush()
        st = stage(top, st, "crowd.wait")
        res = [f.result(timeout=RESULT_TIMEOUT_S) for f in futs]
        n = len(res)
        x = np.stack([r.x for r in res])
        feas = np.fromiter((r.feasible for r in res), dtype=bool, count=n)
        obj = np.fromiter((r.objective for r in res), dtype=np.float64,
                          count=n)
        dev = state.pos.device
        sol = LPSolution(x=torch.from_numpy(x).to(dev, state.pos.dtype),
                         feasible=torch.from_numpy(feas).to(dev),
                         objective=torch.from_numpy(obj).to(
                             dev, state.pos.dtype))
        if top is not None:
            top.attrs.update(rows=int(mv.sum()), n_infeasible=n - int(
                feas.sum()), n_unsure_cells=over)
        st = stage(top, st, "crowd.apply")
        new = apply(state, sol.x, sol.feasible, params, nb)
        stage(top, st, None)
        return new, lp, sol
    finally:
        close_span(top)
