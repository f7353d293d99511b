"""repro_torch.crowd — ORCA collision avoidance on the port's entry points.

The paper's §5 use: a pedestrian simulation in which every agent solves
one small 2-D LP a step.  The model is ORCA (van den Berg, Guy, Lin,
Manocha, *Reciprocal n-Body Collision Avoidance*, ISRR 2009), with the
agent-agent half-planes of RVO2's ``Agent::computeNewVelocity``.  A step:

    grid      each agent's nearest neighbours within ``neighbor_dist``,
              at most ``max_neighbors``, from a uniform grid on the device
              (no N x N tensor, no host sync; on a card one hand-written
              kernel scans the agents sorted by cell)
    orca      one half-plane a neighbour from relative position and
              velocity (cut-off circle, legs, overlap), the objective
              towards the goal and eight rows of a speed octagon: one
              ``LPBatch`` of every agent, ``m_valid`` 8 to 18
    step      the solve, through ``Solver.solve`` (``step_direct``) or
              ``BatchScheduler.submit_many`` (``step_served``), and the
              velocity and position update

Both step functions give the same trajectories in bits on the same start.
Spans (``crowd.step`` and its stages) record into the process default
tracer while a ``torch.profiler`` session records, as the solver's do.
"""
from repro_torch.crowd.grid import neighbours
from repro_torch.crowd.orca import orca_rows
from repro_torch.crowd.step import (CrowdParams, CrowdState, apply, build,
                                    step_direct, step_served)

__all__ = [
    "CrowdParams", "CrowdState", "apply", "build", "neighbours",
    "orca_rows", "step_direct", "step_served",
]
