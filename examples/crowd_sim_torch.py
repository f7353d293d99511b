"""Pedestrian collision avoidance with batch 2-D LPs — the paper's own
motivating application (section 5: "A practical use of the RGB algorithm
has been applied to an early model of pedestrian simulation"), on the
PyTorch/CUDA port.

Each agent solves one LP per time step: maximise progress along its
preferred direction subject to one half-plane constraint per neighbour
(an ORCA-style linear avoidance constraint) and the speed box.

By default each agent *submits its own LP* to the
``repro_torch.serve_lp`` scheduler, which fuses them into one bucketed
batch per step — the serving path a multi-tenant simulation would use.
``--direct`` solves the whole step as one batch through a ``Solver``;
both produce the same trajectories and print the same step lines.

Everything stays on the device: the constraints (pairwise differences,
the ``K_NEIGH`` nearest by ``topk``), the solve (the CUDA kernel on the
card, ``backend="rgb"`` on the CPU, which must be asked for) and the
clearance check, which at 16,384 agents would be a 2.1 GB float64 matrix
on the host.

    PYTHONPATH=src python examples/crowd_sim_torch.py --agents 256 --steps 120
    PYTHONPATH=src python examples/crowd_sim_torch.py --direct
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import LPBatch
from repro_torch.device import as_device
from repro_torch.serve_lp import BatchScheduler
from repro_torch.solver import SolverSpec

RADIUS = 0.3     # agent radius
V_MAX = 1.5      # speed box (the solver's M bound)
TAU = 2.0        # avoidance horizon
K_NEIGH = 8      # constraints per agent (nearest neighbours)


def spec_for(device: torch.device) -> SolverSpec:
    """One spec for both paths, so their trajectories match: the CUDA
    kernel on a card (the reference's ``rgb`` would launch no kernel
    there), ``rgb`` on the CPU."""
    return SolverSpec(backend="kernel" if device.type == "cuda" else "rgb",
                      tile=8, chunk=64, M=V_MAX)


def spawn(n: int, seed: int = 0):
    """Two opposing groups crossing (the classic stress test); grid spawn
    with jitter guarantees initial clearance > 2r.  Numpy float32
    ``(pos, goal)``, the reference's draws."""
    rng = np.random.default_rng(seed)
    half = n // 2
    rows = int(np.ceil(np.sqrt(half)))

    def grid(x0):
        ij = np.stack(np.meshgrid(np.arange(rows), np.arange(rows)),
                      -1).reshape(-1, 2)[:half]
        p = ij * 1.0 + rng.uniform(-0.15, 0.15, (half, 2))
        p[:, 0] += x0
        p[:, 1] -= rows / 2
        return p

    pos = np.concatenate([grid(-12.0), grid(6.0)]).astype(np.float32)
    goal = np.concatenate([np.tile([9.0, 0.0], (half, 1)),
                           np.tile([-9.0, 0.0], (n - half, 1))]
                          ).astype(np.float32)
    return pos, goal


def nearest(pos: torch.Tensor):
    """Each agent's ``K_NEIGH`` nearest neighbours, nearest first:
    ``(idx (N, K), distance (N, K), unit direction (N, K, 2))``."""
    diff = pos[None, :, :] - pos[:, None, :]              # (N, N, 2)
    dist = torch.linalg.vector_norm(diff, dim=-1) + 1e-9
    dist.fill_diagonal_(float("inf"))
    _, idx = torch.topk(-dist, K_NEIGH, dim=1)
    d_k = torch.gather(dist, 1, idx)
    n_k = torch.gather(diff, 1, idx[..., None].expand(-1, -1, 2)) \
        / d_k[..., None]
    return idx, d_k, n_k


def step_constraints(pos: torch.Tensor, vel_pref: torch.Tensor) -> LPBatch:
    """Build each agent's LP: A v <= b for its K nearest neighbours."""
    _, d_k, n_k = nearest(pos)
    # closing-speed limit: v . n <= (gap)/tau  (gap = dist - 2r)
    gap = torch.clamp(d_k - 2 * RADIUS, min=1e-3)
    c = vel_pref / (torch.linalg.vector_norm(vel_pref, dim=-1, keepdim=True)
                    + 1e-9)
    return LPBatch(A=n_k, b=gap / TAU, c=c,
                   m_valid=torch.full((pos.shape[0],), K_NEIGH,
                                      dtype=torch.int32, device=pos.device))


def apply_velocities(pos: torch.Tensor, x: torch.Tensor,
                     feasible: torch.Tensor) -> torch.Tensor:
    """Position update from solved velocities; infeasible (overcrowded)
    agents stop for a step."""
    v = torch.where(feasible[:, None], x, torch.zeros_like(x))
    speed = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    v = torch.where(speed > V_MAX, v * V_MAX / speed, v)
    return pos + 0.1 * v


def sim_step(pos: torch.Tensor, goal: torch.Tensor, solver) -> torch.Tensor:
    """The direct path: one batched solve of every agent's LP, on the
    device ``pos`` lies on, with no host sync."""
    sol = solver(step_constraints(pos, goal - pos))
    return apply_velocities(pos, sol.x, sol.feasible)


def sim_step_served(pos: torch.Tensor, goal: torch.Tensor,
                    sched: BatchScheduler) -> torch.Tensor:
    """One step through the serving path: every agent submits its own LP;
    the scheduler fuses them, solves, and scatters results back."""
    lp = step_constraints(pos, goal - pos)
    futs = sched.submit_many(lp.A.cpu().numpy(), lp.b.cpu().numpy(),
                             lp.c.cpu().numpy())
    sched.flush()
    res = [f.result(timeout=60.0) for f in futs]
    x = torch.as_tensor(np.stack([r.x for r in res]), device=pos.device)
    feasible = torch.as_tensor(np.array([r.feasible for r in res]),
                               device=pos.device)
    return apply_velocities(pos, x, feasible)


def min_pairwise_distance(pos: torch.Tensor,
                          rows: int = 2048) -> torch.Tensor:
    """The smallest distance between two agents, on ``pos``'s device, a
    block of ``rows`` agents at a time (a 0-d tensor: no host sync)."""
    N = pos.shape[0]
    mins = []
    for lo in range(0, N, rows):
        hi = min(lo + rows, N)
        d = torch.linalg.vector_norm(pos[lo:hi, None] - pos[None], dim=-1)
        i = torch.arange(hi - lo, device=pos.device)
        d[i, i + lo] = float("inf")
        mins.append(d.min())
    return torch.stack(mins).min()


def step_line(t: int, pos: torch.Tensor, goal: torch.Tensor):
    """The reference's step line and the step's clearance."""
    gap = float(min_pairwise_distance(pos))
    prog = float(torch.linalg.vector_norm(goal - pos, dim=-1).mean())
    return (f"step {t:4d}: min pairwise distance {gap:.3f} "
            f"(2r = {2*RADIUS}), mean dist-to-goal {prog:.2f}"), gap


def main(argv=None, *, device=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--agents", type=int, default=256)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--direct", action="store_true",
                    help="one batched solve a step (no scheduler)")
    args = ap.parse_args(argv)
    dev = as_device(device)
    spec = spec_for(dev)
    pos_np, goal_np = spawn(args.agents, args.seed)
    pos = torch.as_tensor(pos_np, device=dev)
    goal = torch.as_tensor(goal_np, device=dev)
    sched = solver = None
    if args.direct:
        solver = spec.build(device=dev)
    else:
        # The scheduler solves with the exact spec the direct path uses.
        sched = BatchScheduler(spec, max_batch=args.agents, devices=[dev])

    lines, min_gap = [], np.inf
    try:
        for t in range(args.steps):
            pos = (sim_step(pos, goal, solver) if args.direct
                   else sim_step_served(pos, goal, sched))
            if t % 20 == 0 or t == args.steps - 1:
                line, gap = step_line(t, pos, goal)
                min_gap = min(min_gap, gap)
                lines.append(line)
                print(line)
        if sched is not None:
            print("[serve_lp] " + sched.metrics.format_report(
                sched.cache.stats()).replace("\n", "\n[serve_lp] "))
    finally:
        if sched is not None:
            sched.close()
    print(f"done: worst clearance {min_gap:.3f} "
          f"({'NO collisions' if min_gap > 2*RADIUS*0.95 else 'contacts'})")
    return {"lines": lines, "min_gap": min_gap, "pos": pos}


if __name__ == "__main__":
    main()
