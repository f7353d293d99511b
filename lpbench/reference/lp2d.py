"""A plain 2-D LP solver: the benchmark's reference.

    maximise  c . x   subject to   a_i . x <= b_i  (i < m_valid),
                                   -M <= x_0, x_1 <= M.

It shares no algorithm with the program (which runs Seidel's incremental
method).  Each problem is turned to the frame of its objective: ``u`` along
``c``, ``v`` across it, a point ``x = s v + t u``.  A constraint then reads
``p s + q t <= r`` with ``p = a.v``, ``q = a.u``.  Rows with ``q > 0`` cap
``t`` from above, rows with ``q < 0`` from below, and rows parallel to the
objective bound ``s``.  So the best ``t`` at ``s`` is the concave envelope
``U(s) = min (r - p s) / q`` over the capping rows, the least ``t`` is the
convex ``Lo(s)``, and the problem is the 1-D concave one

    maximise U(s)  over  { s in [s_lo, s_hi] : U(s) - Lo(s) >= 0 },

which bisection on the sign of a slope solves: first the largest
``U - Lo`` (feasibility), then the largest ``U``, then, where that point is
infeasible, the edge of the feasible interval between the two.  Every
constraint is scaled to a unit normal first, so a slack is a distance.

Plain PyTorch on whatever device the tensors lie, in blocks of problems so
that it fits (by default about 2^22 rows a block, and 2,048 problems or
more); float64 unless asked otherwise (the control asks for the precision
below the configuration's).  It imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

# Rows whose |q| is below this are taken as parallel to the objective.
PARALLEL = 1e-12
# Bisection steps: enough for float64 to stop moving on an interval of
# 8 M = 80,000.
STEPS = 96
# Rows (constraints and the box) a block holds by default.  Each problem is
# solved alone, so the block changes only how many launches a solve takes.
ROWS = 2 ** 22


def _block(block, m: int) -> int:
    """``block``, or the default number of problems a block holds at
    ``m`` constraints."""
    return int(block) if block else max(2048, ROWS // (m + 4))


def _rows(A, b, mv, M, dt):
    """Unit-normal rows of the valid constraints and the four box rows:
    ``(ax, ay, r, keep, zero_b)``, where ``zero_b`` is the least offset of a
    valid zero-normal row (``0 <= b``), ``+inf`` when there is none."""
    n, m, _ = A.shape
    dev = A.device
    A = A.to(dt)
    b = b.to(dt)
    valid = torch.arange(m, device=dev)[None, :] < mv.to(dev)[:, None]
    norm = torch.sqrt(A[..., 0] * A[..., 0] + A[..., 1] * A[..., 1])
    zero = norm == 0
    safe = torch.where(zero, torch.ones_like(norm), norm)
    inf = torch.tensor(float("inf"), dtype=dt, device=dev)
    zero_b = torch.where(valid & zero, b, inf).amin(dim=1) if m else \
        torch.full((n,), float("inf"), dtype=dt, device=dev)
    box = torch.tensor([[1.0, -1.0, 0.0, 0.0], [0.0, 0.0, 1.0, -1.0]],
                       dtype=dt, device=dev)
    ax = torch.cat([A[..., 0] / safe, box[0].expand(n, 4)], dim=1)
    ay = torch.cat([A[..., 1] / safe, box[1].expand(n, 4)], dim=1)
    r = torch.cat([b / safe, torch.full((n, 4), float(M), dtype=dt,
                                        device=dev)], dim=1)
    keep = torch.cat([valid & ~zero,
                      torch.ones((n, 4), dtype=torch.bool, device=dev)],
                     dim=1)
    return ax, ay, r, keep, zero_b


def _solve_block(A, b, c, mv, M: float, slack: float, dt) -> Dict:
    dev = A.device
    ax, ay, r, keep, zero_b = _rows(A, b, mv, M, dt)
    r = r + slack
    c = c.to(dt)
    cn = torch.sqrt(c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1])
    ux = c[:, 0] / cn
    uy = c[:, 1] / cn
    vx, vy = -uy, ux
    p = ax * vx[:, None] + ay * vy[:, None]
    q = ax * ux[:, None] + ay * uy[:, None]
    up = keep & (q > PARALLEL)
    down = keep & (q < -PARALLEL)
    par = keep & ~up & ~down
    qs = torch.where(up | down, q, torch.ones_like(q))
    inf = torch.tensor(float("inf"), dtype=dt, device=dev)
    big = 4.0 * float(M)
    # Parallel rows bound s: p s <= r (|p| = 1 for a unit normal).
    s_hi = torch.where(par & (p > 0), r / torch.where(par, p, 1.0), inf)
    s_lo = torch.where(par & (p < 0), r / torch.where(par, p, 1.0), -inf)
    s_hi = torch.clamp(s_hi.amin(dim=1), max=big)
    s_lo = torch.clamp(s_lo.amax(dim=1), min=-big)
    slope_rows = -p / qs

    def envelope(s):
        """``U(s)``, ``Lo(s)`` and their slopes at ``s`` (n,)."""
        t = (r - p * s[:, None]) / qs
        tu = torch.where(up, t, inf)
        td = torch.where(down, t, -inf)
        ku = tu.argmin(dim=1, keepdim=True)
        kd = td.argmax(dim=1, keepdim=True)
        return (tu.gather(1, ku)[:, 0], td.gather(1, kd)[:, 0],
                slope_rows.gather(1, ku)[:, 0],
                slope_rows.gather(1, kd)[:, 0])

    def argmax(slope_of, lo, hi):
        for _ in range(STEPS):
            mid = (lo + hi) * 0.5
            rising = slope_of(mid) > 0
            lo = torch.where(rising, mid, lo)
            hi = torch.where(rising, hi, mid)
        return (lo + hi) * 0.5

    def gap(s):
        U, Lo, _, _ = envelope(s)
        return U - Lo

    def slope_gap(s):
        _, _, su, sd = envelope(s)
        return su - sd

    def slope_top(s):
        return envelope(s)[2]

    lo = torch.minimum(s_lo, s_hi)
    s_f = argmax(slope_gap, lo, s_hi)
    feasible = (s_lo <= s_hi) & (zero_b + slack >= 0) & (gap(s_f) >= 0)
    s_u = argmax(slope_top, lo, s_hi)
    # Where the top of U is infeasible, walk from s_f (feasible) towards
    # s_u to the edge of the feasible interval.
    ok = gap(s_u) >= 0
    a, z = s_f, s_u
    for _ in range(STEPS):
        mid = (a + z) * 0.5
        good = gap(mid) >= 0
        a = torch.where(good, mid, a)
        z = torch.where(good, z, mid)
    s = torch.where(ok, s_u, a)
    t = envelope(s)[0]
    x = torch.stack([s * vx + t * ux, s * vy + t * uy], dim=1)
    obj = c[:, 0] * x[:, 0] + c[:, 1] * x[:, 1]
    return {"feasible": feasible, "x": x, "objective": obj}


def solve(A, b, c, m_valid, *, M: float, slack: float = 0.0,
          dtype=torch.float64, block: Optional[int] = None) -> Dict:
    """Solve every problem of ``A (n, m, 2)``, ``b (n, m)``, ``c (n, 2)``,
    ``m_valid (n,)`` with each constraint loosened by ``slack`` (a distance,
    after scaling to unit normals; negative tightens).  Returns
    ``feasible (n,)``, ``x (n, 2)`` and ``objective (n,)`` in ``dtype``
    (``x`` and ``objective`` are meaningless where infeasible)."""
    n = A.shape[0]
    block = _block(block, A.shape[1])
    outs = [_solve_block(A[i:i + block], b[i:i + block], c[i:i + block],
                         m_valid[i:i + block], M, slack, dtype)
            for i in range(0, n, block)]
    if not outs:
        dev = A.device
        return {"feasible": torch.zeros(0, dtype=torch.bool, device=dev),
                "x": torch.zeros((0, 2), dtype=dtype, device=dev),
                "objective": torch.zeros(0, dtype=dtype, device=dev)}
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def classify(A, b, c, m_valid, *, M: float, band: float, slacks=(),
             feasibility: float = 0.0, block: Optional[int] = None) -> Dict:
    """What an answer to each problem may say, in float64.

    ``sure_feasible``: feasible with every constraint tightened by
    ``band``; ``sure_infeasible``: infeasible with every constraint loosened
    by ``band``.  Between the two (a problem that is feasible only to within
    ``band``, as a degenerate one is after rounding) either flag is right.
    ``objective`` is the optimum of the problem as given, or, where that is
    empty, of the problem loosened by the first of ``slacks`` (then
    ``band``) at which it is not.  ``objective_hi`` is the most a point
    within ``feasibility`` of every constraint can reach: the optimum of the
    problem with each constraint loosened by it (``objective`` where
    ``feasibility`` is 0, or where that problem is empty too)."""
    exact = solve(A, b, c, m_valid, M=M, slack=0.0, block=block)
    tight = solve(A, b, c, m_valid, M=M, slack=-band, block=block)
    loose = solve(A, b, c, m_valid, M=M, slack=band, block=block)
    objective = torch.where(exact["feasible"], exact["objective"],
                            loose["objective"])
    todo = torch.nonzero(~exact["feasible"] & loose["feasible"])[:, 0]
    for slack in slacks:
        if not len(todo):
            break
        part = solve(A[todo], b[todo], c[todo], m_valid[todo], M=M,
                     slack=slack, block=block)
        hit = part["feasible"]
        objective[todo[hit]] = part["objective"][hit]
        todo = todo[~hit]
    objective_hi = objective
    if feasibility > 0:
        wide = solve(A, b, c, m_valid, M=M, slack=feasibility, block=block)
        objective_hi = torch.where(
            wide["feasible"], torch.maximum(objective, wide["objective"]),
            objective)
    return {
        "sure_feasible": tight["feasible"],
        "sure_infeasible": ~loose["feasible"],
        "objective": objective,
        "objective_hi": objective_hi,
    }


def violation(A, b, m_valid, x, *, M: float, relative: bool = True,
              block: Optional[int] = None):
    """Largest violation of ``x (n, 2)`` over each problem's unit-normal
    constraints and its box, in float64 (n,): as a share of
    ``max(1, |x|_inf)``, or with ``relative`` False the distance itself."""
    out = []
    block = _block(block, A.shape[1])
    for i in range(0, A.shape[0], block):
        ax, ay, r, keep, _ = _rows(A[i:i + block], b[i:i + block],
                                   m_valid[i:i + block], M, torch.float64)
        xb = x[i:i + block].to(torch.float64).to(ax.device)
        lhs = ax * xb[:, 0:1] + ay * xb[:, 1:2] - r
        worst = torch.where(keep, lhs, -math.inf).amax(dim=1)
        out.append(worst / torch.clamp(xb.abs().amax(dim=1), min=1.0)
                   if relative else worst)
    if not out:
        return torch.zeros(0, dtype=torch.float64, device=A.device)
    return torch.cat(out)
