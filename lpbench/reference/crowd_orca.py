"""The crowd deployment's plain reference: each agent's ORCA LP rebuilt from
a state, and what an answer to it may be.

From positions, velocities, goals and perturbations (the program's float32
state, taken as exact), in float64 unless asked otherwise:

* neighbours by brute force, a block of agents at a time: every ``j != i``
  with ``|p_j - p_i|^2 < neighbor_dist^2``, the ``max_neighbors`` nearest,
  ties broken by index;
* for each, the ORCA half-plane of RVO2's ``Agent::computeNewVelocity``
  (cut-off circle, left or right leg, overlap; the formulas are those of
  ``repro_torch.crowd.orca``, written out again here);
* the objective ``unit(goal - p + eps)`` and the eight rows of the speed
  octagon with one vertex on it.

The rows are solved by :mod:`lpbench.reference.lp2d`, whose ``solve``,
``classify`` and ``violation`` this module gives as its own, so that
:class:`lpbench.judge.Tally` takes it unchanged; :func:`add` folds a step's
answers into a tally.

**Decisions within a band.**  The program makes each decision that picks a
row again, in float32.  Where a decision lies within a band of its
threshold that float32 rounding of the same inputs could cross, the
reference does not pick:

* a neighbour in or out of range, or the last neighbour kept against the
  next: the agent is **unsure** and left out of the comparison;
* a row whose normal is ``w / |w|`` with ``|w|`` so small that rounding of
  ``w`` turns it by more than ``TURN``: unsure too;
* overlap or not, cut-off circle or legs, left leg or right: the pair is
  **open** where the rows it chooses between differ by more than ``SAME``
  anywhere in the speed disc.  An open pair's candidate rows all enter the
  agent's *tight* LP and none its *relaxed* one.  Whatever the program
  chose lies between the two: the answer is held to the tight LP's
  optimum from below, the relaxed LP's from above, and the relaxed LP's
  rows.  Jammed agents come to rest at contact (``|p| = R``), where the
  overlap test is decided by rounding alone.

Each band is a count of float32 roundings of the magnitudes that enter
the decision, not a tolerance on the answer.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from lpbench.reference.lp2d import classify, solve, violation  # noqa: F401

# float32's unit roundoff: the program computes every row in float32.
U32 = 2.0 ** -24
# A decision is within its band at 64 roundings of the magnitudes that
# enter it (a squared distance: two products and a sum, so 3 at most; the
# terms of w: 3 each; a product of two: 2 more): 64 leaves a margin of 8.
ROUNDINGS = 64
BAND = ROUNDINGS * U32
# A normal w / |w| is unsure where rounding of w's terms could turn it by
# more than 2^-10 (a thousandth of the row's offset at the speed bound).
TURN = 2.0 ** -10
# Candidate rows that differ by at most this (m/s) anywhere in the speed
# disc are one row: at contact with the velocities equal, the cut-off
# circle, both legs and the overlap give one row.
SAME = 2.0 ** -10
SPEED_ROWS = 8
# The candidates a pair's row is chosen from: overlap, cut-off, left, right.
BRANCHES = 4
# Agents a block of the brute force holds (a (block, N) matrix).
BLOCK = 1024


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


def neighbours(pos, *, dist: float, k: int, dtype=torch.float64,
               block: int = BLOCK):
    """``(idx (N, k), valid (N, k), unsure (N,))`` by brute force: the
    ``k`` nearest ``j != i`` with ``|p_j - p_i|^2 < dist^2``, nearest
    first, ties by index; unsure where any ``|p_j - p_i|^2`` lies within
    ``BAND`` of ``dist^2``, or the ``k``-th and ``k+1``-th in range within
    ``BAND`` of each other."""
    p = pos.to(dtype)
    N = p.shape[0]
    dev = p.device
    lim = dist * dist
    take = min(k + 1, max(N - 1, 1))
    idx_out, valid_out, unsure_out = [], [], []
    for lo in range(0, N, block):
        hi = min(lo + block, N)
        d = p[None, :, :] - p[lo:hi, None, :]
        d2 = _dot(d, d)
        me = torch.arange(lo, hi, device=dev)
        d2[torch.arange(hi - lo, device=dev), me] = math.inf
        unsure = ((d2 - lim).abs() <= BAND * lim).any(dim=1)
        d2 = torch.where(d2 < lim, d2, math.inf)
        val, j = torch.topk(d2, take, dim=1, largest=False)
        # ties by index: order by index, then stably by distance
        o = torch.argsort(j, dim=1)
        val, j = val.gather(1, o), j.gather(1, o)
        o = torch.argsort(val, dim=1, stable=True)
        val, j = val.gather(1, o), j.gather(1, o)
        if take > k:
            a, b = val[:, k - 1], val[:, k]
            unsure |= torch.isfinite(b) & (b - a <= BAND * b)
        val, j = val[:, :k], j[:, :k]
        if val.shape[1] < k:
            pad = k - val.shape[1]
            val = torch.nn.functional.pad(val, (0, pad), value=math.inf)
            j = torch.nn.functional.pad(j, (0, pad))
        valid = torch.isfinite(val)
        idx_out.append(torch.where(valid, j, 0))
        valid_out.append(valid)
        unsure_out.append(unsure)
    return (torch.cat(idx_out), torch.cat(valid_out), torch.cat(unsure_out))


def _line(w):
    wl = torch.sqrt(_dot(w, w))
    n = w / wl[..., None]
    return wl, n, torch.stack([n[..., 1], -n[..., 0]], dim=-1)


def _row(d, q):
    a = torch.stack([d[..., 1], -d[..., 0]], dim=-1)
    return a, _dot(a, q)


def orca(pos, vel, idx, *, radius: float, tau: float, dt: float,
         speed: float, dtype=torch.float64) -> Dict:
    """Agent ``i``'s half-plane against each neighbour ``idx[i, s]``:

    * ``A (N, k, 2)``, ``b (N, k)``: the row the reference picks, and
      ``pick (N, k)`` which candidate it is;
    * ``cand_A (N, k, 4, 2)``, ``cand_b (N, k, 4)``: the overlap, cut-off,
      left-leg and right-leg rows, and ``cand (N, k, 4)``: those a choice
      within the bands may pick (the picked one always);
    * ``open (N, k)``: a candidate differs from the pick by more than
      ``SAME`` in the disc of radius ``speed``;
    * ``unsure (N, k)``: a candidate's normal is not resolved (``TURN``).
    """
    p0 = pos.to(dtype)
    v0 = vel.to(dtype)
    R = 2.0 * radius
    p = p0[idx] - p0[:, None, :]
    u_rel = v0[:, None, :] - v0[idx]
    dist2 = _dot(p, p)
    pl = torch.sqrt(dist2)
    ul = torch.sqrt(_dot(u_rel, u_rel))
    vi = v0[:, None, :]

    wl_o, n_o, d_o = _line(u_rel - p * (1.0 / dt))
    w = u_rel - p * (1.0 / tau)
    wl, n, d_cut = _line(w)
    cands = [_row(d_o, vi + 0.5 * (R / dt - wl_o)[..., None] * n_o),
             _row(d_cut, vi + 0.5 * (R / tau - wl)[..., None] * n)]
    leg = torch.sqrt(torch.clamp(dist2 - R * R, min=0.0))
    px, py = p[..., 0], p[..., 1]
    for d_leg in (torch.stack([px * leg - py * R, px * R + py * leg], dim=-1),
                  -torch.stack([px * leg + py * R, -px * R + py * leg],
                               dim=-1)):
        d_leg = d_leg / dist2[..., None]
        u_leg = _dot(u_rel, d_leg)[..., None] * d_leg - u_rel
        cands.append(_row(d_leg, vi + 0.5 * u_leg))
    cand_A = torch.stack([a for a, _ in cands], dim=2)
    cand_b = torch.stack([b for _, b in cands], dim=2)

    dot1 = _dot(w, p)
    g = dot1 * dot1 - R * R * wl * wl
    det = px * w[..., 1] - py * w[..., 0]
    apart = dist2 > R * R
    cut = (dot1 < 0) & (g > 0)
    left = det > 0
    pick = torch.where(~apart, 0, torch.where(cut, 1, torch.where(
        left, 2, 3)))
    A = cand_A.gather(2, pick[..., None, None].expand(*pick.shape, 1, 2))[
        ..., 0, :]
    b = cand_b.gather(2, pick[..., None])[..., 0]

    # The bands.  e_w bounds float32's error in w's terms; each product
    # adds BAND of its magnitude.
    e_w = BAND * (ul + pl / tau)
    e_dot = e_w * pl + BAND * wl * pl
    e_g = 2.0 * dot1.abs() * e_dot + 2.0 * R * R * wl * e_w + BAND * (
        dot1 * dot1 + R * R * wl * wl)
    e_det = e_w * pl + BAND * pl * wl
    e_wo = BAND * (ul + pl / dt)
    near_overlap = (dist2 - R * R).abs() <= BAND * R * R
    near_cut = (g.abs() <= e_g) | (dot1.abs() <= e_dot)
    near_left = det.abs() <= e_det
    far = apart | near_overlap
    use_cut = far & (cut | near_cut)
    use_legs = far & (~cut | near_cut)
    cand = torch.stack([~apart | near_overlap, use_cut,
                        use_legs & (left | near_left),
                        use_legs & (~left | near_left)], dim=2)
    da = cand_A - A[..., None, :]
    diff = speed * torch.sqrt(_dot(da, da)) + (cand_b - b[..., None]).abs()
    is_open = (cand & (diff > SAME)).any(dim=2)
    unsure = (use_cut & (wl <= e_w / TURN)) | (cand[..., 0] & (
        wl_o <= e_wo / TURN))
    return {"A": A, "b": b, "pick": pick, "cand_A": cand_A,
            "cand_b": cand_b, "cand": cand, "open": is_open,
            "unsure": unsure}


def objective(pos, goal, eps, dtype=torch.float64):
    """``unit(goal - p + eps)``, scaled by its largest component first so
    that no square overflows a narrow ``dtype``."""
    w = goal.to(dtype) - pos.to(dtype) + eps.to(dtype)
    w = w / w.abs().amax(dim=1, keepdim=True)
    return w / torch.sqrt(_dot(w, w))[:, None]


def speed_rows(c, max_speed: float):
    turns = torch.tensor([(2 * k + 1) * math.pi / SPEED_ROWS
                          for k in range(SPEED_ROWS)], dtype=torch.float64,
                         device=c.device)
    th = torch.atan2(c[:, 1:2].double(), c[:, 0:1].double()) + turns
    A = torch.stack([torch.cos(th), torch.sin(th)], dim=2).to(c.dtype)
    b = torch.full(A.shape[:2], max_speed * math.cos(math.pi / SPEED_ROWS),
                   dtype=c.dtype, device=c.device)
    return A, b


def _compact(A, b, keep):
    """The rows ``keep`` holds moved to the front, in order, the rest made
    padding ``0 . x <= 1``: ``(A, b, m_valid)``."""
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    A = A.gather(1, order[..., None].expand(*order.shape, 2))
    b = b.gather(1, order)
    kept = keep.gather(1, order)
    return (torch.where(kept[..., None], A, 0.0), torch.where(kept, b, 1.0),
            keep.sum(dim=1).to(torch.int32))


def rows(pos, vel, goal, eps, params: Dict, dtype=torch.float64) -> Dict:
    """Every agent's LP from a state, the octagon first, then the rows of
    its neighbours, nearest first, padding ``0 . x <= 1``:

    * ``A (N, 8 + k, 2)``, ``b``, ``m_valid`` (int32): the relaxed LP, the
      octagon and the rows of the pairs not open (with none open, the
      agent's LP);
    * ``A_tight (N, 8 + 4 k, 2)``, ``b_tight``, ``m_tight``: the tight LP,
      the relaxed one's rows and every candidate row of the open pairs;
    * ``c (N, 2)``; ``unsure (N,)``; ``open (N,)``: open pairs an agent.

    ``params``: ``neighborDist``, ``maxNeighbors``, ``timeHorizon``,
    ``radius``, ``maxSpeed`` (RVO2's names) and ``timeStep``."""
    k = int(params["maxNeighbors"])
    idx, valid, unsure = neighbours(pos, dist=float(params["neighborDist"]),
                                    k=k, dtype=dtype)
    o = orca(pos, vel, idx, radius=float(params["radius"]),
             tau=float(params["timeHorizon"]), dt=float(params["timeStep"]),
             speed=float(params["maxSpeed"]), dtype=dtype)
    unsure = unsure | (o["unsure"] & valid).any(dim=1)
    is_open = o["open"] & valid
    c = objective(pos, goal, eps, dtype)
    sa, sb = speed_rows(c, float(params["maxSpeed"]))
    N = sa.shape[0]
    octagon = torch.ones(sb.shape, dtype=torch.bool, device=sb.device)
    A, b, m = _compact(torch.cat([sa, o["A"]], dim=1),
                       torch.cat([sb, o["b"]], dim=1),
                       torch.cat([octagon, valid & ~is_open], dim=1))
    picked = torch.arange(BRANCHES, device=sa.device) == o["pick"][..., None]
    tight = o["cand"] & valid[..., None] & (is_open[..., None] | picked)
    At, bt, mt = _compact(
        torch.cat([sa, o["cand_A"].reshape(N, -1, 2)], dim=1),
        torch.cat([sb, o["cand_b"].reshape(N, -1)], dim=1),
        torch.cat([octagon, tight.reshape(N, -1)], dim=1))
    return {"A": A, "b": b, "m_valid": m, "A_tight": At, "b_tight": bt,
            "m_tight": mt, "c": c, "unsure": unsure,
            "open": is_open.sum(dim=1)}


def add(tally, ref: Dict, x, feasible, objective, config: Dict) -> None:
    """Fold answers to the LPs of :func:`rows` (all agents, or those of
    ``ref``'s rows taken) into ``tally`` (:class:`lpbench.judge.Tally`):
    the flag is wrong where the tight LP is surely feasible and the answer
    says not, or the relaxed LP surely infeasible and it says so; the
    objective is held between the tight LP's optimum and the relaxed
    LP's, the point to the relaxed LP's rows."""
    M = float(config["M"])
    c = ref["c"]
    tight = tally.classify(ref["A_tight"], ref["b_tight"], c, ref["m_tight"],
                           config)
    loose = tally.classify(ref["A"], ref["b"], c, ref["m_valid"], config)
    verdict = {"sure_feasible": tight["sure_feasible"],
               "sure_infeasible": loose["sure_infeasible"],
               "objective": tight["objective"],
               "objective_hi": torch.maximum(loose["objective_hi"],
                                             tight["objective"])}
    tally.add(verdict, ref["A"], ref["b"], c, ref["m_valid"], x, feasible,
              objective, M)
