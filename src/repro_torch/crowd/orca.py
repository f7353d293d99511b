"""ORCA's half-planes, the objective and the speed octagon of every agent.

For agent ``i`` and a neighbour ``j`` (RVO2 ``Agent::computeNewVelocity``,
agent-agent part): ``p = p_j - p_i``, ``u_rel = v_i - v_j``, the combined
radius ``R = r_i + r_j``, the time horizon ``tau`` and the time step
``dt``.

* ``|p|^2 > R^2``: ``w = u_rel - p / tau``.  Where ``w . p < 0`` and
  ``(w . p)^2 > R^2 |w|^2`` the velocity obstacle's **cut-off circle** is
  nearest: ``n = w / |w|``, ``u = (R / tau - |w|) n``, ``d = (n_y, -n_x)``.
  Otherwise a **leg**: ``l = sqrt(|p|^2 - R^2)``; the left leg
  ``d = (p_x l - p_y R, p_x R + p_y l) / |p|^2`` where ``det(p, w) > 0``,
  else the right ``d = -(p_x l + p_y R, -p_x R + p_y l) / |p|^2``; then
  ``u = (u_rel . d) d - u_rel``.
* ``|p|^2 <= R^2`` (**overlap**): ``w = u_rel - p / dt``, ``n = w / |w|``,
  ``u = (R / dt - |w|) n``, ``d = (n_y, -n_x)``.

The row keeps the new velocity ``v`` left of the line through
``q = v_i + u / 2`` along ``d``: ``a . v <= b`` with ``a = (d_y, -d_x)``,
``b = a . q``.  Each branch is computed for every pair and one is picked,
so a branch not taken may hold inf or nan where it is undefined.
"""
from __future__ import annotations

import math

import torch

# The octagon inscribed in the speed disc, one vertex on the objective:
# row k's normal is the objective turned by (2k + 1) pi / 8.
SPEED_ROWS = 8


def objective(pos: torch.Tensor, goal: torch.Tensor,
              eps: torch.Tensor) -> torch.Tensor:
    """``c = unit(goal - p + eps)`` (N, 2); ``(1, 0)`` where that is 0."""
    w = goal - pos + eps
    n = torch.sqrt(w[:, 0] * w[:, 0] + w[:, 1] * w[:, 1])[:, None]
    unit = torch.zeros_like(w)
    unit[:, 0] = 1.0
    return torch.where(n > 0, w / n, unit)


def speed_rows(c: torch.Tensor, max_speed: float):
    """The octagon's rows ``(A (N, 8, 2), b (N, 8))``: normals
    ``(cos, sin)(theta_c + (2k + 1) pi / 8)``, offsets
    ``max_speed cos(pi / 8)``."""
    # Made on the device in float64 and rounded once (a tensor copied
    # from the host would wait for the stream).
    turn = (2 * torch.arange(SPEED_ROWS, dtype=torch.float64,
                             device=c.device) + 1) * (math.pi / SPEED_ROWS)
    cs, sn = torch.cos(turn).to(c.dtype), torch.sin(turn).to(c.dtype)
    cx, cy = c[:, 0:1], c[:, 1:2]
    A = torch.stack([cs * cx - sn * cy, sn * cx + cs * cy], dim=2)
    b = torch.full(A.shape[:2], max_speed * math.cos(math.pi / SPEED_ROWS),
                   dtype=c.dtype, device=c.device)
    return A, b


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


def _unit_line(w):
    """``(|w|, n = w / |w|, d = (n_y, -n_x))``."""
    wl = torch.sqrt(_dot(w, w))
    n = w / wl[..., None]
    return wl, n, torch.stack([n[..., 1], -n[..., 0]], dim=-1)


def orca_rows(pos: torch.Tensor, vel: torch.Tensor, idx: torch.Tensor, *,
              radius: float, tau: float, dt: float):
    """Agent ``i``'s half-plane against each neighbour ``idx[i, s]``:
    ``(A (N, k, 2), b (N, k))``, every slot computed (mask the empty
    ones)."""
    R = 2.0 * radius
    p = pos[idx] - pos[:, None, :]
    u_rel = vel[:, None, :] - vel[idx]
    dist2 = _dot(p, p)

    # Cut-off circle and legs.
    w = u_rel - p * (1.0 / tau)
    dot1 = _dot(w, p)
    wl, n, d_cut = _unit_line(w)
    u_cut = (R / tau - wl)[..., None] * n
    leg = torch.sqrt(torch.clamp(dist2 - R * R, min=0.0))
    px, py = p[..., 0], p[..., 1]
    left = torch.stack([px * leg - py * R, px * R + py * leg], dim=-1)
    right = -torch.stack([px * leg + py * R, -px * R + py * leg], dim=-1)
    det = px * w[..., 1] - py * w[..., 0]
    d_leg = torch.where((det > 0)[..., None], left, right) / dist2[..., None]
    u_leg = _dot(u_rel, d_leg)[..., None] * d_leg - u_rel
    cut = (dot1 < 0) & (dot1 * dot1 > R * R * _dot(w, w))
    d_far = torch.where(cut[..., None], d_cut, d_leg)
    u_far = torch.where(cut[..., None], u_cut, u_leg)

    # Overlap: resolve it within one time step.
    wl_o, n_o, d_o = _unit_line(u_rel - p * (1.0 / dt))
    u_o = (R / dt - wl_o)[..., None] * n_o

    apart = (dist2 > R * R)[..., None]
    d = torch.where(apart, d_far, d_o)
    u = torch.where(apart, u_far, u_o)
    q = vel[:, None, :] + 0.5 * u
    a = torch.stack([d[..., 1], -d[..., 0]], dim=-1)
    return a, _dot(a, q)
