"""Row-form PDHG primitives for batched 2-D LPs.

Everything here operates on the packed component rows ``(a_x, a_y, b)``
— the same SoA layout :class:`~repro_torch.core.packed.PackedLPBatch`
carries and the Seidel backends consume — so the first-order backend is
matrix-free by construction: the only contact with the constraint matrix
is ``A @ x`` (two multiply-adds over rows) and ``A^T @ y`` (two row
reductions).  That is what lets ``m`` grow into the thousands where the
incremental solvers stop scaling.

Problems are the batch axis; every function is batched over ``(B, ...)``:
``ax/ay/bb (B, m)``, ``x/c (B, 2)``, ``y (B, m)``.  They are plain
PyTorch ops on whatever device the tensors lie — the reference has no
kernel here either.

The LP solved is the repo-wide contract: maximise ``c @ x`` subject to
``A x <= b`` and the box ``|x_i| <= M``.  The box is handled by
projection (not by the four explicit rows the Seidel solvers append), so
the primal iterate is always box-feasible and the dual variable for the
box never needs to be materialised — its reduced cost
``lambda = c - A^T y`` is scored against the normal cone of the box at
``x`` instead (:func:`kkt_residuals_rows`).
"""
from __future__ import annotations

import torch

# Guard for divisions / norms of quantities that may be exactly zero
# (padding problems, zero objectives).
EPS_GUARD = 1e-12


def matvec_rows(ax, ay, x):
    """``A @ x`` per problem: ``ax/ay (B, m)``, ``x (B, 2) -> (B, m)``."""
    return ax * x[:, 0:1] + ay * x[:, 1:2]


def rmatvec_rows(ax, ay, y):
    """``A^T @ y`` per problem: ``y (B, m) -> (B, 2)``."""
    return torch.stack([(ax * y).sum(dim=-1), (ay * y).sum(dim=-1)],
                       dim=-1)


def spectral_norm_rows(ax, ay):
    """Exact ``||A||_2`` per problem, ``(B,)``.

    With only two columns the Gram matrix ``A^T A`` is 2x2, so the top
    eigenvalue has a closed form — no power iteration, no Frobenius
    over-estimate (which would cost a ~sqrt(m/2) step-size haircut at
    large m).
    """
    g11 = (ax * ax).sum(dim=-1)
    g22 = (ay * ay).sum(dim=-1)
    g12 = (ax * ay).sum(dim=-1)
    half = 0.5 * (g11 + g22)
    rad = torch.sqrt(torch.clamp_min(0.25 * (g11 - g22) ** 2 + g12 * g12,
                                     0.0))
    return torch.sqrt(torch.clamp_min(half + rad, 0.0))


def pdhg_step(x, y, ax, ay, bb, c, tau, sigma, M):
    """One extrapolated PDHG iteration (Chambolle–Pock / PDLP form).

    Primal ascent on the reduced cost with projection onto the box, then
    dual ascent on the extrapolated residual with projection onto
    ``y >= 0``::

        x+ = clip(x + tau * (c - A^T y), -M, M)
        y+ = max(0, y + sigma * (A (2 x+ - x) - b))

    ``tau``/``sigma`` are per-problem ``(B,)`` step sizes (they carry the
    primal weight omega, which the restart loop adapts); ``M`` is a
    number or a ``(B, 1)`` tensor of per-problem box bounds.
    """
    lam = c - rmatvec_rows(ax, ay, y)
    x_new = torch.clamp(x + tau[:, None] * lam, -M, M)
    x_bar = 2.0 * x_new - x
    y_new = torch.clamp_min(
        y + sigma[:, None] * (matvec_rows(ax, ay, x_bar) - bb), 0.0)
    return x_new, y_new


def kkt_residuals_rows(x, y, ax, ay, bb, c, *, M, b_scale, c_scale,
                       bound_tol):
    """Relative KKT residuals of ``(x, y)`` per problem.

    Returns ``(pres, dres, compl)``, each ``(B,)``:

    * ``pres`` — primal infeasibility ``||(A x - b)_+||_inf`` over
      ``b_scale = 1 + ||b||_inf``;
    * ``dres`` — stationarity: the distance of the reduced cost
      ``lambda = c - A^T y`` from the normal cone of the box at ``x`` (a
      component at a bound may carry a reduced cost of the matching
      sign; an interior component must have zero reduced cost), over
      ``c_scale = 1 + ||c||_inf``;
    * ``compl`` — constraint complementarity ``sum_h y_h |b_h - a_h x|``
      over ``1 + |c @ x|``.

    Deliberately *not* the textbook duality gap ``D(y) - P(x)``: with the
    box folded into the dual objective the gap carries an
    ``M * ||lambda||_1`` term, and at ``M = 1e4`` that amplifies float32
    rounding in ``lambda`` (~1e-6) into an irreducible ~1e-2 absolute gap
    floor.  The normal-cone split certifies the same KKT system without
    the amplification, so float32 solves can reach their tolerance.
    """
    s = bb - matvec_rows(ax, ay, x)                       # slack (B, m)
    pres = torch.clamp_min(-s, 0.0).amax(dim=-1) / b_scale
    lam = c - rmatvec_rows(ax, ay, y)
    at_hi = x >= (M - bound_tol)
    at_lo = x <= -(M - bound_tol)
    dres_c = torch.where(at_hi, torch.clamp_min(-lam, 0.0),
                         torch.where(at_lo, torch.clamp_min(lam, 0.0),
                                     lam.abs()))
    dres = dres_c.amax(dim=-1) / c_scale
    obj = (c * x).sum(dim=-1)
    compl = (y * s.abs()).sum(dim=-1) / (1.0 + obj.abs())
    return pres, dres, compl
