"""The 1-D linear program at the heart of Seidel's algorithm (paper eqs. 3-4).

When the incremental optimum violates constraint ``l = (a_i, b_i)`` the new
optimum lies on the line ``a_i @ x = b_i``.  Parameterise the line as
``x(t) = p0 + t * u`` with ``p0`` the closest point to the origin and ``u``
the unit direction along the line.  Every previously-considered constraint
``h`` intersects the line at sigma(h, l) = (b_h - a_h @ p0) / (a_h @ u) and
bounds t from the left (a_h @ u < 0) or the right (a_h @ u > 0):

    u_left  = max over left-bounding  sigma(h, l)     (paper eq. 3)
    u_right = min over right-bounding sigma(h, l)     (paper eq. 4)

infeasible iff u_left > u_right, otherwise t* is whichever end the objective
prefers.  These max/min folds are exactly the accumulations the paper
implements with shared-memory atomicMin/atomicMax; here they are
``amin``/``amax`` reductions along the constraint axis (and warp-shuffle
reductions in the CUDA kernel).

Everything here is written over an arbitrary leading "work-unit" axis so the
same function serves the scalar reference and the hand-vectorised RGB solver.
"""
from __future__ import annotations

import torch

# All epsilons are absolute distances because constraints are normalised to
# unit normals before solving (see lp.normalize_batch).  They are Python
# floats: against a tensor they take the tensor's dtype, so a float32 solve
# compares in float32 (the CUDA kernel casts them the same way).
EPS_DENOM = 1e-7   # |a_h @ u| below this -> constraint parallel to the line
EPS_FEAS = 1e-5    # feasibility slack (paper uses a 5-significant-figure
                   # tolerance when comparing CPU and GPU accumulations)
EPS_TIE = 1e-9     # |c @ u| below this -> objective tie, use perpendicular


# The 1-D solve operates on constraint *component rows* (a_x, a_y, b)
# — the packed SoA layout.  The dense solvers consume a PackedLPBatch
# directly; the AoS entry points slice their (…, m, 2) normals into rows
# and run the *identical* ops, which is what makes packed-vs-AoS solves
# bit-identical by construction.
#
# Shape convention: per-problem scalars (a_ix, b_i, cx, …) carry the
# leading batch shape (…,); constraint rows carry one extra trailing
# axis (…, H).  Broadcasting against rows happens via […, None] inside
# these helpers.

def sigma_bounds_rows(ax_prev, ay_prev, b_prev, p0x, p0y, ux, uy, mask):
    """Intersections of previous constraints with the line (the work
    units): all rows (..., H), line frame components pre-expanded to
    (..., 1).  Returns (t_lo, t_hi, parallel_infeasible) reduced over
    H."""
    denom = ax_prev * ux + ay_prev * uy
    num = b_prev - (ax_prev * p0x + ay_prev * p0y)
    is_par = denom.abs() <= EPS_DENOM
    t = num / torch.where(is_par, 1.0, denom)  # guarded divide
    big = torch.finfo(t.dtype).max
    hi = torch.where(mask & (denom > EPS_DENOM), t, big)       # t <= sigma
    lo = torch.where(mask & (denom < -EPS_DENOM), t, -big)     # t >= sigma
    t_hi = hi.amin(dim=-1)   # paper eq. 4 (atomicMin on the GPU)
    t_lo = lo.amax(dim=-1)   # paper eq. 3 (atomicMax on the GPU)
    par_bad = (mask & is_par & (num < -EPS_FEAS)).any(dim=-1)
    return t_lo, t_hi, par_bad


def choose_t_rows(t_lo, t_hi, cx, cy, cpx, cpy, ux, uy):
    """Pick the end of the feasible interval the (augmented) objective
    prefers.  Ties on c@u are broken with the perpendicular objective
    so the incremental optimum stays unique (required by Seidel's
    algorithm).  The one copy of the tie-break — the dense and chunked
    re-solves must share it bit-for-bit."""
    cu = cx * ux + cy * uy
    cpu = cpx * ux + cpy * uy
    pick_hi = torch.where(cu.abs() > EPS_TIE, cu > 0.0, cpu > 0.0)
    return torch.where(pick_hi, t_hi, t_lo)


def resolve_on_line_rows(a_ix, a_iy, b_i, ax_prev, ay_prev, b_prev,
                         cx, cy, cpx, cpy, mask):
    """The full 1-D re-solve on the line of violated constraint
    ``(a_ix, a_iy, b_i)`` against prior constraint rows.  Returns
    (x_new_x, x_new_y, feasible), each with the leading batch shape."""
    p0x, p0y = a_ix * b_i, a_iy * b_i    # closest point to the origin
    ux, uy = -a_iy, a_ix                 # unit direction along the line
    t_lo, t_hi, par_bad = sigma_bounds_rows(
        ax_prev, ay_prev, b_prev, p0x[..., None], p0y[..., None],
        ux[..., None], uy[..., None], mask)
    feasible = (t_lo <= t_hi + EPS_FEAS) & ~par_bad
    t = choose_t_rows(t_lo, t_hi, cx, cy, cpx, cpy, ux, uy)
    return p0x + t * ux, p0y + t * uy, feasible


def box_rows(M, dtype=torch.float32, device=None):
    """The four bounds x<=M, -x<=M, y<=M, -y<=M that make every
    intermediate optimum finite and unique (paper section 2.1), as
    component rows (bax, bay, bb)."""
    bax = torch.tensor([1.0, -1.0, 0.0, 0.0], dtype=dtype, device=device)
    bay = torch.tensor([0.0, 0.0, 1.0, -1.0], dtype=dtype, device=device)
    bb = torch.full((4,), M, dtype=dtype, device=device)
    return bax, bay, bb


def perp(c):
    return torch.stack([-c[..., 1], c[..., 0]], dim=-1)


def sign_tie_break(v, tb):
    """``sign(v)``, falling back to ``sign(tb)`` and then ``+1`` when
    ``|v|`` (resp. ``|tb|``) is within ``EPS_TIE`` of zero."""
    return torch.where(v.abs() > EPS_TIE, torch.sign(v),
                       torch.where(tb.abs() > EPS_TIE, torch.sign(tb), 1.0))


def box_corner(c, M, dtype=None):
    """Initial optimum: the corner of the bounding box |x|,|y| <= M that the
    augmented objective (c, tie-broken by perp(c)) prefers."""
    cp = perp(c)
    sx = sign_tie_break(c[..., 0], cp[..., 0])
    sy = sign_tie_break(c[..., 1], cp[..., 1])
    x0 = torch.stack([sx * M, sy * M], dim=-1)
    if dtype is not None:
        x0 = x0.to(dtype)
    return x0


def box_constraints(M, dtype=torch.float32, device=None):
    """The four bounds x<=M, -x<=M, y<=M, -y<=M that make every intermediate
    optimum finite and unique (paper section 2.1)."""
    A = torch.tensor(
        [[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]], dtype=dtype,
        device=device)
    b = torch.full((4,), M, dtype=dtype, device=device)
    return A, b
