"""Batched Seidel incremental 2-D LP solvers (the paper's NaiveRGB and RGB).

Two plain-PyTorch implementations with deliberately different execution
shapes:

``solve_naive`` — NaiveRGB analogue (paper Fig. 1).  One LP per batch
    lane, no skipping: *every* lane executes the O(i) re-solve at *every*
    step and selects the result where it was violated, exactly like a
    diverged warp in which one violated thread stalls the other 31.  This
    is the faithful divergence baseline.

``solve_rgb`` — RGB analogue (paper Fig. 2).  The batch is processed in
    tiles (a Python loop over tiles).  Within a tile the step-i membership
    test is a dense vector op over problems, and the O(i) re-solve work
    units (one per prior constraint) are laid along the minor axis and
    executed as dense vector ops with a min/max reduction in place of the
    paper's shared-memory atomics.  A host ``if`` on "any problem in the
    tile violated?" skips the re-solve entirely — the cooperative-thread-
    array early exit, and the reason randomised order pays off
    (violations become rare as i grows).  On a CUDA tensor that ``if``
    is one device synchronisation per step: this module is the port's
    oracle, not its fast path.

The CUDA kernel (kernels/batch_lp.py) implements the same algorithm as
``solve_rgb``; this module is its oracle.

Both solvers consume constraints as *component rows* ``(a_x, a_y, b)``
— the packed SoA layout — via the ``oneD.*_rows`` helpers.  A
:class:`~repro_torch.core.packed.PackedLPBatch` therefore feeds
``solve_naive_packed``/``solve_rgb_packed`` directly, with no AoS
round-trip; the AoS entry points slice their ``(…, m, 2)`` normals into
rows and run the identical ops, so packed and AoS solves are
bit-identical by construction.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from repro_torch.core import oneD
from repro_torch.core.lp import LPBatch, LPSolution, _objective

if TYPE_CHECKING:  # pragma: no cover - import cycle guard, typing only
    from repro_torch.core.packed import PackedLPBatch

DEFAULT_M = 1.0e4  # box bound; "very large so as not to affect the optimum"


def _solve_tile_rows(ax, ay, bb, c, m_valid, *, M, chunk: int = 0,
                     skip: bool = True):
    """Solve a tile of T problems cooperatively over constraint rows.

    ax/ay/bb (T, m), c (T, 2), m_valid (T,).

    chunk > 0 enables the *chunked re-solve*: the 1-D LP at step i only
    touches the first ceil((i+4)/chunk) chunks of prior constraints, so
    re-solve work is O(i) like the serial algorithm, instead of O(m)
    dense.  The paper's WU count is i per re-solve; the dense variant
    pays m.

    ``skip=False`` is the NaiveRGB shape: the re-solve runs at every
    step whether or not any problem is violated.
    """
    T, m = ax.shape
    dt, dev = ax.dtype, ax.device
    bax, bay, bbb = oneD.box_rows(M, dt, dev)
    ax_all = torch.cat([bax.expand(T, 4), ax], dim=1)  # (T, H)
    ay_all = torch.cat([bay.expand(T, 4), ay], dim=1)
    b_all = torch.cat([bbb.expand(T, 4), bb], dim=1)
    if chunk:
        pad = (-ax_all.shape[1]) % chunk
        zeros = torch.zeros((T, pad), dtype=dt, device=dev)
        ax_all = torch.cat([ax_all, zeros], dim=1)
        ay_all = torch.cat([ay_all, zeros], dim=1)
        b_all = torch.cat([b_all, torch.ones_like(zeros)], dim=1)
    H = ax_all.shape[1]
    cx, cy = c[:, 0], c[:, 1]
    cperp = oneD.perp(c)
    cpx, cpy = cperp[:, 0], cperp[:, 1]
    x = oneD.box_corner(c, M, dt)
    feas = torch.ones((T,), dtype=torch.bool, device=dev)
    h_idx = torch.arange(H, device=dev)[None, :]  # (1, H)

    for i in range(m):
        a_ix, a_iy, b_i = ax[:, i], ay[:, i], bb[:, i]
        violated = feas & (i < m_valid) & (
            a_ix * x[:, 0] + a_iy * x[:, 1] > b_i + oneD.EPS_FEAS)
        # Host predicate -> genuine skip (block-level early exit).
        if skip and not bool(violated.any()):
            continue
        # Work units: all (problem, prior-constraint) intersections,
        # laid dense along the minor axis; masked min/max reduction
        # replaces shared-memory atomics.
        if not chunk:
            mask = h_idx < (i + 4)
            xn_x, xn_y, feas_new = oneD.resolve_on_line_rows(
                a_ix, a_iy, b_i, ax_all, ay_all, b_all,
                cx, cy, cpx, cpy, mask)
        else:
            xn_x, xn_y, feas_new = _resolve_chunked_rows(
                a_ix, a_iy, b_i, ax_all, ay_all, b_all,
                cx, cy, cpx, cpy, i + 4, chunk)
        x_new = torch.stack([xn_x, xn_y], dim=-1)
        x = torch.where(violated[:, None], x_new, x)
        feas = torch.where(violated, feas & feas_new, feas)
    return x, feas


def _resolve_chunked_rows(a_ix, a_iy, b_i, ax_all, ay_all, b_all,
                          cx, cy, cpx, cpy, n_prior, chunk):
    """1-D re-solve touching only ceil(n_prior/chunk) chunks."""
    T, H = ax_all.shape
    dt, dev = ax_all.dtype, ax_all.device
    p0x, p0y = a_ix * b_i, a_iy * b_i
    ux, uy = -a_iy, a_ix
    big = torch.finfo(dt).max
    n_chunks = (n_prior + chunk - 1) // chunk
    t_lo = torch.full((T,), -big, dtype=dt, device=dev)
    t_hi = torch.full((T,), big, dtype=dt, device=dev)
    bad = torch.zeros((T,), dtype=torch.bool, device=dev)
    for j in range(n_chunks):
        lo_, hi_ = j * chunk, (j + 1) * chunk
        hloc = torch.arange(lo_, hi_, device=dev)[None, :]
        mask = hloc < n_prior
        lo_j, hi_j, bad_j = oneD.sigma_bounds_rows(
            ax_all[:, lo_:hi_], ay_all[:, lo_:hi_], b_all[:, lo_:hi_],
            p0x[..., None], p0y[..., None],
            ux[..., None], uy[..., None], mask)
        t_lo = torch.maximum(t_lo, lo_j)
        t_hi = torch.minimum(t_hi, hi_j)
        bad = bad | bad_j
    feasible = (t_lo <= t_hi + oneD.EPS_FEAS) & ~bad
    t = oneD.choose_t_rows(t_lo, t_hi, cx, cy, cpx, cpy, ux, uy)
    return p0x + t * ux, p0y + t * uy, feasible


# ---------------------------------------------------------------------------
# NaiveRGB: every lane re-solves at every step
# ---------------------------------------------------------------------------

def _naive_from_rows(ax, ay, bb, c, m_valid, *, M) -> LPSolution:
    x, feas = _solve_tile_rows(ax, ay, bb, c, m_valid, M=M, skip=False)
    return LPSolution(x=x, feasible=feas, objective=_objective(c, x))


def solve_naive(batch: LPBatch, *, M: float = DEFAULT_M) -> LPSolution:
    return _naive_from_rows(batch.A[..., 0], batch.A[..., 1], batch.b,
                            batch.c, batch.m_valid, M=M)


def solve_naive_packed(pb: "PackedLPBatch", *,
                       M: float = DEFAULT_M) -> LPSolution:
    """The packed fast path: consume ``PackedLPBatch.L`` rows directly
    (no AoS round-trip)."""
    return _naive_from_rows(pb.ax, pb.ay, pb.b, pb.c,
                            pb.m_valid.reshape(-1), M=M)


# ---------------------------------------------------------------------------
# RGB: tile-cooperative work-unit execution
# ---------------------------------------------------------------------------

def _rgb_from_rows(ax, ay, bb, c, m_valid, *, M, tile, chunk) -> LPSolution:
    B, m = ax.shape
    T = min(tile, B) if B > 0 else tile
    xs, fs = [], []
    for lo in range(0, B, T):
        hi = min(lo + T, B)   # a short last tile needs no pad problems
        x, feas = _solve_tile_rows(ax[lo:hi], ay[lo:hi], bb[lo:hi],
                                   c[lo:hi], m_valid[lo:hi], M=M,
                                   chunk=chunk)
        xs.append(x)
        fs.append(feas)
    if xs:
        x, feas = torch.cat(xs), torch.cat(fs)
    else:
        x = torch.zeros((0, 2), dtype=ax.dtype, device=ax.device)
        feas = torch.zeros((0,), dtype=torch.bool, device=ax.device)
    return LPSolution(x=x, feasible=feas, objective=_objective(c, x))


def solve_rgb(batch: LPBatch, *, M: float = DEFAULT_M,
              tile: int = 32, chunk: int = 0) -> LPSolution:
    return _rgb_from_rows(batch.A[..., 0], batch.A[..., 1], batch.b,
                          batch.c, batch.m_valid, M=M, tile=tile,
                          chunk=chunk)


def solve_rgb_packed(pb: "PackedLPBatch", *, M: float = DEFAULT_M,
                     tile: int = 32, chunk: int = 0) -> LPSolution:
    """The packed fast path: consume ``PackedLPBatch.L`` rows directly
    (no AoS round-trip)."""
    return _rgb_from_rows(pb.ax, pb.ay, pb.b, pb.c,
                          pb.m_valid.reshape(-1), M=M, tile=tile,
                          chunk=chunk)
