"""Restarted PDHG solve loop for batched 2-D LPs (cuPDLP-style).

The iteration runs in fixed blocks of ``iter_block`` steps under a host
loop; residuals, restarts and convergence masks are only evaluated at
block boundaries, so a block is nothing but row-form multiply-adds
enqueued back to back, and the host waits on the device once per block
(the ``any(active)`` test that decides whether another block runs).  Per
problem the solver keeps

* a running average of the iterates since the last restart (the restart
  *candidate* is whichever of {current, average} has the lower
  normalized KKT score — averaging is what restores the linear rate on
  LPs);
* the best iterate seen so far (returned at the end, so a solve
  interrupted by ``max_iters`` still reports its best certificate);
* the primal weight ``omega`` (``tau = eta/omega``, ``sigma =
  eta*omega``), re-balanced on every restart from the observed
  primal/dual movement — cuPDLP's smoothed update, with the per-restart
  step bounded (``OMEGA_STEP_CLAMP``) so one noisy cycle cannot swing the
  weight by orders of magnitude and freeze the primal.

Restarts fire per problem on *sufficient decay* of the KKT score (``<=
RESTART_BETA *`` the score at the last restart, baselined at the actual
starting point, not infinity) or on the *artificial* period
``restart_period`` (0 disables the periodic trigger).  A cycle whose
candidate score blows up past ``DIVERGE_FACTOR *`` the best score seen
recovers by restarting from the best (x, y) pair with ``omega`` pulled
back toward its initial value.  Converged problems freeze: their updates
are masked out, so a batch only pays until its slowest member converges
or ``max_iters`` is hit.

Two 2-D-specific moves make small ragged batches robust, not just the
large well-conditioned ones PDHG is built for:

* each problem is solved in rescaled coordinates ``x' = x / s`` with
  ``s = max(1, ||b||_inf)`` (the 2-D stand-in for cuPDLP's Ruiz
  scaling);
* a *crossover polish* after the loop (the 2-D analogue of PDLP's basis
  crossover): the two highest-dual rows are intersected with each other
  and with the four box faces, and the best feasible vertex replaces the
  iterate when it improves it.  The two rows are taken by a stable
  descending sort, so on tied duals (zero duals tie often) the lower row
  index comes first, as ``lax.top_k`` gives it in the reference.

Feasibility classification matches the Seidel backends on 2-D inputs: an
infeasible LP's primal residual is bounded away from zero, so it rides to
``max_iters`` and is classified by its best residual; "unbounded" LPs
saturate the same ``M`` box the dense backends use.  PDHG answers carry a
first-order tolerance: ``tol`` bounds the *relative KKT residuals* of the
returned point, not the number of correct digits of the objective.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import oneD
from repro_torch.core.lp import LPBatch, LPSolution, _objective
from repro_torch.core.packed import PackedLPBatch
from repro_torch.core.seidel import DEFAULT_M
from repro_torch.pdhg.iteration import (EPS_GUARD, kkt_residuals_rows,
                                        pdhg_step, spectral_norm_rows)

# Block/restart defaults; the measured tuning table overrides per shape
# (see repro_torch.tune.space PDHG_ITER_BLOCKS / PDHG_RESTART_PERIODS).
DEFAULT_ITER_BLOCK = 64
DEFAULT_RESTART_PERIOD = 1024

# Sufficient-decay factor for adaptive restarts (cuPDLP uses ~0.2).
RESTART_BETA = 0.2

# Step-size safety margin: tau * sigma * ||A||^2 = STEP_SAFETY^2 < 1.
STEP_SAFETY = 0.9

# Primal-weight clamp — omega updates are multiplicative, keep them sane.
OMEGA_MIN, OMEGA_MAX = 1e-6, 1e6

# Largest multiplicative omega change one restart may apply.
OMEGA_STEP_CLAMP = 4.0

# A cycle whose candidate KKT score exceeds this multiple of the best
# score seen AND the absolute floor is treated as diverging and recovers
# from the best pair.  The floor keeps recovery an emergency brake: near
# convergence the (nonmonotone) score routinely pops an order of
# magnitude above a ~1e-8 best, and resetting omega there would stall the
# endgame.
DIVERGE_FACTOR = 10.0
DIVERGE_KKT_FLOOR = 0.5

# Feasibility classification threshold on the *relative* primal
# residual.  Converged problems sit at <= tol; infeasible generators in
# this repo sit O(1e-1) away — anything in between means "ran out of
# iterations on a feasible problem", which is classified optimistically
# only up to this floor (comparable to oneD.EPS_FEAS's scale).
FEAS_EPS_REL = 1e-4

# The 15 vertex candidates of the polish: every pair of the two top-dual
# rows and the four box faces.
_PAIRS = [(i, j) for i in range(6) for j in range(i + 1, 6)]


def default_tol(dtype) -> float:
    """Relative KKT tolerance by precision: float32 stops where its
    rounding floor starts; float64 matches the 1e-8 cuPDLP default."""
    return 1e-8 if _is_f64(dtype) else 1e-4


def default_max_iters(dtype) -> int:
    return 100_000 if _is_f64(dtype) else 20_000


def _is_f64(dtype) -> bool:
    return dtype in (torch.float64, "float64")


@dataclasses.dataclass(frozen=True)
class PDHGStats:
    """Per-problem convergence certificate of a PDHG solve: ``(B,)``
    tensors on the solve's device.

    Residuals are *relative* and measured on the internally rescaled
    problem (``b`` and the box divided by ``max(1, ||b||_inf)``), at the
    returned (possibly crossover-polished) primal point paired with the
    best dual iterate."""

    iterations: torch.Tensor   # (B,) int32 iterations to convergence/stop
    restarts: torch.Tensor     # (B,) int32 restarts fired
    primal_res: torch.Tensor   # (B,) relative primal residual
    dual_res: torch.Tensor     # (B,) relative dual (stationarity) residual
    compl: torch.Tensor        # (B,) relative complementarity residual
    kkt: torch.Tensor          # (B,) max of the three
    converged: torch.Tensor    # (B,) bool: some iterate reached kkt <= tol


def _solve_rows(ax, ay, bb, c, m_valid, *, M: float,
                tol: Optional[float], max_iters: Optional[int],
                iter_block: Optional[int],
                restart_period: Optional[int]
                ) -> Tuple[LPSolution, PDHGStats]:
    """The restart loop over component rows; every knob is a Python scalar
    (None -> dtype-based default).  Runs on the device the rows lie on."""
    B, m = ax.shape
    dt = ax.dtype
    dev = ax.device
    tol = float(default_tol(dt) if tol is None else tol)
    max_iters = int(default_max_iters(dt) if max_iters is None
                    else max_iters)
    iter_block = int(DEFAULT_ITER_BLOCK if iter_block is None
                     else iter_block)
    restart_period = int(DEFAULT_RESTART_PERIOD if restart_period is None
                         else restart_period)
    M = float(M)
    c = c.to(dt)
    m_valid = m_valid.reshape(-1)
    i32 = torch.int32

    if m == 0:
        # No constraints at all: the optimum is the preferred box corner
        # (same tie-break as the Seidel backends' start point).
        x = oneD.box_corner(c, M, dtype=dt)
        zeros = torch.zeros((B,), dtype=dt, device=dev)
        sol = LPSolution(x=x, feasible=torch.ones((B,), dtype=torch.bool,
                                                  device=dev),
                         objective=_objective(c, x))
        izeros = torch.zeros((B,), dtype=i32, device=dev)
        stats = PDHGStats(iterations=izeros, restarts=izeros.clone(),
                          primal_res=zeros, dual_res=zeros.clone(),
                          compl=zeros.clone(), kkt=zeros.clone(),
                          converged=sol.feasible.clone())
        return sol, stats

    # Rows at or past m_valid are forced to the neutral constraint
    # (0, 0, 1) so ragged batches match the Seidel masking semantics even
    # if a caller left garbage past the valid count.  The neutral row is
    # then exactly inert: it contributes nothing to A x or A^T y, and its
    # dual component projects to (and stays at) zero.
    keep = (torch.arange(m, device=dev)[None, :]
            < m_valid.to(dev)[:, None])
    ax = torch.where(keep, ax, 0.0).to(dt)
    ay = torch.where(keep, ay, 0.0).to(dt)
    bb = torch.where(keep, bb, 1.0).to(dt)

    # 2-D Ruiz-style rescale: solve for x' = x / s with
    # s = max(1, ||b||_inf); an optimum O(||b||) box-units out becomes O(1)
    # travel for the iteration, and the residuals below are measured on
    # this rescaled problem.
    s_scale = torch.clamp_min(
        torch.where(keep, bb.abs(), 0.0).amax(dim=-1), 1.0).to(dt)
    bb = bb / s_scale[:, None]
    Ms = (M / s_scale)[:, None]                          # (B, 1) box

    # Per-problem geometry: exact ||A||_2 -> step scale eta; primal
    # weight omega seeded from the objective/rhs balance (PDLP init).
    norm_A = spectral_norm_rows(ax, ay)
    eta = STEP_SAFETY / torch.clamp_min(norm_A, EPS_GUARD)
    norm_c = torch.linalg.vector_norm(c, dim=-1)
    norm_b = torch.linalg.vector_norm(torch.where(keep, bb, 0.0), dim=-1)
    omega0 = torch.clamp(
        torch.where((norm_c > EPS_GUARD) & (norm_b > EPS_GUARD),
                    norm_c / torch.clamp_min(norm_b, EPS_GUARD),
                    torch.ones_like(norm_c)),
        OMEGA_MIN, OMEGA_MAX).to(dt)
    b_scale = 1.0 + torch.where(keep, bb.abs(), 0.0).amax(dim=-1)
    c_scale = 1.0 + c.abs().amax(dim=-1)
    bound_tol = 1e-6 * Ms

    def kkt_of(x, y):
        pres, dres, compl = kkt_residuals_rows(
            x, y, ax, ay, bb, c, M=Ms, b_scale=b_scale, c_scale=c_scale,
            bound_tol=bound_tol)
        return pres, dres, compl, torch.maximum(pres,
                                                torch.maximum(dres, compl))

    def vec(fill, dtype=dt):
        return torch.full((B,), fill, dtype=dtype, device=dev)

    x = torch.zeros((B, 2), dtype=dt, device=dev)
    y = torch.zeros((B, m), dtype=dt, device=dev)
    big = torch.finfo(dt).max
    _, _, _, kkt0 = kkt_of(x, y)
    # running average since last restart
    x_sum, y_sum, n_avg = torch.zeros_like(x), torch.zeros_like(y), vec(0.0)
    # last-restart snapshot (omega update + decay baseline; the baseline
    # starts at the actual initial score — an infinite baseline would
    # fire the decay trigger on the very first block and let one noisy
    # cycle set omega)
    x_rs, y_rs, kkt_rs = x, y, kkt0
    cycle = vec(0, i32)
    omega = omega0
    active = vec(True, torch.bool)
    # best-so-far certificate
    best_x, best_y = x, y
    best_kkt, best_pres = vec(big), vec(big)
    best_dres, best_compl = vec(big), vec(big)
    iters_done, restarts = vec(0, i32), vec(0, i32)

    it = 0
    # The one host synchronisation per block: does any problem still run?
    while it < max_iters and bool(active.any()):
        act = active
        actc = act[:, None]
        tau = eta / omega
        sigma = eta * omega
        for _ in range(iter_block):
            x_new, y_new = pdhg_step(x, y, ax, ay, bb, c, tau, sigma, Ms)
            x = torch.where(actc, x_new, x)
            y = torch.where(actc, y_new, y)
            x_sum = x_sum + torch.where(actc, x, 0.0)
            y_sum = y_sum + torch.where(actc, y, 0.0)
            n_avg = n_avg + act
        cycle = cycle + act.to(i32) * iter_block

        # Candidate = better-scored of {current iterate, cycle average}.
        pres_c, dres_c, compl_c, kkt_c = kkt_of(x, y)
        n = torch.clamp_min(n_avg, 1.0)
        x_avg = x_sum / n[:, None]
        y_avg = y_sum / n[:, None]
        pres_a, dres_a, compl_a, kkt_a = kkt_of(x_avg, y_avg)
        use_avg = kkt_a < kkt_c
        uac = use_avg[:, None]
        x_cand = torch.where(uac, x_avg, x)
        y_cand = torch.where(uac, y_avg, y)
        kkt_cand = torch.where(use_avg, kkt_a, kkt_c)
        pres_cand = torch.where(use_avg, pres_a, pres_c)
        dres_cand = torch.where(use_avg, dres_a, dres_c)
        compl_cand = torch.where(use_avg, compl_a, compl_c)

        better = act & (kkt_cand < best_kkt)
        bc = better[:, None]
        best_x = torch.where(bc, x_cand, best_x)
        best_y = torch.where(bc, y_cand, best_y)
        best_kkt = torch.where(better, kkt_cand, best_kkt)
        best_pres = torch.where(better, pres_cand, best_pres)
        best_dres = torch.where(better, dres_cand, best_dres)
        best_compl = torch.where(better, compl_cand, best_compl)

        newly = act & (kkt_cand <= tol)
        iters_done = torch.where(act, it + iter_block, iters_done)
        active = act & ~newly

        # A blown-up cycle recovers from the best pair seen; otherwise
        # restart on sufficient decay or on the artificial period.
        recover = active & (kkt_cand > torch.clamp_min(
            DIVERGE_FACTOR * best_kkt, DIVERGE_KKT_FLOOR))
        decay = kkt_cand <= RESTART_BETA * kkt_rs
        if restart_period:
            decay = decay | (cycle >= restart_period)
        do_rs = active & (decay | recover)
        rsc = do_rs[:, None]

        # cuPDLP's smoothed primal-weight update from the observed
        # movement over the finished restart cycle, bounded to one
        # OMEGA_STEP_CLAMP factor per restart; a recovery instead pulls
        # omega back toward its initial value.
        dx = torch.linalg.vector_norm(x_cand - x_rs, dim=-1)
        dy = torch.linalg.vector_norm(y_cand - y_rs, dim=-1)
        ok = (dx > EPS_GUARD) & (dy > EPS_GUARD)
        omega_prop = torch.exp(
            0.5 * torch.log(torch.clamp_min(dy, EPS_GUARD)
                            / torch.clamp_min(dx, EPS_GUARD))
            + 0.5 * torch.log(omega))
        omega_prop = torch.clamp(omega_prop, omega / OMEGA_STEP_CLAMP,
                                 omega * OMEGA_STEP_CLAMP)
        omega_rs = torch.where(ok, omega_prop, omega)
        omega_rec = torch.sqrt(omega * omega0)
        omega = torch.where(do_rs,
                            torch.where(recover, omega_rec, omega_rs),
                            omega)
        omega = torch.clamp(omega, OMEGA_MIN, OMEGA_MAX)

        rec_c = recover[:, None]
        x_t = torch.where(rec_c, best_x, x_cand)
        y_t = torch.where(rec_c, best_y, y_cand)
        kkt_t = torch.where(recover, best_kkt, kkt_cand)
        x = torch.where(rsc, x_t, x)
        y = torch.where(rsc, y_t, y)
        x_rs = torch.where(rsc, x_t, x_rs)
        y_rs = torch.where(rsc, y_t, y_rs)
        kkt_rs = torch.where(do_rs, kkt_t, kkt_rs)
        reset = do_rs | newly
        rc = reset[:, None]
        x_sum = torch.where(rc, 0.0, x_sum)
        y_sum = torch.where(rc, 0.0, y_sum)
        n_avg = torch.where(reset, 0.0, n_avg)
        cycle = torch.where(do_rs, 0, cycle)
        restarts = restarts + do_rs.to(i32)
        it += iter_block

    feas_eps = max(FEAS_EPS_REL, tol)
    x_it, y_it = best_x, best_y

    # -- crossover polish (2-D basis identification) ----------------------
    # Intersect the two highest-dual rows with each other and with the
    # four box faces (15 candidate vertices); the best feasible one
    # replaces the iterate when it improves it.  On narrow-wedge LPs the
    # iterate converges at the Hoffman rate (slow) but the top duals
    # already name the active faces, so this lands the vertex.  A stable
    # descending sort puts the lower index first among tied duals, as
    # lax.top_k does (torch.topk promises no order among ties).
    if m >= 2:
        top = torch.sort(y_it, dim=1, descending=True,
                         stable=True).indices[:, :2]
    else:
        top = torch.zeros((B, 2), dtype=torch.int64, device=dev)
    axt = torch.gather(ax, 1, top)                       # (B, 2)
    ayt = torch.gather(ay, 1, top)
    bt = torch.gather(bb, 1, top)
    one = torch.ones((B,), dtype=dt, device=dev)
    zero = torch.zeros((B,), dtype=dt, device=dev)
    Msf = Ms[:, 0]
    nx = torch.stack([axt[:, 0], axt[:, 1], one, -one, zero, zero], 1)
    ny = torch.stack([ayt[:, 0], ayt[:, 1], zero, zero, one, -one], 1)
    rr = torch.stack([bt[:, 0], bt[:, 1], Msf, Msf, Msf, Msf], 1)
    pair_i = torch.tensor([i for i, _ in _PAIRS], device=dev)
    pair_j = torch.tensor([j for _, j in _PAIRS], device=dev)
    n1x, n1y, r1 = nx[:, pair_i], ny[:, pair_i], rr[:, pair_i]
    n2x, n2y, r2 = nx[:, pair_j], ny[:, pair_j], rr[:, pair_j]
    det = n1x * n2y - n1y * n2x                          # (B, 15)
    # The guard is the working dtype's: float32's eps on a float64 batch
    # would reject vertices float64 resolves.
    eps = torch.finfo(dt).eps
    det_guard = 100.0 * eps * torch.clamp_min(
        torch.sqrt((n1x ** 2 + n1y ** 2) * (n2x ** 2 + n2y ** 2)),
        EPS_GUARD)
    good = det.abs() > det_guard
    det_safe = torch.where(good, det, 1.0)
    vx = (r1 * n2y - r2 * n1y) / det_safe                # (B, 15)
    vy = (n1x * r2 - n2x * r1) / det_safe
    viols = []
    for k in range(vx.shape[1]):
        rowv = torch.clamp_min(
            ax * vx[:, k:k + 1] + ay * vy[:, k:k + 1] - bb,
            0.0).amax(dim=1)
        boxv = torch.clamp_min(
            torch.maximum(vx[:, k].abs(), vy[:, k].abs()) - Msf, 0.0)
        viols.append(torch.maximum(rowv, boxv))
    pres_v = torch.stack(viols, 1) / b_scale[:, None]    # (B, 15)
    valid = good & (pres_v <= feas_eps)
    obj_v = c[:, 0:1] * vx + c[:, 1:2] * vy
    obj_masked = torch.where(valid, obj_v, -big)
    kbest = torch.argmax(obj_masked, dim=1, keepdim=True)  # first maximum
    obj_pol = torch.gather(obj_masked, 1, kbest)[:, 0]
    x_pol = torch.stack([torch.gather(vx, 1, kbest)[:, 0],
                         torch.gather(vy, 1, kbest)[:, 0]], dim=-1)
    feas_it = best_pres <= feas_eps
    obj_it = _objective(c, x_it)
    # accept only a *meaningful* improvement so a converged iterate is
    # not churned by one-ulp vertex differences
    margin = 8.0 * eps * (1.0 + obj_it.abs())
    improve = valid.any(dim=1) & (~feas_it | (obj_pol > obj_it + margin))
    x_fin = torch.where(improve[:, None], x_pol, x_it)

    pres_f, dres_f, compl_f, kkt_f = kkt_of(x_fin, y_it)
    x_out = x_fin * s_scale[:, None]                     # unscale
    sol = LPSolution(x=x_out, feasible=pres_f <= feas_eps,
                     objective=_objective(c, x_out))
    stats = PDHGStats(
        iterations=iters_done, restarts=restarts,
        primal_res=pres_f, dual_res=dres_f, compl=compl_f, kkt=kkt_f,
        converged=(kkt_f <= tol) | (best_kkt <= tol))
    return sol, stats


# -- public entry points ---------------------------------------------------

def solve_pdhg(batch: LPBatch, *, M: float = DEFAULT_M,
               tol: Optional[float] = None,
               max_iters: Optional[int] = None,
               iter_block: Optional[int] = None,
               restart_period: Optional[int] = None) -> LPSolution:
    """Solve an AoS :class:`LPBatch` with restarted PDHG, on the device
    its tensors lie on."""
    sol, _ = solve_pdhg_with_stats(batch, M=M, tol=tol,
                                   max_iters=max_iters,
                                   iter_block=iter_block,
                                   restart_period=restart_period)
    return sol


def solve_pdhg_packed(pb: PackedLPBatch, *, M: float = DEFAULT_M,
                      tol: Optional[float] = None,
                      max_iters: Optional[int] = None,
                      iter_block: Optional[int] = None,
                      restart_period: Optional[int] = None) -> LPSolution:
    """The packed fast path: consume ``PackedLPBatch.L`` rows directly
    (no AoS round trip)."""
    sol, _ = solve_pdhg_with_stats(pb, M=M, tol=tol, max_iters=max_iters,
                                   iter_block=iter_block,
                                   restart_period=restart_period)
    return sol


def solve_pdhg_with_stats(batch, *, M: float = DEFAULT_M,
                          tol: Optional[float] = None,
                          max_iters: Optional[int] = None,
                          iter_block: Optional[int] = None,
                          restart_period: Optional[int] = None
                          ) -> Tuple[LPSolution, PDHGStats]:
    """Like :func:`solve_pdhg` / :func:`solve_pdhg_packed` (either
    layout) but also returns the per-problem :class:`PDHGStats`
    certificate — what the tests and the smoke run assert convergence
    on."""
    if isinstance(batch, PackedLPBatch):
        rows = (batch.ax, batch.ay, batch.b)
    else:
        rows = (batch.A[..., 0], batch.A[..., 1], batch.b)
    return _solve_rows(*rows, batch.c, batch.m_valid, M=M, tol=tol,
                       max_iters=max_iters, iter_block=iter_block,
                       restart_period=restart_period)
