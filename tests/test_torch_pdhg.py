"""The port's first-order backend (``repro_torch.pdhg``) against the reference's
(``repro.pdhg``), both on the CPU, on the same numpy arrays.

Tolerances, stated per check:

* building blocks (``matvec_rows``, ``rmatvec_rows``, ``spectral_norm_rows``,
  ``pdhg_step``, ``kkt_residuals_rows``): 1e-12 relative in float64, 1e-5 in
  float32 — the same arithmetic, only the reduction order differs;
* the restart loop (``_solve_rows``) in float64 at a fixed budget with ``tol=0``: the same
  iteration and restart counts and ``x`` within 1e-9.  (Once a problem sits
  at float64's rounding floor, ~1e-16, the restart test compares rounding
  noise, and the two packages' reduction orders could fire a restart on
  different blocks; on this input they agree everywhere.);
* the restart loop in float32 at the default tolerance: ``feasible`` equal and the
  objective within 1e-3 relative (to ``max(1, |objective|)``);
* against the exact Seidel backends (the reference's own ``test_pdhg.py``):
  ``feasible`` equal, objectives within ``rtol=atol=2e-3`` at ``tol=1e-5``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.pdhg as rp
import repro.pdhg.iteration as rpi
import repro_torch.pdhg as tp
import repro_torch.pdhg.iteration as tpi
from repro.pdhg.solve import _solve_rows as ref_solve_rows
from repro_torch.core import LPBatch, normalize_packed
from repro_torch.pdhg.solve import _solve_rows as port_solve_rows
from repro_torch.solver import SolverSpec
from _torch_compat import CPU, to_torch_batch, to_torch_packed

TOL = 1e-5
OBJ_RTOL = OBJ_ATOL = 2e-3
BLOCK_RTOL = {"float64": 1e-12, "float32": 1e-5}


def _rows(seed, B, m, dtype):
    """Random component rows, duals, iterates and scales in numpy."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 2 * np.pi, (B, m))
    d = dict(ax=np.cos(theta), ay=np.sin(theta),
             bb=rng.uniform(0.1, 5.0, (B, m)),
             c=rng.normal(size=(B, 2)), x=rng.uniform(-3, 3, (B, 2)),
             y=np.maximum(rng.normal(size=(B, m)), 0.0),
             tau=rng.uniform(0.1, 1.0, B), sigma=rng.uniform(0.1, 1.0, B),
             M=rng.uniform(2.0, 4.0, (B, 1)))
    d["x"][:3] = d["M"][:3]            # components at the box bound
    return {k: v.astype(dtype) for k, v in d.items()}


def _call(mod, np_, name, d):
    ax, ay, bb, c, x, y = (np_(d[k]) for k in ("ax", "ay", "bb", "c", "x",
                                               "y"))
    if name == "matvec_rows":
        return (mod.matvec_rows(ax, ay, x),)
    if name == "rmatvec_rows":
        return (mod.rmatvec_rows(ax, ay, y),)
    if name == "spectral_norm_rows":
        return (mod.spectral_norm_rows(ax, ay),)
    if name == "pdhg_step":
        return mod.pdhg_step(x, y, ax, ay, bb, c, np_(d["tau"]),
                             np_(d["sigma"]), np_(d["M"]))
    return mod.kkt_residuals_rows(
        x, y, ax, ay, bb, c, M=np_(d["M"]), b_scale=1.0 + np_(d["M"])[:, 0],
        c_scale=1.0 + np_(d["M"])[:, 0], bound_tol=1e-6 * np_(d["M"]))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["matvec_rows", "rmatvec_rows",
                                  "spectral_norm_rows", "pdhg_step",
                                  "kkt_residuals_rows"])
def test_building_blocks_match_reference(name, dtype):
    d = _rows(1, 12, 40, dtype)
    with jax.enable_x64(dtype == "float64"):
        ref = [np.asarray(r) for r in _call(rpi, jnp.asarray, name, d)]
    got = [t.numpy() for t in _call(tpi, torch.from_numpy, name, d)]
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert g.dtype == np.dtype(dtype) and g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=BLOCK_RTOL[dtype],
                                   atol=BLOCK_RTOL[dtype])


def _mixed_numpy(seed, B, m, dtype):
    """Feasible, ragged and infeasible problems (numpy), normalised rows."""
    rng = np.random.default_rng(seed)
    xstar = rng.uniform(-50, 50, (B, 1, 2))
    theta = rng.uniform(0, 2 * np.pi, (B, m))
    A = np.stack([np.cos(theta), np.sin(theta)], -1)
    b = (A * xstar).sum(-1) + rng.uniform(0.1, 5.0, (B, m))
    phi = rng.uniform(0, 2 * np.pi, B)
    c = np.stack([np.cos(phi), np.sin(phi)], -1)
    mv = np.full(B, m, np.int32)
    mv[B // 2:] = rng.integers(3, m + 1, B - B // 2)       # ragged half
    A[-2:, 0], b[-2:, 0] = (1.0, 0.0), -1.0                # two infeasible
    A[-2:, 1], b[-2:, 1] = (-1.0, 0.0), -1.0
    keep = np.arange(m)[None] < mv[:, None]
    A = np.where(keep[..., None], A, 0.0)
    b = np.where(keep, b, 1.0)
    return (A.astype(dtype), b.astype(dtype), c.astype(dtype), mv)


def _both(A, b, c, mv, **kw):
    """The reference's and the port's restart loop on the same rows."""
    dt = A.dtype
    with jax.enable_x64(dt == np.float64):
        rs, rst = ref_solve_rows(jnp.asarray(A[..., 0]),
                                 jnp.asarray(A[..., 1]), jnp.asarray(b),
                                 jnp.asarray(c), jnp.asarray(mv), **kw)
        rs = jax.tree_util.tree_map(np.asarray, rs)
        rst = jax.tree_util.tree_map(np.asarray, rst)
    T = torch.from_numpy
    ps, pst = port_solve_rows(T(np.ascontiguousarray(A[..., 0])),
                              T(np.ascontiguousarray(A[..., 1])), T(b),
                              T(c), T(mv), **kw)
    return rs, rst, ps, pst


def test_restart_loop_float64_fixed_budget_matches_reference():
    A, b, c, mv = _mixed_numpy(2, 40, 48, np.float64)
    rs, rst, ps, pst = _both(A, b, c, mv, M=1e4, tol=0.0, max_iters=512,
                             iter_block=64, restart_period=256)
    np.testing.assert_array_equal(pst.iterations.numpy(), rst.iterations)
    np.testing.assert_array_equal(pst.restarts.numpy(), rst.restarts)
    np.testing.assert_array_equal(ps.feasible.numpy(), rs.feasible)
    np.testing.assert_allclose(ps.x.numpy(), rs.x, rtol=0, atol=1e-9)
    assert pst.restarts.numpy().max() >= 1      # the restart logic ran


def test_restart_loop_float32_default_tolerance_matches_reference():
    A, b, c, mv = _mixed_numpy(3, 40, 48, np.float32)
    rs, rst, ps, pst = _both(A, b, c, mv, M=1e4, tol=None, max_iters=None,
                             iter_block=None, restart_period=None)
    np.testing.assert_array_equal(ps.feasible.numpy(), rs.feasible)
    f = rs.feasible
    rel = (np.abs(ps.objective.numpy() - rs.objective)
           / np.maximum(1.0, np.abs(rs.objective)))
    assert rel[f].max() <= 1e-3
    np.testing.assert_array_equal(pst.converged.numpy(), rst.converged)


def _wedge(extra: bool):
    """The reference's narrow-wedge regression input (vertex far from the
    origin, near-antiparallel active normals); ``extra`` appends two rows
    that do not bind at the vertex."""
    v = np.array([1821.0, 1186.0])
    a1, a2 = 0.7, 0.7 + np.pi - 0.0024
    n1 = np.array([np.cos(a1), np.sin(a1)])
    n2 = np.array([np.cos(a2), np.sin(a2)])
    rows = [n1, n2] + ([np.array([0.0, 1.0]), np.array([1.0, 0.0])]
                       if extra else [])
    A = np.stack(rows)
    b = A @ v + np.array([0.0, 0.0] + ([3000.0, 3000.0] if extra else []))
    return A[None], b[None], (n1 + n2)[None], v


@pytest.mark.parametrize("case", ["zero-duals", "wedge-zero-duals",
                                  "wedge"])
def test_polish_tie_order_matches_reference(case):
    """The crossover polish takes the two highest duals; on ties (zero duals
    tie often) both packages must take the lower indices first, as
    ``lax.top_k`` does — the port sorts stably instead of ``torch.topk``.
    With ``max_iters=0`` no block runs and every dual is 0: rows 0 and 1
    are taken, which on the wedge are its two faces, so both land the
    vertex exactly; any other pair lands elsewhere."""
    if case == "zero-duals":
        A, b, c, mv = _mixed_numpy(4, 16, 12, np.float64)
        v = None
    else:
        A, b, c, v = _wedge(extra=case == "wedge-zero-duals")
        mv = np.array([A.shape[1]], np.int32)
    rs, _, ps, _ = _both(A, b, c, mv, M=1e4, tol=TOL, iter_block=None,
                         restart_period=None,
                         max_iters=None if case == "wedge" else 0)
    np.testing.assert_array_equal(ps.feasible.numpy(), rs.feasible)
    np.testing.assert_allclose(ps.x.numpy(), rs.x, rtol=0, atol=1e-9)
    if v is not None:
        np.testing.assert_allclose(ps.x.numpy()[0], v, rtol=1e-3, atol=1e-2)


# -- the reference's own test_pdhg.py, on the port -------------------------

def _rgb(lp):
    return SolverSpec(backend="rgb").build(device="cpu").solve(lp)


def _assert_matches_exact(lp, sol, label):
    ref = _rgb(lp)
    assert torch.equal(ref.feasible, sol.feasible), label
    f = ref.feasible.numpy()
    if f.any():
        np.testing.assert_allclose(sol.objective.numpy()[f],
                                   ref.objective.numpy()[f], rtol=OBJ_RTOL,
                                   atol=OBJ_ATOL, err_msg=label)


def test_converges_with_certificate():
    lp = to_torch_batch(rc.random_feasible_lp(jax.random.key(0), 32, 48))
    sol, st = tp.solve_pdhg_with_stats(lp, tol=TOL)
    assert isinstance(st, tp.PDHGStats)
    assert bool(st.converged.all())
    assert bool((st.iterations >= 1).all() and (st.restarts >= 0).all())
    _assert_matches_exact(lp, sol, "random-feasible")


def test_packed_matches_aos():
    lp = rc.ragged_feasible_lp(jax.random.key(3), 8, 24, m_min=4)
    a = tp.solve_pdhg(to_torch_batch(lp), tol=TOL)
    p = tp.solve_pdhg_packed(to_torch_packed(rc.pack(lp)), tol=TOL)
    assert torch.equal(a.feasible, p.feasible)
    np.testing.assert_allclose(a.x.numpy(), p.x.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_infeasible_classified():
    lp = to_torch_batch(rc.infeasible_lp(4, 12))
    sol, _ = tp.solve_pdhg_with_stats(lp, tol=TOL)
    assert not bool(sol.feasible.any())
    _assert_matches_exact(lp, sol, "infeasible")


@pytest.mark.parametrize("label", ["ragged", "adversarial"])
def test_ragged_and_adversarial_match_exact(label):
    lp = (rc.ragged_feasible_lp(jax.random.key(9), 10, 32, m_min=3)
          if label == "ragged" else rc.adversarial_lp(4, 24))
    lp = to_torch_batch(lp)
    sol = SolverSpec(backend="pdhg", tol=TOL).build(device="cpu").solve(lp)
    _assert_matches_exact(lp, sol, label)


def test_far_origin_optimum_rescale_regression():
    A = torch.tensor([[[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0]]])
    lp = LPBatch(
        A=A, b=torch.tensor([[2000.0, 1500.0, 0.0, 0.0]]),
        c=torch.tensor([[1.0, 1.0]]),
        m_valid=torch.tensor([4], dtype=torch.int32))
    sol, st = tp.solve_pdhg_with_stats(lp, tol=TOL)
    assert bool(sol.feasible[0]) and bool(st.converged[0])
    np.testing.assert_allclose(float(sol.objective[0]), 3500.0, rtol=1e-4)


def test_narrow_wedge_crossover_polish_regression():
    A, b, c, v = _wedge(extra=False)
    lp = to_torch_batch(rc.make_batch(jnp.asarray(A, jnp.float32),
                                      jnp.asarray(b, jnp.float32),
                                      jnp.asarray(c, jnp.float32)))
    sol = SolverSpec(backend="pdhg", tol=TOL).build(device="cpu").solve(lp)
    assert bool(sol.feasible[0])
    np.testing.assert_allclose(sol.x.numpy()[0], v, rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(float(sol.objective[0]), float(c[0] @ v),
                               rtol=1e-3, atol=1e-3)


def test_restarts_fire_with_short_period():
    lp = to_torch_batch(rc.random_feasible_lp(jax.random.key(4), 8, 64))
    _, st = tp.solve_pdhg_with_stats(lp, tol=TOL,
                                     iter_block=tp.DEFAULT_ITER_BLOCK,
                                     restart_period=tp.DEFAULT_ITER_BLOCK)
    ran_long = st.iterations >= 3 * tp.DEFAULT_ITER_BLOCK
    assert bool((st.restarts[ran_long] >= 1).all())


def test_solver_spec_front_end_matches_direct_call():
    pb = to_torch_packed(rc.pack(rc.random_feasible_lp(jax.random.key(6),
                                                       8, 32)))
    via_spec = SolverSpec(backend="pdhg", tol=TOL, iter_block=64,
                          restart_period=1024).build(device="cpu").solve(pb)
    # the front end normalises the rows first; solving the normalised
    # rows directly is the same computation, bit for bit
    direct = tp.solve_pdhg_packed(normalize_packed(pb), tol=TOL,
                                  iter_block=64, restart_period=1024)
    assert torch.equal(via_spec.x, direct.x)
    assert torch.equal(via_spec.feasible, direct.feasible)
    raw = tp.solve_pdhg_packed(pb, tol=TOL, iter_block=64,
                               restart_period=1024)
    assert torch.equal(raw.feasible, direct.feasible)
    np.testing.assert_allclose(raw.x.numpy(), direct.x.numpy(), rtol=1e-5,
                               atol=1e-4)


def test_stats_are_tensors_on_the_solve_device():
    """The port's counterpart of the reference's pytree test: every field
    of ``PDHGStats`` is a ``(B,)`` tensor on the device the solve ran on."""
    lp = to_torch_batch(rc.random_feasible_lp(jax.random.key(8), 4, 16))
    sol, st = tp.solve_pdhg_with_stats(lp, tol=TOL)
    fields = dataclasses.fields(tp.PDHGStats)
    assert len(fields) == 7
    for f in fields:
        t = getattr(st, f.name)
        assert isinstance(t, torch.Tensor) and t.shape == (4,)
        assert t.device == CPU == sol.x.device
    assert st.iterations.dtype == torch.int32
    assert st.converged.dtype == torch.bool


def test_no_constraints_is_the_box_corner():
    """``m == 0``: no iteration, the preferred box corner, as in the
    reference."""
    c = np.array([[1.0, -2.0], [0.0, 0.0], [-1.0, 0.0]], np.float32)
    A = np.zeros((3, 0, 2), np.float32)
    b = np.zeros((3, 0), np.float32)
    mv = np.zeros(3, np.int32)
    rs, rst, ps, pst = _both(A, b, c, mv, M=1e4, tol=None, max_iters=None,
                             iter_block=None, restart_period=None)
    np.testing.assert_array_equal(ps.x.numpy(), rs.x)
    assert bool(ps.feasible.all()) and bool(pst.converged.all())
    assert int(pst.iterations.max()) == 0


def test_defaults_and_constants_match_reference():
    for name in ("DEFAULT_ITER_BLOCK", "DEFAULT_RESTART_PERIOD",
                 "FEAS_EPS_REL"):
        assert getattr(tp, name) == getattr(rp, name)
    import repro.pdhg.solve as rps
    import repro_torch.pdhg.solve as tps
    for name in ("RESTART_BETA", "STEP_SAFETY", "OMEGA_MIN", "OMEGA_MAX",
                 "OMEGA_STEP_CLAMP", "DIVERGE_FACTOR", "DIVERGE_KKT_FLOOR"):
        assert getattr(tps, name) == getattr(rps, name), name
    assert tpi.EPS_GUARD == rpi.EPS_GUARD
    for dt_t, dt_j in ((torch.float32, jnp.float32),
                       (torch.float64, jnp.float64)):
        assert tp.default_tol(dt_t) == rp.default_tol(dt_j)
        assert tp.default_max_iters(dt_t) == rp.default_max_iters(dt_j)
