"""The port's data layer (``repro_torch.core``) against the reference
(``repro.core``) on the same numpy arrays, plus the laws of the port's own
shuffle and generators (a ``jax.random`` stream cannot be reproduced, so
those are tested for what they must satisfy, not for equal draws)."""
import jax
import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch.core as tc
from repro_torch.core.lp import PAD_B
from _torch_compat import CPU, X_TOL, to_torch_batch, to_torch_packed


def _ref_ragged(seed=0, batch=12, m=20):
    return rc.ragged_feasible_lp(jax.random.key(seed), batch, m)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_batch_equal(ref, port, exact=True):
    cmp = (np.testing.assert_array_equal if exact else
           lambda a, b: np.testing.assert_allclose(a, b, rtol=2e-7, atol=0))
    for f in ("A", "b", "c"):
        cmp(_np(getattr(port, f)), _np(getattr(ref, f)))
    np.testing.assert_array_equal(_np(port.m_valid), _np(ref.m_valid))


def _assert_packed_equal(ref, port, exact=True):
    cmp = (np.testing.assert_array_equal if exact else
           lambda a, b: np.testing.assert_allclose(a, b, rtol=2e-7, atol=0))
    cmp(_np(port.L), _np(ref.L))
    cmp(_np(port.c), _np(ref.c))
    np.testing.assert_array_equal(_np(port.m_valid), _np(ref.m_valid))
    assert port.m_valid.dtype == torch.int32 and port.m_valid.ndim == 2


def test_pack_unpack_match_reference():
    lp = _ref_ragged()
    tlp = to_torch_batch(lp)
    _assert_packed_equal(rc.pack(lp), tc.pack(tlp))
    _assert_packed_equal(rc.pack(lp, 32), tc.pack(tlp, 32))
    _assert_batch_equal(rc.unpack(rc.pack(lp, 32)),
                        tc.unpack(tc.pack(tlp, 32)))
    # lossless round trip inside the port
    _assert_batch_equal(tlp, tc.unpack(tc.pack(tlp)))
    with pytest.raises(ValueError):
        tc.pack(tlp, 3)


def test_pack_layout_rows_and_views():
    tlp = to_torch_batch(_ref_ragged(1, 4, 6))
    pb = tc.pack(tlp)
    assert pb.L.shape == (4, 4, 6) and pb.batch == 4 and pb.m_pad == 6
    assert torch.equal(pb.ax, tlp.A[..., 0])
    assert torch.equal(pb.ay, tlp.A[..., 1])
    assert torch.equal(pb.b, tlp.b)
    assert not pb.L[:, 3].any()
    assert pb.ax.data_ptr() == pb.L.data_ptr()   # views, not copies


def test_pad_batch_and_pad_packed_match_reference():
    lp = _ref_ragged(2)
    tlp = to_torch_batch(lp)
    _assert_batch_equal(rc.pad_batch(lp, 33), tc.pad_batch(tlp, 33))
    _assert_batch_equal(rc.pad_batch_dim(lp, 17), tc.pad_batch_dim(tlp, 17))
    pb, tpb = rc.pack(lp), tc.pack(tlp)
    _assert_packed_equal(rc.pad_packed(pb, 128), tc.pad_packed(tpb, 128))
    _assert_packed_equal(rc.pad_packed_batch_dim(pb, 16),
                         tc.pad_packed_batch_dim(tpb, 16))
    assert tc.pad_batch(tlp, tlp.m) is tlp
    assert tc.pad_packed(tpb, tpb.m_pad) is tpb
    for fn, arg in ((tc.pad_batch, 3), (tc.pad_batch_dim, 3)):
        with pytest.raises(ValueError):
            fn(tlp, arg)
    for fn, arg in ((tc.pad_packed, 3), (tc.pad_packed_batch_dim, 3)):
        with pytest.raises(ValueError):
            fn(tpb, arg)


def test_pad_problems_are_neutral():
    tpb = tc.pad_packed_batch_dim(tc.pack(to_torch_batch(_ref_ragged())), 16)
    assert not tpb.m_valid[12:].any()
    assert torch.equal(tpb.c[12:], torch.tensor([[1.0, 0.0]] * 4))
    assert not tpb.L[12:, :2].any()
    assert bool((tpb.L[12:, 2] == PAD_B).all())


def test_concat_split_match_reference():
    a, b = _ref_ragged(3, 5, 9), _ref_ragged(4, 7, 14)
    ta, tb = to_torch_batch(a), to_torch_batch(b)
    _assert_batch_equal(rc.concat_batches([a, b]),
                        tc.concat_batches([ta, tb]))
    _assert_packed_equal(rc.concat_packed([rc.pack(a), rc.pack(b)]),
                         tc.concat_packed([tc.pack(ta), tc.pack(tb)]))
    fused = tc.concat_batches([ta, tb])
    parts = tc.split_batch(fused, [5, 7])
    ref_parts = rc.split_batch(rc.concat_batches([a, b]), [5, 7])
    for r, p in zip(ref_parts, parts):
        _assert_batch_equal(r, p)
    pparts = tc.split_packed(tc.pack(fused), [5, 7])
    assert [p.batch for p in pparts] == [5, 7]
    assert torch.equal(pparts[1].L, tc.pack(fused).L[5:])
    with pytest.raises(ValueError):
        tc.concat_batches([])
    with pytest.raises(ValueError):
        tc.concat_packed([])


@pytest.mark.parametrize("split", ["split_batch", "split_packed"])
def test_split_remainder_policy(split):
    tlp = to_torch_batch(_ref_ragged(5, 8, 6))
    obj = tlp if split == "split_batch" else tc.pack(tlp)
    fn = getattr(tc, split)
    with pytest.raises(ValueError, match="exceed"):
        fn(obj, [5, 5])
    with pytest.raises(ValueError, match="allow_remainder"):
        fn(obj, [3, 2])
    parts = fn(obj, [3, 2], allow_remainder=True)
    assert [p.batch for p in parts] == [3, 2]


def test_normalize_matches_reference_and_is_layout_invariant():
    lp = _ref_ragged(6)
    # scale rows so normalisation has work to do
    lp = rc.LPBatch(A=lp.A * 3.0, b=lp.b * 3.0, c=lp.c, m_valid=lp.m_valid)
    tlp = to_torch_batch(lp)
    # against the reference: 1-ulp material (norm + divide round apart)
    _assert_batch_equal(rc.normalize_batch(lp), tc.normalize_batch(tlp),
                        exact=False)
    _assert_packed_equal(rc.normalize_packed(rc.pack(lp)),
                         tc.normalize_packed(tc.pack(tlp)), exact=False)
    # inside the port: packed and AoS normalise to the same bits
    _assert_packed_equal(tc.pack(tc.normalize_batch(tlp)),
                         tc.normalize_packed(tc.pack(tlp)))
    n = tc.normalize_batch(tlp)
    norms = torch.linalg.vector_norm(n.A, dim=-1)
    valid = torch.arange(n.m)[None] < n.m_valid[:, None]
    np.testing.assert_allclose(norms[valid].numpy(), 1.0, rtol=1e-6)
    assert not norms[~valid].any()          # padding rows stay zero


def test_shuffle_laws():
    """Valid columns permuted, padding at the tail, packed == AoS, optimum
    unchanged to tolerance."""
    tlp = tc.normalize_batch(to_torch_batch(_ref_ragged(7, 16, 24)))
    g = lambda: torch.Generator().manual_seed(11)
    sh = tc.shuffle_batch(g(), tlp)
    assert torch.equal(sh.m_valid, tlp.m_valid) and torch.equal(sh.c, tlp.c)
    moved = 0
    for i in range(tlp.batch):
        mv = int(tlp.m_valid[i])
        rows = torch.cat([tlp.A[i], tlp.b[i, :, None]], dim=1)
        srows = torch.cat([sh.A[i], sh.b[i, :, None]], dim=1)
        # same multiset of valid rows
        key = lambda r: sorted(map(tuple, r.tolist()))
        assert key(rows[:mv]) == key(srows[:mv])
        # padding stays at the tail, untouched
        assert torch.equal(rows[mv:], srows[mv:])
        moved += int(not torch.equal(rows[:mv], srows[:mv]))
    assert moved >= tlp.batch // 2          # it really permutes
    # same generator state -> same permutation in both layouts
    shp = tc.shuffle_packed(g(), tc.pack(tlp))
    _assert_packed_equal(tc.pack(sh), shp)
    # the optimum does not depend on the order
    a, b = tc.solve_rgb(tlp), tc.solve_rgb(sh)
    assert torch.equal(a.feasible, b.feasible)
    np.testing.assert_allclose(a.x.numpy(), b.x.numpy(), **X_TOL)


def test_shuffle_is_stable_for_padding():
    # all-padding problem: the stable argsort must leave it as it is
    tlp = tc.pad_batch_dim(to_torch_batch(_ref_ragged(8, 3, 5)), 6)
    sh = tc.shuffle_batch(torch.Generator().manual_seed(0), tlp)
    assert torch.equal(sh.A[3:], tlp.A[3:])
    assert torch.equal(sh.b[3:], tlp.b[3:])


@pytest.mark.parametrize("gen", ["random_feasible_lp", "replicated_lp",
                                 "ragged_feasible_lp", "adversarial_lp",
                                 "infeasible_lp"])
def test_generators_shapes_and_feasibility(gen):
    B, m = 10, 17
    fn = getattr(tc, gen)
    if gen in ("adversarial_lp", "infeasible_lp"):
        lp = fn(B, m, device=CPU)
        # deterministic generators: equal to the reference's arrays
        _assert_batch_equal(getattr(rc, gen)(B, m), lp, exact=False)
    else:
        lp = fn(torch.Generator().manual_seed(3), B, m, device=CPU)
    assert lp.A.shape == (B, m, 2) and lp.b.shape == (B, m)
    assert lp.c.shape == (B, 2) and lp.m_valid.shape == (B,)
    assert lp.A.dtype == torch.float32 and lp.m_valid.dtype == torch.int32
    assert lp.A.device == CPU
    sol = tc.solve_rgb(tc.normalize_batch(lp))
    if gen == "infeasible_lp":
        assert not sol.feasible.any()
    else:
        assert sol.feasible.all()
        # the optimum satisfies every valid constraint
        n = tc.normalize_batch(lp)
        lhs = (n.A * sol.x[:, None, :]).sum(-1)
        valid = torch.arange(m)[None] < n.m_valid[:, None]
        assert bool(((lhs <= n.b + 1e-3) | ~valid).all())
    if gen == "replicated_lp":
        assert bool((lp.A == lp.A[0]).all()) and bool((lp.b == lp.b[0]).all())
    if gen == "ragged_feasible_lp":
        assert int(lp.m_valid.min()) >= 4 and int(lp.m_valid.max()) <= m
        pad = torch.arange(m)[None] >= lp.m_valid[:, None]
        assert not lp.A[pad].any() and bool((lp.b[pad] == PAD_B).all())


def test_make_batch_coerces_and_places():
    lp = tc.make_batch(np.ones((3, 2), np.float32), np.ones(3, np.float64),
                       [1, 0], device=CPU)
    assert lp.A.shape == (1, 3, 2)
    assert lp.b.dtype == torch.float32 and lp.c.dtype == torch.float32
    assert lp.m_valid.tolist() == [3]
    ints = tc.make_batch(np.ones((2, 3, 2), np.int64), np.ones((2, 3)),
                         np.ones((2, 2)), device=CPU)
    assert ints.A.dtype == torch.float32
    # a tensor input stays where it lies when no device is named
    assert tc.make_batch(torch.ones(2, 3, 2), torch.ones(2, 3),
                         torch.ones(2, 2)).A.device == CPU
    # anything else goes to the default device, which needs a card
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tc.make_batch(np.ones((3, 2)), np.ones(3), [1, 0])


def test_pack_call_counter():
    tlp = to_torch_batch(_ref_ragged(9, 4, 5))
    n0 = tc.pack_call_count()
    pb = tc.pack(tlp)
    assert tc.pack_call_count() == n0 + 1
    tc.normalize_packed(pb), tc.pad_packed(pb, 8), tc.unpack(pb)
    to_torch_packed(rc.pack(_ref_ragged(9, 4, 5)))
    assert tc.pack_call_count() == n0 + 1
    tlp.pack()
    assert tc.pack_call_count() == n0 + 2
    # the card's fused front end counts its AoS conversion the same way
    from repro_torch.core.packed import count_pack
    count_pack()
    assert tc.pack_call_count() == n0 + 3


@pytest.mark.parametrize("backend", ["naive", "rgb", "rgb-chunked"])
@pytest.mark.parametrize("kind", ["feasible", "ragged", "adversarial",
                                  "infeasible"])
def test_seidel_matches_reference(kind, backend):
    lp = {"feasible": lambda: rc.random_feasible_lp(jax.random.key(1), 24, 40),
          "ragged": lambda: _ref_ragged(10, 24, 40),
          "adversarial": lambda: rc.adversarial_lp(6, 30),
          "infeasible": lambda: rc.infeasible_lp(5, 12)}[kind]()
    lp = rc.normalize_batch(lp)
    tlp = to_torch_batch(lp)
    if backend == "naive":
        ref, port = rc.solve_naive(lp), tc.solve_naive(tlp)
        portp = tc.solve_naive_packed(tc.pack(tlp))
    else:
        kw = dict(tile=8, chunk=16) if backend == "rgb-chunked" else {}
        ref, port = rc.solve_rgb(lp, **kw), tc.solve_rgb(tlp, **kw)
        portp = tc.solve_rgb_packed(tc.pack(tlp), **kw)
    from _torch_compat import assert_solutions_close
    assert_solutions_close(ref, port)
    # packed and AoS run the same ops: the same bits
    assert torch.equal(port.x, portp.x)
    assert torch.equal(port.feasible, portp.feasible)
    assert torch.equal(port.objective, portp.objective)


def test_onedim_helpers_match_reference():
    import repro.core.oneD as ro
    import repro_torch.core.oneD as to
    assert (ro.EPS_DENOM, ro.EPS_FEAS, ro.EPS_TIE) == (
        to.EPS_DENOM, to.EPS_FEAS, to.EPS_TIE)
    c = np.array([[1.0, 0.0], [0.0, -2.0], [0.0, 0.0], [1e-12, 3.0],
                  [-1.0, 1e-12]], np.float32)
    np.testing.assert_array_equal(
        np.asarray(ro.box_corner(jax.numpy.asarray(c), 1e4)),
        to.box_corner(torch.from_numpy(c), 1e4).numpy())
    np.testing.assert_array_equal(
        np.asarray(ro.perp(jax.numpy.asarray(c))),
        to.perp(torch.from_numpy(c)).numpy())
    rA, rb = ro.box_constraints(7.0)
    tA, tb = to.box_constraints(7.0)
    np.testing.assert_array_equal(np.asarray(rA), tA.numpy())
    np.testing.assert_array_equal(np.asarray(rb), tb.numpy())
    for r, t in zip(ro.box_rows(7.0), to.box_rows(7.0)):
        np.testing.assert_array_equal(np.asarray(r), t.numpy())
