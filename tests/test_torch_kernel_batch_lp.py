"""The port's RGB kernel module against the reference's Pallas kernel.

On the CPU the port runs the kernel's plain version (``rgb_plain``); the
reference kernel runs as its own tests run it, in interpret mode.  Both get
the same padded packed arrays.  Tolerances are the reference's own
(``tests/test_kernel_batch_lp.py``): ``feasible`` exactly, ``x``
rtol=atol=1e-4, ``objective`` 2e-4 — FMA contraction and reduction order
differ between the frameworks, the algorithm does not.  The CUDA kernel
itself is held against ``rgb_plain`` on the card (``test_torch_gpu.py``,
``chip_smoke.py``)."""
import jax
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

import repro.core as rc
from repro.kernels import ops as rops
from repro.kernels.batch_lp import rgb_pallas
from repro_torch.kernels import ops as tops, ref as tref
from repro_torch.kernels.batch_lp import (DEFAULT_TILE, LANE, SMEM_PER_BLOCK,
                                          WARPS_PER_CTA, _pick_tile,
                                          finish_cuda, launch_geometry,
                                          max_staged_m_pad, prep_cuda,
                                          region_bytes, rgb_cuda, rgb_plain)
from repro_torch.core import normalize_batch, pack, pad_packed_batch_dim
from _torch_compat import CPU, OBJ_TOL, X_TOL, to_torch_batch

M = 1.0e4


def _reference_inputs(lp, tile):
    """Normalised (and already shuffled) reference batch -> the padded
    packed numpy arrays both kernels take."""
    L, c, mv = rops.pack_constraints(lp)
    pb = rc.pad_packed_batch_dim(
        rc.PackedLPBatch(L=L, c=c, m_valid=mv), -(-lp.batch // tile) * tile)
    return pb.L, pb.c, pb.m_valid


def _both(lp, tile=8, chunk=0):
    """(reference x, feas), (port x, feas) on the same arrays."""
    L, c, mv = _reference_inputs(lp, tile)
    xr, fr = rgb_pallas(L, c, mv, M=M, tile=tile, chunk=chunk,
                        interpret=True)
    xt, ft = rgb_plain(torch.from_numpy(np.array(L)),
                       torch.from_numpy(np.array(c)),
                       torch.from_numpy(np.array(mv)), M=M, tile=tile,
                       chunk=chunk)
    B = lp.batch
    return ((np.asarray(xr)[:B], np.asarray(fr)[:B, 0]),
            (xt.numpy()[:B], ft.numpy()[:B, 0]))


def _assert_match(ref, port):
    (xr, fr), (xt, ft) = ref, port
    np.testing.assert_array_equal(fr, ft)
    ok = fr != 0
    np.testing.assert_allclose(xt[ok], xr[ok], **X_TOL)


@pytest.mark.parametrize("batch,m", [
    (8, 5), (64, 37), (100, 200), (3, 1), (128, 128), (17, 513),
])
def test_plain_matches_reference_kernel(batch, m):
    lp = rc.random_feasible_lp(jax.random.key(batch + m), batch, m)
    nb = rc.shuffle_batch(jax.random.key(1), rc.normalize_batch(lp))
    _assert_match(*_both(nb))


def test_plain_infeasible():
    lp = rc.normalize_batch(rc.infeasible_lp(16, 20))
    ref, port = _both(lp)
    _assert_match(ref, port)
    assert not port[1].any()


def test_plain_ragged():
    lp = rc.shuffle_batch(jax.random.key(7), rc.normalize_batch(
        rc.ragged_feasible_lp(jax.random.key(6), 40, 70)))
    _assert_match(*_both(lp))


def test_plain_adversarial():
    lp = rc.normalize_batch(rc.adversarial_lp(8, 60))
    _assert_match(*_both(lp))


def _torch_inputs(seed=2, batch=48, m=30, tile=8, dtype=torch.float32):
    lp = rc.normalize_batch(
        rc.random_feasible_lp(jax.random.key(seed), batch, m))
    L, c, mv = _reference_inputs(lp, tile)
    return (torch.from_numpy(np.array(L)).to(dtype),
            torch.from_numpy(np.array(c)).to(dtype),
            torch.from_numpy(np.array(mv)))


@pytest.mark.parametrize("tile", [8, 32, 128])
def test_plain_tile_sizes(tile):
    """Per-problem results do not depend on the tile."""
    L, c, mv = _torch_inputs(tile=128)      # 128 rows: every tile divides
    base_x, base_f = rgb_plain(L, c, mv, M=M, tile=128)
    x, f = rgb_plain(L, c, mv, M=M, tile=tile)
    assert torch.equal(f, base_f)
    np.testing.assert_allclose(x.numpy(), base_x.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("chunk", [32, 128])
@pytest.mark.parametrize("kind", ["feasible", "ragged", "adversarial"])
def test_plain_dense_and_chunked_bit_identical(kind, chunk):
    """``chunk=32`` is the warp-rounded scan the CUDA kernel always does:
    the re-solve's min/max/OR over h < i are exact, so every scan width
    gives the dense bits."""
    lp = {"feasible": lambda: rc.random_feasible_lp(jax.random.key(3), 16, 300),
          "ragged": lambda: rc.ragged_feasible_lp(jax.random.key(4), 16, 300),
          "adversarial": lambda: rc.adversarial_lp(8, 200)}[kind]()
    L, c, mv = _reference_inputs(rc.normalize_batch(lp), 8)
    L, c, mv = (torch.from_numpy(np.array(a)) for a in (L, c, mv))
    xd, fd = rgb_plain(L, c, mv, M=M, tile=8, chunk=0)
    xc, fc = rgb_plain(L, c, mv, M=M, tile=8, chunk=chunk)
    assert torch.equal(xd, xc) and torch.equal(fd, fc)
    # ... and the chunked reference kernel agrees too
    xr, fr = rgb_pallas(L.numpy(), c.numpy(), mv.numpy(), M=M, tile=8,
                        chunk=chunk, interpret=True)
    np.testing.assert_array_equal(np.asarray(fr), fc.numpy())
    np.testing.assert_allclose(xc.numpy(), np.asarray(xr), **X_TOL)


@pytest.mark.parametrize("chunk", [0, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_ignores_what_lies_past_m_valid(dtype, chunk):
    """The CUDA kernel copies only columns [0, ceil(m_valid / 32) * 32) of
    a problem: whatever the padding past ``m_valid`` holds (here NaN) must
    give the bits of the neutral padding."""
    lp = rc.shuffle_batch(jax.random.key(9), rc.normalize_batch(
        rc.ragged_feasible_lp(jax.random.key(8), 24, 150)))
    L, c, mv = (torch.from_numpy(np.array(a))
                for a in _reference_inputs(lp, 8))
    L, c = L.to(dtype), c.to(dtype)
    past = torch.arange(L.shape[2])[None, :] >= mv
    assert bool(past.any()) and bool((~past).any())
    Ln = L.clone()
    Ln[:, :3, :][past[:, None, :].expand(-1, 3, -1)] = float("nan")
    xa, fa = rgb_plain(L, c, mv, M=M, tile=8, chunk=chunk)
    xb, fb = rgb_plain(Ln, c, mv, M=M, tile=8, chunk=chunk)
    assert torch.equal(fa, fb) and torch.equal(xa, xb)
    assert bool(torch.isfinite(xb).all())


@pytest.mark.parametrize("launcher", [rgb_plain, rgb_cuda])
def test_launcher_value_errors(launcher):
    """The reference launcher's three ValueErrors, same conditions."""
    L, c, mv = _torch_inputs(batch=16, m=30, tile=8)      # (16, 4, 128)
    with pytest.raises(ValueError, match="not a multiple of tile"):
        launcher(L, c, mv, M=M, tile=5)
    with pytest.raises(ValueError, match=f"not a multiple of {LANE}"):
        launcher(L[:, :, :100].contiguous(), c, mv, M=M, tile=8)
    with pytest.raises(ValueError, match="% chunk"):
        launcher(L, c, mv, M=M, tile=8, chunk=48)
    with pytest.raises(ValueError):
        launcher(L, c[:, :1], mv, M=M, tile=8)
    with pytest.raises(ValueError):
        launcher(L, c, mv.to(torch.int64), M=M, tile=8)
    with pytest.raises(TypeError):
        launcher(L.to(torch.float16), c.to(torch.float16), mv, M=M, tile=8)


def test_wrapper_runs_plain_only_for_cpu_tensors():
    """On CPU tensors ``rgb_cuda`` is ``rgb_plain`` and counts no launch."""
    L, c, mv = _torch_inputs()
    n0 = rgb_cuda.launches
    x, f = rgb_cuda(L, c, mv, M=M, tile=8)
    xp, fp = rgb_plain(L, c, mv, M=M, tile=8)
    assert torch.equal(x, xp) and torch.equal(f, fp)
    assert f.dtype == torch.int32 and f.shape == (48, 1)
    assert rgb_cuda.launches == n0
    assert isinstance(rgb_cuda.launches, int)


@pytest.mark.parametrize("which", ["prep-aos", "prep-packed", "finish"])
def test_front_end_passes_refuse_cpu_tensors(which):
    """``prep_cuda`` and ``finish_cuda`` have no CPU mode (their plain
    version is the solver's eager chain): on CPU tensors they raise before
    building or launching anything."""
    L, c, mv = _torch_inputs()
    lp = to_torch_batch(rc.random_feasible_lp(jax.random.key(0), 8, 20))
    n0 = (prep_cuda.launches, finish_cuda.launches)
    with pytest.raises(ValueError, match="unsupported device cpu"):
        if which == "prep-aos":
            prep_cuda(lp.A, lp.b, lp.c, lp.m_valid, m_pad=LANE, b_pad=8)
        elif which == "prep-packed":
            prep_cuda(L, None, c, mv, m_pad=L.shape[2], b_pad=L.shape[0])
        else:
            finish_cuda(torch.zeros((8, 2)), torch.zeros((8, 1), dtype=
                        torch.int32), torch.zeros((8, 2)), 8)
    assert (prep_cuda.launches, finish_cuda.launches) == n0


def test_plain_pad_problems_and_clamped_m_valid():
    L, c, mv = _torch_inputs(batch=5, m=20, tile=8)       # rows 5..7 are pad
    x, f = rgb_plain(L, c, mv, M=M, tile=8)
    assert bool((f[5:] == 1).all())
    assert torch.equal(x[5:], torch.tensor([[M, M]] * 3))  # c=(1,0) corner
    # m_valid beyond m_pad is clamped to m_pad (same answer as m_pad)
    big = torch.full_like(mv, 10_000)
    full = torch.full_like(mv, L.shape[2])
    xa, fa = rgb_plain(L, c, big, M=M, tile=8)
    xb, fb = rgb_plain(L, c, full, M=M, tile=8)
    assert torch.equal(xa, xb) and torch.equal(fa, fb)


def test_plain_counts_resolves():
    L, c, mv = _torch_inputs(tile=8)
    stats = {}
    rgb_plain(L, c, mv, M=M, tile=8, stats=stats)
    assert stats["resolves"] > 0
    assert 0 < stats["resolve_work"] <= stats["resolves"] * L.shape[2]
    # tile does not change what has to be re-solved
    stats2 = {}
    rgb_plain(L, c, mv, M=M, tile=48, stats=stats2)
    assert stats2 == stats


def test_pick_tile_for_hopper():
    # a narrow problem fills a whole CTA, one problem per warp
    assert DEFAULT_TILE == launch_geometry(LANE, 4, DEFAULT_TILE).warps
    assert DEFAULT_TILE == WARPS_PER_CTA
    assert 1 <= WARPS_PER_CTA <= 32
    assert _pick_tile() == DEFAULT_TILE
    assert _pick_tile(10**6) == DEFAULT_TILE
    # small batches are not padded up to a whole default tile
    assert _pick_tile(3) == 3
    assert _pick_tile(1) == 1
    assert _pick_tile(DEFAULT_TILE + 1) == DEFAULT_TILE


@pytest.mark.parametrize("itemsize,limit", [(4, 19_328), (8, 9_600)])
def test_launch_geometry_fits_shared_memory(itemsize, limit):
    """Warps x region fit the block's shared memory; the staged regime
    ends exactly where one warp's region stops fitting; the tile pick is
    untouched by any of it."""
    assert max_staged_m_pad(itemsize) == limit
    assert region_bytes(limit, itemsize) <= SMEM_PER_BLOCK
    assert region_bytes(limit + LANE, itemsize) > SMEM_PER_BLOCK
    for m_pad in range(LANE, 2 * limit, LANE):
        for tile in (1, 3, 8, 32, 96):
            g = launch_geometry(m_pad, itemsize, tile)
            assert 1 <= g.warps <= min(tile, WARPS_PER_CTA)
            assert 0 <= g.smem_bytes <= SMEM_PER_BLOCK
            assert g.staged == (m_pad <= limit)
            if g.staged:
                assert g.smem_bytes == g.warps * region_bytes(m_pad, itemsize)
                # a warp is dropped only where its region would not fit
                assert (g.warps == min(tile, WARPS_PER_CTA)
                        or (g.warps + 1) * region_bytes(m_pad, itemsize)
                        > SMEM_PER_BLOCK)
            else:
                assert g.smem_bytes == 0
                assert g.warps == min(tile, WARPS_PER_CTA)
    # the widest staged problem still gets one warp, the next is unstaged
    assert launch_geometry(limit, itemsize, 8).warps == 1
    assert not launch_geometry(limit + LANE, itemsize, 8).staged
    with pytest.raises(ValueError):
        launch_geometry(256, itemsize, 0)
    assert _pick_tile(4096) == DEFAULT_TILE and _pick_tile(5) == 5


def test_ops_and_ref_match_reference():
    lp = rc.normalize_batch(rc.random_feasible_lp(jax.random.key(0), 32, 50))
    tlp = to_torch_batch(lp)
    L, c, mv = rops.pack_constraints(lp)
    tL, tcc, tmv = tops.pack_constraints(tlp)
    np.testing.assert_array_equal(np.asarray(L), tL.numpy())
    np.testing.assert_array_equal(np.asarray(c), tcc.numpy())
    np.testing.assert_array_equal(np.asarray(mv), tmv.numpy())
    assert tL.shape[2] % LANE == 0
    with pytest.raises(ValueError):
        tops.pack_constraints(tlp, 100)
    x_ref, feas_ref = tref.solve_packed_ref(tL, tcc, tmv)
    x, feas = rgb_plain(tL, tcc, tmv, M=M, tile=8)
    np.testing.assert_array_equal(feas_ref.numpy(), feas[:, 0].numpy())
    np.testing.assert_allclose(x.numpy(), x_ref.numpy(), **X_TOL)
    back = tref.unpack_constraints(tL, tcc, tmv)
    assert torch.equal(back.A[:, :50], tlp.A) and back.m == tL.shape[2]


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 2**30), m=st.integers(2, 90),
       batch=st.sampled_from([5, 16]))
def test_plain_property_sweep(seed, m, batch):
    """Seeded numpy problems of ``m`` constraints, carried ragged in a fixed
    (batch, 90) array so the reference compiles one program per batch."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0.0, 2.0 * np.pi, (batch, 90))
    A = np.stack([np.cos(theta), np.sin(theta)], axis=-1)
    b = (A * rng.uniform(-50.0, 50.0, (batch, 1, 2))).sum(-1) + rng.uniform(
        0.1, 5.0, (batch, 90))
    keep = np.arange(90)[None, :] < m
    A, b = np.where(keep[..., None], A, 0.0), np.where(keep, b, 1.0)
    phi = rng.uniform(0.0, 2.0 * np.pi, batch)
    c = np.stack([np.cos(phi), np.sin(phi)], axis=-1)
    lp = rc.make_batch(A.astype(np.float32), b.astype(np.float32),
                       c.astype(np.float32), np.full((batch,), m, np.int32))
    (xr, fr), (xt, ft) = _both(lp)
    np.testing.assert_array_equal(fr, ft)
    assert ft.all()
    np.testing.assert_allclose((c * xt).sum(-1), (c * xr).sum(-1), **OBJ_TOL)


def _scipy_objectives(A, b, c, mv):
    from scipy.optimize import linprog
    out = []
    for i in range(A.shape[0]):
        m = int(mv[i])
        res = linprog(-c[i], A_ub=A[i, :m], b_ub=b[i, :m],
                      bounds=[(-M, M), (-M, M)], method="highs")
        out.append(-res.fun if res.status == 0 else np.nan)
    return np.array(out)


@pytest.mark.parametrize("kind", ["adversarial", "ragged", "infeasible"])
def test_plain_float64_against_scipy_and_float32_reference(kind):
    """float64 in the port needs no global switch: the same numpy arrays go
    to scipy (float64), to the port (float64) and to the reference kernel
    (float32 — no ``jax_enable_x64`` flip in this process)."""
    pytest.importorskip("scipy")
    lp32 = {"adversarial": lambda: rc.adversarial_lp(4, 24),
            "ragged": lambda: rc.ragged_feasible_lp(jax.random.key(5), 6, 18,
                                                    m_min=3),
            "infeasible": lambda: rc.infeasible_lp(3, 8)}[kind]()
    A, b, c, mv = (np.asarray(a, np.float64) for a in
                   (lp32.A, lp32.b, lp32.c, lp32.m_valid))
    want = _scipy_objectives(A, b, c, mv)
    from repro_torch.core import batch_from_numpy
    tlp = normalize_batch(batch_from_numpy(A, b, c, mv.astype(np.int32),
                                           device=CPU))
    assert tlp.A.dtype == torch.float64
    pb = pad_packed_batch_dim(
        pack(tlp, -(-tlp.m // LANE) * LANE), -(-tlp.batch // 8) * 8)
    x, f = rgb_plain(pb.L, pb.c, pb.m_valid, M=M, tile=8)
    assert x.dtype == torch.float64
    B = tlp.batch
    feas = f.numpy()[:B, 0].astype(bool)
    np.testing.assert_array_equal(feas, ~np.isnan(want))
    obj = (c * x.numpy()[:B]).sum(-1)
    for i in np.flatnonzero(feas):
        assert abs(obj[i] - want[i]) <= 1e-7 * (1.0 + abs(want[i]))
    # ... and the float32 reference kernel agrees to float32 tolerance
    (xr, fr), _ = _both(rc.normalize_batch(lp32))
    np.testing.assert_array_equal(fr.astype(bool), feas)
    np.testing.assert_allclose(x.numpy()[:B][feas], xr[feas], rtol=1e-3,
                               atol=1e-3)
