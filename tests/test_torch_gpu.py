"""Checks that need an NVIDIA card: the hand-written CUDA kernel held against
its plain PyTorch version on the same tensors, and the main paths on the card
(solver, scheduler, pdhg, the tuner's fence, one RPC round trip, a full-width
LP-clipped training step, train steps card against CPU, a bf16 checkpoint
round trip, the MoE layer, the SSD scan and a decode step of every family
card against CPU, the serving entry point on the card, the serving
benchmark with the kernel backend, the crowd simulation's two paths), and
two checks too slow for the CPU suite: the pdhg tail of the cross-backend
property sweep and float64 pdhg against HiGHS.

Run them on a machine with a Hopper card and ``nvcc``::

    python -m pytest -q -m gpu tests/test_torch_gpu.py

Whether there is a card is decided inside the ``card`` fixture, when a test
runs — never while this module is imported — so every pytest worker collects
the same tests; without a card each test skips with a reason.  The kernel is
built with ``--fmad=false`` and IEEE division, and the plain version's eager
ops never fuse, so the two are expected to be equal (only the sign of a zero
may differ, where +0 and -0 tie in a re-solve's min or max); the stated
tolerance (``x`` within 1e-4 in float32, 1e-9 in float64, ``feas`` exactly) is
what a later, contracted build would be held to.
"""
import numpy as np
import pytest
import torch

import _torch_compat  # noqa: F401  (this worker's torch threads)
from repro_torch.core import (adversarial_lp, concat_batches, infeasible_lp,
                              make_batch, normalize_batch, normalize_packed,
                              pack, pack_call_count, pad_packed,
                              pad_packed_batch_dim, ragged_feasible_lp,
                              random_feasible_lp)
from repro_torch.kernels import batch_lp
from repro_torch.kernels.batch_lp import (LANE, launch_geometry,
                                          max_staged_m_pad, rgb_cuda,
                                          rgb_plain)
from repro_torch.serve_lp import BatchScheduler
from repro_torch.solver import SolverSpec, solve_with_spec

pytestmark = pytest.mark.gpu

M = 1.0e4
X_TOL = {torch.float32: 1e-4, torch.float64: 1e-9}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _mixed_packed(device, dtype, batch=96, m=200, tile=8):
    """Feasible, ragged, infeasible and adversarial problems in one padded,
    normalised packed batch on ``device``."""
    g = torch.Generator().manual_seed(5)
    q = batch // 4
    lp = concat_batches([
        random_feasible_lp(g, q, m, dtype=dtype, device=device),
        ragged_feasible_lp(g, q, m, dtype=dtype, device=device),
        infeasible_lp(q, m, dtype=dtype, device=device),
        adversarial_lp(q, m, dtype=dtype, device=device)])
    pb = normalize_packed(pad_packed(lp.pack(), -(-m // LANE) * LANE))
    pb = pad_packed_batch_dim(pb, -(-pb.batch // tile) * tile)
    return pb.L.contiguous(), pb.c.contiguous(), pb.m_valid.contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("chunk", [0, 128])
@pytest.mark.parametrize("tile", [1, 8, 32])
def test_kernel_matches_plain(card, dtype, chunk, tile):
    L, c, mv = _mixed_packed(card, dtype, tile=32)
    n0 = rgb_cuda.launches
    x, f = rgb_cuda(L, c, mv, M=M, tile=tile, chunk=chunk)
    torch.cuda.synchronize()
    assert rgb_cuda.launches == n0 + 1
    xp, fp = rgb_plain(L, c, mv, M=M, tile=L.shape[0], chunk=chunk)
    assert torch.equal(f, fp)
    ok = fp[:, 0] != 0
    assert float((x[ok] - xp[ok]).abs().max()) <= X_TOL[dtype]
    assert int(ok.sum()) == 3 * (L.shape[0] // 4)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bit patterns: unlike ``torch.equal``, tells -0 from
    +0."""
    return t.view({4: torch.int32, 8: torch.int64}[t.element_size()])


def _unstaged(L, c, mv, tile):
    """The kernel in its global-memory regime at a shape it would stage."""
    g = launch_geometry(L.shape[2], L.element_size(), tile)
    return batch_lp._launch(L, c, mv, M, tile, g._replace(staged=False,
                                                          smem_bytes=0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_tile_and_chunk_invariance_in_bits(card, dtype):
    """Neither the tile, nor chunk, nor the regime moves a bit (a zero's
    sign included): tiles 32 and 96 make each warp walk several problems
    through its one staging region; the unstaged regime reads global
    memory.  Against the plain version the results are equal."""
    L, c, mv = _mixed_packed(card, dtype, tile=32)
    base = rgb_cuda(L, c, mv, M=M, tile=8, chunk=0)
    outs = [rgb_cuda(L, c, mv, M=M, tile=tile, chunk=chunk)
            for tile, chunk in ((1, 0), (32, 0), (96, 0), (8, 128), (32, 256))]
    outs += [_unstaged(L, c, mv, tile) for tile in (8, 32)]
    for x, f in outs:
        assert torch.equal(_bits(x), _bits(base[0]))
        assert torch.equal(f, base[1])
    xp, fp = rgb_plain(L, c, mv, M=M, tile=L.shape[0])
    assert torch.equal(base[1], fp) and torch.equal(base[0], xp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("staged", [True, False])
def test_kernel_at_the_staging_limit(card, dtype, staged):
    """The widest m_pad that is staged and the first that is not: equal to
    the plain version."""
    it = torch.empty((), dtype=dtype).element_size()
    m_pad = max_staged_m_pad(it) + (0 if staged else LANE)
    assert launch_geometry(m_pad, it, 8).staged == staged
    rng = np.random.default_rng([7, it, m_pad])
    B = 8
    theta = rng.uniform(0.0, 2.0 * np.pi, (B, m_pad))
    L = np.zeros((B, 4, m_pad))
    L[:, 0], L[:, 1] = np.cos(theta), np.sin(theta)
    L[:, 2] = (L[:, 0] * rng.uniform(-50, 50, (B, 1)) + L[:, 1]
               * rng.uniform(-50, 50, (B, 1)) + rng.uniform(0.1, 5.0,
                                                             (B, m_pad)))
    phi = rng.uniform(0.0, 2.0 * np.pi, B)
    c = np.stack([np.cos(phi), np.sin(phi)], -1)
    mv = np.array([m_pad, m_pad, m_pad - 1, m_pad - 33, 1, 0, 77, m_pad],
                  np.int32)[:, None]
    L = torch.tensor(L, dtype=dtype, device=card)
    c = torch.tensor(c, dtype=dtype, device=card)
    mv = torch.tensor(mv, device=card)
    x, f = rgb_cuda(L, c, mv, M=M, tile=8)
    xp, fp = rgb_plain(L, c, mv, M=M, tile=8)
    assert torch.equal(f, fp) and torch.equal(x, xp)
    assert bool(f.all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_ignores_nan_padding(card, dtype):
    """Columns past m_valid are never copied nor tested: NaN there gives
    the bits of the neutral padding, staged and unstaged."""
    L, c, mv = _mixed_packed(card, dtype, tile=32)
    past = torch.arange(L.shape[2], device=card)[None, :] >= mv
    Ln = L.clone()
    Ln[:, :3, :][past[:, None, :].expand(-1, 3, -1)] = float("nan")
    base = rgb_cuda(L, c, mv, M=M, tile=32)
    for x, f in (rgb_cuda(Ln, c, mv, M=M, tile=32),
                 rgb_cuda(Ln, c, mv, M=M, tile=8), _unstaged(Ln, c, mv, 32)):
        assert torch.equal(_bits(x), _bits(base[0]))
        assert torch.equal(f, base[1])
    xp, fp = rgb_plain(Ln, c, mv, M=M, tile=32)
    assert torch.equal(fp, base[1]) and torch.equal(xp, base[0])


def test_kernel_batch_of_pad_problems_only(card):
    """Problems with m_valid == 0 issue no copy and wait on no barrier:
    a batch of nothing else finishes, staged and unstaged, and every
    answer is the box corner of its objective."""
    B = 64
    for m_pad in (256, max_staged_m_pad(4) + LANE):
        L = torch.zeros((B, 4, m_pad), device=card)
        c = torch.tensor([[1.0, 0.0]] * B, device=card)
        mv = torch.zeros((B, 1), dtype=torch.int32, device=card)
        for tile in (8, 32):
            x, f = rgb_cuda(L, c, mv, M=M, tile=tile)
            torch.cuda.synchronize()
            assert bool((f == 1).all())
            assert torch.equal(x, torch.tensor([[M, M]] * B, device=card))


def test_kernel_pad_problems_and_clamped_m_valid(card):
    L, c, mv = _mixed_packed(card, torch.float32, batch=20, tile=8)
    x, f = rgb_cuda(L, c, mv, M=M, tile=8)
    assert bool((f[20:] == 1).all())
    assert torch.equal(x[20:], torch.tensor([[M, M]] * 4, device=card))
    big = torch.full_like(mv, 10_000)
    full = torch.full_like(mv, L.shape[2])
    xa, fa = rgb_cuda(L, c, big, M=M, tile=8)
    xb, fb = rgb_cuda(L, c, full, M=M, tile=8)
    assert torch.equal(xa, xb) and torch.equal(fa, fb)


def test_wrapper_raises_on_what_the_kernel_does_not_take(card):
    L, c, mv = _mixed_packed(card, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        rgb_cuda(L.transpose(1, 2).contiguous().transpose(1, 2), c, mv, M=M,
                 tile=8)
    with pytest.raises(ValueError, match="share a device"):
        rgb_cuda(L, c.cpu(), mv, M=M, tile=8)
    with pytest.raises(ValueError, match="not a multiple of tile"):
        rgb_cuda(L, c, mv, M=M, tile=7)
    skew = torch.empty(L.numel() + 1, dtype=L.dtype, device=card)[1:]
    skew = skew.view(L.shape).copy_(L)
    with pytest.raises(ValueError, match="aligned"):
        rgb_cuda(skew, c, mv, M=M, tile=8)


def test_refused_launch_is_reported(card):
    """A block of 64 warps (2048 threads) is more than the kernel takes: the
    C entry point returns the error code instead of running nothing
    silently, and the library names it."""
    fn = batch_lp._launcher("rgb", torch.float32)
    L, c, mv = _mixed_packed(card, torch.float32, batch=8, m=16)
    x = torch.empty((8, 2), device=card)
    f = torch.empty((8, 1), dtype=torch.int32, device=card)
    stream = torch.cuda.current_stream().cuda_stream
    code = fn(L.data_ptr(), c.data_ptr(), mv.data_ptr(), x.data_ptr(),
              f.data_ptr(), 8, L.shape[2], 8, M, 64, 1, 1 << 20, stream)
    assert code != 0
    assert batch_lp._bound["error_string"](code)
    # nor a staged launch given less shared memory than its regions need
    g = launch_geometry(L.shape[2], 4, 8)
    code = fn(L.data_ptr(), c.data_ptr(), mv.data_ptr(), x.data_ptr(),
              f.data_ptr(), 8, L.shape[2], 8, M, g.warps, 1,
              g.smem_bytes - 8, stream)
    assert code != 0
    # through the wrapper's enqueue it raises, naming the launch
    with pytest.raises(RuntimeError, match="rgb_cuda: launch refused .* "
                       "for B=8"):
        batch_lp._launch(L, c, mv, M, 8, g._replace(warps=64))
    # the card is still usable afterwards
    x2, f2 = rgb_cuda(L, c, mv, M=M, tile=8)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(x2).all())


# -- the solver front end's two passes: prep and finish ----------------------

def _front_batch(device, dtype, B=37, m=201):
    """An AoS batch for every branch of ``prep``: ragged ``m_valid`` (0
    included), zero-norm rows, rows whose norm lies at and around eps
    (1e-30: in float32 their squares underflow), normals and offsets from
    1e-20 to 1e20 (squares that overflow in float32)."""
    g = torch.Generator().manual_seed(m)
    u = lambda *shape: torch.empty(shape, dtype=torch.float64).uniform_(
        -20, 20, generator=g)
    A = torch.randn((B, m, 2), generator=g, dtype=torch.float64) \
        * 10.0 ** u(B, m, 1)
    b = torch.randn((B, m), generator=g, dtype=torch.float64) * 10.0 ** u(B, m)
    A[:, ::7] = 0.0
    theta = torch.rand((B, m), generator=g, dtype=torch.float64) * 2 * np.pi
    near = 1e-30 * (1.0 + torch.randint(-2, 3, (B, m), generator=g)
                     .double() * 1e-15)
    ring = torch.stack([torch.cos(theta), torch.sin(theta)], -1) \
        * near[..., None]
    A[:, 3::11] = ring[:, 3::11]
    A[:, 5::11, 0], A[:, 5::11, 1] = 1e-30, 0.0
    mv = torch.randint(0, m + 1, (B,), generator=g, dtype=torch.int32)
    mv[:3] = torch.tensor([0, m, 1], dtype=torch.int32)
    c = torch.randn((B, 2), generator=g, dtype=torch.float64)
    return make_batch(A.to(dtype), b.to(dtype), c.to(dtype), mv, device=device)


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data starts 4 bytes off 16."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


def _eager_prep(lp, packed: bool, m_pad: int, b_pad: int, normalize: bool):
    """The solver's eager front end for each layout: normalise, pack, pad."""
    if packed:
        pb = normalize_packed(lp) if normalize else lp
    else:
        pb = pack(normalize_batch(lp) if normalize else lp)
    pb = pad_packed_batch_dim(pad_packed(pb, m_pad), b_pad)
    return pb.L, pb.c, pb.m_valid.to(torch.int32)


@pytest.mark.parametrize("m", [200, 201, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("layout", ["aos", "packed"])
def test_prep_equals_the_eager_chain_in_bits(card, layout, dtype, m):
    """``prep_cuda``'s L, c and m_valid against the eager chain, bit for
    bit: the 16-byte path (m 200, 256; packed with 4 neutral columns more),
    the column path (m 201, and any input not 16-byte aligned), B = 37
    padded to the tile, normalised or not; for AoS also against
    pack-then-normalize_packed."""
    lp = _front_batch(card, dtype, m=m)
    src = lp.pack(m + 4) if layout == "packed" else lp
    m_pad, b_pad = -(-(m + 4) // LANE) * LANE, 40
    args = ((src.L, None) if layout == "packed" else (src.A, src.b))
    for normalize in (True, False):
        want = _eager_prep(src, layout == "packed", m_pad, b_pad, normalize)
        for a in (args, tuple(None if t is None else _misaligned(t)
                              for t in args)):
            n0 = batch_lp.prep_cuda.launches
            got = batch_lp.prep_cuda(*a, src.c, src.m_valid, m_pad=m_pad,
                                     b_pad=b_pad, normalize=normalize)
            assert batch_lp.prep_cuda.launches == n0 + 1
            for g, w in zip(got, want):
                assert g.shape == w.shape and g.dtype == w.dtype
                assert torch.equal(_bits(g), _bits(w))
    if layout == "aos":
        pb = pad_packed_batch_dim(pad_packed(normalize_packed(pack(lp)),
                                             m_pad), b_pad)
        got = batch_lp.prep_cuda(lp.A, lp.b, lp.c, lp.m_valid, m_pad=m_pad,
                                 b_pad=b_pad)
        assert torch.equal(_bits(got[0]), _bits(pb.L))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_solve_equals_the_eager_front_end_in_bits(card, dtype,
                                                        monkeypatch):
    """A whole solve with prep and finish against the same solve through
    the eager chain: x, feasible and objective equal bit for bit, AoS and
    packed alike; one prep, one rgb and one finish launch a call; an AoS
    call counts one pack, a packed one none."""
    from repro_torch.solver import solver as solver_mod
    g = torch.Generator().manual_seed(9)
    lp = concat_batches([
        random_feasible_lp(g, 24, 150, dtype=dtype, device=card),
        ragged_feasible_lp(g, 24, 150, dtype=dtype, device=card),
        infeasible_lp(9, 150, dtype=dtype, device=card),
        adversarial_lp(8, 150, dtype=dtype, device=card)])
    extreme = _front_batch(card, dtype, B=21, m=150)
    spec = SolverSpec(backend="kernel", dtype=str(dtype)[6:])
    counts = lambda: (batch_lp.prep_cuda.launches, rgb_cuda.launches,
                      batch_lp.finish_cuda.launches, pack_call_count())
    for batch in (lp, extreme):
        packed = batch.pack()
        n0 = counts()
        aos = solve_with_spec(spec, batch)
        assert counts() == tuple(v + 1 for v in n0)
        soa = solve_with_spec(spec, packed)
        assert counts() == (n0[0] + 2, n0[1] + 2, n0[2] + 2, n0[3] + 1)
        with monkeypatch.context() as mp:
            mp.setattr(solver_mod, "_takes_fused", lambda *a: False)
            eager = solve_with_spec(spec, batch)
        assert counts()[0] == n0[0] + 2 and counts()[2] == n0[2] + 2
        for sol in (aos, soa):
            assert sol.feasible.dtype == torch.bool
            assert sol.x.shape == eager.x.shape
            assert torch.equal(_bits(sol.x), _bits(eager.x))
            assert torch.equal(sol.feasible, eager.feasible)
            assert torch.equal(_bits(sol.objective), _bits(eager.objective))


def _front_counts():
    return (batch_lp.prep_cuda.launches, rgb_cuda.launches,
            batch_lp.finish_cuda.launches)


@pytest.mark.parametrize("m", [3, 256, 2048])
@pytest.mark.parametrize("B", [1, 7, 16384])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("layout", ["aos", "packed"])
def test_planned_solve_equals_the_op_path_and_the_eager_chain(
        card, layout, dtype, B, m, monkeypatch):
    """A solve from its launch plan, on the call that makes the plan (a
    miss) and on a repeat (a hit), against the same solve through the
    operator (``_solve_fused``, as under a mode) and through the eager
    chain: x, feasible and objective equal bit for bit.  Each planned call
    counts one prep, one rgb (and its geometry) and one finish launch;
    the repeat counts a plan hit; ``Solver.solve`` takes the same plan."""
    from repro_torch.solver import solver as S
    g = torch.Generator().manual_seed(B * 4099 + m)
    lp = random_feasible_lp(g, B, m, dtype=dtype, device=card)
    batch = lp.pack() if layout == "packed" else lp
    spec = SolverSpec(backend="kernel", dtype=str(dtype)[6:])
    shape = S.plan_shape(spec, B, batch.m_pad if layout == "packed" else m)
    gkey = (shape.b_pad, shape.m_pad, str(dtype)[6:], shape.tile)
    sols = []
    for hit in (False, True):
        n0, g0 = _front_counts(), rgb_cuda.geometries.get(gkey, 0)
        h0, m0 = S.solve_with_spec.plan_hits, S.solve_with_spec.plan_misses
        sols.append(solve_with_spec(spec, batch))
        assert _front_counts() == tuple(v + 1 for v in n0)
        assert rgb_cuda.geometries[gkey] == g0 + 1
        assert (S.solve_with_spec.plan_hits,
                S.solve_with_spec.plan_misses) == (h0 + hit, m0 + 1 - hit)
    h0 = S.solve_with_spec.plan_hits
    solver = spec.build()
    sols += [solver.solve(batch), solver.solve(batch)]
    assert S.solve_with_spec.plan_hits >= h0 + 1
    with monkeypatch.context() as mp:
        mp.setattr(S, "unwatched", lambda tensors: False)
        h0, n0 = S.solve_with_spec.plan_hits, _front_counts()
        op = solve_with_spec(spec, batch)
        assert S.solve_with_spec.plan_hits == h0
        assert _front_counts() == tuple(v + 1 for v in n0)
    with monkeypatch.context() as mp:
        mp.setattr(S, "_takes_fused", lambda *a: False)
        n0 = _front_counts()
        eager = solve_with_spec(spec, batch)
        assert _front_counts()[0::2] == n0[0::2]     # no prep, no finish
    for sol in sols + [op]:
        assert sol.x.shape == eager.x.shape == (B, 2)
        assert torch.equal(_bits(sol.x), _bits(eager.x))
        assert torch.equal(sol.feasible, eager.feasible)
        assert torch.equal(_bits(sol.objective), _bits(eager.objective))


def test_a_flop_counter_still_counts_the_operator_once(card):
    """Under ``FlopCounterMode`` a solve on the card dispatches
    ``repro_torch::rgb`` (the planned path steps aside for modes): the
    counter sees one call's FLOPs, and the kernel launches once."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.solver import solver as S
    g = torch.Generator().manual_seed(4)
    lp = random_feasible_lp(g, 64, 100, device=card)
    spec = SolverSpec(backend="kernel")
    solve_with_spec(spec, lp)                   # a plan for this key
    h0, n0 = S.solve_with_spec.plan_hits, rgb_cuda.launches
    with FlopCounterMode(display=False) as fc:
        solve_with_spec(spec, lp)
    torch.cuda.synchronize()
    counts = fc.get_flop_counts()["Global"]
    assert [str(k) for k in counts] == ["repro_torch.rgb"]
    assert fc.get_total_flops() == int(batch_lp.rgb_flops(64, LANE))
    assert rgb_cuda.launches == n0 + 1
    assert S.solve_with_spec.plan_hits == h0


def test_finish_writes_the_eager_objective_in_bits(card):
    """``finish_cuda`` against ``(c * x).sum(-1)`` and ``feas != 0`` on
    values that round apart, signed zeros included."""
    g = torch.Generator().manual_seed(3)
    for dt in (torch.float32, torch.float64):
        x = (torch.randn((1003, 2), generator=g, dtype=torch.float64)
             * 10.0 ** torch.randint(-30, 30, (1003, 2), generator=g))
        x[:8] = torch.tensor([[0.0, -0.0], [-0.0, -0.0]] * 4)
        c = torch.randn((1003, 2), generator=g, dtype=torch.float64)
        c[:4] = -c[:4].abs()
        x, c = x.to(dt).to(card), c.to(dt).to(card)
        feas = torch.randint(-2, 3, (1003, 1), generator=g,
                             dtype=torch.int32).to(card)
        obj, ok = batch_lp.finish_cuda(x, feas, c, 1000)
        assert torch.equal(_bits(obj), _bits((c[:1000] * x[:1000]).sum(-1)))
        assert torch.equal(ok, feas[:1000, 0].to(torch.bool))


def test_solver_on_the_card_goes_through_the_kernel(card):
    g = torch.Generator().manual_seed(1)
    lp = random_feasible_lp(g, 512, 100)            # default device: the card
    assert lp.device == card
    solver = SolverSpec(backend="auto").build()
    assert solver.spec.backend == "kernel" and solver.spec.interpret is False
    n0 = rgb_cuda.launches
    aos, soa = solver.solve(lp), solver.solve(lp.pack())
    assert rgb_cuda.launches == n0 + 2
    assert torch.equal(aos.x, soa.x) and torch.equal(aos.feasible,
                                                     soa.feasible)
    plain = SolverSpec(backend="kernel", interpret=True,
                       tile=512).build().solve(lp)
    assert rgb_cuda.launches == n0 + 2              # interpret: no launch
    assert torch.equal(plain.feasible, aos.feasible)
    assert float((plain.x - aos.x).abs().max()) <= 1e-4
    cpu = SolverSpec(backend="rgb").build(device="cpu").solve(lp.to("cpu"))
    assert torch.equal(cpu.feasible, aos.feasible.cpu())
    np.testing.assert_allclose(aos.x.cpu().numpy(), cpu.x.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_flush_buffers_are_pinned_so_the_copy_in_is_asynchronous(card):
    """The pool hands out numpy views of page-locked tensors; a tensor made
    back from such a view (or from a row slice of it, as the per-device
    dispatch does) must still count as pinned, or ``non_blocking=True``
    silently degrades to a staged, synchronous copy."""
    from repro_torch.serve_lp.scheduler import _FlushBufferPool
    pool = _FlushBufferPool(pinned=True)
    key, bufs = pool.lease(64, 128, np.float32)
    for a in bufs:
        assert torch.from_numpy(a).is_pinned()
        assert torch.from_numpy(a[8:24]).is_pinned()
    pool.release(key, bufs)
    assert not torch.from_numpy(
        _FlushBufferPool().lease(64, 128, np.float32)[1][0]).is_pinned()


def test_scheduler_on_the_card_is_bit_identical_to_direct(card):
    rng = np.random.default_rng(3)
    reqs = []
    for m in (3, 8, 37, 130, 200, 700) * 8:
        theta = rng.uniform(0, 2 * np.pi, m)
        A = np.stack([np.cos(theta), np.sin(theta)], -1).astype(np.float32)
        b = (A @ rng.uniform(-10, 10, 2) + rng.uniform(0.1, 3.0, m)).astype(
            np.float32)
        reqs.append((A, b, np.array([1.0, 0.5], np.float32)))
    spec = SolverSpec(backend="kernel")
    n0, p0 = rgb_cuda.launches, pack_call_count()
    q0 = batch_lp.prep_cuda.launches
    with BatchScheduler(spec, max_batch=16, max_wait_s=0.002) as sched:
        assert sched.buffers.pinned and sched.n_devices >= 1
        futs = [sched.submit(*r) for r in reqs]
        results = [f.result(timeout=120) for f in futs]
        sched.drain()
        snap = sched.metrics.snapshot()
    assert rgb_cuda.launches - n0 == snap["launches_total"] > 0
    assert batch_lp.prep_cuda.launches - q0 == snap["launches_total"]
    assert pack_call_count() == p0 and snap["errors"] == {}
    solver = spec.build()
    for (A, b, c), r in zip(reqs, results):
        d = solver.solve_one(A, b, c)
        assert r.feasible and bool(d.feasible)
        np.testing.assert_array_equal(d.x.cpu().numpy(), r.x)


def test_pdhg_on_the_card_matches_the_cpu(card):
    """The first-order backend's ops on the card against the same ops on
    the CPU (float64, a fixed budget of 512 iterations with ``tol=0``):
    the same iteration and restart counts, ``x`` within 1e-9.  Only the
    reduction order differs between the two devices."""
    from repro_torch.pdhg.solve import _solve_rows
    g = torch.Generator().manual_seed(11)
    lp = concat_batches([
        random_feasible_lp(g, 24, 64, dtype=torch.float64, device="cpu"),
        ragged_feasible_lp(g, 24, 64, dtype=torch.float64, device="cpu"),
        infeasible_lp(8, 64, dtype=torch.float64, device="cpu")])
    pb = normalize_packed(lp.pack())
    kw = dict(M=M, tol=0.0, max_iters=512, iter_block=64,
              restart_period=256)
    sols = {}
    for dev in ("cpu", card):
        p = pb.to(dev)
        sols[str(dev)] = _solve_rows(p.ax, p.ay, p.b, p.c, p.m_valid, **kw)
    (cs, cst), (gs, gst) = sols["cpu"], sols[str(card)]
    assert gs.x.device == card and gst.iterations.device == card
    assert torch.equal(gst.iterations.cpu(), cst.iterations)
    assert torch.equal(gst.restarts.cpu(), cst.restarts)
    assert torch.equal(gs.feasible.cpu(), cs.feasible)
    assert float((gs.x.cpu() - cs.x).abs().max()) <= 1e-9


def test_measure_stats_fences_the_device(card):
    """``measure_stats`` times the device's work, not the enqueue: its
    median of a call that queues ~50 ms of matrix products is at least
    the device time CUDA events measure for the same call."""
    from repro_torch.tune import measure_stats
    a = torch.randn(4096, 4096, device=card)

    def work(t):
        for _ in range(16):
            t = t @ a
        return t

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    work(a)
    torch.cuda.synchronize()
    start.record()
    work(a)
    stop.record()
    torch.cuda.synchronize()
    device_s = start.elapsed_time(stop) / 1e3
    med, iqr, k = measure_stats(work, a, warmup=1, iters=3)
    assert k == 3 and device_s > 1e-3
    assert med >= 0.9 * device_s, (med, device_s)


def test_rpc_roundtrip_on_the_card_launches_the_kernel(card):
    """One ``RpcServer`` round trip on the card: the flush launches
    ``rgb_cuda`` and the answer equals a direct solve in bits."""
    import http.client
    import json
    from repro_torch.serve_lp.rpc import make_frontend, run_in_thread
    spec = SolverSpec(backend="kernel")
    f = make_frontend(spec, max_batch=4, max_wait_s=0.003)
    assert f.scheduler.n_devices >= 1
    rng = np.random.default_rng(8)
    theta = rng.uniform(0, 2 * np.pi, 40)
    A = np.stack([np.cos(theta), np.sin(theta)], -1).astype(np.float32)
    b = (A @ np.array([3.0, -2.0]) + rng.uniform(0.1, 3.0, 40)).astype(
        np.float32)
    c = np.array([0.6, 0.8], np.float32)
    n0 = rgb_cuda.launches
    port, stop = run_in_thread(f)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("POST", "/v1/solve", json.dumps(
            {"A": A.tolist(), "b": b.tolist(), "c": c.tolist()}))
        resp = conn.getresponse()
        assert resp.status == 200
        got = json.loads(resp.read())["result"]
        conn.close()
    finally:
        stop()
    assert rgb_cuda.launches > n0
    d = spec.build().solve_one(A, b, c)
    assert got["feasible"] and bool(d.feasible)
    np.testing.assert_array_equal(np.asarray(got["x"], np.float32),
                                  d.x.cpu().numpy())


def test_full_width_qwen2_step_with_lp_clip_launches_the_kernel_once(card):
    """One full-width Qwen2-0.5B step (bf16, a short batch) with the LP
    trust-region clip: one ``rgb_cuda`` launch, a finite loss, ``lp_s1``
    in [0, 1], and the weights moved."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamW
    cfg = ARCHS["qwen2-0.5b"]
    opt = AdamW()
    prog = make_train_step(cfg, make_host_mesh(1, 1), opt, global_batch=2,
                           lp_clip=True)
    params = prog.model.init(torch.Generator(device=card).manual_seed(0))
    state = opt.init(params)
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (2, 128)),
                                device=card) for k in ("tokens", "labels")}
    before = params["blocks"]["w_up"][0, 0, :8].clone()
    n0 = rgb_cuda.launches
    params, state, m, _ = prog.step(params, state, batch, {})
    torch.cuda.synchronize()
    assert rgb_cuda.launches == n0 + 1
    assert np.isfinite(float(m["loss"])) and 0.0 <= float(m["lp_s1"]) <= 1.0
    assert int(state.step) == 1
    assert not torch.equal(before, params["blocks"]["w_up"][0, 0, :8])


def test_train_steps_on_the_card_match_the_cpu(card):
    """The smoke config in float32, three LP-clipped steps on the card and
    on the CPU from the same weights, TF32 off: the tolerance of
    tests/test_torch_train.py's three-step parity test."""
    import dataclasses
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.data.pipeline import TokenSource, for_model
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import params_from_numpy, params_to_numpy
    from repro_torch.optim import AdamW
    from repro_torch.tree import flatten_with_paths
    cfg = dataclasses.replace(smoke_config(ARCHS["qwen2-0.5b"]),
                              dtype="float32")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    runs, init = {}, None
    try:
        for dev in (torch.device("cpu"), card):
            opt = AdamW()
            prog = make_train_step(cfg, make_host_mesh(1, 1, device=dev),
                                   opt, global_batch=2, lp_clip=True)
            if init is None:
                init = params_to_numpy(prog.model.init(
                    torch.Generator().manual_seed(1)))
            params = params_from_numpy(prog.model, init)
            state = opt.init(params)
            src = TokenSource(for_model(cfg, 32, 2, seed=1))
            metrics = []
            for s in range(3):
                batch = {k: torch.as_tensor(v, device=dev)
                         for k, v in src.global_batch(s).items()}
                params, state, m, _ = prog.step(params, state, batch, {})
                metrics.append((float(m["loss"]), float(m["lp_s1"])))
            runs[dev.type] = (metrics, flatten_with_paths(
                params_to_numpy(params)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (mc, pc), (mg, pg) = runs["cpu"], runs["cuda"]
    for (lc, sc), (lg, sg) in zip(mc, mg):
        np.testing.assert_allclose(lg, lc, rtol=1e-4)
        np.testing.assert_allclose(sg, sc, rtol=1e-4, atol=1e-4)
    for k in pc:
        np.testing.assert_allclose(pg[k], pc[k], rtol=0, atol=2e-6,
                                   err_msg=k)


def test_bf16_checkpoint_round_trip_on_the_card(card, tmp_path):
    """bfloat16 weights and the fp32 AdamW state saved from the card come
    back onto the card with the same bits and dtypes."""
    from repro_torch.ckpt.checkpoint import Checkpointer
    from repro_torch.optim import AdamW
    g = torch.Generator(device=card).manual_seed(0)
    params = {"w": torch.randn((64, 32), generator=g, device=card
                               ).to(torch.bfloat16),
              "blocks": {"b": torch.randn((7,), generator=g, device=card)}}
    opt = AdamW()
    state = opt.init(params)
    _, state = opt.update(params, state, params)
    ck = Checkpointer(tmp_path)
    ck.save(1, (params, state), extra={"next_step": 1})
    ck.wait()
    (p, st), extra = ck.load((params, state))
    assert extra == {"next_step": 1}
    for a, b in ((p["w"], params["w"]), (p["blocks"]["b"],
                                         params["blocks"]["b"]),
                 (st.m["w"], state.m["w"]), (st.v["w"], state.v["w"]),
                 (st.step, state.step)):
        assert b.device.type == "cuda" and a.device == b.device
        assert a.dtype == b.dtype and torch.equal(a, b)


def _no_tf32():
    """TF32 off for float32 card-vs-CPU checks; returns the old setting."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    return old


def test_moe_layer_on_the_card_matches_the_cpu(card):
    """The sort-based MoE in float32 on the card and on the CPU, at the
    three capacity factors the model uses: equal routing, outputs within
    1e-5."""
    from repro_torch.models import MeshInfo, ModelConfig
    from repro_torch.models import layers as L
    cfg = ModelConfig(name="t", family="moe", n_layers=1, d_model=64,
                      n_heads=2, n_kv=2, d_ff=96, vocab=64, n_experts=16,
                      top_k=4)
    rng = np.random.default_rng(0)
    p = {"w_router": rng.standard_normal((64, 16)) * 0.1,
         "w_gate": rng.standard_normal((16, 64, 96)) * 0.1,
         "w_up": rng.standard_normal((16, 64, 96)) * 0.1,
         "w_down": rng.standard_normal((16, 96, 64)) * 0.1}
    x = rng.standard_normal((4, 32, 64))
    old = _no_tf32()
    try:
        for cf in (1.25, 8.0, 16.0):
            out = {}
            for dev in (torch.device("cpu"), card):
                pt = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                      for k, v in p.items()}
                xt = torch.as_tensor(x, dtype=torch.float32, device=dev)
                y, aux = L.moe_layer(pt, xt, MeshInfo(), cfg,
                                     capacity_factor=cf)
                out[dev.type] = (y.cpu(), float(aux))
            np.testing.assert_allclose(out["cuda"][0], out["cpu"][0],
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(out["cuda"][1], out["cpu"][1],
                                       rtol=1e-6)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "olmoe-1b-7b",
                                  "paligemma-3b", "whisper-base",
                                  "mamba2-1.3b", "zamba2-2.7b"])
def test_decode_step_on_the_card_matches_the_cpu(card, arch):
    """The smoke config in float32: prefill and one decode step on the
    card and on the CPU from the same weights, TF32 off; logits within
    1e-5 of the largest |logit|, the cache written in place on both and
    every cache leaf within 1e-5."""
    import dataclasses
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.launch.serve import pad_cache, prefill_length
    from repro_torch.models import (MeshInfo, build_model,
                                    params_from_numpy, params_to_numpy)
    from repro_torch.tree import flatten_with_paths
    cfg = dataclasses.replace(smoke_config(ARCHS[arch]), dtype="float32")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    extra = {}
    if cfg.family == "vlm":
        extra["patches"] = rng.standard_normal((2, cfg.n_prefix,
                                                cfg.d_model))
    if cfg.family == "encdec":
        extra["frames"] = rng.standard_normal((2, cfg.enc_seq, cfg.d_model))
    old = _no_tf32()
    init, out = None, {}
    try:
        for dev in (torch.device("cpu"), card):
            model = build_model(cfg, MeshInfo(), device=dev)
            if init is None:
                init = params_to_numpy(model.init(
                    torch.Generator().manual_seed(0)))
            params = params_from_numpy(model, init)
            batch = {"tokens": torch.as_tensor(toks[:, :8], device=dev)}
            batch.update({k: torch.as_tensor(v, dtype=torch.float32,
                                             device=dev)
                          for k, v in extra.items()})
            logits, cache = model.prefill(params, batch)
            cur = prefill_length(cache, 8)
            cache = pad_cache(cache, 2)
            before = flatten_with_paths(cache)
            dec, cache = model.decode(
                params, {"token": torch.as_tensor(toks[:, 8:], device=dev),
                         "pos": torch.full((2,), cur, dtype=torch.int32,
                                           device=dev)}, cache)
            after = flatten_with_paths(cache)
            assert all(after[k] is t for k, t in before.items())
            out[dev.type] = (logits.cpu().numpy(), dec.cpu().numpy(),
                             {k: t.cpu().float().numpy()
                              for k, t in after.items()})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    v = cfg.vocab
    for i in (0, 1):
        c, g = out["cpu"][i][:, :v], out["cuda"][i][:, :v]
        assert np.abs(g - c).max() <= 1e-5 * np.abs(c).max()
        np.testing.assert_array_equal(out["cpu"][i][:, v:],
                                      out["cuda"][i][:, v:])
    for k, c in out["cpu"][2].items():
        np.testing.assert_allclose(out["cuda"][2][k], c, rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_ssd_chunked_on_the_card_matches_the_cpu(card):
    """The chunked SSD scan in float32 at mamba2-1.3b's head shape (64
    heads of 64, state 128, two chunks of 256), TF32 off: ``y`` and the
    final state within 5e-5 of their largest entry (measured on an H100:
    ``y`` 1.05e-5; its sums of 256 x 128 products run in another order on
    the card, and cancel)."""
    from repro_torch.models import layers as L
    rng = np.random.default_rng(2)
    B, S, H, P, N = 2, 512, 64, 64, 128
    xs = rng.standard_normal((B, S, H, P)) * 0.5
    dt = np.logaddexp(rng.standard_normal((B, S, H)) - 2.0, 0)
    A = -np.linspace(1.0, 16.0, H)
    Bc = rng.standard_normal((B, S, N)) * 0.1
    Cc = rng.standard_normal((B, S, N)) * 0.1
    old = _no_tf32()
    out = {}
    try:
        for dev in (torch.device("cpu"), card):
            y, st = L.ssd_chunked(*(torch.as_tensor(a, dtype=torch.float32,
                                                    device=dev)
                                    for a in (xs, dt, A, Bc, Cc)), 256)
            out[dev.type] = (y.cpu().numpy(), st.cpu().numpy())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    errs = [float(np.abs(g - c).max() / np.abs(c).max())
            for c, g in zip(out["cpu"], out["cuda"])]
    assert all(np.isfinite(g).all() for g in out["cuda"])
    assert max(errs) <= 5e-5, errs


def test_serve_main_on_the_card_whisper_smoke(card, capsys):
    """The serving entry point on the card: the encoder-decoder's smoke
    config, a prompt as long as the encoder (the case in which the
    reference would also grow ``xk``/``xv``)."""
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.launch.serve import main
    cfg = smoke_config(ARCHS["whisper-base"])
    run = main(["--arch", "whisper-base", "--smoke", "--requests", "4",
                "--batch", "2", "--prompt-len", str(cfg.enc_seq),
                "--gen", "5"])
    out = capsys.readouterr().out
    assert "[serve] 20 tokens in " in out
    assert [t.shape for t in run.tokens] == [(2, 5), (2, 5)]
    assert all(((t >= 0) & (t < cfg.vocab)).all() for t in run.tokens)
    assert len(run.prefill_ms) == 2 and all(ms > 0 for ms in run.prefill_ms)
    assert [len(d) for d in run.decode_ms] == [4, 4]


def test_bench_smoke_with_the_kernel_on_the_card(card):
    """The serving benchmark's smoke traffic with ``--method kernel``:
    its flushes launch the CUDA kernel, the fusing assertion holds, and
    its direct-solve check passes (``--check 8``).  (``--assert-overlap``
    is not reachable on one card: each flush is done long before the host
    has assembled the next.)"""
    from repro_torch.serve_lp import bench
    n0 = rgb_cuda.launches
    snap, sched = bench.main(["--smoke", "--method", "kernel",
                              "--open-loop", "--assert-fused"],
                             devices=[card], quiet=True)
    assert snap["n_solved"] == 160 and snap["errors"] == {}
    assert snap["inflight_max"] >= 1 and snap["inflight_now"] == 0
    assert rgb_cuda.launches > n0
    assert sched.spec.backend == "kernel" and sched.spec.interpret is False


def test_crowd_sim_direct_and_served_on_the_card(card):
    """The crowd simulation's two paths on the card print the same step
    lines and reach the same positions (1e-5), one kernel launch a direct
    step."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "..", "examples"))
    import crowd_sim_torch as crowd
    n0 = rgb_cuda.launches
    direct = crowd.main(["--agents", "512", "--steps", "10", "--direct"],
                        device=card)
    assert rgb_cuda.launches == n0 + 10
    served = crowd.main(["--agents", "512", "--steps", "10"], device=card)
    assert served["lines"] == direct["lines"]
    assert float((served["pos"] - direct["pos"]).abs().max()) <= 1e-5


# -- held on the card rather than on the CPU: each takes ~6 s an infeasible
# -- example (pdhg runs to its iteration budget) where there is no card -----

def test_backends_agree_property_with_the_pdhg_tail(card):
    """``test_torch_solver.py``'s cross-backend sweep on the card, with the
    pdhg tail it leaves out: naive, rgb (dense and chunked) and the kernel,
    each shuffling with the spec's seed, agree on feasibility and on the
    objective to 5e-4; pdhg at ``tol=1e-5`` agrees with them on
    feasibility and on the objective to 2e-3 (the reference's tolerance for
    the tail, ``tests/test_solver.py``)."""
    from _hypothesis_compat import given, settings, st

    @settings(max_examples=10, deadline=None)
    @given(kind=st.sampled_from(("random", "ragged", "infeasible")),
           seed=st.integers(0, 2**30), batch=st.integers(1, 12),
           m=st.integers(3, 40))
    def prop(kind, seed, batch, m):
        g = torch.Generator().manual_seed(seed)
        if kind == "random":
            lp = random_feasible_lp(g, batch, m, device="cpu")
        elif kind == "ragged":
            lp = ragged_feasible_lp(g, batch, max(m, 5), m_min=2,
                                    device="cpu")
        else:
            lp = infeasible_lp(batch, m, device="cpu")
        sweep = (
            SolverSpec(backend="naive", shuffle=True, seed=seed),
            SolverSpec(backend="rgb", shuffle=True, seed=seed),
            SolverSpec(backend="rgb", tile=8, chunk=64, shuffle=True,
                       seed=seed),
            SolverSpec(backend="kernel", shuffle=True, seed=seed),
            SolverSpec(backend="kernel", chunk=128, dtype="float64"),
            SolverSpec(backend="pdhg", tol=1e-5),
        )
        n0 = rgb_cuda.launches
        sols = [s.build(device=card).solve(lp) for s in sweep]
        assert rgb_cuda.launches == n0 + 2
        ref = sols[0]
        feas = ref.feasible.cpu().numpy()
        assert bool(feas.any()) == (kind != "infeasible")
        for spec, sol in zip(sweep[1:], sols[1:]):
            assert sol.x.device == card
            np.testing.assert_array_equal(sol.feasible.cpu().numpy(), feas,
                                          err_msg=str(spec))
            tol = 2e-3 if spec.backend == "pdhg" else 5e-4
            np.testing.assert_allclose(
                sol.objective.cpu().numpy()[feas],
                ref.objective.cpu().numpy()[feas], rtol=tol, atol=tol,
                err_msg=str(spec))
    prop()


def test_float64_pdhg_on_the_card_matches_scipy(card):
    """The port's twin of ``test_float64_validation.py``'s pdhg snippet, on
    the card: float64 pdhg against HiGHS on adversarial, ragged and
    infeasible batches (feasibility equal, objective within 1e-6 (1 +
    |obj|)), and at m=2048 the certificate itself under 1e-6 (converged,
    primal residual, KKT residual)."""
    linprog = pytest.importorskip("scipy.optimize").linprog
    from repro_torch.core import pack
    from repro_torch.pdhg import solve_pdhg_with_stats
    f64 = torch.float64
    g = torch.Generator(device=card)
    batches = {
        "adversarial": adversarial_lp(4, 24, dtype=f64, device=card),
        "ragged": ragged_feasible_lp(g.manual_seed(5), 6, 18, m_min=3,
                                     dtype=f64, device=card),
        "infeasible": infeasible_lp(3, 8, dtype=f64, device=card),
        "big-m": random_feasible_lp(g.manual_seed(11), 4, 2048, dtype=f64,
                                    device=card),
    }
    solver = SolverSpec(backend="pdhg", dtype="float64").build(card)
    for name, lp in batches.items():
        A, b = lp.A.cpu().numpy(), lp.b.cpu().numpy()
        c, mv = lp.c.cpu().numpy(), lp.m_valid.cpu().numpy()
        ref_feas, ref_obj = [], []
        for i in range(A.shape[0]):
            res = linprog(-c[i], A_ub=A[i, :mv[i]], b_ub=b[i, :mv[i]],
                          bounds=[(-M, M), (-M, M)], method="highs")
            ref_feas.append(res.status == 0)
            ref_obj.append(-res.fun if res.status == 0 else np.nan)
        sol = solver.solve(lp)
        assert sol.x.dtype == f64 and sol.x.device == card, name
        assert sol.feasible.cpu().tolist() == ref_feas, name
        obj = sol.objective.cpu().numpy()
        for i, ok in enumerate(ref_feas):
            if ok:
                assert abs(obj[i] - ref_obj[i]) <= 1e-6 * (
                    1.0 + abs(ref_obj[i])), (name, i, obj[i], ref_obj[i])
    _, st = solve_pdhg_with_stats(pack(batches["big-m"]))
    assert bool(st.converged.all()), st.kkt
    assert float(st.primal_res.max()) <= 1e-6
    assert float(st.kkt.max()) <= 1e-6
