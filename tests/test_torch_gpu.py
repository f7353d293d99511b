"""Checks that need an NVIDIA card: the hand-written CUDA kernel held against
its plain PyTorch version on the same tensors, and the main paths on the card
(solver, scheduler, pdhg, the tuner's fence, one RPC round trip, a full-width
LP-clipped training step, train steps card against CPU, a bf16 checkpoint
round trip).

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

from repro_torch.core import (adversarial_lp, concat_batches, infeasible_lp,
                              normalize_packed, pack_call_count, pad_packed,
                              pad_packed_batch_dim, ragged_feasible_lp,
                              random_feasible_lp)
from repro_torch.kernels import batch_lp
from repro_torch.kernels.batch_lp import (LANE, launch_geometry,
                                          max_staged_m_pad, rgb_cuda,
                                          rgb_plain)
from repro_torch.serve_lp import BatchScheduler
from repro_torch.solver import SolverSpec

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
    fn = batch_lp._launcher(torch.float32)
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
    # the card is still usable afterwards
    x2, f2 = rgb_cuda(L, c, mv, M=M, tile=8)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(x2).all())


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
    with BatchScheduler(spec, max_batch=16, max_wait_s=0.002) as sched:
        assert sched.buffers.pinned and sched.n_devices >= 1
        futs = [sched.submit(*r) for r in reqs]
        results = [f.result(timeout=120) for f in futs]
        sched.drain()
        snap = sched.metrics.snapshot()
    assert rgb_cuda.launches - n0 == snap["launches_total"] > 0
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
