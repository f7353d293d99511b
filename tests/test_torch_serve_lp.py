"""The port's serving layer (``repro_torch.serve_lp`` and the ``obs`` hooks it
uses) on CPU devices: bit-identical to direct solves with the same spec,
equal to the reference scheduler to the reference's kernel-test tolerances
(``feasible`` exactly, ``x`` 1e-4, ``objective`` 2e-4 — FMA contraction and
reduction order differ between XLA and eager torch ops, the algorithm does
not), and the layout algebra equal to the reference's exactly.

Every scheduler here is given ``devices=[torch.device("cpu")]`` (or four of
them, which exercises uneven multi-device layouts); the default is every
visible card, which raises where there is none."""
import threading
import time

import numpy as np
import pytest
import torch

import repro.serve_lp as rsv
import _torch_compat  # noqa: F401  (this worker's torch threads)
import repro_torch.serve_lp as tsv
from repro_torch.core import (PackedLPBatch, batch_from_numpy,
                              pack_call_count, ragged_feasible_lp)
from repro_torch.kernels.batch_lp import DEFAULT_TILE
from repro_torch.obs import FlightRecorder, Tracer
from repro_torch.serve_lp import (BatchScheduler, ExecSpec, ExecutableCache,
                                  SolverSpec, as_executable, build_executable,
                                  plan_layout)
from repro_torch.serve_lp.scheduler import _FlushBufferPool
from repro_torch.solver import solve_with_spec

CPU1 = [torch.device("cpu")]
CPU4 = [torch.device("cpu")] * 4


def _mixed_requests(seed=0, ms=(3, 8, 37, 128, 130, 200), reps=2):
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(reps):
        for m in ms:
            xstar = rng.uniform(-10, 10, 2)
            theta = rng.uniform(0, 2 * np.pi, m)
            A = np.stack([np.cos(theta), np.sin(theta)], -1)
            b = A @ xstar + rng.uniform(0.1, 3.0, m)
            phi = rng.uniform(0, 2 * np.pi)
            c = np.array([np.cos(phi), np.sin(phi)])
            reqs.append((A.astype(np.float32), b.astype(np.float32),
                         c.astype(np.float32)))
    return reqs


def _sched(spec=None, **kw):
    kw.setdefault("devices", CPU1)
    return BatchScheduler(spec, **kw)


def _assert_bit_identical_to_direct(spec, reqs, results):
    solver = spec.build(device="cpu")
    for (A, b, c), r in zip(reqs, results):
        d = solver.solve(batch_from_numpy(A[None], b[None], c[None],
                                          device="cpu"))
        assert bool(d.feasible[0]) == r.feasible
        np.testing.assert_array_equal(d.x[0].numpy(), r.x)


# -- bucketing and layout algebra: equal to the reference's ----------------

def test_bucket_ladders_match_reference():
    for m in (1, 7, 8, 9, 127, 128, 129, 700, 1024, 5000):
        for base in (8, 128):
            assert tsv.bucket_m(m, base=base) == rsv.bucket_m(m, base=base)
    for n in (1, 31, 32, 33, 100, 1000):
        for unit in (8, 32):
            assert tsv.bucket_batch(n, unit) == rsv.bucket_batch(n, unit)
    assert tsv.shape_ladder(1000) == rsv.shape_ladder(1000) == \
        [128, 256, 512, 1024]
    with pytest.raises(ValueError):
        tsv.bucket_m(0)
    assert _sched(method="rgb").bucket_base == 8
    assert _sched(method="kernel").bucket_base == 128


def test_exec_spec_validation_and_keys():
    rgb = lambda **kw: SolverSpec(backend="rgb", tile=32, **kw)
    with pytest.raises(ValueError):      # only the kernel needs LANE m
        ExecSpec(bucket_m=100, b_pad=32,
                 solver=SolverSpec(backend="kernel", tile=32))
    ExecSpec(bucket_m=16, b_pad=32, solver=rgb())
    ExecSpec(bucket_m=128, b_pad=33, solver=rgb())    # any positive b_pad
    # the legacy even-split mode is not ported: the reference's ValueError
    for mode in ("pmap", "banana"):
        with pytest.raises(ValueError, match="sharding"):
            ExecSpec(bucket_m=128, b_pad=32, solver=rgb(), sharding=mode)
        with pytest.raises(ValueError, match="sharding"):
            _sched(rgb(), sharding=mode)
    assert tsv.SHARDING_MODES == ("mesh",)
    with pytest.raises(ValueError):      # b_pad padding needs a tile
        ExecSpec(bucket_m=128, b_pad=32, solver=SolverSpec(backend="rgb"))
    with pytest.raises(TypeError):
        ExecSpec(bucket_m=128, b_pad=32, solver="rgb")
    mk = lambda **kw: ExecSpec(bucket_m=16, b_pad=32, solver=rgb(**kw))
    assert mk() == mk() and hash(mk()) == hash(mk())
    assert mk(M=2.0e4) != mk() and mk(normalize=False) != mk()
    assert mk(seed=1, shuffle=True) != mk(shuffle=True)


def test_plan_layout_equals_reference_on_a_sweep():
    for rows in range(1, 200, 7):
        for tile in (1, 8, 16, 32):
            for n_dev in (1, 2, 3, 4, 5, 8):
                ref = rsv.plan_layout(rows, tile, n_dev)
                got = plan_layout(rows, tile, n_dev)
                assert got.shards == ref.shards and got.tile == ref.tile
                assert got.b_pad == ref.b_pad
                assert got.offsets == ref.offsets
                assert got.n_launches == ref.n_launches <= 2
                assert got.describe() == ref.describe()
                assert [(g.start, g.n_devices, g.rows_per_device, g.offset)
                        for g in got.groups] == \
                    [(g.start, g.n_devices, g.rows_per_device, g.offset)
                     for g in ref.groups]
    lay = plan_layout(80, 16, 4)
    assert lay.shards == (32, 16, 16, 16)
    assert lay.global_row(1, 0) == 32 and lay.global_row(3, 15) == 79
    with pytest.raises(IndexError):
        lay.global_row(1, 16)
    for bad in ((0, 16, 4), (16, 0, 4), (16, 16, 0)):
        with pytest.raises(ValueError):
            plan_layout(*bad)
    for shards in ((15,), (0, 0), ()):
        with pytest.raises(ValueError):
            tsv.MeshLayout(shards=shards, tile=16)


# -- construction ------------------------------------------------------------

def test_scheduler_construction_rules():
    spec = SolverSpec(backend="rgb", tile=8, chunk=64)
    sched = _sched(spec, max_batch=4)
    assert sched.spec.tile == 8 and sched.spec.chunk == 64
    assert sched.n_devices == 1 and not sched.buffers.pinned
    with pytest.raises(TypeError):
        _sched(spec, method="rgb")
    with pytest.raises(TypeError):
        _sched("rgb")
    default = _sched(SolverSpec(backend="rgb"))
    assert default.spec.tile is None and default.tile is None
    # no explicit tile: each bucket's flush pins its own, and pads to it
    assert default._pin_for_bucket(64, 5).tile == 32
    kern = _sched(SolverSpec(backend="kernel"))
    assert kern._pin_for_bucket(128, 100).tile == DEFAULT_TILE
    assert kern._pin_for_bucket(128, 3).tile == 3
    with pytest.raises(ValueError, match="shuffle"):
        _sched(SolverSpec(backend="rgb", shuffle=True))
    with pytest.raises(ValueError):
        _sched(method="bogus")
    pd = _sched(SolverSpec(backend="pdhg"))    # ported: a dense ladder
    assert pd.spec.backend == "pdhg" and pd.bucket_base == 8
    with pytest.raises(ValueError, match="one device type"):
        _sched(spec, devices=[])
    # auto resolves against the devices' platform; the kernel backend on CPU
    # devices runs its plain version
    assert _sched(SolverSpec(backend="auto")).spec.backend == "rgb"
    assert _sched(SolverSpec(backend="kernel")).spec.interpret is True


def test_default_devices_need_a_card():
    if torch.cuda.is_available():
        sched = BatchScheduler(SolverSpec(backend="kernel"))
        assert sched.buffers.pinned and sched.spec.interpret is False
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchScheduler(SolverSpec(backend="rgb"))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_executable(ExecSpec(bucket_m=16, b_pad=8, solver=SolverSpec(
            backend="rgb", tile=8, chunk=0).resolve("cpu")))


# -- flush triggers ----------------------------------------------------------

def test_size_wait_and_manual_triggers():
    one_bucket = _mixed_requests(ms=(9, 10, 11, 12), reps=1)
    sched = _sched(max_batch=4, tile=8)
    futs = [sched.submit(*r) for r in one_bucket]
    for f in futs:
        f.result(timeout=60.0)
    assert sched.pending() == 0
    assert sched.metrics.flush_reasons == {"size": 1}
    # stop-and-go: a size-triggered flush completes before submit returns
    sync = _sched(max_batch=4, tile=8, pipeline=False)
    futs = [sync.submit(*r) for r in one_bucket]
    assert all(f.done() for f in futs) and sync.metrics.inflight_now == 0
    with _sched(max_batch=1000, max_wait_s=0.02, tile=8) as timed:
        futs = [timed.submit(*r) for r in _mixed_requests(ms=(5, 200),
                                                          reps=1)]
        deadline = time.time() + 10.0
        while not all(f.done() for f in futs):
            assert time.time() < deadline, "wait-trigger never flushed"
            time.sleep(0.01)
        assert timed.metrics.flush_reasons.get("wait", 0) >= 1
    manual = _sched(max_batch=1000, tile=8)
    futs = [manual.submit(*r) for r in _mixed_requests(reps=1)]
    assert manual.pending() == len(futs)
    assert manual.flush() == len(futs) and manual.pending() == 0
    manual.drain()
    assert all(f.done() for f in futs)


# -- round trips ---------------------------------------------------------------

@pytest.mark.parametrize("backend", ["rgb", "kernel"])
def test_roundtrip_bit_identical_to_direct_and_close_to_reference(backend):
    """Mixed-shape requests through the port's scheduler: the same bits as a
    direct solve with the same spec, and the reference scheduler's answers
    to tolerance."""
    kw = (dict(backend="rgb", tile=32) if backend == "rgb" else
          dict(backend="kernel", tile=32, interpret=True))
    reqs = _mixed_requests(ms=(3, 8, 37, 130), reps=2)
    spec = SolverSpec(**kw)
    sched = _sched(spec, max_batch=1000)
    futs = [sched.submit(*r) for r in reqs]
    sched.flush()
    results = [f.result(timeout=120.0) for f in futs]
    sched.close()
    _assert_bit_identical_to_direct(spec, reqs, results)
    ref_sched = rsv.BatchScheduler(rsv.SolverSpec(**kw), max_batch=1000)
    ref_futs = [ref_sched.submit(*r) for r in reqs]
    ref_sched.flush()
    for (A, b, c), r, rf in zip(reqs, results, ref_futs):
        ref = rf.result(timeout=120.0)
        assert r.feasible == ref.feasible is True
        np.testing.assert_allclose(r.x, ref.x, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(r.objective, ref.objective, rtol=2e-4,
                                   atol=2e-4)
        assert (r.m, r.bucket_m, r.batch_size) == (
            ref.m, ref.bucket_m, ref.batch_size)
        assert r.latency_s >= 0.0 and r.x.shape == (2,)
    ref_sched.close()


def test_infeasible_and_degenerate_roundtrip():
    sched = _sched(max_batch=1000, tile=8)
    rng = np.random.default_rng(7)
    theta = rng.uniform(0, 2 * np.pi, 6)
    A = np.stack([np.cos(theta), np.sin(theta)], -1).astype(np.float32)
    xstar = rng.uniform(-5, 5, 2)
    fd = sched.submit(A, (A @ xstar).astype(np.float32),
                      np.array([1.0, 0.0], np.float32))
    fi = sched.submit(np.array([[1.0, 0.0], [-1.0, 0.0]], np.float32),
                      np.array([-1.0, -1.0], np.float32),
                      np.array([1.0, 0.0], np.float32))
    sched.flush()
    assert fd.result(timeout=60).feasible
    np.testing.assert_allclose(fd.result().x, xstar, rtol=1e-4, atol=1e-4)
    assert not fi.result(timeout=60).feasible


def test_submit_honors_spec_dtype():
    req = _mixed_requests(ms=(5,), reps=1)[0]
    s32 = _sched(SolverSpec(backend="rgb", tile=8))
    s32.submit(np.asarray(req[0], np.float64), req[1], req[2])
    q = next(iter(s32._queues.values()))
    assert q[0].ax.dtype == q[0].b.dtype == q[0].c.dtype == np.float32
    s32.flush()
    # float64 needs no global switch in the port
    s64 = _sched(SolverSpec(backend="rgb", tile=8, dtype="float64"))
    f = s64.submit(*req)
    assert next(iter(s64._queues.values()))[0].ax.dtype == np.float64
    s64.flush()
    assert f.result(timeout=60).x.dtype == np.float64


# -- the packed flush path ---------------------------------------------------

@pytest.mark.parametrize("method,interpret", [("rgb", None),
                                              ("kernel", True)])
def test_flush_does_zero_repacks(method, interpret):
    sched = _sched(method=method, max_batch=1000, tile=8,
                   interpret=interpret)
    reqs = _mixed_requests(reps=1)
    n0 = pack_call_count()
    for _ in range(2):                   # cold, then warm executables
        futs = [sched.submit(*r) for r in reqs]
        sched.flush()
        for f in futs:
            f.result(timeout=120.0)
    assert pack_call_count() == n0, "the flush path repacked AoS->SoA"


def test_flush_buffers_reused_for_stable_bucket():
    sched = _sched(method="rgb", max_batch=1000, tile=8)
    reqs = _mixed_requests(ms=(9, 10, 11, 12), reps=1)
    results = []
    for _ in range(4):
        futs = [sched.submit(*r) for r in reqs]
        sched.flush()
        results.append([f.result(timeout=60.0) for f in futs])
    assert sched.buffers.lease_count == 4
    assert sched.buffers.alloc_count == 1
    for later in results[1:]:            # reuse leaks no state
        for a, b in zip(results[0], later):
            np.testing.assert_array_equal(a.x, b.x)
            assert a.feasible == b.feasible
    for _ in range(2):                   # a new shape allocates once
        futs = [sched.submit(*r) for r in _mixed_requests(ms=(200, 210),
                                                          reps=1)]
        sched.flush()
        for f in futs:
            f.result(timeout=60.0)
    assert sched.buffers.alloc_count == 2


def test_buffer_pool_contract():
    pool = _FlushBufferPool(max_per_key=1)
    key, bufs = pool.lease(8, 16, np.float32)
    L, c, mv = bufs
    assert (L.shape, c.shape, mv.shape) == ((8, 4, 16), (8, 2), (8, 1))
    assert (L.dtype, mv.dtype) == (np.float32, np.int32)
    key2, bufs2 = pool.lease(8, 16, np.float32)     # first still out
    assert bufs2[0] is not L and pool.alloc_count == 2
    pool.release(key, bufs)
    pool.release(key2, bufs2)                       # over max_per_key: dropped
    _, again = pool.lease(8, 16, np.float32)
    assert again[0] is L and pool.alloc_count == 2
    assert pool.lease(8, 16, np.float64)[1][0].dtype == np.float64


class _SlowCompleteExec:
    """A real executable whose completion takes a minimum time, so overlap
    and backpressure are observable on the CPU."""

    def __init__(self, inner, delay_s):
        self.inner, self.delay_s = inner, delay_s

    def dispatch(self, L, c, mv):
        return self.inner.dispatch(L, c, mv)

    def complete(self, handle):
        time.sleep(self.delay_s)
        return self.inner.complete(handle)


class _AuditPool(_FlushBufferPool):
    """Records lease/release interleaving: a buffer set may never be leased
    twice without a release in between."""

    def __init__(self):
        super().__init__()
        self._audit_lock = threading.Lock()
        self._out = set()
        self.max_outstanding = self.violations = 0

    def lease(self, b_pad, bm, dtype):
        key, bufs = super().lease(b_pad, bm, dtype)
        with self._audit_lock:
            self.violations += id(bufs[0]) in self._out
            self._out.add(id(bufs[0]))
            self.max_outstanding = max(self.max_outstanding, len(self._out))
        return key, bufs

    def release(self, key, bufs):
        with self._audit_lock:
            self._out.discard(id(bufs[0]))
        super().release(key, bufs)


def test_pipelined_overlap_backpressure_and_release_only_at_completion():
    spec = SolverSpec(backend="rgb", tile=8)
    sched = _sched(spec, max_batch=4, max_inflight=2)
    sched.cache = ExecutableCache(
        lambda s: _SlowCompleteExec(build_executable(s, CPU1), 0.05))
    sched.buffers = _AuditPool()
    reqs = _mixed_requests(ms=(9, 10, 11, 12), reps=4)    # one bucket
    futs = [sched.submit(*r) for r in reqs]               # 4 size flushes
    results = [f.result(timeout=120.0) for f in futs]
    sched.drain()
    snap = sched.metrics.snapshot()
    assert snap["inflight_max"] == 2 and snap["inflight_now"] == 0
    assert snap["overlapped_dispatches"] >= 1 and snap["n_dispatched"] == 4
    # buffers of an in-flight flush were never handed out again: they go
    # back only when its completion has run
    assert sched.buffers.violations == 0
    assert sched.buffers.max_outstanding >= 2
    assert sched.buffers.lease_count == 4
    assert 2 <= sched.buffers.alloc_count <= 3
    _assert_bit_identical_to_direct(spec, reqs, results)


def test_cache_hit_accounting():
    sched = _sched(max_batch=8, tile=8)
    reqs = _mixed_requests(ms=(9, 10, 11, 12, 13, 14, 15, 16), reps=1)
    for _ in range(3):
        for r in reqs:
            sched.submit(*r)
    sched.drain()
    stats = sched.cache.stats()
    assert (stats["misses"], stats["size"], stats["hits"]) == (1, 1, 2)
    for r in _mixed_requests(ms=(200,) * 8, reps=1):
        sched.submit(*r)
    sched.drain()
    stats = sched.cache.stats()
    assert stats["misses"] == 2 and stats["size"] == 2
    assert stats["hit_rate"] == pytest.approx(2 / 4)
    # which shapes and launch geometry the flushes ran, and how often
    uses = sched.cache.uses()
    assert sorted((s.bucket_m, s.b_pad, s.tile, n)
                  for s, n in uses.items()) == [(16, 8, 8, 3), (256, 8, 8, 1)]
    sched.cache.reset_stats()
    assert sched.cache.uses() == {} and len(sched.cache) == 2


# -- fused flush units -------------------------------------------------------

def test_fused_flush_scatter_routing():
    spec = SolverSpec(backend="rgb", tile=8)
    sched = _sched(spec, max_batch=64, max_wait_s=60.0)
    assert sched.fuse
    reqs = _mixed_requests(ms=(3, 5, 12, 14, 30, 60), reps=2)
    futs = [sched.submit(*r) for r in reqs]
    sched.flush()
    results = [f.result(timeout=120.0) for f in futs]
    sched.drain()
    _assert_bit_identical_to_direct(spec, reqs, results)
    snap = sched.metrics.snapshot()
    assert snap["flush_reasons"] == {"fused": 1}
    assert snap["fused_flushes"] == 1 and snap["fused_buckets"] == 4
    assert snap["launches_total"] >= 1
    sched.close()


def test_fused_joint_fill_ratio_and_disable():
    spec = SolverSpec(backend="rgb", tile=8)
    joint = _sched(spec, max_batch=8, max_wait_s=60.0)
    reqs = (_mixed_requests(ms=(5,), reps=4)
            + _mixed_requests(seed=1, ms=(12,), reps=4))
    futs = [joint.submit(*r) for r in reqs]       # 8th submit fills jointly
    results = [f.result(timeout=120.0) for f in futs]
    joint.drain()
    _assert_bit_identical_to_direct(spec, reqs, results)
    snap = joint.metrics.snapshot()
    assert snap["flush_reasons"].get("fused") == 1
    assert snap["fused_buckets"] == 2 and joint.pending() == 0
    joint.close()

    ratio = _sched(spec, max_batch=64, max_wait_s=60.0, fuse_max_m_ratio=2.0)
    futs = [ratio.submit(*r) for r in _mixed_requests(ms=(5, 12, 100),
                                                      reps=1)]
    ratio.flush()
    for f in futs:
        f.result(timeout=120.0)
    ratio.drain()
    snap = ratio.metrics.snapshot()
    assert snap["fused_flushes"] == 1 and snap["fused_buckets"] == 2
    assert snap["n_flushes"] == 2
    ratio.close()

    nofuse = _sched(spec, max_batch=64, max_wait_s=60.0, fuse=False)
    futs = [nofuse.submit(*r) for r in _mixed_requests(ms=(5, 12, 30),
                                                       reps=1)]
    nofuse.flush()
    for f in futs:
        f.result(timeout=120.0)
    nofuse.drain()
    snap = nofuse.metrics.snapshot()
    assert snap["fused_flushes"] == 0 and snap["n_flushes"] == 3
    assert snap["flush_reasons"] == {"manual": 3}
    nofuse.close()


def test_fused_policy_veto_and_buffer_audit():
    spec = SolverSpec(backend="rgb", tile=8)
    sched = _sched(spec, max_batch=64, max_wait_s=60.0)
    sched.set_bucket_policy(lambda bm: (64, 60.0, bm != 8))
    futs = [sched.submit(*r) for r in _mixed_requests(ms=(5, 12, 30),
                                                      reps=1)]
    sched.flush()
    for f in futs:
        f.result(timeout=120.0)
    sched.drain()
    snap = sched.metrics.snapshot()
    assert snap["n_flushes"] == 2
    assert snap["fused_flushes"] == 1 and snap["fused_buckets"] == 2
    sched.close()

    audited = _sched(spec, max_batch=16, max_wait_s=60.0)
    audited.buffers = _AuditPool()
    futs = []
    for rep in range(3):
        futs += [audited.submit(*r) for r in
                 _mixed_requests(seed=rep, ms=(3, 5, 12, 14), reps=2)]
        audited.flush()
    for f in futs:
        f.result(timeout=120.0)
    audited.drain()
    snap = audited.metrics.snapshot()
    assert audited.buffers.violations == 0
    assert audited.buffers.lease_count == snap["n_flushes"]
    assert snap["fused_flushes"] >= 1
    audited.close()


# -- cancellation and failures -------------------------------------------------

def test_cancel_before_flush_is_skipped_and_late_cancel_loses():
    spec = SolverSpec(backend="rgb", tile=8)
    reqs = _mixed_requests(ms=(9, 10), reps=1)
    with _sched(spec, max_batch=64, max_wait_s=60.0) as sched:
        f1, f2 = (sched.submit(*r) for r in reqs)
        assert f1.cancel()
        sched.flush()
        sched.drain()
        assert f2.result(timeout=60).feasible and f1.cancelled()
        assert not sched.metrics.errors
    # once a flush has claimed a request, cancel() loses cleanly
    slow = _sched(spec, max_batch=2, max_wait_s=60.0)
    slow.cache = ExecutableCache(
        lambda s: _SlowCompleteExec(build_executable(s, CPU1), 0.3))
    f1, f2 = (slow.submit(*r) for r in reqs)      # size flush claims both
    assert f1.cancel() is False
    assert f1.result(timeout=30) is not None
    assert f2.result(timeout=30) is not None
    assert not slow.metrics.errors
    slow.close()


def _failing_build(spec):
    raise ValueError(f"executable build refused for {spec.bucket_m}")


def test_solver_errors_reach_futures_and_the_timer_survives():
    sched = _sched(max_batch=1000, tile=8)
    sched.cache = ExecutableCache(_failing_build)
    f = sched.submit(*_mixed_requests(ms=(5,), reps=1)[0])
    with pytest.raises(ValueError):
        sched.flush()
    assert isinstance(f.exception(timeout=1.0), ValueError)

    timed = _sched(max_batch=1000, max_wait_s=0.01, tile=8)
    timed.cache = ExecutableCache(_failing_build)
    timed.start()
    try:
        req = _mixed_requests(ms=(5,), reps=1)[0]
        assert isinstance(timed.submit(*req).exception(timeout=5.0),
                          ValueError)
        assert isinstance(timed.submit(*req).exception(timeout=5.0),
                          ValueError)
    finally:
        timed._stop.set()
        timed._thread.join()
        timed._thread = None
    snap = timed.metrics.snapshot()
    assert snap["errors"].get("timer_flush", 0) >= 1
    assert "timer_flush" in timed.metrics.format_report()


@pytest.mark.parametrize("pipeline", [True, False])
def test_multi_bucket_flush_failure_isolated(pipeline):
    def build(spec):
        if spec.bucket_m == 16:
            raise ValueError(f"injected failure for bucket {spec.bucket_m}")
        return build_executable(spec, CPU1)

    sched = _sched(max_batch=1000, tile=8, pipeline=pipeline, fuse=False)
    sched.cache = ExecutableCache(build)
    f_ok1 = sched.submit(*_mixed_requests(ms=(5,), reps=1)[0])    # 8
    f_bad = sched.submit(*_mixed_requests(ms=(9,), reps=1)[0])    # 16
    f_ok2 = sched.submit(*_mixed_requests(ms=(70,), reps=1)[0])   # 128
    with pytest.raises(ValueError, match="injected failure"):
        sched.flush()
    assert f_ok1.result(timeout=60.0).feasible
    assert f_ok2.result(timeout=60.0).feasible
    assert isinstance(f_bad.exception(timeout=60.0), ValueError)


def test_completion_failure_lands_on_futures_and_recorder(tmp_path):
    class _FailingComplete:
        def dispatch(self, L, c, mv):
            return "handle"

        def complete(self, handle):
            raise RuntimeError("injected completion failure")

    tracer = Tracer(capacity=256)
    rec = FlightRecorder(str(tmp_path), tracer=tracer, min_interval_s=0.0)
    sched = _sched(max_batch=1000, tile=8, tracer=tracer, recorder=rec)
    sched.cache = ExecutableCache(lambda s: _FailingComplete())
    f = sched.submit(*_mixed_requests(ms=(5,), reps=1)[0])
    sched.flush()                        # dispatch succeeds: no raise here
    assert isinstance(f.exception(timeout=60.0), RuntimeError)
    sched.drain()
    assert sched.metrics.snapshot()["errors"].get("solve", 0) == 1
    assert list(tmp_path.iterdir()), "the flight recorder dumped nothing"


def test_close_refuses_new_submits_and_resolves_queued():
    sched = _sched(max_batch=1000, tile=8)
    futs = [sched.submit(*r) for r in _mixed_requests(reps=1)]
    sched.close()
    for f in futs:
        assert f.result(timeout=60.0) is not None
    with pytest.raises(RuntimeError, match="closed"):
        sched.submit(*_mixed_requests(ms=(5,), reps=1)[0])
    sched.close()                        # idempotent
    assert sched.closed


def test_as_executable_adapts_plain_callables():
    calls = []

    def sync_fn(L, c, mv):
        calls.append(L.shape)
        return "x", "feas"

    exe = as_executable(sync_fn)
    assert exe.complete(exe.dispatch(np.zeros((2, 4, 8)), None, None)) == \
        ("x", "feas")
    assert calls == [(2, 4, 8)] and as_executable(exe) is exe
    assert exe.n_launches == 1 and exe.shards == ()


# -- tracing -------------------------------------------------------------------

def test_traced_scheduler_emits_the_span_chain_and_untraced_none():
    tracer = Tracer(capacity=4096)
    reqs = _mixed_requests(ms=(9, 10, 11), reps=1)
    with _sched(SolverSpec(backend="rgb", tile=8), max_batch=64,
                max_wait_s=60.0, tracer=tracer) as sched:
        futs = [sched.submit(*r) for r in reqs]
        sched.flush()
        for f in futs:
            f.result(timeout=60)
        sched.drain()
    names = [s.name for s in tracer.spans()]
    for name in ("request", "queue.wait", "flush.assemble", "flush.dispatch",
                 "device.solve", "flush.scatter"):
        assert name in names, (name, sorted(set(names)))
    assert names.count("request") == 3
    plain = _sched(SolverSpec(backend="rgb", tile=8), max_batch=64)
    f = plain.submit(*reqs[0])
    plain.flush()
    f.result(timeout=60)
    assert plain.tracer.spans() == []
    plain.close()


def test_metrics_snapshot_keys_match_reference():
    ref = rsv.ServeMetrics().snapshot()
    got = tsv.ServeMetrics().snapshot()
    assert sorted(got) == sorted(ref)


# -- several devices (four CPU "devices": the layout is what is tested) ------

def _packed_numpy(batch, m_pad, seed):
    lp = ragged_feasible_lp(torch.Generator().manual_seed(seed), batch, 24,
                            m_min=2, device="cpu")
    pb = lp.pack(m_pad)
    return pb.L.numpy(), pb.c.numpy(), pb.m_valid.numpy()


@pytest.mark.parametrize("b_pad,shards,launches", [
    (64, (16, 16, 16, 16), 1),          # even split
    (80, (32, 16, 16, 16), 2),          # 5 tiles over 4 devices: two groups
    (37, (16, 16, 16, 0), 1),           # prime rows pad to tiles only
    (16, (16, 0, 0, 0), 1),             # underfull: trailing devices unused
])
def test_uneven_shards_on_four_devices_match_one_solve(b_pad, shards,
                                                       launches):
    L, c, mv = _packed_numpy(b_pad, 32, seed=b_pad)
    solver = SolverSpec(backend="rgb", tile=16)
    exe = build_executable(
        ExecSpec(bucket_m=32, b_pad=b_pad, solver=solver, n_devices=4), CPU4)
    assert exe.layout.shards == shards and exe.n_launches == launches
    x, feas = exe(L, c, mv)
    assert x.shape == (b_pad, 2) and feas.shape == (b_pad,)
    ref = solve_with_spec(solver, PackedLPBatch(
        L=torch.from_numpy(L), c=torch.from_numpy(c),
        m_valid=torch.from_numpy(mv)))
    np.testing.assert_array_equal(x, ref.x.numpy())
    np.testing.assert_array_equal(feas, ref.feasible.numpy())
    assert feas.all()
    with pytest.raises(ValueError, match="n_devices"):
        build_executable(ExecSpec(bucket_m=32, b_pad=b_pad, solver=solver,
                                  n_devices=4), CPU1)


def test_fused_scheduler_on_four_devices():
    spec = SolverSpec(backend="rgb", tile=8)
    sched = _sched(spec, max_batch=64, max_wait_s=60.0, devices=CPU4)
    reqs = _mixed_requests(seed=2, ms=(3, 5, 12, 14, 30, 60), reps=2)
    futs = [sched.submit(*r) for r in reqs]
    sched.flush()
    results = [f.result(timeout=120.0) for f in futs]
    sched.drain()
    _assert_bit_identical_to_direct(spec, reqs, results)
    snap = sched.metrics.snapshot()
    assert snap["fused_flushes"] == 1 and snap["fused_buckets"] == 4
    assert len(snap["rows_per_device"]) == 4
    # 12 requests pad to two 8-row tiles, one per device; two devices idle
    assert sum(snap["rows_per_device"]) == 16
    assert snap["rows_per_device"].count(0) == 2
    sched.close()
