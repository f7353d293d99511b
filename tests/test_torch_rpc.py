"""The port's RPC front end (``repro_torch.serve_lp.rpc``) on the CPU.

The reference's own ``test_rpc.py`` cases run on the port, socket-free
through ``LPFrontend.handle`` and over one real socket, with every scheduler
on ``devices=[torch.device("cpu")]``.  One more table holds the two front
ends against each other: the same good and bad payloads give the same
status codes, error codes and ``feasible`` flags, and ``x`` within 1e-4 (the
reference's kernel-test tolerance: FMA contraction and reduction order
differ between XLA and eager torch ops).  Within the port, an accepted
request's answer is bit-identical to a direct solve of the same LP.
"""
import asyncio
import json
import math
import threading
import time
from concurrent.futures import InvalidStateError

import numpy as np
import pytest
import torch

import repro.serve_lp as rsv
import repro.serve_lp.rpc as rrpc
import _torch_compat  # noqa: F401  (this worker's torch threads)
from repro_torch.serve_lp import BatchScheduler, ExecutableCache, SolverSpec
from repro_torch.serve_lp.metrics import ServeMetrics
from repro_torch.serve_lp.rpc import (AdmissionPolicy, QuotaManager, Request,
                                      RpcError, SLOController, TokenBucket,
                                      check_backpressure, make_frontend,
                                      parse_solve_payload, render_metrics,
                                      run_in_thread, validate_exposition)
from repro_torch.tune.table import TableEntry, TableKey, TuningTable

CPU1 = [torch.device("cpu")]
SPEC = SolverSpec(backend="rgb", tile=16, chunk=0)


def _lp(seed=0, m=3):
    rng = np.random.default_rng(seed)
    xstar = rng.uniform(-10, 10, 2)
    theta = rng.uniform(0, 2 * np.pi, m)
    A = np.stack([np.cos(theta), np.sin(theta)], -1).astype(np.float32)
    b = (A @ xstar + rng.uniform(0.1, 3.0, m)).astype(np.float32)
    phi = rng.uniform(0, 2 * np.pi)
    c = np.array([np.cos(phi), np.sin(phi)], np.float32)
    return A, b, c


def _problem_json(A, b, c, **extra):
    return {"A": A.tolist(), "b": b.tolist(), "c": c.tolist(), **extra}


def _post(frontend, obj, headers=None, raw=None):
    req = Request("POST", "/v1/solve",
                  {k.lower(): v for k, v in (headers or {}).items()},
                  raw if raw is not None else json.dumps(obj).encode())
    return asyncio.run(frontend.handle(req))


def _get(frontend, path):
    return asyncio.run(frontend.handle(Request("GET", path, {})))


def _body(resp):
    return json.loads(resp.body)


def _frontend(spec=SPEC, **kw):
    kw.setdefault("devices", CPU1)
    return make_frontend(spec, **kw)


def _sched(spec=SPEC, **kw):
    kw.setdefault("devices", CPU1)
    return BatchScheduler(spec, **kw)


@pytest.fixture
def frontend():
    f = _frontend(max_batch=4, max_wait_s=0.003)
    f.start()
    yield f
    f.close()


@pytest.fixture
def frontend_slo():
    f = _frontend(max_batch=4, max_wait_s=0.003, target_p99_s=0.05)
    f.start()
    yield f
    f.close()


# -- token buckets --------------------------------------------------------

def test_token_bucket_refill_and_pricing():
    t = [0.0]
    bucket = TokenBucket(rate=10.0, burst=5.0, clock=lambda: t[0])
    assert bucket.try_take(5.0) == 0.0
    assert bucket.try_take(1.0) == pytest.approx(0.1)
    t[0] += 0.1
    assert bucket.try_take(1.0) == 0.0
    assert bucket.try_take(6.0) == math.inf
    t[0] += 100.0
    assert bucket.tokens == pytest.approx(5.0)


def test_quota_manager_per_tenant_and_counters():
    t = [0.0]
    q = QuotaManager(rate=100.0, burst=10.0,
                     per_tenant={"vip": (1000.0, 100.0)},
                     clock=lambda: t[0])
    assert q.admit("vip", 50.0) == 0.0
    assert q.admit("anon", 50.0) == math.inf
    assert q.admit("anon", 10.0) == 0.0
    assert q.admit("anon", 1.0) > 0.0
    snap = q.snapshot()
    assert snap["anon"]["admitted"] == 10
    assert snap["anon"]["rejected"] == 51
    assert snap["vip"]["admitted"] == 50


# -- validation -----------------------------------------------------------

_BAD_BODIES = [
    (b"{not json", 400, "bad_json"),
    (b'[1,2]', 400, "bad_request"),
    (json.dumps({"A": [[1, 0]], "b": [1]}).encode(), 422, "missing_field"),
    (json.dumps({"A": [[1, 0, 2]], "b": [1], "c": [1, 1]}).encode(), 422,
     "bad_shape"),
    (json.dumps({"A": [], "b": [], "c": [1, 1]}).encode(), 422,
     "bad_shape"),
    (json.dumps({"A": [[1, 0]], "b": [1, 2], "c": [1, 1]}).encode(), 422,
     "bad_shape"),
    (json.dumps({"A": [[1, 0]], "b": [1], "c": [1, 1, 1]}).encode(), 422,
     "bad_shape"),
    (json.dumps({"A": [[1, "x"]], "b": [1], "c": [1, 1]}).encode(), 422,
     "bad_dtype"),
    (json.dumps({"A": [[1, float("nan")]], "b": [1],
                 "c": [1, 1]}).encode(), 422, "nonfinite"),
    (json.dumps({"problems": []}).encode(), 422, "bad_request"),
]


@pytest.mark.parametrize("body,status,code", _BAD_BODIES)
def test_parse_rejections_typed(body, status, code):
    with pytest.raises(RpcError) as ei:
        parse_solve_payload(body, np.float32, AdmissionPolicy())
    assert (ei.value.status, ei.value.code) == (status, code)


def test_parse_bounds():
    A, b, c = _lp(m=9)
    policy = AdmissionPolicy(m_max=8, batch_max=2)
    with pytest.raises(RpcError) as ei:
        parse_solve_payload(json.dumps(_problem_json(A, b, c)).encode(),
                            np.float32, policy)
    assert (ei.value.status, ei.value.code) == (422, "m_out_of_bounds")
    A, b, c = _lp(m=3)
    probs = {"problems": [_problem_json(A, b, c)] * 3}
    with pytest.raises(RpcError) as ei:
        parse_solve_payload(json.dumps(probs).encode(), np.float32, policy)
    assert (ei.value.status, ei.value.code) == (413, "batch_too_large")
    with pytest.raises(RpcError) as ei:
        parse_solve_payload(b"x" * 100, np.float32,
                            AdmissionPolicy(body_max_bytes=10))
    assert (ei.value.status, ei.value.code) == (413, "body_too_large")


def test_validation_never_touches_scheduler(frontend):
    resp = _post(frontend, {"A": [[1, 0, 3]], "b": [1], "c": [1, 1]})
    assert resp.status == 422
    assert frontend.scheduler.pending() == 0
    assert frontend.scheduler.metrics.n_solved == 0
    assert frontend.counters.snapshot()["lps_accepted"] == 0


# -- the two front ends against each other --------------------------------

def _good_payloads():
    lps = [_lp(seed=s, m=m) for s, m in [(1, 3), (2, 5), (3, 8)]]
    A, b, _ = _lp(seed=9, m=4)
    inf_A = np.array([[1.0, 0.0], [-1.0, 0.0]], np.float32)
    inf_b = np.array([-1.0, -1.0], np.float32)
    c = np.array([1.0, 0.0], np.float32)
    return [
        ("single", _problem_json(*lps[0]), {}),
        ("batch", {"problems": [_problem_json(*lp) for lp in lps]}, {}),
        ("infeasible", _problem_json(inf_A, inf_b, c), {}),
        ("mixed-batch", {"problems": [_problem_json(inf_A, inf_b, c),
                                      _problem_json(A, b, c)]}, {}),
        ("deadline-ok", _problem_json(*lps[1]),
         {"X-Deadline-Ms": "60000"}),
        ("tenant", _problem_json(*lps[2]), {"X-Tenant": "t"}),
    ]


_BAD_PAYLOADS = [
    ("bad-json", None, b"{not json", {}),
    ("bad-shape", {"A": [[1, 0, 3]], "b": [1], "c": [1, 1]}, None, {}),
    ("missing", {"A": [[1, 0]], "b": [1]}, None, {}),
    ("m-too-big", _problem_json(*_lp(m=5000)), None, {}),
    ("bad-deadline", _problem_json(*_lp()), None,
     {"X-Deadline-Ms": "bogus"}),
    ("neg-deadline", _problem_json(*_lp()), None, {"X-Deadline-Ms": "-5"}),
    ("over-burst", {"problems": [_problem_json(*_lp())] * 5}, None, {}),
]


def test_front_ends_answer_the_same_payloads_alike():
    """Reference ``LPFrontend`` vs the port's on one table of good and bad
    payloads: same status and error codes, same ``feasible``, ``x`` within
    1e-4."""
    ref = rrpc.make_frontend(rsv.SolverSpec(backend="rgb", tile=16,
                                            chunk=0),
                             max_batch=4, max_wait_s=0.003,
                             quotas=rrpc.QuotaManager(burst=4.0))
    port = _frontend(max_batch=4, max_wait_s=0.003,
                     quotas=QuotaManager(burst=4.0))
    ref.start()
    port.start()
    try:
        for label, obj, hdr in _good_payloads():
            r = asyncio.run(ref.handle(rrpc.Request(
                "POST", "/v1/solve", {k.lower(): v for k, v in hdr.items()},
                json.dumps(obj).encode())))
            p = _post(port, obj, hdr)
            assert (p.status, r.status) == (200, 200), label
            rb, pb = json.loads(r.body), _body(p)
            rres = rb.get("results", [rb.get("result")])
            pres = pb.get("results", [pb.get("result")])
            assert len(rres) == len(pres), label
            for a, g in zip(rres, pres):
                assert a["feasible"] == g["feasible"], label
                assert (a["m"], a["bucket_m"]) == (g["m"], g["bucket_m"])
                if a["feasible"]:
                    np.testing.assert_allclose(g["x"], a["x"], rtol=1e-4,
                                               atol=1e-4, err_msg=label)
        for label, obj, raw, hdr in _BAD_PAYLOADS:
            body = raw if raw is not None else json.dumps(obj).encode()
            h = {k.lower(): v for k, v in hdr.items()}
            r = asyncio.run(ref.handle(rrpc.Request("POST", "/v1/solve",
                                                    h, body)))
            p = asyncio.run(port.handle(Request("POST", "/v1/solve", h,
                                                body)))
            assert p.status == r.status and p.status >= 400, label
            assert _body(p)["error"]["code"] == \
                json.loads(r.body)["error"]["code"], label
        for path in ("/nope", "/v1/solve", "/healthz", "/readyz"):
            r = asyncio.run(ref.handle(rrpc.Request("GET", path, {})))
            p = _get(port, path)
            assert p.status == r.status, path
    finally:
        ref.close()
        port.close()


# -- solving through the handler ------------------------------------------

def test_single_and_batch_solve_bit_identical_to_direct(frontend):
    lps = [_lp(seed=s, m=m) for s, m in [(1, 3), (2, 5), (3, 8), (4, 3)]]
    resp = _post(frontend, {"problems": [_problem_json(*lp) for lp in lps]})
    assert resp.status == 200
    results = _body(resp)["results"]
    assert len(results) == len(lps)
    with _sched(max_batch=len(lps)) as direct:
        futs = [direct.submit(*lp) for lp in lps]
        direct.flush()
        want = [f.result(timeout=60) for f in futs]
    for got, ref in zip(results, want):
        assert got["feasible"] == bool(ref.feasible)
        np.testing.assert_array_equal(np.asarray(got["x"], np.float32),
                                      ref.x)
    resp = _post(frontend, _problem_json(*lps[0]))
    assert resp.status == 200
    np.testing.assert_array_equal(
        np.asarray(_body(resp)["result"]["x"], np.float32), want[0].x)


def test_submit_runs_off_the_event_loop_thread(frontend, monkeypatch):
    """The event loop parses and awaits; the scheduler is fed (and device
    work launched) from the frontend's one submit thread only."""
    seen = []
    real = frontend.scheduler.submit

    def spy(*a, **k):
        seen.append(threading.current_thread().name)
        return real(*a, **k)

    monkeypatch.setattr(frontend.scheduler, "submit", spy)
    lps = [_lp(seed=s) for s in (1, 2)]
    assert _post(frontend, {"problems": [_problem_json(*lp)
                                         for lp in lps]}).status == 200
    assert len(seen) == 2
    assert all(n.startswith("serve-lp-submit") for n in seen), seen


def test_internal_errors_do_not_leak_reprs(frontend, monkeypatch):
    def _boom(*a, **k):
        raise RuntimeError("secret-internal-detail /srv/private/path")

    monkeypatch.setattr(frontend.quotas, "admit", _boom)
    resp = _post(frontend, _problem_json(*_lp()))
    assert resp.status == 500
    assert _body(resp)["error"]["code"] == "internal"
    assert "secret-internal-detail" not in resp.body.decode()
    assert frontend.scheduler.metrics.errors.get("rpc_internal") == 1


def test_oversized_lines_get_400_not_connection_drop():
    from repro_torch.serve_lp.rpc.server import _read_request

    def _parse(payload):
        async def _run():
            reader = asyncio.StreamReader(limit=1024)
            reader.feed_data(payload)
            reader.feed_eof()
            return await _read_request(reader, body_max=1 << 20)
        return asyncio.run(_run())

    with pytest.raises(RpcError) as ei:
        _parse(b"GET /" + b"x" * 4096 + b" HTTP/1.1\r\n\r\n")
    assert (ei.value.status, ei.value.code) == (400, "bad_request")
    with pytest.raises(RpcError) as ei:
        _parse(b"POST /v1/solve HTTP/1.1\r\nx-big: " + b"y" * 4096
               + b"\r\n\r\n")
    assert (ei.value.status, ei.value.code) == (400, "bad_request")
    req = _parse(b"GET /debug/trace?trace_id=ab&format=spans HTTP/1.1\r\n"
                 b"Host: x\r\n\r\n")
    assert req.path == "/debug/trace"
    assert req.query == {"trace_id": "ab", "format": "spans"}


def test_method_and_route_errors(frontend):
    assert asyncio.run(frontend.handle(
        Request("GET", "/v1/solve", {}))).status == 405
    assert asyncio.run(frontend.handle(
        Request("GET", "/nope", {}))).status == 404
    snap = frontend.counters.snapshot()
    assert snap["requests"][("solve", 405)] == 1
    assert snap["requests"][("other", 404)] == 1


# -- quotas ----------------------------------------------------------------

def test_quota_exhaustion_429_then_refill():
    t = [0.0]
    f = _frontend(max_batch=1, max_wait_s=0.003,
                  quotas=QuotaManager(rate=100.0, burst=2.0,
                                      clock=lambda: t[0]))
    f.start()
    try:
        prob = _problem_json(*_lp())
        assert _post(f, prob, {"X-Tenant": "t1"}).status == 200
        assert _post(f, prob, {"X-Tenant": "t1"}).status == 200
        resp = _post(f, prob, {"X-Tenant": "t1"})
        assert resp.status == 429
        err = _body(resp)["error"]
        assert err["code"] == "quota_exhausted"
        assert resp.headers["Retry-After"] == "1"
        assert err["retry_after_ms"] == pytest.approx(10.0, abs=1.0)
        assert _post(f, prob, {"X-Tenant": "t2"}).status == 200
        t[0] += 0.05
        assert _post(f, prob, {"X-Tenant": "t1"}).status == 200
        assert f.counters.snapshot()["shed"]["quota_exhausted"] == 1
    finally:
        f.close()


def test_batch_over_burst_is_413_not_retryable():
    f = _frontend(max_batch=8, max_wait_s=0.003,
                  quotas=QuotaManager(rate=100.0, burst=2.0))
    f.start()
    try:
        resp = _post(f, {"problems": [_problem_json(*_lp())] * 3})
        assert resp.status == 413
        assert _body(resp)["error"]["code"] == "batch_exceeds_burst"
        assert "Retry-After" not in resp.headers
    finally:
        f.close()


# -- deadlines -------------------------------------------------------------

def test_bad_deadline_rejected(frontend):
    for value in ("bogus", "-5"):
        resp = _post(frontend, _problem_json(*_lp()),
                     {"X-Deadline-Ms": value})
        assert resp.status == 400
        assert _body(resp)["error"]["code"] == "bad_deadline"


def test_deadline_expiry_cancels_instead_of_solving():
    f = _frontend(max_batch=4096, max_wait_s=30.0)
    f.start()
    try:
        t0 = time.perf_counter()
        resp = _post(f, _problem_json(*_lp()), {"X-Deadline-Ms": "40"})
        assert resp.status == 504
        assert _body(resp)["error"]["code"] == "deadline_exceeded"
        assert time.perf_counter() - t0 < 5.0
        assert f.counters.snapshot()["shed"]["deadline_exceeded"] == 1
        sched = f.scheduler
        assert sched.pending() == 1
        sched.flush()
        sched.drain()
        assert sched.metrics.n_solved == 0
        assert sched.metrics.n_flushes == 0
    finally:
        f.close()


def test_deadline_header_wins_over_body(frontend):
    resp = _post(frontend, _problem_json(*_lp(), deadline_ms=0.001),
                 {"X-Deadline-Ms": "60000"})
    assert resp.status == 200


# -- backpressure ----------------------------------------------------------

class _StubSched:
    def __init__(self, pending=0, inflight=0, max_inflight=2, age=0.0):
        self._pending, self._age = pending, age
        self.inflight, self.max_inflight = inflight, max_inflight

    def pending(self):
        return self._pending

    def queue_age_s(self, now=None):
        return self._age


def test_backpressure_depth_and_age_signals():
    policy = AdmissionPolicy(max_pending=10, max_queue_age_s=0.2)
    check_backpressure(_StubSched(pending=50, inflight=1), policy)
    with pytest.raises(RpcError) as ei:
        check_backpressure(_StubSched(pending=10, inflight=2), policy)
    assert ei.value.status == 429 and ei.value.retry_after_s is not None
    with pytest.raises(RpcError):
        check_backpressure(_StubSched(age=0.5), policy)


def test_backpressure_sheds_through_handler():
    f = _frontend(max_batch=4096, max_wait_s=30.0,
                  policy=AdmissionPolicy(max_queue_age_s=0.0))
    f.start()
    try:
        f.scheduler.submit(*_lp())
        time.sleep(0.01)
        resp = _post(f, _problem_json(*_lp()))
        assert resp.status == 429
        assert _body(resp)["error"]["code"] == "overloaded"
        assert "Retry-After" in resp.headers
        assert f.counters.snapshot()["shed"]["overloaded"] == 1
        assert f.scheduler.pending() == 1
    finally:
        f.close()


def test_shed_request_costs_no_quota_tokens():
    quotas = QuotaManager(rate=100.0, burst=10.0)
    f = _frontend(max_batch=4096, max_wait_s=30.0,
                  policy=AdmissionPolicy(max_queue_age_s=0.0),
                  quotas=quotas)
    f.start()
    try:
        f.scheduler.submit(*_lp())
        time.sleep(0.01)
        assert _post(f, _problem_json(*_lp()),
                     {"X-Tenant": "t1"}).status == 429
        snap = quotas.snapshot()
        assert "t1" not in snap or (snap["t1"]["admitted"] == 0
                                    and snap["t1"]["rejected"] == 0)
    finally:
        f.close()


# -- SLO controller --------------------------------------------------------

def _measured_table(us_per_lp, m_bucket=8, tile=16):
    return TuningTable([TableEntry(
        key=TableKey(device_kind="cpu", backend="rgb", dtype="float32",
                     m_bucket=m_bucket, batch_bucket=0),
        tile=tile, chunk=0, us_per_lp=us_per_lp, source="measured")])


def test_slo_derives_limits_from_measured_latency():
    sched = _sched(max_batch=256, max_wait_s=0.005)
    slo = SLOController(0.05, table=_measured_table(50.0),
                        device_kind="cpu")
    slo.install(sched, m_max=8)
    plan = slo.plans()[8]
    assert plan.source == "measured"
    assert plan.est_flush_s == pytest.approx(12.8e-3)
    assert plan.max_wait_s == pytest.approx(24.4e-3)
    assert plan.max_batch == 256
    assert sched._limits_for(8) == (plan.max_batch, plan.max_wait_s)


def test_slo_caps_batch_for_slow_buckets():
    sched = _sched(max_batch=256, max_wait_s=0.005)
    slo = SLOController(0.05, table=_measured_table(500.0),
                        device_kind="cpu")
    slo.install(sched, m_max=8)
    plan = slo.plans()[8]
    assert plan.max_batch == 32
    assert plan.est_flush_s == pytest.approx(16e-3)
    assert plan.max_wait_s == pytest.approx(0.05 - 32e-3)


def test_slo_plans_equal_the_reference_controllers():
    """Same measured table, same scheduler limits: the port's plans are
    the reference's (the padding unit is the pinned tile in both)."""
    table = TuningTable([
        TableEntry(TableKey("cpu", "rgb", "float32", m_bucket=8,
                            batch_bucket=0), tile=16, chunk=0,
                   us_per_lp=50.0),
        TableEntry(TableKey("cpu", "rgb", "float32", m_bucket=16,
                            batch_bucket=0), tile=16, chunk=0,
                   us_per_lp=700.0)])
    import repro.tune.table as rtt
    rt_table = rtt.TuningTable.from_json(table.to_json())
    mine = SLOController(0.05, table=table, device_kind="cpu")
    ref = rrpc.SLOController(0.05, table=rt_table, device_kind="cpu")
    s1 = _sched(max_batch=256, max_wait_s=0.005)
    s2 = rsv.BatchScheduler(rsv.SolverSpec(backend="rgb", tile=16, chunk=0),
                            max_batch=256, max_wait_s=0.005)
    for bm in (8, 16, 32):
        a, b = mine.plan_for(s1, bm), ref.plan_for(s2, bm)
        assert (a.max_batch, a.source, a.allow_fuse) == \
            (b.max_batch, b.source, b.allow_fuse), bm
        assert a.max_wait_s == pytest.approx(b.max_wait_s)
        assert (a.est_flush_s is None) == (b.est_flush_s is None)
        if a.est_flush_s is not None:
            assert a.est_flush_s == pytest.approx(b.est_flush_s)
    s2.close()


def test_slo_defaults_without_measurements():
    sched = _sched(max_batch=64, max_wait_s=0.004)
    slo = SLOController(0.05, table=TuningTable(), device_kind="cpu")
    slo.install(sched, m_max=16)
    for plan in slo.plans().values():
        assert plan.source == "default"
        assert (plan.max_batch, plan.max_wait_s) == (64, 0.004)
    assert sched._limits_for(8) == (64, 0.004)


def test_slo_ignores_heuristic_seeded_entries():
    table = TuningTable([TableEntry(
        key=TableKey(device_kind="cpu", backend="rgb", dtype="float32",
                     m_bucket=8, batch_bucket=0),
        tile=16, chunk=0, us_per_lp=1e9, source="heuristic-seed")])
    sched = _sched(max_batch=64, max_wait_s=0.004)
    slo = SLOController(0.05, table=table, device_kind="cpu")
    slo.install(sched, m_max=8)
    assert slo.plans()[8].source == "default"


def test_slo_allow_fuse_veto_from_next_rung_timing():
    table = TuningTable([
        TableEntry(key=TableKey(device_kind="cpu", backend="rgb",
                                dtype="float32", m_bucket=8,
                                batch_bucket=0),
                   tile=16, chunk=0, us_per_lp=50.0, source="measured"),
        TableEntry(key=TableKey(device_kind="cpu", backend="rgb",
                                dtype="float32", m_bucket=16,
                                batch_bucket=0),
                   tile=16, chunk=0, us_per_lp=1e5, source="measured"),
    ])
    sched = _sched(max_batch=256, max_wait_s=0.005)
    slo = SLOController(0.05, table=table, device_kind="cpu")
    slo.install(sched, m_max=16)
    plans = slo.plans()
    assert plans[8].allow_fuse is False
    assert plans[16].allow_fuse is True
    assert sched._fuse_ok(8) is False and sched._fuse_ok(16) is True


def test_slo_flush_estimate_divides_by_used_devices_only():
    sched = _sched(max_batch=256, max_wait_s=0.005, devices=CPU1 * 4)
    slo = SLOController(0.05, table=_measured_table(50.0),
                        device_kind="cpu")
    plan = slo.plan_for(sched, 8)
    assert plan.est_flush_s == pytest.approx(3.2e-3)
    assert plan.max_batch == 256


def test_slo_on_a_cpu_scheduler_reads_cpu_rows_only():
    """Without ``device_kind``, a CPU scheduler's plans look up the "cpu"
    rows (never a card's), so a bundled card table cannot plan it."""
    card = TuningTable([TableEntry(
        TableKey("nvidia-h100-80gb-hbm3", "rgb", "float32", m_bucket=8,
                 batch_bucket=0), tile=16, chunk=0, us_per_lp=50.0)])
    sched = _sched(max_batch=256, max_wait_s=0.005)
    assert SLOController(0.05, table=card).plan_for(sched, 8).source == \
        "default"
    assert SLOController(0.05, table=_measured_table(50.0)).plan_for(
        sched, 8).source == "measured"


def test_render_metrics_slo_and_sharding_families():
    from repro_torch.serve_lp.rpc.slo import BucketPlan
    m = ServeMetrics()
    m.record_flush(n_real=3, b_pad=16, bucket_m=16, sum_m=30,
                   solve_seconds=0.01, reason="fused", n_buckets=2,
                   launches=2, shards=(8, 8))
    plans = {8: BucketPlan(bucket_m=8, max_batch=32, max_wait_s=0.01,
                           est_flush_s=0.004, source="measured",
                           allow_fuse=False),
             16: BucketPlan(bucket_m=16, max_batch=64, max_wait_s=0.02,
                            est_flush_s=None, source="default")}
    text = render_metrics(m.snapshot(), slo=plans)
    validate_exposition(text)
    for line in (
            'repro_serve_slo_bucket_max_batch{bucket_m="8",'
            'source="measured"} 32',
            'repro_serve_slo_bucket_max_wait_seconds{bucket_m="16",'
            'source="default"} 0.02',
            'repro_serve_slo_bucket_allow_fuse{bucket_m="8",'
            'source="measured"} 0',
            'repro_serve_slo_bucket_allow_fuse{bucket_m="16",'
            'source="default"} 1',
            'repro_serve_slo_bucket_est_flush_seconds{bucket_m="16",'
            'source="default"} 0',
            "repro_serve_launches_total 2",
            "repro_serve_fused_flushes_total 1",
            "repro_serve_fused_buckets_total 2",
            'repro_serve_device_rows_total{device="0"} 8',
            'repro_serve_device_rows_total{device="1"} 8'):
        assert line in text, line
    # one snapshot renders to the same text in both packages
    snap = m.snapshot()
    assert render_metrics(snap, slo=plans) == rrpc.render_metrics(
        snap, slo=plans)


def test_metrics_endpoint_exposes_slo_plans(frontend_slo):
    _post(frontend_slo, _problem_json(*_lp()))
    resp = _get(frontend_slo, "/metrics")
    assert resp.status == 200
    text = resp.body.decode()
    validate_exposition(text)
    assert "repro_serve_slo_bucket_max_batch{" in text
    assert "repro_serve_slo_bucket_allow_fuse{" in text


def test_scheduler_per_bucket_policy_drives_size_trigger():
    with _sched(max_batch=64, max_wait_s=10.0) as sched:
        sched.set_bucket_policy(lambda bm: (2, 10.0))
        f1 = sched.submit(*_lp(seed=1))
        f2 = sched.submit(*_lp(seed=2))
        r1, r2 = f1.result(timeout=60), f2.result(timeout=60)
        assert r1.batch_size == 2 and r2.batch_size == 2
        assert sched.metrics.flush_reasons.get("size") == 1


# -- prometheus exposition -------------------------------------------------

def test_fresh_metrics_render_nan_free():
    m = ServeMetrics()
    assert m.percentile(99.0) == 0.0
    snap = m.snapshot({"hits": 0, "misses": 0, "size": 0, "hit_rate": 0.0})
    text = render_metrics(snap, rpc={"requests": {}, "shed": {},
                                     "inprogress": 0, "lps_accepted": 0},
                          quotas={})
    validate_exposition(text)
    samples = [ln for ln in text.splitlines()
               if ln and not ln.startswith("#")]
    assert samples and all(math.isfinite(float(ln.rsplit(" ", 1)[1]))
                           for ln in samples)


def test_metrics_endpoint_exposes_scheduler_and_rpc_counters(frontend):
    resp = _get(frontend, "/metrics")
    assert resp.status == 200
    validate_exposition(resp.body.decode())
    _post(frontend, _problem_json(*_lp()))
    _post(frontend, {"A": "garbage", "b": [1], "c": [1, 1]})
    resp = _get(frontend, "/metrics")
    text = resp.body.decode()
    validate_exposition(text)
    assert resp.content_type.startswith("text/plain; version=0.0.4")
    assert "repro_serve_solved_total 1" in text
    assert ('repro_serve_rpc_requests_total{code="200",'
            'endpoint="solve"} 1') in text
    assert ('repro_serve_rpc_requests_total{code="422",'
            'endpoint="solve"} 1') in text
    assert 'repro_serve_rpc_quota_admitted_total{tenant="anonymous"} 1' \
        in text


def test_health_and_ready(frontend):
    assert _get(frontend, "/healthz").status == 200
    assert _get(frontend, "/readyz").status == 200
    frontend.close()
    assert _get(frontend, "/healthz").status == 200
    assert _get(frontend, "/readyz").status == 503
    assert _post(frontend, _problem_json(*_lp())).status == 503


# -- scheduler edges the front end relies on --------------------------------

class _SlowExec:
    def __init__(self, delay):
        self.delay = delay

    def dispatch(self, L, c, mv):
        return (np.zeros((L.shape[0], 2), np.float32),
                np.zeros((L.shape[0],), bool))

    def complete(self, handle):
        time.sleep(self.delay)
        return handle


def test_drain_returns_false_on_timeout_then_true():
    sched = _sched(max_batch=2, max_wait_s=10.0)
    sched.cache = ExecutableCache(lambda spec: _SlowExec(0.4))
    futs = [sched.submit(*_lp(seed=s)) for s in (1, 2)]
    assert sched.drain(timeout=0.05) is False
    assert sched.drain(timeout=30.0) is True
    for f in futs:
        assert f.result(timeout=1).feasible is False
    sched.close()


def test_stop_records_drain_timeout(monkeypatch):
    sched = _sched(max_batch=8, max_wait_s=10.0)
    monkeypatch.setattr(sched, "drain", lambda timeout=600.0: False)
    with pytest.warns(RuntimeWarning, match="timed out draining"):
        sched.stop()
    assert sched.metrics.errors.get("drain_timeout") == 1


def test_cancelled_future_skipped_at_scatter():
    with _sched(max_batch=64, max_wait_s=10.0) as sched:
        f1 = sched.submit(*_lp(seed=1))
        f2 = sched.submit(*_lp(seed=2))
        assert f1.cancel()
        sched.flush()
        sched.drain()
        assert f2.result(timeout=60).feasible
        assert f1.cancelled()
        assert not sched.metrics.errors


def test_flush_claims_futures_so_cancel_cannot_race_completion():
    sched = _sched(max_batch=2, max_wait_s=10.0)
    sched.cache = ExecutableCache(lambda spec: _SlowExec(0.3))
    try:
        f1 = sched.submit(*_lp(seed=1))
        f2 = sched.submit(*_lp(seed=2))
        assert f1.cancel() is False
        assert f1.result(timeout=30) is not None
        assert f2.result(timeout=30) is not None
        assert not sched.metrics.errors
    finally:
        sched.close()


class _RacedFuture:
    def done(self):
        return False

    def set_result(self, value):
        raise InvalidStateError("cancelled")

    def set_exception(self, exc):
        raise InvalidStateError("cancelled")


def test_settle_tolerates_lost_cancel_race():
    from repro_torch.serve_lp.scheduler import (_try_set_exception,
                                                _try_set_result)
    assert _try_set_result(_RacedFuture(), 1) is False
    assert _try_set_exception(_RacedFuture(), ValueError("x")) is False


def test_make_frontend_needs_a_card_unless_told_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is the card")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_frontend(SPEC)
    f = _frontend()
    assert f.scheduler.n_devices == 1
    f.close()


def test_main_refuses_multi_host(monkeypatch):
    from repro_torch.serve_lp.rpc.__main__ import _maybe_init_distributed
    monkeypatch.delenv("SERVE_COORDINATOR", raising=False)
    _maybe_init_distributed()
    monkeypatch.setenv("SERVE_COORDINATOR", "10.0.0.1:1234")
    with pytest.raises(RuntimeError, match="multi-host"):
        _maybe_init_distributed()


# -- real socket -------------------------------------------------------------

def test_socket_roundtrip_smoke():
    import http.client
    f = _frontend(max_batch=4, max_wait_s=0.003)
    port, stop = run_in_thread(f)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        A, b, c = _lp()
        conn.request("POST", "/v1/solve", json.dumps(_problem_json(A, b, c)),
                     {"X-Tenant": "sock", "X-Deadline-Ms": "60000"})
        resp = conn.getresponse()
        assert resp.status == 200
        got = json.loads(resp.read())["result"]
        with _sched(max_batch=1) as direct:
            ref = direct.submit(A, b, c).result(timeout=60)
        np.testing.assert_array_equal(np.asarray(got["x"], np.float32),
                                      ref.x)
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        text = resp.read().decode()
        assert resp.status == 200
        validate_exposition(text)
        assert 'tenant="sock"' in text
        conn.request("GET", "/healthz")
        assert conn.getresponse().read() == b"ok\n"
        conn.request("POST", "/v1/solve", "{bad",
                     {"Content-Type": "application/json"})
        assert conn.getresponse().status == 400
        conn.close()
    finally:
        stop()
