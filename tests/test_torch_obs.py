"""The port's observability layer (``repro_torch.obs``) on the CPU: the
reference's own ``test_obs.py`` cases run on the port (span plumbing against
a real traced ``BatchScheduler`` on a CPU device, the trace context over a
real socket, the flight recorder on an injected flush failure, the
exporters, histograms, logs), the exporters held against the reference's on
the same spans, and ``ProfileSession`` over ``torch.profiler``.
"""
import dataclasses
import io
import json
import logging
import os
import threading
import time

import numpy as np
import pytest
import torch

import repro.obs.export as rexp
import repro.obs.trace as rtrace
import _torch_compat  # noqa: F401  (this worker's torch threads)
from repro_torch.obs import (FlightRecorder, NOOP_TRACER, SpanBuffer, Tracer,
                             check_span_chains, current_context, device_idle,
                             new_trace_context, parse_trace_header,
                             setup_logging, to_chrome_trace, use_context)
from repro_torch.obs.export import validate_chrome_trace, write_chrome_trace
from repro_torch.obs.log import JsonFormatter, TextFormatter
from repro_torch.obs.profiler import ProfileSession
from repro_torch.obs.trace import (Span, flush_membership, span_index,
                                   spans_for_trace)
from repro_torch.serve_lp import BatchScheduler, ExecutableCache, SolverSpec
from repro_torch.serve_lp.metrics import ServeMetrics
from repro_torch.serve_lp.rpc import (make_frontend, render_metrics,
                                      validate_exposition)
from repro_torch.serve_lp.rpc.server import run_in_thread

CPU1 = [torch.device("cpu")]
SPEC = SolverSpec(backend="rgb", tile=16, chunk=0)


def _lp(seed=0, m=8):
    rng = np.random.default_rng(seed)
    xstar = rng.uniform(-10, 10, 2)
    theta = rng.uniform(0, 2 * np.pi, m)
    A = np.stack([np.cos(theta), np.sin(theta)], -1).astype(np.float32)
    b = (A @ xstar + rng.uniform(0.1, 3.0, m)).astype(np.float32)
    phi = rng.uniform(0, 2 * np.pi)
    c = np.array([np.cos(phi), np.sin(phi)], np.float32)
    return A, b, c


def _sched(**kw):
    kw.setdefault("devices", CPU1)
    return BatchScheduler(SPEC, **kw)


def _as_ref(spans):
    """The same spans as the reference's ``Span`` type."""
    return [rtrace.Span(**dataclasses.asdict(s)) for s in spans]


# -- trace context / header ------------------------------------------------

def test_parse_trace_header():
    ctx = new_trace_context()
    got = parse_trace_header(ctx.trace_id)
    assert got is not None and got.trace_id == ctx.trace_id
    got = parse_trace_header(ctx.header_value())
    assert (got.trace_id, got.span_id) == (ctx.trace_id, ctx.span_id)
    for bad in (None, "", "xyz", "0" * 31, "0" * 33, "0" * 32 + "-zz",
                "0" * 32 + "-" + "0" * 15, "0" * 32 + "-" + "0" * 16
                + "-extra"):
        assert parse_trace_header(bad) is None, bad


def test_ring_wraparound():
    ring = SpanBuffer(capacity=4)
    for i in range(10):
        ring.append(Span("t" * 32, f"{i:016x}", None, "x",
                         t_start=float(i), t_end=float(i) + 0.5))
    assert (len(ring), ring.total, ring.dropped) == (4, 10, 6)
    assert [s.t_start for s in ring.snapshot()] == [6.0, 7.0, 8.0, 9.0]
    ring.clear()
    assert len(ring) == 0 and ring.snapshot() == []


def test_disabled_tracer_is_noop():
    tr = Tracer(enabled=False)
    s = tr.start_span("request", "a" * 32)
    assert s is None
    tr.end(s)
    assert tr.record("device.solve", "a" * 32, None, 0.0, 1.0) is None
    assert tr.stats()["spans_recorded"] == 0
    assert tr.stats()["spans_started"] == 0
    assert "noop_calls" not in tr.stats()
    assert NOOP_TRACER.enabled is False


# -- scheduler span chains -------------------------------------------------

def test_scheduler_span_chain_invariants():
    tracer = Tracer(enabled=True)
    with _sched(max_batch=4, max_wait_s=0.002, tracer=tracer) as sched:
        futs = [sched.submit(*_lp(i)) for i in range(8)]
        for f in futs:
            assert f.result(timeout=60.0).feasible
    spans = tracer.spans()
    report = check_span_chains(spans)
    assert report["complete"] == 8 and report["problems"] == []
    by_id = span_index(spans)
    for s in spans:
        if s.name == "queue.wait":
            parent = by_id[s.parent_id]
            assert parent.name == "request"
            assert parent.trace_id == s.trace_id
            assert s.t_start >= parent.t_start
    assert {"flush.assemble", "flush.dispatch", "device.solve",
            "flush.scatter"} <= {s.name for s in spans}
    for s in spans:
        if s.name.startswith("flush.") or s.name == "device.solve":
            assert s.attrs.get("flush")
    idle = device_idle(spans)
    assert idle["window_s"] > 0.0 and 0.0 <= idle["idle_frac"] <= 1.0
    # the exporters agree with the reference's on these spans
    ref = _as_ref(spans)
    assert to_chrome_trace(spans)["traceEvents"][1:] == \
        rexp.to_chrome_trace(ref)["traceEvents"][1:]
    assert device_idle(spans) == rexp.device_idle(ref)
    assert check_span_chains(spans) == rexp.check_span_chains(ref)


def test_fused_flush_membership_routes_all_traces():
    tracer = Tracer(enabled=True)
    with _sched(max_batch=64, max_wait_s=10.0, tracer=tracer) as sched:
        futs = ([sched.submit(*_lp(i, m=8)) for i in range(3)]
                + [sched.submit(*_lp(100 + i, m=64)) for i in range(3)])
        sched.flush()
        for f in futs:
            f.result(timeout=60.0)
    spans = tracer.spans()
    members = flush_membership(spans)
    fused = [name for name, tids in members.items() if len(tids) == 6]
    assert fused, f"no flush held all 6 traces: {members}"
    asm = next(s for s in spans if s.name == "flush.assemble"
               and s.attrs["flush"] == fused[0])
    assert asm.attrs["n_buckets"] >= 2
    for tid in members[fused[0]]:
        names = {s.name for s in spans_for_trace(spans, tid)}
        assert {"request", "queue.wait", "flush.assemble", "flush.dispatch",
                "device.solve", "flush.scatter"} <= names


def test_one_trace_across_flushes_checks_each_request_on_its_own():
    """A batch ``POST`` shares one trace id among LPs of different
    m-buckets, which land in different flushes.  Each request is held
    against the flush its own ``queue.wait`` names; the reference takes the
    trace's first flush for every request and reports the others."""
    tracer = Tracer(enabled=True)
    ctx = new_trace_context()
    with _sched(max_batch=64, max_wait_s=10.0, fuse=False,
                tracer=tracer) as sched:
        a = sched.submit(*_lp(1, m=8), trace=ctx)
        sched.flush()
        a.result(timeout=60.0)
        time.sleep(0.002)
        b = sched.submit(*_lp(2, m=64), trace=ctx)
        sched.flush()
        b.result(timeout=60.0)
    spans = tracer.spans()
    assert len(flush_membership(spans)) == 2
    mine = check_span_chains(spans)
    assert mine["complete"] == 2 and mine["problems"] == []
    ref = rexp.check_span_chains(_as_ref(spans))
    assert ref["complete"] == 2 and ref["problems"]     # the reference's


def test_untraced_scheduler_records_nothing():
    with _sched(max_batch=4, max_wait_s=0.002) as sched:
        futs = [sched.submit(*_lp(i)) for i in range(4)]
        for f in futs:
            f.result(timeout=60.0)
        stats = sched.tracer.stats()
    assert stats["enabled"] == 0
    assert stats["spans_recorded"] == 0 and stats["spans_started"] == 0


# -- RPC round trip ----------------------------------------------------------

def test_trace_id_roundtrip_over_socket():
    import http.client
    tracer = Tracer(enabled=True)
    f = make_frontend(SPEC, devices=CPU1, max_batch=4, max_wait_s=0.003,
                      tracer=tracer)
    port, stop = run_in_thread(f)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        A, b, c = _lp()
        body = json.dumps({"A": A.tolist(), "b": b.tolist(),
                           "c": c.tolist()})
        tid = "ab" * 16
        conn.request("POST", "/v1/solve", body,
                     {"X-Trace-Id": tid, "X-Deadline-Ms": "60000"})
        resp = conn.getresponse()
        assert resp.status == 200 and resp.getheader("X-Trace-Id") == tid
        resp.read()
        conn.request("POST", "/v1/solve", body, {"X-Deadline-Ms": "60000"})
        resp = conn.getresponse()
        minted = resp.getheader("X-Trace-Id")
        resp.read()
        assert minted and len(minted) == 32 and minted != tid
        conn.request("GET", f"/debug/trace?trace_id={tid}")
        resp = conn.getresponse()
        assert resp.status == 200
        obj = json.loads(resp.read())
        validate_chrome_trace(obj)
        assert obj["traceEvents"]
        conn.request("GET", f"/debug/trace?trace_id={tid}&format=spans")
        sp = json.loads(conn.getresponse().read())["spans"]
        by_name = {}
        for s in sp:
            by_name.setdefault(s["name"], []).append(s)
        handle = by_name["rpc.handle"][0]
        assert by_name["admit"][0]["parent_id"] == handle["span_id"]
        assert by_name["request"][0]["parent_id"] == handle["span_id"]
        conn.request("GET", "/debug/flight")
        assert conn.getresponse().status == 404    # no recorder
        conn.close()
    finally:
        stop()
    assert check_span_chains(tracer.spans())["problems"] == []


# -- flight recorder ----------------------------------------------------------

class _BadExe:
    def dispatch(self, L, c, mv):
        return None

    def complete(self, handle):
        raise RuntimeError("injected device failure")


def test_flight_recorder_triggers_on_flush_failure(tmp_path):
    tracer = Tracer(enabled=True)
    rec = FlightRecorder(str(tmp_path), tracer=tracer, min_interval_s=0.0)
    sched = _sched(max_batch=4, max_wait_s=0.002, tracer=tracer,
                   recorder=rec)
    sched.cache = ExecutableCache(lambda spec: _BadExe())
    with sched:
        futs = [sched.submit(*_lp(i)) for i in range(4)]
        for f in futs:
            with pytest.raises(RuntimeError):
                f.result(timeout=60.0)
    assert rec.stats()["written"] >= 1
    names = rec.list_snapshots()
    snap = rec.load_snapshot(names[0])
    assert snap["reason"].startswith("error:")
    assert snap["scheduler"]["n_devices"] >= 1
    assert any(s["name"] == "request" for s in snap["spans"])


def test_flight_recorder_debounce_prune_and_safety(tmp_path):
    rec = FlightRecorder(str(tmp_path), min_interval_s=3600.0,
                         max_snapshots=2)
    assert rec.trigger("one") is not None
    assert rec.trigger("two") is None
    assert rec.stats()["suppressed"] == 1
    rec._t_last_write = -1e9
    rec.trigger("two")
    rec._t_last_write = -1e9
    rec.trigger("three")
    assert len(rec.list_snapshots()) == 2
    assert rec.load_snapshot("../etc/passwd") is None
    assert rec.load_snapshot("nope.json") is None


def test_flight_recorder_p99_gate(tmp_path):
    rec = FlightRecorder(str(tmp_path), p99_threshold_s=0.1,
                         min_interval_s=0.0)
    rec.check_p99(0.05)
    assert rec.stats()["written"] == 0
    rec.check_p99(0.5)
    assert rec.stats()["written"] == 1
    assert "p99_threshold" in rec.list_snapshots()[0]
    snap = rec.load_snapshot(rec.list_snapshots()[0])
    assert snap["extra"]["p99_s"] == 0.5


# -- exporters ----------------------------------------------------------------

def _schema_spans():
    tr = Tracer(enabled=True)
    ctx = new_trace_context()
    r = tr.start_span("request", ctx.trace_id, ctx.span_id, bucket_m=8)
    q = tr.start_span("queue.wait", ctx.trace_id, r.span_id)
    tr.end(q)
    tr.end(r)
    tr.record("device.solve", ctx.trace_id, None, 0.0, 1.0, flush="f1",
              devices=(0, 1), bucket_m=8)
    tr.record("flush.assemble", ctx.trace_id, None, 0.0, 0.5, flush="f1",
              bucket_m=8, trace_ids=(ctx.trace_id,))
    return tr.spans()


def test_chrome_trace_schema(tmp_path):
    spans = _schema_spans()
    obj = to_chrome_trace(spans)
    validate_chrome_trace(obj)
    assert {"X", "M"} <= {e["ph"] for e in obj["traceEvents"]}
    # the same events as the reference's exporter (the process name
    # names the package)
    ref = rexp.to_chrome_trace(_as_ref(spans))
    assert obj["traceEvents"][1:] == ref["traceEvents"][1:]
    assert obj["traceEvents"][0]["args"]["name"] == "repro_torch.serve_lp"
    p = tmp_path / "t.json"
    write_chrome_trace(spans, str(p))
    assert json.loads(p.read_text()) == json.loads(json.dumps(obj))
    for bad in ({"traceEvents": [{"ph": "X"}]}, {"nope": 1},
                {"traceEvents": [{"ph": "e", "pid": 1, "name": "x",
                                  "ts": 0, "id": "a"}]}):
        with pytest.raises(ValueError):
            validate_chrome_trace(bad)
    assert to_chrome_trace([]) == {"traceEvents": [],
                                   "displayTimeUnit": "ms"}


def test_device_idle_matches_reference_and_counts_unions():
    tr = Tracer(enabled=True)
    for lo, hi, devs in ((0.0, 1.0, (0,)), (0.5, 1.5, (0,)), (3.0, 4.0, (0,)),
                         (0.0, 4.0, (1,))):
        tr.record("device.solve", "a" * 32, None, lo, hi, flush="f",
                  devices=devs)
    spans = tr.spans()
    got = device_idle(spans)
    assert got == rexp.device_idle(_as_ref(spans))
    assert got["devices"]["0"]["busy_s"] == pytest.approx(2.5)
    assert got["devices"]["1"]["idle_frac"] == pytest.approx(0.0)
    assert got["idle_frac"] == pytest.approx(1.0 - 6.5 / 8.0)
    assert device_idle([])["idle_frac"] == 0.0


def test_histogram_exposition_grammar():
    m = ServeMetrics()
    for i in range(40):
        m.record_latency(0.001 * (i + 1), trace_id=f"{i:032x}")
        m.record_queue_wait(0.0005 * (i + 1))
    m.record_flush(bucket_m=8, n_real=4, b_pad=16, sum_m=32,
                   solve_seconds=0.01, assemble_seconds=0.002,
                   reason="size", trace_id="ab" * 16)
    body = render_metrics(m.snapshot(), rpc=None, quotas=None,
                          trace=Tracer(enabled=True).stats())
    validate_exposition(body)
    assert 'le="+Inf"' in body
    assert "request_latency_seconds_bucket" in body
    assert '# {trace_id="' in body
    assert "repro_serve_trace_enabled 1" in body
    for bad in ('# TYPE h histogram\nh_bucket{le="1"} 5\n'
                'h_bucket{le="+Inf"} 3\nh_sum 1\nh_count 3\n',
                '# TYPE h histogram\nh_bucket{le="+Inf"} 5\nh_count 5\n',
                'x_bucket{le="1"} 3 # malformed 1.0\n'):
        with pytest.raises(ValueError):
            validate_exposition(bad)


def test_snapshot_consistent_under_concurrent_records():
    m = ServeMetrics()
    stop = threading.Event()

    def hammer():
        i = 0
        while not stop.is_set():
            m.record_latency(0.001 * (i % 100 + 1))
            i += 1

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        deadline = time.perf_counter() + 0.5
        while time.perf_counter() < deadline:
            snap = m.snapshot()
            assert snap["latency_p50_ms"] <= snap["latency_p99_ms"]
            assert 0.0 <= snap["latency_p99_ms"] <= 101.0
            h = snap["histograms"]["request_latency_seconds"]
            assert h["count"] == h["cumulative"][-1]
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)


# -- structured logging -------------------------------------------------------

def test_json_log_formatter_binds_trace_context():
    stream = io.StringIO()
    logger = logging.getLogger("repro_torch.test.obs.json")
    logger.propagate = False
    handler = setup_logging(fmt="json", stream=stream, logger=logger)
    try:
        with use_context(trace_id="ab" * 16, tenant="acme"):
            logger.info("flush %d done", 7, extra={"flush": "f-7"})
        logger.warning("outside")
    finally:
        logger.removeHandler(handler)
    lines = [json.loads(line) for line in stream.getvalue().splitlines()]
    assert lines[0]["msg"] == "flush 7 done"
    assert lines[0]["trace_id"] == "ab" * 16
    assert lines[0]["tenant"] == "acme"
    assert lines[0]["flush"] == "f-7"
    assert lines[0]["level"] == "INFO"
    assert "trace_id" not in lines[1]
    assert current_context() == {}
    # a second call replaces its own handler instead of stacking one
    h2 = setup_logging(fmt="text", stream=io.StringIO(), logger=logger)
    assert [h.get_name() for h in logger.handlers].count(
        h2.get_name()) == 1
    logger.removeHandler(h2)


def test_text_formatter_and_setup_validation():
    rec = logging.LogRecord("x", logging.INFO, __file__, 1, "hello", None,
                            None)
    plain = TextFormatter().format(rec)
    assert "hello" in plain and "trace=" not in plain
    with use_context(trace_id="cd" * 16):
        assert "trace=" + "cd" * 16 in TextFormatter().format(rec)
    with pytest.raises(ValueError):
        setup_logging(fmt="xml")
    out = JsonFormatter().format(logging.LogRecord(
        "x", logging.INFO, __file__, 1, "obj %s", (object(),), None))
    assert json.loads(out)["level"] == "INFO"


# -- the profiler session -----------------------------------------------------

def test_profile_session_writes_a_trace_and_tolerates_double_stop(tmp_path):
    d = tmp_path / "prof"
    p = ProfileSession(str(d))
    assert p.stop() is False                   # never started
    assert p.start() is True and p.active
    assert p.start() is False                  # already running
    torch.ones(64).cumsum(0)
    assert p.stop() is True and not p.active
    assert p.stop() is False                   # double stop
    assert os.path.isfile(p.trace_path)
    assert os.path.dirname(p.trace_path) == str(d)
    assert "traceEvents" in json.loads(open(p.trace_path).read())
    with ProfileSession(None) as off:
        assert off.active is False
    assert off.trace_path is None
