"""The port's spans while a profiler records, on the CPU: the process
default tracer records exactly while a ``torch.profiler`` session does, the
solver front end's stages and the served chain land in one ring with the
right parents, and ``ProfileSession`` writes one trace that holds every
thread's twins of the spans (``repro_torch.<name>`` ranges) and the ring's
cross-thread spans on the trace's clock.
"""
import json
import threading

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler

import _torch_compat  # noqa: F401  (this worker's torch threads)
from repro_torch.core.lp import make_batch
from repro_torch.obs import check_span_chains, default_tracer
from repro_torch.obs.export import validate_chrome_trace
from repro_torch.obs.profiler import ProfileSession
from repro_torch.obs.trace import TWIN_PREFIX, span_index
from repro_torch.serve_lp import BatchScheduler, SolverSpec

CPU1 = [torch.device("cpu")]
STAGES = ("solve.cast", "solve.normalize", "solve.pack", "solve.pad",
          "solve.launch", "solve.objective")


@pytest.fixture(autouse=True)
def default_ring():
    """Each test starts and leaves the process default ring empty (one
    xdist worker runs many files, and others assert it records nothing)."""
    tr = default_tracer()
    tr.reset()
    yield tr
    tr.reset()


def _lp(seed, m=8):
    rng = np.random.default_rng(seed)
    xstar = rng.uniform(-10, 10, 2)
    theta = rng.uniform(0, 2 * np.pi, m)
    A = np.stack([np.cos(theta), np.sin(theta)], -1).astype(np.float32)
    b = (A @ xstar + rng.uniform(0.1, 3.0, m)).astype(np.float32)
    c = np.array([np.cos(seed), np.sin(seed)], np.float32)
    return A, b, c


def _batch(n=16, m=8):
    As, bs, cs = zip(*(_lp(i, m) for i in range(n)))
    return make_batch(np.stack(As), np.stack(bs), np.stack(cs), device="cpu")


def _cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def test_the_profiler_flag_is_there_and_process_wide():
    """The default tracer reads this flag; it must exist and be seen by
    every thread (the thread-local ``_profiler_enabled`` is not)."""
    assert autograd_profiler._is_profiler_enabled is False
    seen = []
    with _cpu_profile():
        t = threading.Thread(
            target=lambda: seen.append(autograd_profiler._is_profiler_enabled))
        t.start()
        t.join()
        assert default_tracer().enabled
    assert seen == [True]
    assert autograd_profiler._is_profiler_enabled is False
    assert not default_tracer().enabled


def test_untraced_solve_and_serve_start_no_span(default_ring):
    solver = SolverSpec(backend="kernel").build(device="cpu")
    solver.solve(_batch())
    with BatchScheduler(SolverSpec(backend="kernel"), max_batch=8,
                        max_wait_s=0.002, devices=CPU1) as sched:
        futs = [sched.submit(*_lp(i)) for i in range(100)]
        for f in futs:
            f.result(timeout=60.0)
    assert sched.tracer is default_ring
    assert default_ring.spans_started == 0
    assert default_ring.spans() == []


def test_solve_stages_under_the_profiler(default_ring):
    solver = SolverSpec(backend="kernel").build(device="cpu")
    with _cpu_profile():
        sol = solver.solve(_batch())
    assert bool(sol.feasible.all())
    spans = default_ring.spans()
    top = [s for s in spans if s.name == "solve"]
    assert len(top) == 1 and top[0].parent_id is None
    assert top[0].attrs["B"] == 16 and top[0].attrs["backend"] == "kernel"
    kids = [s for s in spans if s.parent_id == top[0].span_id]
    assert [s.name for s in kids] == list(STAGES)
    for a, b in zip(kids, kids[1:]):
        assert top[0].t_start <= a.t_start <= a.t_end <= b.t_start
    assert kids[-1].t_end <= top[0].t_end
    solver.solve(_batch())                 # after the profile: nothing
    assert len(default_ring.spans()) == len(spans)


def test_served_chain_under_the_profiler(default_ring):
    sched = BatchScheduler(SolverSpec(backend="kernel"), max_batch=4,
                           max_wait_s=60.0, devices=CPU1)
    with _cpu_profile():
        futs = [sched.submit(*_lp(i)) for i in range(6)]
        sched.flush()
        for f in futs:
            f.result(timeout=60.0)
    sched.close()
    spans = default_ring.spans()
    report = check_span_chains(spans)
    assert report["complete"] == 6 and report["problems"] == []
    by_id = span_index(spans)
    names = [s.name for s in spans]
    assert names.count("submit") == 6
    # the size-triggered flush ran inline: its assembly is under a submit
    asm = [s for s in spans if s.name == "flush.assemble"]
    assert {s.attrs["reason"] for s in asm} == {"size", "manual"}
    inline = next(s for s in asm if s.attrs["reason"] == "size")
    assert by_id[inline.parent_id].name == "submit"
    for s in spans:
        if s.name == "solve":
            assert by_id[s.parent_id].name == "flush.dispatch"
        if s.name.startswith("solve."):
            assert by_id[s.parent_id].name == "solve"
        if s.name == "flush.dispatch":
            assert s.attrs["inflight_wait_ms"] >= 0.0
        if s.name == "device.solve":
            assert "device_ms" not in s.attrs        # no events on the CPU
    assert names.count("solve") == len(asm) == 2
    # after the profile nothing more is recorded
    n = len(spans)
    with BatchScheduler(SolverSpec(backend="kernel"), max_batch=4,
                        devices=CPU1) as again:
        for f in [again.submit(*_lp(i)) for i in range(4)]:
            f.result(timeout=60.0)
    assert len(default_ring.spans()) == n


def test_a_span_begun_while_recording_is_kept(default_ring):
    with _cpu_profile():
        s = default_ring.start_span("request", "a" * 32)
        kid = default_ring.child(s, "queue.wait")
    assert s is not None and not default_ring.enabled
    default_ring.end(kid)
    default_ring.end(s)
    assert [x.name for x in default_ring.spans()] == ["queue.wait",
                                                      "request"]
    assert default_ring.start_span("request", "b" * 32) is None


def test_profile_session_puts_every_thread_on_one_clock(tmp_path,
                                                        default_ring):
    sched = BatchScheduler(SolverSpec(backend="kernel"), max_batch=64,
                           max_wait_s=0.002, devices=CPU1).start()
    session = ProfileSession(str(tmp_path))
    assert session.start()
    futs = [sched.submit(*_lp(i)) for i in range(12)]
    for f in futs:
        f.result(timeout=60.0)
    assert session.stop()
    sched.close()
    trace = json.loads(open(session.trace_path).read())
    validate_chrome_trace(trace)
    events = trace["traceEvents"]
    twins = [e for e in events if e.get("ph") == "X"
             and str(e.get("name", "")).startswith(TWIN_PREFIX)]
    main = threading.get_native_id()
    # wait-triggered flushes run on the flush thread, and are in the trace
    asm = [e for e in twins if e["name"] == TWIN_PREFIX + "flush.assemble"]
    assert asm and all(e["tid"] != main for e in asm)
    # each same-thread span's twin starts where the anchor places the span
    spans = default_ring.spans()
    placed = 0
    for name in {s.name for s in spans if s.has_twin}:
        mine = sorted(session.trace_us(s.t_start) for s in spans
                      if s.name == name and s.has_twin)
        theirs = sorted(e["ts"] for e in twins
                        if e["name"] == TWIN_PREFIX + name)
        assert len(mine) == len(theirs), name
        for a, b in zip(mine, theirs):
            assert abs(a - b) < 500.0, (name, a, b)
            placed += 1
    assert placed >= 12 * 1 + 3 * len(asm)
    # the cross-thread spans were added, on their own track
    added = {e["name"] for e in events if e.get("cat") == "request"}
    assert {"request", "queue.wait"} <= added
    assert any(e.get("name") == "device.solve" for e in events)
