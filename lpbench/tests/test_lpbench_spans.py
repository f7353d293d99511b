"""The readers of the program's own spans: each gives a number on a traced
CPU run of its cell (``flush_enqueue_ms.p99`` none: no CUDA events on
the CPU), and ``None`` where the run recorded no spans, where the ring dropped
some, or where the program has no default tracer to read."""
from __future__ import annotations

import json
import math
import time

import pytest
from conftest import ROOT, last_json

from lpbench import drivers, run, spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SPAN_METRICS = ("queue_wait_ms.p99", "post_wait_ms.p99",
                "flush_enqueue_ms.p99", "passes_host_ms.lps",
                "launch_host_ms.lps")
# By the loop a cell's mix names, so that a cell added as data is covered.
ON_THE_CPU = {"serve_open": {"queue_wait_ms.p99", "post_wait_ms.p99"},
              "batch_closed": {"passes_host_ms.lps", "launch_host_ms.lps"}}
HOST_CLOCKED = {"serve_open": {"submit_us.p99", "flush_lps.p99"},
                "batch_closed": {"call_host_ms.lps"}}


@pytest.fixture(autouse=True)
def default_ring():
    """An empty process default ring before and after each test."""
    from repro_torch.obs import default_tracer
    tr = default_tracer()
    tr.reset()
    yield tr
    tr.reset()


def _main(root, capsys, cell, trace):
    rc = run.main(["--workload", cell, "--seed", "3141592653",
                   "--seconds", "0.3", "--trace", str(trace)], device="cpu",
                  root=root)
    assert rc == 0
    return last_json(capsys.readouterr().out)


def _run(cell=CELLS[0]):
    return drivers.Run.of(spec.find_cell(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_span_readers_read_a_traced_cpu_run(small_root, capsys, cell):
    out = _main(small_root, capsys, cell, 1)
    assert out["correct"] is True, out["checks"]
    got = {k: v["value"] for k, v in out["metrics"].items()
           if k in SPAN_METRICS}
    loop = spec.find_cell(cell, small_root).traffic["loop"]
    assert set(got) == ON_THE_CPU[loop]
    for k, v in got.items():
        assert math.isfinite(v) and v > 0, (k, v)
        assert out["metrics"][k]["unit"] == "ms"
    # the per-layer metrics read on the CPU before are still there
    assert HOST_CLOCKED[loop] <= set(out["metrics"])


@pytest.mark.parametrize("cell", CELLS)
def test_the_untraced_line_keeps_its_keys(small_root, capsys, cell):
    out = _main(small_root, capsys, cell, 0)
    wanted = {m["name"] for m in BENCH["end_to_end"]
              if "workloads" not in m or cell in m["workloads"]}
    assert set(out["metrics"]) == wanted
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_no_spans_no_reading(metric, default_ring, monkeypatch):
    read = spec.reader(metric)
    assert read(_run()) is None                     # nothing recorded
    # a ring that dropped spans is not read
    from repro_torch.obs import Tracer
    small = Tracer(capacity=2)
    for i in range(3):
        small.record("solve", "a" * 32, None, float(i), i + 0.5)
    monkeypatch.setattr(default_ring, "buffer", small.buffer)
    assert read(_run()) is None
    # a program without the default tracer (the commit before it)
    import repro_torch.obs
    monkeypatch.delattr(repro_torch.obs, "default_tracer")
    assert read(_run()) is None


def test_serving_readers_select_requests_by_submit_time(default_ring):
    """The serving readers take the requests submitted at least five
    ``max_wait_s`` before the profiler stopped, whenever they ended: a
    late answer counts, a request never answered reads as infinite, and a
    request submitted just before the cut is left out whatever its wait."""
    import torch

    from lpbench import spans
    run = _run("servemix.open")
    tr = default_ring
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        now = time.perf_counter()
        reqs = {}
        for k, ago in (("slow", 2.0), ("fast", 1.0), ("lost", 1.5),
                       ("late", 0.05)):
            r = tr.start_span("request", k[0] * 32, t_start=now - ago)
            reqs[k] = (r, tr.child(r, "queue.wait", t_start=now - ago))
        for k, wait in (("fast", 0.01), ("lost", 0.01), ("late", 0.001)):
            tr.end(reqs[k][1], t_end=reqs[k][1].t_start + wait)
        tr.end(reqs["fast"][0], t_end=reqs["fast"][1].t_end + 0.002,
               feasible=True)
        tr.end(reqs["late"][0], feasible=True)
        flush = tr.start_span("flush.assemble", "f" * 32)
        tr.end(tr.child(flush, "device.solve", t_start=now - 1.0),
               enqueue_ms=2.0)
        tr.end(tr.start_span("submit", "s" * 32, twin=True))
        after = tr.child(flush, "device.solve")
    # answered after the profiler stopped, with a long wait
    tr.end(reqs["slow"][1])
    tr.end(reqs["slow"][0], feasible=True)
    tr.end(after, enqueue_ms=50.0)
    waits = sorted(spans.queue_wait_ms(run))
    assert len(waits) == 3 and waits[-1] > 1900.0      # slow, lost, fast
    post = spans.post_wait_ms(run)
    assert len(post) == 3 and post.count(float("inf")) == 1     # lost
    assert spans.p99(post) is None
    assert spans.flush_enqueue_ms(run) == [2.0]
