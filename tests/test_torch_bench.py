"""The port's serving benchmark (``repro_torch.serve_lp.bench``) on the CPU.

Its request generators are the reference's, draw for draw, so request
``i`` of seed ``s`` must equal the reference's in bits.  Each mode the
reference's CI runs (the smoke traffic, ``--open-loop``, ``--assert-fused``,
``--trace-out --assert-trace`` and ``--rpc --assert-rpc``) runs here on
``devices=[cpu]`` with its own assertions, the trace mode on four CPU
"devices" to the reference's bar of two non-empty ``device.solve`` tracks.
``--assert-overlap`` is not reachable on the port's devices: the open loop's
gauges are checked instead.  ``--sharding pmap`` raises the reference's
``ValueError``.  The direct-solve check fails on a corrupted answer.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.serve_lp import bench as rbench
import _torch_compat  # noqa: F401  (this worker's torch threads)
from repro_torch.serve_lp import bench
from repro_torch.serve_lp import BatchScheduler

CPU1 = [torch.device("cpu")]
CPU4 = CPU1 * 4


@pytest.mark.parametrize("seed", [0, 3, 20190213])
@pytest.mark.parametrize("smoke", [False, True])
def test_make_request_equals_the_reference_in_bits(seed, smoke):
    mk = bench.smoke_config if smoke else bench.BenchConfig
    rmk = rbench.smoke_config if smoke else rbench.BenchConfig
    cfg, rcfg = mk(), rmk()
    cfg.seed = rcfg.seed = seed
    kinds = set()
    for i in range(128):
        got, want = bench.make_request(cfg, i), rbench.make_request(rcfg, i)
        for g, w in zip(got[:3], want[:3]):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.tobytes() == w.tobytes()
        assert got[3] == want[3]
        kinds.add(got[3])
    assert kinds == set(bench.KINDS)


def _tiny(**kw):
    """The reference's test_bench_smoke_tiny configuration."""
    return bench.BenchConfig(requests=24, rate=1e6, m_max=64, max_batch=8,
                             max_wait_s=0.005, tile=8, check=3,
                             warmup=False, **kw)


def test_run_traffic_tiny_matches_the_reference():
    snap, sched = bench.run_traffic(_tiny(), quiet=True, devices=CPU1)
    assert snap["n_solved"] == 24
    assert snap["cache"]["misses"] >= 1
    assert 0.0 <= snap["padding_waste_cells"] < 1.0
    assert np.isfinite(snap["latency_p99_ms"])
    # pipelined loop fully quiesced, every dispatch completed
    assert snap["inflight_now"] == 0
    assert snap["n_dispatched"] == snap["n_flushes"]
    assert snap["errors"] == {}
    # the no-trace contract
    assert sched.tracer.stats()["spans_recorded"] == 0
    ref = dataclasses.asdict(_tiny())
    rsnap, _ = rbench.run_traffic(rbench.BenchConfig(**ref), quiet=True)
    assert snap["n_feasible"] == rsnap["n_feasible"]


@pytest.mark.parametrize("method", ["rgb", "kernel"])
def test_open_loop_overlap(method):
    """The open loop's pipeline gauges.  The pipelined loop stays within
    its in-flight bound and drains; the stop-and-go loop never has two
    flushes in flight, so ``--assert-overlap`` raises there.  (A CPU device
    solves a flush inside its dispatch, so the pipelined loop does not
    overlap here either: the assertion is not reachable on the port's
    devices.)"""
    argv = ["--smoke", "--method", method, "--open-loop"]
    snap, sched = bench.main(argv, devices=CPU1, quiet=True)
    assert snap["n_solved"] == 160
    assert 1 <= snap["inflight_max"] <= sched.max_inflight == 2
    assert snap["inflight_now"] == 0
    assert snap["n_dispatched"] == snap["n_flushes"]
    assert sched.tracer.stats()["spans_recorded"] == 0
    snap, _ = bench.main(argv + ["--no-pipeline"], devices=CPU1, quiet=True)
    assert snap["n_solved"] == 160
    assert snap["inflight_max"] == 1 and snap["overlapped_dispatches"] == 0
    with pytest.raises(AssertionError, match="pipelining"):
        bench.main(argv + ["--no-pipeline", "--assert-overlap"],
                   devices=CPU1, quiet=True)


def test_open_loop_fused():
    snap, _ = bench.main(["--smoke", "--open-loop", "--assert-fused"],
                         devices=CPU1, quiet=True)
    assert snap["fused_flushes"] >= 1 and snap["fused_buckets"] >= 2


def test_trace_on_four_devices(tmp_path):
    from repro_torch.obs.export import validate_chrome_trace
    out = tmp_path / "trace.json"
    snap, sched = bench.main(["--smoke", "--open-loop", "--trace-out",
                              str(out), "--assert-trace"], devices=CPU4,
                             quiet=True)
    assert len(snap["device_tracks"]) >= 2
    assert snap["trace_complete_chains"] >= 160
    assert snap["trace_problems"] == 0
    assert 0.0 <= snap["device_idle_frac"] <= 1.0
    assert snap["device_idle_is"].startswith("lower bound")
    validate_chrome_trace(json.loads(out.read_text()))
    assert sched.tracer.stats()["spans_recorded"] > 0


def test_assert_trace_needs_two_tracks_where_two_devices_are_held():
    cfg = dataclasses.replace(bench.smoke_config(), requests=8, m_max=8,
                              max_batch=4, tile=4, open_loop=True,
                              assert_trace=True, warmup=False, check=0)
    # one bucket (m = 8), flushes of at most 4 rows: each is one tile, so
    # device 0 alone solves them
    with pytest.raises(AssertionError, match="device.solve tracks"):
        bench.run_traffic(cfg, quiet=True, devices=CPU4)
    snap, _ = bench.run_traffic(cfg, quiet=True, devices=CPU1)
    assert list(snap["device_tracks"]) == ["0"]


def test_pmap_raises_the_references_value_error():
    with pytest.raises(ValueError, match="sharding"):
        bench.main(["--smoke", "--sharding", "pmap"], devices=CPU1,
                   quiet=True)


def test_rpc_tiny_assert_rpc(monkeypatch):
    # The burst tenant's quota is shrunk so the overload phase sheds however
    # slowly a loaded CPU answers (the reference's 200 LP/s needs 16 posts
    # answered within 80 ms each).
    monkeypatch.setattr(bench, "BURST_QUOTA", (1.0, 8.0))
    report, sched = bench.main(
        ["--requests", "48", "--m-max", "32", "--max-batch", "8",
         "--max-wait-ms", "5", "--tile", "8", "--check", "4", "--rpc",
         "--rpc-burst", "160", "--rpc-target-p99-ms", "50",
         "--assert-rpc"], devices=CPU1, quiet=True)
    assert report["closed_loop"]["ok"] == 48
    assert report["overload"]["shed_429"] >= 1
    assert report["overload"]["other"] == 0
    assert report["metrics_valid"] and report["slo"]
    assert sched.cache.uses()


def test_check_against_direct_fails_on_a_corrupted_answer():
    cfg = _tiny()
    with BatchScheduler(bench._spec(cfg), max_batch=cfg.max_batch,
                        devices=CPU1) as sched:
        futs = [sched.submit(*bench.make_request(cfg, i)[:3])
                for i in range(cfg.requests)]
    results = [f.result(timeout=60.0) for f in futs]
    bench._check_against_direct(cfg, results, CPU1[0])
    checked = np.linspace(0, cfg.requests - 1, cfg.check).astype(int)
    i = next(int(i) for i in checked if results[i].feasible)
    for bad in (dataclasses.replace(results[i], x=results[i].x + 1e-3),
                dataclasses.replace(results[i], feasible=False)):
        corrupted = results[:i] + [bad] + results[i + 1:]
        with pytest.raises(AssertionError):
            bench._check_against_direct(cfg, corrupted, CPU1[0])
