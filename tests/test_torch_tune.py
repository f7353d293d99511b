"""The port's tuner (``repro_torch.tune``: table, candidate space, runner) on
the CPU: the reference's own ``test_tune.py`` cases run on the port, and the
parts both packages share held against the reference (candidate grids,
table JSON, winners per backend).

Timings here are CPU timings of the port's plain paths: they test that the
runner measures and records, never a speed.  The tuning table's rows for a
card are measured on the card by ``scripts/tune_table.py``.
"""
import json

import jax
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.tune as rt
from repro_torch.kernels.batch_lp import LANE, WARPS_PER_CTA, launch_geometry
from repro_torch.pdhg import DEFAULT_ITER_BLOCK, DEFAULT_RESTART_PERIOD
from repro_torch.solver import SolverSpec, solve_with_spec
from repro_torch.tune import (Candidate, TableEntry, TableKey, TuneResult,
                              TuningTable, bucket_pow2, candidate_space,
                              check_round_trip, current_device_kind,
                              default_backends, default_table,
                              device_platform, heuristic_candidate, measure,
                              measure_stats, measure_stats_many,
                              normalize_device_kind,
                              representative_batch, results_to_entries,
                              set_active_table, tune, tune_shape, use_table,
                              winner_entries)
from repro_torch.tune.table import SCHEMA_VERSION
from _torch_compat import CPU, to_torch_batch


def _key(device="cpu", backend="rgb", dtype="float32", m_bucket=32,
         batch_bucket=16):
    return TableKey(device, backend, dtype, m_bucket, batch_bucket)


def _entry(tile=16, chunk=64, us=1.0, us_iqr=0.0, k=1, **kw):
    return TableEntry(_key(**kw), tile=tile, chunk=chunk, us_per_lp=us,
                      us_iqr=us_iqr, k=k)


# -- table semantics ------------------------------------------------------

def test_bucket_pow2_ladder():
    for x in (1, 8, 9, 700, 4096):
        assert bucket_pow2(x, 8) == rt.bucket_pow2(x, 8)
    assert [bucket_pow2(x, 8) for x in (1, 8, 9, 700)] == [8, 8, 16, 1024]
    with pytest.raises(ValueError):
        bucket_pow2(0, 8)


def test_device_kind_normalisation():
    for name in ("TPU v4", "  NVIDIA  A100 ", "cpu", "TPU v5 lite"):
        assert normalize_device_kind(name) == rt.normalize_device_kind(name)
    assert device_platform("TPU v5 lite") == "tpu"
    assert device_platform("cpu") == "cpu"
    assert device_platform("NVIDIA H100 80GB HBM3") == "gpu"
    assert _key(device="TPU v4").device_kind == "tpu-v4"


def test_table_put_get_lookup_buckets():
    t = TuningTable([_entry()])
    assert t.get(_key()) is not None
    hit = t.lookup(backend="rgb", dtype="float32", m=21, batch=9,
                   device_kind="cpu")
    assert hit is not None and (hit.tile, hit.chunk) == (16, 64)
    for kw in (dict(m=500), dict(backend="naive"), dict(dtype="float64"),
               dict(device_kind="tpu-v4")):
        q = dict(backend="rgb", dtype="float32", m=21, batch=9,
                 device_kind="cpu")
        q.update(kw)
        assert t.lookup(**q) is None, kw


def test_table_lookup_fallbacks():
    fam = TuningTable([_entry(device="gpu", tile=64, chunk=0)])
    hit = fam.lookup(backend="rgb", dtype="float32", m=21, batch=9,
                     device_kind="NVIDIA H100 80GB HBM3")
    assert hit is not None and hit.tile == 64
    both = TuningTable([_entry(device="gpu", tile=64, chunk=0),
                        _entry(device="nvidia-h100-80gb-hbm3", tile=8,
                               chunk=0)])
    assert both.lookup(backend="rgb", dtype="float32", m=21, batch=9,
                       device_kind="NVIDIA H100 80GB HBM3").tile == 8
    wild = TuningTable([_entry(batch_bucket=0, tile=128, chunk=0)])
    assert wild.lookup(backend="rgb", dtype="float32", m=21,
                       device_kind="cpu").tile == 128
    assert wild.lookup(backend="rgb", dtype="float32", m=21, batch=4096,
                       device_kind="cpu").tile == 128


def test_table_merge_keeps_faster():
    slow = TuningTable([_entry(tile=8, us=9.0)])
    fast = TuningTable([_entry(tile=16, us=2.0)])
    assert slow.merge(fast).get(_key()).tile == 16
    assert fast.merge(TuningTable([_entry(tile=8, us=9.0)])) \
        .get(_key()).tile == 16
    other = TuningTable([_entry(m_bucket=64, tile=32, us=1.0)])
    assert len(fast.merge(other)) == 2


def test_table_merge_rejects_improvements_inside_noise_band():
    incumbent = TuningTable([_entry(tile=16, us=10.0, us_iqr=2.0, k=5)])
    incumbent.merge(TuningTable([_entry(tile=8, us=9.0, us_iqr=0.1,
                                        k=5)]))
    assert incumbent.get(_key()).tile == 16
    incumbent.merge(TuningTable([_entry(tile=8, us=8.5, us_iqr=3.0,
                                        k=5)]))
    assert incumbent.get(_key()).tile == 16
    incumbent.merge(TuningTable([_entry(tile=8, us=7.5, us_iqr=0.1,
                                        k=5)]))
    assert incumbent.get(_key()).tile == 8
    legacy = TuningTable([_entry(tile=16, us=10.0)])
    legacy.merge(TuningTable([_entry(tile=8, us=9.99)]))
    assert legacy.get(_key()).tile == 8


def test_table_merge_measured_vs_seed_precedence():
    seed = TableEntry(_key(), tile=32, chunk=64, us_per_lp=0.001,
                      source="heuristic-seed")
    t = TuningTable([seed])
    t.merge(TuningTable([_entry(tile=8, us=100.0, us_iqr=5.0, k=3)]))
    assert t.get(_key()).source == "measured" and t.get(_key()).tile == 8
    t.merge(TuningTable([seed]))
    assert t.get(_key()).source == "measured"


def test_entry_stats_fields_and_json_roundtrip(tmp_path):
    e = _entry(us=2.0, us_iqr=0.25, k=7)
    assert e.noise_band_us == 0.25
    with pytest.raises(ValueError):
        _entry(us_iqr=-0.1)
    with pytest.raises(ValueError):
        _entry(k=0)
    t = TuningTable([e])
    p = t.save(tmp_path / "stats.json")
    back = TuningTable.load(p)
    assert (back.get(_key()).us_iqr, back.get(_key()).k) == (0.25, 7)
    assert back == t
    doc = json.loads(p.read_text())
    assert doc["version"] == SCHEMA_VERSION
    for row in doc["entries"]:
        del row["us_iqr"], row["k"]
    got = TuningTable.from_json(doc).get(_key())
    assert (got.us_iqr, got.k) == (0.0, 1)


def test_table_json_roundtrip_and_interchange_with_reference(tmp_path):
    """Same schema in both packages: a table written by either loads in
    the other to the same rows."""
    t = TuningTable([_entry(), _entry(backend="kernel", tile=64, chunk=0,
                                      us=0.5),
                     _entry(device="gpu", dtype="float64", us=3.0)])
    p = t.save(tmp_path / "t.json")
    assert TuningTable.load(p) == t
    ref = rt.TuningTable.load(p)
    p2 = ref.save(tmp_path / "r.json")
    assert p2.read_text() == p.read_text()
    doc = json.loads(p.read_text())
    assert doc["version"] == SCHEMA_VERSION == rt.SCHEMA_VERSION
    doc["version"] = SCHEMA_VERSION + 1
    with pytest.raises(ValueError, match="schema version"):
        TuningTable.from_json(doc)


def test_entry_validation():
    for kw in (dict(tile=0, chunk=0, us_per_lp=1.0),
               dict(tile=8, chunk=-1, us_per_lp=1.0),
               dict(tile=8, chunk=0, us_per_lp=float("nan"))):
        with pytest.raises(ValueError):
            TableEntry(_key(), **kw)


def test_default_table_loads():
    t = default_table()
    assert isinstance(t, TuningTable)
    for e in t.entries():
        assert e.key.backend in ("naive", "rgb", "kernel", "pdhg")
        assert e.tile >= 1 and e.chunk >= 0
        assert e.source == "measured"
        if e.key.backend == "kernel":
            assert e.chunk == 0 and e.tile % WARPS_PER_CTA == 0


@pytest.mark.parametrize("table", ["bundled", "synthetic"])
def test_check_round_trip_holds(table):
    t = (default_table() if table == "bundled" else TuningTable(
        [_entry(us=2.0, us_iqr=0.1, k=5), _entry(backend="pdhg", tile=64,
                                                 chunk=1024, us=9.0)]))
    check_round_trip(t)


def test_check_round_trip_catches_a_lossy_load(monkeypatch):
    t = TuningTable([_entry()])
    monkeypatch.setattr(TuningTable, "load",
                        classmethod(lambda cls, path: cls()))
    with pytest.raises(ValueError, match="save -> load"):
        check_round_trip(t)


# -- candidate space ------------------------------------------------------

@pytest.mark.parametrize("backend", ["naive", "rgb", "kernel", "pdhg"])
@pytest.mark.parametrize("m,batch", [(100, 1024), (16, 5)])
def test_heuristic_candidate_is_what_a_table_miss_runs(backend, m, batch):
    cand = heuristic_candidate(backend, batch)
    with use_table(TuningTable()):
        spec = SolverSpec(backend=backend).resolve_for_shape(m, batch, "cpu")
    slots = ((spec.iter_block, spec.restart_period) if backend == "pdhg"
             else (spec.tile, spec.chunk))
    assert cand.backend == backend and (cand.tile, cand.chunk) == slots

def test_candidate_space_validity():
    cands = candidate_space(128, 256, device_kind="cpu",
                            backends=("naive", "rgb", "kernel"))
    assert Candidate("naive", 32, 0) in cands
    assert {c.backend for c in cands} == {"naive", "rgb", "kernel"}
    for c in cands:
        assert c.tile >= 1 and c.chunk >= 0
        if c.backend == "rgb" and c.chunk:
            assert c.chunk < 128
        if c.backend == "kernel":
            # whole CTAs of WARPS_PER_CTA problems, from 8; the kernel
            # takes no chunk (every chunk gives the same bits and work)
            assert c.tile % WARPS_PER_CTA == 0 and c.tile >= 8
            assert c.chunk == 0
            g = launch_geometry(128, 4, c.tile)
            assert 1 <= g.warps <= WARPS_PER_CTA
    assert [c.tile for c in cands if c.backend == "kernel"] == \
        [8, 16, 32, 64, 128]
    assert cands == candidate_space(128, 256, device_kind="cpu",
                                    backends=("naive", "rgb", "kernel"))
    tiny = candidate_space(8, 2, device_kind="cpu", backends=("rgb",
                                                              "kernel"))
    assert {c.tile for c in tiny} == {8}
    with pytest.raises(ValueError):
        candidate_space(128, 256, dtype="int8")
    with pytest.raises(ValueError):
        candidate_space(0, 4)


@pytest.mark.parametrize("m_pad,batch", [(8, 2), (128, 256), (2048, 64),
                                         (300, 1000)])
def test_shared_candidate_grids_equal_reference(m_pad, batch):
    """naive, rgb and pdhg enumerate exactly the reference's grid; the
    kernel's grid is the Hopper kernel's own (see the test above)."""
    for be in ("naive", "rgb", "pdhg"):
        got = candidate_space(m_pad, batch, device_kind="cpu",
                              backends=(be,))
        want = rt.candidate_space(m_pad, batch, device_kind="cpu",
                                  backends=(be,))
        assert [(c.backend, c.tile, c.chunk) for c in got] == \
            [(c.backend, c.tile, c.chunk) for c in want]
        assert [c.label() for c in got] == [c.label() for c in want]


def test_default_backends_by_platform():
    assert default_backends("cpu") == ("naive", "rgb", "pdhg") \
        == rt.default_backends("cpu")
    # on a card the compiled kernel and pdhg; rgb/naive are the plain
    # path there (a host sync per Seidel step)
    assert default_backends("NVIDIA H100 80GB HBM3") == ("kernel", "pdhg")
    assert default_backends("nvidia-h100-80gb-hbm3") == ("kernel", "pdhg")
    # no TPU here: elsewhere the reference's CPU set
    assert default_backends("tpu-v4") == ("naive", "rgb", "pdhg")


def test_pdhg_candidate_space():
    cands = candidate_space(2048, 64, backends=("pdhg",))
    assert cands and all(c.backend == "pdhg" for c in cands)
    for c in cands:
        assert c.tile >= 1 and (c.chunk == 0 or c.chunk >= c.tile)
        assert c.label() == f"pdhg/ib{c.tile}/rp{c.chunk}"
    assert cands == candidate_space(64, 8, backends=("pdhg",))


# -- runner ---------------------------------------------------------------

def _solver():
    return SolverSpec(backend="rgb", tile=8, chunk=0).build(device="cpu")


def test_measure_is_fenced_and_positive():
    pb = representative_batch(16, 8, device="cpu")
    assert pb.device == CPU and pb.L.shape == (8, 4, 16)
    assert measure(_solver().solve, pb, warmup=1, iters=3) > 0.0
    with pytest.raises(ValueError):
        measure(_solver().solve, pb, iters=0)


def test_measure_stats_and_tune_record_spread():
    pb = representative_batch(16, 8, device="cpu")
    med, iqr, k = measure_stats(_solver().solve, pb, warmup=1, iters=5)
    assert med > 0.0 and iqr >= 0.0 and k == 5
    _, iqr1, k1 = measure_stats(_solver().solve, pb, warmup=0, iters=1)
    assert iqr1 == 0.0 and k1 == 1
    results = tune_shape(16, 8, backends=("rgb",), warmup=1, iters=3,
                         device="cpu")
    assert all(r.k == 3 and r.iqr_seconds >= 0.0 for r in results)
    (entry,) = results_to_entries(results)
    assert entry.k == 3
    assert entry.us_iqr == pytest.approx(results[0].us_iqr)


def test_measure_stats_many_interleaves_the_calls():
    """Warm-up rounds, then timed rounds, each calling every function
    once in turn; one ``(median, iqr, k)`` per function."""
    calls = []
    fns = [lambda x, n=n: calls.append(n) for n in "abc"]
    stats = measure_stats_many(fns, torch.zeros(1), warmup=2, iters=3)
    assert calls == list("abc") * 5
    assert len(stats) == 3 and all(k == 3 and med >= 0.0 and iqr >= 0.0
                                   for med, iqr, k in stats)
    with pytest.raises(ValueError):
        measure_stats_many(fns, torch.zeros(1), iters=0)


def test_representative_batch_is_the_reference_distribution():
    """Same shape class and distribution as the reference's (the streams
    differ): unit normals, the optimum's neighbourhood feasible, float32
    draws cast to the asked dtype, full ``m_valid``."""
    pb = representative_batch(64, 32, dtype="float64", seed=3,
                              device="cpu")
    ref = rt.representative_batch(64, 32, dtype="float32", seed=3)
    assert tuple(pb.L.shape) == tuple(ref.L.shape) == (32, 4, 64)
    assert pb.L.dtype == torch.float64
    assert torch.equal(pb.m_valid, torch.full((32, 1), 64, dtype=torch.int32))
    norms = torch.hypot(pb.L[:, 0], pb.L[:, 1])
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-6)
    assert bool((pb.L[:, 3] == 0).all())
    # the same draw as float32 and float64 (cast, not redrawn)
    p32 = representative_batch(64, 32, dtype="float32", seed=3,
                               device="cpu")
    assert torch.equal(p32.L.double(), pb.L)
    # the seed decides the stream
    assert not torch.equal(representative_batch(64, 32, seed=4,
                                                device="cpu").L, p32.L)


def test_tune_shape_records_real_timings():
    results = tune_shape(16, 8, backends=("rgb",), warmup=1, iters=1,
                         device="cpu")
    assert results and all(r.seconds > 0 for r in results)
    assert results == sorted(results, key=lambda r: r.seconds)
    (e,) = results_to_entries(results)
    assert e.key.backend == "rgb"
    assert e.key.m_bucket == 16 and e.key.batch_bucket == 8
    assert e.key.device_kind == "cpu" == current_device_kind()
    assert (e.tile, e.chunk) == (results[0].candidate.tile,
                                 results[0].candidate.chunk)


def test_results_to_entries_equal_reference():
    """The winner per backend, bucketed and converted to µs/LP, is the
    same function in both packages."""
    rows = [(Candidate("rgb", 8, 0), 2.0), (Candidate("rgb", 16, 64), 1.0),
            (Candidate("pdhg", 64, 512), 5.0), (Candidate("naive", 32, 0),
                                                3.0)]
    mine = [TuneResult(c, 100, 50, "float32", "cpu", s, 0.1, 3)
            for c, s in rows]
    ref = [rt.TuneResult(rt.Candidate(c.backend, c.tile, c.chunk), 100, 50,
                         "float32", "cpu", s, 0.1, 3) for c, s in rows]
    a = TuningTable(results_to_entries(mine)).to_json()
    b = rt.TuningTable(rt.results_to_entries(ref)).to_json()
    assert a == b


def _results(backend, batch, rows):
    """TuneResults at m_pad 128 from ``(tile, chunk, ms, iqr_ms)`` rows."""
    return [TuneResult(Candidate(backend, t, c), 128, batch, "float32",
                       "cpu", ms * 1e-3, iqr * 1e-3, 200)
            for t, c, ms, iqr in rows]


@pytest.mark.parametrize("case,rows,want", [
    # the heuristic's tile 8 keeps the row against a win inside the noise
    ("inside_noise", [(8, 0, 0.30, 0.02), (16, 0, 0.29, 0.01),
                      (32, 0, 0.31, 0.01)], 8),
    # and loses it to a win beyond the larger IQR
    ("beyond_noise", [(8, 0, 0.30, 0.02), (16, 0, 0.25, 0.01)], 16),
    # a shape where the heuristic's candidate was not timed: the fastest
    ("no_incumbent", [(16, 0, 0.30, 0.0), (32, 0, 0.29, 0.05)], 32),
])
def test_winner_entries_keep_the_heuristic_inside_the_noise(case, rows,
                                                            want):
    (e,) = winner_entries(_results("kernel", 1024, rows))
    assert heuristic_candidate("kernel", 1024).tile == 8
    assert (e.key.backend, e.tile, e.chunk) == ("kernel", want, 0)
    mine = [r for r in _results("kernel", 1024, rows)
            if r.candidate.tile == want]
    assert e.us_per_lp == mine[0].us_per_lp and e.k == 200


def test_winner_entries_per_backend():
    """Each backend is judged against its own heuristic candidate."""
    rows = (_results("kernel", 1024, [(8, 0, 0.30, 0.05),
                                      (64, 0, 0.28, 0.01)])
            + _results("pdhg", 1024, [(DEFAULT_ITER_BLOCK,
                                       DEFAULT_RESTART_PERIOD, 900.0, 10.0),
                                      (128, 512, 800.0, 10.0)]))
    got = {e.key.backend: (e.tile, e.chunk) for e in winner_entries(rows)}
    assert got == {"kernel": (8, 0), "pdhg": (128, 512)}


def test_tune_merges_into_table():
    seen = []
    table = tune([(16, 8)], backends=("rgb",), warmup=1, iters=1,
                 on_result=seen.append, device="cpu")
    assert len(table) == 1 and seen
    assert table.lookup(backend="rgb", dtype="float32", m=16, batch=8,
                        device_kind="cpu") is not None


def test_tune_times_the_pdhg_schedule():
    results = tune_shape(16, 8, backends=("pdhg",), warmup=0, iters=1,
                         device="cpu")
    assert len(results) == len(candidate_space(16, 8, backends=("pdhg",)))
    (e,) = results_to_entries(results)
    spec = SolverSpec(backend="pdhg")
    with use_table(TuningTable([e])):
        got = spec.resolve_for_shape(16, 8, "cpu")
    assert (got.iter_block, got.restart_period) == (e.tile, e.chunk)


# -- resolution precedence (the acceptance contract) ----------------------

def _synthetic_table(tile=16, chunk=64):
    return TuningTable([TableEntry(
        TableKey("cpu", "rgb", "float32", m_bucket=32, batch_bucket=16),
        tile=tile, chunk=chunk, us_per_lp=1.0)])


def test_table_entry_changes_resolved_geometry():
    spec = SolverSpec(backend="rgb")
    with use_table(TuningTable()):
        base = spec.resolve_for_shape(21, 9, "cpu")
    assert (base.tile, base.chunk) == (32, 0)
    with use_table(_synthetic_table(tile=16, chunk=64)):
        tuned = spec.resolve_for_shape(21, 9, "cpu")
    assert (tuned.tile, tuned.chunk) == (16, 64)


def test_explicit_values_beat_table():
    with use_table(_synthetic_table(tile=16, chunk=64)):
        full = SolverSpec(backend="rgb", tile=8,
                          chunk=0).resolve_for_shape(21, 9, "cpu")
        assert (full.tile, full.chunk) == (8, 0)
        half = SolverSpec(backend="rgb", tile=8).resolve_for_shape(21, 9,
                                                                  "cpu")
        assert (half.tile, half.chunk) == (8, 64)
        other = SolverSpec(backend="rgb", chunk=0).resolve_for_shape(
            21, 9, "cpu")
        assert (other.tile, other.chunk) == (16, 0)


def test_table_miss_falls_back_never_errors():
    with use_table(_synthetic_table()):
        assert SolverSpec(backend="rgb").resolve_for_shape(
            500, 9, "cpu").tile == 32
        assert SolverSpec(backend="rgb").resolve_for_shape(
            21, 4096, "cpu").tile == 32
        assert SolverSpec(backend="naive").resolve_for_shape(
            21, 9, "cpu").is_shape_resolved

    class _Boom:
        def lookup(self, **kw):
            raise RuntimeError("boom")

        def lookup_best_backend(self, **kw):
            raise RuntimeError("boom")
    set_active_table(_Boom())
    try:
        r = SolverSpec(backend="rgb").resolve_for_shape(21, 9, "cpu")
        assert (r.tile, r.chunk) == (32, 0)
    finally:
        set_active_table(None)


def test_kernel_chunk_from_table_must_divide_lane_rounded_m():
    t = TuningTable([TableEntry(
        TableKey("cpu", "kernel", "float32", m_bucket=bucket_pow2(384, 8),
                 batch_bucket=16), tile=32, chunk=256, us_per_lp=1.0)])
    with use_table(t):
        spec = SolverSpec(backend="kernel").resolve_for_shape(384, 16,
                                                              "cpu")
        assert spec.chunk == 0 and spec.tile == 32
    t2 = TuningTable([TableEntry(
        TableKey("cpu", "kernel", "float32", m_bucket=bucket_pow2(256, 8),
                 batch_bucket=16), tile=32, chunk=128, us_per_lp=1.0)])
    with use_table(t2):
        spec = SolverSpec(backend="kernel").resolve_for_shape(256, 16,
                                                              "cpu")
        assert spec.chunk == 128 and 256 % LANE == 0


def test_auto_backend_picks_measured_winner():
    mk = lambda backend, us: TableEntry(  # noqa: E731
        TableKey("cpu", backend, "float32", m_bucket=32, batch_bucket=16),
        tile=32, chunk=0, us_per_lp=us)
    with use_table(TuningTable([mk("naive", 0.5), mk("rgb", 2.0)])):
        assert SolverSpec(backend="auto").resolve_for_shape(
            21, 9, "cpu").backend == "naive"
    with use_table(TuningTable()):
        assert SolverSpec(backend="auto").resolve_for_shape(
            21, 9, "cpu").backend == "rgb"
        assert SolverSpec(backend="auto").resolve_for_shape(
            21, 9, "cuda").backend == "kernel"


def test_auto_routes_small_m_kernel_big_m_pdhg():
    mk = lambda backend, mb, tile, chunk, us: TableEntry(  # noqa: E731
        TableKey("cpu", backend, "float32", m_bucket=mb, batch_bucket=0),
        tile=tile, chunk=chunk, us_per_lp=us)
    t = TuningTable([mk("kernel", 64, 8, 0, 1.0),
                     mk("pdhg", 64, 64, 512, 40.0),
                     mk("kernel", 4096, 8, 0, 900.0),
                     mk("pdhg", 4096, 128, 2048, 30.0)])
    with use_table(t):
        small = SolverSpec(backend="auto").resolve_for_shape(48, 32, "cpu")
        big = SolverSpec(backend="auto").resolve_for_shape(4000, 32, "cpu")
    assert small.backend == "kernel" and (small.tile, small.chunk) == (8, 0)
    assert big.backend == "pdhg"
    assert (big.iter_block, big.restart_period) == (128, 2048)
    assert big.is_shape_resolved


def test_pdhg_schedule_resolution_precedence():
    t = TuningTable([TableEntry(
        TableKey("cpu", "pdhg", "float32", m_bucket=32, batch_bucket=16),
        tile=128, chunk=2048, us_per_lp=1.0)])
    with use_table(t):
        tuned = SolverSpec(backend="pdhg").resolve_for_shape(21, 9, "cpu")
        assert (tuned.iter_block, tuned.restart_period) == (128, 2048)
        half = SolverSpec(backend="pdhg",
                          iter_block=32).resolve_for_shape(21, 9, "cpu")
        assert (half.iter_block, half.restart_period) == (32, 2048)
    with use_table(TuningTable()):
        bare = SolverSpec(backend="pdhg").resolve_for_shape(21, 9, "cpu")
    assert (bare.iter_block, bare.restart_period) == (
        DEFAULT_ITER_BLOCK, DEFAULT_RESTART_PERIOD)
    assert bare.is_shape_resolved
    assert bare.tile is not None and bare.chunk is not None


def test_auto_backend_reaches_built_solver():
    solver = SolverSpec(backend="auto").build(device="cpu")
    assert solver._solve_spec.backend == "auto"
    assert solver.spec.backend == "rgb"
    t = TuningTable([TableEntry(
        TableKey("cpu", "naive", "float32", m_bucket=32, batch_bucket=16),
        tile=32, chunk=0, us_per_lp=0.5)])
    lp = to_torch_batch(rc.random_feasible_lp(jax.random.key(7), 9, 21))
    with use_table(t):
        tuned = solver.solve(lp)
        ref = SolverSpec(backend="naive").build(device="cpu").solve(lp)
    assert torch.equal(tuned.x, ref.x)


def test_tuned_solve_end_to_end_matches_untuned():
    lp = to_torch_batch(rc.random_feasible_lp(jax.random.key(3), 9, 21))
    spec = SolverSpec(backend="rgb")
    with use_table(TuningTable()):
        base = solve_with_spec(spec, lp)
    with use_table(_synthetic_table(tile=8, chunk=64)):
        tuned = solve_with_spec(spec, lp)
        tuned_packed = solve_with_spec(spec, lp.pack())
    assert torch.equal(base.feasible, tuned.feasible)
    np.testing.assert_allclose(base.objective.numpy(),
                               tuned.objective.numpy(), rtol=5e-4,
                               atol=5e-4)
    assert torch.equal(tuned.x, tuned_packed.x)
