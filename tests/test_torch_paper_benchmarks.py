"""The port's figure harness (``benchmarks/pt_*.py``) against the reference's
(``benchmarks/*.py``), both on the CPU at tiny grids.

* The solve each twin times equals the reference's, backend for backend, on
  batches made by the reference's own generators and handed to both sides as
  numpy (``feasible`` equal, ``x`` within 1e-4 in float32; the reference's
  ``kernel`` runs in interpret mode, as its own tests run it).  Specs that
  shuffle draw their order from different streams on the two sides; the
  optimum does not depend on the order.
* Fig. 6's reductions equal the reference's outputs exactly; Fig. 5's moved
  arrays equal the host arrays.
* The ``--smoke`` modes of ``pt_pack_layout``, ``pt_pdhg_crossover`` and
  ``pt_tune_cli`` pass with their asserts.  ``pt_pdhg_crossover``'s is run
  with one timed call a row instead of four (the asserts do not read the
  times).
* Row names and JSON keys of each twin's quick grid equal the reference's
  (plus ``card``): both sides run with timing and solving stubbed out, so
  only the rows' names and keys are compared.
* The dry-run readers: ``pt_roofline_report`` renders the port's records as
  the reference renders them, and ``pt_hillclimb`` records
  ``vma-transpose`` as ``no_counterpart``.
* No twin imports ``jax`` or ``repro``, and each needs the card unless it is
  told ``device="cpu"``.

``benchmarks/`` is not a package; this module puts the repository's root
on ``sys.path`` so its modules import as ``benchmarks.<name>``, as
``python -m benchmarks.run`` imports them.
"""
import ast
import contextlib
import io
import json
import os
import pathlib
import re
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import repro.core as rc                                    # noqa: E402
import repro.solver.spec as rspec                          # noqa: E402
import repro_torch.solver.spec as tspec                    # noqa: E402
from benchmarks import (fig3_lp_size, fig4_batch, fig5_transfer,  # noqa: E402
                        fig6_reduction, fig7_naive_vs_rgb, pack_layout,
                        pdhg_crossover, pt_common, pt_fig3_lp_size,
                        pt_fig4_batch, pt_fig5_transfer, pt_fig6_reduction,
                        pt_fig7_naive_vs_rgb, pt_hillclimb, pt_pack_layout,
                        pt_pdhg_crossover, pt_roofline_report, pt_run,
                        pt_serve_bench, pt_solver_sweep, pt_tune_cli,
                        roofline_report, serve_bench, solver_sweep,
                        tune_cli)
from repro_torch.core import batch_from_numpy, pack        # noqa: E402
from repro_torch.launch import dryrun                      # noqa: E402
import _torch_compat                                       # noqa: E402
from _torch_compat import CPU                              # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"
X_TOL = 1e-4
TWINS = sorted(p.stem for p in (REPO / "benchmarks").glob("pt_*.py"))


def _ref_arrays(lp):
    return (np.asarray(lp.A), np.asarray(lp.b), np.asarray(lp.c),
            np.asarray(lp.m_valid))


def _assert_same_solution(ref, got):
    feas = np.asarray(ref.feasible)
    np.testing.assert_array_equal(got.feasible.numpy(), feas)
    np.testing.assert_allclose(got.x.numpy()[feas], np.asarray(ref.x)[feas],
                               rtol=X_TOL, atol=X_TOL)


def _ref_spec(spec: rspec.SolverSpec) -> rspec.SolverSpec:
    """The reference spec as its own tests run it on the CPU."""
    if spec.backend == "kernel":
        return rspec.SolverSpec(**{**spec.__dict__, "interpret": True})
    return spec


def _solve_both(ref_spec, twin_spec, lp):
    ref = _ref_spec(ref_spec).build().solve(lp)
    got = twin_spec.build(device="cpu").solve(
        batch_from_numpy(*_ref_arrays(lp), device="cpu"))
    _assert_same_solution(ref, got)


def _fig_lp(B, m, key, shuffle_key):
    return rc.shuffle_batch(jax.random.key(shuffle_key), rc.normalize_batch(
        rc.random_feasible_lp(jax.random.key(key), B, m)))


# -- the twins stand alone -------------------------------------------------

def test_every_reference_module_has_a_twin():
    refs = sorted(p.stem for p in (REPO / "benchmarks").glob("*.py")
                  if not p.stem.startswith("pt_"))
    assert len(refs) == 14
    assert [f"pt_{r}" for r in refs] == TWINS


def test_twins_import_neither_jax_nor_the_reference():
    pat = re.compile(
        r"^\s*(import|from)\s+(jax|repro\b|benchmarks\.(common|run|fig|"
        r"solver_sweep|pack_layout|pdhg_crossover|tune_cli|serve_bench|"
        r"roofline_report|hillclimb))", re.M)
    hits = [f"{t}: {m.group(0).strip()}" for t in TWINS
            for m in pat.finditer((REPO / "benchmarks" / f"{t}.py")
                                  .read_text())]
    assert hits == []
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
            "import importlib\n"
            f"for t in {TWINS!r}:\n"
            "    importlib.import_module('benchmarks.' + t)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro') or m in ('benchmarks.common', "
            "'benchmarks.run'))\n"
            "print(len([m for m in sys.modules if m.startswith('benchmarks.pt_')]),"
            " bad)\n")
    out = subprocess.run([sys.executable, "-c", code, str(REPO),
                          str(REPO / "src")], capture_output=True, text=True,
                         timeout=300, check=True).stdout.split("\n")[-2]
    assert out == f"{len(TWINS)} []"


def test_every_port_test_module_sets_its_workers_threads():
    """Each ``tests/test_torch_*.py`` imports ``_torch_compat`` at module
    level, which gives an xdist worker's torch its share of the cores, so
    the budget holds whichever port module a worker imports first."""
    missing = []
    for path in sorted((REPO / "tests").glob("test_torch_*.py")):
        body = ast.parse(path.read_text()).body
        names = {a.name for n in body if isinstance(n, ast.Import)
                 for a in n.names}
        names |= {n.module for n in body if isinstance(n, ast.ImportFrom)}
        if "_torch_compat" not in names:
            missing.append(path.name)
    assert missing == []
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:
        assert _torch_compat.THREADS == max(
            1, len(os.sched_getaffinity(0)) // int(workers))
        assert torch.get_num_threads() == _torch_compat.THREADS
    else:
        assert _torch_compat.THREADS is None


@pytest.mark.parametrize("call", [
    lambda: pt_fig3_lp_size.run(),
    lambda: pt_fig4_batch.run(),
    lambda: pt_fig5_transfer.run(),
    lambda: pt_fig6_reduction.run(),
    lambda: pt_fig7_naive_vs_rgb.run(),
    lambda: pt_solver_sweep.run(),
    lambda: pt_pack_layout.main(["--smoke"]),
    lambda: pt_pdhg_crossover.main(["--smoke"]),
    lambda: pt_tune_cli.main(["--smoke"]),
    lambda: pt_serve_bench.run(),
    lambda: pt_run.main(["--only", "fig6"]),
    lambda: pt_common.time_fn(lambda: None),
], ids=["fig3", "fig4", "fig5", "fig6", "fig7", "solver_sweep",
        "pack_layout", "pdhg_crossover", "tune_cli", "serve", "run",
        "time_fn"])
def test_twins_need_the_card_unless_told_the_cpu(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


def test_hillclimb_needs_a_card_or_a_named_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="--peaks"):
        pt_hillclimb.main([])


# -- the solves each twin times ---------------------------------------------

@pytest.mark.parametrize("method", pt_fig3_lp_size.METHODS)
def test_fig3_solves_equal_the_reference(method):
    B, m = 16, 24
    _solve_both(rspec.SolverSpec(backend=method, normalize=False),
                pt_fig3_lp_size.spec(method), _fig_lp(B, m, B + m, 1))


@pytest.mark.parametrize("method", pt_fig4_batch.METHODS)
def test_fig4_solves_equal_the_reference(method):
    B, m = 24, 16
    _solve_both(rspec.SolverSpec(backend=method, normalize=False),
                pt_fig4_batch.spec(method), _fig_lp(B, m, B * 7 + m, 2))


@pytest.mark.parametrize("i", range(len(fig7_naive_vs_rgb.VARIANTS)))
def test_fig7_variants_equal_the_reference(i):
    label, ref = fig7_naive_vs_rgb.VARIANTS[i]
    got_label, got = pt_fig7_naive_vs_rgb.VARIANTS[i]
    assert got_label == label
    _solve_both(ref, got, _fig_lp(12, 20, 20, 4))


def test_fig7_naive_and_the_adversarial_ablation_equal_the_reference():
    _solve_both(rspec.SolverSpec(backend="naive", normalize=False),
                pt_fig7_naive_vs_rgb.NAIVE, _fig_lp(12, 20, 20, 4))
    adv = rc.normalize_batch(rc.adversarial_lp(4, 16))
    for lp in (adv, rc.shuffle_batch(jax.random.key(0), adv)):
        _solve_both(rspec.SolverSpec(backend="rgb", normalize=False),
                    pt_fig7_naive_vs_rgb.ADVERSARIAL, lp)
    # the twin's own adversarial batch is the reference's, in order
    mine, _ = pt_fig7_naive_vs_rgb.adversarial_case(16, CPU)
    assert mine.batch == pt_fig7_naive_vs_rgb.ADV_BATCH
    np.testing.assert_allclose(mine.A[:4].numpy(), np.asarray(adv.A),
                               atol=1e-6)


@pytest.mark.parametrize("i", range(6))
def test_solver_sweep_specs_equal_the_reference(i):
    label, ref = solver_sweep.sweep_specs(full=True)[i]
    got_label, got = pt_solver_sweep.sweep_specs(full=True)[i]
    assert got_label == label
    assert (got.backend, got.tile, got.chunk, got.shuffle) == (
        ref.backend, ref.tile, ref.chunk, ref.shuffle)
    _solve_both(ref, got, rc.random_feasible_lp(jax.random.key(42), 16, 24))


def test_cases_are_normalised_and_shuffled_like_the_reference():
    lp = pt_fig3_lp_size.case(8, 16, CPU)
    assert lp.A.shape == (8, 16, 2)
    np.testing.assert_allclose(lp.A.norm(dim=-1).numpy(), 1.0, atol=1e-6)
    # a different stream for the order: the same problems, permuted
    again = pt_fig3_lp_size.case(8, 16, CPU)
    assert torch.equal(lp.A, again.A)
    raw = pt_fig4_batch.case(8, 16, CPU)
    assert raw.batch == 8 and bool((raw.m_valid == 16).all())


def test_scipy_batch_times_and_solves_the_first_problems():
    lp = pt_fig3_lp_size.case(4, 12, CPU)
    dt, obj = pt_fig3_lp_size.scipy_batch(lp)
    assert dt > 0 and obj.shape == (4,) and not np.isnan(obj).any()
    sol = pt_fig3_lp_size.spec("naive").build(device="cpu").solve(lp)
    np.testing.assert_allclose(sol.objective.numpy(), obj, rtol=2e-4,
                               atol=2e-4)


# -- fig5, fig6 -------------------------------------------------------------

def test_fig6_reductions_equal_the_reference_exactly(monkeypatch):
    seen = []

    def capture(fn, x, **kw):   # the closures read the loop's last c later
        seen.append((np.asarray(fn(x)), np.asarray(x)))
        return 1e-3
    monkeypatch.setattr(fig6_reduction, "time_fn", capture)
    with contextlib.redirect_stdout(io.StringIO()):
        fig6_reduction.run(full=False)
    contentions = (2, 32, 512)
    assert len(seen) == 3 * len(contentions)
    for j, c in enumerate(contentions):
        x = seen[3 * j][1]
        mine = pt_fig6_reduction.reductions(fig6_reduction.N // c, c, CPU)
        for k, (name, fn) in enumerate(mine.items()):
            np.testing.assert_array_equal(
                fn(torch.from_numpy(x.copy())).numpy(), seen[3 * j + k][0],
                err_msg=f"{name} c={c}")


def test_fig5_moves_the_host_arrays_unchanged():
    lp = pt_fig5_transfer.case(8, 16, CPU)
    host = pt_fig5_transfer.host_arrays(lp)
    np.testing.assert_array_equal(host[3], pack(lp).L.numpy())
    moved = pt_fig5_transfer.transfer(host, CPU)
    assert len(moved) == 4
    for h, t in zip(host, moved):
        np.testing.assert_array_equal(t.numpy(), h)


# -- the --smoke modes ------------------------------------------------------

def test_pack_layout_smoke_on_the_cpu(capsys):
    pt_pack_layout.main(["--smoke"], device="cpu")
    out = capsys.readouterr().out
    assert "pack_layout --smoke ok" in out


def test_pdhg_crossover_smoke_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr(pt_pdhg_crossover, "time_fn",
                        lambda fn, *a, **k: pt_common.time_fn(
                            fn, *a, **{**k, "warmup": 0, "iters": 1}))
    pt_pdhg_crossover.main(["--smoke"], device="cpu")
    assert "pdhg_crossover --smoke ok" in capsys.readouterr().out


def test_tune_cli_smoke_on_the_cpu_writes_nothing_without_out(capsys):
    bundled = REPO / "src" / "repro_torch" / "tune" / "default_table.json"
    before = bundled.read_bytes()
    pt_tune_cli.main(["--smoke"], device="cpu")
    assert "tune_cli --smoke ok" in capsys.readouterr().out
    assert bundled.read_bytes() == before


def test_tune_cli_out_and_merge(tmp_path, capsys):
    out = tmp_path / "t.json"
    pt_tune_cli.main(["--smoke", "--out", str(out)], device="cpu")
    pt_tune_cli.main(["--smoke", "--out", str(out), "--merge"], device="cpu")
    assert "for 'cpu'" in capsys.readouterr().out
    assert json.loads(out.read_text())["entries"]


# -- row names and keys -----------------------------------------------------

class _Solution(types.SimpleNamespace):
    pass


def _stub_build(kind):
    """``SolverSpec.build`` returning a solver that answers at once."""
    def build(self, *a, **k):
        def solve(lp, *_a, **_k):
            B = lp.batch
            if kind == "torch":
                return _Solution(x=torch.zeros(B, 2), objective=torch.zeros(B),
                                 feasible=torch.ones(B, dtype=torch.bool))
            return _Solution(x=np.zeros((B, 2), np.float32),
                             objective=np.zeros(B),
                             feasible=np.ones(B, bool))
        return types.SimpleNamespace(solve=solve, spec=self)
    return build


def _snap(cfg):
    snap = {k: 1.0 for k in (
        "throughput_lps", "padding_waste_problems", "padding_waste_cells",
        "device_idle_s_est", "latency_mean_ms", "latency_p50_ms",
        "latency_p99_ms")}
    snap.update(launches_total=1, n_flushes=1, fused_flushes=0,
                fused_buckets=0, rows_per_device=[1], inflight_max=1,
                overlapped_dispatches=0, cache={"hit_rate": 1.0})
    if cfg.trace:
        snap.update(device_idle_frac=0.5, device_busy_s=1.0,
                    device_window_s=2.0, device_tracks={"0": 1},
                    trace_spans=1)
    return snap


_RPC = {"closed_loop": {"rps": 1.0, "p50_ms": 1.0, "p99_ms": 1.0,
                        "errors": 0},
        "overload": {"shed_rate": 0.0, "retry_after_on_429": True}}


def _timer(fn, *args, warmup=1, iters=3, **_):
    """``time_fn`` that calls as often and times nothing."""
    for _ in range(warmup + iters):
        fn(*args)
    return 1e-3


def _stub(monkeypatch, mod, kind):
    """Stub ``mod``'s timing, solving, HiGHS, pdhg, tuner and traffic."""
    monkeypatch.setattr((tspec if kind == "torch" else rspec).SolverSpec,
                        "build", _stub_build(kind))
    if hasattr(mod, "time_fn"):
        monkeypatch.setattr(mod, "time_fn", _timer)
    if hasattr(mod, "scipy_batch"):
        monkeypatch.setattr(mod, "scipy_batch", (
            lambda lp: (1e-3, np.zeros(1))) if kind == "torch" else (
            lambda lp: 1e-3))
    if hasattr(mod, "solve_pdhg_with_stats"):
        arr = torch if kind == "torch" else np
        stats = types.SimpleNamespace(converged=arr.ones(4, dtype=bool),
                                      kkt=arr.zeros(4))
        monkeypatch.setattr(mod, "solve_pdhg_with_stats",
                            lambda pb: (None, stats))
    if hasattr(mod, "tune"):
        pkg = sys.modules["repro_torch.tune" if kind == "torch"
                          else "repro.tune"]

        def tune(shapes, *, on_result=None, **_):
            for m_pad, batch in shapes:
                on_result(pkg.TuneResult(
                    candidate=pkg.Candidate("rgb", 8, 0), m_pad=m_pad,
                    batch=batch, dtype="float32", device_kind="cpu",
                    seconds=1e-3))
            return pkg.TuningTable()
        monkeypatch.setattr(mod, "tune", tune)
    if hasattr(mod, "run_traffic"):
        monkeypatch.setattr(mod, "run_traffic",
                            lambda cfg, **k: (_snap(cfg), None))
        monkeypatch.setattr(mod, "run_rpc_traffic", (
            lambda cfg, **k: (_RPC, None)) if kind == "torch" else (
            lambda cfg, **k: _RPC))


def _rows_and_keys(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    names, keys = [], []
    for ln in buf.getvalue().splitlines():
        if ln.startswith("JSON "):
            keys.append(json.loads(ln[5:]))
        elif ln.startswith("{"):
            keys.append(json.loads(ln))
        elif ln.count(",") >= 2:
            names.append(ln.split(",", 1)[0])
    return names, keys


NAMED = {
    "fig3": (fig3_lp_size, pt_fig3_lp_size, {}),
    "fig4": (fig4_batch, pt_fig4_batch, {}),
    "fig5": (fig5_transfer, pt_fig5_transfer, {}),
    "fig6": (fig6_reduction, pt_fig6_reduction, {}),
    "fig7": (fig7_naive_vs_rgb, pt_fig7_naive_vs_rgb, {}),
    "solver_sweep": (solver_sweep, pt_solver_sweep, {}),
    "pack_layout": (pack_layout, pt_pack_layout, {}),
    "pack_layout_smoke": (pack_layout, pt_pack_layout, {"smoke": True}),
    "pdhg_crossover": (pdhg_crossover, pt_pdhg_crossover, {}),
    "pdhg_crossover_smoke": (pdhg_crossover, pt_pdhg_crossover,
                             {"smoke": True}),
    "tune_cli": (tune_cli, pt_tune_cli, {}),
    "serve_bench": (serve_bench, pt_serve_bench, {}),
}


@pytest.mark.parametrize("which", list(NAMED))
def test_row_names_and_json_keys_equal_the_reference(which, monkeypatch):
    ref_mod, twin, kw = NAMED[which]
    _stub(monkeypatch, ref_mod, "jax")
    _stub(monkeypatch, twin, "torch")
    if which == "fig4":
        _stub(monkeypatch, fig3_lp_size, "jax")
    ref_names, ref_keys = _rows_and_keys(lambda: ref_mod.run(**kw))
    names, keys = _rows_and_keys(lambda: twin.run(device="cpu", **kw))
    assert ref_names
    if which == "serve_bench":
        # the pmap profile: no row, one line saying it has no counterpart
        ref_names.remove("serve_shard_pmap")
        pmap = [k for k in keys if k.get("sharding") == "pmap"]
        assert [k["status"] for k in pmap] == ["no_counterpart"]
        keys.remove(pmap[0])
        ref_keys = [k for k in ref_keys if k.get("sharding") != "pmap"]
    assert names == ref_names
    assert [list(k) for k in keys] == [list(k) + ["card"] for k in ref_keys]


def test_plain_quick_keeps_the_plain_rows_to_the_quick_grid(monkeypatch):
    _stub(monkeypatch, pt_fig3_lp_size, "torch")
    names, _ = _rows_and_keys(lambda: pt_fig3_lp_size.run(
        full=True, device="cpu", plain_quick=True))
    rgb = [n for n in names if n.endswith("/rgb")]
    assert rgb == ["fig3/b128/m8/rgb", "fig3/b128/m64/rgb",
                   "fig3/b128/m512/rgb"]
    assert len([n for n in names if n.endswith("/kernel")]) == 11
    full = pt_common.shapes([(1, 2), (3, 4)], [(1, 2), (0, 1)], True)
    assert full == [((1, 2), True), ((3, 4), True)]
    assert pt_common.shapes([(1, 2), (3, 4)], [(1, 2), (0, 1)], True,
                            True) == [((0, 1), True), ((1, 2), True),
                                      ((3, 4), False)]


def test_run_prints_the_header_and_hands_rows_to_hold(monkeypatch, capsys):
    _stub(monkeypatch, pt_fig3_lp_size, "torch")
    held = []
    rows = pt_run.main(["--only", "fig3"], device="cpu",
                       hold=lambda *a: held.append(a))
    out = capsys.readouterr().out.splitlines()
    assert out[:3] == ["# card=cpu", f"# host_cpu={pt_common.host_cpu()}",
                       "name,us_per_call,derived"]
    assert len(rows) == 12 and rows[0].startswith("fig3/b128/m8/naive,")
    assert [h[0] for h in held] == [r.split(",")[0] for r in rows]
    assert all(h[2] is None and len(h) == 4 for h in held
               if h[0].endswith("scipy-highs"))


# -- the dry-run readers ----------------------------------------------------

def _ref_cells():
    tree = ast.parse((REPO / "benchmarks" / "hillclimb.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and node.targets[0].id == "CELLS":
            return ast.literal_eval(node.value)
    raise AssertionError("no CELLS in hillclimb.py")


def test_hillclimb_cells_are_the_references():
    assert pt_hillclimb.CELLS == _ref_cells()


def test_hillclimb_records_vma_transpose_as_no_counterpart(tmp_path,
                                                           monkeypatch):
    calls = []

    def cell(arch, shape, **kw):
        calls.append((arch, shape, kw["variant"], kw["step_kwargs"]))
        return {"arch": arch, "shape": shape, "multi_pod": False,
                "variant": kw["variant"], "status": "ok", "peaks": kw["peaks"]}
    monkeypatch.setattr(pt_hillclimb, "dryrun_cell", cell)
    out = tmp_path / "dryrun.json"
    monkeypatch.setattr(pt_hillclimb, "RESULTS", out)
    recs = pt_hillclimb.main(["--peaks", H100])
    assert [(r["variant"], r["status"]) for r in recs] == [
        ("vma-transpose", "no_counterpart"), ("weight-resident", "ok"),
        ("fused-psum", "ok"), ("fused-psum", "ok"),
        ("vma-transpose", "no_counterpart")]
    assert all("check_rep" in r["reason"] for r in recs
               if r["status"] == "no_counterpart")
    assert [c[:3] for c in calls] == [
        ("granite-8b", "decode_32k", "weight-resident"),
        ("arctic-480b", "train_4k", "fused-psum"),
        ("arctic-480b", "decode_32k", "fused-psum")]
    assert json.loads(out.read_text()) == recs


def test_roofline_report_renders_the_ports_records_as_the_reference(
        tmp_path, monkeypatch):
    out = tmp_path / "dryrun.json"
    with contextlib.redirect_stdout(io.StringIO()):
        dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                     "--peaks", H100, "--out", str(out)])
    # one variant of the same cell, to fill the variants table
    rec = json.loads(out.read_text())[0]
    dryrun.write_records([{**rec, "variant": "weight-resident"}], out)
    monkeypatch.setattr(roofline_report, "RESULTS", out)
    monkeypatch.setattr(pt_roofline_report, "RESULTS", out)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        roofline_report.main()
    with contextlib.redirect_stdout(io.StringIO()):
        lines = pt_roofline_report.main()
    ref = buf.getvalue().rstrip("\n").split("\n")
    mine = "\n".join(lines).split("\n")
    assert mine.pop(2) == f"counted on meta for: {H100}"
    mine.pop(2)
    assert mine == ref
    assert "| qwen2-0.5b | decode_32k | ok | ? |" in "\n".join(mine)
    assert "| weight-resident |" in "\n".join(mine)
    # a no_counterpart variant is shown as such, not as a failure
    dryrun.write_records([{"arch": "granite-8b", "shape": "train_4k",
                           "multi_pod": False, "variant": "vma-transpose",
                           "status": "no_counterpart"}], out)
    with contextlib.redirect_stdout(io.StringIO()):
        text = "\n".join(pt_roofline_report.main())
    assert "| granite-8b | train_4k | vma-transpose | - | - | no counterpart |" \
        in text and "FAILED |" not in text
