"""Cells, configurations, traffic mixes, loops, kinds of problem,
references and metric readers are found by name; a cell, a loop or a kind
added as files only is found and runs, and a name with no file is refused
before anything runs."""
from __future__ import annotations

import json
import math
import shutil

import pytest
from conftest import KEPT_CELLS, ROOT, add_cell, edit_json, last_json

from lpbench import judge, run, spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_files(cell):
    c = spec.find_cell(cell)
    assert c.chips == 1
    assert callable(c.loop)
    assert c.problem.__file__.endswith(
        f"problems/{c.config['problem']['kind']}.py")
    assert (ROOT / c.config["reference"]).samefile(c.reference.__file__)
    limits = set(c.config["limits"])
    assert {"failed", "wrong", "obj_gap"} <= limits <= set(judge.NUMBERS)
    assert limits & {"x_viol", "row_viol"}
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert m["moves"] in names


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_every_metric_has_a_reader(metric):
    assert callable(spec.reader(metric))


def test_config_files_are_the_ones_benchmark_names():
    for c in BENCH["configs"]:
        path = ROOT / c["file"]
        assert path.is_file()
        assert json.loads(path.read_text())["name"] == c["name"]
        assert path.parent == ROOT / "lpbench" / "configs"


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.find_cell("no-such.cell")


def _run_ok(root, capsys, cell):
    rc = run.main(["--workload", cell, "--seed", "2147483677",
                   "--seconds", "0.3", "--trace", "0"], device="cpu",
                  root=root)
    assert rc == 0
    out = last_json(capsys.readouterr().out)
    assert out["correct"] is True, out["checks"]
    return out


def test_a_cell_added_as_files_runs(small_root, capsys):
    """A new traffic file and a new BENCHMARK.json entry, nothing else."""
    add_cell(small_root, "fig3-m256.b64", "fig3-m256", "b64",
             {"loop": "batch_closed", "batch": 16, "rotate": 2,
              "check_calls": 2, "trace_calls": 2})
    out = _run_ok(small_root, capsys, "fig3-m256.b64")
    assert set(out["metrics"]) == {"lps_per_s", "setup_s"}
    assert math.isfinite(out["metrics"]["lps_per_s"]["value"])
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", list(KEPT_CELLS))
def test_a_kept_mix_runs_as_a_cell_of_data(small_root, capsys, cell):
    """A mix whose cell is out of BENCHMARK.json comes back with a new
    entry alone, and its loop runs correct."""
    add_cell(small_root, cell, *KEPT_CELLS[cell])
    out = _run_ok(small_root, capsys, cell)
    assert set(out["metrics"]) == {"lps_per_s", "setup_s"}
    assert out["attempted"] > 0 and out["failed"] == 0


def test_a_loop_added_as_a_file_runs(small_root, capsys):
    """A new loop is a new file under loops/ that a new mix names; no file
    that is there is edited (this one is a copy of batch_closed)."""
    loops = small_root / "lpbench" / "loops"
    shutil.copy(loops / "batch_closed.py", loops / "batch_again.py")
    add_cell(small_root, "fig3-m256.again", "fig3-m256", "again",
             {"loop": "batch_again", "batch": 16, "rotate": 2,
              "check_calls": 2, "trace_calls": 2})
    c = spec.find_cell("fig3-m256.again", small_root)
    assert c.loop.__module__.endswith("batch_again")
    out = _run_ok(small_root, capsys, "fig3-m256.again")
    assert out["attempted"] > 0


def test_a_problem_kind_added_as_a_file_runs(small_root, capsys):
    """A new configuration whose problem kind is a new file under
    problems/: here every problem's objective turned by a quarter turn."""
    (small_root / "lpbench" / "problems" / "turned.py").write_text(
        "from lpbench.reference import generators\n\n\n"
        "def batch(generator, n, m, dtype, params):\n"
        "    A, b, c = generators.random_feasible_lp(generator, n, m,\n"
        "                                            dtype=dtype)\n"
        "    return A, b, c.flip(-1) * c.new_tensor([-1.0, 1.0])\n")
    cfg = json.loads(
        (small_root / "lpbench" / "configs" / "fig3-m256.json").read_text())
    cfg.update(name="turned", problem={"kind": "turned"})
    (small_root / "lpbench" / "configs" / "turned.json").write_text(
        json.dumps(cfg))
    bench = json.loads((small_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "turned", "source": "test",
                             "file": "lpbench/configs/turned.json",
                             "reduced": [], "why": "test"})
    (small_root / "BENCHMARK.json").write_text(json.dumps(bench))
    add_cell(small_root, "turned.b16", "turned", "b16",
             {"loop": "batch_closed", "batch": 16, "rotate": 2,
              "check_calls": 2, "trace_calls": 2})
    _run_ok(small_root, capsys, "turned.b16")


@pytest.mark.parametrize("where,key,value", [
    ("configs/fig3-m256.json", "problem", {"kind": "no_such_kind"}),
    ("configs/fig3-m256.json", "reference", "lpbench/reference/nowhere.py"),
    ("configs/fig3-m256.json", "reference", "../lp2d.py"),
    ("traffic/b16384.json", "loop", "no_such_loop"),
    ("traffic/b16384.json", "loop", "../drivers"),
])
def test_a_name_with_no_file_is_refused(small_root, capsys, where, key,
                                        value):
    edit_json(small_root / "lpbench" / where, **{key: value})
    with pytest.raises(KeyError):
        spec.find_cell("fig3-m256.b16384", small_root)
    with pytest.raises(KeyError):
        run.main(["--workload", "fig3-m256.b16384", "--seed", "1",
                  "--seconds", "0.1", "--trace", "0"], device="cpu",
                 root=small_root)
    assert capsys.readouterr().out == ""


def test_no_card_no_result(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""
