"""Nothing under lpbench/ imports jax or the JAX package; the reference
imports nothing of the program either.  Top-level module names are
compared whole: ``repro_torch`` is not ``repro``."""
from __future__ import annotations

import ast

import pytest
from conftest import ROOT

BENCH = ROOT / "lpbench"
FILES = sorted(p for p in BENCH.rglob("*.py"))


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    found = set(_imports(path)) & {"jax", "jaxlib", "flax", "repro"}
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize(
    "path", sorted((BENCH / "reference").rglob("*.py")),
    ids=lambda p: p.name)
def test_reference_is_plain(path):
    found = set(_imports(path)) - {"__future__", "math", "typing", "numpy",
                                   "torch", "lpbench"}
    assert not found, f"{path} imports {found}"


def test_whole_names(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import repro_torch.solver\nfrom repro_torch import x\n")
    assert set(_imports(probe)) == {"repro_torch"}


def test_the_run_checks_loaded_modules(monkeypatch):
    import sys
    import types

    from lpbench import run
    monkeypatch.setitem(sys.modules, "jaxlib.xla", types.ModuleType("x"))
    assert "jaxlib" in run.forbidden_modules()
    monkeypatch.delitem(sys.modules, "jaxlib.xla")
    monkeypatch.setitem(sys.modules, "repro_torchish", types.ModuleType("y"))
    assert "repro" not in run.forbidden_modules()


def test_a_reader_that_loads_jax_gets_no_result(small_root, tmp_path,
                                                monkeypatch, capsys):
    """The look at ``sys.modules`` comes after every reader has run: a
    reader that loads a module named ``jax`` (a stub here) ends the run with
    exit code 4 and nothing on standard output."""
    import json
    import sys

    from conftest import edit_json

    from lpbench import run
    stub = tmp_path / "stub"
    (stub / "jax").mkdir(parents=True)
    (stub / "jax" / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(stub))
    (small_root / "lpbench" / "metrics" / "probe_ms.py").write_text(
        "import jax  # noqa: F401\n\n\ndef read(run):\n    return 1.0\n")
    bench = json.loads((small_root / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({"name": "probe_ms", "unit": "ms",
                                "better": "lower", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["fig3-m256.b16384"]})
    (small_root / "BENCHMARK.json").write_text(json.dumps(bench))
    edit_json(small_root / "lpbench" / "traffic" / "b16384.json", batch=8)
    had = sys.modules.get("jax")
    try:
        rc = run.main(["--workload", "fig3-m256.b16384", "--seed", "5",
                       "--seconds", "0.1", "--trace", "0"], device="cpu",
                      root=small_root)
    finally:
        if had is None:
            sys.modules.pop("jax", None)
    assert rc == 4
    out, err = capsys.readouterr()
    assert out == ""
    assert "jax" in err
