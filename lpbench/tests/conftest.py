"""Shared fixtures of the benchmark's tests: the repository on the path, and
a small copy of the checkout (``BENCHMARK.json`` and ``lpbench/`` without
its tests) whose cells are cut to sizes the CPU runs in seconds."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path
from typing import Optional

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# The cuts: sizes only; every loop, mix and limit is the real one.
SMALL = {
    "traffic/b16384.json": {"batch": 32, "check_calls": 2, "trace_calls": 3},
    "traffic/b2048.json": {"batch": 32, "check_calls": 2, "trace_calls": 3},
    "traffic/b131072.json": {"batch": 32, "check_calls": 2, "trace_calls": 3},
    "traffic/open.json": {"rate": 150.0, "pool": 64, "trace_seconds": 0.3},
    "traffic/closed256.json": {"outstanding": 16, "pool": 64,
                               "capacity": 20000, "trace_seconds": 0.3},
    "configs/servemix.json": {"sizes": [8, 16, 32, 64]},
    "configs/fig3-m256.json": {"m": 24},
    "configs/fig3-m2048-f64.json": {"m": 24},
}


ALL_CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]

# Cells out of BENCHMARK.json whose mix and loop stay, so that a later cell
# can come back as data alone: the tests add them to the small checkout.
KEPT_CELLS = {"servemix.closed256": ("servemix", "closed256")}


def edit_json(path: Path, **kw) -> None:
    obj = json.loads(path.read_text())
    obj.update(kw)
    path.write_text(json.dumps(obj, indent=1))


@pytest.fixture
def small_root(tmp_path) -> Path:
    """A checkout holding ``BENCHMARK.json`` and ``lpbench`` (the files
    found by name among them), at small sizes."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "lpbench", tmp_path / "lpbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for rel, kw in SMALL.items():
        edit_json(tmp_path / "lpbench" / rel, **kw)
    return tmp_path


def add_cell(root: Path, name: str, config: str, traffic: str,
             mix: Optional[dict] = None) -> None:
    """A BENCHMARK.json entry reporting ``lps_per_s`` and nothing else, and
    ``traffic/<traffic>.json`` where ``mix`` is given."""
    if mix is not None:
        (root / "lpbench" / "traffic" / f"{traffic}.json").write_text(
            json.dumps(mix))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": name, "config": config,
                               "traffic": traffic, "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "lps_per_s" in (m["name"], m.get("moves")) and "workloads" in m:
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def with_cell(root: Path, cell: str) -> Path:
    """``root``, with ``cell`` added back if it is one of ``KEPT_CELLS``."""
    if cell in KEPT_CELLS:
        add_cell(root, cell, *KEPT_CELLS[cell])
    return root


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])
