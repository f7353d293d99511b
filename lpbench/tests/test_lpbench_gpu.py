"""On the card: each cell end to end as the driver runs it, briefly, and
the control at the cell's own size.  Skips where there is no card."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch
from conftest import ROOT, last_json

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(cell, trace):
    _card()
    r = subprocess.run(
        [sys.executable, "lpbench/run.py", "--workload", cell,
         "--seed", "3000000019", "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert r.returncode == 0, r.stderr[-4000:]
    out = last_json(r.stdout)
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    wanted = {m["name"] for m in BENCH["per_layer" if trace else "end_to_end"]
              if "workloads" not in m or cell in m["workloads"]}
    assert set(out["metrics"]) == wanted
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        for name, m in out["metrics"].items():
            if name.endswith("_roofline.lps"):
                assert 0 < m["value"] <= 100


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell):
    _card()
    from lpbench import control, judge, spec
    c = spec.find_cell(cell)
    tally = control.control_tally(c, 5, torch.device("cuda", 0))
    correct, checks = judge.verdict(tally, 0, c.config["limits"])
    assert not correct, checks
