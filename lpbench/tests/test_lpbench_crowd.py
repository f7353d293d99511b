"""The crowd cells: ``crowd-16384.step`` found by name with its files;
both paths of ``crowd_step`` (the direct one and the served one, whose mix
``lpbench/traffic/served.json`` stays in the tree out of ``BENCHMARK.json``,
so that it can come back as data) run on the CPU at a tiny size (4 groups
of 4 x 4 agents) and read correct; a planted fault (each agent's nearest
ORCA row dropped before the solve) reads incorrect; ``crowd_peaks`` counts
a step's bytes."""
from __future__ import annotations

import json

import pytest
import torch
from conftest import ROOT, add_cell, edit_json, last_json

from lpbench import crowd_peaks, run, spec

CELLS = ("crowd-16384.step", "crowd-16384.served")
SERVE_METRIC = {"name": "crowd_serve_ms.lps", "unit": "ms", "better": "lower",
                "source": "program_counter", "layer": "crowd step",
                "moves": "lps_per_s", "workloads": ["crowd-16384.served"]}


@pytest.fixture
def tiny(small_root):
    """``small_root`` with the crowd cut to 64 agents and a short trace,
    and the served cell with its per-layer metric."""
    lp = small_root / "lpbench"
    cfg = json.loads((lp / "configs" / "crowd-16384.json").read_text())
    edit_json(lp / "configs" / "crowd-16384.json",
              problem=dict(cfg["problem"], side=4))
    edit_json(lp / "traffic" / "step.json", trace_steps=3)
    add_cell(small_root, "crowd-16384.served", "crowd-16384", "served")
    bench = json.loads((small_root / "BENCHMARK.json").read_text())
    bench["per_layer"].append(SERVE_METRIC)
    (small_root / "BENCHMARK.json").write_text(json.dumps(bench))
    return small_root


def test_find_cell_finds_the_crowd_cell():
    c = spec.find_cell("crowd-16384.step")
    assert c.config["name"] == "crowd-16384" and c.chips == 1
    assert c.traffic["loop"] == "crowd_step"
    assert c.traffic["path"] == "direct"
    assert c.problem.__file__.endswith("problems/crowd_blocks.py")
    assert c.reference.__file__.endswith("reference/crowd_orca.py")
    assert {m["name"] for m in c.end_to_end} == {"lps_per_s", "setup_s"}
    assert {m["name"] for m in c.per_layer} == {
        "crowd_build_ms.lps", "crowd_build_roofline.lps"}
    assert all(m["layer"] == "crowd step" for m in c.per_layer)


def test_the_served_mix_comes_back_as_data(tiny):
    c = spec.find_cell("crowd-16384.served", tiny)
    assert c.traffic["path"] == "served"
    assert c.traffic["loop"] == "crowd_step"
    assert spec.reader("crowd_serve_ms.lps")


def _run(root, capsys, cell, trace=0):
    rc = run.main(["--workload", cell, "--seed", "2147483659",
                   "--seconds", "0.3", "--trace", str(trace)],
                  device="cpu", root=root)
    assert rc == 0
    out = capsys.readouterr().out
    return last_json(out), json.loads(out.strip().splitlines()[-2])["info"]


@pytest.mark.parametrize("cell,trace", [(c, t) for c in CELLS
                                        for t in (0, 1)])
def test_both_paths_run_on_the_cpu_and_read_correct(tiny, capsys, cell,
                                                    trace):
    out, info = _run(tiny, capsys, cell, trace)
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] % 64 == 0
    assert info["compared"] > 0 and info["unsure_share"] < 0.005
    if trace:
        # host-clocked spans read on the CPU; no device time to read
        assert out["metrics"]["crowd_build_ms.lps"]["value"] > 0
        assert "crowd_build_roofline.lps" not in out["metrics"]
        assert ("crowd_serve_ms.lps" in out["metrics"]) == \
            cell.endswith("served")
    else:
        assert set(out["metrics"]) == {"lps_per_s", "setup_s"}


def _drop_nearest(build):
    """``build`` with each agent's nearest ORCA row (row 8, after the
    octagon) taken out."""
    def fn(state, params, parent=None):
        lp, nb = build(state, params, parent)
        has = lp.m_valid > 8
        keep = torch.cat([lp.A[:, :8], lp.A[:, 9:],
                          torch.zeros_like(lp.A[:, :1])], dim=1)
        b = torch.cat([lp.b[:, :8], lp.b[:, 9:],
                       torch.ones_like(lp.b[:, :1])], dim=1)
        return type(lp)(A=torch.where(has[:, None, None], keep, lp.A),
                        b=torch.where(has[:, None], b, lp.b), c=lp.c,
                        m_valid=torch.where(has, lp.m_valid - 1,
                                            lp.m_valid)), nb
    return fn


@pytest.mark.parametrize("cell", CELLS)
def test_a_dropped_orca_row_reads_incorrect(tiny, capsys, monkeypatch, cell):
    from repro_torch.crowd import step
    monkeypatch.setattr(step, "build", _drop_nearest(step.build))
    out, _ = _run(tiny, capsys, cell)
    assert out["correct"] is False, out["checks"]
    assert out["failed"] == 0


def test_crowd_peaks_counts_a_steps_bytes():
    # 64 agents, 8 octagon rows each and 100 ORCA rows in all, float32:
    # 64 x (8 x 4 state + 2 x 4 c + 4 m_valid) + 612 x 3 x 4
    assert crowd_peaks.build_bytes(64, 612, "float32") == 64 * 44 + 612 * 12
    assert crowd_peaks.build_bytes(16384, 16384 * 18, "float32") == \
        16384 * 44 + 16384 * 18 * 12
    assert crowd_peaks.build_bytes(1, 8, "float64") == 8 * 8 + 16 + 4 + 8 * 24


def test_the_config_keeps_blocks_parameters():
    cfg = json.loads((ROOT / "lpbench" / "configs" /
                      "crowd-16384.json").read_text())
    assert cfg["agents"] == {"neighborDist": 15.0, "maxNeighbors": 10,
                             "timeHorizon": 5.0, "timeHorizonObst": 5.0,
                             "radius": 2.0, "maxSpeed": 2.0}
    assert cfg["timeStep"] == 0.25
    assert (cfg["problem"]["spacing"], cfg["problem"]["corner"],
            cfg["problem"]["perturbation"]) == (10.0, 55.0, 1e-4)
    assert 4 * cfg["problem"]["side"] ** 2 == 16384
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = [c for c in bench["configs"] if c["name"] == "crowd-16384"][0]
    assert entry["reduced"] == list(cfg["reduced"]) == ["obstacles"]
