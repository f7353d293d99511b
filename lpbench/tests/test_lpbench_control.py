"""The control: the reference computed one precision below the
configuration's (bfloat16 for float32, float32 for float64) put in the
program's place, must come out not correct under each configuration's
limits, where the reference at the configuration's own precision passes
them.  (On the card at the cells' own sizes:
``python3 lpbench/control.py --workload <cell> --seeds ... --control``.)"""
from __future__ import annotations

import pytest
import torch
from conftest import ALL_CELLS, KEPT_CELLS, with_cell

from lpbench import control, judge, loadgen, spec

@pytest.mark.parametrize("cell", ALL_CELLS + list(KEPT_CELLS))
@pytest.mark.parametrize("seed", [1, 2**31 + 5, 77])
def test_control_fails_the_limits(small_root, cell, seed):
    c = spec.find_cell(cell, with_cell(small_root, cell),
                      small_root / "lpbench")
    tally = control.control_tally(c, seed, torch.device("cpu"))
    assert tally.compared > 0
    correct, checks = judge.verdict(tally, 0, c.config["limits"])
    assert not correct, checks
    # the objective gap alone fails it, as do the points where they are
    # held as a share of |x|; a float64 configuration holds them to its
    # stated feasibility tolerance (row_viol), which float32 may keep
    assert tally.obj_gap > c.config["limits"]["obj_gap"]
    if "x_viol" in c.config["limits"]:
        assert tally.x_viol > c.config["limits"]["x_viol"]


@pytest.mark.parametrize("dtype,below", sorted(control.BELOW.items()))
def test_the_control_is_one_precision_below(dtype, below):
    assert torch.finfo(getattr(torch, below)).eps > \
        torch.finfo(getattr(torch, dtype)).eps
    assert set(control.BELOW) == set(loadgen.DTYPES)


@pytest.mark.parametrize("seed", [3, 2**31 + 11, 4294967311])
def test_float64_reference_passes_where_float32_fails(small_root, seed):
    """``fig3-m2048-f64`` at a small batch: its limits hold the float64
    reference in the program's place and refuse the float32 control."""
    c = spec.find_cell("fig3-m2048-f64.b2048", small_root)
    assert c.config["dtype"] == "float64"
    cfg, M = c.config, float(c.config["M"])
    tally = judge.Tally(c.reference)
    for A, b, cc, mv in loadgen.batch_inputs(cfg, c.traffic, seed,
                                             torch.device("cpu"), c.problem):
        assert A.dtype == torch.float64
        got = c.reference.solve(A, b, cc, mv, M=M, dtype=torch.float64)
        tally.add(tally.classify(A, b, cc, mv, cfg), A, b, cc, mv, got["x"],
                  got["feasible"], got["objective"], M)
    correct, checks = judge.verdict(tally, 0, cfg["limits"])
    assert correct and tally.compared > 0, checks
    low = control.control_tally(c, seed, torch.device("cpu"))
    correct, checks = judge.verdict(low, 0, cfg["limits"])
    assert not correct, checks
