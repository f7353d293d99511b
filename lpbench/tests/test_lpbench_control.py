"""The control: the reference computed in bfloat16, the precision below the
configurations' float32, put in the program's place, must come out not
correct under each configuration's limits.  (On the card at the cells' own
sizes: ``python3 lpbench/control.py --workload <cell> --seeds ... --control``.)"""
from __future__ import annotations

import pytest
import torch
from conftest import ALL_CELLS, KEPT_CELLS, with_cell

from lpbench import control, judge, spec

@pytest.mark.parametrize("cell", ALL_CELLS + list(KEPT_CELLS))
@pytest.mark.parametrize("seed", [1, 2**31 + 5, 77])
def test_control_fails_the_limits(small_root, cell, seed):
    c = spec.find_cell(cell, with_cell(small_root, cell),
                      small_root / "lpbench")
    tally = control.control_tally(c, seed, torch.device("cpu"))
    assert tally.compared > 0
    correct, checks = judge.verdict(tally, 0, c.config["limits"])
    assert not correct, checks
    # the objective gap alone fails it, as do the points
    assert tally.obj_gap > c.config["limits"]["obj_gap"]
    assert tally.x_viol > c.config["limits"]["x_viol"]
