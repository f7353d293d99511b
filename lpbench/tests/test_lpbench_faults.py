"""A whole run on the CPU (the look for a card skipped) with the timed path
broken underneath: ``correct`` must come out false for each fault a cell
can have, and true with none.  The faults are planted in the kernel's
function (on the CPU the program runs its plain version): an answer altered
where it is produced, and half of each batch left unsolved."""
from __future__ import annotations

import pytest
import torch
from conftest import ALL_CELLS, KEPT_CELLS, last_json, with_cell

from lpbench import run

def _altered(plain):
    def fn(L, c, m_valid, **kw):
        x, feas = plain(L, c, m_valid, **kw)
        x = x.clone()
        x[0] += 1.0
        return x, feas
    return fn


def _half(plain):
    def fn(L, c, m_valid, **kw):
        x, feas = plain(L, c, m_valid, **kw)
        h = (x.shape[0] + 1) // 2
        x = torch.cat([x[:h], torch.zeros_like(x[h:])])
        feas = torch.cat([feas[:h], torch.ones_like(feas[h:])])
        return x, feas
    return fn


FAULTS = {"none": None, "answer_altered": _altered, "half_unsolved": _half}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("cell", ALL_CELLS + list(KEPT_CELLS))
def test_fault_is_caught(small_root, monkeypatch, capsys, cell, fault):
    from repro_torch.kernels import batch_lp
    if FAULTS[fault] is not None:
        monkeypatch.setattr(batch_lp, "rgb_plain",
                            FAULTS[fault](batch_lp.rgb_plain))
    rc = run.main(["--workload", cell, "--seed", "4294967311",
                   "--seconds", "0.4", "--trace", "0"],
                  device="cpu", root=with_cell(small_root, cell))
    assert rc == 0
    out = last_json(capsys.readouterr().out)
    assert out["correct"] is (fault == "none"), out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
