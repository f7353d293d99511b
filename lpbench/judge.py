"""The comparison that decides ``correct``.

Each answer the timed path produced (``x``, the feasibility flag and the
reported objective) is held against the reference the configuration names
(``config["reference"]``, :mod:`lpbench.reference.lp2d` for both
configurations today) on the inputs the harness made.  A reference module
gives ``classify``, ``violation`` and ``solve`` as ``lp2d`` does.  Three
numbers, each with the limit the configuration states:

* ``wrong``: answers whose flag contradicts the reference where the
  reference is sure: feasible with every constraint tightened by the band,
  or infeasible with every constraint loosened by it.  An exact count, limit
  0.
* ``obj_gap``: over answers flagged feasible (and not surely infeasible),
  the largest ``|objective - optimum| / max(1, |optimum|)``, taken for the
  reported objective and for ``c . x`` alike.
* ``x_viol``: over answers flagged feasible, the largest violation of ``x``
  of a unit-normal constraint or the box, as a share of ``max(1, |x|)``.

Answers that never came, or came as an error, are ``failed``; limit 0.
"""
from __future__ import annotations

import dataclasses
import math
from types import ModuleType
from typing import Dict, Tuple

import torch

NUMBERS = ("failed", "wrong", "obj_gap", "x_viol")


@dataclasses.dataclass
class Tally:
    reference: ModuleType
    compared: int = 0
    wrong: int = 0
    obj_gap: float = 0.0
    x_viol: float = 0.0

    def add(self, ref: Dict, A, b, c, mv, x, feasible, objective,
            M: float) -> None:
        """Fold in one group of answers to problems ``(A, b, c, mv)`` whose
        :meth:`classify` is ``ref`` (all on one device)."""
        n = int(feasible.shape[0])
        if not n:
            return
        dev = ref["objective"].device
        f = feasible.to(dev).bool()
        x64 = x.to(dev, torch.float64)
        sure_f, sure_i = ref["sure_feasible"], ref["sure_infeasible"]
        self.compared += n
        self.wrong += int(((f & sure_i) | (~f & sure_f)).sum())
        sel = f & ~sure_i
        if bool(sel.any()):
            opt = ref["objective"]
            cx = (c.to(dev, torch.float64) * x64).sum(dim=1)
            scale = torch.clamp(opt.abs(), min=1.0)
            gap = torch.maximum(
                (objective.to(dev, torch.float64) - opt).abs(),
                (cx - opt).abs()) / scale
            gap = torch.nan_to_num(gap, nan=math.inf)
            self.obj_gap = max(self.obj_gap, float(gap[sel].max()))
        if bool(f.any()):
            v = self.reference.violation(A.to(dev), b.to(dev), mv.to(dev),
                                         x64, M=M)
            v = torch.nan_to_num(v, nan=math.inf)
            self.x_viol = max(self.x_viol, float(v[f].max()))

    def classify(self, A, b, c, mv, config: dict) -> Dict:
        """The reference's verdict on problems ``(A, b, c, mv)`` at the
        configuration's box and tolerance."""
        tol = config["tolerance"]
        return self.reference.classify(A, b, c, mv, M=float(config["M"]),
                                       band=float(tol["band"]),
                                       slacks=tuple(tol["slacks"]))


def verdict(tally: Tally, failed: int, limits: dict) -> Tuple[bool, dict]:
    """``(correct, checks)``: each number beside its limit."""
    values = {"failed": failed, "wrong": tally.wrong,
              "obj_gap": tally.obj_gap, "x_viol": tally.x_viol}
    checks = {k: {"value": values[k], "limit": limits[k]} for k in NUMBERS}
    correct = tally.compared > 0 and all(
        values[k] <= limits[k] for k in NUMBERS)
    return correct, checks
