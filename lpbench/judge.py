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
  reported objective and for ``c . x`` alike.  Where the configuration
  states a feasibility tolerance (``tolerance["feasibility"]``: the answer's
  point may lie that far outside a unit-normal constraint), the distance is
  from the interval between the optimum and the optimum of the problem with
  every constraint loosened by it: an answer inside it is the optimum of the
  problem within that tolerance.
* ``x_viol``: over answers flagged feasible, the largest violation of ``x``
  of a unit-normal constraint or the box, as a share of ``max(1, |x|)``.
* ``row_viol``: the same violation as a distance, not divided by ``|x|``.
  A configuration that states a feasibility tolerance holds its points to
  it with this number.

Answers that never came, or came as an error, are ``failed``; limit 0.
A configuration's ``limits`` name ``failed``, ``wrong``, ``obj_gap`` and at
least one of ``x_viol`` and ``row_viol``; the numbers it names are compared.
"""
from __future__ import annotations

import dataclasses
import math
from types import ModuleType
from typing import Dict, Tuple

import torch

NUMBERS = ("failed", "wrong", "obj_gap", "x_viol", "row_viol")


@dataclasses.dataclass
class Tally:
    reference: ModuleType
    compared: int = 0
    wrong: int = 0
    obj_gap: float = 0.0
    x_viol: float = 0.0
    row_viol: float = 0.0

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
            hi = ref["objective_hi"]
            cx = (c.to(dev, torch.float64) * x64).sum(dim=1)
            scale = torch.clamp(opt.abs(), min=1.0)

            def outside(v):
                return torch.clamp(opt - v, min=0) + torch.clamp(v - hi, min=0)
            gap = torch.maximum(
                outside(objective.to(dev, torch.float64)), outside(cx)) / scale
            gap = torch.nan_to_num(gap, nan=math.inf)
            self.obj_gap = max(self.obj_gap, float(gap[sel].max()))
        if bool(f.any()):
            v = self.reference.violation(A.to(dev), b.to(dev), mv.to(dev),
                                         x64, M=M, relative=False)
            v = torch.nan_to_num(v, nan=math.inf)
            rel = torch.nan_to_num(
                v / torch.clamp(x64.abs().amax(dim=1), min=1.0), nan=math.inf)
            self.row_viol = max(self.row_viol, float(v[f].max()))
            self.x_viol = max(self.x_viol, float(rel[f].max()))

    def classify(self, A, b, c, mv, config: dict) -> Dict:
        """The reference's verdict on problems ``(A, b, c, mv)`` at the
        configuration's box and tolerance."""
        tol = config["tolerance"]
        return self.reference.classify(
            A, b, c, mv, M=float(config["M"]), band=float(tol["band"]),
            slacks=tuple(tol["slacks"]),
            feasibility=float(tol.get("feasibility", 0.0)))


def verdict(tally: Tally, failed: int, limits: dict) -> Tuple[bool, dict]:
    """``(correct, checks)``: each number beside its limit."""
    values = {"failed": failed, "wrong": tally.wrong,
              "obj_gap": tally.obj_gap, "x_viol": tally.x_viol,
              "row_viol": tally.row_viol}
    checks = {k: {"value": values[k], "limit": limits[k]} for k in NUMBERS
              if k in limits}
    correct = tally.compared > 0 and all(
        v["value"] <= v["limit"] for v in checks.values())
    return correct, checks
