"""The plain reference on hand-built LPs whose answers are known."""
from __future__ import annotations

import math

import pytest
import torch

from lpbench.reference import lp2d

M = 1.0e4


def _batch(problems):
    """``[(rows [(ax, ay, b), ...], (cx, cy)), ...]`` -> padded tensors."""
    m = max(len(r) for r, _ in problems)
    A = torch.zeros((len(problems), m, 2), dtype=torch.float64)
    b = torch.ones((len(problems), m), dtype=torch.float64)
    c = torch.tensor([cc for _, cc in problems], dtype=torch.float64)
    mv = torch.tensor([len(r) for r, _ in problems], dtype=torch.int32)
    for i, (rows, _) in enumerate(problems):
        for j, (ax, ay, bb) in enumerate(rows):
            A[i, j] = torch.tensor([ax, ay])
            b[i, j] = bb
    return A, b, c, mv


CASES = [
    # the unit square: x <= 1, y <= 1, -x <= 0, -y <= 0; max x + y at (1, 1)
    ([(1, 0, 1), (0, 1, 1), (-1, 0, 0), (0, -1, 0)], (1, 1), True, (1, 1)),
    # unnormalised rows scale away: 2x <= 4, 3y <= 3 -> (2, 1)
    ([(2, 0, 4), (0, 3, 3)], (1, 1), True, (2, 1)),
    # nothing binds but the box: the corner (M, -M)
    ([(-1, 0, 5)], (1, -1), True, (M, -M)),
    # x >= 1 and x <= -1: empty
    ([(1, 0, -1), (-1, 0, -1), (0, 1, 3)], (0, 1), False, None),
    # a triangle: y <= 2 - x, y <= 2 + x, y >= 0 -> top at (0, 2)
    ([(1, 1, 2), (-1, 1, 2), (0, -1, 0)], (0, 1), True, (0, 2)),
    # padding rows past m_valid are ignored (see _batch), a zero row is not
    ([(0, 0, -1), (1, 0, 1)], (1, 0), False, None),
]


@pytest.mark.parametrize("rows,c,feasible,x", CASES)
def test_known_answers(rows, c, feasible, x):
    A, b, cc, mv = _batch([(rows, c)])
    out = lp2d.solve(A, b, cc, mv, M=M)
    assert bool(out["feasible"][0]) is feasible
    if feasible:
        got = out["x"][0].tolist()
        assert got == pytest.approx(list(x), abs=1e-9 * max(1.0, abs(x[0])))
        assert float(out["objective"][0]) == pytest.approx(
            c[0] * x[0] + c[1] * x[1], abs=1e-9 * M)


def test_batched_equals_one_by_one():
    problems = [(r, c) for r, c, _, _ in CASES]
    A, b, c, mv = _batch(problems)
    whole = lp2d.solve(A, b, c, mv, M=M, block=3)
    for i in range(len(problems)):
        one = lp2d.solve(A[i:i + 1], b[i:i + 1], c[i:i + 1], mv[i:i + 1], M=M)
        assert bool(one["feasible"][0]) == bool(whole["feasible"][i])


def test_band_classification():
    # x <= 1 and x >= 1 + 1e-6: empty by 1e-6, inside a band of 1e-3
    A, b, c, mv = _batch([([(1, 0, 1), (-1, 0, -1 - 1e-6)], (0, 1)),
                          ([(1, 0, 1), (-1, 0, -1.5)], (0, 1)),
                          ([(1, 0, 1), (-1, 0, 0.5)], (0, 1))])
    ref = lp2d.classify(A, b, c, mv, M=M, band=1e-3, slacks=(1e-5,))
    assert ref["sure_feasible"].tolist() == [False, False, True]
    assert ref["sure_infeasible"].tolist() == [False, True, False]
    # the first is answered at the slack that makes it feasible: y at the box
    assert float(ref["objective"][0]) == pytest.approx(M)


def test_a_single_point_is_in_the_band():
    # three lines through (3, -2) only: feasible to rounding, so either
    # flag is right, and the optimum is that point
    A, b, c, mv = _batch([([(1, 0, 3), (-1, 1, -5), (-1, -1, -1)],
                           (0.3, 0.7))])
    ref = lp2d.classify(A, b, c, mv, M=M, band=1e-3, slacks=(1e-5, 1e-4))
    assert not bool(ref["sure_feasible"][0])
    assert not bool(ref["sure_infeasible"][0])
    assert float(ref["objective"][0]) == pytest.approx(0.3 * 3 - 0.7 * 2,
                                                       abs=1e-4)


def test_violation_of_a_point():
    A, b, c, mv = _batch([([(1, 0, 1), (0, 1, 1)], (1, 1))])
    x = torch.tensor([[1.5, 0.0]], dtype=torch.float64)
    assert float(lp2d.violation(A, b, mv, x, M=M)[0]) == pytest.approx(0.5 / 1.5)
    x = torch.tensor([[2 * M, 0.0]], dtype=torch.float64)
    assert float(lp2d.violation(A, b, mv, x, M=M)[0]) == pytest.approx(
        (2 * M - 1) / (2 * M))
    assert float(lp2d.violation(A, b, mv, x, M=M, relative=False)[0]) == \
        pytest.approx(2 * M - 1)


@pytest.mark.parametrize("off,ok", [(0.9e-5, True), (1.2e-5, False)])
def test_row_viol_holds_a_point_to_the_tolerance_as_a_distance(off, ok):
    # a point at |x| = 100, `off` outside the row x <= 100, at the optimum
    # y = 0: as a share of |x| it lies 100 times closer, inside 1e-5 either
    # way, and its objective is exact, so row_viol alone decides
    from lpbench import judge
    A, b, c, mv = _batch([([(1, 0, 100), (0, 1, 0)], (0, 1))])
    x = torch.tensor([[100 + off, 0.0]], dtype=torch.float64)
    t = judge.Tally(lp2d)
    ref = t.classify(A, b, c, mv, {"M": M, "tolerance": {
        "band": 1e-3, "slacks": [], "feasibility": 1e-5}})
    t.add(ref, A, b, c, mv, x, torch.ones(1, dtype=torch.bool),
          torch.tensor([0.0], dtype=torch.float64), M)
    assert t.obj_gap == 0
    assert t.row_viol == pytest.approx(off, rel=1e-9)
    assert t.x_viol == pytest.approx(off / (100 + off), rel=1e-9)
    limits = {"failed": 0, "wrong": 0, "obj_gap": 1e-9, "row_viol": 1.0001e-5}
    correct, checks = judge.verdict(t, 0, limits)
    assert correct is ok, checks
    assert set(checks) == set(limits)


def test_random_problems_optimal_and_feasible():
    g = torch.Generator().manual_seed(9)
    from lpbench.reference import generators
    A, b, c = generators.random_feasible_lp(g, 64, 40, dtype=torch.float64)
    mv = torch.full((64,), 40, dtype=torch.int32)
    out = lp2d.solve(A, b, c, mv, M=M)
    assert out["feasible"].all()
    assert float(lp2d.violation(A, b, mv, out["x"], M=M).max()) < 1e-9
    # no feasible point of a fine grid around x beats it
    for i in range(8):
        x0 = out["x"][i]
        ang = torch.linspace(0, 2 * math.pi, 64, dtype=torch.float64)
        pts = x0 + 1e-3 * torch.stack([ang.cos(), ang.sin()], 1)
        feas = ((A[i] @ pts.T) <= b[i][:, None] + 1e-12).all(0)
        better = (pts @ c[i]) > float(out["objective"][i]) + 1e-9
        assert not (feas & better).any()


def test_bfloat16_runs():
    A, b, c, mv = _batch([(r, c) for r, c, _, _ in CASES])
    out = lp2d.solve(A, b, c, mv, M=M, dtype=torch.bfloat16)
    assert out["x"].dtype == torch.bfloat16


def test_the_default_block_leaves_every_answer_as_it_was():
    g = torch.Generator().manual_seed(4)
    from lpbench.reference import generators
    A, b, c = generators.random_feasible_lp(g, 40, 12, dtype=torch.float64)
    mv = torch.full((40,), 12, dtype=torch.int32)
    whole = lp2d.solve(A, b, c, mv, M=M)
    parts = lp2d.solve(A, b, c, mv, M=M, block=7)
    for k in whole:
        assert torch.equal(whole[k], parts[k]), k
    assert lp2d._block(None, 64) > lp2d._block(None, 2048) == 2048
    assert lp2d._block(5, 64) == 5


def test_objective_within_the_feasibility_tolerance():
    # the unit square's corner (1, 1), and a third row x + y <= 2 - 4e-6
    # that it misses by 2.8e-6 along the row's unit normal
    rows = [(1, 0, 1), (0, 1, 1), (1, 1, 2 - 4e-6)]
    A, b, c, mv = _batch([(rows, (1, 1))])
    plain = lp2d.classify(A, b, c, mv, M=M, band=1e-3, slacks=())
    assert torch.equal(plain["objective_hi"], plain["objective"])
    ref = lp2d.classify(A, b, c, mv, M=M, band=1e-3, slacks=(),
                        feasibility=1e-5)
    assert float(ref["objective"][0]) == pytest.approx(2 - 4e-6, abs=1e-12)
    # every row loosened by 1e-5 along its unit normal: the third still
    # binds, 1e-5 * sqrt(2) farther out, past the corner's 2
    assert float(ref["objective_hi"][0]) == pytest.approx(
        2 - 4e-6 + 1e-5 * math.sqrt(2), abs=1e-12)
    from lpbench import judge
    x = torch.tensor([[1.0, 1.0]], dtype=torch.float64)   # the corner
    for cfg, gap in (({"band": 1e-3, "slacks": []}, 4e-6 / (2 - 4e-6)),
                     ({"band": 1e-3, "slacks": [], "feasibility": 1e-5}, 0)):
        t = judge.Tally(lp2d)
        r = t.classify(A, b, c, mv, {"M": M, "tolerance": cfg})
        t.add(r, A, b, c, mv, x, torch.ones(1, dtype=torch.bool),
              torch.tensor([2.0], dtype=torch.float64), M)
        assert t.obj_gap == pytest.approx(gap, abs=1e-12)
    # a point below the optimum is as far off either way
    t = judge.Tally(lp2d)
    t.add(ref, A, b, c, mv, 0.5 * x, torch.ones(1, dtype=torch.bool),
          torch.tensor([1.0], dtype=torch.float64), M)
    assert t.obj_gap == pytest.approx((1 - 4e-6) / (2 - 4e-6), abs=1e-12)
