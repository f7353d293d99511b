"""Paper Figure 3 on the port: solve time vs LP size at fixed batch counts.

The PyTorch twin of ``benchmarks/fig3_lp_size.py``: NaiveRGB (every lane
pays every re-solve), RGB (the plain cooperative tiles), the ``kernel``
backend (``rgb_cuda`` on a card; its plain version on the CPU) and the
scipy/HiGHS per-problem loop on the host CPU, over the same grid and row
names.  On a card the separation the paper draws is ``kernel`` against
``naive`` and ``scipy-highs``: the plain ``rgb`` backend is a Python loop
over tiles that syncs at every constraint step, the port's oracle rather
than its fast path.
"""
from __future__ import annotations

import time

import numpy as np

from benchmarks.pt_common import (emit, generator, host_cpu, plain_timing,
                                  shapes, time_fn)
from repro_torch.core import normalize_batch, random_feasible_lp, shuffle_batch
from repro_torch.device import as_device
from repro_torch.solver import SolverSpec

BATCHES = (128, 2048)
SIZES = (8, 32, 128, 512, 2048)
QUICK = ((128,), (8, 64, 512))
METHODS = ("naive", "rgb", "kernel")
SCIPY_CAP = 256  # per-problem python loop gets slow; cap and extrapolate


def case(B: int, m: int, device=None):
    """The batch the figure times at ``(B, m)``: normalised, then in a
    random constraint order (the reference's keys as seeds)."""
    lp = normalize_batch(random_feasible_lp(generator(B + m, device), B, m,
                                            device=device))
    return shuffle_batch(generator(1, device), lp)


def spec(method: str) -> SolverSpec:
    """What a ``method`` row times (the batch is normalised already)."""
    return SolverSpec(backend=method, normalize=False)


def scipy_batch(lp):
    """HiGHS on the host, one problem at a time, on float64 copies of the
    first ``SCIPY_CAP`` problems (copied before the clock starts):
    ``(seconds extrapolated to the whole batch, objectives)``, an
    objective ``nan`` where HiGHS found no optimum."""
    from scipy.optimize import linprog
    n = min(lp.batch, SCIPY_CAP)
    A = lp.A[:n].double().cpu().numpy()
    b = lp.b[:n].double().cpu().numpy()
    c = lp.c[:n].double().cpu().numpy()
    obj = np.full((n,), np.nan)
    t0 = time.perf_counter()
    for i in range(n):
        res = linprog(-c[i], A_ub=A[i], b_ub=b[i],
                      bounds=[(-1e4, 1e4)] * 2, method="highs")
        if res.status == 0:
            obj[i] = -res.fun
    dt = time.perf_counter() - t0
    return dt * (lp.batch / n), obj


def run(full: bool = False, *, device=None, hold=None,
        plain_quick: bool = False):
    device = as_device(device)
    rows = []
    grid = [(B, m) for B in BATCHES for m in SIZES]
    quick = [(B, m) for B in QUICK[0] for m in QUICK[1]]
    for (B, m), plain in shapes(grid, quick, full, plain_quick):
        lp = case(B, m, device)
        for method in METHODS:
            if method == "rgb" and not plain:
                continue
            s = spec(method)
            solver = s.build(device)
            dt = time_fn(solver.solve, lp, device=device,
                         **(plain_timing(plain_quick) if method == "rgb"
                            else {}))
            name = f"fig3/b{B}/m{m}/{method}"
            rows.append(emit(name, dt, f"per_lp_us={dt/B*1e6:.2f}"))
            if hold is not None:
                hold(name, lp, s)
        dt, obj = scipy_batch(lp)
        name = f"fig3/b{B}/m{m}/scipy-highs"
        rows.append(emit(name, dt, f"per_lp_us={dt/B*1e6:.2f}"
                         f"|host_cpu={host_cpu()}"))
        if hold is not None:
            hold(name, lp, None, obj)
    return rows


if __name__ == "__main__":
    run(full=True)
