"""Paper Figure 4 on the port: solve time vs batch amount at fixed LP size.

The PyTorch twin of ``benchmarks/fig4_batch.py`` (the same grid, rows and
scipy cap): the naive and plain RGB backends against the scipy/HiGHS
per-problem loop on the host CPU.  As in the reference there is no
``kernel`` row.
"""
from __future__ import annotations

from benchmarks.pt_common import (emit, generator, host_cpu, plain_timing,
                                  shapes, time_fn)
from benchmarks.pt_fig3_lp_size import scipy_batch
from repro_torch.core import normalize_batch, random_feasible_lp, shuffle_batch
from repro_torch.device import as_device
from repro_torch.solver import SolverSpec

SIZES = (64,)
BATCHES = (64, 256, 1024, 4096, 16384)
QUICK_BATCHES = (64, 512, 4096)
METHODS = ("naive", "rgb")


def case(B: int, m: int, device=None):
    """The batch the figure times at ``(B, m)``."""
    lp = normalize_batch(random_feasible_lp(generator(B * 7 + m, device), B,
                                            m, device=device))
    return shuffle_batch(generator(2, device), lp)


def spec(method: str) -> SolverSpec:
    return SolverSpec(backend=method, normalize=False)


def run(full: bool = False, *, device=None, hold=None,
        plain_quick: bool = False):
    device = as_device(device)
    rows = []
    grid = [(m, B) for m in SIZES for B in BATCHES]
    quick = [(m, B) for m in SIZES for B in QUICK_BATCHES]
    for (m, B), plain in shapes(grid, quick, full, plain_quick):
        lp = case(B, m, device)
        for method in METHODS:
            if method == "rgb" and not plain:
                continue
            s = spec(method)
            solver = s.build(device)
            dt = time_fn(solver.solve, lp, device=device,
                         **(plain_timing(plain_quick) if method == "rgb"
                            else {}))
            name = f"fig4/m{m}/b{B}/{method}"
            rows.append(emit(name, dt, f"per_lp_us={dt/B*1e6:.2f}"))
            if hold is not None:
                hold(name, lp, s)
        if B <= 1024 or full:
            dt, obj = scipy_batch(lp)
            name = f"fig4/m{m}/b{B}/scipy-highs"
            rows.append(emit(name, dt, f"per_lp_us={dt/B*1e6:.2f}"
                             f"|host_cpu={host_cpu()}"))
            if hold is not None:
                hold(name, lp, None, obj)
    return rows


if __name__ == "__main__":
    run(full=True)
