"""SolverSpec sweep on the port: one batch, every backend, one JSON row each.

The PyTorch twin of ``benchmarks/solver_sweep.py``: the same specs, rows
and JSON keys (plus ``card``), each row naming the geometry that ran
(``SolverSpec.resolve_for_shape`` on the device's platform: the bundled
tuning table's row where it has one, else the heuristic).
"""
from __future__ import annotations

import json

from benchmarks.pt_common import emit, generator, plain_timing, time_fn
from repro_torch.core import random_feasible_lp
from repro_torch.device import as_device, card_info
from repro_torch.solver import SolverSpec

FULL_SHAPE = (4096, 256)
QUICK_SHAPE = (512, 64)
PLAIN = ("rgb",)


def sweep_specs(full: bool = False):
    """The canonical sweep: every backend, plus rgb tile/chunk tuning
    points when --full."""
    specs = [
        ("naive", SolverSpec(backend="naive", shuffle=True)),
        ("rgb", SolverSpec(backend="rgb", shuffle=True)),
        ("rgb-t8-c64", SolverSpec(backend="rgb", tile=8, chunk=64,
                                  shuffle=True)),
        ("kernel", SolverSpec(backend="kernel", shuffle=True)),
    ]
    if full:
        specs += [
            ("rgb-t128", SolverSpec(backend="rgb", tile=128,
                                    shuffle=True)),
            ("rgb-t32-c64", SolverSpec(backend="rgb", tile=32, chunk=64,
                                       shuffle=True)),
        ]
    return specs


def case(B: int, m: int, device=None):
    return random_feasible_lp(generator(42, device), B, m, device=device)


def run(full: bool = False, *, device=None, hold=None,
        plain_quick: bool = False):
    """One sweep at the quick or the full shape; with ``plain_quick`` the
    full shape without the plain ``rgb`` rows, then the full spec list at
    the quick shape."""
    device = as_device(device)
    card = card_info()
    if not full:
        plan = [(QUICK_SHAPE, True)]
    elif plain_quick:
        plan = [(FULL_SHAPE, False), (QUICK_SHAPE, True)]
    else:
        plan = [(FULL_SHAPE, True)]
    rows = []
    for (B, m), plain in plan:
        lp = case(B, m, device)
        for label, spec in sweep_specs(full):
            if spec.backend in PLAIN and not plain:
                continue
            solver = spec.build(device)
            dt = time_fn(solver.solve, lp, device=device,
                         **(plain_timing(plain_quick)
                            if spec.backend in PLAIN else {}))
            sol = solver.solve(lp)
            ran = spec.resolve_for_shape(m, B, platform=device.type)
            row = {
                "bench": "solver_sweep",
                "label": label,
                "backend": ran.backend,
                "tile": ran.tile,
                "chunk": ran.chunk,
                "batch": B,
                "m": m,
                "seconds": dt,
                "us_per_lp": dt / B * 1e6,
                "n_feasible": int(sol.feasible.sum()),
                "card": card,
            }
            print(json.dumps(row), flush=True)
            name = f"solver_sweep/b{B}/m{m}/{label}"
            rows.append(emit(name, dt, f"per_lp_us={dt/B*1e6:.2f}"))
            if hold is not None:
                hold(name, lp, spec)
    return rows


if __name__ == "__main__":
    run(full=True)
