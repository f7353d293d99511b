"""Packed-layout microbenchmark on the port: what does pre-packing buy?

The PyTorch twin of ``benchmarks/pack_layout.py``.  Three ways to solve the
same batch stream through one Solver:

* ``aos``      — solve the AoS ``LPBatch`` (the solver packs where the
  backend needs it);
* ``packed``   — pack once up front, solve the ``PackedLPBatch``
  repeatedly (the serving shape);
* ``repack``   — re-pack the AoS batch *on every call* (the regression
  baseline).

One JSON row per (variant, backend) (the reference's keys plus ``card``)
alongside the harness CSV line, with the ``pack_calls`` each variant made
(``repro_torch.core.packed.pack_call_count``).  ``--smoke`` runs a CI-sized
grid and *asserts* that the pre-packed variant packs zero times and
matches the AoS results bit for bit.

    python -m benchmarks.pt_pack_layout          # quick grid
    python -m benchmarks.pt_pack_layout --full   # paper-sized grid
    python -m benchmarks.pt_pack_layout --smoke  # CI assertion mode
"""
from __future__ import annotations

import argparse
import json

import torch

from benchmarks.pt_common import emit, generator, plain_timing, shapes, time_fn
from repro_torch.core import pack, pack_call_count, random_feasible_lp
from repro_torch.device import as_device, card_info
from repro_torch.solver import SolverSpec

FULL_GRID = ((4096, 64), (4096, 512), (16384, 128))
QUICK_GRID = ((512, 64),)
SMOKE_GRID = ((64, 32),)


def _specs(smoke: bool):
    specs = [("rgb", SolverSpec(backend="rgb"))]
    if smoke:
        specs.append(("kernel", SolverSpec(backend="kernel")))
    return specs


def case(B: int, m: int, device=None):
    return random_feasible_lp(generator(B + m, device), B, m, device=device)


def run(full: bool = False, smoke: bool = False, *, device=None, hold=None,
        plain_quick: bool = False):
    """With ``plain_quick`` a ``--full`` run visits the quick grid only:
    every row of this module is the plain ``rgb`` backend's (the kernel's
    rows are ``--smoke``'s)."""
    device = as_device(device)
    card = card_info()
    if smoke:
        grid = list(SMOKE_GRID)
    else:
        grid = [s for s, plain in shapes(FULL_GRID, QUICK_GRID, full,
                                         plain_quick) if plain]
    iters = 2 if smoke else 3
    timing = {"warmup": 1, "iters": iters,
              **plain_timing(plain_quick and not smoke)}
    rows = []
    for B, m in grid:
        lp = case(B, m, device)
        pb = pack(lp)
        for label, spec in _specs(smoke):
            solver = spec.build(device)
            variants = {
                "aos": lambda: solver.solve(lp),
                "packed": lambda: solver.solve(pb),
                "repack": lambda: solver.solve(pack(lp)),
            }
            results = {}
            for variant, fn in variants.items():
                n0 = pack_call_count()
                dt = time_fn(fn, device=device, **timing)
                n_calls = pack_call_count() - n0
                results[variant] = (dt, n_calls, fn())
                row = {
                    "bench": "pack_layout", "variant": variant,
                    "backend": label, "batch": B, "m": m,
                    "seconds": dt, "us_per_lp": dt / B * 1e6,
                    "pack_calls": n_calls, "card": card,
                }
                print(json.dumps(row), flush=True)
                name = f"pack_layout/b{B}/m{m}/{label}/{variant}"
                rows.append(emit(name, dt, f"pack_calls={n_calls}"))
                if hold is not None:
                    hold(name, pb if variant == "packed" else lp, spec)
            if smoke:
                calls_packed = results["packed"][1]
                assert calls_packed == 0, (
                    f"pre-packed solve repacked {calls_packed}x on "
                    f"{label}")
                assert results["repack"][1] >= iters, (
                    "repack variant should pack per call")
                x_packed = results["packed"][2].x
                x_aos = results["aos"][2].x
                assert torch.equal(x_packed.view(torch.int32),
                                   x_aos.view(torch.int32)), (
                    f"packed != AoS on {label}")
    if smoke:
        print("pack_layout --smoke ok: pre-packed path does zero "
              "AoS->SoA repacks and matches AoS bit-for-bit")
    return rows


def main(argv=None, *, device=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run asserting the no-repack claim")
    args = ap.parse_args(argv)
    run(full=args.full, smoke=args.smoke, device=device)


if __name__ == "__main__":
    main()
