"""Kernel-vs-PDHG crossover sweep on the port: where does first-order win?

The PyTorch twin of ``benchmarks/pdhg_crossover.py``: the ``kernel``
backend (``rgb_cuda`` on a card) and restarted PDHG (plain torch ops) on
the same packed batches over an ``m`` ladder, one JSON row per (backend,
m) with the reference's keys plus ``card``.

``--smoke`` keeps the reference's two asserts: (1) PDHG *converges* (the
per-problem certificate of ``solve_pdhg_with_stats``) at the largest smoke
``m``, and (2) ``backend="auto"`` resolves to pdhg with the recorded
schedule when a table says it is fastest at large ``m``.  The synthetic
table is keyed by the device kind the resolution looks up: the card's own
name (``current_device_kind``), or ``"cpu"``.
"""
from __future__ import annotations

import argparse
import json

from benchmarks.pt_common import emit, generator, time_fn
from repro_torch.core import pack, random_feasible_lp
from repro_torch.device import as_device, card_info
from repro_torch.pdhg import solve_pdhg_with_stats
from repro_torch.solver import SolverSpec
from repro_torch.tune.table import (M_BUCKET_BASE, TableEntry, TableKey,
                                    TuningTable, bucket_pow2,
                                    current_device_kind, use_table)

SMOKE_MS = (64, 256, 1024)
FULL_MS = (64, 256, 1024, 2048, 4096, 8192)


def _assert_auto_routes_to_pdhg(m_big: int, batch: int,
                                device) -> SolverSpec:
    """Synthetic-table check that auto routing can pick pdhg: with a table
    recording pdhg fastest at ``m_big`` (and kernel fastest at a small
    bucket), ``backend="auto"`` must resolve to pdhg there with the
    entry's (iter_block, restart_period) — and still route the small
    bucket to kernel."""
    platform = device.type
    kind = "cpu" if platform == "cpu" else current_device_kind()
    mk = lambda be, mb, t, ch, us: TableEntry(  # noqa: E731
        TableKey(kind, be, "float32", mb, 0), tile=t, chunk=ch,
        us_per_lp=us)
    mb_small, mb_big = 64, bucket_pow2(m_big, M_BUCKET_BASE)
    table = TuningTable([
        mk("kernel", mb_small, 8, 0, 1.0),
        mk("pdhg", mb_small, 64, 512, 50.0),
        mk("kernel", mb_big, 8, 0, 900.0),
        mk("pdhg", mb_big, 128, 2048, 30.0),
    ])
    with use_table(table):
        small = SolverSpec(backend="auto").resolve_for_shape(
            64, batch, platform=platform)
        big = SolverSpec(backend="auto").resolve_for_shape(
            m_big, batch, platform=platform)
    assert small.backend == "kernel", (
        f"auto at m=64 picked {small.backend!r}, expected kernel")
    assert big.backend == "pdhg", (
        f"auto at m={m_big} picked {big.backend!r}, expected pdhg")
    assert (big.iter_block, big.restart_period) == (128, 2048), (
        "auto did not pin the recorded pdhg schedule: "
        f"({big.iter_block}, {big.restart_period})")
    return big


def case(B: int, m: int, device=None):
    return random_feasible_lp(generator(7 * m + B, device), B, m,
                              device=device)


def run(full: bool = False, smoke: bool = False, *, device=None,
        hold=None):
    device = as_device(device)
    card = card_info()
    ms = FULL_MS if full else SMOKE_MS
    B = 256 if full else 64
    specs = [
        ("kernel", SolverSpec(backend="kernel")),
        ("pdhg", SolverSpec(backend="pdhg")),
    ]
    rows = []
    stats_at_biggest = None
    for m in ms:
        lp = case(B, m, device)
        pb = pack(lp)
        for label, spec in specs:
            solver = spec.build(device)
            dt = time_fn(solver.solve, pb, device=device)
            sol = solver.solve(pb)
            ran = spec.resolve_for_shape(m, B, platform=device.type)
            row = {
                "bench": "pdhg_crossover",
                "backend": label,
                "batch": B,
                "m": m,
                "seconds": dt,
                "us_per_lp": dt / B * 1e6,
                "n_feasible": int(sol.feasible.sum()),
            }
            if label == "pdhg":
                row["iter_block"] = ran.iter_block
                row["restart_period"] = ran.restart_period
            else:
                row["tile"] = ran.tile
                row["chunk"] = ran.chunk
            row["card"] = card
            print(json.dumps(row), flush=True)
            name = f"pdhg_crossover/b{B}/m{m}/{label}"
            rows.append(emit(name, dt, f"per_lp_us={dt/B*1e6:.2f}"))
            if hold is not None:
                hold(name, pb, spec)
        if m == ms[-1]:
            _, stats_at_biggest = solve_pdhg_with_stats(pb)
    if smoke:
        st = stats_at_biggest
        conv = st.converged.cpu()
        kkt = st.kkt.cpu()
        assert bool(conv.all()), (
            f"pdhg failed to converge on {int((~conv).sum())}/{B} "
            f"problems at m={ms[-1]} (max kkt {float(kkt.max()):.3e})")
        routed = _assert_auto_routes_to_pdhg(ms[-1], B, device)
        print(f"pdhg_crossover --smoke ok: pdhg converged {B}/{B} at "
              f"m={ms[-1]} (max kkt {float(kkt.max()):.3e}); auto routed "
              f"m={ms[-1]} -> pdhg/ib{routed.iter_block}/"
              f"rp{routed.restart_period}")
    return rows


def main(argv=None, *, device=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run asserting pdhg convergence and "
                         "auto routing")
    args = ap.parse_args(argv)
    run(full=args.full, smoke=args.smoke, device=device)


if __name__ == "__main__":
    main()
