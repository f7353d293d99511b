"""The port's benchmark harness entry point — one module per paper figure.

The PyTorch twin of ``benchmarks/run.py``:

``python -m benchmarks.pt_run``          quick pass (CI-sized)
``python -m benchmarks.pt_run --full``   full sweep (paper-sized grids)

Prints ``name,us_per_call,derived`` CSV rows, after two ``#`` lines naming
the card (name and power limit, as ``nvidia-smi`` gives them) and the host
CPU the ``scipy-highs`` rows ran on.  Everything runs on the card;
``main(..., device="cpu")`` runs it on the CPU.

``--plain-quick`` keeps a ``--full`` run's plain ``rgb`` rows to the quick
grid's shapes (the rest of the full grid runs without them), each timed by
one call: on a card the plain backend syncs at every constraint step of
every tile, and one such row takes seconds.

``main(..., hold=fn)`` calls ``fn(name, lp, spec)`` with each solver row's
batch and spec, and ``fn(name, lp, None, objectives)`` for a
``scipy-highs`` row (``nan`` where HiGHS found no optimum): how a smoke run
holds every row it times against another backend.
"""
from __future__ import annotations

import argparse
import inspect

from benchmarks import (pt_fig3_lp_size, pt_fig4_batch, pt_fig5_transfer,
                        pt_fig6_reduction, pt_fig7_naive_vs_rgb,
                        pt_pack_layout, pt_pdhg_crossover, pt_serve_bench,
                        pt_solver_sweep, pt_tune_cli)
from benchmarks.pt_common import host_cpu
from repro_torch.device import as_device, card_info

FIGS = {
    "fig3": pt_fig3_lp_size.run,
    "fig4": pt_fig4_batch.run,
    "fig5": pt_fig5_transfer.run,
    "fig6": pt_fig6_reduction.run,
    "fig7": pt_fig7_naive_vs_rgb.run,
    "serve": pt_serve_bench.run,
    "solver_sweep": pt_solver_sweep.run,
    "pack_layout": pt_pack_layout.run,
    "pdhg_crossover": pt_pdhg_crossover.run,
    "tune": pt_tune_cli.run,
}


def main(argv=None, *, device=None, hold=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--only", default=None,
                    help="comma-separated names (fig3..fig7, serve, "
                         "solver_sweep, pack_layout, pdhg_crossover, "
                         "tune)")
    ap.add_argument("--plain-quick", action="store_true",
                    help="plain rgb rows at the quick grid's shapes only, "
                         "one timed call each")
    args = ap.parse_args(argv)
    device = as_device(device)
    extra = {"device": device, "hold": hold,
             "plain_quick": args.plain_quick}

    only = set(args.only.split(",")) if args.only else set(FIGS)
    print(f"# card={card_info() if device.type == 'cuda' else 'cpu'}")
    print(f"# host_cpu={host_cpu()}")
    print("name,us_per_call,derived")
    rows = []
    for name, fn in FIGS.items():
        if name in only:
            params = inspect.signature(fn).parameters
            out = fn(full=args.full,
                     **{k: v for k, v in extra.items() if k in params})
            rows += [r for r in out or () if isinstance(r, str)]
    return rows


if __name__ == "__main__":
    main()
