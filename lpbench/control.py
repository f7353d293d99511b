"""The readings a limit of the comparison is set from.

    python3 lpbench/control.py --workload <cell> --seeds 1,2,3 [--program 1.5]
                               [--control]

For each seed, in one process on the card:

* ``--program S``: the cell's own loop for ``S`` seconds, as a run drives it,
  and the numbers its answers read against the reference (the lower
  readings);
* ``--control``: the control, the reference itself computed one precision
  below the configuration's (:data:`BELOW`: float32 for float64, bfloat16
  for float32) put in the program's place, on the same inputs a run makes
  and as many answers as a run compares, read the same way (the upper
  readings).

Prints one JSON line per seed and side.  The benchmark's own runs do not run
this.  Needs a card, as a run does.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# The precision one step below each configuration's ``dtype``.
BELOW = {"float64": "float32", "float32": "bfloat16"}


def control_tally(cell, seed: int, device):
    """The reference one precision below the configuration's in the
    program's place, judged as a run: on the batches a batch mix checks, or
    on a serving mix's whole pool."""
    import torch

    from lpbench import judge, loadgen

    cfg, mix = cell.config, cell.traffic
    M = float(cfg["M"])
    low_dt = getattr(torch, BELOW[cfg["dtype"]])
    ref_mod = cell.reference
    tally = judge.Tally(ref_mod)
    if "batch" in mix:
        inputs = loadgen.batch_inputs(cfg, mix, seed, device, cell.problem)
        n = min(int(mix["check_calls"]), len(inputs))
        for A, b, c, mv in inputs[:n]:
            low = ref_mod.solve(A, b, c, mv, M=M, dtype=low_dt)
            ref = tally.classify(A, b, c, mv, cfg)
            tally.add(ref, A, b, c, mv, low["x"].float(), low["feasible"],
                      low["objective"].float(), M)
        return tally
    pool = loadgen.request_pool(cfg, mix, seed, cell.problem)
    for g, m in enumerate(pool.sizes):
        A = torch.from_numpy(pool.A[g]).to(device)
        b = torch.from_numpy(pool.b[g]).to(device)
        c = torch.from_numpy(pool.c[g]).to(device)
        mv = torch.full((len(A),), m, dtype=torch.int32, device=device)
        low = ref_mod.solve(A, b, c, mv, M=M, dtype=low_dt)
        ref = tally.classify(A, b, c, mv, cfg)
        tally.add(ref, A, b, c, mv, low["x"].float(), low["feasible"],
                  low["objective"].float(), M)
    return tally


def main(argv=None, *, device=None, root=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", type=float, default=0.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from lpbench import run as runner
    runner.cache_dirs()
    import torch

    from lpbench import drivers, spec
    root = ROOT if root is None else Path(root)
    cell = spec.find_cell(args.workload, root, root / "lpbench")
    if device is None:
        if not torch.cuda.is_available():
            print("lpbench.control: no CUDA device", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    for seed in (int(s) for s in args.seeds.split(",")):
        sides = []
        if args.program > 0:
            sides.append("program")
        if args.control:
            sides.append("control")
        for side in sides:
            t = time.perf_counter()
            if side == "program":
                r = drivers.Run.of(cell)
                cell.loop(r, seed, args.program, False, device, lambda: 0.0)
                tally, failed = r.tally, r.failed
            else:
                tally, failed = control_tally(cell, seed, device), 0
            print(json.dumps({
                "cell": cell.name, "seed": seed, "side": side,
                "failed": failed, "compared": tally.compared,
                "wrong": tally.wrong, "obj_gap": tally.obj_gap,
                "x_viol": tally.x_viol, "row_viol": tally.row_viol,
                "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
