"""The readings the crowd cells' limits are set from.

    python3 lpbench/crowd_control.py --workload crowd-16384.step --seeds 1,2,3
                                     [--steps 4]

For each seed, in one process on the card: the cell's spawn and its lead
steps (the program's direct steps, as a run's set-up), then ``--steps``
states of the first episode drawn from the seed.  At each state, two
answers to every agent's LP, each judged as a run judges its own against
the reference's float64 rows, for the agents the reference is sure of:

* ``program``: the program's direct step from that state (the lower
  readings);
* ``control``: the reference's own rows built from the state in float16,
  the precision below the configuration's float32 for row building, then
  solved by the reference (the upper readings).

Prints one JSON line per seed and side.  The benchmark's own runs do not
run this.  Needs a card, as a run does.
"""
from __future__ import annotations

import argparse
import json
import random
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_answers(cell, loop, state):
    """The control's answers at ``state``: the reference's rows in float16,
    solved by the reference in float64."""
    import torch

    from repro_torch.core.lp import LPSolution
    cfg = cell.config
    ref = cell.reference.rows(state.pos, state.vel, state.goal, state.eps,
                              loop.reference_params(cfg),
                              dtype=torch.float16)
    A, b, c = (ref[k].double() for k in ("A", "b", "c"))
    got = cell.reference.solve(A, b, c, ref["m_valid"], M=float(cfg["M"]))
    x = got["x"].float()
    return LPSolution(x=x, feasible=got["feasible"],
                      objective=(c * got["x"]).sum(dim=1).float())


def main(argv=None, *, device=None, root=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--steps", type=int, default=4)
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
            print("lpbench.crowd_control: no CUDA device", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    from repro_torch.crowd import CrowdState, step_direct
    from repro_torch.solver import SolverSpec
    loop = spec.module("loops", cell.traffic["loop"], root / "lpbench")
    cfg = cell.config
    prm = loop.params(cfg)
    solver = SolverSpec(backend=cfg["solver"]["backend"], M=float(cfg["M"]),
                        dtype=cfg["dtype"]).build(device=device)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        pos, goal, eps = cell.problem.spawn(cfg["problem"], seed)
        state = CrowdState.start(pos.to(device), goal.to(device),
                                 eps.to(device))
        for _ in range(int(cfg["episode"]["lead_steps"])):
            state = step_direct(state, solver, prm)[0]
        at = sorted(random.Random(seed).sample(
            range(int(cfg["episode"]["episode_steps"])), args.steps))
        held = {"program": [], "control": []}
        for s in range(at[-1] + 1):
            new, _, sol = step_direct(state, solver, prm)
            if s in at:
                held["program"].append((state, sol))
                held["control"].append(
                    (state, control_answers(cell, loop, state)))
            state = new
        for side, items in held.items():
            r = drivers.Run.of(cell)
            loop.judge(r, items)
            tally = r.tally
            print(json.dumps({
                "cell": cell.name, "seed": seed, "side": side,
                "steps": at, "compared": tally.compared,
                "unsure": r.info["unsure"], "wrong": tally.wrong,
                "obj_gap": tally.obj_gap, "x_viol": tally.x_viol,
                "row_viol": tally.row_viol,
                "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
