"""Find the highest rate the served path sustains, once, on the card.

    python3 lpbench/sweep_rate.py --workload servemix.open --seed 7 \\
        --seconds 45 --rates 1000,1500,2000,2500,3000

Drives the cell's open loop at each offered rate in turn, each in a process
of its own as a run is (its configuration and pool, the mix's rate
replaced), and prints one JSON line a rate: the offered and achieved rates,
p50 and p99 from the due time, how late the generator ran, the latency of
the last fifth of the requests against the first (a growing backlog shows
there), Python's collections in the window, and whether the rate is
*sustained*: achieved within 2% of offered, p99 under five times the
scheduler's wait, and the last fifth's mean latency under twice the first's.
The cell's rate is three quarters of the highest sustained one; that number
is written into its traffic file by hand.  The benchmark's runs do not run
this.
"""
from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one(workload: str, rate: float, seed: int, seconds: float,
        device=None, root=None) -> dict:
    """The open loop at ``rate`` in this process; its readings."""
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from lpbench import run as runner
    runner.cache_dirs()
    import numpy as np
    import torch

    from lpbench import drivers, spec
    root = ROOT if root is None else Path(root)
    cell = spec.find_cell(workload, root, root / "lpbench")
    if "rate" not in cell.traffic:
        raise SystemExit(f"{cell.name} is not an open loop")
    device = torch.device(device or "cuda")
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.traffic["rate"] = rate
    r = drivers.Run.of(cell)
    cell.loop(r, seed, seconds, False, device, lambda: 0.0)
    lat = r.latency_s
    fifth = max(1, len(lat) // 5)
    first, last = float(np.mean(lat[:fifth])), float(np.mean(lat[-fifth:]))
    achieved = r.lps_done / r.window_s
    p99 = float(np.percentile(lat, 99))
    wait_s = float(cell.config["scheduler"]["max_wait_s"])
    return {
        "rate": rate, "achieved": achieved,
        "sustained": bool(achieved >= 0.98 * rate and p99 < 5 * wait_s
                          and last < 2 * first and r.failed == 0),
        "p50_ms": float(np.percentile(lat, 50)) * 1e3, "p99_ms": p99 * 1e3,
        "first_fifth_ms": first * 1e3, "last_fifth_ms": last * 1e3,
        "late_ms": r.info.get("late_ms"), "gc": r.info.get("gc"),
        "flush_reasons": r.counters.get("flush_reasons"),
        "flush_lps": (r.counters["n_solved"] / r.counters["n_flushes"]
                      if r.counters.get("n_flushes") else None),
        "submit_us": float(np.mean(r.submit_s)) * 1e6,
        "failed": r.failed, "wrong": r.tally.wrong}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="servemix.open")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=45.0)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--one", action="store_true",
                    help="run the first rate in this process")
    args = ap.parse_args(argv)
    rates = [float(r) for r in args.rates.split(",")]
    if args.one:
        print(json.dumps(one(args.workload, rates[0], args.seed,
                             args.seconds)))
        return 0
    best = None
    for rate in rates:
        p = subprocess.run(
            [sys.executable, str(Path(__file__)), "--one", "--workload",
             args.workload, "--seed", str(args.seed), "--seconds",
             str(args.seconds), "--rates", str(rate)],
            capture_output=True, text=True, timeout=600)
        if p.returncode != 0:
            print(json.dumps({"rate": rate, "error": p.stderr[-2000:]}))
            continue
        line = json.loads(p.stdout.strip().splitlines()[-1])
        print(json.dumps(line), flush=True)
        if line["sustained"]:
            best = rate
    print(json.dumps({"highest_sustained": best,
                      "cell_rate": None if best is None else 0.75 * best}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
